"""The grouped (expert-indexed) GEMM of the MoE path: the CUDA kernel of
`csrc/moe_gemm.cu`, its wrapper and its plain PyTorch version.

Counterpart of `chitu_tpu/ops/pallas_moe_gemm.py` (B8):

    out[b*bm + i] = xs[b*bm + i] @ dequant(w[layer, block_expert[b]])

for token-sorted rows `xs [NB*bm, K]` in dispatch blocks of `bm` rows (the
layout `models.moe.sorted_dispatch` builds), `block_expert [NB]` int32 on
the device, -1 marking a dead block, which reads no weight and writes
zeros. `w` is `[L, E, K, N]` or `[E, K, N]`: dense bf16, or a soft-fp8 / fp8
`QTensor` (e4m3 bytes, f32 scales per 128-row K block, blockwise
`[.., K/128, N/128]` or rowwise `[.., K/128, N]`, read where they lie). K
and N are multiples of 128, bm is 16, 32, 64, 128 or 256. The output is
bf16, the sums f32.

Numerics: the kernel rounds the scaled weight to bf16 before the product,
`bf16(float(e4m3) * scale)`, exactly as `QTensor.dequantize` and the
dequant GEMM of `quant_gemm.cu` do; the plain version dequantizes the same
way and sums in f32. The TPU kernel instead multiplies each 128-row partial
sum by its scale row in f32, so against the interpreted Pallas kernel the
tolerance is atol = rtol = 2e-2 (that of the dequant GEMM's tests), while
kernel and plain version differ only in summation order. Launches repeat bit
for bit: split-K partial sums are added in a fixed order, without atomics.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from chitu_tpu_torch.ops import cuda_build
from chitu_tpu_torch.ops.cuda_build import LAUNCHES
from chitu_tpu_torch.ops.qtensor import QTensor, QuantKind

LAUNCHES.setdefault("grouped_gemm", 0)

QBLK = 128  # K rows that share one scale row; also the kernel's column tile
BLOCK_ROWS = (16, 32, 64, 128, 256)  # what `dispatch_geometry` can give

_FP8_KINDS = (QuantKind.SOFT_FP8, QuantKind.FP8)


def kernel_eligible(w) -> bool:
    """Can this expert stack run through the grouped kernel? Dense stacks
    and e4m3 stacks with K and N multiples of 128 and scales that cover N;
    int8 / int4 expert stacks take the capacity route of `models.moe`. The
    quant block must be 128 rows, the only size whose scale rows the
    kernel (and the TPU kernel) can index."""
    if isinstance(w, QTensor):
        if w.kind not in _FP8_KINDS or w.block != QBLK:
            return False
        K, N = w.data.shape[-2], w.data.shape[-1]
        so = w.scale.shape[-1]
        scale_ok = so == N or so * w.block >= N
        return K % QBLK == 0 and N % QBLK == 0 and scale_ok
    K, N = w.shape[-2], w.shape[-1]
    return K % QBLK == 0 and N % QBLK == 0


def _stack(w):
    return w.data if isinstance(w, QTensor) else w


def expert_weight(w, layer, e: int) -> torch.Tensor:
    """Expert e of `layer` as a dense bf16 [K, N] matrix."""
    d = _stack(w)
    idx = (layer, e) if d.dim() == 4 else (e,)
    if isinstance(w, QTensor):
        return w[idx].dequantize(torch.bfloat16)
    return d[idx].to(torch.bfloat16)


def grouped_matmul_plain(
    xs: torch.Tensor, w, layer, block_expert: torch.Tensor, bm: int
) -> torch.Tensor:
    """For each dispatch block, its rows times the dequantized weight of
    its expert (rounded to bf16, summed in f32); zeros for dead blocks.
    Reads `block_expert` on the host."""
    N = _stack(w).shape[-1]
    E = _stack(w).shape[-3]
    layer = int(layer or 0)
    out = torch.zeros((xs.shape[0], N), dtype=torch.bfloat16, device=xs.device)
    dense = {}
    for b, e in enumerate(block_expert.tolist()):
        if e < 0 or e >= E:
            continue
        if e not in dense:
            dense[e] = expert_weight(w, layer, e).float()
        rows = slice(b * bm, (b + 1) * bm)
        out[rows] = torch.matmul(
            xs[rows].to(torch.bfloat16).float(), dense[e]
        ).to(torch.bfloat16)
    return out


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("moe_gemm")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.chitu_moe_gemm.argtypes = [P] * 5 + [I] * 9 + [P, P, I, P]
        lib.chitu_moe_gemm.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# split-K workspace of the 16-row kernel, one per device, grown on demand:
# partial tiles (16 x 128 f32 each) and ticket counters that every launch
# leaves at zero. Launches that run in order (one stream, as the port
# launches them) share it; launches on different streams must not overlap.
_WORKSPACES = {}
_MAX_SPLITS = 16
_SMS = {}


def _workspace(dev, tiles: int, partials: int):
    ws, counters = _WORKSPACES.get(dev.index, (None, None))
    if ws is None or ws.shape[0] < partials or counters.shape[0] < tiles:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the grouped GEMM's split-K workspace must exist before a "
                "CUDA graph is captured: run the call once beforehand"
            )
        ws = torch.empty((partials, 16, QBLK), dtype=torch.float32, device=dev)
        counters = torch.zeros((tiles,), dtype=torch.int32, device=dev)
        _WORKSPACES[dev.index] = (ws, counters)
    return ws, counters


def _splits(dev, NB: int, E: int, K: int, N: int, fp8: bool) -> int:
    """K splits of the 16-row kernel, from static shapes only: at most
    min(E, NB) dispatch blocks are live at decode, and two blocks fit an
    SM, so K is split until the live blocks' column tiles fill the card,
    keeping at least two K tiles a split."""
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    live_tiles = min(E, NB) * (N // QBLK)
    ktiles = K // (128 if fp8 else 64)
    return max(1, min(2 * _SMS[dev.index] // live_tiles, ktiles // 2, _MAX_SPLITS))


def grouped_matmul(
    xs: torch.Tensor,  # [NB*bm, K] bf16 token-sorted rows
    w: Union[torch.Tensor, QTensor],  # [L, E, K, N] or [E, K, N]
    layer,  # int (ignored when unstacked)
    block_expert: torch.Tensor,  # [NB] int32, -1 = dead block
    bm: int,
) -> torch.Tensor:
    """-> out [NB*bm, N] bf16, out[b*bm+i] = xs[b*bm+i] @
    dequant(w[layer, block_expert[b]]); zeros for dead blocks."""
    if not xs.is_cuda:
        return grouped_matmul_plain(xs, w, layer, block_expert, bm)
    dev = xs.device
    if not kernel_eligible(w):
        raise NotImplementedError(
            "grouped_matmul takes dense bf16 or e4m3 (block 128) expert "
            "stacks with K and N multiples of 128; other stacks go through "
            "models.moe.moe_ffn"
        )
    data = _stack(w)
    if data.dim() not in (3, 4):
        raise ValueError(f"expert stack of shape {tuple(data.shape)}")
    stacked = data.dim() == 4
    L = data.shape[0] if stacked else 1
    E, K, N = data.shape[-3:]
    layer = int(layer or 0) if stacked else 0
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} of a stack of {L}")
    if bm not in BLOCK_ROWS:
        raise NotImplementedError(f"bm={bm}: the kernel takes {BLOCK_ROWS}")
    NB = block_expert.shape[0]
    cuda_build.check("xs", xs, torch.bfloat16, dev, (NB * bm, K))
    cuda_build.check("block_expert", block_expert, torch.int32, dev, (NB,))
    fp8 = isinstance(w, QTensor)
    scale, scale_ld, rowwise = None, 0, 0
    if fp8:
        cuda_build.check("expert data", data, torch.float8_e4m3fn, dev)
        scale = w.scale
        rowwise = int(scale.shape[-1] == N)
        scale_ld = N if rowwise else N // QBLK
        cuda_build.check(
            "expert scale", scale, torch.float32, dev,
            (*data.shape[:-2], K // QBLK, scale_ld),
        )
    else:
        cuda_build.check("expert weights", data, torch.bfloat16, dev)
    out = torch.empty((NB * bm, N), dtype=torch.bfloat16, device=dev)
    if NB == 0:
        return out
    ws, counters, splits = None, None, 1
    if bm == 16:
        splits = _splits(dev, NB, E, K, N, fp8)
        if splits > 1:
            tiles = NB * (N // QBLK)
            ws, counters = _workspace(dev, tiles, tiles * splits)
    rc = _lib().chitu_moe_gemm(
        cuda_build.ptr(xs), cuda_build.ptr(data), cuda_build.ptr(scale),
        cuda_build.ptr(block_expert), cuda_build.ptr(out), NB, bm, K, N, E,
        layer, int(fp8), scale_ld, rowwise, cuda_build.ptr(ws),
        cuda_build.ptr(counters), splits, cuda_build.stream(dev),
    )
    cuda_build.raise_on(rc, "grouped_gemm")
    LAUNCHES["grouped_gemm"] += 1
    return out
