"""Hand-written CUDA attention kernels for Hopper, their wrappers, their
plain PyTorch versions, and the slab-geometry gates.

Counterpart of `chitu_tpu/ops/pallas_attention.py`. Three kernels from
`csrc/attention.cu`, built with nvcc into one shared library with a plain
C interface at first use (into `chitu_tpu_torch/build/`) and bound with
ctypes:

- `attend_decode_fused` (B1): in-kernel KV append + one-token paged decode
  attention; plain version `append_decode` + oracle `attend_decode`.
- `attend_prefill_packed_fused` (B2): packed varlen prefill, append then
  attention (two launches on one stream); plain version
  `append_prefill_packed` + `_oracle_prefill_packed`.
- `attend_prefill` (B5): one sequence's chunk against its paged context;
  plain version the oracle `attend_prefill`.

A wrapper runs the plain version only for tensors that lie on the CPU.
For CUDA tensors it launches its kernel or raises; it never falls back.
Each wrapper counts its kernel launches in `LAUNCHES`. The pool is
updated IN PLACE by B1 and B2 (the JAX kernels alias it and return it).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Optional

import torch

from chitu_tpu_torch.ops import attention as plain

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = (os.path.join(_PKG, "csrc", "attention.cu"),)
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one where it launches its kernel and nowhere else
LAUNCHES: Dict[str, int] = {
    "attend_decode_fused": 0,
    "attend_prefill_packed_fused": 0,
    "attend_prefill": 0,
}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Slab-geometry gates (the JAX package's sizing rules, kept verbatim so the
# port's packed-prefill slab and q blocks equal the JAX engine's)
# ---------------------------------------------------------------------------

Q_BLOCK = 64
VMEM_BUDGET = 10 * 1024 * 1024


def _fit_q_block(T: int, H: int, C: int, page: int, D: int) -> int:
    per_row = H * (6 * C + 4 * page + 8 * D)
    tq = min(T, Q_BLOCK)
    while tq > 8 and tq * per_row > VMEM_BUDGET // 2:
        tq //= 2
    return tq


def _grouped_eligible(
    split_kv: bool, kv_heads: int, head_dim: int, H: int
) -> bool:
    if not split_kv or head_dim % 128 != 0:
        return False
    G = H // kv_heads
    return G > 0 and H == kv_heads * G


def _fit_q_block_grouped(T: int, H: int, page: int, D: int) -> int:
    per_row = H * (14 * D + 4 * page)
    tq = min(T, Q_BLOCK)
    while tq > 8 and tq * per_row > VMEM_BUDGET // 2:
        tq //= 2
    return tq


def packed_q_block(
    H: int, M: int, page: int, D: int,
    kv_heads: Optional[int] = None, split_kv: bool = True,
) -> int:
    """Query-block granularity of packed prefill: each request's tokens
    pad to a multiple of it, so every block belongs to one segment."""
    if kv_heads and _grouped_eligible(split_kv, kv_heads, D, H):
        return _fit_q_block_grouped(1 << 30, H, page, D)
    return _fit_q_block(1 << 30, H, M, page, D)


def prefill_packed_fused_ok(
    split_kv: bool, kv_heads: int, head_dim: int, H: int,
    page: int, Tq: int,
) -> bool:
    """The JAX package's gate for its fused packed prefill (grouped layout
    and page % Tq == 0, which its in-kernel page RMW needs). The CUDA
    kernel appends in a separate launch and needs neither; the gate is
    kept for the slab contract and the tests."""
    return (
        _grouped_eligible(split_kv, kv_heads, head_dim, H)
        and Tq > 0
        and page % Tq == 0
    )


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------

_LIB = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_kernels() -> str:
    """Compile csrc/ into build/attention-<hash>.so unless that exact
    build exists; returns its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"attention-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, so)
    return so


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_kernels())
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.chitu_attend_decode_fused.argtypes = (
            [P] * 8 + [I] * 9 + [F, I, F, P]
        )
        lib.chitu_attend_prefill.argtypes = (
            [P] * 5 + [I] * 11 + [F, I, F, P]
        )
        lib.chitu_attend_prefill_packed_fused.argtypes = (
            [P] * 9 + [I] * 11 + [F, I, F, P]
        )
        for fn in (
            lib.chitu_attend_decode_fused,
            lib.chitu_attend_prefill,
            lib.chitu_attend_prefill_packed_fused,
        ):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, dtype, device, shape=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _raise_on(rc: int, kernel: str):
    if rc == 100000:
        raise NotImplementedError(f"{kernel}: geometry not supported by the kernel")
    if rc:
        raise RuntimeError(
            f"{kernel} launch failed: {torch.cuda.get_device_name()} "
            f"cudaError {rc}"
        )


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _rows_block(G: int, Tq: int) -> int:
    """Query tokens per CUDA block: the largest power of two with
    tokens x G <= 64 rows that divides Tq."""
    bq = 1
    while bq * 2 * G <= 64 and Tq % (bq * 2) == 0:
        bq *= 2
    return bq


def _check_geometry(D: int, M: int, kv_heads: int, H: int):
    if D != 128:
        raise NotImplementedError(
            f"head_dim {D}: the CUDA kernels take head_dim 128 only; other "
            "head sizes wait for the expanded variants (ROADMAP queue B, "
            "item 5)"
        )
    if H % kv_heads or M < 2 * kv_heads * D:
        raise ValueError(f"pool minor {M} cannot hold {kv_heads} K/V heads of {D}")


# ---------------------------------------------------------------------------
# B1: fused append + decode attention
# ---------------------------------------------------------------------------


def attend_decode_fused_plain(
    q, pool, layer, k, v, block_tables, seq_lens, valid, page_size,
    kv_heads, head_dim, scale=None, window=0, softcap=0.0,
):
    plain.append_decode(
        pool, layer, k, v, block_tables, seq_lens, valid, page_size
    )
    return plain.attend_decode(
        q, pool, layer, block_tables, seq_lens, page_size, kv_heads,
        head_dim, scale=scale, window=window, softcap=softcap,
    )


def attend_decode_fused(
    q: torch.Tensor,  # [B, H, D]
    pool: torch.Tensor,  # [L, P, page, M], updated in place
    layer: int,
    k: torch.Tensor,  # [B, KV, D] new token K
    v: torch.Tensor,  # [B, KV, D] new token V
    block_tables: torch.Tensor,  # [B, mp] int32
    seq_lens: torch.Tensor,  # [B] int32 (context excluding the new token)
    valid: torch.Tensor,  # [B] bool
    page_size: int,
    kv_heads: int,
    head_dim: int,
    scale: Optional[float] = None,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """-> out [B, H, D]. Live rows (valid and a page for slot seq_lens[b])
    write their packed K|V row into the pool in place; every row attends
    its prior context plus its new token taken from k/v."""
    B, H, D = q.shape
    L, P, page, M = pool.shape
    assert page == page_size and D == head_dim
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if not q.is_cuda:
        return attend_decode_fused_plain(
            q, pool, layer, k, v, block_tables, seq_lens, valid, page_size,
            kv_heads, head_dim, scale, window, softcap,
        )
    dev = q.device
    _check_geometry(D, M, kv_heads, H)
    mp = block_tables.shape[1]
    _check("q", q, torch.bfloat16, dev)
    _check("pool", pool, torch.bfloat16, dev)
    _check("k", k, torch.bfloat16, dev, (B, kv_heads, D))
    _check("v", v, torch.bfloat16, dev, (B, kv_heads, D))
    _check("block_tables", block_tables, torch.int32, dev, (B, mp))
    _check("seq_lens", seq_lens, torch.int32, dev, (B,))
    _check("valid", valid, torch.bool, dev, (B,))
    out = torch.empty_like(q)
    rc = _lib().chitu_attend_decode_fused(
        _ptr(q), _ptr(pool), _ptr(k), _ptr(v), _ptr(block_tables),
        _ptr(seq_lens), _ptr(valid), _ptr(out), B, int(layer), P, page, M,
        mp, kv_heads, H // kv_heads, D, float(scale), int(window),
        float(softcap), _stream(dev),
    )
    _raise_on(rc, "attend_decode_fused")
    LAUNCHES["attend_decode_fused"] += 1
    return out


# ---------------------------------------------------------------------------
# B5: one sequence's prefill chunk against its paged context
# ---------------------------------------------------------------------------


def attend_prefill(
    q: torch.Tensor,  # [T, H, D]
    pool: torch.Tensor,  # [L, P, page, M]
    layer: int,
    block_table: torch.Tensor,  # [mp] int32
    q_pos: torch.Tensor,  # [T] int32 (consecutive from q_pos[0])
    total_len: int,
    page_size: int,
    kv_heads: int,
    head_dim: int,
    scale: Optional[float] = None,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """-> out [T, H, D] (the chunk's K/V must already be in the pool).
    The kernel places row t at q_pos[0] + t, as the TPU kernel does."""
    T, H, D = q.shape
    L, P, page, M = pool.shape
    assert page == page_size and D == head_dim
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if not q.is_cuda:
        return plain.attend_prefill(
            q, pool, layer, block_table, q_pos, total_len, page_size,
            kv_heads, head_dim, scale=scale, window=window, softcap=softcap,
        )
    dev = q.device
    _check_geometry(D, M, kv_heads, H)
    mp = block_table.shape[0]
    _check("q", q, torch.bfloat16, dev)
    _check("pool", pool, torch.bfloat16, dev)
    _check("block_table", block_table, torch.int32, dev, (mp,))
    _check("q_pos", q_pos, torch.int32, dev, (T,))
    G = H // kv_heads
    out = torch.empty_like(q)
    rc = _lib().chitu_attend_prefill(
        _ptr(q), _ptr(pool), _ptr(block_table), _ptr(q_pos), _ptr(out), T,
        _rows_block(G, T), int(layer), P, page, M, mp, kv_heads, G, D,
        int(total_len), float(scale), int(window), float(softcap),
        _stream(dev),
    )
    _raise_on(rc, "attend_prefill")
    LAUNCHES["attend_prefill"] += 1
    return out


# ---------------------------------------------------------------------------
# B2: packed varlen prefill, append then attend
# ---------------------------------------------------------------------------


def packed_token_layout(block_seg, block_qstart, total_lens, T: int):
    """Per-token (segment, position, live) of a packed slab from its
    block geometry: token t sits in block t // Tq at position
    block_qstart + t % Tq and is live when its block has a segment and
    the position is inside that segment's total length."""
    NB = block_seg.shape[0]
    Tq = T // NB
    t = torch.arange(T, device=block_seg.device)
    blk = torch.div(t, Tq, rounding_mode="floor")
    seg = block_seg[blk]
    pos = block_qstart[blk] + t % Tq
    tot = total_lens[torch.clamp(seg, min=0).long()]
    return seg, pos.to(torch.int32), (seg >= 0) & (pos < tot)


def attend_prefill_packed_fused_plain(
    q, pool, layer, k, v, block_tables, block_seg, block_qstart, total_lens,
    page_size, kv_heads, head_dim, scale=None, window=0, softcap=0.0,
):
    T = q.shape[0]
    seg, pos, live = packed_token_layout(block_seg, block_qstart, total_lens, T)
    minus1 = torch.full_like(seg, -1)
    plain.append_prefill_packed(
        pool, layer, k, v, block_tables, torch.where(live, seg, minus1),
        torch.where(live, pos, minus1), page_size,
    )
    out = plain._oracle_prefill_packed(
        q, pool, layer, block_tables, seg, pos, total_lens, kv_heads,
        head_dim, scale, window, softcap,
    )
    # dead blocks return zeros, as the kernel does
    return torch.where((seg >= 0)[:, None, None], out, torch.zeros_like(out))


def attend_prefill_packed_fused(
    q: torch.Tensor,  # [T, H, D]
    pool: torch.Tensor,  # [L, P, page, M], updated in place
    layer: int,
    k: torch.Tensor,  # [T, KV, D] fresh keys (packed rows)
    v: torch.Tensor,  # [T, KV, D] fresh values
    block_tables: torch.Tensor,  # [R, mp] int32
    block_seg: torch.Tensor,  # [NB] int32 (-1 = dead block)
    block_qstart: torch.Tensor,  # [NB] int32
    total_lens: torch.Tensor,  # [R] int32
    page_size: int,
    kv_heads: int,
    head_dim: int,
    scale: Optional[float] = None,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """-> out [T, H, D]; live rows are appended to the pool in place
    first, then every live block attends causally by absolute position
    over its segment's context (dead blocks: zeros)."""
    T, H, D = q.shape
    L, P, page, M = pool.shape
    NB = block_seg.shape[0]
    assert page == page_size and D == head_dim
    if T % NB:
        raise ValueError(f"{T} packed tokens do not split into {NB} blocks")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if not q.is_cuda:
        return attend_prefill_packed_fused_plain(
            q, pool, layer, k, v, block_tables, block_seg, block_qstart,
            total_lens, page_size, kv_heads, head_dim, scale, window, softcap,
        )
    dev = q.device
    _check_geometry(D, M, kv_heads, H)
    R, mp = block_tables.shape
    _check("q", q, torch.bfloat16, dev)
    _check("pool", pool, torch.bfloat16, dev)
    _check("k", k, torch.bfloat16, dev, (T, kv_heads, D))
    _check("v", v, torch.bfloat16, dev, (T, kv_heads, D))
    _check("block_tables", block_tables, torch.int32, dev, (R, mp))
    _check("block_seg", block_seg, torch.int32, dev, (NB,))
    _check("block_qstart", block_qstart, torch.int32, dev, (NB,))
    _check("total_lens", total_lens, torch.int32, dev, (R,))
    G = H // kv_heads
    out = torch.empty_like(q)
    rc = _lib().chitu_attend_prefill_packed_fused(
        _ptr(q), _ptr(pool), _ptr(k), _ptr(v), _ptr(block_tables),
        _ptr(block_seg), _ptr(block_qstart), _ptr(total_lens), _ptr(out),
        T, NB, _rows_block(G, T // NB), int(layer), P, page, M, mp,
        kv_heads, G, D, float(scale), int(window), float(softcap),
        _stream(dev),
    )
    _raise_on(rc, "attend_prefill_packed_fused")
    LAUNCHES["attend_prefill_packed_fused"] += 1
    return out
