"""Hand-written CUDA attention kernels for Hopper, their wrappers, their
plain PyTorch versions, and the slab-geometry gates.

Counterpart of `chitu_tpu/ops/pallas_attention.py`. Five kernels from
`csrc/attention.cu`, built and loaded by `ops/cuda_build.py` (nvcc, a
plain C interface, ctypes):

- `attend_decode_fused` (B1): in-kernel KV append + one-token paged decode
  attention; plain version `append_decode` + oracle `attend_decode`.
- `attend_prefill_packed_fused` (B2): packed varlen prefill, append then
  attention (two launches on one stream); plain version
  `append_prefill_packed` + `_oracle_prefill_packed`.
- `attend_prefill_packed` (B3): B2's attention alone, the rows appended
  before it; plain version `_oracle_prefill_packed`.
- `attend_decode` (B4): one-token decode, the new token already in the
  pool; plain version the oracle `attend_decode`.
- `attend_prefill` (B5): one sequence's chunk against its paged context;
  plain version the oracle `attend_prefill`.

Two geometries, each raising on anything else (`_check_geometry`): split
K/V rows at head sizes 32, 64, 128 and 192 (B1-B5; 192 is DeepSeek's
dense MLA, V padded to 192 lanes in the row), and the MLA merged latent
row (`split_kv=False`, B1 and B3-B5): one KV head whose 576 live lanes
[c_kv | k_pe] are the key and whose first 512 (`v_dim`, kv_lora_rank) are
the value. There q comes at its 576 live lanes and the output holds the
512 value lanes only, in the kernel and in its plain version alike. Every
kernel takes a bf16 pool or an int8 pool of fp8-e4m3 bits
(infer.kv_dtype=fp8); the appends write the JAX package's e4m3 bytes.

A wrapper runs the plain version only for tensors that lie on the CPU.
For CUDA tensors it launches its kernel or raises; it never falls back.
Each wrapper counts its kernel launches in `LAUNCHES`, under its own name
and, for every variant beyond a bf16 pool at head_dim 128, under
`name[variant]` too (`e4m3`, `d192`, `latent`, `latent,e4m3`, ...). The
pool is updated IN PLACE by B1 and B2 (the JAX kernels alias it and return
it).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from chitu_tpu_torch.ops import attention as plain
from chitu_tpu_torch.ops import cuda_build
from chitu_tpu_torch.ops.cuda_build import (  # noqa: F401
    LAUNCHES,
    reset_launch_counts,
)
from chitu_tpu_torch.ops.cuda_build import check as _check
from chitu_tpu_torch.ops.cuda_build import ptr as _ptr
from chitu_tpu_torch.ops.cuda_build import raise_on as _raise_on
from chitu_tpu_torch.ops.cuda_build import stream as _stream

for _name in (
    "attend_decode_fused", "attend_prefill_packed_fused", "attend_prefill",
    "attend_prefill_packed", "attend_decode",
):
    LAUNCHES.setdefault(_name, 0)

# the merged latent row the CUDA kernel takes: DeepSeek's kv_lora_rank 512
# plus rope 64 live lanes, the first 512 the value
LATENT_QK = 576
LATENT_DV = 512
# C entry chitu_attend_latent's modes
_DECODE_FUSED, _DECODE, _PREFILL, _PACKED = range(4)
# the split-layout head sizes csrc/attention.cu instantiates
SPLIT_HEAD_DIMS = (32, 64, 128, 192)
POOL_DTYPES = (torch.bfloat16, torch.int8)


def build_kernels():
    """Compile every CUDA source of the package (one nvcc each, all at
    once) unless its exact build exists; returns the libraries' paths."""
    return cuda_build.build_all()


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
# Binding
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("attention")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.chitu_attend_decode_fused.argtypes = (
            [P] * 8 + [I] * 9 + [F, I, F, I, P]
        )
        lib.chitu_attend_prefill.argtypes = (
            [P] * 5 + [I] * 11 + [F, I, F, I, P]
        )
        lib.chitu_attend_prefill_packed_fused.argtypes = (
            [P] * 9 + [I] * 11 + [F, I, F, I, P]
        )
        lib.chitu_attend_decode.argtypes = [P] * 5 + [I] * 9 + [F, I, F, I, P]
        lib.chitu_attend_prefill_packed.argtypes = (
            [P] * 7 + [I] * 11 + [F, I, F, I, P]
        )
        lib.chitu_attend_latent.argtypes = (
            [I] + [P] * 9 + [I, P] + [I] * 8 + [F, I, F, I, P]
        )
        for fn in (
            lib.chitu_attend_decode_fused,
            lib.chitu_attend_prefill,
            lib.chitu_attend_prefill_packed_fused,
            lib.chitu_attend_decode,
            lib.chitu_attend_prefill_packed,
            lib.chitu_attend_latent,
        ):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _rows_block(G: int, Tq: int) -> int:
    """Query tokens per CUDA block: the largest power of two with
    tokens x G <= 64 rows that divides Tq."""
    bq = 1
    while bq * 2 * G <= 64 and Tq % (bq * 2) == 0:
        bq *= 2
    return bq


def _check_geometry(
    D: int, M: int, kv_heads: int, H: int, split_kv: bool = True,
    v_dim: Optional[int] = None,
):
    """Accept exactly the geometries the kernels are built for: split K/V
    at the head sizes of SPLIT_HEAD_DIMS, and the merged latent row (one
    KV head, live width 576, value width 512)."""
    if not split_kv:
        if (kv_heads, D, v_dim) != (1, LATENT_QK, LATENT_DV) or H % 16:
            raise NotImplementedError(
                f"merged row kv_heads {kv_heads}, live width {D}, value "
                f"width {v_dim}, {H} heads: the CUDA kernels take one KV "
                f"head of {LATENT_QK} live lanes and {LATENT_DV} value "
                "lanes, with heads a multiple of 16 (DeepSeek-V3's MLA)"
            )
        if M < D:
            raise ValueError(f"pool minor {M} cannot hold a {D}-lane row")
        return
    if D not in SPLIT_HEAD_DIMS or v_dim not in (None, D):
        raise NotImplementedError(
            f"head_dim {D} (value width {v_dim}): the CUDA kernels take "
            f"split K/V at head sizes {SPLIT_HEAD_DIMS} with V at the K "
            "head size; another head size needs its instantiation in "
            "csrc/attention.cu (with_head_dim)"
        )
    if H % kv_heads or M < 2 * kv_heads * D:
        raise ValueError(f"pool minor {M} cannot hold {kv_heads} K/V heads of {D}")


def _check_pool(pool, dev):
    if pool.dtype not in POOL_DTYPES:
        raise TypeError(
            f"pool has dtype {pool.dtype}: the kernels take bf16 or int8 "
            "(fp8-e4m3 bits)"
        )
    _check("pool", pool, pool.dtype, dev)
    if pool.data_ptr() % 16:  # e4m3 rows load 8 and 16 bytes at a time
        raise ValueError("pool must be 16-byte aligned")
    return int(pool.dtype == torch.int8)


def variant_name(name, pool, D, split_kv) -> str:
    """`name[tags]` for a launch beyond a bf16 pool at split head_dim 128
    (tags: `latent` or `d<head_dim>`, and `e4m3` for an int8 pool), else
    `name`."""
    tags = []
    if not split_kv:
        tags.append("latent")
    elif D != 128:
        tags.append(f"d{D}")
    if pool.dtype == torch.int8:
        tags.append("e4m3")
    return f"{name}[{','.join(tags)}]" if tags else name


def _count(name, pool, D, split_kv):
    """One launch of `name`, and of its variant (`variant_name`)."""
    LAUNCHES[name] += 1
    key = variant_name(name, pool, D, split_kv)
    if key != name:
        LAUNCHES[key] = LAUNCHES.get(key, 0) + 1


def _latent(mode, q, pool, layer, bts, pos_in, total, nrows, NB=1,
            knew=None, valid=None, block_seg=None, block_qstart=None,
            total_lens=None, scale=1.0, window=0, softcap=0.0):
    """Launch the latent-row kernel in one of its four modes -> out
    [nrows, H, LATENT_DV]."""
    L, P, page, M = pool.shape
    H = q.shape[1]
    dev = q.device
    _check("q", q, torch.bfloat16, dev, (nrows, H, LATENT_QK))
    fp8 = _check_pool(pool, dev)
    out = torch.empty((nrows, H, LATENT_DV), dtype=torch.bfloat16, device=dev)
    rc = _lib().chitu_attend_latent(
        mode, _ptr(q), _ptr(pool), _ptr(knew), _ptr(bts), _ptr(pos_in),
        _ptr(valid), _ptr(block_seg), _ptr(block_qstart), _ptr(total_lens),
        int(total), _ptr(out), nrows, NB, H, int(layer), P, page, M,
        bts.shape[-1], float(scale), int(window), float(softcap), fp8,
        _stream(dev),
    )
    return out, rc


# ---------------------------------------------------------------------------
# B1: fused append + decode attention; B4: decode over the appended pool
# ---------------------------------------------------------------------------


def _vlanes(out, v_dim):
    return out if v_dim is None else out[..., :v_dim]


def attend_decode_plain(
    q, pool, layer, block_tables, seq_lens, page_size, kv_heads, head_dim,
    scale=None, window=0, softcap=0.0, split_kv=True, v_dim=None,
):
    return _vlanes(plain.attend_decode(
        q, pool, layer, block_tables, seq_lens, page_size, kv_heads,
        head_dim, scale=scale, window=window, softcap=softcap,
        split_kv=split_kv,
    ), v_dim)


def attend_prefill_plain(
    q, pool, layer, block_table, q_pos, total_len, page_size, kv_heads,
    head_dim, scale=None, window=0, softcap=0.0, split_kv=True, v_dim=None,
):
    return _vlanes(plain.attend_prefill(
        q, pool, layer, block_table, q_pos, total_len, page_size, kv_heads,
        head_dim, scale=scale, window=window, softcap=softcap,
        split_kv=split_kv,
    ), v_dim)


def attend_decode_fused_plain(
    q, pool, layer, k, v, block_tables, seq_lens, valid, page_size,
    kv_heads, head_dim, scale=None, window=0, softcap=0.0, split_kv=True,
    v_dim=None,
):
    plain.append_decode(
        pool, layer, k, v, block_tables, seq_lens, valid, page_size
    )
    return _vlanes(plain.attend_decode(
        q, pool, layer, block_tables, seq_lens, page_size, kv_heads,
        head_dim, scale=scale, window=window, softcap=softcap,
        split_kv=split_kv,
    ), v_dim)


def attend_decode_fused(
    q: torch.Tensor,  # [B, H, D]
    pool: torch.Tensor,  # [L, P, page, M], updated in place
    layer: int,
    k: torch.Tensor,  # [B, KV, D] new token K (merged: the latent row)
    v: Optional[torch.Tensor],  # [B, KV, D] new token V (merged: None)
    block_tables: torch.Tensor,  # [B, mp] int32
    seq_lens: torch.Tensor,  # [B] int32 (context excluding the new token)
    valid: torch.Tensor,  # [B] bool
    page_size: int,
    kv_heads: int,
    head_dim: int,
    scale: Optional[float] = None,
    window: int = 0,
    softcap: float = 0.0,
    split_kv: bool = True,
    v_dim: Optional[int] = None,
) -> torch.Tensor:
    """-> out [B, H, v_dim or D]. Live rows (valid and a page for slot
    seq_lens[b]) write their packed row into the pool in place; every row
    attends its prior context plus its new token taken from k/v."""
    B, H, D = q.shape
    L, P, page, M = pool.shape
    assert page == page_size and D == head_dim
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if not q.is_cuda:
        return attend_decode_fused_plain(
            q, pool, layer, k, v, block_tables, seq_lens, valid, page_size,
            kv_heads, head_dim, scale, window, softcap, split_kv, v_dim,
        )
    dev = q.device
    _check_geometry(D, M, kv_heads, H, split_kv, v_dim)
    mp = block_tables.shape[1]
    _check("block_tables", block_tables, torch.int32, dev, (B, mp))
    _check("seq_lens", seq_lens, torch.int32, dev, (B,))
    _check("valid", valid, torch.bool, dev, (B,))
    if not split_kv:
        _check("k", k, torch.bfloat16, dev, (B, 1, D))
        out, rc = _latent(
            _DECODE_FUSED, q, pool, layer, block_tables, seq_lens, 0, B,
            knew=k, valid=valid, scale=scale, window=window, softcap=softcap,
        )
    else:
        _check("q", q, torch.bfloat16, dev)
        fp8 = _check_pool(pool, dev)
        _check("k", k, torch.bfloat16, dev, (B, kv_heads, D))
        _check("v", v, torch.bfloat16, dev, (B, kv_heads, D))
        out = torch.empty_like(q)
        rc = _lib().chitu_attend_decode_fused(
            _ptr(q), _ptr(pool), _ptr(k), _ptr(v), _ptr(block_tables),
            _ptr(seq_lens), _ptr(valid), _ptr(out), B, int(layer), P, page,
            M, mp, kv_heads, H // kv_heads, D, float(scale), int(window),
            float(softcap), fp8, _stream(dev),
        )
    _raise_on(rc, "attend_decode_fused")
    _count("attend_decode_fused", pool, D, split_kv)
    return out


def attend_decode(
    q: torch.Tensor,  # [B, H, D]
    pool: torch.Tensor,  # [L, P, page, M] (the new token already appended)
    layer: int,
    block_tables: torch.Tensor,  # [B, mp] int32
    seq_lens: torch.Tensor,  # [B] int32 (context excluding the new token)
    page_size: int,
    kv_heads: int,
    head_dim: int,
    scale: Optional[float] = None,
    window: int = 0,
    softcap: float = 0.0,
    split_kv: bool = True,
    v_dim: Optional[int] = None,
) -> torch.Tensor:
    """-> out [B, H, v_dim or D]: each row attends positions
    [0, seq_lens[b]] of its pages, its new token's (appended by the plain
    `append_decode` of the same step) included."""
    B, H, D = q.shape
    L, P, page, M = pool.shape
    assert page == page_size and D == head_dim
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if not q.is_cuda:
        return attend_decode_plain(
            q, pool, layer, block_tables, seq_lens, page_size, kv_heads,
            head_dim, scale, window, softcap, split_kv, v_dim,
        )
    dev = q.device
    _check_geometry(D, M, kv_heads, H, split_kv, v_dim)
    mp = block_tables.shape[1]
    _check("block_tables", block_tables, torch.int32, dev, (B, mp))
    _check("seq_lens", seq_lens, torch.int32, dev, (B,))
    if not split_kv:
        out, rc = _latent(
            _DECODE, q, pool, layer, block_tables, seq_lens, 0, B,
            scale=scale, window=window, softcap=softcap,
        )
    else:
        _check("q", q, torch.bfloat16, dev)
        fp8 = _check_pool(pool, dev)
        out = torch.empty_like(q)
        rc = _lib().chitu_attend_decode(
            _ptr(q), _ptr(pool), _ptr(block_tables), _ptr(seq_lens),
            _ptr(out), B, int(layer), P, page, M, mp, kv_heads,
            H // kv_heads, D, float(scale), int(window), float(softcap),
            fp8, _stream(dev),
        )
    _raise_on(rc, "attend_decode")
    _count("attend_decode", pool, D, split_kv)
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
    split_kv: bool = True,
    v_dim: Optional[int] = None,
) -> torch.Tensor:
    """-> out [T, H, v_dim or D] (the chunk's K/V must already be in the
    pool). The kernel places row t at q_pos[0] + t, as the TPU kernel
    does."""
    T, H, D = q.shape
    L, P, page, M = pool.shape
    assert page == page_size and D == head_dim
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if not q.is_cuda:
        return attend_prefill_plain(
            q, pool, layer, block_table, q_pos, total_len, page_size,
            kv_heads, head_dim, scale, window, softcap, split_kv, v_dim,
        )
    dev = q.device
    _check_geometry(D, M, kv_heads, H, split_kv, v_dim)
    mp = block_table.shape[0]
    _check("block_table", block_table, torch.int32, dev, (mp,))
    _check("q_pos", q_pos, torch.int32, dev, (T,))
    if not split_kv:
        out, rc = _latent(
            _PREFILL, q, pool, layer, block_table, q_pos, total_len, T,
            scale=scale, window=window, softcap=softcap,
        )
    else:
        _check("q", q, torch.bfloat16, dev)
        fp8 = _check_pool(pool, dev)
        G = H // kv_heads
        out = torch.empty_like(q)
        rc = _lib().chitu_attend_prefill(
            _ptr(q), _ptr(pool), _ptr(block_table), _ptr(q_pos), _ptr(out),
            T, _rows_block(G, T), int(layer), P, page, M, mp, kv_heads, G, D,
            int(total_len), float(scale), int(window), float(softcap), fp8,
            _stream(dev),
        )
    _raise_on(rc, "attend_prefill")
    _count("attend_prefill", pool, D, split_kv)
    return out


# ---------------------------------------------------------------------------
# B2: packed varlen prefill, append then attend; B3: the attention alone
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


def attend_prefill_packed_plain(
    q, pool, layer, block_tables, block_seg, block_qstart, total_lens,
    page_size, kv_heads, head_dim, scale=None, window=0, softcap=0.0,
    split_kv=True, v_dim=None,
):
    T = q.shape[0]
    seg, pos, _ = packed_token_layout(block_seg, block_qstart, total_lens, T)
    out = _vlanes(plain._oracle_prefill_packed(
        q, pool, layer, block_tables, seg, pos, total_lens, kv_heads,
        head_dim, scale, window, softcap, split_kv,
    ), v_dim)
    # dead blocks return zeros, as the kernel does
    return torch.where((seg >= 0)[:, None, None], out, torch.zeros_like(out))


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
    return attend_prefill_packed_plain(
        q, pool, layer, block_tables, block_seg, block_qstart, total_lens,
        page_size, kv_heads, head_dim, scale, window, softcap,
    )


def _packed_checks(q, pool, block_tables, block_seg, block_qstart,
                   total_lens, kv_heads, split_kv, v_dim):
    T, H, D = q.shape
    M = pool.shape[-1]
    NB = block_seg.shape[0]
    if T % NB:
        raise ValueError(f"{T} packed tokens do not split into {NB} blocks")
    dev = q.device
    _check_geometry(D, M, kv_heads, H, split_kv, v_dim)
    R, mp = block_tables.shape
    _check("block_tables", block_tables, torch.int32, dev, (R, mp))
    _check("block_seg", block_seg, torch.int32, dev, (NB,))
    _check("block_qstart", block_qstart, torch.int32, dev, (NB,))
    _check("total_lens", total_lens, torch.int32, dev, (R,))
    if split_kv:
        _check("q", q, torch.bfloat16, dev)
    return NB, mp, _check_pool(pool, dev)


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
    over its segment's context (dead blocks: zeros). Split K/V only (the
    JAX package's fused gate needs that layout)."""
    T, H, D = q.shape
    L, P, page, M = pool.shape
    assert page == page_size and D == head_dim
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if not q.is_cuda:
        if T % block_seg.shape[0]:
            raise ValueError(
                f"{T} packed tokens do not split into {block_seg.shape[0]} blocks"
            )
        return attend_prefill_packed_fused_plain(
            q, pool, layer, k, v, block_tables, block_seg, block_qstart,
            total_lens, page_size, kv_heads, head_dim, scale, window, softcap,
        )
    dev = q.device
    NB, mp, fp8 = _packed_checks(q, pool, block_tables, block_seg,
                                 block_qstart, total_lens, kv_heads, True,
                                 None)
    _check("k", k, torch.bfloat16, dev, (T, kv_heads, D))
    _check("v", v, torch.bfloat16, dev, (T, kv_heads, D))
    G = H // kv_heads
    out = torch.empty_like(q)
    rc = _lib().chitu_attend_prefill_packed_fused(
        _ptr(q), _ptr(pool), _ptr(k), _ptr(v), _ptr(block_tables),
        _ptr(block_seg), _ptr(block_qstart), _ptr(total_lens), _ptr(out),
        T, NB, _rows_block(G, T // NB), int(layer), P, page, M, mp,
        kv_heads, G, D, float(scale), int(window), float(softcap), fp8,
        _stream(dev),
    )
    _raise_on(rc, "attend_prefill_packed_fused")
    _count("attend_prefill_packed_fused", pool, D, True)
    return out


def attend_prefill_packed(
    q: torch.Tensor,  # [T, H, D]
    pool: torch.Tensor,  # [L, P, page, M] (the slab's rows appended)
    layer: int,
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
    split_kv: bool = True,
    v_dim: Optional[int] = None,
) -> torch.Tensor:
    """-> out [T, H, v_dim or D]: every live block attends causally by
    absolute position over its segment's context, which the plain
    `append_prefill_packed` wrote before (dead blocks: zeros)."""
    T, H, D = q.shape
    L, P, page, M = pool.shape
    assert page == page_size and D == head_dim
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if not q.is_cuda:
        return attend_prefill_packed_plain(
            q, pool, layer, block_tables, block_seg, block_qstart,
            total_lens, page_size, kv_heads, head_dim, scale, window,
            softcap, split_kv, v_dim,
        )
    NB, mp, fp8 = _packed_checks(q, pool, block_tables, block_seg,
                                 block_qstart, total_lens, kv_heads,
                                 split_kv, v_dim)
    if not split_kv:
        out, rc = _latent(
            _PACKED, q, pool, layer, block_tables, None, 0, T, NB=NB,
            block_seg=block_seg, block_qstart=block_qstart,
            total_lens=total_lens, scale=scale, window=window,
            softcap=softcap,
        )
    else:
        G = H // kv_heads
        out = torch.empty_like(q)
        rc = _lib().chitu_attend_prefill_packed(
            _ptr(q), _ptr(pool), _ptr(block_tables), _ptr(block_seg),
            _ptr(block_qstart), _ptr(total_lens), _ptr(out), T, NB,
            _rows_block(G, T // NB), int(layer), P, page, M, mp, kv_heads,
            G, D, float(scale), int(window), float(softcap), fp8,
            _stream(q.device),
        )
    _raise_on(rc, "attend_prefill_packed")
    _count("attend_prefill_packed", pool, D, split_kv)
    return out
