"""Shared model building blocks (plain functions on tensors).

Counterpart of `chitu_tpu/models/common.py` (reference: chitu/models/
model.py): RMSNorm, rotary embedding in all three layouts (hf-llama
half-split, llama interleaved, glm4 partial — reference:
chitu/ops.py:94-326) with YaRN scaling, grouped-query attention, and the
paged-KV append/index helpers. The pool layout and the out-of-range drop
semantics are the JAX package's, so pool bytes compare directly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
# drop sentinel of the paged index helpers (int32 max, as in the JAX
# package's scatter mode='drop')
DROP = 2**31 - 1


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 accumulation (reference: models/model.py:29-78)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_tables(
    head_rot_dim: int,
    max_seq_len: int,
    theta: float,
    rope_scaling=None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [max_seq_len, rot_dim//2] in f32.

    Supports YaRN-style extension with correction range + mscale
    (reference: chitu/models/model_deepseek_v3.py:1353-1445).
    """
    half = head_rot_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=device)
    freqs = 1.0 / (theta ** (ar * 2.0 / head_rot_dim))
    mscale = 1.0
    if rope_scaling is not None and rope_scaling.kind == "yarn":
        factor = rope_scaling.factor
        orig = rope_scaling.original_max_position
        if max_seq_len > orig and factor > 1.0:
            def find_dim(num_rot: float) -> float:
                # dimension whose wavelength reaches num_rot full rotations
                # over the original context
                return (
                    head_rot_dim
                    * math.log(orig / (num_rot * 2 * math.pi))
                    / (2 * math.log(theta))
                )

            low = max(math.floor(find_dim(rope_scaling.beta_fast)), 0)
            high = min(math.ceil(find_dim(rope_scaling.beta_slow)), half - 1)
            # linear ramp over [low, high]: rng=0 keeps the original
            # freqs (extrapolation), rng=1 divides by factor (full
            # interpolation) — smooth = 1 - rng blends between them
            rng = torch.clamp((ar - low) / max(high - low, 1e-3), 0.0, 1.0)
            smooth = 1.0 - rng
            freqs = freqs / factor * (1.0 - smooth) + freqs * smooth

            def get_mscale(scale: float, m: float) -> float:
                if scale <= 1.0 or m == 0.0:
                    return 1.0
                return 0.1 * m * math.log(scale) + 1.0

            mscale = get_mscale(factor, rope_scaling.mscale) / get_mscale(
                factor, rope_scaling.mscale_all_dim
            )
    elif rope_scaling is not None and rope_scaling.kind == "linear":
        freqs = freqs / rope_scaling.factor

    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    ang = torch.outer(t, freqs)
    return torch.cos(ang) * mscale, torch.sin(ang) * mscale


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    layout: str = "hf-llama",
) -> torch.Tensor:
    """Rotate x: [..., T, H, D]. cos/sin: [T, R//2] where R = rotary dims.

    Layouts (reference: chitu/ops.py:94-326):
    - "hf-llama": half-split — pairs are (x[i], x[i + D/2])
    - "llama": interleaved — pairs are (x[2i], x[2i+1])
    - "glm4": partial (first half of D) + interleaved within that
    """
    dtype = x.dtype
    xf = x.float()
    d = x.shape[-1]
    r2 = cos.shape[-1]  # rotated half size
    cos_b = cos[..., :, None, :]  # [T, 1, R/2]
    sin_b = sin[..., :, None, :]

    if layout == "hf-llama":
        assert 2 * r2 == d
        x1, x2 = xf[..., :r2], xf[..., r2:]
        o1 = x1 * cos_b - x2 * sin_b
        o2 = x2 * cos_b + x1 * sin_b
        return torch.cat([o1, o2], dim=-1).to(dtype)

    if layout in ("llama", "glm4"):
        rot = 2 * r2
        xr, xp = xf[..., :rot], xf[..., rot:]
        x1 = xr[..., 0::2]
        x2 = xr[..., 1::2]
        o1 = x1 * cos_b - x2 * sin_b
        o2 = x2 * cos_b + x1 * sin_b
        out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
        if xp.shape[-1]:
            out = torch.cat([out, xp], dim=-1)
        return out.to(dtype)

    raise ValueError(f"unknown rotary layout {layout!r}")


# ---------------------------------------------------------------------------
# Attention (the plain path — the correctness oracle the CUDA kernels are
# held against, reference: attn_backend.py:24-164)
# ---------------------------------------------------------------------------


def grouped_attention(
    q: torch.Tensor,  # [T, H, Dh]
    k: torch.Tensor,  # [S, KV, Dh]
    v: torch.Tensor,  # [S, KV, Dv]
    mask: Optional[torch.Tensor],  # [T, S] bool (True = attend) or None
    scale: Optional[float] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """GQA/MQA attention with f32 softmax. Returns [T, H, Dv]."""
    T, H, Dh = q.shape
    S, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qg = q.reshape(T, KV, G, Dh).float()
    scores = torch.einsum("tkgd,skd->kgts", qg, k.float()) * scale
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    if mask is not None:
        scores = torch.where(
            mask[None, None, :, :], scores, scores.new_tensor(NEG_INF)
        )
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("kgts,skd->tkgd", p, v.float())
    return out.reshape(T, H, -1).to(q.dtype)


# ---------------------------------------------------------------------------
# Paged KV helpers (reference contract: cache_manager.py §2.2)
# ---------------------------------------------------------------------------


def paged_flat_index(
    block_table: torch.Tensor, pos: torch.Tensor, page_size: int
) -> torch.Tensor:
    """Flattened pool index for absolute position(s) `pos`.

    block_table: [..., max_pages] int32; pos: [...] int32.
    Out-of-range positions map to DROP, which paged_append skips.
    """
    page = torch.div(pos, page_size, rounding_mode="floor")
    off = pos % page_size
    mp = block_table.shape[-1]
    blk = torch.gather(
        block_table, -1, torch.clamp(page, max=mp - 1)[..., None].long()
    )[..., 0]
    idx = blk * page_size + off
    # -1 table entries AND positions past the table width both map to the
    # drop sentinel (a clamped gather would otherwise resolve an overflow
    # to the LAST column and silently overwrite that page's live KV)
    oob = (blk < 0) | (page >= mp)
    return torch.where(oob, torch.full_like(idx, DROP), idx).to(torch.int32)


def pad_kv_minor(kv_heads: int, head_dim: int, lane: int = 128) -> int:
    """Pool minor-dim size: KV*D padded up to a multiple of 128."""
    c = max(kv_heads, 1) * head_dim
    return (c + lane - 1) // lane * lane


def kv_pool_minor(kv_heads: int, head_dim: int, lane: int = 128) -> int:
    """GQA pool minor: a K half and a V half of KV*D each, padded to a
    multiple of 128 (the JAX pool's row width, so pools compare byte for
    byte)."""
    c = 2 * kv_heads * head_dim
    return (c + lane - 1) // lane * lane


def kv_encode(vals: torch.Tensor, pool_dtype: torch.dtype) -> torch.Tensor:
    """Encode KV rows for the pool. Only the bf16/f32 pools of this slice
    exist; the fp8 (int8-bits) pool waits for a later slice."""
    if pool_dtype == torch.int8:
        raise NotImplementedError(
            "kv_dtype=fp8 pools are not ported yet (ROADMAP queue A, slice 5)"
        )
    return vals.to(pool_dtype)


def kv_decode(x: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of kv_encode."""
    if x.dtype == torch.int8:
        raise NotImplementedError(
            "kv_dtype=fp8 pools are not ported yet (ROADMAP queue A, slice 5)"
        )
    return x if x.dtype == out_dtype else x.to(out_dtype)


def paged_append(
    pool: torch.Tensor,  # [L, num_pages, page, C] (the WHOLE stacked pool)
    layer: int,
    values: torch.Tensor,  # [N, KV, D] (or [N, C_valid])
    flat_idx: torch.Tensor,  # [N] int32 within one layer (DROP = skip)
) -> torch.Tensor:
    """Scatter one layer's new rows into the pool IN PLACE (the JAX
    version returns a new array; here the pool is updated where it lies)
    and return it. Rows whose index is DROP or past the layer's pages are
    skipped, as the JAX scatter's mode='drop' skips them."""
    L, P, page, C = pool.shape
    N = values.shape[0]
    vals = values.reshape(N, -1)
    if vals.shape[-1] < C:
        vals = torch.nn.functional.pad(vals, (0, C - vals.shape[-1]))
    keep = (flat_idx >= 0) & (flat_idx < P * page)
    idx = (flat_idx[keep].long() + layer * (P * page))
    flat = pool.view(L * P * page, C)
    flat[idx] = kv_encode(vals[keep], pool.dtype)
    return pool
