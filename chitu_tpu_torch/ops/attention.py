"""Attention over the paged KV pool: the plain PyTorch path.

Counterpart of `chitu_tpu/ops/attention.py` (reference: chitu/
attn_backend.py:24-164, the RefAttnBackend equivalent at :246-501):
append via indexed writes, gather pages, masked grouped attention in f32.
These functions are the port's plain versions — the CPU path of the
kernel wrappers in `ops/attention_kernels.py`, and what the CUDA kernels
are held against.

KV pool layouts, as in the JAX package, [L, num_pages, page, M]:
- split K/V (`split_kv=True`, GQA/MHA models): M = pad128(2*KV*D) and
  K-half-then-V-half rows [K_0..K_{KV-1} V_0..V_{KV-1} | pad];
- the merged latent row (`split_kv=False`, MLA absorb): M = pad128(kv_dim)
  and rows [c_kv | k_pe | pad] where K and V are the same row (one KV
  "head" shared by every query head).
Appends update the pool IN PLACE and return it (the JAX functions return a
new pool).

Causal alignment is bottom-right: query token i of a chunk starting at
absolute position p attends to absolute positions <= p+i
(reference: attn_backend.py:88-101).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from chitu_tpu_torch.models.common import (
    DROP,
    NEG_INF,
    grouped_attention,
    kv_decode,
    paged_append,
    paged_flat_index,
)


def pack_kv(
    k: torch.Tensor, v: Optional[torch.Tensor], minor: int
) -> torch.Tensor:
    """[N, KV, D] k and v -> [N, minor] page-row values:
    [K_0..K_{KV-1} V_0..V_{KV-1} | pad]; merged latent rows (v=None):
    [k_flat | pad]."""
    N = k.shape[0]
    if v is None:
        flat = k.reshape(N, -1)
    else:
        flat = torch.cat([k.reshape(N, -1), v.reshape(N, -1)], dim=-1)
    if flat.shape[-1] < minor:
        flat = torch.nn.functional.pad(flat, (0, minor - flat.shape[-1]))
    return flat


def unpack_pool(
    gathered: torch.Tensor, kv_heads: int, head_dim: int,
    split_kv: bool = True,
):
    """[B, S, M] pool rows -> (k [B, S, KV, D], v [B, S, KV, D]) in bf16,
    as the JAX oracle reads the pool (kv_decode's default); the inverse
    of pack_kv. Merged latent rows (`split_kv=False`) give (k, k)."""
    gathered = kv_decode(gathered)
    B, S, M = gathered.shape
    n = kv_heads * head_dim
    k = gathered[..., :n].reshape(B, S, kv_heads, head_dim)
    if not split_kv:
        return k, k
    v = gathered[..., n : 2 * n].reshape(B, S, kv_heads, head_dim)
    return k, v


def _gather(pool: torch.Tensor, layer: int, block_table: torch.Tensor):
    """[B, mp] table -> [B, mp*page, M] rows of one layer (-1 entries read
    page 0, whose columns the callers mask out by position)."""
    L, P, page, M = pool.shape
    safe = torch.clamp(block_table, min=0).long()
    out = pool[layer][safe]  # [B, mp, page, M]
    B, MP = block_table.shape
    return out.reshape(B, MP * page, M)


def append_prefill(
    pool: torch.Tensor,  # [L, P, page, M] (whole stacked pool)
    layer: int,
    k: torch.Tensor,  # [T, KV, D]
    v: Optional[torch.Tensor],  # None: merged latent rows
    block_table: torch.Tensor,  # [mp] int32
    q_pos: torch.Tensor,  # [T] absolute positions
    valid_len: int,
    page_size: int,
) -> torch.Tensor:
    T = k.shape[0]
    ar = torch.arange(T, device=k.device)
    pos = torch.where(ar < valid_len, q_pos, torch.full_like(q_pos, -1))
    bt = block_table[None, :].expand(T, block_table.shape[0])
    flat = paged_flat_index(bt, torch.clamp(pos, min=0), page_size)
    flat = torch.where(pos >= 0, flat, torch.full_like(flat, DROP))
    return paged_append(pool, layer, pack_kv(k, v, pool.shape[-1]), flat)


def append_decode(
    pool: torch.Tensor,  # [L, P, page, M]
    layer: int,
    k: torch.Tensor,  # [B, KV, D]
    v: Optional[torch.Tensor],  # None: merged latent rows
    block_tables: torch.Tensor,  # [B, mp]
    seq_lens: torch.Tensor,  # [B]
    valid: torch.Tensor,  # [B] bool
    page_size: int,
) -> torch.Tensor:
    flat = paged_flat_index(block_tables, seq_lens, page_size)
    flat = torch.where(valid, flat, torch.full_like(flat, DROP))
    return paged_append(pool, layer, pack_kv(k, v, pool.shape[-1]), flat)


def append_prefill_packed(
    pool: torch.Tensor,  # [L, P, page, M]
    layer: int,
    k: torch.Tensor,  # [T, KV, D] packed tokens
    v: Optional[torch.Tensor],  # None: merged latent rows
    block_tables: torch.Tensor,  # [R, mp]
    seg_ids: torch.Tensor,  # [T] int32 (-1 = padding token)
    pos: torch.Tensor,  # [T] absolute position within its sequence
    page_size: int,
) -> torch.Tensor:
    """Packed-varlen append: each token writes into its own segment's
    pages (reference VarLens contract: chitu/utils.py:84-100)."""
    bt = block_tables[torch.clamp(seg_ids, min=0).long()]  # [T, mp]
    flat = paged_flat_index(bt, torch.clamp(pos, min=0), page_size)
    keep = (seg_ids >= 0) & (pos >= 0)
    flat = torch.where(keep, flat, torch.full_like(flat, DROP))
    return paged_append(pool, layer, pack_kv(k, v, pool.shape[-1]), flat)


def attend_prefill(
    q: torch.Tensor,  # [T, H, D]
    pool: torch.Tensor,  # [L, P, page, M]
    layer: int,
    block_table: torch.Tensor,  # [mp]
    q_pos: torch.Tensor,  # [T]
    total_len: int,
    page_size: int,
    kv_heads: int,
    head_dim: int,
    scale: Optional[float] = None,
    window: int = 0,
    softcap: float = 0.0,
    split_kv: bool = True,
) -> torch.Tensor:
    """Chunk attention against the paged context (append must precede)."""
    gathered = _gather(pool, layer, block_table[None])
    k, v = unpack_pool(gathered, kv_heads, head_dim, split_kv)
    S = k.shape[1]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = (cols <= q_pos[:, None]) & (cols < total_len)
    if window > 0:
        mask = mask & (cols > q_pos[:, None] - window)
    return grouped_attention(q, k[0], v[0], mask, scale=scale, softcap=softcap)


# f32 elements of one token chunk's gathered K (and V) in the packed
# oracle: the tokens go in chunks so that a wide pool row (DeepSeek's dense
# MLA: 128 heads of 192) over a long table stays within memory
_ORACLE_CHUNK_ELEMS = 1 << 28


def _oracle_prefill_packed(
    q, pool, layer, block_tables, seg_ids, pos, total_lens,
    kv_heads, head_dim, scale=None, window=0, softcap=0.0, split_kv=True,
):
    gathered = _gather(pool, layer, block_tables)  # [R, S, M]
    k, v = unpack_pool(gathered, kv_heads, head_dim, split_kv)
    seg_safe = torch.clamp(seg_ids, min=0).long()
    T, H, D = q.shape
    S = k.shape[1]
    G = H // kv_heads
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    spos = torch.arange(S, device=q.device)[None, :]
    mask = (
        (spos <= pos[:, None])
        & (spos < total_lens[seg_safe][:, None])
        & (seg_ids >= 0)[:, None]
    )
    if window > 0:
        mask = mask & (spos > pos[:, None] - window)
    qg = q.reshape(T, kv_heads, G, D).float() * scale
    step = max(1, _ORACLE_CHUNK_ELEMS // max(S * kv_heads * D, 1))
    outs = []
    for t0 in range(0, T, step):
        sl = slice(t0, t0 + step)
        kt = k[seg_safe[sl]].float()  # [t, S, KV, D]
        scores = torch.einsum("tkgd,tskd->tkgs", qg[sl], kt)
        del kt
        if softcap > 0.0:
            scores = torch.tanh(scores / softcap) * softcap
        scores = torch.where(
            mask[sl, None, None, :], scores, scores.new_tensor(NEG_INF)
        )
        p = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("tkgs,tskd->tkgd", p, v[seg_safe[sl]].float()))
    return torch.cat(outs).reshape(T, H, D).to(q.dtype)


def attend_prefill_packed(
    q: torch.Tensor,  # [T, H, D]
    pool: torch.Tensor,
    layer: int,
    block_tables: torch.Tensor,  # [R, mp]
    seg_ids: torch.Tensor,  # [T]
    pos: torch.Tensor,  # [T]
    total_lens: torch.Tensor,  # [R]
    page_size: int,
    kv_heads: int,
    head_dim: int,
    scale: Optional[float] = None,
    window: int = 0,
    softcap: float = 0.0,
    split_kv: bool = True,
) -> torch.Tensor:
    """R ragged prompts' chunk attention in one call (reference packed
    varlen prefill: chitu/utils.py:84-100, executor.py:118-131)."""
    return _oracle_prefill_packed(
        q, pool, layer, block_tables, seg_ids, pos, total_lens,
        kv_heads, head_dim, scale, window, softcap, split_kv,
    )


def attend_decode(
    q: torch.Tensor,  # [B, H, D]
    pool: torch.Tensor,  # [L, P, page, M]
    layer: int,
    block_tables: torch.Tensor,  # [B, mp]
    seq_lens: torch.Tensor,  # [B] context EXCLUDING the new token
    page_size: int,
    kv_heads: int,
    head_dim: int,
    scale: Optional[float] = None,
    window: int = 0,
    softcap: float = 0.0,
    split_kv: bool = True,
) -> torch.Tensor:
    """One-token decode attention (new token's K/V already appended)."""
    gathered = _gather(pool, layer, block_tables)
    k, v = unpack_pool(gathered, kv_heads, head_dim, split_kv)
    S = k.shape[1]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = cols <= seq_lens[:, None]
    if window > 0:
        mask = mask & (cols > seq_lens[:, None] - window)
    # grouped_attention per row, batched: [B, KV, G, S] scores
    B, H, D = q.shape
    G = H // kv_heads
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, kv_heads, G, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(
        mask[:, None, None, :], scores, scores.new_tensor(NEG_INF)
    )
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(B, H, -1).to(q.dtype)
