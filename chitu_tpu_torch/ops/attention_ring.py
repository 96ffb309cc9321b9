"""The ring KV pool: the paged pool's pages striped over the dp replicas.

Counterpart of `chitu_tpu/ops/attention_ring.py`. Global page g lives on
replica g // P_local at local index g % P_local (P_local = P / dp, the
pages a rank's arrays hold): the JAX package's contiguous bank split of
the page dim under `shard_map`. Appends are owner-writes: a rank writes
through its local table (`ring_local_block_table`), whose entries for
other ranks' pages are -1, so the plain appends drop those rows.
Attention is flash decoding across ranks: each rank computes the
online-softmax partial (m, l, acc) over its own pages, and the partials
combine over the dp group (`_combine`: one max and one sum all-reduce,
the JAX package's pmax and psums). The JAX functions take a mesh and an
axis name; these take the dp group (`parallel.distributed.DPGroup`) and,
for a test that runs every stripe in one process, `idx` (the stripe)
with no group, combined by `combine_parts`.

Under tp each rank's pool holds its whole KV heads; under pp a stage's
pool holds only its own layers, so the combine runs over the dp group of
the same (stage, TP index) and never over the stages.

On the card the decode of the split layout (`attend_decode_fused_ring`)
runs B1 in its partials mode on the rank's local table (the masked-page
`decode_kernel`, `ops/attention_kernels.attend_decode_partials`), gathers
the dp ranks' S split partials over the group and merges the dp x S
splits with `decode_merge_kernel`. The latent row
(DeepSeek's absorb path) and the prefill chunk's attention are plain
PyTorch, in query tiles; a chunk that starts its sequence attends its own
fresh rows on every rank with no exchange (`attend_prefill_fresh`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from chitu_tpu_torch.models.common import NEG_INF
from chitu_tpu_torch.ops import attention as plain

# queries a tile of the plain prefill partial: its scores are
# [tile, KV, G, S] f32, 128 MiB at 32 heads over 8,192 keys
Q_TILE = 128


def ring_local_block_table(bt: torch.Tensor, p_local: int, idx: int
                           ) -> torch.Tensor:
    """Global block table -> replica `idx`'s local table (-1 = not owned).
    Ownership is the contiguous bank split: global page g lives on
    replica g // p_local."""
    owned = (bt >= 0) & (torch.div(bt, p_local, rounding_mode="floor") == idx)
    return torch.where(owned, bt % p_local, torch.full_like(bt, -1))


def _idx(group, idx):
    return idx if idx is not None else (group.rank if group is not None else 0)


def _page_mask(bt_local: torch.Tensor, S: int, page_size: int) -> torch.Tensor:
    """[B, S] bool: the key column is backed by an owned page."""
    return (bt_local >= 0).repeat_interleave(page_size, dim=1)[:, :S]


def _partial_attention(q, k, v, mask, kv_heads: int, scale: float,
                       softcap: float):
    """Grouped attention partial with online-softmax stats: q [B, H, D],
    k / v [B, S, KV, D], mask [B, S] -> (m [B, KV, G], l [B, KV, G],
    acc [B, KV, G, D]), f32; m = NEG_INF where nothing is owned (the
    flash-decoding split-KV contract, reference:
    chitu/triton_decode_attention.py:20-291)."""
    B, H, D = q.shape
    G = H // kv_heads
    qg = q.reshape(B, kv_heads, G, D).float() * scale
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    keep = mask[:, None, None, :]
    scores = torch.where(keep, scores, scores.new_tensor(NEG_INF))
    m = scores.amax(-1)
    p = torch.where(keep, torch.exp(scores - m[..., None]), scores.new_zeros(()))
    return m, p.sum(-1), torch.einsum("bkgs,bskd->bkgd", p, v.float())


def _combine(m, l, acc, group):
    """The cross-rank LSE reduce of the partials (m, l: [..., ] acc:
    [..., D]) over the dp group -> the normalized output [..., D] f32 on
    every rank; without a group, this rank's partial alone."""
    m_g = m if group is None else group.max_(m.clone())
    corr = torch.where(m > NEG_INF / 2, torch.exp(m - m_g), torch.zeros_like(m))
    la = torch.cat([(l * corr)[..., None], acc * corr[..., None]], dim=-1)
    if group is not None:
        la = group.sum_(la.contiguous())
    return la[..., 1:] / la[..., :1].clamp_min(1e-30)


def combine_parts(parts):
    """`_combine` of every stripe's partial held in one process: parts a
    list of (m, l, acc), one a stripe -> the output [..., D] f32, as the
    pmax and psums over the ring give it."""
    m_g = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(m_g)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        corr = torch.where(m > NEG_INF / 2, torch.exp(m - m_g), torch.zeros_like(m))
        L = L + l * corr
        A = A + acc * corr[..., None]
    return A / L.clamp_min(1e-30)[..., None]


# ---------------------------------------------------------------------------
# appends: owner-writes through the local table
# ---------------------------------------------------------------------------


def append_decode_ring(
    pool: torch.Tensor,  # [L, P_local, page, M], updated in place
    layer: int,
    k: torch.Tensor,  # [B, KV, D] (merged latent: the row)
    v: Optional[torch.Tensor],
    block_tables: torch.Tensor,  # [B, mp] GLOBAL page ids
    seq_lens: torch.Tensor,  # [B]
    valid: torch.Tensor,  # [B] bool
    page_size: int,
    group=None,
    idx: Optional[int] = None,
) -> torch.Tensor:
    lbt = ring_local_block_table(block_tables, pool.shape[1], _idx(group, idx))
    return plain.append_decode(pool, layer, k, v, lbt, seq_lens, valid,
                               page_size)


def append_prefill_ring(
    pool: torch.Tensor,
    layer: int,
    k: torch.Tensor,  # [T, KV, D]
    v: Optional[torch.Tensor],
    block_table: torch.Tensor,  # [mp] GLOBAL
    q_pos: torch.Tensor,  # [T]
    valid_len: int,
    page_size: int,
    group=None,
    idx: Optional[int] = None,
) -> torch.Tensor:
    lbt = ring_local_block_table(block_table, pool.shape[1], _idx(group, idx))
    return plain.append_prefill(pool, layer, k, v, lbt, q_pos, valid_len,
                                page_size)


# ---------------------------------------------------------------------------
# attention: a rank's partial over its own pages, combined over the group
# ---------------------------------------------------------------------------


def decode_ring_partials(q, pool, layer, block_tables, seq_lens, page_size,
                         kv_heads, head_dim, split_kv=True, scale=None,
                         window=0, softcap=0.0, idx=0):
    """Replica `idx`'s partial of the ring decode (the JAX `local` body):
    its pages of each row's context [0, seq_lens] -> (m, l, acc)."""
    lbt = ring_local_block_table(block_tables, pool.shape[1], idx)
    k, v = plain.unpack_pool(plain._gather(pool, layer, lbt), kv_heads,
                             head_dim, split_kv)
    S = k.shape[1]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = (cols <= seq_lens[:, None]) & _page_mask(lbt, S, page_size)
    if window > 0:
        mask = mask & (cols > seq_lens[:, None] - window)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _partial_attention(q, k, v, mask, kv_heads, scale, softcap)


def attend_decode_ring(
    q: torch.Tensor,  # [B, H, D]
    pool: torch.Tensor,  # [L, P_local, page, M]
    layer: int,
    block_tables: torch.Tensor,  # [B, mp] GLOBAL
    seq_lens: torch.Tensor,  # [B] context EXCLUDING the new token
    page_size: int,
    kv_heads: int,
    head_dim: int,
    split_kv: bool = True,
    scale: Optional[float] = None,
    group=None,
    window: int = 0,
    softcap: float = 0.0,
    idx: Optional[int] = None,
) -> torch.Tensor:
    """-> out [B, H, D] in q's dtype: every rank's partial over its own
    pages, the new token's (appended before) included, combined over the
    group."""
    B, H, D = q.shape
    m, l, acc = decode_ring_partials(
        q, pool, layer, block_tables, seq_lens, page_size, kv_heads,
        head_dim, split_kv, scale, window, softcap, _idx(group, idx))
    return _combine(m, l, acc, group).reshape(B, H, -1).to(q.dtype)


def _tiled_partials(q, k, v, kpos, live, q_pos, kv_heads, scale, window,
                    softcap, q_tile):
    """Partials of queries q [T, H, D] at positions q_pos against keys k /
    v [S, KV, D] at positions kpos [S] where `live` [S]: key s counts for
    query t when kpos[s] <= q_pos[t] (and within the window) -> (m [T,
    KV, G], l, acc [T, KV, G, D]), a query tile at a time (a 4,096-token
    chunk never holds all its scores at once)."""
    k, v = k.float(), v.float()
    T, H, D = q.shape
    G = H // kv_heads
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    cols = kpos[None, :]
    ms, ls, accs = [], [], []
    for t0 in range(0, T, q_tile):
        qp = q_pos[t0:t0 + q_tile, None]
        mask = live[None, :] & (cols <= qp)
        if window > 0:
            mask = mask & (cols > qp - window)
        qg = q[t0:t0 + q_tile].reshape(-1, kv_heads, G, D).float() * scale
        s = torch.einsum("tkgd,skd->tkgs", qg, k)
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        keep = mask[:, None, None, :]
        s = torch.where(keep, s, s.new_tensor(NEG_INF))
        m = s.amax(-1)
        p = torch.where(keep, torch.exp(s - m[..., None]), s.new_zeros(()))
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("tkgs,skd->tkgd", p, v))
    return torch.cat(ms), torch.cat(ls), torch.cat(accs)


def prefill_ring_partials(q, pool, layer, block_table, q_pos, total_len,
                          page_size, kv_heads, head_dim, split_kv=True,
                          scale=None, window=0, softcap=0.0, idx=0,
                          q_tile=Q_TILE):
    """Replica `idx`'s partial of a prefill chunk's attention against the
    ring pool: query t attends the owned keys at positions <= q_pos[t]
    and < total_len -> (m [T, KV, G], l, acc [T, KV, G, D])."""
    lbt = ring_local_block_table(block_table, pool.shape[1], idx)
    k, v = plain.unpack_pool(plain._gather(pool, layer, lbt[None]), kv_heads,
                             head_dim, split_kv)
    S = k.shape[1]
    kpos = torch.arange(S, device=q.device)
    live = (kpos < int(total_len)) & _page_mask(lbt[None], S, page_size)[0]
    return _tiled_partials(q, k[0], v[0], kpos, live, q_pos, kv_heads, scale,
                           window, softcap, q_tile)


def attend_prefill_fresh(q, k, v, q_pos, valid_len, pool_dtype, scale=None,
                         window=0, softcap=0.0, v_dim=None, q_tile=Q_TILE):
    """The ring KV pool's prefill of a chunk that starts a sequence
    (position 0): its context is the chunk itself, whose K/V every rank
    holds whole (the batch is replicated), so each rank attends the
    chunk's own rows, read as the pool would hold them (through the
    pool's encoding), with no exchange -> out [T, H, v_dim or D] in q's
    dtype: `attend_prefill_ring`'s result on the rows the chunk appended.
    k / v [T, KV, D] (the latent row: k [T, 1, D], v None)."""
    from chitu_tpu_torch.models.common import kv_decode, kv_encode

    def as_pooled(x):
        return kv_decode(kv_encode(x, pool_dtype))

    T = q.shape[0]
    k = as_pooled(k)
    v = k if v is None else as_pooled(v)
    kpos = torch.arange(T, device=q.device)
    m, l, acc = _tiled_partials(q, k, v, kpos, kpos < int(valid_len), q_pos,
                                k.shape[1], scale, window, softcap, q_tile)
    out = _combine(m, l, acc, None).reshape(T, q.shape[1], -1).to(q.dtype)
    return out if v_dim is None else out[..., :v_dim]


def attend_prefill_ring(
    q: torch.Tensor,  # [T, H, D]
    pool: torch.Tensor,
    layer: int,
    block_table: torch.Tensor,  # [mp] GLOBAL
    q_pos: torch.Tensor,  # [T]
    total_len: int,
    page_size: int,
    kv_heads: int,
    head_dim: int,
    split_kv: bool = True,
    scale: Optional[float] = None,
    group=None,
    window: int = 0,
    softcap: float = 0.0,
    v_dim: Optional[int] = None,
    idx: Optional[int] = None,
) -> torch.Tensor:
    """Chunk prefill attention against the ring pool (a chunk reads the
    earlier chunks' pages from their owners) -> out [T, H, v_dim or D]
    in q's dtype."""
    T, H, D = q.shape
    m, l, acc = prefill_ring_partials(
        q, pool, layer, block_table, q_pos, total_len, page_size, kv_heads,
        head_dim, split_kv, scale, window, softcap, _idx(group, idx))
    out = _combine(m, l, acc, group).reshape(T, H, -1).to(q.dtype)
    return out if v_dim is None else out[..., :v_dim]


def attend_decode_fused_ring(
    attn,  # the route's namespace: ops.attention_kernels or its PLAIN
    q: torch.Tensor,  # [B, H, D]
    pool: torch.Tensor,  # [L, P_local, page, M], updated in place
    layer: int,
    k: torch.Tensor,  # [B, KV, D] new token K (merged: the latent row)
    v: Optional[torch.Tensor],
    block_tables: torch.Tensor,  # [B, mp] GLOBAL
    seq_lens: torch.Tensor,  # [B]
    valid: torch.Tensor,  # [B] bool
    page_size: int,
    kv_heads: int,
    head_dim: int,
    scale: Optional[float] = None,
    window: int = 0,
    softcap: float = 0.0,
    split_kv: bool = True,
    v_dim: Optional[int] = None,
    group=None,
) -> torch.Tensor:
    """B1 on the ring pool -> out [B, H, v_dim or D], the same on every
    rank of the group. Split layout: B1's partials mode on the rank's
    local table (its in-kernel append writes only the rank's own pages),
    every rank's split partials gathered over the group and merged as
    dp x S splits by the decode merge (`attn.decode_merge`). The latent
    row: the plain owner-write append and `attend_decode_ring`."""
    if not split_kv:
        append_decode_ring(pool, layer, k, v, block_tables, seq_lens, valid,
                           page_size, group)
        out = attend_decode_ring(q, pool, layer, block_tables, seq_lens,
                                 page_size, kv_heads, head_dim, False, scale,
                                 group, window, softcap)
        return out if v_dim is None else out[..., :v_dim]
    lbt = ring_local_block_table(block_tables, pool.shape[1], _idx(group, None))
    part_o, part_ml = attn.attend_decode_partials(
        q, pool, layer, k, v, lbt, seq_lens, valid, page_size, kv_heads,
        head_dim, scale, window, softcap, fused=True)
    if group is not None:
        B, KV, S, G, D = part_o.shape
        both = group.gather(torch.cat([part_o, part_ml], dim=-1))
        # [dp, B, KV, S, G, D + 2] -> rank r's split s as split r * S + s
        both = both.permute(1, 2, 0, 3, 4, 5).reshape(B, KV, -1, G, D + 2)
        part_o = both[..., :D].contiguous()
        part_ml = both[..., D:].contiguous()
    return attn.decode_merge(part_o, part_ml, q.dtype)
