"""Ring attention: sequence-parallel prefill over the dp replicas.

Counterpart of `chitu_tpu/parallel/ring.py`. The JAX package shards a
prompt's token dim over the 'dp' mesh axis inside one `shard_map`, and
rotates the K/V slices with `ppermute` while an online-softmax
accumulator folds each incoming block (ring attention, Liu et al.). Here
each replica is a process that holds its slice of the prompt's tokens
through every layer: `ring_attention` takes the rank's query, key and
value slices, and in dp steps attends its queries against the slice it
holds (causal by absolute position, -1 = padding), then passes that
slice on to the next replica (`DPGroup.pass_on`: a two-rank broadcast a
link, keys, values and positions in one buffer) and takes the previous
replica's. `on_block` sees every slice as it passes, the rank's own
first: the model appends each into its (replicated) pool there.

The block step is plain PyTorch, a query tile at a time.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

NEG_INF = -1e30
# queries a tile of the block step ([KV, G, tile, S] f32 scores)
Q_TILE = 256


def _block_attention(q, k, v, pos_q, pos_k, m, l, acc):
    """One online-softmax step of every query tile against one held slice:
    q [T, KV, G, D] f32 (pre-scaled), k / v [S, KV, D], pos_q [T], pos_k
    [S]; m / l [KV, G, T, 1], acc [KV, G, T, D], updated in place."""
    kf, vf = k.float(), v.float()
    for t0 in range(0, q.shape[0], Q_TILE):
        sl = slice(t0, t0 + Q_TILE)
        pq = pos_q[sl]
        keep = ((pos_k[None, :] <= pq[:, None]) & (pos_k[None, :] >= 0)
                & (pq[:, None] >= 0))
        s = torch.einsum("tkgd,skd->kgts", q[sl], kf)
        s = torch.where(keep[None, None], s, s.new_tensor(NEG_INF))
        m_new = torch.maximum(m[:, :, sl], s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m[:, :, sl] - m_new)
        l[:, :, sl] = l[:, :, sl] * alpha + p.sum(-1, keepdim=True)
        acc[:, :, sl] = acc[:, :, sl] * alpha + torch.einsum("kgts,skd->kgtd",
                                                             p, vf)
        m[:, :, sl] = m_new


def _pack(k, v, pos):
    """Keys, values and positions of a slice in one buffer of k's dtype
    (the positions' int32 bits reinterpreted, never converted)."""
    return torch.cat([k.reshape(-1), v.reshape(-1),
                      pos.to(torch.int32).contiguous().view(k.dtype)])


def _unpack(buf, k_shape, v_shape):
    nk, nv = math.prod(k_shape), math.prod(v_shape)
    return (buf[:nk].view(k_shape), buf[nk:nk + nv].view(v_shape),
            buf[nk + nv:].view(torch.int32))


def ring_attention(
    q: torch.Tensor,  # [Tl, H, D] this rank's slice of the prompt
    k: torch.Tensor,  # [Tl, KV, D]
    v: torch.Tensor,  # [Tl, KV, D]
    pos: torch.Tensor,  # [Tl] absolute positions (-1 = padding)
    group=None,  # parallel.distributed.DPGroup (None: one replica)
    scale: Optional[float] = None,
    on_block: Optional[Callable] = None,
) -> torch.Tensor:
    """Causal GQA attention with the sequence dim sharded over the dp
    group -> out [Tl, H, D] in q's dtype, this rank's rows of the
    single-device oracle. `on_block(k, v, pos)` runs on every slice the
    rank holds, its own first."""
    T, H, D = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(T, KV, G, D).float() * scale
    m = torch.full((KV, G, T, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((KV, G, T, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((KV, G, T, D), dtype=torch.float32, device=q.device)
    n = group.size if group is not None else 1
    held = _pack(k.contiguous(), v.contiguous(), pos)
    incoming = torch.empty_like(held)
    for step in range(n):
        kc, vc, pc = _unpack(held, k.shape, v.shape)
        if on_block is not None:
            on_block(kc, vc, pc)
        _block_attention(qf, kc, vc, pos, pc, m, l, acc)
        if step + 1 < n:
            held, incoming = group.pass_on(held, incoming), held
    out = acc / l.clamp_min(1e-30)
    return out.permute(2, 0, 1, 3).reshape(T, H, D).to(q.dtype)
