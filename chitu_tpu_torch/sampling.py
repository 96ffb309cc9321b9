"""Device-resident sampling.

Counterpart of `chitu_tpu/sampling.py` (reference: chitu/executor.py:82-112,
chitu/utils.py:62-81): frequency penalty + greedy / temperature / top-k /
top-p, run on the device tensors of the step so decode windows feed
tokens back without a host round trip.

- Sampling is restricted to the top `MAX_K` logits (exact for greedy and
  top-k <= MAX_K, the standard approximation for top-p). The candidates
  come from an exact `torch.topk` (the JAX package uses the approximate
  top-k on large vocabularies).
- Frequency-penalty counts live in a device tensor [max_reqs, vocab]
  indexed by request slot and are updated IN PLACE.
- Randomness comes from an explicit `torch.Generator` (Gumbel-max over the
  candidates), so streams differ from `jax.random`'s; only the
  distribution is comparable.
"""

from __future__ import annotations

from typing import Optional

import torch

MAX_K = 64


def sample_tokens(
    logits: torch.Tensor,  # [B, V] f32
    generator: Optional[torch.Generator],
    temperature: torch.Tensor,  # [B] f32 (>0; 0 was coerced to greedy upstream)
    top_k: torch.Tensor,  # [B] i32 (<=0 -> no k limit; 1 -> greedy)
    top_p: torch.Tensor,  # [B] f32 (>=1 -> no p limit)
    greedy_all: bool = False,  # host-known: every row is greedy
) -> torch.Tensor:
    """Sample one token per row. Returns [B] int32."""
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if greedy_all:
        return greedy
    k_eff = min(MAX_K, V)
    vals, idx = torch.topk(logits, k_eff, dim=-1)  # [B, K] descending

    j = torch.arange(k_eff, device=logits.device)[None, :]
    kk = torch.where(
        top_k <= 0, torch.full_like(top_k, k_eff), torch.clamp(top_k, max=k_eff)
    )[:, None]
    keep_k = j < kk

    scaled = vals / torch.clamp(temperature, min=1e-6)[:, None]
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    scaled = torch.where(keep_k, scaled, neg_inf)

    # top-p on the truncated distribution: keep the smallest prefix whose
    # probability mass reaches top_p (always keep rank 0)
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < top_p[:, None]
    keep_p[:, 0] = True
    scaled = torch.where(keep_p, scaled, neg_inf)

    u = torch.rand(
        (B, k_eff), generator=generator, device=logits.device,
        dtype=torch.float32,
    )
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-10)))
    choice = torch.argmax(scaled + gumbel, dim=-1)
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    # greedy rows take the exact argmax (no noise)
    return torch.where(top_k == 1, greedy, sampled.to(torch.int32))


def apply_frequency_penalty(
    logits: torch.Tensor,  # [B, V]
    counts: torch.Tensor,  # [max_reqs, V] int32
    slots: torch.Tensor,  # [B] i32 (padding rows: out of range)
    penalty: torch.Tensor,  # [B] f32
) -> torch.Tensor:
    """logits - penalty * count (reference: executor.py:93-101). Slots out
    of range clamp to the last row, as the JAX gather clamps; padding rows
    carry penalty 0."""
    safe = torch.clamp(slots, 0, counts.shape[0] - 1).long()
    c = counts[safe].to(logits.dtype)
    return logits - penalty[:, None] * c


def update_counts(
    counts: torch.Tensor,  # [max_reqs, V] int32, updated IN PLACE
    slots: torch.Tensor,  # [B]
    tokens: torch.Tensor,  # [B]
    valid: Optional[torch.Tensor] = None,  # [B] bool — padded rows don't count
) -> torch.Tensor:
    """Add one to counts[slot, token] for each valid row (rows whose slot
    is out of range are dropped), in place; returns counts."""
    ok = (slots >= 0) & (slots < counts.shape[0])
    if valid is not None:
        ok = ok & valid
    safe = torch.clamp(slots, 0, counts.shape[0] - 1).long()
    counts.index_put_(
        (safe, tokens.long()), ok.to(counts.dtype), accumulate=True
    )
    return counts


def reset_slots(counts: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Zero freed slots' rows in place (called when requests finish)."""
    ok = slots[(slots >= 0) & (slots < counts.shape[0])].long()
    counts[ok] = 0
    return counts
