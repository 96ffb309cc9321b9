"""chitu_tpu_torch/sampling.py against chitu_tpu/sampling.py.

Greedy picks, penalties and count updates must match exactly (penalties
and counts are small powers of two, so products are exact whether or not
a backend fuses the multiply-subtract). jax.random and torch draw
different streams, so stochastic sampling is compared by support and by
frequency: over 4000 seeded draws each side's empirical distribution is
within 0.04 (absolute, per token) of the top-k/top-p-truncated softmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu import sampling as js
from chitu_tpu_torch import sampling as ts

INT_MAX = np.iinfo(np.int32).max


def _logits(B, V, seed=0):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 3


def test_greedy_matches():
    lg = _logits(6, 300)
    one = np.ones(6, np.float32)
    k1 = np.ones(6, np.int32)
    want = js.sample_tokens(
        jnp.asarray(lg), jax.random.PRNGKey(0), jnp.asarray(one),
        jnp.asarray(k1), jnp.asarray(one), greedy_all=True,
    )
    g = torch.Generator().manual_seed(0)
    for greedy_all in (True, False):
        got = ts.sample_tokens(
            torch.from_numpy(lg), g, torch.from_numpy(one),
            torch.from_numpy(k1), torch.from_numpy(one), greedy_all=greedy_all,
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32


def test_frequency_penalty_exact():
    lg = _logits(4, 50, 1)
    counts = np.random.default_rng(2).integers(0, 4, (3, 50)).astype(np.int32)
    slots = np.array([2, 0, INT_MAX, 1], np.int32)  # padded row: slot INT_MAX
    pens = np.array([0.5, 0.25, 0.0, 2.0], np.float32)
    want = js.apply_frequency_penalty(
        jnp.asarray(lg), jnp.asarray(counts), jnp.asarray(slots), jnp.asarray(pens)
    )
    got = ts.apply_frequency_penalty(
        *(torch.from_numpy(a) for a in (lg, counts, slots, pens))
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_update_and_reset_counts_exact():
    counts = np.zeros((3, 20), np.int32)
    slots = np.array([0, 2, 0, INT_MAX, 1], np.int32)
    toks = np.array([5, 7, 5, 3, 19], np.int32)
    valid = np.array([True, True, True, False, False])
    want = js.update_counts(
        jnp.asarray(counts), jnp.asarray(slots), jnp.asarray(toks),
        jnp.asarray(valid),
    )
    tcounts = torch.from_numpy(counts.copy())
    got = ts.update_counts(
        tcounts, *(torch.from_numpy(a) for a in (slots, toks, valid))
    )
    assert got.data_ptr() == tcounts.data_ptr()  # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    freed = np.array([2, INT_MAX], np.int32)
    want = js.reset_slots(want, jnp.asarray(freed))
    got = ts.reset_slots(got, torch.from_numpy(freed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _truncated_probs(row, temp, top_k, top_p, max_k=64):
    """The truncated distribution both samplers are specified to draw
    from: top MAX_K, then top_k, then the top_p prefix, renormalized."""
    order = np.argsort(-row, kind="stable")[: min(max_k, row.size)]
    vals = row[order] / temp
    k = len(order) if top_k <= 0 else min(top_k, len(order))
    vals = vals[:k]
    p = np.exp(vals - vals.max())
    p /= p.sum()
    keep = (np.cumsum(p) - p) < top_p
    keep[0] = True
    p = np.where(keep, p, 0.0)
    out = np.zeros(row.size)
    out[order[:k]] = p / p.sum()
    return out


@pytest.mark.parametrize(
    "temp,top_k,top_p", [(1.0, 8, 1.0), (0.7, -1, 0.8), (1.3, 16, 0.9)]
)
def test_stochastic_support_and_frequencies(temp, top_k, top_p):
    N, V = 4000, 100
    row = _logits(1, V, 3)[0] / 2
    want = _truncated_probs(row, temp, top_k, top_p)
    lg = np.repeat(row[None], N, axis=0)
    temps = np.full(N, temp, np.float32)
    tks = np.full(N, top_k, np.int32)
    tps = np.full(N, top_p, np.float32)
    g = torch.Generator().manual_seed(0)
    got_t = ts.sample_tokens(
        torch.from_numpy(lg), g, torch.from_numpy(temps),
        torch.from_numpy(tks), torch.from_numpy(tps),
    ).numpy()
    got_j = np.asarray(
        js.sample_tokens(
            jnp.asarray(lg), jax.random.PRNGKey(0), jnp.asarray(temps),
            jnp.asarray(tks), jnp.asarray(tps),
        )
    )
    support = set(np.nonzero(want)[0])
    for got in (got_t, got_j):
        assert set(got.tolist()) <= support
        freq = np.bincount(got, minlength=V) / N
        np.testing.assert_allclose(freq, want, atol=0.04)
    # both samplers reach every token the truncation keeps with mass >= 2%
    common = {t for t in support if want[t] >= 0.02}
    assert common <= set(got_t.tolist()) and common <= set(got_j.tolist())
