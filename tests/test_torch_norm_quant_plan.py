"""The activation quantizers' kernel (`csrc/norm_quant.cu`,
`norm_quant_kernel`: B11 `rms_norm_quant`, B12 `quant_acts`) planned and
partitioned on the CPU.

`acts_plan` (`chitu_tpu_torch/ops/norm_quant.py`), a function of shapes
alone, is walked here as the kernel walks it: clusters over row groups
grid-stride, each rank a slice of `slice` 16-byte vectors, a slot of
`threads` threads with `vecs` vectors each, and rank 0's head and tail
scalars around the vector body (the head runs to x's first 16-byte
boundary in the row, so each byte offset of x moves it). Every element
must be taken exactly once.

The kernel's arithmetic on that partition (each rank's partial sum of
squares and amax, folded in rank order; the scale as amax times the f32
reciprocal of 127; a true f32 division per element) is emulated in torch
and held against the plain versions and against the JAX package's
`rms_norm_quant` (Pallas, interpret mode) and `quant_acts`: scales within
1e-6 relative (B11's sum of squares runs in another order), int8 values
at most 1 apart on the few ties a last-bit difference of the scale flips
(the allowance of tests/test_torch_quant.py). B12's scales equal the JAX
package's exactly: XLA compiles the TPU kernel's `amax / 127.0` into the
same product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.ops import pallas_norm_quant as jnq
from chitu_tpu_torch.config import list_model_cards, load_model_card
from chitu_tpu_torch.ops import norm_quant as nq

SMS = 132  # an H100 SXM's SMs
ODD = [1, 96, 1000, 4100, 14336]
OFFSETS = [0, 2, 6, 14]  # x's bytes past a 16-byte boundary


def card_widths():
    """The row widths the quantizers meet on every model card: the hidden
    size (B11), the attention output feeding `wo` and the FFN widths
    (B12)."""
    ws = set()
    for name in list_model_cards():
        a = load_model_card(name)
        ws |= {a.dim, a.n_heads * a.head_dim_()}
        if a.mla is not None:
            ws.add(a.n_heads * a.mla.v_head_dim)
        if a.inter_dim:
            ws.add(a.inter_dim)
        if a.moe is not None and a.moe.moe_inter_dim:
            ws.add(a.moe.moe_inter_dim)
    return sorted(ws)


WIDTHS = sorted(set(card_widths()) | set(ODD))


def walk(plan, T, D, x_off):
    """-> (count [T, D] of how often the kernel takes each element, the
    cluster rank that takes it), walking the plan as `norm_quant_kernel`
    does."""
    count = np.zeros((T, D), np.int32)
    rank_of = np.full((T, D), -1, np.int32)
    clusters = plan.grid // plan.cluster
    groups = -(-T // plan.rows)
    t = np.arange(plan.threads)[:, None]
    k = np.arange(plan.vecs)[None, :]
    e = np.arange(8)
    for cid in range(clusters):
        for g in range(cid, groups, clusters):
            for slot in range(plan.rows):
                row = g * plan.rows + slot
                if row >= T:
                    continue
                addr = x_off + 2 * row * D
                head = min(D, ((16 - addr % 16) % 16) // 2)
                nvec = (D - head) // 8
                tail = D - head - 8 * nvec
                for rank in range(plan.cluster):
                    v0 = rank * plan.slice
                    v = (v0 + t + k * plan.threads).ravel()
                    v = v[v < min(nvec, v0 + plan.slice)]
                    cols = (head + 8 * v[:, None] + e[None, :]).ravel()
                    if rank == 0:
                        ts = np.arange(plan.threads)
                        cols = np.concatenate([
                            cols, ts[ts < head], head + 8 * nvec + ts[ts < tail]])
                    np.add.at(count[row], cols, 1)
                    rank_of[row, cols] = rank
    return count, rank_of


def check_plan(plan):
    assert 1 <= plan.cluster <= nq.MAX_CLUSTER
    assert plan.threads % 32 == 0 and plan.threads >= 32
    assert 1 <= plan.rows and plan.rows * plan.threads <= nq.MAX_THREADS
    assert plan.vecs in nq.VECS
    assert plan.threads * plan.vecs >= plan.slice
    assert plan.grid % plan.cluster == 0 and plan.grid >= plan.cluster


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("T", [1, 16, 65, 67, 300])
def test_plan_covers_every_element_once(T, D):
    """At every card's widths and the odd ones, at decode and slab row
    counts: the plan fits the kernel, and every element is taken once."""
    plan = nq.acts_plan(T, D, SMS)
    check_plan(plan)
    assert plan.slice * plan.cluster >= D // 8
    wide = 2 * T <= SMS and D // 8 > nq.CLUSTER_MIN_VECS
    assert plan.cluster == (min(8, -(-(D // 8) // nq.CLUSTER_VECS)) if wide else 1)
    count, _ = walk(plan, T, D, 0)
    assert (count == 1).all()


@pytest.mark.parametrize("x_off", OFFSETS)
@pytest.mark.parametrize("D", ODD)
@pytest.mark.parametrize("T,sms", [(3, SMS), (16, SMS), (40, 8)])
def test_plan_covers_every_element_at_any_offset(T, D, x_off, sms):
    """x starting 2 to 14 bytes past a 16-byte boundary (and an odd D
    moving each row's start): heads and tails around the vector body take
    what the vectors leave; on a card of 8 SMs the clusters and CTAs walk
    several row groups."""
    plan = nq.acts_plan(T, D, sms)
    check_plan(plan)
    count, _ = walk(plan, T, D, x_off)
    assert (count == 1).all()


def test_plan_from_shapes_alone():
    """One shape, one plan (and so one reduction order): the memo and a
    fresh computation agree; at few rows a row wider than 24,576 splits
    over a cluster, slab rows fill CTAs of up to 256 threads (narrow ones
    several rows) on a grid sized to the card."""
    a = nq.acts_plan(16, 4096, SMS)
    nq.acts_plan.cache_clear()
    assert nq.acts_plan(16, 4096, SMS) == a
    assert (a.cluster, a.threads, a.vecs, a.grid) == (1, 256, 2, 16)
    f = nq.acts_plan(16, 14336, SMS)
    assert (f.cluster, f.threads, f.vecs, f.grid) == (1, 256, 8, 16)
    q = nq.acts_plan(16, 29568, SMS)  # Qwen2-72B's FFN: a cluster
    assert (q.cluster, q.threads, q.vecs, q.grid) == (4, 256, 4, 64)
    s = nq.acts_plan(512, 4096, SMS)
    assert (s.regime, s.threads, s.rows, s.vecs, s.grid) == ("rows", 128, 2, 4, 256)
    f = nq.acts_plan(512, 14336, SMS)
    assert (f.threads, f.vecs, f.grid) == (256, 8, 512)
    n = nq.acts_plan(512, 1000, SMS)  # narrow rows share a CTA
    assert n.rows > 1 and n.rows * n.threads <= 256
    big = nq.acts_plan(1 << 16, 4096, SMS)
    assert big.grid < (1 << 16) // big.rows  # grid-stride over the groups
    assert nq.acts_plan(1, 1 << 18, SMS).cluster == 8
    with pytest.raises(NotImplementedError):
        nq.acts_plan(1, 1 << 19, SMS)
    with pytest.raises(NotImplementedError):
        nq.acts_plan(0, 4096, SMS)


# ---------------------------------------------------------------------------
# the kernel's arithmetic on its partition
# ---------------------------------------------------------------------------

RECIP_127 = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(127.0)


def emulate(x, w, eps, plan, x_off):
    """The kernel's result on x [T, D] bf16 (w None: B12): each cluster
    rank's partial sum of squares and amax over the elements the walk
    gives it, folded in rank order in f32."""
    T, D = x.shape
    _, rank_of = walk(plan, T, D, x_off)
    ranks = torch.from_numpy(rank_of).long()
    xf = x.float()

    def fold(vals, op):
        parts = []
        for c in range(plan.cluster):
            m = ranks == c
            if op == "sum":
                parts.append(torch.where(m, vals, 0.0).sum(-1))
            else:
                parts.append(torch.where(m, vals, 0.0).amax(-1))
        r = parts[0]
        for p in parts[1:]:
            r = r + p if op == "sum" else torch.maximum(r, p)
        return r

    y = xf
    if w is not None:
        ss = fold(xf * xf, "sum")
        inv_d = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(D))
        inv = torch.rsqrt(ss * inv_d + eps)
        y = xf * inv[:, None] * w.float()
    amax = fold(y.abs(), "max").clamp_min(1e-8)
    s = amax * RECIP_127
    q = torch.round(y / s[:, None]).clamp(-127, 127).to(torch.int8)
    return nq.QuantizedActs(data=q, scale=s)


def _acts_close(got, want_data, want_scale, ties):
    want_data = np.asarray(want_data).astype(np.int32)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want_scale),
                               rtol=1e-6)
    d = np.abs(got.data.numpy().astype(np.int32) - want_data)
    assert d.max() <= 1 and (d != 0).sum() <= ties, (d.max(), (d != 0).sum())


def _inputs(T, D, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    w = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(D).astype(np.float32))
    return x.to(torch.bfloat16), w.to(torch.bfloat16)


SHAPES = [(5, 256), (40, 96), (16, 1000), (3, 4100), (16, 4096), (4, 29568)]


@pytest.mark.parametrize("x_off", [0, 2])
@pytest.mark.parametrize("T,D", SHAPES)
def test_emulated_kernel_matches_plain(T, D, x_off):
    x, w = _inputs(T, D, 11)
    plan = nq.acts_plan(T, D, SMS)
    ties = max(2, T * D // 1000)
    got = emulate(x, w, 1e-5, plan, x_off)
    want = nq.rms_norm_quant_plain(x, w, 1e-5)
    _acts_close(got, want.data.numpy(), want.scale.numpy(), ties)
    got = emulate(x, None, 0.0, plan, x_off)
    want = nq.quant_acts_plain(x)
    _acts_close(got, want.data.numpy(), want.scale.numpy(), ties)


@pytest.mark.parametrize("T,D", SHAPES[:4])
def test_emulated_kernel_matches_jax(T, D):
    x, w = _inputs(T, D, 12)
    jx = jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)
    jw = jnp.asarray(w.float().numpy(), dtype=jnp.bfloat16)
    plan = nq.acts_plan(T, D, SMS)
    ties = max(2, T * D // 1000)
    want = jnq.rms_norm_quant(jx, jw, 1e-5, interpret=True)
    _acts_close(emulate(x, w, 1e-5, plan, 0), want.data, want.scale, ties)
    want = jnq.quant_acts(jx, interpret=True)
    got = emulate(x, None, 0.0, plan, 0)
    _acts_close(got, want.data, want.scale, ties)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
