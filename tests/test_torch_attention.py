"""The port's three attention kernel wrappers (B1 attend_decode_fused, B2
attend_prefill_packed_fused, B5 attend_prefill), run on the CPU where they
take their plain PyTorch versions, against the JAX package on the same
numpy inputs: the Pallas kernels in interpret mode (as
tests/test_pallas_attention.py runs them) and the jnp oracle.

Tolerances: pool bytes must be EQUAL (an append is a copy). Outputs match
the f32 jnp oracle to 1e-4 (the same f32 math summed in another order).
Against the interpreted Pallas kernels they match to 1e-2: those kernels
round q, K/V and the softmax probabilities to bf16 for their MXU dots.
Dead rows/blocks are compared where both sides define them: the fused
decode kernel and its plain version differ on rows with valid=False
(the kernel attends the input token, the plain version the pool), so
those rows are excluded as in the JAX tests; dead packed blocks are 0 on
both sides.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.models.common import pad_kv_minor
from chitu_tpu.ops import attention as jattn
from chitu_tpu.ops import pallas_attention as pk
from chitu_tpu_torch.ops import attention_kernels as tk


@pytest.fixture(autouse=True)
def _jax_op_impl_auto():
    """Run each test with the JAX op_impl switch at "auto": a JAX test in
    the same worker may leave it at "pallas", and the JAX side of these
    tests would then reach a Pallas kernel outside interpret mode."""
    mod = importlib.import_module("chitu_tpu.ops.linear")
    old = mod._OP_IMPL
    mod._OP_IMPL = "auto"
    yield
    mod._OP_IMPL = old


PAGE = 16
LAYER = 1
H, KV, D = 8, 4, 128
M = 2 * pad_kv_minor(KV, D)
ORACLE_TOL = 1e-4
KERNEL_TOL = 1e-2


def _pool(seed, P=24):
    r = np.random.default_rng(seed)
    return (r.standard_normal((3, P, PAGE, M)) * 0.3).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol, rows=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# B1: fused append + decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "window,softcap,valid",
    [
        (0, 0.0, (True, True, True)),
        (24, 0.0, (True, True, True)),
        (0, 5.0, (True, True, True)),
        (0, 0.0, (True, False, True)),
    ],
)
def test_decode_fused(window, softcap, valid):
    r = np.random.default_rng(7)
    B, mp = 3, 6
    pool = _pool(0)
    q = (r.standard_normal((B, H, D)) * 0.5).astype(np.float32)
    k = (r.standard_normal((B, KV, D)) * 0.5).astype(np.float32)
    v = (r.standard_normal((B, KV, D)) * 0.5).astype(np.float32)
    bt = np.stack([np.arange(b * mp, (b + 1) * mp) for b in range(B)]).astype(np.int32)
    seq = np.array([5, PAGE * 2 + 3, PAGE * mp - 1], np.int32)
    val = np.array(valid)
    kw = dict(window=window, softcap=softcap)

    tpool = _t(pool)
    got = tk.attend_decode_fused(
        _t(q), tpool, LAYER, _t(k), _t(v), _t(bt), _t(seq), _t(val), PAGE,
        KV, D, **kw,
    )

    layer = jnp.int32(LAYER)
    jpool = jattn.append_decode(
        jnp.asarray(pool), layer, jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(bt), jnp.asarray(seq), jnp.asarray(val), PAGE,
    )
    want = jattn.attend_decode(
        jnp.asarray(q), jpool, layer, jnp.asarray(bt), jnp.asarray(seq),
        PAGE, KV, D, impl="xla", **kw,
    )
    kern, kpool = pk.attend_decode_fused(
        jnp.asarray(q), jnp.asarray(pool), layer, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(bt), jnp.asarray(seq), jnp.asarray(val),
        PAGE, KV, D, interpret=True, **kw,
    )
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(kpool))
    _close(got, want, ORACLE_TOL)
    _close(got, kern, KERNEL_TOL, rows=val)


# ---------------------------------------------------------------------------
# B5: one sequence's prefill chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "start,n,window,softcap",
    [(0, 64, 0, 0.0), (16, 64, 0, 0.0), (64, 64, 0, 0.0), (16, 64, 24, 0.0),
     (16, 64, 0, 5.0)],
)
def test_prefill(start, n, window, softcap):
    r = np.random.default_rng(9)
    pool = _pool(1)
    bt = np.arange(24, dtype=np.int32)
    q = (r.standard_normal((n, H, D)) * 0.5).astype(np.float32)
    q_pos = (start + np.arange(n)).astype(np.int32)
    total = start + n
    kw = dict(window=window, softcap=softcap)
    got = tk.attend_prefill(
        _t(q), _t(pool), LAYER, _t(bt), _t(q_pos), total, PAGE, KV, D, **kw
    )
    args = (
        jnp.asarray(q), jnp.asarray(pool), jnp.int32(LAYER), jnp.asarray(bt),
        jnp.asarray(q_pos), jnp.int32(total), PAGE, KV, D,
    )
    want = jattn.attend_prefill(*args, impl="xla", **kw)
    kern = pk.attend_prefill(*args, interpret=True, **kw)
    _close(got, want, ORACLE_TOL)
    _close(got, kern, KERNEL_TOL)


# ---------------------------------------------------------------------------
# B2: packed varlen prefill, fused append
# ---------------------------------------------------------------------------


def _packed_case(Tq, segs, NB):
    """Slab geometry as the executor builds it: segs = [(start, n)]."""
    T = NB * Tq
    seg_ids = np.full((T,), -1, np.int32)
    pos = np.full((T,), -1, np.int32)
    block_seg = np.full((NB,), -1, np.int32)
    block_qstart = np.zeros((NB,), np.int32)
    total = np.zeros((len(segs),), np.int32)
    off = 0
    for rr, (s, n) in enumerate(segs):
        npad = (n + Tq - 1) // Tq * Tq
        seg_ids[off : off + n] = rr
        pos[off : off + n] = np.arange(s, s + n)
        b0, nb = off // Tq, npad // Tq
        block_seg[b0 : b0 + nb] = rr
        block_qstart[b0 : b0 + nb] = s + np.arange(nb) * Tq
        total[rr] = s + n
        off += npad
    assert off < T  # at least one dead block
    return T, seg_ids, pos, block_seg, block_qstart, total


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 5.0)])
def test_prefill_packed_fused(window, softcap):
    r = np.random.default_rng(5)
    Tq, mp, R = PAGE, 8, 3
    # a fresh prompt, a mid-context continuation (16 tokens already in the
    # pool), and a short prompt; then a dead block
    segs = [(0, 40), (16, 24), (0, 5)]
    T, seg_ids, pos, block_seg, block_qstart, total = _packed_case(Tq, segs, 7)
    assert pk.prefill_packed_fused_ok(True, KV, D, H, PAGE, Tq)
    pool = _pool(2)
    bt = np.stack([np.arange(i * mp, (i + 1) * mp) for i in range(R)]).astype(np.int32)
    q = (r.standard_normal((T, H, D)) * 0.5).astype(np.float32)
    k = (r.standard_normal((T, KV, D)) * 0.5).astype(np.float32)
    v = (r.standard_normal((T, KV, D)) * 0.5).astype(np.float32)
    kw = dict(window=window, softcap=softcap)

    tpool = _t(pool)
    got = tk.attend_prefill_packed_fused(
        _t(q), tpool, LAYER, _t(k), _t(v), _t(bt), _t(block_seg),
        _t(block_qstart), _t(total), PAGE, KV, D, **kw,
    )

    layer = jnp.int32(LAYER)
    jpool = jattn.append_prefill_packed(
        jnp.asarray(pool), layer, jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(bt), jnp.asarray(seg_ids), jnp.asarray(pos), PAGE,
    )
    want = jattn._oracle_prefill_packed(
        jnp.asarray(q), jpool, layer, jnp.asarray(bt), jnp.asarray(seg_ids),
        jnp.asarray(np.maximum(pos, 0)), jnp.asarray(total), KV, D, True,
        None, **kw,
    )
    kern, kpool = pk.attend_prefill_packed_fused(
        jnp.asarray(q), jnp.asarray(pool), layer, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(bt), jnp.asarray(block_seg),
        jnp.asarray(block_qstart), jnp.asarray(total), PAGE, KV, D,
        interpret=True, **kw,
    )
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(kpool))
    live = seg_ids >= 0
    _close(got, want, ORACLE_TOL, rows=live)
    _close(got, kern, KERNEL_TOL, rows=live)
    dead = np.repeat(block_seg < 0, Tq)
    assert dead.any()
    np.testing.assert_array_equal(got.numpy()[dead], 0.0)
    np.testing.assert_array_equal(np.asarray(kern)[dead], 0.0)


def test_gates_match_jax():
    for h, kv, d, page in [(8, 4, 128, 16), (32, 8, 128, 64), (4, 2, 64, 16)]:
        m = 2 * pad_kv_minor(kv, d)
        assert tk.packed_q_block(h, m, page, d, kv_heads=kv) == pk.packed_q_block(
            h, m, page, d, kv_heads=kv
        )
        for tq in (8, 16, 64):
            assert tk.prefill_packed_fused_ok(
                True, kv, d, h, page, tq
            ) == pk.prefill_packed_fused_ok(True, kv, d, h, page, tq)
    # the Llama-3-8B slab: 64-row q blocks fit the budget, the gate passes
    assert tk.packed_q_block(32, 2048, 64, 128, kv_heads=8) == 64
    assert tk.prefill_packed_fused_ok(True, 8, 128, 32, 64, 64)



# ---------------------------------------------------------------------------
# the split decode kernel's geometry and merge (plain versions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,KV_,mp,page", [
    (16, 8, 33, 64), (16, 128, 33, 64), (1, 8, 33, 64), (16, 4, 33, 64),
    (4, 2, 8, 16), (3, 1, 1, 16), (64, 8, 129, 16),
])
def test_decode_split_covers_the_table(B, KV_, mp, page):
    S, chunk = tk.decode_split(B, KV_, mp, page, 132)
    keys = mp * page
    assert S >= 1 and chunk % tk.KEY_TILE == 0
    assert (S - 1) * chunk < keys <= S * chunk  # no empty trailing split
    if B * KV_ >= tk.DECODE_BLOCKS_PER_SM * 132:
        assert S == 1  # enough blocks: the kernel writes the output itself


def test_decode_plan_reads_shapes_only(monkeypatch):
    """The split choice and its scratch come from shapes alone: the plan
    is built from meta tensors, which hold no values, so the launch needs
    no host sync (and a CUDA graph can capture it)."""
    monkeypatch.setattr(tk, "_sm_count", lambda dev: 132)
    meta = dict(device="meta")
    q = torch.empty((16, 32, 128), dtype=torch.bfloat16, **meta)
    bt = torch.empty((16, 33), dtype=torch.int32, **meta)
    S, chunk, part_o, part_ml = tk._decode_plan(q, bt, 8, 64)
    assert (S, chunk) == tk.decode_split(16, 8, 33, 64, 132) == (5, 448)
    assert part_o.numel() == 16 * 32 * S * 128 and part_ml.numel() == 16 * 32 * S * 2
    assert part_o.device.type == "meta"
    S, chunk, part_o, part_ml = tk._decode_plan(
        torch.empty((16, 128, 192), dtype=torch.bfloat16, **meta),
        bt, 128, 64)
    assert S == 1 and part_o is None and part_ml is None


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (40, 0.0), (0, 20.0)])
@pytest.mark.parametrize("S,chunk", [(1, 128), (2, 64), (3, 48), (8, 16), (5, 64)])
def test_split_merge_equals_unsplit(S, chunk, window, softcap):
    """Partials of the splits merged in split order (the kernel's merge,
    empty splits included) equal the unsplit attention in f32."""
    r = np.random.default_rng(5)
    B, mp = 5, 8
    pool = _t(_pool(11, P=B * mp))
    bt = torch.arange(B * mp, dtype=torch.int32).reshape(B, mp)
    seq = torch.tensor([0, 3, PAGE, 3 * PAGE + 5, mp * PAGE - 1], dtype=torch.int32)
    q = torch.from_numpy(r.standard_normal((B, H, D)).astype(np.float32))
    args = (q, pool, LAYER, bt, seq, PAGE, KV, D)
    kw = dict(window=window, softcap=softcap)
    got = tk.attend_decode_split_plain(*args, S, chunk, **kw)
    want = tk.attend_decode_plain(*args, **kw)
    assert (got - want).abs().max().item() <= 1e-5
