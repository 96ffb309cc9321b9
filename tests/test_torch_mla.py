"""The MLA pieces of the port against the JAX package on the CPU: the
merged latent pool row (`split_kv=False`) through the plain appends and
attention functions and through the wrappers of B1, B3, B4 and B5 (which
take their plain versions here); B3 and B4 on the split K/V layout too;
the merged, layer-grouped `PagedKVCache`; and B9's plain version against
the interpreted Pallas absorb kernel.

Latent geometry, small: kv_lora_rank 64 + rope 16 = 80 live lanes in a
128-lane pool row, 8 query heads on one KV head. The JAX functions take q
padded to the pool row (head_dim 128, as the JAX model passes it) and
return every lane; the port's wrappers take q at its 80 live lanes and
return the 64 value lanes, which are compared.

Tolerances: pool bytes must be EQUAL (an append is a copy). Outputs match
the f32 jnp oracle (`impl="xla"`) to 1e-4 (the same f32 math summed in
another order) and the interpreted Pallas kernels to 1e-2 (they round q,
K/V and the probabilities to bf16 for their MXU dots). B9: both sides
multiply the same bf16 values and sum in f32, then round once to bf16;
they are one bf16 step (0.4 %) apart at most: 1e-2.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.kvcache.paged import PagedKVCache as JPagedKVCache
from chitu_tpu.models.common import pad_kv_minor
from chitu_tpu.ops import attention as jattn
from chitu_tpu.ops import pallas_absorb as jabs
from chitu_tpu.ops import pallas_attention as pk
from chitu_tpu_torch.kvcache import PagedKVCache
from chitu_tpu_torch.ops import absorb_kernels as tabs
from chitu_tpu_torch.ops import attention as tattn
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
H = 8
DC, DR = 64, 16
LIVE = DC + DR  # 80 live lanes of a latent row
MROW = pad_kv_minor(1, LIVE)  # 128
SCALE = 1.0 / np.sqrt(96.0)
ORACLE_TOL = 1e-4
KERNEL_TOL = 1e-2


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol, rows=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


class Geom:
    """One pool layout: the port's wrapper arguments and the JAX ones."""

    def __init__(self, layout):
        self.latent = layout == "latent"
        if self.latent:
            self.kv, self.jd, self.td, self.out = 1, MROW, LIVE, DC
            self.M = MROW
            self.tkw = dict(split_kv=False, v_dim=DC)
        else:
            self.kv, self.jd, self.td, self.out = 4, 128, 128, 128
            self.M = 2 * 4 * 128
            self.tkw = {}
        # the model's scale (1 / sqrt(qk_head_dim) with YaRN), never the
        # default 1 / sqrt(q width), which differs between the two q widths
        self.tkw["scale"] = SCALE
        self.jkw = dict(split_kv=not self.latent, scale=SCALE)

    def pool(self, seed, P=24):
        r = np.random.default_rng(seed)
        p = (r.standard_normal((3, P, PAGE, self.M)) * 0.3).astype(np.float32)
        if self.latent:
            p[..., LIVE:] = 0.0  # the pad lanes of a latent row
        return p

    def q(self, r, n):
        """(JAX q at the kernels' head_dim, the port's q at its live lanes)"""
        q = (r.standard_normal((n, H, self.jd)) * 0.5).astype(np.float32)
        if self.latent:
            q[..., LIVE:] = 0.0
        return q, q[..., : self.td]

    def kv_rows(self, r, n):
        """(k, v) of n new tokens; the latent row's v is None."""
        k = (r.standard_normal((n, self.kv, self.td)) * 0.5).astype(np.float32)
        if self.latent:
            return k, None
        return k, (r.standard_normal((n, self.kv, self.td)) * 0.5).astype(np.float32)

    def cut(self, a):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return a[..., : self.out]


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# the plain layout helpers
# ---------------------------------------------------------------------------


def test_pack_and_unpack_the_latent_row():
    r = np.random.default_rng(0)
    k = (r.standard_normal((5, 1, LIVE))).astype(np.float32)
    got = tattn.pack_kv(_t(k), None, MROW)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jattn.pack_kv(jnp.asarray(k), None, MROW)))
    rows = r.standard_normal((2, 7, MROW)).astype(np.float32)
    tk_, tv = tattn.unpack_pool(_t(rows), 1, MROW, split_kv=False)
    jk, jv = jattn.unpack_pool(jnp.asarray(rows), 1, MROW, False)
    assert tk_ is tv
    np.testing.assert_array_equal(tk_.float().numpy(), np.asarray(jk, np.float32))


# ---------------------------------------------------------------------------
# B1: fused append + decode (latent row)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("valid", [(True, True, True), (True, False, True)])
def test_decode_fused_latent(valid):
    g = Geom("latent")
    r = np.random.default_rng(7)
    B, mp = 3, 6
    pool = g.pool(0)
    qj, qt = g.q(r, B)
    k, _ = g.kv_rows(r, B)
    bt = np.stack([np.arange(b * mp, (b + 1) * mp) for b in range(B)]).astype(np.int32)
    seq = np.array([5, PAGE * 2 + 3, PAGE * mp - 1], np.int32)
    val = np.array(valid)

    tpool = _t(pool)
    got = tk.attend_decode_fused(
        _t(qt), tpool, LAYER, _t(k), None, _t(bt), _t(seq), _t(val), PAGE,
        1, LIVE, **g.tkw,
    )
    assert got.shape == (B, H, DC)
    layer = jnp.int32(LAYER)
    jpool = jattn.append_decode(
        jnp.asarray(pool), layer, jnp.asarray(k), None, jnp.asarray(bt),
        jnp.asarray(seq), jnp.asarray(val), PAGE,
    )
    want = jattn.attend_decode(
        jnp.asarray(qj), jpool, layer, jnp.asarray(bt), jnp.asarray(seq),
        PAGE, 1, MROW, impl="xla", **g.jkw,
    )
    kern, kpool = pk.attend_decode_fused(
        jnp.asarray(qj), jnp.asarray(pool), layer, jnp.asarray(k), None,
        jnp.asarray(bt), jnp.asarray(seq), jnp.asarray(val), PAGE, 1, MROW,
        interpret=True, **g.jkw,
    )
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(kpool))
    _close(got, g.cut(want), ORACLE_TOL)
    _close(got, g.cut(kern), KERNEL_TOL, rows=val)


# ---------------------------------------------------------------------------
# B4: decode over the appended pool (both layouts)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["latent", "split"])
def test_decode_after_append(layout):
    g = Geom(layout)
    r = np.random.default_rng(8)
    B, mp = 3, 6
    pool = g.pool(3)
    qj, qt = g.q(r, B)
    k, v = g.kv_rows(r, B)
    bt = np.stack([np.arange(b * mp, (b + 1) * mp) for b in range(B)]).astype(np.int32)
    seq = np.array([0, PAGE + 7, PAGE * mp - 1], np.int32)
    val = np.array([True, True, True])

    tpool = _t(pool)
    tattn.append_decode(tpool, LAYER, _t(k), None if v is None else _t(v),
                        _t(bt), _t(seq), _t(val), PAGE)
    layer = jnp.int32(LAYER)
    jpool = jattn.append_decode(
        jnp.asarray(pool), layer, jnp.asarray(k), _j(v), jnp.asarray(bt),
        jnp.asarray(seq), jnp.asarray(val), PAGE,
    )
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    got = tk.attend_decode(
        _t(qt), tpool, LAYER, _t(bt), _t(seq), PAGE, g.kv, g.td, **g.tkw)
    args = (jnp.asarray(qj), jpool, layer, jnp.asarray(bt), jnp.asarray(seq),
            PAGE, g.kv, g.jd)
    want = jattn.attend_decode(*args, impl="xla", **g.jkw)
    kern = pk.attend_decode(*args, interpret=True, **g.jkw)
    assert got.shape == (B, H, g.out)
    _close(got, g.cut(want), ORACLE_TOL)
    _close(got, g.cut(kern), KERNEL_TOL)


# ---------------------------------------------------------------------------
# B5: one sequence's prefill chunk (latent row)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start,n", [(0, 32), (16, 32), (40, 16)])
def test_prefill_latent(start, n):
    g = Geom("latent")
    r = np.random.default_rng(9)
    pool = g.pool(1)
    bt = np.arange(24, dtype=np.int32)
    qj, qt = g.q(r, n)
    k, _ = g.kv_rows(r, n)
    q_pos = (start + np.arange(n)).astype(np.int32)
    total = start + n

    tpool = _t(pool)
    tattn.append_prefill(tpool, LAYER, _t(k), None, _t(bt), _t(q_pos), n, PAGE)
    jpool = jattn.append_prefill(
        jnp.asarray(pool), jnp.int32(LAYER), jnp.asarray(k), None,
        jnp.asarray(bt), jnp.asarray(q_pos), jnp.int32(n), PAGE,
    )
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    got = tk.attend_prefill(
        _t(qt), tpool, LAYER, _t(bt), _t(q_pos), total, PAGE, 1, LIVE, **g.tkw)
    args = (jnp.asarray(qj), jpool, jnp.int32(LAYER), jnp.asarray(bt),
            jnp.asarray(q_pos), jnp.int32(total), PAGE, 1, MROW)
    want = jattn.attend_prefill(*args, impl="xla", **g.jkw)
    kern = pk.attend_prefill(*args, interpret=True, **g.jkw)
    assert got.shape == (n, H, DC)
    _close(got, g.cut(want), ORACLE_TOL)
    _close(got, g.cut(kern), KERNEL_TOL)


# ---------------------------------------------------------------------------
# B3: packed varlen prefill over the appended pool (both layouts)
# ---------------------------------------------------------------------------


def _packed_case(Tq, segs, NB):
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


@pytest.mark.parametrize("layout", ["latent", "split"])
def test_prefill_packed_after_append(layout):
    g = Geom(layout)
    r = np.random.default_rng(5)
    Tq, mp, R = 8, 8, 3
    # a fresh prompt, a mid-context continuation, a short prompt, then a
    # dead block
    segs = [(0, 40), (16, 24), (0, 5)]
    T, seg_ids, pos, block_seg, block_qstart, total = _packed_case(Tq, segs, 10)
    pool = g.pool(2)
    bt = np.stack([np.arange(i * mp, (i + 1) * mp) for i in range(R)]).astype(np.int32)
    qj, qt = g.q(r, T)
    k, v = g.kv_rows(r, T)

    tpool = _t(pool)
    tattn.append_prefill_packed(
        tpool, LAYER, _t(k), None if v is None else _t(v), _t(bt),
        _t(seg_ids), _t(pos), PAGE)
    layer = jnp.int32(LAYER)
    jpool = jattn.append_prefill_packed(
        jnp.asarray(pool), layer, jnp.asarray(k), _j(v), jnp.asarray(bt),
        jnp.asarray(seg_ids), jnp.asarray(pos), PAGE,
    )
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    got = tk.attend_prefill_packed(
        _t(qt), tpool, LAYER, _t(bt), _t(block_seg), _t(block_qstart),
        _t(total), PAGE, g.kv, g.td, **g.tkw,
    )
    want = jattn.attend_prefill_packed(
        jnp.asarray(qj), jpool, layer, jnp.asarray(bt), jnp.asarray(seg_ids),
        jnp.asarray(np.maximum(pos, 0)), jnp.asarray(total),
        jnp.asarray(block_seg), jnp.asarray(block_qstart), PAGE, g.kv, g.jd,
        impl="xla", **g.jkw,
    )
    kern = pk.attend_prefill_packed(
        jnp.asarray(qj), jpool, layer, jnp.asarray(bt), jnp.asarray(block_seg),
        jnp.asarray(block_qstart), jnp.asarray(total), PAGE, g.kv, g.jd,
        interpret=True, **g.jkw,
    )
    assert got.shape == (T, H, g.out)
    live = seg_ids >= 0
    _close(got, g.cut(want), ORACLE_TOL, rows=live)
    _close(got, g.cut(kern), KERNEL_TOL, rows=live)
    dead = np.repeat(block_seg < 0, Tq)
    np.testing.assert_array_equal(got.numpy()[dead], 0.0)


def test_latent_slab_geometry_matches_jax():
    """The executor sizes the packed q block from the first pool array's
    minor with split_kv off for the latent row, as the JAX executor does."""
    for h, m, page, d in [(8, 128, 16, 128), (32, 640, 64, 640),
                          (128, 640, 64, 640)]:
        assert tk.packed_q_block(h, m, page, d, kv_heads=h, split_kv=False) == \
            pk.packed_q_block(h, m, page, d, kv_heads=h, split_kv=False)


def test_wrappers_refuse_other_geometries_on_the_card_only():
    """The geometry gate the CUDA path applies: the two the kernels take
    pass, everything else raises (checked without a card)."""
    tk._check_geometry(tk.LATENT_QK, 640, 1, 128, False, tk.LATENT_DV)
    tk._check_geometry(tk.LATENT_QK, 640, 1, 32, False, tk.LATENT_DV)
    tk._check_geometry(128, 2048, 8, 32)
    for d in (192, 64, 32):  # the other split head sizes built
        tk._check_geometry(d, 2 * 4 * d, 4, 8)
    for args in [(LIVE, MROW, 1, 8, False, DC), (576, 640, 1, 8, False, 512),
                 (576, 640, 2, 128, False, 512), (576, 640, 1, 128, False, 576),
                 (96, 3072, 16, 16), (192, 6144, 16, 16, True, 128)]:
        with pytest.raises(NotImplementedError):
            tk._check_geometry(*args)


# ---------------------------------------------------------------------------
# the merged, layer-grouped pool
# ---------------------------------------------------------------------------


def test_paged_cache_merged_groups_match_jax():
    groups = {"kv_dense": 1, "kv_moe": 3}
    t = PagedKVCache(4, 10, PAGE, 0, 0, kv_dim=576, layer_groups=groups)
    j = JPagedKVCache(4, 10, PAGE, 0, 0, kv_dim=576, layer_groups=groups)
    assert t.merged and j.merged and t.minor == j.minor == 640
    assert list(t.arrays) == list(j.arrays)
    for name in groups:
        assert tuple(t.arrays[name].shape) == tuple(j.arrays[name].shape)
        assert t.arrays[name].dtype == torch.bfloat16
    assert t.bytes() == j.bytes()
    split = PagedKVCache(2, 10, PAGE, 8, 128)
    assert list(split.arrays) == ["kv"] and split.minor == 2048


# ---------------------------------------------------------------------------
# B9: the absorb projections
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [5, 16])
@pytest.mark.parametrize("kind", ["uk", "uv"])
def test_absorb_plain_matches_pallas(kind, T):
    L, C, Hh, dn, dv = 2, 128, 4, 128, 128
    r = np.random.default_rng(11)
    w = (r.standard_normal((L, C, Hh * (dn + dv))) * 0.1).astype(np.float32)
    x = (r.standard_normal((T, Hh, dn if kind == "uk" else C)) * 0.5).astype(np.float32)
    wj = jnp.asarray(w, jnp.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert tabs.absorb_kernel_ok(wt, dn, dv, C) == jabs.absorb_kernel_ok(wj, dn, dv, C)
    want = jabs.absorb_matmul(xj, wj, jnp.int32(LAYER), kind, dn, dv, interpret=True)
    got = tabs.absorb_matmul_plain(xt, wt, LAYER, kind, dn, dv)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.float(), np.asarray(want, np.float32), KERNEL_TOL)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(tabs.absorb_matmul(xt, wt, LAYER, kind, dn, dv), got)


def test_absorb_gate_matches_jax():
    from chitu_tpu_torch.ops.qtensor import QTensor

    for shape, dn, dv in [((2, 512, 128 * 256), 128, 128),
                          ((2, 64, 8 * 64), 32, 32),
                          ((2, 512, 4 * 256), 128, 128)]:
        wt = torch.zeros(shape, dtype=torch.bfloat16)
        wj = jnp.zeros(shape, jnp.bfloat16)
        assert tabs.absorb_kernel_ok(wt, dn, dv, shape[1]) == \
            jabs.absorb_kernel_ok(wj, dn, dv, shape[1])
    q = QTensor(data=torch.zeros((2, 512, 1024), dtype=torch.int8),
                scale=torch.ones((2, 1024)))
    assert not tabs.absorb_kernel_ok(q, 128, 128, 512)
    assert not tabs.absorb_kernel_ok(torch.zeros((512, 1024)), 128, 128, 512)
