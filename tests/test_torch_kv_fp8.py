"""The fp8 KV cache of the port (infer.kv_dtype=fp8: int8 pools holding
fp8-e4m3 bits) against the JAX package on the CPU.

- `kv_encode` / `kv_decode` byte for byte against the JAX functions: every
  bf16 value, two million f32 values over 2^-17..2^10 in size, and the
  cases that part a plain cast from the JAX encode (ties, subnormals,
  +-448, +-464, magnitudes beyond, infinities, NaN of either sign); the
  decode on all 256 codes, the NaN codes compared as NaN.
- Every attention entry on int8 pools through the port's wrappers (their
  plain versions here) against the jnp oracle (`impl="xla"`) and the
  interpreted Pallas kernels: B1, B2, B3, B4 and B5 on the split layout
  (head_dim 128 and 64), B1, B3, B4 and B5 on the merged latent row.
- The engines: the pool bytes after a served burst and the greedy tokens
  equal the JAX engine's with `infer.kv_dtype=fp8` on `micro-llama-debug`
  (the card tests/test_kv_fp8.py serves, and at head_dim 128) and on
  `tiny-deepseek-debug`.

Tolerances: pool bytes EQUAL where both sides encode the same values (an
append is an encode). Outputs against the oracle 1e-4 (both decode the
pool to the same bf16 values, then f32 math in another order) and
against the interpreted kernels 1e-2 (they round q and the probabilities
to bf16 for their MXU dots). The Pallas kernels read e4m3 by bit
placement (`_pool_f32`), which makes the subnormal codes f32 denormals,
and the CPU (as the TPU) flushes those to zero; the port converts them
exactly, as the oracle does. So the kernel comparisons feed the port the
pool and the new rows with those codes flushed (`_ftz`), the kernels'
own reading of them. Between the two engines the K/V rows are computed
by two frameworks, their f32 sums in another order: a value within an
ulp of an e4m3 rounding midpoint can land one code apart, so the pools
must be equal but for at most 1e-5 of their codes, each one step apart.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from chitu_tpu.config import load_config as jload
from chitu_tpu.engine import Engine as JEngine
from chitu_tpu.models.common import kv_decode as jdecode
from chitu_tpu.models.common import kv_encode as jencode
from chitu_tpu.ops import attention as jattn
from chitu_tpu.ops import pallas_attention as pk
from chitu_tpu.task import SampleParams as JSampleParams
from chitu_tpu_torch import SampleParams
from chitu_tpu_torch.config import load_config as tload
from chitu_tpu_torch.engine import Engine
from chitu_tpu_torch.models.common import kv_decode, kv_encode
from chitu_tpu_torch.models.llama import params_from_numpy
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
ORACLE_TOL = 1e-4
KERNEL_TOL = 1e-2
SPECIALS = [
    0.0, -0.0, 2.0 ** -10, -(2.0 ** -10), 2.0 ** -9, 3 * 2.0 ** -10,
    5 * 2.0 ** -11, 1e-9, -1e-9, 1.0625, 1.1875, -1.0625, 447.0, 448.0,
    -448.0, 456.0, 464.0, -464.0, 464.5, 466.0, 480.0, -480.0, 500.0,
    1000.0, -600.0, 1e30, np.inf, -np.inf, np.nan, -np.nan,
]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol, rows=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _jencode(x):
    return np.asarray(jencode(jnp.asarray(x), jnp.int8))


def _ftz(codes):
    """The Pallas kernels' reading of e4m3 codes: subnormals as zero."""
    codes = np.array(codes, copy=True)
    codes[(codes.view(np.uint8) & 0x78) == 0] = 0
    return codes


def _ftz_vals(x):
    """Values whose encodes are the flushed codes of x's encodes."""
    if x is None:
        return None
    return np.asarray(jdecode(jnp.asarray(_ftz(_jencode(x))), jnp.float32))


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------


def test_encode_every_bf16_value_byte_equal():
    bits = np.arange(1 << 16, dtype=np.uint16)
    want = _jencode(bits.view(ml_dtypes.bfloat16))
    got = kv_encode(torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16),
                    torch.int8)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_f32_byte_equal():
    r = np.random.default_rng(0)
    x = (r.standard_normal(1 << 21) * np.exp2(r.uniform(-17, 10, 1 << 21)))
    x = x.astype(np.float32)
    np.testing.assert_array_equal(
        kv_encode(torch.from_numpy(x), torch.int8).numpy(), _jencode(x))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_encode_specials_byte_equal(dtype):
    """The cases a plain cast gets wrong (it saturates to +-448 beyond 464
    and loses a NaN's sign), and the rounding ties and subnormals."""
    x = np.array(SPECIALS, np.float32)
    if dtype == "bfloat16":  # the same bits on both sides, NaN signs too
        x = x.astype(ml_dtypes.bfloat16)
        tx = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    else:
        tx = torch.from_numpy(x)
    want = _jencode(x)
    got = kv_encode(tx, torch.int8)
    np.testing.assert_array_equal(got.numpy(), want)
    # beyond 464 the code is NaN with the value's sign, never 448
    assert set(want[np.abs(x.astype(np.float32)) > 464].tolist()) <= {127, -1}
    plain = tx.to(torch.float8_e4m3fn).view(torch.int8).numpy()
    assert (plain != want).any()  # the cast alone would not do


def test_decode_every_code():
    codes = np.arange(-128, 128, dtype=np.int8)
    for out in (jnp.bfloat16, jnp.float32):
        want = np.asarray(jdecode(jnp.asarray(codes), out), np.float32)
        got = kv_decode(torch.from_numpy(codes),
                        getattr(torch, jnp.dtype(out).name)).float().numpy()
        np.testing.assert_array_equal(got, want)  # NaN compares as NaN
    assert np.isnan(want).sum() == 2  # 0x7F and 0xFF
    x = torch.from_numpy(np.asarray(jdecode(jnp.asarray(codes)), np.float32))
    # the decode is exact: encoding its values gives back the codes
    finite = torch.isfinite(x)
    assert torch.equal(kv_encode(x, torch.int8)[finite], torch.from_numpy(codes)[finite])
    assert kv_encode(x, torch.bfloat16).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# attention over int8 pools
# ---------------------------------------------------------------------------


class Geom:
    """A pool layout: split K/V at head_dim D, or the merged latent row
    (64 + 16 = 80 live lanes in a 128-lane row)."""

    def __init__(self, layout):
        self.latent = layout == "latent"
        if self.latent:
            self.kv, self.jd, self.td, self.out, self.M = 1, 128, 80, 64, 128
            self.tkw = dict(split_kv=False, v_dim=64, scale=0.1)
            self.jkw = dict(split_kv=False, scale=0.1)
        else:
            D = int(layout[1:])
            self.kv, self.jd, self.td, self.out = 4, D, D, D
            self.M = 2 * 4 * D
            self.tkw, self.jkw = {}, {}

    def pool(self, seed, P=24):
        r = np.random.default_rng(seed)
        p = (r.standard_normal((3, P, PAGE, self.M)) * 0.5).astype(np.float32)
        if self.latent:
            p[..., 80:] = 0.0
        return _jencode(p)

    def q(self, r, n):
        q = (r.standard_normal((n, H, self.jd)) * 0.5).astype(np.float32)
        if self.latent:
            q[..., 80:] = 0.0
        return q, q[..., : self.td]

    def kv_rows(self, r, n):
        k = (r.standard_normal((n, self.kv, self.td)) * 0.5).astype(np.float32)
        if self.latent:
            return k, None
        return k, (r.standard_normal((n, self.kv, self.td)) * 0.5).astype(np.float32)

    def cut(self, a):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return a[..., : self.out]


def _j(a):
    return None if a is None else jnp.asarray(a)


LAYOUTS = ["d128", "d64", "latent"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_fused_e4m3(layout):
    """B1: the append writes the JAX bytes; the new token is attended at
    the value its e4m3 bytes hold."""
    g = Geom(layout)
    r = np.random.default_rng(7)
    B, mp = 3, 6
    pool = g.pool(0)
    qj, qt = g.q(r, B)
    k, v = g.kv_rows(r, B)
    bt = np.stack([np.arange(b * mp, (b + 1) * mp) for b in range(B)]).astype(np.int32)
    seq = np.array([5, PAGE * 2 + 3, PAGE * mp - 1], np.int32)
    val = np.array([True, False, True])
    tpool = _t(pool)
    got = tk.attend_decode_fused(
        _t(qt), tpool, LAYER, _t(k), None if v is None else _t(v), _t(bt),
        _t(seq), _t(val), PAGE, g.kv, g.td, **g.tkw)
    layer = jnp.int32(LAYER)
    jpool = jattn.append_decode(
        jnp.asarray(pool), layer, jnp.asarray(k), _j(v), jnp.asarray(bt),
        jnp.asarray(seq), jnp.asarray(val), PAGE)
    want = jattn.attend_decode(
        jnp.asarray(qj), jpool, layer, jnp.asarray(bt), jnp.asarray(seq),
        PAGE, g.kv, g.jd, impl="xla", **g.jkw)
    kern, kpool = pk.attend_decode_fused(
        jnp.asarray(qj), jnp.asarray(pool), layer, jnp.asarray(k), _j(v),
        jnp.asarray(bt), jnp.asarray(seq), jnp.asarray(val), PAGE, g.kv,
        g.jd, interpret=True, **g.jkw)
    assert tpool.dtype == torch.int8
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(kpool))
    _close(got, g.cut(want), ORACLE_TOL, rows=val)
    flushed = tk.attend_decode_fused(
        _t(qt), _t(_ftz(pool)), LAYER, _t(_ftz_vals(k)),
        None if v is None else _t(_ftz_vals(v)), _t(bt), _t(seq), _t(val),
        PAGE, g.kv, g.td, **g.tkw)
    _close(flushed, g.cut(kern), KERNEL_TOL, rows=val)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_after_append_e4m3(layout):
    """B4 over a pool the plain append wrote."""
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
        jnp.asarray(seq), jnp.asarray(val), PAGE)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    got = tk.attend_decode(
        _t(qt), tpool, LAYER, _t(bt), _t(seq), PAGE, g.kv, g.td, **g.tkw)
    args = (jnp.asarray(qj), jpool, layer, jnp.asarray(bt), jnp.asarray(seq),
            PAGE, g.kv, g.jd)
    _close(got, g.cut(jattn.attend_decode(*args, impl="xla", **g.jkw)), ORACLE_TOL)
    flushed = tk.attend_decode(
        _t(qt), _t(_ftz(tpool.numpy())), LAYER, _t(bt), _t(seq), PAGE, g.kv,
        g.td, **g.tkw)
    _close(flushed, g.cut(pk.attend_decode(*args, interpret=True, **g.jkw)),
           KERNEL_TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefill_e4m3(layout):
    """B5 after the plain append of the chunk (expanded Pallas variant at
    head_dim 64)."""
    g = Geom(layout)
    r = np.random.default_rng(9)
    start, n = 16, 32
    pool = g.pool(1)
    bt = np.arange(24, dtype=np.int32)
    qj, qt = g.q(r, n)
    k, v = g.kv_rows(r, n)
    q_pos = (start + np.arange(n)).astype(np.int32)
    tpool = _t(pool)
    tattn.append_prefill(tpool, LAYER, _t(k), None if v is None else _t(v),
                         _t(bt), _t(q_pos), n, PAGE)
    jpool = jattn.append_prefill(
        jnp.asarray(pool), jnp.int32(LAYER), jnp.asarray(k), _j(v),
        jnp.asarray(bt), jnp.asarray(q_pos), jnp.int32(n), PAGE)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    run = lambda pool_: tk.attend_prefill(
        _t(qt), pool_, LAYER, _t(bt), _t(q_pos), start + n, PAGE, g.kv, g.td,
        **g.tkw)
    args = (jnp.asarray(qj), jpool, jnp.int32(LAYER), jnp.asarray(bt),
            jnp.asarray(q_pos), jnp.int32(start + n), PAGE, g.kv, g.jd)
    _close(run(tpool), g.cut(jattn.attend_prefill(*args, impl="xla", **g.jkw)),
           ORACLE_TOL)
    _close(run(_t(_ftz(tpool.numpy()))),
           g.cut(pk.attend_prefill(*args, interpret=True, **g.jkw)), KERNEL_TOL)


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
    return T, seg_ids, pos, block_seg, block_qstart, total


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefill_packed_after_append_e4m3(layout):
    """B3 over a slab the plain packed append wrote."""
    g = Geom(layout)
    r = np.random.default_rng(5)
    Tq, mp, R = 8, 8, 3
    T, seg_ids, pos, block_seg, block_qstart, total = _packed_case(
        Tq, [(0, 20), (16, 12), (0, 5)], 7)
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
        jnp.asarray(seg_ids), jnp.asarray(pos), PAGE)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    run = lambda pool_: tk.attend_prefill_packed(
        _t(qt), pool_, LAYER, _t(bt), _t(block_seg), _t(block_qstart),
        _t(total), PAGE, g.kv, g.td, **g.tkw)
    args = (jnp.asarray(qj), jpool, layer, jnp.asarray(bt),
            jnp.asarray(seg_ids), jnp.asarray(np.maximum(pos, 0)),
            jnp.asarray(total), jnp.asarray(block_seg),
            jnp.asarray(block_qstart), PAGE, g.kv, g.jd)
    live = seg_ids >= 0
    _close(run(tpool),
           g.cut(jattn.attend_prefill_packed(*args, impl="xla", **g.jkw)),
           ORACLE_TOL, rows=live)
    kern = pk.attend_prefill_packed(
        jnp.asarray(qj), jpool, layer, jnp.asarray(bt), jnp.asarray(block_seg),
        jnp.asarray(block_qstart), jnp.asarray(total), PAGE, g.kv, g.jd,
        interpret=True, **g.jkw)
    _close(run(_t(_ftz(tpool.numpy()))), g.cut(kern), KERNEL_TOL, rows=live)


def test_prefill_packed_fused_e4m3():
    """B2 (split layout, head_dim 128): the slab's appends write the JAX
    bytes, then every live block attends."""
    g = Geom("d128")
    r = np.random.default_rng(6)
    Tq, mp, R = PAGE, 8, 3
    T, seg_ids, pos, block_seg, block_qstart, total = _packed_case(
        Tq, [(0, 40), (16, 24), (0, 5)], 7)
    pool = g.pool(4)
    bt = np.stack([np.arange(i * mp, (i + 1) * mp) for i in range(R)]).astype(np.int32)
    qj, qt = g.q(r, T)
    k, v = g.kv_rows(r, T)
    tpool = _t(pool)
    got = tk.attend_prefill_packed_fused(
        _t(qt), tpool, LAYER, _t(k), _t(v), _t(bt), _t(block_seg),
        _t(block_qstart), _t(total), PAGE, 4, 128)
    layer = jnp.int32(LAYER)
    kern, kpool = pk.attend_prefill_packed_fused(
        jnp.asarray(qj), jnp.asarray(pool), layer, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(bt), jnp.asarray(block_seg),
        jnp.asarray(block_qstart), jnp.asarray(total), PAGE, 4, 128,
        interpret=True)
    jpool = jattn.append_prefill_packed(
        jnp.asarray(pool), layer, jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(bt), jnp.asarray(seg_ids), jnp.asarray(pos), PAGE)
    want = jattn._oracle_prefill_packed(
        jnp.asarray(qj), jpool, layer, jnp.asarray(bt), jnp.asarray(seg_ids),
        jnp.asarray(np.maximum(pos, 0)), jnp.asarray(total), 4, 128, True,
        None)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(kpool))
    live = seg_ids >= 0
    _close(got, want, ORACLE_TOL, rows=live)
    flushed = tk.attend_prefill_packed_fused(
        _t(qt), _t(_ftz(pool)), LAYER, _t(_ftz_vals(k)), _t(_ftz_vals(v)),
        _t(bt), _t(block_seg), _t(block_qstart), _t(total), PAGE, 4, 128)
    _close(flushed, kern, KERNEL_TOL, rows=live)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

LLAMA = [
    "models=micro-llama-debug", "infer.max_seq_len=128", "infer.max_reqs=4",
    "infer.page_size=16", "infer.stop_with_eos=false", "models.dim=256",
    "models.n_heads=4", "models.n_kv_heads=2", "models.head_dim=128",
    "models.inter_dim=512", "infer.kv_dtype=fp8",
]
# tests/test_kv_fp8.py's own card (`tiny_cfg`): head_dim 32
MICRO = LLAMA[:5] + ["infer.kv_dtype=fp8"]
DEEPSEEK = [
    "models=tiny-deepseek-debug", "models.n_layers=2", "infer.max_seq_len=128",
    "infer.page_size=16", "infer.max_reqs=4", "infer.stop_with_eos=false",
    "infer.kv_dtype=fp8",
]


def _serve_both(ovr, prompts, seed):
    """The same f32 tree in both engines, the same prompts submitted
    together -> (JAX tokens, port tokens, JAX engine, port engine)."""
    jeng = JEngine(jload(overrides=ovr))
    tree = jeng.model.init_params(jax.random.PRNGKey(seed), jnp.float32)
    jeng.params = jeng.executor.params = tree
    teng = Engine(tload(overrides=ovr), device="cpu",
                  params=params_from_numpy(jax.tree_util.tree_map(np.asarray, tree)))
    jr = [jeng.submit(p, JSampleParams(temperature=0.0, max_new_tokens=8))
          for p in prompts]
    tr = [teng.submit(p, SampleParams(temperature=0.0, max_new_tokens=8))
          for p in prompts]
    jeng.run_until_complete()
    teng.run_until_complete()
    want = [list(r.async_stream.tokens) for r in jr]
    got = [list(r.async_stream.tokens) for r in tr]
    return want, got, jeng, teng


@pytest.mark.parametrize("ovr,seed", [(LLAMA, 3), (MICRO, 5), (DEEPSEEK, 4)],
                         ids=["micro-llama-d128", "micro-llama", "tiny-deepseek"])
def test_engine_fp8_kv_matches_jax_engine(ovr, seed):
    prompts = ["the quick brown fox", "a", "e4m3 pages " * 6]
    want, got, jeng, teng = _serve_both(ovr, prompts, seed)
    assert all(len(t) == 8 for t in got)
    assert got == want
    assert set(teng.cache.arrays) == set(jeng.cache.arrays)
    for name, pool in teng.cache.arrays.items():
        assert pool.dtype == torch.int8
        a = pool.numpy().astype(np.int32)
        b = np.asarray(jeng.cache.arrays[name]).astype(np.int32)
        assert (a != 0).mean() > 0.01  # the served rows are there
        assert (a != b).mean() <= 1e-5, (name, (a != b).sum())
        assert np.abs(a - b).max() <= 1, name
    assert teng.cache.allocator.num_free() == teng.cache.num_pages
