"""DeepSeek's dense MLA path (`infer.mla_absorb=none`) and the dense
stacked-layer GEMM (B13) of the port against the JAX package on the CPU.

Dense MLA: per-head K = [k_nope | k_pe] and V through the whole `wkv_b`,
plain multi-head attention at qk_head_dim on the split K/V layout, V padded
to qk_head_dim in the pool row. `tiny-deepseek-debug` at 2 layers (one
dense, one MoE: 8 heads of 32 + 16 = 48 lanes, a 768-lane pool row), the
JAX model's f32 tree carried across by `params_from_numpy`:
- the four forwards (a lone prefill in two chunks, a packed slab, a hybrid
  step, a decode step) against the JAX model's `_mla_dense`, attention
  through the jnp oracle on the JAX side and the plain versions here;
- the dense pool geometry's appends byte-equal to the JAX appends on the
  same rows (bf16 and e4m3 pools);
- greedy tokens equal to the JAX engine's at `mla_absorb=none`, with bf16
  and with fp8 pools, and the port's own dense tokens equal to its absorb
  tokens, as tests/test_deepseek.py checks the JAX engine.
B13: the plain version against the interpreted Pallas kernel
(`dense_matmul_stacked(..., interpret=True)`), and Llama logits with the
dense kernel switched on in both packages.

Tolerances: logits 5e-3 and f32 pools 1e-4, as tests/test_torch_deepseek.py
holds the absorb path (the same f32 math in another order; the MoE path
rounds its sorted rows to bf16 on both sides). Appends: bytes equal. B13:
both sides multiply the same bf16 values exactly and sum in f32 in another
order: 1e-5 of a row's size. Llama with B13 on: 5e-3 (see that test).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.config import load_config as jload
from chitu_tpu.engine import Engine as JEngine
from chitu_tpu.models import build_model as jbuild
from chitu_tpu.models.common import kv_pool_minor as jminor
from chitu_tpu.ops import attention as jattn
from chitu_tpu.ops.pallas_quant_gemm import dense_matmul_stacked as jdense
from chitu_tpu.task import SampleParams as JSampleParams
from chitu_tpu_torch import SampleParams
from chitu_tpu_torch.config import load_config as tload
from chitu_tpu_torch.engine import Engine
from chitu_tpu_torch.models import build_model as tbuild
from chitu_tpu_torch.models.common import kv_pool_minor
from chitu_tpu_torch.models.llama import params_from_numpy
from chitu_tpu_torch.ops import attention as tattn
from chitu_tpu_torch.ops import dense_gemm_kernels as tdense
from chitu_tpu_torch.ops import linear as tlinear

from test_torch_deepseek import PAGE, _JaxModel, _TorchModel, _compare

jlinear = importlib.import_module("chitu_tpu.ops.linear")

DENSE = [
    "models=tiny-deepseek-debug", "models.n_layers=2", "infer.max_seq_len=128",
    "infer.page_size=16", "infer.max_reqs=4", "infer.stop_with_eos=false",
    "infer.mla_absorb=none",
]
TOL = 5e-3
POOL_TOL = 1e-4


def _dense_models(seed=0):
    cfg = jload(overrides=DENSE)
    jm = jbuild(cfg.models, cfg)
    assert not jm.absorb and jm.head_dim == 48
    params = jm.init_params(jax.random.PRNGKey(seed), jnp.float32)
    tcfg = tload(overrides=DENSE)
    tm = tbuild(tcfg.models, tcfg, device="cpu")
    assert not tm.absorb and tm.head_dim == jm.head_dim
    tm.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    spec = tm.kv_cache_spec()
    assert spec == {**jm.kv_cache_spec(), "n_layers": cfg.models.n_layers}
    M = kv_pool_minor(spec["kv_heads"], spec["head_dim"])
    assert M == jminor(8, 48) == 2 * 8 * 48
    pools = {name: np.zeros((n, 40, PAGE, M), np.float32)
             for name, n in spec["layer_groups"].items()}
    jmod = _JaxModel(jm, params, {k: jnp.asarray(v) for k, v in pools.items()})
    tmod = _TorchModel(tm, {k: torch.from_numpy(v.copy()) for k, v in pools.items()})
    return cfg, jmod, tmod


def test_four_forwards_match_jax_mla_dense():
    """Logits of every forward and the two f32 pools against the JAX
    model's dense path (the pool rows: K and V padded with zeros)."""
    cfg, jmod, tmod = _dense_models()
    _compare(cfg, jmod, tmod, TOL, POOL_TOL)
    pool = tmod.cache["kv_moe"].numpy().reshape(-1, 2, 8, 48)
    assert np.abs(pool[:, 1, :, 32:]).max() == 0.0  # V's pad lanes
    assert np.abs(pool[:, 0, :, 32:]).max() > 0.0  # k_pe lanes


@pytest.mark.parametrize("pool_dtype", ["float32", "int8"])
def test_dense_pool_appends_byte_equal(pool_dtype):
    """The dense geometry's rows [K_0..K_7 V_0..V_7] with V padded to 48
    lanes, written by the three appends, byte for byte as in JAX."""
    r = np.random.default_rng(3)
    H, D, T, mp = 8, 48, 20, 4
    M = 2 * H * D
    k = r.standard_normal((T, H, D)).astype(np.float32)
    v = np.pad(r.standard_normal((T, H, 32)), ((0, 0), (0, 0), (0, 16)))
    v = v.astype(np.float32)
    pool = np.zeros((2, 12, PAGE, M), getattr(np, pool_dtype))
    bt = np.arange(mp, dtype=np.int32) + 2
    pos = np.arange(3, 3 + T, dtype=np.int32)
    tp = torch.from_numpy(pool.copy())
    tattn.append_prefill(tp, 1, torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(bt), torch.from_numpy(pos), T - 2, PAGE)
    jp = jattn.append_prefill(jnp.asarray(pool), jnp.int32(1), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(bt), jnp.asarray(pos),
                              jnp.int32(T - 2), PAGE)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    bts = np.stack([bt, bt + 4])
    seq = np.array([30, 5], np.int32)
    val = np.array([True, True])
    tattn.append_decode(tp, 0, torch.from_numpy(k[:2]), torch.from_numpy(v[:2]),
                        torch.from_numpy(bts), torch.from_numpy(seq),
                        torch.from_numpy(val), PAGE)
    jp = jattn.append_decode(jp, jnp.int32(0), jnp.asarray(k[:2]),
                             jnp.asarray(v[:2]), jnp.asarray(bts),
                             jnp.asarray(seq), jnp.asarray(val), PAGE)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    seg = np.array([0] * 6 + [1] * 6 + [-1] * 8, np.int32)
    ppos = np.array(list(range(6)) + list(range(10, 16)) + [-1] * 8, np.int32)
    tattn.append_prefill_packed(tp, 1, torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(bts), torch.from_numpy(seg),
                                torch.from_numpy(ppos), PAGE)
    jp = jattn.append_prefill_packed(jp, jnp.int32(1), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(bts),
                                     jnp.asarray(seg), jnp.asarray(ppos), PAGE)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_dense_mla_pool_geometry_matches_jax():
    """DeepSeek-R1's dense MLA pool: 2 x 128 heads x 192 = 49,152 lanes a
    row in both layer groups, bf16 or int8 (e4m3 bits), as the JAX cache
    builds it."""
    from chitu_tpu.kvcache.paged import PagedKVCache as JPagedKVCache
    from chitu_tpu_torch.kvcache import PagedKVCache

    groups = {"kv_dense": 3, "kv_moe": 1}
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.int8, torch.int8)):
        t = PagedKVCache(4, 2, PAGE, 128, 192, dtype=tdt, layer_groups=groups)
        j = JPagedKVCache(4, 2, PAGE, 128, 192, dtype=jdt, layer_groups=groups)
        assert t.minor == j.minor == 49152
        assert list(t.arrays) == list(j.arrays)
        for name, a in t.arrays.items():
            assert tuple(a.shape) == tuple(j.arrays[name].shape)
            assert a.dtype == tdt
        assert t.bytes() == sum(a.size * a.dtype.itemsize for a in j.arrays.values())


GREEDY = SampleParams(temperature=0.0, max_new_tokens=8)
PROMPTS = ["the quick brown fox", "a", "multi-head latent attention " * 4]


@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"])
def test_greedy_tokens_match_jax_engine_mla_dense(kv_dtype):
    """The same f32 tree in both engines at mla_absorb=none, the same
    prompts submitted together: greedy tokens equal."""
    ovr = DENSE + [f"infer.kv_dtype={kv_dtype}"]
    jeng = JEngine(jload(overrides=ovr))
    tree = jeng.model.init_params(jax.random.PRNGKey(3), jnp.float32)
    jeng.params = jeng.executor.params = tree
    teng = Engine(tload(overrides=ovr), device="cpu",
                  params=params_from_numpy(jax.tree_util.tree_map(np.asarray, tree)))
    assert not teng.model.absorb
    assert teng.cache.minor == 768 and set(teng.cache.arrays) == {"kv_dense", "kv_moe"}
    want_dt = torch.int8 if kv_dtype == "fp8" else torch.bfloat16
    assert all(a.dtype == want_dt for a in teng.cache.arrays.values())
    jr = [jeng.submit(p, JSampleParams(temperature=0.0, max_new_tokens=8))
          for p in PROMPTS]
    tr = [teng.submit(p, GREEDY) for p in PROMPTS]
    jeng.run_until_complete()
    teng.run_until_complete()
    got = [list(r.async_stream.tokens) for r in tr]
    assert all(len(t) == 8 for t in got)
    assert got == [list(r.async_stream.tokens) for r in jr]
    assert teng.cache.allocator.num_free() == teng.cache.num_pages


@pytest.mark.parametrize("extra", [["models.n_layers=4"], ["dtype=float32"]],
                         ids=["card-bf16", "f32"])
def test_mla_absorb_none_matches_absorb(extra):
    """Dense per-head K/V and the absorbed latent row are the same
    attention: the port's greedy tokens agree between the two, and the
    dense pool rows are wider. As tests/test_deepseek.py:138 runs it (the
    card's four layers, bf16), and in f32 at two layers. (In bf16 at two
    layers, the port's random weights put a near-tie on this prompt's
    first token: the two paths round in other places, and their logits
    are 9e-3 apart there.)"""
    p = SampleParams(temperature=0.0, max_new_tokens=5)
    absorb = Engine(tload(overrides=DENSE[:-1] + extra), device="cpu")
    dense = Engine(tload(overrides=DENSE + extra), device="cpu")
    assert absorb.model.absorb and not dense.model.absorb
    assert dense.cache.minor > absorb.cache.minor
    assert dense.generate("absorb equivalence", p) == absorb.generate(
        "absorb equivalence", p)


# ---------------------------------------------------------------------------
# B13: the dense stacked-layer GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,K,N", [(5, 256, 384), (16, 1024, 128), (40, 384, 256),
                                   (3, 200, 256)])
def test_dense_matmul_stacked_matches_interpreted_pallas(T, K, N):
    """bf16 operands (both sides multiply the same values exactly), f32
    sums and output; K = 200 is off the kernel's geometry rule and takes
    the plain product on both sides."""
    r = np.random.default_rng(T)
    w = r.standard_normal((3, K, N)).astype(jnp.bfloat16)
    x = r.standard_normal((T, K)).astype(jnp.bfloat16)
    want = np.asarray(jdense(jnp.asarray(x), jnp.int32(2), jnp.asarray(w),
                             interpret=True))
    tw = torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
    tx = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    got = tdense.dense_matmul_stacked(tx, 2, tw)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert tdense.kernel_eligible(K, N) == (K % 128 == 0)
    scale = np.linalg.norm(want, axis=-1, keepdims=True) / np.sqrt(N)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale.max()


@pytest.fixture
def dense_kernel_on():
    """B13 switched on in both packages for one test, restored after: the
    JAX flag needs op_impl=pallas too."""
    old = (jlinear._DENSE_KERNEL, jlinear._OP_IMPL, tlinear.get_dense_kernel())
    jlinear._DENSE_KERNEL = True
    jlinear.set_op_impl("pallas")
    tlinear.set_dense_kernel(True)
    yield
    jlinear._DENSE_KERNEL, jlinear._OP_IMPL = old[:2]
    tlinear.set_dense_kernel(old[2])


def test_llama_logits_with_dense_kernel(dense_kernel_on, monkeypatch):
    """Llama (micro-llama at head_dim 128, 2 layers, every stacked leaf a
    multiple of 128 wide) with B13 on: the port runs every projection of
    the stacks through B13's wrapper (its plain version here); the JAX
    model scan-slices its dense leaves (`split_scan_leaves`), so its
    `linear` sees a 2-D layer and takes `jnp.dot` whatever the flag. The
    port's route rounds the activations to bf16 as the TPU kernel does;
    the JAX route keeps them in f32: 5e-3 on logits of size about 1."""
    from test_torch_llama import OVR, _Jax, _Torch, _script

    calls = []
    real = tlinear.dense_matmul_stacked

    def counted(x, layer, w):
        calls.append(tuple(w.shape))
        return real(x, layer, w)

    monkeypatch.setattr(tlinear, "dense_matmul_stacked", counted)
    jcfg, tcfg = jload(overrides=OVR), tload(overrides=OVR)
    jm = jbuild(jcfg.models, jcfg)
    params = jm.init_params(jax.random.PRNGKey(0), jnp.float32)
    tm = tbuild(tcfg.models, tcfg, device="cpu")
    tm.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    pool = np.zeros((2, 40, PAGE, 2 * 2 * 128), np.float32)
    got = _script(_Torch(tm, pool), np.random.default_rng(0))
    want = _script(_Jax(jm, params, pool, "xla"), np.random.default_rng(0))
    for phase in ("prefill", "decode", "prefill_packed", "step_hybrid"):
        g, rows = got[phase]
        np.testing.assert_allclose(g[rows], want[phase][0][rows], atol=TOL,
                                   rtol=TOL, err_msg=phase)
    # four stacked projections a layer, two layers, in each of the five
    # forward calls of the script
    assert len(calls) == 4 * 2 * 5
    assert {s[0] for s in calls} == {2}
