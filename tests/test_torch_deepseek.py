"""chitu_tpu_torch/models/deepseek_v3.py against chitu_tpu/models/deepseek_v3.py,
and the port's DeepSeek engine against the JAX engine, on the CPU.

The model is `tiny-deepseek-debug` at 2 layers (one dense, one MoE: dim
256, 8 heads, kv_lora_rank 64 + rope 16 = a latent row of 80 live lanes
in a 128-lane pool row, 16 experts of 256 -> 128 -> 256, top-4 over 4
groups, one shared expert). The weights are drawn by the JAX model in
f32, carried across by `params_from_numpy`, dense or quantized to soft-fp8
by the JAX package and merged (`wq_kv_a`, `shared_gu`, `exp_gu`); the
same token ids go through a chunked lone prefill, a packed prefill, a
hybrid step and a decode step of both models, attention through the jnp
oracle on the JAX side and the plain versions on the port's. The JAX MoE
path runs its Pallas grouped kernel in interpret mode.

Tolerance on the logits (size about 1): 5e-3, as for Mixtral: both MoE
paths round the sorted rows and the SwiGLU output to bf16 and sum in
another order, and soft-fp8 adds the two dequant orders. The pools hold
the same latent rows to 1e-4 (f32 on both sides). With the flagship's
head sizes (dn = dv = 128) the JAX model takes its B9 branch, whose
interpreted kernel rounds q and wkv_b to bf16 while the port's plain
version sums in f32: 2e-2 there.
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
from chitu_tpu.quantize import transforms as jqt
from chitu_tpu.task import SampleParams as JSampleParams
from chitu_tpu_torch import SampleParams
from chitu_tpu_torch.config import load_config as tload
from chitu_tpu_torch.engine import Engine
from chitu_tpu_torch.models import build_model as tbuild
from chitu_tpu_torch.models import deepseek_v3 as tds
from chitu_tpu_torch.models.llama import params_from_numpy
from chitu_tpu_torch.ops.qtensor import QTensor
from chitu_tpu_torch.quantize import transforms as tqt


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


jlinear = importlib.import_module("chitu_tpu.ops.linear")

PAGE = 16
MP = 8
TQ = 16  # packed query block of the hand-made slabs
OVR = [
    "models=tiny-deepseek-debug", "models.n_layers=2", "infer.max_seq_len=128",
    "infer.page_size=16", "infer.max_reqs=4", "infer.stop_with_eos=false",
]
# the flagship's head sizes at a small width: the JAX model's B9 branch
FLAGSHIP_HEADS = [
    "models.dim=256", "models.mla.qk_nope_head_dim=128",
    "models.mla.v_head_dim=128", "models.mla.kv_lora_rank=128",
    "models.mla.qk_rope_head_dim=64", "models.n_heads=4",
    "models.n_kv_heads=4",
]
TOL = 5e-3
POOL_TOL = 1e-4
B9_TOL = 2e-2


class _QArgs:
    group_size = 128
    quantize_head = False

    def __init__(self, method):
        self.method = method


@pytest.fixture
def jax_pallas():
    """op_impl=pallas in the JAX package for one test, restored after."""
    old = jlinear._OP_IMPL
    jlinear.set_op_impl("pallas")
    yield
    jlinear._OP_IMPL = old


def _bt(*pages):
    bt = np.full((len(pages), MP), -1, np.int32)
    for i, p in enumerate(pages):
        bt[i, : len(p)] = p
    return bt


def _pack(segs, R, T):
    """[(tokens, start, pages)] -> the packed slab arguments (Tq = TQ)."""
    NB = T // TQ
    tokens = np.zeros(T, np.int32)
    seg_ids = np.full(T, -1, np.int32)
    pos = np.full(T, -1, np.int32)
    block_seg = np.full(NB, -1, np.int32)
    block_q = np.zeros(NB, np.int32)
    total = np.zeros(R, np.int32)
    last = np.zeros(R, np.int32)
    bts = np.full((R, MP), -1, np.int32)
    off = 0
    for r, (toks, s, pages) in enumerate(segs):
        n = len(toks)
        tokens[off : off + n] = toks
        seg_ids[off : off + n] = r
        pos[off : off + n] = np.arange(s, s + n)
        total[r] = s + n
        last[r] = off + n - 1
        bts[r, : len(pages)] = pages
        nb = -(-n // TQ)
        block_seg[off // TQ : off // TQ + nb] = r
        block_q[off // TQ : off // TQ + nb] = s + np.arange(nb) * TQ
        off += nb * TQ
    return tokens, seg_ids, pos, bts, total, last, block_seg, block_q


def _script(m, rng, V):
    """Every public forward once, in an order that serves: a lone prompt
    in two chunks (A), a packed slab of two prompts (B, C), a hybrid step
    (decode rows A, B + prompt D), a decode step (A-D and a dead row)."""
    ids = lambda n: rng.integers(1, V, size=n).astype(np.int32)
    pa, pb, pc, pd = (list(range(8 * i, 8 * i + 8)) for i in range(4))
    a, b, c, d = ids(30), ids(12), ids(20), ids(9)
    out = {}
    t = np.zeros(32, np.int32)
    t[:20] = a[:20]
    out["prefill"] = m.prefill(t, _bt(pa)[0], 0, 20)
    t = np.zeros(16, np.int32)
    t[:10] = a[20:]
    out["prefill_chunk2"] = m.prefill(t, _bt(pa)[0], 20, 10)
    out["prefill_packed"] = m.prefill_packed(
        *_pack([(b, 0, pb), (c, 0, pc)], R=3, T=64))
    dec = (ids(2), np.array([30, 12], np.int32), _bt(pa, pb),
           np.array([True, True]))
    out["hybrid_decode"], out["hybrid_prefill"] = m.step_hybrid(
        *dec, *_pack([(d, 0, pd)], R=2, T=32))
    out["decode"] = m.decode(
        ids(5), np.array([31, 13, 20, 9, 0], np.int32),
        _bt(pa, pb, pc, pd, []), np.array([True] * 4 + [False]))[:4]
    out["pools"] = m.pools()
    return out


class _JaxModel:
    def __init__(self, jm, params, cache):
        self.jm, self.params, self.cache = jm, params, cache

    def _run(self, name, *a):
        *outs, self.cache = getattr(self.jm, name)(
            self.params, self.cache, *map(jnp.asarray, a), PAGE,
            attn_impl="xla")
        return [np.asarray(o) for o in outs] if len(outs) > 1 else np.asarray(outs[0])

    def prefill(self, tokens, bt, start, n):
        *out, self.cache = self.jm.prefill(
            self.params, self.cache, jnp.asarray(tokens), jnp.asarray(bt),
            jnp.int32(start), jnp.int32(n), PAGE, attn_impl="xla")
        return np.asarray(out[0])

    def prefill_packed(self, *a):
        return self._run("prefill_packed", *a)

    def step_hybrid(self, *a):
        return self._run("step_hybrid", *a)

    def decode(self, *a):
        return self._run("decode", *a)

    def pools(self):
        return {k: np.asarray(v) for k, v in self.cache.items()}


class _TorchModel:
    def __init__(self, tm, cache):
        self.tm, self.cache = tm, cache

    def _run(self, name, *a):
        *outs, _ = getattr(self.tm, name)(
            self.cache, *map(torch.from_numpy, a), page_size=PAGE)
        return [o.numpy() for o in outs] if len(outs) > 1 else outs[0].numpy()

    def prefill(self, tokens, bt, start, n):
        out, _ = self.tm.prefill(
            self.cache, torch.from_numpy(tokens), torch.from_numpy(bt),
            start, n, PAGE)
        return out.numpy()

    def prefill_packed(self, *a):
        return self._run("prefill_packed", *a)

    def step_hybrid(self, *a):
        return self._run("step_hybrid", *a)

    def decode(self, *a):
        return self._run("decode", *a)

    def pools(self):
        return {k: v.numpy() for k, v in self.cache.items()}


def _models(ovr, method="none", seed=0):
    cfg = jload(overrides=ovr)
    jm = jbuild(cfg.models, cfg)
    params = jm.init_params(jax.random.PRNGKey(seed), jnp.float32)
    if method != "none":
        params = jqt.merge_moe_gate_up(
            jqt.quantize_params(params, _QArgs(method), jm))
    tcfg = tload(overrides=ovr)
    tm = tbuild(tcfg.models, tcfg, device="cpu")
    assert isinstance(tm, tds.DeepSeekV3ForCausalLM)
    tm.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    spec = tm.kv_cache_spec()
    assert spec == {**jm.kv_cache_spec(), "n_layers": cfg.models.n_layers}
    pools = {
        name: np.zeros((n, 40, PAGE, tm.kv_minor), np.float32)
        for name, n in spec["layer_groups"].items()
    }
    jmod = _JaxModel(jm, params, {k: jnp.asarray(v) for k, v in pools.items()})
    tmod = _TorchModel(tm, {k: torch.from_numpy(v.copy()) for k, v in pools.items()})
    return cfg, jm, params, tm, jmod, tmod


def _compare(cfg, jmod, tmod, tol, pool_tol=POOL_TOL):
    V = cfg.models.vocab_size
    want = _script(jmod, np.random.default_rng(1), V)
    got = _script(tmod, np.random.default_rng(1), V)
    for phase in want:
        if phase == "pools":
            continue
        assert got[phase].shape == want[phase].shape, phase
        assert got[phase].shape[-1] == V
        np.testing.assert_allclose(
            got[phase], want[phase], atol=tol, rtol=tol, err_msg=phase)
    for name in want["pools"]:
        np.testing.assert_allclose(
            got["pools"][name], want["pools"][name], atol=pool_tol,
            rtol=pool_tol, err_msg=name)


@pytest.mark.parametrize("method", ["none", "soft_fp8"])
def test_four_forwards_match_jax(method):
    cfg, jm, params, tm, jmod, tmod = _models(OVR, method)
    lay = tm.moe_layers
    if method == "none":
        assert "exp_gate" in lay and "wq_a" in tm.dense_layers
    else:
        for name in ("wq_kv_a", "shared_gu", "exp_gu"):
            assert isinstance(lay[name], QTensor), name
        assert isinstance(tm.dense_layers["wq_kv_a"], QTensor)
        assert not isinstance(lay["wkv_b"], QTensor)
    assert lay["gate_bias"].dtype == torch.float32
    _compare(cfg, jmod, tmod, TOL)


def test_absorb_kernel_branch_matches_jax(jax_pallas, monkeypatch):
    """dn = dv = 128: the JAX model keeps the whole wkv_b stack out of its
    scan and runs its Pallas absorb kernel (interpreted); the port calls
    B9's wrapper on the whole stack (its plain version here)."""
    ovr = OVR + FLAGSHIP_HEADS
    cfg, jm, params, tm, jmod, tmod = _models(ovr, seed=4)
    assert jm._absorb_static_names(params["moe_layers"], None, "") == {"wkv_b"}
    calls = []
    real = tds.absorb_matmul

    def counted(x, w, layer, kind, dn, dv):
        calls.append(kind)
        return real(x, w, layer, kind, dn, dv)

    monkeypatch.setattr(tds, "absorb_matmul", counted)
    # the second stack's latent rows come from the first stack's output,
    # which carries the JAX kernel's bf16 rounding: both held to 2e-2
    _compare(cfg, jmod, tmod, B9_TOL, pool_tol=B9_TOL)
    # two stacks of one layer, uk + uv a layer, in each of the script's
    # five forward calls (two prefill chunks, packed, hybrid, decode)
    assert calls.count("uk") == calls.count("uv") == 2 * 5


def test_yarn_mscale_matches_jax():
    """max_seq_len beyond the card's original 512 positions: the YaRN
    ramp in the rope tables and the mscale² in the softmax scale."""
    ovr = OVR[:2] + ["infer.max_seq_len=1024"] + OVR[3:]
    cfg = jload(overrides=ovr)
    jm = jbuild(cfg.models, cfg)
    tcfg = tload(overrides=ovr)
    tm = tbuild(tcfg.models, tcfg, device="cpu")
    assert tm.attn_scale == pytest.approx(jm.attn_scale, rel=1e-12)
    assert tm.attn_scale > 1.0 / np.sqrt(tm.qk_head_dim)  # mscale applied
    np.testing.assert_allclose(tm.cos.numpy(), np.asarray(jm.cos), atol=1e-6)
    np.testing.assert_allclose(tm.sin.numpy(), np.asarray(jm.sin), atol=1e-6)
    params = jm.init_params(jax.random.PRNGKey(5), jnp.float32)
    tm.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    pools = {k: np.zeros((n, 80, PAGE, tm.kv_minor), np.float32)
             for k, n in tm.kv_cache_spec()["layer_groups"].items()}
    tokens = np.random.default_rng(2).integers(1, 1000, 64).astype(np.int32)
    bt = np.arange(0, 65, dtype=np.int32)
    want, _ = jm.prefill(params, {k: jnp.asarray(v) for k, v in pools.items()},
                         jnp.asarray(tokens), jnp.asarray(bt), jnp.int32(0),
                         jnp.int32(64), PAGE, attn_impl="xla")
    got, _ = tm.prefill({k: torch.from_numpy(v) for k, v in pools.items()},
                        torch.from_numpy(tokens), torch.from_numpy(bt), 0, 64,
                        PAGE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("method", ["soft_fp8", "fp8", "w8a16"])
def test_quantize_and_merge_match_jax(method):
    """`quantize_params` + `merge_moe_gate_up` on the DeepSeek tree:
    the same leaves quantized (wkv_b, norms, router and bias left alone),
    the same pairs merged, scales to one f32 ulp and the data equal but for
    the values that ulp moves."""
    cfg = jload(overrides=OVR)
    jm = jbuild(cfg.models, cfg)
    params = jm.init_params(jax.random.PRNGKey(6), jnp.float32)
    want = jqt.merge_moe_gate_up(jqt.quantize_params(params, _QArgs(method), jm))
    tcfg = tload(overrides=OVR)
    tm = tbuild(tcfg.models, tcfg, device="cpu")
    tree = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(6), jnp.float32)))
    got = tqt.merge_moe_gate_up(tqt.quantize_params(tree, _QArgs(method), tm))
    for stack in ("dense_layers", "moe_layers"):
        assert set(got[stack]) == set(want[stack]), stack
        for name, w in want[stack].items():
            g = got[stack][name]
            assert isinstance(g, QTensor) == hasattr(w, "data"), (stack, name)
            if not isinstance(g, QTensor):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
                continue
            # the JAX transform runs under jit, where XLA divides by 448
            # (127) as a product with the rounded reciprocal: scales one f32
            # ulp apart, which moves a value on a rounding tie by one step
            # (the rule of test_torch_quant._assert_q_close)
            np.testing.assert_allclose(
                g.scale.numpy(), np.asarray(w.scale), rtol=2.4e-7)
            a = g.data.view(torch.uint8).numpy()
            b = np.ascontiguousarray(np.asarray(w.data)).view(np.uint8)
            assert a.shape == b.shape, (stack, name)
            assert (a != b).mean() <= 2e-3, (stack, name, (a != b).mean())
        assert not isinstance(got[stack]["wkv_b"], QTensor)
    # every kind here is an fp8 or int8 kind: all three pairs merge
    assert "exp_gu" in got["moe_layers"]
    assert "wq_kv_a" in got["dense_layers"] and "shared_gu" in got["moe_layers"]


def test_params_from_numpy_carries_the_tree_byte_for_byte():
    cfg = jload(overrides=OVR)
    jm = jbuild(cfg.models, cfg)
    params = jqt.merge_moe_gate_up(jqt.quantize_params(
        jm.init_params(jax.random.PRNGKey(2), jnp.float32),
        _QArgs("soft_fp8"), jm))
    params["moe_layers"]["gate_bias"] = jnp.linspace(
        -1, 1, params["moe_layers"]["gate_bias"].size,
        dtype=jnp.float32).reshape(params["moe_layers"]["gate_bias"].shape)
    got = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    lay = params["moe_layers"]
    assert got["moe_layers"]["gate_bias"].dtype == torch.float32
    np.testing.assert_array_equal(
        got["moe_layers"]["gate_bias"].numpy(), np.asarray(lay["gate_bias"]))
    for name in ("exp_gu", "exp_down", "shared_gu", "wq_kv_a"):
        q = got["moe_layers"][name]
        assert isinstance(q, QTensor)
        np.testing.assert_array_equal(
            q.data.view(torch.uint8).numpy(),
            np.ascontiguousarray(np.asarray(lay[name].data)).view(np.uint8))
        np.testing.assert_array_equal(q.scale.numpy(), np.asarray(lay[name].scale))
    np.testing.assert_array_equal(
        got["moe_layers"]["wkv_b"].numpy(), np.asarray(lay["wkv_b"]))


ENG = OVR + ["request.max_new_tokens=8"]
GREEDY = SampleParams(temperature=0.0, max_new_tokens=8)


@pytest.mark.parametrize("method", ["none", "soft_fp8"])
def test_greedy_tokens_match_jax_engine(method):
    """The same tree in both engines (f32 weights, or the soft-fp8 tree
    the JAX package made of them; pools bf16), the same prompts submitted
    together: greedy tokens must be equal. The port merges the quantized
    pairs on load, the JAX engine here runs them split: the merged GEMM
    computes the same columns."""
    ovr = ENG + (
        [] if method == "none"
        else [f"quant.method={method}", "quant.quant_on_load=true"])
    jcfg = jload(overrides=ovr)
    jeng = JEngine(jcfg)
    tree = jeng.model.init_params(jax.random.PRNGKey(3), jnp.float32)
    if method != "none":
        tree = jqt.quantize_params(tree, jcfg.quant, jeng.model)
    jeng.params = jeng.executor.params = tree
    teng = Engine(
        tload(overrides=ovr), device="cpu",
        params=params_from_numpy(jax.tree_util.tree_map(np.asarray, tree)),
    )
    assert set(teng.cache.arrays) == {"kv_dense", "kv_moe"}
    assert teng.cache.minor == 128 and teng.degraded == []
    assert ("exp_gu" in teng.model.moe_layers) == (method != "none")
    prompts = ["the quick brown fox", "a", "multi-head latent attention " * 4]
    jr = [jeng.submit(p, JSampleParams(temperature=0.0, max_new_tokens=8))
          for p in prompts]
    tr = [teng.submit(p, GREEDY) for p in prompts]
    jeng.run_until_complete()
    teng.run_until_complete()
    want = [list(r.async_stream.tokens) for r in jr]
    got = [list(r.async_stream.tokens) for r in tr]
    assert all(len(t) == 8 for t in got)
    assert got == want


@pytest.mark.parametrize(
    "method,act", [("none", "int8"), ("soft_fp8", "int8"), ("fp8", "e4m3")])
def test_engine_generates(method, act):
    """`Engine(..., device="cpu")` on the DeepSeek card, quantized on
    load: the pairs merge, wkv_b and the router stay dense, greedy
    generation repeats, a burst completes and everything comes back."""
    ovr = ENG + ([] if method == "none" else [
        f"quant.method={method}", "quant.quant_on_load=true",
        f"quant.fp8_act={act}"])
    eng = Engine(tload(overrides=ovr), device="cpu")
    lay = eng.model.moe_layers
    assert eng.degraded == []
    assert isinstance(lay["wkv_b"], torch.Tensor)
    assert isinstance(lay["moe_gate"], torch.Tensor)
    assert ("exp_gu" in lay) == (method != "none")
    a = eng.generate("hello latent", GREEDY)
    assert len(a) == 8 and a == eng.generate("hello latent", GREEDY)
    reqs = [eng.submit(f"prompt {i} " * (1 + i % 3), GREEDY) for i in range(6)]
    eng.run_until_complete()
    assert all(len(r.async_stream.tokens) == 8 for r in reqs)
    assert eng.cache.allocator.num_free() == eng.cache.num_pages
    assert len(eng.pool) == 0 and len(eng.executor.slots.free) == 4

