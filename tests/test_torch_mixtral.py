"""chitu_tpu_torch/models/mixtral.py against chitu_tpu/models/mixtral.py,
and the port's Mixtral engine against the JAX engine, on the CPU.

The model is `tiny-mixtral-debug` at 2 layers (dim 256, 8 heads of 32, 8
experts of 256 -> 512 -> 256, top-2). The weights are drawn by the JAX
model in f32, carried across by `params_from_numpy`, dense or quantized
to soft-fp8 by the JAX package; the same token ids go through a prefill
chunk and a decode step of both models, attention through the jnp oracle
on the JAX side and the plain versions on the port's. The JAX MoE path
runs its Pallas grouped kernel in interpret mode.

Tolerance on the logits (size about 1): 5e-3. Both MoE paths round the
sorted rows, the gate/up products and the SwiGLU output to bf16; the two
grouped GEMMs sum in another order, so single bf16 values land one step
(0.4 %) apart, and soft-fp8 adds the two dequant orders (the Pallas kernel
scales f32 block sums, the port rounds the scaled weight to bf16 first).
Measured on the prefill logits: 1.4e-3 dense, 2.2e-3 soft-fp8.
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
from chitu_tpu_torch.models.llama import params_from_numpy
from chitu_tpu_torch.models.mixtral import MixtralForCausalLM
from chitu_tpu_torch.ops.qtensor import QTensor


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
MP = 8
OVR = [
    "models=tiny-mixtral-debug", "models.n_layers=2", "infer.max_seq_len=128",
    "infer.page_size=16", "infer.max_reqs=4", "infer.stop_with_eos=false",
]
TOL = 5e-3


class _QArgs:
    group_size = 128
    quantize_head = False

    def __init__(self, method):
        self.method = method


def _bt(*pages):
    bt = np.full((len(pages), MP), -1, np.int32)
    for i, p in enumerate(pages):
        bt[i, : len(p)] = p
    return bt


def _script(prefill, decode, rng, vocab):
    ids = lambda n: rng.integers(1, vocab, size=n).astype(np.int32)
    t1 = np.zeros((32,), np.int32)
    t1[:20] = ids(20)
    out = {"prefill": prefill(t1, _bt(range(0, 8))[0], 0, 20)}
    out["decode"] = decode(
        np.array([ids(1)[0], 0], np.int32), np.array([20, 0], np.int32),
        _bt(range(0, 8), []), np.array([True, False]),
    )[0]
    return out


def _jax_tree(method, merged, seed=0):
    cfg = jload(overrides=OVR)
    jm = jbuild(cfg.models, cfg)
    params = jm.init_params(jax.random.PRNGKey(seed), jnp.float32)
    if method != "none":
        params = jqt.quantize_params(params, _QArgs(method), jm)
        if merged:
            params = jqt.merge_moe_gate_up(params)
    return cfg, jm, params


@pytest.mark.parametrize(
    "case", ["dense", "soft_fp8_split", "soft_fp8_merged", "soft_fp8_rowwise"])
def test_logits_match_jax(case):
    method = "none" if case == "dense" else "soft_fp8"
    cfg, jm, params = _jax_tree(method, merged=case == "soft_fp8_merged")
    if case == "soft_fp8_rowwise":
        params = jqt.expand_fp8_scales_rowwise(params)
    tcfg = tload(overrides=OVR)
    tm = tbuild(tcfg.models, tcfg, device="cpu")
    assert isinstance(tm, MixtralForCausalLM)
    tm.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    assert tm.merged_gu == (case == "soft_fp8_merged")
    for name in ("w_gu",) if tm.merged_gu else ("w_gate", "w_up"):
        leaf = getattr(tm, name)
        assert isinstance(leaf, QTensor) == (method != "none")
        assert leaf.shape == tm._shapes()[name]
    assert isinstance(tm.moe_gate, torch.nn.Parameter)  # the router stays dense
    if case == "soft_fp8_rowwise":
        assert tm.w_down.scale.shape[-1] == tm.w_down.data.shape[-1]

    L, M = cfg.models.n_layers, 2 * 4 * 32
    pool = np.zeros((L, 40, PAGE, M), np.float32)
    jcache = {"kv": jnp.asarray(pool)}
    tcache = {"kv": torch.from_numpy(pool.copy())}

    def jprefill(tokens, bt, start, n):
        nonlocal jcache
        out, jcache = jm.prefill(
            params, jcache, jnp.asarray(tokens), jnp.asarray(bt),
            jnp.int32(start), jnp.int32(n), PAGE, attn_impl="xla")
        return np.asarray(out)

    def jdecode(*a):
        nonlocal jcache
        out, jcache = jm.decode(
            params, jcache, *map(jnp.asarray, a), PAGE, attn_impl="xla")
        return np.asarray(out)

    def tprefill(tokens, bt, start, n):
        out, _ = tm.prefill(
            tcache, torch.from_numpy(tokens), torch.from_numpy(bt), start, n, PAGE)
        return out.numpy()

    def tdecode(*a):
        out, _ = tm.decode(tcache, *map(torch.from_numpy, a), PAGE)
        return out.numpy()

    V = cfg.models.vocab_size
    want = _script(jprefill, jdecode, np.random.default_rng(1), V)
    got = _script(tprefill, tdecode, np.random.default_rng(1), V)
    for phase in ("prefill", "decode"):
        assert got[phase].shape == (V,)
        np.testing.assert_allclose(
            got[phase], want[phase], atol=TOL, rtol=TOL, err_msg=phase)


def test_params_from_numpy_carries_expert_stacks_byte_for_byte():
    _, _, params = _jax_tree("soft_fp8", merged=True, seed=2)
    got = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    lay = params["layers"]
    assert "w_gate_up" not in got and "w_gate" not in got
    for name in ("w_gu", "w_down"):
        q = got[name]
        assert isinstance(q, QTensor) and q.data.dim() == 4
        np.testing.assert_array_equal(
            q.data.view(torch.uint8).numpy(),
            np.asarray(lay[name].data).view(np.uint8))
        np.testing.assert_array_equal(q.scale.numpy(), np.asarray(lay[name].scale))
    np.testing.assert_array_equal(
        got["moe_gate"].numpy(), np.asarray(lay["moe_gate"]))
    assert isinstance(got["wqkv"], QTensor) and isinstance(got["wo"], QTensor)


ENG = OVR + ["request.max_new_tokens=8"]
GREEDY = SampleParams(temperature=0.0, max_new_tokens=8)


@pytest.mark.parametrize("method", ["none", "soft_fp8"])
def test_greedy_tokens_match_jax_engine(method):
    """The same tree in both engines (f32 weights, or the soft-fp8 tree the
    JAX package made of them; pools bf16), the same prompts submitted
    together: greedy tokens must be equal. The port merges the quantized
    gate and up stacks on load, the JAX engine here runs them split: the
    merged GEMM computes the same columns."""
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
    assert teng.model.merged_gu == (method != "none")
    assert teng.degraded == []
    prompts = ["the quick brown fox", "a", "mixture of experts " * 5]
    jr = [
        jeng.submit(p, JSampleParams(temperature=0.0, max_new_tokens=8))
        for p in prompts
    ]
    tr = [teng.submit(p, GREEDY) for p in prompts]
    jeng.run_until_complete()
    teng.run_until_complete()
    want = [list(r.async_stream.tokens) for r in jr]
    got = [list(r.async_stream.tokens) for r in tr]
    assert all(len(t) == 8 for t in got)
    assert got == want


@pytest.mark.parametrize(
    "method,act,merged,capacity",
    [("none", "int8", False, False), ("soft_fp8", "int8", True, False),
     ("fp8", "e4m3", True, False), ("w8a16", "int8", True, True),
     ("w8a8", "int8", True, True), ("w4a16", "int8", False, True)],
)
def test_engine_generates_with_every_expert_layout(method, act, merged, capacity):
    """`Engine(..., device="cpu")` on the Mixtral card: random weights,
    quantized on load. e4m3 experts merge and run the sorted path; int8
    experts merge and take the capacity route, int4 experts stay split and
    take it too (named once in `degraded`); the router stays dense; greedy
    generation repeats and everything comes back."""
    ovr = ENG + ([] if method == "none" else [
        f"quant.method={method}", "quant.quant_on_load=true",
        f"quant.fp8_act={act}"])
    eng = Engine(tload(overrides=ovr), device="cpu")
    m = eng.model
    assert m.merged_gu == merged
    assert bool(eng.degraded) == capacity
    assert isinstance(m.moe_gate, torch.nn.Parameter)
    for name in ("w_gu",) if merged else ("w_gate", "w_up"):
        assert isinstance(getattr(m, name), QTensor) == (method != "none")
    a = eng.generate("hello experts", GREEDY)
    assert len(a) == 8 and a == eng.generate("hello experts", GREEDY)
    reqs = [eng.submit(f"prompt {i} " * (1 + i % 3), GREEDY) for i in range(6)]
    eng.run_until_complete()
    assert all(len(r.async_stream.tokens) == 8 for r in reqs)
    assert eng.cache.allocator.num_free() == eng.cache.num_pages
    assert len(eng.pool) == 0 and len(eng.executor.slots.free) == 4


def test_deepseek_still_raises():
    """The DeepSeek card serves since slice 4 (its dense MLA path since
    slice 5); split over two GPUs it still raises, naming its ROADMAP
    item (queue A's multi-GPU)."""
    cfg = tload(overrides=["models=tiny-deepseek-debug", "infer.max_seq_len=128",
                           "infer.tp_size=2"])
    with pytest.raises(NotImplementedError, match="A.6: multi-GPU"):
        Engine(cfg, device="cpu")
