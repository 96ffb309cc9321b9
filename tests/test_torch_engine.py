"""The port's engine (chitu_tpu_torch/engine.py) on the CPU: the flows the
verify recipe drives on the JAX engine, and greedy tokens equal to the
JAX engine's on the same weights."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.config import load_config as jload
from chitu_tpu.engine import Engine as JEngine
from chitu_tpu.task import SampleParams as JSampleParams
from chitu_tpu_torch import SampleParams, load_config
from chitu_tpu_torch.engine import Engine
from chitu_tpu_torch.models.llama import params_from_numpy


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


TINY = [
    "models=micro-llama-debug", "infer.max_seq_len=128", "infer.max_reqs=4",
    "infer.page_size=16", "request.max_new_tokens=8",
    "infer.stop_with_eos=false",
]
GREEDY = SampleParams(temperature=0.0, max_new_tokens=8)


def _engine(*extra, **kw):
    return Engine(load_config(overrides=TINY + list(extra)), device="cpu", **kw)


def test_greedy_deterministic():
    eng = _engine()
    a = eng.generate("hello world", GREEDY)
    b = eng.generate("hello world", GREEDY)
    assert len(a) == 8 and a == b


def test_mixed_burst_beyond_max_reqs_returns_everything():
    eng = _engine()
    params = [
        GREEDY,
        SampleParams(temperature=0.8, top_k=16, top_p=0.9, max_new_tokens=5),
        SampleParams(temperature=1.0, frequency_penalty=0.5, max_new_tokens=7),
    ]
    reqs = [
        eng.submit(f"prompt number {i} " * (1 + i % 3), params[i % 3])
        for i in range(9)  # > max_reqs = 4
    ]
    eng.run_until_complete()
    for i, r in enumerate(reqs):
        assert len(r.async_stream.tokens) == params[i % 3].max_new_tokens
        assert r.finish_reason == "length"
    assert eng.cache.allocator.num_free() == eng.cache.num_pages
    assert len(eng.pool) == 0
    assert len(eng.executor.slots.free) == 4
    assert int(eng.executor.counts.sum()) == 0  # freed slots' counts reset


def test_overlong_prompt_rejected_cleanly():
    eng = _engine()
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        eng.submit("", GREEDY, prompt_tokens=[5] * 200)
    assert len(eng.pool) == 0
    assert eng.generate("still serving", GREEDY)  # the engine still works


def test_chunked_prefill_matches_unchunked():
    prompt = "word " * 18  # ~90 tokens > a chunk of 32
    want = _engine().generate(prompt, GREEDY)
    got = _engine("infer.prefill_chunk=32").generate(prompt, GREEDY)
    assert got == want and len(got) == 8


def test_hybrid_step_matches_phase_separated():
    p = SampleParams(temperature=0.0, max_new_tokens=24)

    def run(hybrid):
        eng = _engine(f"infer.hybrid_step={hybrid}", "infer.decode_window=4")
        r1 = eng.submit("first request starts decoding", p)
        eng.step()
        eng.step()
        r2 = eng.submit("second arrives mid flight", p)
        r3 = eng.submit("third also shows up", p)
        eng.run_until_complete()
        return [list(r.async_stream.tokens) for r in (r1, r2, r3)]

    assert run("true") == run("false")


PARITY = TINY[:-2] + [
    "models.dim=256", "models.n_heads=4", "models.n_kv_heads=2",
    "models.head_dim=128", "models.inter_dim=512", "infer.stop_with_eos=false",
]


def test_greedy_tokens_match_jax_engine():
    """Same f32 weights in both engines (the pools are bf16 in both), the
    same prompts submitted together: greedy tokens must be equal."""
    jeng = JEngine(jload(overrides=PARITY))
    tree = jeng.model.init_params(jax.random.PRNGKey(3), jnp.float32)
    jeng.params = jeng.executor.params = tree
    teng = Engine(
        load_config(overrides=PARITY), device="cpu",
        params=params_from_numpy(jax.tree_util.tree_map(np.asarray, tree)),
    )
    prompts = ["the quick brown fox", "a", "paged attention " * 5]
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


def test_greedy_tokens_match_jax_engine_soft_fp8():
    """A soft-fp8 tree quantized by the JAX package from f32 weights, the
    same tree in both engines (activations f32, pools bf16): greedy tokens
    must be equal."""
    from chitu_tpu.quantize import quantize_params as jquantize

    ovr = PARITY + ["quant.method=soft_fp8", "quant.quant_on_load=true"]
    jcfg = jload(overrides=ovr)
    jeng = JEngine(jcfg)
    tree = jquantize(
        jeng.model.init_params(jax.random.PRNGKey(5), jnp.float32),
        jcfg.quant, jeng.model,
    )
    jeng.params = jeng.executor.params = tree
    teng = Engine(
        load_config(overrides=ovr), device="cpu",
        params=params_from_numpy(jax.tree_util.tree_map(np.asarray, tree)),
    )
    from chitu_tpu_torch.ops.qtensor import QTensor

    assert isinstance(teng.model.wqkv, QTensor)
    prompts = ["soft fp8 stores bytes", "b", "and computes in bf16 " * 4]
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
    "method",
    ["soft_fp8", "fp8", "w8a16", "w8a8", "simple_w8a8", "w4a16", "w4a16_awq",
     "w4a16_gptq", "awq", "gptq", "llmint8"],
)
def test_quant_on_load_every_method(method):
    """Every method name of the JAX package's `_KIND_BY_METHOD` is accepted
    with quant_on_load: the projections become QTensors of its kind
    (int4 packed where the width allows), norms / embeddings / biases stay
    dense, greedy generation is deterministic and everything is returned."""
    from chitu_tpu.quantize.transforms import _KIND_BY_METHOD as JKINDS
    from chitu_tpu_torch.ops.qtensor import QTensor

    assert method in JKINDS
    eng = _engine(
        f"quant.method={method}", "quant.quant_on_load=true",
        "quant.fp8_act=e4m3", "quant.quantize_head=true",
        "models.dim=256", "models.n_heads=4", "models.n_kv_heads=2",
        "models.head_dim=128", "models.inter_dim=512",
    )
    m = eng.model
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        q = getattr(m, name)
        assert isinstance(q, QTensor) and q.kind.value == JKINDS[method].value
        assert q.shape == m._shapes()[name]
        assert (q.oc_idx is not None) == (method == "llmint8")
    if JKINDS[method].value == "w4a16":
        assert m.wqkv.packed and m.w_gate_up.packed and not m.wo.packed
    for name in ("embed", "norm", "attn_norm", "ffn_norm"):
        assert isinstance(getattr(m, name), torch.nn.Parameter)
    if not eng.cfg.models.tie_word_embeddings:
        assert isinstance(m.lm_head, QTensor) == (method != "llmint8")
    a = eng.generate("hello world", GREEDY)
    assert len(a) == 8 and a == eng.generate("hello world", GREEDY)
    assert eng.cache.allocator.num_free() == eng.cache.num_pages
    assert len(eng.pool) == 0


def test_unknown_quant_method_rejected():
    cfg = load_config(overrides=TINY + ["quant.method=int3", "quant.quant_on_load=true"])
    with pytest.raises(ValueError, match="unknown quant method"):
        Engine(cfg, device="cpu")


@pytest.mark.parametrize(
    "override",
    [
        "infer.pp_size=2", "quant.method=soft_fp8", "infer.dp_size=2",
        "infer.ring_prefill=true", "models=tiny-deepseek-debug",
    ],
)
def test_unported_configurations_raise(override):
    # tp_size=2 serves since slice 13 (tests/test_torch_tp.py), pp_size=2
    # since slice 14 (tests/test_torch_pp.py) and dp_size=2 since slice 16
    # (tests/test_torch_ring.py): on one process each asks for the ranks
    # it needs. ring_prefill, and the DeepSeek card's ring KV, at dp 1
    # serve the default tokens (the JAX engine disables them there).
    # What still raises: a quant method on random weights without
    # quant_on_load
    extra = ["infer.ring_kv=true"] if "deepseek" in override else []
    cfg = load_config(overrides=TINY + [override] + extra)
    if override in ("infer.pp_size=2", "infer.dp_size=2"):
        with pytest.raises(ValueError, match="num_processes=2"):
            Engine(cfg, device="cpu")
        return
    if override in ("infer.ring_prefill=true", "models=tiny-deepseek-debug"):
        plain = load_config(overrides=TINY + [override])
        want = Engine(plain, device="cpu").generate("hello world", GREEDY)
        eng = Engine(cfg, device="cpu")
        assert eng.executor.ring_kv_axis == ""
        assert eng.generate("hello world", GREEDY) == want
        return
    with pytest.raises(NotImplementedError, match="ROADMAP|slice"):
        Engine(cfg, device="cpu")


@pytest.mark.parametrize(
    "override", ["infer.spec_decode=ngram", "infer.prefix_cache=true"]
)
def test_configurations_ported_in_slice_12_serve(override):
    """Refused until slice 12 (the n-gram spec decode and the prefix
    cache): they now build and serve a greedy request."""
    eng = _engine(override)
    assert eng.generate("hello world", GREEDY) == _engine().generate(
        "hello world", GREEDY)
    assert eng.cache.allocator.num_free() == eng.cache.num_pages


# ---------------------------------------------------------------------------
# infer.attn_type and infer.op_impl: the JAX semantics, honoured by the port
# ---------------------------------------------------------------------------

from chitu_tpu_torch.models import deepseek_v3 as tds  # noqa: E402
from chitu_tpu_torch.models import llama as tllama  # noqa: E402
from chitu_tpu_torch.ops import attention_kernels as tk  # noqa: E402
from chitu_tpu_torch.ops import linear as tlinear  # noqa: E402

DS = ["models=tiny-deepseek-debug", "models.n_layers=2"]
# the flagship's MLA head sizes at a small width, where B9 runs
DS_B9 = DS + [
    "models.mla.qk_nope_head_dim=128", "models.mla.v_head_dim=128",
    "models.mla.kv_lora_rank=128", "models.mla.qk_rope_head_dim=64",
    "models.n_heads=4", "models.n_kv_heads=4",
]


def _refuse(monkeypatch, mod, names):
    """Make each `mod.name` raise when called: the route must not reach
    it."""
    def make(name):
        def refuse(*a, **kw):
            raise AssertionError(f"{name} reached under the plain route")
        return refuse

    for n in names:
        monkeypatch.setattr(mod, n, make(n))


@pytest.fixture
def keep_op_impl(monkeypatch):
    """An engine sets the port's op_impl switch; restore it after."""
    monkeypatch.setattr(tlinear, "_OP_IMPL", tlinear.get_op_impl())


@pytest.mark.parametrize("card", [[], DS], ids=["llama", "deepseek"])
@pytest.mark.parametrize("attn_type", ["ref", "xla"])
def test_attn_type_ref_routes_to_plain_attention(monkeypatch, keep_op_impl,
                                                 attn_type, card):
    """attn_type xla|ref: every attention call takes the plain versions
    (the kernel wrappers are never called); greedy tokens equal the
    default route's on the CPU."""
    eng = _engine(*card)
    assert eng.model.attn_route == "kernels"
    want = eng.generate("route me", GREEDY)
    _refuse(monkeypatch, tk, tk.PLAIN.__dict__)
    eng = _engine(*card, f"infer.attn_type={attn_type}")
    assert eng.model.attn_route == "plain"
    assert eng.generate("route me", GREEDY) == want
    with pytest.raises(AssertionError, match="reached under the plain route"):
        _engine(*card).generate("route me", GREEDY)


@pytest.mark.parametrize("method,card,refused", [
    ("soft_fp8", [], [(tlinear, ("quant_gemm",))]),
    ("w8a8", [], [(tlinear, ("int8_gemm", "quant_acts")),
                  (tllama, ("rms_norm_quant", "quant_acts"))]),
    ("none", DS_B9, [(tds, ("absorb_matmul",))]),
], ids=["soft_fp8", "w8a8", "deepseek_absorb"])
def test_op_impl_xla_routes_to_plain_gemms(monkeypatch, keep_op_impl, method,
                                           card, refused):
    """op_impl=xla: the calls JAX's get_op_impl() governs take their
    plain versions (B6/B7, B10, the W8A8 quantizers, B9); greedy tokens
    equal the kernels' route on the CPU."""
    quant = ([f"quant.method={method}", "quant.quant_on_load=true"]
             if method != "none" else [])
    want = _engine(*card, *quant).generate("route me", GREEDY)
    assert tlinear.get_op_impl() == "auto" and tlinear.op_kernels()
    for mod, names in refused:
        _refuse(monkeypatch, mod, names)
    eng = _engine(*card, *quant, "infer.op_impl=xla")
    assert tlinear.get_op_impl() == "xla" and not tlinear.op_kernels()
    assert eng.generate("route me", GREEDY) == want
    with pytest.raises(AssertionError, match="reached under the plain route"):
        _engine(*card, *quant).generate("route me", GREEDY)


def test_op_impl_xla_turns_the_dense_kernel_off(monkeypatch, keep_op_impl):
    """B13 (switched on) runs only while op_impl keeps the kernels."""
    monkeypatch.setattr(tlinear, "_DENSE_KERNEL", True)
    want = _engine().generate("route me", GREEDY)
    _refuse(monkeypatch, tlinear, ("dense_matmul_stacked",))
    assert _engine("infer.op_impl=xla").generate("route me", GREEDY) == want
    with pytest.raises(AssertionError, match="reached under the plain route"):
        _engine().generate("route me", GREEDY)


@pytest.mark.parametrize("override", ["infer.attn_type=flash",
                                      "infer.op_impl=cuda"])
def test_unknown_attn_type_or_op_impl_rejected(override):
    with pytest.raises(ValueError, match="expected one of"):
        Engine(load_config(overrides=TINY + [override]), device="cpu")
