"""AWQ calibration in the port (`chitu_tpu_torch/quantize/awq.py`)
against `chitu_tpu/quantize/awq.py`, on the CPU.

The same numpy inputs go through both packages' functions:
- `auto_scale_search` and `auto_clip_search` on planted-outlier problems
  (the regime AWQ exists for, as in tests/test_awq_calibration.py): equal
  scales (relative 1e-5) and clipped weights (1e-6), where no two grid
  points tie within 1e-6 relative (checked); the port also keeps the JAX
  test's own properties: the scale search beats RTN by 20 %, clipping
  never hurts;
- `calibrate_llama` on a 2-layer dim-256 f32 tree carried across by
  `params_from_numpy`: every projection's input statistics per layer,
  relative 1e-2. The loop runs its products on bf16 activations in both
  packages; XLA keeps some bf16 intermediates at f32 precision inside a
  fusion, so a product's last bit differs now and then, and that flows
  through the loop (measured up to 7e-3 at layer 2);
- `awq_quantize_llama_params` of both packages on the same statistics
  (the JAX ones), merged and unmerged layouts: the W4 codes equal in at
  least 99.9 % of entries, the folded norms relative 1e-5;
- the port's engine serving the JAX package's AWQ tree gives the JAX
  model's logits within 5e-3 (the limit of tests/test_torch_llama.py's
  quantized cases), and the port's own AWQ tree serves and tracks the
  dense logits no worse than 1.2 x RTN W4A16 (the JAX test's criterion).
"""

import dataclasses as dc
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.config import load_config as jload
from chitu_tpu.models import build_model as jbuild
from chitu_tpu.quantize import awq as jawq
from chitu_tpu_torch import SampleParams
from chitu_tpu_torch.config import load_config as tload
from chitu_tpu_torch.engine import Engine
from chitu_tpu_torch.models import build_model as tbuild
from chitu_tpu_torch.models.llama import params_from_numpy
from chitu_tpu_torch.ops.qtensor import QTensor, QuantKind
from chitu_tpu_torch.quantize import awq, quantize_weight


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one torch thread keeps them quick under the
    suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_op_impl_auto():
    """The JAX op_impl switch at "auto": a JAX test in the same worker may
    leave it at "pallas"."""
    mod = importlib.import_module("chitu_tpu.ops.linear")
    old = mod._OP_IMPL
    mod._OP_IMPL = "auto"
    yield
    mod._OP_IMPL = old


def _outlier_problem(seed, K=256, N=128, S=64):
    """numpy draws: activations with 5 % of the channels boosted 30x."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((S, K)).astype(np.float32)
    x *= np.where(r.random(K) < 0.05, 30.0, 1.0).astype(np.float32)[None]
    w = (r.standard_normal((K, N)) * 0.05).astype(np.float32)
    return x, w


def _grid_losses(x, w, n_grid=20):
    """Every grid point's loss of the scale search (the port's arithmetic)."""
    xf, wf = torch.from_numpy(x), torch.from_numpy(w)
    y_ref = xf @ wf
    act = xf.abs().mean(0).clamp_min(1e-8)
    out = []
    for i in range(n_grid):
        s = act ** (i / n_grid)
        s = s / torch.sqrt(s.max() * s.min())
        wq = awq._w4_roundtrip(wf * s[:, None], 128)
        out.append(float((((xf / s) @ wq - y_ref) ** 2).mean()))
    return np.array(out)


def _mse(x, w, wq, s=None):
    y = (x / s[None, :] if s is not None else x) @ wq
    return float(((y - x @ w) ** 2).mean())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auto_scale_search_matches_jax(seed):
    x, w = _outlier_problem(seed)
    losses = np.sort(_grid_losses(x, w))
    assert losses[1] - losses[0] > 1e-6 * losses[0]  # no tie at the top
    sj, lj = jawq.auto_scale_search(jnp.asarray(w), jnp.asarray(x))
    st, lt = awq.auto_scale_search(torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auto_clip_search_matches_jax(seed):
    x, w = _outlier_problem(seed)
    cj = jawq.auto_clip_search(jnp.asarray(w), jnp.asarray(x))
    ct = awq.auto_clip_search(torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)


def test_auto_scale_beats_rtn_and_clip_never_hurts():
    x, w = map(torch.from_numpy, _outlier_problem(0))
    rtn = quantize_weight(w, QuantKind.W4A16).dequantize(torch.float32)
    s, _ = awq.auto_scale_search(w, x)
    scaled = quantize_weight(w * s[:, None], QuantKind.W4A16).dequantize(
        torch.float32)
    assert _mse(x, w, scaled, s) < 0.8 * _mse(x, w, rtn)
    x, w = map(torch.from_numpy, _outlier_problem(1))
    rtn = quantize_weight(w, QuantKind.W4A16).dequantize(torch.float32)
    clipped = quantize_weight(awq.auto_clip_search(w, x), QuantKind.W4A16)
    assert _mse(x, w, clipped.dequantize(torch.float32)) <= 1.01 * _mse(x, w, rtn)


# ---------------------------------------------------------------------------
# the llama driver: one JAX tree, both packages
# ---------------------------------------------------------------------------

OVR = [
    "models=micro-llama-debug", "models.n_layers=2", "models.dim=256",
    "models.n_heads=8", "models.n_kv_heads=4", "models.inter_dim=256",
    "models.vocab_size=512", "infer.max_seq_len=128", "infer.page_size=16",
    "infer.max_reqs=4", "infer.stop_with_eos=false",
]
LAYOUTS = {"merged": "auto", "unmerged": "off"}
rng = np.random.default_rng(0)
CALIB = rng.integers(5, 500, 96)
HOLD = rng.integers(5, 500, 48)


def _jax_tree(layout, dtype):
    """A JAX tree with the JAX test's planted embedding outliers (5 % of
    the columns x 8), and its model."""
    cfg = jload(overrides=OVR + [f"infer.merge_qkv_gate_up={LAYOUTS[layout]}"])
    m = jbuild(cfg.models, cfg)
    p = m.init_params(jax.random.PRNGKey(3), dtype)
    boost = jnp.where(
        jax.random.uniform(jax.random.PRNGKey(7), (cfg.models.dim,)) < 0.05,
        8.0, 1.0)
    p["embed"] = (p["embed"].astype(jnp.float32) * boost).astype(dtype)
    return m, p


def _port_model(layout, tree):
    cfg = tload(overrides=OVR + [f"infer.merge_qkv_gate_up={LAYOUTS[layout]}"])
    m = tbuild(cfg.models, cfg, device="cpu")
    m.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                    m.layout))
    return m


@pytest.fixture(scope="module")
def awq_runs():
    """Per layout: the JAX model and its f32 tree, the port's model and
    tree, both packages' statistics and AWQ trees."""
    out = {}
    for layout in LAYOUTS:
        jm, p = _jax_tree(layout, jnp.float32)
        tm = _port_model(layout, p)
        tree = tm.params_tree()
        out[layout] = dict(
            jm=jm, p=p, tm=tm, tree=tree,
            jstats=jawq.calibrate_llama(jm, p, CALIB),
            tstats=awq.calibrate_llama(tm, tree, CALIB),
            jq=jawq.awq_quantize_llama_params(jm, p, CALIB),
        )
        jstats = {k: [torch.from_numpy(a) for a in v]
                  for k, v in out[layout]["jstats"].items()}
        real = awq.calibrate_llama
        awq.calibrate_llama = lambda *a, **k: jstats
        try:
            out[layout]["tq"] = awq.awq_quantize_llama_params(tm, tree, CALIB)
        finally:
            awq.calibrate_llama = real
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_calibrate_llama_stats_match_jax(awq_runs, layout):
    r = awq_runs[layout]
    assert set(r["tstats"]) == set(r["jstats"]) >= {"wo", "w_down"}
    for name, want in r["jstats"].items():
        got = r["tstats"][name]
        assert len(got) == len(want) == 2
        for l, (g, w) in enumerate(zip(got, want)):
            g = g.numpy()
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel < 1e-2, (name, l, rel)


def _codes(q):
    q = q if not q.packed else __import__(
        "chitu_tpu_torch.ops.qtensor", fromlist=["unpack_int4"]).unpack_int4(q)
    return q.data.numpy()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_awq_quantize_matches_jax(awq_runs, layout):
    r = awq_runs[layout]
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, r["jq"]),
                             r["tm"].layout)
    got = {**{k: v for k, v in r["tq"].items() if k != "layers"},
           **r["tq"]["layers"]}
    names = ("wqkv", "w_gate_up") if layout == "merged" else (
        "wq", "wk", "wv", "w_gate", "w_up")
    for name in names + ("wo", "w_down"):
        g, w = got[name], want[name]
        assert isinstance(g, QTensor) and g.kind == QuantKind.W4A16
        same = (_codes(g) == _codes(w)).mean()
        assert same >= 0.999, (name, same)
    for norm in ("attn_norm", "ffn_norm"):
        np.testing.assert_allclose(got[norm].float().numpy(),
                                   want[norm].float().numpy(), rtol=1e-5)


def test_engine_serves_jax_awq_tree_with_jax_logits():
    """The JAX package's AWQ tree of an f32 model (the JAX model's CPU
    products need f32 activations), carried to the port: teacher-forced
    logits equal to the JAX model's within 5e-3; then the port's engine
    serves it."""
    from test_torch_llama import PAGE, _Jax, _Torch

    jm, p = _jax_tree("merged", jnp.float32)
    jq = jawq.awq_quantize_llama_params(jm, p, CALIB)
    tm = _port_model("merged", jq)
    assert isinstance(tm.wqkv, QTensor) and tm.wqkv.kind == QuantKind.W4A16
    pool = np.zeros((2, 8, PAGE, 2 * 4 * 32), np.float32)
    tok = np.zeros((64,), np.int32)
    tok[:48] = HOLD
    bt = np.arange(8, dtype=np.int32)
    want = _Jax(jm, jq, pool, "xla").prefill(tok, bt, 0, 48)
    got = _Torch(tm, pool).prefill(tok, bt, 0, 48)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    tree = jax.tree_util.tree_map(np.asarray, jq)
    eng = Engine(tload(overrides=OVR), device="cpu",
                 params=params_from_numpy(tree))
    assert isinstance(eng.model.wqkv, QTensor) and eng.model.wqkv.packed
    toks = eng.generate("awq", SampleParams(temperature=0.0, max_new_tokens=6))
    assert len(toks) == 6


def _all_logits(model, ids):
    from chitu_tpu_torch.kvcache import PagedKVCache

    spec = model.kv_cache_spec()
    n, T, page = len(ids), 64, 16
    cache = PagedKVCache(spec["n_layers"], T // page + 1, page,
                         spec["kv_heads"], spec["head_dim"])
    tok = torch.zeros(T, dtype=torch.int32)
    tok[:n] = torch.from_numpy(np.asarray(ids, np.int32))
    with torch.no_grad():
        logits, _ = model.prefill(
            cache.arrays, tok, torch.arange(T // page + 1, dtype=torch.int32),
            0, n, page, return_all_logits=True)
    return logits[:n].float().numpy()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_port_awq_tree_serves_no_worse_than_rtn(awq_runs, layout):
    """The port's own AWQ tree, through its engine, against RTN W4A16 of
    the same weights: teacher-forced logits MSE to the dense model's on
    held-out tokens, AWQ <= 1.2 x RTN (the JAX test's criterion)."""
    from chitu_tpu_torch.quantize import quantize_params

    r = awq_runs[layout]
    ovr = OVR + [f"infer.merge_qkv_gate_up={LAYOUTS[layout]}"]
    cfg = tload(overrides=ovr)
    ref = _all_logits(r["tm"], HOLD)
    own = awq.awq_quantize_llama_params(r["tm"], r["tree"], CALIB)
    awq_eng = Engine(cfg, device="cpu", params=own)
    rtn_tree = quantize_params(
        {**r["tree"], "layers": dict(r["tree"]["layers"])},
        dc.replace(cfg.quant, method="awq", quant_on_load=True), r["tm"])
    rtn_eng = Engine(cfg, device="cpu", params=rtn_tree)
    mse = lambda e: float(np.mean((_all_logits(e.model, HOLD) - ref) ** 2))
    assert mse(awq_eng) <= 1.2 * mse(rtn_eng), (mse(awq_eng), mse(rtn_eng))
    assert len(awq_eng.generate(
        "awq", SampleParams(temperature=0.0, max_new_tokens=4))) == 4
