"""Layouts the JAX package serves that the port refused until slice 17, on
the CPU: DeepSeek's dense MLA (`infer.mla_absorb=none`) under tensor
parallelism, W8A8 under tensor parallelism (a row-parallel input
quantized under the whole row's per-token scale), stacks that pp does
not divide or that have fewer layers than stages, and perplexity on a
world of ranks.

Two worlds of port processes (`tests/torch_tp_world.py` over gloo, a
`file://` rendezvous), started together for the module while the JAX
and one-rank references run here: two ranks that serve the tp2 layouts
and then, their groups made anew, the pp2 ones; and three ranks at pp3.
Held, on f32 trees of the JAX package (tokens compare exactly):
- tiny-deepseek-debug with `mla_absorb=none` at tp2 gives the greedy
  tokens of the JAX engine at `infer.tp_size=2` (GSPMD on the virtual
  devices) and of the port's one rank; each rank's per-head pool, and
  its cut of `wq_b`, `wkv_b` and `wo`, are the one-rank ones / 2;
- a W8A8 tree (quantized by the JAX package) at tp2 gives the port's
  one-rank tokens, and every quantized slice of a row-parallel input
  (`wo`'s, `w_down`'s) equals, bit for bit, the plain quantizer's on
  the whole row (the ranks' slices joined), cut to the rank's columns;
- pp3 at 5 layers (2 / 2 / 1: a pipelined burst and a lone request),
  pp2 at one layer (stage 1 holds none) and DeepSeek at pp3 with two MoE
  layers (stage 2 holds none) give the JAX engine's tokens at the same
  pp_size (its sequential path) and the port's one rank's;
- the perplexity of a token sequence under tp2, pp2 and pp3 equals the
  port's one rank's within 1e-5 relative and the JAX function's on its
  tp2 mesh within 1e-3 (the file's tolerance for the two frameworks,
  `tests/test_torch_evals.py`); under dp, `tests/test_torch_ring.py`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.config import load_config as jload
from chitu_tpu.engine import Engine as JEngine
from chitu_tpu.evals import perplexity_from_tokens as jppl
from chitu_tpu.models import build_model as jbuild
from chitu_tpu.task import SampleParams as JSampleParams
from chitu_tpu_torch import evals, load_config
from chitu_tpu_torch.engine import Engine, check_supported
from chitu_tpu_torch.models.llama import params_from_numpy
from chitu_tpu_torch.ops.norm_quant import (
    acts_absmax_plain,
    quant_acts_given_plain,
    quant_acts_plain,
)
from chitu_tpu_torch.parallel.sharding import StageSlice

from test_torch_tp import (
    BASE, _jax_op_impl_auto, _join, _one_torch_thread, _port_tokens,  # noqa: F401
    _quantized, _spawn, _tree)
from torch_tp_world import save_tree

OFF = ["infer.merge_qkv_gate_up=off"]
DEEPSEEK = ["models=tiny-deepseek-debug", "infer.max_seq_len=128",
            "infer.max_reqs=4", "infer.page_size=16",
            "infer.stop_with_eos=false", "dtype=float32"]
DENSE = DEEPSEEK + ["models.n_layers=2", "infer.mla_absorb=none"]
DS_PP3 = DEEPSEEK + ["models.n_layers=3"]  # 1 dense, 2 MoE: 1 / 1 / 0
MIXTRAL = ["models=tiny-mixtral-debug", "models.n_layers=2",
           "infer.max_seq_len=128", "infer.max_reqs=4", "infer.page_size=16",
           "infer.stop_with_eos=false", "dtype=float32"]
MOE_W8A8 = ["quant.method=w8a8"]
W8A8 = OFF + ["quant.method=w8a8"]
L5, L1 = ["models.n_layers=5"], ["models.n_layers=1"]
rng = np.random.default_rng(17)
PROMPTS = [rng.integers(1, 512, n).tolist() for n in (9, 20, 33)]
NEW = [6, 6, 6]
MOE_PROMPTS = [rng.integers(1, 1024, n).tolist() for n in (11, 26)]
MOE_NEW = [5, 5]
TOKENS = rng.integers(1, 512, 70).tolist()
PPL = dict(tokens=TOKENS, window=32, stride=24)


def _jax_deepseek(ovr, key):
    """A JAX f32 draw of a DeepSeek card, its embedding at 1.0, as numpy."""
    cfg = jload(overrides=ovr)
    p = jbuild(cfg.models, cfg).init_params(jax.random.PRNGKey(key), jnp.float32)
    p["embed"] = p["embed"] * 50.0
    return jax.tree_util.tree_map(np.asarray, p)


def _jax_w8a8(ovr, key):
    """A JAX f32 draw of an MoE card (embedding at 1.0) quantized W8A8 by
    the JAX package (experts too), as numpy."""
    from chitu_tpu.quantize import quantize_params as jquantize

    cfg = jload(overrides=ovr + ["quant.method=w8a8"])
    m = jbuild(cfg.models, cfg)
    p = m.init_params(jax.random.PRNGKey(key), jnp.float32)
    p["embed"] = p["embed"] * 50.0
    return jax.tree_util.tree_map(np.asarray, jquantize(p, cfg.quant, m))


def _jax_engine(ovr, tree):
    """The JAX engine of `ovr` on `tree`, placed with its own shardings."""
    eng = JEngine(jload(overrides=ovr))
    eng.params = eng.executor.params = jax.tree_util.tree_map(
        lambda a, old: jax.device_put(jnp.asarray(a), old.sharding), tree,
        eng.params)
    return eng


def _jax_tokens(ovr, tree, prompts, new):
    eng = _jax_engine(ovr, tree)
    reqs = [eng.submit("", JSampleParams(temperature=0.0, max_new_tokens=n),
                       prompt_tokens=p) for p, n in zip(prompts, new)]
    eng.run_until_complete()
    return [list(r.async_stream.tokens) for r in reqs]


def _port(ovr, tree):
    return Engine(load_config(overrides=ovr), device="cpu",
                  params=lambda m: params_from_numpy(tree, m.layout))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    _, U = _tree(OFF)
    _, U5 = _tree(OFF + L5, key=6)
    _, U1 = _tree(OFF + L1, key=7)
    W = _quantized(U, "w8a8")
    ds = _jax_deepseek(DENSE, 8)
    ds3 = _jax_deepseek(DS_PP3, 9)
    mixw = _jax_w8a8(MIXTRAL, 10)
    dsw = _jax_w8a8(DEEPSEEK + ["models.n_layers=2"], 11)
    d2, d3 = tmp_path_factory.mktemp("two"), tmp_path_factory.mktemp("three")
    trees = dict(U=U, U5=U5, U1=U1, W=W, ds=ds, ds3=ds3, mixw=mixw, dsw=dsw)
    paths = {k: str(d2 / f"{k}.npz") for k in trees}
    for k, t in trees.items():
        save_tree(t, paths[k])
    tp2, pp2, pp3 = ["infer.tp_size=2"], ["infer.pp_size=2"], ["infer.pp_size=3"]
    s3 = [
        dict(name="burst", overrides=BASE + OFF + L5 + pp3, tree=paths["U5"],
             prompts=PROMPTS, new=NEW, spy=True, shards=True, ppl=PPL),
        dict(name="lone", overrides=BASE + OFF + L5 + pp3, tree=paths["U5"],
             prompts=PROMPTS[:1], new=NEW[:1], spy=True),
        dict(name="deepseek", overrides=DS_PP3 + pp3, tree=paths["ds3"],
             prompts=MOE_PROMPTS, new=MOE_NEW, spy=True),
    ]
    p3 = _spawn(str(d3), 3, s3, env_rendezvous=False)
    s2 = [
        dict(name="dense_mla", overrides=DENSE + tp2, tree=paths["ds"],
             prompts=MOE_PROMPTS, new=MOE_NEW),
        dict(name="w8a8", overrides=BASE + W8A8 + tp2, tree=paths["W"],
             prompts=PROMPTS, new=NEW, acts=True),
        dict(name="mixtral_w8a8", overrides=MIXTRAL + MOE_W8A8 + tp2,
             tree=paths["mixw"], prompts=MOE_PROMPTS, new=MOE_NEW, acts=True),
        dict(name="deepseek_w8a8", overrides=DEEPSEEK + [
            "models.n_layers=2"] + MOE_W8A8 + tp2, tree=paths["dsw"],
             prompts=MOE_PROMPTS, new=MOE_NEW, acts=True),
        dict(name="ppl_tp2", overrides=BASE + OFF + tp2, tree=paths["U"],
             ppl=PPL),
        dict(name="one_layer", overrides=BASE + OFF + L1 + pp2,
             tree=paths["U1"], prompts=PROMPTS, new=NEW, spy=True,
             shards=True),
        dict(name="ppl_pp2", overrides=BASE + OFF + pp2, tree=paths["U"],
             ppl=PPL),
    ]
    p2 = _spawn(str(d2), 2, s2, env_rendezvous=False)
    try:
        one = {k: _port(ovr, t) for k, ovr, t in (
            ("dense", DENSE, ds), ("w8a8", BASE + W8A8, W),
            ("U", BASE + OFF, U), ("U5", BASE + OFF + L5, U5),
            ("U1", BASE + OFF + L1, U1), ("ds3", DS_PP3, ds3),
            ("mixw", MIXTRAL + MOE_W8A8, mixw),
            ("dsw", DEEPSEEK + ["models.n_layers=2"] + MOE_W8A8, dsw))}
        jeng = _jax_engine(BASE + OFF + tp2, U)
        ref = dict(
            jax_dense=_jax_tokens(DENSE + tp2, ds, MOE_PROMPTS, MOE_NEW),
            jax_pp3=_jax_tokens(BASE + OFF + L5 + pp3, U5, PROMPTS, NEW),
            jax_pp2=_jax_tokens(BASE + OFF + L1 + pp2, U1, PROMPTS, NEW),
            jax_ds3=_jax_tokens(DS_PP3 + pp3, ds3, MOE_PROMPTS, MOE_NEW),
            jax_ppl=jppl(jeng, TOKENS, window=PPL["window"],
                         stride=PPL["stride"]),
            dense=_port_tokens(one["dense"], MOE_PROMPTS, MOE_NEW),
            w8a8=_port_tokens(one["w8a8"], PROMPTS, NEW),
            mixtral_w8a8=_port_tokens(one["mixw"], MOE_PROMPTS, MOE_NEW),
            deepseek_w8a8=_port_tokens(one["dsw"], MOE_PROMPTS, MOE_NEW),
            pp3=_port_tokens(one["U5"], PROMPTS, NEW),
            pp2=_port_tokens(one["U1"], PROMPTS, NEW),
            ds3=_port_tokens(one["ds3"], MOE_PROMPTS, MOE_NEW),
            ppl=evals.perplexity_from_tokens(one["U"], **PPL),
            ppl5=evals.perplexity_from_tokens(one["U5"], **PPL),
            dense_pool=one["dense"].cache.bytes(),
            dense_leaves={k: v.numel() * v.element_size() for k, v in
                          one["dense"].model.params_tree()["dense_layers"].items()},
        )
    finally:
        out2 = _join(str(d2), p2)
        out3 = _join(str(d3), p3)
    acts = [torch.load(os.path.join(str(d2), f"acts{r}.pt")) for r in range(2)]
    return dict(two=out2, three=out3, ref=ref, acts=acts)


def test_dense_mla_under_tp_matches_jax_and_one_rank(worlds):
    ref, ranks = worlds["ref"], worlds["two"]
    assert ranks[0]["dense_mla"]["tokens"] == ref["jax_dense"] == ref["dense"]
    assert len({tuple(t) for t in ref["dense"]}) > 1
    for r in ranks:
        res = r["dense_mla"]
        # the per-head pool of the rank's 4 of 8 heads
        assert res["pool_bytes"] * 2 == ref["dense_pool"]
        for leaf in ("wq_b", "wkv_b", "wo"):
            got = res["leaf_bytes"][f"dense_layers/{leaf}"]
            assert got * 2 == ref["dense_leaves"][leaf], leaf
        for leaf in ("wkv_a", "kv_norm", "attn_norm"):
            assert res["leaf_bytes"][f"dense_layers/{leaf}"] == \
                ref["dense_leaves"][leaf], leaf


@pytest.mark.parametrize("name", ["w8a8", "mixtral_w8a8", "deepseek_w8a8"])
def test_w8a8_under_tp_matches_one_rank(worlds, name):
    """Llama, Mixtral (its experts on the capacity route, whole rows) and
    DeepSeek (`wo`, the dense FFN's and the shared expert's `*_down`
    row-parallel)."""
    assert worlds["two"][0][name]["tokens"] == worlds["ref"][name]
    assert len({tuple(t) for t in worlds["ref"][name]}) > 1


@pytest.mark.parametrize("name", ["w8a8", "mixtral_w8a8", "deepseek_w8a8"])
def test_w8a8_slices_equal_the_whole_row_quantizer(worlds, name):
    """Every row-parallel W8A8 input of the world (each layer's `wo`, and
    Llama's `w_down`, every step): each rank's int8 values and per-token
    scales equal the plain quantizer's on the whole row (the ranks'
    slices joined in rank order), cut to the rank's columns, bit for
    bit."""
    a0, a1 = (a[name] for a in worlds["acts"])
    assert len(a0) == len(a1) > 0
    widths = set()
    for (x0, q0, s0), (x1, q1, s1) in zip(a0, a1):
        k = x0.shape[-1]
        widths.add(2 * k)
        whole = quant_acts_plain(torch.cat([x0, x1], dim=-1))
        assert torch.equal(q0, whole.data[:, :k])
        assert torch.equal(q1, whole.data[:, k:])
        assert torch.equal(s0, whole.scale) and torch.equal(s1, whole.scale)
    if name == "w8a8":
        assert widths == {8 * 64, 512}  # wo's heads x head_dim, w_down's FFN


def test_given_absmax_plain_equals_the_plain_quantizer():
    """B12's given-absmax plain mode under each row's own absmax is its old
    plain version: values and scales bit-equal (bf16 and f32 rows, a zero
    row under the 1e-8 floor, rows at rounding ties)."""
    g = torch.Generator().manual_seed(12)
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(37, 1000, generator=g) * 3).to(dtype)
        x[3] = 0
        x[5, :8] = torch.tensor([127, -63.5, 0.5, 1.5, -2.5, 126.5, 3, 1],
                                dtype=dtype)
        x[5, 8:] = 0
        want = quant_acts_plain(x)
        got = quant_acts_given_plain(x, acts_absmax_plain(x))
        assert torch.equal(got.data, want.data)
        assert torch.equal(got.scale, want.scale)


def test_uneven_stages_match_jax_and_one_rank(worlds):
    ref = worlds["ref"]
    three, two = worlds["three"], worlds["two"]
    assert ref["jax_pp3"] == ref["pp3"]
    assert three[0]["burst"]["tokens"] == ref["pp3"]
    assert three[0]["lone"]["tokens"] == ref["pp3"][:1]
    # the burst pipelined on every rank, the lone request ran in sequence
    assert all(r["burst"]["pipelined"] == three[0]["burst"]["pipelined"] > 0
               for r in three)
    assert all(r["lone"]["pipelined"] == 0 for r in three)
    # 5 layers over 3 stages: 2 / 2 / 1
    assert [r["burst"]["shards"]["wo"][0] for r in three] == [2, 2, 1]
    assert [r["burst"]["pools"]["kv"][0] for r in three] == [2, 2, 1]
    # one layer over 2 stages: stage 1 holds none, and the head
    assert ref["jax_pp2"] == ref["pp2"] == two[0]["one_layer"]["tokens"]
    assert [r["one_layer"]["shards"]["wo"][0] for r in two] == [1, 0]
    assert "lm_head" in two[1]["one_layer"]["leaves"]
    assert two[0]["one_layer"]["pipelined"] > 0


def test_deepseek_uneven_moe_ranges_match_jax(worlds):
    """Two MoE layers over three stages: stage 0 the dense-first layer and
    one MoE layer, stage 1 the other, stage 2 none (the norm and head)."""
    ref, three = worlds["ref"], worlds["three"]
    assert three[0]["deepseek"]["tokens"] == ref["jax_ds3"] == ref["ds3"]
    pools = [r["deepseek"]["pools"] for r in three]
    assert pools[0]["kv_dense"][0] == 1 and pools[0]["kv_moe"][0] == 1
    assert pools[1] == {"kv_moe": pools[0]["kv_moe"]}
    assert "kv_moe" not in pools[2] and "kv_dense" not in pools[2]
    assert three[2]["deepseek"]["leaves"] == ["lm_head", "norm"]


@pytest.mark.parametrize("world,name", [("two", "ppl_tp2"), ("two", "ppl_pp2"),
                                        ("three", "burst")])
def test_perplexity_on_a_world_of_ranks(worlds, world, name):
    """The controller's number equals the one-rank engine's (1e-5) and the
    JAX function's on its tp2 mesh (1e-3); every rank ran its part."""
    ref = worlds["ref"]
    got = worlds[world][0][name]["ppl"]
    want = ref["ppl5"] if world == "three" else ref["ppl"]
    assert abs(got - want) / want < 1e-5, (got, want)
    if world == "two":
        assert abs(got - ref["jax_ppl"]) / ref["jax_ppl"] < 1e-3


def test_lifted_refusals_and_the_kept_ones():
    """Dense MLA and W8A8 under tp pass `check_supported` (a world of
    ranks serves them, above); a stack pp does not divide, or with fewer
    layers than stages, gets uneven ranges; what the JAX engine refuses
    still raises: ring_kv with pp not dividing the layers, and both ring
    modes at once."""
    for ovr in (DENSE + ["infer.tp_size=2"],
                DENSE + ["infer.tp_size=2", "infer.pp_size=2"],
                BASE + ["infer.tp_size=2", "quant.method=w8a8",
                        "quant.quant_on_load=true"]):
        check_supported(load_config(overrides=ovr))
    assert StageSlice.of(2, 3, {"layers": 8}).ranges == {"layers": (6, 8)}
    assert [StageSlice.of(p, 2, {"layers": 1}).ranges["layers"]
            for p in range(2)] == [(0, 1), (1, 1)]
    s = StageSlice.of(1, 3, {"dense_layers": 1, "moe_layers": 2},
                      first_only=("dense_layers",))
    assert s.ranges == {"dense_layers": (0, 0), "moe_layers": (1, 2)}
    ring = ["infer.dp_size=2", "infer.ring_kv=true"]
    with pytest.raises(ValueError, match="divisible by pp_size"):
        check_supported(load_config(overrides=BASE + L5 + ring + [
            "infer.pp_size=3"]))
    with pytest.raises(ValueError, match="enable one"):
        check_supported(load_config(overrides=BASE + ring + [
            "infer.ring_prefill=true"]))


@pytest.mark.parametrize("fmt,pp", [("hf_llama_bf16", 3), ("mixtral", 3),
                                    ("deepseek_bf16", 2)])
def test_loader_reads_uneven_and_empty_stages(tmp_path, fmt, pp):
    """The checkpoint loaders under an uneven stage layout: each stage's
    tree equals the layer slice of the one-stage tree. Two layers over
    three stages (1 / 1 / 0: the last stage holds the norm and head and no
    layer); DeepSeek's one MoE layer over two stages (stage 1 none)."""
    import test_torch_loader as tl
    from chitu_tpu_torch.models.deepseek_v3 import MLALayout
    from chitu_tpu_torch.models.llama import TPLayout

    ovr, d = tl.checkpoint(fmt, tmp_path)
    jcfg, cfg = tl._cfgs(ovr, d)
    jtree = jax.tree_util.tree_map(
        np.asarray, tl.jload_checkpoint(jbuild(jcfg.models, jcfg), jcfg))
    a = cfg.models
    for p in range(pp):
        model = tl.build_model(a, cfg, device="cpu")
        model.pp = pp
        if fmt == "deepseek_bf16":
            st = StageSlice.of(p, pp, {"dense_layers": model.n_dense,
                                       "moe_layers": model.n_moe},
                               first_only=("dense_layers",))
            model.layout = MLALayout(0, 1, a.n_heads, st)
        else:
            st = StageSlice.of(p, pp, {"layers": a.n_layers},
                               tied=a.tie_word_embeddings)
            model.layout = TPLayout(0, 1, a.n_heads, a.n_kv_heads,
                                    model.head_dim, model.inter_dim,
                                    a.vocab_size, merged=model.merged,
                                    moe=fmt == "mixtral", stage=st)
        got = tl.load_checkpoint(model, cfg, "cpu")
        want = params_from_numpy(jtree, model.layout)
        if "layers" in got:
            got = {**{k: v for k, v in got.items() if k != "layers"},
                   **got["layers"]}
        tl.assert_trees_equal(want, got)
        if fmt == "deepseek_bf16":
            assert ("moe_layers" in got) == (p == 0)
        else:
            assert got["attn_norm"].shape[0] == (1 if p < 2 else 0)
