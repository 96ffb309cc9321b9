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

Since slice 18, the last layouts the port refused:
- a tiny Llama whose FFN (384 columns, 192 a rank) puts the tp2 cut
  inside a quantization block: its soft-fp8 tree (quantized by the JAX
  package; blockwise scales unmerged, and rowwise ones merged by the
  port) and an AWQ checkpoint (FFN 192, groups of 64: 96 rows a rank)
  give the JAX engine's tokens at tp2 and the port's one rank's, a GPTQ
  act-order one the port's one rank's; each rank's bytes of
  a straddled leaf are its share plus the whole blocks' overlap, exactly;
- `/stop` then `/init` on rank 0's server rebuilds the two-rank world
  with other overrides (the one-rank engine's tokens), and an `/init` of
  another world size is refused with 400;
- tiny-mixtral-debug (8 heads, 8 experts) and tiny-deepseek-debug (8
  heads, 16 experts) at tp3 in the three-rank world: attention and its
  pool replicate, the experts take 3 / 3 / 2 and 6 / 5 / 5, and the
  tokens are the JAX engine's at tp3 (its capacity einsum at a capacity
  that drops no token) and the port's one rank's;
- uneven expert ranges cover every expert once, and the summed partial
  products of straddled row and column cuts (soft-fp8, fp8, AWQ, GPTQ;
  tp 2, 3 and 4) equal the whole product within 1e-6 in f32.
"""

import os
from dataclasses import replace

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
from chitu_tpu_torch.parallel.sharding import StageSlice, even_range

import test_torch_loader as tl
from test_torch_tp import (
    BASE, _jax_op_impl_auto, _join, _one_torch_thread, _port_tokens,  # noqa: F401
    _quantized, _spawn, _tree)
import torch_tp_world as tw
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
I384 = ["models.inter_dim=384"]  # 192 a tp2 rank: inside block 2 of 128
SOFT = ["quant.method=soft_fp8", "quant.quant_on_load=true"]
INT4 = tl.LLAMA + ["models.inter_dim=192", "dtype=float32", "infer.do_load=true",
                   "quant.method=w4a16"]  # groups of 64: 96 rows a tp2 rank
NOCAP = ["models.moe.capacity_factor=8.0"]  # the JAX capacity drops no token
PORT0 = ["serve.port=0"]  # rank 0's server on a free port
REINIT = BASE + PORT0 + ["models.n_layers=1", "infer.tp_size=2"]


def _straddled(n, tp, block):
    """Each tp rank's equal slice of n rows or columns, and the whole
    blocks over it: -> [(share, stored, blocks)] a rank."""
    per = n // tp
    out = []
    for r in range(tp):
        a = r * per // block * block
        z = min(-(-(r + 1) * per // block) * block, n)
        out.append((per, z - a, -(-(z - a) // block)))
    return out


def _jax_quantized(ovr, tree, method):
    """`tree` quantized by the JAX package (`quant.method=method`)."""
    from chitu_tpu.quantize import quantize_params as jquantize

    cfg = jload(overrides=ovr + [f"quant.method={method}",
                                 "quant.quant_on_load=true"])
    m = jbuild(cfg.models, cfg)
    q = jquantize(jax.tree_util.tree_map(jnp.asarray, tree), cfg.quant, m)
    return jax.tree_util.tree_map(np.asarray, q)


def _rowwise(tree):
    """Blockwise fp8 scales expanded to every column (exact), the layout
    the JAX engine holds on a mesh (`expand_fp8_scales_rowwise`)."""
    from chitu_tpu.quantize import expand_fp8_scales_rowwise

    t = expand_fp8_scales_rowwise(jax.tree_util.tree_map(jnp.asarray, tree))
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_ckpt_tokens(ovr, prompts, new):
    """Greedy tokens of the JAX engine on the checkpoint `ovr` names."""
    eng = JEngine(jload(overrides=ovr))
    reqs = [eng.submit("", JSampleParams(temperature=0.0, max_new_tokens=n),
                       prompt_tokens=p) for p, n in zip(prompts, new)]
    eng.run_until_complete()
    return [list(r.async_stream.tokens) for r in reqs]


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
        _place, tree, eng.params)
    return eng


def _place(a, old):
    """`a` placed as the engine's own leaf `old`; a sharding whose axis
    does not divide the leaf (a blockwise scale cut mid-block, which the
    engine's jit made padded) through an identity program."""
    try:
        return jax.device_put(jnp.asarray(a), old.sharding)
    except ValueError:
        return jax.jit(lambda x: x, out_shardings=old.sharding)(jnp.asarray(a))


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
    _, U384 = _tree(OFF + I384, key=12)
    F8 = _jax_quantized(BASE + OFF + I384, U384, "soft_fp8")
    F8r = _rowwise(F8)
    mix3 = _jax_deepseek(MIXTRAL + ["infer.tp_size=3"], 13)  # unmerged q, k, v
    ds_tp3 = _jax_deepseek(DEEPSEEK + ["models.n_layers=2"], 14)
    d2, d3 = tmp_path_factory.mktemp("two"), tmp_path_factory.mktemp("three")
    ckpt = {f: tl.write(tl.int4_tensors(INT4, f, perms="shared"),
                        str(d2 / f)) for f in ("awq", "gptq")}
    int4 = {f: INT4 + [f"models.ckpt_dir={d}"] for f, d in ckpt.items()}
    trees = dict(U=U, U5=U5, U1=U1, W=W, ds=ds, ds3=ds3, mixw=mixw, dsw=dsw,
                 F8=F8, F8r=F8r, mix3=mix3, ds_tp3=ds_tp3)
    paths = {k: str(d2 / f"{k}.npz") for k in trees}
    for k, t in trees.items():
        save_tree(t, paths[k])
    tp2, pp2, pp3 = ["infer.tp_size=2"], ["infer.pp_size=2"], ["infer.pp_size=3"]
    tp3 = ["infer.tp_size=3"]
    s3 = [
        dict(name="burst", overrides=BASE + OFF + L5 + pp3, tree=paths["U5"],
             prompts=PROMPTS, new=NEW, spy=True, shards=True, ppl=PPL),
        dict(name="lone", overrides=BASE + OFF + L5 + pp3, tree=paths["U5"],
             prompts=PROMPTS[:1], new=NEW[:1], spy=True),
        dict(name="deepseek", overrides=DS_PP3 + pp3, tree=paths["ds3"],
             prompts=MOE_PROMPTS, new=MOE_NEW, spy=True),
        dict(name="mixtral_tp3", overrides=MIXTRAL + tp3, tree=paths["mix3"],
             prompts=MOE_PROMPTS, new=MOE_NEW, nocap=True, shards=True),
        dict(name="deepseek_tp3", overrides=DEEPSEEK + ["models.n_layers=2"]
             + tp3, tree=paths["ds_tp3"], prompts=MOE_PROMPTS, new=MOE_NEW,
             nocap=True),
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
        dict(name="ppl_tp2", overrides=BASE + OFF + tp2 + PORT0, tree=paths["U"],
             ppl=PPL, reinit=dict(overrides=REINIT, bad=BASE + ["infer.tp_size=4"],
                                  prompts=PROMPTS, new=NEW)),
        dict(name="fp8_straddle", overrides=BASE + OFF + I384 + tp2,
             tree=paths["F8"], prompts=PROMPTS, new=NEW),
        dict(name="fp8_straddle_merged", overrides=BASE + I384 + tp2,
             tree=paths["F8r"], prompts=PROMPTS, new=NEW),
        dict(name="awq_straddle", overrides=int4["awq"] + tp2,
             prompts=PROMPTS, new=NEW),
        dict(name="gptq_straddle", overrides=int4["gptq"] + tp2,
             prompts=PROMPTS, new=NEW),
        dict(name="one_layer", overrides=BASE + OFF + L1 + pp2,
             tree=paths["U1"], prompts=PROMPTS, new=NEW, spy=True,
             shards=True),
        dict(name="ppl_pp2", overrides=BASE + OFF + pp2 + PORT0, tree=paths["U"],
             ppl=PPL, reinit=dict(overrides=REINIT, bad=BASE + ["infer.tp_size=4"],
                                  prompts=PROMPTS, new=NEW, stopped=True)),
    ]
    p2 = _spawn(str(d2), 2, s2, env_rendezvous=False)
    try:
        one = {k: _port(ovr, t) for k, ovr, t in (
            ("dense", DENSE, ds), ("w8a8", BASE + W8A8, W),
            ("U", BASE + OFF, U), ("U5", BASE + OFF + L5, U5),
            ("U1", BASE + OFF + L1, U1), ("ds3", DS_PP3, ds3),
            ("mixw", MIXTRAL + MOE_W8A8, mixw),
            ("dsw", DEEPSEEK + ["models.n_layers=2"] + MOE_W8A8, dsw),
            ("F8", BASE + OFF + I384, F8), ("F8m", BASE + I384, F8r),
            ("mix3", MIXTRAL, mix3),
            ("ds_tp3", DEEPSEEK + ["models.n_layers=2"], ds_tp3))}
        for f in ("awq", "gptq"):
            one[f] = Engine(load_config(overrides=int4[f]), device="cpu")
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
            jax_fp8=_jax_tokens(BASE + OFF + I384 + SOFT + tp2, F8r, PROMPTS,
                                NEW),
            jax_awq=_jax_ckpt_tokens(int4["awq"] + tp2, PROMPTS, NEW),
            jax_mix3=_jax_tokens(MIXTRAL + NOCAP + tp3, mix3, MOE_PROMPTS,
                                 MOE_NEW),
            jax_ds_tp3=_jax_tokens(DEEPSEEK + ["models.n_layers=2"] + NOCAP
                                   + tp3, ds_tp3, MOE_PROMPTS, MOE_NEW),
            fp8_straddle=_port_tokens(one["F8"], PROMPTS, NEW),
            fp8_straddle_merged=_port_tokens(one["F8m"], PROMPTS, NEW),
            awq_straddle=_port_tokens(one["awq"], PROMPTS, NEW),
            gptq_straddle=_port_tokens(one["gptq"], PROMPTS, NEW),
            mixtral_tp3=_port_tokens(one["mix3"], MOE_PROMPTS, MOE_NEW),
            deepseek_tp3=_port_tokens(one["ds_tp3"], MOE_PROMPTS, MOE_NEW),
            reinit=_port_tokens(Engine(load_config(overrides=REINIT[:-1]),
                                       device="cpu"), PROMPTS, NEW),
            reinit_pool=Engine(load_config(overrides=REINIT[:-1]),
                               device="cpu").cache.bytes(),
            one_bytes={k: tw.leaf_bytes(one[k].model.params_tree())
                       for k in ("F8", "awq", "gptq", "mix3", "ds_tp3")},
            one_pool={k: one[k].cache.bytes() for k in ("mix3", "ds_tp3")},
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
    """Dense MLA and W8A8 under tp, heads and experts that tp does not
    divide and ring prefill under pp pass `check_supported` (a world of
    ranks serves them, above); a stack pp does not divide, or with fewer
    layers than stages, gets uneven ranges; what the JAX engine refuses
    still raises: ring_kv with pp not dividing the layers, and both ring
    modes at once."""
    for ovr in (DENSE + ["infer.tp_size=2"],
                DENSE + ["infer.tp_size=2", "infer.pp_size=2"],
                BASE + ["infer.tp_size=2", "quant.method=w8a8",
                        "quant.quant_on_load=true"],
                # slice 18: heads and experts tp does not divide, ring
                # prefill under pp
                MIXTRAL + ["infer.tp_size=3"],
                DEEPSEEK + ["infer.tp_size=3"],
                DENSE + ["infer.tp_size=3"],
                BASE + ["infer.tp_size=3", "infer.pp_size=2"],
                BASE + ["infer.dp_size=2", "infer.pp_size=2",
                        "infer.ring_prefill=true"]):
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


# ---------------------------------------------------------------------------
# slice 18: quantization blocks cut by a shard, /init on a world, heads and
# experts that tp does not divide
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,jax_ref", [
    ("fp8_straddle", "jax_fp8"), ("fp8_straddle_merged", "jax_fp8"),
    ("awq_straddle", "jax_awq"), ("gptq_straddle", None)])
def test_straddled_blocks_match_jax_and_one_rank(worlds, name, jax_ref):
    """The FFN cut inside a quantization block at tp2: the JAX engine's
    tokens at tp2 and the port's one rank's (soft-fp8 with blockwise
    scales unmerged, and with rowwise scales merged by the port: the
    rank's gate and up views joined; AWQ). GPTQ act-order is held to the
    port's one rank alone: the JAX engine's act-order product has no f32
    CPU kernel (a bf16 x bf16 = f32 dot)."""
    ref = worlds["ref"]
    assert worlds["two"][0][name]["tokens"] == ref[name]
    if jax_ref is not None:
        assert ref[name] == ref[jax_ref]
    assert len({tuple(t) for t in ref[name]}) > 1


@pytest.mark.parametrize("name,leaf,dim,L,K,N,block,item,aux_cols,aux_n", [
    # soft-fp8: e4m3 bytes, [K/128, N/128] f32 scales
    ("fp8_straddle", "w_down", -2, 2, 384, 256, 128, 1, 2, 1),
    ("fp8_straddle", "w_gate", -1, 2, 256, 384, 128, 1, 2, 1),
    ("fp8_straddle", "w_up", -1, 2, 256, 384, 128, 1, 2, 1),
    # int4 one nibble a byte, [K/64, N] f32 scales and zeros
    ("awq_straddle", "w_down", -2, 2, 192, 128, 64, 1, 128, 2),
    ("gptq_straddle", "w_down", -2, 2, 192, 128, 64, 1, 128, 2)])
def test_straddled_rank_bytes_are_share_plus_overlap(worlds, name, leaf, dim,
                                                     L, K, N, block, item,
                                                     aux_cols, aux_n):
    """Each rank's bytes of a leaf cut inside its blocks: its share of the
    data, the overlap (the rest of the whole blocks over its cut edges),
    and the scales (and zeros) of those blocks; an act-order GPTQ leaf
    keeps its whole permutation. Exactly."""
    one = {"fp8_straddle": "F8", "awq_straddle": "awq",
           "gptq_straddle": "gptq"}[name]
    leaf = "layers/" + leaf
    whole = worlds["ref"]["one_bytes"][one][leaf]
    n, other = (K, N) if dim == -2 else (N, K)
    perm = whole - L * K * N * item - L * -(-K // block) * aux_cols * 4 * aux_n \
        if dim == -2 else 0
    for r, (share, stored, blocks) in enumerate(_straddled(n, 2, block)):
        assert stored > share  # the cut is inside a block on every rank
        got = worlds["two"][r][name]["leaf_bytes"][leaf]
        if dim == -2:
            want = L * (share + (stored - share)) * N * item \
                + L * blocks * aux_cols * 4 * aux_n + perm
        else:
            want = L * K * (share + (stored - share)) * item \
                + L * -(-K // block) * blocks * 4 * aux_n
        assert got == want, (r, got, want)


@pytest.mark.parametrize("name", ["ppl_tp2", "ppl_pp2"])
def test_init_rebuilds_the_world_and_refuses_another_size(worlds, name):
    """`/stop`, then `/init` on rank 0's server: an /init of 4 ranks on a
    world of 2 is refused (400, naming both), the world stays up, and
    the next /init rebuilds every rank's engine (tp2 at 1 layer, random
    weights of the seed) with the one-rank engine's tokens and half its
    pool. From a running tp2 engine (`/stop` stops every rank's), and
    from a pp2 engine that rank 0 stopped before its server started (the
    groups made anew for the other layout)."""
    ref = worlds["ref"]
    got = worlds["two"][0][name]["reinit"]
    assert got["stop"] == 200 and got["init"] == 200 and got["stop2"] == 200
    status, body = got["bad"]
    assert status == 400
    assert "4 ranks" in body["detail"] and "2 process" in body["detail"]
    assert got["tokens"] == ref["reinit"]
    assert got["pool_bytes"] * 2 == ref["reinit_pool"]
    assert worlds["two"][1][name]["reinit_pool_bytes"] * 2 == \
        ref["reinit_pool"]


@pytest.mark.parametrize("name,one,stack,leaf,heads,experts", [
    ("mixtral_tp3", "mix3", "layers/", "w_down", ("wq", "wk", "wv", "wo"), 8),
    ("deepseek_tp3", "ds_tp3", "moe_layers/", "exp_down",
     ("wq", "wkv_b", "wo"), 16)])
def test_tp3_replicates_heads_and_splits_experts_unevenly(
        worlds, name, one, stack, leaf, heads, experts):
    """tp3 on 8 heads: every rank holds the attention leaves and the pool
    whole (the one-rank engine's bytes); the experts split 3 / 3 / 2 of
    8 and 6 / 5 / 5 of 16; the tokens are the JAX engine's at tp3 (its
    capacity einsum dropping no token) and the port's one rank's, the
    capacity route never taken."""
    ref, three = worlds["ref"], worlds["three"]
    assert three[0][name]["tokens"] == ref[name] == ref["jax_" + one]
    assert len({tuple(t) for t in ref[name]}) > 1
    whole = ref["one_bytes"][one]
    counts = [len(range(*even_range(experts, r, 3))) for r in range(3)]
    assert counts == ([3, 3, 2] if experts == 8 else [6, 5, 5])
    for r, res in enumerate(three):
        got = res[name]
        assert got["pool_bytes"] == ref["one_pool"][one]
        for h in heads:
            key = stack + h
            if key in whole:
                assert got["leaf_bytes"][key] == whole[key], (r, key)
        assert got["leaf_bytes"][stack + leaf] * experts == \
            whole[stack + leaf] * counts[r]
    if name == "mixtral_tp3":
        assert [res[name]["shards"]["w_down"][1] for res in three] == counts


@pytest.mark.parametrize("E,tp", [(8, 3), (16, 3), (256, 3), (8, 5), (7, 4),
                                  (16, 8)])
def test_uneven_expert_ranges_cover_every_expert_once(E, tp):
    """`even_range` over the ranks: contiguous, disjoint, covering [0, E),
    the first E % tp ranks one longer; `loader.rank_experts` and the
    "ep" spec cut of an expert stack give the same ranges."""
    from chitu_tpu_torch.loader import rank_experts
    from chitu_tpu_torch.models.llama import TPLayout
    from chitu_tpu_torch.parallel.sharding import shard_leaf

    stack = torch.arange(E, dtype=torch.float32)[None, :, None, None].expand(
        1, E, 2, 3).contiguous()
    seen = []
    for r in range(tp):
        a, b = even_range(E, r, tp)
        assert b - a == E // tp + (r < E % tp)
        lay = TPLayout(r, tp, 8, 8, 4, 16, 32, moe=True)
        assert rank_experts(lay, E) == list(range(a, b))
        part = shard_leaf(stack, lay.part_spec("w_down", 4), r, tp)
        assert part[0, :, 0, 0].tolist() == [float(e) for e in range(a, b)]
        seen += list(range(a, b))
    assert seen == list(range(E))


def _act_order(q, g):
    """A W4A16 weight with its rows stored group-sorted (act-order GPTQ)."""
    perm = torch.randperm(q.data.shape[-2], generator=g).to(torch.int32)
    return replace(q, in_perm=perm)


@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("dim", ["rows", "cols"])
@pytest.mark.parametrize("kind", ["soft_fp8", "fp8", "awq", "gptq"])
def test_straddled_partial_products_sum_to_the_whole(kind, dim, tp):
    """A [384, 576] weight quantized whole (blocks of 128; int4 groups of
    128 along the rows), cut into tp equal row or column slices (inside
    blocks at tp 2 and 4, or 3 for the columns): the ranks' partial
    products (row cut: each rank's input slice, padded over its whole
    blocks, summed) equal the whole product within 1e-6 in f32, and each
    rank's bytes are its share plus the overlap."""
    from chitu_tpu_torch.ops.linear import linear
    from chitu_tpu_torch.ops.qtensor import QuantKind
    from chitu_tpu_torch.parallel.sharding import shard_qtensor
    from chitu_tpu_torch.quantize.transforms import quantize_weight

    g = torch.Generator().manual_seed(18)
    K, N = 384, 576
    w = torch.randn(K, N, generator=g)
    x = torch.randn(7, K, generator=g)
    q = quantize_weight(w, {"soft_fp8": QuantKind.SOFT_FP8, "fp8": QuantKind.FP8}
                        .get(kind, QuantKind.W4A16))
    if kind == "gptq":
        q = _act_order(q, g)
    whole = linear(x, q, out_dtype=torch.float32)
    spec = (("tp", None) if dim == "rows" else (None, "tp"))
    parts, n = [], (K if dim == "rows" else N)
    for r, (share, stored, blocks) in enumerate(_straddled(n, tp, 128)):
        s = shard_qtensor(q, spec, r, tp)
        k0, k = r * share, share
        if dim == "rows":
            xr = x[:, k0:k0 + k]
            if s.in_perm is not None:  # the whole input, gathered
                xr = x[:, s.in_perm[k0:k0 + k].long()]
                s = s.without("in_perm")
            parts.append(linear(xr, s, out_dtype=torch.float32))
            assert s.shape == (k, N)
            aux = blocks * (-(-N // 128) if kind in ("soft_fp8", "fp8") else N * 2) * 4
            assert s.nbytes() == (share + stored - share) * N + aux
        else:
            parts.append(linear(x, s, out_dtype=torch.float32))
            assert s.shape == (K, k)
            aux = (3 * blocks if kind in ("soft_fp8", "fp8") else 3 * k * 2) * 4
            perm = K * 4 if kind == "gptq" else 0
            stored_cols = stored if kind in ("soft_fp8", "fp8") else share
            assert s.nbytes() == K * stored_cols + aux + perm
    got = sum(parts) if dim == "rows" else torch.cat(parts, dim=-1)
    rel = ((got - whole).abs().max() / whole.abs().max()).item()
    assert rel < 1e-6, rel
