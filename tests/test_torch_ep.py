"""Expert parallelism of the port: Mixtral and DeepSeek under tensor
parallelism and pp x tp, on the CPU. The counterparts of
tests/test_parallel.py:403,680,832 (the JAX package's pp x tp MoE
layouts) and of its GSPMD expert-parallel engines.

Three worlds of port processes, started together once for the module
(tp 2 over 2 ranks, tp 4 over 4, pp 2 x tp 2 over 4), each over gloo
with a `file://` rendezvous, run `tests/torch_tp_world.py`: rank 0
serves each scenario, the others follow it. Held, on f32 trees drawn by the JAX models (so
tokens compare exactly):
- each rank's shards equal the slices that the JAX package's
  `param_partition_specs` gives of the same tree on the 8-device mesh,
  at tp 2 and 4, for Mixtral and DeepSeek, bf16 and soft-fp8, split and
  merged (`w_gu` / `exp_gu`, `wq_kv_a`): experts by expert, MLA heads by
  head, the router and the latent projections whole;
- `moe_ffn_ep` summed over the ranks in one process gives the one-rank
  MoE layer: bf16 and e4m3 experts through the grouped kernel's plain
  version (each rank's partial also against the JAX package's manual-EP
  body), int8 experts through the capacity route's dead column (1e-4
  against the JAX dense oracle);
- greedy tokens at tp 2 equal the JAX engine's at tp 2 and the port's
  one-rank engine's, at tp 4 and pp 2 x tp 2 the one-rank engine's (the
  pipelined decode ran on every rank); soft-fp8 on load at tp 2 and at
  pp 2 x tp 2 keeps the one-rank tokens; on every rank of a world the
  capacity route never ran (it raises) and every router call chose the
  same experts as on rank 0 (a checksum a call);
- each rank holds 1 / tp of the experts and of the other cut leaves;
  DeepSeek's latent pools are whole at pp 1, Mixtral's pool total / tp;
- the checkpoint loaders give each rank its experts and head slices of
  the one-rank tree (Mixtral HF bf16, DeepSeek native fp8);
- E % tp, H % tp and `mla_absorb=none` under tp > 1 pass the engine's
  checks (a world of ranks serves them: tests/test_torch_layouts.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.config import load_config as jload
from chitu_tpu.engine import Engine as JEngine
from chitu_tpu.models import build_model as jbuild
from chitu_tpu.models import moe as jmoe
from chitu_tpu.ops.qtensor import QuantKind as JKind
from chitu_tpu.parallel import make_mesh
from chitu_tpu.parallel.sharding import shard_params as jshard_params
from chitu_tpu.quantize import quantize_params as jquantize
from chitu_tpu.quantize import transforms as jqt
from chitu_tpu.task import SampleParams as JSampleParams
from chitu_tpu_torch import SampleParams, load_config
from chitu_tpu_torch.config import MoEArgs
from chitu_tpu_torch.engine import Engine, check_supported
from chitu_tpu_torch.models import moe as tmoe
from chitu_tpu_torch.models.deepseek_v3 import MLALayout
from chitu_tpu_torch.models.common import kv_pool_minor
from chitu_tpu_torch.models.llama import TPLayout, params_from_numpy
from chitu_tpu_torch.ops.qtensor import QTensor
from chitu_tpu_torch.parallel.sharding import StageSlice

import test_torch_loader as tl
from test_torch_moe import _setup, _tq
from test_torch_tp import _jax_op_impl_auto, _join, _one_torch_thread, _spawn  # noqa: F401
from torch_tp_world import leaf_bytes, save_tree

COMMON = ["infer.max_seq_len=128", "infer.max_reqs=4", "infer.page_size=16",
          "infer.stop_with_eos=false", "dtype=float32"]
MIXTRAL = ["models=tiny-mixtral-debug", "models.n_layers=2",
           "infer.merge_qkv_gate_up=off"] + COMMON
DEEPSEEK = ["models=tiny-deepseek-debug", "models.n_layers=3"] + COMMON  # 1 + 2
# soft-fp8 cuts on 128-column blocks: a rank's q / k / v, wq_b, wo rows
# and shared expert fill whole blocks at tp 2 and 4
MIXTRAL_FP8 = MIXTRAL + ["models.head_dim=128"]
DEEPSEEK_FP8 = DEEPSEEK + ["models.mla.qk_nope_head_dim=48",
                           "models.mla.v_head_dim=64", "models.moe.moe_inter_dim=512"]
SOFT = ["quant.method=soft_fp8", "quant.quant_on_load=true"]
TP2, TP4, PP2TP2 = (["infer.tp_size=2"], ["infer.tp_size=4"],
                    ["infer.pp_size=2", "infer.tp_size=2"])
rng = np.random.default_rng(15)
PROMPTS = [rng.integers(1, 1024, n).tolist() for n in (11, 26, 7, 19)]
NEW = [5, 5, 5, 5]
FAMILIES = {"mixtral": MIXTRAL, "deepseek": DEEPSEEK}


def _jax_tree(ovr, key):
    """A JAX f32 draw with its embedding at 1.0 (far above the engines'
    rounding noise), as numpy."""
    cfg = jload(overrides=ovr)
    p = jbuild(cfg.models, cfg).init_params(jax.random.PRNGKey(key), jnp.float32)
    p["embed"] = p["embed"] * 50.0
    return jax.tree_util.tree_map(np.asarray, p)


def _jax_tokens(ovr, tree):
    """Greedy tokens of the JAX engine on `tree`, placed with its own
    shardings."""
    eng = JEngine(jload(overrides=ovr))
    eng.params = eng.executor.params = jax.tree_util.tree_map(
        lambda a, old: jax.device_put(jnp.asarray(a), old.sharding), tree,
        eng.params)
    reqs = [eng.submit("", JSampleParams(temperature=0.0, max_new_tokens=n),
                       prompt_tokens=p) for p, n in zip(PROMPTS, NEW)]
    eng.run_until_complete()
    return [list(r.async_stream.tokens) for r in reqs]


def _port(ovr, tree=None):
    params = None if tree is None else (
        lambda m: params_from_numpy(tree, m.layout))
    return Engine(load_config(overrides=ovr), device="cpu", params=params)


def _tokens(eng):
    reqs = [eng.submit("", SampleParams(temperature=0.0, max_new_tokens=n),
                       prompt_tokens=p) for p, n in zip(PROMPTS, NEW)]
    eng.run_until_complete()
    return [list(r.async_stream.tokens) for r in reqs]


def _expert_bytes(leaf_bytes):
    return sum(v for k, v in leaf_bytes.items()
               if k.split("/")[-1] in ("w_gate", "w_up", "w_gu", "w_down",
                                       "exp_gate", "exp_up", "exp_gu", "exp_down"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results and their references: the JAX engines' tokens
    at tp 2, the port's one-rank engines' tokens, bytes and pools."""
    trees = {"mixtral": _jax_tree(MIXTRAL, 7), "deepseek": _jax_tree(DEEPSEEK, 8)}
    d2, d4, dpp = (tmp_path_factory.mktemp(k) for k in ("ep2", "ep4", "eppp"))
    paths = {}
    for k, t in trees.items():
        paths[k] = str(d2 / f"{k}.npz")
        save_tree(t, paths[k])
    spy = dict(nocap=True, routes=True, prompts=PROMPTS, new=NEW)
    sc2 = [dict(name=f, overrides=FAMILIES[f] + TP2, tree=paths[f], **spy)
           for f in FAMILIES]
    sc2 += [dict(name="mixtral_fp8", overrides=MIXTRAL_FP8 + SOFT + TP2, **spy),
            dict(name="deepseek_fp8", overrides=DEEPSEEK_FP8 + SOFT + TP2, **spy)]
    sc4 = [dict(name=f"{f}_tp4", overrides=FAMILIES[f] + TP4, tree=paths[f], **spy)
           for f in FAMILIES]
    scpp = [dict(name=f"{f}_pp", overrides=FAMILIES[f] + PP2TP2, tree=paths[f],
                 spy=True, **spy) for f in FAMILIES]
    scpp.append(dict(name="deepseek_fp8_pp", overrides=DEEPSEEK_FP8 + SOFT + PP2TP2,
                     spy=True, **spy))
    p2 = _spawn(str(d2), 2, sc2, env_rendezvous=False)
    p4 = _spawn(str(d4), 4, sc4, env_rendezvous=True)
    ppp = _spawn(str(dpp), 4, scpp, env_rendezvous=False)
    try:
        ref = {}
        for f, ovr in FAMILIES.items():
            ref["jax_" + f] = _jax_tokens(ovr + TP2, trees[f])
            one = _port(ovr, trees[f])
            ref[f] = _tokens(one)
            ref[f + "_bytes"] = (leaf_bytes(one.model.params_tree()),
                                 one.cache.bytes())
        for f, ovr in (("mixtral_fp8", MIXTRAL_FP8), ("deepseek_fp8", DEEPSEEK_FP8)):
            ref[f] = _tokens(_port(ovr + SOFT))
    finally:
        out2 = _join(str(d2), p2)
        out4 = _join(str(d4), p4)
        outpp = _join(str(dpp), ppp)
    return dict(tp2=out2, tp4=out4, pp2_tp2=outpp, ref=ref)


def _world(worlds, name):
    if name.endswith("_pp"):
        return worlds["pp2_tp2"]
    return worlds["tp4"] if name.endswith("_tp4") else worlds["tp2"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tp2_tokens_match_jax_and_one_rank(worlds, family):
    ref = worlds["ref"]
    assert ref[family] == ref["jax_" + family]
    assert len({tuple(t) for t in ref[family]}) > 1  # not a degenerate loop
    assert worlds["tp2"][0][family]["tokens"] == ref[family]


@pytest.mark.parametrize("name", ["mixtral_tp4", "deepseek_tp4", "mixtral_pp",
                                  "deepseek_pp"])
def test_tp4_and_pp2_tp2_keep_the_tokens(worlds, name):
    res = _world(worlds, name)
    family = name.split("_")[0]
    assert res[0][name]["tokens"] == worlds["ref"][family]
    if name.endswith("_pp"):
        # every rank ran the same pipelined windows
        assert all(r[name]["pipelined"] == res[0][name]["pipelined"] > 0
                   for r in res), name
        assert [r[name]["stage"] for r in res] == [0, 0, 1, 1]


@pytest.mark.parametrize("name", ["mixtral_fp8", "deepseek_fp8", "deepseek_fp8_pp"])
def test_soft_fp8_on_load_keeps_the_one_rank_tokens(worlds, name):
    """Quantized whole on every rank, then cut: the e4m3 experts run the
    grouped kernel's path on the rank's experts (the flagship layout,
    tests/test_parallel.py:403,680, at pp 2 x tp 2)."""
    got = _world(worlds, name)[0][name]["tokens"]
    assert got == worlds["ref"][name.replace("_pp", "")]


@pytest.mark.parametrize("world", ["tp2", "tp4", "pp2_tp2"])
def test_routers_agree_and_capacity_route_never_ran(worlds, world):
    """The `nocap` spy raised on no rank (the worlds ran to their end);
    every rank's router calls of a scenario chose the same experts as
    those of the ranks of its stage (one checksum a call)."""
    res = worlds[world]
    for name, r0 in res[0].items():
        for r in res:
            same_stage = [q for q in res if q[name]["stage"] == r[name]["stage"]]
            assert r[name]["routes"], name
            assert all(q[name]["routes"] == r[name]["routes"] for q in same_stage), name


# each family's layout: the leaves whose spec has no cut (norms, the
# router, the latent down-projections) every rank holds whole
LAYOUTS = {"mixtral": TPLayout(moe=True), "deepseek": MLALayout()}


@pytest.mark.parametrize("family,world,name,tp", [
    ("mixtral", "tp2", "mixtral", 2), ("deepseek", "tp2", "deepseek", 2),
    ("mixtral", "tp4", "mixtral_tp4", 4), ("deepseek", "tp4", "deepseek_tp4", 4)])
def test_per_rank_bytes(worlds, family, world, name, tp):
    """Experts total / tp on every rank, every other cut leaf too, the
    router, norms and latent down-projections whole; the pool: Mixtral's
    the rank's KV heads (total / tp, but for a row's 128-lane minimum:
    one head of 32 lanes a rank at tp 4 fills a row of 128), DeepSeek's
    latent pools whole (a latent row is every head's)."""
    one, pool_total = worlds["ref"][family + "_bytes"]
    for r, res in enumerate(worlds[world]):
        got = res[name]
        assert sorted(got["leaf_bytes"]) == sorted(one), r
        for k, v in one.items():
            spec = LAYOUTS[family].part_spec(k.split("/")[-1], 4)
            whole = all(e is None for e in spec)
            assert got["leaf_bytes"][k] * (1 if whole else tp) == v, (r, k)
        assert _expert_bytes(got["leaf_bytes"]) * tp == _expert_bytes(one)
        want_pool = pool_total
        if family == "mixtral":  # tiny-mixtral-debug: 4 KV heads of 32
            want_pool = pool_total * kv_pool_minor(4 // tp, 32) // kv_pool_minor(4, 32)
        assert got["pool_bytes"] == want_pool, r


# ---------------------------------------------------------------------------
# shards against the JAX package's partition specs (no world needed)
# ---------------------------------------------------------------------------


def _jax_shards(ovr, tree, tp):
    """Each tp rank's slice of every leaf of a nested tree, as the JAX
    package places it on the virtual mesh -> [rank] -> nested {name:
    array or {field: array}}."""
    cfg = jload(overrides=ovr + [f"infer.tp_size={tp}"])
    m = jbuild(cfg.models, cfg)
    mesh = make_mesh(tp=tp)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    placed = jshard_params(jt, m.param_partition_specs(jt), mesh)
    devs = list(mesh.devices.flat)

    def per_rank(a):
        out = [None] * tp
        for s in a.addressable_shards:
            out[devs.index(s.device)] = np.asarray(s.data)
        return out

    res = [dict() for _ in range(tp)]

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            fields = ("data", "scale") if hasattr(v, "scale") else (None,)
            for f in fields:
                for r, a in enumerate(per_rank(getattr(v, f) if f else v)):
                    d = res[r]
                    for p in path:
                        d = d.setdefault(p, {})
                    if f:
                        d.setdefault(k, {})[f] = a
                    else:
                        d[k] = a

    walk(placed, ())
    return res


def _assert_equal_to_jax(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k, w in want.items():
        g = got[k]
        if isinstance(g, dict):
            _assert_equal_to_jax(g, w, f"{path}{k}/")
        elif isinstance(g, QTensor):
            for f in ("data", "scale"):
                t = getattr(g, f)
                t = t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
                np.testing.assert_array_equal(t.numpy(), np.asarray(w[f]).view(
                    np.uint8) if t.dtype == torch.uint8 else w[f],
                    err_msg=f"{path}{k}.{f}")
        else:
            np.testing.assert_array_equal(g.float().numpy() if g.dtype == torch.bfloat16
                                          else g.numpy(), np.asarray(w, np.float32)
                                          if g.dtype == torch.bfloat16 else w,
                                          err_msg=f"{path}{k}")


SHARD_CARDS = {"mixtral": MIXTRAL_FP8 + ["models.n_layers=1"],
               "deepseek": DEEPSEEK_FP8 + ["models.n_layers=2"]}


@pytest.fixture(scope="module")
def shard_trees():
    """Per family: the f32 draw in bf16, quantized soft-fp8 by the JAX
    package, and that merged (tp-aware)."""
    out = {}
    for f, ovr in SHARD_CARDS.items():
        cfg = jload(overrides=ovr + SOFT)
        m = jbuild(cfg.models, cfg)
        p = m.init_params(jax.random.PRNGKey(3), jnp.bfloat16)
        q = jquantize(p, cfg.quant, m)
        out[f] = dict(
            bf16=jax.tree_util.tree_map(np.asarray, p),
            soft_fp8=jax.tree_util.tree_map(np.asarray, q),
            merged={tp: jax.tree_util.tree_map(
                np.asarray, jqt.merge_moe_gate_up(dict(q), tp=tp)) for tp in (2, 4)})
    return out


@pytest.mark.parametrize("case", ["bf16", "soft_fp8", "merged"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", sorted(SHARD_CARDS))
def test_shards_equal_jax_partition_slices(shard_trees, family, tp, case):
    tree = shard_trees[family][case]
    tree = tree[tp] if case == "merged" else tree
    ovr = SHARD_CARDS[family]
    if case == "merged":
        m = tree.get("layers", tree.get("moe_layers"))
        assert ("w_gu" in m) or ("exp_gu" in m and "wq_kv_a" in m), sorted(m)
    want = _jax_shards(ovr, tree, tp)
    a = load_config(overrides=ovr).models
    for r in range(tp):
        if family == "mixtral":
            lay = TPLayout(r, tp, a.n_heads, a.n_kv_heads, a.head_dim_(),
                           a.inter_dim, a.vocab_size, merged=False, moe=True)
            w = {k: v for k, v in want[r].items() if k != "layers"}
            w.update(want[r]["layers"])
            _assert_equal_to_jax(params_from_numpy(tree, lay), w)
        else:
            lay = MLALayout(r, tp, a.n_heads, StageSlice())
            _assert_equal_to_jax(params_from_numpy(tree, lay), want[r])


# ---------------------------------------------------------------------------
# moe_ffn_ep in one process
# ---------------------------------------------------------------------------

E, K = 8, 2


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", ["bf16", "e4m3", "int8"])
def test_moe_ffn_ep_sums_to_the_one_rank_layer(mode, tp):
    """The ranks' partials of `moe_ffn_ep` (each on its E / tp experts)
    summed: bf16 and e4m3 through the grouped kernel's plain version
    against the one-rank `moe_ffn_sorted` (each partial rounded to bf16:
    1e-2 of the norm) and each rank's partial against the JAX package's
    manual-EP body on the same local stacks (its grouped kernel
    interpreted; 1e-2 bf16, 2e-2 e4m3); int8 through the capacity route
    with the dead column against the JAX dense oracle on the dequantized
    experts (f32: 1e-4)."""
    x, sel, w, wg, wu, wd = _setup(seed=15)
    args = MoEArgs(n_routed_experts=E, n_activated_experts=K)
    El = E // tp
    if mode == "bf16":
        jw = [jnp.asarray(a[None]).astype(jnp.bfloat16) for a in (wg, wu, wd)]
        tw = [torch.from_numpy(a[None]).to(torch.bfloat16) for a in (wg, wu, wd)]
    else:
        kind = JKind.SOFT_FP8 if mode == "e4m3" else JKind.W8A16
        jw = [jqt.quantize_weight(jnp.asarray(a[None]), kind) for a in (wg, wu, wd)]
        tw = [_tq(a) for a in jw]
    xt = torch.from_numpy(x)
    if mode != "int8":
        xt = xt.to(torch.bfloat16)
    wt, st = torch.from_numpy(w), torch.from_numpy(sel)
    spied = []
    real = tmoe.moe_ffn
    tmoe.moe_ffn = lambda *a, **k: spied.append(1) or real(*a, **k)
    try:
        parts = [tmoe.moe_ffn_ep(
            xt, *[t[:, r * El:(r + 1) * El] for t in tw], wt, st, r, tp,
            layer=0, moe=args) for r in range(tp)]
    finally:
        tmoe.moe_ffn = real
    assert bool(spied) == (mode == "int8")  # the capacity route only for int8
    got = sum(p.float() for p in parts)
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    if mode == "int8":
        deq = [np.asarray(q.dequantize(jnp.float32)) for q in jw]
        want = jmoe.moe_ffn_ref(jnp.asarray(x), *[jnp.asarray(d[0]) for d in deq],
                                jnp.asarray(w), jnp.asarray(sel))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
        return
    one = tmoe.moe_ffn_sorted(xt, *tw, wt, st, E, layer=0)
    assert rel(got.numpy(), one.float().numpy()) < 1e-2
    if tp == 2:
        # rank r's partial: the JAX moe_ffn_manual_ep body on its stacks
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        for r in range(tp):
            sl = np.where((sel - r * El < 0) | (sel - r * El >= El), El,
                          sel - r * El).astype(np.int32)
            jl = [a[:, r * El:(r + 1) * El] for a in jw]
            want = jmoe.moe_ffn_sorted(
                jx, *jl, jnp.asarray(w), jnp.asarray(sl), El, layer=0,
                interpret=True, e_dispatch=El + 1)
            assert rel(parts[r].float().numpy(), np.asarray(
                want.astype(jnp.float32))) < (1e-2 if mode == "bf16" else 2e-2)
    # rank 1 holds experts [El, 2 El): foreign ids take the dead id
    assert tmoe.local_ids(st, El, El).max() == El


def test_moe_ffn_auto_takes_the_ep_path_under_tp():
    x, sel, w, wg, wu, wd = _setup(seed=16)
    tw = [torch.from_numpy(a[None, :4]).to(torch.bfloat16) for a in (wg, wu, wd)]
    args = MoEArgs(n_routed_experts=E, n_activated_experts=K)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    a = tmoe.moe_ffn_auto(xt, *tw, torch.from_numpy(w), torch.from_numpy(sel),
                          args, layer=0, rank=0, tp=2)
    b = tmoe.moe_ffn_ep(xt, *tw, torch.from_numpy(w), torch.from_numpy(sel),
                        0, 2, layer=0, moe=args)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="local experts"):
        tmoe.moe_ffn_ep(xt, *tw, torch.from_numpy(w), torch.from_numpy(sel),
                        0, 4, layer=0, moe=args)


# ---------------------------------------------------------------------------
# the loaders and the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,tp", [("mixtral", 2), ("mixtral", 4), ("deepseek_fp8", 2)])
def test_loader_reads_the_rank_slices(tmp_path, fmt, tp):
    """Each rank reads its experts and its head / column / vocab slices:
    the JAX loader's one-rank tree cut by the rank's layout."""
    extra = (["models.mla.qk_rope_head_dim=32", "models.moe.moe_inter_dim=256"]
             if fmt == "deepseek_fp8" else [])
    ovr, d = tl.checkpoint(fmt, tmp_path)
    ovr = ovr + extra
    if extra:  # the checkpoint at these widths
        d = tl.write(tl._deepseek_fp8(tl.deepseek_tensors(ovr)), str(tmp_path / "w"),
                     files=2)
    jcfg, cfg = tl._cfgs(ovr, d)
    jtree = jax.tree_util.tree_map(
        np.asarray, tl.jload_checkpoint(jbuild(jcfg.models, jcfg), jcfg))
    a = cfg.models
    for r in range(tp):
        model = tl.build_model(a, cfg, device="cpu")
        if fmt == "mixtral":
            model.layout = TPLayout(r, tp, a.n_heads, a.n_kv_heads, model.head_dim,
                                    model.inter_dim, a.vocab_size,
                                    merged=model.merged, moe=True)
        else:
            model.layout = MLALayout(r, tp, a.n_heads, StageSlice())
        got = tl.load_checkpoint(model, cfg, "cpu")
        want = params_from_numpy(jtree, model.layout)
        if "layers" in got:
            got = {**{k: v for k, v in got.items() if k != "layers"}, **got["layers"]}
        tl.assert_trees_equal(want, got)
        stacks = got.get("moe_layers", got)
        stack = stacks.get("exp_down", stacks.get("w_down"))
        n = (stack.data if isinstance(stack, QTensor) else stack).shape[1]
        assert n == a.moe.n_routed_experts // tp


@pytest.mark.parametrize("ovr,match", [
    (MIXTRAL + ["infer.tp_size=3"], "ROADMAP C"),  # 8 experts, 8 heads
    (DEEPSEEK + ["infer.tp_size=4", "models.n_heads=6"], "ROADMAP C"),
    (DEEPSEEK + ["infer.tp_size=2", "infer.mla_absorb=none"], "A.6"),
    (DEEPSEEK + PP2TP2 + ["infer.mla_absorb=none"], "A.6"),
])
def test_refusals(ovr, match):
    """Layouts refused until they were served: experts or heads that tp
    does not divide (ROADMAP C until slice 18: uneven expert ranges and
    replicated attention, tests/test_torch_layouts.py) and the dense MLA
    under tp (A.6, slice 17). Each passes `check_supported` and on one
    process asks for its ranks."""
    check_supported(load_config(overrides=ovr))
    with pytest.raises(ValueError, match="num_processes"):
        Engine(load_config(overrides=ovr), device="cpu")
