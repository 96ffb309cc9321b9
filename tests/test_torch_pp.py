"""Pipeline parallelism of the port (`infer.pp_size`): the counterparts of
tests/test_parallel.py:70,182,211,288,314,363,515,884, on the CPU.

Two worlds of port processes, started once for the module (pp 2 over 2
ranks, pp 2 x tp 2 over 4), each over gloo with a `file://` rendezvous,
run `tests/torch_tp_world.py`: rank 0 serves each scenario, the others
follow it. Weights and prompts cross as `.npz` and JSON files; every
world has a timeout, and all its ranks are killed when one fails. Held,
on f32 trees of the JAX package (so tokens compare exactly):
- a burst of four greedy requests takes the microbatch-pipelined decode
  (a spy counts its windows on every rank), under the default and the
  skew_pipeline policies, and a lone request the sequential path; each
  gives the tokens of the JAX engine at tp=1 and at pp=2 on the 8
  virtual devices, and of the port's one-rank engine;
- frequency penalties and an in-window stop token in the pipelined
  window, a sliding-window + softcap card, a quantized head, soft-fp8 on
  load, a prefix-cache hit and n-gram speculative rounds keep the
  one-rank engine's tokens;
- Mixtral and DeepSeek (soft-fp8 trees the JAX package quantized) at
  pp 2 give the JAX engine's tokens;
- each rank's weights are its layer share of the whole, plus the
  embedding on stage 0 and the norm and head on the last; its pool holds
  L / pp layers (and 1 / tp of the KV heads);
- the checkpoint loader under a stage layout gives each rank the layer
  slice of the one-stage tree;
- a step that fails on one stage ends every rank of its world.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chitu_tpu.config import load_config as jload
from chitu_tpu.engine import Engine as JEngine
from chitu_tpu.models import build_model as jbuild
from chitu_tpu.quantize import quantize_params as jquantize
from chitu_tpu.task import SampleParams as JSampleParams
from chitu_tpu_torch import SampleParams, load_config
from chitu_tpu_torch.engine import Engine
from chitu_tpu_torch.models.llama import TPLayout, params_from_numpy
from chitu_tpu_torch.parallel import pipeline
from chitu_tpu_torch.parallel.sharding import StageSlice

import test_torch_loader as tl
from test_torch_tp import (
    BASE, PREFIX_PROMPTS, REPEAT, _jax_op_impl_auto, _jax_tokens,  # noqa: F401
    _join, _one_torch_thread, _spawn, _tree)  # noqa: F401
from torch_tp_world import save_tree

rng = np.random.default_rng(14)
BURST = [rng.integers(1, 512, n).tolist() for n in (9, 20, 33, 14)]
NEW = [6, 6, 6, 6]
PP2 = ["infer.pp_size=2"]
SOFT = ["quant.method=soft_fp8", "quant.quant_on_load=true"]
SOFTCAP = ["models.sliding_window=24", "models.attn_softcap=30.0"]
QHEAD = SOFT + ["quant.quantize_head=true"]
PEN = [50.0, 50.0]
MOE_NEW = [5, 5]
MIXTRAL = ["models=tiny-mixtral-debug", "models.n_layers=2",
           "infer.max_seq_len=128", "infer.max_reqs=4", "infer.page_size=16",
           "infer.stop_with_eos=false", "dtype=float32"]
DEEPSEEK = ["models=tiny-deepseek-debug", "models.n_layers=3",  # n_moe 2
            "infer.max_seq_len=128", "infer.max_reqs=4", "infer.page_size=16",
            "infer.stop_with_eos=false", "dtype=float32"]
MOE_PROMPTS = [rng.integers(1, 1024, n).tolist() for n in (11, 26)]


def _jax_moe(ovr, key):
    """The JAX engine of a MoE card on an f32 draw (embedding at 1.0)
    quantized soft-fp8 by the JAX package, and that tree as numpy."""
    cfg = jload(overrides=ovr + ["quant.method=soft_fp8"])
    eng = JEngine(cfg)  # serves its own draw unquantized: no on-load pass
    p = eng.model.init_params(jax.random.PRNGKey(key), jnp.float32)
    p["embed"] = p["embed"] * 50.0
    eng.params = eng.executor.params = jquantize(p, cfg.quant, eng.model)
    return eng, jax.tree_util.tree_map(np.asarray, eng.params)


def _jax_moe_tokens(eng, prompts, new):
    reqs = [eng.submit("", JSampleParams(temperature=0.0, max_new_tokens=n),
                       prompt_tokens=p) for p, n in zip(prompts, new)]
    eng.run_until_complete()
    return [list(r.async_stream.tokens) for r in reqs]


def _port(ovr, tree):
    return Engine(load_config(overrides=ovr), device="cpu",
                  params=lambda m: params_from_numpy(tree, m.layout))


def _tokens(eng, prompts, new, pens=None, stop=None, one_by_one=False):
    """Greedy tokens of a one-rank engine; `stop[i]` a stop token of
    request i's own, set on its task as the world script sets it."""
    reqs = []
    for i, (p, n) in enumerate(zip(prompts, new)):
        sp = SampleParams(temperature=0.0, max_new_tokens=n,
                          frequency_penalty=(pens or [0.0] * 8)[i])
        reqs.append(eng.submit("", sp, prompt_tokens=p))
        if stop and stop[i] is not None:
            t = eng.pool[f"task-{reqs[-1].request_id}"]
            t.stop_with_eos, t.stop_tokens = True, frozenset({stop[i]})
        if one_by_one:
            eng.run_until_complete()
    eng.run_until_complete()
    return [list(r.async_stream.tokens) for r in reqs]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results and their references (the JAX engines' and
    the port's one-rank engines' tokens)."""
    _, U = _tree(["infer.merge_qkv_gate_up=off"])
    d2, d4 = tmp_path_factory.mktemp("pp2"), tmp_path_factory.mktemp("pp2tp2")
    paths = {"U": str(d2 / "U.npz")}
    save_tree(U, paths["U"])
    b = BASE + PP2
    sc4 = [
        dict(name="burst", overrides=b + ["infer.tp_size=2"], tree=paths["U"],
             prompts=BURST, new=NEW, spy=True),
        dict(name="lone", overrides=b + ["infer.tp_size=2"], tree=paths["U"],
             prompts=BURST[:1], new=NEW[:1], spy=True),
    ]
    p4 = _spawn(str(d4), 4, sc4, env_rendezvous=True)
    jeng = {"mixtral": _jax_moe(MIXTRAL, 7), "deepseek": _jax_moe(DEEPSEEK, 8)}
    trees = {"U": U, **{k: v[1] for k, v in jeng.items()}}
    for k in jeng:
        paths[k] = str(d2 / f"{k}.npz")
        save_tree(trees[k], paths[k])
    one = _port(BASE + ["infer.merge_qkv_gate_up=off"], U)
    probe = _tokens(one, BURST[:1], [8])[0]
    stop = [probe[2], None]  # cuts request 0 inside the window
    assert probe.index(stop[0]) < 7
    sc2 = [
        dict(name="burst", overrides=b, tree=paths["U"], prompts=BURST, new=NEW,
             spy=True),
        dict(name="lone", overrides=b, tree=paths["U"], prompts=BURST[:1],
             new=NEW[:1], spy=True),
        dict(name="skew", overrides=b + ["scheduler.policy=skew_pipeline"],
             tree=paths["U"], prompts=BURST, new=NEW, spy=True),
        dict(name="penalty", overrides=b, tree=paths["U"], prompts=BURST[:2],
             new=[8, 8], pens=PEN, spy=True),
        dict(name="stop", overrides=b, tree=paths["U"], prompts=BURST[:2],
             new=[8, 8], stop=stop, spy=True),
        dict(name="softcap", overrides=b + SOFTCAP, tree=paths["U"],
             prompts=BURST, new=NEW, spy=True),
        dict(name="qhead", overrides=b + QHEAD, tree=paths["U"],
             prompts=BURST[:3], new=NEW[:3], spy=True),
        dict(name="soft_fp8", overrides=b + SOFT, tree=paths["U"],
             prompts=BURST, new=NEW, spy=True),
        dict(name="prefix", overrides=b + ["infer.prefix_cache=true"],
             tree=paths["U"], prompts=PREFIX_PROMPTS, new=[6, 6], one_by_one=True),
        dict(name="spec", overrides=b + ["infer.spec_decode=ngram",
                                         "infer.spec_k=3"],
             tree=paths["U"], prompts=[REPEAT], new=[12]),
        dict(name="mixtral", overrides=MIXTRAL + SOFT + PP2,
             tree=paths["mixtral"], prompts=MOE_PROMPTS, new=MOE_NEW, spy=True),
        dict(name="deepseek", overrides=DEEPSEEK + SOFT + PP2,
             tree=paths["deepseek"], prompts=MOE_PROMPTS, new=MOE_NEW, spy=True),
    ]
    p2 = _spawn(str(d2), 2, sc2, env_rendezvous=False)
    try:
        ref = dict(
            jax1=_jax_tokens(["infer.merge_qkv_gate_up=off"], U, BURST, NEW),
            jaxpp2=_jax_tokens(["infer.merge_qkv_gate_up=off"] + PP2, U,
                               BURST, NEW),
            burst=_tokens(one, BURST, NEW),
            lone=_tokens(one, BURST[:1], NEW[:1]),
            penalty=_tokens(one, BURST[:2], [8, 8], pens=PEN),
            stop=_tokens(one, BURST[:2], [8, 8], stop=stop),
            prefix=_tokens(one, PREFIX_PROMPTS, [6, 6], one_by_one=True),
            spec=_tokens(one, [REPEAT], [12]),
        )
        for name, extra, prompts in (("softcap", SOFTCAP, BURST),
                                     ("qhead", QHEAD, BURST[:3]),
                                     ("soft_fp8", SOFT, BURST)):
            ref[name] = _tokens(_port(BASE + extra, U), prompts, NEW)
        for name, ovr in (("mixtral", MIXTRAL), ("deepseek", DEEPSEEK)):
            ref[name] = _tokens(_port(ovr + SOFT, trees[name]), MOE_PROMPTS,
                                MOE_NEW)
            ref["jax_" + name] = _jax_moe_tokens(jeng[name][0], MOE_PROMPTS,
                                                 MOE_NEW)
        m = one.model
        nbytes = lambda k: getattr(m, k).numel() * 4  # noqa: E731 (f32)
        ref["bytes"] = {k: nbytes(k) for k in ("embed", "norm", "lm_head")}
        ref["bytes"]["layers"] = sum(nbytes(k) for k in m._shapes()
                                     if k in m.LAYER_LEAVES)
        ref["norm_bytes"] = nbytes("attn_norm") + nbytes("ffn_norm")
        ref["pool"] = one.cache.bytes()
    finally:
        out2 = _join(str(d2), p2)
        out4 = _join(str(d4), p4)
    return dict(pp2=out2, pp2tp2=out4, ref=ref)


def test_burst_takes_the_pipelined_decode_and_keeps_the_tokens(worlds):
    ref = worlds["ref"]
    assert ref["jax1"] == ref["jaxpp2"] == ref["burst"]
    assert len({tuple(t) for t in ref["burst"]}) > 1  # not a degenerate loop
    for w in ("pp2", "pp2tp2"):
        r0 = worlds[w][0]["burst"]
        assert r0["tokens"] == ref["burst"], w
        # every rank ran the same pipelined windows
        assert all(r["burst"]["pipelined"] == r0["pipelined"] > 0
                   for r in worlds[w]), w


def test_lone_request_takes_the_sequential_path(worlds):
    for w in ("pp2", "pp2tp2"):
        r0 = worlds[w][0]["lone"]
        assert r0["tokens"] == worlds["ref"]["lone"] == worlds["ref"]["burst"][:1]
        assert all(r["lone"]["pipelined"] == 0 for r in worlds[w]), w


def test_skew_pipeline_policy_keeps_the_tokens(worlds):
    r0 = worlds["pp2"][0]["skew"]
    assert r0["tokens"] == worlds["ref"]["burst"] and r0["pipelined"] > 0


@pytest.mark.parametrize("name", ["penalty", "stop", "softcap", "qhead",
                                  "soft_fp8"])
def test_pipelined_window_features_keep_the_tokens(worlds, name):
    """Frequency penalties and a stop token latch inside the pipelined
    window (the last stage samples, counts and latches); a sliding window
    with softcap, a quantized head and soft-fp8 weights on each stage."""
    r0 = worlds["pp2"][0][name]
    assert r0["tokens"] == worlds["ref"][name]
    assert r0["pipelined"] > 0
    if name == "penalty":
        for toks in r0["tokens"]:  # -50 a repeat: every token differs
            assert len(set(toks)) == len(toks) == 8
    if name == "stop":
        a, b = r0["tokens"]
        assert len(a) < 8 and len(b) == 8


def test_prefix_cache_and_spec_decode_under_pp(worlds):
    r0, ref = worlds["pp2"][0], worlds["ref"]
    assert r0["prefix"]["tokens"] == ref["prefix"]
    assert r0["prefix"]["prefix_hits"] > 0
    assert r0["spec"]["tokens"] == ref["spec"]
    assert r0["spec"]["spec_stats"][1] > 0  # verify rounds ran


@pytest.mark.parametrize("family", ["mixtral", "deepseek"])
def test_moe_families_at_pp2_match_jax(worlds, family):
    r0, ref = worlds["pp2"][0][family], worlds["ref"]
    assert r0["tokens"] == ref["jax_" + family] == ref[family]
    assert r0["pipelined"] > 0


def test_deepseek_stages_hold_their_stacks_and_pools(worlds):
    """The dense-first layer and its pool on stage 0 only; one MoE layer
    and its pool slice on each stage; the embedding on stage 0, the norm
    and head on stage 1."""
    r0, r1 = (w["deepseek"] for w in worlds["pp2"])
    assert r0["pools"]["kv_dense"][0] == 1 and r0["pools"]["kv_moe"][0] == 1
    assert "kv_dense" not in r1["pools"] and r1["pools"]["kv_moe"][0] == 1
    assert r0["leaves"] == ["dense_layers", "embed", "moe_layers"]
    assert r1["leaves"] == ["lm_head", "moe_layers", "norm"]


@pytest.mark.parametrize("world,tp", [("pp2", 1), ("pp2tp2", 2)])
def test_per_rank_bytes_are_the_stage_share(worlds, world, tp):
    """Rank (p, t): (layers - norms) / (pp tp) + norms / pp, plus the
    embedding / tp on stage 0 and the head / tp and the norm on the last;
    its pool total / (pp tp)."""
    ref = worlds["ref"]
    by = ref["bytes"]
    norms = ref["norm_bytes"]
    for r, res in enumerate(worlds[world]):
        p = r // tp
        want = (by["layers"] - norms) // (2 * tp) + norms // 2
        want += by["embed"] // tp if p == 0 else by["lm_head"] // tp + by["norm"]
        assert res["burst"]["weight_bytes"] == want, r
        assert res["burst"]["pool_bytes"] * 2 * tp == ref["pool"], r
        assert res["burst"]["stage"] == p


def test_supports_pipeline_and_refusals():
    """A stack pp does not divide takes uneven contiguous ranges since
    slice 17 (the JAX package replicates it; tests/test_torch_layouts.py
    serves them); dp > 1 on one process asks for its ranks; Mixtral and
    DeepSeek serve pp x tp (tests/test_torch_ep.py), DeepSeek's dense MLA
    too since slice 17 and experts that tp does not divide since slice 18
    (on one process each asks for its ranks)."""
    assert [StageSlice.of(p, 2, {"layers": 3}).ranges["layers"]
            for p in range(2)] == [(0, 2), (2, 3)]
    s = StageSlice.of(1, 2, {"dense_layers": 1, "moe_layers": 4},
                      first_only=("dense_layers",))
    assert s.ranges == {"dense_layers": (0, 0), "moe_layers": (2, 4)}
    assert (s.embed, s.head) == (False, True)
    assert StageSlice.of(1, 2, {"layers": 4}, tied=True).embed

    one = Engine(load_config(overrides=BASE), device="cpu")
    assert not pipeline.supports_pipeline(one.model)
    # replicas serve since slice 16: on one process dp asks for its ranks
    with pytest.raises(ValueError, match="num_processes=2"):
        Engine(load_config(overrides=BASE + ["infer.dp_size=2"]), device="cpu")
    # experts that tp does not divide take uneven ranges since slice 18
    with pytest.raises(ValueError, match="num_processes=6"):
        Engine(load_config(overrides=BASE + MIXTRAL + PP2 + ["infer.tp_size=3"]),
               device="cpu")
    with pytest.raises(ValueError, match="num_processes=4"):
        Engine(load_config(overrides=BASE + DEEPSEEK + PP2 + [
            "infer.tp_size=2", "infer.mla_absorb=none"]), device="cpu")


@pytest.mark.parametrize("fmt", ["hf_llama_bf16", "gptq_act_order"])
def test_loader_reads_the_stage_layers(tmp_path, fmt):
    """The checkpoint loader under a stage layout (and a stage x TP one)
    gives each rank the layer slice of the one-stage tree: stage 0 the
    embedding, the last stage the norm and the head."""
    ovr, d = tl.checkpoint(fmt, tmp_path)
    jcfg, cfg = tl._cfgs(ovr, d)
    jtree = jax.tree_util.tree_map(
        np.asarray, tl.jload_checkpoint(jbuild(jcfg.models, jcfg), jcfg))
    a = cfg.models
    L = a.n_layers
    for tp in (1, 2):
        for p in range(2):
            model = tl.build_model(a, cfg, device="cpu")
            st = StageSlice.of(p, 2, {"layers": L}, tied=a.tie_word_embeddings)
            model.layout = TPLayout(0, tp, a.n_heads, a.n_kv_heads,
                                    model.head_dim, model.inter_dim,
                                    a.vocab_size, merged=model.merged, stage=st)
            got = tl.load_checkpoint(model, cfg, "cpu")
            want = params_from_numpy(jtree, model.layout)
            got = {**{k: v for k, v in got.items() if k != "layers"},
                   **got["layers"]}
            assert ("embed" in got) == (p == 0 or a.tie_word_embeddings)
            assert ("norm" in got) == (p == 1)
            tl.assert_trees_equal(want, got)


def test_a_step_failing_on_one_stage_ends_the_world(tmp_path):
    """A step that fails on stage 1 alone ends rank 1, and rank 0 fails in
    its next collective instead of waiting: both exit non-zero."""
    sc = [dict(name="fail", overrides=BASE + PP2, fail_rank=1,
               prompts=BURST[:1], new=[4])]
    procs = _spawn(str(tmp_path), 2, sc, env_rendezvous=False)
    deadline = time.time() + 120
    while any(p.poll() is None for p in procs) and time.time() < deadline:
        time.sleep(0.05)
    alive = [p.poll() is None for p in procs]
    for p in procs:
        if p.poll() is None:
            p.kill()
    logs = [p.communicate()[0] for p in procs]
    assert not any(alive), logs
    assert all(p.returncode != 0 for p in procs), logs
    assert "a step fails on this rank alone" in logs[1]
