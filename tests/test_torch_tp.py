"""Tensor parallelism of the port (`infer.tp_size`): the counterparts of
tests/test_parallel.py:33,57,113,144,244,263,486, on the CPU.

Two worlds of port processes, started once for the module (2 ranks
joined through `infer.coordinator` / `num_processes` / `process_id`, 4
ranks through the CHITU_TPU_* variables), each over gloo with a
`file://` rendezvous, run `tests/torch_tp_world.py`: rank 0 serves each
scenario, the others follow it. Weights and prompts cross as `.npz` and
JSON files; every world has a timeout, and all its ranks are killed when
one fails. Held, on f32 trees of the JAX package (so tokens compare
exactly):
- each rank's shards equal the slices that the JAX package's
  `param_partition_specs` gives of the same tree on the 8-device mesh:
  merged rank-major and unmerged, QTensor scales included;
- per-rank weight bytes are total / tp but for the replicated norms, and
  pool bytes total / tp (total / KV when the KV heads are fewer than the
  ranks: each rank holds the one its queries read);
- greedy tokens at tp=2 and tp=4 equal the JAX engine's at the same tp
  and at tp=1, merged and unmerged;
- W8A16 and llmint8 (quantized whole, then cut) serve at tp=2 with the
  tp=1 tokens; n_kv_heads=2 at tp=4 keeps the tokens;
- one HTTP request to rank 0 at tp=2 gives the tp=1 tokens;
- an act-order GPTQ checkpoint (row-parallel weights whose rows index
  the whole input) loads per rank and keeps the tp=1 tokens, and the
  loader cuts each rank the slices `params_from_numpy` cuts;
- a prefix-cache hit and n-gram speculative rounds at tp=2 keep them;
- rank 1 forced to another adaptive-window kappa still runs rank 0's
  windows;
- a step that fails on one rank ends every rank of its world.
"""

import importlib
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.config import load_config as jload
from chitu_tpu.engine import Engine as JEngine
from chitu_tpu.models import build_model as jbuild
from chitu_tpu.parallel import make_mesh
from chitu_tpu.parallel.sharding import shard_params as jshard_params
from chitu_tpu.quantize import quantize_params as jquantize
from chitu_tpu.task import SampleParams as JSampleParams
from chitu_tpu_torch import SampleParams, load_config
from chitu_tpu_torch.engine import Engine
from chitu_tpu_torch.models.llama import TPLayout, params_from_numpy
from chitu_tpu_torch.ops.qtensor import QTensor, QuantKind
from chitu_tpu_torch.parallel import distributed, make_mesh as tmake_mesh
from chitu_tpu_torch.parallel.sharding import (
    dim_range, safe_spec, shard_qtensor,
)

import test_torch_loader as tl
from torch_tp_world import save_tree

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD_TIMEOUT = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


BASE = [
    "models=micro-llama-debug", "models.n_layers=2", "models.dim=256",
    "models.n_heads=8", "models.n_kv_heads=4", "models.head_dim=64",
    "models.inter_dim=512", "models.vocab_size=512", "infer.max_seq_len=128",
    "infer.max_reqs=4", "infer.page_size=16", "infer.stop_with_eos=false",
    "dtype=float32",
]
rng = np.random.default_rng(11)
PROMPTS = [rng.integers(1, 512, n).tolist() for n in (9, 20, 33)]
NEW = [6, 6, 6]
PROMPTS_SMALL = [rng.integers(1, 256, n).tolist() for n in (9, 20, 33)]
PREFIX = rng.integers(1, 512, 40).tolist()
PREFIX_PROMPTS = [PREFIX + [7, 8], PREFIX + rng.integers(1, 512, 9).tolist()]
REPEAT = ([311, 412, 313, 414] * 6)[:24]
KAPPA_NEW = [3, 9, 20]
HTTP_MSG = "tensor parallel over http"


def _tree(extra=(), key=5):
    """A JAX f32 tree with its embedding drawn at 1.0 (its layers add their
    2 % to it, far above the engines' rounding noise), as numpy, and the
    JAX model that made it."""
    cfg = jload(overrides=BASE + list(extra))
    m = jbuild(cfg.models, cfg)
    p = m.init_params(jax.random.PRNGKey(key), jnp.float32)
    p["embed"] = p["embed"] * 50.0
    return m, jax.tree_util.tree_map(np.asarray, p)


def _quantized(tree, method):
    cfg = jload(overrides=BASE + ["infer.merge_qkv_gate_up=off",
                                  f"quant.method={method}", "quant.quant_on_load=true"])
    m = jbuild(cfg.models, cfg)
    q = jquantize(jax.tree_util.tree_map(jnp.asarray, tree), cfg.quant, m)
    return jax.tree_util.tree_map(np.asarray, q)


def _jax_tokens(extra, tree, prompts=PROMPTS, new=NEW):
    """Greedy tokens of the JAX engine on `tree` (placed with the engine's
    own shardings), the prompts submitted together."""
    eng = JEngine(jload(overrides=BASE + list(extra)))
    eng.params = eng.executor.params = jax.tree_util.tree_map(
        lambda a, old: jax.device_put(jnp.asarray(a), old.sharding), tree, eng.params)
    reqs = [eng.submit("", JSampleParams(temperature=0.0, max_new_tokens=n),
                       prompt_tokens=p) for p, n in zip(prompts, new)]
    eng.run_until_complete()
    return [list(r.async_stream.tokens) for r in reqs]


def _port(extra=(), tree=None, merge_tp=1):
    params = None if tree is None else (
        lambda m: params_from_numpy(tree, m.layout, merge_tp))
    return Engine(load_config(overrides=BASE + list(extra)), device="cpu",
                  params=params)


def _port_tokens(eng, prompts=PROMPTS, new=NEW, one_by_one=False):
    reqs = []
    for p, n in zip(prompts, new):
        reqs.append(eng.submit("", SampleParams(temperature=0.0, max_new_tokens=n),
                               prompt_tokens=p))
        if one_by_one:
            eng.run_until_complete()
    eng.run_until_complete()
    return [list(r.async_stream.tokens) for r in reqs]


def _spawn(d, n, scenarios, env_rendezvous):
    """Start a world of n ranks on `scenarios`; -> its processes."""
    rdv = os.path.join(d, "rdv")
    world = {}
    for r in range(n):
        world[str(r)] = [] if env_rendezvous else [
            f"infer.coordinator=file://{rdv}", f"infer.num_processes={n}",
            f"infer.process_id={r}"]
    spec = os.path.join(d, "spec.json")
    with open(spec, "w") as f:
        json.dump({"world": world, "scenarios": scenarios}, f)
    procs = []
    for r in range(n):
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
        if env_rendezvous:
            env.update(CHITU_TPU_COORDINATOR=f"file://{rdv}",
                       CHITU_TPU_NUM_PROCESSES=str(n), CHITU_TPU_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_tp_world.py"), spec, str(r)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _join(d, procs):
    """Wait for every rank (killing all when one fails or time runs out);
    -> each rank's results."""
    deadline = time.time() + WORLD_TIMEOUT
    logs = [None] * len(procs)
    while any(p.poll() is None for p in procs):
        if time.time() > deadline or any(
                p.poll() not in (None, 0) for p in procs):
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for i, p in enumerate(procs):
        logs[i] = p.communicate()[0]
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("world failed:\n" + "\n".join(
            f"--- rank {i} (rc {p.returncode})\n{logs[i][-3000:]}"
            for i, p in enumerate(procs)))
    out = []
    for r in range(len(procs)):
        with open(os.path.join(d, f"out{r}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results and their references: the JAX engines' tokens
    at tp 1, 2 and 4, and the port's tp=1 engines."""
    jm, U = _tree(["infer.merge_qkv_gate_up=off"])
    _, M2 = _tree(["infer.tp_size=2"])  # rank-major merged (merge_tp 2)
    _, KV2 = _tree(["models.n_kv_heads=2"], key=6)
    trees = {"U": U, "M2": M2, "KV2": KV2,
             "w8a16": _quantized(U, "w8a16"), "llmint8": _quantized(U, "llmint8")}
    d2, d4 = tmp_path_factory.mktemp("tp2"), tmp_path_factory.mktemp("tp4")
    paths = {}
    for k, t in trees.items():
        paths[k] = str(d2 / f"{k}.npz")
        save_tree(t, paths[k])
    tp2 = ["infer.tp_size=2"]
    sc2 = [
        dict(name="u2", overrides=BASE + tp2, tree=paths["U"], prompts=PROMPTS,
             new=NEW, shards=True),
        dict(name="m2", overrides=BASE + tp2, tree=paths["M2"], merge_tp=2,
             prompts=PROMPTS, new=NEW),
        dict(name="off2", overrides=BASE + tp2 + ["infer.merge_qkv_gate_up=off"],
             tree=paths["U"], prompts=PROMPTS, new=NEW, shards=True),
        dict(name="w8a16", overrides=BASE + tp2 + ["infer.merge_qkv_gate_up=off"],
             tree=paths["w8a16"], prompts=PROMPTS, new=NEW),
        dict(name="llmint8", overrides=BASE + tp2 + ["infer.merge_qkv_gate_up=off"],
             tree=paths["llmint8"], prompts=PROMPTS, new=NEW),
        dict(name="http", overrides=BASE + tp2 + ["serve.port=0"],
             tree=paths["U"], http=HTTP_MSG),
        dict(name="prefix", overrides=BASE + tp2 + ["infer.prefix_cache=true"],
             tree=paths["U"], prompts=PREFIX_PROMPTS, new=[6, 6], one_by_one=True),
        dict(name="spec", overrides=BASE + tp2 + ["infer.spec_decode=ngram",
                                                  "infer.spec_k=3"],
             tree=paths["U"], prompts=[REPEAT, PROMPTS[1]], new=[12, 8]),
        dict(name="kappa", overrides=BASE + tp2, tree=paths["U"],
             prompts=PROMPTS, new=KAPPA_NEW, kappa={"0": 0.25, "1": 64.0}),
    ]
    for s in sc2:  # the world script indexes kappa by rank
        if "kappa" in s:
            s["kappa"] = [s["kappa"]["0"], s["kappa"]["1"]]
    # an act-order GPTQ checkpoint (o_proj and down_proj permuted too: their
    # row shards gather their input over the group first)
    gptq_ovr = tl.LLAMA + [f"models.ckpt_dir={tl.write(tl.int4_tensors(tl.LLAMA, 'gptq', perms='shared'), str(d2 / 'gptq'))}",
                           "infer.do_load=true", "quant.method=w4a16"]
    sc2.append(dict(name="gptq", overrides=gptq_ovr + tp2, prompts=PROMPTS_SMALL,
                    new=NEW))
    tp4 = ["infer.tp_size=4"]
    sc4 = [
        dict(name="u4", overrides=BASE + tp4, tree=paths["U"], prompts=PROMPTS,
             new=NEW, shards=True),
        dict(name="kv2", overrides=BASE + tp4 + ["models.n_kv_heads=2"],
             tree=paths["KV2"], prompts=PROMPTS, new=NEW),
    ]
    p2 = _spawn(str(d2), 2, sc2, env_rendezvous=False)
    p4 = _spawn(str(d4), 4, sc4, env_rendezvous=True)
    try:
        ref = dict(
            jax1=_jax_tokens(["infer.merge_qkv_gate_up=off"], U),
            jax2=_jax_tokens(["infer.tp_size=2"], M2),
            jax4=_jax_tokens(["infer.tp_size=4", "infer.merge_qkv_gate_up=off"], U),
        )
        one = {}
        for name, tree, extra in (("U", U, ()), ("w8a16", trees["w8a16"], ()),
                                  ("llmint8", trees["llmint8"], ()),
                                  ("KV2", KV2, ["models.n_kv_heads=2"])):
            one[name] = _port(["infer.merge_qkv_gate_up=off", *extra], tree)
        ref["port1"] = {k: _port_tokens(e) for k, e in one.items()}
        e = one["U"]
        ref["bytes"] = (e.weight_bytes(), e.cache.bytes())
        ref["kv2_pool"] = one["KV2"].cache.bytes()
        ref["http"] = e.generate(
            [{"role": "user", "content": HTTP_MSG}],
            SampleParams(temperature=0.0, max_new_tokens=6))
        ref["prefix"] = _port_tokens(e, PREFIX_PROMPTS, [6, 6], one_by_one=True)
        ref["spec"] = _port_tokens(e, [REPEAT, PROMPTS[1]], [12, 8])
        ref["kappa"] = _port_tokens(e, PROMPTS, KAPPA_NEW)
        ref["norm_bytes"] = sum(
            getattr(e.model, n).numel() * 4 for n in ("norm", "attn_norm", "ffn_norm"))
        g = Engine(load_config(overrides=gptq_ovr), device="cpu")
        assert g.model.wo.in_perm is not None
        ref["gptq"] = _port_tokens(g, PROMPTS_SMALL)
    finally:
        out2 = _join(str(d2), p2)
        out4 = _join(str(d4), p4)
    return dict(tp2=out2, tp4=out4, ref=ref, trees=trees, jm=jm)


def test_tp_tokens_match_jax_and_tp1(worlds):
    ref = worlds["ref"]
    assert ref["jax1"] == ref["jax2"] == ref["jax4"] == ref["port1"]["U"]
    assert len({tuple(t) for t in ref["jax1"]}) > 1  # not a degenerate loop
    r0 = worlds["tp2"][0]
    for name in ("u2", "m2", "off2"):
        assert r0[name]["tokens"] == ref["jax2"], name
    assert worlds["tp4"][0]["u4"]["tokens"] == ref["jax4"]
    assert r0["u2"]["merged"] and not r0["off2"]["merged"]
    assert all(w[0]["u2"]["backend"] == "gloo" for w in (worlds["tp2"],))


@pytest.mark.parametrize("method", ["w8a16", "llmint8"])
def test_quantized_tp2_serves_tp1_tokens(worlds, method):
    assert worlds["tp2"][0][method]["tokens"] == worlds["ref"]["port1"][method]


def test_kv_heads_fewer_than_ranks_replicate(worlds):
    ref = worlds["ref"]
    for r, res in enumerate(worlds["tp4"]):
        kv2 = res["kv2"]
        assert not kv2["kv_tp_shard"]
        # each rank holds the one KV head its queries read: total / KV
        assert kv2["pool_bytes"] == ref["kv2_pool"] // 2, r
    assert worlds["tp4"][0]["kv2"]["tokens"] == ref["port1"]["KV2"]


@pytest.mark.parametrize("world,name,tp", [("tp2", "u2", 2), ("tp2", "off2", 2),
                                           ("tp4", "u4", 4)])
def test_per_rank_bytes_are_total_over_tp(worlds, world, name, tp):
    w_total, pool_total = worlds["ref"]["bytes"]
    norms = worlds["ref"]["norm_bytes"]
    for r, res in enumerate(worlds[world]):
        assert res[name]["kv_tp_shard"]
        assert res[name]["pool_bytes"] * tp == pool_total, r
        assert (res[name]["weight_bytes"] - norms) * tp == w_total - norms, r


def test_act_order_checkpoint_at_tp2(worlds):
    """Row-parallel act-order weights gather their input, then sum: the
    tp=2 engine on a GPTQ checkpoint gives the tp=1 engine's tokens."""
    assert worlds["tp2"][0]["gptq"]["tokens"] == worlds["ref"]["gptq"]


@pytest.mark.parametrize("fmt", ["hf_llama_bf16", "gptq_act_order", "glm4"])
def test_loader_cuts_rank_slices(tmp_path, fmt):
    """The checkpoint loader under a tp=2 layout (each mapped view cut
    before its copy; a quantized layer assembled, then cut) gives each rank
    the slices of the JAX loader's tree that `params_from_numpy` cuts."""
    ovr, d = tl.checkpoint(fmt, tmp_path)
    jcfg, cfg = tl._cfgs(ovr, d)
    jtree = jax.tree_util.tree_map(
        np.asarray, tl.jload_checkpoint(jbuild(jcfg.models, jcfg), jcfg))
    a = cfg.models
    for r in range(2):
        model = tl.build_model(a, cfg, device="cpu")
        model.layout = TPLayout(r, 2, a.n_heads, a.n_kv_heads, model.head_dim,
                                model.inter_dim, a.vocab_size, merged=model.merged)
        got = tl.load_checkpoint(model, cfg, "cpu")
        got = {**{k: v for k, v in got.items() if k != "layers"}, **got["layers"]}
        tl.assert_trees_equal(params_from_numpy(jtree, model.layout), got)


def test_http_request_to_rank0(worlds):
    res = worlds["tp2"][0]["http"]
    assert res["tokens"] == [worlds["ref"]["http"]]
    assert res["http"] == 6


def test_prefix_cache_and_spec_decode_keep_tokens(worlds):
    r0, ref = worlds["tp2"][0], worlds["ref"]
    assert r0["prefix"]["tokens"] == ref["prefix"]
    assert r0["prefix"]["prefix_hits"] > 0
    assert r0["spec"]["tokens"] == ref["spec"]
    assert r0["spec"]["spec_stats"][1] > 0  # verify rounds ran


def test_rank1_runs_rank0_windows(worlds):
    """Rank 1's own kappa would pick other windows; it runs rank 0's."""
    r0, r1 = (w["kappa"] for w in worlds["tp2"])
    assert r0["windows"] == r1["windows"] and r0["windows"]
    assert r0["picks"] != r1["picks"]
    assert r0["tokens"] == worlds["ref"]["kappa"]


def test_a_step_failing_on_one_rank_ends_the_world(tmp_path):
    """A step that fails on rank 1 alone ends rank 1 (`Engine.follow`
    raises), and rank 0 fails in its next collective instead of waiting
    for a rank that is gone: both exit non-zero on their own."""
    sc = [dict(name="fail", overrides=BASE + ["infer.tp_size=2"], fail_rank=1,
               prompts=PROMPTS[:1], new=[4])]
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


def test_launcher_ends_when_a_rank_it_started_fails(monkeypatch):
    """`python -m chitu_tpu_torch infer.tp_size=N` (`serve_local`) watches
    the ranks it started: one that exits non-zero ends rank 0 too."""
    ended = []

    def end(why):
        ended.append(why)
        raise RuntimeError(why)  # in place of os._exit, to leave the watch

    monkeypatch.setattr(distributed, "end_world", end)
    ok = subprocess.Popen([sys.executable, "-c", "pass"])
    ok.wait()
    bad = subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"])
    with pytest.raises(RuntimeError):
        distributed._watch([ok, bad])
    assert ended == ["a rank it started exited with 3"]


# ---------------------------------------------------------------------------
# shards against the JAX package's partition specs (no world needed)
# ---------------------------------------------------------------------------


def _jax_shards(extra, tree, tp):
    """Each tp rank's slice of every leaf, as the JAX package places the
    tree on the virtual mesh -> [rank] -> {name: array or {field: array}}."""
    cfg = jload(overrides=BASE + [f"infer.tp_size={tp}", *extra])
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

    flat = {k: v for k, v in placed.items() if k != "layers"}
    flat.update(placed["layers"])
    res = [dict() for _ in range(tp)]
    for k, v in flat.items():
        if hasattr(v, "scale"):
            for f in ("data", "scale"):
                for r, a in enumerate(per_rank(getattr(v, f))):
                    res[r].setdefault(k, {})[f] = a
        else:
            for r, a in enumerate(per_rank(v)):
                res[r][k] = a
    return m, res


@pytest.mark.parametrize("case", ["unmerged", "rank_major", "w8a16"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shards_equal_jax_partition_slices(worlds, case, tp):
    trees = worlds["trees"]
    if case == "rank_major":
        _, tree = _tree([f"infer.tp_size={tp}"])
        extra, merged, mtp = [], True, tp
    else:
        tree = trees["U" if case == "unmerged" else "w8a16"]
        extra, merged, mtp = ["infer.merge_qkv_gate_up=off"], False, 1
    jm, want = _jax_shards(extra, tree, tp)
    assert jm.merge_tp == mtp
    for r in range(tp):
        lay = TPLayout(r, tp, 8, 4, 64, 512, 512, merged=merged)
        got = params_from_numpy(tree, lay, mtp)
        assert sorted(got) == sorted(want[r])
        for k, w in want[r].items():
            g = got[k]
            if isinstance(g, QTensor):
                for f in ("data", "scale"):
                    np.testing.assert_array_equal(
                        getattr(g, f).numpy(), w[f], err_msg=f"{k}.{f}")
            else:
                np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


def test_sharding_rules():
    """`safe_spec` replicates what tp does not divide; head units held by
    several ranks; a QTensor's scale follows its data's spec, but a
    per-out-channel scale of a row-parallel weight replicates."""
    assert safe_spec(("tp", None), (6, 4), 4) == (None, None)
    assert safe_spec((None, "tp"), (6, 8), 4) == (None, "tp")
    assert dim_range(128, ("tp", 2), 3, 4) == (64, 128)  # 2 heads, 4 ranks
    assert dim_range(128, ("tp", 4), 1, 2) == (64, 128)
    block = QTensor(data=torch.zeros(1, 256, 512, dtype=torch.int8),
                    scale=torch.ones(1, 2, 4), kind=QuantKind.SOFT_FP8)
    chan = QTensor(data=torch.zeros(1, 256, 512, dtype=torch.int8),
                   scale=torch.ones(1, 512), kind=QuantKind.W8A16)
    assert shard_qtensor(block, (None, "tp", None), 1, 2).scale.shape == (1, 1, 4)
    assert shard_qtensor(block, (None, None, "tp"), 1, 2).scale.shape == (1, 2, 2)
    assert shard_qtensor(chan, (None, "tp", None), 1, 2).scale.shape == (1, 512)
    assert shard_qtensor(chan, (None, None, "tp"), 1, 2).scale.shape == (1, 256)


def test_mesh_and_process_group_errors():
    with pytest.raises(ValueError, match="need 4 devices"):
        tmake_mesh(tp=4, ranks=2)
    # pipeline stages serve since slice 14, replicas since slice 16
    assert tmake_mesh(pp=2, ranks=2).size == 2
    assert tmake_mesh(dp=2, ranks=2).size == 2
    with pytest.raises(ValueError, match="need 4 devices"):
        tmake_mesh(dp=2, tp=2, ranks=2)
    cfg = load_config(overrides=BASE + ["infer.num_processes=2"])
    with pytest.raises(ValueError, match="no coordinator"):
        distributed.maybe_initialize(cfg, "cpu")
    with pytest.raises(ValueError, match="num_processes"):
        Engine(load_config(overrides=BASE + ["infer.tp_size=2"]), device="cpu")
