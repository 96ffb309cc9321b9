"""One rank of a tensor- or pipeline-parallel test world of the port, on
the CPU.

`tests/test_torch_tp.py` and `tests/test_torch_pp.py` start N copies
(`python tests/torch_tp_world.py SPEC RANK`) joined over gloo through a
`file://` rendezvous; rank 0 runs each scenario of the spec's list
through its engine and the other ranks follow it (`Engine.follow`).
Weights and prompts come from the spec's `.npz` and JSON files; every
rank writes what it saw to `out<rank>.json`. A scenario may count the
pipelined decode windows (`spy`), give requests frequency penalties
(`pens`) or a stop token of their own (`stop`, on every rank's task),
forbid the MoE capacity route (`nocap`: it raises on every rank) and
record a checksum of every router's selections (`routes`), keep every
W8A8 activation quantization of a row-parallel input, its input slice
and its int8 values and scales (`acts`, in `acts<rank>.pt`), and have
rank 0 measure a perplexity after its requests (`ppl`: tokens, window,
stride; every rank runs its part), and have rank 0 serve `/stop` and
`/init` through its HTTP server afterwards (`reinit`: the world rebuilt
with other overrides, and a world-size change refused). Every rank counts its
sequence-parallel ring prefills (`ring_prefills`) and, under dp, the
gathers over its dp group (`dp_gathers`).
"""

import json
import os
import sys
import time
import zlib

import numpy as np
import torch

TREE_SEP = "/"


def save_tree(tree, path):
    """A numpy tree of the JAX package (nested dicts; quantized leaves
    with the QTensor fields) -> one .npz; bf16 leaves are stored as f32."""
    arrays, meta = {}, {}

    def arr(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return a.astype(np.float32)
        # e4m3 crosses as its bytes (`qtensor_from_numpy` reads them so)
        return a.view(np.uint8) if a.dtype.name.startswith("float8") else a

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, prefix + [k])
            return
        key = TREE_SEP.join(prefix)
        if hasattr(t, "scale") and hasattr(t, "data"):
            meta[key] = {"kind": getattr(t.kind, "value", t.kind),
                         "block": int(t.block)}
            for f in ("data", "scale", "zeros", "in_perm", "oc_idx", "oc_w"):
                if getattr(t, f, None) is not None:
                    arrays[key + "#" + f] = arr(getattr(t, f))
        else:
            arrays[key] = arr(t)

    walk(tree, [])
    np.savez(path, **arrays)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_tree(path):
    z = np.load(path)
    with open(path + ".json") as f:
        meta = json.load(f)
    tree = {}
    for key in z.files:
        base, _, field = key.partition("#")
        node = tree
        parts = base.split(TREE_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if field:
            leaf = node.setdefault(parts[-1], dict(meta[base]))
            leaf[field] = z[key]
        else:
            node[parts[-1]] = z[key]
    return tree


def run(spec_path, rank):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    torch.set_num_threads(1)
    from chitu_tpu_torch import SampleParams, evals, load_config
    from chitu_tpu_torch.engine import Engine
    from chitu_tpu_torch.models import deepseek_v3, llama, mixtral, moe
    from chitu_tpu_torch.ops import linear
    from chitu_tpu_torch.models.llama import params_from_numpy
    from chitu_tpu_torch.parallel import pipeline

    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    out, acts = {}, {}
    quant_acts_rows = linear.quant_acts_rows
    for sc in spec["scenarios"]:
        ovr = list(sc["overrides"]) + world[str(rank)]
        cfg = load_config(overrides=ovr)
        tree = load_tree(sc["tree"]) if sc.get("tree") else None
        params = None
        if tree is not None:
            params = lambda m, t=tree: params_from_numpy(t, m.layout, sc.get("merge_tp", 1))
        eng = Engine(cfg, device="cpu", params=params)
        m = eng.model
        res = dict(weight_bytes=eng.weight_bytes(), pool_bytes=eng.cache.bytes(),
                   leaf_bytes=leaf_bytes(m.params_tree()),
                   kv_tp_shard=getattr(m, "kv_tp_shard", False),
                   merged=getattr(m, "merged", True),
                   backend=eng.group.backend, windows=[], picks=[],
                   stage=eng.group.stage,
                   leaves=sorted(k for k, v in m.params_tree().items()
                                 if not isinstance(v, dict) or v),
                   pools={k: list(v.shape) for k, v in eng.cache.arrays.items()})
        decode_pipelined = pipeline.decode_pipelined
        moe_ffn, routers = moe.moe_ffn, (mixtral.route, deepseek_v3.route)
        if sc.get("nocap"):
            def capacity(*a, **k):
                raise AssertionError("the MoE capacity route ran")

            moe.moe_ffn = capacity
        if sc.get("routes"):
            res["routes"] = []

            def routing(*a, **k):
                w, sel = moe.route(*a, **k)
                res["routes"].append(zlib.crc32(sel.numpy().tobytes()))
                return w, sel

            mixtral.route = deepseek_v3.route = routing
        if sc.get("acts"):
            kept = acts[sc["name"]] = []

            def keeping(x, row_max=None):
                q = quant_acts_rows(x, row_max)
                if row_max is not None:
                    kept.append((x.clone(), q.data.clone(), q.scale.clone()))
                return q

            linear.quant_acts_rows = llama.quant_acts_rows = keeping
        if sc.get("spy"):
            res["pipelined"] = 0

            def spy(*a, **k):
                res["pipelined"] += 1
                return decode_pipelined(*a, **k)

            pipeline.decode_pipelined = spy
        if sc.get("stop"):
            stops = {tuple(p): t for p, t in zip(sc["prompts"], sc["stop"])
                     if t is not None}
            make = eng._make_task

            def making(message, params, rid, prompt_tokens, priority, make=make):
                req, task = make(message, params, rid, prompt_tokens, priority)
                tok = stops.get(tuple(prompt_tokens or ()))
                if tok is not None:
                    task.stop_with_eos = True
                    task.stop_tokens = frozenset({tok})
                return req, task

            eng._make_task = making
        if sc.get("kappa"):
            ex = eng.executor
            ex._kappa = sc["kappa"][rank]
            run_window, pick = ex._run_window, ex._pick_window
            ex._run_window = lambda w, *a, **k: (res["windows"].append(w), run_window(w, *a, **k))[1]
            ex._pick_window = lambda *a: (res["picks"].append(pick(*a)), res["picks"][-1])[1]
        if sc.get("fail_rank") == rank:
            def failing(*a, **k):
                raise RuntimeError("a step fails on this rank alone")

            eng.executor.step = failing
        ring = getattr(m, "_prefill_ring", None)
        if ring is not None:
            res["ring_prefills"] = 0

            def ringing(*a, ring=ring, **k):
                res["ring_prefills"] += 1
                return ring(*a, **k)

            m._prefill_ring = ringing
        if getattr(m, "dp_group", None) is not None:
            res["dp_gathers"] = 0
            gather = m.dp_group.gather

            def gathering(x, gather=gather):
                res["dp_gathers"] += 1
                return gather(x)

            m.dp_group.gather = gathering
        if sc.get("shards"):
            m = eng.model
            res["shards"] = {k: list(getattr(m, k).shape) for k in m._shapes()}
        def restore():
            pipeline.decode_pipelined = decode_pipelined
            moe.moe_ffn = moe_ffn
            mixtral.route, deepseek_v3.route = routers
            linear.quant_acts_rows = llama.quant_acts_rows = quant_acts_rows

        if rank != 0:
            if sc.get("reinit"):
                # follow this engine, then the one rank 0's /init builds,
                # until rank 0 ends the world's served life
                from chitu_tpu_torch.serve import ServerContext, follow_world

                ctx = ServerContext(cfg, device="cpu")
                ctx.engine = eng
                if sc["reinit"].get("stopped"):
                    eng.follow()  # rank 0 stops it before its server starts
                follow_world(ctx)
                res["reinit_pool_bytes"] = ctx.engine.cache.bytes()
            else:
                eng.follow()
            restore()
            out[sc["name"]] = res
            continue
        reqs = []
        if sc.get("http"):
            res["http"] = http_request(eng, cfg, sc["http"], reqs)
        for i, p in enumerate(sc.get("prompts", [])):
            sp = SampleParams(temperature=0.0, max_new_tokens=sc["new"][i],
                              frequency_penalty=sc.get("pens", [0.0] * 8)[i])
            reqs.append(eng.submit("", sp, prompt_tokens=p))
            if sc.get("one_by_one"):
                eng.run_until_complete()
        eng.run_until_complete()
        res["tokens"] = [list(r.async_stream.tokens) for r in reqs]
        if sc.get("ppl"):
            res["ppl"] = evals.perplexity_from_tokens(eng, **sc["ppl"])
        res["spec_stats"] = list(eng.executor._spec_stats)
        alloc = eng.cache.allocator
        res["prefix_hits"] = getattr(alloc, "hits", 0)
        if sc.get("reinit"):
            if sc["reinit"].get("stopped"):
                eng.terminate()
            res["reinit"] = reinit(eng, cfg, sc["reinit"])
        else:
            eng.terminate()
        restore()
        out[sc["name"]] = res
    with open(os.path.join(os.path.dirname(spec_path), f"out{rank}.json"), "w") as f:
        json.dump(out, f)
    if acts:
        torch.save(acts, os.path.join(os.path.dirname(spec_path),
                                      f"acts{rank}.pt"))
    from chitu_tpu_torch.parallel import distributed

    distributed.shutdown()


def leaf_bytes(tree, prefix=""):
    """{"stack/name" or "name": bytes} of a model's parameter tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaf_bytes(v, f"{prefix}{k}/"))
        elif hasattr(v, "nbytes") and callable(v.nbytes):
            out[prefix + k] = v.nbytes()
        else:
            out[prefix + k] = v.numel() * v.element_size()
    return out


def _post(port, path, body):
    """-> (status, the JSON answer) of one POST to rank 0's server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def reinit(eng, cfg, spec):
    """Rank 0's server on this engine (running, or stopped already when
    `spec["stopped"]`): `/stop`, an `/init` whose layout has another world
    size (refused), an `/init` with `spec["overrides"]` that every rank
    builds, `spec["prompts"]` through the new engine, then `/stop` and the
    end of the world's served life."""
    from chitu_tpu_torch import SampleParams
    from chitu_tpu_torch.serve import BackgroundServer

    srv = BackgroundServer(cfg, engine=eng, device="cpu")
    port = srv.start()
    got = dict(stop=_post(port, "/stop", {})[0])
    got["bad"] = _post(port, "/init", {"overrides": spec["bad"]})
    got["init"] = _post(port, "/init", {"overrides": spec["overrides"]})[0]
    new = srv.ctx.engine
    reqs = [new.submit("", SampleParams(temperature=0.0, max_new_tokens=n),
                       prompt_tokens=p)
            for p, n in zip(spec["prompts"], spec["new"])]
    srv.ctx.wake.set()
    while any(r.finish_reason is None for r in reqs):
        time.sleep(0.01)
    got["tokens"] = [list(r.async_stream.tokens) for r in reqs]
    got["pool_bytes"] = new.cache.bytes()
    got["stop2"] = _post(port, "/stop", {})[0]
    srv._loop.call_soon_threadsafe(srv._loop.stop)
    srv._thread.join(timeout=5)
    srv.ctx.end_world()
    return got


def http_request(eng, cfg, msg, reqs):
    """One chat completion over HTTP to rank 0's server on this engine;
    the request's token stream joins `reqs` (its submit is recorded)."""
    import urllib.request

    from chitu_tpu_torch.serve import BackgroundServer

    submit = eng.submit

    def recording(*a, **k):
        r = submit(*a, **k)
        reqs.append(r)
        return r

    eng.submit = recording
    srv = BackgroundServer(cfg, engine=eng)
    port = srv.start()
    body = json.dumps({"messages": [{"role": "user", "content": msg}],
                       "max_tokens": 6, "temperature": 0.0}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        resp = json.loads(r.read())
    # stop the server's worker thread; the engine stays up for the caller
    srv.ctx.stop_flag.set()
    srv.ctx.worker.join(timeout=60)
    srv._loop.call_soon_threadsafe(srv._loop.stop)
    srv._thread.join(timeout=5)
    eng.submit = submit
    return resp["usage"]["completion_tokens"]


if __name__ == "__main__":
    run(sys.argv[1], int(sys.argv[2]))
