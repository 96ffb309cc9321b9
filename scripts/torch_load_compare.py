#!/usr/bin/env python3
"""The checkpoint loader of several trees of the port at tp2, on one GPU.

    python3 scripts/torch_load_compare.py [--only LABEL,...] [tree ...]
    python3 scripts/torch_load_compare.py --predict    # no GPU needed

A tree is the root of a checkout of the repository (default: this one),
for example the parent commit unpacked with `git archive` into a
git-ignored directory; give parent, change, change, parent to take turns.
This checkout's `chip_smoke.py` writes the checkpoints of its
`SLICE19_LOADS` (Llama-3-8B AWQ and GPTQ at 4 layers, DeepSeek-R1 in its
published fp8 layout at 4, or deepseek-mid-bench where the disk lacks
room, Qwen2-72B AWQ at 2, Llama-3-8B as Meta mp2 `.pth` at 4) from its
seeded writers into a temporary directory, deleted at the end. Each tree
then loads every checkpoint in a process of its own, with its own
`loader.load_checkpoint`: once as one rank, then as each rank of tp2 in
turn (the rank's layout set on a model built for one rank, so no world
of processes is needed). Each load prints one JSON line: its seconds, the
device memory's peak above what was allocated before it and what it left
resident, the host's peak resident set, and, counted by a wrapper of the
tree's `to_device` (every host-to-device copy of both trees' loaders),
`max_copy_bytes`, the largest single copy, and `copy_bytes`, all copied
bytes. Then the card's name and power limit. Exits non-zero if a tree
fails.

`--predict` prints, for each checkpoint at its full size, what
`chip_smoke.predicted_reads` says each tp2 rank and the one-rank engine
read (total bytes, largest copy), from the tensors' shapes alone (drawn
on the meta device), DeepSeek-R1 and deepseek-mid-bench both.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = 2


def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def layout_of(model, rank, tp):
    """Rank `rank`'s layout of `tp` on a model built for one rank (the
    merge decision of `LlamaForCausalLM._init_tp` under auto)."""
    from chitu_tpu_torch.models.deepseek_v3 import MLALayout
    from chitu_tpu_torch.models.llama import TPLayout

    a = model.args
    if isinstance(model.layout, MLALayout):
        return MLALayout(rank, tp, a.n_heads)
    div = a.n_heads % tp == 0 and a.n_kv_heads % tp == 0 and model.inter_dim % tp == 0
    return TPLayout(rank, tp, a.n_heads, a.n_kv_heads, model.head_dim,
                    model.inter_dim, a.vocab_size, merged=div or tp == 1,
                    moe=model.layout.moe)


def one(tree, loads):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from chitu_tpu_torch import load_config, loader, loaders_moe
    from chitu_tpu_torch.models import build_model

    if not os.path.abspath(loader.__file__).startswith(tree + os.sep):
        sys.exit(f"{loader.__name__} imported from {loader.__file__}, not {tree}")
    cs = smoke()
    count = {}
    mods = [loader, loaders_moe]
    try:
        from chitu_tpu_torch import loader_streaming

        mods.append(loader_streaming)
    except ImportError:  # a tree before the streamed loads
        pass
    for mod in mods:
        if hasattr(mod, "to_device"):
            def counted(t, *a, _f=mod.to_device, **k):
                n = t.numel() * t.element_size()
                count["max"] = max(count["max"], n)
                count["sum"] += n
                return _f(t, *a, **k)

            mod.to_device = counted
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    for ld in loads:
        cfg = load_config(overrides=[
            f"models={ld['model']}", *ld["overrides"], "infer.do_load=true",
            f"models.ckpt_dir={ld['dir']}"])
        for tp, rank in [(1, 0)] + [(TP, r) for r in range(TP)]:
            model = build_model(cfg.models, cfg, device=dev)
            model.layout = layout_of(model, rank, tp)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            count.update(max=0, sum=0)
            host = {}
            t0 = time.time()
            with cs.host_peak(host):
                params = loader.load_checkpoint(model, cfg, dev)
                torch.cuda.synchronize()
            res = dict(
                tree=tree, label=ld["label"], model=cfg.models.name,
                layers=cfg.models.n_layers, tp=tp, rank=rank,
                load_s=time.time() - t0,
                peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
                resident_gib=(torch.cuda.memory_allocated() - base) / 2**30,
                host_peak_gib=host["host_peak_gib"],
                host_start_gib=host["host_start_gib"],
                max_copy_bytes=count["max"], copy_bytes=count["sum"], card=card)
            res["transient_gib"] = res["peak_gib"] - res["resident_gib"]
            print("load " + json.dumps(res), flush=True)
            del params, model
            torch.cuda.empty_cache()


def write_all(cs, root, only):
    """Write SLICE19_LOADS's checkpoints under `root` -> their loads."""
    import torch

    from chitu_tpu_torch import load_config

    dev = torch.device("cuda", 0)
    loads = []
    for label, model, ovr, fmt, _ in cs.SLICE19_LOADS:
        if only and label not in only:
            continue
        m = load_config(overrides=[f"models={model}", *ovr]).models
        d = os.path.join(root, label)
        t0 = time.time()
        if fmt == "fp8":
            groups, _ = cs.r1_ckpt(torch, dev, m)
            need = sum(sum(v.numel() * v.element_size() for v in mk().values())
                       for _, mk in groups)
            if shutil.disk_usage(root).free < need * 1.1:
                model, ovr = "deepseek-mid-bench", []
                groups, _ = cs.r1_ckpt(torch, dev, load_config(
                    overrides=[f"models={model}"]).models)
            n = cs.write_checkpoint(torch, groups, d)
        elif fmt == "pth":
            n = cs.write_pth(torch, cs.llama_ckpt(torch, dev, m, "bf16")[0], d, TP)
        else:
            n = cs.write_checkpoint(torch, cs.llama_ckpt(torch, dev, m, fmt)[0], d)
        print(f"[{label}] wrote {n / 1e9:.2f} GB in {time.time() - t0:.1f} s",
              flush=True)
        loads.append(dict(label=label, model=model, overrides=ovr, dir=d))
    return loads


def predict(cs):
    import torch

    from chitu_tpu_torch import load_config

    cpu = torch.device("cpu")
    for label, model, ovr, fmt, _ in cs.SLICE19_LOADS:
        cards = [(model, ovr)] + ([("deepseek-mid-bench", [])] if fmt == "fp8" else [])
        for card, o in cards:
            m = load_config(overrides=[f"models={card}", *o]).models
            if fmt == "fp8":
                groups = cs.r1_ckpt(torch, cpu, m)[0]
            else:
                groups = cs.llama_ckpt(torch, cpu, m, "bf16" if fmt == "pth" else fmt)[0]
            tensors = cs.planned_tensors(torch, groups, fmt)
            ranks, one = cs.predicted_reads(tensors, fmt, m, TP)
            print("predict " + json.dumps(dict(
                label=label, model=card, layers=m.n_layers, fmt=fmt,
                stored_bytes=sum(n for _, n in tensors.values()),
                ranks=ranks, one_rank=one)), flush=True)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        with open(args[2]) as f:
            one(args[1], json.load(f))
        return
    only = None
    if args[:1] == ["--only"]:
        only, args = set(args[1].split(",")), args[2:]
    sys.path.insert(0, ROOT)
    cs = smoke()
    if args[:1] == ["--predict"]:
        predict(cs)
        return
    root = tempfile.mkdtemp(prefix="chitu_load_compare_")
    rc = 0
    try:
        loads = write_all(cs, root, only)
        spec = os.path.join(root, "loads.json")
        with open(spec, "w") as f:
            json.dump(loads, f)
        for tree in args or [ROOT]:
            rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--one", tree, spec]).returncode
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    sys.exit(rc)


if __name__ == "__main__":
    main()
