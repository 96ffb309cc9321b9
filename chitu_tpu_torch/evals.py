"""Perplexity evaluation via teacher-forced prefill logits.

Counterpart of `chitu_tpu/evals.py` (reference: test/test_eval.py:105-194,
wikitext-2 perplexity by keeping all prefill logits; here
`prefill(..., return_all_logits=True)` is a mode of the model). The
accuracy gate of the quantization ladder and of loaded checkpoints:

    python -m chitu_tpu_torch.evals models=<card> infer.do_load=true \\
        models.ckpt_dir=<dir> eval.text=<file> [eval.window=512]

runs on the GPU (`device=cpu` for the CPU). `--hf <dir>` instead prints
the perplexity of the same text through `transformers` on the CPU, the
ground truth; that needs `transformers`, which the GPU machine lacks.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch


def _bucket_pow2(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def perplexity_from_tokens(
    engine,
    tokens: List[int],
    window: int = 512,
    stride: Optional[int] = None,
) -> float:
    """Sliding-window perplexity of `tokens` under the engine's model.

    Each window is prefilled teacher-forced, padded to a power-of-two
    bucket, into a KV pool of its own (the engine's pool and requests are
    untouched); the loss counts the predictions over the part of each
    window the previous one did not cover (standard strided eval).

    Under tensor, pipeline or data parallelism the engine is rank 0 of a
    world (the controller): the windows go to every rank as a control in
    the step broadcast (`Engine.perplexity`), every rank of replica 0 runs
    the same prefills on its shard and stage (`world_perplexity`), and the
    number is the sampling rank's (the last stage holds the logits)."""
    if getattr(engine, "group", None) is not None:
        return engine.perplexity(list(tokens), window, stride)
    nll, count = _windows_nll(engine, tokens, window, stride)
    return math.exp(nll / max(count, 1))


def world_perplexity(engine, tokens: List[int], window: int,
                     stride: Optional[int]) -> float:
    """Every rank's part of `perplexity_from_tokens` in a world, run by
    `Engine._apply` on each rank: replica 0's ranks prefill the windows
    (its TP ranks each on its shard, its stages in relay), with no
    collective over the replicas (`replica_local`); the other replicas
    wait. The sampling rank's (sum of NLL, count) then goes to every rank.
    -> the perplexity, on every rank."""
    world = engine.group
    got = (0.0, 0)
    if world.replica == 0:
        with replica_local(engine.model):
            got = _windows_nll(engine, tokens, window, stride)
    buf = None
    if world.world_rank == world.sampler:
        buf = torch.tensor(got, dtype=torch.float64, device=engine.device)
    nll, count = world.from_sampler(buf, (2,), torch.float64,
                                    engine.device).tolist()
    return math.exp(nll / max(count, 1))


@contextlib.contextmanager
def replica_local(model):
    """The model's forwards without the replicas' collectives: no ring KV
    attention, no MoE token split over the dp group (a replica runs them
    alone, in a pool of its own)."""
    held = model.dp_group, model.ring_kv
    model.dp_group, model.ring_kv = None, False
    try:
        yield model
    finally:
        model.dp_group, model.ring_kv = held


def _windows_nll(engine, tokens: List[int], window: int,
                 stride: Optional[int]):
    """(sum of the NLL, predictions counted) over the windows; (0, 0) on
    a pipeline stage that holds no logits (it runs the same prefills)."""
    from chitu_tpu_torch.kvcache import PagedKVCache

    model = engine.model
    cfg = engine.cfg
    dev = engine.device
    page = cfg.infer.page_size
    stride = stride or window
    spec = model.kv_cache_spec()
    pool_dtype = next(iter(engine.cache.arrays.values())).dtype

    total_nll = 0.0
    total_count = 0
    start = 0
    prev_end = 0
    with torch.no_grad():
        while start < len(tokens) - 1:
            end = min(start + window, len(tokens))
            chunk = tokens[start:end]
            n = len(chunk)
            if n < 2:
                break
            T = _bucket_pow2(n)
            cache = PagedKVCache(
                spec["n_layers"], T // page + 1, page, spec["kv_heads"],
                spec["head_dim"], dtype=pool_dtype, device=dev,
                kv_dim=spec.get("kv_dim", 0),
                layer_groups=spec.get("layer_groups"),
            )
            bt = torch.arange(T // page + 1, dtype=torch.int32, device=dev)
            tok = torch.zeros(T, dtype=torch.int32, device=dev)
            tok[:n] = torch.tensor(chunk, dtype=torch.int32, device=dev)
            logits, _ = model.prefill(
                cache.arrays, tok, bt, 0, n, page, return_all_logits=True
            )
            if logits is not None:
                logp = torch.log_softmax(logits[: n - 1].float(), dim=-1)
                target = torch.tensor(chunk[1:], dtype=torch.long, device=dev)
                nll = -logp.gather(-1, target[:, None])[:, 0]
                # only count fresh positions (beyond the previous window's
                # coverage)
                fresh_from = max(prev_end - start - 1, 0)
                piece = nll[fresh_from:]
                total_nll += float(piece.double().sum())
                total_count += piece.numel()
            prev_end = end
            start += stride
    return total_nll, total_count


def perplexity_from_text(engine, text: str, window: int = 512) -> float:
    tokens = engine.tokenizer.encode(text, bos=True)
    return perplexity_from_tokens(engine, tokens, window=window)


def _hf_perplexity(hf_dir: str, text: str, window: int) -> dict:
    """Teacher-forced perplexity through `transformers` on the CPU."""
    try:
        from transformers import AutoModelForCausalLM, AutoTokenizer
    except ImportError as e:
        raise SystemExit(
            "--hf needs the transformers package, which this machine lacks "
            "(the GPU machine has none: run --hf where it is installed)"
        ) from e
    tok = AutoTokenizer.from_pretrained(hf_dir)
    model = AutoModelForCausalLM.from_pretrained(hf_dir).eval()
    ids = tok(text, return_tensors="pt").input_ids[0]
    nll, count = 0.0, 0
    with torch.no_grad():
        for s in range(0, max(len(ids) - 1, 1), window):
            chunk = ids[s : s + window + 1]
            if len(chunk) < 2:
                break
            out = model(chunk[None, :-1]).logits[0].float()
            lp = torch.log_softmax(out, -1)
            nll -= lp[range(len(chunk) - 1), chunk[1:]].sum().item()
            count += len(chunk) - 1
    return {"hf_ppl": round(math.exp(nll / max(count, 1)), 4), "tokens": count}


def _cli(argv: List[str]) -> int:
    """One-command perplexity gate: `python -m chitu_tpu_torch.evals
    models=<card> models.ckpt_dir=... infer.do_load=true eval.text=<file>`
    (`device=cpu` for the CPU), or `--hf <ckpt_dir> eval.text=<file>` for
    the transformers ground truth of the same file."""
    import json

    text_path = None
    overrides = []
    hf_dir = None
    window = 512
    device = None
    it = iter(argv)
    for a in it:
        if a == "--hf":
            hf_dir = next(it)
        elif a.startswith("eval.text="):
            text_path = a.split("=", 1)[1]
        elif a.startswith("eval.window="):
            window = int(a.split("=", 1)[1])
        elif a.startswith("device="):
            device = a.split("=", 1)[1]
        elif "=" in a:
            overrides.append(a)
        else:
            raise SystemExit(f"unknown arg {a!r}")
    if text_path is None:
        raise SystemExit("eval.text=<file> is required")
    with open(text_path) as f:
        text = f.read()

    if hf_dir is not None:
        print(json.dumps(_hf_perplexity(hf_dir, text, window)))
        return 0

    from chitu_tpu_torch.config import load_config
    from chitu_tpu_torch.engine import Engine

    eng = Engine(load_config(overrides=overrides), device=device)
    ppl = perplexity_from_text(eng, text, window=window)
    print(json.dumps({
        "engine_ppl": round(ppl, 4),
        "model": eng.cfg.models.name,
        "quant": eng.cfg.quant.method,
        "device": str(eng.device),
    }))
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(_cli(sys.argv[1:]))
