"""Engine: bring-up and the run loop.

Counterpart of `chitu_tpu/engine.py` (reference: chitu/chitu_main.py:38-131
and chitu/backend.py:86-405), for one GPU: tokenizer -> model -> weights
(read from `models.ckpt_dir` when `infer.do_load` is set, `loader.py`;
else a named tensor dict such as `params_from_numpy` gives; else random
from a seeded `torch.Generator`) -> KV pool -> scheduler -> executor. The
run loop mirrors `chitu_run` (reference: chitu_main.py:100-121): schedule
-> step -> update.

A checkpoint may hold quantized projections already (AWQ / GPTQ packed
int4, DeepSeek's native fp8), which load as `QTensor`s whatever
`quant.method` says. With `quant.method` set and `quant.quant_on_load`,
the dense projection weights are quantized after the load or the random
draw (`quantize.quantize_params`). Then, whatever the weights' source,
W4A16 storage is packed two nibbles a byte on the device and quantized
MoE gate and up stacks are merged into one leaf
(`quantize.merge_moe_gate_up`), as the JAX engine does. A configuration
that lands on a known slow path (MoE experts on the capacity route) is
named once in a warning at bring-up (`Engine.degraded`).

The engine runs on CUDA unless `device="cpu"` is passed; with no GPU and
no explicit device it raises. Configurations that later work brings raise
NotImplementedError naming the ROADMAP queue A item.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional

import torch

from chitu_tpu_torch.config import EngineConfig
from chitu_tpu_torch.executor import Executor
from chitu_tpu_torch.kvcache import PagedKVCache
from chitu_tpu_torch.loader import load_checkpoint
from chitu_tpu_torch.models import build_model
from chitu_tpu_torch.ops.attention_kernels import ATTN_TYPES
from chitu_tpu_torch.ops.linear import OP_IMPLS, set_fp8_act, set_op_impl
from chitu_tpu_torch.quantize.transforms import (
    KIND_BY_METHOD,
    merge_moe_gate_up,
    pack_int4_storage,
    quantize_params,
)
from chitu_tpu_torch.scheduler import Scheduler
from chitu_tpu_torch.task import (
    SampleParams,
    Task,
    TaskLoad,
    TaskPool,
    TaskType,
    UserRequest,
    new_request_id,
)
from chitu_tpu_torch.tokenizer import build_tokenizer
from chitu_tpu_torch.utils import get_logger, init_logger, resolve_device

logger = get_logger()

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


class EngineState(enum.Enum):
    RUNNING = 1
    TERMINATING = 2
    TERMINATED = 3


def check_supported(cfg: EngineConfig, have_params: bool = False):
    """Raise for configurations the port does not carry yet."""
    infer = cfg.infer
    quant = cfg.quant
    if quant.method not in ("none", "") and quant.method not in KIND_BY_METHOD:
        raise ValueError(f"unknown quant method {quant.method!r}")
    if infer.attn_type not in ATTN_TYPES:
        raise ValueError(
            f"infer.attn_type={infer.attn_type!r}: expected one of {ATTN_TYPES}")
    if infer.op_impl not in OP_IMPLS:
        raise ValueError(
            f"infer.op_impl={infer.op_impl!r}: expected one of {OP_IMPLS}")
    todo = []
    if infer.tp_size > 1 or infer.pp_size > 1 or infer.dp_size > 1:
        todo.append("tp/pp/dp > 1 (A.6: multi-GPU)")
    if infer.ring_prefill or infer.ring_kv:
        todo.append("ring prefill / ring KV (A.6: multi-GPU)")
    if (
        quant.method not in ("none", "")
        and not quant.quant_on_load
        and not have_params
        and not (infer.do_load and cfg.models.ckpt_dir)
    ):
        # the JAX engine serves such a configuration unquantized
        todo.append(
            f"quant.method={quant.method} on random weights: they are "
            "quantized only on load (quant.quant_on_load=true); quantized "
            "weights come from a checkpoint (infer.do_load=true "
            "models.ckpt_dir=...)"
        )
    if infer.spec_decode:
        todo.append("spec_decode (A.2: n-gram speculative decoding)")
    if infer.prefix_cache:
        todo.append("prefix_cache (A.1: the prefix cache)")
    if todo:
        raise NotImplementedError(
            "not ported yet (see ROADMAP queue A): " + "; ".join(todo)
        )


class Engine:
    """One inference engine instance on one device."""

    def __init__(
        self,
        cfg: EngineConfig,
        device=None,
        params: Optional[Dict[str, torch.Tensor]] = None,
    ):
        init_logger()
        check_supported(cfg, have_params=params is not None)
        set_fp8_act(cfg.quant.fp8_act)
        set_op_impl(cfg.infer.op_impl)
        self.device = resolve_device(device)
        if (
            self.device.type == "cuda"
            and cfg.quant.method not in ("none", "")
            and cfg.dtype != "bfloat16"
        ):
            raise NotImplementedError(
                f"dtype={cfg.dtype} with quant.method={cfg.quant.method}: the "
                "quantized CUDA kernels take bfloat16 activations"
            )
        self.cfg = cfg
        self.state = EngineState.RUNNING
        self.tokenizer = build_tokenizer(cfg.models, cfg.infer)
        # widen model vocab if the tokenizer is bigger (debug tokenizer case)
        margs = cfg.models
        if self.tokenizer.vocab_size > margs.vocab_size:
            margs = dataclasses.replace(
                margs, vocab_size=self.tokenizer.vocab_size
            )
            cfg = dataclasses.replace(cfg, models=margs)
            self.cfg = cfg
        self.model = build_model(margs, cfg, device=self.device)

        t0 = time.time()
        if cfg.infer.do_load and margs.ckpt_dir:
            if params is not None:
                raise ValueError("params given and infer.do_load set: pick one")
            # no random draw first: the checkpoint's leaves are the only
            # copy of the weights on the device
            tree = load_checkpoint(self.model, cfg, self.device)
        else:
            if params is not None:
                self.model.load_params(params)
            else:
                # arch-only debug: random weights (reference: infer.do_load=
                # False, config/serve_config.yaml:9)
                gen = torch.Generator(device=self.device)
                gen.manual_seed(cfg.infer.seed)
                self.model.init_params(gen, _DTYPES[cfg.dtype])
            tree = self.model.params_tree(pop=True)
        if cfg.quant.method not in ("none", "") and cfg.quant.quant_on_load:
            # destructive walk: each dense leaf is freed as it is replaced
            tree = quantize_params(tree, cfg.quant, self.model)
        # int4 storage packed on the device; one grouped GEMM per MoE
        # layer for gate + up
        self.model.load_params(merge_moe_gate_up(pack_int4_storage(tree)))
        logger.info("params ready in %.1fs", time.time() - t0)

        spec = self.model.kv_cache_spec()
        # cache_type (reference: backend.py:218-258): "paged" block pool,
        # "dense"/"skew" one max_seq_len page per request, "nop" one
        # shared page (perf debugging)
        cache_type = cfg.infer.cache_type
        if cache_type == "normal":
            cache_type = "dense"
        if cache_type not in ("paged", "dense", "skew", "nop"):
            raise ValueError(
                f"unknown cache_type {cache_type!r}: expected paged, "
                "dense, skew, nop, or normal (= dense)"
            )
        page_size = cfg.infer.page_size
        if cache_type in ("dense", "skew"):
            page_size = cfg.infer.max_seq_len
            num_pages = cfg.infer.max_reqs
        elif cache_type == "nop":
            page_size = cfg.infer.max_seq_len
            num_pages = 1
        else:
            num_pages = PagedKVCache.num_pages_for(
                cfg.infer.max_reqs, cfg.infer.max_seq_len, page_size
            )
            if cfg.infer.kv_pool_frac < 1.0:
                num_pages = max(
                    cfg.infer.max_seq_len // page_size + 1,
                    int(num_pages * cfg.infer.kv_pool_frac),
                )
        if page_size != cfg.infer.page_size:
            infer = dataclasses.replace(cfg.infer, page_size=page_size)
            cfg = dataclasses.replace(cfg, infer=infer)
            self.cfg = cfg
        self.cache = PagedKVCache(
            spec["n_layers"],
            num_pages,
            page_size,
            spec["kv_heads"],
            spec["head_dim"],
            # fp8 KV: e4m3 bits in int8 lanes (the kernels convert on load)
            dtype=torch.int8 if cfg.infer.kv_dtype == "fp8" else torch.bfloat16,
            device=self.device,
            kv_dim=spec.get("kv_dim", 0),
            layer_groups=spec.get("layer_groups"),
        )
        if cache_type == "nop":
            from chitu_tpu_torch.kvcache import NopAllocator

            self.cache.allocator = NopAllocator(page_size)
        logger.info(
            "KV cache: %d pages x %d tokens (%.1f MiB)",
            num_pages, cfg.infer.page_size, self.cache.bytes() / 1e6,
        )

        self.pool = TaskPool()
        self.scheduler = Scheduler.build(self.pool, cfg)
        # queue probe: non-resident prefill work waiting keeps decode
        # window chains short. Capture the POOL, not self (an engine-
        # capturing closure on the executor forms a reference cycle that
        # defers releasing the weights)
        pool = self.pool
        self.executor = Executor(
            cfg, self.model, self.cache,
            has_waiting=lambda: any(
                t.task_type == TaskType.PREFILL and t.slot < 0
                for t in pool.snapshot()
            ),
        )
        # known slow layouts get one loud warning at bring-up instead of
        # silently serving slow
        self.degraded = self.degraded_paths()
        for msg in self.degraded:
            logger.warning("degraded path: %s", msg)

    def degraded_paths(self) -> List[str]:
        """Conditions where this configuration lands on a known
        structurally slow path, one sentence each."""
        out = []
        if getattr(self.model.args, "moe", None) is not None:
            from chitu_tpu_torch.models.moe import _sorted_eligible

            # the MoE group's stacks (DeepSeek's `moe_layers`), else the
            # module's own (Mixtral)
            group = getattr(self.model, "moe_layers", None)
            get = group.get if group is not None else (
                lambda k: getattr(self.model, k, None)
            )
            ws = tuple(
                get(k)
                for k in ("exp_gu", "exp_gate", "exp_up", "exp_down",
                          "w_gu", "w_gate", "w_up", "w_down")
                if get(k) is not None
            )
            if not ws or not _sorted_eligible(ws):
                out.append(
                    "MoE runs the capacity-einsum fallback (experts not "
                    "eligible for the grouped kernel): quantized experts "
                    "DEQUANTIZE per step and tokens beyond capacity drop "
                    "under skewed routing."
                )
        return out

    # -- request API --------------------------------------------------------

    def submit(
        self,
        message,
        params: Optional[SampleParams] = None,
        request_id: Optional[str] = None,
        prompt_tokens: Optional[List[int]] = None,
        priority: float = 1.0,
    ) -> UserRequest:
        """Create a request+task and enqueue it (reference: serve.py:78-99)."""
        rid = request_id or new_request_id()
        margs = self.cfg.models
        req = UserRequest(
            message,
            rid,
            tokenizer=self.tokenizer,
            params=params
            or SampleParams(
                temperature=self.cfg.request.temperature,
                top_p=self.cfg.request.top_p,
                top_k=self.cfg.request.top_k,
                frequency_penalty=self.cfg.request.frequency_penalty,
                max_new_tokens=self.cfg.request.max_new_tokens,
            ),
            model=margs.name,
            rs_token_id=margs.rs_token_id,
            re_token_id=margs.re_token_id,
            force_full_seq_decode=margs.tokenizer_force_full_seq_decode,
        )
        req.bind_loop()
        task = Task(
            f"task-{rid}",
            req,
            self.tokenizer,
            stop_with_eos=self.cfg.infer.stop_with_eos,
            max_seq_len=self.cfg.infer.max_seq_len,
            prompt_tokens=prompt_tokens,
            priority=priority,
        )
        if not self.pool.add(task):
            # duplicate request id: Task.__init__ already bumped the
            # global TaskLoad; undo it
            TaskLoad.reduce(task.load_score())
            raise ValueError(f"duplicate request id {rid!r}")
        return req

    # -- engine loop --------------------------------------------------------

    def step(self) -> int:
        """One scheduling round (reference: chitu_run, chitu_main.py:100-121).
        Returns the number of tasks stepped."""
        if self.state != EngineState.RUNNING:
            return 0
        task_ids = self.scheduler.schedule(self._admit_predicate())
        if not task_ids:
            return 0
        tasks = [self.pool[tid] for tid in task_ids if tid in self.pool]
        self.executor.step(tasks)
        self.scheduler.update(task_ids)
        for t in tasks:
            if t.task_id not in self.pool:
                self.executor.release(t)
        return len(tasks)

    def _admit_predicate(self):
        """Stateful admission check for new prefills: a prefill is only
        schedulable when a request slot and enough KV pages are free."""
        budget = {
            "slots": len(self.executor.slots.free),
            "pages": self.cache.allocator.num_free(),
        }
        page = self.cfg.infer.page_size

        def admit(task) -> bool:
            if task.slot >= 0:  # already resident
                return True
            need = (task.prefix_len + 1 + page - 1) // page + 1
            if budget["slots"] >= 1 and budget["pages"] >= need:
                budget["slots"] -= 1
                budget["pages"] -= need
                return True
            return False

        return admit

    def run_until_complete(self, max_steps: int = 1_000_000):
        steps = 0
        while len(self.pool) and steps < max_steps:
            if self.step() == 0 and len(self.pool):
                time.sleep(0.001)  # nothing runnable; avoid a busy spin
            steps += 1
        return steps

    def generate(
        self, message, params: Optional[SampleParams] = None,
        prompt_tokens: Optional[List[int]] = None,
    ) -> List[int]:
        """Synchronous one-shot generation (for tests and scripts)."""
        req = self.submit(message, params, prompt_tokens=prompt_tokens)
        task_id = f"task-{req.request_id}"
        while task_id in self.pool:
            self.step()
        return list(req.async_stream.tokens)

    def cancel(self, request_id: str):
        """Stop generating for an abandoned request (client disconnect)."""
        task = self.pool.pool.get(f"task-{request_id}")
        if task is not None and task.req.finish_reason is None:
            task.cancel()

    # -- termination (reference: chitu_main.py:124-131) ---------------------

    def terminate(self):
        """Drain: finish every in-flight request (streams close with a
        'cancelled' reason) and release device residency."""
        self.state = EngineState.TERMINATING
        for task in self.pool.snapshot():
            try:
                task.req.finish("cancelled")
            except Exception:
                logger.exception("cancelling %s failed", task.task_id)
            self.executor.release(task)
            if task.task_id in self.pool:
                self.pool.remove(task.task_id)
        self.state = EngineState.TERMINATED

    def is_terminated(self) -> bool:
        return self.state == EngineState.TERMINATED
