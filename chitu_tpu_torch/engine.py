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

Tensor, pipeline and data parallelism (`infer.tp_size` = N,
`infer.pp_size` = P, `infer.dp_size` = D, every family): D x P x N
processes, one engine each, joined by
`parallel.distributed.maybe_initialize`; rank r = (d * P + p) * N + t
runs on `cuda:(r % device_count)` and holds its stage's layers (stage
p), its shard of them and of their KV heads (TP index t), the same as
every other replica d. With `infer.ring_kv` the pool's pages stripe over
the replicas (each holds num_pages / D of them, `kvcache.PagedKVCache`);
with `infer.ring_prefill` a whole prompt's tokens do (`parallel.ring`).
Every rank runs the same host state machine. Requests enter at rank 0,
the controller (`submit`, `cancel`, and the controls `calibrate` and
`perplexity`, which every rank runs when it applies them); each `step`
of rank 0 broadcasts what arrived since the last one, with its clock and
flags, and every rank applies it before it schedules, so all ranks
launch the same programs. The other ranks run `follow` until rank 0
terminates (a served world then waits for rank 0's next engine,
`serve.follow_world`); a step that fails on any rank ends the world
(`distributed.end_world` under the server, the process's own error
elsewhere).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
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
from chitu_tpu_torch.parallel import distributed, mesh_from_config
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
    if infer.ring_kv and infer.dp_size > 1:
        # the JAX engine's ring pool checks (chitu_tpu/engine.py:236-258);
        # the model-dependent ones follow in Engine.__init__
        if infer.pp_size > 1 and cfg.models.n_layers % infer.pp_size:
            raise ValueError(
                "ring_kv with pp needs n_layers divisible by pp_size "
                "(the pool's layer dim shards contiguously over 'pp')"
            )
        if infer.ring_prefill:
            raise ValueError(
                "ring_kv and ring_prefill both ride the 'dp' axis; "
                "enable one"
            )
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
    if todo:
        raise NotImplementedError(
            "not carried by the port (see the ROADMAP item each names): "
            + "; ".join(todo)
        )


class Engine:
    """One inference engine instance on one device (one rank's, under
    tensor, pipeline or data parallelism). `params`: named tensors
    (`params_from_numpy`), or a function of the model that gives them
    (each rank its own stage and shard: `lambda m: params_from_numpy(tree,
    m.layout)`)."""

    def __init__(
        self,
        cfg: EngineConfig,
        device=None,
        params=None,
    ):
        init_logger()
        check_supported(cfg, have_params=params is not None)
        set_fp8_act(cfg.quant.fp8_act)
        set_op_impl(cfg.infer.op_impl)
        self.group = None
        dp, pp, tp = cfg.infer.dp_size, cfg.infer.pp_size, cfg.infer.tp_size
        if distributed.maybe_initialize(cfg, device):
            self.group = distributed.tp_group()
            mesh_from_config(cfg, self.group.world_size)
            if self.group.world_size != dp * pp * tp:
                raise NotImplementedError(
                    f"{self.group.world_size} processes for dp_size={dp} x "
                    f"pp_size={pp} x tp_size={tp}: the world is one rank a "
                    "(replica, stage, TP index)")
            device = self.group.device
            init_logger(rank=self.group.world_rank)
        elif dp * pp * tp > 1:
            raise ValueError(
                f"dp_size={dp} x pp_size={pp} x tp_size={tp} needs "
                f"num_processes={dp * pp * tp} and a coordinator (one process "
                "a rank; `python -m chitu_tpu_torch infer.dp_size=D "
                "infer.pp_size=P infer.tp_size=N` starts them on one host)")
        # rank 0 of the world is the controller
        self.rank = self.group.world_rank if self.group is not None else 0
        # rank 0's requests and controls since its last step, and the
        # tasks they made, which join the pool when the step broadcasts
        self._outbox: List[tuple] = []
        self._staged: Dict[str, Task] = {}
        self._lock = threading.Lock()
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
        quantize = cfg.quant.method not in ("none", "") and cfg.quant.quant_on_load
        if cfg.infer.do_load and margs.ckpt_dir:
            if params is not None:
                raise ValueError("params given and infer.do_load set: pick one")
            # no random draw first: the checkpoint's leaves are the only
            # copy of the weights on the device
            tree = load_checkpoint(self.model, cfg, self.device)
        else:
            if params is not None:
                self.model.load_params(
                    params(self.model) if callable(params) else params)
            else:
                # arch-only debug: random weights (reference: infer.do_load=
                # False, config/serve_config.yaml:9), quantized leaf by leaf
                # while whole (a rank's shard of a row-parallel weight has
                # the full weight's scales)
                gen = torch.Generator(device=self.device)
                gen.manual_seed(cfg.infer.seed)
                self.model.init_params(
                    gen, _DTYPES[cfg.dtype],
                    transform=self._quantize_leaf if quantize else None)
                quantize = False
            tree = self.model.params_tree(pop=True)
        if quantize:
            # destructive walk: each dense leaf is freed as it is replaced
            tree = quantize_params(tree, cfg.quant, self.model)
        # int4 storage packed on the device; one grouped GEMM per MoE
        # layer for gate + up (a shared expert's pair only at tp 1: its
        # columns are cut under tensor parallelism)
        self.model.load_params(merge_moe_gate_up(pack_int4_storage(tree),
                                                 tp=cfg.infer.tp_size))
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
        if cfg.infer.prefix_cache and cache_type != "paged":
            logger.warning(
                "prefix_cache requires cache_type=paged (got %s); disabled",
                cache_type,
            )
        ring = cfg.infer.ring_kv and dp > 1
        if cfg.infer.ring_kv and not ring:
            logger.warning("ring_kv requested but dp_size <= 1; disabled")
        if ring:
            # the ring pool (ops/attention_ring.py): pages stripe over the
            # replicas; composes with tp (whole KV heads a rank) and pp (a
            # stage's pool holds its own layers)
            if not getattr(self.model, "supports_ring_kv", False):
                raise ValueError(
                    "ring_kv: model family lacks a ring-shardable pool"
                )
            if tp > 1 and not getattr(self.model, "kv_tp_shard", False):
                raise ValueError(
                    "ring_kv with tp > 1 needs a TP-shardable KV pool "
                    "(n_kv_heads divisible by tp, 128-lane-aligned shards)"
                )
            num_pages = (num_pages + dp - 1) // dp * dp
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
            max_slots=cfg.infer.max_reqs,
            # prefix caching is page-granular: dense/skew/nop hold one
            # max_seq_len page per request, so no full prompt page can be
            # shared — disabled loudly above instead of a cache that never
            # hits
            prefix_cache=cfg.infer.prefix_cache and cache_type == "paged",
            ring=dp if ring else 1,
        )
        if cache_type == "nop":
            from chitu_tpu_torch.kvcache import NopAllocator

            self.cache.allocator = NopAllocator(page_size)
        logger.info(
            "KV cache: %d pages x %d tokens (%.1f MiB%s)",
            num_pages, cfg.infer.page_size, self.cache.bytes() / 1e6,
            f" on this rank, {self.cache.local_pages} pages" if ring else "",
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

    def _quantize_leaf(self, name: str, t):
        """`quant.quant_on_load` of one full leaf (`quantize_params` on a
        tree that holds just it, under a stack unless it is a top-level
        leaf)."""
        under = name not in ("embed", "norm", "lm_head")
        tree = {"layers": {name: t}} if under else {name: t}
        tree = quantize_params(tree, self.cfg.quant, self.model)
        return (tree["layers"] if under else tree)[name]

    def weight_bytes(self) -> int:
        """Bytes of this rank's weights on the device."""
        from chitu_tpu_torch.ops.qtensor import QTensor

        n = 0
        tree = self.model.params_tree()

        def walk(t):
            nonlocal n
            if isinstance(t, dict):
                for v in t.values():
                    walk(v)
            elif isinstance(t, QTensor):
                n += t.nbytes()
            elif isinstance(t, torch.Tensor):
                n += t.numel() * t.element_size()

        walk(tree)
        return n

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
        if self.rank != 0:
            raise RuntimeError(
                "requests enter at rank 0; the other ranks follow it")
        req, task = self._make_task(message, params, rid, prompt_tokens,
                                    priority)
        if self.group is None:
            self._add_task(task)
        else:
            with self._lock:
                if rid in self._staged or f"task-{rid}" in self.pool:
                    TaskLoad.reduce(task.load_score())
                    raise ValueError(f"duplicate request id {rid!r}")
                self._staged[rid] = task
                self._outbox.append(("submit", dict(
                    message=message, params=req.params, rid=rid,
                    prompt_tokens=prompt_tokens, priority=priority,
                    arrival=task.arrival)))
        return req

    def _make_task(self, message, params, rid, prompt_tokens, priority):
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
        return req, task

    def _add_task(self, task: Task):
        if not self.pool.add(task):
            # duplicate request id: Task.__init__ already bumped the
            # global TaskLoad; undo it
            TaskLoad.reduce(task.load_score())
            raise ValueError(f"duplicate request id {task.req.request_id!r}")

    # -- lockstep across ranks ----------------------------------------------

    def has_work(self) -> bool:
        return bool(len(self.pool) or self._outbox)

    def _sync(self, step: bool = True) -> bool:
        """Rank 0: broadcast what arrived since the last step (submits,
        cancels, controls), its clock and its flags, and apply it; False
        (and no broadcast) when there is nothing to step. A single process
        applies nothing: its requests are in the pool already."""
        if self.group is None:
            return True
        with self._lock:
            ops, self._outbox = self._outbox, []
        if step and not ops and not len(self.pool):
            return False
        msg = dict(ops=ops, now=time.time(), step=step,
                   spec=self.executor.spec_enabled)
        self.group.decide(msg)
        self._apply(msg)
        return True

    def _apply(self, msg):
        self.scheduler.clock = lambda now=msg["now"]: now
        self.executor.spec_enabled = msg["spec"]
        for op, arg in msg["ops"]:
            if op == "submit":
                task = self._staged.pop(arg["rid"], None)
                if task is None:  # a follower makes rank 0's task
                    req, task = self._make_task(
                        arg["message"], arg["params"], arg["rid"],
                        arg["prompt_tokens"], arg["priority"])
                    req.bind_loop()
                    task.arrival = arg["arrival"]
                self._add_task(task)
            elif op == "cancel":
                self._cancel_now(arg)
            elif op == "calibrate":
                self.executor.calibrate_dispatch()
            elif op == "perplexity":
                from chitu_tpu_torch.evals import world_perplexity

                self._perplexity = world_perplexity(self, **arg)

    def follow(self):
        """The worker loop of ranks other than 0 (the JAX package's
        non-controller hosts, serve.py:525-535): take rank 0's step
        messages and run the same steps, until it terminates this engine.
        The world of processes outlives it: a server's followers then wait
        for rank 0's next control (`serve.follow_world`: another engine,
        or the end). A step that fails raises out of it: a rank that
        stepped on would issue other collectives than the rest, so its
        process ends, and the world with it."""
        if self.group is None or self.rank == 0:
            raise RuntimeError("follow() runs on ranks other than 0")
        while True:
            msg = self.group.decide(None)
            if msg.get("stop"):
                self._terminate_local()
                return
            self._apply(msg)
            if msg["step"]:
                self._step()

    def perplexity(self, tokens: List[int], window: int,
                   stride: Optional[int]) -> float:
        """Rank 0 of a world: `evals.perplexity_from_tokens` on every rank
        in lockstep. The windows go out as a control in the step broadcast,
        every rank runs `evals.world_perplexity` when it applies it, and
        the number comes back from the sampling rank."""
        if self.group is None or self.rank != 0:
            raise RuntimeError("perplexity over a world starts at rank 0")
        with self._lock:
            self._outbox.append(("perplexity", dict(
                tokens=tokens, window=window, stride=stride)))
        self._sync(step=False)
        return self._perplexity

    def calibrate(self):
        """Seed the adaptive-window cost model (`calibrate_dispatch`) on
        every rank; the windows stay rank 0's decisions."""
        if self.group is None:
            self.executor.calibrate_dispatch()
            return
        with self._lock:
            self._outbox.append(("calibrate", None))
        self._sync(step=False)

    # -- engine loop --------------------------------------------------------

    def step(self) -> int:
        """One scheduling round (reference: chitu_run, chitu_main.py:100-121).
        Returns the number of tasks stepped."""
        if self.state != EngineState.RUNNING:
            return 0
        if not self._sync():
            return 0
        return self._step()

    def _step(self) -> int:
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
        while self.has_work() and steps < max_steps:
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
        while task_id in self.pool or req.request_id in self._staged:
            self.step()
        return list(req.async_stream.tokens)

    def cancel(self, request_id: str):
        """Stop generating for an abandoned request (client disconnect);
        under tensor parallelism at rank 0's next step, on every rank."""
        if self.group is not None:
            with self._lock:
                self._outbox.append(("cancel", request_id))
            return
        self._cancel_now(request_id)

    def _cancel_now(self, request_id: str):
        task = self.pool.pool.get(f"task-{request_id}")
        if task is not None and task.req.finish_reason is None:
            task.cancel()

    # -- termination (reference: chitu_main.py:124-131) ---------------------

    def terminate(self):
        """Drain: finish every in-flight request (streams close with a
        'cancelled' reason) and release device residency; rank 0 releases
        the ranks that follow it."""
        if self.group is not None and self.rank == 0 and (
                self.state == EngineState.RUNNING):
            self.group.decide(dict(stop=True))
        self._terminate_local()

    def _terminate_local(self):
        self.state = EngineState.TERMINATING
        for rid, task in list(self._staged.items()):
            task.req.finish("cancelled")
            self._staged.pop(rid)
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
