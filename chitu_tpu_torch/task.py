"""Request / task model.

Capability parity with the reference's task module
(reference: chitu/task.py:1-473): `UserRequest` (message + sampling params +
completion event + timing trace), `SampleParams` with temperature-0 greedy
coercion, `TaskLoad` global load accounting for admission control, `Task`
with a prefill->decode state machine and EOS/length stop, and `TaskPool`.

The reference's `PackedTasks` int64-tensor serialization
(reference: chitu/task.py:303-433) is a NCCL-transport artifact; here the
control plane is host-side, so task batches are plain host objects — see
`chitu_tpu_torch/executor.py` for how a scheduled batch becomes device
tensors.
"""

from __future__ import annotations

import asyncio
import enum
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from chitu_tpu_torch.async_response import AsyncDataStream
from chitu_tpu_torch.utils import get_logger

logger = get_logger()


@dataclass
class SampleParams:
    """Per-request sampling parameters (reference: task.py:51-61)."""

    temperature: float = 1.0
    top_p: float = 0.9
    top_k: int = -1
    frequency_penalty: float = 0.0
    max_new_tokens: int = 128

    def __post_init__(self):
        # temperature 0 -> greedy (reference: task.py:56-61)
        if self.temperature == 0.0:
            self.top_k = 1
            self.temperature = 1.0
        # the device sampler restricts to the top MAX_K logits
        # (sampling.py design note); clamp loudly instead of silently
        from chitu_tpu_torch.sampling import MAX_K

        if self.top_k > MAX_K:
            from chitu_tpu_torch.utils import get_logger

            get_logger().warning(
                "top_k=%d exceeds the sampler's MAX_K=%d and is clamped; "
                "top_p renormalizes over at most MAX_K candidates",
                self.top_k,
                MAX_K,
            )
            self.top_k = MAX_K


class TaskLoad:
    """Global engine load score for admission control
    (reference: task.py:25-48, consumed by /load_status serve.py:137-143)."""

    _lock = threading.Lock()
    _load: float = 0.0
    _num_reqs: int = 0

    @classmethod
    def increase(cls, score: float):
        with cls._lock:
            cls._load += score
            cls._num_reqs += 1

    @classmethod
    def reduce(cls, score: float):
        with cls._lock:
            cls._load -= score
            cls._num_reqs -= 1

    @classmethod
    def get_load(cls) -> float:
        with cls._lock:
            return cls._load

    @classmethod
    def get_num_reqs(cls) -> int:
        with cls._lock:
            return cls._num_reqs

    @classmethod
    def reset(cls):
        with cls._lock:
            cls._load = 0.0
            cls._num_reqs = 0


class UserRequest:
    """One user request: prompt, sampling, output stream, timing trace
    (reference: task.py:64-121)."""

    def __init__(
        self,
        message,
        request_id: str,
        tokenizer=None,
        params: Optional[SampleParams] = None,
        model: str = "chitu-tpu",
        rs_token_id: Optional[int] = None,
        re_token_id: Optional[int] = None,
        force_full_seq_decode: bool = False,
    ):
        self.message = message  # str prompt or list of chat messages
        self.request_id = request_id
        self.params = params or SampleParams()
        self.model = model
        self.completed = asyncio.Event()
        self.async_stream = AsyncDataStream(
            tokenizer,
            rs_token_id=rs_token_id,
            re_token_id=re_token_id,
            force_full_seq_decode=force_full_seq_decode,
        )
        self.finish_reason: Optional[str] = None
        self.prompt_len = 0

        # timing trace (reference: task.py:99-121)
        self.arrival_time = time.time()
        self.prefill_start_time: Optional[float] = None
        self.prefill_end_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    def bind_loop(self):
        try:
            self._loop = asyncio.get_running_loop()
        except RuntimeError:
            self._loop = None

    def add_data(self, token_id: int):
        self.async_stream.add_data(token_id)

    def finish(self, reason: str):
        self.finish_reason = reason
        self.finish_time = time.time()
        self.async_stream.finish()
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self.completed.set)
        else:
            self.completed.set()
        self._write_trace()

    def _write_trace(self):
        """Per-request JSONL trace (reference: task.py:99-121)."""
        trace_dir = os.environ.get("CHITU_TPU_TRACE_DIR", "")
        if not trace_dir:
            return
        try:
            os.makedirs(trace_dir, exist_ok=True)
            out_len = self.async_stream.num_tokens
            decode_s = (
                self.finish_time - self.prefill_end_time
                if self.prefill_end_time
                else 0.0
            )
            rec = {
                "request_id": self.request_id,
                "arrival": self.arrival_time,
                "input_tokens": self.prompt_len,
                "output_tokens": out_len,
                "prefill_s": (
                    (self.prefill_end_time or 0) - (self.prefill_start_time or 0)
                ),
                "total_s": self.finish_time - self.arrival_time,
                "decode_tps": out_len / decode_s if decode_s > 0 else 0.0,
                "finish_reason": self.finish_reason,
            }
            day = time.strftime("%Y_%m_%d")
            with open(os.path.join(trace_dir, f"trace_{day}.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            logger.exception("failed to write request trace")


class TaskType(enum.Enum):
    PREFILL = 1
    DECODE = 2


class Task:
    """Engine-side state for one request (reference: task.py:189-300)."""

    def __init__(
        self,
        task_id: str,
        req: UserRequest,
        tokenizer,
        stop_with_eos: bool = True,
        max_seq_len: int = 2048,
        prompt_tokens: Optional[List[int]] = None,
        priority: float = 1.0,
    ):
        self.task_id = task_id
        self.req = req
        self.task_type = TaskType.PREFILL
        self.priority = priority
        self.arrival = time.time()
        self.sched_score = 0.0
        self.stop_with_eos = stop_with_eos
        self.max_seq_len = max_seq_len
        self.cancelled = False

        # tokenize at construction (reference: task.py:230-237)
        if prompt_tokens is not None:
            self.tokens = list(prompt_tokens)
        elif isinstance(req.message, str):
            self.tokens = tokenizer.encode(req.message, bos=True)
        else:
            self.tokens = list(tokenizer.encode_chat(req.message))
        req.prompt_len = len(self.tokens)
        self.prefix_len = len(self.tokens)
        if self.prefix_len + 1 > max_seq_len:
            raise ValueError(
                f"prompt length {self.prefix_len} exceeds max_seq_len "
                f"{max_seq_len} (need at least one generated token)"
            )
        self.stop_tokens = (
            tokenizer.stop_tokens if tokenizer is not None else frozenset()
        )
        self.response_tokens: List[int] = []
        self.max_new_tokens = req.params.max_new_tokens
        # engine-assigned residency (set by the executor on first prefill)
        self.slot: int = -1
        # how many prompt tokens have been prefilled (chunked prefill support)
        self.prefilled_len: int = 0
        TaskLoad.increase(self.load_score())

    # -- scheduling metadata ------------------------------------------------

    def load_score(self) -> float:
        return float(self.prefix_len + self.max_new_tokens)

    @property
    def seq_len(self) -> int:
        return self.prefix_len + len(self.response_tokens)

    # -- state machine ------------------------------------------------------

    def start_decoding(self):
        self.task_type = TaskType.DECODE
        if self.req.prefill_end_time is None:
            self.req.prefill_end_time = time.time()

    def append_token(self, token_id: int):
        self.response_tokens.append(token_id)
        self.req.add_data(token_id)

    def cancel(self):
        """Client abandoned the request (disconnect): stop generating at
        the next scheduling check and release device residency."""
        self.cancelled = True

    def need_remove(self) -> bool:
        """EOS / length stop check (reference: task.py:260-271)."""
        if self.cancelled:
            return True
        if (
            self.stop_with_eos
            and self.response_tokens
            and self.response_tokens[-1] in self.stop_tokens
        ):
            return True
        if len(self.response_tokens) >= self.max_new_tokens:
            return True
        if self.seq_len >= self.max_seq_len:
            return True
        return False

    def preempt(self):
        """Evict from device residency (KV pages freed by the executor);
        the task re-enters as a prefill that rebuilds its context
        (prompt + generated-so-far) before decoding continues. The
        reference only TODOs this ("scheduling and preemption in paper",
        cache_manager.py:160-168)."""
        self.task_type = TaskType.PREFILL
        self.prefilled_len = 0

    def rebuild_tokens(self) -> List[int]:
        """Token context a preempted task must re-prefill: everything
        except the last response token (which is fed to the next decode
        step and gets its KV appended there)."""
        return self.tokens + self.response_tokens[:-1]

    def finish_reason(self) -> str:
        if self.cancelled:
            return "cancelled"
        if (
            self.stop_with_eos
            and self.response_tokens
            and self.response_tokens[-1] in self.stop_tokens
        ):
            return "stop"
        return "length"


class TaskPool:
    """Global pool of live tasks (reference: task.py:124-186).

    A plain instance (not class-level globals) so multiple engines can
    coexist in one process (tests).
    """

    def __init__(self):
        self.pool: Dict[str, Task] = {}
        self.id_list: List[str] = []
        self.lock = threading.Lock()

    def add(self, task: Task) -> bool:
        with self.lock:
            if task.task_id in self.pool:
                return False
            self.pool[task.task_id] = task
            self.id_list.append(task.task_id)
            return True

    def remove(self, task_id: str) -> bool:
        with self.lock:
            task = self.pool.pop(task_id, None)
            if task is None:
                return False
            self.id_list.remove(task_id)
        TaskLoad.reduce(task.load_score())
        return True

    def __contains__(self, task_id: str) -> bool:
        return task_id in self.pool

    def __getitem__(self, task_id: str) -> Task:
        return self.pool[task_id]

    def __len__(self) -> int:
        return len(self.pool)

    def snapshot(self) -> List[Task]:
        with self.lock:
            return [self.pool[tid] for tid in self.id_list]


_req_counter = 0
_req_counter_lock = threading.Lock()


def new_request_id() -> str:
    global _req_counter
    with _req_counter_lock:
        _req_counter += 1
        return f"req-{_req_counter:08d}"
