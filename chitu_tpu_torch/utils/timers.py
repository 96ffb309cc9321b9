"""Named cumulative timers with device fencing, and a profiler session.

Capability parity with the reference's Timers
(reference: chitu/global_vars.py:118-203): each timer start/stop is fenced
by ``torch.cuda.synchronize()`` when a CUDA device is in use, so a named
phase measures the device work it enqueued, not just the enqueue.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch


def _cuda_sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Timer:
    def __init__(self, name: str, sync: bool = True):
        self.name = name
        self.sync = sync
        self.elapsed_ = 0.0
        self.count = 0
        self.started = False
        self._start_time = 0.0

    def _fence(self):
        if self.sync:
            _cuda_sync()

    def start(self):
        # re-entrant-safe: a prior step that raised mid-timing must not
        # poison subsequent steps
        if self.started:
            self.started = False
        self._fence()
        self._start_time = time.perf_counter()
        self.started = True

    def stop(self):
        assert self.started, f"timer {self.name} not started"
        self._fence()
        self.elapsed_ += time.perf_counter() - self._start_time
        self.count += 1
        self.started = False

    def reset(self):
        self.elapsed_ = 0.0
        self.count = 0
        self.started = False

    def elapsed(self, reset: bool = False) -> float:
        was_started = self.started
        if was_started:
            self.stop()
        value = self.elapsed_
        if reset:
            self.reset()
        if was_started:
            self.start()
        return value


class Timers:
    """Group of named timers (reference: global_vars.py:162-203)."""

    def __init__(self, sync: bool = True):
        self.timers: Dict[str, _Timer] = {}
        self.sync = sync

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, sync=self.sync)
        return self.timers[name]

    def log(self, names=None, normalizer: float = 1.0, logger=None) -> str:
        names = names if names is not None else list(self.timers)
        parts = []
        for name in names:
            t = self.timers.get(name)
            if t is None or t.count == 0:
                continue
            avg_ms = t.elapsed_ * 1000.0 / max(t.count, 1) / normalizer
            parts.append(f"{name}: n={t.count} total={t.elapsed_*1000.0:.1f}ms avg={avg_ms:.3f}ms")
        msg = "timers | " + " | ".join(parts) if parts else "timers | (empty)"
        if logger is not None:
            logger.info(msg)
        return msg

    def reset(self):
        for t in self.timers.values():
            t.reset()


class ProfilerSession:
    """`torch.profiler` trace capture around engine sections; the trace is
    written as a Chrome trace under `log_dir` when the session stops."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.prof = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def start(self):
        if self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.log_dir
                ),
            )
            self.prof.__enter__()

    def stop(self):
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


_GLOBAL_TIMERS: Optional[Timers] = None


def get_timers() -> Timers:
    global _GLOBAL_TIMERS
    if _GLOBAL_TIMERS is None:
        _GLOBAL_TIMERS = Timers()
    return _GLOBAL_TIMERS
