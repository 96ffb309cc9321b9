"""Batch scheduling policies.

Capability parity with the reference's scheduler suite — all 7 policies
(reference: chitu/scheduler.py:13-356): fcfs, prefill_first (default),
stride, deadline, prefix_align, balance, and skew_pipeline (PP slot-group
decode scheduling; the pipelined decode it feeds is not ported yet, so
pp > 1 raises at engine bring-up).

A schedule() returns a list of task_ids forming one engine step's batch.
Like the reference, a batch is homogeneous (all-prefill or all-decode)
unless the policy supports hybrid fill.
"""

from __future__ import annotations

import time
from typing import List, Optional

from chitu_tpu_torch.task import Task, TaskPool, TaskType


class Scheduler:
    """Base scheduler over a TaskPool (reference: scheduler.py:41-62)."""

    def __init__(self, pool: TaskPool, cfg):
        self.pool = pool
        self.cfg = cfg
        self.max_tasks = cfg.infer.max_reqs
        # the clock a policy reads; under tensor parallelism the engine
        # sets it to rank 0's reading of each step
        self.clock = time.time

    @staticmethod
    def build(pool: TaskPool, cfg) -> "Scheduler":
        policy = cfg.scheduler.policy
        cls = _POLICIES.get(policy)
        if cls is None:
            raise ValueError(
                f"unknown scheduler policy {policy!r}; have {sorted(_POLICIES)}"
            )
        return cls(pool, cfg)

    # -- helpers ------------------------------------------------------------

    def _runnable(self, admit=None) -> List[Task]:
        """Runnable tasks; prefills are filtered by the engine's admission
        predicate (free slots/pages) so inadmissible prefills cannot starve
        decode batches (the reference instead rejects at the HTTP layer,
        serve.py:61-67 — we do both)."""
        out = []
        for t in self.pool.snapshot():
            if (
                t.task_type == TaskType.PREFILL
                and admit is not None
                and not admit(t)
            ):
                continue
            out.append(t)
        return out

    def schedule(self, admit=None) -> List[str]:
        raise NotImplementedError

    def update(self, batch_ids: Optional[List[str]] = None) -> List[str]:
        """Remove finished tasks; returns removed decode task ids
        (reference: scheduler.py:44-59)."""
        removed = []
        for t in self.pool.snapshot():
            if t.task_type == TaskType.DECODE and t.need_remove():
                removed.append(t.task_id)
        for tid in removed:
            task = self.pool[tid]
            task.req.finish(task.finish_reason())
            self.pool.remove(tid)
        return removed


class FcfsScheduler(Scheduler):
    """First-come-first-served (reference: scheduler.py:65-94)."""

    def schedule(self, admit=None) -> List[str]:
        tasks = self._runnable(admit)
        if not tasks:
            return []
        tasks.sort(key=lambda t: t.arrival)
        first_type = tasks[0].task_type
        same = [t for t in tasks if t.task_type == first_type]
        return [t.task_id for t in same[: self.max_tasks]]


class PrefillFirstScheduler(Scheduler):
    """All pending prefills first, else decodes (reference: scheduler.py:97-136)."""

    def schedule(self, admit=None) -> List[str]:
        tasks = self._runnable(admit)
        prefills = [t for t in tasks if t.task_type == TaskType.PREFILL]
        decodes = [t for t in tasks if t.task_type == TaskType.DECODE]
        if prefills:
            batch = prefills[: self.max_tasks]
            if self.cfg.scheduler.hybrid_fill and len(batch) < self.max_tasks:
                batch += decodes[: self.max_tasks - len(batch)]
            return [t.task_id for t in batch]
        return [t.task_id for t in decodes[: self.max_tasks]]


class StrideScheduler(Scheduler):
    """Priority-weighted aging: score = priority * elapsed, recomputed
    each round — matches the reference's Stride policy semantics
    (reference: scheduler.py:189-235), which also recomputes rather than
    accumulating a true stride pass."""

    def schedule(self, admit=None) -> List[str]:
        tasks = self._runnable(admit)
        if not tasks:
            return []
        now = self.clock()
        for t in tasks:
            t.sched_score = t.priority * (now - t.arrival)
        tasks.sort(key=lambda t: -t.sched_score)
        first_type = tasks[0].task_type
        same = [t for t in tasks if t.task_type == first_type]
        return [t.task_id for t in same[: self.max_tasks]]


class DeadlineScheduler(Scheduler):
    """Earliest-deadline-first: deadline = arrival + a*prefix + b*max_out
    (reference: scheduler.py:238-272)."""

    def schedule(self, admit=None) -> List[str]:
        tasks = self._runnable(admit)
        if not tasks:
            return []
        a = self.cfg.scheduler.deadline_alpha
        b = self.cfg.scheduler.deadline_beta
        tasks.sort(
            key=lambda t: t.arrival + a * t.prefix_len + b * t.max_new_tokens
        )
        first_type = tasks[0].task_type
        same = [t for t in tasks if t.task_type == first_type]
        return [t.task_id for t in same[: self.max_tasks]]


class PrefixAlignScheduler(Scheduler):
    """Batch tasks with similar prefix lengths (reference: scheduler.py:275-309)."""

    def schedule(self, admit=None) -> List[str]:
        tasks = self._runnable(admit)
        prefills = [t for t in tasks if t.task_type == TaskType.PREFILL]
        decodes = [t for t in tasks if t.task_type == TaskType.DECODE]
        if prefills:
            prefills.sort(key=lambda t: t.prefix_len)
            return [t.task_id for t in prefills[: self.max_tasks]]
        return [t.task_id for t in decodes[: self.max_tasks]]


class BalanceScheduler(Scheduler):
    """Mixed prefill/decode batches at a configured ratio
    (reference: scheduler.py:312-356)."""

    def schedule(self, admit=None) -> List[str]:
        tasks = self._runnable(admit)
        prefills = [t for t in tasks if t.task_type == TaskType.PREFILL]
        decodes = [t for t in tasks if t.task_type == TaskType.DECODE]
        n_pre = min(
            len(prefills), max(1, int(self.max_tasks * self.cfg.scheduler.balance_ratio))
        ) if prefills else 0
        n_dec = min(len(decodes), self.max_tasks - n_pre)
        return [t.task_id for t in prefills[:n_pre]] + [
            t.task_id for t in decodes[:n_dec]
        ]


class SkewPipelineScheduler(Scheduler):
    """PP-aware decode scheduling (reference: scheduler.py:139-186
    SkewPipelineScheduler + global_vars.py:230-268 SlotHandle): decodes
    are pinned to one of `pp` slot groups and scheduled only when every
    group can contribute, so the pipelined decode step keeps all stages
    busy with different microbatches. Prefills run whenever pending
    (filling empty groups quickly)."""

    def __init__(self, pool: TaskPool, cfg):
        super().__init__(pool, cfg)
        self.n_groups = max(cfg.infer.pp_size, 1)
        self._group_of = {}
        self._next = 0

    def group_of(self, task_id: str) -> int:
        g = self._group_of.get(task_id)
        if g is None:
            g = self._next % self.n_groups
            self._group_of[task_id] = g
            self._next += 1
        return g

    def schedule(self, admit=None) -> List[str]:
        tasks = self._runnable(admit)
        prefills = [t for t in tasks if t.task_type == TaskType.PREFILL]
        if prefills:
            return [t.task_id for t in prefills[: self.max_tasks]]
        decodes = [t for t in tasks if t.task_type == TaskType.DECODE]
        # interleave groups so the executor's round-robin grouping
        # reconstructs full slot groups
        by_group: dict = {}
        for t in decodes:
            by_group.setdefault(self.group_of(t.task_id), []).append(t)
        out: List[str] = []
        i = 0
        while len(out) < min(len(decodes), self.max_tasks):
            g = i % self.n_groups
            if by_group.get(g):
                out.append(by_group[g].pop(0).task_id)
            i += 1
            if i > self.n_groups * self.max_tasks:
                break
        return out

    def update(self, batch_ids=None) -> List[str]:
        removed = super().update(batch_ids)
        for tid in removed:
            self._group_of.pop(tid, None)
        return removed


_POLICIES = {
    "fcfs": FcfsScheduler,
    "prefill_first": PrefillFirstScheduler,
    "stride": StrideScheduler,
    "deadline": DeadlineScheduler,
    "prefix_align": PrefixAlignScheduler,
    "balance": BalanceScheduler,
    "skew_pipeline": SkewPipelineScheduler,
}
