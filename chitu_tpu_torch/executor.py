"""Executor: turns scheduled task batches into device steps.

Counterpart of `chitu_tpu/executor.py` (reference: chitu/executor.py:40-162
NormalExecutor). Prefill packs prompts into a fixed-geometry slab (or
runs one prompt's chunks), samples first tokens on the device, and flips
tasks to decode; a hybrid step carries the in-flight decode rows through
the packed prefill's forward; decode runs in windows of K steps whose
sampled tokens feed back on the device, with one host sync per chain of
windows.

PyTorch runs eagerly, so the JAX package's jit caches and first-call
timers are gone. The shapes stay bucketed exactly as there (prefill
length and table-width buckets, decode batch buckets, the fixed packed
slab, the window ladder): they are the shapes a later CUDA-graph capture
keys on. The KV pool and the sampling counts are updated IN PLACE (the
JAX programs donate and replace them).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from chitu_tpu_torch import sampling
from chitu_tpu_torch.kvcache import PagedKVCache, SlotAllocator
from chitu_tpu_torch.ops.attention_kernels import packed_q_block
from chitu_tpu_torch.task import Task, TaskType
from chitu_tpu_torch.utils import get_logger, get_timers

logger = get_logger()


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pow2_buckets(lo: int, hi: int) -> Tuple[int, ...]:
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


class Executor:
    """Single-device executor."""

    def __init__(self, cfg, model, cache: PagedKVCache, has_waiting=None):
        self.cfg = cfg
        self.model = model
        self.cache = cache
        self.device = model.device
        self.page = cfg.infer.page_size
        self.max_reqs = cfg.infer.max_reqs
        self.mp_full = cfg.infer.max_seq_len // self.page + 1

        vocab = model.args.vocab_size
        self.counts = torch.zeros(
            (self.max_reqs, vocab), dtype=torch.int32, device=self.device
        )
        self.slots = SlotAllocator(self.max_reqs)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.infer.seed)
        # admission-queue probe: True when prefill work waits for a slot —
        # decode chains stay short then
        self.has_waiting = has_waiting or (lambda: False)

        self.prefill_buckets = _pow2_buckets(16, cfg.infer.max_seq_len)
        self.decode_buckets = tuple(
            b for b in cfg.infer.decode_buckets if b <= self.max_reqs
        ) or (self.max_reqs,)
        if self.decode_buckets[-1] < self.max_reqs:
            self.decode_buckets = self.decode_buckets + (self.max_reqs,)

        # adaptive-window dispatch-cost model: wall(chain) = a + steps*b,
        # fit online from decode chains; kappa = a/b is the host-round
        # cost in step-equivalents fed to _pick_window.
        # calibrate_dispatch() seeds it explicitly.
        self._lat_pairs: List[Tuple[int, float]] = []
        self._kappa: float = 1.0
        self._kappa_src = "default"

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- slab geometry ------------------------------------------------------

    def _packed_q_block(self) -> int:
        """Query-block granularity for packed varlen prefill (each
        request's tokens pad to a multiple of this)."""
        if not hasattr(self, "_tq_cache"):
            M = self.cache.arrays["kv"].shape[-1]
            self._tq_cache = packed_q_block(
                self.model.args.n_heads, M, self.page, self.model.head_dim,
                kv_heads=self.model.args.n_kv_heads,
            )
        return self._tq_cache

    def _pack_slab(self) -> int:
        """Fixed token-slab size for packed/hybrid prefill: every packed
        call runs at exactly this many tokens (R = max_reqs segments);
        groups whose padded prompts exceed it split across calls."""
        Tq = self._packed_q_block()
        slab = max(2 * Tq, min(max(self.cfg.infer.prefill_chunk, 16), 512))
        p = Tq
        while p < slab:
            p *= 2
        return p

    # -- sampling -----------------------------------------------------------

    def _sampling_arrays(self, tasks: List[Optional[Task]], n: int):
        """Per-row sampler params; None entries are padding rows (invalid,
        slot INT_MAX — ignored by the sampler and the host)."""
        temps = np.ones((n,), np.float32)
        top_ks = np.full((n,), 1, np.int32)
        top_ps = np.ones((n,), np.float32)
        pens = np.zeros((n,), np.float32)
        slots = np.full((n,), np.iinfo(np.int32).max, np.int32)
        valid = np.zeros((n,), bool)
        for i, t in enumerate(tasks):
            if t is None:
                continue
            p = t.req.params
            temps[i] = max(p.temperature, 1e-6)
            top_ks[i] = p.top_k
            top_ps[i] = p.top_p
            pens[i] = p.frequency_penalty
            slots[i] = t.slot
            valid[i] = True
        return tuple(
            self._tensor(a) for a in (temps, top_ks, top_ps, pens, slots, valid)
        )

    def _sample(self, logits, temps, tks, tps, pens, slots, valid):
        """Penalize, sample and count one row per request, on the device."""
        logits = sampling.apply_frequency_penalty(
            logits.float(), self.counts, slots, pens
        )
        toks = sampling.sample_tokens(logits, self.generator, temps, tks, tps)
        sampling.update_counts(self.counts, slots, toks, valid)
        return toks

    # -- steps --------------------------------------------------------------

    def step(self, tasks: List[Task]):
        """Run one engine step over a (possibly mixed) scheduled batch
        (reference: executor.py:150-162)."""
        prefills = [t for t in tasks if t.task_type == TaskType.PREFILL]
        decodes = [t for t in tasks if t.task_type == TaskType.DECODE]
        if prefills:
            piggy = None
            if decodes and self._hybrid_ok():
                # decode rows ride the packed prefill's forward (hybrid
                # step); rows that can't get a page decode normally
                piggy = [
                    t
                    for t in decodes
                    if self.cache.allocator.ensure(t.task_id, t.seq_len + 1)
                ][: self.max_reqs]
            self.prefill_step(prefills, piggyback=piggy or None)
            # a piggybacked row may have just hit EOS / budget
            decodes = [t for t in decodes if not t.need_remove()]
        if decodes:
            self.decode_step(decodes)

    def _hybrid_ok(self) -> bool:
        return hasattr(self.model, "step_hybrid") and self.cfg.infer.hybrid_step

    def prefill_step(
        self, tasks: List[Task], piggyback: Optional[List[Task]] = None
    ):
        """(reference: executor.py:118-131). `piggyback` is the in-flight
        decode batch riding the packed prefill's forward (hybrid step);
        its rows are sampled together with the prefill first tokens."""
        timers = get_timers()
        timers("prefill").start()
        admitted = []
        for t in tasks:
            slot = self.slots.alloc(t.task_id)
            if slot is None:
                continue  # over max_reqs; stays queued
            t.slot = slot
            if not self.cache.allocator.ensure(t.task_id, t.prefix_len + 1):
                self.slots.release(t.task_id)
                t.slot = -1
                logger.warning("KV pool exhausted; deferring %s", t.task_id)
                continue
            if t.req.prefill_start_time is None:
                t.req.prefill_start_time = time.time()
            admitted.append(t)

        if not admitted:
            timers("prefill").stop()
            return

        # preempted tasks rebuild their KV (prompt + generated) and resume
        # decoding directly — no new token is sampled
        resumed = [t for t in admitted if t.response_tokens]
        admitted = [t for t in admitted if not t.response_tokens]
        for t in resumed:
            rebuild = t.rebuild_tokens()
            if not self.cache.allocator.ensure(t.task_id, len(rebuild) + 1):
                logger.warning("cannot rebuild %s; KV pool exhausted", t.task_id)
                continue
            self._prefill_one(t, tokens=rebuild)
            t.start_decoding()
        if not admitted:
            timers("prefill").stop()
            return

        # pack every one-chunk prompt into slab calls (the reference's
        # packed VarLens prefill, utils.py:84-100); longer prompts take
        # the chunked per-request path
        chunk_cap = max(self.cfg.infer.prefill_chunk, 16)
        Tq = self._packed_q_block()
        slab = self._pack_slab()
        logits_by_task = {}
        packable: List[Task] = []
        for t in admitted:
            n_tok = len(t.tokens) - t.prefilled_len
            if n_tok <= chunk_cap and (n_tok + Tq - 1) // Tq * Tq <= slab:
                packable.append(t)
            else:
                logits_by_task[t.task_id] = self._prefill_one(t)

        packed_results = []  # (device tokens, row->task list) per slab
        if len(packable) == 1 and not piggyback:
            # lone prompt with nothing in flight: the per-length chunked
            # path is cheaper than a full slab
            logits_by_task[packable[0].task_id] = self._prefill_one(
                packable[0]
            )
            packable = []
        if packable:
            # first-fit split into fixed-size slabs; only the first slab
            # carries the piggybacked decode batch
            packs: List[List[Task]] = [[]]
            fill = 0
            for t in packable:
                pt = (len(t.tokens) + Tq - 1) // Tq * Tq
                if packs[-1] and (
                    fill + pt > slab or len(packs[-1]) >= self.max_reqs
                ):
                    packs.append([])
                    fill = 0
                packs[-1].append(t)
                fill += pt
            timers("prefill_packs").start()
            for gi, tasks_g in enumerate(packs):
                packed_results.append(
                    self._prefill_packed_step(
                        tasks_g, piggyback if gi == 0 else None
                    )
                )
            timers("prefill_packs").stop()

        # chunked rows: sample on the device, one fetch
        rest = [t for t in admitted if t.task_id in logits_by_task]
        if rest:
            timers("prefill_sample").start()
            logits = torch.stack([logits_by_task[t.task_id] for t in rest])
            arrs = self._sampling_arrays(rest, len(rest))
            toks_host = self._sample(logits, *arrs).cpu().numpy()
            timers("prefill_sample").stop()
            for i, t in enumerate(rest):
                t.prefilled_len = t.prefix_len
                t.start_decoding()
                t.append_token(int(toks_host[i]))
        # packed rows: one host fetch over all slab outputs
        if packed_results:
            fetched = torch.cat([toks for toks, _ in packed_results]).cpu()
            fetched = fetched.numpy()
            off = 0
            for toks, rows in packed_results:
                th = fetched[off : off + toks.shape[0]]
                off += toks.shape[0]
                for i, t in enumerate(rows):
                    if t is None:
                        continue
                    if t.task_type == TaskType.PREFILL:
                        t.prefilled_len = t.prefix_len
                        t.start_decoding()
                    t.append_token(int(th[i]))
        timers("prefill").stop()

    def _prefill_packed_step(
        self, tasks_g: List[Task], piggyback: Optional[List[Task]] = None
    ):
        """Pack R one-chunk prompts into one forward; samples on the
        device and returns (device tokens, row->task list). With
        `piggyback`, the in-flight decode batch rides the same forward
        (hybrid step) and its rows follow the prefill rows."""
        Tq = self._packed_q_block()
        starts = [t.prefilled_len for t in tasks_g]
        lens = [len(t.tokens) - s for t, s in zip(tasks_g, starts)]
        padded = [(n + Tq - 1) // Tq * Tq for n in lens]
        T_bucket = self._pack_slab()
        assert sum(padded) <= T_bucket and len(tasks_g) <= self.max_reqs
        NB = T_bucket // Tq
        R = self.max_reqs
        pages_needed = max(
            (len(t.tokens) + self.page - 1) // self.page for t in tasks_g
        )
        mp = min(
            _bucket(pages_needed, _pow2_buckets(1, self.mp_full)),
            self.mp_full,
        )

        tokens = np.zeros((T_bucket,), np.int32)
        seg_ids = np.full((T_bucket,), -1, np.int32)
        pos = np.full((T_bucket,), -1, np.int32)
        block_seg = np.full((NB,), -1, np.int32)
        block_qstart = np.zeros((NB,), np.int32)
        bts = np.full((R, mp), -1, np.int32)
        total_lens = np.zeros((R,), np.int32)
        last_idx = np.zeros((R,), np.int32)
        off = 0
        for r, t in enumerate(tasks_g):
            s, n = starts[r], lens[r]
            tokens[off : off + n] = t.tokens[s:]
            seg_ids[off : off + n] = r
            pos[off : off + n] = np.arange(s, s + n)
            total_lens[r] = len(t.tokens)
            last_idx[r] = off + n - 1
            bts[r] = self.cache.allocator.block_table([t.task_id], mp)[0]
            nb_r = padded[r] // Tq
            b0 = off // Tq
            block_seg[b0 : b0 + nb_r] = r
            block_qstart[b0 : b0 + nb_r] = s + np.arange(nb_r) * Tq
            off += padded[r]
        pf = [
            self._tensor(a)
            for a in (tokens, seg_ids, pos, bts, total_lens, last_idx,
                      block_seg, block_qstart)
        ]
        cache = {"kv": self.cache.arrays["kv"]}

        if piggyback:
            # fixed B as well: the decode rows are a small fraction of the
            # slab's token stream
            B = self.decode_buckets[-1]
            dec_tokens = np.zeros((B,), np.int32)
            dec_seq = np.zeros((B,), np.int32)
            dec_bts = np.full((B, self.mp_full), -1, np.int32)
            dec_valid = np.zeros((B,), bool)
            for i, t in enumerate(piggyback):
                dec_tokens[i] = (
                    t.response_tokens[-1] if t.response_tokens else t.tokens[-1]
                )
                dec_seq[i] = t.seq_len - 1
                dec_bts[i] = self.cache.allocator.block_table(
                    [t.task_id], self.mp_full
                )[0]
                dec_valid[i] = True
            # sampled rows: R prefill firsts then B decode rows
            rows = list(tasks_g) + [None] * (R - len(tasks_g))
            rows += list(piggyback) + [None] * (B - len(piggyback))
            arrs = self._sampling_arrays(rows, R + B)
            dec_logits, pf_logits, _ = self.model.step_hybrid(
                cache,
                *(self._tensor(a) for a in (dec_tokens, dec_seq, dec_bts, dec_valid)),
                *pf,
                page_size=self.page,
            )
            logits = torch.cat([pf_logits, dec_logits], dim=0)
        else:
            rows = list(tasks_g) + [None] * (R - len(tasks_g))
            arrs = self._sampling_arrays(rows, R)
            logits, _ = self.model.prefill_packed(cache, *pf, page_size=self.page)
        toks = self._sample(logits, *arrs)
        for t in tasks_g:
            t.prefilled_len = len(t.tokens)
        # rows[i] is the task whose sampled token is toks[i] (None = pad)
        return toks, rows

    def _prefill_one(self, t: Task, tokens=None) -> torch.Tensor:
        """Run one request's context through the model (chunked if long)."""
        chunk_cap = max(self.cfg.infer.prefill_chunk, 16)
        pos = t.prefilled_len
        tokens = tokens if tokens is not None else t.tokens
        logits = None
        cache = {"kv": self.cache.arrays["kv"]}
        while pos < len(tokens):
            n = min(len(tokens) - pos, chunk_cap)
            T = _bucket(n, self.prefill_buckets)
            total = pos + n
            pages_needed = (total + self.page - 1) // self.page
            mp = min(
                _bucket(pages_needed, _pow2_buckets(1, self.mp_full)),
                self.mp_full,
            )
            chunk = np.zeros((T,), np.int32)
            chunk[:n] = tokens[pos : pos + n]
            bt = self.cache.allocator.block_table([t.task_id], mp)[0]
            logits, _ = self.model.prefill(
                cache, self._tensor(chunk), self._tensor(bt), pos, n,
                page_size=self.page,
            )
            pos += n
        t.prefilled_len = pos
        return logits

    # -- decode windows -----------------------------------------------------

    def _window_buckets(self) -> Tuple[int, ...]:
        """Descending pow-4 ladder of window lengths below the configured
        decode_window (e.g. 32 -> (32, 8, 2, 1))."""
        out = [max(1, self.cfg.infer.decode_window)]
        while out[-1] > 1:
            out.append(max(1, out[-1] // 4))
        return tuple(out)

    def _pick_window(self, r_eff: List[int], min_headroom: int) -> int:
        """Window length for this batch: the bucket maximizing useful
        slot-steps per unit time, sum_i min(W, r_i) / (W + kappa), where
        r_i is row i's remaining budget and kappa ~ the host dispatch
        cost in step-equivalents. `min_headroom` (positions left to
        max_seq_len) is the only hard cap."""
        cand = [
            w for w in self._window_buckets() if w <= max(min_headroom, 1)
        ]
        if not cand:
            cand = [1]
        if not self.cfg.infer.adaptive_window:
            return cand[0]
        kappa = self._kappa
        return max(
            cand,
            key=lambda w: (sum(min(w, r) for r in r_eff) / (w + kappa), w),
        )

    def _record_chain(self, steps: int, wall: float):
        """Feed one decode-chain timing into the dispatch-cost fit
        (wall = a + steps*b least squares; kappa = a/b)."""
        self._lat_pairs.append((steps, wall))
        if len(self._lat_pairs) > 256:
            del self._lat_pairs[:128]
        pts = self._lat_pairs[-64:]
        ss = [p[0] for p in pts]
        if len(pts) < 4 or max(ss) - min(ss) < 2:
            return
        n = float(len(pts))
        sx = sum(ss)
        sy = sum(p[1] for p in pts)
        sxx = sum(s * s for s in ss)
        sxy = sum(s * w for s, w in pts)
        denom = n * sxx - sx * sx
        if denom <= 0:
            return
        b = (n * sxy - sx * sy) / denom
        if b <= 0:
            return
        a = max(0.0, (sy - b * sx) / n)
        self._kappa = float(np.clip(a / b, 0.25, 64.0))
        self._kappa_src = "online"

    def _run_window(
        self, window: int, tokens, seq_lens, bts, valid, done, slots, temps,
        tks, tps, pens, remaining, stop_ids, check_stop, greedy: bool,
        nopen: bool,
    ):
        """`window` decode+sample steps with the sampled tokens fed back
        on the device (no host sync inside). Returns tokens [window, B]
        (-1 where a row was already done) and the carry (tokens, seq_lens,
        remaining, done). `greedy` / `nopen` are host-known batch
        properties (every row greedy / no row penalized) that skip the
        sampler's top-k machinery and the counts update."""
        cache = {"kv": self.cache.arrays["kv"]}
        done = done | ~valid
        outs = []
        for _ in range(window):
            live = valid & ~done
            logits, _ = self.model.decode(
                cache, tokens, seq_lens, bts, live, page_size=self.page
            )
            if not nopen:
                logits = sampling.apply_frequency_penalty(
                    logits, self.counts, slots, pens
                )
            new = sampling.sample_tokens(
                logits, self.generator, temps, tks, tps, greedy_all=greedy
            )
            if not nopen:
                sampling.update_counts(self.counts, slots, new, live)
            is_stop = check_stop & torch.any(new[:, None] == stop_ids, dim=-1)
            live_i = live.to(torch.int32)
            remaining = remaining - live_i
            done = done | (live & (is_stop | (remaining <= 0)))
            seq_lens = seq_lens + live_i
            tokens = torch.where(live, new, tokens)
            outs.append(torch.where(live, new, torch.full_like(new, -1)))
        return torch.stack(outs), (tokens, seq_lens, remaining, done)

    def calibrate_dispatch(self, reps: int = 3):
        """Measure the host overhead per decode chain in step-equivalents
        and seed the adaptive-window kappa: time the shortest and longest
        window on a fully-masked dummy batch (valid=False rows: no append,
        no count update; the weight reads, the real per-step cost, still
        run), each timed to its host fetch. Called from serving warmup;
        the online fit (_record_chain) keeps refining it."""
        wins = self._window_buckets()
        if len(wins) < 2:
            return
        w_hi, w_lo = wins[0], wins[-1]
        B = self.decode_buckets[0]
        dev = self.device
        zeros_i = torch.zeros((B,), dtype=torch.int32, device=dev)
        args = (
            zeros_i, zeros_i,
            torch.full((B, self.mp_full), -1, dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev),
            torch.ones((B,), dtype=torch.bool, device=dev),
            torch.full((B,), np.iinfo(np.int32).max, dtype=torch.int32, device=dev),
            torch.ones((B,), dtype=torch.float32, device=dev),
            torch.ones((B,), dtype=torch.int32, device=dev),
            torch.ones((B,), dtype=torch.float32, device=dev),
            torch.zeros((B,), dtype=torch.float32, device=dev),
            torch.ones((B,), dtype=torch.int32, device=dev),
            torch.full((B, 8), -2, dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev),
        )

        def run(w):
            toks, _ = self._run_window(w, *args, greedy=True, nopen=True)
            toks.cpu()  # timed to the host fetch, like a real chain

        times = {}
        for w in (w_lo, w_hi):
            run(w)  # warm
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                run(w)
                best = min(best, time.perf_counter() - t0)
            times[w] = best
        b = (times[w_hi] - times[w_lo]) / (w_hi - w_lo)
        if b <= 0:
            return
        a = max(0.0, times[w_lo] - w_lo * b)
        self._kappa = float(np.clip(a / b, 0.25, 64.0))
        self._kappa_src = "calibrated"
        logger.info(
            "dispatch calibration: overhead %.1fms, step %.2fms, kappa %.1f",
            a * 1e3, b * 1e3, self._kappa,
        )

    def _window_schedule(
        self, window: int, budget: int, headroom: int
    ) -> List[int]:
        """Chain of ladder window lengths issued back to back with device-
        side carry (one host round for the whole chain). With admission
        work waiting, keep the chain short (<= 4 x window) so freed slots
        refill promptly; otherwise cover the batch's shared budget. Total
        steps stay <= 4 x window and within `headroom`."""
        if self.has_waiting():
            return [window] * max(1, min(budget // window, 4))
        buckets = self._window_buckets()  # descending
        rem = max(1, min(budget, 4 * window))
        cap = min(max(1, headroom), 4 * window)
        schedule: List[int] = []
        total = 0
        while rem > 0 and len(schedule) < 8:
            over = [
                w for w in buckets
                if rem <= w <= 2 * rem and total + w <= cap
            ]
            if over:
                schedule.append(min(over))
                break
            fit = [w for w in buckets if w <= rem and total + w <= cap]
            if not fit:
                break
            w = fit[0]  # largest that fits
            schedule.append(w)
            total += w
            rem -= w
        return schedule or [max(1, min(window, headroom))]

    def decode_step(self, tasks: List[Task]):
        """One decode group: a chain of windows carried on the device, with
        ONE host sync at the end. Page tables grow before each window, so
        the chain issues back to back (reference: executor.py:133-148).
        Window length adapts to the batch's remaining budgets."""
        timers = get_timers()
        timers("decode").start()
        window = max(1, self.cfg.infer.decode_window)
        live = []
        pending = sorted(tasks, key=lambda t: t.arrival)  # oldest first
        while pending:
            t = pending.pop(0)
            ask = t.seq_len + min(
                window, max(1, t.max_new_tokens - len(t.response_tokens))
            )
            while not self.cache.allocator.ensure(t.task_id, ask):
                victim = pending.pop() if pending else None  # newest waits
                if victim is None:
                    break
                self.preempt(victim)
            else:
                live.append(t)
                continue
            # pool exhausted with no victims left: preempt t itself
            if not live:
                logger.warning("KV pool exhausted; preempting %s", t.task_id)
                self.preempt(t)
        if not live:
            timers("decode").stop()
            return
        order = {id(t): i for i, t in enumerate(tasks)}
        live.sort(key=lambda t: order[id(t)])
        B = _bucket(len(live), self.decode_buckets)
        tokens = np.zeros((B,), np.int32)
        seq_lens = np.zeros((B,), np.int32)
        remaining = np.ones((B,), np.int32)
        check_stop = np.zeros((B,), bool)
        for i, t in enumerate(live):
            tokens[i] = t.response_tokens[-1] if t.response_tokens else t.tokens[-1]
            # context BEFORE the fed token: its KV is appended at this
            # position inside the step
            seq_lens[i] = t.seq_len - 1
            remaining[i] = max(t.max_new_tokens - len(t.response_tokens), 1)
            check_stop[i] = t.stop_with_eos
        min_headroom = min(max(1, t.max_seq_len - t.seq_len) for t in live)
        r_eff = [
            min(int(remaining[i]), max(1, t.max_seq_len - t.seq_len))
            for i, t in enumerate(live)
        ]
        window = self._pick_window(r_eff, min_headroom)
        schedule = self._window_schedule(window, min(r_eff), min_headroom)

        stop_ids = self._stop_ids(live, B)
        temps, tks, tps, pens, slots, valid = self._sampling_arrays(live, B)
        greedy = all(t.req.params.top_k == 1 for t in live)
        nopen = all(t.req.params.frequency_penalty == 0.0 for t in live)

        dev_tokens = self._tensor(tokens)
        dev_seq = self._tensor(seq_lens)
        dev_rem = self._tensor(remaining)
        dev_done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        chk = self._tensor(check_stop)
        outs = []
        steps_issued = 0
        t_chain0 = time.perf_counter()
        for wi, win_w in enumerate(schedule):
            steps_issued += win_w
            ok = True
            for t in live:
                if not self.cache.allocator.ensure(
                    t.task_id, t.seq_len + steps_issued
                ):
                    ok = False
            if not ok and wi > 0:
                break  # pool exhausted: settle for the windows issued
            bts = np.full((B, self.mp_full), -1, np.int32)
            bts[: len(live)] = self.cache.allocator.block_table(
                [t.task_id for t in live], self.mp_full
            )
            toks_w, carry = self._run_window(
                win_w, dev_tokens, dev_seq, self._tensor(bts), valid,
                dev_done, slots, temps, tks, tps, pens, dev_rem, stop_ids,
                chk, greedy, nopen,
            )
            outs.append(toks_w)
            dev_tokens, dev_seq, dev_rem, dev_done = carry

        # ONE host sync for the whole chain
        toks_host = torch.cat(outs, dim=0).cpu().numpy()
        if steps_issued > 0:
            self._record_chain(steps_issued, time.perf_counter() - t_chain0)
        for i, t in enumerate(live):
            for k in range(toks_host.shape[0]):
                tok = int(toks_host[k, i])
                if tok < 0:
                    break
                t.append_token(tok)
                if t.need_remove():
                    break
        timers("decode").stop()

    def _stop_ids(self, tasks: List[Task], n: int) -> torch.Tensor:
        """Per-row stop-token ids [n, 8], -2 padded (per-request sets so one
        task's custom stop token cannot truncate another's stream)."""
        out = np.full((n, 8), -2, np.int32)
        for i, t in enumerate(tasks):
            for j, tok in enumerate(sorted(t.stop_tokens)[:8]):
                out[i, j] = tok
        return self._tensor(out)

    # -- lifecycle ----------------------------------------------------------

    def preempt(self, task: Task):
        """Evict a task's KV pages (slot + frequency-penalty counts stay);
        it re-enters scheduling as a rebuild prefill."""
        logger.info("preempting %s (KV pool pressure)", task.task_id)
        self.cache.allocator.free(task.task_id)
        task.preempt()

    def release(self, task: Task):
        """Free device residency when a request finishes."""
        if task.slot >= 0:
            sampling.reset_slots(
                self.counts,
                torch.tensor([task.slot], dtype=torch.int32, device=self.device),
            )
        self.slots.release(task.task_id)
        self.cache.allocator.free(task.task_id)
        task.slot = -1
