"""Paged KV cache: host-side block allocator + device-resident pools.

Counterpart of `chitu_tpu/kvcache/paged.py` (reference:
chitu/cache_manager.py:12-225 PagedKVCacheManager). Device state is one
pool tensor per layer group, [L_group, num_pages, page, M], which the
attention kernels and the plain appends update IN PLACE (the JAX pools are
donated and replaced instead). Host state is a free-page list + per-request page
lists, and a slot allocator for per-request device state (the sampling
counts row).

Three page allocators, chosen as in JAX (`PagedKVCache._make_allocator`):
the prefix-caching allocator when `infer.prefix_cache` is on, else the C++
host allocator (`NativeBackedPageAllocator` over `native.py`), else, under
`CHITU_TPU_NATIVE=0` or without `max_slots`, the pure-Python one.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from chitu_tpu_torch.models.common import kv_pool_minor, pad_kv_minor


class PageAllocator:
    """Host-side page bookkeeping (reference: cache_manager.py:88-142)."""

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.free_pages: List[int] = list(range(num_pages - 1, -1, -1))
        self.req_pages: Dict[str, List[int]] = {}

    def num_free(self) -> int:
        return len(self.free_pages)

    def ensure(self, req_id: str, total_tokens: int) -> bool:
        """Grow req's page list to cover `total_tokens`; False if exhausted.
        On failure THIS call's pages roll back — a deferred request must
        not hoard pages it cannot use."""
        pages = self.req_pages.setdefault(req_id, [])
        start = len(pages)
        need = (total_tokens + self.page_size - 1) // self.page_size
        while len(pages) < need:
            if not self.free_pages:
                self._rollback(req_id, pages, start)
                return False
            pages.append(self.free_pages.pop())
        return True

    def _rollback(self, req_id: str, pages: List[int], start: int):
        while len(pages) > start:
            self.free_pages.append(pages.pop())
        if not pages:
            self.req_pages.pop(req_id, None)

    def free(self, req_id: str):
        for p in self.req_pages.pop(req_id, []):
            self.free_pages.append(p)

    def block_table(
        self, req_ids: Sequence[str], max_pages: int
    ) -> np.ndarray:
        """[B, max_pages] int32, -1 padded (consumed by paged_flat_index)."""
        bt = np.full((len(req_ids), max_pages), -1, dtype=np.int32)
        for i, rid in enumerate(req_ids):
            pages = self.req_pages.get(rid, [])
            bt[i, : len(pages)] = pages[:max_pages]
        return bt


class PrefixCachingAllocator(PageAllocator):
    """Page-granular automatic prefix caching (additive over the
    reference, whose PrefixAlign scheduler only *sorts* by shared prefix,
    scheduler.py:275-309 — it never reuses KV).

    Full pages of a finished prompt are published under a rolling
    hash chain; a new request whose prompt starts with the same token
    pages attaches those pages read-only and prefills only the tail.
    Sharing is sound because decode writes always land at positions
    beyond the prompt, and the page holding the prompt's final token is
    never shared (lookup caps at len-1), so shared pages are immutable.

    Refcount invariant: a cached page holds 1 cache ref + 1 per attached
    request; pages at exactly 1 ref (cache only) sit in an LRU and are
    reclaimed on pool pressure.
    """

    def __init__(self, num_pages: int, page_size: int):
        super().__init__(num_pages, page_size)
        # chain hash -> (page id, this page's token tuple, parent page id)
        # — the tokens + parent linkage are VERIFIED on every hit, so a
        # hash collision (accidental or crafted) can never attach another
        # prompt's KV pages (the vLLM hash-sharing lesson: content-check
        # on hit, never trust the hash alone)
        self.entries: Dict[int, tuple] = {}
        self.page_hash: Dict[int, int] = {}  # page id -> chain hash
        self.refcount: Dict[int, int] = {}  # shared page id -> refs
        self.lru = OrderedDict()  # chain hash -> None (evictable)
        self.hits = 0  # pages served from cache
        self.misses = 0  # full prompt pages computed fresh

    def _chain(self, tokens: Sequence[int]):
        """Rolling hashes of the full prompt pages eligible for sharing
        (the page holding the last prompt token stays private)."""
        ps = self.page_size
        n_full = max(0, (len(tokens) - 1)) // ps
        h, out = 0, []
        for i in range(n_full):
            h = hash((h, tuple(tokens[i * ps : (i + 1) * ps])))
            out.append(h)
        return out

    def lookup(self, req_id: str, tokens: Sequence[int]) -> int:
        """Attach the longest cached prefix; returns its token count.
        Idempotent per request (no-op once pages are attached)."""
        if self.req_pages.get(req_id):
            return 0
        ps = self.page_size
        pages = []
        chain = self._chain(tokens)
        for i, h in enumerate(chain):
            e = self.entries.get(h)
            if e is None:
                break
            p, page_toks, parent = e
            # content + linkage verification (see __init__ note)
            if page_toks != tuple(tokens[i * ps : (i + 1) * ps]):
                break
            if parent != (pages[i - 1] if i else -1):
                break
            pages.append(p)
        for p in pages:
            self.refcount[p] += 1
            self.lru.pop(self.page_hash[p], None)
        self.hits += len(pages)
        self.misses += len(chain) - len(pages)
        if pages:
            self.req_pages[req_id] = list(pages)
        return len(pages) * self.page_size

    def register(self, req_id: str, tokens: Sequence[int]):
        """Publish a prefilled prompt's full pages for future sharing."""
        ps = self.page_size
        pages = self.req_pages.get(req_id, [])
        for i, h in enumerate(self._chain(tokens)):
            if i >= len(pages):
                break
            p = pages[i]
            if h in self.entries:
                # already published (we attached it, or a twin prompt won
                # the race with a different private page) — leave ours be
                continue
            if p in self.page_hash:
                continue  # page already published under another chain
            self.entries[h] = (
                p,
                tuple(tokens[i * ps : (i + 1) * ps]),
                pages[i - 1] if i else -1,
            )
            self.page_hash[p] = h
            # cache ref + this request's ref
            self.refcount[p] = self.refcount.get(p, 1) + 1

    def ensure(self, req_id: str, total_tokens: int) -> bool:
        pages = self.req_pages.setdefault(req_id, [])
        start = len(pages)
        need = (total_tokens + self.page_size - 1) // self.page_size
        while len(pages) < need:
            if not self.free_pages and not self._evict_one():
                # roll back THIS call's pages only: they are always fresh
                # pops from free_pages (shared attachments happen in
                # lookup), so plain return is refcount-safe
                self._rollback(req_id, pages, start)
                return False
            pages.append(self.free_pages.pop())
        return True

    def num_free(self) -> int:
        return len(self.free_pages) + len(self.lru)

    def _evict_one(self) -> bool:
        while self.lru:
            h, _ = self.lru.popitem(last=False)
            p = self.entries.pop(h)[0]
            self.page_hash.pop(p, None)
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self.refcount.pop(p)
                self.free_pages.append(p)
                return True
            # defensively skip a still-attached entry (invariant says LRU
            # holds cache-only pages, but never wedge the pool on a bug)
        return False

    def free(self, req_id: str):
        for p in self.req_pages.pop(req_id, []):
            if p in self.refcount:
                self.refcount[p] -= 1
                if self.refcount[p] == 1 and p in self.page_hash:
                    self.lru[self.page_hash[p]] = None  # evictable
                elif self.refcount[p] == 0:
                    self.refcount.pop(p)
                    self.free_pages.append(p)
            else:
                self.free_pages.append(p)


class NativeBackedPageAllocator:
    """PageAllocator-compatible facade over the C++ host runtime
    (chitu_tpu_torch/native.py). Request-id strings map to bounded integer
    handles (only resident requests hold pages, so max_slots = max_reqs
    bounds live handles)."""

    def __init__(self, num_pages: int, page_size: int, max_slots: int):
        from chitu_tpu_torch.native import NativePageAllocator

        self.num_pages = num_pages
        self.page_size = page_size
        self.native = NativePageAllocator(num_pages, page_size, max_slots)
        self._free_handles: List[int] = list(range(max_slots - 1, -1, -1))
        self._handle: Dict[str, int] = {}

    def num_free(self) -> int:
        return self.native.num_free()

    def ensure(self, req_id: str, total_tokens: int) -> bool:
        h = self._handle.get(req_id)
        fresh = h is None
        if fresh:
            if not self._free_handles:
                return False
            h = self._free_handles.pop()
            self._handle[req_id] = h
        ok = self.native.ensure(h, total_tokens)
        if not ok and fresh:
            # a deferred request must not retain a handle (or any pages a
            # partial native grow acquired) — handles would exhaust under
            # sustained overload and block admission even with pages free
            self.native.release(h)
            self._free_handles.append(self._handle.pop(req_id))
        return ok

    def free(self, req_id: str):
        h = self._handle.pop(req_id, None)
        if h is not None:
            self.native.release(h)
            self._free_handles.append(h)

    def block_table(self, req_ids: Sequence[str], max_pages: int) -> np.ndarray:
        slots = [self._handle.get(r, -1) for r in req_ids]
        return self.native.block_table(slots, max_pages)


class NopAllocator:
    """Everything maps to page 0; never exhausts (cache_type=nop,
    reference: cache_manager.py:655-732 — perf debugging only)."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.num_pages = 1

    def num_free(self) -> int:
        return 1 << 30

    def ensure(self, req_id: str, total_tokens: int) -> bool:
        return True

    def free(self, req_id: str):
        pass

    def block_table(self, req_ids: Sequence[str], max_pages: int) -> np.ndarray:
        bt = np.full((len(req_ids), max_pages), -1, dtype=np.int32)
        bt[:, 0] = 0
        return bt


class SlotAllocator:
    """Fixed slots for per-request device-resident state (sampling counts;
    reference spirit: cache_manager.py:471-487)."""

    def __init__(self, max_slots: int):
        self.max_slots = max_slots
        self.free: List[int] = list(range(max_slots - 1, -1, -1))
        self.by_req: Dict[str, int] = {}

    def alloc(self, req_id: str) -> Optional[int]:
        if req_id in self.by_req:
            return self.by_req[req_id]
        if not self.free:
            return None
        s = self.free.pop()
        self.by_req[req_id] = s
        return s

    def release(self, req_id: str):
        s = self.by_req.pop(req_id, None)
        if s is not None:
            self.free.append(s)


class PagedKVCache:
    """Device pools + allocator for one model.

    Pool layout: [L, num_pages, page, M], bf16, or int8 holding fp8-e4m3
    bits (`infer.kv_dtype=fp8`: `models.common.kv_encode`). Split K/V rows
    (GQA/MHA, and DeepSeek's dense MLA with V padded to the K head size):
    M = pad128(2*KV*D), K-half then V-half (ops/attention.pack_kv). The MLA
    merged latent row, where `kv_heads == 0`: M = pad128(kv_dim) (640 lanes
    for kv_dim 576, as in the JAX pool, so pool bytes compare directly).
    `layer_groups` ({name: layers}) gives one pool array per group (the
    DeepSeek dense-first and MoE stacks: `kv_dense`, `kv_moe`); without it
    there is one array, `kv`. Every group shares the page allocator.
    `max_slots` (the engine's `infer.max_reqs`) bounds the native
    allocator's request handles; `prefix_cache` picks the prefix-caching
    allocator (`_make_allocator`).

    The ring KV pool (`ring` = dp > 1, `infer.ring_kv`): the allocator
    hands out global page ids 0..num_pages-1, the same on every rank of
    the world (every rank runs the same schedule), and global page g
    lives on replica g // P_local at local index g % P_local of that
    replica's arrays, which hold P_local = num_pages / ring pages
    (`ops/attention_ring.ring_local_block_table`). Prefix sharing stays
    page-granular on the global ids.
    """

    def __init__(
        self,
        n_layers: int,
        num_pages: int,
        page_size: int,
        kv_heads: int,
        head_dim: int,
        dtype=torch.bfloat16,
        device=None,
        kv_dim: int = 0,
        layer_groups: Optional[Dict[str, int]] = None,
        max_slots: int = 0,
        prefix_cache: bool = False,
        ring: int = 1,
    ):
        if num_pages % ring:
            raise ValueError(f"{num_pages} pages do not stripe over {ring} ranks")
        self.n_layers = n_layers
        self.num_pages = num_pages
        self.ring = ring
        self.local_pages = num_pages // ring
        self.page_size = page_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.merged = kv_heads == 0
        self.allocator = self._make_allocator(
            num_pages, page_size, max_slots, prefix_cache
        )
        self.minor = (
            pad_kv_minor(1, kv_dim)
            if self.merged
            else kv_pool_minor(kv_heads, head_dim)
        )
        groups = layer_groups or {"kv": n_layers}
        self.arrays = {
            name: torch.zeros(
                (n, self.local_pages, page_size, self.minor), dtype=dtype,
                device=device,
            )
            for name, n in groups.items()
        }

    @staticmethod
    def _make_allocator(
        num_pages: int,
        page_size: int,
        max_slots: int,
        prefix_cache: bool = False,
    ):
        """The prefix-caching allocator when asked for; else the native
        C++ allocator when the engine gives `max_slots` (its build raises
        on failure; env CHITU_TPU_NATIVE=0 picks the Python allocator,
        which also serves without `max_slots`)."""
        if prefix_cache:
            return PrefixCachingAllocator(num_pages, page_size)
        if max_slots > 0 and os.environ.get("CHITU_TPU_NATIVE", "1") != "0":
            return NativeBackedPageAllocator(num_pages, page_size, max_slots)
        return PageAllocator(num_pages, page_size)

    def bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays.values())

    @staticmethod
    def num_pages_for(max_reqs: int, max_seq_len: int, page_size: int) -> int:
        """Pool sizing (reference: cache_manager.py:32-33)."""
        per_req = max_seq_len // page_size + 1
        return per_req * max_reqs
