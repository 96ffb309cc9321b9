"""Paged KV cache: host-side block allocator + device-resident pools.

Counterpart of `chitu_tpu/kvcache/paged.py` (reference:
chitu/cache_manager.py:12-225 PagedKVCacheManager). Device state is one
pool tensor per layer group, [L_group, num_pages, page, M], which the
attention kernels and the plain appends update IN PLACE (the JAX pools are
donated and replaced instead). Host state is a free-page list + per-request page
lists, and a slot allocator for per-request device state (the sampling
counts row).

The C++ host allocator (`NativeBackedPageAllocator`) and the prefix-
caching allocator are not ported yet; the pure-Python allocator serves.
"""

from __future__ import annotations

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
    ):
        self.n_layers = n_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.merged = kv_heads == 0
        self.allocator = PageAllocator(num_pages, page_size)
        self.minor = (
            pad_kv_minor(1, kv_dim)
            if self.merged
            else kv_pool_minor(kv_heads, head_dim)
        )
        groups = layer_groups or {"kv": n_layers}
        self.arrays = {
            name: torch.zeros(
                (n, num_pages, page_size, self.minor), dtype=dtype,
                device=device,
            )
            for name, n in groups.items()
        }

    def bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays.values())

    @staticmethod
    def num_pages_for(max_reqs: int, max_seq_len: int, page_size: int) -> int:
        """Pool sizing (reference: cache_manager.py:32-33)."""
        per_req = max_seq_len // page_size + 1
        return per_req * max_reqs
