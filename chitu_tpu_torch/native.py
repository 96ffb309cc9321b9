"""ctypes bindings for the native host runtime (csrc/hostops.cpp).

Counterpart of `chitu_tpu/native.py` (reference: csrc/binding.cpp,
setup.py:17-29 build the native layer as a CUDAExtension pybind module).
The host-side pieces (page allocator + block-table assembly) are a plain
C ABI library, the port's own copy of the source, built at first use with
g++ (`ops/cuda_build.build_host`) and loaded through ctypes. Unlike the
JAX package, a failed build raises: only `CHITU_TPU_NATIVE=0` selects the
pure-Python allocator (`kvcache.PagedKVCache._make_allocator`).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np

from chitu_tpu_torch.ops import cuda_build

_lib = None
_lib_lock = threading.Lock()

_I32 = ctypes.c_int32
_P_I32 = ctypes.POINTER(ctypes.c_int32)


def _load() -> ctypes.CDLL:
    """The hostops library, built now if missing (raises on failure)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(cuda_build.build_host("hostops"))
        lib.chitu_alloc_create.restype = ctypes.c_void_p
        lib.chitu_alloc_create.argtypes = [_I32] * 3
        lib.chitu_alloc_destroy.argtypes = [ctypes.c_void_p]
        lib.chitu_alloc_num_free.restype = _I32
        lib.chitu_alloc_num_free.argtypes = [ctypes.c_void_p]
        lib.chitu_alloc_ensure.restype = _I32
        lib.chitu_alloc_ensure.argtypes = [ctypes.c_void_p, _I32, _I32]
        lib.chitu_alloc_release.argtypes = [ctypes.c_void_p, _I32]
        lib.chitu_alloc_pages_of.restype = _I32
        lib.chitu_alloc_pages_of.argtypes = [ctypes.c_void_p, _I32]
        lib.chitu_alloc_block_table.argtypes = [
            ctypes.c_void_p, _P_I32, _I32, _I32, _P_I32,
        ]
        _lib = lib
        return _lib


class NativePageAllocator:
    """Slot-keyed page allocator backed by the C++ library.

    Same contract as kvcache.PageAllocator but keyed by integer slot ids
    (the executor's residency slots) instead of request-id strings.
    """

    def __init__(self, num_pages: int, page_size: int, max_slots: int):
        self._lib = _load()
        self._h = self._lib.chitu_alloc_create(num_pages, page_size, max_slots)
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_slots = max_slots

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.chitu_alloc_destroy(h)
            self._h = None

    def num_free(self) -> int:
        return self._lib.chitu_alloc_num_free(self._h)

    def ensure(self, slot: int, total_tokens: int) -> bool:
        return bool(self._lib.chitu_alloc_ensure(self._h, slot, total_tokens))

    def release(self, slot: int):
        self._lib.chitu_alloc_release(self._h, slot)

    def pages_of(self, slot: int) -> int:
        return self._lib.chitu_alloc_pages_of(self._h, slot)

    def block_table(self, slots: Sequence[int], max_pages: int) -> np.ndarray:
        slots_arr = np.ascontiguousarray(slots, dtype=np.int32)
        out = np.empty((len(slots_arr), max_pages), dtype=np.int32)
        self._lib.chitu_alloc_block_table(
            self._h, slots_arr.ctypes.data_as(_P_I32), len(slots_arr),
            max_pages, out.ctypes.data_as(_P_I32),
        )
        return out
