// Native host runtime: KV page allocator + block-table assembly.
//
// The counterpart of the reference's native runtime layer (reference:
// the host-side free_blocks bookkeeping in chitu/cache_manager.py:88-142)
// and a copy of the JAX package's csrc/hostops.cpp. MoE token alignment
// runs on the device (models/moe.py), so the native layer owns what
// remains on the host hot path: per-window page allocation and
// block-table assembly for every scheduled batch.
//
// Exposed as a plain C ABI consumed through ctypes
// (chitu_tpu_torch/native.py); no pybind11 dependency.
//
// Requests are keyed by their engine slot id (0..max_slots-1), matching
// the executor's SlotAllocator residency model.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Allocator {
  int32_t num_pages;
  int32_t page_size;
  std::vector<int32_t> free_pages;           // stack of free page ids
  std::vector<std::vector<int32_t>> pages;   // per-slot page lists
};

}  // namespace

extern "C" {

void* chitu_alloc_create(int32_t num_pages, int32_t page_size,
                         int32_t max_slots) {
  auto* a = new Allocator();
  a->num_pages = num_pages;
  a->page_size = page_size;
  a->free_pages.reserve(num_pages);
  for (int32_t p = num_pages - 1; p >= 0; --p) a->free_pages.push_back(p);
  a->pages.resize(max_slots);
  return a;
}

void chitu_alloc_destroy(void* h) { delete static_cast<Allocator*>(h); }

int32_t chitu_alloc_num_free(void* h) {
  return static_cast<int32_t>(static_cast<Allocator*>(h)->free_pages.size());
}

namespace {
inline bool slot_ok(const Allocator* a, int32_t slot) {
  // out-of-range slots must fail cleanly, not index past the vector
  // (the python facade passes caller-supplied handles)
  return slot >= 0 && slot < static_cast<int32_t>(a->pages.size());
}
}  // namespace

// Grow slot's page list to cover total_tokens. Returns 1 on success,
// 0 when the pool is exhausted — THIS call's pages roll back so a
// deferred request never hoards pages it cannot use (matching the
// python allocator's rollback).
int32_t chitu_alloc_ensure(void* h, int32_t slot, int32_t total_tokens) {
  auto* a = static_cast<Allocator*>(h);
  if (!slot_ok(a, slot)) return 0;
  auto& pages = a->pages[slot];
  const size_t start = pages.size();
  int32_t need = (total_tokens + a->page_size - 1) / a->page_size;
  while (static_cast<int32_t>(pages.size()) < need) {
    if (a->free_pages.empty()) {
      while (pages.size() > start) {
        a->free_pages.push_back(pages.back());
        pages.pop_back();
      }
      return 0;
    }
    pages.push_back(a->free_pages.back());
    a->free_pages.pop_back();
  }
  return 1;
}

void chitu_alloc_release(void* h, int32_t slot) {
  auto* a = static_cast<Allocator*>(h);
  if (!slot_ok(a, slot)) return;
  auto& pages = a->pages[slot];
  for (int32_t p : pages) a->free_pages.push_back(p);
  pages.clear();
}

int32_t chitu_alloc_pages_of(void* h, int32_t slot) {
  auto* a = static_cast<Allocator*>(h);
  if (!slot_ok(a, slot)) return 0;
  return static_cast<int32_t>(a->pages[slot].size());
}

// Fill out[n][max_pages] (int32, row-major) with the slots' page lists,
// -1 padded — the decode window's block-table assembly.
void chitu_alloc_block_table(void* h, const int32_t* slots, int32_t n,
                             int32_t max_pages, int32_t* out) {
  auto* a = static_cast<Allocator*>(h);
  for (int32_t i = 0; i < n; ++i) {
    int32_t* row = out + static_cast<int64_t>(i) * max_pages;
    const int32_t slot = slots[i];
    if (slot < 0 || slot >= static_cast<int32_t>(a->pages.size())) {
      for (int32_t j = 0; j < max_pages; ++j) row[j] = -1;
      continue;
    }
    const auto& pages = a->pages[slot];
    const int32_t k =
        std::min<int32_t>(static_cast<int32_t>(pages.size()), max_pages);
    std::memcpy(row, pages.data(), sizeof(int32_t) * k);
    for (int32_t j = k; j < max_pages; ++j) row[j] = -1;
  }
}

}  // extern "C"
