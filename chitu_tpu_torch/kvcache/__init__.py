from chitu_tpu_torch.kvcache.paged import (
    NopAllocator,
    PageAllocator,
    PagedKVCache,
    SlotAllocator,
)
