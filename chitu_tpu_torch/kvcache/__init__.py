from chitu_tpu_torch.kvcache.paged import (
    NativeBackedPageAllocator,
    NopAllocator,
    PageAllocator,
    PagedKVCache,
    PrefixCachingAllocator,
    SlotAllocator,
)
