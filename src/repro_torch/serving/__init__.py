"""Paged-KV continuous-batching serving: ``paged_cache`` (page
allocator, floating page pool and identity rows), ``scheduler`` (FIFO
admission, retirement, TTFT/TPOT, SLO policy, the speculative accept
rate), ``spec`` (draft sources) and ``engine``."""

from .engine import Engine, greedy_sample, prepare_weights
from .paged_cache import (
    PAGE_SIZE,
    BlockTable,
    FloatingPageCache,
    PageAllocator,
    PagedKVCache,
    PagedCacheError,
    PageExhausted,
    SlotCapacityExceeded,
    page_keys,
)
from .scheduler import Request, RequestState, Scheduler, SLOTargets
from .spec import DraftSource, ModelDraft, NgramDraft

__all__ = [
    "Engine", "greedy_sample", "prepare_weights", "PAGE_SIZE",
    "BlockTable", "FloatingPageCache", "PageAllocator", "PagedKVCache",
    "PagedCacheError",
    "PageExhausted", "SlotCapacityExceeded", "page_keys", "Request",
    "RequestState", "Scheduler", "SLOTargets", "DraftSource", "ModelDraft",
    "NgramDraft",
]
