"""Paged KV cache (counterpart of ``repro.serving.paged_cache``): the
page allocator and the two device-cache placements it governs.

``PageAllocator`` is host bookkeeping, copied from the reference: a
free list of fixed-size pages with refcounts, reservation- or
usage-based admission, and the prefix-hash map (chained page keys,
first-writer-wins, LRU eviction of refcount-0 hashed pages).

``PagedKVCache`` (identity placement) keeps per-slot contiguous rows
``(L, B, KV, C, Dh)`` (MLA's latent cache: ``(L, B, C, kv_lora)`` and
``(L, B, C, q_rope)``), the block tables being accounting over an
identity mapping.  It serves what the floating pool cannot (windowed
rings: C = the window < max_len; MLA's latent cache, which has no page
structure) and ``REPRO_PAGED_PLACEMENT=identity``.
Where the reference concatenates a row onto its stacked tree on every
admission, the port allocates ``num_slots`` rows once and moves rows in
place, in the reference's row order (a new row at the end, a retired
row swapped with the last).

``FloatingPageCache`` (float placement, the default) holds one global
page pool per segment, ``(L, P+1, KV, T, Dh)`` payloads (+ ``(L, P+1,
KV, T)`` scales), shared by every slot; per-slot state is the host
block tables, stamped into the device ``idx (B,)`` / ``block_table (B,
NP)`` tensors before every step.  Admission, retirement and refill are
host-list surgery; a whole-prompt prefill's pages are scattered into the
pool (``_pool_insert``).

Every device tensor is written in place, on the current stream (the
reference's jitted helpers return new arrays instead): a copy-on-write
page copy (``_copy_page``) and a swap-in land before the next step
reads the page.  Preemption swaps a victim's live pages to the host
(``swap_out``: one indexed gather and one device-to-host copy per pool
tensor, payloads and scales bit for bit) and back (``swap_in``); a
prompt's full pages are published to the prefix-hash map at attach
(``register_prompt``).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.models.attention import _bytes, cache_len
from repro_torch.models.transformer import (
    cache_idx,
    cache_nodes,
    cache_payloads,
    init_caches,
    init_paged_pools,
    map_payloads,
    paged_decode_supported,
    with_idx,
)

PAGE_SIZE = 16

_HASH_ROOT = "moss-prefix-root"


class PagedCacheError(RuntimeError):
    pass


class PageExhausted(PagedCacheError):
    """The page pool cannot cover the requested reservation —
    admission-time backpressure (the scheduler keeps the request
    queued instead of corrupting a resident slot)."""


class SlotCapacityExceeded(PagedCacheError):
    """A sequence would outgrow its slot's ring capacity C on a
    non-windowed arch — writing on would wrap the ring and silently
    clobber live positions, so this raises *before* corruption."""


def pages_for(n_tokens: int, page_size: int) -> int:
    return -(-max(n_tokens, 0) // page_size)


def page_keys(tokens, page_size: int) -> list:
    """Chained page-aligned prefix keys of a prompt: ``keys[j]``
    identifies tokens [0, (j+1)*page_size) — page content AND its
    whole prefix — so a block-table hit on key j is only possible
    when every earlier page matched too.  Only full pages get keys
    (``len(keys) == len(tokens) // page_size``)."""
    toks = np.asarray(tokens)
    keys, prev = [], _HASH_ROOT
    for j in range(len(toks) // page_size):
        chunk = tuple(int(t) for t in toks[j * page_size:
                                           (j + 1) * page_size])
        prev = hash((prev, chunk))
        keys.append(prev)
    return keys


@dataclasses.dataclass
class BlockTable:
    """One slot's logical->physical page map.  ``pages[j]`` is the
    physical page id backing tokens [j*page_size, (j+1)*page_size);
    the leading ``shared0`` entries were mapped from prefix-hash hits
    (refcounted, not owned), the rest are private.  ``reserved`` is
    the worst-case PRIVATE page count admission committed to and
    ``private`` how many of those have materialized — the allocator
    asserts ``private <= reserved`` (reservation-overrun guard)."""
    owner: int
    pages: list[int] = dataclasses.field(default_factory=list)
    reserved: int = 0
    private: int = 0
    shared0: int = 0


class PageAllocator:
    """Free-list + refcount page-pool accounting with
    reservation-based admission and prefix-hash sharing (see module
    docstring)."""

    def __init__(self, num_pages: int, page_size: int = PAGE_SIZE,
                 slot_tokens: int | None = None,
                 usage_mode: bool = False):
        assert num_pages > 0 and page_size > 0
        self.num_pages = num_pages
        self.page_size = page_size
        # per-slot ring capacity in tokens; None = unbounded rows
        self.slot_tokens = slot_tokens
        # usage-based admission (Scheduler v2, docs/continuous-
        # batching.md): admission reserves actual usage + small
        # headroom instead of the worst case, and a request that
        # outgrows its reservation EXTENDS it page by page —
        # ``PageExhausted`` on extension is the engine's preemption
        # trigger, not corruption.  False keeps the v1 invariant:
        # outgrowing a reservation is an accounting bug.
        self.usage_mode = usage_mode
        self._free = list(range(num_pages - 1, -1, -1))
        self._refcount = [0] * num_pages
        # refcount-0 pages kept addressable for prefix hits, oldest
        # first (LRU eviction order)
        self._evictable: OrderedDict[int, None] = OrderedDict()
        self._hash_to_page: dict = {}
        self._page_hash: dict[int, object] = {}
        self._tables: dict[int, BlockTable] = {}
        # sum over residents of (reserved - private): pages promised
        # but not yet materialized — the admission headroom term
        self._outstanding = 0
        self.peak_used = 0
        # hashed refcount-0 pages reclaimed (prefix entries dropped)
        self.evictions = 0

    # -- introspection -------------------------------------------------
    @property
    def free_pages(self) -> int:
        """Allocatable pages: the free list plus the evictable
        (refcount-0 hashed) set."""
        return len(self._free) + len(self._evictable)

    @property
    def cached_pages(self) -> int:
        """Refcount-0 pages retained only for future prefix hits."""
        return len(self._evictable)

    @property
    def committed_pages(self) -> int:
        return sum(bt.reserved for bt in self._tables.values())

    def refcount(self, page: int) -> int:
        return self._refcount[page]

    def table(self, owner: int) -> BlockTable:
        return self._tables[owner]

    def _clamp(self, n_tokens: int) -> int:
        if self.slot_tokens is None:
            return n_tokens
        return min(n_tokens, self.slot_tokens)

    def pages_needed(self, n_tokens: int) -> int:
        return pages_for(self._clamp(n_tokens), self.page_size)

    def _note_used(self) -> None:
        self.peak_used = max(self.peak_used,
                             self.num_pages - self.free_pages)

    # -- prefix hash map -----------------------------------------------
    def lookup(self, keys: list) -> list[int]:
        """Longest registered prefix run: physical pages for
        ``keys[0..k)`` where k is the first miss."""
        pages = []
        for key in keys:
            page = self._hash_to_page.get(key)
            if page is None:
                break
            pages.append(page)
        return pages

    def register_hash(self, page: int, key) -> bool:
        """Publish ``page`` as the backing of prefix ``key``.
        First-writer-wins: an already-taken key or an already-hashed
        page is left alone (returns False)."""
        if key in self._hash_to_page or page in self._page_hash:
            return False
        self._hash_to_page[key] = page
        self._page_hash[page] = key
        return True

    # -- refcount plumbing ---------------------------------------------
    def _ref(self, page: int) -> None:
        if self._refcount[page] == 0:
            # revive from the evictable set (hash entry survives)
            self._evictable.pop(page)
        self._refcount[page] += 1

    def _unref(self, page: int) -> None:
        assert self._refcount[page] > 0, \
            f"double-free of page {page}"
        self._refcount[page] -= 1
        if self._refcount[page] == 0:
            if page in self._page_hash:
                self._evictable[page] = None     # newest at the end
            else:
                self._free.append(page)

    def _drop_hash(self, page: int) -> None:
        key = self._page_hash.pop(page, None)
        if key is not None:
            del self._hash_to_page[key]

    def _alloc_page(self) -> int:
        if self._free:
            page = self._free.pop()
        elif self._evictable:
            # reclaim the least-recently-parked hashed page: its
            # prefix entry dies with it
            page, _ = self._evictable.popitem(last=False)
            self._drop_hash(page)
            self.evictions += 1
        else:
            raise PageExhausted("page pool empty")
        self._refcount[page] = 1
        self._note_used()
        return page

    def _alloc_private(self, bt: BlockTable) -> int:
        if bt.private == bt.reserved:
            # usage mode: the request outgrew its usage-based
            # reservation — extend it one page IF every outstanding
            # promise (plus this one) is still coverable; otherwise
            # raise so the engine can preempt a victim and retry.
            assert self.usage_mode, \
                (f"owner {bt.owner}: private page {bt.private + 1} "
                 f"would overrun its reservation of {bt.reserved} "
                 f"(allocator leak / accounting bug)")
            if self._outstanding + 1 > self.free_pages:
                raise PageExhausted(
                    f"owner {bt.owner}: reservation extension needs 1 "
                    f"page but {self._outstanding} outstanding promises "
                    f"already cover the {self.free_pages} allocatable "
                    f"pages (preempt to proceed)")
            bt.reserved += 1
            self._outstanding += 1
        page = self._alloc_page()
        bt.private += 1
        self._outstanding -= 1
        return page

    # -- lifecycle -----------------------------------------------------
    def _reservation(self, total_tokens: int, n_shared: int,
                     cow_slack: int) -> int:
        return max(self.pages_needed(total_tokens) - n_shared, 0) \
            + cow_slack

    def _revive_cost(self, shared) -> int:
        # shared pages currently parked evictable leave the free pool
        # on admit without consuming any reservation
        return sum(1 for p in shared if self._refcount[p] == 0)

    def can_admit(self, total_tokens: int, shared=(),
                  cow_slack: int = 0) -> bool:
        """Whether a request whose lifetime resident size is
        ``total_tokens`` (of which ``len(shared)`` pages arrive via
        prefix hits) fits: every outstanding promise plus this
        request's private reservation plus the revival of its shared
        pages must be covered by allocatable pages."""
        need = self._reservation(total_tokens, len(shared), cow_slack)
        return (self._outstanding + need + self._revive_cost(shared)
                <= self.free_pages)

    def admit(self, owner: int, prompt_tokens: int, total_tokens: int,
              shared=(), cow_slack: int = 0) -> BlockTable:
        """Reserve the request's worst-case private pages, map the
        shared prefix pages (refcounted) and allocate the remaining
        prompt pages now.  Raises ``PageExhausted`` when the pool
        cannot cover the reservation."""
        assert owner not in self._tables, f"owner {owner} already resident"
        need = self._reservation(total_tokens, len(shared), cow_slack)
        if (self._outstanding + need + self._revive_cost(shared)
                > self.free_pages):
            raise PageExhausted(
                f"reservation of {need} private pages for owner "
                f"{owner} exceeds the pool ({self.free_pages} "
                f"allocatable, {self._outstanding} outstanding)")
        bt = BlockTable(owner=owner, reserved=need,
                        shared0=len(shared))
        for page in shared:
            self._ref(page)
            bt.pages.append(page)
        self._note_used()
        self._tables[owner] = bt
        self._outstanding += need
        self._grow_to(bt, self.pages_needed(prompt_tokens))
        return bt

    def grow(self, owner: int, resident_tokens: int) -> None:
        """Back ``resident_tokens`` with physical pages.  Raises
        ``SlotCapacityExceeded`` past the slot ring and
        ``PageExhausted`` if growth outruns the reservation into an
        empty pool (impossible under reservation-based admission —
        kept as the corruption guard for direct callers)."""
        if (self.slot_tokens is not None
                and resident_tokens > self.slot_tokens):
            raise SlotCapacityExceeded(
                f"owner {owner}: {resident_tokens} tokens > slot ring "
                f"capacity {self.slot_tokens} (ring wrap would clobber "
                f"live positions)")
        self._grow_to(self._tables[owner],
                      self.pages_needed(resident_tokens))

    def _grow_to(self, bt: BlockTable, n_pages: int) -> None:
        while len(bt.pages) < n_pages:
            bt.pages.append(self._alloc_private(bt))

    def ensure_writable(self, owner: int,
                        page_idx: int) -> tuple[str, int, int]:
        """Make logical page ``page_idx`` of ``owner`` safe to write:

          "fresh"  page_idx was one past the frontier — a private
                   page was allocated and appended
          "ok"     the page is private (rc==1, unhashed): in-place
                   writes are safe
          "cow"    the page was shared (rc>1) OR hash-registered: a
                   private copy was allocated and the table entry
                   repointed — the caller must device-copy
                   old -> new before the write lands

        Returns ``(kind, old_page, new_page)`` (equal except "cow").
        Hash-registered pages CoW even at rc==1: their bytes are
        advertised to future prefix hits and must stay pristine."""
        bt = self._tables[owner]
        if page_idx == len(bt.pages):
            page = self._alloc_private(bt)
            bt.pages.append(page)
            return ("fresh", page, page)
        old = bt.pages[page_idx]
        if self._refcount[old] > 1 or old in self._page_hash:
            new = self._alloc_private(bt)
            bt.pages[page_idx] = new
            self._unref(old)
            return ("cow", old, new)
        return ("ok", old, old)

    def release(self, owner: int) -> int:
        """Unreference a retired request's pages and drop its
        remaining reservation; returns the number of pages the table
        held (shared pages may stay alive under other owners)."""
        bt = self._tables.pop(owner)
        for page in bt.pages:
            self._unref(page)
        self._outstanding -= bt.reserved - bt.private
        return len(bt.pages)


# ---------------------------------------------------------------------------
# Identity-placement row moves.  Stacked payloads are (L, B, ...) with the
# slot row at dim 1; one idx (B,) serves every layer.  A one-row prefill
# cache is (L, 1, ...) with a scalar idx, a staging row's idx is (1,).
# A segment's cache is a KVCache (k, v and their scales), an MLACache
# (c_kv, k_rope), an RGLRUState (h, conv), an RWKVState (x_tm, x_cm, S)
# or a griffin unit's tuple of them, whose nodes share one idx: every
# payload moves alike.
# ---------------------------------------------------------------------------


def _leaves(c):
    return [t for n in cache_nodes(c)
            for t in (getattr(n, f) for f in cache_payloads(n))
            if t is not None]


def write_row(big: dict, one: dict, row: int, length: int) -> None:
    """Copy a one-row cache into row ``row`` of the stacked caches, in
    place, and stamp that row's depth to ``length``: a prompt right-padded
    to a bucket arrives with its padded length, and the true one makes
    the validity mask hide the padding (the reference's ``_stamp_idx``).
    Every other row keeps its depth.  (The reference's ``_first_row`` and
    ``_append_row`` are this at the next free row.)"""
    for name, c in one.items():
        dst = big[name]
        for a, o in zip(_leaves(dst), _leaves(c)):
            _bytes(a)[:, row] = _bytes(o[:, 0].to(a.dtype))
        cache_idx(dst)[row] = length


def _swap_shrink(big: dict, row: int, last: int) -> None:
    """Move row ``last`` into ``row`` (retiring a finished slot from the
    decode batch; the caller drops the last row)."""
    if row == last:
        return
    for c in big.values():
        for a in _leaves(c):
            _bytes(a)[:, row] = _bytes(a)[:, last]
        idx = cache_idx(c)
        idx[row] = idx[last]


class PagedKVCache:
    """Identity-placement device cache: per-slot contiguous rows and
    lengths, governed by a ``PageAllocator`` (see module docstring).
    ``rows[i]`` is the owner id (request rid) resident in device row i,
    or None for a released row awaiting refill or shrink within an
    engine step.  ``caches`` is the first ``len(rows)`` rows of the
    preallocated store, as views."""

    def __init__(self, cfg, max_len: int, num_slots: int,
                 page_size: int = PAGE_SIZE,
                 num_pages: int | None = None, device="cuda"):
        self.cfg = cfg
        self.max_len = max_len
        self.num_slots = num_slots
        self.page_size = page_size
        self.device = torch.device(device)
        self.slot_tokens = cache_len(cfg, max_len)    # ring capacity C
        self.ring = self.slot_tokens < max_len        # window arch
        if num_pages is None:
            num_pages = num_slots * pages_for(self.slot_tokens, page_size)
        self.allocator = PageAllocator(
            num_pages, page_size,
            # windowed rings wrap by design: growth clamps instead of
            # raising; non-windowed rows raise before corruption
            slot_tokens=None if self.ring else self.slot_tokens)
        self.rows: list[int | None] = []
        self.lengths: list[int] = []
        self._store = init_caches(cfg, num_slots, max_len, per_slot=True,
                                  device=self.device)

    @property
    def caches(self) -> dict | None:
        n = len(self.rows)
        if n == 0:
            return None
        return {name: with_idx(map_payloads(c, lambda t: t[:, :n]),
                               cache_idx(c)[:n])
                for name, c in self._store.items()}

    @caches.setter
    def caches(self, new: dict) -> None:
        # a step wrote its rows in place; keep the depths it advanced
        n = len(self.rows)
        for name, c in new.items():
            cache_idx(self._store[name])[:n] = cache_idx(c)

    # -- admission -----------------------------------------------------
    def _resident(self, n_tokens: int) -> int:
        return min(n_tokens, self.slot_tokens)

    def can_admit(self, total_tokens: int) -> bool:
        """A slot (fresh row or released row awaiting refill) AND a page
        reservation are both available."""
        has_slot = len(self.rows) < self.num_slots or None in self.rows
        return has_slot and self.allocator.can_admit(
            self._resident(total_tokens))

    def append(self, owner: int, one: dict, length: int,
               total_tokens: int) -> int:
        """Admit ``owner`` into a NEW device row from its one-row prefill
        caches; returns the row index."""
        assert len(self.rows) < self.num_slots
        self.allocator.admit(owner, self._resident(length),
                             self._resident(total_tokens))
        write_row(self._store, one, len(self.rows), length)
        self.rows.append(owner)
        self.lengths.append(length)
        return len(self.rows) - 1

    def refill(self, row: int, owner: int, one: dict, length: int,
               total_tokens: int) -> None:
        """Admit ``owner`` into a released row in place."""
        assert self.rows[row] is None, "refill requires a released row"
        self.allocator.admit(owner, self._resident(length),
                             self._resident(total_tokens))
        write_row(self._store, one, row, length)
        self.rows[row] = owner
        self.lengths[row] = length

    # -- chunked-prefill staging (admission / attach split) ------------
    def stage_admit(self, owner: int, total_tokens: int) -> None:
        """Admission only: commit the page reservation while the request
        chunk-prefills into a detached one-row cache."""
        self.allocator.admit(owner, 0, self._resident(total_tokens))

    def stage_attach(self, owner: int, one: dict, length: int) -> int:
        """Attach only: move the finished staging row into the decode
        batch and materialize its page accounting."""
        self.allocator.grow(owner, self._resident(length))
        assert len(self.rows) < self.num_slots
        write_row(self._store, one, len(self.rows), length)
        self.rows.append(owner)
        self.lengths.append(length)
        return len(self.rows) - 1

    # -- retirement ----------------------------------------------------
    def release(self, row: int) -> None:
        """Free the row's pages (request finished).  The row must then be
        ``refill``ed or ``shrink``ed before the next decode."""
        self.allocator.release(self.rows[row])
        self.rows[row] = None

    def shrink(self, row: int) -> None:
        """Drop a released row from the decode batch (swap-with-last)."""
        assert self.rows[row] is None
        last = len(self.rows) - 1
        _swap_shrink(self._store, row, last)
        self.rows[row] = self.rows[last]
        self.lengths[row] = self.lengths[last]
        self.rows.pop()
        self.lengths.pop()

    # -- decode bookkeeping --------------------------------------------
    def advance(self) -> None:
        """Mirror one decode step: every resident row appended one token
        (the device idx advanced inside the step); grow page backing
        across boundaries."""
        for i, owner in enumerate(self.rows):
            assert owner is not None, "decode ran with a released row"
            self.lengths[i] += 1
            self.allocator.grow(owner, self._resident(self.lengths[i]))

    def commit(self, advs) -> None:
        """Mirror one verify step: row i committed ``advs[i]`` tokens
        (accepted drafts and the correction token).  The verify step
        advanced the rows' device idx by the full draft length, so it is
        restamped from the host lengths: that truncates every rejected
        draft at once (its bytes stay, past the depth, masked)."""
        assert len(advs) == len(self.rows)
        for i, owner in enumerate(self.rows):
            assert owner is not None, "verify ran with a released row"
            self.lengths[i] += int(advs[i])
            self.allocator.grow(owner, self._resident(self.lengths[i]))
        depth = torch.tensor(self.lengths, dtype=torch.int32,
                             device=self.device)
        for c in self._store.values():
            cache_idx(c)[:len(self.rows)] = depth


def _pool_insert(pool, one, pages: torch.Tensor, n_new: int) -> None:
    """Scatter the first ``n_new`` pages of a one-row prefill cache into
    physical pool rows ``pages`` ((n_new,) int64), in place.  Payloads:
    pool (L, P, KV, T, ...), one (L, 1, KV, C, ...) with C >= n_new·T;
    padded-bucket positions past the true length ride along and are
    masked by the slot depth."""
    t = pool.k.shape[3]

    def scatter(buf, row):
        r = row[:, 0, :, :n_new * t]
        r = r.reshape(r.shape[0], r.shape[1], n_new, t, *r.shape[3:])
        _bytes(buf)[:, pages] = _bytes(r.movedim(2, 1).to(buf.dtype))

    for buf, row in zip(_leaves(pool), _leaves(one)):
        scatter(buf, row)


class FloatingPageCache:
    """Floating-placement device cache: one global page pool per segment,
    host block tables stamped into the device idx / block-table tensors
    before every step (see module docstring)."""

    def __init__(self, cfg, max_len: int, num_slots: int,
                 page_size: int = PAGE_SIZE,
                 num_pages: int | None = None,
                 usage_mode: bool = False, device="cuda"):
        if not paged_decode_supported(cfg, max_len, page_size):
            raise ValueError((cfg.family, max_len, page_size))
        self.cfg = cfg
        self.max_len = max_len
        self.num_slots = num_slots
        self.page_size = page_size
        self.device = torch.device(device)
        self.slot_tokens = max_len
        self.ring = False
        self.pages_per_slot = self.slot_tokens // page_size
        if num_pages is None:
            num_pages = num_slots * self.pages_per_slot
        self.allocator = PageAllocator(num_pages, page_size,
                                       slot_tokens=self.slot_tokens,
                                       usage_mode=usage_mode)
        self.num_pages = num_pages
        self.cow_copies = 0
        self.rows: list[int | None] = []
        self.lengths: list[int] = []
        # pools are allocated once up front and live for the engine's
        # lifetime; only their idx / block_table stamps change
        self.caches = init_paged_pools(cfg, max_len, num_pages, page_size,
                                       self.device)

    # -- admission -----------------------------------------------------
    def _resident(self, n_tokens: int) -> int:
        return min(n_tokens, self.slot_tokens)

    def can_admit(self, total_tokens: int, shared=(),
                  cow_slack: int = 0) -> bool:
        has_slot = len(self.rows) < self.num_slots or None in self.rows
        return has_slot and self.allocator.can_admit(
            self._resident(total_tokens), shared=shared,
            cow_slack=cow_slack)

    def _copy_page(self, src: int, dst: int) -> None:
        """The device half of copy-on-write: physical page ``src`` ->
        ``dst``, every layer, payloads and scales, in place."""
        for pool in self.caches.values():
            for buf in _leaves(pool):
                b = _bytes(buf)
                b[:, dst] = b[:, src]

    def _ensure_writable(self, owner: int, page_idx: int) -> None:
        kind, src, dst = self.allocator.ensure_writable(owner, page_idx)
        if kind == "cow":
            # a shared or prefix-hashed page: the write lands in a
            # private copy, made before the step that writes it
            self.cow_copies += 1
            self._copy_page(src, dst)

    def _insert(self, owner: int, one: dict) -> None:
        """Scatter a whole-prompt prefill's pages into the pool."""
        pages = self.allocator.table(owner).pages
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        for name, pool in self.caches.items():
            _pool_insert(pool, one[name], idx, len(pages))

    def append(self, owner: int, one: dict, length: int,
               total_tokens: int) -> int:
        """Admit a prefilled request into the pool; its batch position
        is the next host-list slot (the pool has no row dim)."""
        assert len(self.rows) < self.num_slots
        self.allocator.admit(owner, length, self._resident(total_tokens))
        self._insert(owner, one)
        self.rows.append(owner)
        self.lengths.append(length)
        return len(self.rows) - 1

    def refill(self, row: int, owner: int, one: dict, length: int,
               total_tokens: int) -> None:
        assert self.rows[row] is None, "refill requires a released row"
        self.allocator.admit(owner, length, self._resident(total_tokens))
        self._insert(owner, one)
        self.rows[row] = owner
        self.lengths[row] = length

    # -- chunked-prefill staging (admission / attach split) ------------
    def stage_admit(self, owner: int, total_tokens: int, shared=(),
                    cow_slack: int = 0) -> None:
        """Admission only: commit the reservation (and map any shared
        prefix pages) while the request chunk-prefills into the pool."""
        self.allocator.admit(owner, 0, self._resident(total_tokens),
                             shared=shared, cow_slack=cow_slack)

    def stage_ensure(self, owner: int, lo: int, hi: int) -> None:
        """Make every page prompt positions [lo, hi) touch writable
        before a chunk step: fresh pages past the frontier, a
        copy-on-write only for a full hit (the chunk's first page is
        shared or hashed).  May raise ``PageExhausted`` in usage mode
        (the engine's preemption trigger)."""
        t = self.page_size
        for j in range(lo // t, (hi - 1) // t + 1):
            self._ensure_writable(owner, j)

    def _stamp(self, idx: np.ndarray, bt: np.ndarray) -> None:
        idx_t = torch.from_numpy(idx).to(self.device)
        bt_t = torch.from_numpy(bt).to(self.device)
        self.caches = {name: pool._replace(idx=idx_t, block_table=bt_t)
                       for name, pool in self.caches.items()}

    def _table_rows(self, owners) -> np.ndarray:
        # unassigned entries point at the TRASH page (index num_pages)
        bt = np.full((len(owners), self.pages_per_slot), self.num_pages,
                     np.int32)
        for i, owner in enumerate(owners):
            pages = self.allocator.table(owner).pages
            bt[i, :len(pages)] = pages
        return bt

    def stage_stamp(self, owner: int, depth: int) -> None:
        """Stamp the device idx / block table to ONE staging row so a
        (1, chunk) step writes ``owner``'s pages from ``depth``."""
        self._stamp(np.full((1,), depth, np.int32),
                    self._table_rows([owner]))

    def stage_attach(self, owner: int, depth: int) -> int:
        """Attach only: join the decode batch at ``depth``."""
        assert len(self.rows) < self.num_slots
        self.rows.append(owner)
        self.lengths.append(depth)
        return len(self.rows) - 1

    # -- preemption (swap to host) ---------------------------------------
    def swap_out(self, row: int) -> dict:
        """Preempt: copy the row's live pages (those covering [0,
        depth); payloads and scales, every layer, bit for bit) to a host
        store, release them and drop the row from the decode batch.
        Each pool tensor's victim pages move in one indexed gather and
        one device-to-host copy (into pinned memory on the card, issued
        on the current stream, which ``swap_in``'s copy back follows).
        Shared prefix pages are copied too: they come back private.
        Returns the bundle ``swap_in`` consumes."""
        owner = self.rows[row]
        depth = self.lengths[row]
        # an ensured but unwritten frontier page holds nothing to save,
        # and swap_in re-admits exactly pages_for(depth)
        n_live = pages_for(depth, self.page_size)
        pages = self.allocator.table(owner).pages[:n_live]
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        cuda = self.device.type == "cuda"
        store = {}
        for name, pool in self.caches.items():
            store[name] = []
            for buf in _leaves(pool):
                dev = _bytes(buf).index_select(1, idx)
                host = torch.empty(dev.shape, dtype=dev.dtype,
                                   pin_memory=cuda)
                host.copy_(dev, non_blocking=cuda)
                store[name].append(host)
        self.allocator.release(owner)
        self.rows[row] = None
        self.shrink(row)
        return {"owner": owner, "depth": depth, "n_pages": n_live,
                "store": store}

    def swap_in(self, bundle: dict, total_tokens: int) -> int:
        """Re-admit a preempted request: fresh private pages for its
        recorded depth, the host store written back verbatim, and the
        row rejoins the decode batch at that depth.  Raises
        ``PageExhausted`` when the pages do not fit yet (the request
        stays parked)."""
        owner, depth = bundle["owner"], bundle["depth"]
        assert len(self.rows) < self.num_slots
        self.allocator.admit(owner, depth, self._resident(total_tokens))
        pages = self.allocator.table(owner).pages
        assert len(pages) == bundle["n_pages"]
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        cuda = self.device.type == "cuda"
        for name, pool in self.caches.items():
            for buf, host in zip(_leaves(pool), bundle["store"][name]):
                _bytes(buf)[:, idx] = host.to(self.device,
                                              non_blocking=cuda)
        self.rows.append(owner)
        self.lengths.append(depth)
        return len(self.rows) - 1

    def register_prompt(self, owner: int, keys: list) -> int:
        """Publish the owner's full prompt pages in the prefix-hash map
        (first writer wins); returns how many were registered."""
        pages = self.allocator.table(owner).pages
        return sum(bool(self.allocator.register_hash(pages[j], key))
                   for j, key in enumerate(keys) if j < len(pages))

    # -- retirement ----------------------------------------------------
    def release(self, row: int) -> None:
        self.allocator.release(self.rows[row])
        self.rows[row] = None

    def shrink(self, row: int) -> None:
        """Drop a released row from the decode batch (swap-with-last;
        the pool has no row dim)."""
        assert self.rows[row] is None
        last = len(self.rows) - 1
        if last > 0:
            self.rows[row] = self.rows[last]
            self.lengths[row] = self.lengths[last]
        self.rows.pop()
        self.lengths.pop()

    # -- decode bookkeeping --------------------------------------------
    def prepare_decode(self, write_tokens: int = 1) -> None:
        """Pre-step barrier: make every row's write-target pages private
        (fresh past the frontier, copy-on-write out of shared or hashed
        pages) and stamp the device idx / block table from host state.
        MUST run before each decode step."""
        t = self.page_size
        for i, owner in enumerate(self.rows):
            assert owner is not None, "decode ran with a released row"
            lo = self.lengths[i]
            hi = lo + write_tokens
            for j in range(lo // t, (hi - 1) // t + 1):
                self._ensure_writable(owner, j)
        self._stamp(np.asarray(self.lengths, np.int32),
                    self._table_rows(self.rows))

    def advance(self) -> None:
        """Mirror one decode step: every resident row appended one
        token (page backing was ensured by ``prepare_decode``)."""
        for i, owner in enumerate(self.rows):
            assert owner is not None, "decode ran with a released row"
            self.lengths[i] += 1

    def commit(self, advs) -> None:
        """Mirror one verify step: row i committed ``advs[i]`` tokens
        (accepted drafts and the correction token).  Only the host
        lengths move: ``prepare_decode`` restamps the device idx and
        block tables from them before the next step, so the rejected
        drafts' bytes past the new depth stay masked until overwritten,
        and the frontier pages ensured for the verify window stay in the
        table as the next step's write targets."""
        assert len(advs) == len(self.rows)
        for i, owner in enumerate(self.rows):
            assert owner is not None, "verify ran with a released row"
            self.lengths[i] += int(advs[i])
