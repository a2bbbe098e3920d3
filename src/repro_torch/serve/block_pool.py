"""Block-pool memory manager: ref-counted physical pages with a
content-hash prefix registry, copy-on-write bookkeeping, and an LRU of
evictable cached pages.

This is the host-side half of the KV memory subsystem.  It owns NO device
arrays — it hands out physical page *ids* and keeps the invariants a
shared pool needs; :class:`repro_torch.serve.kv_cache.PagedKVCache` performs the
actual device-side page copies/gathers and maps slots to pages through its
block tables.

Why it exists, in the paper's terms: decode throughput is pinned at
``beta * I`` (eq. 1), so at fixed arithmetic intensity the only remaining
lever is concurrency — more live requests per HBM byte.  Every page this
pool deduplicates (prefix sharing) or defers (on-demand growth instead of
full-budget reservation) buys batch, and batch amortizes the weight read
that dominates ``Q``.

Page lifecycle::

    FREE --acquire--> REFERENCED(rc>=1) --release to rc=0-->
        unfrozen: FREE
        frozen:   CACHED (content kept, hash-addressable, LRU-evictable)
    CACHED --lookup hit--> REFERENCED     (prefix dedup: no copy, rc+=1)
    CACHED --evict (pool dry)--> FREE     (hash entry dropped)

*Frozen* pages are full pages whose content is final (every position's
canonical token has been fed through the model); they are registered under
a chain hash ``H(parent_hash, page_tokens)`` so a later request with the
same token prefix can alias them.  A frozen or multiply-referenced page is
never written in place: callers must ask :meth:`writable` and copy first
(copy-on-write) — :meth:`cow_needed` is the decision, the device copy is
the cache's job.

Physical page 0 is the reserved trash page (idle/masked lanes write there)
and is never handed out.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np


def chain_hash(parent: Optional[int], tokens: Sequence[int]) -> int:
    """Content hash of one full page given its prefix's hash: two pages
    collide only if their whole token prefixes match, which is exactly the
    condition under which their KV content is identical (deterministic
    forward, absolute positions)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(b"\x00" if parent is None else int(parent).to_bytes(8, "little"))
    h.update(np.asarray(tokens, np.int64).tobytes())
    return int.from_bytes(h.digest(), "little")


def token_chain_hashes(tokens: np.ndarray, page_size: int) -> List[int]:
    """Chain hashes of every *full* page of a token stream."""
    out: List[int] = []
    parent: Optional[int] = None
    for b in range(len(tokens) // page_size):
        parent = chain_hash(parent, tokens[b * page_size:(b + 1) * page_size])
        out.append(parent)
    return out


@dataclasses.dataclass
class PoolStats:
    """Cumulative pool counters for the HBM-capacity roofline axis."""
    peak_in_use: int = 0         # high-water mark of referenced pages
    dedup_hits: int = 0          # lookups served by an existing page
    cow_copies: int = 0          # copy-on-write page copies performed
    evictions: int = 0           # cached pages reclaimed under pressure
    freezes: int = 0             # pages registered in the hash index
    # swap-out compaction (kv_cache.swap_out): per-leaf page gathers are
    # packed into ONE contiguous device->host DMA per swap; the second
    # counter is how many separate transfers the packing avoided
    swap_dmas: int = 0           # compacted device->host swap transfers
    swap_transfers_saved: int = 0

    def as_dict(self) -> Dict[str, int]:
        """Counter-name -> value view, the shape the metrics harvest
        would consume."""
        return dataclasses.asdict(self)


class BlockPool:
    """Ref-counted physical-page allocator with a prefix-hash index.

    ``num_pages`` counts the whole pool including the reserved trash page 0.
    """

    TRASH = 0

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("pool needs at least one page past the trash "
                             f"page, got num_pages={num_pages}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._refcount = np.zeros((num_pages,), np.int32)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        # frozen page -> its chain hash; hash -> page (first writer wins)
        self._page_hash: Dict[int, int] = {}
        self._hash_page: Dict[int, int] = {}
        # rc==0 frozen pages, insertion order == LRU order
        self._cached: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self.stats = PoolStats()

    # -- capacity ----------------------------------------------------------

    @property
    def free_page_count(self) -> int:
        """Pages immediately available without evicting cached content."""
        return len(self._free)

    @property
    def available_page_count(self) -> int:
        """Pages obtainable right now: free + evictable cached."""
        return len(self._free) + len(self._cached)

    @property
    def pages_in_use(self) -> int:
        """Pages referenced by at least one block-table entry."""
        return int((self._refcount[1:] > 0).sum())

    @property
    def pages_cached(self) -> int:
        return len(self._cached)

    def refcount(self, page: int) -> int:
        return int(self._refcount[page])

    # -- acquire / release -------------------------------------------------

    def _note_use(self) -> None:
        self.stats.peak_in_use = max(self.stats.peak_in_use,
                                     self.pages_in_use)

    def acquire(self) -> Optional[int]:
        """A fresh writable page (rc=1), evicting the LRU cached page if
        the free list is dry.  None when the pool is exhausted — the
        caller's cue to preempt."""
        if not self._free and self._cached:
            victim, _ = self._cached.popitem(last=False)
            key = self._page_hash.pop(victim)
            if self._hash_page.get(key) == victim:   # bijective by freeze()
                del self._hash_page[key]
            self._free.append(victim)
            self.stats.evictions += 1
        if not self._free:
            return None
        page = self._free.pop()
        self._refcount[page] = 1
        self._note_use()
        return page

    def incref(self, page: int) -> None:
        if page == self.TRASH:
            raise ValueError("cannot reference the trash page")
        if self._refcount[page] <= 0:
            raise ValueError(f"incref of unreferenced page {page}")
        self._refcount[page] += 1

    def release(self, page: int) -> None:
        """Drop one reference.  rc hitting 0 returns the page to the free
        list — or parks it in the cached-LRU if it is frozen (its content
        stays addressable for future prefix hits).  Releasing a page that
        is not referenced is the double-free the free list must be guarded
        against: it raises instead of corrupting."""
        if page == self.TRASH:
            raise ValueError("cannot release the trash page")
        if self._refcount[page] <= 0:
            raise ValueError(
                f"double free: page {page} has no live references")
        self._refcount[page] -= 1
        if self._refcount[page] == 0:
            if page in self._page_hash:
                self._cached[page] = None       # newest = MRU end
            else:
                self._free.append(page)

    # -- content-hash prefix index ----------------------------------------

    def freeze(self, page: int, key: int) -> None:
        """Register a full, final page under its chain hash.  First writer
        wins: if ``key`` is already indexed by ANOTHER live page the
        newcomer stays entirely unregistered — it remains an ordinary
        refcounted page that frees normally, so the two indexes stay
        bijective (a duplicate must never park unreachable in the cached
        LRU, nor have its eviction drop the live owner's index entry).
        Lookups for the shared content keep resolving to the first page."""
        if self._refcount[page] <= 0:
            raise ValueError(f"freeze of unreferenced page {page}")
        if page in self._page_hash:
            return
        if key in self._hash_page and self._hash_page[key] != page:
            return
        self._page_hash[page] = key
        self._hash_page[key] = page
        self.stats.freezes += 1

    def is_frozen(self, page: int) -> bool:
        return page in self._page_hash

    def lookup(self, key: int) -> Optional[int]:
        """Prefix-cache hit: returns an indexed page holding this chain
        hash's content with its refcount bumped (reviving it from the
        cached-LRU if it was unreferenced), or None."""
        page = self._hash_page.get(key)
        if page is None:
            return None
        if self._refcount[page] == 0:
            self._cached.pop(page, None)
            self._refcount[page] = 1
        else:
            self._refcount[page] += 1
        self.stats.dedup_hits += 1
        self._note_use()
        return page

    def peek(self, key: int) -> Optional[int]:
        """Like :meth:`lookup` but without taking a reference — for
        admission-time page-need estimates."""
        return self._hash_page.get(key)

    # -- copy-on-write -----------------------------------------------------

    def writable(self, page: int) -> bool:
        """True iff in-place writes are safe: exactly one reference and no
        hash index entry (frozen content must stay byte-stable for future
        lookups and for siblings that alias it)."""
        return self._refcount[page] == 1 and page not in self._page_hash

    def cow_needed(self, page: int) -> bool:
        return page != self.TRASH and not self.writable(page)

    def note_cow(self) -> None:
        self.stats.cow_copies += 1

    # -- invariants --------------------------------------------------------

    def check(self, table_refs: Optional[Dict[int, int]] = None) -> None:
        """Assert pool invariants (tests/debug): conservation of pages,
        free/cached/referenced disjointness, and — when the caller passes
        the per-page reference counts implied by its block tables —
        refcount agreement."""
        free = set(self._free)
        cached = set(self._cached)
        live = {p for p in range(1, self.num_pages)
                if self._refcount[p] > 0}
        assert not free & cached, "page both free and cached"
        assert not free & live, "free page has references"
        assert not cached & live, "cached page has references"
        assert len(free) + len(cached) + len(live) == self.num_pages - 1, (
            "pages leaked: "
            f"{len(free)} free + {len(cached)} cached + {len(live)} live "
            f"!= {self.num_pages - 1}")
        for p in cached:
            assert p in self._page_hash, "cached page lost its hash"
        if table_refs is not None:
            for p in range(1, self.num_pages):
                assert self._refcount[p] == table_refs.get(p, 0), (
                    f"page {p}: pool refcount {self._refcount[p]} != "
                    f"{table_refs.get(p, 0)} block-table references")
