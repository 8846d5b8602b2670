"""Page-level prefix cache: chain-hashed immutable KV pages shared across
requests, with copy-on-write and LRU eviction.

The serving analogue of the paper's on-chip data-reuse lever (Ultra-RAM
residency; Guo et al.'s decisive efficiency knob): identical prompt prefixes
— few-shot headers, system prompts — dominate production traffic, and their
K/V pages are a pure function of the token prefix, so recomputing them per
request moves and computes bytes the pool already holds.

Design
------

* **Identity = chain hash at page granularity.** Page ``i`` of a prompt is
  keyed by ``h_i = H(h_{i-1}, tokens[i*ps:(i+1)*ps])`` — a page's identity
  includes every predecessor, so a hit on ``h_i`` guarantees the whole
  aligned prefix matches, and lookup is a forward walk that stops at the
  first miss. A prompt's unaligned tail (``len % ps`` tokens) registers one
  PARTIAL entry keyed the same way over the shorter slice.
* **Entries hold references, never copies.** ``register`` takes one
  allocator reference per indexed page (``PageAllocator.share``); a page
  leaves the index only through ``evict``, which releases that reference —
  the page returns to the free list iff no live block table still aliases
  it. An indexed page can therefore never be on the free list (the
  refcount/COW property tests pin this).
* **Sharing is alias-only for full pages; partial pages are COW sources.**
  A hit's full pages go straight into the new request's block table (reads
  only — every row the request will ever write lies beyond them). A partial
  hit's page WOULD be written (the tail splice, or decode appending past the
  prefix), so the engine gives the request a fresh page instead and
  re-materialises the shared rows into it through the normal splice scatter
  — copy-on-write with zero extra device passes.
* **Eviction is LRU over index-only pages.** Lookup touches its hits;
  ``evict`` walks oldest-first and frees entries whose page has no block
  table reference left (allocator refcount 1 — the index's own), leaving
  admission's defer-in-FIFO-order logic untouched: deferral now simply
  happens after eviction has been given the chance to replenish the free
  list.

Only families whose per-request recurrent state is exactly the attention
K/V rows (dense / MoE / VLM transformers) are cacheable: the hybrid ring's
mamba carry and the SSM/rwkv state at an arbitrary split point are not
reconstructible from pages, and the encoder-decoder cross-K/V is not
page-resident. The engine gates on this and falls back to full prefill.

A copy of ``repro/serve/prefix.py``: chain-hash keys are byte-equal to the
reference's (same seed, same blake2b chain), so both engines resolve the
same prompts to the same hits.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

_SEED = b"repro-prefix-v1"


def chain_hash(prev: bytes, tokens: np.ndarray) -> bytes:
    """One link of the page chain hash: H(predecessor digest || token bytes).
    blake2b is stable across processes (unlike ``hash()``) and fast enough
    that a lookup is O(prompt_len) bytes hashed."""
    return hashlib.blake2b(
        prev + np.ascontiguousarray(tokens, np.int32).tobytes(),
        digest_size=16).digest()


@dataclasses.dataclass
class PrefixPlan:
    """One request's prefix-cache resolution, computed at admission.

    ``shared_pages`` alias directly into the block table (immutable full
    pages); ``partial`` names a copy-on-write SOURCE page — the engine
    allocates a fresh page in its place and the splice re-materialises the
    shared rows. ``full_hashes``/``partial_key`` are the prompt's complete
    chain (hits and misses alike) so registration after prefill needs no
    re-hashing."""
    cached_len: int                          # prefix rows reusable from pool
    shared_pages: List[int]                  # aliased full pages, chain order
    partial: Optional[Tuple[int, int]]       # (source page id, valid rows)
    full_hashes: List[bytes]                 # chain keys of ALL full pages
    partial_key: Optional[bytes]             # chain key of the unaligned tail
    partial_rows: int                        # rows of that tail (p % ps)

    @property
    def hit(self) -> bool:
        return self.cached_len > 0

    @property
    def cow(self) -> bool:
        return self.partial is not None


class PrefixIndex:
    """Refcounted hash -> page index over a :class:`PageAllocator`'s pool.

    Host-side bookkeeping only (like the allocator): nothing here touches
    device memory. The engine owns the device-side consequences — aliasing
    pages into block tables, gathering prefix rows into transient prefill
    caches, and re-materialising COW pages via the splice scatter."""

    def __init__(self, allocator, page_size: int):
        self.allocator = allocator
        self.page_size = int(page_size)
        # key -> (page id, valid rows); OrderedDict order IS the LRU order
        # (move_to_end on every hit), oldest first
        self._entries: "OrderedDict[bytes, Tuple[int, int]]" = OrderedDict()
        self.evictions = 0
        # monotone content version (bumped on register/evict): lets the
        # engine skip re-resolving a deferred head request's plan when
        # neither the free list nor the index has changed since it deferred
        self.version = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pages(self) -> Dict[int, int]:
        """page id -> valid rows for every indexed page (test/debug view)."""
        return {page: rows for page, rows in self._entries.values()}

    @property
    def reclaimable(self) -> int:
        """Pages ``evict`` could free right now (refcount 1: held only by
        the index). Admission-control pressure counts these as available —
        a warm cache legitimately parks most of the free list in
        index-only pages, and shedding load over memory that one ``evict``
        call would hand back is a false positive."""
        return sum(1 for page, _ in self._entries.values()
                   if self.allocator.refcount(page) == 1)

    # ------------------------------------------------------------ lookup
    def lookup(self, prompt: np.ndarray, touch: bool = True) -> PrefixPlan:
        """Longest cached page-aligned prefix of ``prompt``.

        Walks the chain over the prompt's full pages until the first miss,
        then probes the first missed region for a PARTIAL entry, longest
        slice first (an unaligned prefix another request registered). Always
        returns the complete hash chain so the caller can register its own
        pages after prefill without re-hashing. ``touch=False`` (the
        scheduler's ordering hint probe) leaves the LRU order unchanged."""
        prompt = np.asarray(prompt, np.int32)
        p = len(prompt)
        ps = self.page_size
        n_full, rem = divmod(p, ps)
        h = _SEED
        full_hashes: List[bytes] = []
        for i in range(n_full):
            h = chain_hash(h, prompt[i * ps:(i + 1) * ps])
            full_hashes.append(h)
        partial_key = chain_hash(h, prompt[n_full * ps:]) if rem else None

        shared: List[int] = []
        hit_keys: List[bytes] = []
        for hh in full_hashes:
            entry = self._entries.get(hh)
            if entry is None or entry[1] != ps:
                break
            shared.append(entry[0])
            hit_keys.append(hh)
        k = len(shared)

        # probe the first missed region for a shorter (partial) entry
        partial = None
        base = full_hashes[k - 1] if k else _SEED
        region = prompt[k * ps:min((k + 1) * ps, p)]
        for j in range(min(ps - 1, len(region)), 0, -1):
            key = chain_hash(base, region[:j])
            entry = self._entries.get(key)
            if entry is not None and entry[1] == j:
                partial = (entry[0], j)
                hit_keys.append(key)
                break

        if touch:
            self._touch_chain(hit_keys)
        cached_len = k * ps + (partial[1] if partial else 0)
        return PrefixPlan(cached_len=cached_len, shared_pages=shared,
                          partial=partial, full_hashes=full_hashes,
                          partial_key=partial_key, partial_rows=rem)

    def _touch_chain(self, keys: List[bytes]):
        """Refresh a chain's LRU position DEEPEST-FIRST, root last, so the
        root ends most-recently-used. Eviction walks oldest-first: touching
        the chain root first would make IT the chain's eviction victim,
        which breaks every lookup of the prefix at the first link while the
        still-held descendant pages become unreachable dead weight. With
        root-last touching, chains shrink from the deep end — each evicted
        page only shortens the longest hit, never zeroes it."""
        for key in reversed(keys):
            self._entries.move_to_end(key)

    def probe_len(self, prompt) -> int:
        """Cached-prefix length WITHOUT touching the LRU order — the
        scheduler's prefix-aware admission ordering hint."""
        return self.lookup(prompt, touch=False).cached_len

    # ---------------------------------------------------------- register
    def register(self, plan: PrefixPlan, pages: List[int], prompt_len: int):
        """Index a freshly prefilled request's prompt pages.

        Full prompt pages register under their chain hash; the unaligned
        tail registers as a partial entry. Each NEW entry takes one
        allocator reference (released only by eviction). Hashes already
        present keep their existing page — a duplicate prompt admitted
        before the first copy registered simply never shares, and its own
        pages free normally at completion."""
        ps = self.page_size
        n_full = prompt_len // ps
        chain: List[bytes] = []
        for i in range(n_full):
            key = plan.full_hashes[i]
            if key not in self._entries:
                self.allocator.share(pages[i])
                self._entries[key] = (pages[i], ps)
            chain.append(key)
        if plan.partial_rows and plan.partial_key is not None:
            key = plan.partial_key
            if key not in self._entries:
                self.allocator.share(pages[n_full])
                self._entries[key] = (pages[n_full], plan.partial_rows)
            chain.append(key)
        self._touch_chain(chain)
        self.version += 1

    # ------------------------------------------------------------ evict
    def evict(self, need_pages: int) -> int:
        """Free up to ``need_pages`` pages by dropping LRU entries whose page
        no live block table references (allocator refcount 1 — the index's
        own reference). Entries still aliased by running requests are
        skipped: their pages cannot be reclaimed, and evicting the entry
        alone would only lose future hits. Returns pages actually freed."""
        freed = 0
        for key in list(self._entries):
            if freed >= need_pages:
                break
            page, _ = self._entries[key]
            if self.allocator.refcount(page) == 1:
                del self._entries[key]
                self.allocator.release([page])
                freed += 1
                self.evictions += 1
                self.version += 1
        return freed
