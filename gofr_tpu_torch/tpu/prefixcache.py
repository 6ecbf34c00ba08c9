"""Prefix cache: refcounted shared KV pages keyed by prompt content.

Ports ``gofr_tpu/tpu/prefixcache.py`` whole: ``PrefixCache`` with
``match``, ``insert``, ``unref``, ``evict``, ``evict_entries``,
``drop_all_idle``, ``keys_for``, ``stats``, ``digest``, ``owns`` and
``resident_pages``, the same cumulative chain keys and the same rules. The
reference's ``@loop_only`` markers (read by its static analysis, a no-op at
run time) are left out; the class is still loop-thread-only.

Serving traffic repeats prompt prefixes (a chat surface re-sends the same
system prompt on every request); without sharing, every admission
re-prefills it. A page of the paged pool is an immutable chunk of KV once
written, so two requests whose prompts agree on a whole page can point
their block tables at the same page.

  - FULL pages only. A page is shareable iff the prompt covers every one
    of its `page_size` positions; the partial tail page stays private
    (decode writes continue into it), so sharing is read-only by
    construction. At least one tail token is always recomputed (the last
    prompt position's logits are needed to sample); the matcher enforces it.
  - CUMULATIVE keys. Page i's key covers tokens [0, (i+1)*ps), so a hit on
    page i implies hits on every earlier page, and matching walks from page
    0 to the first miss. Entries keep the token content beside the key, so
    a hash collision degrades to a miss, never to another prompt's KV.
  - REFCOUNTS. `refs[page]` counts the slots mapping the page. A resident
    page with refs == 0 is evictable (LRU, leaf-first); eviction hands the
    page id back to the allocator. The engine routes a finished slot's
    pages here first: pages the cache owns are unref'd and stay resident.

Host-side and loop-thread-only, like the PageAllocator it feeds.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple


class PrefixCache:
    def __init__(self, page_size: int):
        self.page_size = page_size
        # cumulative key -> (page_id, token_tuple); insertion order = LRU
        self._entries: "OrderedDict[int, Tuple[int, tuple]]" = OrderedDict()
        self._key_of_page: Dict[int, int] = {}
        self._refs: Dict[int, int] = {}
        # chain structure for LEAF-FIRST eviction: evicting page i while
        # page i+1's entry survives would strand the child (match() walks
        # from page 0 and breaks at the missing link), so an entry evicts
        # only when childless
        self._parent: Dict[int, Optional[int]] = {}   # key -> parent key
        self._nchildren: Dict[int, int] = {}
        self.hit_pages = 0
        self.miss_pages = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    # -- introspection -------------------------------------------------------
    @property
    def resident_pages(self) -> int:
        return len(self._entries)

    def owns(self, page_id: int) -> bool:
        return page_id in self._key_of_page

    def stats(self) -> Dict[str, int]:
        lookups = self.hit_pages + self.miss_pages
        return {
            "resident_pages": self.resident_pages,
            "hit_pages": self.hit_pages,
            "miss_pages": self.miss_pages,
            "hit_rate": round(self.hit_pages / lookups, 4) if lookups else 0.0,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
        }

    def digest(self, k: int = 16) -> List[str]:
        """The k hottest (MRU-end) chain keys, hex-encoded: a bounded probe
        payload for fleet routers, never the O(pool) entry table."""
        hot = list(self._entries)[-max(0, k):]
        return [format(key & 0xFFFFFFFFFFFFFFFF, "016x") for key in hot]

    # -- key construction ----------------------------------------------------
    def _keys_for(self, tokens: Sequence[int], n_pages: int) -> List[int]:
        """Cumulative chain keys for the first n_pages full pages."""
        keys = []
        h = 0
        ps = self.page_size
        for i in range(n_pages):
            h = hash((h, tuple(tokens[i * ps:(i + 1) * ps])))
            keys.append(h)
        return keys

    def keys_for(self, tokens: Sequence[int], n_pages: int) -> List[int]:
        """Public chain keys: KV tiers address spilled page blobs by the
        same cumulative keys, so page i of a prompt is
        keys_for(prompt, i + 1)[-1]."""
        return self._keys_for(tokens, n_pages)

    # -- the serving protocol ------------------------------------------------
    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest run of cached full pages from page 0, with at least one
        tail token left unmatched. Acquires a ref on every matched page
        (released by unref when the slot finishes or admission aborts)."""
        ps = self.page_size
        matchable = max(0, (len(tokens) - 1) // ps)
        pages: List[int] = []
        for i, key in enumerate(self._keys_for(tokens, matchable)):
            entry = self._entries.get(key)
            if entry is None:
                break
            page_id, content = entry
            if content != tuple(tokens[i * ps:(i + 1) * ps]):
                break  # hash collision: a miss, never shared
            pages.append(page_id)
            self._entries.move_to_end(key)  # LRU touch
        for page_id in pages:
            self._refs[page_id] += 1
        self.hit_pages += len(pages)
        self.miss_pages += matchable - len(pages)
        return pages

    def insert(self, tokens: Sequence[int], table_pages: Sequence[int]) -> None:
        """Register a freshly prefilled prompt's full pages. table_pages is
        the slot's page list in table order (shared prefix pages first);
        pages already cached are skipped, new ones gain a ref for the OWNING
        slot (the engine unrefs every cache-owned page at slot finish, so
        ownership and sharing release through one path)."""
        ps = self.page_size
        n_full = min(max(0, (len(tokens) - 1) // ps), len(table_pages))
        prev_key: Optional[int] = None
        for i, key in enumerate(self._keys_for(tokens, n_full)):
            page_id = table_pages[i]
            if key in self._entries:
                prev_key = key   # existing chain link (the shared prefix)
                continue
            if page_id in self._key_of_page:
                prev_key = None  # page registered under another key: the
                continue         # chain is broken here, stop linking
            self._entries[key] = (page_id, tuple(tokens[i * ps:(i + 1) * ps]))
            self._key_of_page[page_id] = key
            self._refs[page_id] = self._refs.get(page_id, 0) + 1
            self._parent[key] = prev_key
            self._nchildren.setdefault(key, 0)
            if prev_key is not None:
                self._nchildren[prev_key] = self._nchildren.get(prev_key,
                                                                0) + 1
            prev_key = key
            self.inserted_pages += 1

    def unref(self, page_id: int) -> None:
        # a loud error, not an assert: under python -O a silent negative
        # ref would fail the refs == 0 eviction check forever, an
        # unevictable leak
        refs = self._refs[page_id] - 1
        if refs < 0:
            raise RuntimeError(f"prefix page {page_id} over-released")
        self._refs[page_id] = refs

    def evict(self, n: int) -> List[int]:
        """Reclaim up to n LRU pages with no active refs AND no resident
        children (leaf-first: a chain evicts tail-inward, never stranding a
        descendant); returns the page ids for the allocator's free list."""
        return [page_id for _, page_id, _ in self.evict_entries(n)]

    def evict_entries(self, n: int) -> List[Tuple[int, int, tuple]]:
        """evict() with full entry detail, (chain_key, page_id, tokens) per
        reclaimed page: what a KV tier needs to spill a page's content under
        its content-verified key before the page id is reused."""
        freed: List[Tuple[int, int, tuple]] = []
        if n <= 0:
            return freed
        progress = True
        while progress and len(freed) < n:
            progress = False
            for key in list(self._entries):
                if len(freed) >= n:
                    break
                page_id, content = self._entries[key]
                if (self._refs.get(page_id, 0) != 0
                        or self._nchildren.get(key, 0) != 0):
                    continue
                parent = self._parent.pop(key, None)
                if parent is not None and parent in self._nchildren:
                    self._nchildren[parent] -= 1
                self._nchildren.pop(key, None)
                del self._entries[key]
                del self._key_of_page[page_id]
                del self._refs[page_id]
                freed.append((key, page_id, content))
                self.evicted_pages += 1
                progress = True
        return freed

    def drop_all_idle(self) -> List[int]:
        """Evict every idle page."""
        return self.evict(len(self._entries))
