"""Node-local radix prefix cache over committed KV pages.

A token-trie (flattened: one dict entry per page-granular depth) over
whole pages already resident in a :class:`~tosem_tpu_torch.serve.kv_cache.
PagedKVCache`. Inserted at prefill/decode commit, queried at admit: a
hit copy-on-write-``fork_prefix``-es the matched pages into the new
sequence so the backend prefills only the *suffix*. Matches are
page-granular and fp-identical by construction — the shared pages are
byte-identical, never recomputed.

Every entry owns ONE cache sequence (``__prefix__/<n>``) holding
refcounts on its pages, so pool pressure and LRU eviction retire
prefixes refcount-safely: freeing the owner never touches pages a live
child still shares. The digest (bounded top-K ``(depth, hash)`` pairs)
is what routers use for cluster-wide longest-prefix routing.
"""
from __future__ import annotations

import collections
import hashlib
import struct
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["prefix_hash", "PrefixCache"]


def prefix_hash(tokens: Sequence[int]) -> str:
    """Stable 64-bit hex digest of a token prefix — the wire identity a
    router digest entry and a cross-node transfer agree on. Pure python
    (md5 over 4-byte little-endian words), identical on every node."""
    h = hashlib.md5()
    for t in tokens:
        h.update(struct.pack("<i", int(t)))
    return h.hexdigest()[:16]


class _Entry:
    __slots__ = ("cid", "tokens", "depth", "hash", "hits")

    def __init__(self, cid: str, tokens: Tuple[int, ...], depth: int):
        self.cid = cid
        self.tokens = tokens          # exactly depth * page_size tokens
        self.depth = depth            # whole pages owned
        self.hash = prefix_hash(tokens)
        self.hits = 0


class PrefixCache:
    """Radix index over one :class:`PagedKVCache`.

    ``insert(ids, src_id)`` registers every page-aligned prefix of a
    freshly prefilled sequence (depth 1..n pages) — each depth gets (at
    most) one owning entry holding a ``fork_prefix`` of the source.
    ``lookup(ids)`` returns the deepest entry whose tokens prefix
    ``ids`` while leaving >= 1 suffix token to prefill. LRU-bounded:
    eviction frees the owner sequence; pages a live child still shares
    survive via refcounts.
    """

    def __init__(self, cache, page_size: int, max_entries: int = 64):
        self._cache = cache
        self._q = int(page_size)
        self.max_entries = int(max_entries)
        # insertion-ordered for LRU: move_to_end on hit
        self._by_key: "collections.OrderedDict[Tuple[int, ...], _Entry]" \
            = collections.OrderedDict()
        self._by_hash: Dict[Tuple[int, str], _Entry] = {}
        self._n = 0
        self._lock = threading.RLock()

    # ------------------------------------------------------------- mutation

    def insert(self, ids: Sequence[int], src_id) -> int:
        """Index every page-aligned prefix of ``ids`` backed by
        ``src_id``'s live pages. Returns how many NEW entries landed
        (0 when everything was already indexed or the pool is too
        pressured to pin another prefix)."""
        from tosem_tpu_torch.serve.kv_cache import CachePressure
        added = 0
        with self._lock:
            full = len(ids) // self._q
            whole = tuple(int(t) for t in ids[:full * self._q])
            for depth in range(full, 0, -1):
                key = whole[:depth * self._q]
                if key in self._by_key:
                    self._by_key.move_to_end(key)
                    continue
                self._n += 1
                cid = f"__prefix__/{self._n}"
                try:
                    self._cache.fork_prefix(src_id, cid, depth)
                except (KeyError, ValueError, CachePressure):
                    continue
                ent = _Entry(cid, key, depth)
                self._by_key[key] = ent
                self._by_hash[(depth, ent.hash)] = ent
                added += 1
                while len(self._by_key) > self.max_entries:
                    self.evict_one()
        return added

    def evict_one(self) -> bool:
        """Drop the least-recently-used entry, freeing its owner
        sequence (refcount rollback — shared pages survive for live
        children). Returns False when the index is empty."""
        with self._lock:
            if not self._by_key:
                return False
            _, ent = self._by_key.popitem(last=False)
            self._by_hash.pop((ent.depth, ent.hash), None)
            try:
                self._cache.free(ent.cid)
            except KeyError:
                pass
            return True

    def invalidate(self, cid: str) -> None:
        """Forget the entry owning ``cid`` (already freed elsewhere —
        e.g. pressure eviction spilled/released the owner)."""
        with self._lock:
            for key, ent in list(self._by_key.items()):
                if ent.cid == cid:
                    del self._by_key[key]
                    self._by_hash.pop((ent.depth, ent.hash), None)

    def clear(self) -> None:
        with self._lock:
            while self.evict_one():
                pass

    # -------------------------------------------------------------- queries

    def lookup(self, ids: Sequence[int]) -> Optional[_Entry]:
        """Deepest indexed prefix of ``ids`` that still leaves at least
        one suffix token to feed (the admit path needs a real last
        token to score). LRU-refreshes the hit."""
        with self._lock:
            max_depth = (len(ids) - 1) // self._q
            whole = tuple(int(t) for t in ids[:max_depth * self._q])
            for depth in range(max_depth, 0, -1):
                key = whole[:depth * self._q]
                ent = self._by_key.get(key)
                if ent is not None:
                    ent.hits += 1
                    self._by_key.move_to_end(key)
                    return ent
            return None

    def by_hash(self, depth: int, hash_: str) -> Optional[_Entry]:
        """Resolve a router-digest ``(depth, hash)`` pair — the
        cross-node export path."""
        with self._lock:
            return self._by_hash.get((int(depth), str(hash_)))

    def digest(self, top_k: int = 16) -> List[List[Any]]:
        """Compact ``[depth, n_tokens, hash]`` triples for the hottest
        (most recently used) prefixes — what replicas piggyback to
        routers. ``n_tokens`` lets a router hash a request's own prefix
        without knowing this backend's page size. JSON-safe and
        bounded."""
        with self._lock:
            ents = list(self._by_key.values())[-top_k:]
            return [[e.depth, len(e.tokens), e.hash]
                    for e in reversed(ents)]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"prefix_entries": len(self._by_key),
                    "prefix_pages_pinned":
                        sum(e.depth for e in self._by_key.values())}

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_key)
