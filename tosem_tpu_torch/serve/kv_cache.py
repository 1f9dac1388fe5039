"""Paged KV cache: a block-table allocator over torch page pools.

Counterpart of ``tosem_tpu/serve/kv_cache.py`` (the vLLM block-manager
design): fixed-size pages drawn from a LIFO free list (page ids handed
out 0, 1, ... in creation order, so schedules replay exactly), refcounts
with copy-on-write for forked sequences, and the whole-page
``fork_prefix`` the prefix cache shares pages with.

Pools are ``[layers, num_pages, page_size, heads, head_dim]`` tensors on
the cache's device. The decode step writes them IN PLACE (the JAX cache
swapped in functionally updated pools); :meth:`set_pools` stays for
callers that hand back pools of the same shape. Window eviction
(``release_below``), spill/restore and ``export_seq``/``import_seq``
are not ported yet (``ROADMAP.md`` A6).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tosem_tpu_torch.ops.common import resolve_device


class CachePressure(RuntimeError):
    """Not enough free pages — the scheduler should evict or requeue."""


@dataclass
class _Seq:
    pages: List[int] = field(default_factory=list)
    length: int = 0


class PagedKVCache:
    """Page pool + block-table allocator for one decode model.
    Thread-safe (a scheduler's step loop and stats scrapers race)."""

    def __init__(self, num_pages: int, page_size: int, layers: int,
                 heads: int, head_dim: int, dtype: str = "float32",
                 device="cuda"):
        if num_pages < 1 or page_size < 1:
            raise ValueError("num_pages and page_size must be >= 1")
        self.device = resolve_device(device)
        self.num_pages = num_pages
        self.page_size = page_size
        self.layers = layers
        self.heads = heads
        self.head_dim = head_dim
        self.dtype = str(dtype).replace("torch.", "")
        shape = (layers, num_pages, page_size, heads, head_dim)
        tdt = getattr(torch, self.dtype)
        self.k_pool = torch.zeros(shape, dtype=tdt, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=tdt, device=self.device)
        self._lock = threading.RLock()
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self._seqs: Dict[Any, _Seq] = {}

    # ------------------------------------------------------------ allocation

    def _alloc_page(self) -> int:
        if not self._free:
            raise CachePressure(
                f"KV pool exhausted ({self.num_pages} pages in use)")
        p = self._free.pop()
        self._refs[p] = 1
        return p

    def _decref(self, page: int) -> None:
        self._refs[page] -= 1
        if self._refs[page] == 0:
            del self._refs[page]
            self._free.append(page)

    def create(self, seq_id) -> None:
        with self._lock:
            if seq_id in self._seqs:
                raise ValueError(f"sequence {seq_id!r} already exists")
            self._seqs[seq_id] = _Seq()

    def extend(self, seq_id, n_tokens: int = 1) -> Tuple[int, int]:
        """Grow a sequence by ``n_tokens``, allocating pages as needed
        (all-or-nothing: on :class:`CachePressure` nothing changed).
        Returns ``(start_pos, new_length)``. Appending into a shared,
        partly filled tail page copies it first (copy-on-write)."""
        with self._lock:
            seq = self._seqs[seq_id]
            start = seq.length
            new_len = start + n_tokens
            need = -(-new_len // self.page_size)
            extra = need - len(seq.pages)
            need_cow = bool(seq.length % self.page_size != 0 and seq.pages
                            and self._refs[seq.pages[-1]] > 1)
            if extra + int(need_cow) > len(self._free):
                raise CachePressure(
                    f"need {extra + int(need_cow)} pages, "
                    f"{len(self._free)} free")
            if need_cow:
                old = seq.pages[-1]
                fresh = self._alloc_page()
                self._copy_page(old, fresh)
                self._decref(old)
                seq.pages[-1] = fresh
            for _ in range(max(extra, 0)):
                seq.pages.append(self._alloc_page())
            seq.length = new_len
            return start, new_len

    def _copy_page(self, src: int, dst: int) -> None:
        self.k_pool[:, dst] = self.k_pool[:, src]
        self.v_pool[:, dst] = self.v_pool[:, src]

    def fork(self, src_id, dst_id) -> None:
        """Share ``src``'s pages with a new sequence (refcount++); the
        branches diverge via copy-on-write on their next append."""
        with self._lock:
            src = self._seqs[src_id]
            if dst_id in self._seqs:
                raise ValueError(f"sequence {dst_id!r} already exists")
            for p in src.pages:
                self._refs[p] += 1
            self._seqs[dst_id] = _Seq(pages=list(src.pages),
                                      length=src.length)

    def fork_prefix(self, src_id, dst_id, n_pages: int) -> None:
        """Share the first ``n_pages`` WHOLE pages of ``src`` with a new
        sequence; its next :meth:`extend` starts a fresh page, so the
        shared pages are read-only for it by construction."""
        with self._lock:
            src = self._seqs[src_id]
            if dst_id in self._seqs:
                raise ValueError(f"sequence {dst_id!r} already exists")
            full = src.length // self.page_size
            if not 0 < n_pages <= full:
                raise ValueError(
                    f"fork_prefix wants {n_pages} whole pages; "
                    f"{src_id!r} has {full} committed")
            for p in src.pages[:n_pages]:
                self._refs[p] += 1
            self._seqs[dst_id] = _Seq(pages=list(src.pages[:n_pages]),
                                      length=n_pages * self.page_size)

    def truncate(self, seq_id, new_length: int) -> None:
        """Drop cached positions past ``new_length``; trailing pages the
        sequence no longer needs return to the pool via refcounts."""
        with self._lock:
            seq = self._seqs[seq_id]
            if not 0 <= new_length <= seq.length:
                raise ValueError(
                    f"truncate({new_length}) outside [0, {seq.length}]")
            need = -(-new_length // self.page_size)
            while len(seq.pages) > need:
                self._decref(seq.pages.pop())
            seq.length = new_length

    def free(self, seq_id) -> None:
        with self._lock:
            seq = self._seqs.pop(seq_id, None)
            if seq is not None:
                for p in seq.pages:
                    self._decref(p)

    # ------------------------------------------------------------- kernel IO

    def block_table(self, seq_id, width: Optional[int] = None) -> np.ndarray:
        """[width] int32 physical page ids, 0-padded (padding slots are
        never read)."""
        with self._lock:
            pages = self._seqs[seq_id].pages
            w = width if width is not None else len(pages)
            out = np.zeros((max(w, 1),), np.int32)
            out[:len(pages)] = pages
            return out

    def page_offset(self, seq_id) -> int:
        """Logical page of block-table slot 0: always 0 until window
        eviction (``release_below``) is ported."""
        with self._lock:
            if seq_id not in self._seqs:
                raise KeyError(seq_id)
        return 0

    def length(self, seq_id) -> int:
        with self._lock:
            return self._seqs[seq_id].length

    def pages_of(self, seq_id) -> List[int]:
        with self._lock:
            return list(self._seqs[seq_id].pages)

    def is_spilled(self, seq_id) -> bool:
        """Always False: the spill tier is not ported yet."""
        return False

    def set_pools(self, k_pool, v_pool) -> None:
        if (tuple(k_pool.shape) != tuple(self.k_pool.shape)
                or tuple(v_pool.shape) != tuple(self.v_pool.shape)):
            raise ValueError("pool shape changed across a step")
        with self._lock:
            self.k_pool, self.v_pool = k_pool, v_pool

    # ---------------------------------------------------------------- stats

    def stats(self) -> Dict[str, int]:
        with self._lock:
            used = self.num_pages - len(self._free)
            return {
                "pages_total": self.num_pages,
                "pages_used": used,
                "pages_free": len(self._free),
                "pages_shared": sum(1 for c in self._refs.values()
                                    if c > 1),
                "pages_spilled": 0,
                "pages_evicted_total": 0,
                "sequences": len(self._seqs),
                "sequences_spilled": 0,
            }
