"""Paged KV cache: a block-table allocator over torch page pools, with a
spill tier and a versioned wire format.

Counterpart of ``tosem_tpu/serve/kv_cache.py`` (the vLLM block-manager
design): fixed-size pages drawn from a LIFO free list (page ids handed
out 0, 1, ... in creation order, so schedules replay exactly), refcounts
with copy-on-write for forked sequences, and the whole-page
``fork_prefix`` the prefix cache shares pages with.

- **Window eviction.** :meth:`release_below` drops a sequence's leading
  pages once no future query's window can see them; the block table then
  rolls (slot 0 holds logical page :meth:`page_offset`).
- **Spill tier.** Under page pressure a cold sequence is demoted:
  :meth:`spill` copies its pages into a spill store (the port's runtime
  object store when it is up, an in-process dict otherwise) and frees
  them; :meth:`restore` brings the bytes back into fresh pages. A payload
  the store lost raises :class:`PagesLostError`, the caller's cue to
  re-prefill from the token history.
- **Wire format.** A spill payload is also what :meth:`export_seq` cuts
  and :meth:`import_seq` admits on another cache: page arrays
  ``[layers, pages, page_size, heads, head_dim]`` beside a header naming
  the pool they came from (``KV_WIRE_VERSION``), checked before any byte
  lands in a page (:class:`KVWireError`).

Pools are ``[layers, num_pages, page_size, heads, head_dim]`` tensors on
the cache's device. The decode step writes them IN PLACE (the JAX cache
swapped in functionally updated pools); :meth:`set_pools` stays for
callers that hand back pools of the same shape. Page payloads are numpy
arrays: float32 as they are, bfloat16 as their bits in a ``uint16``
array of the same shape (numpy has no bfloat16), with the header's
``"dtype"`` still ``"bfloat16"``. An import takes those bits from a
``uint16`` array or from any 2-byte ``bfloat16`` ndarray, never
converting a value.
"""
from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tosem_tpu_torch.ops.common import resolve_device


class CachePressure(RuntimeError):
    """Not enough free pages — the scheduler should evict or requeue."""


class PagesLostError(RuntimeError):
    """A spilled sequence's payload is gone (chaos eviction, store
    loss); the caller must recompute the cache from token history."""


class KVWireError(RuntimeError):
    """A spill/wire payload's header does not match the destination
    pool (page size, dtype, layout, heads/head_dim/layers, or an unknown
    wire version): the payload must go to a matching pool, or the
    sequence be re-prefilled from its tokens."""


# the spill payload IS the wire format: every payload carries a
# version-tagged header naming the pool configuration it was cut from
KV_WIRE_VERSION = 1
# [layers, pages, page_size(slots), heads, head_dim]
KV_WIRE_LAYOUT = "lpshd"


class LocalSpillStore:
    """In-process spill backend (no runtime needed — tests, benches)."""

    def __init__(self):
        self._data: Dict[int, Any] = {}
        self._next = 0

    def put(self, payload: Any):
        self._next += 1
        self._data[self._next] = payload
        return self._next

    def get(self, ref):
        if ref not in self._data:
            raise PagesLostError(f"spill ref {ref!r} lost")
        return self._data[ref]

    def drop(self, ref) -> None:
        self._data.pop(ref, None)


class RuntimeSpillStore:
    """Spill backend over the port's runtime object store: a payload
    becomes a store object (its page arrays raw pickle-5 parts), ``get``
    maps it back without a heap copy, and ``drop`` frees the object at
    once. A payload the store lost raises :class:`PagesLostError`."""

    def put(self, payload: Any):
        import tosem_tpu_torch.runtime as rt
        return rt.put(payload)

    def get(self, ref):
        import tosem_tpu_torch.runtime as rt
        from tosem_tpu_torch.runtime.common import ObjectLostError
        try:
            return rt.get(ref, timeout=30.0, copy=False)
        except (ObjectLostError, TimeoutError) as e:
            raise PagesLostError(f"KV spill payload lost: {e}") from e

    def drop(self, ref) -> None:
        import tosem_tpu_torch.runtime as rt
        if rt.is_initialized():
            rt.free(ref)


def default_spill_store():
    import tosem_tpu_torch.runtime as rt
    return RuntimeSpillStore() if rt.is_initialized() else LocalSpillStore()


@dataclass
class _Seq:
    # OWNED pages only: ``pages[t]`` is logical page ``released + t``;
    # ``released`` counts leading pages evicted by :meth:`release_below`
    pages: List[int] = field(default_factory=list)
    length: int = 0
    released: int = 0


@dataclass
class _Spilled:
    ref: Any
    length: int
    n_pages: int
    released: int = 0


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as a payload array (bf16 as its uint16 bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a, dtype: torch.dtype) -> torch.Tensor:
    """A payload array as a CPU tensor of the pool's dtype, by its bits:
    a bf16 pool takes uint16 or 2-byte bfloat16 arrays, nothing else."""
    a = np.asarray(a)
    if dtype == torch.bfloat16:
        if a.dtype.itemsize != 2 or a.dtype.name not in ("uint16",
                                                         "bfloat16"):
            raise KVWireError(f"a bfloat16 pool takes uint16 or bfloat16 "
                              f"page arrays, got {a.dtype}")
        a = a.view(np.int16)
    elif a.dtype != np.dtype(str(dtype).replace("torch.", "")):
        raise KVWireError(f"page arrays of {a.dtype} for a {dtype} pool")
    with warnings.catch_warnings():
        # a payload mapped from the object store is read-only; the
        # tensor is only ever read (copied into the pool)
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(dtype) if dtype == torch.bfloat16 else t


class PagedKVCache:
    """Page pool + block-table allocator for one decode model.
    Thread-safe (a scheduler's step loop and stats scrapers race)."""

    def __init__(self, num_pages: int, page_size: int, layers: int,
                 heads: int, head_dim: int, dtype: str = "float32",
                 spill_store=None, device="cuda"):
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
        self._spilled: Dict[Any, _Spilled] = {}
        self._evicted = 0            # window-released pages, lifetime
        self._spill_store = spill_store or default_spill_store()

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

    def _check_new(self, seq_id) -> None:
        if seq_id in self._seqs or seq_id in self._spilled:
            raise ValueError(f"sequence {seq_id!r} already exists")

    def create(self, seq_id) -> None:
        with self._lock:
            self._check_new(seq_id)
            self._seqs[seq_id] = _Seq()

    def extend(self, seq_id, n_tokens: int = 1) -> Tuple[int, int]:
        """Grow a sequence by ``n_tokens``, allocating pages as needed
        (all-or-nothing: on :class:`CachePressure` nothing changed).
        Returns ``(start_pos, new_length)``. Appending into a shared,
        partly filled tail page copies it first (copy-on-write); that
        copy counts toward the capacity check up front."""
        with self._lock:
            seq = self._seqs[seq_id]
            start = seq.length
            new_len = start + n_tokens
            need = -(-new_len // self.page_size) - seq.released
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

    def _scatter_pages(self, pages, k, v) -> None:
        """Write page payloads (tensors or payload arrays) into the
        pools in place, on the pools' device."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for pool, src in ((self.k_pool, k), (self.v_pool, v)):
            if not isinstance(src, torch.Tensor):
                src = _from_numpy(src, pool.dtype)
            pool[:, idx] = src.to(self.device, pool.dtype)

    def _copy_page(self, src: int, dst: int) -> None:
        # a copy-on-write divergence stays on the device
        self.k_pool[:, dst] = self.k_pool[:, src]
        self.v_pool[:, dst] = self.v_pool[:, src]

    def fork(self, src_id, dst_id) -> None:
        """Share ``src``'s pages with a new sequence (refcount++); the
        branches diverge via copy-on-write on their next append."""
        with self._lock:
            src = self._seqs[src_id]
            self._check_new(dst_id)
            for p in src.pages:
                self._refs[p] += 1
            self._seqs[dst_id] = _Seq(pages=list(src.pages),
                                      length=src.length,
                                      released=src.released)

    def fork_prefix(self, src_id, dst_id, n_pages: int) -> None:
        """Share the first ``n_pages`` WHOLE pages of ``src`` with a new
        sequence; its next :meth:`extend` starts a fresh page, so the
        shared pages are read-only for it by construction."""
        with self._lock:
            src = self._seqs[src_id]
            self._check_new(dst_id)
            if src.released:
                raise ValueError(
                    f"cannot fork_prefix from window-evicted sequence "
                    f"{src_id!r} ({src.released} pages released)")
            full = src.length // self.page_size
            if not 0 < n_pages <= full:
                raise ValueError(
                    f"fork_prefix wants {n_pages} whole pages; "
                    f"{src_id!r} has {full} committed")
            for p in src.pages[:n_pages]:
                self._refs[p] += 1
            self._seqs[dst_id] = _Seq(pages=list(src.pages[:n_pages]),
                                      length=n_pages * self.page_size)

    def release_below(self, seq_id, floor_pos: int) -> int:
        """Sliding-window eviction: release the leading pages whose every
        position is below ``floor_pos`` (the lowest position a future
        query's window can still see), never the page holding the newest
        position. Returns the pages released this call; the table now
        starts :meth:`page_offset` logical pages in."""
        with self._lock:
            seq = self._seqs[seq_id]
            n = 0
            while (len(seq.pages) > 1
                   and (seq.released + 1) * self.page_size
                   <= min(floor_pos, seq.length)):
                self._decref(seq.pages.pop(0))
                seq.released += 1
                n += 1
            self._evicted += n
            return n

    def truncate(self, seq_id, new_length: int) -> None:
        """Rollback (the speculative reject path): drop cached positions
        past ``new_length``; trailing pages the sequence no longer needs
        return to the pool via refcounts."""
        with self._lock:
            seq = self._seqs[seq_id]
            if not 0 <= new_length <= seq.length:
                raise ValueError(
                    f"truncate({new_length}) outside [0, {seq.length}]")
            if new_length < seq.released * self.page_size:
                raise ValueError(
                    f"truncate({new_length}) reaches into "
                    f"{seq.released} released pages")
            need = max(-(-new_length // self.page_size) - seq.released, 0)
            while len(seq.pages) > need:
                self._decref(seq.pages.pop())
            seq.length = new_length

    def free(self, seq_id) -> None:
        with self._lock:
            seq = self._seqs.pop(seq_id, None)
            if seq is not None:
                for p in seq.pages:
                    self._decref(p)
                return
            spilled = self._spilled.pop(seq_id, None)
            if spilled is not None:
                self._spill_store.drop(spilled.ref)

    # ------------------------------------------------------------- kernel IO

    def block_table(self, seq_id, width: Optional[int] = None) -> np.ndarray:
        """[width] int32 physical page ids, 0-padded (padding slots are
        never read). For a window-evicted sequence this is the ROLLING
        table: slot t holds logical page ``page_offset(seq_id) + t``."""
        with self._lock:
            pages = self._seqs[seq_id].pages
            w = width if width is not None else len(pages)
            out = np.zeros((max(w, 1),), np.int32)
            out[:len(pages)] = pages
            return out

    def page_offset(self, seq_id) -> int:
        """Logical page of block-table slot 0 (the kernel's
        ``page_offsets`` operand; 0 until window eviction starts)."""
        with self._lock:
            return self._seqs[seq_id].released

    def length(self, seq_id) -> int:
        with self._lock:
            if seq_id in self._seqs:
                return self._seqs[seq_id].length
            return self._spilled[seq_id].length

    def pages_of(self, seq_id) -> List[int]:
        with self._lock:
            return list(self._seqs[seq_id].pages)

    def is_spilled(self, seq_id) -> bool:
        with self._lock:
            return seq_id in self._spilled

    def set_pools(self, k_pool, v_pool) -> None:
        if (tuple(k_pool.shape) != tuple(self.k_pool.shape)
                or tuple(v_pool.shape) != tuple(self.v_pool.shape)):
            raise ValueError("pool shape changed across a step")
        with self._lock:
            self.k_pool, self.v_pool = k_pool, v_pool

    # ------------------------------------------------- spill/wire payloads

    def wire_header(self, *, length: int, released: int,
                    n_pages: int) -> Dict[str, Any]:
        """The version-tagged header naming this pool's configuration,
        checked by every import and restore."""
        return {
            "version": KV_WIRE_VERSION,
            "layout": KV_WIRE_LAYOUT,
            "page_size": self.page_size,
            "dtype": self.dtype,
            "layers": self.layers,
            "heads": self.heads,
            "head_dim": self.head_dim,
            "length": int(length),
            "page_offset": int(released),
            "n_pages": int(n_pages),
        }

    def check_wire_header(self, header) -> Dict[str, Any]:
        """Validate a payload header against THIS pool; raises
        :class:`KVWireError` on any mismatch. Returns the header."""
        if not isinstance(header, dict):
            raise KVWireError("KV payload has no wire header (pre-"
                              f"version payload? got {type(header)})")
        if header.get("version") != KV_WIRE_VERSION:
            raise KVWireError(
                f"KV wire version {header.get('version')!r} != "
                f"{KV_WIRE_VERSION}")
        for field_, mine in (("layout", KV_WIRE_LAYOUT),
                             ("page_size", self.page_size),
                             ("dtype", self.dtype),
                             ("layers", self.layers),
                             ("heads", self.heads),
                             ("head_dim", self.head_dim)):
            if header.get(field_) != mine:
                raise KVWireError(
                    f"KV payload {field_}={header.get(field_)!r} does "
                    f"not match this pool's {field_}={mine!r} — "
                    "refusing to scatter into a differently-configured "
                    "pool")
        return header

    def _gather_pages(self, pages: List[int]):
        """(k, v) payload arrays of the selected pages: the gather runs
        on the pools' device and only those pages cross to the host."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        return (_to_numpy(self.k_pool[:, idx].cpu()),
                _to_numpy(self.v_pool[:, idx].cpu()))

    def _cut_payload(self, seq: _Seq) -> Dict[str, Any]:
        """Spill/wire payload for a LIVE sequence (pages stay owned)."""
        k, v = self._gather_pages(seq.pages)
        return {
            "header": self.wire_header(length=seq.length,
                                       released=seq.released,
                                       n_pages=len(seq.pages)),
            "k": k,
            "v": v,
            "length": seq.length,
            "released": seq.released,
        }

    def export_seq(self, seq_id) -> Dict[str, Any]:
        """A migratable payload for ``seq_id``, live or spilled, leaving
        its state here unchanged (the caller frees the source only after
        the destination's import succeeded). A spilled sequence exports
        its stored payload (:class:`PagesLostError` when that is
        gone)."""
        with self._lock:
            if seq_id in self._spilled:
                spilled = self._spilled[seq_id]
                payload = self._spill_store.get(spilled.ref)  # may raise
                self.check_wire_header(payload.get("header"))
                return payload
            return self._cut_payload(self._seqs[seq_id])

    def import_seq(self, seq_id, payload: Dict[str, Any]) -> None:
        """Admit a migrated payload as a NEW sequence: check the header
        (:class:`KVWireError`), allocate all-or-nothing
        (:class:`CachePressure` changes nothing), write the page bytes and
        register the exported ``length``/``page_offset``, so decode
        continues from the current step bit for bit."""
        with self._lock:
            header = self.check_wire_header(payload.get("header"))
            self._check_new(seq_id)
            n_pages = int(header["n_pages"])
            k, v = payload["k"], payload["v"]
            if (tuple(k.shape) != (self.layers, n_pages, self.page_size,
                                   self.heads, self.head_dim)
                    or tuple(k.shape) != tuple(v.shape)):
                raise KVWireError(
                    f"payload arrays {tuple(k.shape)}/{tuple(v.shape)} "
                    f"do not match header n_pages={n_pages} and pool "
                    "geometry")
            if n_pages > len(self._free):
                raise CachePressure(
                    f"import needs {n_pages} pages, "
                    f"{len(self._free)} free")
            k, v = (_from_numpy(a, self.k_pool.dtype) for a in (k, v))
            pages = [self._alloc_page() for _ in range(n_pages)]
            if pages:
                self._scatter_pages(pages, k, v)
            self._seqs[seq_id] = _Seq(pages=pages,
                                      length=int(header["length"]),
                                      released=int(header["page_offset"]))

    # ----------------------------------------------------------- spill tier

    def spill(self, seq_id) -> None:
        """Demote a sequence's pages to the spill store and return them
        to the free list. Byte-preserving: restore + the same kernel
        give the same outputs bit for bit."""
        with self._lock:
            seq = self._seqs[seq_id]
            payload = self._cut_payload(seq)
            ref = self._spill_store.put(payload)
            for p in seq.pages:
                self._decref(p)
            del self._seqs[seq_id]
            self._spilled[seq_id] = _Spilled(ref=ref, length=seq.length,
                                             n_pages=len(seq.pages),
                                             released=seq.released)

    def restore(self, seq_id) -> None:
        """Rehydrate a spilled sequence into fresh pages. Raises
        :class:`CachePressure` when the pool can't hold it (nothing
        changed) and :class:`PagesLostError` when the payload is gone
        (the caller re-prefills from token history)."""
        with self._lock:
            spilled = self._spilled[seq_id]
            if spilled.n_pages > len(self._free):
                raise CachePressure(
                    f"restore needs {spilled.n_pages} pages, "
                    f"{len(self._free)} free")
            payload = self._spill_store.get(spilled.ref)   # may raise
            self.check_wire_header(payload.get("header"))
            pages = [self._alloc_page() for _ in range(spilled.n_pages)]
            if pages:
                self._scatter_pages(pages, payload["k"], payload["v"])
            del self._spilled[seq_id]
            self._spill_store.drop(spilled.ref)
            self._seqs[seq_id] = _Seq(pages=pages,
                                      length=payload["length"],
                                      released=payload.get("released", 0))

    def drop_spilled(self, seq_id) -> None:
        """Forget a spilled sequence WITHOUT restoring (the re-prefill
        path after :class:`PagesLostError`)."""
        with self._lock:
            spilled = self._spilled.pop(seq_id, None)
            if spilled is not None:
                self._spill_store.drop(spilled.ref)

    # ---------------------------------------------------------------- stats

    def stats(self) -> Dict[str, int]:
        with self._lock:
            used = self.num_pages - len(self._free)
            return {
                "pages_total": self.num_pages,
                "pages_used": used,
                "pages_free": len(self._free),
                # a shared physical page counts once in pages_used;
                # pages_shared breaks out the copy-on-write subset
                "pages_shared": sum(1 for c in self._refs.values()
                                    if c > 1),
                "pages_spilled": sum(s.n_pages
                                     for s in self._spilled.values()),
                "pages_evicted_total": self._evicted,
                "sequences": len(self._seqs),
                "sequences_spilled": len(self._spilled),
            }
