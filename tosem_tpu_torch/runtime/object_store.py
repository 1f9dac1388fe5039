"""Python client for the native shared-memory object store.

Plasma-client analog (reference: ``src/ray/object_manager/plasma/client.cc``):
immutable objects keyed by 20-byte ids, zero-copy reads out of the mmap'd
segment, per-object refcounts, LRU eviction under memory pressure. The store
itself is C++ (:mod:`tosem_tpu_torch.native` ``objstore.cpp``); this wrapper adds
object-id generation, memoryview-based zero-copy gets, and a spill tier:
an object can be demoted to a disk file (``spill``) and is transparently
restored on the next ``get``/``get_view`` — eviction under memory pressure
becomes a slow path instead of data loss (the reference's
``object_manager/spilled_object_reader.cc`` role). The spill directory is
derived from the segment name, so every process attached to the segment
sees the same spill tier.

Mapped-in-place reads (:meth:`ObjectStore.get_mapped`): a consumer can hold
a READONLY view over the object's shm pages instead of copying them to the
heap — the plasma ``client.cc`` Get contract. The view rides a
:class:`MappedHandle` whose store refcount is the PIN: while any derived
view (or array unpickled over one) is alive, LRU eviction skips the slot,
``spill`` refuses to demote it, and ``delete_if_unpinned`` (the pressure-
eviction delete) returns False — the pages can never be freed out from
under a live mapping. The pin is released by a ``weakref.finalize`` on the
mapping's exporter when the last consumer drops; crashed readers' pins are
reclaimed natively via the per-pid pin ledger.
"""
from __future__ import annotations

import ctypes
import os
import random
import tempfile
import threading
import weakref
from typing import List, Optional, Tuple

from tosem_tpu_torch.native import load_library

ID_LEN = 20

# streamed-spill chunk: bounds the write-path working set so spilling an
# 8 MB object under memory pressure never doubles its footprint
SPILL_CHUNK = 1 << 20

# --- fast unique tokens ----------------------------------------------------
# ``os.urandom`` is a syscall per call and can be pathologically slow under
# sandboxed kernels (hundreds of µs — it dominated the whole put/submit hot
# path). Ids only need uniqueness within the driver process that mints them,
# so one urandom seed feeding a process-local PRNG stream is equivalent and
# ~100× cheaper. The stream is invalidated in fork children via
# ``os.register_at_fork`` (not a getpid() check per call — that is a
# syscall too) so a child never replays the parent's stream.
_token_lock = threading.Lock()
_token_rng: Optional[random.Random] = None


def _reset_token_rng() -> None:
    global _token_rng
    _token_rng = None


# cached pid for the mapped-read pin bookkeeping: os.getpid() is a real
# syscall (pathologically slow under sandboxed kernels) and one fires per
# mapped get; fork children refresh it the same way the token stream does
_pid = os.getpid()


def _refresh_pid() -> None:
    global _pid
    _pid = os.getpid()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_token_rng)
    os.register_at_fork(after_in_child=_refresh_pid)


def fast_token(n: int) -> bytes:
    global _token_rng
    with _token_lock:
        if _token_rng is None:
            _token_rng = random.Random(os.urandom(32))
        return _token_rng.randbytes(n)

_ERRORS = {
    -1: "object already exists (objects are immutable)",
    -2: "object not found",
    -3: "store full (and nothing evictable)",
    -4: "system error",
    -5: "object larger than store capacity",
    -6: "object is pinned by a live mapping",
}


class ObjectStoreError(RuntimeError):
    def __init__(self, code: int, what: str = ""):
        super().__init__(f"{_ERRORS.get(code, f'error {code}')} {what}".strip())
        self.code = code


class ObjectID:
    """20-byte object id (the shape of Ray's ``ObjectID``)."""

    __slots__ = ("binary",)

    def __init__(self, binary: bytes):
        if len(binary) != ID_LEN:
            raise ValueError(f"ObjectID must be {ID_LEN} bytes")
        self.binary = binary

    @classmethod
    def random(cls) -> "ObjectID":
        return cls(fast_token(ID_LEN))

    def hex(self) -> str:
        return self.binary.hex()

    def __hash__(self):
        return hash(self.binary)

    def __eq__(self, other):
        return isinstance(other, ObjectID) and self.binary == other.binary

    def __repr__(self):
        return f"ObjectID({self.hex()[:12]}…)"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.objstore_create.restype = ctypes.c_void_p
    lib.objstore_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.objstore_attach.restype = ctypes.c_void_p
    lib.objstore_attach.argtypes = [ctypes.c_char_p]
    lib.objstore_put.restype = ctypes.c_int
    lib.objstore_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_char_p, ctypes.c_uint64]
    lib.objstore_get.restype = ctypes.c_int
    lib.objstore_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.POINTER(u8p),
                                 ctypes.POINTER(ctypes.c_uint64)]
    lib.objstore_reserve.restype = ctypes.c_int
    lib.objstore_reserve.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint64, ctypes.POINTER(u8p)]
    lib.objstore_seal.restype = ctypes.c_int
    lib.objstore_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.objstore_abort.restype = ctypes.c_int
    lib.objstore_abort.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.objstore_is_sealed.restype = ctypes.c_int
    lib.objstore_is_sealed.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.objstore_reclaim_orphan.restype = ctypes.c_int
    lib.objstore_reclaim_orphan.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.objstore_release.restype = ctypes.c_int
    lib.objstore_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.objstore_refcount.restype = ctypes.c_int
    lib.objstore_refcount.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.objstore_delete_if_unpinned.restype = ctypes.c_int
    lib.objstore_delete_if_unpinned.argtypes = [ctypes.c_void_p,
                                                ctypes.c_char_p]
    lib.objstore_close_keepmap.restype = None
    lib.objstore_close_keepmap.argtypes = [ctypes.c_void_p]
    lib.objstore_contains.restype = ctypes.c_int
    lib.objstore_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.objstore_delete.restype = ctypes.c_int
    lib.objstore_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.objstore_stats.restype = None
    lib.objstore_stats.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.POINTER(ctypes.c_uint64)]
    lib.objstore_close.restype = None
    lib.objstore_close.argtypes = [ctypes.c_void_p]
    return lib


class MappedHandle:
    """A zero-copy read of one store object: ``view`` is a READONLY
    memoryview over the object's shm pages (or, for a spilled object a
    full segment couldn't re-admit, over a heap copy — semantics are
    identical, just not zero-copy).

    Lifetime rules:

    - The pin (store refcount) lives as long as the MAPPING, not the
      handle: every slice of ``view`` — and every array unpickled over
      one — keeps the underlying exporter alive, and a
      ``weakref.finalize`` on that exporter releases the pin when the
      last consumer drops. Dropping the handle itself is always safe.
    - While pinned, the object is skipped by LRU eviction, refused by
      ``spill``, and ``delete_if_unpinned`` returns False. A plain
      ``delete`` (owner dropped the id) defers the free to the last
      release, so even that cannot invalidate the pages.
    - Fork children inherit the views but never release the parent's
      pin (the finalizer is pid-guarded); their own mappings pin and
      release independently.
    - :meth:`release` drops the pin immediately — only call it when no
      derived view has escaped (e.g. after copying the bytes out).
    """

    __slots__ = ("oid", "nbytes", "view", "_finalizer")

    def __init__(self, view: memoryview, oid: "ObjectID", nbytes: int,
                 finalizer=None):
        self.view = view
        self.oid = oid
        self.nbytes = nbytes
        self._finalizer = finalizer

    @property
    def pinned(self) -> bool:
        """True while this handle's own pin is still held (shm-backed
        and not yet explicitly released)."""
        return self._finalizer is not None and self._finalizer.alive

    def release(self) -> None:
        """Drop the pin now (idempotent). The caller asserts no view
        derived from ``view`` is still in use."""
        if self._finalizer is not None:
            self._finalizer()

    def __enter__(self) -> "MappedHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self):
        return (f"MappedHandle({self.oid.hex()[:12]}…, {self.nbytes}B, "
                f"{'pinned' if self.pinned else 'released'})")


def default_spill_dir(name: str) -> str:
    """Spill directory shared by every attacher of segment ``name``."""
    return os.path.join(tempfile.gettempdir(),
                        "tosem_spill_" + name.strip("/").replace("/", "_"))


class ObjectStore:
    """One shared-memory segment, created by the driver, attached by workers."""

    def __init__(self, name: str, capacity: int = 256 << 20,
                 create: bool = True, spill_dir: Optional[str] = None):
        self._lib = _bind(load_library("objstore"))
        self.name = name
        self._created = create
        self.spill_dir = spill_dir or default_spill_dir(name)
        # live mapped-in-place reads handed out by THIS wrapper: when any
        # are outstanding at close(), the segment is unlinked but NOT
        # unmapped (objstore_close_keepmap) so consumer views stay valid
        # until the process exits. The lock serializes the pin+count pair
        # against close's native call (so close can never munmap between
        # a native pin and its count update) and against racing
        # finalizers; RLock because a finalizer can run via GC on a
        # thread that already holds it.
        self._map_lock = threading.RLock()
        self._mapped_outstanding = 0
        if create:
            self._h = self._lib.objstore_create(name.encode(), capacity)
        else:
            self._h = self._lib.objstore_attach(name.encode())
        if not self._h:
            raise ObjectStoreError(-4, f"could not open segment {name!r}")

    def put(self, oid: ObjectID, data: bytes) -> None:
        rc = self._lib.objstore_put(self._h, oid.binary, data, len(data))
        if rc != 0:
            raise ObjectStoreError(rc, f"put {oid!r} ({len(data)} bytes)")

    def get(self, oid: ObjectID) -> Optional[bytes]:
        """Copying get (safe default). Returns None when absent."""
        view = self.get_view(oid)
        if view is None:
            return None
        try:
            return bytes(view)
        finally:
            self.release(oid)

    def get_view(self, oid: ObjectID) -> Optional[memoryview]:
        """Zero-copy view into the segment; caller must :meth:`release`.

        A spilled object is transparently restored: promoted back into
        the segment when it fits (future reads are zero-copy again), or
        served from a heap copy of the file when the segment is full —
        either way the caller cannot tell it was ever spilled.
        """
        view = self._get_view_shm(oid)
        if view is not None:
            return view
        data = self._read_spilled(oid)
        if data is None:
            return None
        try:
            self.put(oid, data)
        except ObjectStoreError as e:
            if e.code == -1:             # raced restore: already back
                pass
            else:                        # segment full: serve the copy
                return memoryview(data)
        else:
            self._unlink_spilled(oid)
        return self._get_view_shm(oid) or memoryview(data)

    def _get_shm_raw(self, oid: ObjectID):
        """ctypes array over the payload with the refcount (pin) held,
        or None when absent from shm. Callers pair with release — either
        directly or via a MappedHandle finalizer."""
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        size = ctypes.c_uint64()
        rc = self._lib.objstore_get(self._h, oid.binary,
                                    ctypes.byref(ptr), ctypes.byref(size))
        if rc == -2:
            return None
        if rc != 0:
            raise ObjectStoreError(rc, f"get {oid!r}")
        return (ctypes.c_uint8 * size.value).from_address(
            ctypes.addressof(ptr.contents))

    def _get_view_shm(self, oid: ObjectID) -> Optional[memoryview]:
        carray = self._get_shm_raw(oid)
        if carray is None:
            return None
        return memoryview(carray).cast("B")

    def get_mapped(self, oid: ObjectID) -> Optional["MappedHandle"]:
        """Mapped-in-place read: a :class:`MappedHandle` whose readonly
        view aliases the shm pages, pinned until the last derived view
        dies (see the handle's lifetime rules). None when absent.

        A spilled object is restored first (promoted back into the
        segment when it fits); when the segment is full the handle is
        served from a heap copy of the file — same readonly semantics,
        no pin needed."""
        handle = self._map_shm(oid)
        if handle is not None:
            return handle
        data = self._read_spilled(oid)
        if data is None:
            return None
        try:
            self.put(oid, data)
        except ObjectStoreError as e:
            if e.code != -1:         # segment full: serve the heap copy
                return MappedHandle(memoryview(data), oid, len(data))
        else:
            self._unlink_spilled(oid)
        handle = self._map_shm(oid)
        if handle is not None:
            return handle
        # raced eviction of the restore: serve the heap copy
        return MappedHandle(memoryview(data), oid, len(data))

    def _map_shm(self, oid: ObjectID) -> Optional["MappedHandle"]:
        """Shm half of :meth:`get_mapped`. The native pin and the
        outstanding-mapping count are taken under ONE _map_lock hold, so
        a concurrent close() either happens-before (native get sees a
        null handle) or sees the count and keeps the mapping alive —
        never an munmap between the pin and the count."""
        with self._map_lock:
            if not self._h:
                return None
            carray = self._get_shm_raw(oid)
            if carray is None:
                return None
            self._mapped_outstanding += 1
        fin = weakref.finalize(carray, ObjectStore._unpin,
                               weakref.ref(self), oid.binary, _pid)
        view = memoryview(carray).cast("B").toreadonly()
        return MappedHandle(view, oid, len(carray), fin)

    @staticmethod
    def _unpin(store_ref, key: bytes, owner_pid: int) -> None:
        """Finalizer for one mapping: release the native pin. Skipped in
        fork children (they would release the PARENT's pin) and after
        the wrapper was closed/collected."""
        if _pid != owner_pid:
            return
        store = store_ref()
        if store is None:
            return
        with store._map_lock:
            store._mapped_outstanding -= 1
            if store._h:
                try:
                    store._lib.objstore_release(store._h, key)
                except Exception:
                    pass

    def refcount(self, oid: ObjectID) -> int:
        """Live pins on the object (0 when unpinned or absent). Dead
        readers' pins are reclaimed before answering."""
        rc = self._lib.objstore_refcount(self._h, oid.binary)
        return rc if rc > 0 else 0

    def delete_if_unpinned(self, oid: ObjectID) -> bool:
        """Eviction-path delete: remove the object (shm + spill file)
        ONLY when no live mapping pins it. False = pinned, nothing
        changed — the caller picks another victim. Unlike :meth:`delete`
        this never defers, so a pinned object can never be observed
        evicted out from under its mapping."""
        rc = self._lib.objstore_delete_if_unpinned(self._h, oid.binary)
        if rc == -6:
            return False
        self._unlink_spilled(oid)
        return True

    def reserve(self, oid: ObjectID, size: int) -> memoryview:
        """Two-phase write (plasma Create/Seal): returns a writable view of
        ``size`` bytes inside the segment; write then :meth:`seal`."""
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        rc = self._lib.objstore_reserve(self._h, oid.binary, size,
                                        ctypes.byref(ptr))
        if rc != 0:
            raise ObjectStoreError(rc, f"reserve {oid!r} ({size} bytes)")
        return memoryview((ctypes.c_uint8 * size).from_address(
            ctypes.addressof(ptr.contents))).cast("B")

    def seal(self, oid: ObjectID) -> None:
        rc = self._lib.objstore_seal(self._h, oid.binary)
        if rc != 0:
            raise ObjectStoreError(rc, f"seal {oid!r}")

    def abort(self, oid: ObjectID) -> None:
        self._lib.objstore_abort(self._h, oid.binary)

    def is_sealed(self, oid: ObjectID) -> Optional[bool]:
        """True = readable, False = mid-write, None = absent."""
        rc = self._lib.objstore_is_sealed(self._h, oid.binary)
        if rc == 1:
            return True
        if rc == 0:
            return False
        return None

    def reclaim_orphan(self, oid: ObjectID) -> bool:
        """Free a mid-write slot whose creator process died; False if the
        creator is still alive (or the slot isn't mid-write)."""
        return self._lib.objstore_reclaim_orphan(self._h, oid.binary) == 0

    def put_parts(self, oid: ObjectID, parts) -> None:
        """Single-copy put: writes buffer ``parts`` back-to-back via
        reserve/seal."""
        views = [p if isinstance(p, memoryview) else memoryview(p)
                 for p in parts]
        total = sum(v.nbytes for v in views)
        dst = self.reserve(oid, total)
        try:
            off = 0
            for v in views:
                dst[off:off + v.nbytes] = v.cast("B")
                off += v.nbytes
        except BaseException:
            self.abort(oid)
            raise
        self.seal(oid)

    def release(self, oid: ObjectID) -> None:
        self._lib.objstore_release(self._h, oid.binary)

    def contains(self, oid: ObjectID) -> bool:
        """True when the object is readable — in shm OR in the spill
        tier (a spilled object is present, just slow)."""
        if self._lib.objstore_contains(self._h, oid.binary):
            return True
        return self.has_spilled(oid)

    def contains_shm(self, oid: ObjectID) -> bool:
        return bool(self._lib.objstore_contains(self._h, oid.binary))

    def delete(self, oid: ObjectID) -> None:
        """Remove the object everywhere: shm segment AND spill tier
        (a deleted object is *gone*, not demoted)."""
        self._lib.objstore_delete(self._h, oid.binary)
        self._unlink_spilled(oid)

    # -- spill tier ------------------------------------------------------

    def _spill_path(self, oid: ObjectID) -> str:
        return os.path.join(self.spill_dir, oid.hex())

    def has_spilled(self, oid: ObjectID) -> bool:
        return os.path.exists(self._spill_path(oid))

    def spill(self, oid: ObjectID) -> bool:
        """Demote a sealed object to disk and free its shm slot.

        Atomic (write-temp + ``os.replace``): a crash mid-spill leaves
        either the shm copy or a complete file, never a torn object.
        The payload is STREAMED from the shm view in ``SPILL_CHUNK``
        slices — no whole-object heap copy at the worst possible moment
        (this runs under memory pressure). Pinned objects (live mapped
        readers) are never victims: returns False without demoting, and
        a reader that pins mid-stream aborts the demotion too. Returns
        False when the object is absent from shm (already spilled
        objects count as success).
        """
        if self.refcount(oid) > 0:
            return False                  # pinned: not a victim
        view = self._get_view_shm(oid)
        if view is None:
            return self.has_spilled(oid)
        path = self._spill_path(oid)
        os.makedirs(self.spill_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                for off in range(0, view.nbytes, SPILL_CHUNK):
                    f.write(view[off:off + SPILL_CHUNK])
                f.flush()
                os.fsync(f.fileno())
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        finally:
            self.release(oid)
        os.replace(tmp, path)
        rc = self._lib.objstore_delete_if_unpinned(self._h, oid.binary)
        if rc == -6:
            # a reader mapped the object while we streamed: it is not
            # spillable after all — shm stays the single source
            self._unlink_spilled(oid)
            return False
        return True

    def _read_spilled(self, oid: ObjectID) -> Optional[bytes]:
        try:
            with open(self._spill_path(oid), "rb") as f:
                return f.read()
        except OSError:
            return None

    def _unlink_spilled(self, oid: ObjectID) -> None:
        try:
            os.unlink(self._spill_path(oid))
        except OSError:
            pass

    def spilled_ids(self) -> List[str]:
        """Hex ids currently resident in the spill tier."""
        try:
            return [n for n in os.listdir(self.spill_dir)
                    if len(n) == 2 * ID_LEN]
        except OSError:
            return []

    def stats(self) -> Tuple[int, int, int]:
        """(used_bytes, num_objects, capacity)."""
        used = ctypes.c_uint64()
        n = ctypes.c_uint64()
        cap = ctypes.c_uint64()
        self._lib.objstore_stats(self._h, ctypes.byref(used), ctypes.byref(n),
                                 ctypes.byref(cap))
        return used.value, n.value, cap.value

    def close(self) -> None:
        with self._map_lock:
            h, self._h = self._h, None
            if not h:
                return
            if self._mapped_outstanding > 0:
                # live mapped reads: unlink the name but keep the pages
                # mapped so consumer views stay valid (they die with the
                # process; the kernel reclaims the memory then)
                self._lib.objstore_close_keepmap(h)
            else:
                self._lib.objstore_close(h)
        if self._created:
            # the segment's creator owns the spill tier's lifetime
            import shutil
            shutil.rmtree(self.spill_dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
