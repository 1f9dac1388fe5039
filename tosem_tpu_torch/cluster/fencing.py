"""Epoch leases + fencing tokens for head-ownership handoff.

The port's copy of ``tosem_tpu/cluster/fencing.py``.

The gray-failure hazard the journal alone cannot close: a head that is
merely PARTITIONED (not dead) keeps its journal file handle, its node
clients, and its replica clients. When a replacement head recovers from
the journal, the old head must lose the ability to mutate the cluster
the instant it heals back — otherwise both heads journal placements,
both adopt KV sequences, and two routers claim the same replica
(split-brain). The classic fix (Chubby/ZooKeeper leases, GCS epoch in
the reference's ``gcs_node_manager``) is a monotonically-increasing
epoch: every control write carries the writer's epoch, and every
receiver keeps a high-water mark, rejecting writes from the past.

Two halves, both tiny and import-light (``os`` + ``threading`` only, so
replica/agent processes can import this without dragging in torch):

- :class:`EpochFence` — the LEASE. A file next to the head journal
  holding the highest epoch ever granted. ``acquire()`` bumps it
  atomically (tmp + rename + fsync); ``check(epoch)`` raises
  :class:`StaleEpochError` when the caller's epoch has been superseded.
  ``HeadJournal.record`` checks the fence before every append, so a
  stale head's journal writes are REJECTED, not merely ignored at
  replay (replay ignores them too — defense in depth for the window
  between the bump and the stale head's next write).
- :class:`Watermark` — the RECEIVER side. An in-memory monotonic epoch
  kept by node agents (placement RPCs), replica workers (``adopt_seq``/
  migration control calls), and train workers (membership changes).
  ``check`` accepts ``None`` (an unfenced legacy caller) so every RPC
  stays backward compatible; a caller that DOES present an epoch is
  held to it.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

try:                                     # POSIX; absent on Windows
    import fcntl
except ImportError:                      # pragma: no cover
    fcntl = None  # type: ignore[assignment]


class StaleEpochError(RuntimeError):
    """A control write carried an epoch older than the receiver's
    high-water mark — the writer's lease was superseded (a newer head
    recovered). The only correct reaction is to stop writing: state
    mutated under a stale epoch is split-brain by definition."""


class EpochFence:
    """File-backed monotonic epoch lease (one file per head journal).

    The file holds a single ASCII integer: the highest epoch ever
    granted for this journal. ``acquire`` is the lease grant — read,
    increment, atomic replace, fsync — serialized across PROCESSES by
    an flock'd sibling lock file, because the heads this fence
    arbitrates between live in different processes: two heads
    recovering concurrently must be granted DISTINCT epochs, or both
    pass ``check`` and the split-brain the fence exists to prevent is
    back. The in-process mutex alone cannot provide that.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def _flocked(self):
        """Open (creating if needed) the sibling ``.lock`` file and
        take an exclusive flock on it; returns the fd or ``None`` where
        flock is unavailable. The lock file is separate from the fence
        file because ``os.replace`` swaps the fence inode out from
        under any lock held on it."""
        if fcntl is None:
            return None
        fd = os.open(f"{self.path}.lock",
                     os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
        except OSError:
            os.close(fd)
            return None
        return fd

    def read(self) -> int:
        try:
            with open(self.path, "r") as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def acquire(self) -> int:
        """Grant the next epoch: bump the fence file and return the new
        value. Crash-safe (tmp + rename, fsync'd, so a torn write can
        never roll the fence backwards) and atomic across processes
        (exclusive flock around the read-modify-replace, so concurrent
        recoveries are granted distinct epochs)."""
        with self._lock:
            lock_fd = self._flocked()
            try:
                epoch = self.read() + 1
                tmp = f"{self.path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    f.write(str(epoch))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
                return epoch
            finally:
                if lock_fd is not None:
                    fcntl.flock(lock_fd, fcntl.LOCK_UN)
                    os.close(lock_fd)

    def check(self, epoch: int) -> None:
        """Raise :class:`StaleEpochError` if ``epoch`` has been
        superseded by a later ``acquire`` (a newer head owns the
        journal now)."""
        current = self.read()
        if epoch < current:
            raise StaleEpochError(
                f"epoch {epoch} is stale: the fence at {self.path!r} "
                f"was advanced to {current} (a newer head recovered)")


class Watermark:
    """In-memory monotonic epoch watermark for control-write receivers.

    ``check(epoch)`` rejects epochs below the mark and advances it on
    newer ones; ``check(None)`` is a no-op so unfenced callers (tests,
    single-head deployments that never recovered) keep working.
    """

    def __init__(self, epoch: int = 0):
        self._lock = threading.Lock()
        self._epoch = int(epoch)

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def advance(self, epoch: int) -> int:
        with self._lock:
            self._epoch = max(self._epoch, int(epoch))
            return self._epoch

    def check(self, epoch: Optional[int], what: str = "write") -> None:
        if epoch is None:
            return
        with self._lock:
            if int(epoch) < self._epoch:
                raise StaleEpochError(
                    f"{what} carries stale epoch {epoch} < watermark "
                    f"{self._epoch}: the sender's head lease was "
                    f"superseded")
            self._epoch = max(self._epoch, int(epoch))
