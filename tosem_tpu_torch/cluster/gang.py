"""Cluster-level gang scheduling — placement groups across node agents.

The reference schedules placement-group bundles across raylets from the
GCS (``src/ray/gcs/gcs_server/gcs_placement_group_scheduler.cc``: prepare
on every node, then commit — 2PC). Single-controller collapse: a driver
plans the bundle layout from agent capacities, then acquires per-node
reservations in **sorted address order** with rollback on failure. The
total order makes concurrent drivers deadlock-free (two gangs contending
for the same nodes cannot hold-and-wait in a cycle), which is the property
the reference's prepare/commit protocol buys with an extra round trip.

Strategies (``python/ray/util/placement_group.py`` vocabulary):

- ``pack``          fill nodes in order (fewest nodes)
- ``spread``        round-robin slots across nodes
- ``strict_pack``   all slots on one node, else fail
- ``strict_spread`` at most one slot per node, else fail

A copy of the JAX package's ``cluster/gang.py``: the same plans for the
same capacities.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

from tosem_tpu_torch.cluster.node import RemoteNode


class GangUnsatisfiable(ValueError):
    """The requested layout can never fit the given nodes."""


class GangTimeout(TimeoutError):
    """Could not acquire the gang's reservations in time."""


class GangReservation:
    """Held reservations: node address → slot count. Release once."""

    def __init__(self, pg_id: str, nodes: Dict[str, RemoteNode],
                 counts: Dict[str, int]):
        self.pg_id = pg_id
        self._nodes = nodes
        self.counts = dict(counts)
        self._released = False

    def submit(self, address: str, fn, *args, **kwargs):
        """Run ``fn`` on a reserved node, inside this gang's admission
        quota (it can use exactly its reserved slots, no more)."""
        if address not in self.counts:
            raise KeyError(f"{address} holds no slots for this gang")
        return self._nodes[address].submit(fn, *args, _pg=self.pg_id,
                                           **kwargs)

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        for addr in self.counts:
            try:
                self._nodes[addr].release(self.pg_id)
            except Exception:
                pass  # dead agent: its reservation died with it

    def __enter__(self) -> "GangReservation":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _plan(capacities: Dict[str, int], n_slots: int,
          strategy: str) -> Optional[Dict[str, int]]:
    """Bundle layout for one acquisition attempt; None = not currently
    satisfiable (caller retries), GangUnsatisfiable = never satisfiable."""
    addrs = sorted(capacities)
    total = sum(capacities.values())
    if strategy == "strict_pack":
        for a in addrs:
            if capacities[a] >= n_slots:
                return {a: n_slots}
        if all(c < n_slots for c in capacities.values()):
            return None
    if strategy == "strict_spread":
        if n_slots > len(addrs):
            raise GangUnsatisfiable(
                f"strict_spread of {n_slots} needs {n_slots} nodes, "
                f"have {len(addrs)}")
        chosen = [a for a in addrs if capacities[a] >= 1][:n_slots]
        return ({a: 1 for a in chosen} if len(chosen) == n_slots else None)
    if n_slots > total:
        return None
    counts: Dict[str, int] = {}
    if strategy == "pack":
        remaining = n_slots
        for a in addrs:
            take = min(capacities[a], remaining)
            if take:
                counts[a] = take
                remaining -= take
            if not remaining:
                return counts
        return None
    if strategy == "spread":
        remaining = n_slots
        free = dict(capacities)
        while remaining:
            progressed = False
            for a in addrs:
                if remaining and free[a] > 0:
                    counts[a] = counts.get(a, 0) + 1
                    free[a] -= 1
                    remaining -= 1
                    progressed = True
            if not progressed:
                return None
        return counts
    raise ValueError(f"unknown strategy {strategy!r}")


def reserve_gang(nodes: Sequence[RemoteNode], n_slots: int,
                 strategy: str = "pack",
                 timeout: Optional[float] = None,
                 poll_s: float = 0.25) -> GangReservation:
    """Atomically reserve ``n_slots`` across ``nodes``.

    All-or-nothing: per-node reservations are acquired in sorted address
    order; any refusal rolls back everything already held before waiting,
    so no partial hold survives a wait (deadlock freedom for concurrent
    drivers). Raises :class:`GangTimeout` after ``timeout`` seconds and
    :class:`GangUnsatisfiable` when the layout can never fit.
    """
    if n_slots <= 0:
        raise ValueError("n_slots must be positive")
    by_addr = {n.address: n for n in nodes}
    if not by_addr:
        raise GangUnsatisfiable("no nodes")
    static_cap = {a: int(by_addr[a].stats()["num_workers"])
                  for a in by_addr}
    if strategy != "strict_spread" and n_slots > sum(static_cap.values()):
        raise GangUnsatisfiable(
            f"{n_slots} slots > cluster capacity {sum(static_cap.values())}")
    if strategy == "strict_pack" and n_slots > max(static_cap.values()):
        raise GangUnsatisfiable(
            f"strict_pack of {n_slots} > largest node "
            f"{max(static_cap.values())}")
    pg_id = os.urandom(8).hex()
    deadline = time.monotonic() + timeout if timeout is not None else None
    while True:
        free = {a: int(by_addr[a].stats().get(
            "free_slots", static_cap[a])) for a in by_addr}
        plan = _plan(free, n_slots, strategy)
        if plan is not None:
            held: List[str] = []
            ok = True
            for addr in sorted(plan):           # total order: no deadlock
                if by_addr[addr].reserve(pg_id, plan[addr]):
                    held.append(addr)
                else:
                    ok = False
                    break
            if ok:
                return GangReservation(pg_id, by_addr, plan)
            for addr in held:                   # rollback before waiting
                try:
                    by_addr[addr].release(pg_id)
                except Exception:
                    pass
        if deadline is not None and time.monotonic() >= deadline:
            raise GangTimeout(
                f"could not reserve {n_slots} slots ({strategy}) within "
                f"{timeout}s")
        time.sleep(poll_s)
