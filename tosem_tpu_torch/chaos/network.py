"""Deterministic emulated network faults: partitions, slow nodes,
duplicated streams.

The port's copy of ``tosem_tpu/chaos/network.py``. Crash faults
(``kill_node``, ``crash_actor``) model a process that STOPS. Gray
failures need the other shapes: a link that silently drops both
directions (partition), a node that answers — eventually
(slow-but-alive), and a retry that delivers the same stream twice
(duplicate delivery after a lost ack). Real chaos tools inject these at
the kernel (tc netem, iptables); this single-host emulation keeps the
determinism contract of :mod:`tosem_tpu_torch.chaos` instead: fault
state lives in one process-wide :class:`NetworkState`, mutated ONLY by
chaos actions fired at deterministic event ordinals (``FaultPlan``), and
consulted by the enforcement points that model the wire:
``cluster.transport.send_tensors`` (replica→replica and rank→rank
streams: a partitioned destination drops the stream (``TransportError``),
and a pending ``dup_stream`` replays the whole stream after its COMMIT
ack — the lost-ack retry the receiver must dedupe), the head's failure
detector (``cluster.supervisor.FailureDetector``: a partitioned node's
probe fails, a slow node's is delayed) and the router's dispatch
(``serve.router.RouterCore``: a slow node's replicas answer late).

Endpoints are plain strings — node NAMES as the pool knows them, with
:data:`HEAD` naming the head side — so the state needs no knowledge of
addresses; enforcement points look up by the name they already have.
Import-light (threading only): transport and replica processes import
this without dragging in the framework.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Tuple

HEAD = "head"


class NetworkState:
    """Process-wide emulated-fault state. All mutators are idempotent
    and all readers are cheap (one lock, tiny sets) — the data plane
    consults this on hot paths, so the empty state must cost ~nothing.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._partitions: List[Tuple[frozenset, frozenset]] = []
        self._slow: Dict[str, float] = {}
        self._dup_streams = 0

    # -- mutators (chaos actions / scenarios) --------------------------

    def partition(self, nodes_a: Iterable[str],
                  nodes_b: Iterable[str]) -> None:
        """Bidirectionally sever every (a, b) pair across the cut."""
        pair = (frozenset(map(str, nodes_a)), frozenset(map(str, nodes_b)))
        with self._lock:
            if pair not in self._partitions:
                self._partitions.append(pair)

    def heal(self) -> None:
        """Remove every partition (the cut heals; traffic resumes)."""
        with self._lock:
            self._partitions.clear()

    def slow_node(self, name: str, delay_s: float) -> None:
        """Inject ``delay_s`` of latency on every probe of / dispatch to
        ``name``; ``delay_s <= 0`` clears the fault."""
        with self._lock:
            if delay_s > 0:
                self._slow[str(name)] = float(delay_s)
            else:
                self._slow.pop(str(name), None)

    def dup_stream(self, times: int = 1) -> None:
        """Arm the next ``times`` transport streams to be re-sent in
        full after their COMMIT ack (the lost-ack retry)."""
        with self._lock:
            self._dup_streams += max(0, int(times))

    def reset(self) -> None:
        with self._lock:
            self._partitions.clear()
            self._slow.clear()
            self._dup_streams = 0

    # -- readers (enforcement points) ----------------------------------

    def dropped(self, src: str, dst: str) -> bool:
        """True when ``src`` and ``dst`` sit on opposite sides of any
        active partition (either direction — partitions here are
        bidirectional; asymmetric cuts are a plan away if ever needed).
        """
        src, dst = str(src), str(dst)
        with self._lock:
            for a, b in self._partitions:
                if (src in a and dst in b) or (src in b and dst in a):
                    return True
        return False

    def delay(self, name: str) -> float:
        with self._lock:
            return self._slow.get(str(name), 0.0)

    def take_dup(self) -> bool:
        """Consume one armed duplicate (the sender asks per stream)."""
        with self._lock:
            if self._dup_streams > 0:
                self._dup_streams -= 1
                return True
            return False


_STATE = NetworkState()


def state() -> NetworkState:
    """The process-wide network-fault state (empty unless chaos armed
    it — every reader treats the empty state as a healthy network)."""
    return _STATE
