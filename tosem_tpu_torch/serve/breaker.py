"""Per-deployment circuit breaker (closed / open / half-open).

The standard pattern (Nygard's "Release It!", the Hystrix/Envoy
outlier-detection role): after ``failure_threshold`` consecutive
failures the breaker OPENS and rejects requests instantly with
:class:`CircuitOpen` — protecting callers from piling onto a deployment
that is down, and the deployment from a retry storm while it restarts
replicas. After ``cooldown_s`` one probe request is admitted
(HALF_OPEN); its success closes the breaker, its failure re-opens it
and restarts the cool-down.

The clock is injectable so breaker tests are instant and deterministic
(the same replayability contract as :mod:`tosem_tpu_torch.chaos`). The
port's copy of ``tosem_tpu/serve/breaker.py``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitOpen(RuntimeError):
    """Request rejected without dispatch: the deployment's breaker is
    open (too many consecutive failures; retry after the cool-down)."""


class CircuitBreaker:
    """Thread-safe three-state breaker.

    Contract: call :meth:`allow` before dispatch (raises
    :class:`CircuitOpen` when rejecting) and keep its return value —
    True means *this request is the half-open probe*. Then exactly one
    of :meth:`record_success` / :meth:`record_failure` per allowed
    request, passing ``probe=`` what allow() returned; a probe
    abandoned without a verdict calls :meth:`release_probe`. Probe
    ownership is per-request so a stale non-probe request finishing
    late can never free or fail a probe it doesn't own.
    """

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """Admit or reject a request. Returns True when the admitted
        request is the half-open probe (the caller must echo that via
        ``probe=`` on its record call, or :meth:`release_probe`)."""
        with self._lock:
            if self._state == CLOSED:
                return False
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    # cool-down elapsed: admit ONE probe
                    self._state = HALF_OPEN
                    self._probe_in_flight = True
                    return True
                raise CircuitOpen(
                    f"circuit open ({self._consecutive_failures} consecutive "
                    f"failures); retry after the "
                    f"{self.cooldown_s}s cool-down")
            # HALF_OPEN: only the single probe may pass
            if self._probe_in_flight:
                raise CircuitOpen("circuit half-open: probe in flight")
            self._probe_in_flight = True
            return True

    def release_probe(self) -> None:
        """Give up a PROBE (allow() returned True) without a verdict —
        e.g. the caller's wait timed out while the request may still
        land later. The probe slot is freed and the breaker returns to
        OPEN with its original open timestamp, so the next allow() can
        admit a fresh probe immediately; without this, an abandoned
        probe would wedge the breaker in 'probe in flight' forever.
        Only the probe's owner may call this (non-probe requests have
        nothing to release)."""
        with self._lock:
            if not self._probe_in_flight:
                return
            self._probe_in_flight = False
            if self._state == HALF_OPEN:
                self._state = OPEN

    def record_success(self, probe: bool = False) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if probe:
                self._probe_in_flight = False
            # any success is live evidence the backend serves requests
            self._state = CLOSED

    def record_failure(self, probe: bool = False, count: int = 1) -> None:
        """``count``: how many LOGICAL requests this failure represents.
        A 16-request micro-batch lost to a replica crash is 16 trips of
        evidence, not one dispatch — the batching data plane passes the
        batch's logical size so the breaker's view of the backend stays
        request-accurate (one lock hold either way). ``probe`` still
        applies once: a batch can carry at most one probe slot."""
        if count < 1:
            raise ValueError("count must be >= 1")
        with self._lock:
            self._consecutive_failures += count
            if probe:
                self._probe_in_flight = False
            if probe and self._state == HALF_OPEN:
                # the probe's verdict decides the half-open outcome —
                # but only while the breaker is STILL half-open; if a
                # concurrent success already closed it, the backend is
                # demonstrably serving and one failure must clear the
                # threshold like any other
                self._state = OPEN
                self._opened_at = self._clock()
            elif (self._state == CLOSED
                  and self._consecutive_failures >= self.failure_threshold):
                self._state = OPEN
                self._opened_at = self._clock()
            # non-probe failures while OPEN/HALF_OPEN only add to the
            # count — a stale request must not restart the cool-down or
            # steal the in-flight probe's verdict
