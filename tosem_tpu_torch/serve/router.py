"""Router tier for the cluster serving plane.

The reference's router actors load-balance requests over replica
workers and every proxy holds a full copy of the routing table
(``serve/router.py``); same shape here. A :class:`RouterCore` is
**stateless** beyond its routing table (pushed by the controller with a
version number) and soft load caches, so routers are replicated freely:
clients hold several router addresses and fail over — a dead router
loses nothing but the requests inside it, and those are retried by the
client on a surviving router.

Routing policy (per request):

- ``key=None`` → least-loaded over the cached per-replica queue
  depths (round-robin tiebreak).
- ``key=...`` → consistent hashing over the deployment's replica ring
  (compile-cache / KV affinity: one session's requests keep landing on
  the replica whose caches are warm), **spilling over** to the
  least-loaded replica when the primary's queue depth exceeds
  ``spill_depth`` and someone else is meaningfully idler — affinity is
  a preference, not a hostage situation.

Load signal: every replica response carries the replica's in-flight
depth (see :mod:`tosem_tpu_torch.serve.replica_worker`), so the cache
refreshes for free on the data path; an explicit scrape only happens
for replicas idle longer than ``scrape_ttl_s``.

Failure semantics: a transport error (dead replica/node) excludes that
replica locally and retries the request on the remaining replicas —
re-admission from step 0, exact for the deterministic backends (greedy
decode, padded-program encode). The per-deployment breaker sees ONE
failure per logical request whatever the attempt count, mirroring the
serving plane's logical-request accounting. Application errors are never
retried and surface to the caller typed.

SLO admission (the control-plane PR): deployments with an
:class:`~tosem_tpu_torch.control.admission.SLOConfig` pushed alongside the
routing table run every request through an estimated-wait check and a
priority-class dispatch gate BEFORE the breaker — overload rejects
typed (:class:`~tosem_tpu_torch.control.admission.Overloaded`, with
``retry_after``) instead of queueing into a breaker trip, decode-class
requests preempt bulk encode in the wait queue, and per-class shed
counters feed ``serve_admission_shed_total`` and ``/-/stats``.

A copy of the JAX package's ``serve/router.py``. Router processes import
neither torch nor numpy: they forward what replicas answer.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from tosem_tpu_torch.chaos import network as _net
from tosem_tpu_torch.runtime.common import DeadlineExceeded
from tosem_tpu_torch.serve.breaker import CircuitBreaker, CircuitOpen

VNODES = 32          # hash-ring points per replica
_HEDGE_POOL_WORKERS = 16   # reusable hedge-dispatch threads per router
# how long a prefix pull's adopt waits for its stream. ``send_prefix``
# returns once the destination's receiver has parked the stream, so the
# wait is for nothing unless two pulls of one prefix into one replica
# crossed: the receiver drops the second stream as a duplicate of the
# parked first, and one adopter finds nothing (ROADMAP.md C-ref11; the
# JAX package's adopt waits its default 30 s there)
_ADOPT_TIMEOUT_S = 2.0


class NoReplicaAvailable(RuntimeError):
    """Every replica in the routing table failed (or none exist) for
    this request — the router-level analog of NodeLostError. NOT a
    ConnectionError subclass: the RPC server swallows ConnectionError
    (peer-gone handling in ``RpcServer._serve_conn``) instead of
    shipping it, and the client handle must distinguish 'no replicas'
    (typed verdict, surface it) from 'this router is dead' (fail over
    to the next router)."""


class ReplicaAppError(RuntimeError):
    """The backend raised while handling the request (application
    error: not retried; carries the remote repr)."""


def _hash64(s: str) -> int:
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")


class _Link:
    """Per-replica soft state (cached depth, dead mark) + clients.

    Clients are PER-THREAD: an RpcClient admits one in-flight call at
    a time (it holds its lock across the whole round trip), so a
    shared client would cap the router at one concurrent request per
    replica — defeating the replica's thread-per-connection server —
    and would head-of-line-block a depth scrape behind an unrelated
    in-flight call. The register keeps every thread's client reachable
    for close()."""

    def __init__(self, info: Dict[str, Any]):
        self.info = dict(info)
        self.address = info["address"]
        self._tls = threading.local()
        self._clients: List[Any] = []
        self._clients_lock = threading.Lock()
        self.depth = 0
        self.depth_ts = 0.0
        self.dead = False
        # last prefix digest this replica piggybacked on a response:
        # bounded [depth, n_tokens, hash] triples of its hottest
        # cached prefixes (None until the first decode response)
        self.prefixes = None

    def client(self):
        from tosem_tpu_torch.cluster.rpc import RpcClient
        cli = getattr(self._tls, "client", None)
        if cli is None:
            cli = RpcClient(self.address)
            self._tls.client = cli
            with self._clients_lock:
                self._clients.append(cli)
        return cli

    def close(self) -> None:
        with self._clients_lock:
            clients, self._clients = self._clients, []
        for cli in clients:
            cli.close()


class RouterPolicy:
    """Routing knobs (one object so the bench/chaos scenarios and the
    controller construct routers identically; serializes through the
    router process boundary via to_json/from_json so the knobs an
    operator configures actually reach process routers)."""

    def __init__(self, spill_depth: int = 4, scrape_ttl_s: float = 0.25,
                 failure_threshold: int = 8, cooldown_s: float = 2.0,
                 hedge_after_s: float = 0.0, hedge_quantile: float = 0.95,
                 hedge_min_samples: int = 8, prefix_routing: bool = True):
        self.spill_depth = spill_depth
        self.scrape_ttl_s = scrape_ttl_s
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        # prefix-aware routing: un-keyed decode requests prefer the
        # replica whose piggybacked digest holds their longest token
        # prefix (depth still wins: an overloaded owner spills to
        # least-loaded as usual, with a best-effort worker→worker
        # prefix transfer to the replica that got the request instead)
        self.prefix_routing = prefix_routing
        # hedging (Dean, "The Tail at Scale"): hedge_after_s > 0 arms
        # it — a request still in flight after the hedge delay is
        # re-dispatched to a SECOND replica, first success wins. The
        # delay starts at hedge_after_s and, once hedge_min_samples
        # latencies are observed for a deployment, becomes that
        # deployment's hedge_quantile latency — so hedges fire only in
        # the tail the fleet itself defines, bounding the extra load to
        # ~(1 - quantile) of traffic
        self.hedge_after_s = hedge_after_s
        self.hedge_quantile = hedge_quantile
        self.hedge_min_samples = max(1, int(hedge_min_samples))

    def to_json(self) -> str:
        import json
        return json.dumps({"spill_depth": self.spill_depth,
                           "scrape_ttl_s": self.scrape_ttl_s,
                           "failure_threshold": self.failure_threshold,
                           "cooldown_s": self.cooldown_s,
                           "hedge_after_s": self.hedge_after_s,
                           "hedge_quantile": self.hedge_quantile,
                           "hedge_min_samples": self.hedge_min_samples,
                           "prefix_routing": self.prefix_routing},
                          sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "RouterPolicy":
        import json
        return cls(**json.loads(blob))


class RouterCore:
    """One router's logic — embeddable in-process (tests, the driver)
    or behind :func:`serve_router` as its own process."""

    def __init__(self, name: str = "router0",
                 policy: Optional[RouterPolicy] = None):
        self.name = name
        self.policy = policy or RouterPolicy()
        self._lock = threading.Lock()
        self._version = -1
        self._table: Dict[str, List[_Link]] = {}
        self._rings: Dict[str, List[Tuple[int, _Link]]] = {}
        self._rr = 0
        self._breakers: Dict[str, CircuitBreaker] = {}
        # SLO admission state per deployment (configs pushed with the
        # routing table; absent deployment = no admission, the
        # pre-control-plane behavior)
        self._admission: Dict[str, Any] = {}
        self._routed = 0          # affinity/least-loaded picks honored
        self._spilled = 0         # affinity overridden by queue depth
        self._retried = 0         # transport-failure re-dispatches
        self._errors = 0          # logical requests ultimately failed
        self._hedged = 0          # hedge attempts launched
        self._hedge_wins = 0      # hedge attempts whose result was used
        self._deadline_shed = 0   # requests shed expired before dispatch
        self._prefix_routed = 0   # picks overridden by a prefix match
        self._prefix_transfers = 0       # worker→worker prefix pulls
        self._prefix_transfer_fails = 0  # pulls that fell back cold
        # per-deployment latency rings feeding the quantile-derived
        # hedge delay; suspects: node names the controller de-preferences
        self._latency: Dict[str, deque] = {}
        self._hedge_pool = None
        # admission gate for the hedge pool: one permit per pool
        # thread, so an attempt either starts immediately or spills to
        # a one-shot thread — it never queues behind abandoned losers
        # still sleeping out a gray replica's latency
        self._hedge_slots = threading.Semaphore(_HEDGE_POOL_WORKERS)
        # per-(deployment, path) totals: what the controller mirrors
        # into the DRIVER registry for process routers (whose own
        # registries no scrape endpoint serves)
        self._dep_counts: Dict[Tuple[str, str], int] = {}
        self._metrics = None

    # -- control plane -------------------------------------------------

    def update_table(self, table: Dict[str, List[Dict[str, Any]]],
                     version: int,
                     admission: Optional[Dict[str, Dict[str, Any]]] = None
                     ) -> bool:
        """Install a routing table push. Stale versions are ignored
        (controller pushes can race over different router connections).
        Links are kept per address so cached depths survive a push;
        dead marks clear — the controller believes these addresses are
        alive, and a wrong belief costs one retried request.
        ``admission`` maps deployment → serialized
        :class:`~tosem_tpu_torch.control.admission.SLOConfig`; replica-count
        changes resize each deployment's dispatch gate in place (wait
        queues survive the push)."""
        with self._lock:
            if version <= self._version:
                return False
            old_pairs = [(dep, lk) for dep, links in self._table.items()
                         for lk in links]
            old = {lk.address: lk for _, lk in old_pairs}
            new_table: Dict[str, List[_Link]] = {}
            rings: Dict[str, List[Tuple[int, _Link]]] = {}
            for dep, infos in table.items():
                links = []
                for info in infos:
                    lk = old.get(info["address"])
                    if lk is None:
                        lk = _Link(info)
                    else:
                        lk.info = dict(info)
                        lk.dead = False
                    links.append(lk)
                new_table[dep] = links
                ring = [(_hash64(f"{lk.info['replica_id']}#{v}"), lk)
                        for lk in links for v in range(VNODES)]
                rings[dep] = sorted(ring, key=lambda p: p[0])
            kept = {lk.address
                    for links in new_table.values() for lk in links}
            dropped = [(dep, lk) for dep, lk in old_pairs
                       if lk.address not in kept]
            for _, lk in {lk.address: (dep, lk)
                          for dep, lk in dropped}.values():
                lk.close()
            self._table = new_table
            self._rings = rings
            self._version = version
            self._update_admission_locked(table, admission)
        # REMOVE the departed replicas' depth series OUTSIDE the lock —
        # a gauge that keeps a dead replica's row (even at zero) forever
        # reads as a live-but-idle replica on a node that may no longer
        # exist
        m = self._metrics_dict()
        for dep, lk in dropped:
            m["replica_queue_depth"].remove(
                (dep, lk.info.get("node", "?"),
                 lk.info.get("replica_id", lk.address)))
        return True

    def _update_admission_locked(
            self, table: Dict[str, List[Dict[str, Any]]],
            admission: Optional[Dict[str, Dict[str, Any]]]) -> None:
        """Refresh per-deployment admission controllers against the new
        table. ``admission=None`` keeps the existing configs (a plain
        table push must not drop the SLOs installed by an earlier one);
        deployments that left the table lose their state."""
        from tosem_tpu_torch.control.admission import (AdmissionController,
                                                 SLOConfig)
        shards: Dict[str, int] = {}
        if admission is not None:
            for dep, cfg in admission.items():
                cur = self._admission.get(dep)
                slo = SLOConfig.from_dict(cfg)
                shards[dep] = max(1, int(cfg.get("_shards", 1)))
                if cur is None or cur.slo.to_dict() != slo.to_dict():
                    self._admission[dep] = AdmissionController(
                        dep, slo, replicas=len(table.get(dep, ())) or 1,
                        shards=shards[dep],
                        on_shed=self._make_shed_observer(dep))
            for dep in [d for d in self._admission
                        if d not in admission]:
                del self._admission[dep]
        for dep, adm in self._admission.items():
            if dep in table:
                adm.update_replicas(len(table[dep]) or 1,
                                    shards=shards.get(dep))

    def _make_shed_observer(self, dep: str):
        def observe(klass: str, reason: str) -> None:
            self._metrics_dict()["admission_shed"].inc(
                1.0, (dep, klass, reason))
        return observe

    def table_version(self) -> int:
        with self._lock:
            return self._version

    def health(self) -> Dict[str, Any]:
        return {"ok": True, "pid": os.getpid(), "name": self.name}

    # -- picks ---------------------------------------------------------

    def _fresh_depth(self, lk: _Link) -> int:
        """Cached depth, scraping only when stale (idle replicas stop
        piggybacking, so a bounded scrape keeps the view honest)."""
        now = time.monotonic()
        if now - lk.depth_ts <= self.policy.scrape_ttl_s or lk.dead:
            return lk.depth
        try:
            lk.depth = int(lk.client().call("load"))
            lk.depth_ts = now
        except Exception:
            pass        # stale depth is fine; route() handles dead links
        return lk.depth

    def _least_loaded(self, links: List[_Link], exclude: set) -> _Link:
        live = [lk for lk in links
                if lk.address not in exclude and not lk.dead]
        if not live:
            # every replica is marked dead/tried: fall back to anything
            # not yet tried this request — a restarted replica at an old
            # address answers, a corpse fails fast into the next retry
            live = [lk for lk in links if lk.address not in exclude]
        if not live:
            raise NoReplicaAvailable("all replicas tried")
        with self._lock:
            self._rr += 1
            order = self._rr
        # least-loaded with round-robin tiebreak: equal-depth replicas
        # share fresh traffic instead of one absorbing it all. Replicas
        # on SUSPECT nodes (failure detector missed a probe — gray, not
        # yet dead) rank behind every healthy one: they still serve as
        # a last resort, but fresh traffic prefers nodes answering
        # their heartbeats
        n = len(live)
        i = min(range(n), key=lambda j: (
            1 if live[j].info.get("suspect") else 0,
            self._fresh_depth(live[j]), (j - order) % n))
        return live[i]

    def _pick(self, dep: str, key: Optional[str],
              exclude: set) -> Tuple[_Link, bool]:
        """(link, spilled?) for one attempt."""
        with self._lock:
            links = list(self._table.get(dep, ()))
            ring = self._rings.get(dep, ())
        if not links:
            raise NoReplicaAvailable(f"no replicas for deployment {dep!r}")
        if key is None:
            return self._least_loaded(links, exclude), False
        h = _hash64(str(key))
        primary = None
        if ring:
            # first ring point clockwise of the key's hash
            lo, hi = 0, len(ring)
            while lo < hi:
                mid = (lo + hi) // 2
                if ring[mid][0] < h:
                    lo = mid + 1
                else:
                    hi = mid
            primary = ring[lo % len(ring)][1]
        if (primary is not None and primary.address not in exclude
                and not primary.dead):
            if primary.info.get("suspect"):
                # affinity defers to suspicion: a warm cache on a node
                # that stopped answering heartbeats is not worth the
                # gray-latency risk — spill to a healthy replica and
                # let a cleared suspicion restore affinity
                best = self._least_loaded(links, exclude)
                if best is not primary:
                    return best, True
                return primary, False
            depth = self._fresh_depth(primary)
            if depth < self.policy.spill_depth:
                return primary, False
            best = self._least_loaded(links, exclude)
            if best is not primary and self._fresh_depth(best) < depth:
                return best, True       # spillover: affinity overridden
            return primary, False
        return self._least_loaded(links, exclude), False

    # -- prefix-aware routing ------------------------------------------

    def _prefix_match(self, links: List[_Link], ids) -> Optional[tuple]:
        """Deepest piggybacked digest entry that prefixes ``ids``
        while leaving >= 1 suffix token: ``(link, depth, n_tokens,
        hash)``, or None. Each candidate length hashes once however
        many replicas advertise it."""
        from tosem_tpu_torch.serve.prefix_cache import prefix_hash
        best = None
        hashed: Dict[int, str] = {}
        for lk in links:
            if lk.dead or not lk.prefixes:
                continue
            for ent in lk.prefixes:
                try:
                    depth, n_tok, h = (int(ent[0]), int(ent[1]),
                                       str(ent[2]))
                except (TypeError, ValueError, IndexError):
                    continue
                if not 0 < n_tok < len(ids):
                    continue
                if best is not None and n_tok <= best[2]:
                    continue
                want = hashed.get(n_tok)
                if want is None:
                    want = hashed[n_tok] = prefix_hash(ids[:n_tok])
                if want == h:
                    best = (lk, depth, n_tok, h)
        return best

    def _apply_prefix_routing(self, deployment: str, request: Any,
                              key: Optional[str], lk: _Link,
                              spilled: bool,
                              tried: set) -> Tuple[_Link, bool]:
        """Longest-prefix override of one pick. An un-keyed decode
        request reroutes to the replica advertising its deepest cached
        prefix — unless that owner is suspect or past ``spill_depth``
        (load still wins, exactly like affinity spill). When the pick
        stands but another replica owns the prefix (keyed affinity, or
        an overloaded owner), the matched pages are pulled worker→
        worker into the picked replica first, so its admit prefills
        only the suffix instead of recomputing the whole prompt."""
        if not self.policy.prefix_routing or not isinstance(request, dict):
            return lk, spilled
        ids = request.get("ids")
        if not isinstance(ids, (list, tuple)) or len(ids) < 2:
            return lk, spilled
        with self._lock:
            links = [l for l in self._table.get(deployment, ())
                     if l.address not in tried]
        best = self._prefix_match(links, ids)
        if best is None or best[0] is lk:
            return lk, spilled
        owner, depth, _, h = best
        if (key is None and not owner.info.get("suspect")
                and self._fresh_depth(owner) < self.policy.spill_depth):
            with self._lock:
                self._prefix_routed += 1
            return owner, spilled
        self._transfer_prefix(owner, lk, depth, h)
        return lk, spilled

    def _transfer_prefix(self, owner: _Link, dst: _Link, depth: int,
                         h: str) -> None:
        """Best-effort worker→worker prefix pull (owner streams the
        pages to ``dst``'s tensor receiver, ``dst`` indexes them).
        Failure just means a cold prefill — never the request's
        verdict."""
        try:
            addr = getattr(dst, "_transport_addr", None)
            if addr is None:
                addr = dst.client().call("backend_call",
                                         "transport_address")
                dst._transport_addr = addr
            owner.client().call("backend_call", "send_prefix",
                                depth, h, addr)
            dst.client().call("backend_call", "adopt_prefix", h,
                              timeout=_ADOPT_TIMEOUT_S)
            with self._lock:
                self._prefix_transfers += 1
        except Exception:
            with self._lock:
                self._prefix_transfer_fails += 1

    # -- data plane ----------------------------------------------------

    def _breaker(self, dep: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(dep)
            if br is None:
                br = self._breakers[dep] = CircuitBreaker(
                    failure_threshold=self.policy.failure_threshold,
                    cooldown_s=self.policy.cooldown_s)
            return br

    def route(self, deployment: str, request: Any,
              key: Optional[str] = None,
              klass: Optional[str] = None,
              timeout_s: Optional[float] = None) -> Any:
        """Route one logical request; returns the backend's value.
        ``klass`` names the request's priority class for deployments
        with SLO admission (unknown/None ranks 0 — bulk).

        ``timeout_s`` is the request's end-to-end deadline budget:
        expired work sheds as typed :class:`DeadlineExceeded` BEFORE
        dispatch (and before admission — a request nobody is waiting
        for must not occupy an admission slot or a replica), and every
        retry re-checks the remaining budget."""
        if timeout_s is not None and timeout_s <= 0:
            with self._lock:
                self._deadline_shed += 1
            raise DeadlineExceeded(
                f"request to {deployment!r} arrived with an expired "
                f"deadline budget ({timeout_s:.3f}s)")
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._lock:
            adm = self._admission.get(deployment)
        if adm is None:
            return self._route_admitted(deployment, request, key,
                                        deadline=deadline)
        # admission BEFORE the breaker: a shed is a typed capacity
        # verdict (Overloaded, retry_after), not backend-failure
        # evidence — it must neither trip the breaker nor occupy a
        # half-open probe slot
        adm.admit(klass)               # may raise Overloaded
        try:
            return self._route_admitted(deployment, request, key,
                                        deadline=deadline)
        finally:
            adm.release()

    # -- dispatch helpers ----------------------------------------------

    def _call_replica(self, lk: _Link, request: Any) -> Dict[str, Any]:
        """One dispatch to one replica. The emulated network's
        slow-node fault applies HERE — gray latency on the wire to a
        slow node's replicas, which is exactly the tail the hedge
        delay must cover."""
        gray = _net.state().delay(lk.info.get("node", ""))
        if gray > 0:
            time.sleep(gray)
        return lk.client().call("call", request)

    def _hedge_delay(self, deployment: str) -> Optional[float]:
        """None when hedging is disarmed; otherwise the current hedge
        delay — the policy floor until enough latencies are observed,
        then the deployment's own hedge_quantile latency."""
        if self.policy.hedge_after_s <= 0:
            return None
        with self._lock:
            ring = self._latency.get(deployment)
            samples = sorted(ring) if ring else []
        if len(samples) < self.policy.hedge_min_samples:
            return self.policy.hedge_after_s
        q = min(max(self.policy.hedge_quantile, 0.0), 1.0)
        idx = min(len(samples) - 1, int(q * len(samples)))
        return max(samples[idx], 1e-4)

    def _record_latency(self, deployment: str, elapsed: float) -> None:
        with self._lock:
            ring = self._latency.get(deployment)
            if ring is None:
                ring = self._latency[deployment] = deque(maxlen=128)
            ring.append(elapsed)

    def _call_hedged(self, deployment: str, lk: _Link, spilled: bool,
                     request: Any, tried: set, delay: float,
                     deadline: Optional[float]):
        """First-wins hedged dispatch: launch the primary, wait the
        hedge delay, and if it has not returned launch ONE hedge on a
        different replica. The first SUCCESS wins; the loser is
        abandoned (its late result is discarded — duplicate-retire is
        safe because the data-plane backends are idempotent per
        request: deterministic encode/decode, per-(seq, step) outcome
        ledgers on the stateful paths). Returns ``(out, winner_link,
        spilled, attempt_s)`` — ``attempt_s`` is the winning attempt's
        own dispatch latency; on total failure re-raises with every
        corpse marked so the outer retry loop moves on."""
        cv = threading.Condition()
        outcomes: List[tuple] = []

        def attempt(link: _Link) -> None:
            a0 = time.monotonic()
            try:
                res = (link, True, self._call_replica(link, request),
                       time.monotonic() - a0)
            except BaseException as e:
                res = (link, False, e, 0.0)
            with cv:
                outcomes.append(res)
                cv.notify_all()

        self._dispatch_attempt(attempt, lk)
        wait = delay
        if deadline is not None:
            wait = min(wait, max(0.0, deadline - time.monotonic()))
        with cv:
            cv.wait_for(lambda: outcomes, timeout=wait)
            launched = 1
        if not outcomes:
            second = None
            try:
                second, _ = self._pick(deployment, None,
                                       tried | {lk.address})
            except NoReplicaAvailable:
                second = None
            if second is not None and second.address != lk.address:
                with self._lock:
                    self._hedged += 1
                self._metrics_dict()["router_hedges"].inc(
                    1.0, (deployment, "fired"))
                self._dispatch_attempt(attempt, second)
                launched = 2
        while True:
            with cv:
                wins = [o for o in outcomes if o[1]]
                if wins:
                    winner = wins[0]
                    break
                if len(outcomes) >= launched:
                    winner = None
                    break
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    with self._lock:
                        self._deadline_shed += 1
                    raise DeadlineExceeded(
                        f"request to {deployment!r} exceeded its "
                        "deadline budget mid-hedge")
                cv.wait(timeout=remaining)
        if winner is not None:
            wlk = winner[0]
            if launched == 2 and wlk is not lk:
                with self._lock:
                    self._hedge_wins += 1
                self._metrics_dict()["router_hedges"].inc(
                    1.0, (deployment, "won"))
            # the ring gets the winning ATTEMPT's latency, not the
            # client-observed total: a hedged winner's total embeds the
            # hedge delay itself, and a quantile fed its own delay
            # ratchets upward until hedging self-disables
            return winner[2], wlk, spilled, winner[3]
        # every launched attempt failed: mark transport corpses, then
        # surface an application error if one occurred (never retried),
        # else the primary's transport error (outer loop retries)
        app_err = None
        conn_err = None
        for link, _ok, exc, _t in outcomes:
            if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
                link.dead = True
                tried.add(link.address)
                conn_err = conn_err or exc
            else:
                app_err = app_err or exc
        raise app_err or conn_err

    def _pool(self):
        """Lazy dispatch pool for hedged attempts (worker threads are
        reused, so per-thread RPC clients are too)."""
        with self._lock:
            if self._hedge_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._hedge_pool = ThreadPoolExecutor(
                    max_workers=_HEDGE_POOL_WORKERS,
                    thread_name_prefix=f"tosem-hedge-{self.name}")
            return self._hedge_pool

    def _dispatch_attempt(self, fn, link) -> None:
        """Start one hedged attempt WITHOUT ever queueing it. Pool
        threads are preferred (reused RPC clients), but a loser
        abandoned on a gray replica holds its thread for that replica's
        full latency — under a slow-node fault the pool fills with
        sleeping corpses, and a queued PRIMARY would inherit their
        delay, re-creating the very tail hedging exists to cut. When no
        pool permit is free the attempt runs on a one-shot thread
        instead."""
        if self._hedge_slots.acquire(blocking=False):
            def run(lk=link):
                try:
                    fn(lk)
                finally:
                    self._hedge_slots.release()
            self._pool().submit(run)
        else:
            threading.Thread(
                target=fn, args=(link,), daemon=True,
                name=f"tosem-hedge-spill-{self.name}").start()

    def _route_admitted(self, deployment: str, request: Any,
                        key: Optional[str] = None,
                        deadline: Optional[float] = None) -> Any:
        br = self._breaker(deployment)
        probe = br.allow()              # may raise CircuitOpen
        tried: set = set()
        t0 = time.monotonic()
        try:
            while True:
                if deadline is not None and time.monotonic() >= deadline:
                    # budget burnt walking corpses: shed typed, no
                    # breaker verdict (a deadline is the CALLER's
                    # constraint, not backend-failure evidence)
                    with self._lock:
                        self._deadline_shed += 1
                    raise DeadlineExceeded(
                        f"request to {deployment!r} exceeded its "
                        "deadline budget before dispatch")
                try:
                    lk, spilled = self._pick(deployment, key, tried)
                    lk, spilled = self._apply_prefix_routing(
                        deployment, request, key, lk, spilled, tried)
                except NoReplicaAvailable:
                    with self._lock:
                        self._errors += 1
                    br.record_failure(probe=probe)
                    probe = False
                    raise
                hedge_delay = self._hedge_delay(deployment)
                attempt_s = None
                try:
                    if hedge_delay is None:
                        out = self._call_replica(lk, request)
                    else:
                        out, lk, spilled, attempt_s = self._call_hedged(
                            deployment, lk, spilled, request, tried,
                            hedge_delay, deadline)
                except DeadlineExceeded:
                    raise
                except (ConnectionError, TimeoutError, OSError):
                    # transport loss: the replica (or its node) is gone.
                    # Exclude it locally — the controller's next table
                    # push re-homes it — and re-admit the request from
                    # step 0 on a survivor. One logical request, one
                    # eventual breaker verdict (below), however many
                    # corpses it walked past.
                    lk.dead = True
                    tried.add(lk.address)
                    with self._lock:
                        self._retried += 1
                    continue
                except Exception as e:
                    # application error (RpcError): the backend itself
                    # failed this request — never retried, one breaker
                    # trip, typed for the caller
                    with self._lock:
                        self._errors += 1
                    br.record_failure(probe=probe)
                    probe = False
                    raise ReplicaAppError(str(e)) from None
                lk.depth = int(out.get("load", 0))
                lk.depth_ts = time.monotonic()
                prefixes = out.get("prefixes")
                if prefixes is not None:
                    lk.prefixes = prefixes
                with self._lock:
                    if spilled:
                        self._spilled += 1
                    else:
                        self._routed += 1
                    ckey = (deployment,
                            "spilled" if spilled else "routed")
                    self._dep_counts[ckey] = \
                        self._dep_counts.get(ckey, 0) + 1
                br.record_success(probe=probe)
                probe = False
                self._record_latency(
                    deployment,
                    attempt_s if attempt_s is not None
                    else time.monotonic() - t0)
                self._observe(deployment, lk, spilled)
                return out["value"]
        except BaseException:
            if probe:
                # a probe abandoned WITHOUT a verdict (an unexpected
                # raise before any record call) must not wedge the
                # breaker half-open; probe flips False the moment a
                # record call consumes it, so this can never free a
                # slot some other request now owns
                br.release_probe()
            raise

    # -- telemetry -----------------------------------------------------

    def _metrics_dict(self):
        if self._metrics is None:
            from tosem_tpu_torch.obs.metrics import cluster_serve_metrics
            self._metrics = cluster_serve_metrics()
        return self._metrics

    def _observe(self, deployment: str, lk: _Link, spilled: bool) -> None:
        """Feed the cluster serving instruments in THIS router's
        process registry (the driver's, for in-proc routers)."""
        m = self._metrics_dict()
        info = lk.info
        m["router_requests"].inc(
            1.0, (deployment, self.name, "spilled" if spilled else "routed"))
        m["replica_queue_depth"].set(
            lk.depth, (deployment, info.get("node", "?"),
                       info.get("replica_id", lk.address)))

    def stats(self) -> Dict[str, Any]:
        """Router-tier snapshot: routed-vs-spilled counters plus the
        per-node queue-depth rollup the controller aggregates."""
        with self._lock:
            links = [(dep, lk) for dep, ls in self._table.items()
                     for lk in ls]
            out = {"name": self.name, "version": self._version,
                   "routed": self._routed, "spilled": self._spilled,
                   "retried": self._retried, "errors": self._errors,
                   "hedged": self._hedged,
                   "hedge_wins": self._hedge_wins,
                   "deadline_shed": self._deadline_shed,
                   "prefix_routed": self._prefix_routed,
                   "prefix_transfers": self._prefix_transfers,
                   "prefix_transfer_fails":
                       self._prefix_transfer_fails}
            requests: Dict[str, Dict[str, int]] = {}
            for (dep, path), n in self._dep_counts.items():
                requests.setdefault(dep, {})[path] = n
            out["requests"] = requests
            out["admission"] = {dep: adm.stats()
                                for dep, adm in self._admission.items()}
        per_node: Dict[str, int] = {}
        replicas = {}
        for dep, lk in links:
            node = lk.info.get("node", "?")
            per_node[node] = per_node.get(node, 0) + lk.depth
            replicas[lk.info.get("replica_id", lk.address)] = {
                "deployment": dep, "node": node, "depth": lk.depth,
                "dead": lk.dead}
        out["node_queue_depth"] = per_node
        out["replicas"] = replicas
        return out

    def close(self) -> None:
        with self._lock:
            links = [lk for ls in self._table.values() for lk in ls]
            pool, self._hedge_pool = self._hedge_pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        for lk in links:
            lk.close()


# --------------------------------------------------------- process entry


def serve_router(port: int = 0, announce_fd: Optional[int] = None,
                 name: str = "router",
                 lifeline_fd: Optional[int] = None,
                 policy: Optional[RouterPolicy] = None) -> None:
    """Run one router until killed, or until the lifeline pipe hits
    EOF (the write end lives in the spawning controller — a crashed
    driver must not leave orphan routers; same contract as
    :mod:`tosem_tpu_torch.serve.replica_worker`)."""
    from tosem_tpu_torch.cluster.rpc import RpcServer
    core = RouterCore(name=name, policy=policy)
    server = RpcServer(core, port=port)
    line = f"{server.address}\n".encode()
    if announce_fd is not None:
        os.write(announce_fd, line)
        os.close(announce_fd)
    else:
        sys.stdout.write(line.decode())
        sys.stdout.flush()
    try:
        if lifeline_fd is not None:
            while os.read(lifeline_fd, 1):
                pass
        else:
            while True:
                time.sleep(3600)
    except (KeyboardInterrupt, OSError):
        pass
    finally:
        server.shutdown()
        core.close()


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    port, announce_fd, lifeline_fd, name = 0, None, None, "router"
    policy: Optional[RouterPolicy] = None
    i = 0
    while i < len(args):
        if args[i] == "--port":
            port = int(args[i + 1]); i += 2
        elif args[i] == "--announce-fd":
            announce_fd = int(args[i + 1]); i += 2
        elif args[i] == "--lifeline-fd":
            lifeline_fd = int(args[i + 1]); i += 2
        elif args[i] == "--name":
            name = args[i + 1]; i += 2
        elif args[i] == "--policy":
            policy = RouterPolicy.from_json(args[i + 1]); i += 2
        else:
            print(f"unknown arg {args[i]}", file=sys.stderr)
            return 2
    serve_router(port=port, announce_fd=announce_fd, name=name,
                 lifeline_fd=lifeline_fd, policy=policy)
    return 0


class RemoteRouter:
    """Driver/client-side handle to a router process.

    ``route`` uses a per-thread client: a 16-thread client fleet must
    pipeline through the router's thread-per-connection server, not
    serialize on one socket's in-flight lock."""

    def __init__(self, address: str, name: str = "router"):
        self.address = address
        self.name = name
        self._proc: Optional[subprocess.Popen] = None
        self._lifeline: Optional[int] = None
        self._tls = threading.local()
        self._control = None
        self._control_lock = threading.Lock()

    def _client(self):
        from tosem_tpu_torch.cluster.rpc import RpcClient
        cli = getattr(self._tls, "client", None)
        if cli is None:
            cli = self._tls.client = RpcClient(self.address)
        return cli

    def _ctl(self):
        from tosem_tpu_torch.cluster.rpc import RpcClient
        with self._control_lock:
            if self._control is None:
                self._control = RpcClient(self.address)
            return self._control

    # data plane (per-thread connection)
    def route(self, deployment: str, request: Any,
              key: Optional[str] = None,
              klass: Optional[str] = None,
              timeout_s: Optional[float] = None) -> Any:
        return self._client().call("route", deployment, request, key,
                                   klass, timeout_s)

    # control plane (shared connection; controller is single-threaded
    # per router)
    def update_table(self, table: Dict[str, Any], version: int,
                     admission: Optional[Dict[str, Any]] = None) -> bool:
        return bool(self._ctl().call("update_table", table, version,
                                     admission))

    def stats(self) -> Dict[str, Any]:
        return self._ctl().call("stats")

    def table_version(self) -> int:
        return int(self._ctl().call("table_version"))

    def alive(self, timeout: float = 5.0) -> bool:
        from tosem_tpu_torch.cluster.rpc import RpcClient
        try:
            with RpcClient(self.address, timeout=timeout,
                           call_timeout=timeout) as probe:
                return bool(probe.call("health").get("ok"))
        except Exception:
            return False

    @classmethod
    def spawn_local(cls, name: str = "router",
                    startup_timeout: float = 60.0,
                    policy: Optional[RouterPolicy] = None
                    ) -> "RemoteRouter":
        """Boot a router subprocess on this host and connect to it.
        ``policy`` ships over argv — the knobs an operator configures
        on the controller must reach the process router, not silently
        fall back to defaults."""
        from tosem_tpu_torch.cluster.node import die_with_parent, read_announce
        r, w = os.pipe()
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get(
            "PYTHONPATH", "")
        life_r, life_w = os.pipe()
        argv = [sys.executable, "-c",
                "from tosem_tpu_torch.serve.router import main; main()",
                "--announce-fd", str(w), "--name", name,
                "--lifeline-fd", str(life_r)]
        if policy is not None:
            argv += ["--policy", policy.to_json()]
        proc = subprocess.Popen(argv, pass_fds=(w, life_r), env=env,
                                preexec_fn=die_with_parent)
        os.close(w)
        os.close(life_r)
        line = read_announce(r, startup_timeout)
        if not line.endswith(b"\n"):
            proc.kill()
            proc.wait()
            os.close(life_w)
            raise RuntimeError(f"router {name!r} failed to announce "
                               f"within {startup_timeout}s")
        router = cls(line.decode().strip(), name=name)
        router._proc = proc
        router._lifeline = life_w
        return router

    def kill(self) -> None:
        """Simulated router death (SIGKILL)."""
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self.close()

    def close(self) -> None:
        with self._control_lock:
            if self._control is not None:
                self._control.close()
                self._control = None
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
        if self._lifeline is not None:
            try:
                os.close(self._lifeline)
            except OSError:
                pass
            self._lifeline = None
