"""Cluster serving plane: node-spanning deployments behind a router tier.

The reference serves traffic across a cluster — a controller places
backend replicas on raylets, router/proxy actors load-balance over
them, and the GCS re-homes replicas when a node dies. This module is
that composition for OUR substrate: :class:`ClusterServe` turns a
deployment into a node-spanning service over the cluster plane
(:mod:`tosem_tpu_torch.cluster`).

Three layers:

- **Placement** — replicas spread (or packed) across
  :class:`~tosem_tpu_torch.cluster.supervisor.NodePool` nodes using the
  per-node capacity the agents report (``replica_slots_free``), with
  every placement journaled through the pool's
  :class:`~tosem_tpu_torch.cluster.supervisor.HeadJournal` so
  :meth:`ClusterServe.recover` can rebuild a crashed head's routing
  table. A deployment may declare ``sharding=(dp, tp)``: each logical
  replica then runs a dp×tp mesh of positions on its own device (the
  backend receives ``dp``/``tp``, e.g.
  :func:`~tosem_tpu_torch.parallel.flash.sharded_flash_attention`), with
  ``dp*tp`` node slots withheld from the task plane via a
  :mod:`~tosem_tpu_torch.cluster.gang` reservation.
- **Routing** — replicated, stateless
  :class:`~tosem_tpu_torch.serve.router.RouterCore` processes in front
  (consistent-hash affinity with queue-depth-aware spillover); the
  controller pushes versioned routing tables, clients fail over across
  routers (:class:`ClusterHandle`).
- **Failover** — the pool's failure detector declares a node dead →
  this controller drops its replicas from the table (pushed
  immediately, so routers stop picking corpses), journals the
  removals, and re-places the replicas on surviving nodes under the
  same replica ids (the consistent-hash ring stays stable). Requests
  in flight on the dead node are re-admitted from step 0 by the
  routers — exact for the deterministic backends (greedy decode,
  padded-program encode), one breaker trip per logical request.

Chaos seam: ``serve.route`` fires per client request routed through a
:class:`ClusterHandle` (actions ``kill_router`` / ``kill_node`` /
``slow_node``), so the canned ``router-chaos`` plan can kill a router
mid-traffic and then a replica node, and ``slow-node-hedge`` can turn
one replica's node gray (alive but slow), deterministically.

A copy of the JAX package's ``serve/cluster_serve.py``; its replicas are
``tosem_tpu_torch.serve.replica_worker`` processes, so a backend named
by ``"module:qualname"`` must be importable there.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from tosem_tpu_torch.chaos import hooks as _chaos
from tosem_tpu_torch.chaos import network as _net
from tosem_tpu_torch.cluster.fencing import StaleEpochError
from tosem_tpu_torch.cluster.gang import GangReservation, _plan, reserve_gang
from tosem_tpu_torch.cluster.node import RemoteNode
from tosem_tpu_torch.cluster.supervisor import NodePool
from tosem_tpu_torch.control.admission import Overloaded, SLOConfig
from tosem_tpu_torch.runtime.common import DeadlineExceeded
from tosem_tpu_torch.serve.breaker import CircuitOpen
from tosem_tpu_torch.serve.router import (NoReplicaAvailable, RemoteRouter,
                                    ReplicaAppError, RouterCore,
                                    RouterPolicy)


class PlacementError(RuntimeError):
    """The requested replica layout does not fit the live nodes'
    reported capacity."""


class ClusterReplica:
    """One placed replica: id, host node, direct RPC address, and (for
    sharded replicas) the gang reservation withholding its slots."""

    def __init__(self, replica_id: str, deployment: str, node: str,
                 address: str, devices: int = 0,
                 gang: Optional[GangReservation] = None):
        self.replica_id = replica_id
        self.deployment = deployment
        self.node = node
        self.address = address
        self.devices = devices
        self.gang = gang

    def info(self) -> Dict[str, Any]:
        return {"replica_id": self.replica_id, "node": self.node,
                "address": self.address, "devices": self.devices}


class ClusterDeployment:
    """Spec + live placements of one node-spanning deployment."""

    def __init__(self, name: str, backend_ref: str,
                 init_kwargs: Dict[str, Any], num_replicas: int,
                 strategy: str, sharding: Optional[Tuple[int, int]],
                 warmup_shapes: Optional[Sequence] = None,
                 slo: Optional[SLOConfig] = None):
        self.name = name
        self.backend_ref = backend_ref
        self.init_kwargs = dict(init_kwargs)
        self.num_replicas = num_replicas
        self.strategy = strategy
        self.sharding = tuple(sharding) if sharding else None
        self.warmup_shapes = list(warmup_shapes or [])
        self.slo = slo
        self.replicas: List[ClusterReplica] = []

    @property
    def devices_per_replica(self) -> int:
        return (self.sharding[0] * self.sharding[1]
                if self.sharding else 0)

    def spec(self) -> Dict[str, Any]:
        """Journal-serializable deployment spec (what recover replays)."""
        return {"deployment": self.name, "backend_ref": self.backend_ref,
                "init_kwargs": json.dumps(self.init_kwargs,
                                          sort_keys=True),
                "num_replicas": self.num_replicas,
                "strategy": self.strategy,
                "sharding": list(self.sharding) if self.sharding else None,
                "warmup_shapes": self.warmup_shapes,
                "slo": self.slo.to_dict() if self.slo else None}

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "ClusterDeployment":
        return cls(spec["deployment"], spec["backend_ref"],
                   json.loads(spec.get("init_kwargs") or "{}"),
                   int(spec["num_replicas"]), spec.get("strategy", "spread"),
                   tuple(spec["sharding"]) if spec.get("sharding") else None,
                   spec.get("warmup_shapes") or [],
                   slo=(SLOConfig.from_dict(spec["slo"])
                        if spec.get("slo") else None))


def plan_replicas(capacities: Dict[str, int], num_replicas: int,
                  strategy: str = "spread") -> Dict[str, int]:
    """Node → replica-count layout over reported free capacity.

    Rides the gang scheduler's planner (same spread/pack vocabulary —
    one placement algebra for bundles and replicas). Raises
    :class:`PlacementError` when the layout cannot fit right now."""
    if strategy not in ("spread", "pack"):
        raise ValueError(f"unknown placement strategy {strategy!r}; "
                         "choose 'spread' or 'pack'")
    usable = {n: c for n, c in capacities.items() if c > 0}
    plan = _plan(usable, num_replicas, strategy) if usable else None
    if plan is None:
        raise PlacementError(
            f"cannot place {num_replicas} replicas ({strategy}) on "
            f"capacities {capacities}")
    return plan


class ClusterHandle:
    """Client handle: routes through the router tier with failover.

    ``key`` pins a request to its consistent-hash replica (session /
    KV / compile-cache affinity); keyless requests go least-loaded.
    Router loss fails over to the next router transparently — the
    logical request is only surfaced as failed when NO router answers
    or the routed call itself fails typed (application error, open
    breaker, no replicas)."""

    def __init__(self, cs: "ClusterServe", name: str):
        self._cs = cs
        self._name = name
        self._rr = itertools.count()

    def call(self, request: Any, timeout: Optional[float] = None,
             key: Optional[str] = None,
             klass: Optional[str] = None) -> Any:
        """Route one request. ``timeout`` is the request's END-TO-END
        deadline budget: the router sheds it typed
        (:class:`~tosem_tpu_torch.runtime.common.DeadlineExceeded`) the
        moment the budget cannot be met — before admission, and at
        every retry-loop top — instead of burning replica capacity on
        an answer the client has already abandoned. ``klass`` names
        the priority class for SLO-admitted deployments (decode
        classes preempt bulk in the router queue)."""
        self._cs._fire_route_chaos(self._name)
        routers = self._cs._routers_snapshot()
        if not routers:
            raise ConnectionError("no routers configured")
        start = next(self._rr)
        last: Optional[BaseException] = None
        for k in range(len(routers)):
            router = routers[(start + k) % len(routers)]
            try:
                return router.route(self._name, request, key=key,
                                    klass=klass, timeout_s=timeout)
            except (NoReplicaAvailable, ReplicaAppError, CircuitOpen,
                    Overloaded, DeadlineExceeded):
                raise               # typed verdicts: not a router death
            except (ConnectionError, TimeoutError, OSError) as e:
                last = e            # router gone: fail over to the next
                continue
            except Exception as e:
                raise self._translate(e) from None
        raise ConnectionError(
            f"no live router for deployment {self._name!r}"
            + (f" (last error: {last!r})" if last else ""))

    @staticmethod
    def _translate(e: Exception) -> BaseException:
        """Re-type a remote router error (the RPC layer ships
        ``repr(exc)``; prefix-match like RemoteNode._translate)."""
        msg = str(e)
        if msg.startswith("Overloaded("):
            # recover the retry hint the admission check computed — a
            # typed shed without its backoff number is half a verdict.
            # [retry_after=…] is the structural field _shed embeds for
            # exactly this parse; the prose fallback covers Overloaded
            # raised elsewhere
            m = (re.search(r"\[retry_after=(\d+(?:\.\d+)?)s\]", msg)
                 or re.search(r"estimated wait (\d+(?:\.\d+)?)s", msg))
            return Overloaded(
                msg, retry_after=float(m.group(1)) if m else 0.0)
        for prefix, typ in (("NoReplicaAvailable(", NoReplicaAvailable),
                            ("ReplicaAppError(", ReplicaAppError),
                            ("CircuitOpen(", CircuitOpen),
                            ("DeadlineExceeded(", DeadlineExceeded),
                            ("StaleEpochError(", StaleEpochError)):
            if msg.startswith(prefix):
                return typ(msg)
        return e


class ClusterServe:
    """The cluster serving controller (single-controller, like Serve —
    but its replicas are processes on OTHER nodes and its data plane is
    the replicated router tier, so the controller is off the request
    path entirely)."""

    def __init__(self, pool: NodePool, num_routers: int = 1,
                 router_procs: bool = True,
                 router_policy: Optional[RouterPolicy] = None,
                 replica_startup_timeout: float = 120.0,
                 placement_scorer: Optional[Any] = None):
        self.pool = pool
        self._lock = threading.RLock()
        self._deployments: Dict[str, ClusterDeployment] = {}
        self._version = 0
        self._rid_next: Dict[str, int] = {}
        self._replica_startup_timeout = replica_startup_timeout
        self._closed = False
        # multi-model multiplexing: single-replica placements (scale-up,
        # failover re-placement) score nodes by compile-cache / KV
        # affinity through this scorer and its model ledger; None keeps
        # the pre-control-plane best-capacity choice
        self._scorer = placement_scorer
        self._router_procs = router_procs
        self._router_policy = router_policy
        self._router_seq = max(1, num_routers)
        # telemetry state (guarded by self._lock in stats(): /-/stats
        # is served by a threaded HTTP server, so scrapes race)
        self._metrics: Optional[Dict[str, Any]] = None
        self._exported_placed: set = set()
        self._exported_nodes: set = set()
        self._mirrored: Dict[Tuple[str, str, str], int] = {}
        self._routers: List[Union[RemoteRouter, RouterCore]] = []
        for i in range(max(1, num_routers)):
            if router_procs:
                self._routers.append(RemoteRouter.spawn_local(
                    name=f"router{i}", policy=router_policy))
            else:
                self._routers.append(
                    RouterCore(name=f"router{i}", policy=router_policy))
        pool.add_death_listener(self._on_node_dead)
        # gray-failure wiring: SUSPECT nodes (detector phi-accrual /
        # missed-probe state) are flagged in the pushed table so routers
        # de-prefer — not drop — their replicas before death is declared
        self._suspect_nodes: set = set()
        add_suspect = getattr(pool, "add_suspect_listener", None)
        if add_suspect is not None:
            add_suspect(self._on_node_suspect)

    @property
    def epoch(self) -> int:
        """The head's fencing epoch (the pool journal's lease term);
        stamped on placements and KV adoptions so a superseded head's
        writes are rejected typed by every receiver."""
        return int(getattr(self.pool, "epoch", 0) or 0)

    # -- capacity / placement ------------------------------------------

    def _capacities(self, per_replica: int = 1,
                    exclude: Sequence[str] = ()) -> Dict[str, int]:
        """Free replica slots per live node, in units of ONE replica
        (a dp×tp replica consumes ``per_replica`` agent slots)."""
        caps: Dict[str, int] = {}
        for name, node in self.pool.live_nodes().items():
            if name in exclude:
                continue
            try:
                st = node.stats()
            except Exception:
                continue            # unprobeable now: not a candidate
            free = int(st.get("replica_slots_free",
                              st.get("free_slots", 0)))
            caps[name] = free // max(1, per_replica)
        return caps

    def _next_rid(self, name: str) -> str:
        n = self._rid_next.get(name, 0)
        self._rid_next[name] = n + 1
        return f"{name}#r{n}"

    def _start_replica(self, dep: ClusterDeployment, node_name: str,
                       node: RemoteNode, replica_id: str
                       ) -> ClusterReplica:
        """Place one replica on ``node``: gang-reserve its device slots
        (sharded), spawn the worker, journal the placement."""
        devices = dep.devices_per_replica
        gang: Optional[GangReservation] = None
        init_kwargs = dict(dep.init_kwargs)
        if dep.sharding:
            dp, tp = dep.sharding
            init_kwargs.setdefault("dp", dp)
            init_kwargs.setdefault("tp", tp)
            # withhold the replica's cores from the task plane for its
            # whole lifetime — all-or-nothing on this node, no waiting
            # (the planner already checked capacity; a race just fails
            # this node and the caller picks another)
            gang = reserve_gang([node], devices, strategy="strict_pack",
                                timeout=0.0)
        try:
            address = node.start_replica(
                replica_id, dep.backend_ref, init_kwargs,
                devices=devices,
                startup_timeout=self._replica_startup_timeout,
                epoch=self.epoch)
        except BaseException:
            if gang is not None:
                gang.release()
            raise
        rep = ClusterReplica(replica_id, dep.name, node_name, address,
                             devices=devices, gang=gang)
        self.pool.record_event(
            "replica_placed", deployment=dep.name, replica_id=replica_id,
            node=node_name, address=address, devices=devices,
            gang_id=gang.pg_id if gang else None)
        return rep

    def _warm_replica(self, dep: ClusterDeployment,
                      rep: ClusterReplica) -> None:
        if dep.warmup_shapes:
            from tosem_tpu_torch.cluster.rpc import RpcClient
            with RpcClient(rep.address) as cli:
                cli.call("warmup", list(dep.warmup_shapes))
        if self._scorer is not None:
            # the model's executable is now resident on this node: LRU-
            # ledger it (cold models may be evicted to fit) and PIN it
            # for this replica — eviction must skip models with traffic
            ledger = self._scorer.ledger
            evicted = ledger.record_warm(rep.node, dep.name)
            ledger.pin(rep.node, dep.name, rep.replica_id)
            if evicted:
                from tosem_tpu_torch.obs.metrics import control_plane_metrics
                control_plane_metrics()["model_evictions"].inc(
                    float(len(evicted)))

    def _unpin_replica(self, dep: ClusterDeployment,
                       rep: ClusterReplica) -> None:
        if self._scorer is not None:
            self._scorer.ledger.unpin(rep.node, dep.name,
                                      rep.replica_id)

    def _discard_replica(self, dep: ClusterDeployment,
                         rep: ClusterReplica, node: Optional[RemoteNode],
                         reason: str) -> None:
        """Stop and release a started-but-unwanted replica (warm
        failure, delete race) — the ONE place start-side resources
        (process, gang, ledger pin) are unwound."""
        self._unpin_replica(dep, rep)
        if node is not None:
            try:
                node.stop_replica(rep.replica_id,
                                      epoch=self.epoch)
            except Exception:
                pass
        if rep.gang is not None:
            rep.gang.release()
        self.pool.record_event("replica_removed", deployment=dep.name,
                               replica_id=rep.replica_id, reason=reason)

    def _finish_placement(self, dep: ClusterDeployment,
                          rep: ClusterReplica,
                          node: Optional[RemoteNode]) -> bool:
        """Warm, then register, one just-started replica (shared by
        scale-up and failover re-placement — the delete-races-placement
        handshake must not exist twice). A warm failure or a delete
        race DISCARDS the replica instead of leaking its process/gang:
        placement is contained per replica, so a repeating failure
        cannot bleed node slots tick over tick. True = the replica
        entered ``dep.replicas``."""
        try:
            self._warm_replica(dep, rep)
        except Exception as e:
            self.pool.record_event("replica_lost", deployment=dep.name,
                                   replica_id=rep.replica_id,
                                   error=repr(e))
            self._discard_replica(dep, rep, node, reason="warmup failed")
            return False
        with self._lock:
            # a delete/failed-deploy can race this placement: if the
            # deployment is no longer registered, the fresh replica
            # must be torn down, not leaked as an orphan the journal
            # records placed after deployment_deleted
            if self._deployments.get(dep.name) is not dep:
                registered = False
            else:
                dep.replicas.append(rep)
                registered = True
        if not registered:
            self._discard_replica(dep, rep, node,
                                  reason="deployment gone")
            return False
        return True

    # -- control plane -------------------------------------------------

    def deploy(self, name: str, backend: Any, *, num_replicas: int = 2,
               strategy: str = "spread",
               sharding: Optional[Tuple[int, int]] = None,
               init_kwargs: Optional[Dict[str, Any]] = None,
               warmup_shapes: Optional[Sequence] = None,
               slo: Optional[SLOConfig] = None
               ) -> ClusterDeployment:
        """Place ``num_replicas`` of ``backend`` (a class or a
        ``"module:qualname"`` ref importable on the nodes) across the
        pool and route traffic to them. ``sharding=(dp, tp)`` makes
        each logical replica a dp×tp-meshed sharded program (the
        backend receives ``dp``/``tp`` kwargs). ``slo`` turns on
        SLO-aware admission at every router: overload rejects typed
        (:class:`~tosem_tpu_torch.control.admission.Overloaded`) under the
        declared latency budget, with priority classes."""
        ref = (backend if isinstance(backend, str)
               else f"{backend.__module__}:{backend.__qualname__}")
        dep = ClusterDeployment(name, ref, init_kwargs or {},
                                num_replicas, strategy, sharding,
                                warmup_shapes, slo=slo)
        with self._lock:
            if self._closed:
                raise RuntimeError("controller is closed")
            if name in self._deployments:
                raise ValueError(f"deployment {name!r} already exists")
            self._deployments[name] = dep
        self.pool.record_event("deployment_created", **dep.spec())
        try:
            caps = self._capacities(
                per_replica=max(1, dep.devices_per_replica))
            counts = plan_replicas(caps, num_replicas, strategy)
            nodes = self.pool.live_nodes()
            for node_name in sorted(counts):
                for _ in range(counts[node_name]):
                    rep = self._start_replica(
                        dep, node_name, nodes[node_name],
                        self._next_rid(name))
                    with self._lock:
                        dep.replicas.append(rep)
            with self._lock:
                to_warm = list(dep.replicas)
            for rep in to_warm:
                self._warm_replica(dep, rep)
        except BaseException:
            # unregister FIRST: the deployment is already visible to
            # the node-death listener, and a failover re-placement
            # racing this teardown must find the deployment gone
            # rather than re-place into a dying one
            with self._lock:
                self._deployments.pop(name, None)
            self._teardown_deployment(dep)
            self.pool.record_event("deployment_deleted", deployment=name,
                                   reason="deploy failed")
            raise
        self._push_table()
        return dep

    def get_handle(self, name: str) -> ClusterHandle:
        with self._lock:
            if name not in self._deployments:
                raise KeyError(f"no deployment {name!r}")
        return ClusterHandle(self, name)

    def get_deployment(self, name: str) -> Optional[ClusterDeployment]:
        with self._lock:
            return self._deployments.get(name)

    def list_deployments(self) -> List[str]:
        with self._lock:
            return sorted(self._deployments)

    def delete(self, name: str) -> None:
        with self._lock:
            dep = self._deployments.pop(name, None)
        if dep is None:
            return
        self._teardown_deployment(dep)
        self.pool.record_event("deployment_deleted", deployment=name)
        self._push_table()

    # -- autoscaling (the ControlPlane's actuator) ---------------------

    def scale(self, name: str, num_replicas: int) -> Dict[str, Any]:
        """Move deployment ``name`` to ``num_replicas`` (the control
        plane's actuator).

        Scale-UP places each new replica and **warms its compile cache
        before it enters the routing table** — the router tier only
        sees the replica after ``warmup_shapes`` compiled, so its first
        request never pays a JIT. A node dying mid-placement (the
        ``scale-under-kill`` chaos window) is contained per replica:
        the warming replica never joins ``dep.replicas`` — it cannot
        be counted as capacity or routed to — and placement retries on
        surviving nodes.

        Scale-DOWN removes the least-loaded replicas from routing
        FIRST (typed ``NodeDrainingError``-style fail-fast: no fresh
        traffic lands on a leaving replica), live-migrates their
        in-flight decode sequences to survivors (live KV migration
        — zero step-0 restarts), then stops the processes."""
        if num_replicas < 1:
            raise ValueError("a deployment needs at least one replica; "
                             "use ClusterServe.delete to tear it down")
        with self._lock:
            if self._closed:
                raise RuntimeError("controller is closed")
            dep = self._deployments.get(name)
            if dep is None:
                raise KeyError(f"no deployment {name!r}")
            current = len(dep.replicas)
        out = {"deployment": name, "from": current, "to": num_replicas,
               "placed": 0, "removed": 0, "sequences_migrated": 0}
        if num_replicas > current:
            out["placed"] = self._scale_up(dep, num_replicas - current)
        elif num_replicas < current:
            removed, migrated = self._scale_down(
                dep, current - num_replicas)
            out["removed"], out["sequences_migrated"] = removed, migrated
        with self._lock:
            dep.num_replicas = len(dep.replicas)
        self.pool.record_event("deployment_scaled", deployment=name,
                               **{k: v for k, v in out.items()
                                  if k != "deployment"})
        return out

    def _scale_up(self, dep: ClusterDeployment, count: int) -> int:
        placed = 0
        for _ in range(count):
            rep = None
            exclude: List[str] = []
            for _attempt in range(3):
                caps = self._capacities(
                    per_replica=max(1, dep.devices_per_replica),
                    exclude=exclude)
                try:
                    node_name = self._pick_node(dep, caps)
                except PlacementError:
                    break
                self._fire_scale_chaos(dep.name, node_name)
                node = self.pool.live_nodes().get(node_name)
                if node is None:
                    # the chosen node died between pick and placement:
                    # nothing was started there, nothing to count —
                    # retry on the survivors
                    exclude.append(node_name)
                    continue
                rid = self._next_rid(dep.name)
                try:
                    rep = self._start_replica(dep, node_name, node, rid)
                except Exception as e:
                    # mid-placement node death: the half-started
                    # replica is NOT appended to dep.replicas, so the
                    # control loop's capacity view and the routing
                    # table never include it
                    self.pool.record_event(
                        "replica_lost", deployment=dep.name,
                        replica_id=rid, error=repr(e))
                    exclude.append(node_name)
                    continue
                break
            if rep is None:
                break               # no capacity now: next tick retries
            # warm BEFORE routing: the replica enters the table (and
            # takes traffic) only with its compile cache filled
            if not self._finish_placement(dep, rep, node):
                break               # discarded (warm failure / delete)
            placed += 1
        if placed:
            self._push_table()
        return placed

    def _scale_down(self, dep: ClusterDeployment,
                    count: int) -> Tuple[int, int]:
        from tosem_tpu_torch.cluster.rpc import RpcClient
        with self._lock:
            reps = list(dep.replicas)
        count = min(count, len(reps) - 1)   # never below one replica
        if count <= 0:
            return 0, 0
        loads: Dict[str, int] = {}
        for r in reps:
            try:
                with RpcClient(r.address) as cli:
                    loads[r.replica_id] = int(cli.call("load"))
            except Exception:
                # unprobeable replica: most attractive victim (likely
                # already dead)
                loads[r.replica_id] = -1
        victims = sorted(reps, key=lambda r: (loads[r.replica_id],
                                              r.replica_id))[:count]
        with self._lock:
            for v in victims:
                if v in dep.replicas:
                    dep.replicas.remove(v)
        # stop NEW traffic first (the drain-before-stop contract), then
        # move live decode state, then stop the processes
        self._push_table()
        migrated = 0
        live = self.pool.live_nodes()
        for v in victims:
            with self._lock:
                survivors = list(dep.replicas)
            migrated += self._migrate_replica_seqs(dep, v, survivors)
            self._unpin_replica(dep, v)
            node = live.get(v.node)
            if node is not None:
                try:
                    node.stop_replica(v.replica_id,
                                      epoch=self.epoch)
                except Exception:
                    pass
            if v.gang is not None:
                v.gang.release()
            self.pool.record_event(
                "replica_removed", deployment=dep.name,
                replica_id=v.replica_id, reason="scale_down",
                node=v.node)
        return len(victims), migrated

    def scale_routers(self, num_routers: int) -> int:
        """Grow/shrink the router TIER (the second closed-loop axis):
        fresh routers receive the current table+admission push before
        any client can reach them; shrink closes the tail routers —
        clients holding their addresses fail over, by design."""
        if num_routers < 1:
            raise ValueError("the router tier needs at least one router")
        with self._lock:
            if self._closed:
                return len(self._routers)
            cur = len(self._routers)
        if num_routers > cur:
            fresh: List[Union[RemoteRouter, RouterCore]] = []
            for _ in range(num_routers - cur):
                with self._lock:
                    name = f"router{self._router_seq}"
                    self._router_seq += 1
                if self._router_procs:
                    fresh.append(RemoteRouter.spawn_local(
                        name=name, policy=self._router_policy))
                else:
                    fresh.append(RouterCore(
                        name=name, policy=self._router_policy))
            with self._lock:
                self._routers.extend(fresh)
            self._push_table()      # the fresh routers catch up here
            self.pool.record_event("routers_scaled", count=num_routers,
                                   direction="up")
        elif num_routers < cur:
            with self._lock:
                victims = self._routers[num_routers:]
                self._routers = self._routers[:num_routers]
            for router in victims:
                try:
                    router.close()
                except Exception:
                    pass
            # re-push so survivors learn the NEW shard count: a stale
            # _shards leaves each survivor admitting 1/old_count of the
            # SLO budget — permanent under-admission
            self._push_table()
            self.pool.record_event("routers_scaled", count=num_routers,
                                   direction="down")
        with self._lock:
            return len(self._routers)

    def num_routers(self) -> int:
        with self._lock:
            return len(self._routers)

    def _fire_scale_chaos(self, deployment: str, node_name: str) -> None:
        """Chaos seam ``control.scale``: fired once per scale-up
        placement with the chosen target node — ``kill_node`` SIGKILLs
        that node and declares it dead BEFORE the replica starts (the
        mid-scale-up death window the ``scale-under-kill`` plan
        pins)."""
        act = _chaos.fire("control.scale", target=deployment)
        if act is None:
            return
        if act["action"] == "kill_node":
            node = self.pool.live_nodes().get(node_name)
            if node is not None:
                node.kill()
                self.pool.detector.declare_dead(node_name)

    def _teardown_deployment(self, dep: ClusterDeployment) -> None:
        nodes = self.pool.live_nodes()
        with self._lock:
            reps, dep.replicas = list(dep.replicas), []
        for rep in reps:
            node = nodes.get(rep.node)
            if node is not None:
                try:
                    node.stop_replica(rep.replica_id,
                                      epoch=self.epoch)
                except Exception:
                    pass            # dead node: its replicas died too
            if rep.gang is not None:
                rep.gang.release()
            self._unpin_replica(dep, rep)
            self.pool.record_event("replica_removed", deployment=dep.name,
                                   replica_id=rep.replica_id,
                                   reason="deleted")

    # -- routing table -------------------------------------------------

    def _routers_snapshot(self) -> List[Union[RemoteRouter, RouterCore]]:
        with self._lock:
            return list(self._routers)

    def _push_table(self) -> int:
        """Push the current placements to every router (versioned, so a
        racing push over another connection can never roll a router
        back). Unreachable routers are skipped — they are either dead
        (clients fail over) or will catch up on the next push."""
        with self._lock:
            self._version += 1
            version = self._version
            suspect = set(self._suspect_nodes)
            table = {name: [dict(rep.info(),
                                 suspect=(rep.node in suspect))
                            for rep in dep.replicas]
                     for name, dep in self._deployments.items()}
            routers = list(self._routers)
            # each router admits 1/N of the deployment's budget: the
            # SLO is an AGGREGATE contract, and scaling the router
            # tier must not multiply the admitted inflight
            admission = {
                name: {**dep.slo.to_dict(),
                       "_shards": max(1, len(routers))}
                for name, dep in self._deployments.items()
                if dep.slo is not None}
        for router in routers:
            try:
                router.update_table(table, version, admission)
            except Exception:
                pass
        return version

    def table_version(self) -> int:
        with self._lock:
            return self._version

    # -- failover ------------------------------------------------------

    def _on_node_suspect(self, node_name: str, node: RemoteNode,
                         entering: bool) -> None:
        """Pool suspect listener (the detector's pre-death state): flag
        the node's replicas in the routing table so routers de-prefer
        them — traffic drains toward healthy replicas BEFORE the death
        verdict, instead of piling retries onto a gray node — and clear
        the flag when a probe succeeds again."""
        with self._lock:
            if entering:
                self._suspect_nodes.add(node_name)
            else:
                self._suspect_nodes.discard(node_name)
            if self._metrics is None:
                from tosem_tpu_torch.obs.metrics import cluster_serve_metrics
                self._metrics = cluster_serve_metrics()
            if entering:
                self._metrics["suspect_nodes"].set(1.0, (node_name,))
            else:
                self._metrics["suspect_nodes"].remove((node_name,))
        self._push_table()

    def _on_node_dead(self, node_name: str, node: RemoteNode) -> None:
        """Pool death listener: drop the node's replicas from routing
        (pushed immediately), then re-place them on survivors under
        the SAME replica ids — the hash ring stays stable, so affinity
        keys land on the re-placed replica, not a shuffled one."""
        with self._lock:
            # a dead node's suspect flag (and its gauge row) dies with it
            self._suspect_nodes.discard(node_name)
            if self._metrics is not None:
                self._metrics["suspect_nodes"].remove((node_name,))
            lost: List[Tuple[ClusterDeployment, ClusterReplica]] = []
            for dep in self._deployments.values():
                mine = [r for r in dep.replicas if r.node == node_name]
                for rep in mine:
                    dep.replicas.remove(rep)
                    lost.append((dep, rep))
        if self._scorer is not None:
            # the node's ledger (residency AND pins) dies with it —
            # never zero it, REMOVE it
            self._scorer.ledger.drop_node(node_name)
        if not lost:
            return
        self._push_table()
        for dep, rep in lost:
            self.pool.record_event(
                "replica_removed", deployment=dep.name,
                replica_id=rep.replica_id, reason="node_death",
                node=node_name)
            # the gang died with its node; release() is a no-op on a
            # dead agent but clears the driver-side handle
            if rep.gang is not None:
                rep.gang.release()
            try:
                self._place_one(dep, rep.replica_id,
                                exclude=(node_name,))
            except Exception as e:
                self.pool.record_event(
                    "replica_lost", deployment=dep.name,
                    replica_id=rep.replica_id, error=repr(e))
        self._push_table()

    def _pick_node(self, dep: ClusterDeployment,
                   caps: Dict[str, int]) -> str:
        """Node choice for ONE replica: affinity-scored when a
        placement scorer is configured (warm compile cache /
        co-residency / pressure — see
        :class:`~tosem_tpu_torch.control.multiplex.PlacementScorer`),
        best-free-capacity otherwise (the pre-control-plane rule)."""
        candidates = [n for n, c in caps.items() if c > 0]
        if not candidates:
            raise PlacementError(
                f"no capacity for a replica of {dep.name!r} "
                f"(capacities {caps})")
        if self._scorer is not None:
            with self._lock:
                co: Dict[str, int] = {}
                for r in dep.replicas:
                    co[r.node] = co.get(r.node, 0) + 1
            pick = self._scorer.pick(
                {n: caps[n] for n in candidates}, dep.name, co)
            if pick is not None:
                return pick
        return max(sorted(candidates), key=lambda n: caps[n])

    def _place_one(self, dep: ClusterDeployment, replica_id: str,
                   exclude: Sequence[str] = ()) -> ClusterReplica:
        """Re-place one replica on the best surviving node."""
        caps = self._capacities(
            per_replica=max(1, dep.devices_per_replica), exclude=exclude)
        node_name = self._pick_node(dep, caps)
        node = self.pool.live_nodes()[node_name]
        rep = self._start_replica(dep, node_name, node, replica_id)
        if not self._finish_placement(dep, rep, node):
            raise PlacementError(
                f"replica {replica_id} was discarded during placement "
                "(deployment deleted, or warmup failed)")
        return rep

    # -- node drain (live KV migration) --------------------------------

    def _migrate_replica_seqs(self, dep: ClusterDeployment,
                              rep: ClusterReplica,
                              survivors: Sequence[ClusterReplica]
                              ) -> int:
        """Live-migrate ``rep``'s in-flight decode sequences onto
        ``survivors`` (backends exposing the migration surface —
        ``list_seqs``/``transport_address``/``send_seq``/``adopt_seq``;
        page bytes stream node→node over
        :mod:`tosem_tpu_torch.cluster.transport`, the driver only brokers
        addresses). Shared by :meth:`drain_node` and replica-level
        scale-down — a scaled-away decode replica must not restart its
        sequences at step 0 any more than a drained node's. Returns the
        migrated-sequence count; failures fall back to the re-admission
        path per sequence."""
        from tosem_tpu_torch.cluster.rpc import RpcClient, RpcError
        if not survivors:
            return 0
        migrated = 0
        try:
            with contextlib.ExitStack() as stack:
                src_cli = stack.enter_context(RpcClient(rep.address))
                seqs = src_cli.call("backend_call", "list_seqs")
                if not seqs:
                    return 0
                # one client + transport address per survivor;
                # sequences round-robin over them so one replica does
                # not absorb every migrated page
                dsts = []
                for r in survivors:
                    try:
                        cli = stack.enter_context(RpcClient(r.address))
                        dsts.append((cli, cli.call(
                            "backend_call", "transport_address")))
                    except (RpcError, ConnectionError,
                            TimeoutError, OSError):
                        continue
                if not dsts:
                    return 0
                for j, sid in enumerate(seqs):
                    dst_cli, addr = dsts[j % len(dsts)]
                    # per-sequence containment: one failed migration
                    # (pressure on the destination, a torn stream)
                    # must not abandon the REST of the replica's
                    # sequences to step-0 recompute
                    try:
                        src_cli.call("backend_call", "send_seq", sid,
                                     addr)
                        dst_cli.call("backend_call", "adopt_seq", sid,
                                     _epoch=self.epoch)
                        src_cli.call("backend_call", "release", sid)
                        migrated += 1
                    except (RpcError, ConnectionError,
                            TimeoutError, OSError):
                        continue
        except (RpcError, ConnectionError, TimeoutError, OSError):
            pass  # backend without the surface / replica gone:
            #       sequences fall back to the re-admission path
        return migrated

    def drain_node(self, node_name: str) -> Dict[str, Any]:
        """Gracefully drain ``node_name``: for every replica placed
        there, live-migrate its in-flight decode sequences to a
        SURVIVOR replica of the same deployment (backends exposing the
        migration surface — ``list_seqs``/``transport_address``/
        ``send_seq``/``adopt_seq``; page bytes stream node→node over
        :mod:`tosem_tpu_torch.cluster.transport`, the driver only brokers
        addresses), drop the node from routing, re-place its replicas
        on surviving capacity under the same ids, and stop its
        processes. Unlike node DEATH (step-0 re-admission), a drained
        node's sequences continue from their current step. Returns
        ``{"replicas_moved", "sequences_migrated", "deployments"}``;
        journaled as ``node_drained``."""
        with self._lock:
            doomed: List[Tuple[ClusterDeployment, ClusterReplica]] = []
            for dep in self._deployments.values():
                for rep in [r for r in dep.replicas
                            if r.node == node_name]:
                    dep.replicas.remove(rep)
                    doomed.append((dep, rep))
        if not doomed:
            return {"replicas_moved": 0, "sequences_migrated": 0,
                    "deployments": []}
        # stop NEW traffic to the draining replicas first: routers must
        # not admit fresh sequences onto state that is about to move
        self._push_table()
        migrated = 0
        for dep, rep in doomed:
            with self._lock:
                survivors = [r for r in dep.replicas
                             if r.node != node_name]
            migrated += self._migrate_replica_seqs(dep, rep, survivors)
        nodes = self.pool.live_nodes()
        node = nodes.get(node_name)
        for dep, rep in doomed:
            self.pool.record_event(
                "replica_removed", deployment=dep.name,
                replica_id=rep.replica_id, reason="node_drain",
                node=node_name)
            self._unpin_replica(dep, rep)
            if node is not None:
                try:
                    node.stop_replica(rep.replica_id,
                                      epoch=self.epoch)
                except Exception:
                    pass
            if rep.gang is not None:
                rep.gang.release()
            try:
                self._place_one(dep, rep.replica_id,
                                exclude=(node_name,))
            except Exception as e:
                self.pool.record_event(
                    "replica_lost", deployment=dep.name,
                    replica_id=rep.replica_id, error=repr(e))
        self.pool.record_event("node_drained", node=node_name,
                               replicas=len(doomed),
                               sequences_migrated=migrated)
        self._push_table()
        return {"replicas_moved": len(doomed),
                "sequences_migrated": migrated,
                "deployments": sorted({d.name for d, _ in doomed})}

    # -- chaos seam ----------------------------------------------------

    def _fire_route_chaos(self, deployment: str) -> None:
        act = _chaos.fire("serve.route", target=deployment)
        if act is None:
            return
        if act["action"] == "kill_router":
            self.chaos_kill_router()
        elif act["action"] == "kill_node":
            self.chaos_kill_replica_node(deployment)
        elif act["action"] == "slow_node":
            self.chaos_slow_replica_node(
                deployment, float(act.get("delay_s") or 0.0))

    def chaos_slow_replica_node(self, deployment: str,
                                delay_s: float) -> Optional[str]:
        """Arm a gray fault: the node hosting ``deployment``'s LAST
        replica answers every dispatch ``delay_s`` late (the emulated-
        network state routers consult) — the node is alive and correct,
        just slow. Hedged routing is what keeps the tail flat through
        this; the ``slow-node-hedge`` plan pins exactly that."""
        with self._lock:
            dep = self._deployments.get(deployment)
            if dep is None or not dep.replicas:
                return None
            node_name = dep.replicas[-1].node
        _net.state().slow_node(node_name, delay_s)
        return node_name

    def chaos_kill_router(self) -> Optional[str]:
        """SIGKILL the first live router process (chaos: the client's
        next attempt on it fails and must fail over)."""
        for router in self._routers_snapshot():
            if isinstance(router, RemoteRouter) and \
                    router._proc is not None and \
                    router._proc.poll() is None:
                router.kill()
                return router.name
        return None

    def chaos_kill_replica_node(self, deployment: str) -> Optional[str]:
        """SIGKILL the first live node hosting a replica of
        ``deployment`` and declare it dead out-of-band (the detector's
        declare_dead path) — failover runs synchronously, the caller's
        request then rides the refreshed table."""
        with self._lock:
            dep = self._deployments.get(deployment)
            hosts = [r.node for r in dep.replicas] if dep else []
        live = self.pool.live_nodes()
        for node_name in hosts:
            node = live.get(node_name)
            if node is not None:
                node.kill()
                self.pool.detector.declare_dead(node_name)
                return node_name
        return None

    # -- head crash-restart --------------------------------------------

    @classmethod
    def recover(cls, journal_path: str, num_routers: int = 1,
                router_procs: bool = True, probe_timeout: float = 2.0,
                router_policy: Optional[RouterPolicy] = None,
                **pool_kwargs: Any) -> "ClusterServe":
        """Rebuild a crashed head's serving plane from its journal:
        recover the node pool, re-adopt replica processes that
        OUTLIVED the head (a head crash is not a node crash — the
        agents and their replicas keep serving), re-place the ones
        that did not, and push a fresh routing table."""
        pool = NodePool.recover(journal_path, probe_timeout=probe_timeout,
                                **pool_kwargs)
        cs = cls(pool, num_routers=num_routers, router_procs=router_procs,
                 router_policy=router_policy)
        specs: Dict[str, Dict[str, Any]] = getattr(pool, "deployments", {})
        placements: Dict[str, Dict[str, Any]] = getattr(
            pool, "placements", {})
        with cs._lock:
            for name, spec in specs.items():
                cs._deployments[name] = ClusterDeployment.from_spec(spec)
        live = pool.live_nodes()
        listings: Dict[str, Dict[str, Any]] = {}
        for node_name, node in live.items():
            try:
                listings[node_name] = node.list_replicas()
            except Exception:
                listings[node_name] = {}
        adopted: List[ClusterReplica] = []
        for rid, p in sorted(placements.items()):
            dep = cs._deployments.get(p["deployment"])
            if dep is None:
                continue
            node_name = p["node"]
            hosted = listings.get(node_name, {}).get(rid)
            if hosted is not None and hosted.get("alive"):
                rep = ClusterReplica(rid, dep.name, node_name,
                                     hosted["address"],
                                     devices=int(p.get("devices") or 0))
                if p.get("gang_id") and node_name in live:
                    # re-own the surviving agent-side reservation so a
                    # later release (delete / node death) still frees it
                    rep.gang = GangReservation(
                        p["gang_id"], {live[node_name].address:
                                       live[node_name]},
                        {live[node_name].address: rep.devices})
                dep.replicas.append(rep)
                adopted.append(rep)
                pool.record_event("replica_adopted", deployment=dep.name,
                                  replica_id=rid, node=node_name)
                # keep ids monotonic past the adopted ones
                cs._bump_rid(dep.name, rid)
            else:
                pool.record_event("replica_removed", deployment=dep.name,
                                  replica_id=rid,
                                  reason="lost at recovery")
                cs._bump_rid(dep.name, rid)
                if p.get("gang_id") and node_name in live:
                    # the replica died but its AGENT survived: the
                    # agent's in-memory reservation is still holding
                    # the dead replica's dp*tp slots — release it or
                    # the node's capacity is leaked until agent restart
                    GangReservation(
                        p["gang_id"],
                        {live[node_name].address: live[node_name]},
                        {live[node_name].address:
                         int(p.get("devices") or 0)}).release()
                try:
                    cs._place_one(dep, rid)
                except Exception as e:
                    pool.record_event("replica_lost",
                                      deployment=dep.name,
                                      replica_id=rid, error=repr(e))
        # fence the survivors under the NEW epoch: every agent and every
        # adopted replica advances its watermark, so the superseded
        # head's stamped writes (placements, adopt_seq, stops) are
        # rejected typed from here on — re-adoption IS the fencing point
        cs._fence_survivors(live, adopted)
        cs._push_table()
        return cs

    def _fence_survivors(self, live: Dict[str, RemoteNode],
                         adopted: Sequence[ClusterReplica]) -> None:
        from tosem_tpu_torch.cluster.rpc import RpcClient
        epoch = self.epoch
        for node in live.values():
            try:
                node.fence(epoch)
            except Exception:
                pass            # unreachable agent: the detector's case
        for rep in adopted:
            try:
                with RpcClient(rep.address) as cli:
                    cli.call("fence", epoch)
            except Exception:
                pass            # dead replica: re-placement's case

    def _bump_rid(self, name: str, rid: str) -> None:
        """Advance the id counter past a journal-recovered replica id
        so fresh placements never collide with adopted ones."""
        try:
            n = int(rid.rsplit("#r", 1)[1])
        except (IndexError, ValueError):
            return
        self._rid_next[name] = max(self._rid_next.get(name, 0), n + 1)

    # -- telemetry -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Aggregate control+data-plane snapshot (the ``/-/stats``
        payload): per-deployment placements, per-router routed/spilled
        counters, and the per-node queue-depth rollup — mirrored into
        the driver registry's cluster gauges so one Prometheus scrape
        sees the whole tier."""
        with self._lock:
            deps = {name: {"replicas": len(dep.replicas),
                           "nodes": sorted({r.node for r in dep.replicas}),
                           "strategy": dep.strategy,
                           "sharding": (list(dep.sharding)
                                        if dep.sharding else None),
                           "placement": [r.info() for r in dep.replicas]}
                    for name, dep in self._deployments.items()}
            routers = list(self._routers)
            version = self._version
        router_stats: List[Dict[str, Any]] = []
        remote_stats: List[Dict[str, Any]] = []
        for router in routers:
            try:
                rs = router.stats()
            except Exception:
                rs = {"name": getattr(router, "name", "?"), "dead": True}
            router_stats.append(rs)
            if isinstance(router, RemoteRouter):
                remote_stats.append(rs)
        if self._scorer is not None:
            # serve-recency feeds the ledger's LRU order: a model whose
            # replicas show router-observed depth is HOT on its node,
            # whatever order placement warmed things in
            for rs in router_stats:
                for info in rs.get("replicas", {}).values():
                    if info.get("depth", 0) > 0:
                        self._scorer.ledger.touch(
                            info.get("node", "?"),
                            info.get("deployment", "?"))
        nodes: Dict[str, Dict[str, Any]] = {}
        routed = spilled = 0
        prefix_routed = prefix_transfers = 0
        for rs in router_stats:
            routed += rs.get("routed", 0)
            spilled += rs.get("spilled", 0)
            prefix_routed += rs.get("prefix_routed", 0)
            prefix_transfers += rs.get("prefix_transfers", 0)
            for node, depth in rs.get("node_queue_depth", {}).items():
                cur = nodes.setdefault(node, {"queue_depth": 0,
                                              "replicas": 0})
                # each router has its own (cached) view; the max is the
                # honest rollup — summing would count a request once
                # per router that saw it
                cur["queue_depth"] = max(cur["queue_depth"], depth)
        # export under the controller lock: /-/stats is served by a
        # threaded HTTP server, and a racing scrape must not double-
        # apply a mirrored counter delta or cross the departed-label
        # bookkeeping mid-update
        with self._lock:
            if self._metrics is None:
                from tosem_tpu_torch.obs.metrics import cluster_serve_metrics
                self._metrics = cluster_serve_metrics()
            # mirror PROCESS routers' routed/spilled counters into the
            # driver registry by delta (their own registries have no
            # scrape endpoint; in-proc routers already feed this
            # registry directly — mirroring those would double-count)
            for rs in remote_stats:
                rname = rs.get("name", "?")
                for dep_name, paths in rs.get("requests", {}).items():
                    for path, total in paths.items():
                        mkey = (dep_name, rname, path)
                        delta = total - self._mirrored.get(mkey, 0)
                        if delta > 0:
                            self._metrics["router_requests"].inc(
                                delta, mkey)
                            self._mirrored[mkey] = total
            placed_now: set = set()
            for name, d in deps.items():
                per_node: Dict[str, int] = {}
                for r in d["placement"]:
                    per_node[r["node"]] = per_node.get(r["node"], 0) + 1
                for node, count in per_node.items():
                    nodes.setdefault(node, {"queue_depth": 0,
                                            "replicas": 0})
                    nodes[node]["replicas"] += count
                    self._metrics["replicas_placed"].set(count,
                                                         (name, node))
                    placed_now.add((name, node))
            for node, d in nodes.items():
                self._metrics["node_queue_depth"].set(d["queue_depth"],
                                                      (node,))
            # REMOVE series whose label sets departed (a dead node
            # keeping its last replica count/queue depth forever would
            # read as mass that failover never moved — and a permanent
            # zero row is just as stale: it reads as a live idle node
            # to every aggregation over the label)
            for name, node in self._exported_placed - placed_now:
                self._metrics["replicas_placed"].remove((name, node))
            for node in self._exported_nodes - set(nodes):
                self._metrics["node_queue_depth"].remove((node,))
            self._exported_placed = placed_now
            self._exported_nodes = set(nodes)
        return {"deployments": deps, "routers": router_stats,
                "nodes": nodes, "version": version,
                "routed": routed, "spilled": spilled,
                "prefix_routed": prefix_routed,
                "prefix_transfers": prefix_transfers}

    def close(self, stop_replicas: bool = True,
              close_pool: bool = False) -> None:
        with self._lock:
            self._closed = True
            deployments = list(self._deployments.values())
            self._deployments = {}
            routers = list(self._routers)
            self._routers = []
        if stop_replicas:
            for dep in deployments:
                self._teardown_deployment(dep)
        for router in routers:
            try:
                router.close()
            except Exception:
                pass
        if close_pool:
            self.pool.close(close_nodes=True)
