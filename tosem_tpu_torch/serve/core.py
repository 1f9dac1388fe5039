"""Serve-lite: deployments, replica routing, retries — on the actor runtime.

The reference's serving stack (SURVEY §2.1 Ray Serve) is a controller that
deploys backend classes as replica actors, a router that load-balances
requests over them, and an HTTP proxy in front
(``python/ray/serve/api.py:36,210,361``; ``serve/router.py``;
``serve/backend_worker.py``). This is the same architecture on
:mod:`tosem_tpu_torch.runtime`: replicas are runtime actors with restart policies,
the router is driver-side (single-controller — no distributed router actors
needed), and failures re-dispatch to surviving replicas.

    serve = Serve()
    serve.deploy("echo", EchoBackend, num_replicas=2)
    h = serve.get_handle("echo")
    fut = h.remote({"x": 1})
    fut.result(timeout=5)

Backend contract: a class whose ``call(self, request)`` handles one request
(the ``__call__`` of a Serve backend).

The port's copy of ``tosem_tpu/serve/core.py``: replicas are actors of
:mod:`tosem_tpu_torch.runtime`, which spawns them as processes of their own
once torch is loaded, so each replica creates its own CUDA context.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import tosem_tpu_torch.runtime as rt
from tosem_tpu_torch.chaos import hooks as _chaos
from tosem_tpu_torch.runtime.common import (ActorDiedError, TaskCancelledError,
                                      TaskError, WorkerCrashedError)
from tosem_tpu_torch.serve.batching import (BatchingReplica, BatchPolicy,
                                      BatchQueue, DecodePolicy,
                                      DecodeQueue)
from tosem_tpu_torch.serve.breaker import CircuitBreaker, CircuitOpen

RETRYABLE = (ActorDiedError, WorkerCrashedError)


class ServeFuture:
    """A routed request: retries on replica death with exponential
    backoff, like the reference's router re-submitting to another worker
    replica — but with a bounded retry budget so a dead deployment fails
    in bounded time instead of spinning."""

    def __init__(self, deployment: "Deployment", request: Any,
                 max_retries: int, pin: Optional[int] = None):
        self._dep = deployment
        self._request = request
        self._retries_left = max_retries
        self._attempt = 0
        self._pin = pin
        # breaker admission happens per attempt, per request, so probe
        # ownership is this future's alone — a stale request finishing
        # late can never free or fail another request's probe
        self._probe = False
        self._ref = self._dispatch_attempt()

    def _dispatch_attempt(self):
        """Admit through the breaker, then dispatch — releasing an
        acquired probe slot if the dispatch itself fails (a deleted
        deployment raising here must not wedge the breaker in
        'probe in flight' forever)."""
        breaker = self._dep.breaker
        self._probe = breaker.allow() if breaker is not None else False
        try:
            return self._dep._dispatch(self._request, pin=self._pin)
        except BaseException:
            if breaker is not None and self._probe:
                breaker.release_probe()
                self._probe = False
            raise

    def result(self, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        breaker = self._dep.breaker
        while True:
            remaining = (None if deadline is None
                         else max(deadline - time.monotonic(), 0.001))
            try:
                value = rt.get(self._ref, timeout=remaining)
            except RETRYABLE:
                if breaker is not None:
                    breaker.record_failure(probe=self._probe)
                    self._probe = False
                if self._retries_left <= 0:
                    raise
                # deterministic exponential backoff: replica restarts /
                # re-deploys get breathing room before the re-dispatch —
                # clipped to the caller's own deadline (never sleep past
                # the time budget of a result(timeout=...) call)
                delay = min(self._dep.backoff_base_s * (2 ** self._attempt),
                            self._dep.backoff_cap_s)
                if deadline is not None:
                    budget = deadline - time.monotonic()
                    if budget <= 0:
                        raise          # out of time: surface the failure
                    # at most half the remaining budget goes to backing
                    # off — sleeping the WHOLE budget would guarantee
                    # the retried attempt times out unwaited
                    delay = min(delay, budget / 2)
                self._retries_left -= 1
                time.sleep(delay)
                self._attempt += 1
                self._ref = self._dispatch_attempt()  # may raise CircuitOpen
            except TaskError:
                # application error: counts against the breaker (the
                # backend is failing requests) but is never retried —
                # the caller sees its own exception
                if breaker is not None:
                    breaker.record_failure(probe=self._probe)
                    self._probe = False
                raise
            except BaseException:
                # anything without a clear verdict — the caller's wait
                # timed out (the request may still land later),
                # cancellation, a result that fails to unpickle,
                # KeyboardInterrupt: free our probe slot rather than
                # wedging the breaker in 'probe in flight' forever
                if breaker is not None and self._probe:
                    breaker.release_probe()
                    self._probe = False
                raise
            else:
                if breaker is not None:
                    breaker.record_success(probe=self._probe)
                    self._probe = False
                return value


class Deployment:
    """One named backend: N replica actors + a round-robin pointer."""

    def __init__(self, name: str, backend_cls, num_replicas: int,
                 init_args: Tuple, init_kwargs: Dict,
                 max_restarts: int, max_retries: int,
                 breaker: Optional[CircuitBreaker] = None,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 batch_policy: Optional[BatchPolicy] = None,
                 decode_policy: Optional[DecodePolicy] = None,
                 warmup_shapes: Optional[Sequence] = None):
        if batch_policy is not None and decode_policy is not None:
            raise ValueError("a deployment is either micro-batched "
                             "(batch_policy) or continuous-batching "
                             "decode (decode_policy), not both")
        if decode_policy is not None:
            # best-effort deploy-time guard: max_active beyond the
            # backend's static batch dimension would fail every packed
            # sequence at the first oversized step_batch
            backend_max = (init_kwargs or {}).get(
                "max_batch", getattr(backend_cls, "max_batch", None))
            if (isinstance(backend_max, int)
                    and decode_policy.max_active > backend_max):
                raise ValueError(
                    f"decode_policy.max_active={decode_policy.max_active}"
                    f" exceeds the backend's max_batch={backend_max} "
                    "(the compiled step program's batch dimension)")
        self.name = name
        self.backend_cls = backend_cls
        self.max_retries = max_retries
        self.breaker = breaker
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._init_args = init_args
        self._init_kwargs = init_kwargs
        self.batch_policy = batch_policy
        self.decode_policy = decode_policy
        self._warmup_shapes = list(warmup_shapes or [])
        if batch_policy is not None:
            # batched deployments run behind the replica wrapper: it
            # owns the (status, value)-per-request wire and per-request
            # error isolation, so one poison request can never fail its
            # batchmates (see serve/batching.py)
            self._actor_cls = rt.remote(max_restarts=max_restarts)(
                BatchingReplica)
            self._spawn = lambda: self._actor_cls.remote(
                backend_cls, init_args, init_kwargs or {})
        else:
            self._actor_cls = rt.remote(max_restarts=max_restarts)(
                backend_cls)
            self._spawn = lambda: self._actor_cls.remote(
                *init_args, **(init_kwargs or {}))
        self._lock = threading.Lock()
        self._replicas: List[Any] = [self._spawn()
                                     for _ in range(num_replicas)]
        self._rr = itertools.count()
        self._closed = False
        # (ref, replica, n_logical) triples not yet observed done —
        # drives both the least-loaded dispatch and the autoscaler's
        # demand signal. n_logical is the LOGICAL request count behind
        # a dispatch (a 16-request micro-batch weighs 16, not 1), so
        # routing and scaling see requests, never dispatches. Pruned on
        # every dispatch and load() call, so counts are true in-flight
        # numbers and results never stay pinned.
        self._outstanding: List[Any] = []
        # the two data planes share the queue slot: Handle routing,
        # load() accounting, stats(), and close() treat them uniformly
        # (both expose submit/depth/stats/close)
        if batch_policy is not None:
            self._queue: Optional[Any] = BatchQueue(self, batch_policy)
        elif decode_policy is not None:
            self._queue = DecodeQueue(self, decode_policy)
        else:
            self._queue = None
        if self._warmup_shapes:
            self.warmup(self._warmup_shapes)

    def _counts_locked(self) -> Dict[int, int]:
        """Per-replica outstanding LOGICAL request counts from the
        current (possibly slightly stale) list. Caller holds
        self._lock."""
        counts: Dict[int, int] = {id(r): 0 for r in self._replicas}
        for _, rep, n in self._outstanding:
            if id(rep) in counts:
                counts[id(rep)] += n
        return counts

    def _prune_amortized(self) -> None:
        """Bound both count staleness and pinned-result growth without an
        O(outstanding) rt.wait on every request: prune once the list
        exceeds a few requests per replica."""
        with self._lock:
            threshold = max(32, 4 * len(self._replicas))
            needs = len(self._outstanding) > threshold
        if needs:
            self.load()

    def _pick_replica(self, pin: Optional[int]) -> Tuple[Any, int]:
        """Least-loaded routing over LOGICAL request counts (shared by
        the single-request and micro-batch dispatch paths)."""
        with self._lock:
            replicas = list(self._replicas)
            if not replicas:
                # deleted deployment: a clear terminal signal, not a
                # min()-of-empty / mod-zero crash inside a retry loop
                raise ActorDiedError(
                    f"deployment {self.name!r} has no replicas "
                    "(deleted?)")
            if pin is None:
                # least-loaded with round-robin tiebreak: fresh replicas
                # absorb new traffic. Counts may include a few completed
                # -but-unpruned refs (bounded by _prune_amortized), which
                # only biases toward spreading. NOTE: already-submitted
                # calls stay with their replica (actor queues preserve
                # stateful ordering) — scale-up helps future requests.
                counts = self._counts_locked()
                order = next(self._rr)
                i = min(range(len(replicas)),
                        key=lambda j: (counts.get(id(replicas[j]), 0),
                                       (j - order) % len(replicas)))
            else:
                i = pin % len(replicas)
            return replicas[i], i

    def _fire_chaos(self, replica, i: int) -> None:
        act = _chaos.fire("serve.dispatch", target=self.name, replica=i)
        if act is not None:
            if act["action"] == "crash_replica":
                # chaos: SIGKILL the replica's process just before the
                # request lands — the call fails with ActorDiedError,
                # the restart policy replays the replica's init, and
                # the router's retry path re-dispatches
                from tosem_tpu_torch.chaos.injector import crash_actor_process
                crash_actor_process(replica._actor_id)
            elif act["action"] == "slow_replica":
                time.sleep(act["delay_s"])

    def _dispatch(self, request: Any, pin: Optional[int] = None):
        # breaker admission is the caller's job (ServeFuture): it owns
        # the per-request probe flag the breaker hands out
        self._prune_amortized()
        replica, i = self._pick_replica(pin)
        self._fire_chaos(replica, i)
        ref = replica.call.remote(request)
        with self._lock:
            self._outstanding.append((ref, replica, 1))
        return ref

    def _dispatch_batch(self, requests: List[Any],
                        bucket: Optional[int] = None,
                        pin: Optional[int] = None):
        """Ship one micro-batch to a replica (the BatchQueue's dispatch
        path). ``bucket`` is the padding target the batch was binned
        under; the replica pads every request to exactly that shape, so
        the compiled-program cache sees one program per bucket. Returns
        ``(ref, replica)`` so the completion thread can retry elsewhere
        on replica death. In-flight accounting weighs the batch by its
        LOGICAL size."""
        self._prune_amortized()
        replica, i = self._pick_replica(pin)
        self._fire_chaos(replica, i)
        ref = replica.call_batch.remote(requests, bucket)
        with self._lock:
            self._outstanding.append((ref, replica, len(requests)))
        return ref, replica

    @property
    def num_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    def load(self) -> int:
        """In-flight LOGICAL request count plus micro-batch queue depth
        (the autoscaler's demand signal, the replica queue-length metric
        Serve's controller scrapes). Queued-but-undispatched requests
        count too: demand waiting for a batch slot is exactly what
        scale-up should relieve — and a 16-request batch in flight is 16
        units of demand, not one dispatch. Prunes refs that completed
        since the last call."""
        queued = self._queue.depth() if self._queue is not None else 0
        with self._lock:
            triples = list(self._outstanding)
        if not triples:
            return queued
        refs = [r for r, _, _ in triples]
        done, _ = rt.wait(refs, num_returns=len(refs), timeout=0.0)
        done_set = set(done)
        with self._lock:
            self._outstanding = [t for t in self._outstanding
                                 if t[0] not in done_set]
            return queued + sum(n for _, _, n in self._outstanding)

    def handle(self, pin: Optional[int] = None) -> "Handle":
        """``pin``: route every request of this handle to one replica —
        session affinity for stateful backends (streaming)."""
        return Handle(self, pin=pin)

    def scale(self, num_replicas: int) -> None:
        """Add/remove replicas (the controller's autoscale entry point).

        Scale-down retires the LEAST-LOADED replicas (ideally idle ones)
        rather than a fixed tail — killing a mid-request replica forces
        client-visible retries. No-op after delete() (a late autoscaler
        tick must not spawn unreachable actors).
        """
        if num_replicas < 1:
            raise ValueError("a deployment needs at least one replica; "
                             "use Serve.delete to tear it down")
        self.load()              # prune so counts below are near-exact
        with self._lock:
            if self._closed:
                return
            cur = len(self._replicas)
            if num_replicas > cur:
                fresh = [self._spawn() for _ in range(num_replicas - cur)]
                self._replicas.extend(fresh)
                # pre-warm new replicas without blocking the scaler:
                # the warmup call queues FIRST on the fresh actor, so
                # any request routed there waits behind the compile
                # instead of paying it (actor queues are FIFO)
                for r in fresh:
                    self._warm_async(r)
            elif num_replicas < cur:
                # counts computed UNDER the lock: a dispatch racing this
                # scale-down either lands before (counted, replica looks
                # busy and survives) or after (sees the shrunken list).
                # Decode steps bypass _dispatch, so fold in the decode
                # queue's own per-replica sequence counts — killing a
                # replica packing live sequences forces a full re-decode
                # of each one (and a breaker trip per logical sequence)
                counts = self._counts_locked()
                if self.decode_policy is not None and \
                        self._queue is not None:
                    for key, n in self._queue.replica_loads().items():
                        counts[key] = counts.get(key, 0) + n
                victims = sorted(self._replicas,
                                 key=lambda r: counts.get(id(r), 0))[
                                     :cur - num_replicas]
                victim_ids = {id(v) for v in victims}
                self._replicas = [r for r in self._replicas
                                  if id(r) not in victim_ids]
                for v in victims:
                    rt.kill(v)

    def _can_warm(self) -> bool:
        return (self.batch_policy is not None
                or hasattr(self.backend_cls, "warmup"))

    def _warm_async(self, replica) -> None:
        if self._warmup_shapes and self._can_warm():
            replica.warmup.remote(self._warmup_shapes)

    def warmup(self, shapes: Sequence, timeout: Optional[float] = None
               ) -> List[Any]:
        """Pre-compile the declared shapes on EVERY replica and block
        until done — the deploy-time warm-cache fill that keeps replica
        0's first request from eating a multi-second JIT. ``shapes`` is
        backend-defined (the model backends take their bucket palette).
        Requires a backend with a ``warmup(shapes)`` method (batched
        deployments always have one via the replica wrapper)."""
        if not self._can_warm():
            raise ValueError(
                f"backend {self.backend_cls.__name__} has no warmup() "
                "and the deployment is unbatched — nothing to pre-warm")
        with self._lock:
            replicas = list(self._replicas)
        refs = [r.warmup.remote(list(shapes)) for r in replicas]
        return [rt.get(ref, timeout=timeout) for ref in refs]

    def stats(self) -> Dict[str, Any]:
        """Data-plane snapshot: replica count, logical load, and (for
        batched deployments) queue depth / batch-size telemetry — the
        ``/-/stats`` ingress payload."""
        out: Dict[str, Any] = {"replicas": self.num_replicas,
                               "load": self.load(),
                               "batched": self.batch_policy is not None,
                               "decode": self.decode_policy is not None}
        if self._queue is not None:
            out.update(self._queue.stats())
            if self.batch_policy is not None:
                out["max_batch_size"] = self.batch_policy.max_batch_size
                out["batch_wait_ms"] = self.batch_policy.batch_wait_ms
            else:
                out["max_active"] = self.decode_policy.max_active
        return out

    def close(self) -> None:
        """Kill every replica and refuse further scaling (delete path).
        Queued-but-undispatched requests fail with ActorDiedError."""
        with self._lock:
            self._closed = True
            victims = list(self._replicas)
            self._replicas = []
        if self._queue is not None:
            self._queue.close()
        for v in victims:
            rt.kill(v)


class Handle:
    """Client-side handle (``serve.get_handle`` role).

    On a batched deployment, un-pinned requests ride the micro-batch
    queue (a :class:`~tosem_tpu_torch.serve.batching.BatchedFuture` comes
    back); pinned handles bypass batching — session affinity implies
    stateful per-session ordering that must not interleave with other
    sessions' requests inside one batch."""

    def __init__(self, deployment: Deployment, pin: Optional[int] = None):
        self._dep = deployment
        self._pin = pin

    def _submit_batched(self, request: Any, sync: bool,
                        timeout: Optional[float] = None):
        """Breaker-admitted submit to the micro-batch queue: admission
        happens HERE (not at flush) so an open circuit rejects at
        ``.remote()`` exactly like the unbatched path — per logical
        request, owning its own probe flag. A submit that raises (queue
        closed by delete) releases an acquired probe rather than
        wedging the breaker in 'probe in flight' forever (mirror of
        ``ServeFuture._dispatch_attempt``)."""
        dep = self._dep
        breaker = dep.breaker
        probe = breaker.allow() if breaker is not None else False
        try:
            return dep._queue.submit(request, probe=probe, sync=sync,
                                     timeout=timeout)
        except BaseException:
            if breaker is not None and probe:
                breaker.release_probe()
            raise

    def remote(self, request: Any):
        dep = self._dep
        if dep._queue is not None and self._pin is None:
            return self._submit_batched(request, sync=False)
        return ServeFuture(dep, request, dep.max_retries, pin=self._pin)

    def call(self, request: Any, timeout: Optional[float] = None) -> Any:
        dep = self._dep
        if dep._queue is not None and self._pin is None:
            # sync + idle queue: submit completes the request inline on
            # this thread (no completion-thread spawn / Event handoff),
            # keeping single-client p50 at the unbatched path's cost
            return self._submit_batched(request, sync=True,
                                        timeout=timeout).result(timeout)
        return self.remote(request).result(timeout)

    def stream(self, request: Any, on_token,
               timeout: Optional[float] = None) -> Any:
        """Streaming decode: ``on_token(tokens, done)`` fires from the
        decode scheduler as tokens commit (it must be fast and non-
        blocking — push into a queue, never write a slow socket
        directly); returns the final result like :meth:`call`. Only a
        continuous-batching (DecodeQueue) deployment streams."""
        from tosem_tpu_torch.serve.batching import DecodeQueue
        dep = self._dep
        if not isinstance(dep._queue, DecodeQueue) or self._pin is not None:
            raise TypeError(
                f"deployment {dep.name!r} has no decode queue to "
                "stream from (deploy with decode_policy=...)")
        breaker = dep.breaker
        probe = breaker.allow() if breaker is not None else False
        try:
            fut = dep._queue.submit(request, probe=probe,
                                    on_token=on_token)
        except BaseException:
            if breaker is not None and probe:
                breaker.release_probe()
            raise
        return fut.result(timeout)


class Serve:
    """The controller: name → deployment registry (serve/api.py:36 role)."""

    def __init__(self):
        if not rt.is_initialized():
            rt.init()
        self._deployments: Dict[str, Deployment] = {}
        self._lock = threading.Lock()

    def deploy(self, name: str, backend_cls, *, num_replicas: int = 1,
               init_args: Tuple = (), init_kwargs: Optional[Dict] = None,
               max_restarts: int = 2, max_retries: int = 3,
               circuit_breaker: Union[bool, CircuitBreaker, None] = None,
               backoff_base_s: float = 0.05,
               backoff_cap_s: float = 2.0,
               max_batch_size: int = 1,
               batch_wait_ms: float = 5.0,
               buckets: Optional[Sequence[int]] = None,
               length_of: Optional[Callable[[Any], int]] = None,
               batch_policy: Optional[BatchPolicy] = None,
               decode_policy: Optional[DecodePolicy] = None,
               warmup_shapes: Optional[Sequence] = None) -> Deployment:
        """``circuit_breaker``: True for a default breaker (5 consecutive
        failures open it for 5s), or a configured
        :class:`~tosem_tpu_torch.serve.breaker.CircuitBreaker`; None disables
        (the pre-breaker behavior).

        ``max_batch_size > 1`` (or an explicit ``batch_policy``) turns
        on the adaptive micro-batching data plane: concurrent requests
        coalesce into batches under the ``batch_wait_ms`` latency
        budget, optionally binned into padding ``buckets`` via
        ``length_of`` (see :mod:`tosem_tpu_torch.serve.batching`).
        ``warmup_shapes`` pre-compiles the declared shapes on every
        replica before ``deploy`` returns, so the first request never
        pays the JIT.

        ``decode_policy`` turns on the iteration-level decode data plane
        instead (continuous batching for autoregressive backends — see
        :class:`~tosem_tpu_torch.serve.batching.DecodeQueue`): the backend
        must implement the decode-client protocol (``admit`` /
        ``step_batch`` / ``result`` / ``release``). Mutually exclusive
        with micro-batching."""
        if circuit_breaker is True:
            breaker: Optional[CircuitBreaker] = CircuitBreaker()
        elif isinstance(circuit_breaker, CircuitBreaker):
            breaker = circuit_breaker
        else:
            breaker = None
        if batch_policy is None and max_batch_size > 1:
            batch_policy = BatchPolicy(max_batch_size=max_batch_size,
                                       batch_wait_ms=batch_wait_ms,
                                       buckets=buckets,
                                       length_of=length_of)
        # reserve the name, then construct OUTSIDE the registry lock:
        # Deployment.__init__ blocks on warmup_shapes compiles (multi-
        # second on model backends), and holding the global lock through
        # that would stall every concurrent deploy/get_handle/stats call
        with self._lock:
            if name in self._deployments:
                raise ValueError(f"deployment {name!r} already exists")
            self._deployments[name] = None       # reservation marker
        try:
            dep = Deployment(name, backend_cls, num_replicas, init_args,
                             init_kwargs or {}, max_restarts, max_retries,
                             breaker=breaker, backoff_base_s=backoff_base_s,
                             backoff_cap_s=backoff_cap_s,
                             batch_policy=batch_policy,
                             decode_policy=decode_policy,
                             warmup_shapes=warmup_shapes)
        except BaseException:
            with self._lock:
                self._deployments.pop(name, None)
            raise
        with self._lock:
            if name not in self._deployments:
                deleted = True   # delete() raced the warmup
            else:
                self._deployments[name] = dep
                deleted = False
        if deleted:
            dep.close()
            raise RuntimeError(
                f"deployment {name!r} was deleted while deploying")
        return dep

    def get_handle(self, name: str) -> Handle:
        with self._lock:
            dep = self._deployments[name]
        if dep is None:
            raise KeyError(f"deployment {name!r} is still deploying "
                           "(warmup in progress)")
        return dep.handle()

    def delete(self, name: str) -> None:
        with self._lock:
            dep = self._deployments.pop(name, None)
        if dep is not None:
            dep.close()          # marks closed: late scale() calls no-op

    def list_deployments(self) -> List[str]:
        with self._lock:
            return sorted(self._deployments)

    def get_deployment(self, name: str) -> Optional[Deployment]:
        """Public registry accessor (autoscaler/dashboard use this, not
        the private dict). Names still mid-deploy read as absent."""
        with self._lock:
            return self._deployments.get(name)

    def deployments(self) -> Dict[str, Deployment]:
        with self._lock:
            return {n: d for n, d in self._deployments.items()
                    if d is not None}

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-deployment data-plane snapshot (the ``/-/stats`` ingress
        payload): replica counts, logical load, batching telemetry."""
        return {name: dep.stats()
                for name, dep in sorted(self.deployments().items())}
