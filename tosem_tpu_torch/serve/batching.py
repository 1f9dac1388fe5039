"""Adaptive micro-batching data plane for Serve-lite.

``serve/core.py`` historically executed exactly one request per backend
``call()`` — so the flash-attention kernels (which only win at batch ≥ 8
with segment-id padding) and the runtime's batched pipe I/O were
unreachable from the serving layer. This module coalesces concurrent
:class:`~tosem_tpu_torch.serve.core.ServeFuture`-style requests into
micro-batches under a latency budget, the Clipper/Orca-style continuous
batching the reference ecosystem applies at the request level:

- **Flush policy** — a bin flushes when it reaches ``max_batch_size``
  OR its oldest request has waited ``batch_wait_ms``, whichever first.
  *Adaptive*: while the deployment is idle (no batch in flight) an
  arriving request dispatches immediately — batching only ever steals
  latency from requests that would have queued anyway, so single-client
  p50 stays within noise of the unbatched path. Under load, the
  in-flight cap (``max_inflight_per_replica``) holds new arrivals in
  the queue while replicas chew, and batch sizes grow with observed
  queue depth without any tuning.
- **Padding-bucket routing** — requests carrying variable-length
  payloads are binned by the same pad-target palette the training
  batcher uses (:func:`tosem_tpu_torch.data.feeding.bucket_for`), so each
  micro-batch pads to ONE palette shape, a backend builds one step
  callable per bucket, and padded BERT/speech batches stay on the flash kernels
  (key-padding masks ride as kernel segment ids).
- **Per-request error isolation** — the replica-side wrapper
  (:class:`BatchingReplica`) reports one ``(status, value)`` outcome per
  request; a poison request fails only its own future, and the circuit
  breaker counts per-request outcomes (a lost 16-request batch is 16
  trips of evidence).

Results are scattered back to the originating futures in submit order.

The port's copy of ``tosem_tpu/serve/batching.py``. Where the JAX
package compiles one XLA program per bucket, the port's backends build
one step callable per bucket. :class:`DecodeQueue` turns on spill,
migration and streamed hand-off only for a backend that has them
(``spill_seq``, ``export_seq``, ``send_seq``); the port's
``BertDecodeBackend`` has the first two, so disaggregated prefill hands
each prefilled sequence over by export until the transport behind
``send_seq`` is ported (ROADMAP.md A11).
"""
from __future__ import annotations

import collections
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from tosem_tpu_torch.chaos import hooks as _chaos
from tosem_tpu_torch.data.feeding import pad_target
from tosem_tpu_torch.obs.metrics import serve_metrics
from tosem_tpu_torch.runtime.common import DeadlineExceeded, TaskError
from tosem_tpu_torch.serve.breaker import CircuitOpen

# statuses on the replica→driver batch wire
OK = "ok"
ERR = "err"


@dataclass
class BatchPolicy:
    """Knobs for a deployment's micro-batch queue.

    ``buckets``/``length_of`` enable padding-bucket routing: requests
    are measured with ``length_of(request)`` and binned to the smallest
    palette bucket that fits (overlong requests get their own
    ``align``-rounded shape). ``align`` defaults to 128 — the flash
    kernels' lane-tile requirement — so bucketed batches stay eligible.
    """
    max_batch_size: int = 8
    batch_wait_ms: float = 5.0
    adaptive: bool = True
    max_inflight_per_replica: int = 2
    buckets: Optional[Sequence[int]] = None
    length_of: Optional[Callable[[Any], int]] = None
    align: int = 128

    def __post_init__(self):
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if self.batch_wait_ms < 0:
            raise ValueError("batch_wait_ms must be >= 0")
        if self.max_inflight_per_replica < 1:
            raise ValueError("max_inflight_per_replica must be >= 1")

    def bucket_of(self, request: Any) -> Optional[int]:
        if self.buckets is None or self.length_of is None:
            return None
        return pad_target(self.length_of(request), self.buckets,
                          align=self.align)


class BatchedFuture:
    """Future for a queued request (the batched ``ServeFuture`` role):
    the completion machinery lives in the queue's threads, the caller
    just waits. ``result(timeout)`` raises :class:`TimeoutError` like
    ``rt.get`` — a timed-out wait does NOT abandon the request (the
    in-flight batch still records its breaker verdict when it lands)."""

    __slots__ = ("_event", "_value", "_exc")

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._exc: Optional[BaseException] = None

    def _set_result(self, value: Any) -> None:
        self._value = value
        self._event.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("batched request still in flight")
        if self._exc is not None:
            raise self._exc
        return self._value


@dataclass
class _Item:
    request: Any
    future: BatchedFuture
    probe: bool
    enqueued_at: float = field(default_factory=time.monotonic)
    deadline: Optional[float] = None   # monotonic shed-by time


class BatchingReplica:
    """Replica-side wrapper: one backend instance behind a batched call
    surface with per-request error isolation.

    ``call_batch`` returns one ``(OK, value)`` or ``(ERR, cause, tb)``
    tuple per request, in order. A backend that defines its own
    vectorized ``call_batch(requests, pad_to=…)`` gets it tried first;
    if the vectorized path raises, the batch falls back to per-request
    ``call`` so a single poison request fails alone instead of taking
    its batchmates down. Backends without ``call_batch`` always take
    the per-request loop (batching still amortizes the actor-call round
    trip).
    """

    def __init__(self, backend_cls, init_args: Tuple, init_kwargs: Dict):
        self.backend = backend_cls(*init_args, **(init_kwargs or {}))

    def call(self, request: Any) -> Any:
        return self.backend.call(request)

    def _one(self, request: Any, pad_to: Optional[int] = None) -> Tuple:
        """One isolated request. ``pad_to`` keeps the fallback on the
        batch's bucket program: surviving batchmates of a poison
        request must produce the exact bytes they would have produced
        in the vectorized call (the bit-exactness contract — results
        never depend on batch composition)."""
        try:
            vector = (getattr(self.backend, "call_batch", None)
                      if pad_to is not None else None)
            if vector is not None:
                return (OK, vector([request], pad_to=pad_to)[0])
            return (OK, self.backend.call(request))
        except Exception as e:
            return (ERR,) + _portable_error(e)

    def call_batch(self, requests: List[Any],
                   pad_to: Optional[int] = None) -> List[Tuple]:
        if len(requests) == 1 and pad_to is None:
            # a solo unbucketed request has nothing to vectorize: skip
            # the batch assembly (bucketed deployments keep the vector
            # path — one compiled program per bucket, never per length)
            return [self._one(requests[0])]
        vector = getattr(self.backend, "call_batch", None)
        if vector is not None:
            try:
                values = vector(requests, pad_to=pad_to)
            except Exception:
                # vectorized path poisoned: isolate per request, still
                # on the bucket's program shape
                return [self._one(r, pad_to) for r in requests]
            if len(values) != len(requests):
                # wire bug, not a poison request: surface it — a silent
                # per-request re-run would mask the backend defect
                raise RuntimeError(
                    f"backend call_batch returned {len(values)} "
                    f"results for {len(requests)} requests")
            return [(OK, v) for v in values]
        return [self._one(r) for r in requests]

    def warmup(self, shapes: Sequence) -> Dict[str, Any]:
        """Pre-compile declared shapes (deploy-time warm cache fill).
        Delegates to the backend's ``warmup`` when it has one."""
        fn = getattr(self.backend, "warmup", None)
        if fn is None:
            return {"warmed": 0}
        return fn(shapes)

    def stats(self) -> Dict[str, Any]:
        fn = getattr(self.backend, "stats", None)
        return fn() if fn is not None else {}


def _portable_error(e: BaseException) -> Tuple[BaseException, str]:
    """(cause, remote traceback) that survives the result pickle — an
    unpicklable backend exception must fail ITS request, not the whole
    batch result."""
    tb = traceback.format_exc()
    from tosem_tpu_torch.runtime import common
    try:
        common.loads(common.dumps(e))
        return e, tb
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}"), tb


class BatchQueue:
    """Per-deployment micro-batch queue + flusher.

    The flusher thread owns the flush decision; each dispatched batch
    gets a completion thread that retries replica-death transport
    failures with the deployment's backoff (mirroring
    ``ServeFuture.result``) and scatters per-request outcomes back to
    the futures. The queue tracks *logical* requests throughout: its
    ``depth()`` plus the deployment's in-flight logical count is the
    autoscaler's demand signal.
    """

    def __init__(self, deployment, policy: BatchPolicy):
        self._dep = deployment
        self.policy = policy
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._bins: Dict[Optional[int], collections.deque] = {}
        self._depth = 0              # queued logical requests
        self._inflight_batches = 0
        self._closed = False
        self._close_error: Optional[BaseException] = None
        self._ewma_batch = 1.0
        self._batches = 0
        self._requests_ok = 0
        self._requests_err = 0
        self._metrics = serve_metrics()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"serve-batch-{deployment.name}")
        self._thread.start()

    # ----------------------------------------------------------- client side

    def submit(self, request: Any, probe: bool = False,
               sync: bool = False,
               timeout: Optional[float] = None) -> BatchedFuture:
        """``sync``: the caller will block on ``result()`` immediately
        (the ``Handle.call`` path). When the queue is idle this runs the
        whole dispatch→get→scatter chain inline on the caller's thread —
        no completion-thread spawn, no Event handoff — so a lone
        request's latency is structurally the unbatched path's (thread
        creation and cross-thread wakeups are the dominant per-request
        cost on small hosts, not the batch bookkeeping). ``timeout``
        bounds the INLINE chain (get + backoff retries) so the sync
        caller's deadline contract survives batching; on the queued
        path it becomes the item's flush-time deadline — a request
        whose budget expired while it queued is shed typed
        (:class:`~tosem_tpu_torch.runtime.common.DeadlineExceeded`) at
        dispatch instead of riding the batch to an answer its caller
        already abandoned (its batchmates dispatch untouched)."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        item = _Item(request, BatchedFuture(), probe, deadline=deadline)
        bucket = self.policy.bucket_of(request)
        items = None
        with self._cv:
            if self._closed:
                raise self._close_error or RuntimeError(
                    f"deployment {self._dep.name!r} batch queue closed")
            self._bins.setdefault(bucket, collections.deque()).append(item)
            self._depth += 1
            if (self.policy.adaptive and self._depth == 1
                    and self._inflight_batches == 0):
                # idle fast path: dispatch from the submitting thread —
                # skipping the flusher wakeup hop — so a lone request's
                # latency matches the unbatched path (the flush decision
                # is trivial: this item, alone, now; _pick_locked
                # records the post-pick queue depth)
                items, bucket, _ = self._pick_locked(time.monotonic())
            else:
                self._metrics["queue_depth"].set(self._depth,
                                                 (self._dep.name,))
                self._cv.notify_all()
        if items is not None:
            self._dispatch(items, bucket, inline=sync, deadline=deadline)
        return item.future

    def depth(self) -> int:
        """Queued logical requests (not yet dispatched)."""
        with self._lock:
            return self._depth

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "queued": self._depth,
                "inflight_batches": self._inflight_batches,
                "batches": self._batches,
                "ewma_batch_size": round(self._ewma_batch, 2),
                "requests_ok": self._requests_ok,
                "requests_err": self._requests_err,
            }

    def close(self, error: Optional[BaseException] = None) -> None:
        """Stop the flusher and fail every queued request (deployment
        deleted). In-flight batches finish on their own threads."""
        with self._cv:
            self._closed = True
            self._close_error = error
            pending = [it for b in self._bins.values() for it in b]
            self._bins.clear()
            self._depth = 0
            self._cv.notify_all()
        from tosem_tpu_torch.runtime.common import ActorDiedError
        exc = error or ActorDiedError(
            f"deployment {self._dep.name!r} deleted with requests queued")
        for it in pending:
            self._release_probe(it)
            it.future._set_exception(exc)
        self._thread.join(timeout=2.0)

    # ---------------------------------------------------------- flusher side

    def _pick_locked(self, now: float
                     ) -> Tuple[Optional[List[_Item]], Optional[int],
                                Optional[float]]:
        """Flush decision. Returns (items, bucket, wait_s): items=None
        means wait up to wait_s (None = until notified)."""
        if not self._bins:
            return None, None, None
        cap = max(1, self._dep.num_replicas
                  * self.policy.max_inflight_per_replica)
        if self._inflight_batches >= cap:
            return None, None, None       # woken by batch completion
        # oldest-head bin first: FIFO fairness across buckets
        order = sorted(self._bins.items(),
                       key=lambda kv: kv[1][0].enqueued_at)
        full = [(b, q) for b, q in order
                if len(q) >= self.policy.max_batch_size]
        if full:
            bucket, q = full[0]
        elif self.policy.adaptive and self._inflight_batches == 0:
            # idle hardware: waiting can only add latency (the Clipper
            # insight — batch only when the system is busy)
            bucket, q = order[0]
        else:
            bucket, q = order[0]
            deadline = q[0].enqueued_at + self.policy.batch_wait_ms / 1e3
            if now < deadline:
                return None, None, max(deadline - now, 1e-4)
        items = [q.popleft()
                 for _ in range(min(len(q), self.policy.max_batch_size))]
        if not q:
            del self._bins[bucket]
        self._depth -= len(items)
        self._inflight_batches += 1
        self._metrics["queue_depth"].set(self._depth, (self._dep.name,))
        return items, bucket, None

    def _loop(self) -> None:
        while True:
            with self._cv:
                items = None
                while items is None:
                    if self._closed:
                        return
                    items, bucket, wait_s = self._pick_locked(
                        time.monotonic())
                    if items is None:
                        self._cv.wait(timeout=wait_s)
            self._dispatch(items, bucket)

    def _batch_done_locked_dec(self) -> None:
        with self._cv:
            self._inflight_batches -= 1
            if self._bins:
                # wake the flusher only when queued work exists — a
                # lone closed-loop client must not pay a flusher
                # context switch per request just to free its slot
                self._cv.notify_all()

    def _dispatch(self, items: List[_Item], bucket: Optional[int],
                  inline: bool = False,
                  deadline: Optional[float] = None) -> None:
        name = self._dep.name
        now = time.monotonic()
        # flush-time deadline shed: an item whose budget expired while
        # it queued fails ALONE, typed, before any replica work — its
        # batchmates dispatch as if it never queued. No breaker verdict
        # (the deployment did nothing wrong; the budget was just small).
        expired = [it for it in items
                   if it.deadline is not None and now >= it.deadline]
        if expired:
            items = [it for it in items if it not in expired]
            for it in expired:
                self._release_probe(it)
                it.future._set_exception(DeadlineExceeded(
                    f"request budget expired after "
                    f"{(now - it.enqueued_at) * 1e3:.0f}ms in the "
                    f"{name!r} batch queue"))
            self._count(err=len(expired))
            if not items:
                self._batch_done_locked_dec()
                return
        self._metrics["batch_size"].set(len(items), (name,))
        for it in items:
            self._metrics["batch_wait_ms"].observe(
                (now - it.enqueued_at) * 1e3, (name,))
        with self._lock:
            self._batches += 1
            self._ewma_batch = 0.8 * self._ewma_batch + 0.2 * len(items)
        try:
            ref, replica = self._dep._dispatch_batch(
                [it.request for it in items], bucket)
        except BaseException as e:
            # dispatch never reached a replica (deleted deployment):
            # mirror ServeFuture._dispatch_attempt — release any probe
            # without a verdict, surface the error per future
            self._batch_done_locked_dec()
            for it in items:
                self._release_probe(it)
                it.future._set_exception(e)
            self._count(err=len(items))
            return
        if inline:
            # sync caller: get + scatter on this thread — the futures
            # are already resolved when submit() returns, exactly like
            # ServeFuture.result's in-thread wait (backoff retries
            # sleep the caller, matching the unbatched path)
            self._complete(ref, replica, items, bucket, deadline=deadline)
        else:
            threading.Thread(target=self._complete,
                             args=(ref, replica, items, bucket), daemon=True,
                             name=f"serve-batch-wait-{name}").start()

    # ------------------------------------------------------- completion side

    def _release_probe(self, item: _Item) -> None:
        if item.probe:
            breaker = self._dep.breaker
            if breaker is not None:
                breaker.release_probe()
            item.probe = False

    def _take_probe(self, items: List[_Item]) -> bool:
        """Consume the batch's probe flag (at most one request holds the
        breaker's half-open probe) for a batch-level record call."""
        probe = False
        for it in items:
            if it.probe:
                probe = True
                it.probe = False
        return probe

    def _count(self, ok: int = 0, err: int = 0) -> None:
        name = self._dep.name
        with self._lock:
            self._requests_ok += ok
            self._requests_err += err
        if ok:
            self._metrics["requests"].inc(ok, (name, "ok"))
        if err:
            self._metrics["requests"].inc(err, (name, "error"))

    def _fail(self, items: List[_Item], exc: BaseException) -> None:
        # the in-flight slot is released BEFORE futures complete — same
        # reason as _finish below
        self._batch_done_locked_dec()
        for it in items:
            it.future._set_exception(exc)
        self._count(err=len(items))

    def _finish(self, items: List[_Item], outcomes: List[Tuple]) -> None:
        """Terminal bookkeeping for a landed batch. The in-flight slot
        is released BEFORE futures are completed: a closed-loop client
        woken by its future submits its next request immediately, and
        that request must find the queue idle (adaptive immediate
        dispatch) rather than race this thread's remaining scatter work
        into a pointless batch_wait_ms stall."""
        self._batch_done_locked_dec()
        self._scatter(items, outcomes)

    def _complete(self, ref, replica, items: List[_Item],
                  bucket: Optional[int],
                  deadline: Optional[float] = None) -> None:
        import tosem_tpu_torch.runtime as rt
        from tosem_tpu_torch.serve.core import RETRYABLE
        breaker = self._dep.breaker
        retries_left = self._dep.max_retries
        attempt = 0
        while True:
            try:
                remaining = (None if deadline is None
                             else max(deadline - time.monotonic(), 0.001))
                # single-memcpy result handoff: a batch result above the
                # inline threshold rides a store handle and is mapped in
                # place here — item values scattered to futures alias
                # the (pinned, readonly) shm pages, no heap copy
                outcomes = rt.get(ref, timeout=remaining, copy=False)
                if (not isinstance(outcomes, list)
                        or len(outcomes) != len(items)):
                    raise TaskError(RuntimeError(
                        f"batch wire mismatch: {len(items)} requests, "
                        f"{outcomes!r:.120}"), "")
            except RETRYABLE as e:
                # transport failure: the whole batch is evidence —
                # one breaker trip per LOGICAL request (satellite:
                # requests, not dispatches)
                if breaker is not None:
                    breaker.record_failure(probe=self._take_probe(items),
                                           count=len(items))
                if retries_left <= 0:
                    self._fail(items, e)
                    return
                retries_left -= 1
                delay = min(self._dep.backoff_base_s * (2 ** attempt),
                            self._dep.backoff_cap_s)
                if deadline is not None:
                    # mirror ServeFuture.result: never sleep past the
                    # caller's budget, and leave half of what's left
                    # for the retried attempt itself
                    budget = deadline - time.monotonic()
                    if budget <= 0:
                        self._fail(items, e)
                        return
                    delay = min(delay, budget / 2)
                time.sleep(delay)
                attempt += 1
                if breaker is not None:
                    # per-attempt re-admission, like ServeFuture's
                    # _dispatch_attempt: once the batch's failures
                    # opened the circuit, retries must shed load during
                    # the cooldown instead of hammering the deployment
                    try:
                        items[0].probe = breaker.allow()
                    except CircuitOpen as e2:
                        self._fail(items, e2)
                        return
                try:
                    ref, replica = self._dep._dispatch_batch(
                        [it.request for it in items], bucket)
                except BaseException as e2:
                    for it in items:
                        self._release_probe(it)
                    self._fail(items, e2)
                    return
            except TaskError as e:
                # whole-batch application error that escaped the
                # wrapper's isolation (e.g. the batch result itself
                # failed to unpickle): verdict per logical request
                if breaker is not None:
                    breaker.record_failure(probe=self._take_probe(items),
                                           count=len(items))
                self._fail(items, e)
                return
            except BaseException as e:
                # no verdict (interpreter teardown, cancellation):
                # free the probe instead of wedging the breaker
                for it in items:
                    self._release_probe(it)
                self._fail(items, e)
                return
            else:
                self._finish(items, outcomes)
                return

    def _scatter(self, items: List[_Item], outcomes: List[Tuple]) -> None:
        breaker = self._dep.breaker
        ok = err = 0
        for it, out in zip(items, outcomes):
            if out[0] == OK:
                if breaker is not None:
                    breaker.record_success(probe=it.probe)
                it.probe = False
                it.future._set_result(out[1])
                ok += 1
            else:
                cause, tb = out[1], (out[2] if len(out) > 2 else "")
                if breaker is not None:
                    breaker.record_failure(probe=it.probe)
                it.probe = False
                it.future._set_exception(TaskError(cause, tb))
                err += 1
        self._count(ok=ok, err=err)


# ---------------------------------------------------------------------------
# iteration-level decode scheduling (continuous batching)


@dataclass
class SamplingPolicy:
    """Default branch-fanout for a decode deployment's requests.

    ``n > 1`` turns every request into an N-branch group: beam search
    when ``beam`` is set (branches scored by cumulative logprob, COW-
    forked/rolled-back through the paged cache's refcounts), independent
    parallel sampling otherwise (deterministic per-(seed, branch, step)
    draws at ``temperature``). Per-request keys (``"n"``, ``"beam"``,
    ``"temperature"``, ``"seed"``) override these defaults. A group
    occupies ``n`` rows of every decode step — the scheduler weighs it
    as ``n`` slots against ``max_active``."""
    n: int = 1
    beam: bool = False
    temperature: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.n < 1:
            raise ValueError("n must be >= 1")
        if self.temperature <= 0:
            raise ValueError("temperature must be > 0")


@dataclass
class DecodePolicy:
    """Knobs for a deployment's continuous-batching decode queue.

    ``max_active`` bounds the step-program rows packed into one
    replica's decode step (an N-branch sampling/beam group counts N) —
    it must not exceed the backend's ``max_batch`` (the static batch
    dimension of the compiled step program). ``idle_wait_s`` is the
    scheduler's sleep when admission is blocked but work remains (page
    pressure with nothing retiring yet). ``sampling`` sets the default
    :class:`SamplingPolicy` merged into every request.

    ``prefill_replicas`` turns on prefill/decode DISAGGREGATION: the
    deployment's first N replicas become prefill-only — admissions run
    on them ASYNCHRONOUSLY (the scheduler keeps stepping decode
    replicas while prompts prefill elsewhere, so a burst of long
    prompts never stalls in-flight token streams), and each prefilled
    sequence's KV pages migrate to a decode replica over the live-KV-
    migration path before its first step. Requires a backend with the
    migration surface (``export_seq``/``import_seq``); the remaining
    replicas serve decode steps.

    ``straggler_factor`` > 0 arms the slow-replica watchdog (gray-
    failure recovery): a replica whose recent median step time exceeds
    ``straggler_factor`` × the fleet median (with at least
    ``straggler_min_samples`` steps observed and an absolute floor of
    ``straggler_min_s`` — tiny steps jitter) is DRAINED through the
    live-migration path, exactly like a deliberate node drain: its
    sequences continue from their current step on healthy replicas
    instead of decoding at the straggler's pace until a 120s step
    timeout finally declares it dead. Off by default (0.0) — single-
    replica fleets and deterministic tests must never self-drain."""
    max_active: int = 8
    idle_wait_s: float = 0.01
    sampling: Optional[SamplingPolicy] = None
    prefill_replicas: int = 0
    straggler_factor: float = 0.0
    straggler_min_samples: int = 3
    straggler_min_s: float = 0.02
    # multi-turn sessions: requests may carry {"session": key}; the
    # replica keeps the finished KV resident (spillable, migrating with
    # drains) so the next turn admits as a pure suffix prefill
    session: bool = False

    def __post_init__(self):
        if self.max_active < 1:
            raise ValueError("max_active must be >= 1")
        if self.idle_wait_s < 0:
            raise ValueError("idle_wait_s must be >= 0")
        if self.prefill_replicas < 0:
            raise ValueError("prefill_replicas must be >= 0")
        if self.straggler_factor < 0:
            raise ValueError("straggler_factor must be >= 0")
        if self.straggler_min_samples < 1:
            raise ValueError("straggler_min_samples must be >= 1")
        if self.sampling is not None and self.sampling.n > self.max_active:
            raise ValueError(
                f"sampling.n={self.sampling.n} exceeds max_active="
                f"{self.max_active}")


@dataclass
class _DecodeItem:
    request: Any
    future: BatchedFuture
    probe: bool
    seq_id: str
    step: int = 0                    # next decode-step index
    replica: Any = None              # pinned actor handle (cache lives there)
    attempts: int = 0                # transport-failure re-admissions spent
    stalls: int = 0                  # consecutive page-pressured steps
    slots: int = 1                   # step rows this item packs (group: n)
    prefill_state: Any = None        # exported state awaiting a decode slot
    src_replica: Any = None          # prefill replica while admitting
    on_token: Any = None             # streaming callback (tokens, done)
    streamed: int = 0                # tokens delivered to on_token
    observed: int = 0                # tokens seen since last admit
    enqueued_at: float = field(default_factory=time.monotonic)


class DecodeQueue:
    """Iteration-level scheduler for autoregressive decode (the
    Orca/vLLM continuous-batching discipline on the Serve-lite data
    plane).

    Where :class:`BatchQueue` batches whole REQUESTS, this queue
    schedules per decode STEP: every iteration it admits new sequences
    into free batch slots, packs all active sequences into one
    ``step_batch`` call per replica (one compiled program regardless of
    packing — retired rows ride along inactive, so there are no per-step
    recompiles), retires finished sequences immediately (their slot and
    KV pages free THIS step, not when the batch drains), and under page
    pressure spills the pressured sequence's KV pages to the object
    store and requeues it instead of OOMing.

    Contracts carried over from the micro-batch plane:

    - **Per-request error isolation** — a poison prompt fails only its
      own future (``admit`` validates replica-side); a transport failure
      re-admits only the dead replica's sequences.
    - **Logical accounting** — the breaker sees one verdict per
      SEQUENCE (a replica death with 6 active sequences is 6 trips of
      evidence); :meth:`depth` counts queued + active + spilled
      sequences, so the autoscaler sees demand, not dispatches.
    - **Determinism** — greedy decode is deterministic and spill/
      restore is byte-preserving, so outputs never depend on scheduling
      decisions, evictions, or replica deaths (recovery re-prefills
      from token history and replays the identical token path).

    Chaos site ``serve.decode_step`` fires once per scheduler iteration
    (actions: ``evict_pages`` spills the coldest active sequence,
    ``slow_step`` delays the loop); each per-replica step dispatch also
    fires the ``serve.dispatch`` site, so canned plans can kill a
    replica mid-decode.
    """

    def __init__(self, deployment, policy: DecodePolicy):
        self._dep = deployment
        self.policy = policy
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: collections.deque = collections.deque()
        self._active: List[_DecodeItem] = []      # admit order
        self._waiting: List[_DecodeItem] = []     # spilled, awaiting restore
        # replicas whose last step spilled a pressured sequence for its
        # batchmates: their restores skip the next turn (C-ref9)
        self._hold_restores: set = set()
        self._closed = False
        self._close_error: Optional[BaseException] = None
        self._seq_counter = 0
        self._steps = 0
        self._tokens = 0
        self._loop_errors = 0
        self._seqs_ok = 0
        self._seqs_err = 0
        self._spills = 0
        self._restores = 0
        self._migrations = 0
        self._migration_fallbacks = 0
        self._readmit_step0 = 0
        # disaggregated-prefill state: (item, admit ref) pairs in
        # flight on the prefill tier, prefilled sequences waiting for a
        # decode-replica slot, and (item, import ref, t0) handoffs in
        # flight on the decode tier — every phase is ASYNC so the
        # scheduler loop only ever blocks on step dispatches
        self._prefilling: List[Tuple[_DecodeItem, Any]] = []
        self._prefilled: collections.deque = collections.deque()
        self._importing: List[Tuple[_DecodeItem, Any, float]] = []
        # straggler watchdog state: recent per-replica step times keyed
        # id(replica), replicas quarantined after a straggler drain
        # (admission routes around them until they die or recover), and
        # the drain count for stats/tests
        self._step_times: Dict[int, collections.deque] = {}
        self._quarantined: set = set()
        self._straggler_drains = 0
        # decode-replica tensor-receiver addresses, fetched once per
        # replica (the worker→worker page-stream destinations)
        self._transport_addrs: Dict[int, str] = {}
        self._can_stream = (hasattr(deployment.backend_cls, "send_seq")
                            and hasattr(deployment.backend_cls,
                                        "transport_address"))
        self._cache_stats: Dict[str, Any] = {}
        self._can_spill = hasattr(deployment.backend_cls, "spill_seq")
        self._can_migrate = hasattr(deployment.backend_cls, "export_seq")
        if policy.prefill_replicas and not self._can_migrate:
            raise ValueError(
                "prefill_replicas requires a backend with the "
                "migration surface (export_seq/import_seq)")
        # serializes live migration against the step loop: an exported
        # sequence must never receive a step on its OLD replica after
        # the source copy was released (RLock — the chaos hook drains
        # from the scheduler thread itself)
        self._mig_lock = threading.RLock()
        self._metrics = serve_metrics()
        self._last_scrape = 0.0
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"serve-decode-{deployment.name}")
        self._thread.start()

    # ----------------------------------------------------------- client side

    def submit(self, request: Any, probe: bool = False,
               sync: bool = False,
               timeout: Optional[float] = None,
               on_token: Any = None) -> BatchedFuture:
        """Queue one sequence for decode. ``sync``/``timeout`` exist for
        Handle-surface compatibility; a decode request spans many
        scheduler iterations, so there is no inline fast path — the
        caller bounds its wait via ``result(timeout)``.

        ``on_token(tokens, done)`` streams committed tokens out of the
        step loop as they land (called from the scheduler thread —
        callbacks must be fast and non-blocking; push into a queue)."""
        del sync, timeout
        if isinstance(request, dict) and request.get("session") is not None \
                and not self.policy.session:
            raise ValueError(
                "request carries a session key but "
                "DecodePolicy(session=True) is not set for deployment "
                f"{self._dep.name!r}")
        sampling = self.policy.sampling
        if sampling is not None and sampling.n > 1 \
                and isinstance(request, dict):
            # deployment-default fanout: merge the policy's knobs under
            # any per-request overrides (never mutate the caller's dict)
            request = {"n": sampling.n, "beam": sampling.beam,
                       "temperature": sampling.temperature,
                       "seed": sampling.seed, **request}
        slots = 1
        if isinstance(request, dict):
            try:
                slots = max(int(request.get("n", 1) or 1), 1)
            except (TypeError, ValueError):
                slots = 1                # poison n: fails at admit
        with self._cv:
            if self._closed:
                raise self._close_error or RuntimeError(
                    f"deployment {self._dep.name!r} decode queue closed")
            self._seq_counter += 1
            item = _DecodeItem(
                request=request, future=BatchedFuture(), probe=probe,
                seq_id=f"{self._dep.name}/{self._seq_counter}",
                slots=slots, on_token=on_token)
            self._pending.append(item)
            self._cv.notify_all()
        return item.future

    def depth(self) -> int:
        """Demand signal: queued + active + spilled + prefilling
        sequences (every sequence the data plane still owes a
        completion)."""
        with self._lock:
            return (len(self._pending) + len(self._active)
                    + len(self._waiting) + len(self._prefilling)
                    + len(self._prefilled) + len(self._importing))

    def replica_loads(self) -> Dict[int, int]:
        """Per-replica step-row counts keyed ``id(replica)`` — the
        decode plane's own in-flight accounting (steps never pass
        through ``Deployment._dispatch``, so ``_outstanding`` can't see
        them; an N-branch group weighs N). ``Deployment.scale`` uses
        this to retire the least-loaded replica instead of one packing
        live sequences."""
        with self._lock:
            counts: Dict[int, int] = {}
            for it in (self._active + self._waiting
                       + [p for p, _ in self._prefilling]
                       + [p for p, _, _ in self._importing]
                       + list(self._prefilled)):
                counts[id(it.replica)] = (counts.get(id(it.replica), 0)
                                          + it.slots)
            # a streamed admit sets .replica to the decode DESTINATION;
            # the prefill itself runs on src_replica — charge it there
            # too, or _launch_prefills sees every prefill replica as
            # idle and piles the whole tier onto index 0
            for it, _ in self._prefilling:
                if (it.src_replica is not None
                        and it.src_replica is not it.replica):
                    counts[id(it.src_replica)] = (
                        counts.get(id(it.src_replica), 0) + it.slots)
            return counts

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "queued": len(self._pending),
                "active_sequences": len(self._active),
                "spilled_sequences": len(self._waiting),
                "decode_steps": self._steps,
                "tokens_emitted": self._tokens,
                "sequences_ok": self._seqs_ok,
                "sequences_err": self._seqs_err,
                "kv_spills": self._spills,
                "kv_restores": self._restores,
                "kv_migrations": self._migrations,
                "kv_migration_fallbacks": self._migration_fallbacks,
                "seqs_readmitted_step0": self._readmit_step0,
                "prefilling_sequences": len(self._prefilling)
                + len(self._prefilled),
                "scheduler_loop_errors": self._loop_errors,
                "straggler_drains": self._straggler_drains,
                "straggler_quarantined": len(self._quarantined),
            }
            out.update({f"kv_{k}": v
                        for k, v in sorted(self._cache_stats.items())})
            return out

    def close(self, error: Optional[BaseException] = None) -> None:
        with self._cv:
            self._closed = True
            self._close_error = error
            doomed = (list(self._pending) + list(self._active)
                      + list(self._waiting)
                      + [p for p, _ in self._prefilling]
                      + [p for p, _, _ in self._importing]
                      + list(self._prefilled))
            self._pending.clear()
            self._active = []
            self._waiting = []
            self._prefilling = []
            self._importing = []
            self._prefilled.clear()
            self._cv.notify_all()
        from tosem_tpu_torch.runtime.common import ActorDiedError
        exc = error or ActorDiedError(
            f"deployment {self._dep.name!r} deleted with sequences "
            "in flight")
        for it in doomed:
            self._release_probe(it)
            it.future._set_exception(exc)
        self._thread.join(timeout=2.0)

    # -------------------------------------------------------- scheduler side

    def _release_probe(self, item: _DecodeItem) -> None:
        if item.probe:
            breaker = self._dep.breaker
            if breaker is not None:
                breaker.release_probe()
            item.probe = False

    def _release_replica_state(self, item: _DecodeItem) -> None:
        """Best-effort fire-and-forget release of an ADMITTED sequence's
        replica-side state (KV pages, ledger). Every post-admission
        failure path must call this or the failed sequence's pages leak
        out of the pool forever (backend ``release`` is idempotent)."""
        if item.replica is None:
            return
        try:
            item.replica.release.remote(item.seq_id)
        except BaseException:
            pass                  # dead replica: its pool died with it

    def _succeed(self, item: _DecodeItem, value: Any) -> None:
        breaker = self._dep.breaker
        if breaker is not None:
            breaker.record_success(probe=item.probe)
        item.probe = False
        item.future._set_result(value)
        with self._lock:
            self._seqs_ok += 1
        self._metrics["requests"].inc(1, (self._dep.name, "ok"))

    def _fail(self, item: _DecodeItem, exc: BaseException,
              verdict: bool = True) -> None:
        breaker = self._dep.breaker
        if breaker is not None:
            if verdict:
                breaker.record_failure(probe=item.probe)
                item.probe = False
            else:
                self._release_probe(item)
        item.probe = False
        item.future._set_exception(exc)
        with self._lock:
            self._seqs_err += 1
        self._metrics["requests"].inc(1, (self._dep.name, "error"))

    def _replicas(self) -> List[Any]:
        with self._dep._lock:
            return list(self._dep._replicas)

    def _replica_index(self, replica) -> int:
        with self._dep._lock:
            for i, r in enumerate(self._dep._replicas):
                if r is replica:
                    return i
        return 0

    def _split_replicas(self) -> Tuple[List[Any], List[Any]]:
        """(prefill tier, decode tier) under disaggregation: the
        deployment's first ``prefill_replicas`` replicas admit, the
        rest step. Always leaves at least one decode replica; without
        disaggregation the prefill tier is empty."""
        reps = self._replicas()
        n = min(self.policy.prefill_replicas, max(len(reps) - 1, 0))
        return reps[:n], reps[n:]

    def _pick_replica(self, slots: int = 1,
                      exclude=None) -> Optional[Any]:
        """Least-loaded DECODE replica with ``slots`` free step rows,
        by THIS queue's own row counts (active + spilled both hold
        replica-side state). Deterministic: ties break by replica
        index. ``exclude`` drops one replica from consideration (the
        drain path must never migrate a sequence back onto the
        replica being drained)."""
        _, replicas = self._split_replicas()
        if exclude is not None:
            replicas = [r for r in replicas if r is not exclude]
        with self._lock:
            quarantined = set(self._quarantined)
        if quarantined:
            # a drained straggler keeps its process but loses admission
            # preference: route around it while ANY healthy replica has
            # room (it still serves as the last resort — a quarantined
            # fleet must not deadlock the queue)
            healthy = [r for r in replicas if id(r) not in quarantined]
            if healthy:
                replicas = healthy
        if not replicas:
            if exclude is not None:
                return None       # nowhere else: caller falls back
            from tosem_tpu_torch.runtime.common import ActorDiedError
            raise ActorDiedError(
                f"deployment {self._dep.name!r} has no replicas "
                "(deleted?)")
        counts = self.replica_loads()
        best = min(range(len(replicas)),
                   key=lambda j: (counts.get(id(replicas[j]), 0), j))
        if counts.get(id(replicas[best]), 0) + slots \
                > self.policy.max_active:
            return None
        return replicas[best]

    def _requeue_for_readmission(self, items: List[_DecodeItem],
                                 cause: BaseException,
                                 charge: bool = True) -> None:
        """Replica-death recovery: reset each surviving sequence to step
        0 and put it at the FRONT of the pending queue — re-admission
        re-prefills from the prompt and greedy decode replays the
        identical token path, so the client sees the same output it
        would have seen without the death. Sequences out of retry
        budget fail instead. ``charge=False`` (voluntary drain, a
        migration falling back) spends no retry budget — the sequence
        did nothing wrong."""
        for it in items:
            # if the actor restarts (max_restarts) with replayed state,
            # the dead incarnation's pages would otherwise be
            # resurrected and leak; release is idempotent and a no-op
            # on a fresh restart, and actor FIFO orders it before any
            # re-admission to the same replica
            self._release_replica_state(it)
            if charge:
                it.attempts += 1
                if it.attempts > self._dep.max_retries:
                    self._fail(it, cause, verdict=False)
                    continue
            with self._lock:
                self._readmit_step0 += 1
            it.step = 0
            it.replica = None
            it.prefill_state = None
            # re-admission replays the identical token path from step
            # 0; the streaming dedupe counter restarts with it so the
            # callback never sees a token twice
            it.observed = 0
            with self._cv:
                closed = self._closed
                if not closed:
                    self._pending.appendleft(it)
            if closed:
                self._fail(it, self._close_error or cause, verdict=False)

    def _spill_item(self, item: _DecodeItem) -> bool:
        """Move one active sequence's KV pages out of the pool (page
        pressure or chaos eviction); the sequence parks in ``_waiting``
        until pages free up."""
        if not self._can_spill:
            return False
        import tosem_tpu_torch.runtime as rt
        try:
            rt.get(item.replica.spill_seq.remote(item.seq_id),
                   timeout=60.0)
        except self._retryable() as e:
            self._on_replica_death(item.replica, e)
            return False
        with self._lock:
            if item in self._active:
                self._active.remove(item)
                self._waiting.append(item)
                self._spills += 1
        return True

    def _retryable(self):
        from tosem_tpu_torch.serve.core import RETRYABLE
        return RETRYABLE

    def _on_replica_death(self, replica, cause: BaseException) -> None:
        """Every sequence pinned to the dead replica loses its cache;
        the breaker sees one trip per LOGICAL sequence."""
        with self._lock:
            affected = [it for it in self._active + self._waiting
                        if it.replica is replica]
            self._active = [it for it in self._active
                            if it.replica is not replica]
            self._waiting = [it for it in self._waiting
                             if it.replica is not replica]
            # disaggregated tier: admits in flight on a dead prefill
            # replica re-admit too (their refs are dead with the
            # actor), as do handoffs importing into a dead decode
            # replica
            affected += [p for p, _ in self._prefilling
                         if p.replica is replica
                         or p.src_replica is replica]
            affected += [p for p in self._prefilled
                         if p.replica is replica]
            affected += [p for p, _, _ in self._importing
                         if p.replica is replica]
            self._prefilling = [(p, r) for p, r in self._prefilling
                                if p.replica is not replica
                                and p.src_replica is not replica]
            self._prefilled = collections.deque(
                p for p in self._prefilled if p.replica is not replica)
            self._importing = [e for e in self._importing
                               if e[0].replica is not replica]
            self._transport_addrs.pop(id(replica), None)
            self._step_times.pop(id(replica), None)
            self._quarantined.discard(id(replica))
        if not affected:
            return
        breaker = self._dep.breaker
        if breaker is not None:
            probe = False
            for it in affected:
                if it.probe:
                    probe = True
                    it.probe = False
            breaker.record_failure(probe=probe, count=len(affected))
        self._requeue_for_readmission(affected, cause)

    def _fire_decode_chaos(self) -> None:
        act = _chaos.fire("serve.decode_step", target=self._dep.name,
                          step=self._steps)
        if act is None:
            return
        if act["action"] == "evict_pages":
            with self._lock:
                victim = self._active[0] if self._active else None
            if victim is not None:
                self._spill_item(victim)
        elif act["action"] == "slow_step":
            time.sleep(act["delay_s"])
        elif act["action"] == "drain_replica":
            # chaos: drain the replica hosting the OLDEST active
            # sequence with live migration — its sequences must
            # continue from the current step on other replicas
            with self._lock:
                victim = (self._active[0].replica if self._active
                          else None)
            if victim is not None:
                self.drain_replica(victim, migrate=True)
        elif act["action"] == "crash_prefill":
            # chaos: SIGKILL the prefill tier's first replica — admits
            # in flight re-admit, already-migrated sequences on the
            # decode tier must not notice
            prefill, _ = self._split_replicas()
            if prefill:
                from tosem_tpu_torch.chaos.injector import crash_actor_process
                crash_actor_process(prefill[0]._actor_id)

    def _restore_waiting(self) -> None:
        """Bring spilled sequences back before admitting new ones
        (oldest spill first — FIFO fairness). CachePressure leaves a
        sequence parked; the backend resolves a LOST payload internally
        by re-prefilling from token history."""
        import tosem_tpu_torch.runtime as rt
        from tosem_tpu_torch.serve.kv_cache import CachePressure
        with self._lock:
            waiting = list(self._waiting)
            # a pressure spill's pages go to its batchmates' next step
            # first, not straight back to a restore on that replica
            held, self._hold_restores = self._hold_restores, set()
        for it in waiting:
            if it.replica in held:
                continue
            try:
                rt.get(it.replica.restore_seq.remote(it.seq_id),
                       timeout=60.0)
            except TaskError as e:
                if isinstance(e.cause, CachePressure):
                    continue              # stays parked; retried next tick
                with self._lock:
                    if it in self._waiting:
                        self._waiting.remove(it)
                self._release_replica_state(it)
                self._fail(it, e)
                continue
            except self._retryable() as e:
                self._on_replica_death(it.replica, e)
                continue
            with self._lock:
                if it in self._waiting:
                    self._waiting.remove(it)
                    self._active.append(it)
                    self._restores += 1

    # ------------------------------------------------------ live migration

    def _move_item(self, item: _DecodeItem, dst) -> bool:
        """Move one sequence's replica-side state ``item.replica`` →
        ``dst`` (export → import → release the source copy) and
        repoint the item WITHOUT touching its step counter — decode
        continues from the current step on the destination. On ANY
        failure the sequence falls back to step-0 re-admission (the
        recompute path — correct by determinism, just slower), spending
        no retry budget. Callers hold ``_mig_lock``."""
        import tosem_tpu_torch.runtime as rt
        t0 = time.monotonic()
        try:
            state = rt.get(item.replica.export_seq.remote(item.seq_id),
                           timeout=60.0)
            rt.get(dst.import_seq.remote(item.seq_id, state),
                   timeout=60.0)
        except BaseException as e:
            with self._lock:
                if item in self._active:
                    self._active.remove(item)
                if item in self._waiting:
                    self._waiting.remove(item)
                self._migration_fallbacks += 1
            self._metrics["kv_migrations"].inc(
                1, (self._dep.name, "fallback"))
            self._requeue_for_readmission([item], e, charge=False)
            return False
        # the destination owns the state now: free the source copy
        # (fire-and-forget, idempotent) and repoint. A spilled-on-
        # source sequence imported LIVE on the destination leaves the
        # waiting set here.
        self._release_replica_state(item)
        with self._lock:
            item.replica = dst
            if item in self._waiting:
                self._waiting.remove(item)
                self._active.append(item)
            self._migrations += 1
        self._metrics["kv_migrations"].inc(1, (self._dep.name, "ok"))
        self._metrics["kv_migration_ms"].observe(
            (time.monotonic() - t0) * 1e3, (self._dep.name,))
        return True

    def drain_replica(self, replica, migrate: bool = True
                      ) -> Dict[str, int]:
        """Evacuate every sequence pinned to ``replica`` (node drain /
        scale-down). ``migrate=True`` moves each sequence's KV pages +
        step ledger to another replica and CONTINUES from the current
        step (zero recomputed tokens); ``migrate=False`` is the older
        behavior — step-0 re-admission — kept as the measured baseline
        arm. Neither path trips the breaker or spends retry budget:
        a drained sequence did nothing wrong."""
        with self._mig_lock:
            with self._lock:
                items = [it for it in self._active + self._waiting
                         if it.replica is replica]
            out = {"migrated": 0, "readmitted": 0}
            for item in items:
                dst = (self._pick_replica(item.slots, exclude=replica)
                       if migrate and self._can_migrate else None)
                if dst is None:
                    with self._lock:
                        if item in self._active:
                            self._active.remove(item)
                        if item in self._waiting:
                            self._waiting.remove(item)
                    self._requeue_for_readmission(
                        [item], RuntimeError(
                            f"replica drained ({self._dep.name})"),
                        charge=False)
                    out["readmitted"] += 1
                elif self._move_item(item, dst):
                    out["migrated"] += 1
                else:
                    out["readmitted"] += 1
            out["sessions"] = self._move_sessions(replica)
            return out

    def _move_sessions(self, replica) -> int:
        """Relocate the draining replica's resident session stashes so
        multi-turn warmth survives the drain. Best-effort (sessions are
        a perf hint, correctness is cold re-prefill): any failure just
        leaves the next turn cold."""
        import tosem_tpu_torch.runtime as rt
        if not (self.policy.session
                and hasattr(self._dep.backend_cls, "export_sessions")):
            return 0
        try:
            dst = self._pick_replica(1, exclude=replica)
        except BaseException:
            dst = None
        if dst is None:
            return 0
        try:
            sessions = rt.get(replica.export_sessions.remote(),
                              timeout=60.0)
        except BaseException:
            return 0
        moved = 0
        for key, state in sessions.items():
            try:
                rt.get(dst.import_session.remote(key, state),
                       timeout=60.0)
                moved += 1
            except BaseException:
                continue
        return moved

    # ------------------------------------------ disaggregated prefill

    def _transport_addr(self, replica) -> Optional[str]:
        """Cached tensor-receiver address of a decode replica (fetched
        once per replica; None disables the direct stream for this
        launch — the export fallback still works)."""
        import tosem_tpu_torch.runtime as rt
        key = id(replica)
        if key in self._transport_addrs:
            return self._transport_addrs[key]
        try:
            addr = rt.get(replica.transport_address.remote(),
                          timeout=30.0)
        except BaseException:
            return None
        self._transport_addrs[key] = addr
        return addr

    def _launch_prefills(self) -> None:
        """Disaggregated admission: fire ``admit`` on the prefill tier
        WITHOUT waiting — the decode tier keeps stepping while prompts
        prefill in other processes. The DESTINATION decode replica is
        chosen at launch so the prefill replica can stream the pages
        straight to its tensor receiver (worker→worker, no driver
        hop); the driver later fires only ``adopt_seq``. In-flight
        prefills are bounded by ``max_active`` so a prompt flood
        cannot run the prefill pool out of pages."""
        prefill, _ = self._split_replicas()
        if not prefill:
            return
        while True:
            with self._cv:
                if self._closed or not self._pending:
                    return
                inflight = (sum(p.slots for p, _ in self._prefilling)
                            + sum(p.slots for p in self._prefilled))
                item = self._pending[0]
                if item.slots > self.policy.max_active:
                    pass              # oversized: the sync path fails it
                elif inflight + item.slots > self.policy.max_active:
                    return
                self._pending.popleft()
            if item.slots > self.policy.max_active:
                self._fail(item, ValueError(
                    f"n={item.slots} branches exceed max_active="
                    f"{self.policy.max_active}"))
                continue
            counts = self.replica_loads()
            best = min(range(len(prefill)),
                       key=lambda j: (counts.get(id(prefill[j]), 0), j))
            src = prefill[best]
            try:
                dst = (self._pick_replica(item.slots)
                       if self._can_stream else None)
            except BaseException as e:
                # decode tier momentarily empty (ActorDiedError): the
                # item is already off _pending, so it must fail here —
                # escaping would strand it outside every queue with a
                # future nobody resolves
                self._fail(item, e, verdict=False)
                continue
            addr = self._transport_addr(dst) if dst is not None else None
            item.src_replica = src
            # `replica` names where the decode state will LIVE: the
            # stream destination when known at launch, else the
            # prefill replica until the export handoff resolves one
            item.replica = dst if addr is not None else src
            try:
                if addr is not None:
                    ref = src.admit.remote(item.seq_id, item.request,
                                           False, addr)
                else:
                    # no streaming surface / no decode capacity yet:
                    # the admit outcome carries the exported state
                    ref = src.admit.remote(item.seq_id, item.request,
                                           True)
            except BaseException as e:
                self._fail(item, e, verdict=False)
                continue
            with self._lock:
                self._prefilling.append((item, ref))

    def _collect_prefills(self) -> None:
        """Harvest finished async admits: done-at-admit sequences
        retire straight off the prefill replica; the rest migrate
        (pages + ledger) onto the decode tier — or park in
        ``_prefilled`` until a decode slot frees."""
        import tosem_tpu_torch.runtime as rt
        from tosem_tpu_torch.serve.kv_cache import CachePressure
        with self._lock:
            pending = list(self._prefilling)
        if not pending:
            # sequences parked by a pressured import retry even when no
            # prefill is left to finish (the JAX package's copy returns
            # here and leaves them parked for good: ROADMAP.md C-ref8)
            self._activate_prefilled()
            return
        refs = [ref for _, ref in pending]
        done, _ = rt.wait(refs, num_returns=len(refs), timeout=0.0)
        done_set = set(done)
        for item, ref in pending:
            if ref not in done_set:
                continue
            with self._lock:
                if (item, ref) not in self._prefilling:
                    continue          # a death handler swept it
                self._prefilling.remove((item, ref))
            try:
                first = rt.get(ref, timeout=30.0)
            except TaskError as e:
                if isinstance(e.cause, CachePressure):
                    # prefill pool momentarily full: back to the queue
                    with self._cv:
                        if not self._closed:
                            self._pending.appendleft(item)
                            item.replica = None
                            continue
                    self._fail(item, self._close_error or e)
                else:
                    self._fail(item, e)   # poison prompt: fails alone
                continue
            except self._retryable() as e:
                # the ADMIT died with the prefill replica; the item
                # left _prefilling above, so the death sweep can't see
                # it — requeue it alongside its batchmates
                self._on_replica_death(item.src_replica or item.replica,
                                       e)
                self._requeue_for_readmission([item], e)
                continue
            except BaseException as e:
                self._release_replica_state(item)
                self._fail(item, e, verdict=False)
                continue
            self._tokens += int(first.get("n_tokens", 1))
            # the admit's token streams now, as on the colocated path
            # (the JAX package's copy never streams it: ROADMAP.md C-ref7)
            self._fire_on_token(item, first)
            if first.get("done"):
                # done at admit (short budget / eos): the state never
                # left the PREFILL replica — retire must release it
                # there, not on the planned stream destination, or the
                # prefill pool leaks a sequence per completion
                item.replica = item.src_replica or item.replica
                item.src_replica = None
                with self._lock:
                    self._active.append(item)
                self._retire(item, result=first.get("result"))
                continue
            item.src_replica = None
            if first.get("sent"):
                # pages already streamed worker→worker to item.replica
                # (the send COMMITTED before the admit outcome): fire
                # the idempotent adopt WITHOUT waiting and activate
                # now — actor FIFO orders the adopt before any step
                # this scheduler dispatches afterwards, so the slot
                # never idles a round trip. A pressured adopt parks
                # the payload and the step's "pending" outcome retries.
                try:
                    item.replica.adopt_seq.remote(item.seq_id, 10.0)
                except BaseException as e:
                    self._fail_prefilled(item, e)
                    continue
                with self._lock:
                    self._active.append(item)
                    self._migrations += 1
                self._metrics["kv_migrations"].inc(
                    1, (self._dep.name, "ok"))
                continue
            item.prefill_state = first.get("state")
            item.replica = None
            with self._lock:
                self._prefilled.append(item)
        self._activate_prefilled()

    def _activate_prefilled(self) -> None:
        """Hand prefilled sequences to the decode tier as slots free:
        FIRE the import of the state the admit outcome carried (the
        live-KV-migration import half; same counters, same wire format
        as node drain) without waiting — :meth:`_collect_imports`
        harvests completions, so the handoff never blocks the step
        loop. A sequence whose state never arrived (older backend)
        falls back to the synchronous export path."""
        with self._mig_lock:
            deferred: List[_DecodeItem] = []
            while True:
                with self._lock:
                    if not self._prefilled:
                        break
                    item = self._prefilled.popleft()
                if item.prefill_state is None \
                        and item.replica is not None:
                    # pressured adopt: the stream is parked on the
                    # destination's receiver — re-fire the adopt there
                    # (pages free when something retires)
                    try:
                        ref = item.replica.adopt_seq.remote(item.seq_id)
                    except BaseException as e:
                        self._fail_prefilled(item, e)
                        continue
                    with self._lock:
                        self._importing.append((item, ref,
                                                time.monotonic()))
                    continue
                if item.prefill_state is None:
                    self._fail_prefilled(item, RuntimeError(
                        "prefilled sequence lost its exported state"))
                    continue
                try:
                    dst = self._pick_replica(item.slots)
                except Exception:
                    deferred.append(item)
                    break             # no replicas: close() will sweep
                if dst is None:
                    deferred.append(item)
                    break             # decode tier full: retry next tick
                # binding the item to dst BEFORE the import lands keeps
                # the slot accounting honest (replica_loads counts
                # _importing), so concurrent activations can't
                # oversubscribe the destination
                item.replica = dst
                try:
                    ref = dst.import_seq.remote(item.seq_id,
                                                item.prefill_state)
                except BaseException as e:
                    self._fail_prefilled(item, e)
                    continue
                with self._lock:
                    self._importing.append((item, ref,
                                            time.monotonic()))
            if deferred:
                with self._lock:
                    self._prefilled.extendleft(reversed(deferred))

    def _collect_imports(self) -> None:
        """Harvest finished decode-tier imports: the sequence joins the
        active set and steps from its exported position. Page pressure
        sends it back to the prefilled queue (retried when something
        retires); anything else falls back to step-0 re-admission."""
        import tosem_tpu_torch.runtime as rt
        from tosem_tpu_torch.serve.kv_cache import CachePressure
        with self._lock:
            pending = list(self._importing)
        if not pending:
            return
        refs = [ref for _, ref, _ in pending]
        done, _ = rt.wait(refs, num_returns=len(refs), timeout=0.0)
        done_set = set(done)
        for entry in pending:
            item, ref, t0 = entry
            if ref not in done_set:
                continue
            with self._lock:
                if entry not in self._importing:
                    continue          # a death handler swept it
                self._importing.remove(entry)
            try:
                rt.get(ref, timeout=30.0)
            except TaskError as e:
                if isinstance(e.cause, CachePressure):
                    # pool full on the destination. An exported state
                    # retries the import anywhere; a streamed payload
                    # stays parked on ITS destination's receiver
                    # (adopt_seq put it back), so keep the binding
                    if item.prefill_state is not None:
                        item.replica = None
                    with self._lock:
                        self._prefilled.append(item)
                    continue
                self._fail_prefilled(item, e)
                continue
            except self._retryable() as e:
                self._on_replica_death(item.replica, e)
                self._fail_prefilled(item, e)
                continue
            except BaseException as e:
                self._fail_prefilled(item, e)
                continue
            item.prefill_state = None
            with self._lock:
                self._active.append(item)
                self._migrations += 1
            self._metrics["kv_migrations"].inc(
                1, (self._dep.name, "ok"))
            self._metrics["kv_migration_ms"].observe(
                (time.monotonic() - t0) * 1e3, (self._dep.name,))

    def _fail_prefilled(self, item: _DecodeItem,
                        cause: BaseException) -> None:
        """A prefilled sequence whose decode-tier import failed
        re-admits from step 0 (its prefill-replica copy was released
        at export, so recompute is the only fallback)."""
        item.prefill_state = None
        item.replica = None
        with self._lock:
            self._migration_fallbacks += 1
        self._metrics["kv_migrations"].inc(
            1, (self._dep.name, "fallback"))
        self._requeue_for_readmission([item], cause, charge=False)

    def _admit_pending(self) -> None:
        """Fill free batch slots from the queue — the iteration-level
        half of continuous batching: admission happens every step, not
        when a batch drains."""
        import tosem_tpu_torch.runtime as rt
        from tosem_tpu_torch.serve.kv_cache import CachePressure
        while True:
            with self._cv:
                if self._closed or not self._pending:
                    return
                item = self._pending[0]
            if item.slots > self.policy.max_active:
                # an N > max_active group can NEVER fit a step program:
                # fail it alone instead of wedging the queue head
                with self._cv:
                    if self._pending and self._pending[0] is item:
                        self._pending.popleft()
                self._fail(item, ValueError(
                    f"n={item.slots} branches exceed max_active="
                    f"{self.policy.max_active}"))
                continue
            try:
                replica = self._pick_replica(item.slots)
            except Exception:
                return                    # no replicas: close() will sweep
            if replica is None:
                return                    # all slots busy
            with self._cv:
                if self._closed or not self._pending \
                        or self._pending[0] is not item:
                    continue
                self._pending.popleft()
            item.replica = replica
            try:
                first = rt.get(
                    replica.admit.remote(item.seq_id, item.request),
                    timeout=120.0)
            except TaskError as e:
                if isinstance(e.cause, CachePressure):
                    # pool full. With sequences still draining, requeue
                    # and wait for their pages; with NOTHING active the
                    # pool can never fit this prompt — fail it.
                    with self._cv:
                        busy = bool(self._active or self._waiting)
                        closed = self._closed
                        if busy and not closed:
                            self._pending.appendleft(item)
                    if busy and not closed:
                        return
                    self._fail(item, self._close_error or e)
                    continue
                # poison prompt (bad ids, overlong): fails alone
                self._fail(item, e)
                continue
            except self._retryable() as e:
                self._on_replica_death(replica, e)
                self._requeue_for_readmission([item], e)
                continue
            except BaseException as e:
                # no clear verdict (e.g. the wait timed out): the admit
                # may still have landed replica-side — release it
                self._release_replica_state(item)
                self._fail(item, e, verdict=False)
                continue
            with self._lock:
                self._active.append(item)
            self._tokens += int(first.get("n_tokens", 1))
            self._fire_on_token(item, first)
            if first.get("done"):
                self._retire(item, result=first.get("result"))

    @staticmethod
    def _fire_on_token(item: _DecodeItem, out: Dict[str, Any]) -> None:
        """Push an outcome's committed tokens to the item's streaming
        callback. A step-0 re-admission (replica death) replays the
        identical greedy path, so the monotonic ``streamed`` watermark
        dedupes: only tokens past it are delivered. Callback errors
        never touch the scheduler loop — the consumer (e.g. a dropped
        HTTP connection) fails alone."""
        if "token" not in out:
            return
        toks = out.get("tokens") or [out["token"]]
        before = item.observed
        item.observed += len(toks)
        if item.on_token is None:
            return
        fresh = list(toks[max(item.streamed - before, 0):])
        item.streamed = max(item.streamed, item.observed)
        if not fresh and not out.get("done"):
            return
        try:
            item.on_token(fresh, bool(out.get("done")))
        except BaseException:
            item.on_token = None

    def _retire(self, item: _DecodeItem,
                result: Optional[Any] = None) -> None:
        """``result`` is the final payload when the backend shipped it
        inline with the done outcome (the fast path — no extra round
        trip per retired sequence); otherwise it is fetched here."""
        import tosem_tpu_torch.runtime as rt
        try:
            if result is None:
                # mapped handoff: a large final payload (logits/tokens)
                # comes back as readonly views over the store, pinned
                # until the caller drops it
                result = rt.get(item.replica.result.remote(item.seq_id),
                                timeout=60.0, copy=False)
            # release is fire-and-forget: nothing waits on page frees,
            # the next step's extend sees them (actor FIFO ordering)
            item.replica.release.remote(item.seq_id)
        except self._retryable() as e:
            self._on_replica_death(item.replica, e)
            return
        with self._lock:
            if item in self._active:
                self._active.remove(item)
        self._succeed(item, result)

    def _step_replicas(self) -> None:
        """One decode iteration: one ``step_batch`` per replica holding
        active sequences. Holds ``_mig_lock`` end to end so a drain
        can never export a sequence between this iteration's dispatch
        and its commit."""
        with self._mig_lock:
            self._step_replicas_locked()

    def _step_replicas_locked(self) -> None:
        import tosem_tpu_torch.runtime as rt
        with self._lock:
            groups: Dict[int, List[_DecodeItem]] = {}
            handles: Dict[int, Any] = {}
            for it in self._active:
                groups.setdefault(id(it.replica), []).append(it)
                handles[id(it.replica)] = it.replica
        order = sorted(groups, key=lambda k: self._replica_index(
            handles[k]))
        # dispatch EVERY replica's step before reaping any: the per-
        # replica step programs run concurrently in their actor
        # processes (serial dispatch-then-wait made N replicas step at
        # single-replica throughput — the cluster-decode bench's
        # original bottleneck)
        refs: Dict[int, Any] = {}
        for key in order:
            items = groups[key]
            replica = handles[key]
            self._dep._fire_chaos(replica, self._replica_index(replica))
            self._metrics["decode_occupancy"].observe(
                len(items), (self._dep.name,))
            try:
                refs[key] = replica.step_batch.remote(
                    [it.seq_id for it in items],
                    [it.step for it in items])
            except BaseException as e:
                self._on_replica_death(replica, e)
        elapsed = self._time_steps(refs)
        for key in order:
            if key not in refs:
                continue
            items = groups[key]
            replica = handles[key]
            try:
                outcomes = rt.get(refs[key], timeout=120.0)
            except self._retryable() as e:
                self._on_replica_death(replica, e)
                continue
            except TaskError as e:
                # whole-step application error (scheduler/backend bug):
                # every packed sequence sees it — isolation held at
                # admit-time validation, a step failure is systemic
                with self._lock:
                    for it in items:
                        if it in self._active:
                            self._active.remove(it)
                for it in items:
                    self._release_replica_state(it)
                    self._fail(it, e)
                continue
            pressured: Optional[_DecodeItem] = None
            for it, out in zip(items, outcomes):
                # a mid-loop _retire can hit a dead replica and requeue
                # this whole group at step 0 (_on_replica_death); items
                # no longer active must not have their step advanced —
                # a stale step would hit the backend's 'skips ahead'
                # guard after re-admission and fail the batch
                with self._lock:
                    if it not in self._active:
                        continue
                if out.get("pending"):
                    # streamed handoff not adopted yet (parked under
                    # pressure, or the fire-and-forget adopt was
                    # lost): re-fire the idempotent adopt and retry
                    # this step next iteration; a sequence that stays
                    # pending past the stall limit is unrecoverable
                    it.stalls += 1
                    if it.stalls > self.PRESSURE_STALL_LIMIT:
                        with self._lock:
                            if it in self._active:
                                self._active.remove(it)
                        self._release_replica_state(it)
                        self._fail_prefilled(it, RuntimeError(
                            f"sequence {it.seq_id} never adopted on "
                            "its decode replica"))
                        continue
                    try:
                        it.replica.adopt_seq.remote(it.seq_id, 0.5)
                    except BaseException:
                        pass
                    continue
                if out.get("pressure"):
                    if pressured is None:
                        pressured = it
                    continue
                it.step += 1
                it.stalls = 0
                # a speculative step commits up to spec_k tokens, a
                # group step one per live branch
                self._tokens += int(out.get("n_tokens", 1))
                self._fire_on_token(it, out)
                if out.get("done"):
                    self._retire(it, result=out.get("result"))
            if pressured is not None:
                # Page pressure is usually TRANSIENT: batchmates retire
                # (their release is in flight on the actor's queue) or
                # spilled peers rotate back in. So: spill the pressured
                # sequence when that frees pages someone can use (other
                # actives, or a waiting set to rotate through), retry
                # quietly otherwise, and only a sequence that stays
                # pressured across PRESSURE_STALL_LIMIT iterations
                # without emitting a token — the pool genuinely cannot
                # hold it plus anyone — fails. A spill that hands its
                # pages to other actives on the replica is progress, not
                # a stall, and that replica's restores wait one iteration
                # so that those actives, not the restore, take the freed
                # pages (the JAX package's copy restores first and counts
                # every spill, failing sequences a tight pool could
                # serve: ROADMAP.md C-ref9). A spill that did not happen
                # (no spill_seq, a failed call) counts as the reference's.
                with self._lock:
                    others = len([i for i in self._active
                                  if i.replica is replica]) > 1
                    rotating = bool(self._waiting)
                stalled = (pressured.stalls + 1
                           > self.PRESSURE_STALL_LIMIT)
                spilled = (not stalled and (others or rotating)
                           and self._spill_item(pressured))
                if spilled and others:
                    with self._lock:
                        self._hold_restores.add(replica)
                else:
                    pressured.stalls += 1
                if stalled:
                    from tosem_tpu_torch.serve.kv_cache import CachePressure
                    with self._lock:
                        if pressured in self._active:
                            self._active.remove(pressured)
                    self._release_replica_state(pressured)
                    self._fail(pressured, CachePressure(
                        f"sequence {pressured.seq_id} cannot grow: KV "
                        f"pool still exhausted after "
                        f"{self.PRESSURE_STALL_LIMIT} eviction attempts"))
        self._check_stragglers(elapsed, handles)
        with self._lock:
            self._steps += 1

    def _time_steps(self, refs: Dict[int, Any]) -> Dict[int, float]:
        """Per-replica wall time of THIS iteration's concurrent step
        dispatches, measured as each ref completes (an in-order reap
        would charge a slow replica's wait to every replica reaped
        after it). Only runs with the watchdog armed and a fleet to
        compare — otherwise zero overhead and zero behavior change."""
        if self.policy.straggler_factor <= 0 or len(refs) < 2:
            return {}
        import tosem_tpu_torch.runtime as rt
        t0 = time.monotonic()
        by_ref = {ref: key for key, ref in refs.items()}
        waiting = list(refs.values())
        deadline = t0 + 120.0
        elapsed: Dict[int, float] = {}
        while waiting:
            budget = deadline - time.monotonic()
            if budget <= 0:
                break             # hung replica: the reap loop's case
            try:
                done, waiting = rt.wait(waiting, num_returns=1,
                                        timeout=budget)
            except BaseException:
                break
            if not done:
                break
            now = time.monotonic()
            for ref in done:
                elapsed[by_ref[ref]] = now - t0
        return elapsed

    def _check_stragglers(self, elapsed: Dict[int, float],
                          handles: Dict[int, Any]) -> None:
        """Slow-replica watchdog: a replica whose recent MEDIAN step
        time exceeds ``straggler_factor`` × the fleet median is drained
        through the live-migration path (sequences continue from their
        current step elsewhere — the node-drain machinery, fired by
        detection instead of an operator) and quarantined from new
        admissions. Robust by construction: medians on both axes, an
        absolute floor, and a minimum sample count — one GC pause must
        not drain a healthy replica."""
        if not elapsed:
            return
        import statistics
        with self._lock:
            for key, dt in elapsed.items():
                self._step_times.setdefault(
                    key, collections.deque(maxlen=32)).append(dt)
            meds = {key: statistics.median(self._step_times[key])
                    for key in elapsed
                    if len(self._step_times[key])
                    >= self.policy.straggler_min_samples
                    and key not in self._quarantined}
        if len(meds) < 2:
            return                # no fleet to compare against
        fleet = statistics.median(meds.values())
        worst = max(meds, key=lambda k: meds[k])
        threshold = max(self.policy.straggler_factor * fleet,
                        self.policy.straggler_min_s)
        if meds[worst] <= threshold:
            return
        victim = handles.get(worst)
        if victim is None:
            return
        with self._lock:
            self._step_times.pop(worst, None)
            self._quarantined.add(worst)
            self._straggler_drains += 1
        self.drain_replica(victim, migrate=True)

    # KV-page gauges need a replica round trip (cache_stats lives actor-
    # side); scraping every decode step would cost as much as the step
    # itself, so the remote half refreshes at most this often.
    SCRAPE_INTERVAL_S = 0.25

    # consecutive token-less pressured iterations before a sequence is
    # declared unplaceable (pool can't hold it plus anyone else). Each
    # iteration spans an actor round trip, so in-flight page releases
    # have long since landed by the time this trips.
    PRESSURE_STALL_LIMIT = 6

    def _refresh_gauges(self, block: bool = True) -> None:
        # the WHOLE refresh runs on a time budget, not per step: the
        # local half used to re-walk the metric registry every
        # iteration (lock + label-set hash per gauge), which at
        # millisecond step times is measurable scheduler overhead for
        # telemetry nobody scrapes faster than the remote half anyway.
        # ``block=False`` is the scheduler loop's mode: the remote
        # scrape is fired and harvested an interval later, so
        # telemetry never steals a step's wall time; direct callers
        # (tests, ad-hoc pokes) keep synchronous semantics.
        now = time.monotonic()
        if now - self._last_scrape < self.SCRAPE_INTERVAL_S:
            return
        self._last_scrape = now
        name = self._dep.name
        with self._lock:
            self._metrics["decode_active"].set(len(self._active), (name,))
            self._metrics["queue_depth"].set(len(self._pending), (name,))
        import tosem_tpu_torch.runtime as rt
        replicas = self._replicas()
        if not replicas or not hasattr(self._dep.backend_cls,
                                       "cache_stats"):
            return
        try:
            # async mode: harvest the PREVIOUS interval's request and
            # fire the next — the stats round trip queues behind a step
            # on a busy actor, and waiting on it here would steal a
            # step's worth of wall time from the scheduler per interval
            prev = getattr(self, "_scrape_ref", None)
            stats = None
            if prev is not None:
                if not block:
                    # scheduler mode: POLL — on a busy actor the stats
                    # ref queues behind a step, and rt.get's timeout
                    # would stall the loop for the full 0.5 s every
                    # interval; leave the ref outstanding and retry
                    # next interval instead
                    done, _ = rt.wait([prev], num_returns=1,
                                      timeout=0.0)
                    if not done:
                        return
                    stats = rt.get(prev, timeout=0.5)
                # block mode: DISCARD the in-flight ref — synchronous
                # callers (tests, ad-hoc scrapes) want the counters as
                # of NOW, and the outstanding request is an interval
                # old (fired mid-decode, pre-retirement)
            if block:
                stats = rt.get(replicas[0].cache_stats.remote(),
                               timeout=5.0)
                self._scrape_ref = None
            else:
                self._scrape_ref = replicas[0].cache_stats.remote()
        except BaseException:
            self._scrape_ref = None
            return
        if stats is None:
            return
        with self._lock:
            self._cache_stats = dict(stats)
        for state in ("used", "free", "spilled"):
            v = stats.get(f"pages_{state}")
            if v is not None:
                self._metrics["kv_pages"].set(v, (name, state))
        shared = stats.get("pages_shared")
        if shared is not None:
            self._metrics["kv_pages_shared"].set(shared, (name,))
        evicted = stats.get("pages_evicted_total")
        if evicted is not None:
            self._metrics["kv_evicted"].set(evicted, (name,))
        proposed = stats.get("spec_proposed") or 0
        if proposed:
            self._metrics["spec_acceptance"].set(
                stats.get("spec_accepted", 0) / proposed, (name,))
        hits = stats.get("prefix_hits") or 0
        misses = stats.get("prefix_misses") or 0
        if hits or misses:
            self._metrics["prefix_hit_rate"].set(
                hits / (hits + misses), (name,))
        for path, key in (("reused", "prefix_pages_reused"),
                          ("prefilled", "prefix_pages_prefilled")):
            v = stats.get(key)
            if v is not None:
                self._metrics["prefix_pages"].set(v, (name, path))
        prefill = stats.get("prefill_tokens") or 0
        reused = stats.get("reused_tokens") or 0
        if prefill or reused:
            self._metrics["prefix_suffix_fraction"].set(
                prefill / (prefill + reused), (name,))
        remote = stats.get("prefix_remote_imports")
        if remote is not None:
            self._metrics["prefix_remote_hits"].set(remote, (name,))

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not (self._pending or self._active
                           or self._waiting or self._prefilling
                           or self._prefilled or self._importing) \
                        and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                had_active = bool(self._active)
            try:
                self._fire_decode_chaos()
                self._restore_waiting()
                if self.policy.prefill_replicas:
                    # disaggregated: fire-and-forget admits on the
                    # prefill tier, harvest finished ones, hand them
                    # to the decode tier (also async), and keep
                    # stepping — the loop only ever BLOCKS on steps
                    self._launch_prefills()
                    self._collect_prefills()
                    self._collect_imports()
                    if not self._split_replicas()[0]:
                        # a 1-replica fleet has no prefill tier
                        # (_split_replicas always keeps a decode
                        # replica): admit colocated rather than
                        # stalling _pending forever
                        self._admit_pending()
                else:
                    self._admit_pending()
                with self._lock:
                    stepping = bool(self._active)
                    prefilling = bool(self._prefilling
                                      or self._prefilled
                                      or self._importing)
                if stepping:
                    self._step_replicas()
                self._refresh_gauges(block=False)
            except BaseException:
                # anything the per-call handlers didn't classify (e.g.
                # a builtin TimeoutError from rt.get on a slow host):
                # the scheduler thread must NEVER die — every pending
                # future would hang forever. State is safe to retry:
                # items keep their step, and the backends' (seq, step)
                # ledger makes re-sending a step idempotent.
                with self._lock:
                    self._loop_errors += 1
                time.sleep(max(self.policy.idle_wait_s, 0.05))
                continue
            if not had_active and not stepping:
                if prefilling:
                    # nothing to step YET but admits are in flight on
                    # the prefill tier: poll briskly so the first
                    # prefilled sequence starts decoding promptly
                    time.sleep(min(self.policy.idle_wait_s, 0.002))
                else:
                    # admission blocked (page pressure, no replicas):
                    # don't spin — pages free when something retires
                    time.sleep(self.policy.idle_wait_s)
