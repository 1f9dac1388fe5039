"""Device timing of one op, for the benchmark rows.

Counterpart of ``tosem_tpu/utils/timing.py`` (``BenchStats``,
``time_fn``, ``DeviceLoopBench``, ``chain_overhead``,
``MeasurementBelowNoiseFloor``, ``gflops``, ``matmul_flops``,
``conv2d_flops``). The JAX
package runs N applications of an op inside one compiled loop so that
host dispatch drops out. On the card the same end is reached with a CUDA
graph: :class:`DeviceLoopBench` captures N calls of the op (every kernel
they launch, forward and backward), replays the graph between two CUDA
events, and reports the device time per call. A Python call through an
autograd Function and ``ctypes`` costs tens of microseconds on the host,
more than a small kernel takes, so events around calls launched one by
one would time the host's launch rate, not the kernels.

The N calls rotate over enough copies of the operands to span twice the
H100's 50 MB L2, so each call reads its inputs from device memory as a
caller with fresh data would, not from a warm L2 (a bound in bytes over
3.35 TB/s holds only then).

A capture that fails raises: there is no quiet switch to host timing.
On CPU tensors the op runs N times under ``time.perf_counter``.

:func:`time_fn` is the other harness, the JAX package's differential
batch method: N calls launched one after another from Python, one sync,
``(t_N - t_1) / (N - 1)``. It shares no mechanism with graph replay, so
the two cross-check each other (the CLI's ``timing_check``); where a
call's host launch costs more than its kernel, it times the host's
launch rate, and says so by disagreeing.
"""
from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable

L2_BYTES = 50 * 2 ** 20    # H100 SXM L2
MAX_CALLS = 4096           # calls in one timing, at most
# one timing of n calls lasts about this long when n is picked here: long
# against CUDA-event resolution (~0.5 us) and a graph launch (~10 us),
# and against the host clock's noise
SIGNAL_S = {"cuda": 0.02, "cpu": 0.05}


class MeasurementBelowNoiseFloor(RuntimeError):
    """The timed op cannot be resolved against timer noise."""


@dataclass
class BenchStats:
    name: str
    iters: int
    mean_s: float
    std_s: float
    min_s: float
    p50_s: float

    @property
    def mean_ms(self) -> float:
        return self.mean_s * 1e3

    def throughput(self, work_per_iter: float) -> float:
        """Work units a second from the least time (the estimator noise
        only ever inflates)."""
        return work_per_iter / self.min_s if self.min_s > 0 else float("inf")


def _sync(x: Any) -> None:
    """Wait for the device work behind ``x`` (a tensor or a tuple, list
    or dict of them). CPU tensors are computed when a call returns."""
    import torch
    leaves = x.values() if isinstance(x, dict) else \
        (x if isinstance(x, (tuple, list)) else [x])
    if any(isinstance(v, torch.Tensor) and v.device.type == "cuda"
           for v in leaves):
        torch.cuda.synchronize()


def _timed_batch(fn: Callable[[], Any], n: int) -> float:
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn()
    _sync(out)
    return time.perf_counter() - t0


def time_fn(fn: Callable[[], Any], *, iters: int = 20, warmup: int = 3,
            name: str = "bench", inner: int = 0,
            target_sample_s: float = 50e-3) -> BenchStats:
    """Time ``fn`` (returning tensors) by differential batches: a sample
    launches ``inner`` calls back to back and syncs once, and the
    per-call time is ``(t_inner - min t_1) / (inner - 1)``, which cancels
    the per-sample sync. ``inner=0`` picks it so each sample lasts about
    ``target_sample_s``. On the card the calls are queued as fast as
    Python launches them, so a call whose kernel is shorter than its
    launch is timed at the launch rate."""
    for _ in range(max(1, warmup)):
        _sync(fn())
    t1_min = min(_timed_batch(fn, 1) for _ in range(3))
    t10_min = min(_timed_batch(fn, 10) for _ in range(2))
    k_est = max((t10_min - t1_min) / 9.0, 1e-8)
    if inner <= 0:
        inner = max(2, min(4000, int(round(target_sample_s / k_est))))
    inner = max(2, inner)
    samples = []
    for _ in range(iters):
        t = _timed_batch(fn, inner)
        samples.append(max(t - t1_min, 1e-9) / (inner - 1))
    return BenchStats(
        name=name, iters=iters, mean_s=statistics.fmean(samples),
        std_s=statistics.pstdev(samples) if len(samples) > 1 else 0.0,
        min_s=min(samples), p50_s=statistics.median(samples))


def _tensors(args):
    import torch
    return [a for a in args if isinstance(a, torch.Tensor)]


def _copy(args):
    """A fresh copy of every tensor argument (a leaf that requires grad
    stays one); other arguments pass as they are."""
    import torch
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            a = a.detach().clone().requires_grad_(a.requires_grad)
        out.append(a)
    return tuple(out)


@dataclass
class DeviceLoopBench:
    """Seconds of device time per call of ``op(*args)``.

    ``perturb`` is accepted for the JAX package's signature and unused:
    that harness feeds each output back into one operand so XLA cannot
    hoist the op out of its loop; a captured graph replays every launch
    it recorded, so nothing needs the feedback."""
    op: Callable[..., Any]
    args: tuple
    perturb: int = 0

    def time(self, *, n_iter: int = 0, reps: int = 3) -> float:
        """Seconds per call (the least over ``reps`` timings of N calls).
        ``n_iter=0`` picks N so that one timing lasts about
        :data:`SIGNAL_S`, up to :data:`MAX_CALLS`."""
        ts = _tensors(self.args)
        if ts and ts[0].device.type == "cuda":
            return self._time_cuda(n_iter, reps)
        return self._time_host(n_iter, reps)

    def _time_host(self, n_iter, reps):
        self.op(*self.args)

        def run(n):
            t0 = time.perf_counter()
            for _ in range(n):
                self.op(*self.args)
            return time.perf_counter() - t0

        n = n_iter
        if n <= 0:
            n = 1
            while n < MAX_CALLS and run(n) < SIGNAL_S["cpu"]:
                n *= 4
            n = min(n, MAX_CALLS)
        best = min(run(n) for _ in range(max(1, reps)))
        if best <= 0:
            raise MeasurementBelowNoiseFloor(
                f"{n} calls took no measurable host time")
        return best / n

    def _time_cuda(self, n_iter, reps):
        import torch
        nbytes = sum(t.numel() * t.element_size()
                     for t in _tensors(self.args))
        n_copies = max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))
        copies = [self.args] + [_copy(self.args)
                                for _ in range(n_copies - 1)]
        # warm-up on a side stream, as graph capture asks: kernel builds,
        # library handles and autograd set-up happen outside the capture
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for args in copies[:2]:
                self.op(*args)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()

        def capture(n):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for i in range(n):
                    self.op(*copies[i % n_copies])
            graph.replay()          # the first replay uploads the graph
            return graph

        def replay_s(graph):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3

        n = n_iter if n_iter > 0 else 8
        graph = capture(n)
        if n_iter <= 0:
            t = replay_s(graph)
            want = min(MAX_CALLS, max(n, math.ceil(
                n * SIGNAL_S["cuda"] / max(t, 1e-7))))
            if want > n:
                del graph
                n = want
                graph = capture(n)
        best = min(replay_s(graph) for _ in range(max(1, reps)))
        del graph, copies
        torch.cuda.synchronize()
        if best <= 0:
            raise MeasurementBelowNoiseFloor(
                f"a graph of {n} calls took no measurable device time")
        return best / n


def _one_element(*xs, which=0):
    return xs[which].reshape(-1)[:1].clone()


def chain_overhead(args: tuple, perturb: int = 0, *,
                   reps: int = 3) -> float:
    """Seconds a call of the timing's floor: :class:`DeviceLoopBench` of
    a one-element copy of ``args[perturb]`` over the same operand
    copies. On the card that is a graph node's launch gap and minimal
    kernel (a microsecond or two), which every replayed call pays
    however small its kernel; on the host, a Python call. The JAX
    package's bracket is its loop's bookkeeping (an identity op); a
    captured graph has none, and an op that launches nothing times 0.
    So a row's ``[t - overhead, t]`` bounds the op's own device time
    once the per-node floor is taken off. 0.0 when the floor is below
    the timer's resolution."""
    bench = DeviceLoopBench(
        op=lambda *xs: _one_element(*xs, which=perturb), args=args,
        perturb=perturb)
    try:
        return bench.time(reps=reps)
    except MeasurementBelowNoiseFloor:
        return 0.0


def gflops(flop_count: float, seconds: float) -> float:
    return flop_count / seconds / 1e9 if seconds > 0 else float("inf")


def matmul_flops(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


def conv2d_flops(n: int, h_out: int, w_out: int, c_out: int, kh: int, kw: int,
                 c_in: int) -> float:
    return 2.0 * n * h_out * w_out * c_out * kh * kw * c_in
