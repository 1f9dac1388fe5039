"""Pipeline parallelism over a ``pp`` mesh axis (GPipe).

Counterpart of ``tosem_tpu/parallel/pipeline.py``. Layer stages are
sharded across the ``pp`` axis and microbatches stream through a loop of
``M + pp - 1`` ticks whose hand-off is a ``ppermute`` ring shift
(position i to i + 1). Masked compute, as in the JAX package: every
position runs its stage at every tick, and the startup/drain bubble costs
``(pp - 1) / (M + pp - 1)`` of the schedule. The last stage's rows go
back to every position through one ``psum``.

Usage::

    stage_fn(stage_params, x) -> y          # one stage's math, y like x
    params   [pp, ...]                       # stacked per-stage params
    x        [M, mb, ...]                    # microbatched global input

    fwd = make_pipeline_fn(stage_fn, mesh, n_micro=M)
    y = fwd(params, x)                       # [M, mb, ...] final outputs

``params`` is a tree (dicts, lists, tuples) of tensors with a leading
stage axis, sharded ``P("pp")``; the microbatch stream is replicated over
``pp`` (each stage sees it; only stage 0 reads it).

Where the JAX package differentiates the scan with ``jax.grad``, here
``fwd`` is a ``torch.autograd.Function`` whose forward is one
``shard_map`` and whose backward is another, running the reverse
schedule: the ring goes the other way (i to i - 1), and at each tick a
stage whose microbatch is real takes the gradient of its stage from the
input the forward saved, recomputing the stage (a stage's remat), while a
bubble tick sends zeros. The stage gradient is a nested backward, which
runs on the thread that called the ``shard_map``
(:func:`~tosem_tpu_torch.parallel.spmd.on_caller`): the outer backward
holds PyTorch's autograd thread of the card. Parameter gradients stay
stacked ``[pp, ...]``, summed over the microbatches in fp32.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from tosem_tpu_torch.parallel.mesh import Mesh
from tosem_tpu_torch.parallel.spmd import (P, _leaves, _rebuild,
                                           axis_index, axis_size, on_caller,
                                           ppermute, psum, shard_map)


def _map(fn, tree):
    return _rebuild(tree, [fn(x) for x in _leaves(tree)])


def stack_stage_params(per_stage_params) -> Any:
    """[tree per stage] -> one tree with a leading stage axis."""
    trees = list(per_stage_params)
    cols = zip(*(_leaves(t) for t in trees))
    return _rebuild(trees[0], [torch.stack(c) for c in cols])


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [M, B // M, ...]."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro {n_micro}")
    return x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _forward_body(stage_fn, n_micro, axis, params, x):
    """One position: its stage over every tick. Returns (the last stage's
    outputs, summed over the axis; this stage's input at each tick)."""
    stage, n = axis_index(axis), axis_size(axis)
    local = _map(lambda p: p[0], params)
    ring = [(i, (i + 1) % n) for i in range(n)]
    zero = torch.zeros_like(x[0])
    act, emitted, inputs = zero, [], []
    for t in range(n_micro + n - 1):
        # microbatch m sits at stage s at tick t = m + s; stage 0 injects
        # the stream while it lasts
        inp = (x[t] if t < n_micro else zero) if stage == 0 else act
        out = stage_fn(local, inp)
        inputs.append(inp)
        emitted.append(out)
        act = ppermute(out, axis, ring)
    outs = torch.stack(emitted[n - 1:n - 1 + n_micro])
    mine = outs if stage == n - 1 else torch.zeros_like(outs)
    return psum(mine, axis), torch.stack(inputs)[None]


def _stage_vjp(stage_fn, local, inp, cot):
    """(d input, d stage params) of one stage at one tick: the stage
    recomputed from its saved input under autograd."""
    leaves = [p.detach().requires_grad_() for p in _leaves(local)]
    with torch.enable_grad():
        inp = inp.detach().requires_grad_()
        out = stage_fn(_rebuild(local, leaves), inp)
        grads = torch.autograd.grad(out, [inp] + leaves, cot,
                                    allow_unused=True)
    return grads[0], [torch.zeros_like(p) if g is None else g
                      for g, p in zip(grads[1:], leaves)]


def _backward_body(stage_fn, n_micro, axis, params, saved, dy):
    """One position: the reverse schedule. Returns (d stream, summed over
    the axis; this stage's parameter gradients [1, ...])."""
    stage, n = axis_index(axis), axis_size(axis)
    local = _map(lambda p: p[0], params)
    ring_back = [(i, (i - 1) % n) for i in range(n)]
    zero = torch.zeros_like(dy[0])
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in _leaves(local)]
    dx = [zero] * n_micro
    arriving = zero
    for t in reversed(range(n_micro + n - 1)):
        m = t - stage
        # the cotangent of this stage's output at tick t: the pipeline's
        # output gradient at the last stage, else what stage + 1 sent
        # back for its input at tick t + 1
        cot = (dy[m] if 0 <= m < n_micro else zero) if stage == n - 1 \
            else arriving
        if 0 <= m < n_micro:
            d_inp, d_p = on_caller(_stage_vjp, stage_fn, local,
                                   saved[0, t], cot)
            for a, g in zip(acc, d_p):
                a.add_(g.float())
            if stage == 0:
                dx[t] = d_inp
        else:
            d_inp = zero
        arriving = ppermute(d_inp, axis, ring_back)
    mine = torch.stack(dx) if stage == 0 else torch.zeros_like(dy)
    grads = [a.to(p.dtype)[None] for a, p in zip(acc, _leaves(local))]
    return psum(mine, axis), _rebuild(local, grads)


class _Pipeline(torch.autograd.Function):
    """``forward(ctx, fns, tree, x, *leaves)``: the pipelined stream;
    backward: d x and d leaves, each from one shard_map."""

    @staticmethod
    def forward(ctx, fns, tree, x, *leaves):
        fwd, _ = fns
        with torch.no_grad():
            out, saved = fwd(_rebuild(tree, leaves), x)
        ctx.fns, ctx.tree = fns, tree
        ctx.save_for_backward(saved, *leaves)
        return out

    @staticmethod
    def backward(ctx, dy):
        saved, *leaves = ctx.saved_tensors
        _, bwd = ctx.fns
        with torch.no_grad():
            dx, grads = bwd(_rebuild(ctx.tree, leaves), saved,
                            dy.contiguous())
        return (None, None, dx if ctx.needs_input_grad[2] else None,
                *_leaves(grads))


def make_pipeline_fn(stage_fn: Callable, mesh: Mesh, *, n_micro: int,
                     axis: str = "pp", param_spec: Optional[P] = None,
                     batch_spec: Optional[P] = None) -> Callable:
    """Build ``fwd(params, x) -> y`` pipelined over ``mesh[axis]``,
    differentiable in ``params`` and ``x``.

    params: stacked [n_stages, ...] tree, sharded on the stage axis.
    x: [M, mb, ...] microbatched input, replicated by default; pass
    ``batch_spec`` (e.g. ``P(None, "dp")``) to shard the microbatch dim
    over a data-parallel axis of a 2-D ``(dp, pp)`` mesh: each dp slice
    pipelines its own batch shard.
    """
    pspec = param_spec or P(axis)
    bspec = batch_spec if batch_spec is not None else P()
    saved_spec = P(axis, *bspec)

    def fwd_body(params, x):
        return _forward_body(stage_fn, n_micro, axis, params, x)

    def bwd_body(params, saved, dy):
        return _backward_body(stage_fn, n_micro, axis, params, saved, dy)

    fwd = shard_map(fwd_body, mesh, in_specs=(pspec, bspec),
                    out_specs=(bspec, saved_spec))
    bwd = shard_map(bwd_body, mesh, in_specs=(pspec, saved_spec, bspec),
                    out_specs=(bspec, pspec))

    def run(params, x):
        if x.shape[0] != n_micro:
            raise ValueError(
                f"input has {x.shape[0]} microbatches but the pipeline was "
                f"built with n_micro={n_micro}: a mismatch would silently "
                "drop or duplicate microbatches")
        skeleton = _map(lambda _: None, params)
        return _Pipeline.apply((fwd, bwd), skeleton, x, *_leaves(params))

    return run
