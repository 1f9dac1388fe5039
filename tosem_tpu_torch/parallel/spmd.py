"""SPMD over a mesh of positions: the counterpart of ``jax.shard_map`` and
the ``lax`` axis collectives.

:func:`shard_map` takes global tensors in and gives global tensors out.
It splits each input by its partition spec (:class:`P`) into a
contiguous tensor each position owns, on the position's device, as a
device owns its slice of a sharded array; runs ``body`` once per
position, each in its own thread; and assembles the outputs by
``out_specs``. A dimension no output spec names is taken from the
position at index 0 of the unnamed axes, so a ``P()`` output is position
0's (the JAX package's ``check_vma=False``).

Inside a body, :func:`psum`, :func:`all_gather`, :func:`psum_scatter`,
:func:`ppermute`, :func:`all_to_all` and :func:`pbroadcast` meet among
the positions that share every mesh coordinate but the named axes, and
:func:`axis_index`/:func:`axis_size` read the position's place. Each
collective combines its members' values once, in position order (a sum
is the left fold ``((x0 + x1) + x2) + ...``), so every member gets the
same bits; each member gets the result on its own device. A collective's
result may be shared between members on one device: bodies treat their
inputs and collective results as read-only, as traced JAX code does.

Positions on one card launch onto the caller's current stream of that
card, so their kernels are ordered as one program's, and a sharded call
gives each (row, head) cell the same bits as the unsharded kernel. Every
wait inside a collective and the join of the position threads has a time
limit (``timeout``): a body that hangs or fails makes the call raise,
never hang. A body's autograd graph must not reach into a collective:
the differentiable sharded ops (:mod:`tosem_tpu_torch.parallel.ring`) are
``torch.autograd.Function``\\ s whose forward and backward are each one
``shard_map``, and a collective refuses an input that requires grad. A
body without collectives stays differentiable: the split and the
assembly are copies autograd sees, so gradients reach the global inputs.

A body may hand work to the thread that called the ``shard_map``
(:func:`on_caller`) and wait for its result. The backward of a
differentiable sharded op runs on PyTorch's autograd thread of the card,
and a position thread that itself ran a backward there would wait on
that busy thread forever; the caller's thread runs it as a nested
backward instead (:mod:`tosem_tpu_torch.parallel.pipeline`'s stage
gradients).

Over a multi-process mesh (:func:`~tosem_tpu_torch.parallel.mesh.
process_mesh`) each process runs its own positions. A meeting whose
members lie in several processes gathers the members' values over the
meeting's process group (``all_gather_object``, values on the CPU) and
every rank runs the same combine over all of them in member order, so
the ranks get the bits of a one-process mesh. An output block that no
position of some rank holds is gathered from the others the same way.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tosem_tpu_torch.parallel.mesh import Mesh

DEFAULT_TIMEOUT_S = 300.0
# after the time limit, how long positions get to return once woken
_GRACE_S = 2.0


class P(tuple):
    """A partition spec: one entry a tensor dimension, each a mesh axis
    name, a tuple of names (the dimension split over their product,
    row-major) or None (whole). Trailing dimensions not named are
    whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(a) for a in self) + ")"


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _linear(coords: Dict[str, int], axes: Sequence[str],
            sizes: Dict[str, int]) -> int:
    i = 0
    for a in axes:
        i = i * sizes[a] + coords[a]
    return i


def _check_axes(mesh: Mesh, axes: Sequence[str]) -> None:
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} not in mesh {mesh.axis_names}")


# ----------------------------------------------------------------- trees
#
# Arguments and results are trees of dicts, lists, tuples and named tuples
# with tensors (or other values, which replicate) at the leaves. A spec is
# a prefix of its tree: a P (or None) covers the whole subtree below it.


def _leaves_with_specs(tree, spec) -> List[Tuple[Any, P]]:
    if spec is None or isinstance(spec, P):
        spec = P() if spec is None else spec
        return [(leaf, spec) for leaf in _leaves(tree)]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves_with_specs(tree[k],
                                                            spec[k])]
    if isinstance(tree, (list, tuple)):
        if len(spec) != len(tree):
            raise ValueError(f"spec {spec!r} does not match a sequence of "
                             f"{len(tree)}")
        return [x for t, s in zip(tree, spec)
                for x in _leaves_with_specs(t, s)]
    raise ValueError(f"spec {spec!r} for a leaf: use P(...)")


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(tree, leaves):
    return _build(tree, iter(leaves))


def _build(node, it):
    # a module-level recursion: a nested closure that calls itself is a
    # reference cycle, which would hold its leaves (device tensors) until
    # the garbage collector runs
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_build(t, it) for t in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(t, it) for t in node)
    return next(it)


# ------------------------------------------------------ split / assemble


def _owned(piece: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A fresh contiguous copy of ``piece`` on ``device`` (its own
    allocation, so it starts on the allocator's alignment)."""
    out = torch.empty(piece.shape, dtype=piece.dtype, device=device)
    out.copy_(piece)
    return out


def split(x, mesh: Mesh, spec: P) -> list:
    """``x`` cut by ``spec``: one value per position (row-major). A
    tensor dimension named by the spec is split evenly (it must divide)
    and each position gets its block as an owned contiguous tensor on its
    device; a tensor with no named dimension is shared by the positions
    on its device and copied to the others; any other value replicates.
    Another process's positions get None."""
    n = mesh.size
    if not torch.is_tensor(x):
        return [x] * n
    local = mesh.local_positions()
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec!r} names {len(spec)} dimensions of a "
                         f"{x.ndim}-d tensor")
    sizes = mesh.shape
    dims = [(d, _entry_axes(e)) for d, e in enumerate(spec) if e is not None]
    for d, axes in dims:
        _check_axes(mesh, axes)
        parts = int(np.prod([sizes[a] for a in axes]))
        if x.shape[d] % parts:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} is not "
                             f"divisible by {axes} = {parts} positions")
    out = [None] * n
    for i in local:
        dev = mesh.device_of(i)
        if not dims:
            out[i] = x if x.device == dev else x.to(dev)
            continue
        c = mesh.coords(i)
        piece = x
        for d, axes in dims:
            size = x.shape[d] // int(np.prod([sizes[a] for a in axes]))
            piece = piece.narrow(d, _linear(c, axes, sizes) * size, size)
        out[i] = _owned(piece, dev)
    return out


def _block_keys(mesh: Mesh, spec: P):
    dims = [(d, _entry_axes(e)) for d, e in enumerate(spec) if e is not None]
    for _, axes in dims:
        _check_axes(mesh, axes)
    named = [a for _, axes in dims for a in axes]
    return dims, [tuple(mesh.coords(i)[a] for a in named)
                  for i in range(mesh.size)]


def assemble(pieces: Sequence, mesh: Mesh, spec: P):
    """The global value of per-position ``pieces`` under ``spec``: the
    named dimensions concatenated in axis order, on the device of this
    process's first piece; each block from the first position
    (row-major) holding it, which is the one at index 0 of the axes the
    spec does not name. None marks a piece this process does not hold (or
    a None output)."""
    held = [i for i, p in enumerate(pieces) if p is not None]
    if not held:
        return None
    first = next((pieces[i] for i in held if mesh.is_local(i)),
                 pieces[held[0]])
    if not torch.is_tensor(first):
        return first
    sizes = mesh.shape
    dims, keys = _block_keys(mesh, spec)
    if not dims:
        return first
    shape = list(first.shape)
    for d, axes in dims:
        shape[d] *= int(np.prod([sizes[a] for a in axes]))
    out = torch.empty(shape, dtype=first.dtype, device=first.device)
    done = set()
    for i in held:
        if keys[i] in done:
            continue
        done.add(keys[i])
        c = mesh.coords(i)
        view = out
        for d, axes in dims:
            size = pieces[i].shape[d]
            view = view.narrow(d, _linear(c, axes, sizes) * size, size)
        view.copy_(pieces[i])
    if len(done) != len(set(keys)):
        raise RuntimeError(f"assemble under {spec!r}: blocks missing")
    return out


@dataclass
class Sharded:
    """A tensor held as its positions' blocks (:func:`split`):
    :func:`shard_map` hands each position its own block without cutting
    again when the spec matches, and :func:`gather` puts it back
    together."""
    mesh: Mesh
    spec: P
    pieces: list

    @classmethod
    def of(cls, x, mesh: Mesh, spec: P) -> "Sharded":
        return cls(mesh, P(*spec), split(x, mesh, P(*spec)))

    def gather(self):
        return assemble(self.pieces, self.mesh, self.spec)


# ------------------------------------------------------------ positions


class _Aborted(RuntimeError):
    """Another position of the call failed or the call timed out."""


class _Meeting:
    def __init__(self, op: str, n: int, members: Optional[List[int]],
                 n_local: int):
        self.op = op
        self.values: list = [None] * n
        self.members = members      # flat positions (process meshes)
        self.n_local = n_local
        self.arrived = 0
        self.taken = 0
        self.results: Optional[list] = None
        self.error: Optional[BaseException] = None


class _Call:
    """What the positions of one shard_map call share."""

    def __init__(self, mesh: Mesh, timeout: float):
        self.mesh = mesh
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self.cond = threading.Condition()
        self.meetings: Dict[tuple, _Meeting] = {}
        self.failed: Optional[str] = None
        self.requests: collections.deque = collections.deque()
        self.finished = 0

    def abort(self, why: str) -> None:
        with self.cond:
            if self.failed is None:
                self.failed = why
            self.cond.notify_all()


class _Position:
    def __init__(self, call: _Call, flat: int):
        self.call = call
        self.flat = flat
        self.coords = call.mesh.coords(flat)
        self.device = call.mesh.device_of(flat)
        self.seq = 0


_LOCAL = threading.local()


def _here() -> _Position:
    pos = getattr(_LOCAL, "position", None)
    if pos is None:
        raise RuntimeError("a collective or axis query runs inside a "
                           "shard_map body only")
    return pos


def _group(pos: _Position, axis_name) -> Tuple[Tuple[str, ...], int, int,
                                                tuple]:
    """(axes, this position's index among the members, member count,
    the coordinates the members share)."""
    axes = _entry_axes(axis_name)
    mesh = pos.call.mesh
    _check_axes(mesh, axes)
    sizes = mesh.shape
    n = int(np.prod([sizes[a] for a in axes]))
    rest = tuple((a, pos.coords[a]) for a in mesh.axis_names
                 if a not in axes)
    return axes, _linear(pos.coords, axes, sizes), n, rest


def _members(mesh: Mesh, axes, rest) -> List[int]:
    """The flat positions of a group, in member order."""
    sizes = mesh.shape
    fixed = dict(rest)
    out = []
    for i in range(mesh.size):
        c = mesh.coords(i)
        if all(c[a] == v for a, v in fixed.items()):
            out.append((_linear(c, axes, sizes), i))
    return [i for _, i in sorted(out)]


def axis_index(axis_name) -> int:
    """This position's index along ``axis_name`` (a name or a tuple of
    names, row-major)."""
    return _group(_here(), axis_name)[1]


def axis_size(axis_name) -> int:
    return _group(_here(), axis_name)[2]


def _cpu(tree):
    return _rebuild(tree, [x.detach().cpu() if torch.is_tensor(x) else x
                           for x in _leaves(tree)])


def _exchange(mesh: Mesh, members: List[int], values: list) -> list:
    """Every member's (value, device) in member order: the local ones
    as they are, the other processes' over the group's process group
    (values on the CPU, where the combine puts their results too)."""
    import torch.distributed as dist
    group = mesh.process_group(members)
    mine = {j: _cpu(values[j][0]) for j, i in enumerate(members)
            if mesh.is_local(i)}
    got = [None] * dist.get_world_size(group)
    dist.all_gather_object(got, mine, group=group)
    out = list(values)
    cpu = torch.device("cpu")
    for part in got:
        for j, v in part.items():
            if out[j] is None:
                out[j] = (v, cpu)
    return out


def _meet(op: str, axis_name, value, combine: Callable[[list, list],
                                                        list]):
    """Deposit ``value`` in this position's meeting over ``axis_name`` and
    return its share of ``combine(values, devices)`` (one result per
    member, in member order), computed once by the last member of this
    process to arrive (after gathering the other processes' members)."""
    pos = _here()
    if any(torch.is_tensor(v) and v.requires_grad for v in _leaves(value)):
        raise RuntimeError(
            f"{op}: an input requires grad. No autograd graph may cross a "
            "collective (on a GPU each device's backward runs on one "
            "thread, and positions meeting inside it would wait forever): "
            "take gradients inside the body and meet on their values, or "
            "write a torch.autograd.Function whose forward and backward "
            "are each a shard_map")
    call = pos.call
    mesh = call.mesh
    axes, idx, n, rest = _group(pos, axis_name)
    key = (pos.seq, axes, rest)
    pos.seq += 1
    with call.cond:
        m = call.meetings.get(key)
        if m is None:
            members = _members(mesh, axes, rest) if mesh.ranks is not None \
                else None
            n_local = n if members is None else \
                sum(1 for i in members if mesh.is_local(i))
            m = call.meetings[key] = _Meeting(op, n, members, n_local)
        if m.op != op:
            raise RuntimeError(f"collective {pos.seq - 1} over {axes}: "
                               f"{op} meets {m.op} (bodies must call the "
                               "same collectives in the same order)")
        m.values[idx] = (value, pos.device)
        m.arrived += 1
        last = m.arrived == m.n_local
    if last:
        results = error = None
        try:
            values = m.values
            if m.n_local < n:
                values = _exchange(mesh, m.members, values)
            results = combine([v for v, _ in values],
                              [d for _, d in values])
        except BaseException as e:      # handed to every member
            error = e
        with call.cond:
            m.results, m.error = results, error
            call.cond.notify_all()
    with call.cond:
        while m.results is None and m.error is None:
            if call.failed is not None:
                raise _Aborted(call.failed)
            left = call.deadline - time.monotonic()
            if left <= 0:
                call.failed = call.failed or (
                    f"{op} over {axes} waited past the {call.timeout} s "
                    "time limit")
                call.cond.notify_all()
                raise _Aborted(call.failed)
            call.cond.wait(left)
        m.taken += 1
        if m.taken == m.n_local:
            del call.meetings[key]
        if m.error is not None:
            raise RuntimeError(f"{op} over {axes} failed") from m.error
        return m.results[idx]


def on_caller(fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` on the thread that called the
    ``shard_map`` (under this position's card) and return its result:
    for work that must not run on a position thread, such as a backward
    pass inside the backward of a sharded op."""
    pos = _here()
    call = pos.call
    box: Dict[str, Any] = {}
    with call.cond:
        call.requests.append((fn, args, kwargs, pos.device, box))
        call.cond.notify_all()
        while "done" not in box:
            if call.failed is not None:
                raise _Aborted(call.failed)
            left = call.deadline - time.monotonic()
            if left <= 0:
                call.failed = call.failed or (
                    f"on_caller waited past the {call.timeout} s time "
                    "limit")
                call.cond.notify_all()
                raise _Aborted(call.failed)
            call.cond.wait(left)
    if "error" in box:
        raise box["error"]
    return box["result"]


def _serve_requests(call: _Call, n_threads: int) -> None:
    """The caller's side of :func:`on_caller`: run the positions'
    requests until they have all finished or the time limit passes."""
    while True:
        with call.cond:
            while not call.requests and call.finished < n_threads \
                    and call.failed is None:
                left = call.deadline - time.monotonic()
                if left <= 0:
                    return
                call.cond.wait(left)
            if not call.requests:
                return
            fn, args, kwargs, dev, box = call.requests.popleft()
        try:
            with contextlib.ExitStack() as stack:
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                box["result"] = fn(*args, **kwargs)
        except BaseException as e:     # raised in the position
            box["error"] = e
        with call.cond:
            box["done"] = True
            call.cond.notify_all()


def _to(x, dev):
    return x if not torch.is_tensor(x) or x.device == dev else x.to(dev)


def _fold(values: list):
    """The left fold ``((v0 + v1) + v2) + ...`` of tensors or numbers,
    on v0's device."""
    acc = values[0]
    for v in values[1:]:
        acc = (torch.add(acc, _to(v, acc.device)) if torch.is_tensor(acc)
               else acc + v)
    return acc


def psum(x, axis_name):
    """The sum over the axis, of a tensor, a number or a tree of them
    (one meeting for the whole tree): every member gets the left fold in
    member order."""
    def combine(values, devices):
        trees = [_leaves(v) for v in values]
        summed = [_fold([t[j] for t in trees]) for j in range(len(trees[0]))]
        return [_rebuild(values[0], [_to(s, d) for s in summed])
                for d in devices]
    return _meet("psum", axis_name, x, combine)


def all_gather(x: torch.Tensor, axis_name, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """The members' tensors in member order, concatenated along ``axis``
    (``tiled``) or stacked at it."""
    def combine(values, devices):
        d0 = values[0].device
        vs = [_to(v, d0) for v in values]
        out = torch.cat(vs, axis) if tiled else torch.stack(vs, axis)
        return [_to(out, d) for d in devices]
    return _meet("all_gather", axis_name, x, combine)


def psum_scatter(x: torch.Tensor, axis_name, *, scatter_dimension: int = 0,
                 tiled: bool = False) -> torch.Tensor:
    """The sum over the axis (the left fold), member i keeping block i of
    ``scatter_dimension`` (which must divide by the member count; without
    ``tiled`` its size must equal it and the dimension is dropped)."""
    def combine(values, devices):
        n = len(values)
        total = _fold(values)
        size = total.shape[scatter_dimension]
        if size % n or (not tiled and size != n):
            raise ValueError(f"psum_scatter: dimension {scatter_dimension} "
                             f"of {tuple(total.shape)} over {n} members")
        blocks = total.chunk(n, scatter_dimension)
        if not tiled:
            blocks = [b.squeeze(scatter_dimension) for b in blocks]
        return [_owned(b, d) for b, d in zip(blocks, devices)]
    return _meet("psum_scatter", axis_name, x, combine)


def ppermute(x: torch.Tensor, axis_name,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Member ``dst`` receives a copy of member ``src``'s ``x`` for each
    ``(src, dst)`` of ``perm``; a member no pair sends to gets zeros."""
    perm = [(int(s), int(d)) for s, d in perm]
    if len({d for _, d in perm}) != len(perm) or \
            len({s for s, _ in perm}) != len(perm):
        raise ValueError(f"ppermute: {perm} is not a permutation")

    def combine(values, devices):
        out = [torch.zeros_like(v) for v in values]
        for s, d in perm:
            out[d] = _owned(values[s], devices[d])
        return out
    return _meet("ppermute", axis_name, x, combine)


def all_to_all(x: torch.Tensor, axis_name, split_axis: int,
               concat_axis: int, *, tiled: bool = True) -> torch.Tensor:
    """Each member cuts ``x`` into blocks along ``split_axis``, one a
    member; member i gets block i of every member, concatenated in member
    order along ``concat_axis``."""
    if not tiled:
        raise ValueError("all_to_all takes tiled=True only")

    def combine(values, devices):
        n = len(values)
        if values[0].shape[split_axis] % n:
            raise ValueError(f"all_to_all: dimension {split_axis} of "
                             f"{tuple(values[0].shape)} over {n} members")
        blocks = [v.chunk(n, split_axis) for v in values]
        return [torch.cat([_to(blocks[j][i], devices[i]) for j in range(n)],
                          concat_axis).contiguous()
                for i in range(n)]
    return _meet("all_to_all", axis_name, x, combine)


def pbroadcast(x: torch.Tensor, axis_name, root: int = 0) -> torch.Tensor:
    """Every member gets member ``root``'s ``x`` (``ncclBroadcast``)."""
    def combine(values, devices):
        return [values[root] if d == devices[root] else
                _to(values[root], d) for d in devices]
    return _meet("pbroadcast", axis_name, x, combine)


# ------------------------------------------------------------- shard_map


def _streams(mesh: Mesh) -> Dict[str, Any]:
    """The caller's current stream of each card the mesh uses."""
    return {str(d): torch.cuda.current_stream(d)
            for d in {mesh.device_of(i) for i in range(mesh.size)}
            if d.type == "cuda"}


def _position_args(args, in_specs, mesh: Mesh) -> List[list]:
    """The arguments of each position: every leaf split by its spec (or,
    a :class:`Sharded` leaf with that spec on this mesh, its blocks)."""
    per_pos: List[list] = [[] for _ in range(mesh.size)]
    for arg, spec in zip(args, in_specs):
        pairs = _leaves_with_specs(arg, spec)
        cut = []
        for leaf, s in pairs:
            if isinstance(leaf, Sharded):
                if leaf.mesh is not mesh or tuple(leaf.spec) != tuple(s):
                    raise ValueError(f"a Sharded argument cut by "
                                     f"{leaf.spec!r} on another mesh or "
                                     f"spec than {s!r}")
                cut.append(leaf.pieces)
            else:
                cut.append(split(leaf, mesh, s))
        for i in mesh.local_positions():
            per_pos[i].append(_rebuild(arg, [c[i] for c in cut]))
    return per_pos


def _gather_missing(pieces: List[list], mesh: Mesh, specs) -> None:
    """Fill in, from the other processes, the output blocks some rank
    holds no position of. Whether that is needed follows from the mesh
    alone, so every rank takes part or none does."""
    world = int(mesh.ranks.max()) + 1
    needed = []
    for j, spec in enumerate(specs):
        _, keys = _block_keys(mesh, spec)
        for r in range(world):
            have = {keys[i] for i in range(mesh.size) if mesh.rank_of(i) == r}
            if have != set(keys):
                needed.append(j)
                break
    if not needed:
        return
    import torch.distributed as dist
    mine = {}
    for j in needed:
        _, keys = _block_keys(mesh, specs[j])
        for i, p in enumerate(pieces[j]):
            if p is not None and (j, keys[i]) not in mine:
                mine[(j, keys[i])] = (i, p.detach().cpu()
                                      if torch.is_tensor(p) else p)
    got = [None] * world
    dist.all_gather_object(got, mine)
    for part in got:
        for (j, _), (i, p) in part.items():
            if pieces[j][i] is None:
                pieces[j][i] = p


def shard_map(body: Callable, mesh: Mesh, in_specs, out_specs, *,
              timeout: float = DEFAULT_TIMEOUT_S) -> Callable:
    """``run(*args)``: ``body`` once per position of ``mesh`` over the
    position's share of each argument (``in_specs``: one spec a
    positional argument, or a single :class:`P` for a one-argument
    body), the outputs assembled by ``out_specs`` (a spec tree prefix of
    the body's result). Raises what a position raised, or TimeoutError
    when a position has not finished within ``timeout`` seconds."""
    if isinstance(in_specs, P) or in_specs is None:
        in_specs = (in_specs,)
    in_specs = tuple(in_specs)

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"shard_map body takes {len(in_specs)} "
                            f"arguments (in_specs), got {len(args)}")
        per_pos = _position_args(args, in_specs, mesh)
        call = _Call(mesh, timeout)
        streams = _streams(mesh)
        grad = torch.is_grad_enabled()
        results: list = [None] * mesh.size
        errors: list = [None] * mesh.size
        local = mesh.local_positions()

        def position(i):
            pos = _Position(call, i)
            _LOCAL.position = pos
            try:
                with contextlib.ExitStack() as stack:
                    stack.enter_context(torch.set_grad_enabled(grad))
                    if pos.device.type == "cuda":
                        stack.enter_context(torch.cuda.device(pos.device))
                        stack.enter_context(
                            torch.cuda.stream(streams[str(pos.device)]))
                    results[i] = body(*per_pos[i])
            except BaseException as e:   # recorded; raised by the caller
                errors[i] = e
                call.abort(f"position {i} raised {type(e).__name__}: {e}")
            finally:
                _LOCAL.position = None
                with call.cond:
                    call.finished += 1
                    call.cond.notify_all()

        threads = [threading.Thread(target=position, args=(i,), daemon=True,
                                    name=f"shard_map-pos{i}")
                   for i in local]
        for t in threads:
            t.start()
        _serve_requests(call, len(threads))
        for t in threads:
            t.join(max(0.0, call.deadline - time.monotonic()))
        late = [i for i, t in zip(local, threads) if t.is_alive()]
        if late:
            # wake the positions waiting in a meeting; give the others a
            # moment to return before calling them hung
            call.abort(f"positions {late} still running at the "
                       f"{timeout} s time limit")
            for t in threads:
                t.join(_GRACE_S)
            hung = [i for i, t in zip(local, threads) if t.is_alive()]
            if hung:
                raise TimeoutError(f"shard_map over {mesh}: positions "
                                   f"{hung} did not finish within "
                                   f"{timeout} s")
        real = [e for e in errors if e is not None
                and not isinstance(e, _Aborted)]
        if real:
            raise real[0]
        if any(e is not None for e in errors):
            raise TimeoutError(f"shard_map over {mesh}: {call.failed}")
        i0 = local[0]
        pairs0 = _leaves_with_specs(results[i0], out_specs)
        per_leaf = [None if r is None else _leaves(r) for r in results]
        pieces = [[None if leaves is None else leaves[j]
                   for leaves in per_leaf] for j in range(len(pairs0))]
        if mesh.ranks is not None:
            _gather_missing(pieces, mesh, [s for _, s in pairs0])
        out = [assemble(pieces[j], mesh, s)
               for j, (_, s) in enumerate(pairs0)]
        return _rebuild(results[i0], out)

    return run
