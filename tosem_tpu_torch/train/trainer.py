"""Single-device training loop: train state, AdamW, losses, the train
step and the preemption-safe ``fit``.

The port's counterpart of ``tosem_tpu/train/trainer.py`` in PyTorch's
idiom: the model owns its parameters, so the train state is the step
count, the model and its optimizer (:class:`TrainState`), not a tree of
parameters, and a step updates them in place and returns the same state.
A loss function is ``loss_fn(model, batch, generator) -> (loss, aux)``;
the generator (on the model's device) drives dropout where the JAX
package passed an ``rng`` key.

Data-parallel training over the tensor transport is
:mod:`tosem_tpu_torch.train.distributed`. The steps over a device mesh
(``make_train_step(mesh=)`` with ``shard_batch``, and
``make_partitioned_train_step`` with ``shard_train_state`` and
``shard_batch_by_rules``) compute the **global** step, as GSPMD computes
the JAX package's: one ``shard_map`` in which each position gathers the
parameters, computes the loss numerator and weight count of its rows
(``loss_fn(..., reduce="sum")``), meets the others on the counts, takes
its gradients of ``numerator / global count`` inside the position, and
meets them on the gradients, so the masked mean is over the whole batch
(a mean of the positions' means is another loss). BatchNorm in training
is not row-separable: inside a position of ``make_train_step(mesh=)`` it
takes the global batch's moments (``nn.layers.batch_moments_over``, one
meeting in its forward and one in its backward), and the model's
buffers (BatchNorm's moving stats) go into the step and come back out of
it, position 0's copy written to the model.
"""
from __future__ import annotations

import copy
import functools
import hashlib
import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tosem_tpu_torch.chaos import hooks as _chaos


class TrainingPreempted(RuntimeError):
    """The training process was preempted mid-run (chaos ``train.step``
    ``preempt`` action, or raised by user code on a SIGTERM notice). A
    :func:`fit` with the same ``ckpt_dir`` resumes from the latest atomic
    checkpoint with a bit-exact metric history."""


@dataclass
class TrainState:
    """What a step changes: the step count, the model's parameters and
    the optimizer's moments. ``state_dict``/``load_state_dict`` make it a
    checkpoint tree."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, tree: Dict[str, Any]) -> None:
        self.model.load_state_dict(tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        self.step = int(tree["step"])


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``optax.adamw``'s defaults as a factory ``params -> optimizer``:
    eps added outside the square root, decoupled weight decay 1e-4 (not
    torch's 1e-2) applied to every parameter. The update
    ``p -= lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)`` is optax's
    algebra in torch's order; the moments keep the parameters' dtype."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def create_train_state(model: nn.Module, optimizer) -> TrainState:
    """``optimizer`` is a factory such as :func:`adamw`, called on the
    model's parameters as ``optax``'s ``init`` is."""
    return TrainState(model=model, optimizer=optimizer(model.parameters()))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None, *,
                       reduce: str = "mean"):
    """Token-level cross entropy in fp32; ``weights`` (same shape as
    labels) restricts the average to selected positions (e.g. MLM
    masks). ``reduce="sum"`` gives ``(numerator, count)`` instead, whose
    quotient ``numerator / max(count, 1)`` is the mean: what a mesh step
    sums over its positions before it divides."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    if reduce == "sum":
        if weights is None:
            return -ll.sum(), torch.tensor(float(ll.numel()),
                                           device=ll.device)
        w = weights.float()
        return -(ll * w).sum(), w.sum()
    if reduce != "mean":
        raise ValueError(f"reduce must be 'mean' or 'sum', got {reduce!r}")
    if weights is None:
        return -ll.mean()
    w = weights.float()
    return -(ll * w).sum() / torch.clamp(w.sum(), min=1.0)


def mlm_loss(model, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, *, attn_fn=None,
             reduce: str = "mean"):
    """Masked-LM loss for BERT-style batches.

    Batch keys: ``ids`` (with mask tokens substituted), ``labels``
    (original tokens), optional ``mask`` (attention mask) and ``masked``
    (which positions were masked). The loss averages only over masked
    positions, or over all of them when ``masked`` is absent (plain LM).
    ``attn_fn`` (e.g. ``flash_attn_fn()``) is bound with
    ``functools.partial``. ``reduce="sum"`` returns ``(numerator,
    {"count": masked positions})`` (see :func:`cross_entropy_loss`)."""
    enc = model.apply(batch["ids"], mask=batch.get("mask"), train=True,
                      attn_fn=attn_fn, generator=generator)
    logits = model.mlm_logits(enc)
    if reduce == "sum":
        num, count = cross_entropy_loss(logits, batch["labels"],
                                        batch.get("masked"), reduce="sum")
        return num, {"count": count}
    return cross_entropy_loss(logits, batch["labels"],
                              batch.get("masked"), reduce=reduce), {}


def classification_loss(model, batch: Dict[str, torch.Tensor],
                        generator: Optional[torch.Generator] = None, *,
                        reduce: str = "mean"):
    """Image-classification loss for (image, label) batches, with the
    batch's accuracy in the aux. ``reduce="sum"`` returns ``(numerator,
    {"count": rows, "accuracy": correct rows})``: every aux value but
    ``count`` is then a numerator over the count, as the loss is."""
    logits = model(batch["image"], train=True)
    label = batch["label"].long()
    correct = (logits.argmax(-1) == label).float()
    num, count = cross_entropy_loss(logits, label, reduce="sum")
    if reduce == "sum":
        return num, {"count": count, "accuracy": correct.sum()}
    if reduce != "mean":
        raise ValueError(f"reduce must be 'mean' or 'sum', got {reduce!r}")
    # the quotient the mesh step forms, so a one-position mesh step is
    # this step bit for bit
    count = torch.clamp(count, min=1.0)
    return num / count, {"accuracy": correct.sum() / count}


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable[..., Tuple[torch.Tensor,
                                                 Dict[str, Any]]],
                    *, mesh=None, dp_axis: str = "dp"):
    """``step(state, batch, generator) -> (state, metrics)``: one
    forward, backward and optimizer update, in place. ``state`` must hold
    this ``model`` and ``optimizer`` (so its checkpoints are theirs);
    ``metrics`` holds the loss (a 0-d tensor, not synchronised) and the
    loss function's aux values.

    With ``mesh``, the parameters stay replicated (the model's) and the
    batch is cut over ``dp_axis`` by its leading dim (:func:`shard_batch`,
    or plain tensors the step cuts): the global step over the mesh's
    positions (see the module docstring), its gradient applied to the
    model by ``optimizer`` on the caller's thread, and the model's
    buffers set to position 0's after the step (all positions agree).
    ``loss_fn`` must take ``reduce="sum"`` (as :func:`mlm_loss` and
    :func:`classification_loss` do); its aux numerators come back as
    means over the global batch. A model with BatchNorm takes CPU
    positions or one position a card: the moments' backward meets inside
    each position's backward, which on a card runs on the card's one
    autograd thread."""
    if mesh is not None:
        return _replicated_mesh_step(model, optimizer, loss_fn, mesh,
                                     dp_axis)

    def step(state: TrainState, batch, generator=None):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("train state holds another model or optimizer "
                             "than this step was built for")
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(model, batch, generator)
        loss.backward()
        # a parameter the loss never reached (the segment table of a
        # batch without segments) gets a zero gradient, as under
        # jax.grad, so AdamW still decays it as optax does
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), **aux}
    return step


# ------------------------------------------------------- mesh train steps


def shard_batch(batch: Any, mesh, axis: str = "dp") -> Any:
    """A batch (a dict of tensors) held as blocks of its leading dim over
    ``axis`` (a 0-d leaf replicates)."""
    from tosem_tpu_torch.parallel.spmd import P, Sharded
    return {k: Sharded.of(v, mesh, P(axis) if getattr(v, "ndim", 0) >= 1
                          else P()) for k, v in batch.items()}


def shard_batch_by_rules(batch: Any, mesh, batch_rules) -> Any:
    from tosem_tpu_torch.parallel.sharding import shard_tree
    return shard_tree(batch, mesh, batch_rules)


@dataclass
class MeshTrainState:
    """A train state held as blocks over a mesh: each parameter cut by
    its rule's spec (``specs``), each position owning its blocks
    (``blocks[name].pieces[i]``, an ``nn.Parameter`` on the position's
    device) and an optimizer of its own over them, whose moments are
    blocks of the same cut. ``buffers`` are copies of the model's
    buffers (BatchNorm's moving stats), replicated, which a step
    updates. ``model`` is the module the blocks came from; a step does
    not touch it (:meth:`gather` gives the full tensors)."""
    model: nn.Module
    mesh: Any
    specs: Dict[str, Any]
    blocks: Dict[str, Any]
    optimizers: Any
    step: int = 0
    buffers: Dict[str, torch.Tensor] = field(default_factory=dict)

    def gather(self) -> Dict[str, torch.Tensor]:
        """The full parameters, by name (detached)."""
        with torch.no_grad():
            return {n: b.gather().detach() for n, b in self.blocks.items()}


def shard_train_state(state: TrainState, mesh, rules) -> MeshTrainState:
    """``state``'s parameters and optimizer moments cut by ``rules``
    (:mod:`tosem_tpu_torch.parallel.sharding`), each position owning a
    copy of its blocks on its device, and an optimizer of ``state``'s
    type and hyperparameters over them on each position."""
    from tosem_tpu_torch.parallel.sharding import spec_for_path, _clip_spec
    from tosem_tpu_torch.parallel.spmd import P, Sharded, split
    opt = state.optimizer
    if len(opt.param_groups) != 1:
        raise ValueError("shard_train_state takes an optimizer with one "
                         "parameter group")
    named = list(state.model.named_parameters())
    specs = {n: _clip_spec(spec_for_path(n, rules), p.ndim)
             for n, p in named}
    local = mesh.local_positions()
    blocks, moments = {}, {}
    with torch.no_grad():
        for n, p in named:
            pieces = split(p.detach(), mesh, specs[n])
            blocks[n] = Sharded(mesh, specs[n], [
                None if x is None else
                nn.Parameter(_own(x), requires_grad=p.requires_grad)
                for x in pieces])
            st = opt.state.get(p, {})
            moments[n] = {k: (split(v, mesh, specs[n])
                              if torch.is_tensor(v) and v.shape == p.shape
                              else [v] * mesh.size) for k, v in st.items()}
    # the group's hyperparameters that the optimizer's constructor takes
    takes = inspect.signature(type(opt).__init__).parameters
    group = {k: v for k, v in opt.param_groups[0].items()
             if k != "params" and k in takes}
    optimizers = [None] * mesh.size
    for i in local:
        params = [blocks[n].pieces[i] for n, _ in named]
        o = type(opt)(params, **group)
        for n, _ in named:
            if moments[n]:
                o.state[blocks[n].pieces[i]] = {
                    k: (_own(v[i]) if torch.is_tensor(v[i]) else v[i])
                    for k, v in moments[n].items()}
        optimizers[i] = o
    return MeshTrainState(model=state.model, mesh=mesh, specs=specs,
                          blocks=blocks, optimizers=Sharded(mesh, P(),
                                                            optimizers),
                          step=state.step,
                          buffers={n: _own(b) for n, b
                                   in state.model.named_buffers()})


def _own(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out.copy_(x)
    return out


class _LossOf(nn.Module):
    """``loss_fn`` over ``model`` as a module, so ``functional_call`` can
    run it on tensors that are not the model's."""

    def __init__(self, model: nn.Module, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch, generator):
        return self.loss_fn(self.model, batch, generator, reduce="sum")


def _batch_rows(batch: Dict[str, torch.Tensor], specs: Dict[str, Any],
                mesh) -> Tuple[Dict[str, torch.Tensor], tuple, int, int]:
    """This position's rows of the batch, inside a shard_map body: every
    dim a spec cuts beyond the leading one is gathered, and the rows are
    split over the axes that cut it. Returns (rows, the axes that split
    rows, the first row's index in the global batch, global rows)."""
    from tosem_tpu_torch.parallel.spmd import all_gather, axis_index
    from tosem_tpu_torch.parallel.spmd import _entry_axes
    sizes = mesh.shape
    out, row_axes, start, total = {}, None, 0, None
    for k, x in batch.items():
        spec = tuple(specs[k])
        if not torch.is_tensor(x) or x.ndim == 0:
            out[k] = x
            continue
        lead = _entry_axes(spec[0]) if spec else ()
        rest = tuple(a for e in spec[1:] for a in _entry_axes(e))
        for d, e in enumerate(spec):
            if d and e is not None:
                x = all_gather(x, e, axis=d, tiled=True)
        k_rest = int(np.prod([sizes[a] for a in rest])) if rest else 1
        if x.shape[0] % k_rest:
            raise ValueError(
                f"batch leaf {k!r}: {x.shape[0]} rows a position do not "
                f"split over {rest} = {k_rest} positions")
        per = x.shape[0] // k_rest
        i_rest = axis_index(rest) if rest else 0
        x = x.narrow(0, i_rest * per, per)
        axes = lead + rest
        if row_axes is not None and axes != row_axes:
            raise ValueError(f"batch leaves split rows over {row_axes} and "
                             f"{axes}: every leaf must split alike")
        row_axes = axes
        n_lead = int(np.prod([sizes[a] for a in lead])) if lead else 1
        i_lead = axis_index(lead) if lead else 0
        start = i_lead * per * k_rest + i_rest * per
        total = per * k_rest * n_lead
        out[k] = x.contiguous()
    return out, row_axes or (), start, total


def _global_grads(skel, loss_fn, params, batch, row_axes, start, total,
                  gen_state, device, buffers=None):
    """Inside a position: (global loss, gradients of the global loss by
    name, the generator's state after the step, the buffers after the
    step, the aux numerators' global means). ``params`` are full tensors
    (no grad); ``buffers`` (the model's, e.g. BatchNorm's moving stats)
    are copied, and the copies updated."""
    from torch.func import functional_call
    from tosem_tpu_torch.nn.layers import RowSlice, batch_moments_over
    from tosem_tpu_torch.parallel.spmd import axis_size, psum
    gen = None
    if gen_state is not None:
        gen = torch.Generator(device=device)
        gen.set_state(torch.frombuffer(bytearray(gen_state),
                                       dtype=torch.uint8))
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    bufs = {n: b.detach().clone() for n, b in (buffers or {}).items()}
    tensors = {f"model.{n}": p for n, p in leaves.items()}
    tensors.update({f"model.{n}": b for n, b in bufs.items()})
    # a one-member axis leaves the moments the position's own, so a
    # one-position mesh step is the plain step bit for bit
    moment_axes = row_axes if row_axes and axis_size(row_axes) > 1 else ()
    with torch.enable_grad(), batch_moments_over(moment_axes):
        num, aux = functional_call(skel, tensors,
                                   (batch, RowSlice(gen, start, total)))
        if "count" not in aux:
            raise ValueError("a mesh step's loss_fn(..., reduce='sum') "
                             "returns (numerator, {'count': ...})")
        count = aux["count"].detach()
        if row_axes:
            count = psum(count, row_axes)
        local = num / torch.clamp(count, min=1.0)
        names = list(leaves)
        grads = torch.autograd.grad(local, [leaves[n] for n in names],
                                    allow_unused=True)
    grads = {n: torch.zeros_like(leaves[n]) if g is None else g
             for n, g in zip(names, grads)}
    num = num.detach()
    sums = {k: v.detach() for k, v in aux.items() if k != "count"}
    if row_axes:
        num, grads, sums = psum((num, grads, sums), row_axes)
    loss = num / torch.clamp(count, min=1.0)
    means = {k: v / torch.clamp(count, min=1.0) for k, v in sums.items()}
    return loss, grads, (None if gen is None
                         else bytes(gen.get_state().numpy())), bufs, means


def _skeletons(model: nn.Module, loss_fn, n: int) -> list:
    """A parameterless copy of the loss over ``model`` for each position
    (functional_call swaps a module's tensors for the call, so threads
    never share one)."""
    meta = copy.deepcopy(model).to("meta")
    return [_LossOf(copy.deepcopy(meta), loss_fn) for _ in range(n)]


def _gen_state(generator, mesh):
    if generator is None:
        return None
    devs = {mesh.device_of(i).type for i in mesh.local_positions()}
    if devs != {generator.device.type}:
        raise ValueError(f"generator on {generator.device} for positions "
                         f"on {sorted(devs)}")
    return bytes(generator.get_state().numpy())


def _check_batchnorm_positions(model, mesh) -> None:
    from tosem_tpu_torch.nn.layers import BatchNorm
    if not any(isinstance(m, BatchNorm) for m in model.modules()):
        return
    cards = [mesh.device_of(i) for i in mesh.local_positions()
             if mesh.device_of(i).type == "cuda"]
    if len(set(cards)) < len(cards):
        raise ValueError(
            "a mesh step over a model with BatchNorm takes one position a "
            "card: the global moments' backward meets inside each "
            "position's backward, and positions sharing a card share its "
            "one autograd thread")


def _replicated_mesh_step(model, optimizer, loss_fn, mesh, dp_axis):
    from tosem_tpu_torch.parallel.spmd import P, Sharded, shard_map
    _check_batchnorm_positions(model, mesh)
    names = [n for n, _ in model.named_parameters()]
    bnames = [n for n, _ in model.named_buffers()]
    skels = Sharded(mesh, P(), _skeletons(model, loss_fn, mesh.size))

    def body(params, buffers, batch, skel, gen_state):
        rows, axes, start, total = _batch_rows(batch, specs_of(batch),
                                               mesh)
        return _global_grads(skel, loss_fn, params, rows, axes, start,
                             total, gen_state, _device_of(params), buffers)

    def specs_of(batch):
        return {k: (P(dp_axis) if getattr(v, "ndim", 0) >= 1 else P())
                for k, v in batch.items()}

    def step(state: TrainState, batch, generator=None):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("train state holds another model or optimizer "
                             "than this step was built for")
        bspecs = specs_of({k: _global_like(v) for k, v in batch.items()})
        run = shard_map(body, mesh,
                        in_specs=({n: P() for n in names},
                                  {n: P() for n in bnames}, bspecs, P(),
                                  P()),
                        out_specs=P())
        params = dict(model.named_parameters())
        buffers = dict(model.named_buffers())
        with torch.no_grad():
            loss, grads, gen_after, bufs, means = run(
                {n: params[n].detach() for n in names},
                {n: buffers[n] for n in bnames}, batch, skels,
                _gen_state(generator, mesh))
            for n in bnames:
                buffers[n].copy_(bufs[n])
        optimizer.zero_grad(set_to_none=True)
        for n in names:
            params[n].grad = grads[n].to(params[n].device)
        optimizer.step()
        if gen_after is not None:
            generator.set_state(torch.frombuffer(bytearray(gen_after),
                                                 dtype=torch.uint8))
        state.step += 1
        return state, {"loss": loss, **means}
    return step


def _global_like(v):
    """A batch leaf's global stand-in for its spec: a Sharded leaf's
    first block (its rank is what matters)."""
    from tosem_tpu_torch.parallel.spmd import Sharded
    if isinstance(v, Sharded):
        return next(p for p in v.pieces if p is not None)
    return v


def _device_of(params: Dict[str, torch.Tensor]) -> torch.device:
    return next(iter(params.values())).device


def make_partitioned_train_step(model: nn.Module, optimizer,
                                loss_fn: Callable[..., Tuple[torch.Tensor,
                                                             Dict[str,
                                                                  Any]]],
                                *, mesh, rules, batch_rules):
    """Fully sharded train step over any named-axis mesh (tp/sp/dp):
    ``step(mesh_state, batch, generator) -> (mesh_state, metrics)`` on a
    :class:`MeshTrainState` from :func:`shard_train_state` with the same
    ``rules``, and a batch cut by ``batch_rules``
    (:func:`shard_batch_by_rules`, or plain tensors the step cuts).

    One ``shard_map``: each position gathers the parameters from their
    blocks, takes its rows of the batch (a batch cut over ``sp`` is
    gathered along the sequence and that dp shard's rows split over
    ``sp``; positions of other axes, ``tp``, repeat their rows' compute),
    computes the global loss's gradients inside the position, meets the
    positions sharing its rows' axes on them, and updates its own blocks
    with its own optimizer. The blocks' layout is the rules' after every
    step, and between steps a position holds only its blocks.
    BatchNorm takes the moments of the rows' axes (the global batch),
    and the state's ``buffers`` go in and come back updated.
    ``optimizer`` names the optimizer type the state was cut with; the
    state carries the positions' optimizers."""
    from tosem_tpu_torch.parallel.sharding import spec_for_path, _clip_spec
    from tosem_tpu_torch.parallel.spmd import (P, Sharded, all_gather,
                                               axis_index, shard_map)
    _check_batchnorm_positions(model, mesh)
    skels = Sharded(mesh, P(), _skeletons(model, loss_fn, mesh.size))

    def body(specs, bspecs, blocks, buffers, batch, opt, skel, gen_state):
        full = {}
        for n, b in blocks.items():
            t = b.detach()
            for d, e in enumerate(specs[n]):
                if e is not None:
                    t = all_gather(t, e, axis=d, tiled=True)
            full[n] = t
        rows, axes, start, total = _batch_rows(batch, bspecs, mesh)
        loss, grads, gen_after, bufs, _ = _global_grads(
            skel, loss_fn, full, rows, axes, start, total, gen_state,
            _device_of(blocks), buffers)
        opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            for n, b in blocks.items():
                g = grads[n]
                for d, e in enumerate(specs[n]):
                    if e is not None:
                        size = b.shape[d]
                        g = g.narrow(d, axis_index(e) * size, size)
                b.grad = g.contiguous()
        opt.step()
        # a block's gradient may view the full one: drop them, so that
        # between steps a position holds its blocks and moments only
        opt.zero_grad(set_to_none=True)
        return loss, gen_after, bufs

    def step(state: MeshTrainState, batch, generator=None):
        if state.mesh is not mesh:
            raise ValueError("train state is held over another mesh")
        bspecs = {k: _clip_spec(spec_for_path(k, batch_rules),
                                getattr(_global_like(v), "ndim", 0))
                  for k, v in batch.items()}
        run = shard_map(functools.partial(body, state.specs, bspecs), mesh,
                        in_specs=(state.specs,
                                  {n: P() for n in state.buffers}, bspecs,
                                  P(), P(), P()),
                        out_specs=P())
        with torch.no_grad():
            loss, gen_after, bufs = run(state.blocks, state.buffers, batch,
                                        state.optimizers, skels,
                                        _gen_state(generator, mesh))
            for n, b in state.buffers.items():
                b.copy_(bufs[n])
        if gen_after is not None:
            generator.set_state(torch.frombuffer(bytearray(gen_after),
                                                 dtype=torch.uint8))
        state.step += 1
        return state, {"loss": loss}
    return step


def fold_in(seed: int, step: int) -> int:
    """A 63-bit seed for ``step`` of a run seeded with ``seed``: the
    counterpart of ``jax.random.fold_in(rng, step)``, a function of the
    two numbers alone."""
    digest = hashlib.blake2b(f"{int(seed)}:{int(step)}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator that drives step ``step``'s randomness on
    ``device``."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, step))


def fit(state: TrainState, step_fn: Callable, batch_fn: Callable[[int], Any],
        num_steps: int, *, seed: int,
        ckpt_dir: Optional[str] = None, checkpoint_every: int = 0,
        keep: int = 3, resume: bool = True, async_save: bool = False,
        on_step: Optional[Callable[[int, Dict[str, float]], None]] = None
        ) -> Tuple[TrainState, List[Dict[str, float]]]:
    """Preemption-safe training loop: checkpoint and auto-resume.

    ``step_fn(state, batch, generator) -> (state, metrics)`` is a step
    built by :func:`make_train_step`; ``batch_fn(step) -> batch`` must be
    deterministic in ``step``. Step ``s`` draws from
    :func:`step_generator` ``(seed, s)``, so a resumed run draws the same
    dropout masks and its metric history is a bit-exact continuation
    (given kernels that are deterministic run to run).

    With ``ckpt_dir``, every ``checkpoint_every`` steps (and at the last)
    the train state and the metric history are written atomically with
    checksums (:func:`tosem_tpu_torch.train.checkpoint.save_versioned`,
    last ``keep`` kept); ``resume=True`` restores the newest valid
    checkpoint before stepping, skipping any version a preemption tore.
    With ``async_save=True`` the write runs in a background thread
    (:class:`~tosem_tpu_torch.train.checkpoint.AsyncCheckpointer`) and a
    preemption flushes it before raising.

    Chaos site ``train.step`` fires after each step's bookkeeping; action
    ``preempt`` raises :class:`TrainingPreempted`.
    """
    from tosem_tpu_torch.train import checkpoint as _ckpt
    history: List[Dict[str, float]] = []
    start = state.step
    if ckpt_dir and resume:
        found = _ckpt.restore_latest(ckpt_dir, state)
        if found is not None:
            start, state, extra = found
            history = list((extra or {}).get("history", []))
    saver = (_ckpt.AsyncCheckpointer(ckpt_dir, keep=keep)
             if ckpt_dir and async_save else None)
    for step in range(start, num_steps):
        batch = batch_fn(step)
        gen = step_generator(seed, step, state.device)
        state, metrics = step_fn(state, batch, gen)
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(metrics)
        if on_step is not None:
            on_step(step + 1, metrics)
        done = step + 1
        if ckpt_dir and checkpoint_every and \
                (done % checkpoint_every == 0 or done == num_steps):
            if saver is not None:
                # snapshot the history now: the writer must not see
                # appends from later steps
                saver.save(done, state, extra={"history": list(history)})
            else:
                _ckpt.save_versioned(ckpt_dir, done, state,
                                     extra={"history": history}, keep=keep)
        act = _chaos.fire("train.step", step=done)
        if act is not None and act["action"] == "preempt":
            if saver is not None:
                saver.flush()   # preemption: the snapshot must land now
            raise TrainingPreempted(f"training preempted after step {done}")
    if saver is not None:
        saver.flush()
    return state, history
