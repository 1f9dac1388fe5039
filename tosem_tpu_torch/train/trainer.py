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
(``mesh=``, ``shard_batch``, ``make_partitioned_train_step``) compute
the global step over a mesh and are not ported yet (``ROADMAP.md``
A10's remainder: global-semantics mesh training), nor is
``classification_loss`` (it waits for ResNet, A12).
"""
from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from tosem_tpu_torch.chaos import hooks as _chaos


class TrainingPreempted(RuntimeError):
    """The training process was preempted mid-run (chaos ``train.step``
    ``preempt`` action, or raised by user code on a SIGTERM notice). A
    :func:`fit` with the same ``ckpt_dir`` resumes from the latest atomic
    checkpoint with a bit-exact metric history."""


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


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
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Token-level cross entropy in fp32; ``weights`` (same shape as
    labels) restricts the average to selected positions (e.g. MLM
    masks)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    if weights is None:
        return -ll.mean()
    w = weights.float()
    return -(ll * w).sum() / torch.clamp(w.sum(), min=1.0)


def mlm_loss(model, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, *, attn_fn=None):
    """Masked-LM loss for BERT-style batches.

    Batch keys: ``ids`` (with mask tokens substituted), ``labels``
    (original tokens), optional ``mask`` (attention mask) and ``masked``
    (which positions were masked). The loss averages only over masked
    positions, or over all of them when ``masked`` is absent (plain LM).
    ``attn_fn`` (e.g. ``flash_attn_fn()``) is bound with
    ``functools.partial``."""
    enc = model.apply(batch["ids"], mask=batch.get("mask"), train=True,
                      attn_fn=attn_fn, generator=generator)
    logits = model.mlm_logits(enc)
    return cross_entropy_loss(logits, batch["labels"],
                              batch.get("masked")), {}


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable[..., Tuple[torch.Tensor,
                                                 Dict[str, Any]]],
                    *, mesh=None):
    """``step(state, batch, generator) -> (state, metrics)``: one
    forward, backward and optimizer update, in place. ``state`` must hold
    this ``model`` and ``optimizer`` (so its checkpoints are theirs);
    ``metrics`` holds the loss (a 0-d tensor, not synchronised) and the
    loss function's aux values."""
    if mesh is not None:
        raise _not_ported("train steps over a device mesh (mesh=)",
                          "A10's remainder: global-semantics mesh training")

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


def make_partitioned_train_step(*args, **kwargs):
    raise _not_ported("partitioned (tp/sp/dp) train steps",
                      "A10's remainder: global-semantics mesh training")


def shard_batch(*args, **kwargs):
    raise _not_ported("batch sharding over a mesh",
                      "A10's remainder: global-semantics mesh training")


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
