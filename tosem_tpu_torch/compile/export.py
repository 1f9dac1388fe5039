"""Export a program for a native host: ``torch.export`` and the ``.meta``
contract.

Counterpart of ``tosem_tpu/compile/export.py``'s ``export_program``,
``pattern_fill`` and ``_dtype_name``. Where the JAX package lowers a
jitted function to StableHLO (``<name>.mlir``) with XLA's compile
options (``<name>.copts``), the port writes the ``torch.export``
program:

- ``<name>.pt2``  — ``torch.export.save`` of the exported program, which
  ``torch.export.load(path).module()`` runs again;
- ``<name>.meta`` — one ``in/out <role> <dtype> [dims...]`` line an
  argument and an output, the JAX package's contract, line for line.

There is no ``.copts``: it is XLA's. Nor does a ``.pt2`` keep a
process-wide switch such as TF32 for cuDNN: a program exported from an
fp32 model runs in fp32 under ``ops.common.precision("float32")``, which
the caller sets. Roles tell a driver how to treat
each input: ``niter`` (a loop trip count), ``eps`` (a runtime-zero
feedback scalar), ``data`` (the deterministic pattern of
:func:`pattern_fill`).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

_DTYPE_NAMES = {torch.float32: "f32", torch.int32: "s32",
                torch.bfloat16: "bf16"}


def _dtype_name(dt) -> str:
    """The driver's name of a dtype (torch or numpy)."""
    if not isinstance(dt, torch.dtype):
        dt = torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype
    return _DTYPE_NAMES[dt]


def pattern_fill(shape, dtype=torch.float32) -> torch.Tensor:
    """The driver's deterministic input fill: element ``i`` is
    ``((i % 251) - 125) * 1e-3`` in fp32, then cast to ``dtype``."""
    shape = tuple(shape)
    n = int(np.prod(shape)) if shape else 1
    vals = ((np.arange(n) % 251) - 125).astype(np.float32) * 1e-3
    arr = vals.reshape(shape) if shape else vals[0]
    return torch.as_tensor(arr).to(dtype)


class _Program(nn.Module):
    """A function as a module, so ``torch.export`` can take it (the
    tensors it closes over become the program's constants)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _flat(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _flat(x)]
    raise TypeError(f"cannot export an output of type {type(tree)}")


def export_program(fn: Callable, example_args: Sequence[Any], out_dir: str,
                   name: str, roles: Optional[Sequence[str]] = None
                   ) -> Dict[str, str]:
    """Export ``fn`` (a module or a function of tensors returning a
    tensor or a tuple of them) at the example arguments' shapes and write
    ``<name>.pt2`` and ``<name>.meta`` under ``out_dir``. ``roles[i]``
    defaults to ``data``. ``torch.export.load(path).module()`` runs the
    ``.pt2`` again."""
    os.makedirs(out_dir, exist_ok=True)
    module = fn if isinstance(fn, nn.Module) else _Program(fn)
    args = tuple(example_args)
    program = torch.export.export(module, args)
    with torch.no_grad():
        outs = _flat(module(*args))
    flat_in = _flat(args)
    roles = list(roles or [])
    roles += ["data"] * (len(flat_in) - len(roles))
    lines = []
    for t, role in zip(flat_in, roles):
        dims = " ".join(str(int(d)) for d in t.shape)
        lines.append(f"in {role} {_dtype_name(t.dtype)} {dims}".rstrip())
    for t in outs:
        dims = " ".join(str(int(d)) for d in t.shape)
        lines.append(f"out data {_dtype_name(t.dtype)} {dims}".rstrip())
    paths = {"pt2": os.path.join(out_dir, f"{name}.pt2"),
             "meta": os.path.join(out_dir, f"{name}.meta")}
    torch.export.save(program, paths["pt2"])
    with open(paths["meta"], "w") as f:
        f.write("\n".join(lines) + "\n")
    return paths
