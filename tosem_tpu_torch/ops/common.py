"""Shared op-level helpers: matmul precision names.

The JAX package passes a ``precision`` name to every matmul. PyTorch has
no per-call precision argument; its float32 matmul and cuDNN precisions
are process-wide switches. :func:`precision` flips both for the extent
of a ``with`` block and restores them after.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

# name -> (allow TF32 in matmul, allow TF32 in cuDNN). "float32" turns
# TF32 off for both, so an fp32 run is honest fp32 (cuDNN convolutions
# default to TF32 in PyTorch). "default" leaves the switches alone: bf16
# operands stay bf16 with fp32 accumulation either way.
PRECISION: dict = {
    "float32": (False, False),
    "tensorfloat32": (True, True),
    "default": None,
}


@contextlib.contextmanager
def precision(name: Optional[str]):
    """Run the block under the named matmul precision."""
    if name is None:
        name = "default"
    if name not in PRECISION:
        raise ValueError(f"unknown precision {name!r}; expected one of "
                         f"{sorted(PRECISION)}")
    want = PRECISION[name]
    if want is None:
        yield
        return
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = want
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` with no card
    present raises: a GPU entry point never carries on quietly on the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run the plain versions")
    return dev
