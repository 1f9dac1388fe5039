"""Shared op-level helpers: matmul precision names and settings.

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


MATMUL_ENV = ("CUBLAS_WORKSPACE_CONFIG", "CUBLASLT_WORKSPACE_SIZE",
              "NVIDIA_TF32_OVERRIDE", "TORCH_BLAS_PREFER_CUBLASLT",
              "CUDA_VISIBLE_DEVICES")


def matmul_settings() -> dict:
    """This process's switches that decide how cuBLAS and cuDNN round:
    what two processes must hold equal for their products to agree bit
    for bit."""
    import os
    b = torch.backends
    out = {"tf32_matmul": b.cuda.matmul.allow_tf32,
           "tf32_cudnn": b.cudnn.allow_tf32,
           "float32_matmul_precision": torch.get_float32_matmul_precision(),
           "bf16_reduced_reduction":
               b.cuda.matmul.allow_bf16_reduced_precision_reduction,
           "fp16_reduced_reduction":
               b.cuda.matmul.allow_fp16_reduced_precision_reduction,
           "deterministic": torch.are_deterministic_algorithms_enabled(),
           "cudnn_benchmark": b.cudnn.benchmark,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "env": {k: os.environ.get(k) for k in MATMUL_ENV}}
    if hasattr(b.cuda, "preferred_blas_library"):
        out["blas"] = str(b.cuda.preferred_blas_library())
    return out


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


def pick_device(device, *xs) -> torch.device:
    """The device a tensor function runs on: ``device`` if given, else
    the device of the first tensor among ``xs``, else ``"cuda"`` (which
    raises where there is no card, as :func:`resolve_device`)."""
    if device is None:
        for x in xs:
            if isinstance(x, torch.Tensor):
                return x.device
        device = "cuda"
    return resolve_device(device)


def as_f32(x, device) -> torch.Tensor:
    """``x`` (a tensor, numpy array, sequence or number) as an fp32 tensor
    on ``device``; numpy data is copied (read-only arrays included)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    import numpy as np
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)
