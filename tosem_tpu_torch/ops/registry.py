"""Kernel-backend registry: which lowering serves a call, and how often
each kernel launched.

Two kernel families, each with two backends:

- ``cuda`` — the hand-written CUDA C++ kernel for ``sm_90a``
  (``ops/csrc``). Runs on CUDA tensors only, in fp32 or bf16.
- ``torch`` — the plain PyTorch version of the same computation. Runs on
  CPU tensors only: it is what the CPU tests exercise and what
  ``chip_smoke.py`` holds each kernel against on the card.

Each backend of a family takes every mode of it, so the platform of the
operands and their dtype decide everything. Resolution is strict: a CUDA
tensor resolves to ``cuda`` or raises :class:`BackendUnavailable`, and
nothing falls back silently to the plain version. The one counted
fallback left is in :func:`tosem_tpu_torch.nn.attention.flash_attn_fn`,
for dense masks that no kernel mode covers (:data:`FALLBACK_COUNTS`).

:data:`LAUNCH_COUNTS` holds one plain integer per kernel; each wrapper
adds one where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional

FAMILIES = ("flash", "paged")

BACKEND_CUDA = "cuda"
BACKEND_TORCH = "torch"

# backend -> the one platform it runs on
_PLATFORM = {BACKEND_CUDA: "cuda", BACKEND_TORCH: "cpu"}
_CUDA_DTYPES = ("float32", "bfloat16")

# kernel name -> launches since the last reset
LAUNCH_COUNTS: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dkv": 0,
                                 "flash_bwd_dq": 0, "paged_decode": 0,
                                 "paged_decode_multi": 0}

# "family:requested->served" for the dense-mask fallback of flash_attn_fn
FALLBACK_COUNTS: "collections.Counter[str]" = collections.Counter()


class BackendUnavailable(ValueError):
    """No registered lowering can serve the request."""


def platform_of(tensor) -> str:
    """``"cuda"`` or ``"cpu"``: where a tensor's kernels must run."""
    kind = tensor.device.type
    if kind not in _PLATFORM.values():
        raise BackendUnavailable(f"no kernels for device type {kind!r}")
    return kind


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def resolve(family: str, backend: Optional[str] = None, *,
            platform: str, dtype: Optional[str] = None) -> str:
    """The backend that serves this call. With no ``backend`` it is the
    platform's own (``cuda`` for CUDA tensors, ``torch`` for CPU
    tensors); an explicit ``backend`` must run on ``platform``, or this
    raises. Never falls back."""
    if family not in FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}; expected "
                         f"one of {FAMILIES}")
    if backend is None:
        backend = BACKEND_CUDA if platform == "cuda" else BACKEND_TORCH
    if backend not in _PLATFORM:
        raise BackendUnavailable(
            f"unknown {family} backend {backend!r}; expected one of "
            f"{sorted(_PLATFORM)}")
    if _PLATFORM[backend] != platform:
        raise BackendUnavailable(
            f"{family}:{backend} runs on {_PLATFORM[backend]} tensors, "
            f"not {platform}")
    if (backend == BACKEND_CUDA and dtype is not None
            and dtype not in _CUDA_DTYPES):
        raise BackendUnavailable(
            f"{family}:{backend} takes {_CUDA_DTYPES}, not {dtype}")
    return backend


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
