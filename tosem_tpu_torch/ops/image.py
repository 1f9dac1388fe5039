"""Image preprocessing: half-pixel bilinear resize, per-channel
normalisation and the letterbox.

Counterpart of ``tosem_tpu/ops/image.py`` (XLA ops there, no Pallas
kernel). Tensors keep the JAX package's ``[..., H, W, C]`` layout. The
resize is two gathers and two lerps over index and weight vectors
computed in fp32 as the JAX package computes them, so both packages take
the same source pixels and weights; the result is cast back to the
input's dtype.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _axis_indices(in_size: int, out_size: int, device):
    """Half-pixel-centre source coordinates for one axis: (lo, hi, w)."""
    scale = in_size / out_size
    src = (torch.arange(out_size, dtype=torch.float32, device=device)
           + 0.5) * scale - 0.5
    src = src.clamp(0.0, in_size - 1)
    lo = torch.floor(src).to(torch.int64)
    hi = torch.clamp(lo + 1, max=in_size - 1)
    w = src - lo.to(torch.float32)
    return lo, hi, w


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int
                    ) -> torch.Tensor:
    """Half-pixel bilinear resize of ``[..., H, W, C]`` with no
    antialiasing (``jax.image.resize(..., "bilinear", antialias=False)``)."""
    if img.ndim < 3:
        raise ValueError("expected [..., H, W, C]")
    H, W = img.shape[-3], img.shape[-2]
    ylo, yhi, wy = _axis_indices(H, out_h, img.device)
    xlo, xhi, wx = _axis_indices(W, out_w, img.device)
    f = img.float()
    top = f.index_select(-3, ylo)
    bot = f.index_select(-3, yhi)
    rows = top + (bot - top) * wy[:, None, None]      # [..., out_h, W, C]
    left = rows.index_select(-2, xlo)
    right = rows.index_select(-2, xhi)
    out = left + (right - left) * wx[:, None]
    return out.to(img.dtype)


def normalize_image(img: torch.Tensor, mean: Sequence[float],
                    std: Sequence[float], scale: float = 1.0
                    ) -> torch.Tensor:
    """Per-channel ``(img * scale - mean) / std`` in fp32."""
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=img.device)
    std_t = torch.as_tensor(std, dtype=torch.float32, device=img.device)
    return (img.float() * scale - mean_t) / std_t


def letterbox(img: torch.Tensor, size: int, pad_value: float = 0.0
              ) -> Tuple[torch.Tensor, float]:
    """Aspect-preserving resize into a ``size`` x ``size`` canvas, padded
    at the bottom and the right. Returns (canvas, scale)."""
    H, W = img.shape[-3], img.shape[-2]
    s = min(size / H, size / W)
    new_h, new_w = int(round(H * s)), int(round(W * s))
    resized = resize_bilinear(img, new_h, new_w)
    pad = (0, 0, 0, size - new_w, 0, size - new_h)
    return F.pad(resized, pad, value=pad_value), s
