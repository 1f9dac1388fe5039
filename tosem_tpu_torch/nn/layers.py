"""Standard layers, as ``torch.nn.Module``s.

Counterpart of ``tosem_tpu/nn/layers.py``. Parameters keep the JAX
package's names and dtypes, so a converted parameter tree loads as a
``state_dict``: ``Dense`` holds ``w`` [d_in, d_out] and ``b``;
``LayerNorm`` holds ``scale`` and ``bias``; ``Embedding`` holds
``table`` [vocab, dim]. The conv layers take (N, C, H, W) tensors (the
ResNet runs them ``channels_last``) and hold ``w`` as OIHW where the JAX
package holds HWIO (``models/convert.py`` transposes); ``BatchNorm``
holds ``scale`` and ``bias`` and its moving ``mean`` and ``var`` as
buffers, the JAX package's ``state``. Every parameter is
trainable; serving entry points run under ``torch.no_grad()``. Random
init draws from a ``torch.Generator`` on the CPU, so a seed gives the
same weights on every device (not the JAX package's numbers: its PRNG
differs). Dropout masks are drawn on the activation's device.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tosem_tpu_torch.ops.common import precision as _precision
from tosem_tpu_torch.ops.conv import conv2d_nchw, pad_same


def _trunc_normal(shape, std, dtype, generator):
    """Normal truncated at +-2 std, drawn in fp32 then cast."""
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)
    return t.to(dtype)


def _he_normal(shape, fan_in, dtype, generator):
    t = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (t * math.sqrt(2.0 / fan_in)).to(dtype)


class Dense(nn.Module):
    """``y = x @ w + b`` with ``w`` [d_in, d_out]."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = True,
                 dtype=torch.float32, precision: str = "default",
                 init_std: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_in, self.d_out, self.precision = d_in, d_out, precision
        if init_std is None:
            w = _he_normal((d_in, d_out), d_in, dtype, generator)
        else:
            w = _trunc_normal((d_in, d_out), init_std, dtype, generator)
        self.w = nn.Parameter(w)
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype)) if bias
                  else None)

    def forward(self, x):
        with _precision(self.precision):
            y = torch.matmul(x, self.w)
        if self.b is not None:
            y = y + self.b
        return y


class LayerNorm(nn.Module):
    """Statistics in fp32, normalised value cast to the INPUT dtype, and
    only then the scale and bias (in that dtype) — the JAX package's
    order, which differs from a fused fp32 affine in bf16.

    ``forward`` takes its statistics as the JAX package writes them, a
    ``mean`` over the last dim, whose reduction torch splits by the row
    count. :meth:`rows` is the same normalisation with the statistics of
    ``F.layer_norm`` (no affine), one reduction layout a row (one block a
    row on the card), so a row gets the same bits however many rows share
    the call: the decode steps use it, so a speculative step's rows equal
    greedy's."""

    def __init__(self, dim: int, *, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return y.to(x.dtype) * self.scale + self.bias

    def rows(self, x):
        # Debt: this second form (and the ``per_row`` flag that routes the
        # decode steps here) exists only because the sparse encode's
        # parity limit (chip_smoke.py's encode_sparse) sits below what the
        # encoder reads with these statistics. Once that limit is set
        # again from its readings (ROADMAP.md C3), ``forward`` takes this
        # form and the flag goes.
        y = F.layer_norm(x.float(), (self.dim,), None, None, self.eps)
        return y.to(x.dtype) * self.scale + self.bias


class Conv2D(nn.Module):
    """(N, C, H, W) x OIHW conv, SAME (XLA's, asymmetric where the total
    is odd) or VALID padding."""

    def __init__(self, c_in: int, c_out: int, kernel: Tuple[int, int],
                 stride: int = 1, *, padding: str = "SAME", bias: bool = False,
                 dtype=torch.float32, precision: str = "default",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = kernel
        self.stride, self.padding, self.precision = stride, padding, precision
        self.w = nn.Parameter(_he_normal((c_out, c_in, kh, kw),
                                         kh * kw * c_in, dtype, generator))
        self.b = (nn.Parameter(torch.zeros(c_out, dtype=dtype)) if bias
                  else None)

    def forward(self, x):
        y = conv2d_nchw(x, self.w, self.stride, padding=self.padding,
                        precision=self.precision)
        if self.b is not None:
            y = y + self.b[:, None, None]
        return y


class DepthwiseConv2D(nn.Module):
    """Per-channel conv (``groups = C``), weight [C, 1, kh, kw]."""

    def __init__(self, channels: int, kernel: Tuple[int, int],
                 stride: int = 1, *, padding: str = "SAME",
                 dtype=torch.float32, precision: str = "default",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = kernel
        self.channels = channels
        self.stride, self.padding, self.precision = stride, padding, precision
        self.w = nn.Parameter(_he_normal((channels, 1, kh, kw), kh * kw,
                                         dtype, generator))

    def forward(self, x):
        return conv2d_nchw(x, self.w, self.stride, padding=self.padding,
                           groups=self.channels, precision=self.precision)


_MOMENTS = threading.local()


@contextlib.contextmanager
def batch_moments_over(axes: Sequence[str]):
    """Inside a position of a mesh step: BatchNorm in training takes its
    moments over the rows of every position along ``axes`` (the global
    batch's, as BatchNorm in the JAX package's jitted global step), not
    over this position's rows alone."""
    old = getattr(_MOMENTS, "axes", None)
    _MOMENTS.axes = tuple(axes) or None
    try:
        yield
    finally:
        _MOMENTS.axes = old


class _GlobalMoments(torch.autograd.Function):
    """(mean, biased var) per channel over the rows of every position of
    ``axes``: the forward is one meeting (each position's count, sum and
    centred sum of squares, combined in position order), the backward
    another (the positions' gradients of mean and var, summed). The
    positions' backwards must each run on their own thread: CPU
    positions, or one position a card."""

    @staticmethod
    def forward(ctx, xf, dims, axes):
        from tosem_tpu_torch.parallel.spmd import all_gather
        x = xf.detach()
        n = float(np.prod([x.shape[d] for d in dims]))
        s = x.sum(dims)
        m2 = (x - _bcast(s / n, dims, x)).square().sum(dims)
        parts = all_gather(torch.stack([torch.full_like(s, n), s, m2]),
                           axes)
        counts, sums, m2s = parts[:, 0], parts[:, 1], parts[:, 2]
        total = counts.sum(0)
        mean = sums.sum(0) / total
        var = (m2s + counts * (sums / counts - mean).square()).sum(0) / total
        ctx.save_for_backward(x, mean, total)
        ctx.dims, ctx.axes = dims, axes
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        from tosem_tpu_torch.parallel.spmd import psum
        x, mean, total = ctx.saved_tensors
        g = psum(torch.stack([g_mean, g_var]), ctx.axes)
        dx = _bcast(g[0] / total, ctx.dims, x) \
            + _bcast(2.0 * g[1] / total, ctx.dims, x) \
            * (x - _bcast(mean, ctx.dims, x))
        return dx, None, None


def _bcast(v, dims, x):
    """A per-channel vector shaped to broadcast against ``x`` reduced
    over ``dims``."""
    return v.reshape([1 if d in dims else n for d, n in enumerate(x.shape)])


class BatchNorm(nn.Module):
    """Batch normalization over dim 1 of (N, C, ...) with moving stats.

    In training the moments are the batch's, in fp32, the variance the
    biased one (``jnp.var``); the moving ``mean`` and ``var`` (fp32
    buffers, the JAX package's ``state``) update in place as
    ``momentum * old + (1 - momentum) * batch``. ``F.batch_norm`` is not
    used: its ``momentum`` is the complement and it updates the moving
    variance with the unbiased one. The normalised value is cast to the
    parameters' dtype before scale and bias, as in the JAX package.
    Inside :func:`batch_moments_over` the moments are the global batch's
    (:class:`_GlobalMoments`)."""

    def __init__(self, dim: int, *, momentum: float = 0.9, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.dim, self.momentum, self.eps, self.dtype = dim, momentum, eps, \
            dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype))
        self.register_buffer("mean", torch.zeros(dim, dtype=torch.float32))
        self.register_buffer("var", torch.ones(dim, dtype=torch.float32))

    def forward(self, x, *, train: bool = False):
        xf = x.float()
        dims = (0,) + tuple(range(2, x.ndim))
        if train:
            axes = getattr(_MOMENTS, "axes", None)
            if axes:
                mean, var = _GlobalMoments.apply(xf, dims, axes)
            else:
                mean = xf.mean(dims)
                var = (xf - _bcast(mean, dims, xf)).square().mean(dims)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean.detach())
                self.var.copy_(m * self.var + (1 - m) * var.detach())
        else:
            mean, var = self.mean, self.var
        y = (xf - _bcast(mean, dims, xf)) * _bcast(
            torch.rsqrt(var + self.eps), dims, xf)
        y = y.to(self.scale.dtype) * _bcast(self.scale, dims, xf) \
            + _bcast(self.bias, dims, xf)
        return y.to(x.dtype)


def max_pool(x, window: int, stride: int, padding: str = "SAME"):
    """Max over ``window`` x ``window`` of (N, C, H, W); SAME pads with
    -inf as XLA does (asymmetric where the total is odd)."""
    pad = (0, 0)
    if padding == "SAME":
        x, pad = pad_same(x, window, window, stride, value=-math.inf)
    return F.max_pool2d(x, window, stride, padding=pad)


def avg_pool_global(x):
    """Mean over the spatial dims of (N, C, H, W): [N, C]."""
    return x.mean(dim=(2, 3))


def relu(x):
    return F.relu(x)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, *, dtype=torch.float32,
                 init_std: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab, self.dim = vocab, dim
        self.table = nn.Parameter(
            _trunc_normal((vocab, dim), init_std, dtype, generator))

    def forward(self, ids):
        """Row gather. Ids must lie in [0, vocab): torch raises where
        ``jnp.take`` would clamp, so callers validate first."""
        return F.embedding(ids, self.table)

    def attend(self, x):
        """Logits against the table (tied softmax head). The table is
        promoted to ``x``'s dtype first, as JAX promotes a bf16 table
        against fp32 encodings."""
        table = self.table.to(torch.promote_types(x.dtype, self.table.dtype))
        return torch.matmul(x, table.t())


@dataclass(frozen=True)
class RowSlice:
    """A generator for rows ``[start, start + rows)`` of a batch of
    ``batch`` rows: a dropout mask is drawn for the whole batch and these
    rows are kept, so a position of a mesh step draws the masks the
    unsharded step draws for its rows (as a sharded JAX program draws
    the global masks)."""
    generator: Optional[torch.Generator]
    start: int
    batch: int


def base_generator(generator):
    """The ``torch.Generator`` behind ``generator`` (a
    :class:`RowSlice`'s, or itself)."""
    return generator.generator if isinstance(generator, RowSlice) \
        else generator


class Dropout(nn.Module):
    """``where(mask, x / keep, 0)`` with ``keep = 1 - rate``, as the JAX
    package computes it. The mask is drawn on ``x.device`` from
    ``generator``, which must live on that device (None = the device's
    default generator), or for a :class:`RowSlice`'s rows of the whole
    batch."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        if not train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        if isinstance(generator, RowSlice):
            full = torch.rand((generator.batch,) + tuple(x.shape[1:]),
                              generator=generator.generator, device=x.device)
            mask = full.narrow(0, generator.start, x.shape[0]) < keep
        else:
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")
