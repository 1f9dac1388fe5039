"""Standard layers, as ``torch.nn.Module``s.

Counterpart of ``tosem_tpu/nn/layers.py`` (the layers the BERT path
uses). Parameters keep the JAX package's names, shapes and dtypes, so a
converted parameter tree loads as a ``state_dict``: ``Dense`` holds
``w`` [d_in, d_out] and ``b``; ``LayerNorm`` holds ``scale`` and
``bias``; ``Embedding`` holds ``table`` [vocab, dim]. Every parameter is
trainable; serving entry points run under ``torch.no_grad()``. Random
init draws from a ``torch.Generator`` on the CPU, so a seed gives the
same weights on every device (not the JAX package's numbers: its PRNG
differs). Dropout masks are drawn on the activation's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tosem_tpu_torch.ops.common import precision as _precision


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
