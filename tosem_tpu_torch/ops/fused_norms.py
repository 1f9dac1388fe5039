"""Fused layernorm and row softmax, forward and backward: the CUDA kernels
and their plain versions.

Counterpart of ``tosem_tpu/ops/fused_norms.py``, the second half of
north-star config 5 (the BERT kernel suite). :func:`fused_layernorm` and
:func:`fused_softmax` are ``torch.autograd.Function``\\ s, the counterparts
of the two ``custom_vjp``\\ s: the layernorm saves the flattened x, gamma
and the fp32 row statistics (mu, rstd), the softmax saves its output y in
the output dtype, and both passes route by the operands' device. On CUDA
tensors they launch ``csrc/fused_norms.cu`` (B6 ``ln_fwd``, B7 ``ln_bwd``,
B8 ``sm_fwd``, B9 ``sm_bwd``; B6, B7 and B8 in the body
:func:`_row_body` picks); on CPU tensors the plain versions
(``_ln_fwd_torch``, ``_ln_bwd_torch``, ``_sm_fwd_torch``,
``_sm_bwd_torch``), which follow the Pallas kernel bodies step for step.
There is no fallback from one to the other.

Both ops flatten their input to ``[rows, last dim]``. mu and rstd are
``[rows, 1]`` fp32 as in the JAX package. The layernorm applies its
affine in fp32 and then casts, unlike ``nn/layers.LayerNorm`` (cast,
then affine), so no model calls it (``ROADMAP.md`` C-ref3).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tosem_tpu_torch.ops import _build, registry

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# B7's dgamma/dbeta partials: at most this many fp32 rows of sums. The
# block body writes one per ceil(R / parts) rows (fixed by R alone, so the
# sum order is too); the warp-row body one per block of its grid
_LN_BWD_PARTS = 512
# B7 keeps 2 * D fp32 sums in shared memory: 229,376 bytes at this width
_LN_MAX_D = 28672
# B6, B7 and B8's warp-row body: 16-byte vectors, rows of at most this
# many elements (32 values a lane; B7's fp32 body at 1024 holds x, dy,
# the next row, gamma and two column sums in 255 registers, unspilled)
_VEC_BYTES = 16
_WARP_ROW_MAX = 1024

_ARGTYPES = {
    "ln_fwd": ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
               + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]),
    "ln_bwd": ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
               + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "sm_fwd": ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
               + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
    "sm_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
               + [ctypes.c_void_p]),
}


# ---------------------------------------------------------------- plain


def _ln_fwd_torch(x2, gamma, beta, eps):
    """Plain version of ``_ln_fwd_kernel``: ``(y, mu, rstd)`` of ``x2``
    ``[R, D]``; y in x's dtype, mu and rstd ``[R, 1]`` fp32."""
    x = x2.float()
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd
    out = (y * gamma.float() + beta.float()).to(x2.dtype)
    return out, mu, rstd


def _ln_bwd_torch(x2, gamma, mu, rstd, dy2):
    """Plain version of ``_ln_bwd_kernel`` and the sum of its partials:
    ``(dx, dgamma, dbeta)``, dx in x's dtype, dgamma and dbeta summed in
    fp32 and cast to gamma's dtype."""
    x = x2.float()
    g = gamma.float()
    dy = dy2.float()
    xhat = (x - mu) * rstd
    wdy = dy * g
    c1 = wdy.mean(-1, keepdim=True)
    c2 = (wdy * xhat).mean(-1, keepdim=True)
    dx = (wdy - c1 - xhat * c2) * rstd
    dg = (dy * xhat).sum(0)
    db = dy.sum(0)
    return dx.to(x2.dtype), dg.to(gamma.dtype), db.to(gamma.dtype)


def _sm_fwd_torch(x2):
    """Plain version of ``_sm_fwd_kernel``: the row softmax in fp32 with
    the row max subtracted, in x's dtype."""
    x = x2.float()
    m = x.amax(-1, keepdim=True)
    e = torch.exp(x - m)
    return (e / e.sum(-1, keepdim=True)).to(x2.dtype)


def _sm_bwd_torch(y2, dy2):
    """Plain version of ``_sm_bwd_kernel``: dx = y * (dy - sum(y * dy)),
    from y in its own dtype, dx in y's dtype."""
    y = y2.float()
    dy = dy2.float()
    inner = (y * dy).sum(-1, keepdim=True)
    return (y * (dy - inner)).to(y2.dtype)


# ---------------------------------------------------------------- CUDA


def _kernel(name):
    fn = getattr(_build.load("fused_norms"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(what, first, *others):
    """Every operand a contiguous fp32/bf16 CUDA tensor on one device."""
    for x in (first,) + others:
        if x.device.type != "cuda" or x.device != first.device:
            raise ValueError(f"{what} takes CUDA tensors on one device; got "
                             f"{x.device} beside {first.device}")
        if x.dtype not in _DTYPE_CODE:
            raise TypeError(f"{what} takes float32/bfloat16, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{what} needs contiguous operands")
    if first.numel() == 0:
        raise ValueError(f"{what} got an empty operand")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _row_body(n, dtype, *ptrs):
    """The body of B6, B7 or B8 for rows of ``n`` elements of ``dtype``
    over operands at the addresses ``ptrs`` (every input's and output's
    ``data_ptr()``, gamma's included), chosen before launch from these
    alone: ``("warp", V)``, one warp a row held in registers as V
    16-byte vectors a lane, when a row is a whole number of vectors, at
    most :data:`_WARP_ROW_MAX` wide, and every operand is 16-byte
    aligned; else ``("block", 0)``, one block a row (B7: a block of
    rows), which takes any row."""
    per_vec = _VEC_BYTES // dtype.itemsize
    if (n % per_vec or n > _WARP_ROW_MAX
            or any(p % _VEC_BYTES for p in ptrs)):
        return "block", 0
    return "warp", -(-n // (32 * per_vec))


def _ln_fwd_cuda(x2, gamma, beta, eps):
    """Launch B6 ``ln_fwd``. Returns ``(y, mu, rstd)`` as the plain
    version does."""
    _check("ln_fwd", x2, gamma, beta)
    R, D = x2.shape
    if gamma.shape != (D,) or beta.shape != (D,) or beta.dtype != gamma.dtype:
        raise ValueError(f"gamma and beta must be [{D}] of one dtype")
    y = torch.empty_like(x2)
    mu = torch.empty((R, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty((R, 1), dtype=torch.float32, device=x2.device)
    _, vecs = _row_body(D, x2.dtype, x2.data_ptr(), gamma.data_ptr(),
                        beta.data_ptr(), y.data_ptr())
    code = _kernel("ln_fwd")(
        _DTYPE_CODE[x2.dtype], _DTYPE_CODE[gamma.dtype], vecs,
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), R, D, float(eps), _stream(x2))
    _build.check(code, "ln_fwd")
    registry.count_launch("ln_fwd")
    return y, mu, rstd


def _ln_bwd_cuda(x2, gamma, mu, rstd, dy2):
    """Launch B7 ``ln_bwd`` (dx and per-block dgamma/dbeta partials, then
    their fixed-order sum) in the body :func:`_row_body` picks.
    Returns ``(dx, dgamma, dbeta)`` as the plain version does."""
    _check("ln_bwd", x2, gamma, dy2)
    _check("ln_bwd", mu, rstd)
    R, D = x2.shape
    if gamma.shape != (D,) or dy2.shape != x2.shape or dy2.dtype != x2.dtype:
        raise ValueError(f"ln_bwd: gamma must be [{D}] and dy {x2.dtype} "
                         f"{tuple(x2.shape)}")
    for name, s in (("mu", mu), ("rstd", rstd)):
        if s.dtype != torch.float32 or s.numel() != R:
            raise ValueError(f"{name} must be float32 with {R} rows")
    if D > _LN_MAX_D:
        raise ValueError(f"ln_bwd takes rows of at most {_LN_MAX_D}, got {D}")
    n_parts = min(R, _LN_BWD_PARTS)
    dx = torch.empty_like(x2)
    parts = torch.empty((2, n_parts, D), dtype=torch.float32,
                        device=x2.device)
    dg = torch.empty((D,), dtype=gamma.dtype, device=x2.device)
    db = torch.empty((D,), dtype=gamma.dtype, device=x2.device)
    _, vecs = _row_body(D, x2.dtype, x2.data_ptr(), gamma.data_ptr(),
                        dy2.data_ptr(), dx.data_ptr())
    code = _kernel("ln_bwd")(
        _DTYPE_CODE[x2.dtype], _DTYPE_CODE[gamma.dtype], vecs,
        x2.data_ptr(), gamma.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        dy2.data_ptr(), dx.data_ptr(), parts[0].data_ptr(),
        parts[1].data_ptr(), dg.data_ptr(), db.data_ptr(), R, D, n_parts,
        _stream(x2))
    _build.check(code, "ln_bwd")
    registry.count_launch("ln_bwd")
    return dx, dg, db


def _sm_fwd_cuda(x2):
    """Launch B8 ``sm_fwd``. Returns y in x's dtype."""
    _check("sm_fwd", x2)
    R, N = x2.shape
    y = torch.empty_like(x2)
    _, vecs = _row_body(N, x2.dtype, x2.data_ptr(), y.data_ptr())
    code = _kernel("sm_fwd")(_DTYPE_CODE[x2.dtype], vecs, x2.data_ptr(),
                             y.data_ptr(), R, N, _stream(x2))
    _build.check(code, "sm_fwd")
    registry.count_launch("sm_fwd")
    return y


def _sm_bwd_cuda(y2, dy2):
    """Launch B9 ``sm_bwd``. Returns dx in y's dtype."""
    _check("sm_bwd", y2, dy2)
    if dy2.shape != y2.shape or dy2.dtype != y2.dtype:
        raise ValueError(f"sm_bwd: dy must be {y2.dtype} {tuple(y2.shape)}")
    R, N = y2.shape
    dx = torch.empty_like(y2)
    code = _kernel("sm_bwd")(_DTYPE_CODE[y2.dtype], y2.data_ptr(),
                             dy2.data_ptr(), dx.data_ptr(), R, N,
                             _stream(y2))
    _build.check(code, "sm_bwd")
    registry.count_launch("sm_bwd")
    return dx


# ---------------------------------------------------------------- autograd


class _LayerNormFn(torch.autograd.Function):
    """``fused_layernorm`` with its backward: the counterpart of the JAX
    package's ``custom_vjp``. ``cuda`` picks B6/B7 (CUDA tensors) or the
    plain versions (CPU tensors) for both passes."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, cuda):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        fwd = _ln_fwd_cuda if cuda else _ln_fwd_torch
        out, mu, rstd = fwd(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mu, rstd)
        ctx.cuda = cuda
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, mu, rstd = ctx.saved_tensors
        # autograd may hand over an expanded or strided gradient
        dy2 = dy.reshape(x2.shape).to(x2.dtype).contiguous()
        bwd = _ln_bwd_cuda if ctx.cuda else _ln_bwd_torch
        dx, dg, db = bwd(x2, gamma, mu, rstd, dy2)
        return dx.reshape(dy.shape), dg, db, None, None


class _SoftmaxFn(torch.autograd.Function):
    """``fused_softmax`` with its backward, from the saved output y."""

    @staticmethod
    def forward(ctx, x, cuda):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y = (_sm_fwd_cuda if cuda else _sm_fwd_torch)(x2)
        ctx.save_for_backward(y)
        ctx.cuda = cuda
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        dy2 = dy.reshape(y.shape).to(y.dtype).contiguous()
        dx = (_sm_bwd_cuda if ctx.cuda else _sm_bwd_torch)(y, dy2)
        return dx.reshape(dy.shape), None


def _served(x, backend):
    return registry.resolve("norms", backend,
                            platform=registry.platform_of(x),
                            dtype=registry.dtype_name(x.dtype))


def fused_layernorm(x, gamma, beta, eps: float = 1e-6, *,
                    backend: Optional[str] = None):
    """LayerNorm over the last dim of ``x`` ``[..., D]``: fp32 statistics,
    the affine in fp32, the output in x's dtype. ``backend`` is
    ``"cuda"`` or ``"torch"`` (None = the operands' platform) and must
    match where ``x`` lives."""
    cuda = _served(x, backend) == registry.BACKEND_CUDA
    return _LayerNormFn.apply(x, gamma, beta, float(eps), cuda)


def fused_softmax(x, *, backend: Optional[str] = None):
    """Numerically stable softmax over the last dim, in x's dtype."""
    cuda = _served(x, backend) == registry.BACKEND_CUDA
    return _SoftmaxFn.apply(x, cuda)
