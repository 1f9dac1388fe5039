"""Flash attention forward and backward: the CUDA kernels and their
plain versions.

Counterpart of ``tosem_tpu/ops/flash_attention.py``. :func:`flash_attention`
takes ``[B, H, T, D]`` (``layout="bhtd"``) or ``[B, T, H, D]``
(``layout="bthd"``) operands and returns the same layout. On CUDA tensors
it launches ``csrc/flash_fwd.cu`` (the port of the Pallas ``_fwd_kernel``);
on CPU tensors it runs :func:`_flash_attention_torch`, the plain version
that mirrors the JAX package's ``_flash_attention_xla``. There is no
fallback from one to the other.

When an operand requires grad, the call goes through :class:`_FlashFn`,
the counterpart of the JAX package's ``custom_vjp``: it saves q, k, v,
the output, the LSE and the segment ids, and its backward routes by
device as the forward does. On CUDA tensors the backward computes
Delta = rowsum(dO * O) in torch and launches ``csrc/flash_bwd.cu``
(``flash_bwd_dkv``, the port of ``_bwd_dkv_kernel``, then
``flash_bwd_dq``, the port of ``_bwd_dq_kernel``); on CPU tensors it runs
:func:`_flash_bwd_torch`. Segment ids get no gradient.

Modes: dense, ``causal`` (key position <= query position, top-left
aligned) and :class:`SegmentIds` (attend where the ids are equal; a
key-padding mask is ``SegmentIds(q=ones, kv=mask)``), in any
combination, forward and backward. The kernels mask a ragged edge
themselves, so no sequence length has to tile. Block-sparse mask
programs (``mask=``/``programs=`` in the JAX package) are not ported yet
(``ROADMAP.md`` A4, B1's schedule mode).

Both arms also return the per-row log-sum-exp ``[B, H, Tq]`` fp32
(``return_lse=True``); the backward reads it.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from tosem_tpu_torch.ops import _build, registry

_NEG_INF = -1e30
_KERNEL_D = (16, 32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class SegmentIds(NamedTuple):
    """Per-token segment ids gating attention to equal ids: ``q`` [B, Tq]
    and ``kv`` [B, Tk] int32. A row whose id appears nowhere in ``kv``
    gives finite garbage (as in the JAX package)."""
    q: torch.Tensor
    kv: torch.Tensor


def _to_bthd(x, layout):
    if layout == "bthd":
        return x
    if layout == "bhtd":
        return x.transpose(1, 2)
    raise ValueError(f"unknown layout {layout!r}")


def _dims(x, layout):
    """(B, T, H, d) of an operand in the given layout."""
    if layout == "bhtd":
        B, H, T, d = x.shape
    else:
        B, T, H, d = x.shape
    return B, T, H, d


def _visible(segment_ids, causal, Tq, Tk, device):
    """``[B|1, 1, Tq, Tk]`` bool of the (query, key) pairs a mode lets
    through, or None when every pair is visible (dense)."""
    keep = None
    if causal:
        rows = torch.arange(Tq, device=device)[:, None]
        cols = torch.arange(Tk, device=device)[None, :]
        keep = (rows >= cols)[None, None]
    if segment_ids is not None:
        seg = (segment_ids.q.to(torch.int32)[:, :, None]
               == segment_ids.kv.to(torch.int32)[:, None, :])[:, None]
        keep = seg if keep is None else keep & seg
    return keep


def _scores(qb, kb, segment_ids, causal, sm_scale):
    """fp32 scaled scores ``[B, H, Tq, Tk]`` of bthd operands, masked
    scores at -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kb.float()) * sm_scale
    keep = _visible(segment_ids, causal, qb.shape[1], kb.shape[1], qb.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    return s


def _from_bthd(x, layout):
    return (x.transpose(1, 2) if layout == "bhtd" else x).contiguous()


def _flash_attention_torch(q, k, v, segment_ids, causal, sm_scale, layout):
    """Plain PyTorch version: one dense masked softmax. Scores are fp32
    products of the input-dtype operands, the probabilities are cast to
    the value dtype before the PV product, masked scores are -1e30.
    Returns ``(out, lse)``."""
    qb, kb, vb = (_to_bthd(x, layout) for x in (q, k, v))
    s = _scores(qb, kb, segment_ids, causal, sm_scale)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    w = (e / l).to(vb.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w.float(), vb.float()).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    return _from_bthd(out, layout), lse


def _bwd_delta(do, out, layout):
    """Delta = rowsum(dO * O) in fp32, ``[B, H, Tq]`` (the JAX package
    computes it in XLA, outside its kernels)."""
    delta = (do.float() * out.float()).sum(-1)
    if layout == "bthd":
        delta = delta.transpose(1, 2)                 # [B, Tq, H] -> [B, H, Tq]
    return delta.contiguous()


def _bwd_probs(q, k, lse, segment_ids, causal, sm_scale, layout):
    """p = exp(s - LSE) in fp32, ``[B, H, Tq, Tk]``; 0 where masked."""
    qb, kb = _to_bthd(q, layout), _to_bthd(k, layout)
    return torch.exp(_scores(qb, kb, segment_ids, causal, sm_scale)
                     - lse[..., None])


def _flash_bwd_dkv_torch(q, k, v, do, lse, delta, segment_ids, causal,
                         sm_scale, layout):
    """Plain version of ``_bwd_dkv_kernel``: dV = sum_q bf(p) dO and
    dK = sum_q bf(p (dO.v - Delta) scale) q, bf() rounding to the input
    dtype as the reference casts before its dots. Returns ``(dk, dv)``."""
    p = _bwd_probs(q, k, lse, segment_ids, causal, sm_scale, layout)
    qf, vf, dof = (_to_bthd(x, layout).float() for x in (q, v, do))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * sm_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qf)
    return (_from_bthd(dk.to(k.dtype), layout),
            _from_bthd(dv.to(v.dtype), layout))


def _flash_bwd_dq_torch(q, k, v, do, lse, delta, segment_ids, causal,
                        sm_scale, layout):
    """Plain version of ``_bwd_dq_kernel``: dQ = scale * sum_k
    bf(p (dO.v - Delta)) k, the scale applied after the sum."""
    p = _bwd_probs(q, k, lse, segment_ids, causal, sm_scale, layout)
    kf, vf, dof = (_to_bthd(x, layout).float() for x in (k, v, do))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(), kf)
    return _from_bthd((dq * sm_scale).to(q.dtype), layout)


def _flash_bwd_torch(q, k, v, out, lse, do, segment_ids, causal, sm_scale,
                     layout):
    """Plain PyTorch backward: Delta, then the plain versions of the two
    kernels. Returns ``(dq, dk, dv)`` in the operands' layout."""
    delta = _bwd_delta(do, out, layout)
    dk, dv = _flash_bwd_dkv_torch(q, k, v, do, lse, delta, segment_ids,
                                  causal, sm_scale, layout)
    dq = _flash_bwd_dq_torch(q, k, v, do, lse, delta, segment_ids, causal,
                             sm_scale, layout)
    return dq, dk, dv


_ARGTYPES = {
    "flash_fwd": ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
                  + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "flash_bwd_dq": ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9
                     + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 15
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "flash_bwd_dkv": ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10
                      + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 18
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
}


def _kernel(source, name):
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _strides(x, layout):
    if layout == "bthd":
        return x.stride(0), x.stride(1), x.stride(2)
    return x.stride(0), x.stride(2), x.stride(1)


def _check_operands(q, k, v, segment_ids, layout):
    """Validate what the kernels take; returns ``(B, Tq, Tk, H, d, qseg,
    kseg)`` with the segment-id pointers' tensors (or None)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} dtype {x.dtype} != q dtype {q.dtype}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous head dimension")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernel takes float32/bfloat16, got {q.dtype}")
    B, Tq, H, d = _dims(q, layout)
    Bk, Tk, Hk, dk = _dims(k, layout)
    if (Bk, Hk, dk) != (B, H, d) or _dims(v, layout) != (B, Tk, H, d):
        raise ValueError(f"q/k/v shapes disagree: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} ({layout})")
    if d not in _KERNEL_D:
        raise ValueError(f"flash kernel takes head dim in {_KERNEL_D}, "
                         f"got {d}")
    qseg = kseg = None
    if segment_ids is not None:
        qseg, kseg = segment_ids.q, segment_ids.kv
        for name, x, shape in (("q", qseg, (B, Tq)), ("kv", kseg, (B, Tk))):
            if (x.dtype != torch.int32 or tuple(x.shape) != shape
                    or not x.is_contiguous() or x.device != q.device):
                raise ValueError(
                    f"segment ids {name} must be contiguous int32 {shape} on "
                    f"{q.device}; got {x.dtype} {tuple(x.shape)} on "
                    f"{x.device}")
    return B, Tq, Tk, H, d, qseg, kseg


def _ptr(x):
    return None if x is None else x.data_ptr()


def _flash_fwd_cuda(q, k, v, segment_ids, causal, sm_scale, layout):
    """Launch ``csrc/flash_fwd.cu``. Returns ``(out, lse)``."""
    B, Tq, Tk, H, d, qseg, kseg = _check_operands(q, k, v, segment_ids,
                                                  layout)
    out_shape = (B, Tq, H, d) if layout == "bthd" else (B, H, Tq, d)
    out = torch.empty(out_shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _kernel("flash_fwd", "flash_fwd")(
        _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), _ptr(qseg), _ptr(kseg),
        B, H, Tq, Tk, *_strides(q, layout), *_strides(k, layout),
        *_strides(v, layout), *_strides(out, layout),
        float(sm_scale), int(bool(causal)), stream)
    _build.check(code, "flash_fwd")
    registry.LAUNCH_COUNTS["flash_fwd"] += 1
    return out, lse


def _bwd_operands(q, k, v, do, lse, delta, segment_ids, layout):
    """Validate the backward's operands; returns the shared leading
    arguments of both C functions, ``(B, H, Tq, Tk)`` and the operand
    strides."""
    B, Tq, Tk, H, d, qseg, kseg = _check_operands(q, k, v, segment_ids,
                                                  layout)
    if do.dtype != q.dtype or tuple(do.shape) != tuple(q.shape) \
            or do.stride(-1) != 1:
        raise ValueError(f"dO must be {q.dtype} {tuple(q.shape)} with a "
                         "contiguous head dimension")
    for name, x in (("LSE", lse), ("Delta", delta)):
        if (x.dtype != torch.float32 or tuple(x.shape) != (B, H, Tq)
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 "
                             f"{(B, H, Tq)}")
    common = (_DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
              v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              _ptr(qseg), _ptr(kseg))
    strides = (*_strides(q, layout), *_strides(k, layout),
               *_strides(v, layout), *_strides(do, layout))
    return common, (B, H, Tq, Tk), strides


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, segment_ids, causal,
                        sm_scale, layout):
    """Launch ``flash_bwd_dkv`` (B2). Returns ``(dk, dv)``."""
    common, dims, strides = _bwd_operands(q, k, v, do, lse, delta,
                                          segment_ids, layout)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    code = _kernel("flash_bwd", "flash_bwd_dkv")(
        *common, dk.data_ptr(), dv.data_ptr(), *dims, *strides,
        *_strides(dk, layout), *_strides(dv, layout), float(sm_scale),
        int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_bwd_dkv")
    registry.LAUNCH_COUNTS["flash_bwd_dkv"] += 1
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, segment_ids, causal,
                       sm_scale, layout):
    """Launch ``flash_bwd_dq`` (B3). Returns ``dq``."""
    common, dims, strides = _bwd_operands(q, k, v, do, lse, delta,
                                          segment_ids, layout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    code = _kernel("flash_bwd", "flash_bwd_dq")(
        *common, dq.data_ptr(), *dims, *strides, *_strides(dq, layout),
        float(sm_scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_bwd_dq")
    registry.LAUNCH_COUNTS["flash_bwd_dq"] += 1
    return dq


def _flash_bwd_cuda(q, k, v, out, lse, do, segment_ids, causal, sm_scale,
                    layout):
    """Delta in torch, then B2 and B3. Returns ``(dq, dk, dv)``, each
    shaped and typed as its operand."""
    # autograd may hand over an expanded or strided gradient
    do = do.to(q.dtype).contiguous()
    delta = _bwd_delta(do, out, layout)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, segment_ids,
                                 causal, sm_scale, layout)
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, segment_ids, causal,
                            sm_scale, layout)
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """Flash attention with its backward: the counterpart of the JAX
    package's ``custom_vjp`` ``_flash_attention``. ``cuda`` picks the
    kernels (CUDA tensors) or the plain versions (CPU tensors) for both
    passes. Returns ``(out, lse)``; the LSE carries no gradient, and
    neither do the segment ids."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, causal, sm_scale, layout, cuda):
        seg = None if qseg is None else SegmentIds(qseg, kseg)
        fwd = _flash_fwd_cuda if cuda else _flash_attention_torch
        out, lse = fwd(q, k, v, seg, causal, sm_scale, layout)
        ctx.save_for_backward(q, k, v, out, lse, qseg, kseg)
        ctx.mode = (causal, sm_scale, layout, cuda)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse, qseg, kseg = ctx.saved_tensors
        causal, sm_scale, layout, cuda = ctx.mode
        seg = None if qseg is None else SegmentIds(qseg, kseg)
        bwd = _flash_bwd_cuda if cuda else _flash_bwd_torch
        dq, dk, dv = bwd(q, k, v, out, lse, do, seg, causal, sm_scale,
                         layout)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, sm_scale: Optional[float] = None,
                    causal: bool = False, *,
                    segment_ids: Optional[SegmentIds] = None,
                    layout: str = "bhtd", backend: Optional[str] = None,
                    return_lse: bool = False):
    """Flash attention. ``backend`` is ``"cuda"`` or ``"torch"`` (None =
    the operands' platform); it must match where the operands live.
    ``return_lse`` also returns the ``[B, H, Tq]`` fp32 LSE. When grad is
    enabled and an operand requires it, the call records
    :class:`_FlashFn`, whose backward runs on the same backend."""
    if layout not in ("bhtd", "bthd"):
        raise ValueError(f"unknown layout {layout!r}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes 4-D q, k, v")
    served = registry.resolve("flash", backend,
                              platform=registry.platform_of(q),
                              dtype=registry.dtype_name(q.dtype))
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    cuda = served == registry.BACKEND_CUDA
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        qseg, kseg = (None, None) if segment_ids is None else segment_ids
        out, lse = _FlashFn.apply(q, k, v, qseg, kseg, bool(causal),
                                  float(scale), layout, cuda)
    elif cuda:
        out, lse = _flash_fwd_cuda(q, k, v, segment_ids, causal, scale,
                                   layout)
    else:
        out, lse = _flash_attention_torch(q, k, v, segment_ids, causal,
                                          scale, layout)
    return (out, lse) if return_lse else out


def mha_flash_attention(q, k, v, mask=None, *, causal: bool = False,
                        segment_ids: Optional[SegmentIds] = None,
                        backend: Optional[str] = None):
    """Flash attention in the ``[B, T, H, D]`` layout of
    :func:`tosem_tpu_torch.nn.attention.dot_product_attention`. ``mask``
    (a dense tensor) must be None: padding travels as ``segment_ids``."""
    if mask is not None:
        raise ValueError("flash path takes causal/segment masks only; pass "
                         "padding as segment_ids (flash_attn_fn does this) "
                         "or use dot_product_attention")
    return flash_attention(q, k, v, None, causal, segment_ids=segment_ids,
                           layout="bthd", backend=backend)
