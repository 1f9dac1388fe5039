"""Flash attention forward: the CUDA kernel and its plain version.

Counterpart of ``tosem_tpu/ops/flash_attention.py``. :func:`flash_attention`
takes ``[B, H, T, D]`` (``layout="bhtd"``) or ``[B, T, H, D]``
(``layout="bthd"``) operands and returns the same layout. On CUDA tensors
it launches ``csrc/flash_fwd.cu`` (the port of the Pallas ``_fwd_kernel``);
on CPU tensors it runs :func:`_flash_attention_torch`, the plain version
that mirrors the JAX package's ``_flash_attention_xla``. There is no
fallback from one to the other.

Modes: dense, ``causal`` (key position <= query position, top-left
aligned) and :class:`SegmentIds` (attend where the ids are equal; a
key-padding mask is ``SegmentIds(q=ones, kv=mask)``), in any
combination. The kernel masks a ragged edge itself, so no sequence
length has to tile. Block-sparse mask programs (``mask=``/``programs=``
in the JAX package) and the backward kernels are not ported yet
(``ROADMAP.md`` A4, B1-B3).

Both arms also return the per-row log-sum-exp ``[B, H, Tq]`` fp32
(``return_lse=True``), which the backward pass will need.
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


def _flash_attention_torch(q, k, v, segment_ids, causal, sm_scale, layout):
    """Plain PyTorch version: one dense masked softmax. Scores are fp32
    products of the input-dtype operands, the probabilities are cast to
    the value dtype before the PV product, masked scores are -1e30.
    Returns ``(out, lse)``."""
    qb, kb, vb = (_to_bthd(x, layout) for x in (q, k, v))
    Tq, Tk = qb.shape[1], kb.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kb.float()) * sm_scale
    keep = None
    if causal:
        rows = torch.arange(Tq, device=q.device)[:, None]
        cols = torch.arange(Tk, device=q.device)[None, :]
        keep = (rows >= cols)[None, None]
    if segment_ids is not None:
        seg = (segment_ids.q.to(torch.int32)[:, :, None]
               == segment_ids.kv.to(torch.int32)[:, None, :])[:, None]
        keep = seg if keep is None else keep & seg
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    w = (e / l).to(vb.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w.float(), vb.float()).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    if layout == "bhtd":
        out = out.transpose(1, 2)
    return out.contiguous(), lse


_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
             + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _kernel():
    fn = _build.load("flash_fwd").flash_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _strides(x, layout):
    if layout == "bthd":
        return x.stride(0), x.stride(1), x.stride(2)
    return x.stride(0), x.stride(2), x.stride(1)


def _flash_fwd_cuda(q, k, v, segment_ids, causal, sm_scale, layout):
    """Launch ``csrc/flash_fwd.cu``. Returns ``(out, lse)``."""
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
    out_shape = (B, Tq, H, d) if layout == "bthd" else (B, H, Tq, d)
    out = torch.empty(out_shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _kernel()(
        _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        None if qseg is None else qseg.data_ptr(),
        None if kseg is None else kseg.data_ptr(),
        B, H, Tq, Tk, *_strides(q, layout), *_strides(k, layout),
        *_strides(v, layout), *_strides(out, layout),
        float(sm_scale), int(bool(causal)), stream)
    _build.check(code, "flash_fwd")
    registry.LAUNCH_COUNTS["flash_fwd"] += 1
    return out, lse


def flash_attention(q, k, v, sm_scale: Optional[float] = None,
                    causal: bool = False, *,
                    segment_ids: Optional[SegmentIds] = None,
                    layout: str = "bhtd", backend: Optional[str] = None,
                    return_lse: bool = False):
    """Flash attention forward. ``backend`` is ``"cuda"`` or ``"torch"``
    (None = the operands' platform); it must match where the operands
    live. ``return_lse`` also returns the ``[B, H, Tq]`` fp32 LSE."""
    if layout not in ("bhtd", "bthd"):
        raise ValueError(f"unknown layout {layout!r}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes 4-D q, k, v")
    served = registry.resolve("flash", backend,
                              platform=registry.platform_of(q),
                              dtype=registry.dtype_name(q.dtype))
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if served == registry.BACKEND_CUDA:
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
