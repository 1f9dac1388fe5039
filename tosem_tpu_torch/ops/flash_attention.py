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
themselves, so no sequence length has to tile.

Block-sparse mask programs (``mask=``, a
:class:`~tosem_tpu_torch.ops.mask_programs.Mask`, or precompiled
``programs=``) resolve through the registry's ``schedule`` family. On
CUDA tensors the mask is compiled at the kernels' 64 x 64 tiles and the
schedule-mode kernels run (``flash_fwd_sched``, ``flash_bwd_dkv_sched``,
``flash_bwd_dq_sched``: only the scheduled tiles, segment ids on top);
there Tq and Tk must be multiples of 64, and a schedule compiled at other
tiles raises ``ValueError``. The schedule arrays are uploaded to the
device once per compiled program (so once per mask, shape, tiles, heads
and device: :func:`compile_mask_programs` returns one object per key)
and stay there, so a call copies nothing from the host. On CPU tensors
the plain versions fold the mask's ``dense()`` into the same masked
softmax, as the JAX package's ``xla`` arm does.

Both arms also return the per-row log-sum-exp ``[B, H, Tq]`` fp32
(``return_lse=True``); the backward reads it.

The kernels are built at head dims 16, 32, 64 and 128. Any other head
dim up to 128 runs on the next of them (:func:`kernel_head_dim`): the
CUDA wrappers zero-pad the last dimension of q, k, v (and dO), launch,
and slice the outputs back. Zero lanes add exact zeros to every fp32 dot
product, the caller's scale (that of the true head dim) passes through
unchanged, and the LSE and Delta are those of the unpadded call. A head
dim above 128 raises (ROADMAP.md C1).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

import numpy as np

from tosem_tpu_torch.ops import _build, registry
from tosem_tpu_torch.ops.flash_blocks import (FLASH_BK, FLASH_BQ,
                                              select_block_sizes)
from tosem_tpu_torch.ops.mask_programs import (CausalMask, Mask,
                                               MaskPrograms,
                                               compile_mask_programs,
                                               pack_bitmaps)

_NEG_INF = -1e30
_KERNEL_D = (16, 32, 64, 128)
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


@functools.lru_cache(maxsize=8)
def _dense_mask(mask, Tq, Tk, device):
    """A mask program's ``dense()`` as a ``[1, H|1, Tq, Tk]`` bool tensor
    on ``device``, kept for the next call of the same shape."""
    dm = torch.as_tensor(mask.dense(Tq, Tk), device=device)
    return dm[None, None] if dm.ndim == 2 else dm[None]


def _visible(segment_ids, causal, Tq, Tk, device, mask=None):
    """``[B|1, H|1, Tq, Tk]`` bool of the (query, key) pairs a mode lets
    through, or None when every pair is visible (dense). A mask program
    folds in as its ``dense()``: ``[Tq, Tk]``, or ``[H, Tq, Tk]`` for a
    :class:`~tosem_tpu_torch.ops.mask_programs.MultiHeadMask`."""
    keep = None
    if causal:
        rows = torch.arange(Tq, device=device)[:, None]
        cols = torch.arange(Tk, device=device)[None, :]
        keep = (rows >= cols)[None, None]
    if mask is not None:
        dm = _dense_mask(mask, Tq, Tk, torch.device(device))
        keep = dm if keep is None else keep & dm
    if segment_ids is not None:
        seg = (segment_ids.q.to(torch.int32)[:, :, None]
               == segment_ids.kv.to(torch.int32)[:, None, :])[:, None]
        keep = seg if keep is None else keep & seg
    return keep


def _scores(qb, kb, segment_ids, causal, sm_scale, mask=None):
    """fp32 scaled scores ``[B, H, Tq, Tk]`` of bthd operands, masked
    scores at -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kb.float()) * sm_scale
    keep = _visible(segment_ids, causal, qb.shape[1], kb.shape[1], qb.device,
                    mask)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    return s


def _from_bthd(x, layout):
    return (x.transpose(1, 2) if layout == "bhtd" else x).contiguous()


def _flash_attention_torch(q, k, v, segment_ids, causal, sm_scale, layout,
                           mask=None):
    """Plain PyTorch version: one dense masked softmax. Scores are fp32
    products of the input-dtype operands, the probabilities are cast to
    the value dtype before the PV product, masked scores are -1e30.
    ``mask`` is a mask program, folded in densely. Returns
    ``(out, lse)``."""
    qb, kb, vb = (_to_bthd(x, layout) for x in (q, k, v))
    s = _scores(qb, kb, segment_ids, causal, sm_scale, mask)
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


def _bwd_probs(q, k, lse, segment_ids, causal, sm_scale, layout, mask=None):
    """p = exp(s - LSE) in fp32, ``[B, H, Tq, Tk]``; 0 where masked."""
    qb, kb = _to_bthd(q, layout), _to_bthd(k, layout)
    return torch.exp(_scores(qb, kb, segment_ids, causal, sm_scale, mask)
                     - lse[..., None])


def _flash_bwd_dkv_torch(q, k, v, do, lse, delta, segment_ids, causal,
                         sm_scale, layout, mask=None):
    """Plain version of ``_bwd_dkv_kernel``: dV = sum_q bf(p) dO and
    dK = sum_q bf(p (dO.v - Delta) scale) q, bf() rounding to the input
    dtype as the reference casts before its dots. Returns ``(dk, dv)``."""
    p = _bwd_probs(q, k, lse, segment_ids, causal, sm_scale, layout, mask)
    qf, vf, dof = (_to_bthd(x, layout).float() for x in (q, v, do))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * sm_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qf)
    return (_from_bthd(dk.to(k.dtype), layout),
            _from_bthd(dv.to(v.dtype), layout))


def _flash_bwd_dq_torch(q, k, v, do, lse, delta, segment_ids, causal,
                        sm_scale, layout, mask=None):
    """Plain version of ``_bwd_dq_kernel``: dQ = scale * sum_k
    bf(p (dO.v - Delta)) k, the scale applied after the sum."""
    p = _bwd_probs(q, k, lse, segment_ids, causal, sm_scale, layout, mask)
    kf, vf, dof = (_to_bthd(x, layout).float() for x in (k, v, do))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(), kf)
    return _from_bthd((dq * sm_scale).to(q.dtype), layout)


def _flash_bwd_torch(q, k, v, out, lse, do, segment_ids, causal, sm_scale,
                     layout, mask=None):
    """Plain PyTorch backward: Delta, then the plain versions of the two
    kernels. Returns ``(dq, dk, dv)`` in the operands' layout."""
    delta = _bwd_delta(do, out, layout)
    dk, dv = _flash_bwd_dkv_torch(q, k, v, do, lse, delta, segment_ids,
                                  causal, sm_scale, layout, mask)
    dq = _flash_bwd_dq_torch(q, k, v, do, lse, delta, segment_ids, causal,
                             sm_scale, layout, mask)
    return dq, dk, dv


def _argtypes(pointers, strides, sched=0):
    """ctypes signature: dtype and D, the pointers, (B, H, Tq, Tk), the
    strides, the scale, then the causal flag (dense modes, ``sched=0``)
    or the ``sched`` schedule pointers and (Hs, L) (schedule mode), then
    the stream."""
    mode = ([ctypes.c_void_p] * sched + [ctypes.c_int] * 2 if sched
            else [ctypes.c_int])
    return ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * pointers
            + [ctypes.c_int] * 4 + [ctypes.c_longlong] * strides
            + [ctypes.c_float] + mode + [ctypes.c_void_p])


_ARGTYPES = {
    "flash_fwd": _argtypes(7, 12),
    "flash_bwd_dq": _argtypes(9, 15),
    "flash_bwd_dkv": _argtypes(10, 18),
    # schedule mode: five schedule arrays and the launch order
    "flash_fwd_sched": _argtypes(7, 12, sched=6),
    "flash_bwd_dq_sched": _argtypes(9, 15, sched=6),
    "flash_bwd_dkv_sched": _argtypes(10, 18, sched=6),
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
    kernel_head_dim(d)
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


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run a call of head dim ``d`` at: the
    least of :data:`_KERNEL_D` that holds it. Above 128 no body is built,
    and the call raises rather than fall back (ROADMAP.md C1)."""
    for width in _KERNEL_D:
        if d <= width:
            return width
    raise ValueError(
        f"flash kernel takes head dim up to {_KERNEL_D[-1]}, got {d}: no "
        "body is built for it (ROADMAP.md C1)")


def _pad_heads(tensors, width):
    """Each tensor zero-padded along its last (head) dimension to
    ``width``, as a new contiguous tensor (the ones already that wide
    pass through)."""
    return tuple(x if x.shape[-1] == width
                 else F.pad(x, (0, width - x.shape[-1])) for x in tensors)


def _unpad(x, d):
    """The first ``d`` lanes of a padded output, contiguous."""
    return x if x.shape[-1] == d else x[..., :d].contiguous()


class _DeviceSchedule(NamedTuple):
    """One :class:`~tosem_tpu_torch.ops.mask_programs.BlockSchedule` on
    the device: int32 ``num``/``blk``/``kind``/``mid``, the bitmaps
    packed into int64 words (:func:`pack_bitmaps`), the int32
    :func:`launch_order` of the resident tiles, and the sizes the launch
    checks."""
    num: torch.Tensor
    blk: torch.Tensor
    kind: torch.Tensor
    mid: torch.Tensor
    bits: torch.Tensor
    order: torch.Tensor
    Hs: int
    n_major: int
    n_minor: int        # the stream tiles it names: max(blk) + 1
    L: int


class _DevicePrograms(NamedTuple):
    fwd: _DeviceSchedule
    dq: _DeviceSchedule
    dkv: _DeviceSchedule


# (id(programs), device) -> (programs, _DevicePrograms). The entry holds
# the programs object, so its id cannot be reused while the entry lives.
_DEVICE_PROGRAMS: "collections.OrderedDict" = collections.OrderedDict()
_DEVICE_PROGRAMS_MAX = 128


def launch_order(num) -> np.ndarray:
    """The order in which the bf16 kernels launch their resident tiles: a
    permutation of ``range(n_major)`` by descending entry count, summed
    over the schedule's head rows (``num`` [Hs, n_major]), ties in tile
    order. The heaviest tiles start first, so the longest rows do not
    trail in the last wave. It is the port's launch order only: the
    tiles of a row still stream in the schedule's own order."""
    work = np.asarray(num, np.int64).sum(axis=0)
    return np.argsort(-work, kind="stable").astype(np.int32)


def _upload_schedule(sched, device) -> _DeviceSchedule:
    mb = np.asarray(sched.mask_blocks)
    if tuple(mb.shape[1:]) != (FLASH_BQ, FLASH_BK):
        raise ValueError(
            f"schedule bitmaps are {tuple(mb.shape[1:])}, the CUDA kernels' "
            f"tiles are ({FLASH_BQ}, {FLASH_BK}): compile the mask programs "
            "at BlockSizes() (select_block_sizes)")

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)
    blk = np.asarray(sched.blk)
    return _DeviceSchedule(
        num=dev(sched.num), blk=dev(blk), kind=dev(sched.kind),
        mid=dev(sched.mid),
        bits=torch.as_tensor(pack_bitmaps(mb), device=device),
        order=dev(launch_order(sched.num)),
        Hs=int(blk.shape[0]), n_major=int(blk.shape[1]),
        n_minor=int(blk.max()) + 1, L=int(blk.shape[2]))


def _device_programs(programs: MaskPrograms, device) -> _DevicePrograms:
    """The device copy of ``programs``, uploaded on its first use on
    ``device`` and kept (LRU, :data:`_DEVICE_PROGRAMS_MAX` entries)."""
    key = (id(programs), str(device))
    hit = _DEVICE_PROGRAMS.get(key)
    if hit is None:
        hit = (programs, _DevicePrograms(
            *(_upload_schedule(s, device) for s in programs)))
        _DEVICE_PROGRAMS[key] = hit
        if len(_DEVICE_PROGRAMS) > _DEVICE_PROGRAMS_MAX:
            _DEVICE_PROGRAMS.popitem(last=False)
    else:
        _DEVICE_PROGRAMS.move_to_end(key)
    return hit[1]


def _sched_args(programs, which, device, H, n_major, n_minor):
    """The launch arguments of one schedule (five pointers and the
    launch order's; then Hs, L), after checking it
    against the operands: ``n_major`` resident tiles, at most ``n_minor``
    streamed ones, one or H head rows."""
    ds = getattr(_device_programs(programs, device), which)
    if ds.n_major != n_major or ds.n_minor > n_minor or ds.Hs not in (1, H):
        raise ValueError(
            f"{which} schedule covers {ds.n_major} resident tiles, "
            f"{ds.n_minor} streamed and {ds.Hs} head rows; the operands "
            f"have {n_major}, {n_minor} and {H} heads: recompile the mask "
            "programs for this shape")
    ptrs = (ds.num, ds.blk, ds.kind, ds.mid, ds.bits, ds.order)
    return (*(p.data_ptr() for p in ptrs), ds.Hs, ds.L)


def _check_tiles(Tq, Tk, causal):
    """Schedule mode: the kernels' tiles must divide both lengths, and
    causality travels inside the mask program."""
    if Tq % FLASH_BQ or Tk % FLASH_BK:
        raise ValueError(f"schedule mode needs sequence lengths ({Tq},{Tk}) "
                         f"that divide into the kernels' ({FLASH_BQ}, "
                         f"{FLASH_BK}) tiles")
    if causal:
        raise ValueError("a mask program carries causality: compile "
                         "mask & CausalMask() instead of passing causal")


def _check_rows_aligned(tensors, layout):
    """The bf16 kernels copy 16-byte pieces of each row with
    ``cp.async``: every operand must start on 16 bytes, and its (batch,
    time, head) strides must be whole multiples of 8 elements."""
    for name, x in tensors:
        if x.data_ptr() % 16 or any(st % 8 for st in _strides(x, layout)):
            raise ValueError(
                f"{name} must start on 16 bytes with (batch, time, head) "
                f"strides that are multiples of 8 for the bf16 flash "
                f"kernel; got strides {tuple(x.stride())} at offset "
                f"{x.storage_offset()}")


def _flash_fwd_cuda(q, k, v, segment_ids, causal, sm_scale, layout,
                    programs=None):
    """Launch ``csrc/flash_fwd.cu`` (``flash_fwd``, or ``flash_fwd_sched``
    over ``programs.fwd``). Returns ``(out, lse)``."""
    B, Tq, Tk, H, d, qseg, kseg = _check_operands(q, k, v, segment_ids,
                                                  layout)
    width = kernel_head_dim(d)
    q, k, v = _pad_heads((q, k, v), width)
    if q.dtype == torch.bfloat16:
        _check_rows_aligned((("q", q), ("k", k), ("v", v)), layout)
    out_shape = ((B, Tq, H, width) if layout == "bthd"
                 else (B, H, Tq, width))
    out = torch.empty(out_shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (_DTYPE_CODE[q.dtype], width, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), _ptr(qseg),
            _ptr(kseg), B, H, Tq, Tk, *_strides(q, layout),
            *_strides(k, layout), *_strides(v, layout),
            *_strides(out, layout), float(sm_scale))
    if programs is None:
        name, mode = "flash_fwd", (int(bool(causal)),)
    else:
        _check_tiles(Tq, Tk, causal)
        name = "flash_fwd_sched"
        mode = _sched_args(programs, "fwd", q.device, H, Tq // FLASH_BQ,
                           Tk // FLASH_BK)
    code = _kernel("flash_fwd", name)(*args, *mode, stream)
    _build.check(code, name)
    registry.count_launch(name)
    return _unpad(out, d), lse


def _bwd_operands(q, k, v, do, lse, delta, segment_ids, layout):
    """Validate the backward's operands and pad them to the kernels'
    head dim; returns the padded ``(q, k, v, do)``, the shared leading
    arguments of both C functions, ``(B, H, Tq, Tk)`` and the operand
    strides."""
    B, Tq, Tk, H, d, qseg, kseg = _check_operands(q, k, v, segment_ids,
                                                  layout)
    if do.dtype != q.dtype or tuple(do.shape) != tuple(q.shape) \
            or do.stride(-1) != 1:
        raise ValueError(f"dO must be {q.dtype} {tuple(q.shape)} with a "
                         "contiguous head dimension")
    q, k, v, do = _pad_heads((q, k, v, do), kernel_head_dim(d))
    if q.dtype == torch.bfloat16:
        _check_rows_aligned((("q", q), ("k", k), ("v", v), ("dO", do)),
                            layout)
    for name, x in (("LSE", lse), ("Delta", delta)):
        if (x.dtype != torch.float32 or tuple(x.shape) != (B, H, Tq)
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 "
                             f"{(B, H, Tq)}")
    common = (_DTYPE_CODE[q.dtype], q.shape[-1], q.data_ptr(), k.data_ptr(),
              v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              _ptr(qseg), _ptr(kseg))
    strides = (*_strides(q, layout), *_strides(k, layout),
               *_strides(v, layout), *_strides(do, layout))
    return (q, k, v, do), common, (B, H, Tq, Tk), strides


def _bwd_mode(name, programs, which, causal, q, dims, n_major, n_minor):
    """(C function name, its mode arguments): the causal flag, or the
    checked ``which`` schedule of ``programs``."""
    if programs is None:
        return name, (int(bool(causal)),)
    B, H, Tq, Tk = dims
    _check_tiles(Tq, Tk, causal)
    return name + "_sched", _sched_args(programs, which, q.device, H,
                                        n_major, n_minor)


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, segment_ids, causal,
                        sm_scale, layout, programs=None):
    """Launch ``flash_bwd_dkv`` (B2), or ``flash_bwd_dkv_sched`` over the
    kv-major ``programs.dkv``. Returns ``(dk, dv)``."""
    d = q.shape[-1]
    (q, k, v, do), common, dims, strides = _bwd_operands(
        q, k, v, do, lse, delta, segment_ids, layout)
    name, mode = _bwd_mode("flash_bwd_dkv", programs, "dkv", causal, q,
                           dims, dims[3] // FLASH_BK, dims[2] // FLASH_BQ)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    code = _kernel("flash_bwd", name)(
        *common, dk.data_ptr(), dv.data_ptr(), *dims, *strides,
        *_strides(dk, layout), *_strides(dv, layout), float(sm_scale),
        *mode, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, name)
    registry.count_launch(name)
    return _unpad(dk, d), _unpad(dv, d)


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, segment_ids, causal,
                       sm_scale, layout, programs=None):
    """Launch ``flash_bwd_dq`` (B3), or ``flash_bwd_dq_sched`` over the
    q-major ``programs.dq``. Returns ``dq``."""
    d = q.shape[-1]
    (q, k, v, do), common, dims, strides = _bwd_operands(
        q, k, v, do, lse, delta, segment_ids, layout)
    name, mode = _bwd_mode("flash_bwd_dq", programs, "dq", causal, q, dims,
                           dims[2] // FLASH_BQ, dims[3] // FLASH_BK)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    code = _kernel("flash_bwd", name)(
        *common, dq.data_ptr(), *dims, *strides, *_strides(dq, layout),
        float(sm_scale), *mode,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, name)
    registry.count_launch(name)
    return _unpad(dq, d)


def _flash_bwd_cuda(q, k, v, out, lse, do, segment_ids, causal, sm_scale,
                    layout, programs=None):
    """Delta in torch, then B2 and B3 (their schedule mode when
    ``programs`` is given). Returns ``(dq, dk, dv)``, each shaped and
    typed as its operand. A head dim the kernels pad is padded once here
    for both, after Delta is taken on the unpadded dO and O."""
    # autograd may hand over an expanded or strided gradient
    do = do.to(q.dtype).contiguous()
    delta = _bwd_delta(do, out, layout)
    d = q.shape[-1]
    q, k, v, do = _pad_heads((q, k, v, do), kernel_head_dim(d))
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, segment_ids,
                                 causal, sm_scale, layout, programs)
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, segment_ids, causal,
                            sm_scale, layout, programs)
    return _unpad(dq, d), _unpad(dk, d), _unpad(dv, d)


class _FlashFn(torch.autograd.Function):
    """Flash attention with its backward: the counterpart of the JAX
    package's ``custom_vjp`` ``_flash_attention``. ``cuda`` picks the
    kernels (CUDA tensors, over ``programs`` in schedule mode) or the
    plain versions (CPU tensors, folding ``mask``) for both passes.
    Returns ``(out, lse)``; the LSE carries no gradient, and neither do
    the segment ids, the mask or the programs (kept for the backward as
    they are: their device copy stays in the upload cache)."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, causal, sm_scale, layout, cuda,
                mask, programs):
        seg = None if qseg is None else SegmentIds(qseg, kseg)
        if cuda:
            out, lse = _flash_fwd_cuda(q, k, v, seg, causal, sm_scale, layout,
                                       programs)
        else:
            out, lse = _flash_attention_torch(q, k, v, seg, causal, sm_scale,
                                              layout, mask)
        ctx.save_for_backward(q, k, v, out, lse, qseg, kseg)
        ctx.mode = (causal, sm_scale, layout, cuda, mask, programs)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse, qseg, kseg = ctx.saved_tensors
        causal, sm_scale, layout, cuda, mask, programs = ctx.mode
        seg = None if qseg is None else SegmentIds(qseg, kseg)
        if cuda:
            dq, dk, dv = _flash_bwd_cuda(q, k, v, out, lse, do, seg, causal,
                                         sm_scale, layout, programs)
        else:
            dq, dk, dv = _flash_bwd_torch(q, k, v, out, lse, do, seg, causal,
                                          sm_scale, layout, mask)
        return (dq, dk, dv) + (None,) * 8


def flash_attention(q, k, v, sm_scale: Optional[float] = None,
                    causal: bool = False, *,
                    segment_ids: Optional[SegmentIds] = None,
                    layout: str = "bhtd", mask: Optional[Mask] = None,
                    programs: Optional[MaskPrograms] = None,
                    backend: Optional[str] = None,
                    return_lse: bool = False):
    """Flash attention. ``backend`` is ``"cuda"`` or ``"torch"`` (None =
    the operands' platform); it must match where the operands live.
    ``return_lse`` also returns the ``[B, H, Tq]`` fp32 LSE. When grad is
    enabled and an operand requires it, the call records
    :class:`_FlashFn`, whose backward runs on the same backend.

    ``mask`` is a static mask program (``causal=True`` with a mask means
    ``mask & CausalMask()``; without one it keeps the kernels' causal
    mode). ``programs`` are precompiled schedules
    (:func:`compile_mask_programs` at the kernels' tiles); on ``cuda``
    they may come without their mask, on ``torch`` the mask is what runs
    and ``programs`` alone raise, as the JAX package's ``xla`` arm
    does."""
    if layout not in ("bhtd", "bthd"):
        raise ValueError(f"unknown layout {layout!r}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes 4-D q, k, v")
    if causal and mask is not None:
        mask, causal = mask & CausalMask(), False
    elif causal and programs is not None:
        raise ValueError("precompiled programs carry their own mask: "
                         "compile mask & CausalMask() into them instead of "
                         "passing causal=True")
    scheduled = mask is not None or programs is not None
    served = registry.resolve("schedule" if scheduled else "flash", backend,
                              platform=registry.platform_of(q),
                              dtype=registry.dtype_name(q.dtype))
    _, Tq, H, d = _dims(q, layout)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    cuda = served == registry.BACKEND_CUDA
    if scheduled and cuda and programs is None:
        Tk = _dims(k, layout)[1]
        blocks = select_block_sizes(Tq, d, registry.dtype_name(q.dtype), Tk,
                                    mask_sig=mask.signature(), backend=served)
        programs = compile_mask_programs(mask, Tq, Tk, blocks, heads=H)
    elif scheduled and not cuda:
        if mask is None:
            raise ValueError(
                "the torch arm folds the MASK into a dense where; "
                "precompiled programs without their mask cannot run there: "
                "pass mask=")
        mask.head_masks(H)                   # a MultiHeadMask's arity
        programs = None
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        qseg, kseg = (None, None) if segment_ids is None else segment_ids
        out, lse = _FlashFn.apply(q, k, v, qseg, kseg, bool(causal),
                                  float(scale), layout, cuda, mask, programs)
    elif cuda:
        out, lse = _flash_fwd_cuda(q, k, v, segment_ids, causal, scale,
                                   layout, programs)
    else:
        out, lse = _flash_attention_torch(q, k, v, segment_ids, causal,
                                          scale, layout, mask)
    return (out, lse) if return_lse else out


def mha_flash_attention(q, k, v, mask=None, *, causal: bool = False,
                        segment_ids: Optional[SegmentIds] = None,
                        mask_program: Optional[Mask] = None,
                        backend: Optional[str] = None):
    """Flash attention in the ``[B, T, H, D]`` layout of
    :func:`tosem_tpu_torch.nn.attention.dot_product_attention`. ``mask``
    (a dense tensor) must be None: padding travels as ``segment_ids``,
    static sparsity as ``mask_program`` (a mask program compiled to a
    block schedule)."""
    if mask is not None:
        raise ValueError("flash path takes causal/segment/program masks "
                         "only; pass padding as segment_ids (flash_attn_fn "
                         "does this), static sparsity as mask_program, or "
                         "use dot_product_attention")
    return flash_attention(q, k, v, None, causal, segment_ids=segment_ids,
                           layout="bthd", mask=mask_program, backend=backend)
