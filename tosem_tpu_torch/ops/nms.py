"""Greedy NMS as a keep mask: the CUDA sweep and its plain version.

The port's counterpart of ``tosem_tpu/models/pointpillars.py``
``device_nms``: boxes [N, 4] (x1, y1, x2, y2) and scores [N] -> a bool
keep mask over the N boxes in input order, static in shape. Candidates
are taken in the stable descending score order; a box whose score is
not above ``score_threshold`` is never kept; each kept box suppresses
the later boxes whose IoU with it exceeds ``iou_threshold``.

:func:`nms_sweep` routes by the operands' device: CUDA tensors launch
``csrc/nms.cu`` (``nms_sweep``, counted in ``registry.LAUNCH_COUNTS``);
CPU tensors run :func:`nms_plain`, the JAX package's algorithm on torch
ops (the IoU matrix and a loop over the sorted candidates). There is no
fallback from one to the other: the kernel's wrapper refuses CPU
tensors, other dtypes and more boxes than its shared memory holds.
Both take the order from ``torch.argsort(-scores, stable=True)`` and
compute the IoU with the same operations in the same order, so their
masks agree element for element. The score order is found on the
device and nothing is read back to the host: the sweep can be captured
in a CUDA graph.
"""
from __future__ import annotations

import ctypes

import torch

from tosem_tpu_torch.ops import _build, registry

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float,
                                      ctypes.c_float]
             + [ctypes.c_void_p] * 3)


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Axis-aligned IoU [N, N] of boxes [N, 4] = (x1, y1, x2, y2)."""
    area = (boxes[:, 2] - boxes[:, 0]).clamp_min(0) * \
        (boxes[:, 3] - boxes[:, 1]).clamp_min(0)
    x1 = torch.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y1 = torch.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = torch.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y2 = torch.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    union = area[:, None] + area[None, :] - inter
    return inter / union.clamp_min(1e-9)


def score_order(scores: torch.Tensor) -> torch.Tensor:
    """The candidates' order: descending score, ties in index order."""
    return torch.argsort(-scores, stable=True)


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float = 0.5,
              score_threshold: float = 0.0) -> torch.Tensor:
    """The plain version: the JAX package's ``device_nms`` step for step
    (an IoU matrix of the sorted boxes, then one pass over them)."""
    n = boxes.shape[0]
    order = score_order(scores)
    iou = iou_matrix(boxes[order])
    live = scores[order] > score_threshold
    kept = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        take = live[i]
        kept[i] = take
        live = live & ~(take & (iou[i] > iou_threshold))
        live[i] = False
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = kept
    return keep


def max_boxes() -> int:
    """The most boxes one launch of the kernel takes (its live flags
    fill the block's static shared memory)."""
    return int(_build.load("nms").nms_max_n())


def _nms_cuda(boxes, scores, iou_threshold, score_threshold):
    for name, t in (("boxes", boxes), ("scores", scores)):
        if t.device.type != "cuda" or t.device != boxes.device:
            raise ValueError(f"the NMS kernel takes CUDA tensors on one "
                             f"device; {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the NMS kernel takes float32 {name}, got "
                            f"{t.dtype}")
    n = boxes.shape[0]
    if boxes.shape != (n, 4) or scores.shape != (n,):
        raise ValueError(f"boxes [N, 4] and scores [N], got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    if n == 0:
        return keep
    if n > max_boxes():
        raise ValueError(f"the NMS kernel holds at most {max_boxes()} "
                         f"boxes, got {n}")
    boxes = boxes.contiguous()
    scores = scores.contiguous()
    order = score_order(scores)
    scratch = torch.empty(n, 4, dtype=torch.float32, device=boxes.device)
    fn = _build.load("nms").nms_sweep
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    _build.check(fn(boxes.data_ptr(), scores.data_ptr(), order.data_ptr(),
                    n, float(iou_threshold), float(score_threshold),
                    scratch.data_ptr(), keep.data_ptr(), stream),
                 "nms_sweep")
    registry.count_launch("nms_sweep")
    return keep


def nms_sweep(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float = 0.5,
              score_threshold: float = 0.0) -> torch.Tensor:
    """Keep mask [N] (bool, input order): the CUDA kernel on CUDA
    tensors, :func:`nms_plain` on CPU tensors."""
    backend = registry.resolve("nms", platform=registry.platform_of(boxes),
                               dtype=registry.dtype_name(boxes.dtype))
    if backend == registry.BACKEND_CUDA:
        return _nms_cuda(boxes, scores, iou_threshold, score_threshold)
    return nms_plain(boxes, scores, iou_threshold, score_threshold)
