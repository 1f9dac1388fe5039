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
ops (the IoU matrix and a loop over the sorted candidates above the
score threshold). There is no fallback from one to the other: the
kernel's wrapper refuses CPU tensors, other dtypes, more boxes than its
shared-memory bitmap holds (:func:`max_boxes`) and an overlap mask the
device cannot hold. Both take the order from
``torch.argsort(-scores, stable=True)`` and compute the IoU with the
same operations in the same order, so their masks agree element for
element. The kernel is a bitmask NMS: the overlap
words of every live pair in parallel, then one block's chunked sweep
over them (``csrc/nms.cu``). The score order is found on the device,
the scratch comes from torch's allocator on the current stream, and
nothing is read back to the host: the call can be captured in a CUDA
graph.
"""
from __future__ import annotations

import ctypes

import torch

from tosem_tpu_torch.ops import _build, registry

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float,
                                      ctypes.c_float]
             + [ctypes.c_void_p] * 6)


def iou_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Axis-aligned IoU [M, N] of boxes a [M, 4] against boxes b [N, 4],
    (x1, y1, x2, y2), each element by the JAX package's ``iou_matrix``
    operations in its order."""
    def area(x):
        return (x[:, 2] - x[:, 0]).clamp_min(0) * \
            (x[:, 3] - x[:, 1]).clamp_min(0)
    x1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / union.clamp_min(1e-9)


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Axis-aligned IoU [N, N] of boxes [N, 4] = (x1, y1, x2, y2)."""
    return iou_rows(boxes, boxes)


def score_order(scores: torch.Tensor) -> torch.Tensor:
    """The candidates' order: descending score, ties in index order."""
    return torch.argsort(-scores, stable=True)


def _live_order(scores: torch.Tensor, score_threshold: float):
    """The candidates above the score threshold, in score order. A box
    at or below it is never kept and suppresses nothing, so the greedy
    pass runs over these alone and keeps what a pass over all N keeps."""
    order = score_order(scores)
    return order[scores[order] > score_threshold]


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float = 0.5,
              score_threshold: float = 0.0) -> torch.Tensor:
    """The plain version: the JAX package's ``device_nms`` step for step
    (an IoU matrix of the sorted boxes, then one pass over them), over
    the live candidates only (:func:`_live_order`)."""
    n = boxes.shape[0]
    order = _live_order(scores, score_threshold)
    m = order.shape[0]
    iou = iou_matrix(boxes[order])
    live = torch.ones(m, dtype=torch.bool, device=boxes.device)
    kept = torch.zeros(m, dtype=torch.bool, device=boxes.device)
    for i in range(m):
        take = live[i]
        kept[i] = take
        live = live & ~(take & (iou[i] > iou_threshold))
        live[i] = False
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = kept
    return keep


def nms_plain_rows(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_threshold: float = 0.5, score_threshold: float = 0.0,
                   rows: int = 4096) -> torch.Tensor:
    """:func:`nms_plain` with its IoU matrix made ``rows`` rows at a time
    (:func:`iou_rows`), for box counts whose N x N temporaries do not fit
    in memory (at 60,025 live boxes each is 14.4 GB, and ``nms_plain``
    holds seven at once): the same operations on each element and the
    same pass, so the same keep mask."""
    n = boxes.shape[0]
    order = _live_order(scores, score_threshold)
    m = order.shape[0]
    srt = boxes[order]
    live = torch.ones(m, dtype=torch.bool, device=boxes.device)
    kept = torch.zeros(m, dtype=torch.bool, device=boxes.device)
    for start in range(0, m, rows):
        over = iou_rows(srt[start:start + rows], srt) > iou_threshold
        for i in range(start, min(start + rows, m)):
            take = live[i]
            kept[i] = take
            live = live & ~(take & over[i - start])
            live[i] = False
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = kept
    return keep


def max_boxes() -> int:
    """The most boxes one launch of the kernel takes: its sweep keeps a
    bit a box in one block's shared memory (the device's opt-in
    ceiling)."""
    return int(_build.load("nms").nms_max_n())


def mask_words(n: int) -> int:
    """64-bit words a row of n bits takes: the kernel's overlap words a
    row of n candidates (one a chunk of 64), and its occupancy words a
    row of ``mask_words(n)`` overlap words."""
    return -(-n // 64)


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
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=boxes.device)
    if n > max_boxes():
        raise ValueError(f"the NMS kernel holds at most {max_boxes()} "
                         f"boxes, got {n}")
    boxes = boxes.contiguous()
    scores = scores.contiguous()
    order = score_order(scores)
    words = mask_words(n)
    dev = boxes.device
    sorted_boxes = torch.empty(n, 4, dtype=torch.float32, device=dev)
    live = torch.empty(words, dtype=torch.int64, device=dev)
    occ = torch.empty(n, mask_words(words), dtype=torch.int64, device=dev)
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    try:
        mask = torch.empty(n, words, dtype=torch.int64, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        raise torch.cuda.OutOfMemoryError(
            f"the NMS kernel's overlap mask for {n} boxes ({n * words * 8} "
            f"bytes) does not fit on {dev}") from e
    fn = _build.load("nms").nms_sweep
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(boxes.data_ptr(), scores.data_ptr(), order.data_ptr(),
                    n, float(iou_threshold), float(score_threshold),
                    sorted_boxes.data_ptr(), live.data_ptr(),
                    mask.data_ptr(), occ.data_ptr(), keep.data_ptr(), stream),
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
