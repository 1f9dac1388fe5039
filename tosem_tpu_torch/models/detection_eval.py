"""COCO-style detection evaluation (AP@[.5:.95], AP50, AP75, per class).

A copy of ``tosem_tpu/models/detection_eval.py`` (NumPy, no JAX there):
the reference scores EfficientDet with pycocotools through
``coco_metric.py``; this keeps the same protocol without it: greedy
score-ordered matching per class at each IoU threshold, 101-point
interpolated AP. It runs on the host, on the detections the port's
``postprocess`` hands back as numpy arrays.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

COCO_IOU_THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05).round(2))


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between [N,4] and [M,4] boxes in (y1,x1,y2,x2)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(
        a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(
        b[:, 3] - b[:, 1], 0)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(br - tl, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


def _ap_from_matches(scores: np.ndarray, matched: np.ndarray,
                     n_gt: int) -> float:
    """101-point interpolated AP (COCOeval's accumulate convention)."""
    if n_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = matched[order].astype(np.float64)
    fp = 1.0 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    # precision envelope (monotone non-increasing from the right)
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    recall_points = np.linspace(0.0, 1.0, 101)
    idx = np.searchsorted(recall, recall_points, side="left")
    prec_at = np.where(idx < len(precision), precision[np.minimum(
        idx, len(precision) - 1)], 0.0)
    return float(prec_at.mean())


def match_detections(det_boxes: np.ndarray, det_scores: np.ndarray,
                     gt_boxes: np.ndarray, iou_thr: float) -> np.ndarray:
    """Greedy per-image matching: score order, best unmatched GT ≥ thr.

    → bool[N] (True = true positive), the COCOeval matching rule.
    """
    matched = np.zeros(len(det_boxes), bool)
    if len(gt_boxes) == 0 or len(det_boxes) == 0:
        return matched
    ious = iou_matrix(det_boxes, gt_boxes)
    taken = np.zeros(len(gt_boxes), bool)
    for i in np.argsort(-det_scores, kind="stable"):
        cand = np.where(~taken)[0]
        if len(cand) == 0:
            break
        j = cand[np.argmax(ious[i, cand])]
        if ious[i, j] >= iou_thr:
            matched[i] = True
            taken[j] = True
    return matched


def evaluate_detections(
        detections: Sequence[Dict[str, np.ndarray]],
        ground_truths: Sequence[Dict[str, np.ndarray]],
        iou_thresholds: Sequence[float] = COCO_IOU_THRESHOLDS,
) -> Dict[str, float]:
    """COCO protocol over a dataset.

    detections[i]: {"boxes": [N,4], "scores": [N], "classes": [N]}
    ground_truths[i]: {"boxes": [M,4], "classes": [M]}
    → {"AP": mAP@[.5:.95], "AP50", "AP75", "per_class": {cls: AP}}
    """
    if len(detections) != len(ground_truths):
        raise ValueError("detections and ground_truths length mismatch")
    classes = sorted({int(c) for g in ground_truths
                      for c in np.asarray(g["classes"]).reshape(-1)})
    ap_per_thr_cls: Dict[Tuple[float, int], float] = {}
    for thr in iou_thresholds:
        for cls in classes:
            scores_all: List[np.ndarray] = []
            matched_all: List[np.ndarray] = []
            n_gt = 0
            for det, gt in zip(detections, ground_truths):
                g_mask = np.asarray(gt["classes"]).reshape(-1) == cls
                g_boxes = np.asarray(gt["boxes"]).reshape(-1, 4)[g_mask]
                n_gt += int(g_mask.sum())
                d_cls = np.asarray(det["classes"]).reshape(-1)
                d_mask = d_cls == cls
                d_boxes = np.asarray(det["boxes"]).reshape(-1, 4)[d_mask]
                d_scores = np.asarray(det["scores"]).reshape(-1)[d_mask]
                matched_all.append(match_detections(
                    d_boxes, d_scores, g_boxes, thr))
                scores_all.append(d_scores)
            ap_per_thr_cls[(thr, cls)] = _ap_from_matches(
                np.concatenate(scores_all) if scores_all else np.empty(0),
                np.concatenate(matched_all) if matched_all
                else np.empty(0, bool), n_gt)

    def mean_over(thrs) -> float:
        vals = [ap_per_thr_cls[(t, c)] for t in thrs for c in classes
                if not np.isnan(ap_per_thr_cls[(t, c)])]
        return float(np.mean(vals)) if vals else 0.0

    per_class = {c: float(np.nanmean(
        [ap_per_thr_cls[(t, c)] for t in iou_thresholds]))
        for c in classes}
    return {
        "AP": mean_over(iou_thresholds),
        "AP50": mean_over([iou_thresholds[0]]) if iou_thresholds else 0.0,
        "AP75": (mean_over([0.75]) if 0.75 in iou_thresholds else
                 float("nan")),
        "per_class": per_class,
    }
