"""Perception onboard pipeline: detection + tracking over components.

The reference's onboard pipeline (`modules/perception/onboard/` —
lidar detection component → fused tracking component wired by Cyber
channels; `modules/perception/lidar/lib/tracker/`). Same topology here:
a :class:`DetectionComponent` runs the PointPillars detector on each
point-cloud message and publishes scored boxes; a
:class:`TrackerComponent` maintains stable track identities with a
greedy-IoU associate-update-retire loop (host-side control flow: the
detector's math on the device, identity bookkeeping on the host); both
ride the deterministic :class:`~tosem_tpu_torch.dataflow.ComponentRuntime`,
so a recorded drive replays bit-identically.

The port's counterpart of ``tosem_tpu/models/perception.py``. The port's
:class:`~tosem_tpu_torch.models.pointpillars.PointPillarsDetector` owns
its weights, so where the JAX package takes ``(params, detector)`` the
port takes the detector alone. On a CUDA detector ``detect`` launches
the NMS sweep (``ops/csrc/nms.cu``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from tosem_tpu_torch.dataflow.components import Component, ComponentRuntime
from tosem_tpu_torch.models.pointpillars import PointPillarsDetector
from tosem_tpu_torch.ops.nms import iou_matrix


class DetectionComponent(Component):
    """pts → detections (the lidar detection component role).

    ``detector`` is a :class:`PointPillarsDetector` with its weights; a
    cloud (numpy or tensor) runs on the detector's device."""

    def __init__(self, detector: PointPillarsDetector, *,
                 in_channel: str = "pts", out_channel: str = "detections",
                 score_threshold: float = 0.5, iou_threshold: float = 0.5):
        super().__init__("detection", [in_channel])
        self.detector = detector
        self.score_threshold = score_threshold
        self.iou_threshold = iou_threshold
        self.out_channel = out_channel

    def on_init(self, ctx):
        self._write = ctx.writer(self.out_channel)

    def proc(self, pts, *fused):
        dev = next(self.detector.parameters()).device
        with torch.no_grad():
            boxes, scores, keep = self.detector.detect(
                torch.as_tensor(pts, dtype=torch.float32, device=dev),
                iou_threshold=self.iou_threshold,
                score_threshold=self.score_threshold)
        k = keep.cpu().numpy()
        self._write({"boxes": boxes.cpu().numpy()[k],
                     "scores": scores.cpu().numpy()[k]})


@dataclass
class Track:
    track_id: int
    box: np.ndarray
    score: float
    age: int = 0            # frames since last match
    hits: int = 1


class GreedyIouTracker:
    """Associate-update-retire tracker (the lidar tracker role,
    `lidar/lib/tracker/multi_lidar_fusion` shape, minus motion models).
    Host code: the IoU matrix is ``ops.nms.iou_matrix`` on CPU tensors."""

    def __init__(self, iou_threshold: float = 0.3, max_age: int = 3):
        self.iou_threshold = iou_threshold
        self.max_age = max_age
        self._next_id = 0
        self.tracks: List[Track] = []

    def update(self, boxes: np.ndarray, scores: np.ndarray) -> List[Track]:
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        for t in self.tracks:
            t.age += 1
        if len(boxes) and self.tracks:
            track_boxes = np.stack([t.box for t in self.tracks])
            both = np.concatenate([track_boxes, boxes])
            iou = iou_matrix(torch.from_numpy(both)).numpy()[
                :len(self.tracks), len(self.tracks):]
            # greedy: best pair first (the matcher's assignment role)
            pairs = sorted(((iou[i, j], i, j)
                            for i in range(iou.shape[0])
                            for j in range(iou.shape[1])), reverse=True)
            used_t, used_d = set(), set()
            for v, i, j in pairs:
                if v < self.iou_threshold:
                    break
                if i in used_t or j in used_d:
                    continue
                used_t.add(i)
                used_d.add(j)
                t = self.tracks[i]
                t.box, t.score = boxes[j], float(scores[j])
                t.age = 0
                t.hits += 1
        else:
            used_d = set()
        for j in range(len(boxes)):
            if j not in used_d:
                self.tracks.append(Track(self._next_id, boxes[j],
                                         float(scores[j])))
                self._next_id += 1
        self.tracks = [t for t in self.tracks if t.age <= self.max_age]
        return list(self.tracks)


class TrackerComponent(Component):
    """detections → tracks."""

    def __init__(self, *, in_channel: str = "detections",
                 out_channel: str = "tracks",
                 iou_threshold: float = 0.3, max_age: int = 3):
        super().__init__("tracker", [in_channel])
        self.tracker = GreedyIouTracker(iou_threshold, max_age)
        self.out_channel = out_channel

    def on_init(self, ctx):
        self._write = ctx.writer(self.out_channel)

    def proc(self, det, *fused):
        tracks = self.tracker.update(det["boxes"], det["scores"])
        self._write([{"track_id": t.track_id,
                      "box": t.box.tolist(),
                      "score": t.score,
                      "hits": t.hits} for t in tracks])


def build_pipeline(detector: PointPillarsDetector, *,
                   runtime: Optional[ComponentRuntime] = None,
                   score_threshold: float = 0.5,
                   tracker_iou: float = 0.3,
                   max_age: int = 3) -> ComponentRuntime:
    """Wire pts → detection → tracker on a component runtime; callers
    write point clouds to ``pts`` and read fused output from a sink
    component or the ``tracks`` channel's latest message. The detector
    runs where its weights are (``PointPillarsDetector(device=...)``)."""
    rtc = runtime or ComponentRuntime()
    rtc.add(DetectionComponent(detector, score_threshold=score_threshold))
    rtc.add(TrackerComponent(iou_threshold=tracker_iou, max_age=max_age))
    return rtc
