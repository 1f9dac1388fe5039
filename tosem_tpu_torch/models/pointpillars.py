"""PointPillars-family lidar detection: voxelisation, the pillar feature
net, the BEV canvas, a per-cell head and the NMS sweep.

Counterpart of ``tosem_tpu/models/pointpillars.py`` (Apollo's
PointPillars: pillar assembly, the PFE, the scatter to BEV and
``nms_cuda``). Every shape is static and nothing is read back to the
host, so :meth:`PointPillarsDetector.apply` and ``detect`` can be
captured in a CUDA graph:

- **Voxelisation** is a stable sort of the points by pillar id: a point's
  slot in its pillar is its rank in its run of equal ids, points past
  the capacity ``P`` are dropped, and one scatter with distinct
  destinations writes the dense ``[H * W, P, C]`` pillars. The pillar
  means run over the STORED points only, added slot by slot in slot
  order (the points' input order within a pillar, which is the JAX
  package's ``segment_sum`` order) on the dense tensor: no float atomics,
  so two launches give the same bits.
- **The pillar feature net** is one product over the dense pillars and a
  masked max over the slots.
- **The canvas** is a reshape: the pillars are dense over the grid.
- **NMS** is ``ops/nms.py``: the CUDA sweep on the card, the JAX
  package's algorithm on torch ops on the CPU.

Grid arithmetic divides by the pillar size held as a device tensor
(made by a fill, so a graph capture takes it): a CUDA division by a
Python scalar multiplies by its reciprocal, which can move a point on a
pillar edge to the next pillar.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tosem_tpu_torch.ops.common import precision, resolve_device
# iou_matrix stays importable from here, as from the JAX package's module
from tosem_tpu_torch.ops.nms import iou_matrix, nms_sweep  # noqa: F401


@dataclass(frozen=True)
class PillarGrid:
    x_min: float = 0.0
    x_max: float = 32.0
    y_min: float = 0.0
    y_max: float = 32.0
    nx: int = 32                 # pillars along x
    ny: int = 32
    max_points_per_pillar: int = 16

    @property
    def n_pillars(self) -> int:
        return self.nx * self.ny

    @property
    def dx(self) -> float:
        return (self.x_max - self.x_min) / self.nx

    @property
    def dy(self) -> float:
        return (self.y_max - self.y_min) / self.ny


def _cell(v, lo: float, size: float):
    """floor((v - lo) / size) as int64, the division a true one."""
    step = torch.full((), size, dtype=v.dtype, device=v.device)
    return torch.floor((v - lo) / step).to(torch.int64)


def voxelize(points: torch.Tensor, grid: PillarGrid
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points [N, C] (x, y, rest...) -> (pillars [HW, P, C + 4],
    mask [HW, P]). Per stored point: its C features, its offsets from
    its pillar's point mean (x, y) and from the pillar's centre (x, y).
    Out-of-range points are dropped; a pillar keeps its first P points
    in input order."""
    N, C = points.shape
    P, HW = grid.max_points_per_pillar, grid.n_pillars
    dev = points.device
    x, y = points[:, 0], points[:, 1]
    ix = _cell(x, grid.x_min, grid.dx)
    iy = _cell(y, grid.y_min, grid.dy)
    valid = (ix >= 0) & (ix < grid.nx) & (iy >= 0) & (iy < grid.ny)
    pid = torch.where(valid, ix * grid.ny + iy,
                      torch.full_like(ix, HW))          # HW: the sentinel
    # stable sort by pillar id; the rank within each run is the slot
    order = torch.argsort(pid, stable=True)
    spid = pid[order]
    first = torch.searchsorted(spid, spid, side="left")
    slot = torch.arange(N, device=dev) - first
    keep = (spid < HW) & (slot < P)
    # distinct destinations for the kept points; the rest land in a
    # spare row that is dropped
    dest = torch.where(keep, spid * P + slot, torch.full_like(spid, HW * P))
    flat = torch.zeros(HW * P + 1, C + 1, dtype=points.dtype, device=dev)
    src = torch.cat([points[order], torch.ones(N, 1, dtype=points.dtype,
                                               device=dev)], 1)
    flat = flat.index_copy(0, dest, torch.where(keep[:, None], src,
                                                torch.zeros_like(src)))
    raw = flat[:-1].reshape(HW, P, C + 1)
    mask = raw[:, :, C] > 0.5
    # per-pillar sums of the stored x, y and count, slot by slot
    cols = torch.stack([raw[:, :, 0], raw[:, :, 1], raw[:, :, C]], -1)
    sums = cols[:, 0]
    for p in range(1, P):
        sums = sums + cols[:, p]
    cnt = sums[:, 2].clamp_min(1.0)
    mean_x, mean_y = sums[:, 0] / cnt, sums[:, 1] / cnt
    cell = torch.arange(HW, device=dev)
    cx = grid.x_min + ((cell // grid.ny).to(points.dtype) + 0.5) * grid.dx
    cy = grid.y_min + ((cell % grid.ny).to(points.dtype) + 0.5) * grid.dy
    px, py = raw[:, :, 0], raw[:, :, 1]
    aug = torch.cat([raw[:, :, :C], torch.stack([
        px - mean_x[:, None], py - mean_y[:, None],
        px - cx[:, None], py - cy[:, None]], -1)], -1)
    pillars = torch.where(mask[..., None], aug, torch.zeros_like(aug))
    return pillars, mask


class PillarFeatureNet(nn.Module):
    """Per-pillar PointNet: Dense -> ReLU -> masked max over the slots.
    ``w`` [in, feat] and ``b`` as in the JAX package."""

    def __init__(self, in_dim: int, feat_dim: int = 64, *, generator=None):
        super().__init__()
        self.in_dim, self.feat_dim = in_dim, feat_dim
        self.w = nn.Parameter(torch.randn(in_dim, feat_dim,
                                          generator=generator)
                              * (2.0 / in_dim) ** 0.5)
        self.b = nn.Parameter(torch.zeros(feat_dim))

    def forward(self, pillars, mask):
        with precision("float32"):
            h = F.relu(torch.matmul(pillars, self.w) + self.b)
        h = torch.where(mask[:, :, None], h, torch.full_like(h, -1e9))
        feat = h.amax(1)
        return torch.where(mask.any(1)[:, None], feat,
                           torch.zeros_like(feat))          # [HW, F]


def to_canvas(features: torch.Tensor, grid: PillarGrid) -> torch.Tensor:
    """[HW, F] -> [nx, ny, F]: the scatter to BEV is a reshape."""
    return features.reshape(grid.nx, grid.ny, -1)


def device_nms(boxes: torch.Tensor, scores: torch.Tensor,
               iou_threshold: float = 0.5,
               score_threshold: float = 0.0) -> torch.Tensor:
    """Greedy NMS as a bool keep mask over the N boxes (``ops/nms.py``:
    the CUDA sweep on the card, the plain version on the CPU)."""
    return nms_sweep(boxes, scores, iou_threshold, score_threshold)


class _Head(nn.Module):
    def __init__(self, feat_dim: int, generator):
        super().__init__()
        self.w = nn.Parameter(torch.randn(feat_dim, 5, generator=generator)
                              * 0.05)
        self.b = nn.Parameter(torch.zeros(5))


class PointPillarsDetector(nn.Module):
    """Points -> scored boxes: voxelize, the PFN, the canvas, and a
    per-cell head predicting (score, box deltas). Parameters ``pfn.{w,b}``
    and ``head.{w,b}`` (the JAX package's tree). Random init from a CPU
    ``torch.Generator`` seeded by ``seed``. :meth:`apply` keeps the JAX
    package's name and shadows ``nn.Module.apply``."""

    def __init__(self, grid: PillarGrid, point_dim: int = 4,
                 feat_dim: int = 64, *, device="cuda", seed: int = 0):
        super().__init__()
        self.grid = grid
        self.feat_dim = feat_dim
        gen = torch.Generator().manual_seed(seed)
        self.pfn = PillarFeatureNet(point_dim + 4, feat_dim, generator=gen)
        self.head = _Head(feat_dim, gen)
        self.to(resolve_device(device))

    def apply(self, points):
        """points [N, C] -> (boxes [HW, 4] (x1, y1, x2, y2), scores
        [HW])."""
        g = self.grid
        pillars, mask = voxelize(points, g)
        canvas = to_canvas(self.pfn(pillars, mask), g)     # [nx, ny, F]
        with precision("float32"):
            out = torch.matmul(canvas, self.head.w) + self.head.b
        scores = torch.sigmoid(out[:, :, 0]).reshape(-1)    # [HW]
        dev, dt = points.device, points.dtype
        cxs = g.x_min + (torch.arange(g.nx, device=dev, dtype=dt) + 0.5) \
            * g.dx
        cys = g.y_min + (torch.arange(g.ny, device=dev, dtype=dt) + 0.5) \
            * g.dy
        cx = cxs.repeat_interleave(g.ny)
        cy = cys.repeat(g.nx)
        d = out[:, :, 1:].reshape(-1, 4)
        boxes = torch.stack([
            cx + d[:, 0] - torch.exp(d[:, 2]) * g.dx,
            cy + d[:, 1] - torch.exp(d[:, 3]) * g.dy,
            cx + d[:, 0] + torch.exp(d[:, 2]) * g.dx,
            cy + d[:, 1] + torch.exp(d[:, 3]) * g.dy,
        ], 1)                                               # [HW, 4]
        return boxes, scores

    def detect(self, points, iou_threshold=0.5, score_threshold=0.5):
        boxes, scores = self.apply(points)
        keep = device_nms(boxes, scores, iou_threshold, score_threshold)
        return boxes, scores, keep

