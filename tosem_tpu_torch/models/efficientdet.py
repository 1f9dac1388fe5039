"""EfficientDet: an EfficientNet backbone, BiFPN, and class and box heads.

Counterpart of ``tosem_tpu/models/efficientdet.py`` (google/automl's
EfficientDet: ``efficientdet_arch.py``, ``backbone/``,
``det_model_fn.py``'s focal and box losses, ``anchors.py``). The model
takes NHWC fp32 images at its boundary, as the JAX package does, and runs
NCHW inside on the port's ``nn/layers.py`` convolutions (XLA's
asymmetric SAME padding) and BatchNorm (momentum 0.9, biased variance).
Every convolution and product runs under ``precision("float32")``: TF32
off, as the JAX package's ``detection_train`` asks for float32.

Where the layouts meet:

- the heads' outputs are permuted back to NHWC before the reshape to
  ``[B, H * W * A, K]``, so anchor ``a`` of cell ``(y, x)`` sits where
  :func:`generate_anchors` puts it;
- the BiFPN's nearest resize takes source index ``i * H // h`` in
  integers, as the JAX package does (``F.interpolate`` computes its
  source index in floating point);
- the head convolutions are shared across pyramid levels, their
  BatchNorms are one per (layer, level).

Parameter and buffer names follow the JAX package's trees, with ``b{i}``
as ``blocks.{i}`` and ``td{i}``/``bu{i}`` as ``td_convs.{i}``/
``bu_convs.{i}`` (``models/convert.py``). Random init draws from a CPU
``torch.Generator`` seeded by ``seed`` (not the JAX package's numbers).
Target assignment, the losses and box decoding are batched torch ops;
the NMS of :func:`postprocess` stays on the host in numpy, as in the
JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tosem_tpu_torch.nn.layers import BatchNorm, Conv2D, DepthwiseConv2D
from tosem_tpu_torch.ops.common import precision, resolve_device

PRECISION = "float32"


def swish(x):
    return F.silu(x)


# ------------------------------------------------------------------ config

@dataclass
class EfficientDetConfig:
    """Compound scaling per ``hparams_config.py`` (d0, d1; ``tiny`` is the
    CI-sized model)."""
    name: str = "d0"
    backbone_width: float = 1.0
    backbone_depth: float = 1.0
    image_size: int = 512
    fpn_channels: int = 64
    fpn_layers: int = 3
    head_layers: int = 3
    num_classes: int = 90
    num_scales: int = 3
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_scale: float = 4.0
    min_level: int = 3
    max_level: int = 7

    @classmethod
    def d0(cls, **kw):
        return cls(name="d0", **kw)

    @classmethod
    def d1(cls, **kw):
        return cls(name="d1", backbone_width=1.0, backbone_depth=1.1,
                   image_size=640, fpn_channels=88, fpn_layers=4,
                   head_layers=3, **kw)

    @classmethod
    def tiny(cls, **kw):
        """64 px, thin, levels 3-5 (P6/P7 would be 1x1 maps whose
        batch variance degenerates at batch 1-2)."""
        kw.setdefault("num_classes", 5)
        return cls(name="tiny", backbone_width=0.25, backbone_depth=0.34,
                   image_size=64, fpn_channels=16, fpn_layers=1,
                   head_layers=1, max_level=5, **kw)

    @property
    def num_anchors(self) -> int:
        return self.num_scales * len(self.aspect_ratios)

    @property
    def levels(self) -> List[int]:
        return list(range(self.min_level, self.max_level + 1))


def _round_channels(c: float, width: float, divisor: int = 8) -> int:
    c *= width
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def _round_repeats(r: int, depth: float) -> int:
    return int(math.ceil(r * depth))


def _conv(c_in, c_out, kernel, stride=1, *, bias=False, generator=None):
    return Conv2D(c_in, c_out, kernel, stride, bias=bias,
                  precision=PRECISION, generator=generator)


def _dwconv(channels, kernel, stride=1, *, generator=None):
    return DepthwiseConv2D(channels, kernel, stride, precision=PRECISION,
                           generator=generator)


# ------------------------------------------------------------- EfficientNet

class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int, *, generator=None):
        super().__init__()
        self.c1 = _conv(channels, reduced, (1, 1), bias=True,
                        generator=generator)
        self.c2 = _conv(reduced, channels, (1, 1), bias=True,
                        generator=generator)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.c2(swish(self.c1(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excite."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 expand: int, se_ratio: float = 0.25, *, generator=None):
        super().__init__()
        self.c_in, self.c_out, self.stride = c_in, c_out, stride
        mid = c_in * expand
        self.expand = expand
        if expand != 1:
            self.exp_conv = _conv(c_in, mid, (1, 1), generator=generator)
            self.exp_bn = BatchNorm(mid)
        self.dw = _dwconv(mid, (kernel, kernel), stride, generator=generator)
        self.dw_bn = BatchNorm(mid)
        self.se = SqueezeExcite(mid, max(1, int(c_in * se_ratio)),
                                generator=generator)
        self.proj = _conv(mid, c_out, (1, 1), generator=generator)
        self.proj_bn = BatchNorm(c_out)

    def forward(self, x, *, train: bool = False):
        h = x
        if self.expand != 1:
            h = swish(self.exp_bn(self.exp_conv(h), train=train))
        h = swish(self.dw_bn(self.dw(h), train=train))
        h = self.se(h)
        h = self.proj_bn(self.proj(h), train=train)
        if self.stride == 1 and self.c_in == self.c_out:
            h = h + x
        return h


class EfficientNet(nn.Module):
    """Feature extractor emitting C3/C4/C5 (strides 8/16/32)."""

    # (kernel, stride, expand, channels, repeats): the B0 stage table
    STAGES = [(3, 1, 1, 16, 1), (3, 2, 6, 24, 2), (5, 2, 6, 40, 2),
              (3, 2, 6, 80, 3), (5, 1, 6, 112, 3), (5, 2, 6, 192, 4),
              (3, 1, 6, 320, 1)]
    FEATURE_STAGES = (2, 4, 6)      # stage indices producing C3, C4, C5

    def __init__(self, cfg: EfficientDetConfig, *, generator=None):
        super().__init__()
        w, d = cfg.backbone_width, cfg.backbone_depth
        stem_c = _round_channels(32, w)
        self.stem = _conv(3, stem_c, (3, 3), 2, generator=generator)
        self.stem_bn = BatchNorm(stem_c)
        blocks, self.block_stage = [], []
        c_prev = stem_c
        for si, (k, stride, e, c, r) in enumerate(self.STAGES):
            c_out = _round_channels(c, w)
            for i in range(_round_repeats(r, d)):
                blocks.append(MBConv(c_prev, c_out, k,
                                     stride if i == 0 else 1, e,
                                     generator=generator))
                self.block_stage.append(si)
                c_prev = c_out
        self.blocks = nn.ModuleList(blocks)
        self.feature_channels = [_round_channels(self.STAGES[si][3], w)
                                 for si in self.FEATURE_STAGES]

    def forward(self, x, *, train: bool = False):
        h = swish(self.stem_bn(self.stem(x), train=train))
        feats = []
        n = len(self.blocks)
        for i, b in enumerate(self.blocks):
            h = b(h, train=train)
            # the feature comes AFTER the last block of a feature stage
            last = i + 1 == n or self.block_stage[i + 1] != \
                self.block_stage[i]
            if last and self.block_stage[i] in self.FEATURE_STAGES:
                feats.append(h)
        return feats                     # [C3, C4, C5]


# ------------------------------------------------------------------- BiFPN

def _resize_nearest(x, h: int, w: int):
    """Nearest resize of (N, C, H, W) to (h, w): source row ``i * H // h``
    and column ``j * W // w``, integer arithmetic as in the JAX package."""
    H, W = x.shape[2], x.shape[3]
    ry = torch.arange(h, device=x.device) * H // h
    rx = torch.arange(w, device=x.device) * W // w
    return x.index_select(2, ry).index_select(3, rx)


class SepConv(nn.Module):
    """Depthwise-separable conv, no norm: the head convolutions, shared
    across pyramid levels."""

    def __init__(self, c_in: int, c_out: int, *, generator=None):
        super().__init__()
        self.dw = _dwconv(c_in, (3, 3), generator=generator)
        self.pw = _conv(c_in, c_out, (1, 1), bias=True, generator=generator)

    def forward(self, x):
        return self.pw(self.dw(x))


class SepConvBN(nn.Module):
    """Depthwise-separable conv + BatchNorm: the BiFPN's conv unit."""

    def __init__(self, c_in: int, c_out: int, *, generator=None):
        super().__init__()
        self.dw = _dwconv(c_in, (3, 3), generator=generator)
        self.pw = _conv(c_in, c_out, (1, 1), bias=True, generator=generator)
        self.bn = BatchNorm(c_out)

    def forward(self, x, *, train: bool = False):
        return self.bn(self.pw(self.dw(x)), train=train)


class BiFPNLayer(nn.Module):
    """One top-down and bottom-up pass with fast normalised fusion:
    ``relu(w) / (sum(relu(w)) + 1e-4)`` over the parameters ``w_td``
    [n - 1, 2] and ``w_bu`` [n - 1, 3]."""

    def __init__(self, n_levels: int, channels: int, *, generator=None):
        super().__init__()
        self.n = n_levels
        self.td_convs = nn.ModuleList(
            SepConvBN(channels, channels, generator=generator)
            for _ in range(n_levels - 1))
        self.bu_convs = nn.ModuleList(
            SepConvBN(channels, channels, generator=generator)
            for _ in range(n_levels - 1))
        self.w_td = nn.Parameter(torch.ones(n_levels - 1, 2))
        self.w_bu = nn.Parameter(torch.ones(n_levels - 1, 3))

    @staticmethod
    def _fuse(ws, inputs):
        w = F.relu(ws)
        w = w / (w.sum() + 1e-4)
        out = 0
        for i, x in enumerate(inputs):
            out = out + w[i] * x
        return out

    def forward(self, feats: List[torch.Tensor], *, train: bool = False):
        n = self.n
        td = [None] * n
        td[n - 1] = feats[n - 1]
        for i in range(n - 2, -1, -1):          # top-down: P7 -> P3
            up = _resize_nearest(td[i + 1], feats[i].shape[2],
                                 feats[i].shape[3])
            fused = self._fuse(self.w_td[i], [feats[i], up])
            td[i] = self.td_convs[i](swish(fused), train=train)
        out = [None] * n
        out[0] = td[0]
        for i in range(1, n):                   # bottom-up: P3 -> P7
            down = _resize_nearest(out[i - 1], feats[i].shape[2],
                                   feats[i].shape[3])
            fused = self._fuse(self.w_bu[i - 1], [feats[i], td[i], down])
            out[i] = self.bu_convs[i - 1](swish(fused), train=train)
        return out


# ---------------------------------------------------------------- the model

class EfficientDet(nn.Module):
    """``forward(images, train=False)``: NHWC images [B, H, W, 3] ->
    (class logits [B, A_total, K], box regressions [B, A_total, 4]); in
    training the BatchNorms update their moving stats in place."""

    def __init__(self, cfg: EfficientDetConfig, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        kw = dict(generator=gen)
        self.backbone = EfficientNet(cfg, **kw)
        ch = cfg.fpn_channels
        n_levels = len(cfg.levels)
        self.lateral = nn.ModuleList(
            _conv(c, ch, (1, 1), bias=True, **kw)
            for c in self.backbone.feature_channels)
        self.extra = nn.ModuleList(                      # P6, P7
            _conv(ch, ch, (3, 3), 2, bias=True, **kw)
            for _ in range(n_levels - 3))
        self.fpn = nn.ModuleList(BiFPNLayer(n_levels, ch, **kw)
                                 for _ in range(cfg.fpn_layers))
        self.class_convs = nn.ModuleList(SepConv(ch, ch, **kw)
                                         for _ in range(cfg.head_layers))
        self.box_convs = nn.ModuleList(SepConv(ch, ch, **kw)
                                       for _ in range(cfg.head_layers))
        self.class_bns = nn.ModuleList(
            nn.ModuleList(BatchNorm(ch) for _ in range(n_levels))
            for _ in range(cfg.head_layers))
        self.box_bns = nn.ModuleList(
            nn.ModuleList(BatchNorm(ch) for _ in range(n_levels))
            for _ in range(cfg.head_layers))
        self.class_out = _conv(ch, cfg.num_anchors * cfg.num_classes,
                               (3, 3), bias=True, **kw)
        self.box_out = _conv(ch, cfg.num_anchors * 4, (3, 3), bias=True,
                             **kw)
        # the focal-loss prior: initial foreground probability 0.01
        with torch.no_grad():
            self.class_out.b.fill_(-math.log((1 - 0.01) / 0.01))
        self.to(resolve_device(device))

    def _head(self, convs, bns, out_conv, level, li, width, train):
        h = level
        for i, conv in enumerate(convs):
            h = swish(bns[i][li](conv(h), train=train))
        y = out_conv(h)
        B, _, H, W = y.shape
        # NHWC before the reshape: anchor order is (y, x, anchor)
        return y.permute(0, 2, 3, 1).reshape(
            B, H * W * self.cfg.num_anchors, width)

    def forward(self, images, *, train: bool = False):
        cfg = self.cfg
        with precision(PRECISION):
            x = images.permute(0, 3, 1, 2)
            feats = self.backbone(x, train=train)
            levels = [lat(f) for lat, f in zip(self.lateral, feats)]
            h = levels[-1]
            for conv in self.extra:
                h = conv(h)
                levels.append(h)
            for layer in self.fpn:
                levels = layer(levels, train=train)
            cls_out, box_out = [], []
            for li, lv in enumerate(levels):
                cls_out.append(self._head(self.class_convs, self.class_bns,
                                          self.class_out, lv, li,
                                          cfg.num_classes, train))
                box_out.append(self._head(self.box_convs, self.box_bns,
                                          self.box_out, lv, li, 4, train))
        return torch.cat(cls_out, 1), torch.cat(box_out, 1)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


# ----------------------------------------------------------------- anchors

def generate_anchors(cfg: EfficientDetConfig) -> np.ndarray:
    """[A_total, 4] (ymin, xmin, ymax, xmax) in pixels, level by level,
    then cell by cell (y, x), then octave, then aspect ratio."""
    boxes = []
    size = cfg.image_size
    for level in cfg.levels:
        stride = 2 ** level
        feat = max(1, size // stride)
        for y in range(feat):
            for x in range(feat):
                cy, cx = (y + 0.5) * stride, (x + 0.5) * stride
                for octave in range(cfg.num_scales):
                    base = (cfg.anchor_scale * stride *
                            2 ** (octave / cfg.num_scales))
                    for ar in cfg.aspect_ratios:
                        h = base / math.sqrt(ar)
                        w = base * math.sqrt(ar)
                        boxes.append((cy - h / 2, cx - w / 2,
                                      cy + h / 2, cx + w / 2))
    return np.asarray(boxes, np.float32)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU [..., N, M] of boxes a [..., N, 4] and b [..., M, 4] (ymin,
    xmin, ymax, xmax)."""
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0) * \
        (a[..., 3] - a[..., 1]).clamp_min(0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0) * \
        (b[..., 3] - b[..., 1]).clamp_min(0)
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter
                    + 1e-8)


def _centres(anchors):
    ah = anchors[..., 2] - anchors[..., 0]
    aw = anchors[..., 3] - anchors[..., 1]
    return ah, aw, anchors[..., 0] + ah / 2, anchors[..., 1] + aw / 2


def encode_boxes(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Anchor-relative (ty, tx, th, tw) regression targets."""
    ah, aw, acy, acx = _centres(anchors)
    gh = (gt[..., 2] - gt[..., 0]).clamp_min(1e-3)
    gw = (gt[..., 3] - gt[..., 1]).clamp_min(1e-3)
    gcy = gt[..., 0] + gh / 2
    gcx = gt[..., 1] + gw / 2
    return torch.stack([(gcy - acy) / ah, (gcx - acx) / aw,
                        torch.log(gh / ah), torch.log(gw / aw)], -1)


def decode_boxes(regs: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    ah, aw, acy, acx = _centres(anchors)
    cy = regs[..., 0] * ah + acy
    cx = regs[..., 1] * aw + acx
    # clamped: an untrained anchor must not overflow exp
    h = torch.exp(regs[..., 2].clamp(-4.0, 4.0)) * ah
    w = torch.exp(regs[..., 3].clamp(-4.0, 4.0)) * aw
    return torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)


# ------------------------------------------------------------------- losses

def _last_writer(index: torch.Tensor) -> torch.Tensor:
    """[B, G] bool: entry g is the last (highest g) of its row to carry
    its index. The JAX package's ``.at[index].set`` on the CPU lets the
    last of duplicate indices win; a CUDA scatter with duplicates keeps
    any one of them, so only the last writers scatter."""
    G = index.shape[1]
    same = index[:, :, None] == index[:, None, :]          # [B, G, G']
    later = torch.ones(G, G, dtype=torch.bool, device=index.device).triu(1)
    return ~(same & later).any(-1)


def _set_last(values: torch.Tensor, index: torch.Tensor,
              updates: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """``values.at[index].set(updates)`` per row, duplicates resolved as
    :func:`_last_writer` says: the others go to a spare column that is
    dropped."""
    A = values.shape[1]
    spare = torch.cat([values, values[:, :1]], 1)
    return spare.scatter(1, torch.where(last, index, A), updates)[:, :A]


def assign_targets(gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                   n_gt: torch.Tensor, anchors: torch.Tensor,
                   pos_iou: float = 0.5, neg_iou: float = 0.5):
    """Batched target assignment (the anchor labeler): padded gt_boxes
    [B, G, 4], gt_classes [B, G], n_gt [B], anchors [A, 4] ->
    (cls_targets [B, A] int {-2 ignore, -1 background, >= 0 class},
    box_targets [B, A, 4], positive mask [B, A]). Each valid ground truth
    is force-matched to its best anchor, class and box target alike."""
    B, G = gt_classes.shape
    dev = gt_boxes.device
    gidx = torch.arange(G, device=dev)
    valid = gidx[None, :] < n_gt[:, None]                   # [B, G]
    iou = box_iou(anchors[None], gt_boxes)                  # [B, A, G]
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.max(2)                          # [B, A]
    best_anchor = iou.argmax(1)                             # [B, G]
    last = _last_writer(best_anchor)
    best_gt = _set_last(best_gt, best_anchor, torch.where(
        valid, gidx[None, :].expand(B, G),
        best_gt.gather(1, best_anchor)), last)
    gt_classes = gt_classes.to(torch.int64)
    neg1 = torch.full_like(best_gt, -1)
    cls = torch.where(best_iou >= pos_iou, gt_classes.gather(1, best_gt),
                      neg1)
    cls = torch.where((best_iou >= neg_iou) & (best_iou < pos_iou),
                      torch.full_like(cls, -2), cls)
    cls = _set_last(cls, best_anchor, torch.where(
        valid, gt_classes, cls.gather(1, best_anchor)), last)
    matched = gt_boxes.gather(1, best_gt[..., None].expand(B, -1, 4))
    box_t = encode_boxes(matched, anchors[None])
    return cls, box_t, cls >= 0


def sigmoid_ce(logits, labels):
    return logits.clamp_min(0) - logits * labels + \
        torch.log1p(torch.exp(-logits.abs()))


def focal_loss(logits: torch.Tensor, cls_targets: torch.Tensor,
               num_classes: int, alpha: float = 0.25,
               gamma: float = 1.5) -> torch.Tensor:
    """Sigmoid focal loss summed over anchors and classes of the last two
    dims (a leading batch dim gives one sum a row); label -2 (ignore)
    contributes zero."""
    onehot = F.one_hot(cls_targets.clamp_min(0), num_classes).to(
        logits.dtype)
    onehot = torch.where((cls_targets >= 0)[..., None], onehot,
                         torch.zeros_like(onehot))
    p = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, onehot)
    p_t = onehot * p + (1 - onehot) * (1 - p)
    a_t = onehot * alpha + (1 - onehot) * (1 - alpha)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    kept = (cls_targets != -2)[..., None]
    return torch.where(kept, loss, torch.zeros_like(loss)).sum((-2, -1))


def huber_loss(pred, target, delta: float = 0.1):
    abs_err = (pred - target).abs()
    quad = abs_err.clamp_max(delta)
    return 0.5 * quad ** 2 + delta * (abs_err - quad)


def detection_loss(cls_logits, box_regs, gt_boxes, gt_classes, n_gt,
                   anchors, cfg: EfficientDetConfig,
                   box_weight: float = 50.0) -> Dict[str, torch.Tensor]:
    """Batched total detection loss: per image focal and Huber box loss
    over the positive count (at least 1), then the batch mean."""
    cls_t, box_t, pos = assign_targets(gt_boxes, gt_classes, n_gt, anchors)
    n_pos = pos.sum(1).clamp_min(1).to(cls_logits.dtype)
    c_loss = focal_loss(cls_logits, cls_t, cfg.num_classes) / n_pos
    hub = huber_loss(box_regs, box_t)
    b_loss = torch.where(pos[..., None], hub, torch.zeros_like(hub)).sum(
        (1, 2)) / n_pos
    c_loss, b_loss = c_loss.mean(), b_loss.mean()
    return {"loss": c_loss + box_weight * b_loss, "class_loss": c_loss,
            "box_loss": b_loss}


# -------------------------------------------------------------- postprocess

def nms_host(boxes: np.ndarray, scores: np.ndarray,
             iou_thresh: float = 0.5, max_out: int = 100) -> List[int]:
    """Greedy NMS on the host (numpy, ``np.argsort``'s default kind, as
    in the JAX package)."""
    order = np.argsort(-scores)
    keep = []
    while order.size and len(keep) < max_out:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        tl = np.maximum(boxes[i, :2], boxes[rest, :2])
        br = np.minimum(boxes[i, 2:], boxes[rest, 2:])
        wh = np.maximum(br - tl, 0)
        inter = wh[:, 0] * wh[:, 1]
        area_i = max((boxes[i, 2] - boxes[i, 0]) *
                     (boxes[i, 3] - boxes[i, 1]), 1e-8)
        area_r = np.maximum((boxes[rest, 2] - boxes[rest, 0]) *
                            (boxes[rest, 3] - boxes[rest, 1]), 1e-8)
        iou = inter / (area_i + area_r - inter)
        order = rest[iou <= iou_thresh]
    return keep


def postprocess(cls_logits, box_regs, anchors, *, score_thresh: float = 0.3,
                iou_thresh: float = 0.5, max_out: int = 100):
    """Per image, (boxes [n, 4], scores [n], classes [n]) numpy arrays:
    sigmoid and box decoding on the logits' device, the best class per
    anchor, the score threshold and NMS on the host."""
    probs = torch.sigmoid(cls_logits)
    anchors_t = torch.as_tensor(anchors, device=box_regs.device)
    boxes_np = decode_boxes(box_regs, anchors_t).detach().cpu().numpy()
    probs_np = probs.detach().cpu().numpy()
    out = []
    for b in range(probs_np.shape[0]):
        score = probs_np[b].max(-1)
        klass = probs_np[b].argmax(-1)
        sel = score >= score_thresh
        bx, sc, kl = boxes_np[b][sel], score[sel], klass[sel]
        keep = nms_host(bx, sc, iou_thresh, max_out)
        out.append((bx[keep], sc[keep], kl[keep]))
    return out


def efficientdet_d0(*, device="cuda", seed: int = 0, **kw) -> EfficientDet:
    return EfficientDet(EfficientDetConfig.d0(**kw), device=device,
                        seed=seed)


def efficientdet_tiny(*, device="cuda", seed: int = 0, **kw
                      ) -> EfficientDet:
    return EfficientDet(EfficientDetConfig.tiny(**kw), device=device,
                        seed=seed)
