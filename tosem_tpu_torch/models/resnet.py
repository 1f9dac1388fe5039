"""ResNet family (v1.5 bottleneck): north-star config 4.

Counterpart of ``tosem_tpu/models/resnet.py`` (``BottleneckBlock``,
``ResNet``, ``resnet50``, ``resnet18_ish``). The model takes NHWC fp32
images at its boundary, as the data pipeline gives them, casts them to
its dtype and runs ``channels_last`` inside: ``permute(0, 3, 1, 2)`` of
the NHWC batch is a ``channels_last`` NCHW tensor with no copy, which
cuDNN convolves as it is. The head is fp32, as in the JAX package.
``device`` defaults to ``"cuda"``, which raises with no card.

Parameter and buffer names follow the JAX package's trees with
``block{i}`` as ``blocks.{i}`` (``models/convert.py``). Random init
draws from a CPU ``torch.Generator`` seeded by ``seed``, so a seed gives
the same weights on every device (not the JAX package's numbers).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tosem_tpu_torch.ops.common import resolve_device
from tosem_tpu_torch.nn.layers import (BatchNorm, Conv2D, Dense,
                                       avg_pool_global, max_pool, relu)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(dtype) -> torch.dtype:
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


class BottleneckBlock(nn.Module):
    """1x1 reduce -> 3x3 -> 1x1 expand (x4), projection shortcut on a
    shape change. v1.5: the stride lives on the 3x3."""

    expansion = 4

    def __init__(self, c_in: int, width: int, stride: int, *,
                 dtype=torch.float32, precision: str = "default",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c_out = width * self.expansion
        kw = dict(dtype=dtype, precision=precision, generator=generator)
        self.conv1 = Conv2D(c_in, width, (1, 1), **kw)
        self.bn1 = BatchNorm(width, dtype=dtype)
        self.conv2 = Conv2D(width, width, (3, 3), stride, **kw)
        self.bn2 = BatchNorm(width, dtype=dtype)
        self.conv3 = Conv2D(width, c_out, (1, 1), **kw)
        self.bn3 = BatchNorm(c_out, dtype=dtype)
        self.project = c_in != c_out or stride != 1
        if self.project:
            self.conv_proj = Conv2D(c_in, c_out, (1, 1), stride, **kw)
            self.bn_proj = BatchNorm(c_out, dtype=dtype)

    def forward(self, x, *, train: bool = False):
        h = relu(self.bn1(self.conv1(x), train=train))
        h = relu(self.bn2(self.conv2(h), train=train))
        h = self.bn3(self.conv3(h), train=train)
        shortcut = x
        if self.project:
            shortcut = self.bn_proj(self.conv_proj(x), train=train)
        return relu(h + shortcut)


class ResNet(nn.Module):
    """Configurable depth; ``small_inputs`` swaps the 7x7/maxpool stem
    for CIFAR's 3x3 stem. ``forward(x, train=False)`` takes NHWC images
    and gives fp32 logits; in training the BatchNorm layers update their
    moving stats in place."""

    def __init__(self, block_counts: Sequence[int], num_classes: int, *,
                 small_inputs: bool = False, dtype=torch.float32,
                 precision: str = "default", device="cuda", seed: int = 0):
        super().__init__()
        dtype = _dtype(dtype)
        gen = torch.Generator().manual_seed(seed)
        kw = dict(dtype=dtype, precision=precision, generator=gen)
        self.dtype, self.small_inputs = dtype, small_inputs
        self.stem = (Conv2D(3, 64, (3, 3), 1, **kw) if small_inputs
                     else Conv2D(3, 64, (7, 7), 2, **kw))
        self.stem_bn = BatchNorm(64, dtype=dtype)
        blocks, c_in = [], 64
        for stage, count in enumerate(block_counts):
            width = 64 * (2 ** stage)
            for i in range(count):
                stride = 2 if (i == 0 and stage > 0) else 1
                blocks.append(BottleneckBlock(c_in, width, stride, **kw))
                c_in = width * BottleneckBlock.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(c_in, num_classes, dtype=torch.float32,
                          precision=precision, generator=gen)
        self.to(resolve_device(device))

    def forward(self, x, *, train: bool = False):
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        h = relu(self.stem_bn(self.stem(h), train=train))
        if not self.small_inputs:
            h = max_pool(h, 3, 2)
        for block in self.blocks:
            h = block(h, train=train)
        return self.head(avg_pool_global(h).float())

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


def resnet50(num_classes: int = 10, *, small_inputs: bool = True,
             dtype=torch.bfloat16, precision: str = "default",
             device="cuda", seed: int = 0) -> ResNet:
    return ResNet([3, 4, 6, 3], num_classes, small_inputs=small_inputs,
                  dtype=dtype, precision=precision, device=device, seed=seed)


def resnet18_ish(num_classes: int = 10, *, dtype=torch.bfloat16,
                 precision: str = "default", device="cuda",
                 seed: int = 0) -> ResNet:
    """Small bottleneck variant for tests."""
    return ResNet([1, 1], num_classes, small_inputs=True, dtype=dtype,
                  precision=precision, device=device, seed=seed)
