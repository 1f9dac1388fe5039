"""Padding buckets and the block-sparse routing rule of the serving layer.

Counterpart of the framework-neutral part of ``tosem_tpu/data/feeding.py``
that the port's backends and serving queues need:
:func:`bucket_boundaries`, :func:`bucket_for`, :func:`sparse_mask_spec`
and :func:`pad_target`, copied (the JAX package's module imports JAX).
The speech batchers wait for ROADMAP.md A13.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np


def bucket_boundaries(lengths: Sequence[int], n_buckets: int) -> List[int]:
    """Quantile pad-target palette: one step callable per bucket."""
    qs = np.quantile(np.asarray(lengths, float),
                     np.linspace(0, 1, n_buckets + 1)[1:])
    out: List[int] = []
    for q in qs:
        b = int(math.ceil(q))
        if not out or b > out[-1]:
            out.append(b)
    return out


def bucket_for(length: int, boundaries: Sequence[int]) -> Optional[int]:
    """Smallest palette bucket that fits ``length``, or None when it
    exceeds the largest bucket: the one routing rule the training
    batcher and the serving bucket router share."""
    for b in boundaries:
        if length <= b:
            return b
    return None


def sparse_mask_spec(pad_t: int, *, local_window: Optional[int] = None,
                     doc_len: Optional[int] = None) -> Optional[str]:
    """Which block-sparse mask spec a batch padded to ``pad_t`` should
    ride, or None for the dense path.

    A sliding window pays only once the bucket spans more than twice the
    window (below that the band covers every block), and document
    packing only once a row holds more than one document. Windowed
    buckets get the symmetric encoder band ``local:W:W-1`` (W keys of
    left context incl. self, W-1 right); doc-packed buckets get the
    block-diagonal ``doc:L``. Both compose, documents first, and either
    way the request's key-padding mask still applies as segment ids."""
    specs = []
    if doc_len is not None and doc_len >= 1 and pad_t > doc_len:
        specs.append(f"doc:{doc_len}")
    if local_window is not None and local_window >= 1 \
            and pad_t > 2 * local_window:
        specs.append(f"local:{local_window}:{local_window - 1}")
    return "+".join(specs) if specs else None


def pad_target(length: int, boundaries: Sequence[int],
               align: int = 1) -> int:
    """Pad target for a sequence at serving time: its palette bucket
    when one fits, else ``length`` rounded up to ``align`` (overlong
    requests can't be dropped the way the training batcher drops them —
    they get their own aligned shape, keeping e.g. flash-attention tile
    eligibility where possible)."""
    b = bucket_for(length, boundaries)
    if b is not None:
        return b
    return int(math.ceil(length / align) * align) if align > 1 else length
