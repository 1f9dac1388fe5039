"""Padding buckets and the block-sparse routing rule of the serving layer.

Counterpart of the framework-neutral part of ``tosem_tpu/data/feeding.py``
that the port's backends need: :func:`bucket_for` and
:func:`sparse_mask_spec`, copied (the JAX package's module imports JAX).
"""
from __future__ import annotations

from typing import Optional, Sequence


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
