"""Multi-head attention: the dense path and the flash dispatch.

Counterpart of ``tosem_tpu/nn/attention.py``. :func:`dot_product_attention`
is the dense reference (masked with ``finfo(float32).min``, as there);
:func:`flash_attn_fn` builds an ``attn_fn`` that sends q/k/v to the flash
kernel (``cuda`` on CUDA tensors, its plain ``torch`` version on CPU
tensors). A ``[B, 1, 1, Tk]`` key-padding mask rides the kernel as
segment ids (q ids all 1, kv ids the mask), so padded batches stay on the
kernel. ``flash_attn_fn(mask=...)`` takes a block-sparse mask program
(``LocalMask``, ``DocumentMask``, ...): the kernels run its schedule, and
the key-padding mask still rides on top as segment ids. Only a query- or
head-dependent dense mask, which no kernel mode covers, takes the dense
path, with causality and the mask program folded in, and that fallback
is counted.
"""
from __future__ import annotations

import collections
import math
from typing import Optional

import torch
from torch import nn

from tosem_tpu_torch.nn.layers import Dense, Dropout
from tosem_tpu_torch.ops.common import precision as _precision


def dot_product_attention(q, k, v, mask=None, *,
                          precision: str = "default"):
    """q, k, v: [B, T, H, D]. mask: broadcastable to [B, H, Tq, Tk]
    (True = keep)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    with _precision(precision):
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask.bool(), logits, torch.full_like(
            logits, torch.finfo(torch.float32).min))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    with _precision(precision):
        return torch.einsum("bhqk,bkhd->bqhd", weights, v)


# dispatch tally: which lowering served each call. Keys are the backend
# names ("cuda", "torch") plus "dense" for the counted dense-mask
# fallback, each also qualified by the mask signature ("cuda:causal",
# "dense:dense", ...); "flash" aggregates every kernel-path call.
FLASH_DISPATCH_COUNTS = collections.Counter({"flash": 0, "dense": 0})


def _tally(served: str, sig: str) -> None:
    FLASH_DISPATCH_COUNTS[served] += 1
    FLASH_DISPATCH_COUNTS[f"{served}:{sig}"] += 1
    if served != "dense":
        FLASH_DISPATCH_COUNTS["flash"] += 1


def _as_key_padding(mask, B: int, Tk: int):
    """[B, Tk] key-padding vector from a broadcastable attention mask, or
    None when the mask is not a pure key mask."""
    if mask is None or mask.ndim != 4:
        return None
    mb, mh, mq, mk = mask.shape
    if (mh, mq) != (1, 1) or mk != Tk or mb not in (1, B):
        return None
    kv = mask[:, 0, 0, :]
    if mb == 1:
        kv = kv.expand(B, Tk)
    return kv


def flash_attn_fn(causal: bool = False, precision: str = "default",
                  mask=None, backend: Optional[str] = None):
    """An ``attn_fn`` for :class:`MultiHeadAttention` that runs the flash
    kernel. ``backend`` (``"cuda"``/``"torch"``) must match the operands'
    device. ``mask`` is a static
    :class:`~tosem_tpu_torch.ops.mask_programs.Mask` (sliding window,
    prefix-LM, packed documents, per-head compositions) compiled once
    into a block schedule, e.g. ``flash_attn_fn(mask=LocalMask(128,
    right=127))`` for a long-document encoder; on the card the sequence
    length must then be a multiple of 64. Every call is tallied in
    :data:`FLASH_DISPATCH_COUNTS` under the backend that served it and
    the effective mask signature (``mask & CausalMask()`` when
    causal)."""
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.ops.flash_attention import (SegmentIds,
                                                     mha_flash_attention)
    if mask is not None:
        from tosem_tpu_torch.ops.mask_programs import CausalMask
        sig = (mask & CausalMask()).signature() if causal \
            else mask.signature()
    else:
        sig = "causal" if causal else "dense"

    def core(q, k, v, attn_mask):
        B, Tq, Tk = q.shape[0], q.shape[1], k.shape[1]
        served = backend or ("cuda" if q.is_cuda else "torch")
        kv_mask = _as_key_padding(attn_mask, B, Tk)
        if attn_mask is None or kv_mask is not None:
            seg = None
            if kv_mask is not None:
                seg = SegmentIds(
                    q=torch.ones((B, Tq), dtype=torch.int32,
                                 device=q.device),
                    kv=kv_mask.to(torch.int32).contiguous())
            out = mha_flash_attention(q, k, v, causal=causal,
                                      segment_ids=seg, mask_program=mask,
                                      backend=backend)
            _tally(served, sig)
            return out
        # a query- or head-dependent dense mask: no kernel mode covers
        # it, so the dense path serves and the event is counted
        registry.FALLBACK_COUNTS[f"flash:{served}->dense"] += 1
        _tally("dense", sig)
        attn_mask = attn_mask.bool()
        if causal:
            cm = torch.tril(torch.ones((Tq, Tk), dtype=torch.bool,
                                       device=q.device))[None, None]
            attn_mask = cm & attn_mask
        if mask is not None:
            # [Tq, Tk] (uniform) or [H, Tq, Tk] (per head), over the batch
            dm = torch.as_tensor(mask.dense(Tq, Tk), device=q.device)
            attn_mask = attn_mask & (dm[None, None] if dm.ndim == 2
                                     else dm[None])
        return dot_product_attention(q, k, v, attn_mask,
                                     precision=precision)
    return core


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, heads: int, *, dropout: float = 0.0,
                 dtype=torch.float32, precision: str = "default",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.dim, self.heads, self.head_dim = dim, heads, dim // heads
        self.precision = precision
        self.q = Dense(dim, dim, dtype=dtype, precision=precision,
                       generator=generator)
        self.k = Dense(dim, dim, dtype=dtype, precision=precision,
                       generator=generator)
        self.v = Dense(dim, dim, dtype=dtype, precision=precision,
                       generator=generator)
        self.o = Dense(dim, dim, dtype=dtype, precision=precision,
                       generator=generator)
        self.drop = Dropout(dropout)

    def forward(self, x, *, mask=None, train: bool = False,
                attn_fn=None, generator: Optional[torch.Generator] = None):
        """``attn_fn`` overrides the core attention (e.g. flash)."""
        B, T, _ = x.shape
        q = self.q(x).reshape(B, T, self.heads, self.head_dim)
        k = self.k(x).reshape(B, T, self.heads, self.head_dim)
        v = self.v(x).reshape(B, T, self.heads, self.head_dim)
        core = attn_fn or (
            lambda q, k, v, mask: dot_product_attention(
                q, k, v, mask, precision=self.precision))
        out = core(q, k, v, mask).reshape(B, T, self.dim)
        out = self.o(out)
        return self.drop(out, train=train, generator=generator)
