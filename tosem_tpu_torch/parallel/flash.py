"""Sharded flash and paged attention: the kernels under ``shard_map``.

Counterpart of ``tosem_tpu/parallel/flash.py``. Each position of a
``(dp, tp)`` mesh runs the unmodified single-device op on its block:
:func:`~tosem_tpu_torch.ops.flash_attention.flash_attention` (B1, dense,
segment ids or schedule mode) and
:func:`~tosem_tpu_torch.ops.paged_attention.paged_attention` (B4, or B5
with ``q_rows``, ``window`` or ``page_offsets``). The batch splits over
the data axis and the heads over the model axis; the sequence stays
whole (sequence sharding is :mod:`tosem_tpu_torch.parallel.ring`'s job).
Attention reduces only within a (batch row, head) cell, and both
kernels give a cell the same bits whatever else the launch holds, so a
sharded call equals the unsharded one bit for bit.

Block-sparse masks shard with the heads. A uniform mask compiles the
same schedule inside every position. A
:class:`~tosem_tpu_torch.ops.mask_programs.MultiHeadMask` is compiled
ONCE for the full head set, and each position runs the schedule rows of
its own heads with the whole bitmap pool (ids are pool-global): the JAX
package's ``_program_specs``. On the CPU the plain version runs the
position's slice of the head masks.
"""
from __future__ import annotations

from typing import Optional

import torch

from tosem_tpu_torch.ops.flash_attention import SegmentIds, flash_attention
from tosem_tpu_torch.ops.flash_blocks import select_block_sizes
from tosem_tpu_torch.ops.mask_programs import (BlockSchedule, CausalMask,
                                               Mask, MaskPrograms,
                                               MultiHeadMask,
                                               compile_mask_programs)
from tosem_tpu_torch.parallel.mesh import Mesh, _all_cards
from tosem_tpu_torch.parallel.spmd import P, axis_index, shard_map


def dp_tp_mesh(dp: int, tp: int, devices=None) -> Mesh:
    """The conventional ``(dp, tp)`` mesh over the first ``dp * tp`` of
    ``devices`` (one entry a position; e.g. ``["cuda:0"] * 4`` for four
    positions on one card). With no ``devices`` it takes every card, one
    position each, and fails loudly when there are fewer than ``dp * tp``."""
    import numpy as np
    devs = list(devices) if devices is not None else _all_cards()
    if dp < 1 or tp < 1:
        raise ValueError(f"sharding axes must be >= 1, got ({dp}, {tp})")
    if len(devs) < dp * tp:
        raise ValueError(
            f"sharding ({dp}, {tp}) needs {dp * tp} positions, got "
            f"{len(devs)} devices (pass devices=[device] * {dp * tp} to "
            "put several positions on one device)")
    arr = np.empty(dp * tp, dtype=object)
    arr[:] = devs[:dp * tp]
    return Mesh(arr.reshape(dp, tp), ("dp", "tp"))


def _check_axes(mesh: Mesh, data_axis, model_axis) -> None:
    if data_axis not in mesh.axis_names:
        raise ValueError(f"data axis {data_axis!r} not in mesh "
                         f"{mesh.axis_names}")
    if model_axis is not None and model_axis not in mesh.axis_names:
        raise ValueError(f"model axis {model_axis!r} not in mesh "
                         f"{mesh.axis_names}")


def _int32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def sharded_paged_attention(mesh: Mesh, *,
                            sm_scale: Optional[float] = None,
                            window: Optional[int] = None,
                            data_axis: str = "dp",
                            model_axis: Optional[str] = "tp",
                            backend: Optional[str] = None):
    """Model-sharded paged decode attention: ``run(q, k_pages, v_pages,
    block_tables, seq_lens, q_rows=None, page_offsets=None) -> out``
    over ``mesh``, by :func:`~tosem_tpu_torch.ops.paged_attention.
    paged_partition_specs`: the KV pools shard their HEAD dim over
    ``model_axis`` (each position owns its heads' slice of every page),
    q shards batch over ``data_axis`` and heads over ``model_axis``, and
    the per-sequence operands follow the batch. Each position runs
    :func:`~tosem_tpu_torch.ops.paged_attention.paged_attention` on its
    blocks, so the result equals the unsharded kernel's bit for bit.
    ``window`` is fixed when the callable is built, as in the JAX
    package; ``q_rows`` and ``page_offsets`` are per call. Integer
    operands may be arrays; they become int32 tensors on q's device."""
    from tosem_tpu_torch.ops.paged_attention import (paged_attention,
                                                     paged_partition_specs)
    _check_axes(mesh, data_axis, model_axis)

    def body(q, kp, vp, bt, sl, kr, po):
        return paged_attention(q, kp, vp, bt, sl, sm_scale=sm_scale,
                               backend=backend, q_rows=kr, window=window,
                               page_offsets=po)

    def run(q, k_pages, v_pages, block_tables, seq_lens, q_rows=None,
            page_offsets=None):
        specs = paged_partition_specs(data_axis, model_axis,
                                      multi=q.ndim == 4)
        dev = q.device
        ints = [None if x is None else _int32(x, dev)
                for x in (q_rows, page_offsets)]
        fn = shard_map(body, mesh, in_specs=(
            specs["q"], specs["kv_pages"], specs["kv_pages"],
            specs["block_tables"], specs["seq_lens"],
            specs["q_rows"] if q_rows is not None else P(),
            specs["page_offsets"] if page_offsets is not None else P()),
            out_specs=specs["out"])
        return fn(q, k_pages, v_pages, _int32(block_tables, dev),
                  _int32(seq_lens, dev), *ints)

    return run


def _head_slice(programs: MaskPrograms, lo: int, hi: int) -> MaskPrograms:
    """The schedule rows of heads ``[lo, hi)`` of every direction, with
    the whole bitmap pool."""
    def cut(s: BlockSchedule) -> BlockSchedule:
        return BlockSchedule(num=s.num[lo:hi], blk=s.blk[lo:hi],
                             kind=s.kind[lo:hi], mid=s.mid[lo:hi],
                             mask_blocks=s.mask_blocks)
    return MaskPrograms(*(cut(s) for s in programs))


def sharded_flash_attention(mesh: Mesh, *, causal: bool = False,
                            sm_scale: Optional[float] = None,
                            data_axis: str = "dp",
                            model_axis: Optional[str] = "tp",
                            layout: str = "bthd",
                            block_sizes=None,
                            mask: Optional[Mask] = None,
                            backend: Optional[str] = None):
    """``run(q, k, v, segment_ids=None) -> out`` over ``mesh``.

    q/k/v use ``layout`` ("bthd" = [B, T, H, D], "bhtd"); batch shards
    over ``data_axis``, heads over ``model_axis`` (None for a data-only
    mesh), and ``segment_ids`` shard their batch with q/k/v. Each position
    calls :func:`~tosem_tpu_torch.ops.flash_attention.flash_attention`
    with the arguments the unsharded call takes. ``mask`` runs the
    schedule mode: a uniform mask in every position, a
    :class:`~tosem_tpu_torch.ops.mask_programs.MultiHeadMask` compiled
    once for all heads (at ``block_sizes``, default the kernels' tiles)
    and sliced by head over ``model_axis``."""
    _check_axes(mesh, data_axis, model_axis)
    if layout == "bthd":
        op_spec = P(data_axis, None, model_axis, None)
        h_dim, t_dim = 2, 1
    elif layout == "bhtd":
        op_spec = P(data_axis, model_axis, None, None)
        h_dim, t_dim = 1, 2
    else:
        raise ValueError(f"unknown layout {layout!r}")
    seg_spec = SegmentIds(P(data_axis, None), P(data_axis, None))
    eff_mask = mask & CausalMask() if causal and mask is not None else mask
    per_head = isinstance(eff_mask, MultiHeadMask)
    tp = mesh.shape[model_axis] if model_axis is not None else 1
    if per_head and len(eff_mask.masks) % tp:
        raise ValueError(
            f"MultiHeadMask has {len(eff_mask.masks)} head masks, not "
            f"divisible over {tp} '{model_axis}' shards")
    # (id(programs), ...) -> (programs, [its head slices]): one object per
    # slice, so each is uploaded to the device once
    slices = {}

    def head_slices(q, k):
        H, d = q.shape[h_dim], q.shape[-1]
        Tq, Tk = q.shape[t_dim], k.shape[t_dim]
        blocks = block_sizes or select_block_sizes(
            Tq, d, str(q.dtype).replace("torch.", ""), Tk,
            mask_sig=eff_mask.signature(), backend=backend)
        programs = compile_mask_programs(eff_mask, Tq, Tk, blocks, heads=H)
        hit = slices.get(id(programs))
        if hit is None:
            hl = H // tp
            hit = slices[id(programs)] = (programs, [
                (_head_slice(programs, i * hl, (i + 1) * hl),
                 MultiHeadMask(eff_mask.masks[i * hl:(i + 1) * hl]))
                for i in range(tp)])
        return hit[1]

    def run(q, k, v, segment_ids: Optional[SegmentIds] = None):
        parts = head_slices(q, k) if per_head else None

        def body(q, k, v, seg):
            if parts is None:
                return flash_attention(q, k, v, sm_scale, causal,
                                       segment_ids=seg, layout=layout,
                                       mask=mask, backend=backend)
            i = axis_index(model_axis) if model_axis is not None else 0
            programs, sub_mask = parts[i]
            # the kernels run the sliced schedule; the plain version
            # folds the position's head masks
            return flash_attention(q, k, v, sm_scale, False,
                                   segment_ids=seg, layout=layout,
                                   mask=sub_mask, programs=programs,
                                   backend=backend)
        fn = shard_map(body, mesh, in_specs=(
            op_spec, op_spec, op_spec,
            seg_spec if segment_ids is not None else P()),
            out_specs=op_spec)
        return fn(q, k, v, segment_ids)

    return run
