"""Sequence/context parallelism: ring attention and Ulysses all-to-all.

Counterpart of ``tosem_tpu/parallel/ring.py``, over the ``sp`` axis of a
mesh, in the ``[B, T, H, D]`` layout:

- **Ring attention** (:func:`ring_attention`): each position keeps its
  query block and accumulates online-softmax attention while the K/V
  blocks travel around the ring (``ppermute``), n - 1 hops. Scores, row
  statistics and the accumulator are fp32 with masked scores at
  ``-1e30``, as in the JAX package.
- **Ulysses** (:func:`ulysses_attention`): ``all_to_all`` re-shards
  [T/sp, H] -> [T, H/sp], runs full attention per head group, and
  converts back. Needs heads divisible by sp.

:func:`make_ring_attn_fn` and :func:`make_ulysses_attn_fn` give the
``attn_fn(q, k, v, mask)`` hook of
:class:`tosem_tpu_torch.nn.attention.MultiHeadAttention` over global
tensors, forward and gradients. Each is a ``torch.autograd.Function``
whose forward is one ``shard_map`` and whose backward is another; the
bodies run without autograd and write their gradients out, so no
autograd graph crosses a collective (on a GPU, PyTorch runs every
backward node of a device on one thread, and position threads that
each ran a backward meeting inside a collective would wait for each
other forever). The ring backward sends dK/dV around the ring with K/V
and one hop more to their owner; the Ulysses backward is the
all-to-all reversed around an explicit attention backward.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from tosem_tpu_torch.parallel.mesh import Mesh
from tosem_tpu_torch.parallel.spmd import (P, all_to_all, axis_index,
                                           axis_size, ppermute, shard_map)

_NEG_INF = -1e30


def _scale(D: int, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)


def _scores(qf, kf, scale, qpos=None, kpos=None):
    """fp32 scores [B, H, Tq, Tk], ``-1e30`` where a key lies after its
    query (causal, by global positions)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if qpos is not None:
        s = torch.where((qpos[:, None] >= kpos[None, :])[None, None], s,
                        torch.full_like(s, _NEG_INF))
    return s


def _ring_positions(axis, Tl, causal, device):
    n, my = axis_size(axis), axis_index(axis)
    if not causal:
        return n, my, None, lambda src: None
    ar = torch.arange(Tl, device=device)
    return n, my, my * Tl + ar, lambda src: src * Tl + ar


def _ring_forward(q, k, v, axis, causal, sm_scale):
    """(out in q's dtype, fp32 LSE [B, H, Tl]) of the local query block
    over the whole ring's keys."""
    B, Tl, H, D = q.shape
    scale = _scale(D, sm_scale)
    n, my, qpos, kpos = _ring_positions(axis, Tl, causal, q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    qf = q.float()
    m = torch.full((B, H, Tl), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Tl, H, D), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for j in range(n):
        src = (my - j) % n                        # owner of k_cur
        s = _scores(qf, k_cur.float(), scale, qpos, kpos(src))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha.permute(0, 2, 1)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, v_cur.float())
        m = m_new
        if j < n - 1:       # the last block is consumed without a hop
            k_cur = ppermute(k_cur, axis, perm)
            v_cur = ppermute(v_cur, axis, perm)
    out = acc / l.permute(0, 2, 1)[..., None]
    return out.to(q.dtype), m + torch.log(l)


def ring_attention(q, k, v, *, axis: str, causal: bool = False,
                   sm_scale: Optional[float] = None):
    """Ring attention over an already-mapped axis: call inside a
    ``shard_map`` body, with q/k/v the position's sequence blocks [B, Tl,
    H, D]. Forward only; :func:`make_ring_attn_fn` differentiates."""
    with torch.no_grad():
        return _ring_forward(q, k, v, axis, causal, sm_scale)[0]


def _ring_backward(q, k, v, out, lse, do, axis, causal, sm_scale):
    """(dq, dk, dv) of the local blocks: dq accumulates here, dK/dV of
    each key block travel with it around the ring and hop once more to
    the block's owner."""
    B, Tl, H, D = q.shape
    scale = _scale(D, sm_scale)
    n, my, qpos, kpos = _ring_positions(axis, Tl, causal, q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    qf, dof = q.float(), do.float()
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1)      # [B, H, Tl]
    dq = torch.zeros((B, Tl, H, D), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    dk_cur = torch.zeros_like(dq)
    dv_cur = torch.zeros_like(dq)
    for j in range(n):
        src = (my - j) % n
        kf, vf = k_cur.float(), v_cur.float()
        p = torch.exp(_scores(qf, kf, scale, qpos, kpos(src))
                      - lse[..., None])
        dv_cur = dv_cur + torch.einsum("bhqk,bqhd->bkhd", p, dof)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf)
        dk_cur = dk_cur + torch.einsum("bhqk,bqhd->bkhd", ds, qf)
        if j < n - 1:
            k_cur = ppermute(k_cur, axis, perm)
            v_cur = ppermute(v_cur, axis, perm)
        dk_cur = ppermute(dk_cur, axis, perm)
        dv_cur = ppermute(dv_cur, axis, perm)
    return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)


def _ulysses_full(x, axis):
    # [B, Tl, H, D] -> [B, T, H/n, D]: split heads, concat sequence
    return all_to_all(x, axis, 2, 1, tiled=True)


def _ulysses_local(x, axis):
    # [B, T, H/n, D] -> [B, Tl, H, D]
    return all_to_all(x, axis, 1, 2, tiled=True)


def _ulysses_probs(q, k, axis, causal, scale):
    n = axis_size(axis)
    if q.shape[2] % n:
        raise ValueError(f"heads {q.shape[2]} must divide by axis size {n}")
    qf, kf = _ulysses_full(q, axis).float(), _ulysses_full(k, axis).float()
    T = qf.shape[1]
    pos = torch.arange(T, device=q.device) if causal else None
    return qf, kf, torch.softmax(_scores(qf, kf, scale, pos, pos), -1)


def _ulysses_forward(q, k, v, axis, causal, sm_scale):
    scale = _scale(q.shape[-1], sm_scale)
    _, _, w = _ulysses_probs(q, k, axis, causal, scale)
    vf = _ulysses_full(v, axis).float()
    out = torch.einsum("bhqk,bkhd->bqhd", w, vf)
    return (_ulysses_local(out.to(q.dtype), axis),)


def ulysses_attention(q, k, v, *, axis: str, causal: bool = False,
                      sm_scale: Optional[float] = None):
    """All-to-all sequence parallelism inside a ``shard_map`` body: local
    blocks [B, Tl, H, D] -> [B, T, H/n, D] -> full attention -> back.
    Forward only; :func:`make_ulysses_attn_fn` differentiates."""
    with torch.no_grad():
        return _ulysses_forward(q, k, v, axis, causal, sm_scale)[0]


def _ulysses_backward(q, k, v, out, do, axis, causal, sm_scale):
    scale = _scale(q.shape[-1], sm_scale)
    qf, kf, w = _ulysses_probs(q, k, axis, causal, scale)
    vf = _ulysses_full(v, axis).float()
    dof = _ulysses_full(do, axis).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", w, dof)
    dw = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = w * (dw - (dw * w).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return tuple(_ulysses_local(g.to(x.dtype), axis)
                 for g, x in ((dq, q), (dk, k), (dv, v)))


class _SequenceParallel(torch.autograd.Function):
    """``fwd(q, k, v) -> (out, *saved)`` and ``bwd(q, k, v, out, *saved,
    do) -> (dq, dk, dv)``, each one shard_map over global tensors."""

    @staticmethod
    def forward(ctx, q, k, v, fwd, bwd):
        out, *saved = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, *saved)
        ctx.bwd = bwd
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = ctx.bwd(*ctx.saved_tensors, do)
        return dq, dk, dv, None, None


def _no_grad(fn):
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


def _attn_fn(name, fwd, bwd):
    def attn_fn(q, k, v, mask=None):
        if mask is not None:
            raise ValueError(f"{name} supports causal/none masks only")
        return _SequenceParallel.apply(q, k, v, fwd, bwd)
    return attn_fn


def make_ring_attn_fn(mesh: Mesh, *, sp: str = "sp", dp: Optional[str] = "dp",
                      tp: Optional[str] = "tp", causal: bool = False):
    """``attn_fn(q, k, v, mask)`` over global [B, T, H, D] tensors, T
    sharded on ``sp`` (``dp``/``tp`` name the axes sharding batch and
    heads, None if unused). Padding masks are refused; causal is handled
    inside the ring with global positions."""
    spec, lse_spec = P(dp, sp, tp, None), P(dp, tp, sp)
    fwd = shard_map(_no_grad(lambda q, k, v: _ring_forward(
        q, k, v, sp, causal, None)), mesh, in_specs=(spec,) * 3,
        out_specs=(spec, lse_spec))
    bwd = shard_map(_no_grad(lambda q, k, v, o, lse, do: _ring_backward(
        q, k, v, o, lse, do, sp, causal, None)), mesh,
        in_specs=(spec,) * 4 + (lse_spec, spec), out_specs=(spec,) * 3)
    return _attn_fn("ring attention", fwd, bwd)


def make_ulysses_attn_fn(mesh: Mesh, *, sp: str = "sp",
                         dp: Optional[str] = "dp", tp: Optional[str] = "tp",
                         causal: bool = False):
    """``attn_fn`` for :func:`ulysses_attention` (the contract of
    :func:`make_ring_attn_fn`)."""
    spec = P(dp, sp, tp, None)
    fwd = shard_map(_no_grad(lambda q, k, v: _ulysses_forward(
        q, k, v, sp, causal, None)), mesh, in_specs=(spec,) * 3,
        out_specs=(spec,))
    bwd = shard_map(_no_grad(lambda q, k, v, o, do: _ulysses_backward(
        q, k, v, o, do, sp, causal, None)), mesh,
        in_specs=(spec,) * 5, out_specs=(spec,) * 3)
    return _attn_fn("ulysses", fwd, bwd)
