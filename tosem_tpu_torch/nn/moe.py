"""Mixture-of-Experts with expert parallelism (the ``ep`` mesh axis).

Counterpart of ``tosem_tpu/nn/moe.py``: a GShard/Switch-style top-k
routed expert MLP with the JAX package's arithmetic. The router, the
one-hot dispatch and combine tensors and every expert product run in
fp32 with TF32 off; capacity is ``C = ceil(k·N/E · factor)``; a token's
place in its expert's queue is an fp32 ``cumsum`` over the (token,
choice) rows in order, and overflow is dropped by place (its combine
weight is 0, the residual carries it). The aux loss is Switch's
``E · Σ_e f_e · p_e``.

Top-k ties: ``jax.lax.top_k`` gives the lower expert first, and so does
the stable descending sort here (``torch.topk`` promises no order of
ties on CUDA).

Expert parallelism: where the JAX package annotates the expert stacks
``P("ep")`` and lets GSPMD insert the all-to-alls, the port has no
GSPMD. :class:`ExpertParallelMoE` holds each expert stack as its
positions' blocks (:class:`~tosem_tpu_torch.parallel.spmd.Sharded`, E/ep
experts a position) and runs the experts as an ``autograd.Function``
whose forward is one ``shard_map`` (each position's experts, their
outputs combined into a partial ``y`` and summed over ``ep``) and whose
backward is another (each position's expert gradients, the input
gradient summed over ``ep``): no autograd graph crosses a meeting. The
router is computed once, outside, by ordinary autograd.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tosem_tpu_torch.nn.layers import _he_normal, gelu
from tosem_tpu_torch.ops.common import precision

EXPERT_PARAMS = ("w1", "b1", "w2", "b2")


class MoELayer(nn.Module):
    """Top-k routed expert MLP block: [N, d] -> ([N, d], aux).

    ``capacity_factor``: C = ceil(k·N/E · factor). ``k``: experts per
    token (2 = GShard, 1 = Switch). Parameters: ``gate`` [d, E], ``w1``
    [E, d, h], ``b1`` [E, h], ``w2`` [E, h, d], ``b2`` [E, d]."""

    def __init__(self, dim: int, n_experts: int, *, hidden: int = 0,
                 k: int = 2, capacity_factor: float = 1.25,
                 dtype=torch.float32, generator=None):
        super().__init__()
        if k > n_experts:
            raise ValueError(f"k={k} routed experts per token exceeds "
                             f"n_experts={n_experts}")
        self.dim = dim
        self.n_experts = n_experts
        self.hidden = hidden or 4 * dim
        self.k = k
        self.capacity_factor = capacity_factor
        E, d, h = n_experts, dim, self.hidden
        self.gate = nn.Parameter(_he_normal((d, E), d, dtype, generator))
        self.w1 = nn.Parameter(_he_normal((E, d, h), d, dtype, generator))
        self.b1 = nn.Parameter(torch.zeros((E, h), dtype=dtype))
        self.w2 = nn.Parameter(_he_normal((E, h, d), h, dtype, generator))
        self.b2 = nn.Parameter(torch.zeros((E, d), dtype=dtype))

    def capacity(self, n_tokens: int) -> int:
        return capacity(n_tokens, self.k, self.n_experts,
                        self.capacity_factor)

    def forward(self, x):
        """x: [N, dim] -> (y [N, dim] in x's dtype, aux)."""
        dispatch, combine, aux, _ = route(x, self.gate, self.k,
                                          self.capacity_factor)
        out = _experts(dispatch, x.float(), self.w1, self.b1, self.w2,
                       self.b2)[-1]
        with precision("float32"):
            y = torch.einsum("nec,ecd->nd", combine, out).to(x.dtype)
        return y, aux


def capacity(n_tokens: int, k: int, n_experts: int,
             capacity_factor: float) -> int:
    return max(1, math.ceil(k * n_tokens / n_experts * capacity_factor))


def route(x, gate, k: int, capacity_factor: float):
    """Top-k routing of tokens ``x`` [N, d] by ``gate`` [d, E] ->
    (dispatch [N, E, C], combine [N, E, C], aux, dropped): the one-hot
    dispatch (no gradient), the weighted combine and the aux loss (both
    differentiable in ``x`` and the gate) and how many (token, choice)
    rows overflowed their expert's capacity (a tensor)."""
    N = x.shape[0]
    E = gate.shape[1]
    C = capacity(N, k, E, capacity_factor)
    with precision("float32"):
        logits = torch.matmul(x, gate)                         # [N, E]
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]                  # [N, k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    with torch.no_grad():
        sel = F.one_hot(top_e, E).float()                     # [N, k, E]
        flat = sel.reshape(N * k, E)
        pos = torch.cumsum(flat, dim=0) - flat                # queue rank
        pos = (pos * flat).sum(-1).reshape(N, k)
        keep = pos < C                                        # overflow out
        slot = F.one_hot(pos.long().clamp(max=C - 1), C).float() \
            * keep[..., None].float()                         # [N, k, C]
        with precision("float32"):
            dispatch = torch.einsum("nke,nkc->nec", sel, slot)
        dropped = (~keep).sum()
    weight = torch.einsum("nk,nke->ne", top_p, sel)           # [N, E]
    combine = dispatch * weight[..., None]
    f = sel[:, 0].mean(0)
    pbar = probs.mean(0)
    aux = E * torch.sum(f * pbar)
    return dispatch, combine, aux, dropped


def _experts(dispatch, xf, w1, b1, w2, b2):
    """The experts of ``w1``..``b2`` over their dispatched tokens ->
    (xin [E, C, d], pre-activation u [E, C, h], gelu(u), out [E, C, d]),
    fp32 without TF32."""
    with precision("float32"):
        xin = torch.einsum("nec,nd->ecd", dispatch, xf)
        u = torch.einsum("ecd,edh->ech", xin, w1.float()) \
            + b1.float()[:, None, :]
        hh = gelu(u)
        out = torch.einsum("ech,ehd->ecd", hh, w2.float()) \
            + b2.float()[:, None, :]
    return xin, u, hh, out


def _experts_backward(dispatch, combine, xf, w1, b1, w2, b2, gy):
    """(d combine, d x, d w1, d b1, d w2, d b2) of ``y = combine · out``
    over these experts, ``gy`` the gradient of y (fp32)."""
    xin, u, hh, out = _experts(dispatch, xf, w1, b1, w2, b2)
    with precision("float32"):
        g_comb = torch.einsum("nd,ecd->nec", gy, out)
        g_out = torch.einsum("nec,nd->ecd", combine, gy)
        g_w2 = torch.einsum("ech,ecd->ehd", hh, g_out)
        g_hh = torch.einsum("ecd,ehd->ech", g_out, w2.float())
        g_u = torch.ops.aten.gelu_backward(g_hh, u, approximate="tanh")
        g_w1 = torch.einsum("ecd,ech->edh", xin, g_u)
        g_xin = torch.einsum("ech,edh->ecd", g_u, w1.float())
        g_x = torch.einsum("nec,ecd->nd", dispatch, g_xin)
    return (g_comb, g_x, g_w1.to(w1.dtype), g_u.sum(1).to(b1.dtype),
            g_w2.to(w2.dtype), g_out.sum(1).to(b2.dtype))


def moe_rules(ep_axis: str = "ep"):
    """Partition specs of the expert stacks: experts over ``ep``, the
    gate replicated (keys are the layer's parameter names)."""
    from tosem_tpu_torch.parallel.spmd import P
    return {"gate": P(), "w1": P(ep_axis, None, None), "b1": P(ep_axis, None),
            "w2": P(ep_axis, None, None), "b2": P(ep_axis, None)}


def shard_moe_params(params: Dict[str, torch.Tensor], mesh,
                     ep_axis: str = "ep"):
    """``{name: tensor}`` of a :class:`MoELayer` -> ``{name: Sharded}``
    cut by :func:`moe_rules`."""
    from tosem_tpu_torch.parallel.spmd import Sharded
    rules = moe_rules(ep_axis)
    return {k: Sharded.of(v, mesh, rules[k]) for k, v in params.items()}


class _ExpertParallel(torch.autograd.Function):
    """The experts of an :class:`ExpertParallelMoE` (``ep``): forward and
    backward each one shard_map. ``pieces`` are the expert stacks'
    blocks, param by param, position by position."""

    @staticmethod
    def forward(ctx, ep, dispatch, combine, x, *pieces):
        y = ep.forward_experts(dispatch, combine, x, pieces)
        ctx.save_for_backward(dispatch, combine, x, *pieces)
        ctx.ep = ep
        return y

    @staticmethod
    def backward(ctx, gy):
        dispatch, combine, x, *pieces = ctx.saved_tensors
        g_comb, g_x, g_pieces = ctx.ep.backward_experts(dispatch, combine,
                                                        x, pieces, gy)
        return (None, None, g_comb, g_x, *g_pieces)


class ExpertParallelMoE(nn.Module):
    """A :class:`MoELayer` whose experts are cut over the ``axis`` of
    ``mesh``: each expert stack is held as its positions' blocks
    (``self.blocks[name]``, a ``Sharded`` under ``P(axis)``, every piece
    a leaf parameter), the gate replicated. ``forward(x) -> (y, aux)``
    equals the layer's (within the order of the final sum) and is
    differentiable in ``x``, the gate and every block; an optimizer over
    :meth:`parameters` updates the blocks in place, so they stay
    sharded. :meth:`gather` gives the global parameters."""

    def __init__(self, layer: MoELayer, mesh, axis: str = "ep"):
        super().__init__()
        from tosem_tpu_torch.parallel.spmd import P, Sharded, shard_map
        n = mesh.shape[axis]
        if layer.n_experts % n:
            raise ValueError(f"{layer.n_experts} experts do not divide "
                             f"over {axis} = {n} positions")
        self.mesh, self.axis = mesh, axis
        self.k, self.capacity_factor = layer.k, layer.capacity_factor
        self.gate = nn.Parameter(layer.gate.detach().clone())
        rules = moe_rules(axis)
        self.blocks = {}
        self._pieces = nn.ParameterList()
        for name in EXPERT_PARAMS:
            sh = Sharded.of(getattr(layer, name).detach(), mesh, rules[name])
            sh.pieces = [nn.Parameter(p) for p in sh.pieces]
            self.blocks[name] = sh
            self._pieces.extend(sh.pieces)
        self._specs = [rules[name] for name in EXPERT_PARAMS]
        ec = P(None, axis)
        self._fwd = shard_map(_no_grad(self._fwd_body), mesh,
                              in_specs=(ec, ec, P()) + tuple(self._specs),
                              out_specs=P())
        self._bwd = shard_map(_no_grad(self._bwd_body), mesh,
                              in_specs=(ec, ec, P()) + tuple(self._specs)
                              + (P(),),
                              out_specs=(ec, P()) + tuple(self._specs))

    def _fwd_body(self, dispatch, combine, xf, w1, b1, w2, b2):
        from tosem_tpu_torch.parallel.spmd import psum
        out = _experts(dispatch, xf, w1, b1, w2, b2)[-1]
        with precision("float32"):
            part = torch.einsum("nec,ecd->nd", combine, out)
        return psum(part, self.axis)

    def _bwd_body(self, dispatch, combine, xf, w1, b1, w2, b2, gy):
        from tosem_tpu_torch.parallel.spmd import psum
        g_comb, g_x, *g = _experts_backward(dispatch, combine, xf, w1, b1,
                                            w2, b2, gy)
        return (g_comb, psum(g_x, self.axis), *g)

    def _sharded(self, pieces):
        from tosem_tpu_torch.parallel.spmd import Sharded
        n = self.mesh.size
        return [Sharded(self.mesh, spec,
                        [p.detach() for p in pieces[i * n:(i + 1) * n]])
                for i, spec in enumerate(self._specs)]

    def forward_experts(self, dispatch, combine, xf, pieces):
        return self._fwd(dispatch, combine, xf, *self._sharded(pieces))

    def backward_experts(self, dispatch, combine, xf, pieces, gy):
        from tosem_tpu_torch.parallel.spmd import split
        g_comb, g_x, *g = self._bwd(dispatch, combine, xf,
                                    *self._sharded(pieces), gy.float())
        g_pieces = []
        for gt, spec in zip(g, self._specs):
            g_pieces += split(gt, self.mesh, spec)
        return g_comb, g_x, g_pieces

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        dispatch, combine, aux, _ = route(x, self.gate, self.k,
                                          self.capacity_factor)
        y = _ExpertParallel.apply(self, dispatch, combine, x.float(),
                                  *self._pieces)
        return y.to(x.dtype), aux

    def gather(self) -> Dict[str, torch.Tensor]:
        """The global parameters, named as the layer's."""
        from tosem_tpu_torch.parallel.spmd import Sharded
        out = {"gate": self.gate.detach()}
        for name, sh in self.blocks.items():
            out[name] = Sharded(sh.mesh, sh.spec,
                                [p.detach() for p in sh.pieces]).gather()
        return out


def _no_grad(fn):
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run
