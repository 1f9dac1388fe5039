"""Pipeline-parallel BERT: the encoder stack over a ``pp`` mesh.

Counterpart of ``tosem_tpu/models/bert_pipeline.py``: the embeddings,
``ln_emb`` and ``ln_out`` run outside the pipeline on the caller's
device; the homogeneous encoder stack is split into ``pp`` contiguous
stages whose stacked parameters shard ``P("pp")`` (:mod:`tosem_tpu_torch.
parallel.pipeline`); inside a stage each layer runs in turn with its
slice of the stack. A stage is the model's own ``EncoderLayer`` called
with those tensors (``torch.func.functional_call`` on a parameterless
copy of the layer, one a thread), so a pipelined layer runs the ops the
sequential model runs, on the same microbatch rows.

Scope, as in the JAX package: dense BERT (MoE layers break stage
homogeneity), no padding mask inside the pipelined stack, dropout off.
``attn_fn`` (e.g. ``flash_attn_fn()``) is the layers' attention.
"""
from __future__ import annotations

import copy
import threading
from typing import Dict, Mapping, Optional

import torch
from torch.func import functional_call

from tosem_tpu_torch.models.bert import Bert
from tosem_tpu_torch.parallel.mesh import Mesh
from tosem_tpu_torch.parallel.pipeline import (make_pipeline_fn, microbatch,
                                               unmicrobatch)


def stack_layer_params(params: Mapping[str, torch.Tensor], n_layers: int,
                       n_stages: int) -> Dict[str, torch.Tensor]:
    """``layers.{i}.<name>`` entries of a parameter dict -> ``{<name>:
    [n_stages, per_stage, ...]}``."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into "
                         f"{n_stages} stages")
    per = n_layers // n_stages
    names = [k[len("layers.0."):] for k in params
             if k.startswith("layers.0.")]
    return {n: torch.stack([params[f"layers.{i}.{n}"]
                            for i in range(n_layers)]).reshape(
                                (n_stages, per)
                                + tuple(params[f"layers.0.{n}"].shape))
            for n in names}


def make_bert_pipeline_fn(model: Bert, mesh: Mesh, *, n_micro: int,
                          axis: str = "pp", attn_fn=None):
    """-> ``fwd(params, ids) -> encodings [B, T, dim]`` pipelined over
    ``mesh[axis]``, differentiable. ``params`` is a dict of the model's
    parameters by name (``dict(model.named_parameters())``, or None for
    exactly that); the layer stack is stacked per call."""
    cfg = model.cfg
    if cfg.moe_experts:
        raise ValueError(
            "pipeline BERT requires a homogeneous (dense) encoder stack; "
            "MoE layers have a different parameter structure")
    n_stages = mesh.shape[axis]
    layer = copy.deepcopy(model.layers[0]).to("meta")
    local = threading.local()

    def stage_fn(stage_params, h):
        # one parameterless layer a thread: functional_call swaps the
        # layer's tensors in place for the duration of the call
        skel = getattr(local, "layer", None)
        if skel is None:
            skel = local.layer = copy.deepcopy(layer)
        per = next(iter(stage_params.values())).shape[0]
        for j in range(per):
            h = functional_call(skel, {k: v[j] for k, v in
                                       stage_params.items()}, (h,),
                                {"mask": None, "train": False,
                                 "attn_fn": attn_fn})
        return h

    pipe = make_pipeline_fn(stage_fn, mesh, n_micro=n_micro, axis=axis)

    def fwd(params: Optional[Mapping[str, torch.Tensor]], ids):
        if params is None:
            params = dict(model.named_parameters())
        T = ids.shape[1]
        pos_ids = torch.arange(T, device=ids.device)[None, :]

        def sub(name):
            return {k[len(name) + 1:]: v for k, v in params.items()
                    if k.startswith(name + ".")}
        h = functional_call(model.tok, sub("tok"), (ids,)) + \
            functional_call(model.pos, sub("pos"), (pos_ids,))
        h = functional_call(model.ln_emb, sub("ln_emb"), (h,))
        stacked = stack_layer_params(params, cfg.layers, n_stages)
        h = unmicrobatch(pipe(stacked, microbatch(h, n_micro)))
        return functional_call(model.ln_out, sub("ln_out"), (h,))

    return fwd
