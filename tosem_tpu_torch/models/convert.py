"""Carry JAX-package BERT parameters into the port.

The input is the JAX model's ``Variables["params"]`` as nested dicts of
numpy arrays (``jax.tree_util.tree_map(np.asarray, vs["params"])``); the
output is a ``state_dict`` for :class:`tosem_tpu_torch.models.bert.Bert`.
Names map one to one, except ``layer{i}`` -> ``layers.{i}``. Nothing here
imports JAX: bf16 arrays arrive as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects, so their bits travel as uint16.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^layer(\d+)$")


def array_to_tensor(a) -> torch.Tensor:
    """numpy array (bf16 included) -> CPU tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def bert_params_from_numpy(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested numpy parameter tree -> flat ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            m = _LAYER.match(key) if not prefix else None
            name = f"layers.{m.group(1)}" if m else key
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(val, Mapping):
                walk(val, path)
            else:
                out[path] = array_to_tensor(val)

    walk(tree, "")
    return out


def load_bert_params(model, tree: Mapping) -> None:
    """Load a converted tree into ``model`` (strict: every name must
    match), onto the model's device."""
    model.load_state_dict(bert_params_from_numpy(tree), strict=True)
