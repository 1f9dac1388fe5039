"""Rule-based partition specs: the framework's sharding vocabulary.

Counterpart of ``tosem_tpu/parallel/sharding.py``: a list of ``(regex,
P)`` rules matched (``re.search``, first match wins) against each leaf's
path, and the tree of specs they give. The paths are the port's
parameter names: a ``state_dict``'s dotted names (``layers.0.attn.q.w``)
or, for nested dicts, the keys joined by dots. ``models/convert.py``
transposes no weight (``Dense.w`` is ``[d_in, d_out]`` in both packages),
so each rule's spec is the JAX package's spec of the same parameter.
:func:`shard_tree` cuts each leaf among a mesh's positions
(:class:`~tosem_tpu_torch.parallel.spmd.Sharded`) and :func:`gather`
puts it back together.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Sequence, Tuple

from tosem_tpu_torch.parallel.mesh import Mesh, NamedSharding
from tosem_tpu_torch.parallel.spmd import P, Sharded

# A rule is (pattern, spec); first match (re.search) wins.
Rules = Sequence[Tuple[str, P]]


def spec_for_path(p: str, rules: Rules, default: P = P()) -> P:
    for pat, spec in rules:
        if re.search(pat, p):
            return spec
    return default


def _clip_spec(spec: P, ndim: int) -> P:
    """Drop trailing axes of a spec that exceed the leaf's rank (scalars in
    a tree matched by a 2D rule just replicate)."""
    if len(spec) <= ndim:
        return spec
    return P(*spec[:ndim])


def _map_with_path(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}.{k}" if prefix
                                  else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map_with_path(fn, v, f"{prefix}.{i}" if prefix
                                         else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _leaf_spec(path: str, leaf, rules: Rules, default: P) -> P:
    return _clip_spec(spec_for_path(path, rules, default),
                      getattr(leaf, "ndim", 0))


def tree_specs(tree: Any, rules: Rules, default: P = P()) -> Any:
    """The spec tree of ``tree`` (nested dicts and sequences of tensors),
    leaf by leaf through ``rules``."""
    return _map_with_path(
        lambda path, leaf: _leaf_spec(path, leaf, rules, default), tree)


def tree_shardings(tree: Any, mesh: Mesh, rules: Rules,
                   default: P = P()) -> Any:
    return _map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, _leaf_spec(path, leaf, rules, default)), tree)


def shard_tree(tree: Any, mesh: Mesh, rules: Rules, default: P = P()) -> Any:
    """Every leaf cut among ``mesh``'s positions by its rule's spec."""
    return _map_with_path(
        lambda path, leaf: Sharded.of(
            leaf, mesh, _leaf_spec(path, leaf, rules, default)), tree)


def gather(tree: Any) -> Any:
    """A :func:`shard_tree` result back as global tensors."""
    return _map_with_path(
        lambda path, leaf: leaf.gather() if isinstance(leaf, Sharded)
        else leaf, tree)


# ---------------------------------------------------------------------------
# Canonical rule sets


def bert_rules(tp: str = "tp",
               ep: Optional[str] = None) -> List[Tuple[str, P]]:
    """Megatron-style tensor parallelism for the BERT encoder
    (:mod:`tosem_tpu_torch.models.bert`): QKV and the MLP up-projection
    are column-parallel (output features sharded), the attention output
    and MLP down-projection row-parallel (contraction dim sharded), the
    embeddings shard the feature dim. Everything else (layernorms, biases
    of row-parallel layers) replicates.

    ``ep``: the mesh axis of MoE-BERT's expert stacks
    (``layers.*.moe.*``), needed on a mesh that hosts an MoE config, or
    the E-times FFN weights replicate onto every position. None for dense
    models and meshes without an expert axis."""
    rules = [
        (r"attn\.(q|k|v)\.w$", P(None, tp)),
        (r"attn\.(q|k|v)\.b$", P(tp)),
        (r"attn\.o\.w$", P(tp, None)),
        (r"fc1\.w$", P(None, tp)),
        (r"fc1\.b$", P(tp)),
        (r"fc2\.w$", P(tp, None)),
        (r"(tok|pos|seg)\.table$", P(None, tp)),
    ]
    if ep is not None:
        # from the MoE layer's own spec table, so the two cannot drift
        from tosem_tpu_torch.nn.moe import moe_rules
        rules += [(rf"moe\.{name}$", spec)
                  for name, spec in moe_rules(ep).items()]
    return rules


def seq_batch_rules(dp: str = "dp", sp: Optional[str] = "sp"
                    ) -> List[Tuple[str, P]]:
    """Token batches ([B, T] int tensors): batch over dp, sequence over
    sp (context parallelism; attention over sp is
    :mod:`tosem_tpu_torch.parallel.ring`'s job)."""
    return [(r"", P(dp, sp) if sp else P(dp))]


def image_batch_rules(dp: str = "dp") -> List[Tuple[str, P]]:
    """Image batches ([B, H, W, C] + [B] labels): batch over dp."""
    return [(r"", P(dp))]
