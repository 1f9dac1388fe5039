"""Device meshes, SPMD and the sharded ops: the counterpart of
``tosem_tpu/parallel``.

A :class:`~tosem_tpu_torch.parallel.mesh.Mesh` is an array of positions
under named axes, each on a ``torch.device`` (several may share one);
:func:`~tosem_tpu_torch.parallel.spmd.shard_map` runs a body once per
position, each in its own thread, with the ``lax``-style collectives
between them. On top: the collective ops and their bandwidth sweep
(north-star config 3), rule-based sharding, sharded flash and paged
attention, and ring/Ulysses sequence parallelism. ``pipeline.py``,
``cluster.py``, ``cluster_worker.py`` and ``jobs.py`` are not ported yet
(ROADMAP.md A10). Submodules import lazily.
"""

# exported lazily (PEP 562), as the JAX package's parallel/__init__ exports
# them (less the modules not ported yet)
_LAZY_EXPORTS = {
    **{n: ("tosem_tpu_torch.parallel.mesh", n)
       for n in ("Mesh", "MeshSpec", "make_mesh", "default_mesh",
                 "multihost_init", "replicated", "sharded")},
    **{n: ("tosem_tpu_torch.parallel.spmd", n)
       for n in ("P", "Sharded", "shard_map", "psum", "all_gather",
                 "psum_scatter", "ppermute", "all_to_all", "pbroadcast",
                 "axis_index", "axis_size")},
    **{n: ("tosem_tpu_torch.parallel.collectives", n)
       for n in ("CollectiveSpec", "collective_bench",
                 "bus_bandwidth_factor", "DEFAULT_COLLECTIVE_SWEEP",
                 "all_reduce", "all_gather_op", "reduce_scatter_op",
                 "ring_permute", "all_to_all_op", "broadcast")},
    **{n: ("tosem_tpu_torch.parallel.sharding", n)
       for n in ("bert_rules", "image_batch_rules", "seq_batch_rules",
                 "shard_tree", "gather", "spec_for_path", "tree_shardings",
                 "tree_specs")},
    **{n: ("tosem_tpu_torch.parallel.ring", n)
       for n in ("make_ring_attn_fn", "make_ulysses_attn_fn",
                 "ring_attention", "ulysses_attention")},
    **{n: ("tosem_tpu_torch.parallel.flash", n)
       for n in ("dp_tp_mesh", "sharded_flash_attention",
                 "sharded_paged_attention")},
}

__all__ = sorted(_LAZY_EXPORTS)


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    value = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = value
    return value
