"""Serving: the BERT encode/decode backends with their paged KV cache,
prefix cache and step-callable keys, and the control plane that serves
them from replica processes — :class:`Serve` deploys a backend as
runtime actors, :class:`BatchPolicy` micro-batches whole requests into
padding buckets, :class:`DecodePolicy` schedules decode per step
(continuous batching), :class:`CircuitBreaker` guards a deployment and
:class:`HttpIngress` puts HTTP in front.

    serve = Serve()
    serve.deploy("decode", BertDecodeBackend,
                 init_kwargs=dict(preset="base", max_batch=8,
                                  device="cuda"),
                 decode_policy=DecodePolicy(max_active=8))
    ingress = HttpIngress(serve)     # POST /decode?stream=1

Cluster serving places replicas of a backend on node agents and routes
to them through a tier of router processes::

    cs = ClusterServe(pool, num_routers=2)     # pool: a NodePool
    cs.deploy("decode", "tosem_tpu_torch.serve.backends:BertDecodeBackend",
              num_replicas=2, init_kwargs=dict(preset="base"))
    cs.get_handle("decode").call({"ids": [1, 2, 3]}, key="session-1")

with SLO admission (:class:`SLOConfig`, :class:`Overloaded`) and the
autoscalers (:class:`ServeAutoscaler`, ``tosem_tpu_torch.control``). The
speech backends wait for ROADMAP.md A13.
"""
# exported lazily (PEP 562): a replica that unpickles BatchingReplica or a
# queue type imports its own module only, not torch with the backends
_LAZY_EXPORTS = {
    "Serve": "core", "Deployment": "core", "Handle": "core",
    "ServeFuture": "core", "HttpIngress": "http",
    "CircuitBreaker": "breaker", "CircuitOpen": "breaker",
    "BatchPolicy": "batching", "BatchQueue": "batching",
    "BatchedFuture": "batching", "BatchingReplica": "batching",
    "DecodePolicy": "batching", "DecodeQueue": "batching",
    "SamplingPolicy": "batching",
    "BertEncodeBackend": "backends", "BertDecodeBackend": "backends",
    "ShardedAttentionBackend": "backends",
    "ShardedPagedDecodeBackend": "backends",
    "ServeAutoscaler": "autoscale", "ServeScaleConfig": "autoscale",
    "ClusterServe": "cluster_serve", "ClusterDeployment": "cluster_serve",
    "ClusterHandle": "cluster_serve", "PlacementError": "cluster_serve",
    "RouterCore": "router", "RouterPolicy": "router",
    "RemoteRouter": "router", "NoReplicaAvailable": "router",
    "ReplicaAppError": "router",
    # re-exported from the control plane
    "Overloaded": "tosem_tpu_torch.control.admission",
    "SLOConfig": "tosem_tpu_torch.control.admission",
}

__all__ = sorted(_LAZY_EXPORTS)


def __getattr__(name: str):
    try:
        mod = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    if "." not in mod:
        mod = f"{__name__}.{mod}"
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value
