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

The autoscaler, cluster serving, the router and admission control wait
for ROADMAP.md A11; the speech backends for A13.
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
}

__all__ = sorted(_LAZY_EXPORTS)


def __getattr__(name: str):
    try:
        mod = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value
