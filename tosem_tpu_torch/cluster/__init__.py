"""The cluster fabric, as far as the port has it: the RPC plane
(``cluster/rpc.py``), node agents (``cluster/node.py``), head-node
supervision (``cluster/supervisor.py``: the journal, the failure
detector, ``NodePool``), gang reservations (``cluster/gang.py``), the
worker-pool autoscaler (``cluster/autoscaler.py``), the chunked tensor
transport (``cluster/transport.py``) and the epoch fences
(``cluster/fencing.py``), copies of the JAX package's modules of the
same names. Discovery, the KV store, channels, the parameter server,
replay, bootstrap, stub generation and the cross-language gateway come
later (ROADMAP.md A11); the agents' trial plane with ``tune/`` (A14).

Import-light: the names below load on first use, and nothing here loads
torch or numpy until a tensor is sent or received, so node agents and
routers run without either.
"""

# exported lazily (PEP 562)
_LAZY_EXPORTS = {
    "Autoscaler": "autoscaler", "AutoscalerConfig": "autoscaler",
    "RemoteNode": "node",
    "FailureDetector": "supervisor", "HeadJournal": "supervisor",
    "NodeLostError": "supervisor", "NodePool": "supervisor",
    "RpcClient": "rpc", "RpcError": "rpc", "RpcServer": "rpc",
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
