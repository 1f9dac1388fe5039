"""The cluster fabric, as far as the port has it: the RPC plane
(``cluster/rpc.py``), node agents (``cluster/node.py``), head-node
supervision (``cluster/supervisor.py``: the journal, the failure
detector, ``NodePool``), gang reservations (``cluster/gang.py``), the
worker-pool autoscaler (``cluster/autoscaler.py``), the chunked tensor
transport (``cluster/transport.py``) and the epoch fences
(``cluster/fencing.py``), discovery and named actors
(``cluster/discovery.py``), the KV store (``cluster/kv.py``), cross-host
channels (``cluster/channel.py``), the parameter server
(``cluster/param.py``), record/replay (``cluster/replay.py``), remote
bootstrap (``cluster/bootstrap.py``), stub generation
(``cluster/stubgen.py``) and the cross-language gateway
(``cluster/xlang.py``): copies of the JAX package's modules of the same
names, the agents' trial plane included (``start_trial``,
``trial_status``, ``kill_trial``: ``tosem_tpu_torch.tune`` trials as
processes of an agent).

Import-light: the names below load on first use, and nothing here loads
torch or numpy until a tensor is sent or received, so node agents and
routers run without either.
"""

# ``replay`` names both a submodule and its function: the function is
# bound here, once, after the submodule loads (stdlib only), so a later
# import of the submodule cannot shadow it with the module object
from tosem_tpu_torch.cluster.replay import Recorder, replay, replay_source

# exported lazily (PEP 562)
_LAZY_EXPORTS = {
    "Autoscaler": "autoscaler", "AutoscalerConfig": "autoscaler",
    "BootstrapService": "bootstrap", "ElasticAgentPool": "bootstrap",
    "LocalRunner": "bootstrap", "SshRunner": "bootstrap",
    "bootstrap_agent": "bootstrap",
    "Registry": "discovery", "deregister_actor": "discovery",
    "get_actor": "discovery", "register_actor": "discovery",
    "KVStore": "kv",
    "ParameterPoller": "param", "ParameterServer": "param",
    "describe": "stubgen", "describe_remote": "stubgen",
    "write_stubs": "stubgen",
    "XLangGateway": "xlang", "xlang_call": "xlang",
    "RemoteNode": "node",
    "FailureDetector": "supervisor", "HeadJournal": "supervisor",
    "NodeLostError": "supervisor", "NodePool": "supervisor",
    "RpcClient": "rpc", "RpcError": "rpc", "RpcServer": "rpc",
}

__all__ = sorted([*_LAZY_EXPORTS, "Recorder", "replay", "replay_source"])


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
