"""Service discovery + named actors.

Two reference roles: Cyber's topology discovery (`cyber/service_discovery/`
— writers/readers announce themselves on channels and peers look them up)
and Ray's named actors (`ray.get_actor(name)` backed by GCS named-actor
tables). Both reduce to a registry keyed by (kind, name) over
:class:`~tosem_tpu_torch.cluster.kv.KVStore`; CAS gives unique registration,
and actor handles round-trip as (actor_id, method names) pairs — cheap to
serialize because the runtime's handles are already thin ids.

A copy of the JAX package's ``cluster/discovery.py``.
"""
from __future__ import annotations

import json
import pickle
from typing import Any, Dict, List, Optional

from tosem_tpu_torch.cluster.kv import KVStore

_NS = "discovery"


class Registry:
    def __init__(self, kv: Optional[KVStore] = None):
        self.kv = kv or KVStore()

    def register(self, kind: str, name: str, payload: Dict[str, Any], *,
                 unique: bool = False) -> bool:
        """Announce an endpoint. ``unique=True`` uses CAS so a second
        registration under the same name fails instead of overwriting
        (named-actor semantics)."""
        blob = json.dumps(payload).encode()
        key = f"{kind}/{name}"
        if unique:
            return self.kv.cas(_NS, key, None, blob)
        self.kv.put(_NS, key, blob)
        return True

    def lookup(self, kind: str, name: str) -> Optional[Dict[str, Any]]:
        blob = self.kv.get(_NS, f"{kind}/{name}")
        return None if blob is None else json.loads(blob)

    def list(self, kind: str) -> List[str]:
        prefix = f"{kind}/"
        return [k[len(prefix):] for k in self.kv.keys(_NS, prefix)]

    def deregister(self, kind: str, name: str) -> bool:
        return self.kv.delete(_NS, f"{kind}/{name}")


# ------------------------------------------------------- named actors

_ACTORS_NS = "named_actors"


def register_actor(name: str, handle, kv: Optional[KVStore] = None,
                   registry: Optional[Registry] = None) -> bool:
    """``Actor.options(name=...)`` analog: publish a handle under a
    unique name."""
    store = registry.kv if registry is not None else (kv or _default_kv())
    blob = pickle.dumps((handle._actor_id, sorted(handle._method_names)))
    return store.cas(_ACTORS_NS, name, None, blob)


def get_actor(name: str, kv: Optional[KVStore] = None,
              registry: Optional[Registry] = None):
    """``ray.get_actor(name)`` analog; raises KeyError when absent."""
    from tosem_tpu_torch.runtime.api import ActorHandle
    store = registry.kv if registry is not None else (kv or _default_kv())
    blob = store.get(_ACTORS_NS, name)
    if blob is None:
        raise KeyError(f"no actor registered under {name!r}")
    actor_id, methods = pickle.loads(blob)
    return ActorHandle(actor_id, methods)


def deregister_actor(name: str, kv: Optional[KVStore] = None) -> bool:
    return (kv or _default_kv()).delete(_ACTORS_NS, name)


_DEFAULT_KV: Optional[KVStore] = None


def _default_kv() -> KVStore:
    global _DEFAULT_KV
    if _DEFAULT_KV is None:
        _DEFAULT_KV = KVStore()
    return _DEFAULT_KV
