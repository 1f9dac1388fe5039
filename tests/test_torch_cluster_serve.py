"""The port's cluster serving plane (``tosem_tpu_torch/serve/
cluster_serve.py``, ``serve/router.py``, ``serve/replica_worker.py``):
``tests/test_cluster_serve.py`` run against the port — placement
planning, router-tier routing (consistent hash, spillover, failure
re-admission), node-death failover, journal-backed recovery, and
sharded dp×tp replicas (meshes of CPU positions here). Fast tests run
the router against in-process fake replicas (plain RpcServers); the
reference's multi-process legs keep their ``slow`` mark, and so does
``tests/test_kv_migration.py``'s cluster drain at the tiny preset.

Across packages: ``plan_replicas``, ``gang._plan`` and the router's
consistent-hash pick and spillover give equal answers for the same
seeded capacities and keys. The slice as a whole, unmarked: tiny BERT
(the JAX package's weights, fp32) served from replica processes on two
node agents through two router processes gives the JAX package's greedy
streams token for token, before and after a node is killed.
"""
import os
import time

import pytest
import torch

from tosem_tpu_torch.cluster.rpc import RpcServer
from tosem_tpu_torch.serve.breaker import CircuitOpen
from tosem_tpu_torch.serve.cluster_serve import (ClusterServe,
                                                 PlacementError,
                                                 plan_replicas)
from tosem_tpu_torch.serve.router import (NoReplicaAvailable,
                                          ReplicaAppError, RouterCore,
                                          RouterPolicy)

# one intra-op thread, as the sharded tests run: a CPU reduction's bits
# can depend on how many threads split it, and the sharded replica's
# answer is held bit for bit against the unsharded one
torch.set_num_threads(1)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


# ------------------------------------------------------------- placement


class TestPlacement:
    def test_spread_round_robins_nodes(self):
        plan = plan_replicas({"n0": 4, "n1": 4}, 4, "spread")
        assert plan == {"n0": 2, "n1": 2}

    def test_spread_overflows_to_capacity(self):
        plan = plan_replicas({"n0": 1, "n1": 3}, 4, "spread")
        assert plan == {"n0": 1, "n1": 3}

    def test_pack_fills_first_node(self):
        plan = plan_replicas({"n0": 4, "n1": 4}, 3, "pack")
        assert plan == {"n0": 3}

    def test_capacity_shortfall_raises_typed(self):
        with pytest.raises(PlacementError):
            plan_replicas({"n0": 1, "n1": 1}, 3, "spread")

    def test_zero_capacity_nodes_not_candidates(self):
        plan = plan_replicas({"n0": 0, "n1": 2}, 2, "spread")
        assert plan == {"n1": 2}

    def test_unknown_strategy_raises(self):
        with pytest.raises(ValueError):
            plan_replicas({"n0": 4}, 1, "strict_diagonal")


# ------------------------------------------------------- router (fakes)


class _FakeReplica:
    """In-process replica: an RpcServer with the replica wire shape."""

    def __init__(self, load=0, fail=False):
        self.load = load
        self.fail = fail
        self.calls = 0
        self._server = RpcServer({"call": self._call, "load": self._load})
        self.address = self._server.address

    def _call(self, request):
        self.calls += 1
        if self.fail:
            raise ValueError("poison backend")
        return {"value": {"echo": request}, "load": self.load}

    def _load(self):
        return self.load

    def kill(self):
        self._server.shutdown()


def _table(deployment, replicas, nodes=None):
    return {deployment: [
        {"replica_id": f"{deployment}#r{i}", "address": r.address,
         "node": (nodes[i] if nodes else f"n{i}"), "devices": 0}
        for i, r in enumerate(replicas)]}


class TestRouterCore:
    def test_routes_and_counts(self):
        reps = [_FakeReplica(), _FakeReplica()]
        router = RouterCore("r0")
        try:
            assert router.update_table(_table("echo", reps), 1)
            for i in range(6):
                out = router.route("echo", {"i": i})
                assert out == {"echo": {"i": i}}
            st = router.stats()
            assert st["routed"] == 6 and st["spilled"] == 0
            # least-loaded + rr tiebreak at equal depth: both serve
            assert reps[0].calls > 0 and reps[1].calls > 0
        finally:
            router.close()
            for r in reps:
                r.kill()

    def test_consistent_hash_affinity_is_sticky(self):
        reps = [_FakeReplica() for _ in range(3)]
        router = RouterCore("r0")
        try:
            router.update_table(_table("echo", reps), 1)
            for key in ("sess-a", "sess-b", "sess-c", "sess-d"):
                before = [r.calls for r in reps]
                for _ in range(4):
                    router.route("echo", {"k": key}, key=key)
                delta = [r.calls - b for r, b in zip(reps, before)]
                # all 4 keyed requests landed on ONE replica
                assert sorted(delta) == [0, 0, 4], (key, delta)
        finally:
            router.close()
            for r in reps:
                r.kill()

    def test_spillover_when_primary_queue_deep(self):
        reps = [_FakeReplica() for _ in range(2)]
        router = RouterCore("r0", policy=RouterPolicy(spill_depth=4))
        try:
            router.update_table(_table("echo", reps), 1)
            # find which replica the key hashes to, then load it up
            router.route("echo", {}, key="sess")
            primary = max(reps, key=lambda r: r.calls)
            other = reps[0] if primary is reps[1] else reps[1]
            primary.load = 10          # piggybacked on the next response
            router.route("echo", {}, key="sess")   # caches depth=10
            n_before = other.calls
            for _ in range(3):
                router.route("echo", {}, key="sess")
            assert other.calls - n_before == 3     # affinity overridden
            assert router.stats()["spilled"] >= 3
        finally:
            router.close()
            for r in reps:
                r.kill()

    def test_dead_replica_readmits_on_survivor(self):
        reps = [_FakeReplica() for _ in range(2)]
        router = RouterCore("r0")
        try:
            router.update_table(_table("echo", reps), 1)
            reps[0].kill()             # node loss: transport error
            for i in range(4):
                assert router.route("echo", {"i": i}) == {
                    "echo": {"i": i}}
            st = router.stats()
            assert st["retried"] >= 1 and st["errors"] == 0
            assert reps[1].calls == 4
            # one retried-but-successful logical request is SUCCESS
            # evidence: the breaker must still admit
            router.route("echo", {"again": 1})
        finally:
            router.close()
            for r in reps:
                r.kill()

    def test_app_error_is_typed_and_never_retried(self):
        reps = [_FakeReplica(fail=True), _FakeReplica()]
        router = RouterCore("r0")
        try:
            router.update_table(_table("echo", reps), 1)
            raised = 0
            for i in range(4):
                try:
                    router.route("echo", {"i": i})
                except ReplicaAppError:
                    raised += 1
            assert raised >= 1
            # the failing call was never re-dispatched to the healthy
            # replica: application errors are the caller's verdict
            assert reps[0].calls + reps[1].calls == 4
        finally:
            router.close()
            for r in reps:
                r.kill()

    def test_breaker_opens_after_total_loss(self):
        reps = [_FakeReplica()]
        router = RouterCore(
            "r0", policy=RouterPolicy(failure_threshold=2,
                                      cooldown_s=60.0))
        try:
            router.update_table(_table("echo", reps), 1)
            reps[0].kill()
            for _ in range(2):
                with pytest.raises(NoReplicaAvailable):
                    router.route("echo", {})
            with pytest.raises(CircuitOpen):
                router.route("echo", {})
        finally:
            router.close()

    def test_stale_table_push_ignored(self):
        reps = [_FakeReplica()]
        router = RouterCore("r0")
        try:
            assert router.update_table(_table("echo", reps), 5)
            assert not router.update_table({}, 4)
            assert router.table_version() == 5
            assert router.route("echo", {"x": 1}) == {"echo": {"x": 1}}
        finally:
            router.close()
            reps[0].kill()

    def test_no_replicas_is_typed(self):
        router = RouterCore("r0")
        router.update_table({}, 1)
        with pytest.raises(NoReplicaAvailable):
            router.route("ghost", {})

    def test_node_depth_rollup_in_stats(self):
        reps = [_FakeReplica(load=2), _FakeReplica(load=3)]
        router = RouterCore("r0")
        try:
            router.update_table(
                _table("echo", reps, nodes=["nA", "nA"]), 1)
            for i in range(2):
                router.route("echo", {"i": i})
            # depths piggybacked from responses roll up per node
            st = router.stats()
            assert st["node_queue_depth"].get("nA", 0) >= 2
        finally:
            router.close()
            for r in reps:
                r.kill()


# ------------------------------------------------- sharded replica (mesh)


class TestShardedBackendInProcess:
    def test_dp_tp_response_bit_identical_to_reference(self):
        """The acceptance pin: a dp×tp sharded replica's response is
        bit-identical to the single-process kernel on the same inputs
        (sharding splits batch/heads, never the softmax axis)."""
        from tosem_tpu_torch.serve.backends import ShardedAttentionBackend
        b = ShardedAttentionBackend(dp=2, tp=2, batch=2, heads=2,
                                    seq=128, dim=64, device="cpu")
        out = b.call({"seed": 11})
        ref = ShardedAttentionBackend.reference({"seed": 11}, batch=2,
                                                heads=2, seq=128, dim=64,
                                                device="cpu")
        assert out["out"].tobytes() == ref.tobytes()
        assert out["mesh"] == [2, 2] and out["devices"] == 4

    def test_sharding_must_divide_batch_and_heads(self):
        from tosem_tpu_torch.serve.backends import ShardedAttentionBackend
        with pytest.raises(ValueError):
            ShardedAttentionBackend(dp=3, tp=1, batch=4, device="cpu")
        with pytest.raises(ValueError):
            ShardedAttentionBackend(dp=1, tp=3, heads=4, device="cpu")

    def test_mesh_glue_validates_device_count(self):
        # the port's mesh takes its positions as a list of devices (8 on
        # the CPU here, where the JAX package's tests have 8 virtual ones)
        from tosem_tpu_torch.parallel.flash import dp_tp_mesh
        mesh = dp_tp_mesh(4, 2, ["cpu"] * 8)
        assert mesh.axis_names == ("dp", "tp")
        assert mesh.devices.shape == (4, 2)
        with pytest.raises(ValueError):
            dp_tp_mesh(16, 2, ["cpu"] * 8)

    def test_http_ingress_duck_types_and_passes_key(self):
        """POST /<name>?key=... reaches a cluster-style handle's
        affinity kwarg; /-/stats serves the controller's rollup."""
        import json
        from urllib.request import Request, urlopen

        from tosem_tpu_torch.serve.http import HttpIngress

        seen = {}

        class _Handle:
            def call(self, request, timeout=None, key=None):
                seen["key"] = key
                return {"echo": request}

        class _Controller:
            def get_deployment(self, name):
                return object() if name == "echo" else None

            def get_handle(self, name):
                return _Handle()

            def list_deployments(self):
                return ["echo"]

            def stats(self):
                return {"routed": 7, "spilled": 1,
                        "nodes": {"n0": {"queue_depth": 0}}}

        ingress = HttpIngress(_Controller())
        try:
            req = Request(f"{ingress.url}/echo?key=sess-9",
                          data=json.dumps({"x": 1}).encode(),
                          method="POST")
            body = json.loads(urlopen(req, timeout=10).read())
            assert body == {"result": {"echo": {"x": 1}}}
            assert seen["key"] == "sess-9"
            st = json.loads(urlopen(f"{ingress.url}/-/stats",
                                    timeout=10).read())
            assert st["deployments"]["routed"] == 7
        finally:
            ingress.shutdown()


# --------------------------------------------------- multi-process legs


@pytest.mark.slow
class TestClusterServeProcesses:
    def test_deploy_route_failover(self, tmp_path):
        """2 agents × capacity 2, 2 replicas spread; a node kill moves
        its replica to the survivor under the SAME id, requests keep
        succeeding, and the journal records the transition."""
        from tosem_tpu_torch.cluster.node import RemoteNode
        from tosem_tpu_torch.cluster.supervisor import HeadJournal, NodePool
        jp = str(tmp_path / "head.jsonl")
        pool = NodePool(journal_path=jp, miss_threshold=1,
                        probe_timeout=3.0)
        cs = None
        try:
            for i in range(2):
                pool.add_node(RemoteNode.spawn_local(num_workers=2),
                              name=f"n{i}")
            cs = ClusterServe(pool, num_routers=1, router_procs=False)
            dep = cs.deploy(
                "vec", "tosem_tpu_torch.serve.bench_serve:VectorWorkBackend",
                num_replicas=2, strategy="spread",
                init_kwargs={"n": 64})
            assert {r.node for r in dep.replicas} == {"n0", "n1"}
            h = cs.get_handle("vec")
            first = h.call({"x": 1})
            victim = dep.replicas[0].node
            victim_rid = dep.replicas[0].replica_id
            pool.live_nodes()[victim].kill()
            pool.detector.check_once()          # discovers the death
            assert victim not in {r.node for r in dep.replicas}
            assert victim_rid in {r.replica_id for r in dep.replicas}
            assert h.call({"x": 1}) == first    # same program, re-homed
            events = [e["event"] for e in HeadJournal.load(jp)]
            assert "replica_placed" in events
            assert "replica_removed" in events
            # stats rollup sees both planes
            st = cs.stats()
            assert st["deployments"]["vec"]["replicas"] == 2
            assert victim not in st["deployments"]["vec"]["nodes"]
        finally:
            if cs is not None:
                cs.close()
            pool.close(close_nodes=True)

    def test_recover_adopts_surviving_replicas(self, tmp_path):
        """Head crash-restart: replica processes OUTLIVE the head; the
        recovered controller re-adopts them at their old addresses
        (no respawn) and keeps serving."""
        from tosem_tpu_torch.cluster.node import RemoteNode
        from tosem_tpu_torch.cluster.supervisor import NodePool
        jp = str(tmp_path / "head.jsonl")
        pool = NodePool(journal_path=jp, miss_threshold=1,
                        probe_timeout=3.0)
        nodes = [RemoteNode.spawn_local(num_workers=2) for _ in range(2)]
        for i, n in enumerate(nodes):
            pool.add_node(n, name=f"n{i}")
        cs = ClusterServe(pool, num_routers=1, router_procs=False)
        cs2 = None
        try:
            dep = cs.deploy(
                "vec", "tosem_tpu_torch.serve.bench_serve:VectorWorkBackend",
                num_replicas=2, strategy="spread",
                init_kwargs={"n": 64})
            old = {r.replica_id: r.address for r in dep.replicas}
            # "crash" the head: drop the controller without teardown
            pool.detector.stop()
            cs2 = ClusterServe.recover(jp, num_routers=1,
                                       router_procs=False,
                                       miss_threshold=1)
            dep2 = cs2.get_deployment("vec")
            assert {r.replica_id: r.address
                    for r in dep2.replicas} == old
            assert cs2.get_handle("vec").call({"x": 2}) is not None
            # fresh ids never collide with adopted ones
            assert cs2._rid_next["vec"] == 2
        finally:
            cs.close(stop_replicas=False)
            if cs2 is not None:
                cs2.close()
                cs2.pool.close(close_nodes=True)
            pool.close(close_nodes=True)

    def test_sharded_replica_process_end_to_end(self, tmp_path):
        """sharding=(1, 2): the replica process runs a mesh of 2
        positions on its device, gang-reserves its agent slots, and
        answers bit-identically to the single-process reference."""
        import numpy as np

        from tosem_tpu_torch.cluster.node import RemoteNode
        from tosem_tpu_torch.cluster.supervisor import NodePool
        from tosem_tpu_torch.serve.backends import ShardedAttentionBackend
        pool = NodePool(miss_threshold=1, probe_timeout=3.0)
        cs = None
        try:
            node = RemoteNode.spawn_local(num_workers=2)
            pool.add_node(node, name="n0")
            cs = ClusterServe(pool, num_routers=1, router_procs=False,
                              replica_startup_timeout=300.0)
            cs.deploy("shard", ShardedAttentionBackend, num_replicas=1,
                      sharding=(1, 2),
                      init_kwargs={"batch": 2, "heads": 2, "seq": 128,
                                   "dim": 64, "device": "cpu"})
            # the gang reservation withholds the dp*tp slots from the
            # task plane while the replica lives
            assert node.stats()["free_slots"] == 0
            out = cs.get_handle("shard").call({"seed": 5})
            ref = ShardedAttentionBackend.reference(
                {"seed": 5}, batch=2, heads=2, seq=128, dim=64, device="cpu")
            assert np.asarray(out["out"]).tobytes() == ref.tobytes()
            assert out["devices"] == 2
            cs.delete("shard")
            assert node.stats()["free_slots"] == 2
        finally:
            if cs is not None:
                cs.close()
            pool.close(close_nodes=True)


@pytest.mark.slow
def test_cluster_serve_drain_node_migrates_sequences():
    """``tests/test_kv_migration.py``'s cluster drain against the port:
    a sequence admitted and stepped on one replica moves to the survivor
    with ``drain_node`` and finishes with the undisturbed stream."""
    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.rpc import RpcClient
    from tosem_tpu_torch.cluster.supervisor import NodePool
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    kw = dict(DRAIN_KW, max_new_tokens=12)
    ref = BertDecodeBackend(**kw)
    want = ref.call(DRAIN_PROMPT)["tokens"]
    pool = NodePool(miss_threshold=2, probe_timeout=5.0)
    cs = None
    try:
        for i in range(2):
            pool.add_node(RemoteNode.spawn_local(num_workers=2),
                          name=f"n{i}")
        cs = ClusterServe(pool, num_routers=1, router_procs=False)
        dep = cs.deploy(
            "dec", "tosem_tpu_torch.serve.backends:BertDecodeBackend",
            num_replicas=2, strategy="spread", init_kwargs=kw)
        by_node = {r.node: r for r in dep.replicas}
        assert len(by_node) == 2
        src_node = sorted(by_node)[0]
        src = by_node[src_node]
        with RpcClient(src.address) as cli:
            cli.call("backend_call", "admit", "s1", DRAIN_PROMPT)
            cli.call("backend_call", "step_batch", ["s1"], [0])
        out = cs.drain_node(src_node)
        assert out["replicas_moved"] == 1
        assert out["sequences_migrated"] == 1
        surv = next(r for r in dep.replicas if r.node != src_node
                    and r.replica_id != src.replica_id)
        with RpcClient(surv.address) as cli:
            assert cli.call("backend_call", "list_seqs") == ["s1"]
            step = 1
            while True:
                o = cli.call("backend_call", "step_batch", ["s1"],
                             [step])[0]
                step += 1
                if o.get("done"):
                    break
            res = cli.call("backend_call", "result", "s1")
        assert res["tokens"] == want
        assert len(dep.replicas) == 2
        assert all(r.node != src_node for r in dep.replicas)
    finally:
        if cs is not None:
            cs.close()
        pool.close(close_nodes=True)


DRAIN_KW = dict(max_batch=4, max_len=64, page_size=16, num_pages=24,
                device="cpu")
DRAIN_PROMPT = {"ids": [1, 2, 3, 4]}


# ------------------------------------------------------ across packages


def _capacities(rng):
    n = int(rng.integers(1, 6))
    return {f"n{i}": int(rng.integers(0, 5)) for i in range(n)}


def _outcome(fn, *a):
    try:
        return ("ok", fn(*a))
    except Exception as e:                  # the typed refusal, by name
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("strategy", ["spread", "pack"])
def test_plan_replicas_equals_the_reference(strategy):
    import numpy as np

    from tosem_tpu.serve import cluster_serve as ref
    rng = np.random.default_rng(7)
    seen = set()
    for _ in range(200):
        caps = _capacities(rng)
        n = int(rng.integers(1, 9))
        got = _outcome(plan_replicas, caps, n, strategy)
        want = _outcome(ref.plan_replicas, caps, n, strategy)
        assert got == want, (caps, n)
        seen.add(got[0])
    assert seen == {"ok", "raises"}


@pytest.mark.parametrize("strategy", ["spread", "pack", "strict_pack",
                                      "strict_spread"])
def test_gang_plans_equal_the_reference(strategy):
    import numpy as np

    from tosem_tpu.cluster import gang as ref
    from tosem_tpu_torch.cluster import gang
    rng = np.random.default_rng(11)
    for _ in range(200):
        caps = _capacities(rng)
        n = int(rng.integers(1, 9))
        assert _outcome(gang._plan, caps, n, strategy) == \
            _outcome(ref._plan, caps, n, strategy), (caps, n)


def _routers(policy_kw, n_replicas=5):
    """Both packages' RouterCores on one table of unreachable replicas
    (a scrape TTL no test outlives: picks read the cached depths)."""
    from tosem_tpu.serve import router as ref
    from tosem_tpu_torch.serve import router as port
    table = {"dec": [{"replica_id": f"dec#r{i}", "address": f"10.0.0.{i}:1",
                      "node": f"n{i % 3}", "devices": 0}
                     for i in range(n_replicas)]}
    out = []
    for mod in (port, ref):
        r = mod.RouterCore("r0", policy=mod.RouterPolicy(
            scrape_ttl_s=1e12, **policy_kw))
        assert r.update_table(table, 1)
        out.append(r)
    return out


def _set_depths(router, depths):
    for lk in router._table["dec"]:
        lk.depth = depths[lk.info["replica_id"]]


def test_hash_ring_picks_equal_the_reference():
    from tosem_tpu.serve import router as ref
    from tosem_tpu_torch.serve import router as port
    for i in range(500):
        s = f"session-{i}"
        assert port._hash64(s) == ref._hash64(s)
    a, b = _routers({})
    try:
        for i in range(300):
            key = f"k{i}"
            la, sa = a._pick("dec", key, set())
            lb, sb = b._pick("dec", key, set())
            assert (la.info["replica_id"], sa) == \
                (lb.info["replica_id"], sb)
    finally:
        a.close()
        b.close()


def test_spillover_and_least_loaded_picks_equal_the_reference():
    import numpy as np
    a, b = _routers({"spill_depth": 3})
    rng = np.random.default_rng(5)
    try:
        spilled = 0
        for i in range(300):
            depths = {f"dec#r{j}": int(rng.integers(0, 8))
                      for j in range(5)}
            _set_depths(a, depths)
            _set_depths(b, depths)
            key = None if i % 4 == 0 else f"k{i % 37}"
            tried = ({f"10.0.0.{int(rng.integers(5))}:1"}
                     if i % 7 == 0 else set())
            la, sa = a._pick("dec", key, set(tried))
            lb, sb = b._pick("dec", key, set(tried))
            assert (la.info["replica_id"], sa) == \
                (lb.info["replica_id"], sb), (i, depths, key, tried)
            spilled += sa
        assert spilled > 0
    finally:
        a.close()
        b.close()


# ----------------------------------------- the slice as a whole (tiny BERT)

E2E_KW = dict(max_batch=4, max_len=64, page_size=16, num_pages=48,
              max_new_tokens=8)
E2E_PROMPTS = [[1 + (7 * i + 3 * j) % 120 for j in range(3 + 5 * i)]
               for i in range(4)]


@pytest.fixture(scope="module")
def reference_streams(tmp_path_factory):
    """The JAX package's tiny decoder at fp32: its greedy streams on the
    prompts, and its parameters in an ``.npz`` for the replicas."""
    import dataclasses

    import jax
    import numpy as np

    import tosem_tpu.models.bert as jbert
    from tosem_tpu.serve.backends import BertDecodeBackend as JDec

    @dataclasses.dataclass(frozen=True)
    class RefConfig32(jbert.BertConfig):
        dtype: str = "float32"

    mp = pytest.MonkeyPatch()
    mp.setattr(jbert, "BertConfig", RefConfig32)
    try:
        ref = JDec(**E2E_KW)
        assert ref.cfg.dtype == "float32"
        streams = [ref.call({"ids": p})["tokens"] for p in E2E_PROMPTS]
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    flat[f"{prefix}{k}"] = np.asarray(v)
        walk(jax.tree_util.tree_map(np.asarray, ref._vs["params"]), "")
    finally:
        mp.undo()
    path = str(tmp_path_factory.mktemp("weights") / "bert_tiny.npz")
    np.savez(path, **flat)
    return streams, path


def test_tiny_bert_served_over_node_agents_gives_the_reference_streams(
        tmp_path, reference_streams):
    """Two node agents of one worker each, two tiny-BERT replicas spread
    over them, two router processes: keyed greedy calls through the
    handle give the JAX package's streams token for token; after one
    node is SIGKILLed the next calls are re-admitted on the survivor and
    give the same streams, and the failure detector's verdict drops the
    dead replica from the table (the survivor has no slot to re-place it
    in, which the journal records)."""
    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.supervisor import HeadJournal, NodePool
    streams, npz = reference_streams
    jp = str(tmp_path / "head.jsonl")
    pool = NodePool(journal_path=jp, miss_threshold=1, probe_timeout=5.0)
    cs = None
    try:
        for i in range(2):
            pool.add_node(RemoteNode.spawn_local(num_workers=1),
                          name=f"n{i}")
        cs = ClusterServe(pool, num_routers=2, router_procs=True,
                          replica_startup_timeout=120.0)
        dep = cs.deploy(
            "tiny", "tests.test_torch_cluster_backends:NpzBertDecode",
            num_replicas=2, strategy="spread",
            init_kwargs=dict(E2E_KW, params_npz=npz, device="cpu"))
        assert {r.node for r in dep.replicas} == {"n0", "n1"}
        h = cs.get_handle("tiny")
        got = [h.call({"ids": p}, timeout=60.0, key=f"s{i}")["tokens"]
               for i, p in enumerate(E2E_PROMPTS)]
        assert got == streams
        victim, survivor = dep.replicas
        pool.live_nodes()[victim.node].kill()
        got = [h.call({"ids": p}, timeout=60.0, key=f"s{i}")["tokens"]
               for i, p in enumerate(E2E_PROMPTS)]
        assert got == streams
        assert pool.detector.check_once() == [victim.node]
        assert [r.replica_id for r in dep.replicas] == \
            [survivor.replica_id]
        assert h.call({"ids": E2E_PROMPTS[0]}, key="s0")["tokens"] == \
            streams[0]
        events = [(e["event"], e.get("replica_id"))
                  for e in HeadJournal.load(jp)]
        assert ("replica_removed", victim.replica_id) in events
        assert ("replica_lost", victim.replica_id) in events
        st = cs.stats()
        assert sum(r.get("retried", 0) for r in st["routers"]) >= 1
        assert sum(r.get("errors", 0) for r in st["routers"]) == 0
    finally:
        if cs is not None:
            cs.close()
        pool.close(close_nodes=True)


def test_crossed_prefix_pull_waits_two_seconds_not_thirty():
    """C-ref11: a keyed request whose replica lacks a prefix another
    replica advertises pulls it over before dispatch. When two pulls of
    one prefix into one replica cross, the receiver keeps one stream and
    one adopt finds nothing; the port's router bounds that adopt's wait
    at 2 s (the JAX package's waits its default 30 s). The fake
    destination below never sees the stream and waits what it is told."""
    from tosem_tpu_torch.serve.prefix_cache import prefix_hash
    from tosem_tpu_torch.serve.router import _ADOPT_TIMEOUT_S
    ids = list(range(1, 11))
    digest = [[1, 4, prefix_hash(ids[:4])]]
    seen = {}

    def backend_call(name):
        def fn(method, *args, **kw):
            seen.setdefault(name, []).append((method, args, kw))
            if method == "transport_address":
                return "127.0.0.1:1"
            if method == "adopt_prefix":
                time.sleep(min(kw.get("timeout", 30.0), 5.0))
                raise TimeoutError("no stream under that key")
            return 1
        return fn

    servers = {}
    for name in ("owner", "dst"):
        def call(request, name=name):
            out = {"value": name, "load": 0}
            if name == "owner":
                out["prefixes"] = digest
            return out
        servers[name] = RpcServer({"call": call, "load": lambda: 0,
                                   "backend_call": backend_call(name)})
    table = {"dec": [{"replica_id": f"dec#{n}", "address": s.address,
                      "node": n, "devices": 0}
                     for n, s in servers.items()]}
    router = RouterCore("r0")
    try:
        router.update_table(table, 1)
        # the owner's digest arrives on its responses
        while router.route("dec", {"ids": [0]}) != "owner":
            pass
        key = next(k for k in (f"k{i}" for i in range(200))
                   if router._pick("dec", k, set())[0].info["node"] == "dst")
        assert router.route("dec", {"ids": ids}, key=key) == "dst"
        adopts = [kw for m, _, kw in seen["dst"] if m == "adopt_prefix"]
        assert adopts == [{"timeout": _ADOPT_TIMEOUT_S}]
        assert _ADOPT_TIMEOUT_S == 2.0
        assert router.stats()["prefix_transfer_fails"] == 1
    finally:
        router.close()
        for s in servers.values():
            s.shutdown()
