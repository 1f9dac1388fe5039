"""The port's head-node supervision (``tosem_tpu_torch/cluster/
supervisor.py``): ``tests/test_cluster_supervisor.py`` run against the
port, journal replay/reconcile, heartbeat failure detection and
node-death failover (fast fakes here; the real multi-process legs keep
their ``slow`` mark), the pool's trial plane included: a trial whose
node dies resubmits to a survivor and resumes from its checkpoint.
Across packages: ``HeadJournal.reconcile`` of the same events gives
equal tables, and a journal written by either package reconciles in
the other."""
import os
import threading

import pytest

from tosem_tpu_torch.cluster.supervisor import (FailureDetector,
                                                HeadJournal, NodeLostError,
                                                NodePool)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
COUNTING = "tosem_tpu_torch.tune.examples:counting"


# module-level so spawn-mode agents can unpickle it by reference
def cube(x):
    return x ** 3


class _FakeNode:
    """Duck-typed RemoteNode: scripted liveness + submit behavior."""

    def __init__(self, alive=True, fail_submit=False):
        self.address = f"fake:{id(self)}"
        self._alive = alive
        self._fail_submit = fail_submit
        self.submitted = []

    def alive(self, timeout=None):
        return self._alive

    def submit(self, fn, *args, **kwargs):
        if self._fail_submit or not self._alive:
            raise ConnectionError("fake node down")
        self.submitted.append((fn, args))
        return fn(*args, **kwargs)

    def kill(self):
        self._alive = False
        self._fail_submit = True

    def close(self):
        pass


class TestHeadJournal:
    def test_record_load_reconcile(self, tmp_path):
        p = str(tmp_path / "head.journal")
        j = HeadJournal(p)
        j.record("node_added", name="n0", address="h:1")
        j.record("node_added", name="n1", address="h:2")
        j.record("work_submitted", work_id="w1", fn="f")
        j.record("work_submitted", work_id="w2", fn="g")
        j.record("work_done", work_id="w1")
        j.record("node_removed", name="n1")
        j.record("trial_started", trial_id="t1", node="n0", attempt=1)
        j.close()
        state = HeadJournal.reconcile(HeadJournal.load(p))
        assert state["nodes"] == {"n0": "h:1"}
        assert set(state["outstanding_work"]) == {"w2"}
        assert set(state["outstanding_trials"]) == {"t1"}

    def test_reconcile_rebuilds_serve_placements(self, tmp_path):
        """The serving control plane rides the same journal: deployments
        declared and replicas placed/removed replay into the state
        ClusterServe.recover rebuilds the routing table from."""
        p = str(tmp_path / "head.journal")
        j = HeadJournal(p)
        j.record("deployment_created", deployment="vec",
                 backend_ref="m:Backend", init_kwargs="{}",
                 num_replicas=2, strategy="spread", sharding=None,
                 warmup_shapes=[])
        j.record("replica_placed", deployment="vec",
                 replica_id="vec#r0", node="n0", address="h:1",
                 devices=0, gang_id=None)
        j.record("replica_placed", deployment="vec",
                 replica_id="vec#r1", node="n1", address="h:2",
                 devices=0, gang_id=None)
        j.record("replica_removed", deployment="vec",
                 replica_id="vec#r0", reason="node_death", node="n0")
        j.record("replica_placed", deployment="vec",
                 replica_id="vec#r0", node="n1", address="h:3",
                 devices=0, gang_id=None)
        j.record("deployment_created", deployment="gone",
                 backend_ref="m:B", init_kwargs="{}", num_replicas=1,
                 strategy="spread", sharding=None, warmup_shapes=[])
        j.record("replica_placed", deployment="gone",
                 replica_id="gone#r0", node="n0", address="h:4",
                 devices=0, gang_id=None)
        j.record("deployment_deleted", deployment="gone")
        j.close()
        state = HeadJournal.reconcile(HeadJournal.load(p))
        assert set(state["deployments"]) == {"vec"}
        assert set(state["placements"]) == {"vec#r0", "vec#r1"}
        # the re-placement wins: last placed address for the same id
        assert state["placements"]["vec#r0"]["node"] == "n1"
        assert state["placements"]["vec#r0"]["address"] == "h:3"

    def test_reconcile_rebuilds_train_progress(self, tmp_path):
        """Training rides the same journal: a recovered head learns
        which dp jobs were live and the last journaled step (what a
        restarted DistributedTrainer resumes from), with elasticity
        events folding into the world size."""
        p = str(tmp_path / "head.journal")
        j = HeadJournal(p)
        j.record("train_started", job="dp", world=3, grain=4,
                 backend="nodes")
        j.record("train_step_done", job="dp", step=1)
        j.record("train_step_done", job="dp", step=2)
        j.record("train_worker_lost", job="dp", node="n2")
        j.record("train_shrunk", job="dp", step=2, world=2)
        j.record("train_step_done", job="dp", step=3)
        j.record("train_grown", job="dp", step=3, world=3)
        j.record("train_started", job="done-job", world=1, grain=1,
                 backend="threads")
        j.record("train_step_done", job="done-job", step=5)
        j.record("train_finished", job="done-job", step=5)
        j.close()
        state = HeadJournal.reconcile(HeadJournal.load(p))
        tj = state["train_jobs"]
        assert tj["dp"]["step"] == 3
        assert tj["dp"]["world"] == 3
        assert tj["dp"]["grain"] == 4
        assert tj["dp"]["finished"] is False
        assert tj["done-job"]["finished"] is True

    def test_recover_from_sigkilled_head_torn_tail(self, tmp_path):
        """A head SIGKILLed mid-record leaves a torn final line; recover
        must skip the tail and still expose every completed serve
        placement (the satellite-3 acceptance: NodePool.recover
        rebuilds SERVE placements, not just trials)."""
        import subprocess
        import sys
        p = str(tmp_path / "head.journal")
        script = f"""
import os, signal
from tosem_tpu_torch.cluster.supervisor import HeadJournal
j = HeadJournal({p!r})
j.record("node_added", name="n0", address="127.0.0.1:1")
j.record("deployment_created", deployment="vec",
         backend_ref="m:Backend", init_kwargs="{{}}", num_replicas=1,
         strategy="spread", sharding=None, warmup_shapes=[])
j.record("replica_placed", deployment="vec", replica_id="vec#r0",
         node="n0", address="127.0.0.1:2", devices=0, gang_id=None)
# torn tail: raw partial line, then the head dies mid-write
j._f.write(b'{{"event": "replica_pla')
j._f.flush()
os.fsync(j._f.fileno())
os.kill(os.getpid(), signal.SIGKILL)
"""
        proc = subprocess.run([sys.executable, "-c", script],
                              timeout=60)
        assert proc.returncode == -9        # SIGKILLed, as scripted
        events = HeadJournal.load(p)
        assert [e["event"] for e in events] == [
            "node_added", "deployment_created", "replica_placed"]
        pool = NodePool.recover(p, probe_timeout=0.5)
        try:
            # the journaled node is unreachable -> removed at recovery,
            # but the serving state survives the torn tail intact
            assert pool.live_nodes() == {}
            assert set(pool.deployments) == {"vec"}
            assert pool.placements["vec#r0"]["address"] == "127.0.0.1:2"
        finally:
            pool.close()

    def test_death_listener_fires_and_errors_are_contained(self):
        """Composed layers hook node death via add_death_listener; a
        broken listener must not stop later listeners."""
        pool = NodePool(miss_threshold=1)
        seen = []

        def boom(name, node):
            raise RuntimeError("broken listener")

        pool.add_death_listener(boom)
        pool.add_death_listener(lambda name, node: seen.append(name))
        node = _FakeNode()
        pool.add_node(node, name="n0")
        node.kill()
        pool.detector.check_once()
        assert seen == ["n0"]
        pool.close()

    def test_torn_tail_is_skipped(self, tmp_path):
        p = str(tmp_path / "head.journal")
        j = HeadJournal(p)
        j.record("node_added", name="n0", address="h:1")
        j.close()
        with open(p, "ab") as f:
            f.write(b'{"event": "node_add')     # head crashed mid-write
        events = HeadJournal.load(p)
        assert [e["event"] for e in events] == ["node_added"]

    def test_concurrent_records_all_land(self, tmp_path):
        p = str(tmp_path / "head.journal")
        j = HeadJournal(p)

        def spam(k):
            for i in range(20):
                j.record("work_submitted", work_id=f"{k}-{i}")
        threads = [threading.Thread(target=spam, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        j.close()
        assert len(HeadJournal.load(p)) == 80


class TestFailureDetector:
    def test_declares_dead_after_misses(self):
        node = _FakeNode(alive=True)
        deaths = []
        det = FailureDetector(miss_threshold=2,
                              on_dead=lambda n, _: deaths.append(n))
        det.add("n0", node)
        assert det.check_once() == []
        node._alive = False
        assert det.check_once() == []        # miss 1 of 2
        assert det.check_once() == ["n0"]    # miss 2: dead
        assert deaths == ["n0"]
        assert det.is_dead("n0")
        assert det.check_once() == []        # dead nodes aren't re-probed

    def test_recovery_resets_miss_count(self):
        node = _FakeNode(alive=True)
        det = FailureDetector(miss_threshold=2)
        det.add("n0", node)
        node._alive = False
        det.check_once()                     # miss 1
        node._alive = True
        det.check_once()                     # reset
        node._alive = False
        det.check_once()                     # miss 1 again — still live
        assert not det.is_dead("n0")

    def test_declare_dead_out_of_band(self):
        deaths = []
        det = FailureDetector(on_dead=lambda n, _: deaths.append(n))
        det.add("n0", _FakeNode())
        det.declare_dead("n0")
        det.declare_dead("n0")               # idempotent
        assert deaths == ["n0"]


class TestNodePoolFakes:
    def test_submit_routes_and_journals(self, tmp_path):
        pool = NodePool(journal_path=str(tmp_path / "j"))
        pool.add_node(_FakeNode(), name="n0")
        assert pool.submit(cube, 3) == 27
        events = [e["event"] for e in HeadJournal.load(
            str(tmp_path / "j"))]
        assert events == ["node_added", "work_submitted", "work_done"]
        pool.close()

    def test_dead_node_failover_to_survivor(self):
        dead = _FakeNode(fail_submit=True)
        live = _FakeNode()
        pool = NodePool(miss_threshold=1)
        pool.add_node(dead, name="dead")
        pool.add_node(live, name="live")
        outs = [pool.submit(cube, i) for i in range(4)]
        assert outs == [0, 1, 8, 27]
        assert pool.detector.is_dead("dead")
        assert len(live.submitted) == 4
        pool.close()

    def test_all_nodes_dead_raises_typed(self):
        pool = NodePool(miss_threshold=1)
        pool.add_node(_FakeNode(fail_submit=True), name="n0")
        with pytest.raises(NodeLostError):
            pool.submit(cube, 1)
        pool.close()

    def test_trial_with_no_survivors_reports_failed_fast(self):
        """A trial whose resubmission exhausted the pool must report
        FAILED immediately, not RESUBMITTING until the poll timeout."""
        node = _FakeNode()
        node.start_trial = lambda *a, **k: None    # accepts the trial
        pool = NodePool(miss_threshold=1)
        pool.add_node(node, name="n0")
        pool.start_trial("t1", COUNTING, {"x": 1.0}, max_iterations=4)
        # the only node dies; resubmission finds no survivors
        node.kill()
        pool.detector.check_once()
        st = pool.trial_status("t1")
        assert st["status"] == "FAILED"
        assert "NodeLostError" in st["error"]
        pool.close()


@pytest.mark.slow
class TestNodePoolProcesses:
    def test_node_death_resubmits_to_survivor(self, tmp_path):
        from tosem_tpu_torch.cluster.node import RemoteNode
        pool = NodePool(journal_path=str(tmp_path / "j"),
                        miss_threshold=1, probe_timeout=3.0)
        n0 = RemoteNode.spawn_local(num_workers=1,
                                    extra_sys_path=[TESTS_DIR])
        n1 = RemoteNode.spawn_local(num_workers=1,
                                    extra_sys_path=[TESTS_DIR])
        try:
            pool.add_node(n0, name="n0")
            pool.add_node(n1, name="n1")
            assert [pool.submit(cube, i) for i in range(3)] == [0, 1, 8]
            n0.kill()                       # hard node loss
            assert [pool.submit(cube, i) for i in range(3)] == [0, 1, 8]
            assert pool.detector.is_dead("n0")
            # head crash-restart: the journal rebuilds the survivor set
            pool.close()
            pool2 = NodePool.recover(str(tmp_path / "j"))
            assert list(pool2.live_nodes()) == ["n1"]
            assert pool2.submit(cube, 4) == 64
            pool2.close()
        finally:
            pool.close(close_nodes=False)
            n0.close()
            n1.close()

    def test_trial_resumes_on_survivor_after_node_death(self, tmp_path):
        """A node dies mid-trial: the pool resubmits the SAME trial id
        to a survivor with a shared checkpoint dir, so the trial
        RESUMES (full metric history, state continued) instead of
        restarting."""
        from tosem_tpu_torch.cluster.node import RemoteNode
        ckdir = str(tmp_path / "shared_ckpts")
        pool = NodePool(miss_threshold=1, probe_timeout=3.0)
        nodes = [RemoteNode.spawn_local(num_workers=1,
                                        extra_sys_path=[TESTS_DIR])
                 for _ in range(2)]
        try:
            for i, n in enumerate(nodes):
                pool.add_node(n, name=f"n{i}")
            pool.start_trial("t1", COUNTING, {"x": 1.0},
                             max_iterations=30, checkpoint_dir=ckdir,
                             checkpoint_freq=2)
            # wait until the trial has checkpointed at least once, then
            # kill its node
            import time
            host = pool._trials["t1"]["node"]
            ck = os.path.join(ckdir, "t1.ckpt")
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and not os.path.exists(ck):
                time.sleep(0.1)
            assert os.path.exists(ck), "trial never checkpointed"
            dict(pool.live_nodes())[host].kill()
            st = pool.wait_trial("t1", timeout=120.0)
            assert st["status"] == "SUCCEEDED", st
            iters = [m["training_iteration"] for m in st["metrics"]]
            assert iters == list(range(1, 31)), iters
            # two hosts contributed: resumed, not restarted
            assert pool._trials["t1"]["resubmits"] >= 2
        finally:
            pool.close(close_nodes=True)


# ------------------------------------------------------ across packages


def _events():
    """A journal's worth of every event kind reconcile folds, including
    a stale-epoch line (dropped) and epoch-less ones (always applied)."""
    return [
        {"event": "node_added", "name": "n0", "address": "h:1",
         "epoch": 1},
        {"event": "node_added", "name": "n1", "address": "h:2",
         "epoch": 1},
        {"event": "work_submitted", "work_id": "w1", "fn": "f", "epoch": 1},
        {"event": "work_submitted", "work_id": "w2", "fn": "g"},
        {"event": "work_done", "work_id": "w1", "epoch": 1},
        {"event": "trial_started", "trial_id": "t1", "node": "n0",
         "attempt": 1, "epoch": 1},
        {"event": "deployment_created", "deployment": "vec",
         "backend_ref": "m:B", "init_kwargs": "{}", "num_replicas": 2,
         "strategy": "spread", "sharding": None, "warmup_shapes": [],
         "slo": None, "epoch": 1},
        {"event": "replica_placed", "deployment": "vec",
         "replica_id": "vec#r0", "node": "n0", "address": "h:5",
         "devices": 0, "gang_id": None, "epoch": 1},
        {"event": "replica_placed", "deployment": "vec",
         "replica_id": "vec#r1", "node": "n1", "address": "h:6",
         "devices": 0, "gang_id": None, "epoch": 2},
        # a superseded head's late write: fenced out by the replay
        {"event": "replica_removed", "deployment": "vec",
         "replica_id": "vec#r1", "reason": "stale", "epoch": 1},
        {"event": "node_removed", "name": "n0", "reason": "heartbeat",
         "epoch": 2},
        {"event": "replica_removed", "deployment": "vec",
         "replica_id": "vec#r0", "reason": "node_death", "node": "n0",
         "epoch": 2},
        {"event": "replica_placed", "deployment": "vec",
         "replica_id": "vec#r0", "node": "n1", "address": "h:7",
         "devices": 2, "gang_id": "g0", "epoch": 2},
        {"event": "train_started", "job": "dp", "world": 3, "grain": 4,
         "epoch": 2},
        {"event": "train_step_done", "job": "dp", "step": 2, "epoch": 2},
        {"event": "train_shrunk", "job": "dp", "step": 2, "world": 2,
         "epoch": 2},
        {"event": "train_finished", "job": "dp", "step": 2, "epoch": 2},
    ]


def test_reconcile_tables_equal_the_reference():
    from tosem_tpu.cluster.supervisor import HeadJournal as RefJournal
    events = _events()
    got = HeadJournal.reconcile(events)
    want = RefJournal.reconcile(events)
    assert got == want
    assert got["stale_dropped"] == 1
    assert got["placements"]["vec#r1"]["address"] == "h:6"


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_journal_written_by_one_package_reconciles_in_the_other(
        tmp_path, writer, reader):
    """Each package's journal file (epoch lease included) loads and
    reconciles in the other to the writer's own table."""
    from tosem_tpu.cluster.supervisor import HeadJournal as RefJournal
    cls = {"ref": RefJournal, "port": HeadJournal}
    p = str(tmp_path / "head.journal")
    j = cls[writer](p)
    for e in _events():
        fields = {k: v for k, v in e.items() if k not in ("event", "epoch")}
        j.record(e["event"], **fields)
    j.close()
    own = cls[writer].reconcile(cls[writer].load(p))
    other = cls[reader].reconcile(cls[reader].load(p))
    assert other == own
    # one head wrote every line under its own lease: no line is stale
    assert own["stale_dropped"] == 0
    assert set(own["nodes"]) == {"n1"}
    assert set(own["placements"]) == {"vec#r0"}
    # the reader's head takes the next epoch lease from the writer's fence
    j2 = cls[reader](p)
    try:
        assert j2.epoch == j.epoch + 1
    finally:
        j2.close()
