"""The port's multi-process cluster fixture (``tosem_tpu_torch/parallel/
cluster.py``) and the process-group arm of its meshes.

``tests/test_cluster.py``'s four cases run against the port, marked
``slow`` as there: real OS processes join a gloo group through
``multihost_init``'s real branch (cards hidden), all-reduce across the
process boundary, a killed rank is named, a sweep runs over a mesh of
every process's positions, and an elastic relaunch resumes from its
checkpoint. Tier 1 runs one 2-process all-reduce with a time limit of
its own, the fold order across processes (each rank gets the bits of a
one-process mesh of the same positions), and ``multihost_init``'s
backend choice with the card count faked. No case reads the wall clock
for its verdict. The children import their jobs from
``test_torch_cluster_jobs.py`` (the JAX package's ``cluster_jobs.py``
imports JAX).
"""
import os
import time

import numpy as np
import pytest
import torch

from tosem_tpu_torch.parallel.cluster import LocalCluster

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))

torch.set_num_threads(1)


def _mk(n=2, dev=1):
    return LocalCluster(num_processes=n, devices_per_process=dev,
                        extra_sys_path=[TESTS_DIR])


def _allreduce(c):
    res = c.run("test_torch_cluster_jobs:allreduce_job", timeout=60)
    assert res.ok, (res, c.log(0), c.log(1))
    for rank in (0, 1):
        r = res.results[rank]
        assert r["joined"] is True          # real multihost_init branch
        assert r["backend"] == "gloo"       # the children see no card
        assert r["n_global_devices"] == 2
        assert r["n_local_devices"] == 1
        assert r["out"]["total"] == pytest.approx(3.0)  # 1 + 2


@pytest.mark.slow
def test_two_process_collective():
    c = _mk()
    try:
        _allreduce(c)
    finally:
        c.stop()


def test_two_process_allreduce_within_its_limit():
    """Tier 1's cluster case: the same job, given 60 s (the run is a few
    seconds: two interpreters importing torch and joining)."""
    c = _mk()
    try:
        _allreduce(c)
    finally:
        c.stop()


@pytest.mark.slow
def test_kill_one_process_detected():
    c = _mk()
    try:
        c.start("test_torch_cluster_jobs:spin_job",
                kwargs={"seconds": 120.0})
        ready = os.path.join(c.workdir, "ready_p1")
        deadline = time.monotonic() + 120
        while not os.path.exists(ready):
            assert time.monotonic() < deadline, c.log(1)
            time.sleep(0.1)
        c.kill_process(1)
        res = c.wait(timeout=60)
        assert not res.ok
        assert res.failed == [1]                # the dead rank is identified
    finally:
        c.stop()


@pytest.mark.slow
def test_cross_process_collective_sweep():
    c = _mk(n=2, dev=2)
    try:
        res = c.run("tosem_tpu_torch.parallel.jobs:collective_sweep_job",
                    kwargs={"sizes": [1 << 14], "n_iter": 4, "reps": 1},
                    timeout=240)
        assert res.ok, (res, c.log(0), c.log(1))
        out = res.results[0]["out"]
        assert out["n_processes"] == 2 and out["n_devices"] == 4
        assert len(out["rows"]) == 2            # all_reduce + all_gather
        for row in out["rows"]:
            assert row["bus_bw_gbps"] > 0
        assert os.path.exists(os.path.join(c.workdir, "process_sweep.csv"))
    finally:
        c.stop()


@pytest.mark.slow
def test_elastic_restart_resumes_from_checkpoint():
    c = _mk()
    try:
        res = c.run_elastic("test_torch_cluster_jobs:train_job",
                            kwargs={"steps": 5, "crash_at": 2},
                            max_restarts=1, timeout=180)
        assert res.ok, (res, c.log(0), c.log(1))
        assert res.restarts == 1
        for rank in (0, 1):
            out = res.results[rank]["out"]
            assert out["start_step"] >= 1       # resumed, not from scratch
        # 5 steps of w += 0.5 * (mean_target - w), targets {1, 2}
        w = res.results[0]["out"]["final_w"]
        assert abs(w[0] - 1.5 * (1 - 0.5 ** 5)) < 1e-5
    finally:
        c.stop()


def test_fold_order_across_processes():
    """Two processes of two positions each: psum's result on both ranks
    is the left fold over all four positions in position order, bit for
    bit what a one-process mesh of four positions gives; a fold of the
    processes' partials would round otherwise on these values."""
    from test_torch_cluster_jobs import FOLD_VALUES
    from tosem_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from tosem_tpu_torch.parallel.spmd import P, psum, shard_map
    c = _mk(n=2, dev=2)
    try:
        res = c.run("test_torch_cluster_jobs:fold_order_job", timeout=60)
        assert res.ok, (res, c.log(0), c.log(1))
    finally:
        c.stop()
    mesh = make_mesh(MeshSpec.of(dp=4), ["cpu"] * 4)
    one = shard_map(lambda v: psum(v, "dp"), mesh, in_specs=P("dp"),
                    out_specs=P())(torch.from_numpy(FOLD_VALUES.copy()))
    want = one.view(torch.int32).tolist()
    for rank in (0, 1):
        out = res.results[rank]["out"]
        assert out["n_devices"] == 4
        assert out["psum_bits"] == want
        assert out["gathered"] == FOLD_VALUES.tolist()
    v = FOLD_VALUES
    left = ((v[0] + v[1]) + v[2]) + v[3]
    partials = (v[0] + v[1]) + (v[2] + v[3])
    assert not np.array_equal(left, partials)      # the values tell
    assert np.array_equal(np.asarray(want, np.int32).view(np.float32)[0],
                          left)


# ------------------------------------------ multihost_init's backend


@pytest.fixture
def fake_dist(monkeypatch):
    """``multihost_init`` with the card count faked and the group's
    formation recorded instead of joined."""
    import torch.distributed as dist
    calls = {}

    def init(backend, **kw):
        calls["backend"] = backend
        calls.update(kw)

    def set_device(i):
        calls["device"] = i
    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)

    def cards(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    return calls, cards


def test_cpu_process_forms_a_gloo_group(fake_dist):
    from tosem_tpu_torch.parallel.mesh import multihost_init
    calls, cards = fake_dist
    cards(0)
    assert multihost_init("127.0.0.1:1234", 2, 1) is True
    assert calls["backend"] == "gloo" and "device" not in calls
    assert calls["init_method"] == "tcp://127.0.0.1:1234"
    assert (calls["world_size"], calls["rank"]) == (2, 1)
    assert calls["timeout"].total_seconds() == 300.0


def test_a_card_for_each_rank_forms_nccl_on_its_own_card(fake_dist):
    from tosem_tpu_torch.parallel.mesh import multihost_init
    calls, cards = fake_dist
    cards(2)
    assert multihost_init("127.0.0.1:1234", 2, 1, timeout_s=30.0)
    assert calls["backend"] == "nccl"
    assert calls["device"] == 1         # cuda:{local rank}, before joining
    assert calls["timeout"].total_seconds() == 30.0


def test_ranks_outnumbering_the_cards_raise_at_join(fake_dist):
    """Two ranks on the one card would form an nccl group that fails at
    its first collective: every rank refuses before joining, rank 0
    included."""
    from tosem_tpu_torch.parallel.mesh import multihost_init
    calls, cards = fake_dist
    cards(1)
    for pid in (0, 1):
        with pytest.raises(RuntimeError, match="ranks on this host but 1"):
            multihost_init("127.0.0.1:1234", 2, pid)
    assert calls == {}


def test_local_ranks_read_from_the_environment(fake_dist, monkeypatch):
    """Four ranks over two hosts of two cards: the host's ranks, not the
    job's, must fit its cards."""
    from tosem_tpu_torch.parallel.mesh import multihost_init
    calls, cards = fake_dist
    cards(2)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:29500")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "3")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert multihost_init()
    assert calls["backend"] == "nccl" and calls["device"] == 1
    assert calls["rank"] == 3


def test_env_contract_kept(fake_dist, monkeypatch):
    from tosem_tpu_torch.parallel.mesh import multihost_init
    calls, cards = fake_dist
    cards(0)
    assert multihost_init() is False            # no address: one process
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(ValueError, match="NUM_PROCESSES"):
        multihost_init()
    assert calls == {}
