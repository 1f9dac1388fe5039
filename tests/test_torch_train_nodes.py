"""``DistributedTrainer(backend="nodes")``: data-parallel ranks as replica
processes on node agents (``train/distributed.py``'s ``_ReplicaHandle``,
``_spawn_gang``, the node-death path).

Two agents (``RemoteNode.spawn_local``) in a ``NodePool`` with a
journal; the ranks are ``TrainWorkerBackend`` replicas that build the
job from its ref (``tests/test_torch_cluster_jobs.py``: the port's
``demo_job`` on the CPU, one intra-op thread). Inside the port the
contract is bit for bit: a nodes run's losses and parameters equal the
threads backend's and the single-process local fold's, before and after
an agent is SIGKILLed mid-run, and the head's journal records the
placements, the loss and the shrink. Across the packages the nodes run
on the JAX package's ``demo_job`` weights and batches agrees with the
reference's own threads backend within its fp32 budget.
"""
import os

import numpy as np
import pytest
import torch

from tosem_tpu_torch.cluster.node import RemoteNode
from tosem_tpu_torch.cluster.supervisor import HeadJournal, NodePool
from tosem_tpu_torch.train.distributed import (DataParallelConfig,
                                               DistributedTrainer,
                                               demo_job, fit_distributed,
                                               make_dp_train_step)

torch.set_num_threads(1)

JOB_KW = dict(towers=3, dim=16, batch=16, grain=4, seed=7)
JOB_REF = "tests.test_torch_cluster_jobs:cpu_demo_job"


def _fold(num_steps, kw=JOB_KW):
    """The single-process local fold: (losses, final parameters)."""
    job = demo_job(**kw, device="cpu")
    state = job.init_state()
    step_fn = make_dp_train_step(job)
    losses = []
    for _ in range(num_steps):
        state, m = step_fn(state)
        losses.append(m["loss"])
    return losses, [p.clone() for p in state.leaves()]


def _cfg(job):
    return DataParallelConfig(grain=4, bucket_bytes=1024, job=job,
                              transport_capacity=8 << 20)


def _same(state, want):
    got = state.leaves()
    return len(got) == len(want) and all(torch.equal(a, b)
                                         for a, b in zip(got, want))


def _events(path, job):
    return [e for e in HeadJournal.load(path) if e.get("job") == job]


@pytest.fixture
def pool(tmp_path):
    journal = str(tmp_path / "head.jsonl")
    p = NodePool(journal_path=journal, miss_threshold=1, probe_timeout=3.0)
    for i in range(2):
        p.add_node(RemoteNode.spawn_local(num_workers=1), name=f"n{i}")
    p.journal_file = journal
    yield p
    p.close(close_nodes=True)


def test_nodes_equal_threads_and_the_fold_bit_for_bit(pool):
    want, params = _fold(3)
    with DistributedTrainer(JOB_REF, dict(JOB_KW), _cfg("nodes-eq"),
                            backend="nodes", world=2, pool=pool) as tr:
        # the gang spreads the two ranks over both agents
        assert sorted(h.node_name for h in tr._workers) == ["n0", "n1"]
        assert len({h.address for h in tr._workers}) == 2
        got = tr.fit(3)
        assert _same(tr.fetch_state(), params)
        assert tr.stats()["backend"] == "nodes"
        # each rank reports from its own process: (stage, shard)
        # gradients of 3 towers x 2 shards x 3 steps, and no kernel
        # launch (the CPU runs the plain versions)
        ranks = [h.call("stats") for h in tr._workers]
        assert [r["rank"] for r in ranks] == [0, 1]
        assert [r["shard_grads"] for r in ranks] == [18, 18]
        assert all(not any(r["launch_counts"].values()) for r in ranks)
        slots_held = {n: pool.live_nodes()[n].stats()["free_slots"]
                      for n in ("n0", "n1")}
    with DistributedTrainer(JOB_REF, dict(JOB_KW), _cfg("threads-eq"),
                            backend="threads", world=2) as tr:
        threads = tr.fit(3)
    assert got == threads == want
    # the gang's slots come back on close
    for n in ("n0", "n1"):
        assert (pool.live_nodes()[n].stats()["free_slots"]
                == slots_held[n] + 1)
    ev = _events(pool.journal_file, "nodes-eq")
    assert [e["event"] for e in ev] == [
        "train_worker_placed", "train_worker_placed", "train_started"]
    assert ev[-1]["backend"] == "nodes" and ev[-1]["world"] == 2


def test_killed_agent_shrinks_the_world_bit_for_bit(pool):
    want, params = _fold(4)
    with DistributedTrainer(JOB_REF, dict(JOB_KW), _cfg("nodes-kill"),
                            backend="nodes", world=2, pool=pool) as tr:
        victim = tr._workers[-1]

        def kill_after_step_1(done, metrics):
            if done == 1:
                victim.node.kill()        # SIGKILL the rank's agent
        got = tr.fit(4, on_step=kill_after_step_1)
        assert tr.world == 1 and tr.stats()["shrinks"] == 1
        assert victim.node_name not in pool.live_nodes()
        assert _same(tr.fetch_state(), params)
    assert got == want
    ev = [e["event"] for e in _events(pool.journal_file, "nodes-kill")]
    assert ev.count("train_worker_lost") == 1
    assert ev.count("train_shrunk") == 1
    lost = next(e for e in _events(pool.journal_file, "nodes-kill")
                if e["event"] == "train_worker_lost")
    assert lost["node"] == victim.node_name


def test_grow_onto_a_named_agent(pool):
    """``add_worker`` starts a rank on a node agent and the trajectory
    continues bit for bit."""
    want, params = _fold(4)
    with DistributedTrainer(JOB_REF, dict(JOB_KW), _cfg("nodes-grow"),
                            backend="nodes", world=1, pool=pool) as tr:
        assert tr.fit(2) == want[:2]
        tr.add_worker("n1")
        assert tr.world == 2 and tr._workers[-1].node_name == "n1"
        assert tr.fit(4) == want
        assert _same(tr.fetch_state(), params)
    ev = [e["event"] for e in _events(pool.journal_file, "nodes-grow")]
    assert ev.count("train_grown") == 1


def test_fit_distributed_takes_a_pool(pool):
    want, _ = _fold(2)
    assert fit_distributed(JOB_REF, 2, job_kwargs=dict(JOB_KW),
                           cfg=_cfg("nodes-fd"), backend="nodes", world=2,
                           pool=pool) == want


def test_nodes_backend_needs_a_pool_and_a_job_ref(pool):
    with pytest.raises(ValueError, match="NodePool"):
        DistributedTrainer(JOB_REF, dict(JOB_KW), _cfg("no-pool"),
                           backend="nodes", world=2)
    with pytest.raises(ValueError, match="job ref"):
        DistributedTrainer(job=demo_job(**JOB_KW, device="cpu"),
                           cfg=_cfg("no-ref"), backend="nodes", world=2,
                           pool=pool)


def test_nodes_agree_with_the_reference_threads_backend(pool, tmp_path):
    """The JAX package's threads backend on its own demo_job, and the
    port's nodes backend on the same weights and batches (carried to the
    ranks in an ``.npz``): losses within the reference's fp32 budget."""
    import jax

    from tosem_tpu.ops.parity import TOLERANCES
    from tosem_tpu.train.distributed import DataParallelConfig as RefCfg
    from tosem_tpu.train.distributed import DistributedTrainer as RefTrainer
    from tosem_tpu.train.distributed import demo_job as ref_demo
    ref_job = ref_demo(**JOB_KW)
    init = jax.tree_util.tree_map(
        np.asarray, ref_job.init_state()["params"])
    arrays = {f"p/{stage}/{leaf}": a for stage, sub in init.items()
              for leaf, a in sub.items()}
    for step in range(3):
        for k, v in ref_job.batch_fn(step).items():
            arrays[f"b{step}/{k}"] = np.asarray(v)
    npz = str(tmp_path / "ref_job.npz")
    np.savez(npz, **arrays)
    rcfg = RefCfg(grain=4, bucket_bytes=1024, job="ref-threads",
                  transport_capacity=8 << 20)
    with RefTrainer("tosem_tpu.train.distributed:demo_job", dict(JOB_KW),
                    rcfg, backend="threads", world=2) as ref_tr:
        ref_losses = ref_tr.fit(3)
    kw = dict(JOB_KW, npz=npz)
    with DistributedTrainer("tests.test_torch_cluster_jobs:npz_demo_job",
                            kw, _cfg("nodes-xpkg"), backend="nodes",
                            world=2, pool=pool) as tr:
        got = tr.fit(3)
    tol = TOLERANCES["flash"]["float32"]
    np.testing.assert_allclose(got, ref_losses, rtol=tol, atol=tol)
    assert os.path.exists(npz)
