"""The port's data-parallel training (``tosem_tpu_torch/train/
distributed.py``): the JAX package's ``tests/test_train_distributed.py``
run against the copy, plus the packages held against each other.

Inside the port the contract is bit for bit: a job's loss trajectory and
final parameters are a pure function of (job, grain), whatever the world
size, the overlap mode or a mid-run shrink and grow, so every run here
is ``torch.equal`` to the single-process local fold. Across the packages
the local folds agree within the fp32 budget on the reference's own
``demo_job`` weights and batches. The straggler watchdog's copies
assert on the compute times the ranks report, never on wall time: the
ranks' clocks are frozen, so a rank's report is exactly the slowness
injected into it.
"""
import numpy as np
import pytest
import torch

from tosem_tpu_torch.train.distributed import (Bucket, DataParallelConfig,
                                               DistributedTrainer,
                                               TrainWorkerLost,
                                               _assign_shards, demo_job,
                                               dp_params_from_numpy,
                                               fit_distributed,
                                               make_dp_train_step,
                                               partition_buckets)

torch.set_num_threads(1)

JOB_KW = dict(towers=3, dim=16, batch=16, grain=4, seed=7, device="cpu")
JOB_REF = "tosem_tpu_torch.train.distributed:demo_job"


def _reference(num_steps, jobkw=JOB_KW):
    """The single-process local fold: (losses, final parameter leaves)."""
    job = demo_job(**jobkw)
    state = job.init_state()
    step_fn = make_dp_train_step(job)
    out = []
    for _ in range(num_steps):
        state, m = step_fn(state)
        out.append(m["loss"])
    return out, [p.clone() for p in state.leaves()]


def _reference_losses(num_steps, jobkw=JOB_KW):
    return _reference(num_steps, jobkw)[0]


def _same_params(tr, want):
    got = tr.fetch_state().leaves()
    return len(got) == len(want) and all(torch.equal(a, b)
                                         for a, b in zip(got, want))


def _trainer(world=2, jobkw=JOB_KW, **kw):
    cfg = kw.pop("cfg", None) or DataParallelConfig(
        grain=jobkw["grain"], bucket_bytes=kw.pop("bucket_bytes", 1024),
        job=kw.pop("job", f"test-{world}"), transport_capacity=8 << 20)
    return DistributedTrainer(JOB_REF, dict(jobkw), cfg,
                              backend="threads", world=world, **kw)


# ------------------------------------------------------------- buckets


class TestPartitionBuckets:
    def test_size_targeted_runs(self):
        meta = [(100, 0), (150, 0), (100, 0), (60, 0)]
        out = partition_buckets(meta, bucket_bytes=260)
        assert [b.leaves for b in out] == [(0, 1), (2, 3)]
        assert [b.nbytes for b in out] == [250, 160]
        assert [b.bid for b in out] == [0, 1]

    def test_oversized_leaf_rides_alone(self):
        meta = [(10, 0), (5000, 0), (10, 0)]
        out = partition_buckets(meta, bucket_bytes=100)
        assert [b.leaves for b in out] == [(0,), (1,), (2,)]

    def test_uneven_tail_gets_own_bucket(self):
        meta = [(90, 0)] * 5
        out = partition_buckets(meta, bucket_bytes=180)
        assert [b.leaves for b in out] == [(0, 1), (2, 3), (4,)]

    def test_buckets_never_span_stages(self):
        meta = [(10, 0), (10, 1), (10, 1), (10, 2)]
        out = partition_buckets(meta, bucket_bytes=10_000)
        assert [b.leaves for b in out] == [(0,), (1, 2), (3,)]
        assert [b.stage for b in out] == [0, 1, 2]

    def test_single_param_bucket(self):
        out = partition_buckets([(42, 0)], bucket_bytes=1)
        assert out == [Bucket(bid=0, stage=0, leaves=(0,), nbytes=42)]

    def test_dtype_mixed_tree_groups_without_concat(self):
        meta = [(4 * 8, 0), (2 * 8, 0), (8 * 8, 0), (4, 0)]
        out = partition_buckets(meta, bucket_bytes=70)
        flat = [li for b in out for li in b.leaves]
        assert flat == [0, 1, 2, 3]
        assert sum(b.nbytes for b in out) == sum(nb for nb, _ in meta)

    def test_bad_bucket_bytes_rejected(self):
        with pytest.raises(ValueError):
            partition_buckets([(1, 0)], bucket_bytes=0)

    @pytest.mark.parametrize("meta,nbytes", [
        ([(100, 0), (150, 0), (100, 0), (60, 0)], 260),
        ([(10, 0), (5000, 0), (10, 0)], 100),
        ([(90, 0)] * 5, 180),
        ([(10, 0), (10, 1), (10, 1), (10, 2)], 10_000)])
    def test_same_buckets_as_the_reference(self, meta, nbytes):
        from tosem_tpu.train.distributed import partition_buckets as ref
        assert ([tuple(vars(b).values()) for b in
                 partition_buckets(meta, nbytes)]
                == [tuple(vars(b).values()) for b in ref(meta, nbytes)])


def test_assign_shards_contiguous_ascending():
    assert _assign_shards(4, 2) == [[0, 1], [2, 3]]
    assert _assign_shards(4, 3) == [[0, 1], [2], [3]]
    assert _assign_shards(5, 2) == [[0, 1, 2], [3, 4]]
    assert _assign_shards(4, 4) == [[0], [1], [2], [3]]


# -------------------------------------------------------- bit identity


class TestBitIdentity:
    @pytest.mark.parametrize("world", [1, 2, 4])
    @pytest.mark.parametrize("overlap", [True, False])
    def test_world_and_overlap_match_local_fold(self, world, overlap):
        # losses AND every parameter, bit for bit
        ref, params = _reference(3)
        with _trainer(world=world, job=f"bi-{world}-{overlap}") as tr:
            tr.overlap = overlap
            assert tr.fit(3) == ref
            assert _same_params(tr, params)

    def test_uneven_shard_runs_match(self):
        # world=3 over grain=4: ranks own 2/1/1 shards — the fold
        # grouping must still be ((g0+g1)+g2)+g3
        ref, params = _reference(3)
        with _trainer(world=3, job="bi-dp3") as tr:
            assert tr.fit(3) == ref
            assert _same_params(tr, params)

    def test_serialized_comms_identical_to_overlap(self):
        # overlap changes WHEN reduces launch, never the fold order
        with _trainer(world=2, job="bi-ov") as a:
            a.overlap = True
            ov = a.fit(3)
        with _trainer(world=2, job="bi-se") as b:
            b.overlap = False
            se = b.fit(3)
        assert ov == se == _reference_losses(3)

    def test_mixed_precision_arms_agree(self):
        kw = dict(JOB_KW, mixed_precision=True)
        ref, params = _reference(3, kw)
        with _trainer(world=2, jobkw=kw, job="bi-mp") as tr:
            assert tr.fit(3) == ref
            assert _same_params(tr, params)

    def test_every_rank_contributes_to_the_fold(self):
        # corrupt ONE rank's replicated params: its shard gradients
        # enter the fold, so the trajectory must depart from the
        # reference — proof the chain really sums every rank's shards
        ref = _reference_losses(4)
        with _trainer(world=2, job="bi-sens") as tr:
            assert tr.fit(1) == ref[:1]
            with torch.no_grad():
                tr._workers[0].backend._state.params["s00"]["w"].add_(1.0)
            got = tr.fit(4)
        assert got[1:] != ref[1:]


# ----------------------------------------------------------- elasticity


class TestElastic:
    def test_shrink_mid_epoch_bit_identical(self):
        ref, params = _reference(6)
        with _trainer(world=3, job="el-shrink") as tr:
            tr._workers[-1].fail_at_step = 2   # dies inside step 2
            got = tr.fit(6)
            assert got == ref and _same_params(tr, params)
            st = tr.stats()
            assert st["world"] == 2 and st["shrinks"] == 1

    def test_grow_mid_epoch_bit_identical(self):
        ref, params = _reference(6)
        with _trainer(world=2, job="el-grow") as tr:
            tr.fit(3)
            tr.add_worker()
            got = tr.fit(6)
            assert got == ref and _same_params(tr, params)
            st = tr.stats()
            assert st["world"] == 3 and st["grows"] == 1

    def test_shrink_then_grow_same_trajectory(self):
        ref, params = _reference(8)
        with _trainer(world=3, job="el-sg") as tr:
            tr._workers[-1].fail_at_step = 2
            tr.fit(5)
            tr.add_worker()
            assert tr.fit(8) == ref
            # the grown rank adopted rank 0's state byte for byte
            assert all(torch.equal(a, b) for a, b in zip(
                tr._workers[-1].backend._state.leaves(), params))
            st = tr.stats()
            assert st["shrinks"] == 1 and st["grows"] == 1

    def test_chaos_kill_at_world4_then_grow_back(self):
        # the chip's shrink/grow run at CPU size: the chaos site loses
        # the highest rank at step 1, a rank grows back after it
        from tosem_tpu_torch.chaos import ChaosController, Fault, FaultPlan
        ref, params = _reference(3)
        plan = FaultPlan(seed=3, name="dp-kill", faults=[
            Fault(site="train.dist_step", action="kill_node", at=2)])
        with _trainer(world=4, job="el-chaos") as tr:
            with ChaosController(plan) as chaos:
                tr.fit(2)
            assert len(chaos.log) == 1 and tr.world == 3
            tr.add_worker()
            assert tr.fit(3) == ref and _same_params(tr, params)
            assert tr.world == 4

    def test_double_death_same_step(self):
        ref = _reference_losses(5)
        with _trainer(world=4, job="el-dd") as tr:
            tr._workers[-1].fail_at_step = 1
            tr._workers[-2].fail_at_step = 1
            assert tr.fit(5) == ref
            assert tr.world == 2

    def test_all_dead_raises(self):
        with _trainer(world=2, job="el-dead") as tr:
            tr._workers[0].fail_at_step = 1
            tr._workers[1].fail_at_step = 1
            with pytest.raises(TrainWorkerLost):
                tr.fit(4)

    def test_grow_beyond_grain_rejected(self):
        with _trainer(world=4, job="el-cap") as tr:
            with pytest.raises(ValueError, match="grain"):
                tr.add_worker()

    def test_world_bounds_validated(self):
        with pytest.raises(ValueError, match="world"):
            _trainer(world=5, job="el-bounds")


# --------------------------------------------------- checkpoint resume


class TestCheckpointResume:
    def test_resume_across_restart_bit_identical(self, tmp_path):
        ref, params = _reference(8)
        root = str(tmp_path / "ckpt")
        with _trainer(world=2, job="ck-a", ckpt_dir=root,
                      checkpoint_every=2, async_save=False) as tr:
            assert tr.fit(4) == ref[:4]
        with _trainer(world=2, job="ck-b", ckpt_dir=root,
                      checkpoint_every=2, async_save=False) as tr:
            assert tr.fit(8) == ref
            assert _same_params(tr, params)

    def test_resume_across_node_death_mid_epoch(self, tmp_path):
        ref = _reference_losses(8)
        root = str(tmp_path / "ckpt")
        with _trainer(world=3, job="ck-kill", ckpt_dir=root,
                      checkpoint_every=1, async_save=False) as tr:
            tr._workers[-1].fail_at_step = 3
            assert tr.fit(5) == ref[:5]
            assert tr.stats()["shrinks"] == 1
        with _trainer(world=2, job="ck-kill2", ckpt_dir=root,
                      checkpoint_every=1, async_save=False) as tr:
            assert tr.fit(8) == ref

    def test_async_checkpoints_resume_identically(self, tmp_path):
        ref = _reference_losses(6)
        root = str(tmp_path / "ckpt")
        with _trainer(world=2, job="ck-async", ckpt_dir=root,
                      checkpoint_every=1, async_save=True) as tr:
            assert tr.fit(3) == ref[:3]
            # close() flushes the background writer via the backend
        with _trainer(world=2, job="ck-async2", ckpt_dir=root,
                      checkpoint_every=1, async_save=True) as tr:
            assert tr.fit(6) == ref

    def test_fit_distributed_one_shot(self, tmp_path):
        ref = _reference_losses(3)
        got = fit_distributed(JOB_REF, 3, job_kwargs=dict(JOB_KW),
                              cfg=DataParallelConfig(
                                  grain=4, bucket_bytes=1024,
                                  job="ck-oneshot",
                                  transport_capacity=8 << 20),
                              world=2,
                              ckpt_dir=str(tmp_path / "ck"))
        assert got == ref


# ------------------------------------------- reduction-arm validation


def _dp_mesh(n=4):
    from tosem_tpu_torch.parallel.mesh import default_mesh
    return default_mesh("dp", ["cpu"] * n)


def _shard_map_run(num_steps=3, jobkw=JOB_KW, job=None):
    """The shard_map arm on a dp mesh of 4 CPU positions: (losses, final
    parameter leaves)."""
    job = job or demo_job(**jobkw)
    step_fn = make_dp_train_step(job, reduce="shard_map", mesh=_dp_mesh())
    state = job.init_state()
    out = []
    for _ in range(num_steps):
        state, m = step_fn(state)
        out.append(m["loss"])
    return out, [p.clone() for p in state.leaves()]


class TestReductionArms:
    def test_shard_map_arm_names_its_roadmap_item(self):
        # the on-device collective arm is ported (A10) and builds on a dp
        # mesh; the mesh train steps beside it, whose loss is the global
        # batch's, are what still name their roadmap item
        from tosem_tpu_torch.train.trainer import (
            make_partitioned_train_step, make_train_step, shard_batch)
        assert callable(make_dp_train_step(demo_job(**JOB_KW),
                                           reduce="shard_map",
                                           mesh=_dp_mesh()))
        model = torch.nn.Linear(2, 2)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        remainder = "A10's remainder: global-semantics mesh training"
        with pytest.raises(NotImplementedError, match=remainder):
            make_train_step(model, opt, None, mesh=_dp_mesh())
        with pytest.raises(NotImplementedError, match=remainder):
            make_partitioned_train_step(model, opt, None, _dp_mesh())
        with pytest.raises(NotImplementedError, match=remainder):
            shard_batch({}, _dp_mesh())

    def test_shard_map_arm_validates_mesh(self):
        job = demo_job(**JOB_KW)
        with pytest.raises(ValueError, match="mesh"):
            make_dp_train_step(job, reduce="shard_map")
        with pytest.raises(ValueError, match="grain"):
            make_dp_train_step(job, reduce="shard_map", mesh=_dp_mesh(2))
        with pytest.raises(ValueError, match="grain"):
            make_dp_train_step(job, reduce="shard_map", mesh=_dp_mesh(),
                               dp_axis="tp")

    @pytest.mark.parametrize("mixed_precision", [False, True])
    def test_shard_map_arm_float_parity(self, mixed_precision):
        # the reference's pin: float parity with the fold (rtol 2e-5).
        # The port's psum folds in shard order, as the local arm does,
        # and each shard's gradients do not depend on what runs beside
        # them, so on the CPU the two arms agree bit for bit as well
        kw = dict(JOB_KW, mixed_precision=mixed_precision)
        ref, ref_params = _reference(3, kw)
        got, params = _shard_map_run(3, kw)
        np.testing.assert_allclose(got, ref, rtol=2e-5)
        assert got == ref
        assert all(torch.equal(a, b) for a, b in zip(params, ref_params))

    def test_transport_arm_parity_with_shard_map_arm(self):
        # cross-arm check: chain-transport dp (bit == local fold) vs the
        # shard_map psum: the same trajectory to float tolerance
        sm, _ = _shard_map_run(3)
        with _trainer(world=4, job="arm-x") as tr:
            tp = tr.fit(3)
        np.testing.assert_allclose(tp, sm, rtol=2e-5)

    def test_shard_map_arm_steps_one_state_object_forward(self):
        # the arm updates its state in place, as the local fold does:
        # three calls on one state object give the local fold's three
        # losses
        job = demo_job(**JOB_KW)
        step_fn = make_dp_train_step(job, reduce="shard_map",
                                     mesh=_dp_mesh())
        state = job.init_state()
        losses = [step_fn(state)[1]["loss"] for _ in range(3)]
        assert losses == _reference_losses(3)

    def test_unknown_reduce_rejected(self):
        with pytest.raises(ValueError, match="lowering"):
            make_dp_train_step(demo_job(**JOB_KW), reduce="nccl")

    def test_nodes_backend_names_its_roadmap_item(self):
        with pytest.raises(NotImplementedError, match="A11"):
            DistributedTrainer(JOB_REF, dict(JOB_KW),
                               DataParallelConfig(job="nodes"),
                               backend="nodes", world=2)

    def test_unknown_backend_rejected(self):
        with pytest.raises(ValueError, match="backend"):
            DistributedTrainer(JOB_REF, dict(JOB_KW),
                               DataParallelConfig(job="nope"),
                               backend="mpi", world=2)


# ------------------------------------------------- the packages agree


def _fp32_tol():
    """The reference's fp32 parity budget (``TOLERANCES``)."""
    from tosem_tpu.ops.parity import TOLERANCES
    return TOLERANCES["flash"]["float32"]


def _ref_job_state(kw):
    """The reference's demo_job, its initial params as numpy, and its
    local fold's losses and final params over 3 steps."""
    import jax
    from tosem_tpu.train.distributed import demo_job as ref_demo
    from tosem_tpu.train.distributed import make_dp_train_step as ref_step
    job = ref_demo(**kw)
    state = job.init_state()
    init = jax.tree_util.tree_map(np.asarray, state["params"])
    step_fn = ref_step(job)
    losses = []
    for _ in range(3):
        state, m = step_fn(state)
        losses.append(m["loss"])
    final = [np.asarray(x) for x in
             jax.tree_util.tree_leaves(state["params"])]
    return job, init, losses, final


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_local_fold_agrees_with_the_reference(mixed_precision):
    """Both packages' local folds on the reference's demo_job: its
    weights carried across, its batches from its own batch_fn."""
    kw = dict(towers=3, dim=16, batch=16, grain=4, seed=7,
              mixed_precision=mixed_precision)
    ref_job, init, ref_losses, ref_final = _ref_job_state(kw)
    job = demo_job(**kw, device="cpu")
    job.init_params = lambda: dp_params_from_numpy(init, device="cpu")
    job.batch_fn = lambda step: {
        k: torch.from_numpy(np.asarray(v).copy())
        for k, v in ref_job.batch_fn(step).items()}
    state = job.init_state()
    step_fn = make_dp_train_step(job)
    losses = []
    for _ in range(3):
        state, m = step_fn(state)
        losses.append(m["loss"])
    tol = _fp32_tol()
    np.testing.assert_allclose(losses, ref_losses, rtol=tol, atol=tol)
    got = [p.numpy() for p in state.leaves()]
    assert len(got) == len(ref_final)
    for g, w in zip(got, ref_final):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_transport_arm_agrees_with_the_reference():
    """The port's chain (world 4) and the reference's local fold on the
    same weights and batches: within the fp32 budget."""
    kw = dict(towers=3, dim=16, batch=16, grain=4, seed=7)
    ref_job, init, ref_losses, _ = _ref_job_state(kw)
    job = demo_job(**kw, device="cpu")
    job.init_params = lambda: dp_params_from_numpy(init, device="cpu")
    job.batch_fn = lambda step: {
        k: torch.from_numpy(np.asarray(v).copy())
        for k, v in ref_job.batch_fn(step).items()}
    cfg = DataParallelConfig(grain=4, bucket_bytes=1024, job="xpkg",
                             transport_capacity=8 << 20)
    with DistributedTrainer(job=job, cfg=cfg, world=4) as tr:
        got = tr.fit(3)
    np.testing.assert_allclose(got, ref_losses, rtol=_fp32_tol(),
                               atol=_fp32_tol())


def test_shard_map_arm_agrees_with_the_reference_s():
    """The port's shard_map arm (4 CPU positions) against the
    reference's shard_map arm (4 of conftest's virtual CPU devices) on
    the reference's demo_job weights and batches: the reference's
    rtol 2e-5."""
    import jax
    from jax.sharding import Mesh
    from tosem_tpu.train.distributed import make_dp_train_step as ref_step
    kw = dict(towers=3, dim=16, batch=16, grain=4, seed=7)
    ref_job, init, _, _ = _ref_job_state(kw)
    ref_fn = ref_step(ref_job, reduce="shard_map",
                      mesh=Mesh(np.array(jax.devices()[:4]), ("dp",)))
    state = ref_job.init_state()
    ref_losses = []
    for _ in range(3):
        state, m = ref_fn(state)
        ref_losses.append(m["loss"])
    job = demo_job(**kw, device="cpu")
    job.init_params = lambda: dp_params_from_numpy(init, device="cpu")
    job.batch_fn = lambda step: {
        k: torch.from_numpy(np.asarray(v).copy())
        for k, v in ref_job.batch_fn(step).items()}
    got, params = _shard_map_run(3, job=job)
    np.testing.assert_allclose(got, ref_losses, rtol=2e-5)
    ref_final = [np.asarray(x) for x in
                 jax.tree_util.tree_leaves(state["params"])]
    for g, w in zip(params, ref_final):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=1e-7)


def test_bert_stage_carries_across_through_the_converter():
    import dataclasses

    import jax
    import optax
    from tosem_tpu.models.bert import Bert as JBert
    from tosem_tpu.models.bert import BertConfig as JConfig
    from tosem_tpu.train.trainer import create_train_state
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.models.convert import bert_params_from_numpy
    cfg = dataclasses.replace(JConfig.tiny(), dtype="bfloat16")
    ts = create_train_state(JBert(cfg), jax.random.PRNGKey(0),
                            optax.adamw(1e-4))
    tree = {"bert": jax.tree_util.tree_map(np.asarray, ts["params"])}
    got = dp_params_from_numpy(tree, device="cpu",
                               stages={"bert": bert_params_from_numpy})
    port = Bert(BertConfig.tiny(), device="cpu").state_dict()
    assert sorted(got["bert"]) == sorted(port)
    want = bert_params_from_numpy(tree["bert"])
    for name, t in got["bert"].items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, want[name])


# ------------------------------------------------- straggler watchdog


def _wd_cfg(job, **kw):
    return DataParallelConfig(grain=4, bucket_bytes=1024, job=job,
                              transport_capacity=8 << 20,
                              straggler_factor=kw.pop("factor", 4.0),
                              straggler_min_samples=kw.pop("samples", 2),
                              straggler_min_s=kw.pop("floor", 0.05), **kw)


def _frozen(tr):
    """Freeze every rank's compute clock: a rank then reports exactly
    the slowness injected into it (``set_debug_slow``), whatever the
    host's load."""
    for h in tr._workers:
        h.backend.clock = lambda: 0.0
    return tr


class TestStragglerWatchdog:
    def test_slow_rank_evicted_bit_identical(self):
        # a gray-slow rank (alive to every probe) must be evicted
        # through the SAME shrink path as a death, and the trajectory
        # must not notice — shard boundaries move, the fold order
        # doesn't
        ref, params = _reference(8)
        with _frozen(_trainer(world=3, cfg=_wd_cfg("wd-evict"))) as tr:
            tr._workers[-1].backend.set_debug_slow(0.06)
            got = tr.fit(8)
            st = tr.stats()
            assert _same_params(tr, params)
        assert got == ref
        assert st["straggler_evictions"] == 1
        assert st["world"] == 2 and st["shrinks"] == 1

    def test_recovery_same_magnitude_as_node_death(self):
        # the acceptance bound, counted in steps: a slow rank costs the
        # detection window (min_samples slow steps) and then the death
        # path's one rewire — it leaves at the same point a rank that
        # died right after those steps leaves
        ref = _reference_losses(6)
        evicted_at = {}
        with _trainer(world=3, cfg=_wd_cfg("wd-mag-dead")) as tr:
            tr._workers[-1].fail_at_step = 2
            assert tr.fit(6) == ref
            dead = tr.stats()
        with _frozen(_trainer(world=3, cfg=_wd_cfg("wd-mag-slow"))) as tr:
            tr._workers[-1].backend.set_debug_slow(0.06)

            def on_step(done, _):
                evicted_at.setdefault(tr.world, done)
            assert tr.fit(6, on_step=on_step) == ref
            slow = tr.stats()
        assert dead["shrinks"] == slow["shrinks"] == 1
        assert dead["world"] == slow["world"] == 2
        # two slow samples (the first two steps), evicted after them:
        # the first step done at world 2 is the third, as after a death
        # inside the third step
        assert evicted_at == {3: 1, 2: 3}

    def test_watchdog_off_by_default(self):
        # straggler_factor=0.0 is the default: a slow rank makes the
        # run slower, never smaller
        assert DataParallelConfig().straggler_factor == 0.0
        ref = _reference_losses(3)
        with _frozen(_trainer(world=2, job="wd-off")) as tr:
            tr._workers[-1].backend.set_debug_slow(0.06)
            assert tr.fit(3) == ref
            st = tr.stats()
        assert st["straggler_evictions"] == 0 and st["world"] == 2

    def test_absolute_floor_protects_fast_fleets(self):
        # with the watchdog armed, ranks 10, 20 and 30 ms apart trip the
        # 1.2 factor (30 > 1.2 x 20) but sit under the 50 ms absolute
        # floor — the factor alone must never evict
        ref = _reference_losses(5)
        with _frozen(_trainer(world=3,
                              cfg=_wd_cfg("wd-floor", factor=1.2))) as tr:
            for h, s in zip(tr._workers, (0.01, 0.02, 0.03)):
                h.backend.set_debug_slow(s)
            assert tr.fit(5) == ref
            st = tr.stats()
        assert st["straggler_evictions"] == 0 and st["world"] == 3

    def test_chaos_slow_node_drives_watchdog(self):
        # the canned-fault route: train.dist_step/slow_node turns the
        # highest rank gray at step 2; the watchdog must evict it and
        # the trajectory must stay bit-identical
        from tosem_tpu_torch.chaos import ChaosController, Fault, FaultPlan
        ref = _reference_losses(8)
        plan = FaultPlan(seed=71, name="wd-chaos", faults=[
            Fault(site="train.dist_step", action="slow_node", at=2,
                  delay_s=0.06)])
        with ChaosController(plan):
            with _frozen(_trainer(world=3, cfg=_wd_cfg("wd-chaos"))) as tr:
                got = tr.fit(8)
                st = tr.stats()
        assert got == ref
        assert st["straggler_evictions"] == 1 and st["world"] == 2


# ------------------------------------------------------- observability


def test_http_stats_includes_live_train_jobs():
    # the serving ingress's /-/stats rolls live training jobs in next
    # to the deployments (telemetry never fails the endpoint)
    import json
    from urllib.request import urlopen

    from tosem_tpu_torch.serve.http import HttpIngress

    class _Controller:
        def get_deployment(self, name):
            return None

        def list_deployments(self):
            return []

        def stats(self):
            return {}

    cfg = DataParallelConfig(grain=4, bucket_bytes=1024,
                             job="http-job", transport_capacity=8 << 20)
    tr = DistributedTrainer(JOB_REF, dict(JOB_KW), cfg,
                            backend="threads", world=2)
    ingress = HttpIngress(_Controller())
    try:
        tr.fit(1)
        st = json.loads(urlopen(f"{ingress.url}/-/stats",
                                timeout=30).read())
        assert st["train"]["http-job"]["world"] == 2
        assert st["train"]["http-job"]["step"] == 1
    finally:
        ingress.shutdown()
        tr.close()
    # closed trainers drop out of the rollup
    from tosem_tpu_torch.train.distributed import jobs_stats
    assert "http-job" not in jobs_stats()


def test_stats_and_metrics_rollup():
    from tosem_tpu_torch.obs.metrics import Registry
    reg = Registry()
    cfg = DataParallelConfig(grain=4, bucket_bytes=1024, job="obs-job",
                             transport_capacity=8 << 20)
    tr = DistributedTrainer(JOB_REF, dict(JOB_KW), cfg,
                            backend="threads", world=2, registry=reg)
    try:
        tr.fit(2)
        from tosem_tpu_torch.train.distributed import jobs_stats
        js = jobs_stats()
        assert js["obs-job"]["step"] == 2
        assert js["obs-job"]["world"] == 2
        text = reg.prometheus_text()
        assert 'train_steps_total{job="obs-job"} 2' in text
        assert 'train_dp_size{job="obs-job"} 2' in text
        assert "train_allreduce_bytes_total" in text
        assert "train_allreduce_ms" in text
        assert "train_examples_per_s" in text
    finally:
        tr.close()
    assert "obs-job" not in jobs_stats()
