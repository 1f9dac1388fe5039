"""The port's device mesh (``tosem_tpu_torch/parallel``: ``mesh.py``,
``spmd.py``, ``collectives.py``, ``sharding.py``): the JAX package's
``tests/test_parallel.py`` and the rule tests of ``tests/test_sharding.py``
run against the port, plus the two packages held against each other.

The reference runs on ``conftest.py``'s 8 virtual CPU devices, the port
on 8 CPU positions. The collectives' inputs are integer-valued fp32, so
both packages' sums are exact and compared bit for bit.
"""
import os
import socket
import sys
import threading

import numpy as np
import pytest
import torch

from tosem_tpu_torch.parallel.collectives import (
    CollectiveSpec, _make_global_input, all_gather_op, all_reduce,
    all_to_all_op, broadcast, bus_bandwidth_factor, collective_bench,
    reduce_scatter_op, ring_permute)
from tosem_tpu_torch.parallel.mesh import (Mesh, MeshSpec, default_mesh,
                                           make_mesh, multihost_init)
from tosem_tpu_torch.parallel.spmd import (P, Sharded, all_gather,
                                           all_to_all, assemble, axis_index,
                                           axis_size, pbroadcast, ppermute,
                                           psum, psum_scatter, shard_map,
                                           split)

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


@pytest.fixture
def mesh1d_t():
    return default_mesh("x", CPU8)


@pytest.fixture
def mesh2d_t():
    return make_mesh(MeshSpec.of(dp=4, tp=2), CPU8)


# ----------------------------------------------------------------- mesh


class TestMeshSpec:
    def test_resolve_exact(self):
        assert MeshSpec.of(dp=4, tp=2).resolve(8) == {"dp": 4, "tp": 2}

    def test_resolve_wildcard(self):
        assert MeshSpec.of(dp=-1, tp=2).resolve(8) == {"dp": 4, "tp": 2}

    def test_resolve_errors(self):
        with pytest.raises(ValueError):
            MeshSpec.of(dp=3, tp=2).resolve(8)
        with pytest.raises(ValueError):
            MeshSpec.of(dp=-1, tp=-1).resolve(8)
        with pytest.raises(ValueError):
            MeshSpec.of(dp=-1, tp=3).resolve(8)

    @pytest.mark.parametrize("axes,n", [({"dp": 4, "tp": 2}, 8),
                                        ({"dp": -1, "tp": 2}, 8),
                                        ({"dp": 2, "sp": -1, "tp": 2}, 8),
                                        ({"x": -1}, 8), ({"dp": 1}, 1)])
    def test_resolve_matches_the_reference(self, axes, n):
        from tosem_tpu.parallel.mesh import MeshSpec as JSpec
        assert MeshSpec.of(**axes).resolve(n) == JSpec.of(**axes).resolve(n)

    def test_make_mesh(self):
        mesh = make_mesh(MeshSpec.of(dp=2, tp=4), CPU8)
        assert mesh.shape == {"dp": 2, "tp": 4}
        assert mesh.size == 8 and mesh.cards() == 1
        mesh = default_mesh("x", CPU8)
        assert mesh.shape == {"x": 8}

    def test_make_mesh_wants_every_position(self):
        # as the reference's: fixed axes must cover the devices given
        with pytest.raises(ValueError, match="wants 4 devices"):
            make_mesh(MeshSpec.of(dp=2, tp=2), CPU8)
        mesh = make_mesh(MeshSpec.of(dp=2, tp=2), CPU8[:4])
        assert mesh.coords(3) == {"dp": 1, "tp": 1}

    def test_positions_share_a_device(self):
        mesh = Mesh(np.array([torch.device("cpu")] * 4, dtype=object)
                    .reshape(2, 2), ("dp", "tp"))
        assert {str(mesh.device_of(i)) for i in range(4)} == {"cpu"}
        with pytest.raises(ValueError):
            Mesh(np.array(CPU8, dtype=object), ("a", "b"))

    def test_no_devices_takes_every_card_or_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: every card is a valid default")
        with pytest.raises(RuntimeError, match="device_count"):
            make_mesh(MeshSpec.of(dp=-1))
        with pytest.raises(RuntimeError, match="device_count"):
            default_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            default_mesh("x", ["cuda"] * 2)

    def test_multihost_noop_without_env(self, monkeypatch):
        monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
        assert multihost_init() is False

    def test_multihost_partial_env_raises_in_both_packages(self,
                                                           monkeypatch):
        from tosem_tpu.parallel.mesh import multihost_init as j_init
        monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
        monkeypatch.delenv("NUM_PROCESSES", raising=False)
        monkeypatch.delenv("PROCESS_ID", raising=False)
        for fn in (multihost_init, j_init):
            with pytest.raises(ValueError, match="NUM_PROCESSES"):
                fn()

    def test_multihost_init_joins_a_gloo_group(self, monkeypatch):
        import torch.distributed as dist
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        monkeypatch.setenv("COORDINATOR_ADDRESS", f"localhost:{port}")
        monkeypatch.setenv("NUM_PROCESSES", "1")
        monkeypatch.setenv("PROCESS_ID", "0")
        try:
            if torch.cuda.is_available():
                pytest.skip("a GPU is present: the group would be nccl")
            assert multihost_init() is True
            assert dist.get_world_size() == 1 and dist.get_rank() == 0
            t = torch.ones(3)
            dist.all_reduce(t)
            assert torch.equal(t, torch.ones(3))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


# ----------------------------------------------------------- collectives


def _x(n, rows_per_dev=4, cols=8):
    return torch.arange(n * rows_per_dev * cols,
                        dtype=torch.float32).reshape(n * rows_per_dev, cols)


class TestCollectiveNumerics:
    def test_all_reduce(self, mesh1d_t):
        x = _x(8)
        out = all_reduce(mesh1d_t, "x")(x)
        assert torch.equal(out, sum(x.split(4)))

    def test_all_gather(self, mesh1d_t):
        x = _x(8)
        assert torch.equal(all_gather_op(mesh1d_t, "x")(x), x)

    def test_reduce_scatter(self, mesh1d_t):
        x = _x(8, rows_per_dev=8)
        out = reduce_scatter_op(mesh1d_t, "x")(x)
        # dual check: all_gather(reduce_scatter(x)) == all_reduce(x)
        full = all_gather_op(mesh1d_t, "x")(out)
        assert torch.equal(full, all_reduce(mesh1d_t, "x")(x))

    def test_ring_permute(self, mesh1d_t):
        x = _x(8)
        outs = ring_permute(mesh1d_t, "x")(x).split(4)
        xs = x.split(4)
        for i in range(8):
            assert torch.equal(outs[(i + 1) % 8], xs[i])

    def test_all_to_all(self, mesh1d_t):
        n = 8
        x = _x(n, rows_per_dev=n, cols=4)
        out = all_to_all_op(mesh1d_t, "x")(x)
        xs = x.numpy().reshape(n, n, 4)
        np.testing.assert_array_equal(out.numpy().reshape(n, n, 4),
                                      np.swapaxes(xs, 0, 1))

    def test_broadcast(self, mesh1d_t):
        x = _x(8)
        assert torch.equal(broadcast(mesh1d_t, "x", root=3)(x),
                           x.split(4)[3])
        with pytest.raises(ValueError, match="divisible"):
            broadcast(mesh1d_t, "x")(_x(1, rows_per_dev=3))

    @pytest.mark.parametrize("name", ["all_reduce", "all_gather",
                                      "reduce_scatter", "ring_permute",
                                      "all_to_all", "broadcast"])
    def test_matches_the_reference(self, name, mesh1d_t, mesh1d):
        """Both packages' op on the same integer-valued fp32 input, bit
        for bit (the reference on 8 virtual devices)."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec
        from tosem_tpu.parallel import collectives as jcol
        x = np.arange(8 * 8 * 16, dtype=np.float32).reshape(64, 16) % 251
        xj = jax.device_put(x, NamedSharding(mesh1d, PartitionSpec("x")))
        want = np.asarray(getattr(jcol, _JAX_NAME[name])(mesh1d, "x")(xj))
        got = getattr(sys.modules[all_reduce.__module__],
                      _JAX_NAME[name])(mesh1d_t, "x")(torch.from_numpy(x))
        assert got.numpy().tobytes() == want.tobytes()


_JAX_NAME = {"all_reduce": "all_reduce", "all_gather": "all_gather_op",
             "reduce_scatter": "reduce_scatter_op",
             "ring_permute": "ring_permute", "all_to_all": "all_to_all_op",
             "broadcast": "broadcast"}


class TestBusBandwidth:
    def test_factors(self):
        assert bus_bandwidth_factor("all_reduce", 8) == pytest.approx(2 * 7 / 8)
        assert bus_bandwidth_factor("all_gather", 8) == pytest.approx(7 / 8)
        assert bus_bandwidth_factor("reduce_scatter", 4) == pytest.approx(3 / 4)
        assert bus_bandwidth_factor("all_to_all", 8) == pytest.approx(7 / 8)
        assert bus_bandwidth_factor("broadcast", 8) == 1.0
        assert bus_bandwidth_factor("all_reduce", 1) == 1.0

    def test_factors_match_the_reference(self):
        from tosem_tpu.parallel.collectives import bus_bandwidth_factor as jf
        for name in _JAX_NAME:
            for n in range(1, 9):
                assert bus_bandwidth_factor(name, n) == jf(name, n)

    def test_bench_row(self, mesh1d_t):
        row = collective_bench(CollectiveSpec("all_reduce", 4096), mesh1d_t,
                               n_iter=64, reps=1)
        assert row.metric == "bus_bw_gbps" and row.value > 0
        assert row.n_devices == 8 and row.device == "cpu"
        assert row.extra["bytes"] == 4096
        assert row.extra["positions"] == 8 and row.extra["cards"] == 1

    def test_input_builder_alignment(self, mesh1d_t):
        spec = CollectiveSpec("all_reduce", 1 << 16)
        x = _make_global_input(spec, mesh1d_t)
        assert x.numel() * x.element_size() == 8 * (1 << 16)
        assert x.shape[1] == 128

    @pytest.mark.parametrize("nbytes", [1024, 4096, 1 << 16, 1000])
    def test_input_shape_matches_the_reference(self, nbytes, mesh1d_t,
                                               mesh1d):
        from tosem_tpu.parallel.collectives import (CollectiveSpec as JS,
                                                    _make_global_input as jm)
        want = jm(JS("all_reduce", nbytes), mesh1d)
        got = _make_global_input(CollectiveSpec("all_reduce", nbytes),
                                 mesh1d_t)
        assert tuple(got.shape) == tuple(want.shape)

    def test_sweep_is_the_reference_s(self):
        from tosem_tpu.parallel.collectives import \
            DEFAULT_COLLECTIVE_SWEEP as jsweep
        from tosem_tpu_torch.parallel.collectives import \
            DEFAULT_COLLECTIVE_SWEEP
        assert [s.bench_id for s in DEFAULT_COLLECTIVE_SWEEP] == \
            [s.bench_id for s in jsweep]

    def test_allreduce_config_runs_on_cpu_positions(self, tmp_path):
        from tosem_tpu_torch import cli
        from tosem_tpu_torch.utils.results import read_results
        path = tmp_path / "ar.csv"
        assert cli.main(["--device=cpu", "--config=allreduce",
                         "--max_bytes=4096",
                         f"--results_csv={path}"]) == 0
        rows = read_results(str(path))
        assert {r["extra"]["collective"] for r in rows} == set(_JAX_NAME)
        assert all(r["n_devices"] == 8 and r["device"] == "cpu"
                   and r["extra"]["positions"] == 8
                   and r["extra"]["cards"] == 1 for r in rows)


# ----------------------------------------------------------------- spmd


class TestShardMap:
    def test_split_gives_owned_contiguous_blocks(self, mesh2d_t):
        x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
        pieces = split(x, mesh2d_t, P("dp", None, "tp"))
        assert len(pieces) == 8
        for i, p in enumerate(pieces):
            c = mesh2d_t.coords(i)
            assert p.is_contiguous() and p.shape == (2, 6, 2)
            assert p.untyped_storage().data_ptr() != \
                x.untyped_storage().data_ptr()
            assert torch.equal(p, x[2 * c["dp"]:2 * c["dp"] + 2, :,
                                    2 * c["tp"]:2 * c["tp"] + 2])
        assert torch.equal(assemble(pieces, mesh2d_t,
                                    P("dp", None, "tp")), x)

    def test_split_refuses_an_uneven_dimension(self, mesh2d_t):
        with pytest.raises(ValueError, match="divisible"):
            split(torch.zeros(6, 3), mesh2d_t, P("dp"))
        with pytest.raises(ValueError, match="not in mesh"):
            split(torch.zeros(8, 2), mesh2d_t, P("sp"))

    def test_tuple_axes_split_row_major(self, mesh2d_t):
        x = torch.arange(16.0)
        pieces = split(x, mesh2d_t, P(("dp", "tp")))
        assert [int(p[0]) for p in pieces] == list(range(0, 16, 2))
        got = shard_map(lambda x: psum(x, ("dp", "tp")), mesh2d_t,
                        P(("dp", "tp")), P())(x)
        assert torch.equal(got, sum(x.split(2)))

    def test_axis_queries(self, mesh2d_t):
        def body(x):
            return torch.tensor([[axis_index("dp"), axis_index("tp"),
                                  axis_size("dp"), axis_size("tp"),
                                  axis_index(("dp", "tp"))]])
        out = shard_map(body, mesh2d_t, P("dp"), P(("dp", "tp")))(
            torch.zeros(8))
        assert out.tolist() == [[i // 2, i % 2, 4, 2, i] for i in range(8)]

    def test_collectives_meet_within_the_other_coordinates(self, mesh2d_t):
        x = torch.arange(8.0).reshape(4, 2)
        # a psum over tp adds the two positions of each dp row only
        got = shard_map(lambda x: psum(x, "tp"), mesh2d_t, P("dp", "tp"),
                        P("dp", "tp"))(x)
        assert torch.equal(got, x.sum(1, keepdim=True).expand(4, 2))
        got = shard_map(lambda x: psum(x, "dp"), mesh2d_t, P("dp", "tp"),
                        P("dp", "tp"))(x)
        assert torch.equal(got, x.sum(0, keepdim=True).expand(4, 2))

    def test_psum_is_the_left_fold_and_every_member_gets_its_bits(
            self, mesh1d_t):
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.standard_normal((8, 1000))
                             .astype(np.float32) * 1e3)
        want = x[0]
        for r in x[1:]:
            want = want + r
        got = shard_map(lambda v: psum(v[0], "x")[None], mesh1d_t, P("x"),
                        P("x"))(x)
        for row in got:
            assert torch.equal(row, want)

    def test_psum_of_a_tree_and_numbers(self, mesh1d_t):
        def body(x):
            return psum({"a": x, "b": [x * 2, 3]}, "x")
        out = shard_map(body, mesh1d_t, P("x"), P())(torch.arange(8.0))
        assert torch.equal(out["a"], torch.tensor([28.0]))
        assert torch.equal(out["b"][0], torch.tensor([56.0]))
        assert out["b"][1] == 24

    def test_psum_scatter_all_gather_duals(self, mesh1d_t):
        x = torch.arange(8 * 16.0).reshape(8, 16)

        def body(v):
            s = psum_scatter(v[0], "x", tiled=True)
            return all_gather(s, "x", tiled=True)[None]
        out = shard_map(body, mesh1d_t, P("x"), P("x"))(x)
        for row in out:
            assert torch.equal(row, x.sum(0))
        untiled = shard_map(lambda v: psum_scatter(v[0, :8], "x")[None],
                            mesh1d_t, P("x"), P("x"))(x)
        assert torch.equal(untiled, x[:, :8].sum(0))
        stacked = shard_map(lambda v: all_gather(v[0], "x")[None], mesh1d_t,
                            P("x"), P())(x)
        assert torch.equal(stacked[0], x)

    def test_ppermute_non_receivers_get_zeros(self, mesh1d_t):
        x = torch.arange(1.0, 9.0)
        out = shard_map(lambda v: ppermute(v, "x", [(0, 5), (5, 0)]),
                        mesh1d_t, P("x"), P("x"))(x)
        assert out.tolist() == [6, 0, 0, 0, 0, 1, 0, 0]
        with pytest.raises(ValueError, match="permutation"):
            shard_map(lambda v: ppermute(v, "x", [(0, 1), (2, 1)]),
                      mesh1d_t, P("x"), P("x"))(x)

    def test_all_to_all_and_pbroadcast(self, mesh2d_t):
        x = torch.arange(4 * 8.0).reshape(4, 8)
        out = shard_map(lambda v: all_to_all(v, "dp", 1, 0), mesh2d_t,
                        P("dp"), P("dp"))(x)
        assert torch.equal(out.reshape(4, 4, 2).transpose(0, 1)
                           .reshape(4, 8), x)
        b = shard_map(lambda v: pbroadcast(v, "dp", root=2), mesh2d_t,
                      P("dp"), P("dp"))(x)
        assert all(torch.equal(r, x[2]) for r in b)

    def test_replicated_output_is_position_zero_s(self, mesh1d_t):
        out = shard_map(lambda v: v * 10, mesh1d_t, P("x"), P())(
            torch.arange(8.0))
        assert torch.equal(out, torch.tensor([0.0]))

    def test_replicated_inputs_are_shared_not_copied(self, mesh1d_t):
        w = torch.ones(3)
        seen = []
        lock = threading.Lock()

        def body(x, w_):
            with lock:
                seen.append(w_ is w)
            return x
        shard_map(body, mesh1d_t, (P("x"), P()), P("x"))(torch.zeros(8), w)
        assert seen == [True] * 8

    def test_sharded_leaves_are_not_cut_again(self, mesh1d_t):
        x = torch.arange(16.0)
        sh = Sharded.of(x, mesh1d_t, P("x"))
        ptrs = [p.data_ptr() for p in sh.pieces]
        got = []
        lock = threading.Lock()

        def body(v):
            with lock:
                got.append(v.data_ptr())
            return v
        out = shard_map(body, mesh1d_t, P("x"), P("x"))(sh)
        assert sorted(got) == sorted(ptrs) and torch.equal(out, x)
        assert torch.equal(sh.gather(), x)
        with pytest.raises(ValueError, match="Sharded"):
            shard_map(body, mesh1d_t, P(), P())(sh)

    def test_named_tuple_and_none_arguments(self, mesh1d_t):
        from tosem_tpu_torch.ops.flash_attention import SegmentIds
        seg = SegmentIds(torch.arange(8).reshape(8, 1),
                         torch.arange(8).reshape(8, 1) * 2)

        def body(s, nothing):
            assert isinstance(s, SegmentIds) and nothing is None
            return s.kv - s.q
        out = shard_map(body, mesh1d_t,
                        (SegmentIds(P("x"), P("x")), P()), P("x"))(seg, None)
        assert torch.equal(out, torch.arange(8).reshape(8, 1))

    def test_a_body_error_reaches_the_caller(self, mesh1d_t):
        def body(v):
            if axis_index("x") == 5:
                raise KeyError("position five")
            return psum(v, "x")
        with pytest.raises(KeyError, match="position five"):
            shard_map(body, mesh1d_t, P("x"), P(), timeout=30)(
                torch.zeros(8))

    def test_a_hung_meeting_times_out(self, mesh1d_t):
        def body(v):
            if axis_index("x") == 0:
                return v            # never meets the others
            return psum(v, "x")
        with pytest.raises(TimeoutError, match="time limit"):
            shard_map(body, mesh1d_t, P("x"), P("x"), timeout=0.5)(
                torch.zeros(8))

    def test_a_hung_body_times_out(self, mesh1d_t):
        gate = threading.Event()

        def body(v):
            if axis_index("x") == 3:
                gate.wait(10)
            return v
        try:
            with pytest.raises(TimeoutError, match="did not finish"):
                shard_map(body, mesh1d_t, P("x"), P("x"), timeout=0.5)(
                    torch.zeros(8))
        finally:
            gate.set()

    def test_mismatched_collectives_raise(self, mesh1d_t):
        def body(v):
            return (psum(v, "x") if axis_index("x") % 2 else
                    all_gather(v, "x"))
        with pytest.raises(RuntimeError):
            shard_map(body, mesh1d_t, P("x"), P(), timeout=10)(
                torch.zeros(8))

    def test_collectives_outside_a_body_raise(self):
        with pytest.raises(RuntimeError, match="inside a shard_map"):
            psum(torch.zeros(1), "x")
        with pytest.raises(RuntimeError, match="inside a shard_map"):
            axis_index("x")

    def test_argument_count_is_checked(self, mesh1d_t):
        with pytest.raises(TypeError, match="in_specs"):
            shard_map(lambda a: a, mesh1d_t, P("x"), P())(torch.zeros(8),
                                                          torch.zeros(8))


def test_launch_counts_are_exact_under_threads():
    """``registry.count_launch`` from many threads at once, with the
    interpreter switching threads as often as it can: no add is lost."""
    from tosem_tpu_torch.ops import registry
    registry.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def launch():
            for _ in range(2000):
                registry.count_launch("paged_decode")
        threads = [threading.Thread(target=launch) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert registry.LAUNCH_COUNTS["paged_decode"] == 16 * 2000
    finally:
        sys.setswitchinterval(old)
        registry.reset_launch_counts()


# -------------------------------------------------------------- sharding


def test_spec_for_path_rules():
    from tosem_tpu_torch.parallel.sharding import bert_rules, spec_for_path
    rules = bert_rules()
    assert spec_for_path("layers.0.attn.q.w", rules) == P(None, "tp")
    assert spec_for_path("layers.0.attn.o.w", rules) == P("tp", None)
    assert spec_for_path("layers.1.fc2.w", rules) == P("tp", None)
    assert spec_for_path("ln_out.scale", rules) == P()
    # a stage-keyed tree (a DPJob's) picks up the same layout
    assert spec_for_path("bert.layers.0.fc1.w", rules) == P(None, "tp")


def test_tree_specs_clips_scalars():
    from tosem_tpu_torch.parallel.sharding import tree_specs
    tree = {"w": torch.zeros(4, 4), "count": torch.zeros(())}
    specs = tree_specs(tree, [(r"", P("dp", None))])
    assert specs["w"] == P("dp", None)
    assert specs["count"] == P()


def _port_name(path: str) -> str:
    """The converter's name of a reference parameter path
    (``layer0/attn/q/w`` -> ``layers.0.attn.q.w``)."""
    parts = path.split("/")
    if parts[0].startswith("layer"):
        parts = ["layers", parts[0][len("layer"):]] + parts[1:]
    return ".".join(parts)


def test_bert_rules_match_the_reference_for_every_parameter():
    """Every converted parameter gets the reference's spec (the converter
    transposes nothing), and so does its optimizer moment's path."""
    import jax
    from tosem_tpu.parallel.sharding import bert_rules as jrules
    from tosem_tpu.parallel.sharding import path_str
    from tosem_tpu.parallel.sharding import spec_for_path as jspec
    from tosem_tpu.models.bert import Bert as JBert
    from tosem_tpu.models.bert import BertConfig as JConfig
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.models.convert import bert_params_from_numpy
    from tosem_tpu_torch.parallel.sharding import bert_rules, spec_for_path
    params = JBert(JConfig.tiny()).init(jax.random.PRNGKey(0))["params"]
    state = bert_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          params))
    port = Bert(BertConfig.tiny(), device="cpu").state_dict()
    assert sorted(state) == sorted(port)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(state)
    checked = 0
    for path, leaf in flat:
        p = path_str(path)
        name = _port_name(p)
        assert name in state
        want = tuple(jspec("params/" + p, jrules()))
        assert tuple(spec_for_path(name, bert_rules())) == want, name
        assert tuple(spec_for_path("bert." + name, bert_rules())) == \
            tuple(jspec("opt_state/0/mu/" + p, jrules()))
        assert tuple(state[name].shape) == tuple(leaf.shape)
        checked += 1
    assert checked == len(port)


def test_tree_specs_of_the_port_model_match_the_reference():
    import jax
    from tosem_tpu.models.bert import Bert as JBert
    from tosem_tpu.models.bert import BertConfig as JConfig
    from tosem_tpu.parallel.sharding import bert_rules as jrules
    from tosem_tpu.parallel.sharding import tree_specs as jtree
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.parallel.sharding import bert_rules, tree_specs
    from tosem_tpu.parallel.sharding import path_str
    params = JBert(JConfig.tiny()).init(jax.random.PRNGKey(0))["params"]
    flat = jax.tree_util.tree_flatten_with_path(
        jtree(params, jrules()),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    want = {_port_name(path_str(p)): tuple(s) for p, s in flat}
    got = tree_specs(Bert(BertConfig.tiny(), device="cpu").state_dict(),
                     bert_rules())
    assert sorted(got) == sorted(want)
    for name, spec in got.items():
        assert tuple(spec) == want[name], name


def test_shard_tree_and_gather_round_trip():
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.parallel.sharding import (bert_rules, gather,
                                                   shard_tree)
    mesh = make_mesh(MeshSpec.of(dp=2, tp=2), CPU8[:4])
    state = Bert(BertConfig.tiny(), device="cpu").state_dict()
    sh = shard_tree(state, mesh, bert_rules())
    q = sh["layers.0.attn.q.w"]
    assert isinstance(q, Sharded) and q.spec == P(None, "tp")
    assert q.pieces[1].shape == (32, 16)
    assert sh["ln_out.scale"].pieces[0] is state["ln_out.scale"]
    back = gather(sh)
    assert all(torch.equal(back[k], state[k]) for k in state)


def test_batch_rules():
    from tosem_tpu_torch.parallel.sharding import (image_batch_rules,
                                                   seq_batch_rules,
                                                   shard_tree, tree_specs)
    batch = {"ids": torch.zeros(4, 8, dtype=torch.int32),
             "labels": torch.zeros(4, 8, dtype=torch.int32)}
    assert tree_specs(batch, seq_batch_rules())["ids"] == P("dp", "sp")
    assert tree_specs(batch, seq_batch_rules(sp=None))["ids"] == P("dp")
    assert tree_specs({"x": torch.zeros(4, 2, 2, 3)},
                      image_batch_rules())["x"] == P("dp")
    mesh = make_mesh(MeshSpec.of(dp=2, sp=2, tp=2), CPU8)
    sh = shard_tree(batch, mesh, seq_batch_rules())
    assert sh["ids"].pieces[0].shape == (2, 4)


def test_moe_rules_wait_for_their_module():
    """``bert_rules(ep=)`` places MoE-BERT's expert stacks on ``ep`` and
    keeps the dense layers' Megatron specs."""
    import dataclasses
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.parallel.sharding import bert_rules, shard_tree
    mesh = make_mesh(MeshSpec.of(dp=2, tp=2, ep=2), CPU8)
    m = Bert(dataclasses.replace(BertConfig.tiny(), moe_experts=4),
             device="cpu")
    params = {n: p.detach() for n, p in m.named_parameters()}
    sh = shard_tree(params, mesh, bert_rules(ep="ep"))
    assert sh["layers.1.moe.w1"].spec[0] == "ep"
    assert sh["layers.1.moe.w1"].pieces[0].shape == (2, 32, 64)
    assert tuple(sh["layers.1.moe.gate"].spec) == ()
    assert sh["layers.0.fc1.w"].spec[1] == "tp"
    assert bert_rules() == bert_rules(ep="ep")[:len(bert_rules())]


def test_parallel_package_exports_what_the_reference_s_does():
    """Every name the JAX package's ``parallel/__init__`` imports, less
    the modules not ported yet (pipeline.py, cluster.py)."""
    import ast
    import tosem_tpu_torch.parallel as par
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree = ast.parse(open(os.path.join(root, "tosem_tpu", "parallel",
                                       "__init__.py")).read())
    left_out = {"tosem_tpu.parallel.pipeline", "tosem_tpu.parallel.cluster"}
    want = {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
            and n.module not in left_out for a in n.names}
    assert len(want) > 20
    assert sorted(n for n in want if not hasattr(par, n)) == []
    for n in par.__all__:
        assert getattr(par, n) is not None
