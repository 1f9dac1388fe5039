"""Routing-lite (``models/routing.py``): lane-graph search — host A*
(the reference's a_star_strategy.cc) vs the batched device SSSP
(min-plus relaxation as tensor steps), held to the JAX package's own
tests and to the JAX package.

Copies of ``tests/test_routing.py``'s eight tests against the port on
the CPU. Across packages: ``batched_sssp`` on seeded lane graphs with
integer lengths equal to the JAX package's, element for element
(integer sums below 2^24 are exact in fp32, and a minimum does not
depend on its order), and to ``scipy.sparse.csgraph.shortest_path``;
A*'s routes and the component's answers equal.
"""
import numpy as np
import pytest

from tosem_tpu_torch.dataflow.components import Component, ComponentRuntime
from tosem_tpu_torch.models.routing import (Lane, LaneGraph,
                                            RoutingComponent, a_star,
                                            batched_sssp, route_reference)

CPU = "cpu"


def _highway():
    """Two parallel lanes, A-side ends; reaching d2 from a0 needs a
    lane change (cost = length + penalty)."""
    return LaneGraph([
        Lane("a0", 100.0, successors=["a1"], right="b0"),
        Lane("a1", 100.0, successors=[], right="b1"),
        Lane("b0", 100.0, successors=["b1"], left="a0"),
        Lane("b1", 100.0, successors=["b2"], left="a1"),
        Lane("b2", 80.0, successors=[], half_width=1.5),
    ])


class TestAStar:
    def test_straight_route(self):
        g = _highway()
        assert a_star(g, "b0", "b2") == ["b0", "b1", "b2"]

    def test_route_with_lane_change(self):
        g = _highway()
        # a1 has no successor: the only way to b2 crosses to the B side
        route = a_star(g, "a0", "b2")
        assert route is not None and route[0] == "a0" \
            and route[-1] == "b2"
        assert any(l.startswith("b") for l in route)

    def test_no_route_is_none(self):
        g = LaneGraph([Lane("x", 10.0), Lane("y", 10.0)])
        assert a_star(g, "x", "y") is None

    def test_unknown_lane_raises(self):
        with pytest.raises(KeyError):
            a_star(_highway(), "a0", "zz")


class TestDeviceSssp:
    def test_parity_with_a_star_costs(self):
        """The TPU solver and the host solver must agree on every
        reachable cost — batched over ALL sources at once."""
        g = _highway()
        c = g.cost_matrix()
        dists = batched_sssp(c, range(len(g.order)), device=CPU).numpy()

        def a_star_cost(src, dst):
            route = a_star(g, src, dst)
            if route is None:
                return np.inf
            total = 0.0
            for cur, nxt in zip(route, route[1:]):
                total += dict(g.edges(cur))[nxt]
            return total

        for i, src in enumerate(g.order):
            for j, dst in enumerate(g.order):
                expect = 0.0 if src == dst else a_star_cost(src, dst)
                assert dists[i, j] == pytest.approx(expect), (src, dst)

    def test_unreachable_is_inf(self):
        g = LaneGraph([Lane("x", 10.0), Lane("y", 10.0)])
        d = batched_sssp(g.cost_matrix(), [0], device=CPU).numpy()
        assert d[0, 1] == np.inf and d[0, 0] == 0.0


class TestRoutingToPlanning:
    def test_route_reference_handoff(self):
        g = _highway()
        ref = route_reference(g, ["b0", "b1", "b2"])
        assert ref["length_m"] == pytest.approx(280.0)
        assert ref["lane_half"] == pytest.approx(1.5)   # narrowest wins

    def test_component_answers_requests(self):
        g = _highway()
        rtc = ComponentRuntime()
        rtc.add(RoutingComponent(g))
        got = []

        class Sink(Component):
            def __init__(self):
                super().__init__("sink", ["route"])

            def proc(self, msg, *f):
                got.append(msg)

        rtc.add(Sink())
        req = rtc.writer("route_request")
        req({"src": "b0", "dst": "b2"})
        req({"src": "a1", "dst": "a0"})     # unreachable (no back edge)
        rtc.run_until(1.0)
        assert got[0]["route"] == ["b0", "b1", "b2"]
        assert got[0]["lane_half"] == pytest.approx(1.5)
        assert "error" in got[1]


# ------------------------------------------------- against the JAX package

def integer_lane_graph(n, seed, package=None):
    """A seeded lane graph of ``n`` lanes with integer lengths: a chain of
    successors, random forward jumps, and left/right neighbours."""
    from tosem_tpu_torch.models import routing
    mod = package or routing
    rng = np.random.default_rng(seed)
    lanes = []
    for i in range(n):
        succ = [f"l{i + 1}"] if i + 1 < n and rng.random() < 0.9 else []
        for _ in range(int(rng.integers(0, 3))):
            j = int(rng.integers(0, n))
            if j != i and f"l{j}" not in succ:
                succ.append(f"l{j}")
        left = f"l{i - 1}" if i > 0 and rng.random() < 0.3 else None
        right = f"l{i + 1}" if i + 1 < n and rng.random() < 0.3 else None
        lanes.append(mod.Lane(f"l{i}", float(rng.integers(5, 400)),
                              successors=succ, left=left, right=right))
    return mod.LaneGraph(lanes)


@pytest.mark.parametrize("n,seed", [(12, 0), (40, 1), (96, 2)])
def test_batched_sssp_matches_the_jax_package(n, seed):
    import scipy.sparse.csgraph as csgraph
    from tosem_tpu.models import routing as ref
    ours = integer_lane_graph(n, seed)
    theirs = integer_lane_graph(n, seed, ref)
    c = ours.cost_matrix()
    assert np.array_equal(c, theirs.cost_matrix())
    sources = list(range(0, n, 3))
    got = batched_sssp(c, sources, device=CPU).numpy()
    want = np.asarray(ref.batched_sssp(theirs.cost_matrix(), sources))
    assert np.array_equal(got, want)
    graph = np.where(np.isfinite(c), c, 0.0)
    np.fill_diagonal(graph, 0.0)
    exact = csgraph.shortest_path(graph, indices=sources)
    assert np.array_equal(got, exact.astype(np.float32))


@pytest.mark.parametrize("seed", range(2))
def test_a_star_routes_match_the_jax_package(seed):
    from tosem_tpu.models import routing as ref
    ours = integer_lane_graph(30, seed + 10)
    theirs = integer_lane_graph(30, seed + 10, ref)
    rng = np.random.default_rng(seed)
    for src, dst in rng.integers(0, 30, (12, 2)):
        a, b = f"l{src}", f"l{dst}"
        assert a_star(ours, a, b) == ref.a_star(theirs, a, b)
