"""Routing-lite — lane-graph search feeding the planner.

The reference's routing module answers "which lane segments get me from
A to B" over a topological lane graph with an A* strategy
(``modules/routing/graph/topo_graph.cc``,
``strategy/a_star_strategy.cc``; lane changes enter as edge costs), and
its result seeds planning's reference line. Redesign, two solvers over
one graph:

- :func:`a_star` — the reference's exact host-side algorithm (graph
  search is tiny and latency-bound; the host is the right processor,
  same call the reference makes).
- :func:`batched_sssp` — the device-shaped alternative for BATCHES of
  routing queries (fleet simulation, K candidate destinations):
  Bellman-Ford relaxation as N-1 dense min-plus steps on a static
  ``[N, N]`` cost matrix, every source at once (``[S, N]`` distances)
  — shortest paths as tensor ops on the card instead of a per-query
  pointer chase. Parity with A* is pinned in tests.

:func:`route_reference` turns a route into the planner's inputs (total
station length + lane half-width), and :class:`RoutingComponent` answers
route requests on the component runtime — request in, route out, the
``routing_component.cc`` contract. Scenario selection stays descoped
(SURVEY: planning scenarios are config plumbing around the optimizers).

The port's counterpart of ``tosem_tpu/models/routing.py``: the graph and
A* are the same host code; :func:`batched_sssp` runs on the card.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tosem_tpu_torch.dataflow.components import Component
from tosem_tpu_torch.ops.common import resolve_device

__all__ = ["Lane", "LaneGraph", "a_star", "batched_sssp",
           "route_reference", "RoutingComponent"]

_CHANGE_COST = 5.0     # lane-change penalty (routing_config.pb.txt role)


@dataclass
class Lane:
    """One lane segment (topo node): forward length + neighbors."""
    lane_id: str
    length: float
    successors: List[str] = field(default_factory=list)
    left: Optional[str] = None      # adjacent lanes (change edges)
    right: Optional[str] = None
    half_width: float = 1.75


class LaneGraph:
    """Topological lane graph (``topo_graph.cc`` role): nodes are lane
    segments, edges are successor (cost = segment length) and
    left/right change (cost = length + change penalty)."""

    def __init__(self, lanes: Sequence[Lane]):
        self.lanes: Dict[str, Lane] = {l.lane_id: l for l in lanes}
        if len(self.lanes) != len(lanes):
            raise ValueError("duplicate lane ids")
        for lane in lanes:
            for nxt in lane.successors + [x for x in (lane.left,
                                                      lane.right) if x]:
                if nxt not in self.lanes:
                    raise ValueError(f"{lane.lane_id!r} references "
                                     f"unknown lane {nxt!r}")
        self.order = [l.lane_id for l in lanes]
        self.index = {lid: i for i, lid in enumerate(self.order)}

    def edges(self, lane_id: str) -> List[Tuple[str, float]]:
        lane = self.lanes[lane_id]
        out = [(s, lane.length) for s in lane.successors]
        for adj in (lane.left, lane.right):
            if adj is not None:
                out.append((adj, lane.length + _CHANGE_COST))
        return out

    def cost_matrix(self) -> np.ndarray:
        """Dense ``[N, N]`` edge-cost matrix (inf = no edge, 0 diag) —
        the static-shape input the device solver consumes."""
        n = len(self.order)
        m = np.full((n, n), np.inf, np.float32)
        np.fill_diagonal(m, 0.0)
        for lid in self.order:
            i = self.index[lid]
            for nxt, cost in self.edges(lid):
                j = self.index[nxt]
                m[i, j] = min(m[i, j], cost)
        return m


def a_star(graph: LaneGraph, src: str, dst: str) -> Optional[List[str]]:
    """The reference's strategy: A* over the topo graph (zero heuristic
    = Dijkstra; lane geometry gives no admissible distance-to-goal
    without a map projection, and the reference's heuristic is likewise
    conservative). Returns the lane-id route or None."""
    if src not in graph.lanes or dst not in graph.lanes:
        raise KeyError("unknown src/dst lane")
    best: Dict[str, float] = {src: 0.0}
    prev: Dict[str, str] = {}
    heap: List[Tuple[float, str]] = [(0.0, src)]
    while heap:
        cost, cur = heapq.heappop(heap)
        if cur == dst:
            route = [cur]
            while cur != src:
                cur = prev[cur]
                route.append(cur)
            return route[::-1]
        if cost > best.get(cur, np.inf):
            continue
        for nxt, ecost in graph.edges(cur):
            nc = cost + ecost
            if nc < best.get(nxt, np.inf):
                best[nxt] = nc
                prev[nxt] = cur
                heapq.heappush(heap, (nc, nxt))
    return None


def batched_sssp(cost_matrix, sources: Sequence[int], device="cuda"):
    """Single-source shortest-path distances for a BATCH of sources.

    Bellman-Ford as N-1 min-plus relaxation steps (static trip count —
    no data-dependent control flow) over every source at once:
    ``dist' = min(dist, min_k(dist_k + C[k, :]))``. Each step is one
    broadcasted ``[S, N, N]`` add and an ``amin`` over it on
    ``device`` (a minimum is exact in any order, so the answer does not
    depend on how the reduction is split). Returns ``[S, N]`` fp32
    distances on ``device`` (inf = unreachable).
    """
    import torch
    dev = resolve_device(device)
    c = torch.as_tensor(np.asarray(cost_matrix, np.float32)).to(dev)
    n = c.shape[0]
    src = torch.as_tensor(list(sources), dtype=torch.long).to(dev)
    d = torch.full((src.shape[0], n), float("inf"), dtype=torch.float32,
                   device=dev)
    d[torch.arange(src.shape[0], device=dev), src] = 0.0
    for _ in range(max(n - 1, 1)):
        d = torch.minimum(d, (d[:, :, None] + c[None]).amin(1))
    return d


def route_reference(graph: LaneGraph, route: Sequence[str]
                    ) -> Dict[str, float]:
    """Planner inputs from a route: total station length along the
    route's reference line and the narrowest lane half-width (the
    conservative corridor bound) — the routing→planning handoff."""
    if not route:
        raise ValueError("empty route")
    length = sum(graph.lanes[lid].length for lid in route)
    half = min(graph.lanes[lid].half_width for lid in route)
    return {"length_m": length, "lane_half": half, "n_lanes": len(route)}


class RoutingComponent(Component):
    """route requests → routes (the ``routing_component.cc`` contract):
    consumes ``{"src": ..., "dst": ...}``, publishes the lane route plus
    the planner handoff, or ``{"error": ...}`` for no-path."""

    def __init__(self, graph: LaneGraph, *,
                 in_channel: str = "route_request",
                 out_channel: str = "route"):
        super().__init__("routing", [in_channel])
        self.graph = graph
        self.out_channel = out_channel

    def on_init(self, ctx):
        self._write = ctx.writer(self.out_channel)

    def proc(self, req, *fused):
        route = a_star(self.graph, req["src"], req["dst"])
        if route is None:
            self._write({"error": f"no route {req['src']}→{req['dst']}"})
            return
        out = {"route": route}
        out.update(route_reference(self.graph, route))
        self._write(out)
