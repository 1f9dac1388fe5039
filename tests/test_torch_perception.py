"""The port's perception pipeline (``models/perception.py``): the tracker,
the detection component on PointPillars and ``build_pipeline``, held to
the JAX package's own tests and to the JAX package.

Copies of ``tests/test_perception.py``'s four tracker tests and its slow
pipeline test (the occupancy head trained on the CPU, ``slow`` as
there). Across packages, at ``tests/test_perception.py``'s 8 x 8 grid
with the JAX package's weights carried over by ``models/convert.py``:
``detect``'s boxes and scores within ``DET_TOL`` of the largest value
and its keep masks equal, the components' detections the same, and the
tracker's ids, hits and boxes equal over a scripted sequence and over
the pipeline's frames. ``GreedyIouTracker`` is host code on the same
IoU operations in both packages, so its boxes are compared exactly.
"""
import numpy as np
import pytest
import torch

from tosem_tpu_torch.dataflow import Component
from tosem_tpu_torch.models.perception import (GreedyIouTracker,
                                               build_pipeline)
from tosem_tpu_torch.models.pointpillars import (PillarGrid,
                                                 PointPillarsDetector,
                                                 voxelize)

torch.set_num_threads(1)

# detect's boxes and scores: fp32 products in another order than XLA's
DET_TOL = 1e-5
GRID = (0, 8, 0, 8, 8, 8, 16)          # tests/test_perception.py:55
# untrained weights score an empty pillar sigmoid(0) = 0.5 (ties, kept
# in index order) and an occupied one 0.03-0.45: 0.3 keeps both kinds
SCORE_T = 0.3


def _box(x, y, s=1.0):
    return [x, y, x + s, y + s]


class TestTracker:
    def test_stable_identity_across_frames(self):
        tr = GreedyIouTracker(iou_threshold=0.3)
        t1 = tr.update(np.array([_box(0, 0)]), np.array([0.9]))
        t2 = tr.update(np.array([_box(0.2, 0.0)]), np.array([0.8]))
        assert t1[0].track_id == t2[0].track_id
        assert t2[0].hits == 2

    def test_new_object_gets_new_id(self):
        tr = GreedyIouTracker()
        tr.update(np.array([_box(0, 0)]), np.array([0.9]))
        tracks = tr.update(np.array([_box(0.1, 0), _box(5, 5)]),
                           np.array([0.9, 0.7]))
        ids = sorted(t.track_id for t in tracks)
        assert len(ids) == 2 and ids[0] != ids[1]

    def test_stale_track_retired(self):
        tr = GreedyIouTracker(max_age=2)
        tr.update(np.array([_box(0, 0)]), np.array([0.9]))
        for _ in range(3):
            tr.update(np.zeros((0, 4)), np.zeros(0))
        assert tr.tracks == []

    def test_greedy_matching_prefers_best_iou(self):
        tr = GreedyIouTracker(iou_threshold=0.1)
        first = tr.update(np.array([_box(0, 0), _box(2, 0)]),
                          np.array([0.9, 0.9]))
        by_x = {round(t.box[0]): t.track_id for t in first}
        # detections shifted slightly; each must match its nearest track
        second = tr.update(np.array([_box(2.2, 0), _box(0.2, 0)]),
                           np.array([0.9, 0.9]))
        for t in second:
            assert t.track_id == by_x[round(t.box[0] - 0.2)]


@pytest.mark.slow
def test_pipeline_tracks_moving_object():
    grid = PillarGrid(*GRID)
    det = PointPillarsDetector(grid, device="cpu", seed=0)
    rng = np.random.default_rng(0)

    def scene(cx, cy):
        obj = rng.normal([cx, cy], 0.25, (40, 2)).astype(np.float32)
        feats = rng.normal(0, 1, (40, 2)).astype(np.float32)
        return torch.from_numpy(np.concatenate([obj, feats], axis=1))

    # train the per-cell occupancy head on one static scene (weights are
    # shared across cells, so detection generalizes to moving objects)
    pts0 = scene(2.5, 2.5)
    _, mask = voxelize(pts0, grid)
    target = (mask.sum(1) >= 8).float()

    # canonical 2x2 boxes centered on each cell: consistent geometry
    # across cells so inter-frame IoU association works
    cxs = (torch.arange(8) + 0.5).repeat_interleave(8)
    cys = (torch.arange(8) + 0.5).repeat(8)
    canon = torch.stack([cxs - 1, cys - 1, cxs + 1, cys + 1], 1)

    opt = torch.optim.SGD(det.parameters(), lr=0.5)
    for _ in range(250):
        boxes, s = det.apply(pts0)
        s = s.clamp(1e-6, 1 - 1e-6)
        bce = -(target * torch.log(s) + (1 - target) * torch.log(1 - s)
                ).mean()
        loss = bce + 0.05 * ((boxes - canon) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()

    # ~1-cell boxes moving 1 cell/frame → inter-frame IoU ≈ 0.3; use a
    # tolerant association threshold so motion this fast still matches
    rtc = build_pipeline(det, score_threshold=0.5, tracker_iou=0.15)
    seen: list = []

    class TrackSink(Component):
        def __init__(self):
            super().__init__("sink", ["tracks"])

        def proc(self, tracks, *f):
            seen.append(tracks)

    rtc.add(TrackSink())
    pts_w = rtc.writer("pts")
    # object drifts one cell per frame
    for i, (cx, cy) in enumerate([(2.5, 2.5), (3.5, 2.5), (4.5, 2.5)]):
        pts_w(scene(cx, cy))
        rtc.run_until(float(i + 1))

    assert len(seen) == 3
    ids_per_frame = [{t["track_id"] for t in frame} for frame in seen]
    assert all(len(ids) >= 1 for ids in ids_per_frame)
    # the dominant track persists across all frames
    common = set.intersection(*ids_per_frame)
    assert common, ids_per_frame
    # the LIVE persistent track (most hits) — common may also contain
    # not-yet-retired stale tracks whose boxes froze
    last = {t["track_id"]: t for t in seen[-1]}
    tid = max(common, key=lambda i: last[i]["hits"])
    assert last[tid]["hits"] == 3
    xs = [next(t for t in frame if t["track_id"] == tid)["box"][0]
          for frame in seen]
    assert xs[0] < xs[1] < xs[2]


# ------------------------------------------------- against the JAX package

def _clouds(n_frames=4, seed=3):
    """Clouds of a drifting cluster over background points, [N, 4]."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_frames):
        obj = rng.normal([2.0 + 0.7 * i, 3.0], 0.4, (60, 2))
        bg = rng.uniform(-0.5, 8.5, (40, 2))
        xy = np.concatenate([obj, bg]).astype(np.float32)
        feats = rng.normal(0, 1, (100, 2)).astype(np.float32)
        out.append(np.concatenate([xy, feats], 1))
    return out


@pytest.fixture(scope="module")
def both():
    """The JAX package's detector, weights and jitted ``detect``, and the
    port's detector with those weights."""
    import jax
    from tosem_tpu.models.pointpillars import PillarGrid as RefGrid
    from tosem_tpu.models.pointpillars import PointPillarsDetector as Ref
    from tosem_tpu_torch.models.convert import load_pointpillars_params
    ref = Ref(RefGrid(*GRID))
    params = ref.init(jax.random.key(0))
    det = PointPillarsDetector(PillarGrid(*GRID), device="cpu", seed=1)
    load_pointpillars_params(det, jax.tree_util.tree_map(np.asarray, params))
    detect = jax.jit(ref.detect, static_argnames=("iou_threshold",
                                                  "score_threshold"))
    return ref, params, det, detect


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("frame", range(4))
def test_detect_matches_the_jax_package(both, frame):
    import jax.numpy as jnp
    ref, params, det, detect = both
    pts = _clouds()[frame]
    jb, js, jk = detect(params, jnp.asarray(pts), iou_threshold=0.5,
                        score_threshold=SCORE_T)
    with torch.no_grad():
        pb, ps, pk = det.detect(torch.from_numpy(pts), 0.5, SCORE_T)
    assert _rel(pb, jb) <= DET_TOL and _rel(ps, js) <= DET_TOL
    assert np.array_equal(pk.numpy(), np.asarray(jk))
    assert 0 < int(pk.sum()) < pk.numel()      # NMS kept some, cut some


def _scripted_boxes():
    """Frames of (boxes, scores): two objects crossing, one leaving and
    coming back after the tracker's max_age, a newcomer, an empty frame."""
    a = [[0.2 * i, 0.0, 0.2 * i + 1.0, 1.0] for i in range(8)]
    b = [[4.0 - 0.3 * i, 0.1, 5.0 - 0.3 * i, 1.1] for i in range(8)]
    frames = []
    for i in range(8):
        rows = [a[i]] + ([b[i]] if i not in (3, 4, 5, 6) else [])
        if i >= 5:
            rows.append([6.0, 6.0, 7.5, 7.0])
        if i == 2:
            rows = []
        frames.append((np.asarray(rows, np.float32).reshape(-1, 4),
                       np.linspace(0.9, 0.6, len(rows)).astype(np.float32)))
    return frames


def _track_rows(tracks):
    return [(t.track_id, t.hits, t.age, np.asarray(t.box).tolist(),
             t.score) for t in tracks]


@pytest.mark.parametrize("iou,max_age", [(0.3, 3), (0.1, 1), (0.5, 2)])
def test_tracker_ids_match_the_jax_package(iou, max_age):
    from tosem_tpu.models.perception import GreedyIouTracker as RefTracker
    ref, ours = RefTracker(iou, max_age), GreedyIouTracker(iou, max_age)
    for boxes, scores in _scripted_boxes():
        want = _track_rows(ref.update(boxes, scores))
        got = _track_rows(ours.update(boxes, scores))
        assert got == want


def _pipeline_tracks(build, frames):
    seen = []

    def sink_class(component):
        class Sink(component):
            def __init__(self):
                super().__init__("sink", ["tracks", "detections"])

            def proc(self, tracks, det):
                seen.append((tracks, det))
        return Sink
    rtc, component = build()
    rtc.add(sink_class(component)())
    w = rtc.writer("pts")
    for i, pts in enumerate(frames):
        w(pts)
        rtc.run_until(float(i + 1))
    return seen


def test_pipeline_matches_the_jax_package(both):
    """pts → detection → tracker in both packages on the same clouds and
    weights: the same detections (boxes within DET_TOL) and the same
    track ids and hits, frame by frame."""
    import jax.numpy as jnp
    from tosem_tpu.dataflow import Component as RefComponent
    from tosem_tpu.models.perception import build_pipeline as ref_build
    ref, params, det, _ = both
    frames = _clouds(6, seed=5)
    want = _pipeline_tracks(
        lambda: (ref_build(params, ref, score_threshold=SCORE_T,
                           tracker_iou=0.15), RefComponent),
        [jnp.asarray(p) for p in frames])
    got = _pipeline_tracks(
        lambda: (build_pipeline(det, score_threshold=SCORE_T,
                                tracker_iou=0.15), Component), frames)
    assert len(got) == len(want) == 6
    for (gt, gd), (wt, wd) in zip(got, want):
        assert len(gd["boxes"]) == len(wd["boxes"]) > 0
        assert _rel(gd["boxes"], wd["boxes"]) <= DET_TOL
        assert _rel(gd["scores"], wd["scores"]) <= DET_TOL
        assert [(t["track_id"], t["hits"]) for t in gt] == \
            [(t["track_id"], t["hits"]) for t in wt]
        for a, b in zip(gt, wt):
            assert _rel(a["box"], b["box"]) <= DET_TOL
