"""The port's PointPillars (``models/pointpillars.py``) and its NMS
(``ops/nms.py``) held against the JAX package's on the CPU, at the
reference's test grids (``PillarGrid(0, 8, 0, 8, 4, 4, 8)``, capacity 3
for overflow), with points from numpy and the reference's weights
carried over by ``models/convert.py``.

Tolerances: ``voxelize`` is exact (same floors, the pillar sums in the
reference's order: pillars, masks and offsets bit for bit); the PFN,
``apply`` and ``detect`` within 1e-6 of the largest value (fp32
products in another order), masks and keep masks equal; the plain NMS
keep mask equal to the reference's element for element, ties included,
and so is a numpy model of the CUDA kernel's bitmask design; gradients
through ``apply`` within 1e-5. The CUDA kernel refuses CPU tensors; it
runs on the card only (``chip_smoke.py``). The last part copies
``tests/test_pointpillars.py``'s checks."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FWD_TOL = 1e-6
GRAD_TOL = 1e-5


def _grids():
    from tosem_tpu.models import pointpillars as ref
    from tosem_tpu_torch.models import pointpillars as port
    args = (0, 8, 0, 8, 4, 4, 8)
    return ref.PillarGrid(*args), port.PillarGrid(*args)


def _points(n, seed, lo=-1.0, hi=9.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, (n, 4)).astype(np.float32)
    pts[:, 2:] = rng.uniform(0, 1, (n, 2))
    return pts


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def detectors():
    """The reference's detector and weights, and the port's loaded with
    them."""
    import jax
    from tosem_tpu.models.pointpillars import PointPillarsDetector as Ref
    from tosem_tpu_torch.models.convert import load_pointpillars_params
    from tosem_tpu_torch.models.pointpillars import PointPillarsDetector
    rg, pg = _grids()
    ref = Ref(rg)
    params = ref.init(jax.random.key(0))
    det = PointPillarsDetector(pg, device="cpu")
    load_pointpillars_params(det, jax.tree_util.tree_map(np.asarray, params))
    return ref, params, det


@pytest.mark.parametrize("n,seed,cap", [(200, 0, 8), (64, 1, 3), (500, 2, 3),
                                        (5, 3, 8)])
def test_voxelize_equals_reference(n, seed, cap):
    """Dropped points, overflow past capacity and the overflow mean."""
    import jax
    import jax.numpy as jnp
    from tosem_tpu.models import pointpillars as ref
    from tosem_tpu_torch.models import pointpillars as port
    args = (0, 8, 0, 8, 4, 4, cap)
    pts = _points(n, seed)
    rp, rm = jax.jit(ref.voxelize, static_argnums=1)(
        jnp.asarray(pts), ref.PillarGrid(*args))
    pp, pm = port.voxelize(torch.from_numpy(pts), port.PillarGrid(*args))
    assert np.array_equal(pm.numpy(), np.asarray(rm))
    assert np.array_equal(pp.numpy(), np.asarray(rp))
    if cap == 3 and n >= 64:
        assert int(pm.sum(1).max()) == 3         # some pillar overflowed


def test_pfn_apply_and_detect_match_reference(detectors):
    import jax
    import jax.numpy as jnp
    from tosem_tpu.models import pointpillars as ref_mod
    ref, params, det = detectors
    pts = _points(256, 5)
    rp, rm = ref_mod.voxelize(jnp.asarray(pts), _grids()[0])
    want = ref.pfn.apply(params["pfn"], rp, rm)
    with torch.no_grad():
        got = det.pfn(torch.from_numpy(np.array(rp)),
                      torch.from_numpy(np.array(rm)))
    assert _rel(got, want) <= FWD_TOL
    # scores at init lie near 0.01 at this density: the threshold splits
    rb, rs, rk = jax.jit(lambda p, x: ref.detect(p, x, 0.3, 0.01))(
        params, jnp.asarray(pts))
    with torch.no_grad():
        pb, ps, pk = det.detect(torch.from_numpy(pts), 0.3, 0.01)
    assert _rel(pb, rb) <= FWD_TOL and _rel(ps, rs) <= FWD_TOL
    assert np.array_equal(pk.numpy(), np.asarray(rk))
    assert 0 < int(pk.sum()) < len(pk)


def _nms_case(rng, n, levels):
    """Boxes [n, 4] over a 10 x 10 field, sides 0.5-3; scores uniform, or
    from ``levels`` values (most tie and the stable order decides; one
    level: every score ties at 0)."""
    xy = rng.uniform(0, 10, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.5, 3, (n, 2))],
                           1).astype(np.float32)
    scores = (rng.integers(0, levels, n) / levels if levels
              else rng.uniform(0, 1, n)).astype(np.float32)
    return boxes, scores


def _reference_nms(boxes, scores, iou_t, score_t):
    import jax
    import jax.numpy as jnp
    from tosem_tpu.models.pointpillars import device_nms as ref_nms
    return np.asarray(jax.jit(ref_nms, static_argnums=(2, 3))(
        jnp.asarray(boxes), jnp.asarray(scores), iou_t, score_t))


# (n, levels, iou_t, score_t): the first four, then the kernel's chunk
# boundaries (64 candidates a word) and every score tied and live
NMS_CASES = [(32, 0, 0.5, 0.0), (64, 4, 0.3, 0.2), (48, 2, 0.1, 0.0),
             (16, 1, 0.5, 0.5), (63, 0, 0.5, 0.0), (64, 0, 0.3, 0.2),
             (65, 2, 0.5, 0.0), (129, 0, 0.3, 0.2), (96, 1, 0.3, -1.0)]


@pytest.mark.parametrize("n,levels,iou_t,score_t", NMS_CASES)
def test_plain_nms_equals_reference(n, levels, iou_t, score_t):
    """Random boxes; ``levels`` > 0 draws scores from that many values,
    so most scores tie and the stable order decides."""
    from tosem_tpu_torch.ops.nms import nms_plain, nms_sweep
    rng = np.random.default_rng(n + levels)
    for _ in range(4):
        boxes, scores = _nms_case(rng, n, levels)
        want = _reference_nms(boxes, scores, iou_t, score_t)
        got = nms_sweep(torch.from_numpy(boxes), torch.from_numpy(scores),
                        iou_t, score_t)
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(got, nms_plain(torch.from_numpy(boxes),
                                          torch.from_numpy(scores),
                                          iou_t, score_t))


@pytest.mark.parametrize("n,levels,iou_t,score_t", NMS_CASES[4:])
def test_row_blocked_plain_nms_equals_reference(n, levels, iou_t, score_t):
    """``nms_plain_rows`` (the yardstick past the plain version's memory)
    in blocks of 16 rows."""
    from tosem_tpu_torch.ops.nms import nms_plain_rows
    rng = np.random.default_rng(3 * n + levels)
    boxes, scores = _nms_case(rng, n, levels)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    assert np.array_equal(nms_plain_rows(b, s, iou_t, score_t, rows=16)
                          .numpy(),
                          _reference_nms(boxes, scores, iou_t, score_t))


def _bitmask_nms_model(boxes, scores, iou_t, score_t, seed=0):
    """``csrc/nms.cu``'s design in numpy, word for word: live0 packed
    into W = ceil(n / 64) words; overlap words mask[i][c] (bit b: j = 64c
    + b > i, j live at the start, IoU(i, j) > iou_t) for live rows only,
    written on the row's own chunk always and elsewhere only where not
    zero, with a bit in the row's occupancy words; every other word holds
    garbage, which the design must never use. Then the sweep: ``removed``
    = ~live0, each chunk resolved in series on its diagonal words, the
    kept rows' later non-zero words (from their occupancy) ORed in, and
    the clear bits of ``removed`` scattered to the input order. The IoUs
    are the port's ``iou_matrix``, whose bits the kernel's arithmetic
    matches."""
    from tosem_tpu_torch.ops.nms import iou_matrix, mask_words, score_order
    n = len(scores)
    W = mask_words(n)
    one = np.uint64(1)
    order = score_order(torch.from_numpy(scores)).numpy()
    over = np.zeros((n, W * 64), bool)
    over[:, :n] = iou_matrix(torch.from_numpy(boxes[order])).numpy() > iou_t
    bits = one << np.arange(64, dtype=np.uint64)
    live0 = np.zeros(W * 64, bool)
    live0[:n] = scores[order] > score_t
    live = (live0.reshape(W, 64) * bits).sum(1, dtype=np.uint64)
    garbage = np.random.default_rng(seed).integers(
        0, 2 ** 63, (n, W), dtype=np.int64).astype(np.uint64)
    mask = garbage.copy()
    occ = np.zeros((n, mask_words(W)), np.uint64)
    for i in np.flatnonzero(live0[:n]):
        for c in range(i // 64, W):
            j = np.arange(64 * c, 64 * c + 64)
            word = (((j > i) & live0[j] & over[i, j]) * bits).sum(
                dtype=np.uint64)
            if c == i // 64 or word:
                mask[i, c] = word
            if c != i // 64 and word:
                occ[i, c // 64] |= one << np.uint64(c % 64)
    full = ~np.uint64(0)
    removed = ~live
    for c in range(W):
        if removed[c] == full:
            continue
        run = removed[c]
        kept = []
        for b in range(64):
            if 64 * c + b < n and not (run >> np.uint64(b)) & one:
                kept.append(64 * c + b)
                run |= mask[64 * c + b, c]
        removed[c] = run
        for i in kept:
            for w in range(c + 1, W):
                if (occ[i, w // 64] >> np.uint64(w % 64)) & one:
                    removed[w] |= mask[i, w]
    sweep = ((removed[:, None] & bits) == 0).reshape(-1)[:n]
    keep = np.zeros(n, bool)
    keep[order] = sweep
    return keep


@pytest.mark.parametrize("n,levels,iou_t,score_t", NMS_CASES[4:] + [
    (1, 0, 0.5, 0.0), (128, 4, -0.1, 0.5), (200, 0, 0.5, 0.7)])
def test_bitmask_nms_model_equals_reference(n, levels, iou_t, score_t):
    """The kernel's words, bits and chunks, held against the reference
    before any card runs them (at a negative IoU threshold every pair
    overlaps; at score 0.7 whole chunks start removed)."""
    rng = np.random.default_rng(7 * n + levels)
    for _ in range(2):
        boxes, scores = _nms_case(rng, n, levels)
        assert np.array_equal(
            _bitmask_nms_model(boxes, scores, iou_t, score_t),
            _reference_nms(boxes, scores, iou_t, score_t))


def test_iou_matrix_matches_reference():
    import jax.numpy as jnp
    from tosem_tpu.models.pointpillars import iou_matrix as ref_iou
    from tosem_tpu_torch.models.pointpillars import iou_matrix
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 5, (30, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 2, (30, 2))],
                           1).astype(np.float32)
    boxes[3] = [1, 1, 1, 1]                       # a zero-area box
    assert np.array_equal(iou_matrix(torch.from_numpy(boxes)).numpy(),
                          np.asarray(ref_iou(jnp.asarray(boxes))))


def test_the_cuda_sweep_refuses_cpu_tensors():
    from tosem_tpu_torch.ops.nms import _nms_cuda
    with pytest.raises(ValueError, match="CUDA"):
        _nms_cuda(torch.zeros(4, 4), torch.zeros(4), 0.5, 0.0)


def test_nms_registry_family():
    from tosem_tpu_torch.ops import registry
    assert "nms" in registry.FAMILIES and "nms_sweep" in \
        registry.LAUNCH_COUNTS
    assert registry.resolve("nms", platform="cuda",
                            dtype="float32") == "cuda"
    assert registry.resolve("nms", platform="cpu") == "torch"


def test_gradients_end_to_end_match_jax_grad(detectors):
    import jax
    import jax.numpy as jnp
    from tosem_tpu_torch.models.convert import pointpillars_params_from_numpy
    ref, params, det = detectors
    pts = _points(128, 6, 0.0, 8.0)

    def loss(p):
        _, s = ref.apply(p, jnp.asarray(pts))
        return jnp.mean((s - 1.0) ** 2)
    want = pointpillars_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss))(params)))
    det.zero_grad()
    _, s = det.apply(torch.from_numpy(pts))
    ((s - 1.0) ** 2).mean().backward()
    for name, p in det.named_parameters():
        assert _rel(p.grad, want[name].numpy()) <= GRAD_TOL, name
    det.zero_grad()


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from tosem_tpu_torch.models.pointpillars import (PillarGrid,
                                                     PointPillarsDetector)
    with pytest.raises(RuntimeError, match="cuda"):
        PointPillarsDetector(PillarGrid())


# ------------------------------- tests/test_pointpillars.py on the port

GRID3 = (0, 8, 0, 8, 4, 4, 3)


def _grid3():
    from tosem_tpu_torch.models.pointpillars import PillarGrid
    return PillarGrid(*GRID3)


def test_voxelize_assigns_points_to_pillars():
    from tosem_tpu_torch.models.pointpillars import voxelize
    pts = torch.tensor([[0.5, 0.5, 1.0, 0.1], [0.7, 0.9, 2.0, 0.2],
                        [7.9, 7.9, 3.0, 0.3], [-1.0, 2.0, 0.0, 0.0],
                        [9.0, 1.0, 0.0, 0.0]])
    pillars, mask = voxelize(pts, _grid3())
    assert pillars.shape == (16, 3, 8)
    assert int(mask.sum()) == 3
    assert int(mask[0].sum()) == 2 and int(mask[15].sum()) == 1
    assert sorted(pillars[0, :2, 2].tolist()) == [1.0, 2.0]


def test_voxelize_capacity_overflow_drops_extras():
    from tosem_tpu_torch.models.pointpillars import voxelize
    pts = torch.cat([torch.full((10, 1), 0.5), torch.full((10, 1), 0.5),
                     torch.arange(10.0)[:, None], torch.zeros(10, 1)], 1)
    _, mask = voxelize(pts, _grid3())
    assert int(mask[0].sum()) == 3 and int(mask.sum()) == 3


def test_voxelize_overflow_mean_uses_stored_points_only():
    from tosem_tpu_torch.models.pointpillars import voxelize
    xs = torch.tensor([0.1, 0.2, 0.3, 0.7, 0.7])
    pts = torch.stack([xs, torch.full((5,), 0.5), torch.zeros(5),
                       torch.zeros(5)], 1)
    pillars, _ = voxelize(pts, _grid3())
    np.testing.assert_allclose(sorted(pillars[0, :3, 4].tolist()),
                               [-0.1, 0.0, 0.1], atol=1e-6)


def test_voxelize_offset_features():
    from tosem_tpu_torch.models.pointpillars import PillarGrid, voxelize
    pts = torch.tensor([[1.0, 1.0, 0.0, 0.0], [1.5, 1.5, 0.0, 0.0]])
    pillars, _ = voxelize(pts, PillarGrid(0, 8, 0, 8, 4, 4, 4))
    np.testing.assert_allclose(sorted(pillars[0, :2, 4].tolist()),
                               [-0.25, 0.25], atol=1e-6)


def test_pfn_masked_max():
    from tosem_tpu_torch.models.pointpillars import PillarFeatureNet
    pfn = PillarFeatureNet(8, 16, generator=torch.Generator().manual_seed(0))
    pillars = torch.randn(16, 3, 8, generator=torch.Generator().manual_seed(1))
    mask = torch.zeros(16, 3, dtype=torch.bool)
    mask[0, :2] = True
    with torch.no_grad():
        feats = pfn(pillars, mask)
        h = torch.relu(pillars[0] @ pfn.w + pfn.b)
    assert feats.shape == (16, 16)
    assert float(feats[1:].abs().max()) == 0.0      # empty pillars -> 0
    torch.testing.assert_close(feats[0], h[:2].amax(0), rtol=1e-5,
                               atol=0)


def test_canvas_shape():
    from tosem_tpu_torch.models.pointpillars import to_canvas
    feats = torch.arange(16 * 5, dtype=torch.float32).reshape(16, 5)
    canvas = to_canvas(feats, _grid3())
    assert canvas.shape == (4, 4, 5)
    assert float(canvas[0, 1, 0]) == float(feats[1, 0])


def _host_nms(boxes, scores, iou_t, score_t):
    from tosem_tpu_torch.models.pointpillars import iou_matrix
    idx = np.argsort(-scores)
    keep = np.zeros(len(boxes), bool)
    iou = iou_matrix(torch.from_numpy(boxes)).numpy()
    alive = scores > score_t
    for i in idx:
        if not alive[i]:
            continue
        keep[i] = True
        for j in idx:
            if j != i and alive[j] and iou[i, j] > iou_t:
                alive[j] = False
        alive[i] = False
    return keep


def test_device_nms_matches_host():
    from tosem_tpu_torch.models.pointpillars import device_nms
    rng = np.random.default_rng(0)
    for _ in range(10):
        xy = rng.uniform(0, 10, (32, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.5, 3, (32, 2))],
                               1).astype(np.float32)
        scores = rng.uniform(0, 1, 32).astype(np.float32)
        keep = device_nms(torch.from_numpy(boxes), torch.from_numpy(scores))
        np.testing.assert_array_equal(keep.numpy(),
                                      _host_nms(boxes, scores, 0.5, 0.0))


def test_detector_end_to_end_and_grads():
    from tosem_tpu_torch.models.pointpillars import (PillarGrid,
                                                     PointPillarsDetector)
    det = PointPillarsDetector(PillarGrid(0, 8, 0, 8, 4, 4, 8),
                               device="cpu")
    pts = torch.rand(64, 4, generator=torch.Generator().manual_seed(1)) * 8
    with torch.no_grad():
        boxes, scores, keep = det.detect(pts)
    assert boxes.shape == (16, 4) and scores.shape == (16,)
    assert keep.dtype == torch.bool

    def loss():
        _, s = det.apply(pts)
        return ((s - 1.0) ** 2).mean()
    first = loss()
    first.backward()
    assert float(det.pfn.w.grad.abs().sum()) > 0
    opt = torch.optim.SGD(det.parameters(), lr=0.5)
    for _ in range(20):
        opt.zero_grad()
        loss().backward()
        opt.step()
    with torch.no_grad():
        assert float(loss()) < float(first.detach())
