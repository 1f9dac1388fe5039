"""The port's COCO-style evaluation (``models/detection_eval.py``, a
numpy copy) and image ops (``ops/image.py``) held against the JAX
package's on the CPU. AP figures are equal (the same numpy arithmetic);
the image ops within 1e-6 of the reference (fp32 gathers and lerps in
the same order)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

IMG_TOL = 1e-6


def _random_set(rng, n_images, n_classes=3):
    dets, gts = [], []
    for _ in range(n_images):
        m = int(rng.integers(0, 5))
        xy = rng.uniform(0, 50, (m, 2))
        g = np.concatenate([xy, xy + rng.uniform(5, 20, (m, 2))], 1)
        gts.append({"boxes": g.astype(np.float32),
                    "classes": rng.integers(0, n_classes, m)})
        n = int(rng.integers(0, 8))
        src = g[rng.integers(0, m, n)] if m else np.zeros((n, 4))
        d = src + rng.normal(0, 3, (n, 4))
        dets.append({"boxes": d.astype(np.float32),
                     "scores": rng.integers(0, 5, n) / 5.0,     # ties
                     "classes": rng.integers(0, n_classes, n)})
    return dets, gts


@pytest.mark.parametrize("seed", range(6))
def test_evaluate_detections_equals_reference(seed):
    from tosem_tpu.models.detection_eval import evaluate_detections as ref
    from tosem_tpu_torch.models.detection_eval import evaluate_detections
    dets, gts = _random_set(np.random.default_rng(seed), 6)
    want, got = ref(dets, gts), evaluate_detections(dets, gts)
    assert got == want


def test_iou_and_matching_equal_reference():
    from tosem_tpu.models import detection_eval as ref
    from tosem_tpu_torch.models import detection_eval as port
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 20, (9, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b = a[::2] + rng.normal(0, 1, (5, 4)).astype(np.float32)
    assert np.array_equal(port.iou_matrix(a, b), ref.iou_matrix(a, b))
    scores = rng.integers(0, 3, 9).astype(np.float32)
    for thr in (0.3, 0.5, 0.75):
        assert np.array_equal(port.match_detections(a, scores, b, thr),
                              ref.match_detections(a, scores, b, thr))
    assert port.COCO_IOU_THRESHOLDS == ref.COCO_IOU_THRESHOLDS


def test_perfect_detections_score_one():
    from tosem_tpu_torch.models.detection_eval import evaluate_detections
    g = {"boxes": np.array([[0, 0, 10, 10], [20, 20, 30, 35]], np.float32),
         "classes": np.array([1, 2])}
    d = {"boxes": g["boxes"], "scores": np.array([0.9, 0.8]),
         "classes": g["classes"]}
    out = evaluate_detections([d], [g])
    assert out["AP"] == out["AP50"] == out["AP75"] == 1.0
    with pytest.raises(ValueError):
        evaluate_detections([d], [g, g])


@pytest.mark.parametrize("shape,out", [((13, 17, 3), (26, 34)),
                                       ((13, 17, 3), (7, 9)),
                                       ((2, 8, 8, 3), (8, 8)),
                                       ((2, 13, 17, 1), (32, 8))])
def test_resize_bilinear_matches_reference(shape, out):
    import jax.numpy as jnp
    from tosem_tpu.ops.image import resize_bilinear as ref
    from tosem_tpu_torch.ops.image import resize_bilinear
    img = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(ref(jnp.asarray(img), *out))
    got = resize_bilinear(torch.from_numpy(img), *out).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= IMG_TOL


def test_normalize_and_letterbox_match_reference():
    import jax.numpy as jnp
    from tosem_tpu.ops import image as ref
    from tosem_tpu_torch.ops import image as port
    img = np.random.default_rng(1).uniform(0, 255, (10, 20, 3)).astype(
        np.float32)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    want = np.asarray(ref.normalize_image(jnp.asarray(img), mean, std,
                                          1 / 255.0))
    got = port.normalize_image(torch.from_numpy(img), mean, std, 1 / 255.0)
    assert np.abs(got.numpy() - want).max() <= IMG_TOL * np.abs(want).max()
    rc, rs = ref.letterbox(jnp.asarray(img), 32, 7.0)
    pc, ps = port.letterbox(torch.from_numpy(img), 32, 7.0)
    assert ps == rs and pc.shape == rc.shape
    assert np.abs(pc.numpy() - np.asarray(rc)).max() <= \
        IMG_TOL * np.abs(np.asarray(rc)).max()


def test_resize_grads_flow_and_identity_is_exact():
    from tosem_tpu_torch.ops.image import resize_bilinear
    img = torch.rand(6, 6, 1, generator=torch.Generator().manual_seed(2),
                     requires_grad=True)
    (resize_bilinear(img, 12, 12) ** 2).sum().backward()
    assert torch.isfinite(img.grad).all() and float(img.grad.abs().sum()) > 0
    x = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(resize_bilinear(x, 8, 8), x)
