"""The port's EfficientDet (``models/efficientdet.py``) held against the
JAX package's on the CPU, at ``EfficientDetConfig.tiny()``: one set of
weights (with moving stats and BatchNorm affines drawn from numpy) in
both packages, carried into the port by ``models/convert.py``.

Tolerances, fp32 throughout, each as max |port - reference| over the
largest reference value: 1e-5 for the forward in eval mode and for the
losses, 1e-4 for the forward in training mode, the loss through it and
the moving stats it leaves (each kind over its largest stat; batch
statistics over 2 images of 2 x 2 pixels at P5 amplify the
convolutions' differing sum orders), 1e-4 for the loss's gradients in
the head outputs, and 1e-3 for each parameter's gradient through the
whole model (of the largest gradient of all for the few that vanish in
exact arithmetic). Anchors, target assignment and the host NMS are
exact. D0's parameter shapes are held leaf for leaf against
``jax.eval_shape`` of the reference's init, with no compute. The last
class copies ``tests/test_efficientdet.py``'s checks. The reference's
model runs once, jitted, in the module's fixture."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

EVAL_TOL = 1e-5
TRAIN_TOL = 1e-4
LOSS_GRAD_TOL = 1e-4
# the port's own fp32 gradients read up to 1.9e-4 against fp64 on these
# weights (the squeeze-excite conv's bias), the reference's likewise
PARAM_GRAD_TOL = 1e-3
# a gradient whose largest element is below this share of the largest
# gradient of all vanishes in exact arithmetic: a per-channel shift that
# a training-mode BatchNorm takes out again (rounding noise in both
# packages), or a head BatchNorm with no positive anchor below it
VANISHING = 1e-6


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _gt(cfg):
    s = cfg.image_size
    boxes = np.array([[[0.1 * s, 0.2 * s, 0.6 * s, 0.7 * s],
                       [0.5 * s, 0.5 * s, 0.9 * s, 0.95 * s]],
                      [[0.3 * s, 0.1 * s, 0.8 * s, 0.5 * s],
                       [0.0, 0.0, 0.0, 0.0]]], np.float32)
    classes = np.array([[1, 3], [2, 0]], np.int32)
    n_gt = np.array([2, 1], np.int32)
    return boxes, classes, n_gt


def _stats_gap(got, want):
    """Moving stats: the largest gap of each kind (means, variances) over
    the largest stat of that kind. A mean behind a zero-mean input is
    rounding (~1e-9), so a gap over its own size says nothing."""
    worst = 0.0
    for kind in (".mean", ".var"):
        keys = [k for k in want if k.endswith(kind)]
        scale = max(float(want[k].abs().max()) for k in keys)
        gap = max(float((got[k] - want[k]).abs().max()) for k in keys)
        worst = max(worst, gap / scale)
    return worst


def _reference_tree(shapes, sd):
    """The reference's params and state laid out as ``shapes`` (its
    ``jax.eval_shape`` of init), filled from the port's ``state_dict``
    (OIHW -> HWIO): the reverse of ``models/convert.py``."""
    import jax
    import jax.numpy as jnp
    from tosem_tpu_torch.models.convert import _effdet_name

    def fill(path, leaf):
        t = sd[".".join(_effdet_name(p.key) for p in path)].numpy()
        return jnp.asarray(t.transpose(2, 3, 1, 0) if t.ndim == 4 else t)
    return {part: jax.tree_util.tree_map_with_path(fill, shapes[part])
            for part in ("params", "state")}


@pytest.fixture(scope="module")
def tiny():
    """Weights from the port's init (seed 3) with moving stats, BatchNorm
    scales and biases drawn from numpy, laid out as the reference's tree;
    the port's model loaded back from that tree by the converter; two
    images; and the reference's eval and train outputs, new moving
    stats, loss and gradients, from one jitted call."""
    import jax
    import jax.numpy as jnp
    from tosem_tpu.models.efficientdet import (EfficientDet,
                                               EfficientDetConfig,
                                               detection_loss,
                                               generate_anchors)
    from tosem_tpu_torch.models import efficientdet as port
    from tosem_tpu_torch.models.convert import load_efficientdet_params
    cfg = EfficientDetConfig.tiny()
    ref = EfficientDet(cfg)
    src = port.EfficientDet(port.EfficientDetConfig.tiny(), device="cpu",
                            seed=3)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name, t in list(src.named_buffers()) + list(
                src.named_parameters()):
            if name.endswith(".mean") or (name.endswith(".bias") and (
                    "bn" in name.split(".")[-2] or "_bns." in name)):
                t.copy_(torch.from_numpy(rng.normal(0, 0.1, t.shape)))
            elif name.endswith((".var", ".scale")):
                t.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, t.shape)))
    vs = _reference_tree(jax.eval_shape(ref.init, jax.random.PRNGKey(0)),
                         src.state_dict())
    model = port.EfficientDet(port.EfficientDetConfig.tiny(), device="cpu")
    load_efficientdet_params(model, _np(vs["params"]), _np(vs["state"]))
    imgs = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    anchors = generate_anchors(cfg)
    boxes, classes, n_gt = _gt(cfg)

    def everything(vs, x):
        ev, _ = ref.apply(vs, x, train=False)
        tr, ns = ref.apply(vs, x, train=True)

        def loss_fn(p):
            (cl, bx), _ = ref.apply({"params": p, "state": vs["state"]}, x,
                                    train=True)
            return detection_loss(cl, bx, boxes, classes, n_gt,
                                  jnp.asarray(anchors), cfg)["loss"]
        loss, grads = jax.value_and_grad(loss_fn)(vs["params"])
        return ev, tr, ns, loss, grads
    ev, tr, ns, loss, grads = jax.jit(everything)(vs, imgs)
    return {"cfg": cfg, "vs": vs, "model": model, "anchors": anchors,
            "imgs": imgs, "eval": _np(ev), "train": _np(tr),
            "state": _np(ns), "loss": float(loss), "grads": _np(grads)}


def _fresh(tiny):
    """A port model with the fixture's weights and moving stats (the
    fixture's model is left untouched by training-mode calls)."""
    from tosem_tpu_torch.models import efficientdet as port
    from tosem_tpu_torch.models.convert import load_efficientdet_params
    m = port.EfficientDet(port.EfficientDetConfig.tiny(), device="cpu")
    load_efficientdet_params(m, _np(tiny["vs"]["params"]),
                             _np(tiny["vs"]["state"]))
    return m


# ------------------------------------------------------------- the model


def test_eval_forward_matches_reference(tiny):
    cl, bx = tiny["eval"]
    with torch.no_grad():
        pcl, pbx = tiny["model"](torch.from_numpy(tiny["imgs"]))
    assert pcl.shape == cl.shape and pbx.shape == bx.shape
    assert _rel(pcl, cl) <= EVAL_TOL
    assert _rel(pbx, bx) <= EVAL_TOL


def test_train_forward_and_moving_stats_match_reference(tiny):
    from tosem_tpu_torch.models.convert import efficientdet_params_from_numpy
    cl, bx = tiny["train"]
    m = _fresh(tiny)
    with torch.no_grad():
        pcl, pbx = m(torch.from_numpy(tiny["imgs"]), train=True)
    assert _rel(pcl, cl) <= TRAIN_TOL
    assert _rel(pbx, bx) <= TRAIN_TOL
    want = efficientdet_params_from_numpy({}, tiny["state"])
    bufs = dict(m.named_buffers())
    assert set(want) == set(bufs)
    assert _stats_gap(bufs, want) <= TRAIN_TOL
    # the stats moved: a train forward that left them would fail above
    start = efficientdet_params_from_numpy({}, _np(tiny["vs"]["state"]))
    assert _stats_gap(bufs, start) > 1e-2


def test_model_gradients_match_jax_grad(tiny):
    """Every parameter's gradient of the training-mode loss through the
    whole model, against ``jax.grad`` of the reference."""
    from tosem_tpu_torch.models.convert import efficientdet_params_from_numpy
    from tosem_tpu_torch.models.efficientdet import detection_loss
    cfg = tiny["cfg"]
    boxes, classes, n_gt = _gt(cfg)
    want = efficientdet_params_from_numpy(tiny["grads"], {})
    m = _fresh(tiny)
    cl, bx = m(torch.from_numpy(tiny["imgs"]), train=True)
    loss = detection_loss(cl, bx, torch.from_numpy(boxes),
                          torch.from_numpy(classes), torch.from_numpy(n_gt),
                          torch.from_numpy(tiny["anchors"]), cfg)["loss"]
    assert abs(float(loss.detach()) - tiny["loss"]) <= \
        TRAIN_TOL * abs(tiny["loss"])
    loss.backward()
    got = dict(m.named_parameters())
    assert set(got) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    vanishing = {k for k, w in want.items()
                 if float(w.abs().max()) < VANISHING * top}
    # only biases in front of a training-mode BatchNorm vanish, beside
    # the box head's BatchNorms at levels with no positive anchor (zero)
    assert all(k.endswith(("proj_bn.bias", "pw.b")) or not want[k].any()
               for k in vanishing)
    gaps = {k: float((got[k].grad - w).abs().max()) / (
        top if k in vanishing else float(w.abs().max()))
        for k, w in want.items()}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= PARAM_GRAD_TOL, (worst, gaps[worst])


def test_param_names_and_shapes_match_the_converted_tree(tiny):
    from tosem_tpu_torch.models.convert import efficientdet_params_from_numpy
    conv = efficientdet_params_from_numpy(_np(tiny["vs"]["params"]),
                                          _np(tiny["vs"]["state"]))
    sd = tiny["model"].state_dict()
    assert set(conv) == set(sd)
    assert all(conv[k].shape == sd[k].shape for k in sd)


def test_d0_parameter_shapes_leaf_for_leaf():
    """D0 at full width: every reference leaf (params and state) by
    ``jax.eval_shape``, no compute, against the port's state dict."""
    import jax
    from tosem_tpu.models.efficientdet import EfficientDet, EfficientDetConfig
    from tosem_tpu_torch.models import efficientdet as port
    from tosem_tpu_torch.models.convert import _effdet_name
    shapes = jax.eval_shape(EfficientDet(EfficientDetConfig.d0()).init,
                            jax.random.PRNGKey(0))
    want = {}
    for part in ("params", "state"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes[part])[0]:
            name = ".".join(_effdet_name(p.key) for p in path)
            s = tuple(leaf.shape)
            want[name] = (s[3], s[2], s[0], s[1]) if len(s) == 4 else s
    model = port.EfficientDet(port.EfficientDetConfig.d0(), device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    n_params = sum(int(np.prod(s)) for path, s in want.items()
                   if not path.endswith((".mean", ".var")))
    assert n_params == model.param_count() == 4_336_838


def test_anchors_equal_reference():
    from tosem_tpu.models.efficientdet import EfficientDetConfig, \
        generate_anchors as ref_anchors
    from tosem_tpu_torch.models import efficientdet as port
    for name in ("tiny", "d0"):
        want = ref_anchors(getattr(EfficientDetConfig, name)())
        got = port.generate_anchors(getattr(port.EfficientDetConfig, name)())
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_heads_reshape_in_anchor_order(tiny):
    """Anchor ``a`` of cell (y, x) of a level is row ``(y * W + x) * A +
    a`` of the outputs: a bias on one anchor slot of the class conv moves
    exactly the rows generate_anchors gives that slot."""
    m = _fresh(tiny)
    cfg = m.cfg
    K = cfg.num_classes
    with torch.no_grad():
        base, _ = m(torch.from_numpy(tiny["imgs"][:1]))
        m.class_out.b[4 * K + 1] += 100.0          # anchor 4, class 1
        moved, _ = m(torch.from_numpy(tiny["imgs"][:1]))
    rows = torch.nonzero((moved - base).abs().amax(-1) > 50)[:, 1]
    want = np.arange(len(tiny["anchors"]))[4::cfg.num_anchors]
    assert np.array_equal(rows.numpy(), want)


# ------------------------------------------------- boxes, targets, losses


def test_box_iou_encode_decode_match_reference(tiny):
    import jax.numpy as jnp
    from tosem_tpu.models import efficientdet as ref
    from tosem_tpu_torch.models import efficientdet as port
    rng = np.random.default_rng(3)
    an = tiny["anchors"]
    gt = (an[:50] + rng.uniform(-4, 4, (50, 4))).astype(np.float32)
    assert _rel(port.box_iou(torch.from_numpy(an[:40]),
                             torch.from_numpy(gt)),
                ref.box_iou(jnp.asarray(an[:40]), jnp.asarray(gt))) <= 1e-6
    enc_ref = ref.encode_boxes(jnp.asarray(gt), jnp.asarray(an[:50]))
    enc = port.encode_boxes(torch.from_numpy(gt), torch.from_numpy(an[:50]))
    assert _rel(enc, enc_ref) <= 1e-6
    regs = rng.normal(0, 3, (2, 50, 4)).astype(np.float32)   # clamp hit
    dec_ref = ref.decode_boxes(jnp.asarray(regs), jnp.asarray(an[:50]))
    dec = port.decode_boxes(torch.from_numpy(regs), torch.from_numpy(an[:50]))
    assert _rel(dec, dec_ref) <= 1e-6


def test_assign_targets_match_reference(tiny):
    import jax
    import jax.numpy as jnp
    from tosem_tpu.models.efficientdet import assign_targets as ref_assign
    from tosem_tpu_torch.models.efficientdet import assign_targets
    boxes, classes, n_gt = _gt(tiny["cfg"])
    an = tiny["anchors"]
    cls, box_t, pos = assign_targets(
        torch.from_numpy(boxes), torch.from_numpy(classes),
        torch.from_numpy(n_gt), torch.from_numpy(an))
    for b in range(2):
        rc, rb, rp = ref_assign(jnp.asarray(boxes[b]), jnp.asarray(classes[b]),
                                jnp.asarray(n_gt[b]), jnp.asarray(an))
        assert np.array_equal(cls[b].numpy(), np.asarray(rc))
        assert np.array_equal(pos[b].numpy(), np.asarray(rp))
        assert _rel(box_t[b], rb) <= 1e-6


def test_duplicate_forced_matches_resolve_as_the_reference():
    """Ground truths that share their best anchor (anchor 0, which a
    padded ground truth also names: the reference's argmax over a column
    of -1) all force-match it. The reference's scatter on the CPU lets
    the last writer win, a padded one writing back the anchor's own
    value; the port resolves the duplicates the same way on every
    device (a CUDA scatter keeps any one of them)."""
    import jax.numpy as jnp
    from tosem_tpu.models.efficientdet import assign_targets as ref_assign
    from tosem_tpu_torch.models.efficientdet import (_last_writer,
                                                     assign_targets)
    anchors = np.array([[0, 0, 31, 31], [0, 0, 100, 100],
                        [50, 50, 60, 60], [200, 200, 210, 210]], np.float32)
    # IoU with anchor 0: 0.938, 0.936, 0.784; argmax picks gt 0
    gt = np.array([[[0, 0, 32, 32], [0, 0, 30, 30], [0, 0, 35, 35],
                    [0, 0, 0, 0]]], np.float32)
    classes = np.array([[4, 7, 9, 1]], np.int32)
    # (ground truths, n_gt, anchor 0's class): gt 2 writes last; a padded
    # gt 3 writes back the argmax's class; a valid zero box writes last
    for G, n, want0 in ((3, 3, 9), (4, 3, 4), (4, 4, 1), (4, 1, 4)):
        g, c = gt[:, :G], classes[:, :G]
        cls, box_t, pos = assign_targets(
            torch.from_numpy(g), torch.from_numpy(c), torch.tensor([n]),
            torch.from_numpy(anchors))
        rc, rb, rp = ref_assign(jnp.asarray(g[0]), jnp.asarray(c[0]),
                                jnp.asarray(n), jnp.asarray(anchors))
        assert int(np.asarray(rc)[0]) == want0, (G, n)
        assert np.array_equal(cls[0].numpy(), np.asarray(rc)), (G, n)
        assert np.array_equal(pos[0].numpy(), np.asarray(rp)), (G, n)
        assert _rel(box_t[0], rb) <= 1e-6
    idx = torch.tensor([[1, 1, 0, 1, 2]])
    assert _last_writer(idx).tolist() == [[False, False, True, True, True]]


def test_focal_loss_with_ignore_labels_matches_reference():
    import jax.numpy as jnp
    from tosem_tpu.models.efficientdet import focal_loss as ref_focal
    from tosem_tpu_torch.models.efficientdet import focal_loss
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 4, (300, 7)).astype(np.float32)
    targets = rng.integers(-2, 7, 300).astype(np.int32)
    want = float(ref_focal(jnp.asarray(logits), jnp.asarray(targets), 7))
    got = float(focal_loss(torch.from_numpy(logits),
                           torch.from_numpy(targets).long(), 7))
    assert abs(got - want) <= 1e-5 * abs(want)
    # ignored anchors contribute nothing
    ign = np.where(targets == -2, 5, targets).astype(np.int32)
    kept = targets != -2
    only = float(focal_loss(torch.from_numpy(logits[kept]),
                            torch.from_numpy(ign[kept]).long(), 7))
    assert abs(got - only) <= 1e-5 * abs(only)


def test_detection_loss_and_its_gradients_match_jax_grad(tiny):
    import jax
    import jax.numpy as jnp
    from tosem_tpu.models.efficientdet import detection_loss as ref_loss
    from tosem_tpu_torch.models.efficientdet import detection_loss
    cfg = tiny["cfg"]
    boxes, classes, n_gt = _gt(cfg)
    A = len(tiny["anchors"])
    rng = np.random.default_rng(9)
    cl = rng.normal(-3, 2, (2, A, cfg.num_classes)).astype(np.float32)
    bx = rng.normal(0, 0.3, (2, A, 4)).astype(np.float32)

    def f(c, b):
        return ref_loss(c, b, boxes, classes, n_gt,
                        jnp.asarray(tiny["anchors"]), cfg)
    want, gw = jax.jit(lambda c, b: (f(c, b), jax.grad(
        lambda c, b: f(c, b)["loss"], argnums=(0, 1))(c, b)))(cl, bx)
    tc = torch.from_numpy(cl).requires_grad_()
    tb = torch.from_numpy(bx).requires_grad_()
    got = detection_loss(tc, tb, torch.from_numpy(boxes),
                         torch.from_numpy(classes), torch.from_numpy(n_gt),
                         torch.from_numpy(tiny["anchors"]), cfg)
    for k in ("loss", "class_loss", "box_loss"):
        assert abs(float(got[k]) - float(want[k])) <= \
            EVAL_TOL * abs(float(want[k])), k
    got["loss"].backward()
    assert _rel(tc.grad, gw[0]) <= LOSS_GRAD_TOL
    assert _rel(tb.grad, gw[1]) <= LOSS_GRAD_TOL


def test_postprocess_detections_equal_reference(tiny):
    import jax.numpy as jnp
    from tosem_tpu.models.efficientdet import postprocess as ref_post
    from tosem_tpu_torch.models.efficientdet import postprocess
    cfg = tiny["cfg"]
    A = len(tiny["anchors"])
    rng = np.random.default_rng(11)
    cl = rng.normal(-2, 2, (2, A, cfg.num_classes)).astype(np.float32)
    bx = rng.normal(0, 0.5, (2, A, 4)).astype(np.float32)
    want = ref_post(jnp.asarray(cl), jnp.asarray(bx), tiny["anchors"],
                    score_thresh=0.3)
    got = postprocess(torch.from_numpy(cl), torch.from_numpy(bx),
                      tiny["anchors"], score_thresh=0.3)
    for (gb, gs, gk), (wb, ws, wk) in zip(got, want):
        assert len(gb) == len(wb) > 5
        assert np.array_equal(gk, wk)
        assert np.abs(gs - ws).max() <= 1e-6
        assert np.abs(gb - wb).max() <= 1e-4


def test_nms_host_is_the_reference_s():
    from tosem_tpu.models.efficientdet import nms_host as ref_nms
    from tosem_tpu_torch.models.efficientdet import nms_host
    rng = np.random.default_rng(2)
    for _ in range(5):
        xy = rng.uniform(0, 50, (60, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(2, 20, (60, 2))],
                               1).astype(np.float32)
        scores = rng.integers(0, 6, 60).astype(np.float32)   # ties
        assert nms_host(boxes, scores, 0.4, 20) == ref_nms(boxes, scores,
                                                           0.4, 20)


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from tosem_tpu_torch.models.efficientdet import efficientdet_tiny
    with pytest.raises(RuntimeError, match="cuda"):
        efficientdet_tiny()


# ------------------------------- tests/test_efficientdet.py on the port


class TestReferenceChecks:
    def test_output_shapes_match_anchors(self, tiny):
        with torch.no_grad():
            cls, box = tiny["model"](torch.zeros(2, 64, 64, 3))
        assert cls.shape == (2, len(tiny["anchors"]),
                             tiny["cfg"].num_classes)
        assert box.shape == (2, len(tiny["anchors"]), 4)

    def test_initial_class_prior(self):
        from tosem_tpu_torch.models.efficientdet import efficientdet_tiny
        m = efficientdet_tiny(device="cpu")
        with torch.no_grad():
            cls, _ = m(torch.zeros(1, 64, 64, 3))
        p = float(torch.sigmoid(cls).mean())
        assert 0.003 < p < 0.05

    def test_bifpn_fusion_weights_normalized(self):
        from tosem_tpu_torch.models.efficientdet import BiFPNLayer
        layer = BiFPNLayer(3, 8)
        feats = [torch.ones(1, 8, 8 // 2 ** i, 8 // 2 ** i)
                 for i in range(3)]
        with torch.no_grad():
            out = layer(feats)
        assert [o.shape for o in out] == [f.shape for f in feats]
        assert all(bool(torch.isfinite(o).all()) for o in out)

    def test_iou_known_values(self):
        from tosem_tpu_torch.models.efficientdet import box_iou
        a = torch.tensor([[0., 0., 2., 2.]])
        b = torch.tensor([[1., 1., 3., 3.], [0., 0., 2., 2.],
                          [5., 5., 6., 6.]])
        iou = box_iou(a, b)[0]
        assert float(iou[0]) == pytest.approx(1 / 7, abs=1e-5)
        assert float(iou[1]) == pytest.approx(1.0, abs=1e-5)
        assert float(iou[2]) == 0.0

    def test_encode_decode_roundtrip(self, tiny):
        from tosem_tpu_torch.models.efficientdet import (decode_boxes,
                                                         encode_boxes)
        an = torch.from_numpy(tiny["anchors"][:50])
        gt = an + torch.tensor([2.0, -3.0, 5.0, 1.0])
        back = decode_boxes(encode_boxes(gt, an), an)
        np.testing.assert_allclose(back.numpy(), gt.numpy(), rtol=1e-4,
                                   atol=1e-3)

    def test_anchor_count_formula(self, tiny):
        cfg = tiny["cfg"]
        expect = sum(max(1, 64 // 2 ** lv) ** 2 * cfg.num_anchors
                     for lv in cfg.levels)
        assert len(tiny["anchors"]) == expect

    def test_nms_suppresses_overlaps(self):
        from tosem_tpu_torch.models.efficientdet import nms_host
        boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                         np.float32)
        scores = np.array([0.9, 0.8, 0.7], np.float32)
        assert nms_host(boxes, scores, iou_thresh=0.5) == [0, 2]

    def test_loss_finite_and_decomposes(self, tiny):
        from tosem_tpu_torch.models.efficientdet import detection_loss
        with torch.no_grad():
            cls, box = tiny["model"](torch.zeros(2, 64, 64, 3))
        out = detection_loss(cls, box,
                             torch.tensor([[[10., 10., 40., 40.]],
                                           [[5., 20., 30., 60.]]]),
                             torch.tensor([[1], [3]]), torch.tensor([1, 1]),
                             torch.from_numpy(tiny["anchors"]), tiny["cfg"])
        assert np.isfinite(float(out["loss"]))
        assert float(out["loss"]) == pytest.approx(
            float(out["class_loss"]) + 50.0 * float(out["box_loss"]),
            rel=1e-5)

    def test_empty_image_only_background(self, tiny):
        from tosem_tpu_torch.models.efficientdet import detection_loss
        with torch.no_grad():
            cls, box = tiny["model"](torch.zeros(1, 64, 64, 3))
        out = detection_loss(cls, box, torch.zeros(1, 1, 4),
                             torch.zeros(1, 1, dtype=torch.int32),
                             torch.tensor([0]),
                             torch.from_numpy(tiny["anchors"]), tiny["cfg"])
        assert float(out["box_loss"]) == pytest.approx(0.0, abs=1e-6)
