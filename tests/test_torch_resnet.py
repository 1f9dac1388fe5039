"""The port's ResNet path held against the JAX package's on the CPU:
the layers (``nn/layers.py``: ``Conv2D``, ``DepthwiseConv2D``,
``BatchNorm``, ``max_pool``, ``avg_pool_global``, ``relu``), the model
(``models/resnet.py``) through the converter (``models/convert.py``),
``classification_loss`` and the train steps, plain and over a mesh of 8
CPU positions.

fp32 throughout unless named: layers within 1e-5 (1e-4 for the model's
logits, 2e-4 for parameters after SGD steps) of the reference. Each
check has a yardstick that must break it: torch's own ``F.batch_norm``
moving-stat update (complement momentum, unbiased variance) for
BatchNorm's state, and per-position moments for the mesh step."""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _key(i=0):
    import jax
    return jax.random.PRNGKey(i)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _x(shape=(4, 9, 9, 6), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 2.0 + 0.5


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2)])
def test_conv2d_layer_matches_reference(k, stride):
    from tosem_tpu.nn.layers import Conv2D as Ref
    from tosem_tpu_torch.nn.layers import Conv2D
    ref = Ref(6, 5, (k, k), stride)
    vs = ref.init(_key(1))
    x = _x()
    want, _ = ref.apply(vs, x)
    layer = Conv2D(6, 5, (k, k), stride)
    with torch.no_grad():
        layer.w.copy_(torch.from_numpy(np.array(
            vs["params"]["w"])).permute(3, 2, 0, 1))
    got = layer(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_depthwise_conv_matches_reference():
    from tosem_tpu.nn.layers import DepthwiseConv2D as Ref
    from tosem_tpu_torch.nn.layers import DepthwiseConv2D
    ref = Ref(6, (3, 3), 2)
    vs = ref.init(_key(2))
    x = _x()
    want, _ = ref.apply(vs, x)
    layer = DepthwiseConv2D(6, (3, 3), 2)
    assert tuple(layer.w.shape) == (6, 1, 3, 3)
    with torch.no_grad():
        layer.w.copy_(torch.from_numpy(np.array(
            vs["params"]["w"])).permute(3, 2, 0, 1))
    np.testing.assert_allclose(_nhwc(layer(_nchw(x))), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def _bn_pair(dtype="float32"):
    import jax.numpy as jnp
    from tosem_tpu.nn.layers import BatchNorm as Ref
    from tosem_tpu_torch.nn.layers import BatchNorm
    jdt = jnp.dtype(dtype)
    ref = Ref(6, dtype=jdt)
    vs = ref.init(_key())
    rng = np.random.default_rng(5)
    scale = rng.standard_normal(6).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    vs = {"params": {"scale": jnp.asarray(scale, jdt),
                     "bias": jnp.asarray(bias, jdt)},
          "state": {"mean": jnp.asarray(rng.standard_normal(6), jnp.float32),
                    "var": jnp.asarray(rng.random(6) + 0.5, jnp.float32)}}
    layer = BatchNorm(6, dtype=getattr(torch, dtype))
    with torch.no_grad():
        layer.scale.copy_(torch.from_numpy(scale))
        layer.bias.copy_(torch.from_numpy(bias))
        layer.mean.copy_(torch.from_numpy(np.asarray(vs["state"]["mean"])))
        layer.var.copy_(torch.from_numpy(np.asarray(vs["state"]["var"])))
    return ref, vs, layer


def test_batchnorm_train_matches_reference_output_and_moving_stats():
    ref, vs, layer = _bn_pair()
    x = _x()
    want, new_state = ref.apply(vs, x, train=True)
    got = layer(_nchw(x), train=True)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(layer, name).numpy(),
                                   np.asarray(new_state[name]), atol=1e-6,
                                   rtol=1e-6)


def test_torch_batch_norm_update_breaks_the_moving_stats_check():
    """The yardstick: ``F.batch_norm(training=True, momentum=0.9)``
    takes momentum as the new value's weight and updates the moving
    variance with the unbiased batch variance."""
    ref, vs, layer = _bn_pair()
    x = _x()
    _, new_state = ref.apply(vs, x, train=True)
    rm, rv = layer.mean.clone(), layer.var.clone()
    F.batch_norm(_nchw(x), rm, rv, training=True, momentum=0.9, eps=1e-5)
    assert np.abs(rm.numpy() - np.asarray(new_state["mean"])).max() > 1e-2
    assert np.abs(rv.numpy() - np.asarray(new_state["var"])).max() > 1e-2
    # with the complement momentum, the unbiased variance alone parts
    rm, rv = layer.mean.clone(), layer.var.clone()
    F.batch_norm(_nchw(x), rm, rv, training=True, momentum=0.1, eps=1e-5)
    np.testing.assert_allclose(rm.numpy(), np.asarray(new_state["mean"]),
                               atol=1e-6)
    assert np.abs(rv.numpy() - np.asarray(new_state["var"])).max() > 1e-3


def test_batchnorm_eval_matches_reference():
    ref, vs, layer = _bn_pair()
    x = _x()
    want, state = ref.apply(vs, x, train=False)
    got = layer(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert np.array_equal(layer.mean.numpy(), np.asarray(state["mean"]))


def test_batchnorm_bf16_matches_reference():
    import jax.numpy as jnp
    ref, vs, layer = _bn_pair("bfloat16")
    x = _x()
    want, new_state = ref.apply(vs, jnp.asarray(x, jnp.bfloat16), train=True)
    got = layer(_nchw(x).bfloat16(), train=True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(_nhwc(got.float()) - want).max() <= \
        2e-2 * np.abs(want).max()
    np.testing.assert_allclose(layer.var.numpy(),
                               np.asarray(new_state["var"]), rtol=1e-5)


@pytest.mark.parametrize("h,window,stride", [(9, 3, 2), (8, 3, 2),
                                             (7, 3, 1), (8, 2, 2)])
def test_pools_and_relu_match_reference(h, window, stride):
    from tosem_tpu.nn import layers as ref
    from tosem_tpu_torch.nn import layers as port
    x = _x((2, h, h, 3))
    np.testing.assert_array_equal(
        _nhwc(port.max_pool(_nchw(x), window, stride)),
        np.asarray(ref.max_pool(x, window, stride)))
    np.testing.assert_allclose(port.avg_pool_global(_nchw(x)).numpy(),
                               np.asarray(ref.avg_pool_global(x)),
                               atol=1e-6)
    np.testing.assert_array_equal(_nhwc(port.relu(_nchw(x))),
                                  np.asarray(ref.relu(x)))


# ------------------------------------------------------------------ model


def _pair(classes=4, seed=0):
    import jax.numpy as jnp
    from tosem_tpu.models.resnet import resnet18_ish as ref_r18
    from tosem_tpu_torch.models.convert import load_resnet_params
    from tosem_tpu_torch.models.resnet import resnet18_ish
    ref = ref_r18(num_classes=classes, dtype=jnp.float32)
    vs = ref.init(_key(seed))
    model = resnet18_ish(num_classes=classes, dtype=torch.float32,
                         device="cpu")
    load_resnet_params(model, _np_tree(vs["params"]), _np_tree(vs["state"]))
    return ref, vs, model


def _batch(n=16, hw=8, classes=4):
    from tosem_tpu_torch.data.synthetic import cifar_like_batches
    return next(cifar_like_batches(n, n=64, hw=hw, classes=classes,
                                   steps=1))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_resnet18_forward_matches_reference_train_and_eval():
    import jax.numpy as jnp
    ref, vs, model = _pair()
    x = _batch()["image"]
    want, state = ref.apply(vs, jnp.asarray(x), train=True)
    got = model(torch.from_numpy(x), train=True)
    assert got.dtype == torch.float32
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() \
        <= 1e-4 * scale
    assert np.abs(model.blocks[0].bn2.mean.numpy() - np.asarray(
        state["block0"]["bn2"]["mean"])).max() <= 1e-5
    assert np.abs(model.stem_bn.var.numpy() - np.asarray(
        state["stem_bn"]["var"])).max() <= 1e-5
    want, _ = ref.apply({"params": vs["params"], "state": state},
                        jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= \
        1e-4 * np.abs(np.asarray(want)).max()


def test_converter_names_every_parameter_and_buffer():
    _, vs, model = _pair()
    from tosem_tpu_torch.models.convert import resnet_params_from_numpy
    sd = resnet_params_from_numpy(_np_tree(vs["params"]),
                                  _np_tree(vs["state"]))
    assert set(sd) == set(model.state_dict())
    assert tuple(sd["blocks.1.conv2.w"].shape) == (128, 128, 3, 3)
    assert sd["blocks.1.conv2.w"].is_contiguous()


def _sgd(model, lr=1e-2):
    return lambda p: torch.optim.SGD(p, lr=lr, momentum=0.9)


def test_two_sgd_steps_match_reference():
    import jax.numpy as jnp
    import optax
    from tosem_tpu.train.trainer import classification_loss as ref_loss
    from tosem_tpu.train.trainer import make_train_step as ref_step
    from tosem_tpu_torch.models.convert import resnet_params_from_numpy
    from tosem_tpu_torch.train import (classification_loss,
                                       create_train_state, make_train_step)
    ref, vs, model = _pair()
    b = _batch()
    opt = optax.sgd(1e-2, momentum=0.9)
    ts = {"step": jnp.zeros((), jnp.int32), "params": vs["params"],
          "state": vs["state"], "opt_state": opt.init(vs["params"])}
    rstep = ref_step(ref, opt, ref_loss, donate=False)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    st = create_train_state(model, _sgd(model))
    step = make_train_step(model, st.optimizer, classification_loss)
    for _ in range(2):
        ts, rm = rstep(ts, jb, _key(1))
        st, m = step(st, _t(b))
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                                 abs=2e-5)
        assert float(m["accuracy"]) == float(rm["accuracy"])
    want = resnet_params_from_numpy(_np_tree(ts["params"]),
                                    _np_tree(ts["state"]))
    got = model.state_dict()
    worst = max(float((got[n] - want[n]).abs().max()) for n in want)
    assert worst <= 2e-4
    assert st.step == 2


def test_resnet50_has_the_reference_parameter_count():
    import jax
    import jax.numpy as jnp
    from tosem_tpu.models.resnet import resnet50 as ref_r50
    from tosem_tpu_torch.models.resnet import resnet50
    ref = ref_r50(num_classes=1000, small_inputs=False, dtype=jnp.float32)
    shapes = jax.eval_shape(ref.init, _key())
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))
    model = resnet50(num_classes=1000, small_inputs=False,
                     dtype=torch.float32, device="cpu")
    assert model.param_count() == want
    assert 24e6 < want < 27e6


def test_classification_loss_sum_form_is_the_mean_form():
    from tosem_tpu_torch.train import classification_loss
    _, _, model = _pair()
    b = _t(_batch())
    with torch.no_grad():
        mean, aux = classification_loss(model, b)
        num, saux = classification_loss(model, b, reduce="sum")
    assert float(num / saux["count"]) == pytest.approx(float(mean),
                                                       rel=1e-6)
    assert float(saux["accuracy"] / saux["count"]) == \
        pytest.approx(float(aux["accuracy"]))


# ------------------------------------------------------------- mesh step


def _mesh8():
    from tosem_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    return make_mesh(MeshSpec.of(dp=8), ["cpu"] * 8)


def _run(mesh, steps=2, seed=3):
    from tosem_tpu_torch.models.resnet import resnet18_ish
    from tosem_tpu_torch.train import (classification_loss,
                                       create_train_state, make_train_step,
                                       shard_batch)
    model = resnet18_ish(num_classes=4, dtype=torch.float32, device="cpu",
                         seed=seed)
    st = create_train_state(model, _sgd(model))
    step = make_train_step(model, st.optimizer, classification_loss,
                           mesh=mesh)
    b = _t(_batch())
    metrics = []
    for _ in range(steps):
        st, m = step(st, b if mesh is None else shard_batch(b, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {n: t.detach().clone()
                     for n, t in model.state_dict().items()}


def _gap(a, b):
    return max(float((a[n] - b[n]).abs().max()) for n in a)


def test_mesh_step_over_8_positions_is_the_global_step():
    """BatchNorm over the global batch inside the mesh step: loss,
    accuracy, parameters and moving stats equal the plain step on the
    whole batch (2 rows a position, so per-position moments would be
    another model)."""
    plain, want = _run(None)
    mesh, got = _run(_mesh8())
    for p, m in zip(plain, mesh):
        assert m["loss"] == pytest.approx(p["loss"], abs=1e-5)
        assert m["accuracy"] == p["accuracy"]
    assert _gap(got, want) <= 1e-5


def test_per_position_moments_break_the_mesh_check(monkeypatch):
    import contextlib

    from tosem_tpu_torch.nn import layers
    plain, want = _run(None, steps=1)
    monkeypatch.setattr(layers, "batch_moments_over",
                        lambda axes: contextlib.nullcontext())
    mesh, got = _run(_mesh8(), steps=1)
    assert abs(mesh[0]["loss"] - plain[0]["loss"]) > 1e-3 \
        or _gap(got, want) > 1e-3


def _run_partitioned(mesh, steps=2, seed=3):
    from tosem_tpu_torch.models.resnet import resnet18_ish
    from tosem_tpu_torch.parallel.sharding import image_batch_rules
    from tosem_tpu_torch.train import (classification_loss,
                                       create_train_state,
                                       make_partitioned_train_step,
                                       shard_batch_by_rules,
                                       shard_train_state)
    model = resnet18_ish(num_classes=4, dtype=torch.float32, device="cpu",
                         seed=seed)
    init = {n: b.detach().clone() for n, b in model.named_buffers()}
    st = shard_train_state(create_train_state(model, _sgd(model)), mesh, [])
    step = make_partitioned_train_step(model, None, classification_loss,
                                       mesh=mesh, rules=[],
                                       batch_rules=image_batch_rules())
    b = shard_batch_by_rules(_t(_batch()), mesh, image_batch_rules())
    losses = []
    for _ in range(steps):
        st, m = step(st, b)
        losses.append(float(m["loss"]))
    # the step leaves the model as it was: the state carries the update
    assert all(torch.equal(v, init[n]) for n, v in model.named_buffers())
    return losses, {**st.gather(),
                    **{n: v.detach().clone() for n, v in st.buffers.items()}}


def test_partitioned_step_over_8_positions_is_the_global_step():
    """The partitioned step over a BatchNorm model: the global batch's
    moments, and the moving stats carried in the state's buffers, equal
    the plain step's on the whole batch."""
    plain, want = _run(None)
    losses, got = _run_partitioned(_mesh8())
    for p, m in zip(plain, losses):
        assert m == pytest.approx(p["loss"], abs=1e-5)
    assert set(got) == set(want)
    assert _gap(got, want) <= 1e-5
    assert any(n.endswith(".mean") for n in got)


def test_mesh_of_one_position_is_the_plain_step_bit_for_bit():
    from tosem_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    _, want = _run(None, steps=1)
    _, got = _run(make_mesh(MeshSpec.of(dp=1), ["cpu"]), steps=1)
    assert all(torch.equal(got[n], want[n]) for n in want)


class TestTraining:
    """``tests/test_models.py``'s ResNet training tests on the port (8
    CPU positions where the reference has 8 virtual devices)."""

    def test_small_forward(self):
        from tosem_tpu_torch.models.resnet import resnet18_ish
        m = resnet18_ish(num_classes=10, dtype=torch.float32, device="cpu")
        logits = m(torch.ones(2, 32, 32, 3), train=True)
        assert logits.shape == (2, 10) and logits.dtype == torch.float32
        assert "blocks.0.bn1.mean" in m.state_dict()

    def test_loss_decreases_resnet(self):
        from tosem_tpu_torch.data.synthetic import cifar_like_batches
        from tosem_tpu_torch.models.resnet import resnet18_ish
        from tosem_tpu_torch.train import (classification_loss,
                                           create_train_state,
                                           make_train_step, shard_batch)
        mesh = _mesh8()
        m = resnet18_ish(num_classes=4, dtype=torch.float32, device="cpu")
        st = create_train_state(m, lambda p: torch.optim.Adam(p, lr=1e-2))
        step = make_train_step(m, st.optimizer, classification_loss,
                               mesh=mesh)
        losses = []
        # 12 of the reference's 30 steps: a mesh step of 8 position
        # threads takes about a second on one CPU core
        for batch in cifar_like_batches(16, n=64, hw=8, classes=4,
                                        steps=12):
            st, metrics = step(st, shard_batch(_t(batch), mesh))
            losses.append(float(metrics["loss"]))
        assert losses[-1] < losses[0], losses
        assert st.step == 12

    def test_step_recompiles_per_batch_structure(self):
        """A batch with an extra key gives the same loss; the same state
        and batch give the same loss again."""
        from tosem_tpu_torch.models.resnet import resnet18_ish
        from tosem_tpu_torch.train import (classification_loss,
                                           create_train_state,
                                           make_train_step, shard_batch)
        mesh = _mesh8()
        m = resnet18_ish(num_classes=4, dtype=torch.float32, device="cpu")
        init = {k: v.clone() for k, v in m.state_dict().items()}
        st = create_train_state(m, _sgd(m))
        step = make_train_step(m, st.optimizer, classification_loss,
                               mesh=mesh)
        b16 = _t(_batch())
        b_extra = dict(b16, sample_weight=torch.ones(16))

        def fresh_loss(b):
            m.load_state_dict(init)
            _, met = step(st, shard_batch(b, mesh))
            return float(met["loss"])
        l16, lex, l16b = fresh_loss(b16), fresh_loss(b_extra), \
            fresh_loss(b16)
        assert np.isfinite(l16)
        assert lex == pytest.approx(l16)
        assert l16b == pytest.approx(l16)

    def test_single_device_step(self):
        from tosem_tpu_torch.models.resnet import resnet18_ish
        from tosem_tpu_torch.train import (classification_loss,
                                           create_train_state,
                                           make_train_step)
        m = resnet18_ish(num_classes=4, dtype=torch.float32, device="cpu")
        st = create_train_state(m, functools.partial(torch.optim.SGD,
                                                     lr=1e-2))
        step = make_train_step(m, st.optimizer, classification_loss)
        batch = next(__import__("tosem_tpu_torch.data.synthetic",
                                fromlist=["x"]).cifar_like_batches(
            8, n=32, hw=8, classes=4, steps=1))
        st2, metrics = step(st, _t(batch))
        assert float(metrics["loss"]) > 0
        assert st2.step == 1

    def test_resnet50_param_count(self):
        from tosem_tpu_torch.models.resnet import resnet50
        m = resnet50(num_classes=1000, small_inputs=False,
                     dtype=torch.float32, device="cpu")
        assert 24e6 < m.param_count() < 27e6
