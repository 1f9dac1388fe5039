"""The port's training path held against the JAX package's, at
``BertConfig.tiny()`` in fp32 with dropout 0 on both sides, from the JAX
package's initial weights carried across by ``bert_params_from_numpy``:
the losses, one ``make_train_step`` step (loss within 2e-5, gradients
within atol 5e-4 / rtol 5e-3) and the parameters after three AdamW steps
(within 1e-5; at lr 1e-4 three steps move a weight by at most 3e-4).
Then the port's own pins: remat against no remat (loss within 1e-6,
gradients within rtol 1e-5 / atol 1e-6, as ``tests/test_models.py``), and
with dropout 0.1 two runs from one seed, and remat against no remat, bit
for bit."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

B, T = 2, 64
GRAD = dict(atol=5e-4, rtol=5e-3)


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def _batch_np(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 50:] = 0                      # key padding on row 1
    masked = rng.random((B, T)) < 0.15
    masked[:, 0] = True
    return {"ids": ids, "labels": ids, "mask": mask, "masked": masked}


def _to_jax(batch):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref():
    """The JAX model, its initial train state (adamw(1e-4)) and the
    parameters as numpy."""
    import jax
    import optax
    from tosem_tpu.models.bert import Bert as JBert
    from tosem_tpu.models.bert import BertConfig as JConfig
    from tosem_tpu.train.trainer import create_train_state
    cfg = dataclasses.replace(JConfig.tiny(), dtype="float32")
    model = JBert(cfg)
    ts = create_train_state(model, jax.random.PRNGKey(0), optax.adamw(1e-4))
    tree = jax.tree_util.tree_map(np.asarray, ts["params"])
    return cfg, model, ts, tree


def _port(ref, **change):
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.models.convert import load_bert_params
    cfg = dataclasses.replace(BertConfig(**dataclasses.asdict(ref[0])),
                              **change)
    model = Bert(cfg, device="cpu", seed=1)
    load_bert_params(model, ref[3])
    return model


def _flat(tree):
    from tosem_tpu_torch.models.convert import bert_params_from_numpy
    import jax
    return bert_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _bert_train_loss(flash, jax_side):
    """The loss of the reference's ``bert_train`` leg (``cli.py``):
    apply with ``attn_fn``, the tied MLM head, cross entropy over the
    masked positions, on either package."""
    if jax_side:
        from tosem_tpu.nn.attention import flash_attn_fn
        from tosem_tpu.nn.core import variables
        from tosem_tpu.train.trainer import cross_entropy_loss
        afn = flash_attn_fn() if flash else None

        def loss_fn(model, params, state, batch, rng):
            enc, new_state = model.apply(
                {"params": params, "state": state}, batch["ids"],
                mask=batch["mask"], train=True, rng=rng, attn_fn=afn)
            logits = model.mlm_logits(variables(params, state), enc)
            return cross_entropy_loss(logits, batch["labels"],
                                      batch["masked"]), {"state": new_state}
        return loss_fn
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.train import mlm_loss
    return functools.partial(mlm_loss,
                             attn_fn=flash_attn_fn() if flash else None)


def _ref_grads(ref, loss_fn, batch):
    import jax
    _, model, ts, _ = ref

    def lf(params):
        return loss_fn(model, params, ts["state"], batch,
                       jax.random.PRNGKey(2))[0]
    loss, grads = jax.value_and_grad(lf)(ts["params"])
    return float(loss), _flat(grads)


def _port_steps(ref, flash, n, **change):
    from tosem_tpu_torch.train import (adamw, create_train_state,
                                       make_train_step)
    model = _port(ref, **change)
    st = create_train_state(model, adamw(1e-4))
    step = make_train_step(model, st.optimizer,
                           _bert_train_loss(flash, jax_side=False))
    batch = _to_torch(_batch_np())
    losses, grads = [], None
    for i in range(n):
        st, met = step(st, batch, torch.Generator().manual_seed(i))
        losses.append(float(met["loss"]))
        if i == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return model, losses, grads


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_reference(weighted):
    import jax.numpy as jnp
    from tosem_tpu.train.trainer import cross_entropy_loss as j_ce
    from tosem_tpu_torch.train import cross_entropy_loss
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 7, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, size=(3, 7)).astype(np.int32)
    w = (rng.random((3, 7)) < 0.4) if weighted else None
    want = float(j_ce(jnp.asarray(logits), jnp.asarray(labels),
                      None if w is None else jnp.asarray(w)))
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6


def test_cross_entropy_of_an_empty_weight_mask_is_zero():
    from tosem_tpu_torch.train import cross_entropy_loss
    logits = torch.randn(2, 3, 5, generator=torch.Generator().manual_seed(0))
    loss = cross_entropy_loss(logits, torch.zeros(2, 3, dtype=torch.int64),
                              torch.zeros(2, 3, dtype=torch.bool))
    assert float(loss) == 0.0


def test_adamw_matches_optax_update():
    """Three updates of optax.adamw(1e-4) and the port's adamw(1e-4) on
    the same fp32 parameters and gradients, one gradient all zeros (the
    weight decay still applies)."""
    import jax.numpy as jnp
    import optax
    from tosem_tpu_torch.train import adamw
    rng = np.random.default_rng(6)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32)
             for _ in range(2)] + [np.zeros((4, 5), np.float32)]
    opt = optax.adamw(1e-4)
    jp, js = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = adamw(1e-4)([tp])
    for g in grads:
        upd, js = opt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
    # the same algebra in another order: a few ulp apart, no more
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=0)
    assert not np.array_equal(np.asarray(jp), p0)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_train_step_matches_reference(ref, flash):
    """One step's loss and gradients, and the parameters after three
    steps. With ``flash`` both sides pass ``attn_fn=flash_attn_fn()``:
    the port runs its flash Function (key padding as segment ids), while
    the reference's flash dispatch falls back to its XLA arm here,
    because Tk = 64 is not a multiple of 128 (``nn/attention.py``)."""
    import jax
    import optax
    from tosem_tpu.train.trainer import make_train_step
    from tosem_tpu_torch.nn.attention import FLASH_DISPATCH_COUNTS
    batch = _batch_np()
    jloss = _bert_train_loss(flash, jax_side=True)
    want_loss, want_grads = _ref_grads(ref, jloss, _to_jax(batch))
    flash_calls = FLASH_DISPATCH_COUNTS["torch"]
    model, losses, grads = _port_steps(ref, flash, 3)
    assert (FLASH_DISPATCH_COUNTS["torch"] > flash_calls) == flash
    assert abs(losses[0] - want_loss) <= 2e-5
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(_np(g), _np(want_grads[name]),
                                   err_msg=name, **GRAD)
    step = make_train_step(ref[1], optax.adamw(1e-4), jloss, donate=False)
    ts = ref[2]
    for _ in range(3):
        ts, _ = step(ts, _to_jax(batch), jax.random.PRNGKey(2))
    want = _flat(ts["params"])
    for name, p in model.state_dict().items():
        if name.endswith("attn.k.b"):
            # softmax is blind to a bias shared by every key, so this
            # gradient is rounding noise on both sides (pinned here), and
            # Adam turns noise of any size into a step of lr * sign
            assert np.abs(_np(grads[name])).max() < 1e-6
            assert np.abs(_np(want_grads[name])).max() < 1e-6
            continue
        np.testing.assert_allclose(_np(p), _np(want[name]), rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_matches_no_remat(ref, remat):
    _, l0, g0 = _port_steps(ref, True, 1)
    _, l1, g1 = _port_steps(ref, True, 1, remat=remat)
    assert abs(l0[0] - l1[0]) < 1e-6
    for name in g0:
        np.testing.assert_allclose(_np(g1[name]), _np(g0[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_dropout_runs_are_bit_identical(ref, remat):
    """Dropout 0.1: a run equals a second run from the same seed, and a
    rematerialised run equals the plain one, loss and gradients bit for
    bit. ``torch.utils.checkpoint`` replays only the default generators,
    so this fails if a recomputed layer draws new masks."""
    _, l0, g0 = _port_steps(ref, True, 2, dropout=0.1)
    _, l1, g1 = _port_steps(ref, True, 2, dropout=0.1, remat=remat)
    _, nodrop, _ = _port_steps(ref, True, 1)
    assert l0 == l1 and l0[0] != nodrop[0]
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_dropout_draws_its_mask_from_the_generator_on_the_device():
    from tosem_tpu_torch.nn.layers import Dropout
    x = torch.randn(4, 6, 8, generator=torch.Generator().manual_seed(0))
    got = Dropout(0.25)(x, train=True,
                        generator=torch.Generator().manual_seed(9))
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(9),
                      device=x.device) < 0.75
    assert torch.equal(got, torch.where(keep, x / 0.75, torch.zeros_like(x)))
    assert torch.equal(Dropout(0.25)(x, train=False), x)


def test_parameters_are_trainable_and_serving_builds_no_graph(ref):
    model = _port(ref)
    assert all(p.requires_grad for p in model.parameters())
    ids = torch.from_numpy(_batch_np()["ids"])
    mask = torch.ones_like(ids)
    assert model.apply(ids).requires_grad
    assert not model.encode_fn()(ids, mask).requires_grad
    assert not any(t.requires_grad for t in model.prefill_fn()(ids, mask))


def test_unported_training_paths_raise_naming_the_roadmap():
    """The mesh train steps are ported (A10, ``test_torch_mesh_train.py``)
    and build; ranks as replica processes are ported too (A11,
    ``test_torch_train_nodes.py``) and refuse to start without the
    ``NodePool`` they are placed on; the classification loss came with
    ResNet (A12; ``test_torch_resnet.py``) and takes the mesh steps'
    ``reduce="sum"``."""
    from tosem_tpu_torch.parallel.mesh import default_mesh
    from tosem_tpu_torch.train import trainer
    from tosem_tpu_torch.train.distributed import (DataParallelConfig,
                                                   DistributedTrainer)
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    mesh = default_mesh("dp", ["cpu"] * 2)
    assert callable(trainer.make_train_step(model, opt, None, mesh=mesh))
    assert callable(trainer.make_partitioned_train_step(
        model, opt, None, mesh=mesh, rules=[], batch_rules=[]))
    with pytest.raises(ValueError, match="NodePool"):
        DistributedTrainer("tosem_tpu_torch.train.distributed:demo_job",
                           {}, DataParallelConfig(job="nodes"),
                           backend="nodes", world=1)
    assert "reduce" in __import__("inspect").signature(
        trainer.classification_loss).parameters              # A12


def test_unreached_parameter_keeps_optax_momentum():
    """A parameter the loss reaches at step 0 but not at step 1 keeps
    moving on its moments under optax.adamw (jax.grad gives it a zero
    gradient); torch's AdamW would skip a None gradient, so the step
    gives it zeros."""
    import jax
    import jax.numpy as jnp
    import optax
    from tosem_tpu_torch.train import adamw, create_train_state
    from tosem_tpu_torch.train import make_train_step
    p0 = {"a": np.asarray([0.5, -1.0], np.float32),
          "b": np.asarray([2.0, 0.25], np.float32)}

    def jloss(p, step):
        return jnp.sum(p["a"] ** 2) + (jnp.sum(p["b"] ** 2) if step == 0
                                       else 0.0)
    opt = optax.adamw(1e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = opt.init(jp)
    for s in range(2):
        g = jax.grad(jloss)(jp, s)
        upd, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)

    model = torch.nn.Module()
    model.a = torch.nn.Parameter(torch.from_numpy(p0["a"].copy()))
    model.b = torch.nn.Parameter(torch.from_numpy(p0["b"].copy()))
    st = create_train_state(model, adamw(1e-2))

    def loss_fn(m, step, generator):
        loss = (m.a ** 2).sum()
        return (loss + (m.b ** 2).sum() if step == 0 else loss), {}
    step = make_train_step(model, st.optimizer, loss_fn)
    for s in range(2):
        st, _ = step(st, s)
    for name in ("a", "b"):
        np.testing.assert_allclose(getattr(model, name).detach().numpy(),
                                   np.asarray(jp[name]), rtol=1e-6, atol=0,
                                   err_msg=name)
