"""The port's train steps over a device mesh (``tosem_tpu_torch/train/
trainer.py``: ``make_train_step(mesh=)``, ``make_partitioned_train_step``)
held against the JAX package's: ``tests/test_models.py``'s
``test_loss_decreases_bert_mlm`` and ``tests/test_sharding.py``'s
``test_partitioned_bert_step`` run against the port, then the packages'
global steps against each other on converted weights.

Both packages compute the GLOBAL masked-mean loss over the mesh. The
batches here give the dp shards very different masked counts, so a mean
of the shards' means is another loss; the yardstick that computes it
must break the bound the mesh steps hold. The reference runs on
``conftest.py``'s 8 virtual CPU devices, the port on 8 CPU positions.
Losses are held within 2e-5 and parameters after three adamw(1e-4) steps
within 1e-5 (as ``test_torch_train.py``), except the attention key
biases: softmax is blind to a bias shared by every key, so their
gradient is rounding noise, which Adam turns into steps of lr * sign in
any two reduction orders. A mesh of one position is the unsharded step
bit for bit, dropout included.
"""
import functools

import numpy as np
import pytest
import torch

from tosem_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from tosem_tpu_torch.parallel.sharding import bert_rules, seq_batch_rules
from tosem_tpu_torch.parallel.spmd import P
from tosem_tpu_torch.train.trainer import (adamw, create_train_state,
                                           make_partitioned_train_step,
                                           make_train_step, mlm_loss,
                                           shard_batch, shard_batch_by_rules,
                                           shard_train_state)

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
B, T = 8, 16


def _cfg(**over):
    from tosem_tpu_torch.models.bert import BertConfig
    kw = dict(vocab_size=64, max_len=32, dim=16, heads=2, layers=2,
              mlp_dim=32, dropout=0.0, dtype="float32")
    kw.update(over)
    return BertConfig(**kw)


def _skewed_batch(seed=1):
    """Rows 0-1 (dp shard 0 of 4) fully masked, the other rows one masked
    position each: 32 + 6 masked positions, so the shards' means weigh
    very differently from the global mean."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 64, size=(B, T)).astype(np.int32)
    masked = np.zeros((B, T), bool)
    masked[:2] = True
    masked[2:, 3] = True
    inputs = np.where(masked, 1, ids).astype(np.int32)
    return {"ids": inputs, "labels": ids, "masked": masked}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v).copy())
            for k, v in batch.items()}


def _model(cfg, seed=3):
    from tosem_tpu_torch.models.bert import Bert
    return Bert(cfg, device="cpu", seed=seed)


def _params(state):
    if hasattr(state, "gather"):
        return state.gather()
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def _hold(got, want, atol=1e-5):
    for n in want:
        if n.endswith("attn.k.b"):
            continue            # gradient is rounding noise: see above
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=0,
                                   atol=atol, err_msg=n)


def _run(kind, cfg, batch, steps=3, lr=1e-4, gens=False, model=None):
    """(losses, parameters) after ``steps`` steps of the unsharded step
    or a mesh step (``dp``: make_train_step(mesh=) over dp=4 x tp=2;
    ``dp_tp_sp``: make_partitioned_train_step over (2, 2, 2); ``one``
    and ``one_dp``: the two over a single position)."""
    m = model if model is not None else _model(cfg)
    st = create_train_state(m, adamw(lr))
    if kind == "plain":
        step, b = make_train_step(m, st.optimizer, mlm_loss), batch
    elif kind in ("dp", "one_dp"):
        mesh = make_mesh(MeshSpec.of(dp=4, tp=2) if kind == "dp"
                         else MeshSpec.of(dp=1), CPU8 if kind == "dp"
                         else ["cpu"])
        step = make_train_step(m, st.optimizer, mlm_loss, mesh=mesh)
        b = shard_batch(batch, mesh)
    else:
        shape = dict(dp=2, tp=2, sp=2) if kind == "dp_tp_sp" \
            else dict(dp=1, tp=1, sp=1)
        mesh = make_mesh(MeshSpec.of(**shape),
                         ["cpu"] * int(np.prod(list(shape.values()))))
        st = shard_train_state(st, mesh, bert_rules())
        step = make_partitioned_train_step(
            m, None, mlm_loss, mesh=mesh, rules=bert_rules(),
            batch_rules=seq_batch_rules())
        b = shard_batch_by_rules(batch, mesh, seq_batch_rules())
    losses = []
    for i in range(steps):
        g = torch.Generator().manual_seed(100 + i) if gens else None
        st, met = step(st, b, g)
        losses.append(float(met["loss"]))
    return losses, _params(st)


class TestTraining:
    def test_loss_decreases_bert_mlm(self):
        from tosem_tpu.data import mlm_batches
        cfg = _cfg(max_len=16, layers=1)
        m = _model(cfg)
        mesh8 = make_mesh(MeshSpec.of(dp=4, tp=2), CPU8)
        st = create_train_state(m, adamw(5e-3, weight_decay=0.0))
        step = make_train_step(m, st.optimizer, mlm_loss, mesh=mesh8)
        losses = []
        gen = torch.Generator().manual_seed(0)
        for batch in mlm_batches(8, 16, 64, steps=20):
            batch = {k: v for k, v in batch.items() if k != "mask"}
            st, metrics = step(st, shard_batch(_t(batch), mesh8), gen)
            losses.append(float(metrics["loss"]))
        assert losses[-1] < losses[0], losses


def test_partitioned_bert_step():
    mesh = make_mesh(MeshSpec.of(dp=2, tp=2, sp=2), CPU8)
    cfg = _cfg(dropout=0.0)
    m = _model(cfg)
    ts = create_train_state(m, adamw(1e-2))
    ts = shard_train_state(ts, mesh, bert_rules())

    # params and moments landed with the rule-derived layout
    fc1 = ts.blocks["layers.0.fc1.w"]
    assert fc1.spec == P(None, "tp")
    assert all(p.shape == (16, 16) for p in fc1.pieces)
    assert ts.blocks["layers.0.ln1.scale"].spec == P()

    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, size=(4, 16)).astype(np.int32))
    batch = {"ids": ids, "labels": ids,
             "masked": torch.ones((4, 16), dtype=torch.bool)}
    batch = shard_batch_by_rules(batch, mesh, seq_batch_rules())
    assert batch["ids"].spec == P("dp", "sp")

    step = make_partitioned_train_step(m, None, mlm_loss, mesh=mesh,
                                       rules=bert_rules(),
                                       batch_rules=seq_batch_rules())
    losses = []
    for i in range(5):
        ts, metrics = step(ts, batch, torch.Generator().manual_seed(i))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]      # it learns on the fixed batch
    # the output layout is the input layout: each position holds its
    # blocks of the parameters and of the moments, nothing else
    fc1 = ts.blocks["layers.0.fc1.w"]
    assert fc1.spec == P(None, "tp")
    for i, opt in enumerate(ts.optimizers.pieces):
        mu = opt.state[fc1.pieces[i]]["exp_avg"]
        assert mu.shape == fc1.pieces[i].shape == (16, 16)
        assert {id(p) for g in opt.param_groups for p in g["params"]} == \
            {id(b.pieces[i]) for b in ts.blocks.values()}


@pytest.fixture(scope="module")
def reference_run(request):
    """The JAX package's global steps on the skewed batch: losses and
    parameters (numpy) after three adamw(1e-4) steps of
    make_train_step(mesh=) over (dp=4, tp=2) and of
    make_partitioned_train_step over (2, 2, 2), from the weights the
    port loads."""
    import jax
    import optax
    from jax.sharding import Mesh
    from tosem_tpu.models.bert import Bert as JBert
    from tosem_tpu.models.bert import BertConfig as JConfig
    from tosem_tpu.parallel.sharding import bert_rules as jrules
    from tosem_tpu.parallel.sharding import seq_batch_rules as jbrules
    from tosem_tpu.train import trainer as jt
    devs = request.getfixturevalue("devices8")
    cfg = JConfig(vocab_size=64, max_len=32, dim=16, heads=2, layers=2,
                  mlp_dim=32, dropout=0.0, dtype="float32")
    model = JBert(cfg)
    opt = optax.adamw(1e-4)
    ts0 = jt.create_train_state(model, jax.random.PRNGKey(0), opt)
    init = jax.tree_util.tree_map(np.asarray, ts0["params"])
    batch = {k: jax.numpy.asarray(v) for k, v in _skewed_batch().items()}
    out = {"init": init}
    mesh = Mesh(np.array(devs).reshape(4, 2), ("dp", "tp"))
    step = jt.make_train_step(model, opt, jt.mlm_loss, mesh=mesh,
                              donate=False)
    ts, losses = ts0, []
    for i in range(3):
        ts, met = step(ts, jt.shard_batch(batch, mesh),
                       jax.random.PRNGKey(i))
        losses.append(float(met["loss"]))
    out["dp"] = (losses, jax.tree_util.tree_map(np.asarray, ts["params"]))
    mesh3 = Mesh(np.array(devs).reshape(2, 2, 2), ("dp", "tp", "sp"))
    ts = jt.shard_train_state(
        jt.create_train_state(model, jax.random.PRNGKey(0), opt), mesh3,
        jrules())
    step = jt.make_partitioned_train_step(model, opt, jt.mlm_loss,
                                          mesh=mesh3, rules=jrules(),
                                          batch_rules=jbrules(),
                                          donate=False)
    sb = jt.shard_batch_by_rules(batch, mesh3, jbrules())
    losses = []
    for i in range(3):
        ts, met = step(ts, sb, jax.random.PRNGKey(i))
        losses.append(float(met["loss"]))
    out["dp_tp_sp"] = (losses,
                       jax.tree_util.tree_map(np.asarray, ts["params"]))
    return out


def _port_from(init):
    from tosem_tpu_torch.models.convert import (bert_params_from_numpy,
                                                load_bert_params)
    m = _model(_cfg())
    load_bert_params(m, init)
    return m, bert_params_from_numpy


@pytest.mark.parametrize("kind", ["dp", "dp_tp_sp"])
def test_global_step_matches_reference(reference_run, kind):
    """The port's mesh step against the reference's on the same mesh
    shape, weights and skewed batch: both are the global step."""
    m, convert = _port_from(reference_run["init"])
    losses, params = _run(kind, _cfg(), _t(_skewed_batch()), model=m)
    want_losses, want = reference_run[kind]
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=2e-5)
    _hold(params, convert(want))


def test_mean_of_means_breaks_the_bound(reference_run):
    """The yardstick: the same three steps on the mean of the dp shards'
    means (the loss a per-shard step without the global count computes)
    lands outside the bound the mesh steps hold."""
    m, convert = _port_from(reference_run["init"])
    batch = _t(_skewed_batch())

    def mean_of_means(model, b, generator=None):
        parts = [mlm_loss(model, {k: v[i:i + 2] for k, v in b.items()},
                          generator)[0] for i in range(0, B, 2)]
        return torch.stack(parts).mean(), {}
    st = create_train_state(m, adamw(1e-4))
    step = make_train_step(m, st.optimizer, mean_of_means)
    losses = []
    for _ in range(3):
        st, met = step(st, batch)
        losses.append(float(met["loss"]))
    want_losses, want = reference_run["dp"]
    assert max(abs(a - b) for a, b in zip(losses, want_losses)) > 2e-5
    with pytest.raises(AssertionError):
        _hold(_params(st), convert(want))


@pytest.mark.parametrize("kind", ["one", "one_dp"])
def test_one_position_mesh_is_the_unsharded_step(kind):
    """A mesh of one position computes what the unsharded step computes,
    bit for bit, with dropout 0.1 drawn from the same generators."""
    cfg = _cfg(dropout=0.1)
    batch = _t(_skewed_batch())
    want_losses, want = _run("plain", cfg, batch, gens=True)
    losses, params = _run(kind, cfg, batch, gens=True)
    assert losses == want_losses
    for n in want:
        assert torch.equal(params[n], want[n]), n


@pytest.mark.parametrize("kind", ["dp", "dp_tp_sp"])
def test_dropout_masks_follow_the_global_batch(kind):
    """With dropout 0.1, each position draws the whole batch's masks from
    the step's generator and keeps its rows' (``nn.layers.RowSlice``), so
    the mesh step holds the unsharded step's bound on the same
    generators; and the generator advances as the unsharded step's."""
    cfg = _cfg(dropout=0.1)
    batch = _t(_skewed_batch())
    want_losses, want = _run("plain", cfg, batch, gens=True)
    losses, params = _run(kind, cfg, batch, gens=True)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=2e-5)
    _hold(params, want)
    # a different generator is another run: the bound breaks
    other_losses, _ = _run(kind, cfg, batch, gens=False)
    assert max(abs(a - b) for a, b in zip(other_losses, want_losses)) > 2e-5


def test_generator_advances_as_the_unsharded_step():
    cfg = _cfg(dropout=0.1)
    batch = _t(_skewed_batch())
    after = []
    for kind in ("plain", "dp"):
        m = _model(cfg)
        st = create_train_state(m, adamw(1e-4))
        if kind == "plain":
            step, b = make_train_step(m, st.optimizer, mlm_loss), batch
        else:
            mesh = make_mesh(MeshSpec.of(dp=4), ["cpu"] * 4)
            step = make_train_step(m, st.optimizer, mlm_loss, mesh=mesh)
            b = shard_batch(batch, mesh)
        g = torch.Generator().manual_seed(7)
        step(st, b, g)
        after.append(g.get_state())
    assert torch.equal(after[0], after[1])


def test_rows_that_do_not_split_over_sp_raise():
    mesh = make_mesh(MeshSpec.of(dp=2, tp=2, sp=2), CPU8)
    m = _model(_cfg())
    st = shard_train_state(create_train_state(m, adamw(1e-4)), mesh,
                           bert_rules())
    step = make_partitioned_train_step(m, None, mlm_loss, mesh=mesh,
                                       rules=bert_rules(),
                                       batch_rules=seq_batch_rules())
    b = _t({k: v[:2] for k, v in _skewed_batch().items()})   # 1 row a dp
    with pytest.raises(ValueError, match="do not split"):
        step(st, b)


def test_loss_fn_without_a_count_is_refused():
    mesh = make_mesh(MeshSpec.of(dp=2), ["cpu"] * 2)
    m = _model(_cfg())
    st = create_train_state(m, adamw(1e-4))

    def mean_only(model, b, generator=None, reduce="mean"):
        return mlm_loss(model, b, generator)
    step = make_train_step(m, st.optimizer, mean_only, mesh=mesh)
    with pytest.raises(ValueError, match="count"):
        step(st, _t(_skewed_batch()))


def test_mesh_step_refuses_another_state():
    mesh = make_mesh(MeshSpec.of(dp=2), ["cpu"] * 2)
    m = _model(_cfg())
    st = create_train_state(m, adamw(1e-4))
    step = make_train_step(m, st.optimizer, mlm_loss, mesh=mesh)
    other = create_train_state(_model(_cfg()), adamw(1e-4))
    with pytest.raises(ValueError, match="another model"):
        step(other, _t(_skewed_batch()))


def test_mesh_step_runs_flash_attention():
    """``mlm_loss`` bound to the flash ``attn_fn`` (the chip phase's
    form) takes the flash path inside the positions: its plain version on
    the CPU, within 2e-5 of the dense mesh step."""
    from tosem_tpu_torch.nn.attention import (FLASH_DISPATCH_COUNTS,
                                              flash_attn_fn)
    batch = _t(_skewed_batch())
    mesh = make_mesh(MeshSpec.of(dp=4), ["cpu"] * 4)
    out = []
    for attn in (None, flash_attn_fn()):
        m = _model(_cfg())
        st = create_train_state(m, adamw(1e-4))
        step = make_train_step(m, st.optimizer,
                               functools.partial(mlm_loss, attn_fn=attn),
                               mesh=mesh)
        before = FLASH_DISPATCH_COUNTS["torch"]
        st, met = step(st, shard_batch(batch, mesh))
        out.append((float(met["loss"]), FLASH_DISPATCH_COUNTS["torch"]
                    - before))
    assert out[0][1] == 0 and out[1][1] > 0
    assert abs(out[0][0] - out[1][0]) <= 2e-5
