"""The port's GPipe pipeline (``tosem_tpu_torch/parallel/pipeline.py``)
and pipelined BERT (``models/bert_pipeline.py``): the JAX package's
``tests/test_pipeline.py`` and ``tests/test_bert_pipeline.py`` run
against the port, with the packages held against each other on the same
seeded numpy inputs.

The reference runs on ``conftest.py``'s virtual CPU devices, the port on
4 CPU positions. Forward outputs are held at the reference's fp32 limit
(2e-5), gradients at its limits (rtol 1e-4, atol 1e-5; BERT's 1e-4 /
1e-6), in both packages and across them. The port's gradient is its
``autograd.Function`` (one ``shard_map`` running the reverse schedule),
the reference's ``jax.grad`` of its scan.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tosem_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from tosem_tpu_torch.parallel.pipeline import (make_pipeline_fn, microbatch,
                                               stack_stage_params,
                                               unmicrobatch)

torch.set_num_threads(1)

D = 8
FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def stage_fn(p, x):
    return torch.relu(x @ p["w"] + p["b"])


def _params_np(seed, n_stages=4):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((D, D)) * 0.4).astype(np.float32),
             "b": np.zeros(D, np.float32)} for _ in range(n_stages)]


def _t(per_stage, grad=False):
    return [{k: torch.from_numpy(v.copy()).requires_grad_(grad)
             for k, v in p.items()} for p in per_stage]


def _sequential(per_stage, x):
    for p in per_stage:
        x = stage_fn(p, x)
    return x


@pytest.fixture
def pp_mesh():
    return make_mesh(MeshSpec.of(pp=4), ["cpu"] * 4)


def _jax_pipeline(devices8, per_stage_np, x_np, n_micro):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from tosem_tpu.parallel import pipeline as jp
    mesh = Mesh(np.array(devices8[:4]), ("pp",))

    def jstage(p, x):
        return jax.nn.relu(x @ p["w"] + p["b"])
    stacked = jp.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in per_stage_np])
    return jstage, jp.make_pipeline_fn(jstage, mesh, n_micro=n_micro), \
        stacked, jnp.asarray(x_np)


class TestPipeline:
    @pytest.mark.parametrize("n_micro", [1, 2, 8])
    def test_matches_sequential(self, pp_mesh, devices8, n_micro):
        per_np = _params_np(0)
        x_np = np.random.default_rng(1).standard_normal(
            (16, D)).astype(np.float32)
        per = _t(per_np)
        x = torch.from_numpy(x_np)
        want = _sequential(per, x)
        fwd = make_pipeline_fn(stage_fn, pp_mesh, n_micro=n_micro)
        with torch.no_grad():
            got = unmicrobatch(fwd(stack_stage_params(per),
                                   microbatch(x, n_micro)))
        np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)
        # the reference's pipeline on the same inputs
        from tosem_tpu.parallel.pipeline import microbatch as jmb
        from tosem_tpu.parallel.pipeline import unmicrobatch as jumb
        _, jfwd, jstacked, jx = _jax_pipeline(devices8, per_np, x_np,
                                              n_micro)
        ref = np.asarray(jumb(jfwd(jstacked, jmb(jx, n_micro))))
        np.testing.assert_allclose(got.numpy(), ref, **FWD)

    def test_jit_and_grads_match_sequential(self, pp_mesh, devices8):
        per_np = _params_np(2)
        rng = np.random.default_rng(3)
        x_np = rng.standard_normal((8, D)).astype(np.float32)
        y_np = rng.standard_normal((8, D)).astype(np.float32)
        x, y = torch.from_numpy(x_np), torch.from_numpy(y_np)
        fwd = make_pipeline_fn(stage_fn, pp_mesh, n_micro=4)

        stacked = {k: v.detach().requires_grad_()
                   for k, v in stack_stage_params(_t(per_np)).items()}
        xg = x.clone().requires_grad_()
        out = unmicrobatch(fwd(stacked, microbatch(xg, 4)))
        ((out - y) ** 2).mean().backward()

        per = _t(per_np, grad=True)
        xs = x.clone().requires_grad_()
        ((_sequential(per, xs) - y) ** 2).mean().backward()
        for s in range(4):
            np.testing.assert_allclose(stacked["w"].grad[s].numpy(),
                                       per[s]["w"].grad.numpy(), **GRAD)
            np.testing.assert_allclose(stacked["b"].grad[s].numpy(),
                                       per[s]["b"].grad.numpy(), **GRAD)
        np.testing.assert_allclose(xg.grad.numpy(), xs.grad.numpy(), **GRAD)

        # against jax.grad of the reference's pipeline
        import jax
        import jax.numpy as jnp
        from tosem_tpu.parallel.pipeline import microbatch as jmb
        from tosem_tpu.parallel.pipeline import unmicrobatch as jumb
        _, jfwd, jstacked, jx = _jax_pipeline(devices8, per_np, x_np, 4)

        def loss(p, xx):
            o = jumb(jfwd(p, jmb(xx, 4)))
            return jnp.mean((o - jnp.asarray(y_np)) ** 2)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jstacked, jx)
        for k in ("w", "b"):
            np.testing.assert_allclose(stacked[k].grad.numpy(),
                                       np.asarray(gp[k]), **GRAD)
        np.testing.assert_allclose(xg.grad.numpy(), np.asarray(gx), **GRAD)

    def test_pipelined_training_step(self, pp_mesh):
        per_np = _params_np(5)
        x = torch.from_numpy(np.random.default_rng(6).standard_normal(
            (16, D)).astype(np.float32))
        # realizable target: another pipeline net's output (loss -> ~0)
        with torch.no_grad():
            y = _sequential(_t(_params_np(7)), x)
        fwd = make_pipeline_fn(stage_fn, pp_mesh, n_micro=8)
        p = {k: v.detach() for k, v in stack_stage_params(
            _t(per_np)).items()}
        losses = []
        for _ in range(100):
            p = {k: v.detach().requires_grad_() for k, v in p.items()}
            loss = ((unmicrobatch(fwd(p, microbatch(x, 8))) - y) ** 2
                    ).mean()
            loss.backward()
            p = {k: v.detach() - 0.05 * v.grad for k, v in p.items()}
            losses.append(float(loss.detach()))
        assert losses[-1] < 0.75 * losses[0], (losses[0], losses[-1])
        assert losses[-1] == min(losses)

    def test_microbatch_count_mismatch_rejected(self, pp_mesh):
        stacked = stack_stage_params(_t(_params_np(8)))
        fwd = make_pipeline_fn(stage_fn, pp_mesh, n_micro=4)
        x = torch.zeros(16, D)
        with pytest.raises(ValueError, match="microbatches"):
            fwd(stacked, microbatch(x, 8))    # 8 fed, built for 4

    def test_microbatch_helpers(self):
        x = torch.arange(24.0).reshape(12, 2)
        mb = microbatch(x, 4)
        assert mb.shape == (4, 3, 2)
        assert torch.equal(unmicrobatch(mb), x)
        with pytest.raises(ValueError):
            microbatch(x, 5)


# ------------------------------------------------------------ BERT


def _jax_bert(layers=4, dtype="float32", seed=1):
    import jax
    from tosem_tpu.models import Bert as JBert
    from tosem_tpu.models import BertConfig as JConfig
    cfg = dataclasses.replace(JConfig.tiny(), layers=layers, dropout=0.0,
                              dtype=dtype)
    model = JBert(cfg)
    return model, model.init(jax.random.PRNGKey(seed))


def _port_bert(jvs, layers=4, dtype="float32"):
    import jax
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.models.convert import load_bert_params
    cfg = dataclasses.replace(BertConfig.tiny(), layers=layers, dropout=0.0,
                              dtype=dtype)
    m = Bert(cfg, device="cpu")
    load_bert_params(m, jax.tree_util.tree_map(np.asarray, jvs["params"]))
    return m


def _ids():
    return (np.arange(64, dtype=np.int32).reshape(4, 16) * 7) % 100 + 2


def test_stack_layer_params_shapes():
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.models.bert_pipeline import stack_layer_params
    cfg = dataclasses.replace(BertConfig.tiny(), layers=4)
    params = dict(Bert(cfg, device="cpu").named_parameters())
    stacked = stack_layer_params(params, 4, 2)
    assert stacked["fc1.w"].shape == (2, 2, cfg.dim, cfg.mlp_dim)
    assert torch.equal(stacked["fc1.w"][1, 0], params["layers.2.fc1.w"])
    with pytest.raises(ValueError):
        stack_layer_params(params, 4, 3)


def test_moe_config_rejected(pp_mesh):
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.models.bert_pipeline import make_bert_pipeline_fn
    model = Bert(BertConfig.tiny(), device="cpu")
    # the port builds no MoE layer (A13): a config that asks for experts
    # is refused by the pipeline before any layer is touched
    model.cfg = dataclasses.replace(model.cfg, moe_experts=4)
    with pytest.raises(ValueError, match="homogeneous"):
        make_bert_pipeline_fn(model, pp_mesh, n_micro=2)


def test_pipelined_forward_matches_sequential(devices8):
    import jax
    from jax.sharding import Mesh
    from tosem_tpu.models.bert_pipeline import \
        make_bert_pipeline_fn as jpipe
    from tosem_tpu_torch.models.bert_pipeline import make_bert_pipeline_fn
    mesh = make_mesh(MeshSpec.of(pp=2), ["cpu"] * 2)
    jmesh = Mesh(np.array(devices8[:2]), ("pp",))
    ids = torch.from_numpy(_ids())
    # bf16: the reference's limits (mean 0.02, max 0.25) against the
    # port's sequential model; microbatching changes no row's layer math
    jm, jvs = _jax_bert(dtype="bfloat16", seed=0)
    m = _port_bert(jvs, dtype="bfloat16")
    with torch.no_grad():
        want = m.apply(ids)
        got = make_bert_pipeline_fn(m, mesh, n_micro=2)(None, ids)
    diff = (got.float() - want.float()).abs()
    assert float(diff.mean()) < 0.02 and float(diff.max()) < 0.25
    # fp32: 2e-5 against the port's sequential model and the reference's
    # pipeline on the same weights
    jm32, jvs32 = _jax_bert()
    m32 = _port_bert(jvs32)
    with torch.no_grad():
        want32 = m32.apply(ids)
        got32 = make_bert_pipeline_fn(m32, mesh, n_micro=2)(None, ids)
    np.testing.assert_allclose(got32.numpy(), want32.numpy(), **FWD)
    ref32 = np.asarray(jpipe(jm32, jmesh, n_micro=2)(
        jvs32["params"], jax.numpy.asarray(_ids())))
    np.testing.assert_allclose(got32.numpy(), ref32, **FWD)


def test_pipelined_mlm_grads_flow(devices8):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from tosem_tpu.models.bert_pipeline import \
        make_bert_pipeline_fn as jpipe
    from tosem_tpu_torch.models.bert_pipeline import make_bert_pipeline_fn
    mesh = make_mesh(MeshSpec.of(pp=4), ["cpu"] * 4)
    jmesh = Mesh(np.array(devices8[:4]), ("pp",))
    ids_np = _ids()
    ids = torch.from_numpy(ids_np)
    jm, jvs = _jax_bert()
    m = _port_bert(jvs)
    fwd = make_bert_pipeline_fn(m, mesh, n_micro=2)

    def loss_of(h):
        logp = torch.log_softmax(m.mlm_logits(h), -1)
        return -logp.gather(-1, ids.long()[..., None]).mean()
    loss_of(fwd(None, ids)).backward()
    g = {n: p.grad.clone() for n, p in m.named_parameters()
         if p.grad is not None}
    for i in range(4):
        assert float(g[f"layers.{i}.fc1.w"].abs().sum()) > 0, i
    # the port's sequential model, and jax.grad of the reference's
    # pipeline, on a spot-checked layer and the embeddings
    m.zero_grad()
    loss_of(m.apply(ids)).backward()
    jfwd = jpipe(jm, jmesh, n_micro=2)

    def jloss(params):
        h = jfwd(params, jnp.asarray(ids_np))
        logp = jax.nn.log_softmax(jm.mlm_logits({"params": params}, h))
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(ids_np)[
            ..., None], -1))
    jg = jax.jit(jax.grad(jloss))(jvs["params"])
    tol = dict(rtol=1e-4, atol=1e-6)
    params = dict(m.named_parameters())
    for name, jname in (("layers.2.fc1.w", ("layer2", "fc1", "w")),
                        ("layers.0.attn.q.w", ("layer0", "attn", "q", "w")),
                        ("tok.table", ("tok", "table"))):
        np.testing.assert_allclose(g[name].numpy(),
                                   params[name].grad.numpy(), **tol)
        ref = jg
        for k in jname:
            ref = ref[k]
        np.testing.assert_allclose(g[name].numpy(), np.asarray(ref), **tol)
