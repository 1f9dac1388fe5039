"""The port's MoE layer (``tosem_tpu_torch/nn/moe.py``) on the CPU.

The JAX package's ``tests/test_moe.py`` (six cases) against the port,
then the layer held to ``tosem_tpu.nn.moe.MoELayer`` on its own initial
weights and the same seeded numpy tokens: outputs within 2e-5, aux
within rel 1e-5, gradients of every parameter and of the input within
1e-4 of each tensor's largest value (fp32). Ties in the gate resolve to
the lower expert in both packages. Expert parallelism runs over 4 CPU
positions (``ExpertParallelMoE``), held to the unsharded layer within
the reference's rtol 2e-5 / atol 2e-5.
"""
import numpy as np
import pytest
import torch

from tosem_tpu_torch.nn.moe import (ExpertParallelMoE, MoELayer, moe_rules,
                                    route, shard_moe_params)
from tosem_tpu_torch.parallel.mesh import default_mesh

torch.set_num_threads(1)

D = 8
TOL = 2e-5
GRAD_TOL = 1e-4


def _layer(**kw):
    return MoELayer(D, 4, hidden=16, generator=torch.Generator()
                    .manual_seed(0), **kw)


def _randn(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


@pytest.fixture
def ep_mesh():
    return default_mesh("ep", ["cpu"] * 4)


class TestRouting:
    def test_output_shape_and_aux(self):
        layer = _layer()
        y, aux = layer(_randn(1, 24, D))
        assert y.shape == (24, D)
        # E·Σf·p is 1 at uniform routing, permille noise below it at 24
        # tokens (the reference's bound)
        assert float(aux.detach()) >= 1.0 - 0.01

    def test_manual_two_token_routing(self):
        layer = _layer(k=1, capacity_factor=4.0)
        x = torch.eye(2, D)
        with torch.no_grad():
            layer.gate.fill_(-10.0)
            layer.gate[0, 0] = 10.0
            layer.gate[1, 2] = 10.0
        y, _ = layer(x)

        def expert(e, t):
            h = torch.nn.functional.gelu(x[t] @ layer.w1[e] + layer.b1[e],
                                         approximate="tanh")
            return h @ layer.w2[e] + layer.b2[e]
        torch.testing.assert_close(y[0], expert(0, 0), rtol=1e-5, atol=0)
        torch.testing.assert_close(y[1], expert(2, 1), rtol=1e-5, atol=0)

    def test_capacity_drops_overflow_deterministically(self):
        layer = _layer(k=1, capacity_factor=1.0)     # C = 1·8/4 = 2
        x = _randn(2, 8, D).abs() + 0.1
        with torch.no_grad():
            layer.gate.zero_()
            layer.gate[:, 0] = 5.0
        y, _ = layer(x)
        assert layer.capacity(8) == 2
        dropped = route(x, layer.gate, 1, 1.0)[3]
        norms = y.detach().norm(dim=1)
        assert norms[0] > 1e-4 and norms[1] > 1e-4
        assert torch.all(norms[2:] < 1e-6)
        assert int(dropped) == 6

    def test_grads_reach_gate_and_experts(self):
        layer = _layer()
        y, aux = layer(_randn(3, 16, D))
        (torch.mean(y ** 2) + 0.01 * aux).backward()
        for name in ("gate", "w1", "w2"):
            assert float(getattr(layer, name).grad.abs().sum()) > 0, name


def _pair(seed=0, k=2, capacity_factor=1.25, tie=False):
    """The reference layer's initial weights in both packages."""
    import jax
    import jax.numpy as jnp
    from tosem_tpu.nn.moe import MoELayer as JMoE
    jl = JMoE(D, 4, hidden=16, k=k, capacity_factor=capacity_factor)
    vs = jl.init(jax.random.key(seed))
    if tie:
        # experts 1, 2 and 3 score alike for every token, so which two
        # a token keeps is decided by the order of ties alone
        g = np.asarray(vs["params"]["gate"]).copy()
        g[:, 2] = g[:, 1]
        g[:, 3] = g[:, 1]
        vs["params"]["gate"] = jnp.asarray(g)
    pl = MoELayer(D, 4, hidden=16, k=k, capacity_factor=capacity_factor)
    pl.load_state_dict({n: torch.from_numpy(np.asarray(v).copy())
                        for n, v in vs["params"].items()})
    return jl, vs, pl


def _ref_loss_grads(jl, vs, x, yt):
    import jax
    import jax.numpy as jnp

    def loss(params, x):
        (y, aux), _ = jl.apply({"params": params, "state": {}}, x)
        return jnp.mean((y - yt) ** 2) + 0.01 * aux, (y, aux)
    (_, (y, aux)), (g, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(vs["params"], jnp.asarray(x))
    return np.asarray(y), float(aux), {n: np.asarray(v) for n, v in
                                       g.items()}, np.asarray(gx)


def _port_loss_grads(run, params, x, yt):
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = run(xt)
    loss = torch.mean((y - torch.from_numpy(yt)) ** 2) + 0.01 * aux
    grads = torch.autograd.grad(loss, [xt] + list(params))
    return y.detach().numpy(), float(aux), grads


def _gap(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("k,factor,tie", [(2, 1.25, False), (1, 1.0, False),
                                          (2, 0.5, False), (2, 1.25, True)])
def test_layer_and_grads_match_the_reference(k, factor, tie):
    jl, vs, pl = _pair(seed=7, k=k, capacity_factor=factor, tie=tie)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(32, D)).astype(np.float32)
    yt = (0.3 * rng.normal(size=(32, D))).astype(np.float32)
    y_ref, aux_ref, g_ref, gx_ref = _ref_loss_grads(jl, vs, x, yt)
    names = ["gate", "w1", "b1", "w2", "b2"]
    y, aux, grads = _port_loss_grads(
        pl, [getattr(pl, n) for n in names], x, yt)
    np.testing.assert_allclose(y, y_ref, rtol=TOL, atol=TOL)
    assert aux == pytest.approx(aux_ref, rel=1e-5)
    assert _gap(grads[0], gx_ref) <= GRAD_TOL
    for n, g in zip(names, grads[1:]):
        assert _gap(g, g_ref[n]) <= GRAD_TOL, n


def test_tied_gate_picks_the_lower_experts():
    """Three experts tie for every token: both packages keep the lowest
    two, in index order, and so route each token to the same pair."""
    jl, vs, pl = _pair(seed=3, tie=True)
    with torch.no_grad():
        pl.gate[:, 0] = -50.0          # the tie decides both choices
    x = torch.from_numpy(np.abs(np.random.default_rng(4).normal(
        size=(16, D))).astype(np.float32))
    dispatch, _, _, _ = route(x, pl.gate, 2, 4.0)
    per_expert = dispatch.sum((0, 2))
    assert per_expert.tolist() == [0.0, 16.0, 16.0, 0.0]


def test_sharded_matches_unsharded(ep_mesh):
    layer = _layer()
    x = _randn(4, 32, D)
    want, aux_w = layer(x)
    sharded = shard_moe_params({n: p.detach() for n, p in
                                layer.named_parameters()}, ep_mesh)
    assert sharded["w1"].spec[0] == "ep"
    assert sharded["w1"].pieces[0].shape == (1, D, 16)
    ep = ExpertParallelMoE(layer, ep_mesh)
    got, aux_g = ep(x)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert float(aux_g) == pytest.approx(float(aux_w), rel=1e-5)


def test_sharded_gradients_match_unsharded(ep_mesh):
    layer = _layer()
    x = _randn(5, 32, D).requires_grad_(True)
    yt = _randn(6, 32, D) * 0.3

    def loss(run):
        y, aux = run(x)
        return torch.mean((y - yt) ** 2) + 0.01 * aux
    names = ["gate", "w1", "b1", "w2", "b2"]
    want = torch.autograd.grad(loss(layer), [x] + [getattr(layer, n)
                                                   for n in names])
    ep = ExpertParallelMoE(layer, ep_mesh)
    got = torch.autograd.grad(loss(ep), [x, ep.gate] + list(ep._pieces))
    assert _gap(got[0], want[0]) <= GRAD_TOL
    assert _gap(got[1], want[1]) <= GRAD_TOL
    pieces = got[2:]
    for i, n in enumerate(names[1:]):
        g = torch.cat(pieces[4 * i:4 * i + 4])
        assert _gap(g, want[2 + i]) <= GRAD_TOL, n


def test_ep_training_step(ep_mesh):
    layer = _layer()
    ep = ExpertParallelMoE(layer, ep_mesh)
    x = _randn(5, 32, D)
    y_t = _randn(6, 32, D) * 0.3
    opt = torch.optim.SGD(ep.parameters(), lr=0.1)
    losses = []
    for _ in range(40):
        y, aux = ep(x)
        loss = torch.mean((y - y_t) ** 2) + 0.01 * aux
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < 0.7 * losses[0]
    # the expert stacks stay cut over ep through the updates
    w1 = ep.blocks["w1"]
    assert w1.spec[0] == "ep" and len(w1.pieces) == 4
    assert all(p.shape == (1, D, 16) for p in w1.pieces)
    assert not torch.equal(ep.gather()["w1"], layer.w1.detach())


def test_moe_rules_specs():
    rules = moe_rules("ep")
    assert rules["w1"][0] == "ep" and rules["b2"][0] == "ep"
    assert tuple(rules["gate"]) == ()


def test_k_above_experts_raises():
    with pytest.raises(ValueError, match="exceeds"):
        MoELayer(D, 2, k=3)
