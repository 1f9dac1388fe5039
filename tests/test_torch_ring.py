"""The port's ring and Ulysses attention (``tosem_tpu_torch/parallel/
ring.py``): the JAX package's ``tests/test_ring.py`` run against the
port, plus the packages held against each other.

The reference runs on ``conftest.py``'s 8 virtual CPU devices, the port
on 8 CPU positions; both get the same seeded numpy inputs. Outputs are
held at the reference's fp32 limits (2e-5; gradients 5e-4 / 5e-3).
"""
import numpy as np
import pytest
import torch

from tosem_tpu_torch.nn.attention import dot_product_attention
from tosem_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from tosem_tpu_torch.parallel.ring import (make_ring_attn_fn,
                                           make_ulysses_attn_fn,
                                           ring_attention, ulysses_attention)
from tosem_tpu_torch.parallel.spmd import P, shard_map

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


def _qkv(B=2, T=64, H=4, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(3)]


def _t(arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _causal_mask(T):
    return torch.tril(torch.ones((T, T), dtype=torch.bool))[None, None]


@pytest.fixture
def sp_mesh_t():
    return make_mesh(MeshSpec.of(sp=8), CPU8)


@pytest.fixture
def dp_sp_tp_mesh_t():
    return make_mesh(MeshSpec.of(dp=2, sp=2, tp=2), CPU8)


def _jax_fn(make, mesh, arrays, grads=False, **kw):
    """The reference's attn_fn over its mesh on ``arrays``: output, and
    the gradients of sum(out ** 2) when ``grads``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    fn = make(mesh, **kw)
    names = mesh.axis_names
    spec = PartitionSpec("dp" if "dp" in names else None, "sp",
                         "tp" if "tp" in names else None, None)
    xs = [jax.device_put(a, NamedSharding(mesh, spec)) for a in arrays]
    out = np.asarray(jax.jit(fn)(*xs))
    if not grads:
        return out
    g = jax.jit(jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) ** 2),
                         (0, 1, 2)))(*xs)
    return out, [np.asarray(x) for x in g]


class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_reference_sp8(self, sp_mesh_t, causal):
        arrays = _qkv()
        q, k, v = _t(arrays)
        fn = make_ring_attn_fn(sp_mesh_t, sp="sp", dp=None, tp=None,
                               causal=causal)
        out = fn(q, k, v)
        mask = _causal_mask(q.shape[1]) if causal else None
        ref = dot_product_attention(q, k, v, mask, precision="float32")
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5,
                                   rtol=2e-5)

    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_the_reference_s_ring(self, sp_mesh_t, mesh1d, causal):
        from jax.sharding import Mesh
        from tosem_tpu.parallel.ring import make_ring_attn_fn as jmake
        arrays = _qkv(seed=1)
        jmesh = Mesh(np.asarray(mesh1d.devices), ("sp",))
        want = _jax_fn(jmake, jmesh, arrays, dp=None, tp=None, causal=causal)
        out = make_ring_attn_fn(sp_mesh_t, dp=None, tp=None,
                                causal=causal)(*_t(arrays))
        np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)

    def test_full_mesh_dp_sp_tp(self, dp_sp_tp_mesh_t):
        q, k, v = _t(_qkv(B=2, T=32, H=4, D=8))
        out = make_ring_attn_fn(dp_sp_tp_mesh_t, causal=True)(q, k, v)
        ref = dot_product_attention(q, k, v, _causal_mask(32),
                                    precision="float32")
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5,
                                   rtol=2e-5)

    @pytest.mark.parametrize("causal", [False, True])
    def test_grads_flow(self, sp_mesh_t, causal):
        q, k, v = _t(_qkv(B=1, T=32, H=2, D=8), grad=True)
        fn = make_ring_attn_fn(sp_mesh_t, dp=None, tp=None, causal=causal)
        g_ring = torch.autograd.grad((fn(q, k, v) ** 2).sum(), (q, k, v))
        mask = _causal_mask(32) if causal else None
        g_ref = torch.autograd.grad((dot_product_attention(
            q, k, v, mask, precision="float32") ** 2).sum(), (q, k, v))
        for a, b, name in zip(g_ring, g_ref, "qkv"):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4,
                                       rtol=5e-3, err_msg=name)

    def test_grads_match_the_reference_s(self, dp_sp_tp_mesh_t, devices8):
        from jax.sharding import Mesh
        from tosem_tpu.parallel.ring import make_ring_attn_fn as jmake
        arrays = _qkv(B=2, T=32, H=2, D=8, seed=4)
        jmesh = Mesh(np.array(devices8).reshape(2, 2, 2), ("dp", "sp", "tp"))
        _, want = _jax_fn(jmake, jmesh, arrays, grads=True, causal=True)
        q, k, v = _t(arrays, grad=True)
        out = make_ring_attn_fn(dp_sp_tp_mesh_t, causal=True)(q, k, v)
        got = torch.autograd.grad((out ** 2).sum(), (q, k, v))
        for a, b, name in zip(got, want, "qkv"):
            np.testing.assert_allclose(a.numpy(), b, atol=5e-4, rtol=5e-3,
                                       err_msg=name)

    def test_rejects_padding_mask(self, sp_mesh_t):
        q, k, v = _t(_qkv(T=16))
        fn = make_ring_attn_fn(sp_mesh_t, dp=None, tp=None)
        with pytest.raises(ValueError):
            fn(q, k, v, mask=torch.ones((2, 1, 1, 16), dtype=torch.bool))

    def test_core_inside_a_body(self, sp_mesh_t):
        q, k, v = _t(_qkv(T=64))
        spec = P(None, "sp", None, None)
        out = shard_map(lambda a, b, c: ring_attention(a, b, c, axis="sp",
                                                       causal=True),
                        sp_mesh_t, (spec,) * 3, spec)(q, k, v)
        ref = dot_product_attention(q, k, v, _causal_mask(64),
                                    precision="float32")
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5,
                                   rtol=2e-5)


class TestUlysses:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_reference(self, sp_mesh_t, causal):
        q, k, v = _t(_qkv(B=2, T=64, H=8, D=16))  # H divisible by sp=8
        fn = make_ulysses_attn_fn(sp_mesh_t, dp=None, tp=None, causal=causal)
        out = fn(q, k, v)
        mask = _causal_mask(64) if causal else None
        ref = dot_product_attention(q, k, v, mask, precision="float32")
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5,
                                   rtol=2e-5)

    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_the_reference_s_ulysses(self, sp_mesh_t, mesh1d,
                                             causal):
        from jax.sharding import Mesh
        from tosem_tpu.parallel.ring import make_ulysses_attn_fn as jmake
        arrays = _qkv(B=2, T=64, H=8, D=16, seed=2)
        jmesh = Mesh(np.asarray(mesh1d.devices), ("sp",))
        want = _jax_fn(jmake, jmesh, arrays, dp=None, tp=None, causal=causal)
        out = make_ulysses_attn_fn(sp_mesh_t, dp=None, tp=None,
                                   causal=causal)(*_t(arrays))
        np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)

    @pytest.mark.parametrize("causal", [False, True])
    def test_grads_flow(self, dp_sp_tp_mesh_t, causal):
        q, k, v = _t(_qkv(B=2, T=32, H=4, D=8, seed=3), grad=True)
        fn = make_ulysses_attn_fn(dp_sp_tp_mesh_t, causal=causal)
        g = torch.autograd.grad((fn(q, k, v) ** 2).sum(), (q, k, v))
        mask = _causal_mask(32) if causal else None
        w = torch.autograd.grad((dot_product_attention(
            q, k, v, mask, precision="float32") ** 2).sum(), (q, k, v))
        for a, b, name in zip(g, w, "qkv"):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4,
                                       rtol=5e-3, err_msg=name)

    def test_heads_must_divide(self, sp_mesh_t):
        q, k, v = _t(_qkv(T=64, H=4))
        with pytest.raises(ValueError, match="heads"):
            make_ulysses_attn_fn(sp_mesh_t, dp=None, tp=None)(q, k, v)
        with pytest.raises(ValueError):
            make_ulysses_attn_fn(sp_mesh_t, dp=None, tp=None)(
                q, k, v, mask=torch.ones(1, 1, 1, 64, dtype=torch.bool))

    def test_core_inside_a_body(self, sp_mesh_t):
        q, k, v = _t(_qkv(T=64, H=8))
        spec = P(None, "sp", None, None)
        out = shard_map(lambda a, b, c: ulysses_attention(a, b, c, axis="sp"),
                        sp_mesh_t, (spec,) * 3, spec)(q, k, v)
        ref = dot_product_attention(q, k, v, None, precision="float32")
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5,
                                   rtol=2e-5)


def test_no_graph_crosses_a_collective(sp_mesh_t):
    """A body that feeds a tensor that requires grad into a collective is
    refused: on a GPU the positions' backwards would meet on one
    thread."""
    from tosem_tpu_torch.parallel.spmd import psum
    x = torch.ones(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        shard_map(lambda a: psum(a * 2, "sp"), sp_mesh_t, P("sp"), P())(x)


def _tiny_cfg(T):
    from tosem_tpu_torch.models.bert import BertConfig
    return BertConfig(vocab_size=64, max_len=T, dim=16, heads=2, layers=2,
                      mlp_dim=32, dropout=0.0, dtype="float32")


class TestBertWithRing:
    def test_bert_forward_ring_vs_xla(self, dp_sp_tp_mesh_t):
        """BERT encoder with ring attention as attn_fn matches the plain
        path."""
        from tosem_tpu_torch.models.bert import Bert
        model = Bert(_tiny_cfg(32), device="cpu")
        ids = torch.from_numpy(np.random.default_rng(1).integers(
            0, 64, (4, 32)))
        with torch.no_grad():
            ref = model.apply(ids)
            out = model.apply(ids, attn_fn=make_ring_attn_fn(
                dp_sp_tp_mesh_t))
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4,
                                   rtol=1e-4)

    def test_bert_ring_forward_matches_the_reference_s(self, devices8):
        """Both packages' BERT with ring attention, the reference's
        weights carried across: within the reference's 1e-4."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh
        from tosem_tpu.models.bert import Bert as JBert
        from tosem_tpu.models.bert import BertConfig as JConfig
        from tosem_tpu.parallel.ring import make_ring_attn_fn as jmake
        from tosem_tpu_torch.models.bert import Bert
        from tosem_tpu_torch.models.convert import load_bert_params
        jcfg = JConfig(vocab_size=64, max_len=32, dim=16, heads=2, layers=2,
                       mlp_dim=32, dropout=0.0, dtype="float32")
        jmodel = JBert(jcfg)
        vs = jmodel.init(jax.random.PRNGKey(0))
        ids = np.random.default_rng(2).integers(0, 64, (4, 32)).astype(
            np.int32)
        jmesh = Mesh(np.array(devices8).reshape(2, 2, 2), ("dp", "sp", "tp"))
        want, _ = jax.jit(lambda v_, i_: jmodel.apply(
            v_, i_, attn_fn=jmake(jmesh)))(vs, jnp.asarray(ids))
        model = Bert(_tiny_cfg(32), device="cpu")
        load_bert_params(model, jax.tree_util.tree_map(np.asarray,
                                                       vs["params"]))
        mesh = make_mesh(MeshSpec.of(dp=2, sp=2, tp=2), CPU8)
        with torch.no_grad():
            out = model.apply(torch.from_numpy(ids),
                              attn_fn=make_ring_attn_fn(mesh))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)

    def test_bert_long_context_ring_plus_remat_backward(self,
                                                        dp_sp_tp_mesh_t):
        """Sequence parallelism (ring attention over sp) x activation
        remat in one backward pass: loss and gradients match the
        unsharded, non-remat graph."""
        from dataclasses import replace
        from tosem_tpu_torch.models.bert import Bert
        from tosem_tpu_torch.train.trainer import cross_entropy_loss
        T = 256
        cfg = _tiny_cfg(T)
        ids = torch.from_numpy(np.random.default_rng(1).integers(
            0, 64, (4, T)))

        def loss_grads(model, attn_fn):
            model.zero_grad(set_to_none=True)
            enc = model.apply(ids, attn_fn=attn_fn)
            loss = cross_entropy_loss(model.mlm_logits(enc), ids)
            loss.backward()
            return loss.item(), {n: p.grad.clone()
                                 for n, p in model.named_parameters()
                                 if p.grad is not None}

        l_ref, g_ref = loss_grads(Bert(cfg, device="cpu"), None)
        l_sp, g_sp = loss_grads(Bert(replace(cfg, remat="full"),
                                     device="cpu"),
                                make_ring_attn_fn(dp_sp_tp_mesh_t))
        assert abs(l_ref - l_sp) < 1e-5
        assert sorted(g_ref) == sorted(g_sp)
        for n in g_ref:
            np.testing.assert_allclose(g_sp[n].numpy(), g_ref[n].numpy(),
                                       atol=2e-4, rtol=2e-4, err_msg=n)
