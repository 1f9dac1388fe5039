"""The port's fused layernorm and softmax (their plain ``torch`` arms, on
the CPU) held against the JAX package's ``fused_layernorm`` and
``fused_softmax``, whose Pallas kernels run in interpret mode here, as
``tests/test_pallas_kernels.py`` runs them. The same numpy inputs from a
seed go through both. Tolerances are the reference's own
(``tests/test_pallas_kernels.py:162-210``): layernorm 1e-5 forward and
1e-4 gradients, softmax atol 1e-6 / rtol 1e-5 forward and atol 1e-5 /
rtol 1e-4 gradients in fp32; 2e-2 in bf16."""
import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

LN_FWD = {"float32": dict(atol=1e-5, rtol=1e-5),
          "bfloat16": dict(atol=2e-2, rtol=2e-2)}
LN_GRAD = {"float32": dict(atol=1e-4, rtol=1e-4),
           "bfloat16": dict(atol=2e-2, rtol=2e-2)}
SM_FWD = {"float32": dict(atol=1e-6, rtol=1e-5),
          "bfloat16": dict(atol=2e-2, rtol=2e-2)}
SM_GRAD = {"float32": dict(atol=1e-5, rtol=1e-4),
           "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# 256 rows in a 3-D input; a row count no 256-row block divides; an odd
# width; a wide one
LN_SHAPES = [(4, 64, 96), (200, 96), (64, 77), (24, 1000)]
SM_SHAPES = [(4, 16, 128), (200, 96), (64, 77), (8, 1000)]


def _ref():
    return importlib.import_module("tosem_tpu.ops.fused_norms")


def _port():
    return importlib.import_module("tosem_tpu_torch.ops.fused_norms")


def _ln_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(D).astype(np.float32)
    b = rng.standard_normal(D).astype(np.float32)
    return x, g, b


def _jnp(a, dtype):
    import jax.numpy as jnp
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LN_SHAPES)
def test_layernorm_forward_and_statistics_match_reference(shape, dtype):
    x, g, b = _ln_inputs(shape)
    D = shape[-1]
    jx, jg, jb = (_jnp(a, dtype) for a in (x, g, b))
    ref_out = _ref().fused_layernorm(jx, jg, jb)
    _, ref_mu, ref_rstd = _ref()._ln_fwd(jx.reshape(-1, D), jg, jb, 1e-6)
    tdt = getattr(torch, dtype)
    tx, tg, tb = (torch.from_numpy(a).to(tdt) for a in (x, g, b))
    out = _port().fused_layernorm(tx, tg, tb)
    assert out.dtype == tdt and out.shape == tx.shape
    np.testing.assert_allclose(_np(out), _np(ref_out), **LN_FWD[dtype])
    _, mu, rstd = _port()._ln_fwd_torch(tx.reshape(-1, D), tg, tb, 1e-6)
    assert mu.dtype == rstd.dtype == torch.float32
    assert mu.shape == rstd.shape == (x.size // D, 1)
    np.testing.assert_allclose(_np(mu), _np(ref_mu), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(rstd), _np(ref_rstd), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LN_SHAPES)
def test_layernorm_grads_match_reference(shape, dtype):
    import jax
    import jax.numpy as jnp
    x, g, b = _ln_inputs(shape, seed=1)
    loss = lambda *a: jnp.sum(
        _ref().fused_layernorm(*a).astype(jnp.float32) ** 2)
    want = jax.grad(loss, (0, 1, 2))(*(_jnp(a, dtype) for a in (x, g, b)))
    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, g, b)]
    (_port().fused_layernorm(*ts).float() ** 2).sum().backward()
    for t, w, name in zip(ts, want, ("dx", "dgamma", "dbeta")):
        assert t.grad.dtype == tdt
        np.testing.assert_allclose(_np(t.grad), _np(w), err_msg=name,
                                   **LN_GRAD[dtype])


def test_layernorm_grads_take_gammas_dtype():
    """bf16 x with fp32 gamma/beta: dx in bf16, dgamma/dbeta in fp32,
    as the reference casts them (``fused_norms.py:133-134``)."""
    import jax
    import jax.numpy as jnp
    x, g, b = _ln_inputs((200, 96), seed=2)
    loss = lambda *a: jnp.sum(
        _ref().fused_layernorm(*a).astype(jnp.float32) ** 2)
    want = jax.grad(loss, (0, 1, 2))(_jnp(x, "bfloat16"), _jnp(g, "float32"),
                                     _jnp(b, "float32"))
    ts = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(),
          torch.from_numpy(g).requires_grad_(),
          torch.from_numpy(b).requires_grad_()]
    (_port().fused_layernorm(*ts).float() ** 2).sum().backward()
    assert [t.grad.dtype for t in ts] == [torch.bfloat16, torch.float32,
                                          torch.float32]
    for t, w in zip(ts, want):
        assert str(w.dtype) == str(t.grad.dtype).replace("torch.", "")
        np.testing.assert_allclose(_np(t.grad), _np(w), **LN_GRAD["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SM_SHAPES)
def test_softmax_forward_matches_reference(shape, dtype):
    x = (np.random.default_rng(3).standard_normal(shape) * 5).astype(
        np.float32)
    want = _ref().fused_softmax(_jnp(x, dtype))
    tdt = getattr(torch, dtype)
    got = _port().fused_softmax(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == shape
    np.testing.assert_allclose(_np(got), _np(want), **SM_FWD[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SM_SHAPES)
def test_softmax_grads_match_reference(shape, dtype):
    """Gradients of sum(softmax(x) * t); the backward reads the saved y
    in the output dtype in both packages."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    t = rng.standard_normal(shape).astype(np.float32)
    jt = jnp.asarray(t)
    want = jax.grad(lambda a: jnp.sum(
        _ref().fused_softmax(a).astype(jnp.float32) * jt))(_jnp(x, dtype))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    (_port().fused_softmax(tx).float() * torch.from_numpy(t)).sum().backward()
    assert tx.grad.dtype == tdt
    np.testing.assert_allclose(_np(tx.grad), _np(want), **SM_GRAD[dtype])


def test_softmax_extreme_values_stay_finite_and_match():
    x = np.array([[1e4, 1e4 + 1, -1e4]], np.float32)
    want = _ref().fused_softmax(_jnp(x, "float32"))
    got = _port().fused_softmax(torch.from_numpy(x))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), **SM_FWD["float32"])


def test_plain_backwards_match_the_reference_vjps():
    """The plain B7 and B9 on the reference's own saved residuals."""
    import jax
    ref, port = _ref(), _port()
    x, g, b = _ln_inputs((200, 96), seed=5)
    dy = np.random.default_rng(6).standard_normal(x.shape).astype(
        np.float32)
    _, vjp = jax.vjp(lambda *a: ref.fused_layernorm(*a), x, g, b)
    want = vjp(dy)
    _, mu, rstd = ref._ln_fwd(x, g, b, 1e-6)
    got = port._ln_bwd_torch(torch.from_numpy(x), torch.from_numpy(g),
                             torch.from_numpy(np.array(mu)),
                             torch.from_numpy(np.array(rstd)),
                             torch.from_numpy(dy))
    for a, w in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(w), **LN_GRAD["float32"])
    y, vjp = jax.vjp(ref.fused_softmax, x)
    (want,) = vjp(dy)
    got = port._sm_bwd_torch(torch.from_numpy(np.array(y)),
                             torch.from_numpy(dy))
    np.testing.assert_allclose(_np(got), _np(want), **SM_GRAD["float32"])


def test_cuda_request_on_cpu_tensors_raises():
    from tosem_tpu_torch.ops.registry import BackendUnavailable
    port = _port()
    x = torch.randn(8, 32)
    g, b = torch.ones(32), torch.zeros(32)
    with pytest.raises(BackendUnavailable):
        port.fused_layernorm(x, g, b, backend="cuda")
    with pytest.raises(BackendUnavailable):
        port.fused_softmax(x, backend="cuda")
    # the kernels' wrappers refuse CPU tensors before loading anything
    for call in (lambda: port._ln_fwd_cuda(x, g, b, 1e-6),
                 lambda: port._sm_fwd_cuda(x),
                 lambda: port._sm_bwd_cuda(x, x)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_default_backend_on_cpu_runs_the_plain_versions():
    from tosem_tpu_torch.ops import registry
    registry.reset_launch_counts()
    x = torch.randn(4, 16, requires_grad=True)
    y = _port().fused_softmax(x)
    y.sum().backward()
    _port().fused_layernorm(x, torch.ones(16), torch.zeros(16))
    assert all(registry.LAUNCH_COUNTS[k] == 0
               for k in ("ln_fwd", "ln_bwd", "sm_fwd", "sm_bwd"))
