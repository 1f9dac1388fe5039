"""The port's fused layernorm and softmax (their plain ``torch`` arms, on
the CPU) held against the JAX package's ``fused_layernorm`` and
``fused_softmax``, whose Pallas kernels run in interpret mode here, as
``tests/test_pallas_kernels.py`` runs them. The same numpy inputs from a
seed go through both. Tolerances are the reference's own
(``tests/test_pallas_kernels.py:162-210``): layernorm 1e-5 forward and
1e-4 gradients, softmax atol 1e-6 / rtol 1e-5 forward and atol 1e-5 /
rtol 1e-4 gradients in fp32; 2e-2 in bf16."""
import importlib
import importlib.util
import pathlib

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
# width; a wide one; the widest row of the kernels' warp-row body (1024)
# and one element wider
LN_SHAPES = [(4, 64, 96), (200, 96), (64, 77), (24, 1000), (8, 1024),
             (8, 1025)]
SM_SHAPES = [(4, 16, 128), (200, 96), (64, 77), (8, 1000), (8, 1024),
             (8, 1025)]


def _ref():
    return importlib.import_module("tosem_tpu.ops.fused_norms")


def _chip_smoke():
    """``chip_smoke.py`` at the repository root: its module level only
    defines constants and functions."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


# The body B6 and B8 take on the card for each row width, in each dtype,
# over 16-byte-aligned operands: ("warp", V) holds a row in one warp as V
# 16-byte vectors a lane (8 bf16 or 4 fp32 values a vector); ("block", 0)
# streams it through one block. Every width of chip_smoke.py's LN_SHAPES
# and SM_SHAPES and of this file's shapes is listed.
ROW_BODY = {
    512: {"bfloat16": ("warp", 2), "float32": ("warp", 4)},
    768: {"bfloat16": ("warp", 3), "float32": ("warp", 6)},
    1000: {"bfloat16": ("warp", 4), "float32": ("warp", 8)},
    1024: {"bfloat16": ("warp", 4), "float32": ("warp", 8)},
    96: {"bfloat16": ("warp", 1), "float32": ("warp", 1)},
    128: {"bfloat16": ("warp", 1), "float32": ("warp", 1)},
    77: {"bfloat16": ("block", 0), "float32": ("block", 0)},
    1: {"bfloat16": ("block", 0), "float32": ("block", 0)},
    1025: {"bfloat16": ("block", 0), "float32": ("block", 0)},
    1032: {"bfloat16": ("block", 0), "float32": ("block", 0)},
    8192: {"bfloat16": ("block", 0), "float32": ("block", 0)},
}


def test_row_body_table_covers_every_shape_checked():
    smoke = _chip_smoke()
    widths = {s[-1] for s in (*smoke.LN_SHAPES, *smoke.SM_SHAPES,
                              *LN_SHAPES, *SM_SHAPES)}
    assert widths == set(ROW_BODY)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", sorted(ROW_BODY))
def test_row_body_maps_each_width_to_its_stated_body(n, dtype):
    tdt = getattr(torch, dtype)
    # four aligned operands at unrelated addresses, as B6 passes them
    ptrs = (0x7f0000000000, 0x7f0000200010, 0x7f0000400200, 0x7f00006000f0)
    assert _port()._row_body(n, tdt, *ptrs) == ROW_BODY[n][dtype]
    assert _port()._row_body(n, tdt, *ptrs[:2]) == ROW_BODY[n][dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [1, 2, 4, 8, 12])
def test_row_body_refuses_operands_off_16_bytes(offset, dtype):
    """Any operand, input or output, off a 16-byte boundary sends the row
    to the block body, at a width the warp body takes."""
    port = _port()
    tdt = getattr(torch, dtype)
    aligned = [0x10000, 0x20000, 0x30000, 0x40000]
    assert port._row_body(768, tdt, *aligned)[0] == "warp"
    for i in range(len(aligned)):
        ptrs = list(aligned)
        ptrs[i] += offset
        assert port._row_body(768, tdt, *ptrs) == ("block", 0)


def test_row_body_refuses_a_view_at_storage_offset_one():
    """The case chip_smoke.py launches: a contiguous view one element
    into its storage is 2 (bf16) or 4 (fp32) bytes off 16."""
    port = _port()
    for dtype in (torch.bfloat16, torch.float32):
        base = torch.zeros(64 * 768 + 16, dtype=dtype)
        x = base[1:1 + 64 * 768].view(64, 768)
        y = torch.empty_like(x)
        assert x.is_contiguous() and x.data_ptr() % 16 == dtype.itemsize
        assert port._row_body(768, dtype, x.data_ptr(),
                              y.data_ptr()) == ("block", 0)
        assert port._row_body(768, dtype, base.data_ptr(),
                              y.data_ptr())[0] == "warp"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_body_refuses_widths_off_the_vector(dtype):
    """A row that is not a whole number of 16-byte vectors never gets the
    warp body, however narrow."""
    tdt = getattr(torch, dtype)
    per_vec = 16 // tdt.itemsize
    for n in range(1, 1025):
        body, vecs = _port()._row_body(n, tdt, 0, 16)
        if n % per_vec:
            assert (body, vecs) == ("block", 0), n
        else:
            assert (body, vecs) == ("warp", -(-n // (32 * per_vec))), n
            assert 1 <= vecs <= 32 // per_vec


def test_row_body_depends_on_shape_dtype_and_alignment_only():
    """The same width, dtype and alignment class give the same body
    wherever the operands lie and whatever else the call holds; the row
    count is not an argument at all."""
    port = _port()
    for dtype in (torch.bfloat16, torch.float32):
        for n in (1, 77, 96, 512, 768, 1000, 1024, 1025, 8192):
            want = port._row_body(n, dtype, 0)
            for base in (16, 4096, 0x7fff_ffff_fff0, 2 ** 40 + 48):
                assert port._row_body(n, dtype, base, base + 16 * n) == want
                assert port._row_body(n, dtype, base) == want
        x = torch.zeros(4, 768, dtype=dtype)
        assert port._row_body(768, dtype, x.data_ptr()) == \
            port._row_body(768, dtype, x.data_ptr() + 16 * 1000)


# B7 (ln_bwd) picks its body with the same chooser, over its four operands
# x, gamma, dy and dx: the warp-row body (its dgamma/dbeta sums kept per
# lane, one partial row per block) where B6 takes it, in either gamma
# dtype, and the block body elsewhere. Every width of chip_smoke.py's
# LN_SHAPES and of this file's is listed in ROW_BODY.


def test_ln_bwd_body_table_covers_every_layernorm_shape_checked():
    smoke = _chip_smoke()
    widths = {s[-1] for s in (*smoke.LN_SHAPES, *LN_SHAPES)}
    assert widths <= set(ROW_BODY)
    assert {1, 77, 512, 768, 1000, 1024, 1025, 8192} <= widths


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", sorted(ROW_BODY))
def test_ln_bwd_body_maps_each_width_to_its_stated_body(n, dtype, gdtype):
    """x, gamma, dy and dx at unrelated aligned addresses, gamma in
    either dtype: the body depends on x's dtype and the width alone."""
    tdt = getattr(torch, dtype)
    x = torch.zeros(2, n, dtype=tdt)
    g = torch.zeros(n, dtype=getattr(torch, gdtype))
    dy, dx = torch.zeros_like(x), torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, g, dy, dx)]
    assert all(p % 16 == 0 for p in ptrs)
    assert _port()._row_body(n, tdt, *ptrs) == ROW_BODY[n][dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [2, 4, 8, 12])
def test_ln_bwd_body_refuses_each_operand_off_16_bytes(offset, dtype):
    """x, gamma, dy or dx off a 16-byte boundary (gamma included: the
    warp-row body loads it as 16-byte vectors too) sends B7 to the block
    body at the suite's width."""
    port = _port()
    tdt = getattr(torch, dtype)
    aligned = [0x7f0000000000, 0x7f0000300040, 0x7f0000600080,
               0x7f00009000c0]
    assert port._row_body(768, tdt, *aligned) == ROW_BODY[768][dtype]
    for i, name in enumerate(("x", "gamma", "dy", "dx")):
        ptrs = list(aligned)
        ptrs[i] += offset
        assert port._row_body(768, tdt, *ptrs) == ("block", 0), name


def test_ln_bwd_body_of_views_as_chip_smoke_launches_them():
    """chip_smoke.py's B7 cases off 16 bytes: x, gamma or dy a contiguous
    view one element into its storage, the rest fresh tensors."""
    port = _port()
    for dtype in (torch.bfloat16, torch.float32):
        R, D = 64, 768
        fresh = [torch.zeros(R, D, dtype=dtype), torch.zeros(D, dtype=dtype),
                 torch.zeros(R, D, dtype=dtype), torch.empty(R, D,
                                                             dtype=dtype)]
        assert port._row_body(D, dtype, *(t.data_ptr() for t in fresh))[0] \
            == "warp"
        for i, shape in ((0, (R, D)), (1, (D,)), (2, (R, D))):
            n = int(np.prod(shape))
            view = torch.zeros(n + 16, dtype=dtype)[1:1 + n].view(shape)
            ops = list(fresh)
            ops[i] = view
            assert port._row_body(D, dtype, *(t.data_ptr() for t in ops)) \
                == ("block", 0)


def test_ln_bwd_body_depends_on_shape_dtype_and_alignment_only():
    """The same width, dtype and alignment class give B7 the same body
    wherever its four operands lie; the row count and gamma's dtype are
    not arguments at all."""
    import inspect
    port = _port()
    assert list(inspect.signature(port._row_body).parameters) == [
        "n", "dtype", "ptrs"]
    for dtype in (torch.bfloat16, torch.float32):
        for n in (1, 77, 512, 768, 1000, 1024, 1025, 8192):
            want = port._row_body(n, dtype, 0, 0, 0, 0)
            for base in (16, 4096, 0x7fff_ffff_fff0, 2 ** 40 + 48):
                ptrs = (base, base + 16 * n, base + 64 * n, base + 96 * n)
                assert port._row_body(n, dtype, *ptrs) == want
