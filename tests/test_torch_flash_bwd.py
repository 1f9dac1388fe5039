"""The port's flash attention backward (the autograd Function's plain
``torch`` arm, on the CPU) held against ``jax.grad`` of the JAX package's
flash attention: its Pallas backward kernels in interpret mode at
explicit 32x32 blocks, and its ``xla`` arm at ragged lengths no block
tiles. Gradients of ``sum(out**2)`` within atol 5e-4 / rtol 5e-3 in fp32,
bf16 gradients against fp32 ones within atol 0.5 / rtol 5e-2 (the
reference's own budgets, ``tests/test_pallas_kernels.py``)."""
import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FP32 = dict(atol=5e-4, rtol=5e-3)
BF16 = dict(atol=0.5, rtol=5e-2)
MODES = ("dense", "causal", "segments")
LAYOUTS = ("bhtd", "bthd")


def _ref():
    return importlib.import_module("tosem_tpu.ops.flash_attention")


def _inputs(seed, B, H, Tq, Tk, D, layout, mode):
    """q, k, v (numpy, fp32, in ``layout``) and the segment ids (numpy
    int32 ``[B, Tq]``/``[B, Tk]``, or None): key padding, every query
    seeing at least its first key."""
    rng = np.random.default_rng(seed)

    def shape(T):
        return (B, H, T, D) if layout == "bhtd" else (B, T, H, D)
    q, k, v = (rng.standard_normal(shape(T)).astype(np.float32)
               for T in (Tq, Tk, Tk))
    seg = None
    if mode == "segments":
        kv = (rng.random((B, Tk)) < 0.7).astype(np.int32)
        kv[:, 0] = 1
        seg = (np.ones((B, Tq), np.int32), kv)
    return q, k, v, seg


def _ref_grads(q, k, v, seg, mode, layout, dtype="float32", **kw):
    import jax
    import jax.numpy as jnp
    ref = _ref()
    jseg = None if seg is None else ref.SegmentIds(jnp.asarray(seg[0]),
                                                   jnp.asarray(seg[1]))

    def loss(q, k, v):
        out = ref.flash_attention(q, k, v, None, mode == "causal",
                                  segment_ids=jseg, layout=layout, **kw)
        return jnp.sum(out.astype(jnp.float32) ** 2)
    args = [jnp.asarray(x).astype(jnp.dtype(dtype)) for x in (q, k, v)]
    return [np.asarray(g, np.float32)
            for g in jax.grad(loss, (0, 1, 2))(*args)]


def _port_grads(q, k, v, seg, mode, layout, dtype=torch.float32):
    from tosem_tpu_torch.ops.flash_attention import (SegmentIds,
                                                     flash_attention)
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    pseg = None if seg is None else SegmentIds(
        torch.from_numpy(seg[0]), torch.from_numpy(seg[1]))
    out = flash_attention(*ts, causal=mode == "causal", segment_ids=pseg,
                          layout=layout)
    assert out.dtype == dtype and out.requires_grad
    (out.float() ** 2).sum().backward()
    return [t.grad.float().numpy() for t in ts]


def _close(got, want, tol):
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **tol)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", MODES)
def test_grads_match_reference_pallas_interpret(mode, layout):
    q, k, v, seg = _inputs(0, 1, 2, 64, 64, 16, layout, mode)
    want = _ref_grads(q, k, v, seg, mode, layout, bq=32, bk=32,
                      backend="pallas-interpret")
    _close(_port_grads(q, k, v, seg, mode, layout), want, FP32)


@pytest.mark.parametrize("mode", MODES)
def test_ragged_grads_match_reference_xla(mode):
    """Tq and Tk that tile nothing (the Pallas arm cannot take them)."""
    q, k, v, seg = _inputs(1, 2, 3, 40, 72, 16, "bthd", mode)
    want = _ref_grads(q, k, v, seg, mode, "bthd", backend="xla")
    _close(_port_grads(q, k, v, seg, mode, "bthd"), want, FP32)


@pytest.mark.parametrize("mode", ["dense", "segments"])
def test_bf16_grads_track_fp32_reference(mode):
    q, k, v, seg = _inputs(2, 1, 2, 64, 64, 64, "bhtd", mode)
    want = _ref_grads(q, k, v, seg, mode, "bhtd", backend="xla")
    got = _port_grads(q, k, v, seg, mode, "bhtd", dtype=torch.bfloat16)
    _close(got, want, BF16)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", MODES)
def test_function_matches_autograd_through_the_plain_forward(mode, layout):
    """The explicit backward formulas against autograd's derivative of
    the plain forward, on the same fp32 inputs."""
    from tosem_tpu_torch.ops.flash_attention import (SegmentIds,
                                                     _flash_attention_torch)
    q, k, v, seg = _inputs(3, 2, 2, 24, 40, 16, layout, mode)
    got = _port_grads(q, k, v, seg, mode, layout)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    pseg = None if seg is None else SegmentIds(
        torch.from_numpy(seg[0]), torch.from_numpy(seg[1]))
    out, _ = _flash_attention_torch(*ts, pseg, mode == "causal", 0.25,
                                    layout)
    (out ** 2).sum().backward()
    _close(got, [t.grad.numpy() for t in ts], dict(atol=1e-5, rtol=0))


def test_backward_is_recorded_only_when_grad_is_wanted():
    from tosem_tpu_torch.ops.flash_attention import _FlashFn, flash_attention
    q = torch.randn(1, 2, 8, 16, generator=torch.Generator().manual_seed(0))
    assert flash_attention(q, q, q).grad_fn is None
    qg = q.clone().requires_grad_()
    out, lse = flash_attention(qg, q, q, return_lse=True)
    assert isinstance(out.grad_fn, _FlashFn._backward_cls)
    assert not lse.requires_grad
    with torch.no_grad():
        assert flash_attention(qg, q, q).grad_fn is None


def test_segment_ids_get_no_gradient_and_lse_is_unchanged():
    from tosem_tpu_torch.ops.flash_attention import (SegmentIds,
                                                     flash_attention)
    q, k, v, seg = _inputs(4, 1, 2, 16, 16, 16, "bthd", "segments")
    ids = SegmentIds(torch.from_numpy(seg[0]), torch.from_numpy(seg[1]))
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    plain = flash_attention(*ts, segment_ids=ids, layout="bthd",
                            return_lse=True)
    tracked = flash_attention(*(t.clone().requires_grad_() for t in ts),
                              segment_ids=ids, layout="bthd",
                              return_lse=True)
    assert torch.equal(plain[0], tracked[0].detach())
    assert torch.equal(plain[1], tracked[1])
    tracked[0].sum().backward()
    assert ids.q.grad is None and ids.kv.grad is None
