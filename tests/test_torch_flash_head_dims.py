"""Head dims the flash kernels are not built at (ROADMAP.md C1).

B1-B3 are built at head dims 16, 32, 64 and 128; the CUDA wrappers run
any other head dim up to 128 at the next of them, its q, k, v (and dO)
zero-padded by ``_pad_heads`` and the outputs cut back by ``_unpad``,
with the caller's scale and the unpadded call's LSE and Delta. Zero
lanes add exact zeros to every fp32 dot product, so on the CPU the
wrapper's padding around the plain versions must give the unpadded plain
versions' bits, in every mode (dense, causal, segment ids, a mask
program). Padded or not, the port at head dim 80 is held against
``jax.grad`` of the JAX package's flash attention (its Pallas kernels in
interpret mode; fp32 atol 5e-4 / rtol 5e-3, its own budget). A head dim
above 128 raises in each CUDA wrapper before anything is launched: shown
on meta tensors, which carry shapes and no data.
"""
import importlib

import numpy as np
import pytest
import torch

from tosem_tpu_torch.ops import flash_attention as fa
from tosem_tpu_torch.ops import registry
from tosem_tpu_torch.ops.mask_programs import LocalMask

torch.set_num_threads(1)

MODES = ("dense", "causal", "segments", "local:64")


def _operands(seed, D, B=2, T=128, H=3, layout="bthd"):
    rng = np.random.default_rng(seed)
    shape = (B, T, H, D) if layout == "bthd" else (B, H, T, D)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)) for _ in range(4))
    kv = np.ones((B, T), np.int32)
    kv[:, T - 37:] = 2
    seg = fa.SegmentIds(torch.ones(B, T, dtype=torch.int32),
                        torch.from_numpy(kv))
    return q, k, v, do, seg


def _mode(mode, seg):
    """(segment ids, causal, mask) of one mode."""
    if mode == "segments":
        return seg, False, None
    if mode == "causal":
        return None, True, None
    if mode.startswith("local:"):
        return None, False, LocalMask(int(mode.split(":")[1]))
    return None, False, None


@pytest.mark.parametrize("d,width", [(1, 16), (8, 16), (16, 16), (17, 32),
                                     (48, 64), (64, 64), (80, 128),
                                     (96, 128), (128, 128)])
def test_kernel_head_dim_is_the_next_built_width(d, width):
    assert fa.kernel_head_dim(d) == width


@pytest.mark.parametrize("d", [129, 160, 256])
def test_head_dims_above_128_raise_naming_c1(d):
    with pytest.raises(ValueError, match="ROADMAP.md C1"):
        fa.kernel_head_dim(d)


@pytest.mark.parametrize("layout", ("bthd", "bhtd"))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", (8, 48, 80, 96))
def test_padding_around_the_plain_versions_is_exact(d, mode, layout):
    """What the CUDA wrappers do to a head dim they pad, around the plain
    versions: the same output, LSE and gradients, bit for bit."""
    q, k, v, do, seg = _operands(d, d, layout=layout)
    ids, causal, mask = _mode(mode, seg)
    scale = 1.0 / d ** 0.5
    out, lse = fa._flash_attention_torch(q, k, v, ids, causal, scale, layout,
                                         mask)
    delta = fa._bwd_delta(do, out, layout)
    dk, dv = fa._flash_bwd_dkv_torch(q, k, v, do, lse, delta, ids, causal,
                                     scale, layout, mask)
    dq = fa._flash_bwd_dq_torch(q, k, v, do, lse, delta, ids, causal, scale,
                                layout, mask)

    width = fa.kernel_head_dim(d)
    pq, pk, pv, pdo = fa._pad_heads((q, k, v, do), width)
    assert pq.shape[-1] == width and pq.is_contiguous()
    assert torch.equal(pq[..., d:], torch.zeros_like(pq[..., d:]))
    p_out, p_lse = fa._flash_attention_torch(pq, pk, pv, ids, causal, scale,
                                             layout, mask)
    p_dk, p_dv = fa._flash_bwd_dkv_torch(pq, pk, pv, pdo, lse, delta, ids,
                                         causal, scale, layout, mask)
    p_dq = fa._flash_bwd_dq_torch(pq, pk, pv, pdo, lse, delta, ids, causal,
                                  scale, layout, mask)
    for name, got, want in (("out", p_out, out), ("dq", p_dq, dq),
                            ("dk", p_dk, dk), ("dv", p_dv, dv)):
        cut = fa._unpad(got, d)
        assert cut.is_contiguous() and cut.shape == want.shape, name
        assert torch.equal(cut, want), name
        # the padded lanes of every output are exact zeros
        assert not got[..., d:].any(), name
    assert torch.equal(p_lse, lse)


def test_built_widths_pass_through_unpadded():
    q, k, v, do, _ = _operands(0, 64)
    assert all(a is b for a, b in zip(fa._pad_heads((q, k, v, do), 64),
                                      (q, k, v, do)))
    assert fa._unpad(q, 64) is q


@pytest.mark.parametrize("mode", ("dense", "causal", "segments"))
def test_head_dim_80_matches_reference_pallas_interpret(mode):
    """Forward and ``jax.grad`` at head dim 80 (a width the JAX package's
    kernels take as it is), Pallas interpret mode at 32 x 32 blocks."""
    import jax
    import jax.numpy as jnp
    ref = importlib.import_module("tosem_tpu.ops.flash_attention")
    rng = np.random.default_rng(80)
    q, k, v = (rng.standard_normal((1, 64, 2, 80)).astype(np.float32)
               for _ in range(3))
    kv = np.ones((1, 64), np.int32)
    kv[:, 50:] = 2
    jseg = (ref.SegmentIds(jnp.ones((1, 64), jnp.int32), jnp.asarray(kv))
            if mode == "segments" else None)
    pseg = (fa.SegmentIds(torch.ones(1, 64, dtype=torch.int32),
                          torch.from_numpy(kv))
            if mode == "segments" else None)
    causal = mode == "causal"

    def jloss(q, k, v):
        out = ref.flash_attention(q, k, v, None, causal, segment_ids=jseg,
                                  layout="bthd", bq=32, bk=32,
                                  backend="pallas-interpret")
        return jnp.sum(out ** 2), out
    (_, jout), jgrads = jax.value_and_grad(jloss, (0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*ts, causal=causal, segment_ids=pseg,
                             layout="bthd")
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=0)
    for t, g, name in zip(ts, jgrads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=5e-4,
                                   rtol=5e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cuda_wrappers_refuse_head_dims_above_128_before_a_launch(dtype):
    meta = dict(device="meta", dtype=dtype)
    q, k, v, do = (torch.empty(1, 64, 2, 160, **meta) for _ in range(4))
    lse, delta = (torch.empty(1, 2, 64, device="meta") for _ in range(2))
    before = dict(registry.LAUNCH_COUNTS)
    with pytest.raises(ValueError, match="ROADMAP.md C1"):
        fa._flash_fwd_cuda(q, k, v, None, False, 0.1, "bthd")
    with pytest.raises(ValueError, match="ROADMAP.md C1"):
        fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, None, False, 0.1,
                               "bthd")
    with pytest.raises(ValueError, match="ROADMAP.md C1"):
        fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, None, False, 0.1,
                              "bthd")
    assert dict(registry.LAUNCH_COUNTS) == before
