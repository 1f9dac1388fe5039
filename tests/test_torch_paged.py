"""The port's paged decode attention (plain ``torch`` arm, on the CPU)
held against the JAX package's lowerings over the paged parity matrix,
at the harness's tolerances (fp32 5e-6, bf16 2e-2), plus the bit-exact
row-r == sequential-step property the prefix cache relies on."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _scenarios():
    from tosem_tpu.ops import parity
    return parity.scenarios("paged")


def _ids(sc):
    return f"{sc.name}:{sc.dtype}"


def to_torch(x):
    from tosem_tpu_torch.models.convert import array_to_tensor
    return array_to_tensor(np.asarray(x))


def _port_call(args, kwargs):
    from tosem_tpu_torch.ops.paged_attention import paged_attention
    q, kp, vp, bt, sl = (to_torch(a) for a in args)
    kw = {}
    if kwargs.get("window") is not None:
        kw["window"] = kwargs["window"]
    for name in ("q_rows", "page_offsets"):
        if kwargs.get(name) is not None:
            kw[name] = to_torch(kwargs[name])
    return paged_attention(q, kp, vp, bt, sl, backend="torch", **kw)


def _compare(sc, ref, got):
    from tosem_tpu.ops import parity
    args, kwargs = parity.build_case(sc)
    keep = parity._valid_rows_mask("paged", args, kwargs, ref.shape)
    diff = np.abs(np.where(keep, got, 0.0) - np.where(keep, ref, 0.0))
    assert np.isfinite(got[keep]).all()
    return float(diff.max())


@pytest.mark.parametrize("sc", _scenarios(), ids=_ids)
def test_plain_arm_matches_reference_xla(sc):
    from tosem_tpu.ops import parity
    args, kwargs = parity.build_case(sc)
    ref = parity._run_cell("paged", "xla", sc, 0)
    got = _port_call(args, kwargs).float().numpy()
    assert got.shape == ref.shape
    assert _compare(sc, ref, got) <= parity.TOLERANCES["paged"][sc.dtype]


@pytest.mark.parametrize("sc", _scenarios(), ids=_ids)
def test_plain_arm_matches_reference_pallas_interpret(sc):
    """The Pallas kernel's own arithmetic (online softmax page by page)
    run in interpret mode: the port's plain version agrees within the
    family tolerance (a dense softmax and an online one round
    differently, so bits are not compared across packages)."""
    from tosem_tpu.ops import parity
    args, kwargs = parity.build_case(sc)
    ref = parity._run_cell("paged", "pallas-interpret", sc, 0)
    got = _port_call(args, kwargs).float().numpy()
    assert _compare(sc, ref, got) <= parity.TOLERANCES["paged"][sc.dtype]


@pytest.mark.parametrize("sc", _scenarios(), ids=_ids)
def test_plain_arm_matches_numpy_oracle(sc):
    from tosem_tpu.ops import parity
    args, kwargs = parity.build_case(sc)
    ref = parity._paged_oracle(*args, kwargs)
    got = _port_call(args, kwargs).float().numpy()
    assert _compare(sc, ref, got) <= parity.TOLERANCES["paged"][sc.dtype]


def _pools(rng, B, H, D, page, npg, dtype=torch.float32):
    P = B * npg + 2
    kp = torch.from_numpy(rng.standard_normal((P, page, H, D))).to(dtype)
    vp = torch.from_numpy(rng.standard_normal((P, page, H, D))).to(dtype)
    bt = torch.from_numpy(rng.permutation(P)[:B * npg]
                          .reshape(B, npg).astype(np.int32))
    return kp, vp, bt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 4, 64])
def test_multi_token_row_equals_sequential_step_bit_for_bit(K, dtype):
    """Row r of a K-row call == the one-token call at seq_len - (K-1-r),
    bit for bit, on the port's plain arm (on the reference's xla arm
    this fails by ~1e-7: ROADMAP C-ref1)."""
    from tosem_tpu_torch.ops.paged_attention import paged_attention
    rng = np.random.default_rng(0)
    B, H, D, page = 2, 2, 16, 8
    npg = -(-(K + 40) // page)
    kp, vp, bt = _pools(rng, B, H, D, page, npg, dtype)
    sl = torch.tensor([K + 29, K + 17], dtype=torch.int32)
    q4 = torch.from_numpy(rng.standard_normal((B, K, H, D))).to(dtype)
    multi = paged_attention(q4, kp, vp, bt, sl)
    for r in range(K):
        one = paged_attention(q4[:, r].contiguous(), kp, vp, bt,
                              sl - (K - 1 - r))
        assert torch.equal(multi[:, r], one), r


def test_reference_pallas_interpret_rows_are_sequential_steps():
    """The property above, on the JAX package's Pallas arm (the arm
    C-ref1 names exact): the port's pin restates it."""
    import jax.numpy as jnp
    from tosem_tpu.ops.paged_attention import paged_attention
    rng = np.random.default_rng(0)
    B, H, D, page, npg, K = 2, 2, 16, 8, 4, 4
    kp, vp, bt = (jnp.asarray(x.numpy())
                  for x in _pools(rng, B, H, D, page, npg))
    sl = jnp.asarray([29, 17], jnp.int32)
    q4 = jnp.asarray(rng.standard_normal((B, K, H, D)), jnp.float32)
    multi = paged_attention(q4, kp, vp, bt, sl, backend="pallas-interpret")
    for r in range(K):
        one = paged_attention(q4[:, r][:, None], kp, vp, bt,
                              sl - (K - 1 - r),
                              backend="pallas-interpret")[:, 0]
        np.testing.assert_array_equal(np.asarray(multi[:, r]),
                                      np.asarray(one))


def test_inactive_rows_are_exact_zeros():
    from tosem_tpu_torch.ops.paged_attention import paged_attention
    rng = np.random.default_rng(3)
    kp, vp, bt = _pools(rng, 3, 2, 16, 8, 4)
    sl = torch.tensor([29, 0, 5], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((3, 2, 16))).float()
    out = paged_attention(q, kp, vp, bt, sl)
    assert torch.all(out[1] == 0.0)
    gen = paged_attention(q[:, None], kp, vp, bt, sl)[:, 0]
    assert torch.equal(gen, out)


def test_window_with_rolling_table_matches_full_table():
    from tosem_tpu_torch.ops.paged_attention import paged_attention
    rng = np.random.default_rng(2)
    kp, vp, bt = _pools(rng, 2, 2, 16, 8, 4)
    sl = torch.tensor([30, 20], dtype=torch.int32)
    q4 = torch.from_numpy(rng.standard_normal((2, 2, 2, 16))).float()
    full = paged_attention(q4, kp, vp, bt, sl, window=6)
    po = torch.tensor([2, 1], dtype=torch.int32)
    narrow = torch.stack([bt[0, 2:4], bt[1, 1:3]])
    got = paged_attention(q4, kp, vp, narrow, sl, window=6, page_offsets=po)
    # the narrow table gathers fewer keys, so the sums run over another
    # extent: equal within the family's fp32 tolerance, not bit for bit
    assert torch.allclose(full, got, rtol=0, atol=5e-6)


def test_validation_rejects_bad_operands():
    from tosem_tpu_torch.ops.paged_attention import paged_attention
    rng = np.random.default_rng(4)
    kp, vp, bt = _pools(rng, 2, 2, 16, 8, 4)
    sl = torch.tensor([3, 4], dtype=torch.int32)
    q = torch.zeros(2, 2, 16)
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp[..., :8], bt, sl)
    with pytest.raises(ValueError):
        paged_attention(torch.zeros(2, 3, 16), kp, vp, bt, sl)
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp, bt[:1], sl)
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp, bt, sl, window=0)
