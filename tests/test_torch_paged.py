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


# ------------------------------------------- the kernels' chunk plan (B4/B5)


@pytest.mark.parametrize("page", [1, 3, 8, 16, 48, 128, 256, 1000])
def test_decode_chunks_cover_every_key_position(page):
    """The chunks tile the table's W slots (so all W * page key
    positions) without overlap, each a whole number of pages; a chunk
    holds about _CHUNK_KEYS keys, or one page when a page is larger."""
    from tosem_tpu_torch.ops.paged_attention import _CHUNK_KEYS, _decode_chunks
    for W in range(1, 70):
        ppc, n = _decode_chunks(W, page)
        assert ppc >= 1 and n >= 1
        assert (n - 1) * ppc < W <= n * ppc
        slots = [j for c in range(n) for j in range(c * ppc,
                                                    min((c + 1) * ppc, W))]
        assert slots == list(range(W))
        assert ppc * page <= max(_CHUNK_KEYS, page)
        assert ppc == 1 or (ppc + 1) * page > _CHUNK_KEYS


def test_decode_chunks_depend_on_table_width_and_page_only():
    """The plan takes the table width and the page size, never the
    sequence lengths, so a decode step reads nothing back to the host
    (and a CUDA graph could capture it); the wrappers size their scratch
    from shapes alone."""
    import inspect
    from tosem_tpu_torch.ops import paged_attention as pa
    assert list(inspect.signature(pa._decode_chunks).parameters) == [
        "W", "page"]
    assert list(inspect.signature(pa._chunk_scratch).parameters) == [
        "q", "B", "K", "H", "D", "W", "page"]
    assert pa._decode_chunks(4, 128) == (1, 4)
    assert pa._decode_chunks(32, 16) == (8, 4)
    assert pa._decode_chunks(3, 1000) == (1, 3)
    q = torch.zeros(2, 3, 16)
    ppc, n, part = pa._chunk_scratch(q, 2, 1, 3, 16, 32, 16)
    assert (ppc, n) == (8, 4) and part.numel() == 2 * 3 * 4 * 1 * (16 + 2)
    with pytest.raises(ValueError):
        pa._decode_chunks(0, 16)


def _chunked_rows(q, k, v, pos, bound, live, window, scale, page, ppc):
    """One query row per sequence, as the kernels order it: each chunk
    of ``ppc`` table slots gives (m, l, acc) over its keys (P rounded to
    the input dtype before PV), and the chunks are combined in index
    order, M = max m, out = sum acc w / sum l w with w = exp(m - M); a
    chunk whose keys the row cannot see (l = 0) is skipped."""
    B, T = pos.shape
    valid = (pos <= bound[:, None]) & live
    if window is not None:
        valid &= pos > bound[:, None] - window
    parts = []
    for t0 in range(0, T, ppc * page):
        sl_ = slice(t0, t0 + ppc * page)
        s = torch.einsum("bhd,bthd->bht", q.float(),
                         k[:, sl_].float()) * scale
        val = valid[:, None, sl_]
        s = torch.where(val, s, torch.full_like(s, -1e30))
        m = s.amax(-1)
        p = torch.where(val, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        acc = torch.einsum("bht,bthd->bhd", p.to(v.dtype).float(),
                           v[:, sl_].float())
        parts.append((m, p.sum(-1), acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    l = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][2])
    for m, lc, ac in parts:
        w = torch.exp(m - M)
        live_c = lc > 0
        l = torch.where(live_c, l + lc * w, l)
        acc = torch.where(live_c[..., None], acc + ac * w[..., None], acc)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l[..., None]).to(q.dtype)


def chunked_plain(q, kp, vp, bt, sl, *, q_rows=None, page_offsets=None,
                  window=None, ppc=None):
    """A plain rendering of B4/B5's chunk-and-combine order (for these
    tests only): q [B, H, D] or [B, K, H, D], every row through
    :func:`_chunked_rows` at its own causal bound, the table slots past
    the last real page or wholly below the window masked. ``ppc``: pages
    a chunk (None: the kernels' plan, :func:`_decode_chunks`)."""
    from tosem_tpu_torch.ops import paged_attention as pa
    multi = q.ndim == 4
    q4 = q if multi else q[:, None]
    B, K, H, D = q4.shape
    W, page = bt.shape[1], kp.shape[1]
    if ppc is None:
        ppc, _ = pa._decode_chunks(W, page)
    k, v = pa._gather(kp, bt), pa._gather(vp, bt)
    pos = pa._positions(bt, page, page_offsets).long()
    sl = sl.long()
    kr = (torch.full((B,), K, dtype=torch.long) if q_rows is None
          else q_rows.long())
    po = (torch.zeros(B, dtype=torch.long) if page_offsets is None
          else page_offsets.long())
    # live table slots, as the kernels' live_slots()
    j_last = torch.clamp(torch.div(sl + page - 1, page,
                                   rounding_mode="floor") - 1 - po,
                         min=0).clamp(max=W - 1)
    j_first = torch.zeros_like(j_last)
    if window is not None:
        first_pos = torch.clamp(sl - kr - window + 1, min=0)
        j_first = torch.clamp(torch.div(first_pos, page,
                                        rounding_mode="floor") - po, min=0)
    slot = torch.arange(W * page)[None, :] // page
    live = ((slot >= j_first[:, None]) & (slot <= j_last[:, None])
            & (sl[:, None] > 0))
    rows = []
    for r in range(K):
        bound = sl - kr + torch.clamp(kr - 1, max=r)
        rows.append(_chunked_rows(q4[:, r], k, v, pos, bound, live, window,
                                  1.0 / D ** 0.5, page, ppc))
    out = torch.stack(rows, dim=1)
    return out if multi else out[:, 0]


_INTERPRET = {}


def _pallas_interpret(sc):
    from tosem_tpu.ops import parity
    key = _ids(sc)
    if key not in _INTERPRET:
        _INTERPRET[key] = parity._run_cell("paged", "pallas-interpret", sc, 0)
    return _INTERPRET[key]


@pytest.mark.parametrize("ppc", [1, 2, None])
@pytest.mark.parametrize("sc", _scenarios(), ids=_ids)
def test_chunked_rendering_matches_reference_pallas_interpret(sc, ppc):
    """The kernels' order (chunks of 1, 2 or all 4 pages of the parity
    tables) within the family tolerance of the Pallas kernel's online
    softmax in interpret mode."""
    from tosem_tpu.ops import parity
    args, kwargs = parity.build_case(sc)
    q, kp, vp, bt, sl = (to_torch(a) for a in args)
    kw = {"window": kwargs.get("window")}
    for name in ("q_rows", "page_offsets"):
        if kwargs.get(name) is not None:
            kw[name] = to_torch(kwargs[name])
    if q.ndim == 4 and "q_rows" not in kw:
        kw["q_rows"] = torch.full((q.shape[0],), q.shape[1],
                                  dtype=torch.int32)
    got = chunked_plain(q, kp, vp, bt, sl, ppc=ppc, **kw).float().numpy()
    ref = _pallas_interpret(sc)
    assert got.shape == ref.shape
    assert _compare(sc, ref, got) <= parity.TOLERANCES["paged"][sc.dtype]


@pytest.mark.parametrize("ppc", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 4, 8])
def test_chunked_rendering_rows_are_sequential_steps(K, dtype, ppc):
    """B5's pin under the kernels' order: row r of a K-row call is a
    one-token call at seq_len - (K - 1 - r), bit for bit, however many
    chunks the table splits into."""
    rng = np.random.default_rng(5)
    B, H, D, page = 3, 2, 16, 8
    npg = -(-(K + 40) // page)
    kp, vp, bt = _pools(rng, B, H, D, page, npg, dtype)
    sl = torch.tensor([K + 29, K + 17, K], dtype=torch.int32)
    q4 = torch.from_numpy(rng.standard_normal((B, K, H, D))).to(dtype)
    multi = chunked_plain(q4, kp, vp, bt, sl, ppc=ppc)
    for r in range(K):
        one = chunked_plain(q4[:, r].contiguous(), kp, vp, bt,
                            sl - (K - 1 - r), ppc=ppc)
        assert torch.equal(multi[:, r], one), r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_rendering_masked_chunks_are_exact_no_ops(dtype):
    """Chunks that a row's bound masks entirely (a table wider than the
    sequences, a window that leaves whole chunks behind) change nothing,
    bit for bit; an idle row stays exact zeros."""
    rng = np.random.default_rng(6)
    B, H, D, page = 3, 2, 16, 8
    kp, vp, bt = _pools(rng, B, H, D, page, 12, dtype)
    sl = torch.tensor([29, 0, 17], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((B, H, D))).to(dtype)
    narrow = chunked_plain(q, kp, vp, bt[:, :4], sl, ppc=1)
    for ppc in (1, 2):
        wide = chunked_plain(q, kp, vp, bt, sl, ppc=ppc)
        assert torch.equal(chunked_plain(q, kp, vp, bt[:, :4], sl,
                                         ppc=ppc), wide)
    assert torch.equal(wide, chunked_plain(q, kp, vp, bt, sl, ppc=2))
    assert torch.all(narrow[1] == 0)
    ref = _paged_plain_ref(q, kp, vp, bt, sl)
    assert torch.allclose(wide.float(), ref.float(), rtol=0,
                          atol=5e-6 if dtype == torch.float32 else 2e-2)
    # a window that leaves the first chunks of 8 keys wholly behind
    q4 = q[:, None].contiguous()
    kr = torch.ones(B, dtype=torch.int32)
    got = chunked_plain(q4, kp, vp, bt, sl, q_rows=kr, window=6, ppc=1)
    want = _paged_plain_ref(q4, kp, vp, bt, sl, q_rows=kr, window=6)
    assert torch.allclose(got.float(), want.float(), rtol=0,
                          atol=5e-6 if dtype == torch.float32 else 2e-2)


def _paged_plain_ref(q, kp, vp, bt, sl, **kw):
    from tosem_tpu_torch.ops.paged_attention import paged_attention
    return paged_attention(q, kp, vp, bt, sl, backend="torch", **kw)
