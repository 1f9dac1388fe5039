"""The port's sharded attention (``tosem_tpu_torch/parallel/flash.py``)
and the sharded replicas (``serve/backends.py``): the JAX package's
``tests/test_sharded_decode.py`` run against the port, plus the packages
held against each other.

Within the port, a sharded call equals the unsharded one bit for bit
(``torch.equal``), as the reference pins for its own arms: attention
reduces only within a (batch row, head) cell. Across the packages the
outputs agree within ``TOLERANCES``; the replicas' seeded workloads are
byte-equal. The reference runs on ``conftest.py``'s 8 virtual CPU
devices, the port on CPU positions.
"""
import numpy as np
import pytest
import torch

from tosem_tpu_torch.ops.flash_attention import SegmentIds, flash_attention
from tosem_tpu_torch.ops.paged_attention import paged_attention
from tosem_tpu_torch.parallel.flash import (dp_tp_mesh,
                                            sharded_flash_attention,
                                            sharded_paged_attention)

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


def _mesh(dp, tp):
    return dp_tp_mesh(dp, tp, CPU8)


def _tol(family):
    from tosem_tpu.ops.parity import TOLERANCES
    return TOLERANCES[family]["float32"]


def _workload(seed=0, B=4, H=4, D=16, P=12, page=8, tables=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, H, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, H, D)).astype(np.float32)
    bt = rng.integers(0, P, (B, tables)).astype(np.int32)
    sl = rng.integers(0, tables * page + 1, (B,)).astype(np.int32)
    return q, kp, vp, bt, sl


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


class TestShardedPagedAttention:
    @pytest.mark.parametrize("dp,tp", [(1, 2), (2, 1), (2, 2), (4, 2),
                                       (2, 4), (4, 1), (1, 4)])
    def test_single_token_bit_identical(self, dp, tp):
        q, kp, vp, bt, sl = _workload(seed=dp * 10 + tp)
        ref = paged_attention(*_t(q, kp, vp, bt, sl))
        out = sharded_paged_attention(_mesh(dp, tp))(*_t(q, kp, vp, bt, sl))
        assert out.numpy().tobytes() == ref.numpy().tobytes()

    @pytest.mark.parametrize("dp,tp", [(2, 2), (4, 2)])
    def test_single_token_matches_the_reference_s(self, dp, tp):
        from tosem_tpu.parallel.flash import dp_tp_mesh as jmesh
        from tosem_tpu.parallel.flash import sharded_paged_attention as jrun
        q, kp, vp, bt, sl = _workload(seed=dp * 10 + tp)
        want = np.asarray(jrun(jmesh(dp, tp))(q, kp, vp, bt, sl))
        out = sharded_paged_attention(_mesh(dp, tp))(*_t(q, kp, vp, bt, sl))
        np.testing.assert_allclose(out.numpy(), want, atol=_tol("paged"),
                                   rtol=_tol("paged"))

    def test_inactive_rows_zero(self):
        q, kp, vp, bt, sl = _workload(seed=3)
        sl[:] = 0
        out = sharded_paged_attention(_mesh(2, 2))(*_t(q, kp, vp, bt, sl))
        assert not out.any()

    def test_multi_token_q_rows_bit_identical(self):
        from tosem_tpu.ops.paged_attention import paged_attention as jpaged
        rng = np.random.default_rng(7)
        B, K, H, D = 4, 3, 4, 16
        q = rng.standard_normal((B, K, H, D)).astype(np.float32)
        _, kp, vp, bt, sl = _workload(seed=8)
        sl = np.maximum(sl, K)
        kr = rng.integers(1, K + 1, (B,)).astype(np.int32)
        ref = paged_attention(*_t(q, kp, vp, bt, sl), q_rows=_t(kr)[0])
        out = sharded_paged_attention(_mesh(2, 2))(*_t(q, kp, vp, bt, sl),
                                                   q_rows=kr)
        assert out.numpy().tobytes() == ref.numpy().tobytes()
        want = np.asarray(jpaged(q, kp, vp, bt, sl, impl="xla", q_rows=kr))
        np.testing.assert_allclose(out.numpy(), want, atol=_tol("paged"),
                                   rtol=_tol("paged"))

    def test_window_and_offsets_bit_identical(self):
        from tosem_tpu.ops.paged_attention import paged_attention as jpaged
        rng = np.random.default_rng(11)
        B, K, H, D = 4, 2, 4, 16
        q = rng.standard_normal((B, K, H, D)).astype(np.float32)
        _, kp, vp, bt, _ = _workload(seed=12)
        po = np.array([0, 1, 0, 2], np.int32)
        sl = np.array([10, 20, 30, 25], np.int32)
        kr = np.array([2, 1, 2, 2], np.int32)
        ref = paged_attention(*_t(q, kp, vp, bt, sl), q_rows=_t(kr)[0],
                              window=9, page_offsets=_t(po)[0])
        out = sharded_paged_attention(_mesh(2, 2), window=9)(
            *_t(q, kp, vp, bt, sl), q_rows=kr, page_offsets=po)
        assert out.numpy().tobytes() == ref.numpy().tobytes()
        want = np.asarray(jpaged(q, kp, vp, bt, sl, impl="xla", q_rows=kr,
                                 window=9, page_offsets=po))
        np.testing.assert_allclose(out.numpy(), want, atol=_tol("paged"),
                                   rtol=_tol("paged"))

    def test_bf16_pools_bit_identical(self):
        q, kp, vp, bt, sl = (x.to(torch.bfloat16) if x.is_floating_point()
                             else x for x in _t(*_workload(seed=5)))
        ref = paged_attention(q, kp, vp, bt, sl)
        out = sharded_paged_attention(_mesh(2, 4))(q, kp, vp, bt, sl)
        assert torch.equal(out, ref)

    @pytest.mark.parametrize("window", [None, 5])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_rows_only_reorder_the_einsum_sums(self, dtype, window):
        # the plain arm sums products over contiguous last dims so that a
        # cell's bits do not hang on the batch count; against the einsum
        # form it differs only in the order of its sums, so the two agree
        # within the JAX package's paged tolerance
        from tosem_tpu_torch.ops import paged_attention as pa
        q, kp, vp, bt, sl = _t(*_workload(seed=7))
        dt = getattr(torch, dtype)
        q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
        sl[0] = 0                  # a row with no visible key
        k, v = pa._gather(kp, bt), pa._gather(vp, bt)
        pos = pa._positions(bt, kp.shape[1], None)
        bound = sl - 1
        scale = q.shape[-1] ** -0.5
        got = pa._attend_rows(q, k, v, pos, bound, window, scale)

        s = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
        valid = pos <= bound[:, None]
        if window is not None:
            valid = valid & (pos > bound[:, None] - window)
        valid = valid[:, None, :]
        s = torch.where(valid, s, torch.full_like(s, pa._NEG_INF))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = torch.where(valid, p, torch.zeros_like(p))
        l = p.sum(-1, keepdim=True)
        p = (p / torch.where(l == 0.0, torch.ones_like(l), l)).to(v.dtype)
        want = torch.einsum("bht,bthd->bhd", p.float(), v.float()).to(dt)

        from tosem_tpu.ops.parity import TOLERANCES
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   atol=TOLERANCES["paged"][dtype], rtol=0)

    def test_divisibility_validated(self):
        q, kp, vp, bt, sl = _workload(B=3)
        run = sharded_paged_attention(_mesh(2, 2))
        with pytest.raises(ValueError, match="divisible"):
            run(*_t(q, kp, vp, bt, sl))
        q2, kp2, vp2, bt2, sl2 = _workload(H=3)
        with pytest.raises(ValueError, match="divisible"):
            run(*_t(q2, kp2, vp2, bt2, sl2))

    def test_unknown_axes_rejected(self):
        mesh = _mesh(2, 2)
        with pytest.raises(ValueError, match="data axis"):
            sharded_paged_attention(mesh, data_axis="nope")
        with pytest.raises(ValueError, match="model axis"):
            sharded_paged_attention(mesh, model_axis="nope")

    def test_data_only_mesh(self):
        q, kp, vp, bt, sl = _workload(seed=21)
        ref = paged_attention(*_t(q, kp, vp, bt, sl))
        run = sharded_paged_attention(_mesh(4, 1), model_axis=None)
        out = run(*_t(q, kp, vp, bt, sl))
        assert out.numpy().tobytes() == ref.numpy().tobytes()

    def test_partition_specs_shape(self):
        from tosem_tpu_torch.ops.paged_attention import paged_partition_specs
        from tosem_tpu_torch.parallel.spmd import P
        specs = paged_partition_specs("dp", "tp")
        assert specs["q"] == P("dp", "tp", None)
        assert specs["kv_pages"] == P(None, None, "tp", None)
        assert specs["block_tables"] == P("dp", None)
        multi = paged_partition_specs("dp", "tp", multi=True)
        assert multi["q"] == P("dp", None, "tp", None)

    @pytest.mark.parametrize("multi", [False, True])
    def test_partition_specs_are_the_reference_s(self, multi):
        from tosem_tpu.ops.paged_attention import \
            paged_partition_specs as jspecs
        from tosem_tpu_torch.ops.paged_attention import paged_partition_specs
        for axes in (("dp", "tp"), ("dp", None), ("x", "y")):
            got = paged_partition_specs(*axes, multi=multi)
            want = jspecs(*axes, multi=multi)
            assert sorted(got) == sorted(want)
            assert all(tuple(got[k]) == tuple(want[k]) for k in got)

    def test_lazy_root_export(self):
        import tosem_tpu_torch
        assert callable(tosem_tpu_torch.sharded_paged_attention)
        assert tosem_tpu_torch.dp_tp_mesh is dp_tp_mesh


def _qkv(seed, B=4, T=128, H=4, D=16, layout="bthd"):
    rng = np.random.default_rng(seed)
    shape = (B, T, H, D) if layout == "bthd" else (B, H, T, D)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(3)]


def _padding(B, T, lengths):
    kv = (np.arange(T)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    return SegmentIds(torch.ones(B, T, dtype=torch.int32),
                      torch.from_numpy(kv))


class TestShardedFlashAttention:
    @pytest.mark.parametrize("dp,tp", [(2, 2), (1, 4), (4, 2), (2, 1)])
    @pytest.mark.parametrize("causal", [False, True])
    def test_bit_identical(self, dp, tp, causal):
        q, k, v = _qkv(dp * 10 + tp)
        ref = flash_attention(q, k, v, None, causal, layout="bthd")
        out = sharded_flash_attention(_mesh(dp, tp), causal=causal)(q, k, v)
        assert torch.equal(out, ref)

    @pytest.mark.parametrize("layout", ["bthd", "bhtd"])
    def test_segments_bit_identical(self, layout):
        q, k, v = _qkv(4, layout=layout)
        seg = _padding(4, 128, [128, 100, 61, 1])
        ref = flash_attention(q, k, v, None, False, segment_ids=seg,
                              layout=layout)
        out = sharded_flash_attention(_mesh(2, 2), layout=layout)(q, k, v,
                                                                  seg)
        assert torch.equal(out, ref)

    def test_matches_the_reference_s(self):
        from tosem_tpu.ops.flash_attention import SegmentIds as JSeg
        from tosem_tpu.parallel.flash import dp_tp_mesh as jmesh
        from tosem_tpu.parallel.flash import sharded_flash_attention as jrun
        q, k, v = _qkv(9)
        seg = _padding(4, 128, [128, 90, 64, 3])
        want = np.asarray(jrun(jmesh(2, 2), causal=True, backend="xla")(
            q.numpy(), k.numpy(), v.numpy(),
            JSeg(seg.q.numpy(), seg.kv.numpy())))
        out = sharded_flash_attention(_mesh(2, 2), causal=True)(q, k, v, seg)
        np.testing.assert_allclose(out.numpy(), want, atol=_tol("flash"),
                                   rtol=_tol("flash"))

    def test_multihead_mask_is_sliced_by_head(self):
        from tosem_tpu_torch.ops.mask_programs import (CausalMask, LocalMask,
                                                       MultiHeadMask)
        q, k, v = _qkv(5)
        mh = MultiHeadMask([CausalMask(), LocalMask(32), LocalMask(16),
                            CausalMask()])
        ref = flash_attention(q, k, v, None, False, mask=mh, layout="bthd")
        for dp, tp in ((1, 4), (2, 2), (2, 1)):
            out = sharded_flash_attention(_mesh(dp, tp), mask=mh)(q, k, v)
            assert torch.equal(out, ref), (dp, tp)
        out = sharded_flash_attention(_mesh(1, 2), mask=mh, causal=True)(
            q, k, v)
        assert torch.equal(out, flash_attention(q, k, v, None, True,
                                                mask=mh, layout="bthd"))

    def test_head_slices_are_the_full_program_s_rows(self):
        from tosem_tpu_torch.ops.flash_blocks import BlockSizes
        from tosem_tpu_torch.ops.mask_programs import (CausalMask, LocalMask,
                                                       MultiHeadMask,
                                                       compile_mask_programs)
        from tosem_tpu_torch.parallel.flash import _head_slice
        mh = MultiHeadMask([CausalMask(), LocalMask(64)] * 2)
        full = compile_mask_programs(mh, 256, 256, BlockSizes(), heads=4)
        part = compile_mask_programs(MultiHeadMask(mh.masks[2:]), 256, 256,
                                     BlockSizes(), heads=2)
        cut = _head_slice(full, 2, 4)
        for a, b in zip(cut, full):
            np.testing.assert_array_equal(a.num, b.num[2:4])
            assert a.mask_blocks is b.mask_blocks
        for a, b in zip(cut, part):
            np.testing.assert_array_equal(a.blk, b.blk)
            np.testing.assert_array_equal(a.kind, b.kind)

    def test_uniform_mask_in_every_position(self):
        from tosem_tpu_torch.ops.mask_programs import LocalMask
        q, k, v = _qkv(6)
        ref = flash_attention(q, k, v, None, True, mask=LocalMask(48),
                              layout="bthd")
        out = sharded_flash_attention(_mesh(2, 2), causal=True,
                                      mask=LocalMask(48))(q, k, v)
        assert torch.equal(out, ref)

    def test_validation(self):
        from tosem_tpu_torch.ops.mask_programs import (CausalMask,
                                                       MultiHeadMask)
        mesh = _mesh(2, 4)
        with pytest.raises(ValueError, match="layout"):
            sharded_flash_attention(mesh, layout="tbhd")
        with pytest.raises(ValueError, match="model axis"):
            sharded_flash_attention(mesh, model_axis="sp")
        with pytest.raises(ValueError, match="divisible"):
            sharded_flash_attention(mesh, mask=MultiHeadMask(
                [CausalMask()] * 6))
        q, k, v = _qkv(1, H=6)
        with pytest.raises(ValueError, match="divisible"):
            sharded_flash_attention(mesh)(q, k, v)

    def test_gradients_flow_through_the_split(self):
        # no collective in the body: the split and the assembly are
        # copies autograd sees, and each position's backward is the
        # unsharded backward's on its cells
        q, k, v = (x.requires_grad_() for x in _qkv(2))
        do = _qkv(3)[0]
        out = sharded_flash_attention(_mesh(2, 2), causal=True)(q, k, v)
        got = torch.autograd.grad(out, (q, k, v), do)
        ref = flash_attention(q, k, v, None, True, layout="bthd")
        want = torch.autograd.grad(ref, (q, k, v), do)
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    def test_dp_tp_mesh_needs_enough_positions(self):
        with pytest.raises(ValueError, match="needs 8 positions"):
            dp_tp_mesh(2, 4, ["cpu"] * 4)
        with pytest.raises(ValueError, match=">= 1"):
            dp_tp_mesh(0, 1, CPU8)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device_count"):
                dp_tp_mesh(1, 1)


# ------------------------------------------------------------ replicas

PAGED_DIMS = dict(batch=4, heads=4, head_dim=16, pages=16, page_size=8,
                  table_w=4)
MODES = ({"seed": 1}, {"seed": 2, "q_tokens": 3},
         {"seed": 3, "q_tokens": 2, "offsets": True})


class TestShardedPagedDecodeBackend:
    def test_in_process_parity_all_modes(self):
        from tosem_tpu_torch.serve.backends import ShardedPagedDecodeBackend
        backend = ShardedPagedDecodeBackend(dp=2, tp=2, device="cpu",
                                            **PAGED_DIMS)
        for req in MODES:
            out = backend.call(dict(req))
            ref = ShardedPagedDecodeBackend.reference(req, device="cpu",
                                                      **PAGED_DIMS)
            assert np.asarray(out["out"]).tobytes() == ref.tobytes()
        assert out["mesh"] == [2, 2]
        assert out["devices"] == 4 and out["cards"] == 1

    @pytest.mark.parametrize("req", MODES)
    def test_workloads_are_byte_equal_to_the_reference_s(self, req):
        from tosem_tpu.serve.backends import ShardedPagedDecodeBackend as J
        from tosem_tpu_torch.serve.backends import ShardedPagedDecodeBackend
        kw = dict(q_tokens=req.get("q_tokens", 0),
                  offsets=req.get("offsets", False))
        got = ShardedPagedDecodeBackend._workload(req["seed"], **PAGED_DIMS,
                                                  **kw)
        want = J._workload(req["seed"], **PAGED_DIMS, **kw)
        for g, w in zip(got, want):
            assert (g is None and w is None) or g.tobytes() == w.tobytes()

    @pytest.mark.parametrize("req", MODES)
    def test_replica_matches_the_reference_s(self, req):
        from tosem_tpu.serve.backends import ShardedPagedDecodeBackend as J
        from tosem_tpu_torch.serve.backends import ShardedPagedDecodeBackend
        out = ShardedPagedDecodeBackend(dp=2, tp=2, device="cpu",
                                        **PAGED_DIMS).call(dict(req))
        want = J(dp=2, tp=2, **PAGED_DIMS).call(dict(req))["out"]
        np.testing.assert_allclose(out["out"], want, atol=_tol("paged"),
                                   rtol=_tol("paged"))

    def test_windowed_parity(self):
        from tosem_tpu_torch.serve.backends import ShardedPagedDecodeBackend
        dims = dict(batch=2, heads=2, head_dim=16, pages=8,
                    page_size=8, table_w=3)
        backend = ShardedPagedDecodeBackend(dp=1, tp=2, window=10,
                                            device="cpu", **dims)
        req = {"seed": 5}
        out = backend.call(dict(req))
        ref = ShardedPagedDecodeBackend.reference(req, window=10,
                                                  device="cpu", **dims)
        assert np.asarray(out["out"]).tobytes() == ref.tobytes()

    def test_divisibility_validated(self):
        from tosem_tpu_torch.serve.backends import ShardedPagedDecodeBackend
        with pytest.raises(ValueError):
            ShardedPagedDecodeBackend(dp=2, tp=1, batch=3, device="cpu")
        with pytest.raises(ValueError):
            ShardedPagedDecodeBackend(dp=1, tp=2, heads=3, device="cpu")

    def test_default_device_is_the_card(self):
        from tosem_tpu_torch.serve.backends import ShardedPagedDecodeBackend
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is valid")
        with pytest.raises(RuntimeError, match="cuda"):
            ShardedPagedDecodeBackend(dp=2, tp=2)

    def test_warmup(self):
        from tosem_tpu_torch.serve.backends import ShardedPagedDecodeBackend
        be = ShardedPagedDecodeBackend(dp=1, tp=2, device="cpu",
                                       **PAGED_DIMS)
        assert be.warmup([]) == {"warmed": 1}


ATTN_DIMS = dict(batch=4, heads=4, seq=64, dim=16)


class TestShardedAttentionBackend:
    @pytest.mark.parametrize("dp,tp", [(2, 2), (1, 4), (4, 1)])
    def test_in_process_parity(self, dp, tp):
        from tosem_tpu_torch.serve.backends import ShardedAttentionBackend
        be = ShardedAttentionBackend(dp=dp, tp=tp, device="cpu",
                                     **ATTN_DIMS)
        for seed in (0, 7):
            out = be.call({"seed": seed})
            ref = ShardedAttentionBackend.reference({"seed": seed},
                                                    device="cpu",
                                                    **ATTN_DIMS)
            assert out["out"].tobytes() == ref.tobytes()
        assert out["mesh"] == [dp, tp] and out["devices"] == dp * tp

    def test_workload_is_byte_equal_to_the_reference_s(self):
        from tosem_tpu.serve.backends import ShardedAttentionBackend as J
        from tosem_tpu_torch.serve.backends import ShardedAttentionBackend
        got = ShardedAttentionBackend._qkv(4, 4, 64, 16, 3)
        want = J._qkv(4, 4, 64, 16, 3)
        assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))

    def test_replica_matches_the_reference_s(self):
        from tosem_tpu.serve.backends import ShardedAttentionBackend as J
        from tosem_tpu_torch.serve.backends import ShardedAttentionBackend
        out = ShardedAttentionBackend(dp=2, tp=2, device="cpu",
                                      **ATTN_DIMS).call({"seed": 4})
        want = J(dp=2, tp=2, **ATTN_DIMS).call({"seed": 4})["out"]
        np.testing.assert_allclose(out["out"], want, atol=_tol("flash"),
                                   rtol=_tol("flash"))

    def test_divisibility_validated(self):
        from tosem_tpu_torch.serve.backends import ShardedAttentionBackend
        with pytest.raises(ValueError, match="batch"):
            ShardedAttentionBackend(dp=3, tp=1, device="cpu")
        with pytest.raises(ValueError, match="heads"):
            ShardedAttentionBackend(dp=1, tp=3, device="cpu")

    def test_root_exports(self):
        import tosem_tpu_torch
        from tosem_tpu_torch.serve import backends
        assert tosem_tpu_torch.ShardedAttentionBackend is \
            backends.ShardedAttentionBackend
        assert tosem_tpu_torch.ShardedPagedDecodeBackend is \
            backends.ShardedPagedDecodeBackend
