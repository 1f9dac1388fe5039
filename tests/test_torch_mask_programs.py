"""The port's block-sparse mask programs (``tosem_tpu_torch.ops.mask_programs``)
against the JAX package's, on the CPU.

- The compiler: for every mask of ``tests/test_mask_programs.py`` (T 256)
  and of the parity harness's schedule matrix (``tosem_tpu/ops/parity.py``,
  T 128), at 32 x 32 and 64 x 64 tiles, the schedule arrays and the
  statistics are element-equal to the reference's; signatures and the
  spec language agree; the device upload packs bitmaps losslessly.
- The plain arms: ``schedule_attention_torch`` against
  ``schedule_attention_xla``, and ``flash_attention(mask=)`` forward and
  gradients against the reference's Pallas kernels in interpret mode, at
  the parity matrix's shapes (B 1, H 2, T 128, D 16, 32 x 32 blocks),
  within ``TOLERANCES["schedule"]`` (max |diff| 2e-5 fp32, 2e-2 bf16).
- The layers above: ``flash_attn_fn(mask=)``'s tally and dense fallback,
  ``sparse_mask_spec``, the long-document ``BertEncodeBackend`` routing
  and its parity with the reference model, and the ``flash_sparse`` leg's
  rows.
"""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 2e-5, "bfloat16": 2e-2}       # TOLERANCES["schedule"]


def _ref():
    return importlib.import_module("tosem_tpu.ops.mask_programs")


def _port():
    return importlib.import_module("tosem_tpu_torch.ops.mask_programs")


# name -> (T, mask made from a mask_programs module). The first eight are
# tests/test_mask_programs.py's MASKS, the rest the schedule matrix's
MASKS = {
    "causal": (256, lambda mp: mp.CausalMask()),
    "local": (256, lambda mp: mp.LocalMask(96)),
    "local_band": (256, lambda mp: mp.LocalMask(64, right=63)),
    "prefix": (256, lambda mp: mp.PrefixLMMask(100)),
    "doc": (256, lambda mp: mp.DocumentMask(np.arange(256) // 96)),
    "doc_causal": (256, lambda mp: mp.DocumentMask(np.arange(256) // 96)
                   & mp.CausalMask()),
    "full": (256, lambda mp: mp.FullMask()),
    "multihead": (256, lambda mp: mp.MultiHeadMask((mp.CausalMask(),
                                                    mp.LocalMask(64)))),
    "m:causal": (128, lambda mp: mp.mask_from_spec("causal", 128)),
    "m:local": (128, lambda mp: mp.mask_from_spec("local:48", 128)),
    "m:prefix": (128, lambda mp: mp.mask_from_spec("prefix:40", 128)),
    "m:doc": (128, lambda mp: mp.mask_from_spec("doc:64", 128)),
    "m:local_band": (128, lambda mp: mp.mask_from_spec("local:32:31", 128)),
    "m:multihead": (128, lambda mp: mp.MultiHeadMask((mp.CausalMask(),
                                                      mp.LocalMask(32)))),
}


def _blocks(pkg, b):
    mod = importlib.import_module(f"{pkg}.ops.flash_blocks")
    return mod.BlockSizes(b, b, b, b)


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("name", list(MASKS))
def test_schedules_are_element_equal_to_the_reference(name, tile):
    T, build = MASKS[name]
    ref, port = _ref(), _port()
    want = ref.compile_mask_programs(build(ref), T, T,
                                     _blocks("tosem_tpu", tile), heads=2)
    got = port.compile_mask_programs(build(port), T, T,
                                     _blocks("tosem_tpu_torch", tile),
                                     heads=2)
    for which in ("fwd", "dq", "dkv"):
        for field in ("num", "blk", "kind", "mid", "mask_blocks"):
            w = np.asarray(getattr(getattr(want, which), field))
            g = np.asarray(getattr(getattr(got, which), field))
            assert g.dtype == w.dtype == np.int32, (which, field)
            np.testing.assert_array_equal(g, w, err_msg=f"{which}.{field}")
    ws = ref.program_stats(build(ref), T, T, _blocks("tosem_tpu", tile),
                           heads=2)
    gs = port.program_stats(build(port), T, T,
                            _blocks("tosem_tpu_torch", tile), heads=2)
    for which in ("fwd", "bwd"):
        assert vars(gs[which]) == vars(ws[which]), which
        assert gs[which].fraction == ws[which].fraction
    assert port.executed_block_fraction(
        build(port), T, T, _blocks("tosem_tpu_torch", tile), heads=2) == \
        ref.executed_block_fraction(build(ref), T, T,
                                    _blocks("tosem_tpu", tile), heads=2)


def test_signatures_and_specs_agree_with_the_reference():
    ref, port = _ref(), _port()
    for name, (T, build) in MASKS.items():
        assert build(port).signature() == build(ref).signature(), name
    for spec in ("causal", "full", "local:96", "local:64:63", "prefix:100",
                 "doc", "doc:64", "doc:100+causal", "local:1024+prefix:128",
                 "doc:2048+causal"):
        assert _port().mask_from_spec(spec, 8192).signature() == \
            ref.mask_from_spec(spec, 8192).signature(), spec
    for bad in ("nope", "local", "prefix"):
        with pytest.raises(ValueError):
            port.mask_from_spec(bad, 256)
    with pytest.raises(ValueError):
        port.LocalMask(0)
    with pytest.raises(TypeError):
        port.MultiHeadMask((port.MultiHeadMask((port.CausalMask(),)),))
    mh = port.MultiHeadMask((port.CausalMask(), port.LocalMask(32)))
    with pytest.raises(ValueError, match="head"):
        port.compile_mask_programs(mh, 128, 128,
                                   _blocks("tosem_tpu_torch", 64), heads=3)
    port.reset_program_cache()
    a = port.compile_mask_programs(port.LocalMask(64), 256, 256,
                                   _blocks("tosem_tpu_torch", 64))
    b = port.compile_mask_programs(port.LocalMask(64), 256, 256,
                                   _blocks("tosem_tpu_torch", 64))
    assert a is b                       # one compile per key


@pytest.mark.parametrize("name", ["local_band", "doc_causal", "multihead",
                                  "prefix"])
def test_device_upload_packs_the_reference_bitmaps(name):
    """The schedule the CUDA kernels read (uploaded here to a CPU
    tensor): int32 arrays as compiled, and 64-bit bitmap rows that unpack
    to the reference's [M, 64, 64] int32 bitmaps."""
    from tosem_tpu_torch.ops import flash_attention as fa
    T, build = MASKS[name]
    ref, port = _ref(), _port()
    want = ref.compile_mask_programs(build(ref), T, T,
                                     _blocks("tosem_tpu", 64), heads=2)
    got = port.compile_mask_programs(build(port), T, T,
                                     _blocks("tosem_tpu_torch", 64), heads=2)
    dev = fa._device_programs(got, "cpu")
    assert fa._device_programs(got, "cpu") is dev       # uploaded once
    for which in ("fwd", "dq", "dkv"):
        ds, ws = getattr(dev, which), getattr(want, which)
        for field in ("num", "blk", "kind", "mid"):
            np.testing.assert_array_equal(getattr(ds, field).numpy(),
                                          getattr(ws, field))
        assert ds.bits.dtype == torch.int64
        assert tuple(ds.bits.shape) == ws.mask_blocks.shape[:2]
        np.testing.assert_array_equal(port.unpack_bitmaps(ds.bits.numpy()),
                                      ws.mask_blocks)
        assert (ds.Hs, ds.n_major, ds.L) == ws.blk.shape


@pytest.mark.parametrize("name", list(MASKS))
def test_launch_order_puts_the_heaviest_tiles_first(name):
    """The forward kernel's launch order of the resident tiles, uploaded
    beside the schedule: a permutation of range(n_major) along which the
    entry count (summed over head rows; per row where there is one) does
    not rise, ties in tile order."""
    from tosem_tpu_torch.ops import flash_attention as fa
    T, build = MASKS[name]
    port = _port()
    progs = port.compile_mask_programs(build(port), T, T,
                                       _blocks("tosem_tpu_torch", 64),
                                       heads=2)
    num = np.asarray(progs.fwd.num)
    order = fa.launch_order(num)
    assert order.dtype == np.int32
    assert sorted(order.tolist()) == list(range(num.shape[1]))
    work = num.sum(axis=0)[order]
    assert (np.diff(work) <= 0).all()
    for a, b, wa, wb in zip(order, order[1:], work, work[1:]):
        assert wa > wb or a < b
    if num.shape[0] == 1:
        assert (np.diff(num[0][order]) <= 0).all()
    if name in ("causal", "m:causal"):
        assert order.tolist() == list(range(num.shape[1]))[::-1]
    dev = fa._device_programs(progs, "cpu")
    assert dev.fwd.order.dtype == torch.int32
    np.testing.assert_array_equal(dev.fwd.order.numpy(), order)


def test_schedule_checks_raise_value_error():
    """What the CUDA wrappers refuse before a launch: a schedule compiled
    at other tiles than the kernels' 64 x 64, lengths that do not divide
    into them, causal beside a program, and a program of another shape."""
    from tosem_tpu_torch.ops import flash_attention as fa
    port = _port()
    at32 = port.compile_mask_programs(port.LocalMask(48), 128, 128,
                                      _blocks("tosem_tpu_torch", 32))
    with pytest.raises(ValueError, match="tiles"):
        fa._device_programs(at32, "cpu")
    with pytest.raises(ValueError, match="tiles"):
        fa._check_tiles(100, 128, False)
    with pytest.raises(ValueError, match="tiles"):
        fa._check_tiles(128, 96, False)
    with pytest.raises(ValueError, match="causal"):
        fa._check_tiles(128, 128, True)
    at64 = port.compile_mask_programs(port.LocalMask(48), 128, 128,
                                      _blocks("tosem_tpu_torch", 64))
    with pytest.raises(ValueError, match="recompile"):
        fa._sched_args(at64, "fwd", "cpu", 2, 4, 4)
    with pytest.raises(ValueError, match="must divide into blocks"):
        port.compile_mask_programs(port.LocalMask(48), 100, 100,
                                   _blocks("tosem_tpu_torch", 64))
    q = torch.zeros(1, 2, 128, 16)
    with pytest.raises(ValueError, match="mask="):
        fa.flash_attention(q, q, q, programs=at64)
    with pytest.raises(ValueError, match="CausalMask"):
        fa.flash_attention(q, q, q, causal=True, programs=at64,
                           backend="torch")


def _schedule_scenarios():
    from tosem_tpu.ops import parity
    return parity.scenarios("schedule")


def _port_mask(sc, T):
    port = _port()
    p = sc.p()
    if p.get("multihead"):
        return port.MultiHeadMask((port.CausalMask(), port.LocalMask(32)))
    return port.mask_from_spec(p["mask"], T)


def _case(sc):
    """The parity harness's deterministic case, as numpy fp32 q/k/v, the
    reference's kwargs, and the port's mask and segment ids."""
    from tosem_tpu.ops import parity
    from tosem_tpu_torch.ops.flash_attention import SegmentIds
    args, kwargs = parity.build_case(sc)
    qkv = [np.array(a, np.float32) for a in args]
    seg = kwargs.get("segment_ids")
    pseg = None if seg is None else SegmentIds(
        torch.from_numpy(np.array(seg.q)), torch.from_numpy(
            np.array(seg.kv)))
    return qkv, kwargs, _port_mask(sc, qkv[0].shape[2]), pseg


@pytest.mark.parametrize("sc", _schedule_scenarios(), ids=str)
def test_schedule_attention_torch_matches_xla(sc):
    from tosem_tpu.ops.mask_programs import schedule_attention_xla
    import jax.numpy as jnp
    port = _port()
    (q, k, v), kw, mask, pseg = _case(sc)
    T = q.shape[2]
    ref_prog = _ref().compile_mask_programs(kw["mask"], T, T,
                                            kw["block_sizes"], heads=2)
    dt = jnp.dtype(sc.dtype)
    want = np.asarray(schedule_attention_xla(
        *(jnp.asarray(x).astype(dt) for x in (q, k, v)), ref_prog.fwd,
        segment_ids=kw.get("segment_ids")), np.float32)
    prog = port.compile_mask_programs(mask, T, T,
                                      _blocks("tosem_tpu_torch", 32),
                                      heads=2)
    tdt = getattr(torch, sc.dtype)
    got = port.schedule_attention_torch(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), prog.fwd,
        segment_ids=pseg)
    assert got.dtype == tdt
    assert np.abs(got.float().numpy() - want).max() <= TOL[sc.dtype]
    # the mask-in form compiles the same program itself
    low = port.schedule_lowering_torch(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), mask=mask,
        block_sizes=_blocks("tosem_tpu_torch", 32), segment_ids=pseg)
    assert torch.equal(low, got)


def _bf16_scenarios():
    """Every mask (with or without segments) of the schedule matrix in
    bf16; the fp32 forward is checked beside the gradients."""
    seen, out = set(), []
    for sc in _schedule_scenarios():
        if sc.name not in seen:
            seen.add(sc.name)
            out.append(type(sc)(sc.family, sc.name, "bfloat16", sc.params))
    return out


def _ref_flash(q, k, v, kw, dtype):
    import jax.numpy as jnp
    from tosem_tpu.ops.flash_attention import flash_attention
    dt = jnp.dtype(dtype)
    return flash_attention(*(jnp.asarray(x).astype(dt) for x in (q, k, v)),
                           None, False, mask=kw["mask"],
                           block_sizes=kw["block_sizes"],
                           segment_ids=kw.get("segment_ids"),
                           backend="pallas-interpret")


@pytest.mark.parametrize("sc", _bf16_scenarios(), ids=str)
def test_flash_forward_matches_reference_pallas_interpret(sc):
    from tosem_tpu_torch.ops.flash_attention import flash_attention
    (q, k, v), kw, mask, pseg = _case(sc)
    want = np.asarray(_ref_flash(q, k, v, kw, sc.dtype), np.float32)
    tdt = getattr(torch, sc.dtype)
    got = flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                          mask=mask, segment_ids=pseg)
    assert got.dtype == tdt
    assert np.abs(got.float().numpy() - want).max() <= TOL[sc.dtype]


@pytest.mark.parametrize(
    "sc", [s for s in _schedule_scenarios() if s.dtype == "float32"],
    ids=str)
def test_flash_grads_match_reference_jax_grad(sc):
    """fp32: the forward, then the gradients of sum(out**2) through
    ``torch.autograd`` against ``jax.vjp`` of the same loss."""
    import jax
    from tosem_tpu_torch.ops.flash_attention import flash_attention
    (q, k, v), kw, mask, pseg = _case(sc)
    ref_out, vjp = jax.vjp(lambda a, b, c: _ref_flash(a, b, c, kw,
                                                      "float32"), q, k, v)
    want = vjp(2 * ref_out)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*ts, mask=mask, segment_ids=pseg)
    assert np.abs(out.detach().numpy() - np.asarray(ref_out)).max() <= \
        TOL["float32"]
    (out ** 2).sum().backward()
    for t, w, name in zip(ts, want, "qkv"):
        w = np.asarray(w)
        # TOLERANCES["schedule"] of the largest gradient element
        err = np.abs(t.grad.numpy() - w).max() / np.abs(w).max()
        assert err <= TOL["float32"], (f"d{name}", err)


def _qkv(B=1, H=2, T=256, D=32, seed=0, layout="bhtd"):
    rng = np.random.default_rng(seed)
    shape = (B, H, T, D) if layout == "bhtd" else (B, T, H, D)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(3)]


def _dense(q, k, v, keep):
    """Softmax attention ([B, H, T, D]) with a dense bool mask."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


def test_causal_flag_equals_causal_mask_and_composes():
    from tosem_tpu_torch.ops.flash_attention import flash_attention
    port = _port()
    q, k, v = _qkv()
    assert torch.equal(flash_attention(q, k, v, causal=True),
                       flash_attention(q, k, v, mask=port.CausalMask()))
    # causal=True with a mask is their intersection
    a = flash_attention(q, k, v, causal=True,
                        mask=port.LocalMask(96, right=95))
    b = flash_attention(q, k, v, mask=port.LocalMask(96))
    torch.testing.assert_close(a, b, atol=TOL["float32"], rtol=0)
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_attention(*ts, causal=True).sum().backward()
    us = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_attention(*us, mask=port.CausalMask()).sum().backward()
    for t, u in zip(ts, us):
        assert torch.equal(t.grad, u.grad)


def test_segments_compose_with_a_mask():
    """Key padding refines the schedule: the serving path's long bucket
    with per-request padding, forward and gradients, against a dense
    softmax with both masks folded."""
    from tosem_tpu_torch.ops.flash_attention import (SegmentIds,
                                                     flash_attention)
    port = _port()
    B, T = 2, 256
    q, k, v = _qkv(B=B)
    kv = torch.cat([torch.ones(B, 192, dtype=torch.int32),
                    torch.zeros(B, 64, dtype=torch.int32)], 1)
    seg = SegmentIds(torch.ones(B, T, dtype=torch.int32), kv)
    mask = port.LocalMask(96)
    keep = (torch.from_numpy(mask.dense(T, T))[None, None]
            & kv.bool()[:, None, None, :])
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*ts, mask=mask, segment_ids=seg)
    us = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = _dense(*us, keep)
    torch.testing.assert_close(out, ref, atol=TOL["float32"], rtol=0)
    (out ** 2).sum().backward()
    (ref ** 2).sum().backward()
    for t, u in zip(ts, us):
        torch.testing.assert_close(t.grad, u.grad, atol=5e-4, rtol=5e-3)


def test_multihead_mask_folds_per_head():
    from tosem_tpu_torch.ops.flash_attention import flash_attention
    port = _port()
    q, k, v = _qkv()
    mh = port.MultiHeadMask((port.CausalMask(), port.LocalMask(64)))
    keep = torch.from_numpy(mh.dense(256, 256))[None]
    torch.testing.assert_close(flash_attention(q, k, v, mask=mh),
                               _dense(q, k, v, keep), atol=TOL["float32"],
                               rtol=0)
    with pytest.raises(ValueError, match="head"):
        flash_attention(*_qkv(H=3), mask=mh)


def test_flash_attn_fn_tallies_the_mask_signature():
    from tosem_tpu_torch.nn.attention import (FLASH_DISPATCH_COUNTS,
                                              flash_attn_fn)
    port = _port()
    q, k, v = _qkv(B=2, layout="bthd")
    before = dict(FLASH_DISPATCH_COUNTS)
    out = flash_attn_fn(mask=port.LocalMask(96))(q, k, v, None)
    assert FLASH_DISPATCH_COUNTS["flash"] == before.get("flash", 0) + 1
    assert FLASH_DISPATCH_COUNTS["torch:local:96:0"] == \
        before.get("torch:local:96:0", 0) + 1
    tr = lambda x: x.transpose(1, 2)
    keep = torch.from_numpy(port.LocalMask(96).dense(256, 256))[None, None]
    torch.testing.assert_close(tr(out), _dense(tr(q), tr(k), tr(v), keep),
                               atol=TOL["float32"], rtol=0)
    flash_attn_fn()(q, k, v, None)
    assert FLASH_DISPATCH_COUNTS["torch:dense"] == \
        before.get("torch:dense", 0) + 1
    assert FLASH_DISPATCH_COUNTS["torch:local:96:0"] == \
        before.get("torch:local:96:0", 0) + 1
    # causal composes into the key: the effective mask's signature
    sig = (port.LocalMask(96, right=95) & port.CausalMask()).signature()
    flash_attn_fn(causal=True, mask=port.LocalMask(96, right=95))(
        q, k, v, None)
    assert FLASH_DISPATCH_COUNTS[f"torch:{sig}"] == \
        before.get(f"torch:{sig}", 0) + 1


def test_dense_fallback_folds_the_mask_program():
    """A query-dependent dense mask takes the counted dense path, with
    the mask program and causality folded in."""
    from tosem_tpu_torch.nn.attention import (FLASH_DISPATCH_COUNTS,
                                              flash_attn_fn)
    from tosem_tpu_torch.ops import registry
    port = _port()
    B, T = 1, 100
    q, k, v = _qkv(B=B, T=T, D=16, layout="bthd")
    rows = torch.ones(B, 1, T, 1, dtype=torch.bool)
    rows[:, :, -3:] = False                 # query-dependent: no kernel mode
    am = rows & torch.ones(1, 1, 1, T, dtype=torch.bool)
    mask = port.LocalMask(32)
    fb = registry.FALLBACK_COUNTS["flash:torch->dense"]
    key = "dense:" + (mask & port.CausalMask()).signature()
    before = FLASH_DISPATCH_COUNTS[key]
    out = flash_attn_fn(causal=True, mask=mask)(q, k, v, am)
    assert registry.FALLBACK_COUNTS["flash:torch->dense"] == fb + 1
    assert FLASH_DISPATCH_COUNTS[key] == before + 1
    keep = (torch.from_numpy(mask.dense(T, T))
            & torch.tril(torch.ones(T, T, dtype=torch.bool)))[None, None]
    tr = lambda x: x.transpose(1, 2)
    want = _dense(tr(q), tr(k), tr(v), keep & am)
    # rows the dense mask empties are finfo.min-uniform there, -1e30 here
    torch.testing.assert_close(tr(out)[:, :, :-3], want[:, :, :-3],
                               atol=TOL["float32"], rtol=0)


def test_sparse_mask_spec_matches_the_reference_cases():
    from tosem_tpu.data.feeding import sparse_mask_spec as ref
    from tosem_tpu_torch.data.feeding import bucket_for, sparse_mask_spec
    cases = [dict(pad_t=512, local_window=64), dict(pad_t=128,
                                                    local_window=64),
             dict(pad_t=129, local_window=64), dict(pad_t=512),
             dict(pad_t=512, doc_len=128), dict(pad_t=128, doc_len=128),
             dict(pad_t=512, local_window=64, doc_len=128),
             dict(pad_t=512, local_window=0, doc_len=0)]
    for c in cases:
        kw = dict(c)
        pad = kw.pop("pad_t")
        assert sparse_mask_spec(pad, **kw) == ref(pad, **kw), c
    assert sparse_mask_spec(512, local_window=64) == "local:64:63"
    assert sparse_mask_spec(128, local_window=64) is None
    assert sparse_mask_spec(512, local_window=64, doc_len=128) == \
        "doc:128+local:64:63"
    from tosem_tpu.data.feeding import bucket_for as ref_bucket
    for n in (1, 64, 65, 512, 513):
        assert bucket_for(n, (64, 128, 512)) == ref_bucket(n, (64, 128, 512))


def _jax_params(backend):
    import jax
    return jax.tree_util.tree_map(np.asarray, backend._vs["params"])


def test_encode_backend_routes_long_buckets_to_the_schedule():
    from tosem_tpu_torch.nn.attention import FLASH_DISPATCH_COUNTS
    from tosem_tpu_torch.serve.backends import BertEncodeBackend
    be = BertEncodeBackend(max_len=256, max_batch=2, local_window=64,
                           seed=3, device="cpu")
    reqs = [{"ids": [(i % 120) + 1 for i in range(200)]},
            {"ids": [(i % 110) + 2 for i in range(150)]}]
    before = dict(FLASH_DISPATCH_COUNTS)
    out = be.call_batch(reqs)                   # pads to 256
    delta = {k: n - before.get(k, 0) for k, n in FLASH_DISPATCH_COUNTS.items()
             if n != before.get(k, 0)}
    assert delta.get("torch:local:64:63") == 2, delta    # two layers
    assert "torch:dense" not in delta
    assert all(np.isfinite(o["pooled"]).all() for o in out)
    before = dict(FLASH_DISPATCH_COUNTS)
    be.call_batch([{"ids": [5, 6, 7]}])         # pads to 128: dense
    delta = {k: n - before.get(k, 0) for k, n in FLASH_DISPATCH_COUNTS.items()
             if n != before.get(k, 0)}
    assert delta.get("torch:dense") == 2, delta
    # the sparse bucket's step is keyed by its mask signature
    from tosem_tpu_torch.serve.compile_cache import shape_key
    assert shape_key(be._tag + ";mask=local:64:63", (2, 256),
                     be.cfg.dtype) in be._steps
    assert shape_key(be._tag, (2, 128), be.cfg.dtype) in be._steps


def test_encode_backend_sparse_matches_the_reference_model():
    """Same weights: the port's routed sparse encode against the JAX
    package's model with the band folded densely (its xla arm)."""
    from tosem_tpu.models.bert import pad_ids_batch
    from tosem_tpu.nn.attention import flash_attn_fn
    from tosem_tpu.ops.mask_programs import mask_from_spec
    from tosem_tpu.serve.backends import BertEncodeBackend as JEnc
    from tosem_tpu_torch.serve.backends import BertEncodeBackend
    ref = JEnc(max_len=256, max_batch=1, local_window=64, seed=7,
               pooled=False)
    port = BertEncodeBackend(max_len=256, max_batch=1, local_window=64,
                             device="cpu", pooled=False,
                             params=_jax_params(ref))
    ids = [(i % 100) + 1 for i in range(250)]
    got = port.call_batch([{"ids": ids}], pad_to=256)[0]["encoding"]
    fwd = ref.model.encode_fn(ref._vs, attn_fn=flash_attn_fn(
        mask=mask_from_spec("local:64:63", 256), backend="xla"))
    idsb, maskb, _ = pad_ids_batch([ids], 256, pad_batch_to=1)
    want = np.asarray(fwd(idsb, maskb), np.float32)[0, :len(ids)]
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=5e-2, rtol=5e-2)


def test_flash_sparse_leg_writes_the_reference_rows(tmp_path):
    """``cli --config=flash_sparse --device=cpu``: 6 rows with the
    reference's ids (its suite run with its timer stubbed), fractions
    from the port's 64 x 64 programs."""
    from tosem_tpu.ops import kernel_suite as ref_suite
    from tosem_tpu_torch.ops.flash_blocks import BlockSizes
    from tosem_tpu_torch.utils.results import read_results

    class _FixedTimer:
        def __init__(self, op, args, perturb=0):
            pass

        def time(self, **_):
            return 1e-3
    real = ref_suite.DeviceLoopBench
    ref_suite.DeviceLoopBench = _FixedTimer
    try:
        want = ref_suite.sparse_kernel_suite(batch=1, seq=512, heads=2,
                                             head_dim=32, dtype="float32",
                                             window=128, reps=1)
    finally:
        ref_suite.DeviceLoopBench = real
    path = str(tmp_path / "flash_sparse.csv")
    out = subprocess.run([sys.executable, "-m", "tosem_tpu_torch.cli",
                          "--device=cpu", "--config=flash_sparse",
                          f"--results_csv={path}"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert "ROADMAP.md A4" in out.stdout
    rows = read_results(path)
    assert [r["bench_id"] for r in rows] == [r.bench_id for r in want]
    port = _port()
    for r, w in zip(rows, want):
        assert (r["unit"], r["metric"], r["config"]) == \
            (w.unit, w.metric, w.config)
        assert set(r["extra"]) == set(w.extra)
        assert r["extra"]["blocks_src"] == "fixed"
        assert r["value"] > 0 and np.isfinite(r["value"])
        stats = port.program_stats(port.mask_from_spec(
            {"causal": "causal", "local128": "local:128",
             "docpack128": "doc:128+causal"}[r["bench_id"].split("_")[2]],
            512), 512, 512, BlockSizes(), heads=2)
        which = "bwd" if "fwdbwd" in r["bench_id"] else "fwd"
        assert r["extra"]["executed_block_fraction"] == \
            stats[which].fraction
