"""The port's flash attention (plain ``torch`` arm, on the CPU) held
against the JAX package's lowerings on the parity matrix's own inputs,
at the parity harness's tolerances (fp32 2e-5, bf16 2e-2)."""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# the scenario modes of the flash matrix: dense, causal, segment ids,
# both layouts, and the block-sparse mask programs (with segment ids)
PORTED = ("dense", "causal", "segments", "causal_segments", "bthd_layout",
          "local_mask", "prefix_mask", "doc_mask", "doc_mask_segments")


def _scenarios():
    from tosem_tpu.ops import parity
    return [sc for sc in parity.scenarios("flash") if sc.name in PORTED]


def _ids(sc):
    return f"{sc.name}:{sc.dtype}"


def to_torch(x):
    from tosem_tpu_torch.models.convert import array_to_tensor
    return array_to_tensor(np.asarray(x))


def _port_args(args, kwargs, spec=None):
    from tosem_tpu_torch.ops.flash_attention import SegmentIds
    q, k, v = (to_torch(a) for a in args)
    seg = kwargs.get("segment_ids")
    if seg is not None:
        seg = SegmentIds(to_torch(seg.q), to_torch(seg.kv))
    layout = kwargs.get("layout", "bhtd")
    mask = None
    if spec is not None:
        # the same mask program, built by the port from the scenario's spec
        from tosem_tpu_torch.ops.mask_programs import mask_from_spec
        mask = mask_from_spec(spec, q.shape[2 if layout == "bhtd" else 1])
    return q, k, v, dict(causal=bool(kwargs.get("causal")),
                         segment_ids=seg, mask=mask, layout=layout)


def _run_port(sc):
    from tosem_tpu.ops import parity
    from tosem_tpu_torch.ops.flash_attention import flash_attention
    args, kwargs = parity.build_case(sc)
    q, k, v, kw = _port_args(args, kwargs, sc.p().get("mask"))
    return flash_attention(q, k, v, backend="torch", **kw).float().numpy()


@pytest.mark.parametrize("sc", _scenarios(), ids=_ids)
def test_plain_arm_matches_reference_xla(sc):
    from tosem_tpu.ops import parity
    ref = parity._run_cell("flash", "xla", sc, 0)
    got = _run_port(sc)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= parity.TOLERANCES["flash"][sc.dtype]


@pytest.mark.parametrize("sc", _scenarios(), ids=_ids)
def test_plain_arm_matches_numpy_oracle(sc):
    from tosem_tpu.ops import parity
    args, kwargs = parity.build_case(sc)
    ref = parity._dense_mask_oracle(args[0], args[1], args[2], kwargs)
    got = _run_port(sc)
    assert np.abs(got - ref).max() <= parity.TOLERANCES["flash"][sc.dtype]


@pytest.mark.parametrize("name", ["causal_segments", "bthd_layout"])
def test_plain_arm_matches_reference_pallas_interpret(name):
    from tosem_tpu.ops import parity
    sc = next(s for s in _scenarios() if s.name == name)
    ref = parity._run_cell("flash", "pallas-interpret", sc, 0)
    got = _run_port(sc)
    assert np.abs(got - ref).max() <= parity.TOLERANCES["flash"][sc.dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dense", "causal", "segments"])
def test_ragged_lengths_match_reference_xla(mode, dtype):
    """Tq and Tk that tile nothing: the kernel masks its edge itself."""
    import importlib

    import jax.numpy as jnp
    from tosem_tpu.ops import parity
    ref_fa = importlib.import_module("tosem_tpu.ops.flash_attention")
    from tosem_tpu_torch.ops.flash_attention import (SegmentIds,
                                                     flash_attention)
    rng = np.random.default_rng(7)
    B, H, Tq, Tk, D = 2, 3, 45, 71, 16
    qn, kn, vn = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                  for T in (Tq, Tk, Tk))
    jdt = jnp.dtype(dtype)
    causal = mode == "causal"
    seg_ref = seg_port = None
    if mode == "segments":
        sq = np.ones((B, Tq), np.int32)
        sk = (rng.random((B, Tk)) < 0.8).astype(np.int32)
        sk[:, 0] = 1
        seg_ref = ref_fa.SegmentIds(jnp.asarray(sq), jnp.asarray(sk))
        seg_port = SegmentIds(torch.from_numpy(sq), torch.from_numpy(sk))
    ref = ref_fa.flash_attention(
        *(jnp.asarray(x).astype(jdt) for x in (qn, kn, vn)), causal=causal,
        segment_ids=seg_ref, layout="bthd", backend="xla")
    ref = np.asarray(ref.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = flash_attention(*(torch.from_numpy(x).to(tdt) for x in (qn, kn, vn)),
                          causal=causal, segment_ids=seg_port, layout="bthd")
    assert np.abs(got.float().numpy() - ref).max() \
        <= parity.TOLERANCES["flash"][dtype]


def test_lse_is_the_log_normaliser():
    from tosem_tpu_torch.ops.flash_attention import flash_attention
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 24, 16, generator=g) for _ in range(3))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / 4.0
    s = s.masked_fill(~torch.tril(torch.ones(24, 24, dtype=torch.bool)),
                      float("-inf"))
    assert lse.shape == (1, 2, 24) and lse.dtype == torch.float32
    assert torch.allclose(lse, torch.logsumexp(s, -1), atol=1e-5)


def test_wrapper_rejects_what_it_does_not_take():
    from tosem_tpu_torch.ops.flash_attention import (flash_attention,
                                                     mha_flash_attention)
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, layout="btdh")
    with pytest.raises(ValueError):
        mha_flash_attention(q, q, q, mask=torch.ones(1, 1, 8, 8))
    with pytest.raises(ValueError):
        flash_attention(q[0], q[0], q[0])


CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tosem_tpu_torch", "ops", "csrc")
_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


def _c_params(source, name):
    """The ctypes types of the parameters of ``extern "C" int name(...)``
    in ``csrc/<source>``, parsed from the source (a pointer is
    ``c_void_p``)."""
    with open(os.path.join(CSRC, source)) as f:
        src = f.read()
    found = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src,
                      re.S)
    assert found, f"{name} not in {source}"
    types = []
    for param in found.group(1).split(","):
        param = " ".join(param.split())
        types.append(ctypes.c_void_p if "*" in param
                     else _C_TYPES[param.rsplit(" ", 1)[0]])
    return types


@pytest.mark.parametrize("name,source", [
    ("flash_fwd", "flash_fwd.cu"), ("flash_fwd_sched", "flash_fwd.cu"),
    ("flash_bwd_dq", "flash_bwd.cu"), ("flash_bwd_dkv", "flash_bwd.cu"),
    ("flash_bwd_dq_sched", "flash_bwd.cu"),
    ("flash_bwd_dkv_sched", "flash_bwd.cu")])
def test_ctypes_signatures_match_the_c_interface(name, source):
    """Each ``_ARGTYPES`` entry has the C function's parameters, one for
    one and of the same width: an int where a pointer belongs cuts the
    pointer to 32 bits on the card and nowhere else."""
    from tosem_tpu_torch.ops.flash_attention import _ARGTYPES
    assert _ARGTYPES[name] == _c_params(source, name)


def test_bf16_kernel_takes_16_byte_rows_only():
    """The bf16 forward copies rows in 16-byte pieces: the wrapper
    refuses an operand that starts off 16 bytes or whose (batch, time,
    head) strides are not multiples of 8 elements."""
    from tosem_tpu_torch.ops.flash_attention import _check_rows_aligned
    x = torch.zeros(2, 64, 4, 16, dtype=torch.bfloat16)
    _check_rows_aligned((("q", x),), "bthd")
    _check_rows_aligned((("q", x.transpose(1, 2)),), "bhtd")
    shifted = torch.zeros(x.numel() + 8, dtype=torch.bfloat16)[1:][
        :x.numel()].view(x.shape)
    with pytest.raises(ValueError, match="16 bytes"):
        _check_rows_aligned((("k", shifted),), "bthd")
    wide = torch.zeros(2, 64, 4, 20, dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="multiples of 8"):
        _check_rows_aligned((("v", wide),), "bthd")
