"""The PyTorch port stands alone: importing it loads neither JAX nor
Triton, no module of it imports the JAX package, and its entry points
refuse to run on a missing GPU instead of carrying on on the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tosem_tpu_torch")


def _package_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_import_loads_neither_jax_nor_triton():
    code = ("import sys, tosem_tpu_torch; "
            "from tosem_tpu_torch.serve import backends; "
            "from tosem_tpu_torch.ops import flash_attention, paged_attention;"
            " from tosem_tpu_torch import train, chaos; "
            "from tosem_tpu_torch.train import checkpoint, trainer; "
            "from tosem_tpu_torch.ops import fused_norms, kernel_suite; "
            "from tosem_tpu_torch.utils import results, timing, roofline; "
            "from tosem_tpu_torch import cli; "
            "print(sorted(m for m in ('jax', 'triton', 'tosem_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("module", ["tosem_tpu_torch.ops.mask_programs",
                                    "tosem_tpu_torch.data.feeding"])
def test_copied_modules_import_alone(module):
    """The mask-program compiler and the feeding rule are copies of JAX
    package modules: importing either loads neither JAX nor the JAX
    package."""
    code = (f"import sys, {module}; "
            "print(sorted(m for m in ('jax', 'triton', 'tosem_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.stdout.strip() == "[]"


def test_no_module_imports_the_jax_package():
    offenders = []
    for path in _package_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in ("tosem_tpu", "jax", "jaxlib", "triton"):
                    offenders.append((os.path.relpath(path, ROOT), n))
    assert offenders == []


def test_every_lazy_export_resolves():
    import tosem_tpu_torch
    for name in tosem_tpu_torch.__all__:
        assert getattr(tosem_tpu_torch, name) is not None


@pytest.mark.parametrize("entry", ["bert", "kv_cache", "decode", "encode"])
def test_default_device_raises_without_a_gpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.serve.backends import (BertDecodeBackend,
                                                BertEncodeBackend)
    from tosem_tpu_torch.serve.kv_cache import PagedKVCache
    make = {"bert": lambda: Bert(BertConfig.tiny()),
            "kv_cache": lambda: PagedKVCache(4, 8, 1, 2, 16),
            "decode": lambda: BertDecodeBackend(),
            "encode": lambda: BertEncodeBackend()}[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        make()


def test_cuda_tensor_never_resolves_to_the_plain_version():
    from tosem_tpu_torch.ops import registry
    with pytest.raises(registry.BackendUnavailable):
        registry.resolve("flash", "torch", platform="cuda")
    with pytest.raises(registry.BackendUnavailable):
        registry.resolve("paged", "cuda", platform="cpu")
    assert registry.resolve("paged", platform="cuda") == "cuda"
    assert registry.resolve("flash", platform="cpu") == "torch"
    with pytest.raises(registry.BackendUnavailable):
        registry.resolve("flash", platform="cuda", dtype="float16")


@pytest.mark.parametrize("family", ["flash", "schedule", "paged", "norms"])
@pytest.mark.parametrize("backend,platform,dtype,served", [
    (None, "cuda", "bfloat16", "cuda"), (None, "cuda", "float32", "cuda"),
    ("cuda", "cuda", None, "cuda"), (None, "cpu", "float16", "torch"),
    ("torch", "cpu", "bfloat16", "torch"),
    ("torch", "cuda", "bfloat16", None), ("cuda", "cpu", "float32", None),
    (None, "cuda", "float64", None), ("xla", "cpu", None, None)])
def test_resolve_decides_by_platform_and_dtype_alone(family, backend,
                                                     platform, dtype, served):
    from tosem_tpu_torch.ops import registry
    if served is None:
        with pytest.raises(registry.BackendUnavailable):
            registry.resolve(family, backend, platform=platform, dtype=dtype)
    else:
        assert registry.resolve(family, backend, platform=platform,
                                dtype=dtype) == served


def test_resolve_rejects_an_unknown_family():
    from tosem_tpu_torch.ops import registry
    with pytest.raises(ValueError, match="family"):
        registry.resolve("nope", platform="cpu")


def test_registry_has_the_norms_family_and_its_counts():
    from tosem_tpu_torch.ops import registry
    assert "norms" in registry.FAMILIES
    assert registry.resolve("norms", platform="cuda",
                            dtype="bfloat16") == "cuda"
    assert {"ln_fwd", "ln_bwd", "sm_fwd", "sm_bwd"} <= set(
        registry.LAUNCH_COUNTS)
    registry.reset_launch_counts()
    assert set(registry.LAUNCH_COUNTS.values()) == {0}


def test_ops_package_exports_lazily():
    import tosem_tpu_torch
    from tosem_tpu_torch import ops
    from tosem_tpu_torch.ops import fused_norms, kernel_suite
    assert ops.fused_layernorm is fused_norms.fused_layernorm
    assert ops.fused_softmax is fused_norms.fused_softmax
    assert ops.bert_kernel_suite is kernel_suite.bert_kernel_suite
    assert tosem_tpu_torch.fused_softmax is fused_norms.fused_softmax
    with pytest.raises(AttributeError):
        ops.no_such_export


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    csrc = os.path.join(PKG, "ops", "csrc")
    notes = {"flash_fwd.cu": ["_fwd_kernel"],
             "flash_bwd.cu": ["_bwd_dkv_kernel", "_bwd_dq_kernel"],
             "paged_decode.cu": ["_decode_kernel", "_decode_multi_kernel"],
             "fused_norms.cu": ["_ln_fwd_kernel", "_ln_bwd_kernel",
                                "_sm_fwd_kernel", "_sm_bwd_kernel"]}
    for name, kernels in notes.items():
        head = open(os.path.join(csrc, name)).read().split("#include")[0]
        assert "Replaces" in head and "bounds it" in head
        for k in kernels:
            assert k in head
