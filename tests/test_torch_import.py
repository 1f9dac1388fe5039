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
    """Nor ``ml_dtypes``, which the card's machine does not have: bf16
    KV payloads travel as uint16 bits."""
    code = ("import sys, tosem_tpu_torch; "
            "from tosem_tpu_torch.serve import backends; "
            "from tosem_tpu_torch.ops import flash_attention, paged_attention;"
            " from tosem_tpu_torch import train, chaos; "
            "from tosem_tpu_torch.train import checkpoint, trainer; "
            "from tosem_tpu_torch.ops import fused_norms, kernel_suite; "
            "from tosem_tpu_torch.utils import results, timing, roofline; "
            "from tosem_tpu_torch import cli; "
            "from tosem_tpu_torch import runtime, obs, native; "
            "from tosem_tpu_torch.serve import (batching, core, http, "
            "breaker); "
            "from tosem_tpu_torch.chaos import plan, injector; "
            "from tosem_tpu_torch.serve import kv_cache, prefix_cache; "
            "from tosem_tpu_torch.train import distributed; "
            "from tosem_tpu_torch.cluster import fencing, transport; "
            "from tosem_tpu_torch.chaos import network; "
            "print(sorted(m for m in ('jax', 'triton', 'tosem_tpu', "
            "'ml_dtypes') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.stdout.strip() == "[]"


# the port's copies of JAX-package modules that import no JAX there
COPIED_MODULES = [
    "tosem_tpu_torch.ops.mask_programs", "tosem_tpu_torch.data.feeding",
    "tosem_tpu_torch.native", "tosem_tpu_torch.runtime",
    "tosem_tpu_torch.runtime.object_store", "tosem_tpu_torch.runtime.common",
    "tosem_tpu_torch.runtime.worker", "tosem_tpu_torch.runtime.runtime",
    "tosem_tpu_torch.runtime.api", "tosem_tpu_torch.obs",
    "tosem_tpu_torch.obs.metrics", "tosem_tpu_torch.obs.httpd",
    "tosem_tpu_torch.obs.memory_monitor", "tosem_tpu_torch.chaos",
    "tosem_tpu_torch.chaos.plan", "tosem_tpu_torch.chaos.injector",
    "tosem_tpu_torch.serve.breaker", "tosem_tpu_torch.serve.batching",
    "tosem_tpu_torch.serve.core", "tosem_tpu_torch.serve.http",
    "tosem_tpu_torch.chaos.network", "tosem_tpu_torch.cluster",
    "tosem_tpu_torch.cluster.fencing", "tosem_tpu_torch.cluster.transport",
    "tosem_tpu_torch.train.distributed"]
# the control plane: a replica of a plain backend imports these only
CONTROL_MODULES = [m for m in COPIED_MODULES
                   if m.split(".")[1] in ("native", "runtime", "obs",
                                          "chaos", "serve", "cluster")]


@pytest.mark.parametrize("module", COPIED_MODULES)
def test_copied_modules_import_alone(module):
    """The mask-program compiler, the feeding rules, the runtime, the
    observability and chaos layers and the serving control plane are
    copies of JAX package modules: importing any one of them loads
    neither JAX nor the JAX package."""
    code = (f"import sys, {module}; "
            "print(sorted(m for m in ('jax', 'triton', 'tosem_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("module", CONTROL_MODULES)
def test_control_plane_modules_load_no_torch(module):
    """The runtime and the serving control plane stand apart from the
    model: a replica that unpickles a queue, the batching wrapper or a
    plain backend does not pay for importing torch."""
    code = (f"import sys, {module}; "
            "print(sorted(m for m in ('torch', 'numpy.linalg', 'jax') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert "torch" not in out.stdout and "jax" not in out.stdout


def test_default_start_method_is_spawn_once_torch_is_loaded():
    code = ("import os; os.environ.pop('TOSEM_RT_START_METHOD', None); "
            "import tosem_tpu_torch.runtime as rt; "
            "from tosem_tpu_torch.runtime.runtime import "
            "_default_start_method as d; before = d(); import torch; "
            "print(before, d())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.stdout.split() == ["fork", "spawn"]


def test_scan_reaches_every_subpackage_and_function_level_imports():
    """The no-JAX scan below walks every file of every subpackage and
    every import inside a function body, where the copied control plane
    keeps most of its imports."""
    subpackages = {os.path.relpath(p, PKG).split(os.sep)[0]
                   for p in _package_files()}
    assert {"native", "runtime", "obs", "chaos", "serve", "ops",
            "train", "cluster"} <= subpackages
    nested = {}
    for path in _package_files():
        tree = ast.parse(open(path).read(), path)
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for n in ast.walk(fn):
                    if isinstance(n, ast.ImportFrom) and n.module:
                        rel = os.path.relpath(path, PKG)
                        nested.setdefault(rel, set()).add(n.module)
    for rel in ("runtime/runtime.py", "serve/batching.py",
                "serve/core.py", "chaos/injector.py"):
        assert any(m.startswith("tosem_tpu_torch.")
                   for m in nested[rel.replace("/", os.sep)]), rel


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


def test_parallel_and_sharded_replicas_load_neither_jax_nor_triton():
    """The device mesh, its sharded ops and the sharded replicas import
    neither JAX, Triton nor the JAX package."""
    code = ("import sys; import tosem_tpu_torch.parallel as par; "
            "from tosem_tpu_torch.parallel import (mesh, spmd, collectives, "
            "sharding, flash, ring); "
            "[getattr(par, n) for n in par.__all__]; "
            "from tosem_tpu_torch.serve.backends import ("
            "ShardedAttentionBackend, ShardedPagedDecodeBackend); "
            "from tosem_tpu_torch.ops.paged_attention import "
            "paged_partition_specs; "
            "print(sorted(m for m in ('jax', 'triton', 'tosem_tpu', "
            "'ml_dtypes') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("entry", ["make_mesh", "default_mesh", "dp_tp_mesh",
                                   "attention_replica", "paged_replica"])
def test_a_mesh_without_devices_raises_without_a_gpu(entry):
    """With no ``devices`` a mesh takes every card; with none it raises
    and never moves its positions to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: every card is a valid default")
    from tosem_tpu_torch.parallel import (MeshSpec, default_mesh,
                                          dp_tp_mesh, make_mesh)
    from tosem_tpu_torch.serve.backends import (ShardedAttentionBackend,
                                                ShardedPagedDecodeBackend)
    make = {"make_mesh": lambda: make_mesh(MeshSpec.of(dp=-1)),
            "default_mesh": lambda: default_mesh("x"),
            "dp_tp_mesh": lambda: dp_tp_mesh(1, 1),
            "attention_replica": lambda: ShardedAttentionBackend(dp=2, tp=2),
            "paged_replica": lambda: ShardedPagedDecodeBackend(dp=2,
                                                               tp=2)}[entry]
    with pytest.raises(RuntimeError, match="cuda|device_count"):
        make()
