"""Kernels and their plain versions: flash attention forward and
backward, paged decode attention, fused layernorm and softmax (CUDA C++
in ``csrc/``), the backend registry, the kernel build and the BERT kernel
suite. Submodules import lazily; nothing here loads a kernel."""

# exported lazily (PEP 562), as the JAX package's ops/__init__ exports them
_LAZY_EXPORTS = {
    "fused_layernorm": ("tosem_tpu_torch.ops.fused_norms", "fused_layernorm"),
    "fused_softmax": ("tosem_tpu_torch.ops.fused_norms", "fused_softmax"),
    "bert_kernel_suite": ("tosem_tpu_torch.ops.kernel_suite",
                          "bert_kernel_suite"),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    value = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = value
    return value
