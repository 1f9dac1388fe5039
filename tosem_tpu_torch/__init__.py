"""tosem_tpu_torch: the PyTorch/CUDA port of ``tosem_tpu`` for one NVIDIA
H100.

The JAX package ``tosem_tpu`` stays the reference; this package is built
beside it slice by slice, with every Pallas kernel on a slice's path
rewritten by hand in CUDA C++ for ``sm_90a``. Ported so far (the BERT
serving and training slices):

- ``tosem_tpu_torch.ops``     flash attention forward and backward and
                              paged decode kernels (``ops/csrc``), their
                              plain versions, the backend registry
- ``tosem_tpu_torch.nn``      layers and attention as ``nn.Module``s
- ``tosem_tpu_torch.models``  BERT encoder / causal decoder, and the
                              converter for JAX-package parameters
- ``tosem_tpu_torch.serve``   paged KV cache, prefix cache, BERT encode
                              and greedy-decode backends
- ``tosem_tpu_torch.train``   train state, AdamW, MLM loss, train step,
                              ``fit`` with atomic checkpoints and resume
- ``tosem_tpu_torch.chaos``   the chaos injection seam (``train.step``)

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``.
``import tosem_tpu_torch`` loads neither JAX nor Triton, and builds no
kernel: each kernel is compiled by ``nvcc`` at its first launch.
"""

__version__ = "0.1.0"

# exported lazily (PEP 562) so the import stays light
_LAZY_EXPORTS = {
    "BackendUnavailable": ("tosem_tpu_torch.ops.registry",
                           "BackendUnavailable"),
    "LAUNCH_COUNTS": ("tosem_tpu_torch.ops.registry", "LAUNCH_COUNTS"),
    "SegmentIds": ("tosem_tpu_torch.ops.flash_attention", "SegmentIds"),
    "flash_attention": ("tosem_tpu_torch.ops.flash_attention",
                        "flash_attention"),
    "BlockSizes": ("tosem_tpu_torch.ops.flash_blocks", "BlockSizes"),
    "select_page_size": ("tosem_tpu_torch.ops.flash_blocks",
                         "select_page_size"),
    "paged_attention": ("tosem_tpu_torch.ops.paged_attention",
                        "paged_attention"),
    "Bert": ("tosem_tpu_torch.models.bert", "Bert"),
    "BertConfig": ("tosem_tpu_torch.models.bert", "BertConfig"),
    "bert_params_from_numpy": ("tosem_tpu_torch.models.convert",
                               "bert_params_from_numpy"),
    "PagedKVCache": ("tosem_tpu_torch.serve.kv_cache", "PagedKVCache"),
    "CachePressure": ("tosem_tpu_torch.serve.kv_cache", "CachePressure"),
    "PrefixCache": ("tosem_tpu_torch.serve.prefix_cache", "PrefixCache"),
    "BertEncodeBackend": ("tosem_tpu_torch.serve.backends",
                          "BertEncodeBackend"),
    "BertDecodeBackend": ("tosem_tpu_torch.serve.backends",
                          "BertDecodeBackend"),
    "TrainState": ("tosem_tpu_torch.train.trainer", "TrainState"),
    "TrainingPreempted": ("tosem_tpu_torch.train.trainer",
                          "TrainingPreempted"),
    "adamw": ("tosem_tpu_torch.train.trainer", "adamw"),
    "create_train_state": ("tosem_tpu_torch.train.trainer",
                           "create_train_state"),
    "cross_entropy_loss": ("tosem_tpu_torch.train.trainer",
                           "cross_entropy_loss"),
    "mlm_loss": ("tosem_tpu_torch.train.trainer", "mlm_loss"),
    "make_train_step": ("tosem_tpu_torch.train.trainer", "make_train_step"),
    "fit": ("tosem_tpu_torch.train.trainer", "fit"),
    "CheckpointCorruptError": ("tosem_tpu_torch.train.checkpoint",
                               "CheckpointCorruptError"),
}

__all__ = sorted(_LAZY_EXPORTS)


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
