"""tosem_tpu_torch: the PyTorch/CUDA port of ``tosem_tpu`` for one NVIDIA
H100.

The JAX package ``tosem_tpu`` stays the reference; this package is built
beside it slice by slice, with every Pallas kernel on a slice's path
rewritten by hand in CUDA C++ for ``sm_90a``. Ported so far (the BERT
serving and training slices, the BERT kernel suite, block-sparse mask
programs, the serving control plane, data-parallel training, the device
mesh, and cluster serving):

- ``tosem_tpu_torch.ops``     flash attention forward and backward (dense,
                              causal, segment ids, and the schedule mode
                              of a block-sparse mask program), paged
                              decode, fused layernorm and softmax kernels
                              (``ops/csrc``), their plain versions, the
                              mask-program compiler, the backend
                              registry, the BERT and sparse kernel suites
- ``tosem_tpu_torch.data``    padding buckets and the sparse routing rule
- ``tosem_tpu_torch.nn``      layers and attention as ``nn.Module``s
- ``tosem_tpu_torch.models``  BERT encoder / causal decoder, and the
                              converter for JAX-package parameters
- ``tosem_tpu_torch.serve``   paged KV cache, prefix cache, BERT encode
                              and greedy-decode backends, and the control
                              plane that serves them from replica
                              processes: ``Serve``, micro-batching and
                              continuous-batching queues, circuit
                              breaker, HTTP ingress; cluster serving
                              (``ClusterServe``: replicas on node agents
                              behind a tier of router processes, failover,
                              drain with live KV migration, sharded
                              replicas as gangs)
- ``tosem_tpu_torch.runtime`` the actor runtime (tasks, actors, spawned
                              workers) over a shared-memory object store
                              (``native/objstore.cpp``, built by g++)
- ``tosem_tpu_torch.obs``     metric registry and Prometheus export,
                              memory watchdog
- ``tosem_tpu_torch.train``   train state, AdamW, MLM loss, train step,
                              ``fit`` with atomic checkpoints and resume,
                              data-parallel training
                              (``DistributedTrainer``: a chain all-reduce
                              over the transport, elastic shrink/grow)
- ``tosem_tpu_torch.parallel`` meshes of positions, ``shard_map`` and
                              its collectives, the collective sweep,
                              sharding rules, sharded flash and paged
                              attention, ring/Ulysses attention
- ``tosem_tpu_torch.cluster`` the RPC plane, node agents, the head's
                              journal, failure detector and ``NodePool``,
                              gangs, the chunked tensor transport and
                              epoch fences
- ``tosem_tpu_torch.control`` the scaling policy core, SLO admission,
                              model multiplexing, the closed-loop
                              ``ControlPlane``
- ``tosem_tpu_torch.chaos``   seeded fault plans, the injection seam, the
                              survival runner's 17 scenarios and the
                              ``chaos`` CLI
- ``tosem_tpu_torch.models``  also EfficientDet and PointPillars (the NMS
                              sweep ``ops/csrc/nms.cu``), COCO-style AP
- ``tosem_tpu_torch.compile`` ``export_program`` on ``torch.export``
- ``tosem_tpu_torch.utils``   result CSVs, device timing, the roofline
- ``tosem_tpu_torch.tune``    HPO: searchers, schedulers, ``tune.run`` on
                              the runtime, training services (threads,
                              subprocesses, node agents), the experiment
                              manager behind ``hpo_cli``
- ``tosem_tpu_torch.analysis`` the study's test classification and its
                              RQ3/RQ4 tables
- ``tosem_tpu_torch.cli``     the experiment runner (``bert_kernels``,
                              ``flash_sparse``, ``allreduce``,
                              ``serve_bench``, ``detection_train``,
                              ``detection_infer``, ``pointpillars_infer``,
                              ``analysis`` and the rest)

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
    # block-sparse mask programs: the schedule mode of B1-B3
    "FullMask": ("tosem_tpu_torch.ops.mask_programs", "FullMask"),
    "CausalMask": ("tosem_tpu_torch.ops.mask_programs", "CausalMask"),
    "LocalMask": ("tosem_tpu_torch.ops.mask_programs", "LocalMask"),
    "PrefixLMMask": ("tosem_tpu_torch.ops.mask_programs", "PrefixLMMask"),
    "DocumentMask": ("tosem_tpu_torch.ops.mask_programs", "DocumentMask"),
    "MultiHeadMask": ("tosem_tpu_torch.ops.mask_programs", "MultiHeadMask"),
    "mask_from_spec": ("tosem_tpu_torch.ops.mask_programs", "mask_from_spec"),
    "compile_mask_programs": ("tosem_tpu_torch.ops.mask_programs",
                              "compile_mask_programs"),
    "select_page_size": ("tosem_tpu_torch.ops.flash_blocks",
                         "select_page_size"),
    "paged_attention": ("tosem_tpu_torch.ops.paged_attention",
                        "paged_attention"),
    "fused_layernorm": ("tosem_tpu_torch.ops.fused_norms", "fused_layernorm"),
    "fused_softmax": ("tosem_tpu_torch.ops.fused_norms", "fused_softmax"),
    "bert_kernel_suite": ("tosem_tpu_torch.ops.kernel_suite",
                          "bert_kernel_suite"),
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
    "DataParallelConfig": ("tosem_tpu_torch.train.distributed",
                           "DataParallelConfig"),
    "DistributedTrainer": ("tosem_tpu_torch.train.distributed",
                           "DistributedTrainer"),
    "DPJob": ("tosem_tpu_torch.train.distributed", "DPJob"),
    "fit_distributed": ("tosem_tpu_torch.train.distributed",
                        "fit_distributed"),
    "make_dp_train_step": ("tosem_tpu_torch.train.distributed",
                           "make_dp_train_step"),
    "sharded_flash_attention": ("tosem_tpu_torch.parallel.flash",
                                "sharded_flash_attention"),
    "ShardedAttentionBackend": ("tosem_tpu_torch.serve.backends",
                                "ShardedAttentionBackend"),
    "dp_tp_mesh": ("tosem_tpu_torch.parallel.flash", "dp_tp_mesh"),
    "sharded_paged_attention": ("tosem_tpu_torch.parallel.flash",
                                "sharded_paged_attention"),
    "ShardedPagedDecodeBackend": ("tosem_tpu_torch.serve.backends",
                                  "ShardedPagedDecodeBackend"),
    "DeadlineExceeded": ("tosem_tpu_torch.runtime.common",
                         "DeadlineExceeded"),
    "TensorReceiver": ("tosem_tpu_torch.cluster.transport",
                       "TensorReceiver"),
    "send_tensors": ("tosem_tpu_torch.cluster.transport", "send_tensors"),
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
