"""Training: the train state, AdamW with optax's defaults, the MLM loss,
the train step, the preemption-safe ``fit`` and atomic checkpoints, and
data-parallel training over the tensor transport (``DistributedTrainer``,
bit-identical to the single-process fold at any world size)."""
from tosem_tpu_torch.train.trainer import (TrainState, TrainingPreempted,
                                           adamw, create_train_state,
                                           cross_entropy_loss, fit,
                                           make_train_step, mlm_loss,
                                           shard_batch)
from tosem_tpu_torch.train.checkpoint import (AsyncCheckpointer,
                                              CheckpointCorruptError,
                                              latest_checkpoint,
                                              restore_checkpoint,
                                              restore_latest, restore_or_init,
                                              save_checkpoint, save_versioned)
from tosem_tpu_torch.train.distributed import (Bucket, DataParallelConfig,
                                               DistributedTrainer, DPJob,
                                               DPState, TrainWorkerLost,
                                               demo_job,
                                               dp_params_from_numpy,
                                               fit_distributed, jobs_stats,
                                               make_dp_train_step,
                                               partition_buckets)

__all__ = ["AsyncCheckpointer", "Bucket", "CheckpointCorruptError",
           "DPJob", "DPState", "DataParallelConfig", "DistributedTrainer",
           "TrainState", "TrainWorkerLost", "TrainingPreempted", "adamw",
           "create_train_state", "cross_entropy_loss", "demo_job",
           "dp_params_from_numpy", "fit", "fit_distributed", "jobs_stats",
           "latest_checkpoint", "make_dp_train_step", "make_train_step",
           "mlm_loss", "partition_buckets", "restore_checkpoint",
           "restore_latest", "restore_or_init", "save_checkpoint",
           "save_versioned", "shard_batch"]
