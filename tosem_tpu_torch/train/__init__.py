"""Training: the train state, AdamW with optax's defaults, the MLM loss,
the train step, the preemption-safe ``fit`` and atomic checkpoints."""
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

__all__ = ["AsyncCheckpointer", "CheckpointCorruptError", "TrainState",
           "TrainingPreempted", "adamw", "create_train_state",
           "cross_entropy_loss", "fit", "latest_checkpoint",
           "make_train_step", "mlm_loss", "restore_checkpoint",
           "restore_latest", "restore_or_init", "save_checkpoint",
           "save_versioned", "shard_batch"]
