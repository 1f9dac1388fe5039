"""Model families ported so far: BERT (encoder and causal decoder), the
encoder as pipeline stages (``bert_pipeline``), and ResNet (``resnet``)."""
from tosem_tpu_torch.models.resnet import (BottleneckBlock, ResNet,
                                           resnet18_ish, resnet50)

__all__ = ["BottleneckBlock", "ResNet", "resnet18_ish", "resnet50"]
