"""Model families ported so far: BERT (encoder and causal decoder, MoE
layers included), the encoder as pipeline stages (``bert_pipeline``),
ResNet (``resnet``) and the DeepSpeech-family acoustic model
(``speech``)."""
from tosem_tpu_torch.models.resnet import (BottleneckBlock, ResNet,
                                           resnet18_ish, resnet50)

__all__ = ["BottleneckBlock", "ResNet", "resnet18_ish", "resnet50"]
