"""Model families ported so far: BERT (encoder and causal decoder, MoE
layers included), the encoder as pipeline stages (``bert_pipeline``),
ResNet (``resnet``), the DeepSpeech-family acoustic model (``speech``),
and detection: EfficientDet (``efficientdet``), PointPillars
(``pointpillars``) and COCO-style AP (``detection_eval``)."""
from tosem_tpu_torch.models.resnet import (BottleneckBlock, ResNet,
                                           resnet18_ish, resnet50)

__all__ = ["BottleneckBlock", "ResNet", "resnet18_ish", "resnet50"]
