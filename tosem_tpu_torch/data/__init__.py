"""Data feeding helpers of the port: padding buckets and the serving
layer's block-sparse routing rule (:mod:`tosem_tpu_torch.data.feeding`),
and the synthetic datasets (:mod:`tosem_tpu_torch.data.synthetic`)."""
from tosem_tpu_torch.data.synthetic import (SyntheticImageDataset,
                                            cifar_like_batches, mlm_batches)

__all__ = ["SyntheticImageDataset", "cifar_like_batches", "mlm_batches"]
