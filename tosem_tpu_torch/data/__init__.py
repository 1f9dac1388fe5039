"""Data feeding of the port: manifests, the synthetic speech corpus,
padding buckets, the speech batcher and the serving layer's block-sparse
routing rule (:mod:`tosem_tpu_torch.data.feeding`), the MFCC front end
(:mod:`~tosem_tpu_torch.data.audio`), sample bundles and the LDC93S1
importer (:mod:`~tosem_tpu_torch.data.sample_collections`), scorer
packages (:mod:`~tosem_tpu_torch.data.scorer`) and the synthetic image
and MLM datasets (:mod:`~tosem_tpu_torch.data.synthetic`)."""
from tosem_tpu_torch.data.synthetic import (SyntheticImageDataset,
                                            cifar_like_batches, mlm_batches)

__all__ = ["SyntheticImageDataset", "cifar_like_batches", "mlm_batches"]
