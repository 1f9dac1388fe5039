"""Data feeding helpers of the port: padding buckets and the serving
layer's block-sparse routing rule (:mod:`tosem_tpu_torch.data.feeding`)."""
