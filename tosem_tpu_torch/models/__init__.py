"""Model families ported so far: BERT (encoder and causal decoder), and
the encoder as pipeline stages (``bert_pipeline``)."""
