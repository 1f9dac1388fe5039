"""Model families ported so far: BERT (encoder and causal decoder)."""
