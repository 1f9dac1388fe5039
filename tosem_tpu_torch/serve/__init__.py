"""Serving: paged KV cache, prefix cache, step-callable keys and the
BERT encode/decode backends."""
