"""Utilities carried from the JAX package (``metrics``, and the KV-pool
layer of ``quant``)."""
