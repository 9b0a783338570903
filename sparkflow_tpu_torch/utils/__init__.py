"""Utilities carried from the JAX package (``metrics``)."""
