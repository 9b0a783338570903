"""Utilities carried from the JAX package (``metrics``, the KV-pool layer of
``quant``, ``preempt``, the host data plane ``data`` and the WordPiece
front end ``text``), and ``flops`` and ``tracing`` (``torch.profiler``)
rewritten for the card."""
