"""Utilities carried from the JAX package (``metrics``, the KV-pool layer of
``quant``, ``preempt``, the host data plane ``data`` and the WordPiece
front end ``text``), and ``flops`` rewritten for the card."""
