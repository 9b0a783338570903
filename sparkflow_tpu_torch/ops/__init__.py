"""Kernels of the PyTorch port: attention for the decode-serving path.

See :mod:`sparkflow_tpu_torch.ops.attention`; the CUDA sources live in
``ops/csrc/`` and are built at first use by :mod:`._build`.
"""

from .attention import (attention_reference, flash_attention,
                        last_attention_path, paged_attention,
                        paged_attention_reference, reset_launch_counts)

__all__ = ["attention_reference", "flash_attention", "last_attention_path",
           "paged_attention", "paged_attention_reference",
           "reset_launch_counts"]
