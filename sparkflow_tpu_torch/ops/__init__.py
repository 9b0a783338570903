"""Kernels of the PyTorch port: attention for the decode-serving,
speculative-decoding and training paths, and ring attention (sequence
parallelism) over the flash kernels.

See :mod:`sparkflow_tpu_torch.ops.attention`; the CUDA sources live in
``ops/csrc/`` and are built at first use by :mod:`._build`.
"""

from .attention import (FlashAttentionFunction, attention_reference,
                        flash_attention, flash_attention_backward,
                        flash_attention_backward_reference, flash_bwd_dkv,
                        flash_bwd_dkv_reference, flash_bwd_dq,
                        flash_bwd_dq_reference, last_attention_path,
                        launch_counts, paged_attention,
                        paged_attention_reference, paged_attention_verify,
                        paged_attention_verify_reference,
                        reset_launch_counts, ring_attention,
                        ring_flash_attention)

__all__ = ["FlashAttentionFunction", "attention_reference",
           "flash_attention", "flash_attention_backward",
           "flash_attention_backward_reference", "flash_bwd_dkv",
           "flash_bwd_dkv_reference", "flash_bwd_dq",
           "flash_bwd_dq_reference", "last_attention_path", "launch_counts",
           "paged_attention", "paged_attention_reference",
           "paged_attention_verify", "paged_attention_verify_reference",
           "reset_launch_counts", "ring_attention", "ring_flash_attention"]
