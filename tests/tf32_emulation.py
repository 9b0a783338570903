"""The 3xTF32 arithmetic of the port's float32 tensor-core kernels
(``csrc/mma_tf32.cuh``), emulated in PyTorch on the CPU, for the tests of
the kernels' numerics (test_torch_flash_fwd_tf32.py,
test_torch_flash_bwd_tf32.py):

- TF32 rounding as ``cvt.rna.tf32.f32`` does it, on float32 bit patterns:
  10 mantissa bits kept, to nearest, ties away from zero;
- each product split into big = tf32(x) and small = tf32(x - big) of both
  operands, summed k-step by k-step of 8 (the m16n8k8 depth) in order,
  small terms first: small_a * big_b, big_a * small_b, big_a * big_b.
"""

import torch

LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on each float32 of ``x``: the low 13 bits of
    the pattern rounded off, to nearest, ties away from zero (adding half
    of the dropped range to the magnitude bits carries into the kept ones
    exactly when the dropped bits are at least half)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def product(a, b, mode, acc=None):
    """``acc + a @ b`` ([..., M, K] x [..., K, N], float32; ``acc`` zeros if
    None) as the kernels take it: k-steps of 8 in order, each added to the
    float32 accumulator as three TF32 products, small terms first
    (``mode="3x"``), as the one big_a * big_b product (``"1x"``), or
    unrounded (``"float32"``). K is zero-padded to a multiple of 8, as the
    kernels' tiles are zero-filled past the ragged edge."""
    k = a.shape[-1]
    pad = -k % 8
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    if acc is None:
        acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, k + pad, 8):
        if mode == "float32":
            acc = acc + a[..., k0:k0 + 8] @ b[..., k0:k0 + 8, :]
            continue
        ab, a_s = split(a[..., k0:k0 + 8])
        bb, b_s = split(b[..., k0:k0 + 8, :])
        if mode == "3x":
            acc = acc + a_s @ bb
            acc = acc + ab @ b_s
        acc = acc + ab @ bb
    return acc
