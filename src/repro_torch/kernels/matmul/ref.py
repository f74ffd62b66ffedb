"""Plain PyTorch matmul with f32 accumulation: the CPU path and the CUDA
kernel's oracle (the reference's ``matmul_ref``).  On a CUDA tensor it
runs in full f32 only while ``torch.backends.cuda.matmul.allow_tf32`` is
False (PyTorch's default), which the callers that compare set.

Beside it, a plain emulation of the f32 kernel's arithmetic (3xTF32,
``matmul.cu``), for the tests: the operands split into TF32 big + small,
and the three products whose sum the kernel's tensor cores take."""

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 (10 stored mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``: add half a unit of the 13
    dropped bits to the magnitude bits and clear them (a carry rounds up
    into the exponent).  NaN and inf pass through."""
    x = x.float()
    bits = x.contiguous().view(torch.int32)
    r = torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def split_tf32(x: torch.Tensor):
    """x -> (big, small) = (tf32(x), tf32(x - big)), as the kernel splits
    each operand element (x - big is exact in f32)."""
    big = tf32_rna(x)
    return big, tf32_rna(x.float() - big)


def matmul_3xtf32_emulated(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 kernel's products: small_a.big_b + big_a.small_b +
    big_a.big_b, each product of two TF32 values exact in f32, the sums in
    f32 (the kernel's tensor cores sum in another order, and truncate;
    see matmul.cu).  The dropped small.small term is ~2^-22 a product."""
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    return ((as_ @ bb + ab @ bs) + ab @ bb).to(a.dtype)


def matmul_1xtf32_emulated(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """big_a.big_b alone, a plain TF32 product: each operand off by up to
    2^-11 relative, about three decimal digits.  Not a port of the
    function; the tests hold the kernel at least 10x closer than this."""
    return (tf32_rna(a) @ tf32_rna(b)).to(a.dtype)
