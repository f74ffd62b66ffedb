"""Plain PyTorch tile reduction: the CPU path and the CUDA kernel's oracle.

It runs the reference *Pallas kernel's* butterfly (``tile_reduce.py``),
step by step in the input dtype, not the reference's ``tile_reduce_ref``
segment fold: in bf16 the kernel rounds after every step, and a fold
rounds once, so the two differ by up to a few bf16 ulps of the sum.
"""

from __future__ import annotations

import torch

OPS = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def tile_reduce_ref(x: torch.Tensor, tile_size: int, op: str = "sum") -> torch.Tensor:
    """x (n, width): every lane gets its ``tile_size``-lane tile's
    reduction, via the xor butterfly cut to log2(tile_size) steps."""
    fn = OPS[op]
    lanes = torch.arange(x.shape[-1], device=x.device)
    offset = tile_size // 2
    while offset >= 1:
        x = fn(x, x.index_select(-1, lanes ^ offset))  # stays inside the tile
        offset //= 2
    return x
