"""Tile-reduction wrapper: the CUDA kernel (``tile_reduce.cu``) on a CUDA
tensor, the plain version (``ref.py``) on a CPU tensor.  Counterpart of
``repro.kernels.tile_reduce.tile_reduce.tile_reduce``."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.tile_reduce.ref import OPS, tile_reduce_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_MAX_TILE = 1024                                  # one tile per block at most
_ARGS = [build.P, build.P, build.I64, build.I, build.I, build.I, build.P]


def tile_reduce(x: torch.Tensor, tile_size: int, op: str = "sum") -> torch.Tensor:
    """x (n, width) -> every lane holds the sum/max/min of its
    ``tile_size``-lane tile, in x's dtype (bf16 rounded after every
    butterfly step, as the reference kernel does)."""
    if x.dim() != 2:
        raise ValueError(f"tile_reduce takes an (n, width) block; got {tuple(x.shape)}")
    n, w = x.shape
    if tile_size & (tile_size - 1) or tile_size > w:      # the reference's check
        raise ValueError(f"tile_size {tile_size} must be a power of two <= {w}")
    if tile_size > 0 and w % tile_size:
        raise ValueError(f"width {w} is not a whole number of {tile_size}-lane tiles")
    if op not in OPS:
        raise ValueError(f"op must be one of {tuple(OPS)}; got {op!r}")
    if x.device.type == "cpu":
        return tile_reduce_ref(x, tile_size, op)
    if x.dtype not in _DTYPES:
        raise TypeError(f"tile_reduce kernel takes f32/bf16/int32; got {x.dtype}")
    if tile_size > _MAX_TILE:
        raise ValueError(f"tile_reduce kernel takes tiles of at most {_MAX_TILE} lanes")
    x = x.contiguous()
    y = torch.empty_like(x)
    build.launch("repro_tile_reduce", _ARGS, x.device, x.data_ptr(), y.data_ptr(),
                 n * w, tile_size, tuple(OPS).index(op), _DTYPES[x.dtype])
    tile_reduce.launches += 1
    return y


tile_reduce.launches = 0
