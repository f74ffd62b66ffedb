"""Warp and cooperative-group abstractions (the ``vx_tile`` analogue).

Counterpart of ``repro.core.warp``.  The paper's Vortex extension reshapes
warps dynamically: ``vx_tile(group_mask, size)`` merges or splits warps so
that a cooperative-group tile of ``size`` threads becomes a schedulable
unit (Table II of the paper).  Here a "warp" is a *lane group*: the
trailing axis of an ``(..., num_warps, warp_size)`` tensor.  ``TileGroup``
carries what ``vx_tile`` encodes in hardware: the group size and the
Table II group mask (one bit per minimal-granule slot, set where a new
group starts).  On Hopper a tile of at most 32 lanes is a
``thread_block_tile<size>`` inside one CUDA warp; wider warps (up to the
reference's 128) span several CUDA warps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Minimal warp granule: Table II uses 4-thread granules for a 32-thread
# core (8 mask bits).  Vortex starts cores with 4-thread warps and merges
# them through vx_tile.
MIN_GRANULE = 4


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class WarpConfig:
    """Static warp-level configuration of a core.

    warp_size: threads per (merged) warp, a power of two of at most 128
        (the reference's lane-group limit, kept so both packages accept
        the same configurations).
    num_warps: warps per thread block (Vortex: 4 warps x 8 threads).
    """

    warp_size: int = 32
    num_warps: int = 4

    def __post_init__(self):
        if not _is_pow2(self.warp_size):
            raise ValueError(f"warp_size must be a power of two, got {self.warp_size}")
        if self.warp_size > 128:
            raise ValueError("warp_size > 128 exceeds the reference's lane-group width")
        if self.num_warps < 1:
            raise ValueError("num_warps must be >= 1")

    @property
    def block_size(self) -> int:
        return self.warp_size * self.num_warps


def group_mask_for(size: int, warp_size: int, granule: int = MIN_GRANULE) -> int:
    """Table II group mask: bit i (MSB-first over warp_size/granule slots)
    is set where a new group of ``size`` threads starts at slot i.

    warp_size=32, granule=4 (8 slots), as in the paper:
      size=32 -> 0b10000000, 16 -> 0b10001000, 8 -> 0b10101010,
      4 -> 0b11111111.
    """
    if size < granule or size > warp_size or not _is_pow2(size):
        raise ValueError(f"tile size {size} invalid for warp_size={warp_size}")
    n_slots = warp_size // granule
    stride = size // granule
    mask = 0
    for slot in range(0, n_slots, stride):
        mask |= 1 << (n_slots - 1 - slot)  # MSB-first, as printed in Table II
    return mask


def size_from_group_mask(mask: int, warp_size: int, granule: int = MIN_GRANULE) -> int:
    """Inverse of :func:`group_mask_for` for uniform masks."""
    n_slots = warp_size // granule
    bits = [(mask >> (n_slots - 1 - i)) & 1 for i in range(n_slots)]
    if bits[0] != 1:
        raise ValueError("group mask must mark slot 0 as a group start")
    starts = [i for i, b in enumerate(bits) if b]
    strides = {b - a for a, b in zip(starts, starts[1:])} or {n_slots}
    if len(strides) != 1:
        raise ValueError(f"non-uniform group mask {mask:#b} unsupported")
    return next(iter(strides)) * granule


@dataclasses.dataclass(frozen=True)
class TileGroup:
    """A cooperative-group tile: ``tiled_partition(block, size)``.

    CUDA's ``thread_block_tile<size>`` and the paper's ``vx_tile``:
    ``size`` threads per group, ``group_mask`` per Table II.  Every
    warp-level primitive takes a TileGroup and then works within
    ``size``-lane segments of the lane axis.
    """

    size: int
    warp: WarpConfig = WarpConfig()

    def __post_init__(self):
        if not _is_pow2(self.size) or self.size > self.warp.warp_size:
            raise ValueError(
                f"tile size {self.size} must be a power of two <= warp_size "
                f"{self.warp.warp_size}")

    @property
    def group_mask(self) -> int:
        return group_mask_for(self.size, self.warp.warp_size)

    @property
    def num_groups_per_warp(self) -> int:
        return self.warp.warp_size // self.size

    # accessor methods, PR-transformation rules of Table III
    def thread_rank(self, tid):
        """thread_group::thread_rank() == tid % group_size."""
        return tid % self.size

    def meta_group_rank(self, tid):
        """thread_group::meta_group_rank() == tid / group_size."""
        return tid // self.size

    def num_threads(self):
        """thread_group::num_threads() == group_size."""
        return self.size


def full_warp_tile(warp: WarpConfig = WarpConfig()) -> TileGroup:
    """The default configuration: one group spanning the whole warp."""
    return TileGroup(size=warp.warp_size, warp=warp)


def segment_view(value: torch.Tensor, tile: Optional[TileGroup], warp_size: int):
    """Reshape the trailing lane axis (warp_size,) into (n_groups, size):
    a merged warp sees its members contiguously."""
    size = tile.size if tile is not None else warp_size
    if value.shape[-1] != warp_size:
        raise ValueError(f"lane axis {value.shape[-1]} != warp_size {warp_size}")
    n_groups = warp_size // size
    return value.reshape(value.shape[:-1] + (n_groups, size)), n_groups, size


def unsegment_view(value: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`segment_view`."""
    return value.reshape(value.shape[:-2] + (value.shape[-2] * value.shape[-1],))
