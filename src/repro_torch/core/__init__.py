"""The paper's layer: warp-level features with HW and SW implementation paths.

Counterpart of ``repro.core`` (``warp``, ``hw_backend``, ``sw_backend``,
``primitives``), mirroring the paper's two solutions:
  - HW path (``backend='hw'``): lanes exchange values in one vectorised
    op, the ``vx_shfl`` / ``vx_vote`` / ``vx_tile`` ISA-extension
    analogue.  On Hopper it is literal in the warp-intrinsic CUDA kernels
    of ``repro_torch.kernels`` (``warp_ops``, ``tile_reduce``, ``mse``).
  - SW path (``backend='sw'``): the extended parallel-region
    transformation, loop serialisation + the memory-array rewrite rules of
    Table III.
"""

from repro_torch.core.warp import (
    MIN_GRANULE,
    TileGroup,
    WarpConfig,
    full_warp_tile,
    group_mask_for,
    size_from_group_mask,
)
from repro_torch.core.primitives import (
    get_default_backend,
    match_any,
    set_default_backend,
    shfl_down,
    shfl_idx,
    shfl_up,
    shfl_xor,
    tile_reduce,
    vote_all,
    vote_any,
    vote_ballot,
    vote_uni,
    warp_reduce,
    warp_scan,
)

__all__ = [
    "MIN_GRANULE",
    "TileGroup",
    "WarpConfig",
    "full_warp_tile",
    "group_mask_for",
    "size_from_group_mask",
    "get_default_backend",
    "set_default_backend",
    "shfl_up",
    "shfl_down",
    "shfl_xor",
    "shfl_idx",
    "vote_all",
    "vote_any",
    "vote_uni",
    "vote_ballot",
    "match_any",
    "warp_reduce",
    "warp_scan",
    "tile_reduce",
]
