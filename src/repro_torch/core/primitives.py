"""Public warp-level primitive API with HW/SW backend dispatch.

Counterpart of ``repro.core.primitives``: the ``vx_*`` intrinsic surface
of the paper (Table I).  Every function takes tensors whose **trailing
axis is the warp's lane axis** and an optional
:class:`~repro_torch.core.warp.TileGroup` restricting the collective to
cooperative-group segments (the ``vx_tile`` configuration).

``backend='hw'`` lowers to vectorised lane ops (hw_backend, the ISA
extension path); ``backend='sw'`` lowers to the PR-transformation
memory-array form (sw_backend, the software-only path).  Both are plain
PyTorch on any device, differentiable where float, and compute the same
function.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import hw_backend as _hw
from repro_torch.core import sw_backend as _sw
from repro_torch.core.warp import TileGroup, segment_view, unsegment_view

_BACKENDS = {"hw": _hw, "sw": _sw}
_DEFAULT_BACKEND = "hw"


def set_default_backend(name: str) -> None:
    global _DEFAULT_BACKEND
    if name not in _BACKENDS:
        raise ValueError(f"unknown backend {name!r}; expected 'hw' or 'sw'")
    _DEFAULT_BACKEND = name


def get_default_backend() -> str:
    return _DEFAULT_BACKEND


def _resolve(backend: Optional[str]):
    return _BACKENDS[backend or _DEFAULT_BACKEND]


def _seg_apply(fn, value, tile, warp_size, *args, **kwargs):
    """Apply a segment-level op within tile groups of the lane axis."""
    ws = warp_size if warp_size is not None else value.shape[-1]
    seg, n_groups, size = segment_view(value, tile, ws)
    out = fn(seg, *args, width=size, **kwargs)
    if out.shape[-1] == size:  # lane-shaped result
        return unsegment_view(out)
    return out  # group-shaped result (e.g. ballot words)


# -- shuffles ----------------------------------------------------------------

def shfl_up(value, delta: int, *, tile: Optional[TileGroup] = None,
            warp_size: Optional[int] = None, backend: Optional[str] = None):
    be = _resolve(backend)
    return _seg_apply(lambda v, width: be.shfl_up(v, delta, width), value, tile, warp_size)


def shfl_down(value, delta: int, *, tile: Optional[TileGroup] = None,
              warp_size: Optional[int] = None, backend: Optional[str] = None):
    be = _resolve(backend)
    return _seg_apply(lambda v, width: be.shfl_down(v, delta, width), value, tile, warp_size)


def shfl_xor(value, mask: int, *, tile: Optional[TileGroup] = None,
             warp_size: Optional[int] = None, backend: Optional[str] = None):
    be = _resolve(backend)
    return _seg_apply(lambda v, width: be.shfl_xor(v, mask, width), value, tile, warp_size)


def shfl_idx(value, src_lane, *, tile: Optional[TileGroup] = None,
             warp_size: Optional[int] = None, backend: Optional[str] = None):
    be = _resolve(backend)
    ws = warp_size if warp_size is not None else value.shape[-1]
    if isinstance(src_lane, torch.Tensor) and src_lane.dim() >= 1:
        src_lane, _, _ = segment_view(src_lane, tile, ws)
    return _seg_apply(lambda v, width: be.shfl_idx(v, src_lane, width), value, tile, ws)


# -- votes -------------------------------------------------------------------

def vote_all(pred, *, member_mask=None, tile: Optional[TileGroup] = None,
             warp_size: Optional[int] = None, backend: Optional[str] = None):
    be = _resolve(backend)
    return _seg_apply(lambda v, width: be.vote_all(v, width, member_mask),
                      pred, tile, warp_size)


def vote_any(pred, *, member_mask=None, tile: Optional[TileGroup] = None,
             warp_size: Optional[int] = None, backend: Optional[str] = None):
    be = _resolve(backend)
    return _seg_apply(lambda v, width: be.vote_any(v, width, member_mask),
                      pred, tile, warp_size)


def vote_uni(value, *, member_mask=None, tile: Optional[TileGroup] = None,
             warp_size: Optional[int] = None, backend: Optional[str] = None):
    be = _resolve(backend)
    return _seg_apply(lambda v, width: be.vote_uni(v, width, member_mask),
                      value, tile, warp_size)


def vote_ballot(pred, *, member_mask=None, tile: Optional[TileGroup] = None,
                warp_size: Optional[int] = None, backend: Optional[str] = None):
    """Returns one packed word set per group: (..., [n_words]) without a
    tile (CUDA's per-warp uint32), or (..., n_groups, [n_words]) with a
    tile.  The word axis is squeezed when the segment fits one word."""
    be = _resolve(backend)
    ws = warp_size if warp_size is not None else pred.shape[-1]
    seg, n_groups, size = segment_view(pred, tile, ws)
    out = be.vote_ballot(seg, size, member_mask)  # (..., n_groups[, n_words])
    if tile is None:
        out = out.squeeze(pred.dim() - 1)  # drop the singleton group axis
    return out


def match_any(value, *, member_mask=None, tile: Optional[TileGroup] = None,
              warp_size: Optional[int] = None, backend: Optional[str] = None):
    be = _resolve(backend)
    return _seg_apply(lambda v, width: be.match_any(v, width, member_mask),
                      value, tile, warp_size)


# -- reductions / scans -------------------------------------------------------

def warp_reduce(value, op: str = "sum", *, tile: Optional[TileGroup] = None,
                warp_size: Optional[int] = None, backend: Optional[str] = None):
    be = _resolve(backend)
    return _seg_apply(lambda v, width: be.warp_reduce(v, width, op),
                      value, tile, warp_size)


def warp_scan(value, op: str = "sum", *, tile: Optional[TileGroup] = None,
              warp_size: Optional[int] = None, backend: Optional[str] = None):
    be = _resolve(backend)
    return _seg_apply(lambda v, width: be.warp_scan(v, width, op),
                      value, tile, warp_size)


def tile_reduce(value, tile: TileGroup, op: str = "sum", *,
                backend: Optional[str] = None):
    """cg::reduce over a cooperative-group tile (the reduce_tile benchmark)."""
    return warp_reduce(value, op, tile=tile, warp_size=tile.warp.warp_size,
                       backend=backend)
