"""vx_shfl / vx_vote wrappers: the CUDA kernels (``warp_ops.cu``) on a CUDA
tensor, the plain versions (``ref.py``) on a CPU tensor.  Counterparts of
``repro.kernels.warp_ops.warp_ops``'s ``shfl`` and ``vote``, with the
same (n, width) register-block layout."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.warp_ops.ref import SHFL_MODES, VOTE_MODES, shfl_ref, vote_ref

_WORD_DTYPES = (torch.float32, torch.int32)     # moved as 32-bit words
_MAX_WIDTH = 1024                                # one row per block at most
_SHFL_ARGS = [build.P, build.P, build.I64, build.I, build.I, build.I, build.P]
_VOTE_ARGS = [build.P, build.P, build.P, build.I64, build.I, build.I, build.P]


def _check_block(x: torch.Tensor, name: str) -> int:
    if x.dim() != 2:
        raise ValueError(f"{name} takes an (n, width) block; got {tuple(x.shape)}")
    w = x.shape[1]
    if w < 1 or w & (w - 1) or w > _MAX_WIDTH:
        raise ValueError(f"{name}: width must be a power of two <= {_MAX_WIDTH}; got {w}")
    return w


def shfl(x: torch.Tensor, mode: str, imm: int) -> torch.Tensor:
    """x (n, width) -> the lane permute ``mode`` with immediate ``imm``:
    up/down by ``imm`` lanes (out-of-range sources keep their own lane),
    bfly = xor with ``imm`` (< width), idx = lane ``imm % width``."""
    w = _check_block(x, "shfl")
    if mode not in SHFL_MODES:
        raise ValueError(f"shfl mode must be one of {SHFL_MODES}; got {mode!r}")
    if mode != "idx" and imm < 0:
        raise ValueError(f"shfl {mode} takes imm >= 0; got {imm}")
    if mode == "bfly" and imm >= w:
        # the reference kernel reads out of its block here (NaN in
        # interpret mode): an undefined result, refused rather than copied
        raise ValueError(f"shfl bfly needs imm < width ({w}); got {imm}")
    if x.device.type == "cpu":
        return shfl_ref(x, mode, imm)
    if x.dtype not in _WORD_DTYPES:
        raise TypeError(f"shfl kernel moves 32-bit words (f32/int32); got {x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    build.launch("repro_shfl", _SHFL_ARGS, x.device, x.data_ptr(), y.data_ptr(),
                 x.shape[0], w, SHFL_MODES.index(mode),
                 imm % w if mode == "idx" else min(imm, w))
    shfl.launches += 1
    return y


def vote(pred: torch.Tensor, mode: str,
         member_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pred (n, width), cast to int32 first -> all/any/uni as (n, width)
    int32 0/1, ballot as (n, 1) uint32 (width <= 32).  ``member_mask``
    broadcasts to (n, width); a lane is a member where it is non-zero
    after the same int32 cast.  ``uni`` compares every member with lane 0."""
    w = _check_block(pred, "vote")
    if mode not in VOTE_MODES:
        raise ValueError(f"vote mode must be one of {VOTE_MODES}; got {mode!r}")
    if mode == "ballot" and w > 32:
        raise ValueError("ballot kernel emits one 32-bit word per warp")
    if pred.device.type == "cpu":
        return vote_ref(pred, mode, member_mask)
    p = pred.to(torch.int32).contiguous()
    member = None
    if member_mask is not None:
        member = torch.as_tensor(member_mask, device=p.device).expand(p.shape) \
            .to(torch.int32).contiguous()
    if mode == "ballot":
        out = torch.empty(p.shape[0], 1, dtype=torch.int32, device=p.device)
    else:
        out = torch.empty_like(p)
    build.launch("repro_vote", _VOTE_ARGS, p.device, p.data_ptr(),
                 None if member is None else member.data_ptr(), out.data_ptr(),
                 p.shape[0], w, VOTE_MODES.index(mode))
    vote.launches += 1
    return out.view(torch.uint32) if mode == "ballot" else out


shfl.launches = 0
vote.launches = 0
