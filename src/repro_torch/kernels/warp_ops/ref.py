"""Plain PyTorch versions of the warp_ops kernels: the CPU path and the
CUDA kernels' oracle.

They follow the reference's *Pallas kernel* (``warp_ops.py``), not its
``ref.py`` oracle, where the two disagree: ``vote`` casts ``pred`` and
the member mask to int32 first (so 0.5 is false), and ``uni`` compares
every member with lane 0, member or not.  The wrapper refuses the one
input whose kernel result is undefined (``bfly`` with ``imm >= width``).
"""

from __future__ import annotations

from typing import Optional

import torch

SHFL_MODES = ("up", "down", "bfly", "idx")
VOTE_MODES = ("all", "any", "uni", "ballot")


def shfl_src(mode: str, width: int, imm: int, device=None) -> torch.Tensor:
    """Source lane of every lane, as ``warp_ops.py::_lane_perm_shfl``."""
    lanes = torch.arange(width, device=device)
    if mode == "up":
        return torch.where(lanes >= imm, lanes - imm, lanes)
    if mode == "down":
        return torch.where(lanes + imm < width, lanes + imm, lanes)
    if mode == "bfly":
        return lanes ^ imm
    if mode == "idx":
        return torch.full((width,), imm % width, device=device)
    raise ValueError(mode)


def shfl_ref(x: torch.Tensor, mode: str, imm: int) -> torch.Tensor:
    """x (n, width) -> x[:, src] for the mode's source lanes."""
    return x.index_select(-1, shfl_src(mode, x.shape[-1], imm, x.device))


def vote_ref(pred: torch.Tensor, mode: str,
             member_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pred (n, width) -> (n, width) int32 0/1 for all/any/uni, (n, 1)
    uint32 for ballot (width <= 32)."""
    p = pred.to(torch.int32)
    if member_mask is None:
        member = torch.ones_like(p, dtype=torch.bool)
    else:
        member = torch.as_tensor(member_mask, device=p.device).expand(p.shape) \
            .to(torch.int32) != 0
    if mode == "all":
        r = ((p != 0) | ~member).all(-1, keepdim=True)
    elif mode == "any":
        r = ((p != 0) & member).any(-1, keepdim=True)
    elif mode == "uni":
        r = ((p == p[:, :1]) | ~member).all(-1, keepdim=True)
    elif mode == "ballot":
        shifts = torch.arange(p.shape[-1], device=p.device)
        bits = ((p != 0) & member).to(torch.int64) << shifts
        # int64 words < 2^32 -> uint32 through a wrapping int32 cast and a
        # dtype view, which every device supports
        return bits.sum(-1, keepdim=True).to(torch.int32).view(torch.uint32)
    else:
        raise ValueError(mode)
    return r.to(torch.int32).expand(p.shape).contiguous()
