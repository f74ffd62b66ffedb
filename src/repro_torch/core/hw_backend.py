"""Hardware-path lowering of warp-level primitives (``vx_shfl`` / ``vx_vote``).

Counterpart of ``repro.core.hw_backend``.  Vortex's HW solution adds ALU
datapaths so lanes exchange *register* values directly, with no memory
round trip.  Here every primitive is one vectorised tensor op over the
trailing lane axis (roll, flip, gather, masked lane reduction): no
per-lane loop and no scratch array.  On CUDA tensors these are PyTorch's
own kernels; the hand-written warp-intrinsic kernels (``__shfl_*_sync``,
``__ballot_sync``) are in ``repro_torch.kernels.warp_ops`` and
``kernels.tile_reduce``.

All functions work on a *segment*: the trailing axis is one warp (or one
cooperative-group tile after ``segment_view``).  Out-of-range shuffles
keep the lane's own value (CUDA ``__shfl_*_sync`` semantics).  Results
equal the reference's bit for bit: the same operands meet in the same
order.
"""

from __future__ import annotations

import torch


def _lane_iota(width: int, device=None) -> torch.Tensor:
    return torch.arange(width, dtype=torch.int64, device=device)


def _member_bool(member_mask, width: int, device=None) -> torch.Tensor:
    """Normalise a member mask (int bitmask, or a bool or integer tensor
    of per-row bitmasks) to bool (..., width).  Bit ``i`` of an integer
    mask is lane ``i`` (LSB-first, CUDA's ``%laneid`` convention)."""
    if member_mask is None:
        return torch.ones(width, dtype=torch.bool, device=device)
    if isinstance(member_mask, int):
        return torch.tensor([bool((member_mask >> i) & 1) for i in range(width)],
                            device=device)
    member_mask = torch.as_tensor(member_mask, device=device)
    if member_mask.dtype == torch.bool:
        return member_mask
    lanes = _lane_iota(width, member_mask.device)
    return ((member_mask.to(torch.int64)[..., None] >> lanes) & 1).bool()


def _as_uint32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> uint32, through an int32 view (the
    int64 -> int32 cast wraps; a dtype view works on every device)."""
    return words.to(torch.int32).view(torch.uint32)


def _broadcast_lanes(r: torch.Tensor, shape) -> torch.Tensor:
    return r.expand(shape).contiguous()


# --------------------------------------------------------------------------
# vx_shfl: Up, Down, Bfly (xor), Idx
# --------------------------------------------------------------------------

def shfl_up(value: torch.Tensor, delta: int, width: int) -> torch.Tensor:
    """r[tid] = value[tid - delta]; lanes with tid < delta keep their own."""
    if delta == 0:
        return value
    rolled = torch.roll(value, delta, dims=-1)
    keep = _lane_iota(width, value.device) < delta
    return torch.where(keep, value, rolled)


def shfl_down(value: torch.Tensor, delta: int, width: int) -> torch.Tensor:
    """r[tid] = value[tid + delta]; lanes with tid + delta >= width keep own."""
    if delta == 0:
        return value
    rolled = torch.roll(value, -delta, dims=-1)
    keep = _lane_iota(width, value.device) >= width - delta
    return torch.where(keep, value, rolled)


def shfl_xor(value: torch.Tensor, mask: int, width: int) -> torch.Tensor:
    """r[tid] = value[tid ^ mask], the butterfly exchange.  A power-of-two
    mask is a static pair swap (reshape + flip, no gather); other masks
    gather, and an out-of-range partner keeps the lane's own value."""
    if isinstance(mask, int) and mask > 0 and (mask & (mask - 1)) == 0 \
            and width % (2 * mask) == 0:
        shape = value.shape
        v = value.reshape(shape[:-1] + (width // (2 * mask), 2, mask))
        return v.flip(-2).reshape(shape)
    lanes = _lane_iota(width, value.device)
    src = lanes ^ mask
    src = torch.where(src < width, src, lanes)
    return torch.gather(value, -1, src.expand(value.shape))


def shfl_idx(value: torch.Tensor, src_lane, width: int) -> torch.Tensor:
    """r[tid] = value[srcLane] (srcLane a scalar or one per lane)."""
    src = torch.as_tensor(src_lane, dtype=torch.int64, device=value.device) % width
    return torch.gather(value, -1, src.expand(value.shape))


# --------------------------------------------------------------------------
# vx_vote: All, Any, Uni, Ballot
# --------------------------------------------------------------------------

def vote_all(pred: torch.Tensor, width: int, member_mask=None) -> torch.Tensor:
    member = _member_bool(member_mask, width, pred.device)
    active = pred.bool() | ~member  # inactive lanes don't veto
    return _broadcast_lanes(active.all(-1, keepdim=True), pred.shape)


def vote_any(pred: torch.Tensor, width: int, member_mask=None) -> torch.Tensor:
    member = _member_bool(member_mask, width, pred.device)
    active = pred.bool() & member
    return _broadcast_lanes(active.any(-1, keepdim=True), pred.shape)


def vote_uni(value: torch.Tensor, width: int, member_mask=None) -> torch.Tensor:
    """True iff all member lanes hold the first member lane's value."""
    member = _member_bool(member_mask, width, value.device)
    first_idx = torch.argmax(member.to(torch.int32), dim=-1)  # first member
    first = torch.gather(value, -1, first_idx[..., None].expand(
        value.shape[:-1] + (1,)))
    same = (value == first) | ~member
    return _broadcast_lanes(same.all(-1, keepdim=True),
                            value.shape[:-1] + (width,))


def vote_ballot(pred: torch.Tensor, width: int, member_mask=None) -> torch.Tensor:
    """Packed ballot words: bit tid set iff lane tid is a member with
    pred != 0.  Returns (..., n_words) uint32, n_words = ceil(width / 32);
    for width <= 32 the word axis is squeezed (CUDA's uint32)."""
    member = _member_bool(member_mask, width, pred.device)
    bits = (pred.bool() & member).to(torch.int64)
    n_words = (width + 31) // 32
    words = []
    for w in range(n_words):
        lo, hi = w * 32, min((w + 1) * 32, width)
        shifts = _lane_iota(hi - lo, pred.device)
        words.append((bits[..., lo:hi] << shifts).sum(-1))
    out = _as_uint32(torch.stack(words, dim=-1))
    return out[..., 0] if n_words == 1 else out


def match_any(value: torch.Tensor, width: int, member_mask=None) -> torch.Tensor:
    """CUDA ``__match_any_sync``: per-lane ballot of the lanes sharing its
    value.  Returns (..., width) uint32 (width <= 32 only, like CUDA)."""
    if width > 32:
        raise ValueError("match_any restricted to width <= 32 (single ballot word)")
    member = _member_bool(member_mask, width, value.device)
    eq = ((value[..., :, None] == value[..., None, :])
          & member[..., None, :] & member[..., :, None])
    shifts = _lane_iota(width, value.device)
    return _as_uint32((eq.to(torch.int64) << shifts).sum(-1))


# --------------------------------------------------------------------------
# Warp/tile reductions: the log2-step shuffle tree.
# --------------------------------------------------------------------------

_REDUCE_OPS = {
    "sum": torch.add,
    "max": torch.maximum,
    "min": torch.minimum,
    "prod": torch.mul,
    "or": torch.bitwise_or,
    "and": torch.bitwise_and,
}


def warp_reduce(value: torch.Tensor, width: int, op: str = "sum") -> torch.Tensor:
    """Butterfly (shfl_xor) tree reduction, the cuda-samples ``reduce`` /
    ``reduce_tile`` pattern: log2(width) exchanges, and every lane ends
    with the full reduction (``cg::reduce``)."""
    fn = _REDUCE_OPS[op]
    offset = width // 2
    while offset >= 1:
        value = fn(value, shfl_xor(value, offset, width))
        offset //= 2
    return value


def warp_scan(value: torch.Tensor, width: int, op: str = "sum") -> torch.Tensor:
    """Inclusive Hillis-Steele scan via shfl_up (``cg::inclusive_scan``)."""
    fn = _REDUCE_OPS[op]
    lanes = _lane_iota(width, value.device)
    delta = 1
    while delta < width:
        shifted = shfl_up(value, delta, width)
        value = torch.where(lanes >= delta, fn(value, shifted), value)
        delta *= 2
    return value
