"""Software-path lowering: the PR-transformation rules of Table III.

Counterpart of ``repro.core.sw_backend``.  The paper's software solution
has no ISA support: the compiler serialises each parallel region into a
loop over threads and rewrites warp primitives into *memory arrays*, a
temporary array as large as the warp that holds each thread's
contribution and is read back by (transformed) thread index.  Collectives
use **nested loop serialisation**: an outer loop over groups and inner
loops over lanes (Figure 4b of the paper).

Here each ``lax.fori_loop`` of the reference is a ``for tid in
range(width)`` loop, and each read or write is one index op on a
temporary tensor, so every lane costs its own memory operations (and, on
a CUDA tensor, its own kernel launches).  That is intentionally the
*expensive* path: the baseline Figure 5 compares against.

All functions take segments whose trailing axis is one warp or tile, as
:mod:`repro_torch.core.hw_backend` does, and give the same results bit
for bit where the arithmetic is exact (shuffles, votes, ballots, integer
and max/min reductions); float sums accumulate serially, lane 0 first,
as the reference's SW path does, and so differ from the butterfly in
rounding only.
"""

from __future__ import annotations

import torch

from repro_torch.core.hw_backend import _REDUCE_OPS, _as_uint32, _lane_iota, _member_bool


def _serial_map(width: int, src_of_tid, value: torch.Tensor) -> torch.Tensor:
    """Loop-serialised ``r[tid] = value[src_of_tid(tid)]``: one iteration
    per thread reads ``value[src]`` and writes the result array, the
    single-loop serialisation of a parallel region holding a shuffle."""
    out = torch.zeros_like(value)
    for tid in range(width):
        out[..., tid] = value[..., src_of_tid(tid)]
    return out


def _broadcast(temp: torch.Tensor, shape, dtype) -> torch.Tensor:
    """The second inner loop of Figure 4b: write ``temp`` to every lane."""
    out = torch.zeros(shape, dtype=dtype, device=temp.device)
    for tid in range(shape[-1]):
        out[..., tid] = temp
    return out


# --------------------------------------------------------------------------
# Table III shuffle rules
# --------------------------------------------------------------------------

def shfl_up(value: torch.Tensor, delta: int, width: int) -> torch.Tensor:
    # r[tid] = value[tid - delta]  (keep own when tid < delta)
    return _serial_map(width, lambda tid: tid - delta if tid >= delta else tid, value)


def shfl_down(value: torch.Tensor, delta: int, width: int) -> torch.Tensor:
    # r[tid] = value[tid + delta]  (keep own when tid + delta >= width)
    return _serial_map(width, lambda tid: tid + delta if tid + delta < width else tid,
                       value)


def shfl_xor(value: torch.Tensor, mask: int, width: int) -> torch.Tensor:
    # r[tid] = value[tid ^ mask]  (out-of-range partner: keep own, CUDA)
    return _serial_map(width, lambda tid: tid ^ mask if (tid ^ mask) < width else tid,
                       value)


def shfl_idx(value: torch.Tensor, src_lane, width: int) -> torch.Tensor:
    # r = value[srcLane]
    if not isinstance(src_lane, torch.Tensor) or src_lane.dim() == 0:
        src = int(src_lane) % width
        return _serial_map(width, lambda tid: src, value)
    src_arr = (src_lane.to(device=value.device, dtype=torch.int64) % width
               ).expand(value.shape)
    out = torch.zeros_like(value)
    for tid in range(width):
        # per-lane source: read this lane's index, then its element
        out[..., tid] = torch.gather(value, -1, src_arr[..., tid:tid + 1])[..., 0]
    return out


# --------------------------------------------------------------------------
# Table III vote rules: nested loop serialisation (Figure 4b)
# --------------------------------------------------------------------------

def _nested_vote(pred: torch.Tensor, width: int, member_mask, init: bool, combine):
    """Figure 4b: an inner loop accumulates ``temp = combine(temp,
    value[tid])`` over the lanes of one group, a second inner loop
    broadcasts ``temp`` to every lane.  (The outer loop over groups lives
    in ``primitives.py``: here the segment *is* the group.)"""
    member = _member_bool(member_mask, width, pred.device)
    temp = torch.full(pred.shape[:-1], init, dtype=torch.bool, device=pred.device)
    for tid in range(width):
        temp = combine(temp, pred[..., tid], member[..., tid])
    return _broadcast(temp, pred.shape, torch.bool)


def vote_any(pred: torch.Tensor, width: int, member_mask=None) -> torch.Tensor:
    # r = r || value[tid]
    return _nested_vote(pred.bool(), width, member_mask, False,
                        lambda t, v, m: t | (v & m))


def vote_all(pred: torch.Tensor, width: int, member_mask=None) -> torch.Tensor:
    # r = r && value[tid]
    return _nested_vote(pred.bool(), width, member_mask, True,
                        lambda t, v, m: t & (v | ~m))


def vote_uni(value: torch.Tensor, width: int, member_mask=None) -> torch.Tensor:
    member = _member_bool(member_mask, width, value.device)
    # serial pass: find the first member's value, then compare lane by lane
    lanes = _lane_iota(width, value.device)
    first_idx = torch.where(member, lanes, width).min(dim=-1).values
    first_idx = torch.clamp(first_idx, max=width - 1)
    first = torch.gather(value, -1, first_idx[..., None].expand(
        value.shape[:-1] + (1,)))[..., 0]
    ok = torch.ones(value.shape[:-1], dtype=torch.bool, device=value.device)
    for tid in range(width):
        ok = ok & ((value[..., tid] == first) | ~member[..., tid])
    return _broadcast(ok, value.shape[:-1] + (width,), torch.bool)


def vote_ballot(pred: torch.Tensor, width: int, member_mask=None) -> torch.Tensor:
    # r = r | ((value[tid] != 0) << tid), serial OR accumulation per word
    member = _member_bool(member_mask, width, pred.device)
    bits = (pred.bool() & member).to(torch.int64)
    n_words = (width + 31) // 32
    words = []
    for w in range(n_words):
        lo, hi = w * 32, min((w + 1) * 32, width)
        r = torch.zeros(pred.shape[:-1], dtype=torch.int64, device=pred.device)
        for tid in range(lo, hi):
            r = r | (bits[..., tid] << (tid - lo))
        words.append(r)
    out = _as_uint32(torch.stack(words, dim=-1))
    return out[..., 0] if n_words == 1 else out


def match_any(value: torch.Tensor, width: int, member_mask=None) -> torch.Tensor:
    if width > 32:
        raise ValueError("match_any restricted to width <= 32")
    member = _member_bool(member_mask, width, value.device)
    out = torch.zeros(value.shape[:-1] + (width,), dtype=torch.int64,
                      device=value.device)
    for tid in range(width):
        mine, my_m = value[..., tid], member[..., tid]
        r = torch.zeros(value.shape[:-1], dtype=torch.int64, device=value.device)
        for j in range(width):
            bit = (value[..., j] == mine) & member[..., j] & my_m
            r = r | (bit.to(torch.int64) << j)
        out[..., tid] = r
    return _as_uint32(out)


# --------------------------------------------------------------------------
# Reductions / scans: serialised accumulation (the reduce benchmark's SW form)
# --------------------------------------------------------------------------

def warp_reduce(value: torch.Tensor, width: int, op: str = "sum") -> torch.Tensor:
    fn = _REDUCE_OPS[op]
    temp = value[..., 0]
    for tid in range(1, width):
        temp = fn(temp, value[..., tid])
    return _broadcast(temp, value.shape, value.dtype)


def warp_scan(value: torch.Tensor, width: int, op: str = "sum") -> torch.Tensor:
    fn = _REDUCE_OPS[op]
    out = torch.zeros_like(value)
    acc = value[..., 0]
    for tid in range(width):
        v = value[..., tid]
        acc = v if tid == 0 else fn(acc, v)
        out[..., tid] = acc
    return out
