"""The parallel-region (PR) transformation and its three executors.

Counterpart of ``repro.core.pr_transform``: §IV of the paper as an
executable compiler pass,

  (1) identify parallel regions: boundaries are cross-thread operations
      (Sync, TilePartition, Collective);
  (2) control-structure fission: ``If`` nodes spanning boundaries are
      split; the condition is re-evaluated per region (carried as a
      predicate stack, so every fissioned region re-checks
      ``groupId == 0`` exactly as Figure 4b does);
  (3) regions holding only synchronization / partitioning are removed;
  (4) loop serialisation: each region becomes one loop over threads;
      collectives get **nested** loop serialisation (an outer loop over
      groups, the inner serialised lane walks of ``sw_backend``);
  (5) special variables are rewritten: ``threadIdx`` becomes the loop
      index, thread-locals become tensors indexed by tid.

Three executors share the flattened program (``run``'s ``path``):
  ``hw``: ``run_hw``, the vectoriser: the block is a value-per-lane
      tensor, collectives lower to vectorised lane ops (``hw_backend``),
      divergence is mask algebra (the ``vx_split``/``vx_join`` analogue);
  ``kernel``: the same vectoriser with each collective lowered through the
      hand-written warp-intrinsic CUDA kernels (``kernels.warp_ops``'s
      ``shfl``/``vote``, ``kernels.tile_reduce``) by the static table of
      :func:`kernel_route`; a kind or dtype no kernel computes stays on
      ``hw_backend``.  On a CPU tensor each wrapper runs its plain version;
  ``sw``: ``run_sw``, the serialiser, the PR transformation's output.
      Each region is a Python loop over threads whose writes land in
      place, so lane t+1 sees what lane t wrote in the same region (the
      reference's ``fori_loop`` carry); on a CUDA tensor every lane's
      statement costs its own launches.

Divergence semantics (every path, deterministic): predicated lanes do not
update their targets; votes take the active mask as member mask;
reductions neutralise inactive lanes (coalesced-group semantics);
shuffles read the segment as-is (CUDA leaves reads from inactive lanes
undefined; they are pinned to the stored value so HW == SW is testable).

Memory rules, the reference's own: a ``Load`` index wraps once if
negative (numpy-style) and then clamps to the buffer (both paths); a
``Store`` on the HW path drops masked lanes and indices outside the
buffer after the same wrap, and where lanes store to one index the
highest active tid wins; on the SW path a ``Store`` index wraps and
clamps as a ``Load``'s does, and serial order makes the highest tid win.
Inputs are copied onto the device (64-bit dtypes narrowed to 32 bits, as
the reference's default does) and are never written.
"""

from __future__ import annotations

import dataclasses
import math
import numbers
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hw_backend as _hw
from repro_torch.core import sw_backend as _sw
from repro_torch.core.ir import (
    Assign,
    Collective,
    ExecCtx,
    If,
    Load,
    Stmt,
    Store,
    Sync,
    ThreadProgram,
    TilePartition,
)
from repro_torch.core.warp import TileGroup
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.tile_reduce.ops import tile_reduce
from repro_torch.kernels.warp_ops.ops import shfl, vote

PATHS = ("hw", "sw", "kernel")

# ---------------------------------------------------------------------------
# Pass 1+2: flatten control structure into predicated statements
# ---------------------------------------------------------------------------

PredFn = Callable[..., Any]


@dataclasses.dataclass
class FlatStmt:
    """A statement with its enclosing predicate stack and static tile state."""

    stmt: Stmt
    preds: Tuple[Tuple[PredFn, bool], ...]  # (cond_fn, value_it_must_equal)
    tile: Optional[TileGroup]

    @property
    def is_boundary(self) -> bool:
        return isinstance(self.stmt, (Sync, TilePartition, Collective))


def flatten(program: ThreadProgram) -> List[FlatStmt]:
    """If-fission + predication.  TilePartition is interpreted statically."""
    out: List[FlatStmt] = []

    def walk(stmts: Sequence[Stmt], preds, tile):
        for s in stmts:
            if isinstance(s, If):
                tile = walk(s.body, preds + ((s.cond, True),), tile)
                tile = walk(s.orelse, preds + ((s.cond, False),), tile)
            elif isinstance(s, TilePartition):
                if preds:
                    raise ValueError("tiled_partition under divergence is unsupported")
                tile = TileGroup(size=s.size, warp=program.warp) \
                    if s.size != program.warp.warp_size else None
                out.append(FlatStmt(s, preds, tile))
            else:
                out.append(FlatStmt(s, preds, tile))
        return tile

    walk(program.stmts, (), None)
    return out


# ---------------------------------------------------------------------------
# Pass 3+4: region splitting (for reporting + the SW loop structure)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Region:
    """A maximal run of per-thread statements, serialised as ONE loop."""

    items: List[FlatStmt]


@dataclasses.dataclass
class TransformReport:
    n_regions_identified: int   # before removal (incl. sync/partition-only)
    n_regions_serialized: int   # loops actually emitted
    n_collectives: int          # nested-loop serialisations emitted
    n_fissioned_ifs: int        # Ifs split across region boundaries


def split_regions(flat: List[FlatStmt]) -> Tuple[List[Any], TransformReport]:
    """Return the region/boundary sequence plus the paper-step report."""
    seq: List[Any] = []
    cur: List[FlatStmt] = []
    n_identified = 0
    n_collectives = 0
    for fs in flat:
        if fs.is_boundary:
            n_identified += 1  # the boundary splits off a region
            if cur:
                seq.append(Region(cur))
                cur = []
            if isinstance(fs.stmt, Collective):
                n_collectives += 1
                seq.append(fs)
            # Sync / TilePartition regions are *removed* (paper step 3);
            # TilePartition already acted statically during flatten().
        else:
            cur.append(fs)
    if cur:
        seq.append(Region(cur))
    regions = [r for r in seq if isinstance(r, Region)]
    # fission count: an If was fissioned if its predicate spans >1 emitted
    # unit (serialised region or collective boundary).
    pred_regions: Dict[int, set] = {}
    for uidx, unit in enumerate(seq):
        items = unit.items if isinstance(unit, Region) else [unit]
        for fs in items:
            for (fn, _val) in fs.preds:
                pred_regions.setdefault(id(fn), set()).add(uidx)
    n_fissioned = sum(1 for v in pred_regions.values() if len(v) > 1)
    report = TransformReport(
        n_regions_identified=n_identified + len(regions),
        n_regions_serialized=len(regions),
        n_collectives=n_collectives,
        n_fissioned_ifs=n_fissioned,
    )
    return seq, report


# ---------------------------------------------------------------------------
# Environment views and values
# ---------------------------------------------------------------------------

class EnvView:
    """Read view over thread-local state handed to statement functions.
    ``tid`` is the lane (a Python int) in SW mode."""

    def __init__(self, env: Dict[str, torch.Tensor], tid: Optional[int] = None,
                 mode: str = "hw"):
        self._env = env
        self._tid = tid
        self._mode = mode

    def __getitem__(self, name: str):
        arr = self._env[name]
        if self._mode == "hw":
            return arr
        # SW: the 0-d element, the rewrite x -> x[tid] of paper step 5
        # (the index clamped to the array, as a dynamic index is)
        return arr[min(self._tid, arr.shape[0] - 1)]


_NEUTRAL = {"sum": 0, "prod": 1, "max": -math.inf, "min": math.inf, "or": 0, "and": -1}

# the reference's arrays are 32-bit unless 64-bit mode is on
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.uint64: torch.uint32, torch.complex128: torch.complex64}


def _neutral_for(op: str, dtype: torch.dtype):
    """The value an inactive lane contributes, as a Python scalar of
    ``dtype``'s kind (so ``torch.where`` keeps the operand's dtype)."""
    if dtype == torch.bool:
        return True if op == "and" else bool(_NEUTRAL[op])
    if not dtype.is_floating_point and not dtype.is_complex:
        if op == "max":
            return torch.iinfo(dtype).min
        if op == "min":
            return torch.iinfo(dtype).max
        return int(_NEUTRAL[op])
    return float(_NEUTRAL[op])


def _as_tensor(v, device: torch.device) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=device)


def _lanes(v, bs: int, device: torch.device) -> torch.Tensor:
    """A statement value broadcast to one element per lane."""
    return torch.broadcast_to(_as_tensor(v, device), (bs,))


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``; uint32 ballot words go through int64, which is
    exact (a uint32 cast is not supported everywhere)."""
    if x.dtype == torch.uint32 and dtype != torch.uint32:
        x = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return x.to(dtype)


def _clamped_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """A negative index wraps once, then the index clamps to [0, n)."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _init_env(program: ThreadProgram, inputs: Dict[str, Any], device: torch.device):
    bs = program.block_size
    env: Dict[str, torch.Tensor] = {}
    for name, dtype in program.locals.items():
        env[name] = torch.zeros((bs,), dtype=dtype, device=device)
    for name, (shape, dtype) in program.buffers.items():
        env[f"@{name}"] = torch.zeros(shape, dtype=dtype, device=device)
    for name, arr in inputs.items():
        t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(np.array(arr))
        env[name] = t.to(device=device, dtype=_NARROW.get(t.dtype, t.dtype), copy=True)
    return env


def _finalize(env):
    return {k.lstrip("@"): v for k, v in env.items()}


def _mask_of(preds, view, tid, ctx, device) -> torch.Tensor:
    """The lanes' active mask: a bool tensor shaped like ``tid``."""
    mask = torch.ones(tid.shape, dtype=torch.bool, device=device)
    for fn, want in preds:
        c = _as_tensor(fn(view, tid, ctx), device).to(torch.bool)
        mask = mask & (c if want else ~c)
    return mask


# ---------------------------------------------------------------------------
# Collectives: the vectorised lowering and the kernel lowering
# ---------------------------------------------------------------------------

def _broadcast_ballot(b: torch.Tensor, operand: torch.Tensor, seg: int) -> torch.Tensor:
    """The ballot word (word 0 of a multi-word ballot, CUDA's uint32
    convention) on every lane of its segment."""
    b = b[..., None] if b.dim() == operand.dim() - 1 else b[..., :1]
    return b.expand(operand.shape[:-1] + (seg,))


def _apply_collective_hw(kind, operand, mask, seg, params):
    """Vectorised collective over (n_segments, seg) with active mask."""
    op = params.get("op", "sum")
    if kind in ("warp_reduce", "warp_scan"):
        operand = torch.where(mask, operand, _neutral_for(op, operand.dtype))
        fn = _hw.warp_reduce if kind == "warp_reduce" else _hw.warp_scan
        return fn(operand, seg, op)
    if kind == "shfl_up":
        return _hw.shfl_up(operand, params["delta"], seg)
    if kind == "shfl_down":
        return _hw.shfl_down(operand, params["delta"], seg)
    if kind == "shfl_xor":
        return _hw.shfl_xor(operand, params["mask"], seg)
    if kind == "shfl_idx":
        return _hw.shfl_idx(operand, params["src_lane"], seg)
    if kind == "vote_all":
        return _hw.vote_all(operand, seg, member_mask=mask)
    if kind == "vote_any":
        return _hw.vote_any(operand, seg, member_mask=mask)
    if kind == "vote_uni":
        return _hw.vote_uni(operand, seg, member_mask=mask)
    if kind == "vote_ballot":
        return _broadcast_ballot(_hw.vote_ballot(operand, seg, member_mask=mask),
                                 operand, seg)
    raise ValueError(f"unknown collective kind {kind!r}")


_SHFL_MODES = {"shfl_up": "up", "shfl_down": "down", "shfl_xor": "bfly", "shfl_idx": "idx"}
_SHFL_DTYPES = (torch.float32, torch.int32, torch.bool)   # bool moves as int32
_REDUCE_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
_REDUCE_OPS = ("sum", "max", "min")
_BALLOT_MAX_SEG = 32                                      # one 32-bit word


def kernel_route(kind: str, params: Dict[str, Any], dtype: torch.dtype, seg: int) -> str:
    """Which hand-written kernel the ``kernel`` path lowers a collective
    to, a static table on (kind, op, dtype, segment width): ``"shfl"``,
    ``"vote"`` or ``"tile_reduce"``; ``"none"`` for ``shfl_xor`` with a
    mask >= seg (every partner is out of range: each lane keeps its own
    value, no launch); ``"hw_backend"`` where no kernel computes it (other
    dtypes, a per-lane ``src_lane``, a ballot wider than one word,
    prod/or/and reductions, scans)."""
    if kind in _SHFL_MODES:
        if dtype not in _SHFL_DTYPES:
            return "hw_backend"
        if kind == "shfl_xor" and params["mask"] >= seg:
            return "none"
        if kind == "shfl_idx" and not isinstance(params["src_lane"], numbers.Integral):
            return "hw_backend"
        return "shfl"
    if kind in ("vote_all", "vote_any", "vote_uni"):
        return "vote"
    if kind == "vote_ballot":
        return "vote" if seg <= _BALLOT_MAX_SEG else "hw_backend"
    if kind == "warp_reduce":
        fits = params.get("op", "sum") in _REDUCE_OPS and dtype in _REDUCE_DTYPES
        return "tile_reduce" if fits else "hw_backend"
    if kind == "warp_scan":
        return "hw_backend"
    raise ValueError(f"unknown collective kind {kind!r}")


def _apply_collective_kernel(kind, operand, mask, seg, params):
    """The collective through the warp-intrinsic kernels, by
    :func:`kernel_route`; the results equal ``_apply_collective_hw``'s
    (bit for bit, f32 sums within rounding of another butterfly order)."""
    route = kernel_route(kind, params, operand.dtype, seg)
    if route == "hw_backend":
        return _apply_collective_hw(kind, operand, mask, seg, params)
    if route == "none":
        return operand
    if route == "shfl":
        imm = {"shfl_up": params.get("delta"), "shfl_down": params.get("delta"),
               "shfl_xor": params.get("mask"), "shfl_idx": params.get("src_lane")}[kind]
        if kind == "shfl_idx":
            imm = int(imm) % seg
        if operand.dtype == torch.bool:
            return shfl(operand.to(torch.int32), _SHFL_MODES[kind], imm).to(torch.bool)
        return shfl(operand, _SHFL_MODES[kind], imm)
    if route == "vote":
        if kind == "vote_uni":
            # the kernel's uni compares with lane 0; the executor's member
            # set starts at the first active lane
            first = torch.argmax(mask.to(torch.int32), dim=-1, keepdim=True)
            pred, mode = operand == operand.gather(-1, first), "all"
        else:
            pred, mode = operand.to(torch.bool), kind[len("vote_"):]
        r = vote(pred.to(torch.int32), mode, mask)
        return _broadcast_ballot(r, operand, seg) if mode == "ballot" else r.to(torch.bool)
    op = params.get("op", "sum")
    return tile_reduce(torch.where(mask, operand, _neutral_for(op, operand.dtype)), seg, op)


# ---------------------------------------------------------------------------
# HW path: the vectoriser (and its kernel lowering)
# ---------------------------------------------------------------------------

def run_hw(program: ThreadProgram, inputs: Dict[str, Any],
           device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Vectorised execution, the hardware path."""
    return _run_hw(program, inputs, resolve_device(device), _apply_collective_hw)


def _run_hw(program: ThreadProgram, inputs: Dict[str, Any], dev: torch.device,
            collective: Callable) -> Dict[str, torch.Tensor]:
    """The vectoriser, with ``collective`` lowering each Collective."""
    bs = program.block_size
    env = _init_env(program, inputs, dev)
    tid = torch.arange(bs, dtype=torch.int32, device=dev)
    lane = tid.to(torch.int64)

    for fs in flatten(program):
        s = fs.stmt
        if isinstance(s, (Sync, TilePartition)):
            continue  # lockstep: sync is free; partition acted statically
        ctx = ExecCtx(warp=program.warp, tile=fs.tile)
        view = EnvView(env)
        mask = _mask_of(fs.preds, view, tid, ctx, dev)
        if isinstance(s, Assign):
            old = env[s.target]
            val = _cast(_lanes(s.fn(view, tid, ctx), bs, dev), old.dtype)
            env[s.target] = torch.where(mask, val, old)
        elif isinstance(s, Load):
            buf, old = env[f"@{s.buffer}"], env[s.target]
            idx = _clamped_index(_lanes(s.index_fn(view, tid, ctx), bs, dev), buf.shape[0])
            env[s.target] = torch.where(mask, _cast(buf.index_select(0, idx), old.dtype), old)
        elif isinstance(s, Store):
            buf = env[f"@{s.buffer}"]
            n = buf.shape[0]
            idx = _lanes(s.index_fn(view, tid, ctx), bs, dev).to(torch.int64)
            val = _cast(_lanes(s.value_fn(view, tid, ctx), bs, dev), buf.dtype)
            idx = torch.where(idx < 0, idx + n, idx)
            live = mask & (idx >= 0) & (idx < n)          # masked or OOB: dropped
            slot = torch.where(live, idx, n)               # slot n: a discard row
            # the highest live tid writes each index, as the reference's
            # scatter orders it (an index_put_ with duplicates is undefined)
            last = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
            last.scatter_reduce_(0, slot, lane, "amax")
            slot = torch.where(live & (last.index_select(0, slot) == lane), slot, n)
            out = torch.cat([buf, buf[:1]])
            out.index_put_((slot,), val)
            env[f"@{s.buffer}"] = out[:n]
        elif isinstance(s, Collective):
            seg = ctx.segment_size
            operand = _lanes(s.operand_fn(view, tid, ctx), bs, dev).reshape(-1, seg)
            res = collective(s.kind, operand, mask.reshape(-1, seg), seg, s.params)
            res = _cast(res.reshape(bs), env[s.target].dtype)
            env[s.target] = torch.where(mask, res, env[s.target])
        else:
            raise TypeError(f"unknown stmt {type(s)}")
    return _finalize(env)


# ---------------------------------------------------------------------------
# SW path: the serialiser (PR transformation output)
# ---------------------------------------------------------------------------

def _sw_group(kind, v, m, seg, params):
    """One group's collective: the inner serialised lane walks."""
    op = params.get("op", "sum")
    if kind in ("warp_reduce", "warp_scan"):
        v = torch.where(m, v, _neutral_for(op, v.dtype))
        fn = _sw.warp_reduce if kind == "warp_reduce" else _sw.warp_scan
        return fn(v, seg, op)
    if kind == "shfl_up":
        return _sw.shfl_up(v, params["delta"], seg)
    if kind == "shfl_down":
        return _sw.shfl_down(v, params["delta"], seg)
    if kind == "shfl_xor":
        return _sw.shfl_xor(v, params["mask"], seg)
    if kind == "shfl_idx":
        return _sw.shfl_idx(v, params["src_lane"], seg)
    if kind == "vote_all":
        return _sw.vote_all(v, seg, member_mask=m)
    if kind == "vote_any":
        return _sw.vote_any(v, seg, member_mask=m)
    if kind == "vote_uni":
        return _sw.vote_uni(v, seg, member_mask=m)
    if kind == "vote_ballot":
        return _broadcast_ballot(_sw.vote_ballot(v, seg, member_mask=m), v, seg)
    raise ValueError(f"unknown collective kind {kind!r}")


def _apply_collective_sw(fs: FlatStmt, env, program: ThreadProgram, device):
    """Nested loop serialisation: an outer serial loop over segments, the
    inner serialised lane walks of ``sw_backend``."""
    s = fs.stmt
    bs = program.block_size
    seg = fs.tile.size if fs.tile is not None else program.warp.warp_size
    tid = torch.arange(bs, dtype=torch.int32, device=device)
    ctx = ExecCtx(warp=program.warp, tile=fs.tile)
    view = EnvView(env)  # the operand gather is itself a region output
    operand = _lanes(s.operand_fn(view, tid, ctx), bs, device).reshape(-1, seg)
    mask = _mask_of(fs.preds, view, tid, ctx, device)
    seg_mask = mask.reshape(-1, seg)
    res = torch.stack([_sw_group(s.kind, operand[g], seg_mask[g], seg, s.params)
                       for g in range(operand.shape[0])])   # the outer group loop
    res = _cast(res.reshape(bs), env[s.target].dtype)
    env[s.target] = torch.where(mask, res, env[s.target])


def _pred_at(preds, view, tid, ctx, device) -> Optional[torch.Tensor]:
    """A lane's predicate as a 0-d bool tensor, re-evaluated per region
    (fission); None where the statement is not predicated."""
    if not preds:
        return None
    return _mask_of(preds, view, tid, ctx, device)


def run_sw(program: ThreadProgram, inputs: Dict[str, Any],
           device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Serialised execution, the PR-transformation software path."""
    dev = resolve_device(device)
    bs = program.block_size
    env = _init_env(program, inputs, dev)
    seq, _report = split_regions(flatten(program))
    tids = torch.arange(bs, dtype=torch.int32, device=dev)

    for item in seq:
        if isinstance(item, FlatStmt):  # a Collective boundary
            _apply_collective_sw(item, env, program, dev)
            continue
        for t in range(bs):             # the region's thread loop
            tid = tids[t]
            view = EnvView(env, tid=t, mode="sw")
            for fs in item.items:
                ctx = ExecCtx(warp=program.warp, tile=fs.tile)
                pred = _pred_at(fs.preds, view, tid, ctx, dev)
                s = fs.stmt
                if isinstance(s, Assign):
                    arr = env[s.target]
                    val = _cast(_as_tensor(s.fn(view, tid, ctx), dev), arr.dtype)
                    arr[t] = val if pred is None else torch.where(pred, val, arr[t])
                elif isinstance(s, Load):
                    buf, arr = env[f"@{s.buffer}"], env[s.target]
                    idx = _clamped_index(_as_tensor(s.index_fn(view, tid, ctx), dev),
                                         buf.shape[0])
                    val = _cast(buf.index_select(0, idx.reshape(1))[0], arr.dtype)
                    arr[t] = val if pred is None else torch.where(pred, val, arr[t])
                elif isinstance(s, Store):
                    buf = env[f"@{s.buffer}"]
                    idx = _clamped_index(_as_tensor(s.index_fn(view, tid, ctx), dev),
                                         buf.shape[0]).reshape(1)
                    val = _cast(_as_tensor(s.value_fn(view, tid, ctx), dev), buf.dtype)
                    if pred is not None:
                        val = torch.where(pred, val, buf.index_select(0, idx)[0])
                    buf.index_copy_(0, idx, val.reshape(1))
                else:
                    raise TypeError(f"{type(s)} inside a serialised region")
    return _finalize(env)


def run(program: ThreadProgram, inputs: Dict[str, Any], path: str = "hw",
        device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Run ``program`` on ``inputs`` by one of ``PATHS``: every local and
    buffer (and input) by name, on ``device`` (CUDA unless the caller
    passes ``"cpu"``; an error without a GPU)."""
    if path == "hw":
        return run_hw(program, inputs, device)
    if path == "kernel":
        return _run_hw(program, inputs, resolve_device(device), _apply_collective_kernel)
    if path == "sw":
        return run_sw(program, inputs, device)
    raise ValueError(f"unknown path {path!r}; expected one of {PATHS}")


def transform_report(program: ThreadProgram) -> TransformReport:
    _seq, report = split_regions(flatten(program))
    return report
