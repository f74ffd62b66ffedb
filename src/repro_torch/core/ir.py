"""Thread-program mini-IR: the carrier for the PR transformation.

Counterpart of ``repro.core.ir``.  The paper's software solution is a
*compiler* pass (an extension of CuPBoP / COX's parallel-region
transformation) over CUDA kernels.  Its carrier here is a small
structured IR instead of LLVM IR: a kernel is a list of statements over
per-thread state, with explicit cross-thread operations (Sync,
TilePartition, Collective) that define parallel-region boundaries.

Statement functions receive ``(env, tid, ctx)``:
  env: an EnvView (whole (block_size,) tensors on the HW path, 0-d
       element views inside the serialised loops on the SW path),
  tid: thread index within the block, int32 (a (block_size,) tensor on
       the HW path, a 0-d tensor on the SW path),
  ctx: static ExecCtx (warp config, active TileGroup).
Functions must be pure torch expressions so one definition runs on both
paths; lambdas that use only operators also run on the reference's jnp
values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.warp import TileGroup, WarpConfig

StmtFn = Callable[..., Any]  # (env, tid, ctx) -> value


@dataclasses.dataclass(frozen=True)
class ExecCtx:
    """Static execution context visible to statement functions."""

    warp: WarpConfig
    tile: Optional[TileGroup] = None

    @property
    def block_size(self) -> int:
        return self.warp.block_size

    @property
    def segment_size(self) -> int:
        """Collective segment width: tile size if partitioned, else warp size."""
        return self.tile.size if self.tile is not None else self.warp.warp_size


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------

class Stmt:
    pass


@dataclasses.dataclass
class Assign(Stmt):
    """Per-thread computation: ``target = fn(env, tid, ctx)``."""

    target: str
    fn: StmtFn


@dataclasses.dataclass
class Load(Stmt):
    """``target = buffer[index_fn(env, tid, ctx)]``: a shared-memory read."""

    target: str
    buffer: str
    index_fn: StmtFn


@dataclasses.dataclass
class Store(Stmt):
    """``buffer[index_fn(...)] = value_fn(...)``: a shared-memory write."""

    buffer: str
    index_fn: StmtFn
    value_fn: StmtFn


@dataclasses.dataclass
class If(Stmt):
    """Structured divergence.  If the body spans cross-thread operations the
    PR pass applies if-fission (paper step 2): the condition is re-evaluated
    per region, which is why ``cond`` must be a recomputable pure function of
    thread-local state."""

    cond: StmtFn
    body: List[Stmt]
    orelse: List[Stmt] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Sync(Stmt):
    """block.sync() / tile.sync(): a pure region boundary."""

    scope: str = "block"  # 'block' | 'tile' | 'warp'


@dataclasses.dataclass
class TilePartition(Stmt):
    """``tiled_partition<size>(block)`` == ``vx_tile(group_mask, size)``.

    Static reconfiguration of the collective segment width; a region
    boundary (the paper removes regions containing only partitioning)."""

    size: int


@dataclasses.dataclass
class Collective(Stmt):
    """A warp-level function: ``target = kind(operand_fn(...), **params)``.

    kinds: shfl_up/shfl_down/shfl_xor/shfl_idx, vote_all/vote_any/vote_uni/
    vote_ballot, warp_reduce, warp_scan.  Region boundary on the SW path
    (gets nested-loop serialisation)."""

    target: str
    kind: str
    operand_fn: StmtFn
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ThreadProgram:
    """A kernel: block geometry + declared thread-locals + shared buffers.

    locals: name -> torch dtype (each becomes a (block_size,) tensor:
        'thread-local variables are converted to arrays').
    buffers: name -> (shape, torch dtype) shared/global tensors.
    """

    warp: WarpConfig
    stmts: List[Stmt]
    locals: Dict[str, Any] = dataclasses.field(default_factory=dict)
    buffers: Dict[str, Tuple[Tuple[int, ...], Any]] = dataclasses.field(default_factory=dict)

    @property
    def block_size(self) -> int:
        return self.warp.block_size
