"""Quickstart: the paper's warp-level features, HW path vs SW path.

    python -m repro_torch.quickstart [--device cpu]

Counterpart of ``examples/quickstart.py``: (1) shuffle, vote and reduce
through the HW and SW backends, (2) a ``tiled_partition<8>`` tile's group
mask, sums and ballots, (3) the Figure-3 kernel through the PR pass (its
transform report; the ``hw``, ``kernel`` and ``sw`` executors agree), (4)
the hand-written CUDA ``shfl`` kernel against its plain version (on the
CPU the wrapper runs that plain version, so the check is trivial there).
Runs on the GPU by default, in seconds on the CPU.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import primitives as P
from repro_torch.core.ir import Assign, Collective, If, Sync, ThreadProgram, TilePartition
from repro_torch.core.pr_transform import run as run_program
from repro_torch.core.pr_transform import transform_report
from repro_torch.core.warp import TileGroup, WarpConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.warp_ops.ops import shfl
from repro_torch.kernels.warp_ops.ref import shfl_ref

TILE = 4


def fig3_program(warp: WarpConfig) -> ThreadProgram:
    """Figure 3a: a tile<4> partition, group 0's work, its tile.any vote."""
    return ThreadProgram(
        warp=warp,
        locals={"groupId": torch.int32, "gtid": torch.int32, "x": torch.float32,
                "r": torch.int32},
        buffers={},
        stmts=[
            TilePartition(size=TILE),
            Assign("groupId", lambda env, tid, ctx: tid // TILE),
            If(cond=lambda env, tid, ctx: env["groupId"] == 0,
               body=[
                   Assign("gtid", lambda env, tid, ctx: tid % TILE),
                   Assign("x", lambda env, tid, ctx: (env["gtid"] + 1).to(torch.float32)),
                   Sync(),
                   Collective(target="r", kind="vote_any",
                              operand_fn=lambda env, tid, ctx: env["x"] > 2),
               ],
               orelse=[]),
            Sync(),
        ],
    )


def main(device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    warp = WarpConfig(warp_size=32, num_warps=4)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(warp.num_warps, warp.warp_size, generator=gen, device=dev)

    # --- 1. warp-level functions: identical semantics, two lowerings -------
    print(f"== shfl/vote/reduce on {dev}: backend='hw' (register path) vs 'sw' "
          "(PR-serialised) ==")
    for backend in ("hw", "sw"):
        down = P.shfl_down(x, 1, backend=backend)
        any_ = P.vote_any(x > 1.0, backend=backend)
        total = P.warp_reduce(x, "sum", backend=backend)
        print(f"  [{backend}] shfl_down[0,:3]={down[0, :3].tolist()}, "
              f"vote_any[:2]={any_[:2, 0].tolist()}, warp_sum[:2]={total[:2, 0].tolist()}")

    # --- 2. cooperative groups: tiled_partition (the vx_tile analogue) -----
    tile = TileGroup(size=8, warp=warp)
    print(f"\n== tiled_partition<8>: group_mask={tile.group_mask:#010b} "
          "(paper Table II) ==")
    seg_sum = P.tile_reduce(x, tile, "sum")
    ballot = P.vote_ballot(x > 0, tile=tile)
    print(f"  per-tile sums row0: {seg_sum[0, ::8].tolist()}")
    print(f"  per-tile ballots row0: {[hex(int(b)) for b in ballot[0].to(torch.int64)]}")

    # --- 3. the Figure-3 kernel through the PR transformation --------------
    prog = fig3_program(warp)
    rep = transform_report(prog)
    print("\n== Figure-3 kernel through the PR pass ==")
    print(f"  regions identified={rep.n_regions_identified}, "
          f"serialized={rep.n_regions_serialized}, "
          f"collectives (nested loops)={rep.n_collectives}, "
          f"fissioned ifs={rep.n_fissioned_ifs}")
    out = {path: run_program(prog, {}, path, dev) for path in ("hw", "kernel", "sw")}
    hw_sw = torch.equal(out["hw"]["r"], out["sw"]["r"])
    kernel_hw = torch.equal(out["kernel"]["r"], out["hw"]["r"])
    if not (hw_sw and kernel_hw):
        raise AssertionError("the hw, kernel and sw executors must agree")
    print(f"  r (tile.any(x>2), groupId==0 lanes): HW==SW: {hw_sw}, kernel==HW: "
          f"{kernel_hw}; r[:8]={out['hw']['r'][:8].tolist()}")

    # --- 4. the hand-written CUDA shfl kernel against its plain version ----
    y = shfl(x, "bfly", 1)
    same = torch.equal(y, shfl_ref(x, "bfly", 1))
    if not same:
        raise AssertionError("the shfl kernel differs from its plain version")
    what = "CUDA kernel" if dev.type == "cuda" else "wrapper (plain version on the CPU)"
    print(f"\n== vx_shfl {what} matches its plain version: {same} ==")
    print("done.")
    return dict(hw_equals_sw=hw_sw, kernel_equals_hw=kernel_hw, shfl_matches_plain=same,
                report=rep)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
