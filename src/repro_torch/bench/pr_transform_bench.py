"""Whole thread programs through the PR transformation on the GPU.

    python -m repro_torch.bench.pr_transform_bench [--seed N]

The whole-program counterpart of Figure 5: the programs of the
reference's ``tests/test_pr_transform.py`` (Fig. 3's tile vote, if/else
fission, the special-variable rewrite, the cross-warp shared-memory
reduction, every collective kind, tile reconfiguration) and the memory
and divergence edges (a vote and a ballot with lane 0 of each segment
inactive, integer reductions, shuffles of int32 and bool words, loads and
stores outside the buffer, duplicate store indices, a region's carry),
run by the three executors of ``core.pr_transform``:
  - ``kernel``: collectives through the warp-intrinsic CUDA kernels
    (``shfl``, ``vote``, ``tile_reduce``);
  - ``hw``: collectives as vectorised lane ops (``core.hw_backend``);
  - ``sw``: the PR transformation's loops over threads and groups.

Each program runs at WarpConfig(8, 4), the paper's evaluation block, and
at WarpConfig(32, 32), 1024 threads, a full CUDA block.  ``check`` holds
``kernel`` to ``hw`` bit for bit (f32 sums within rtol 1e-6, another
butterfly order) and ``sw`` to ``hw`` exactly (f32 sums within the
reference test's 1e-5), except where the two paths follow their own
memory rule (an out-of-range store, a region's carry): there, on a GPU,
each path must equal the same path on the CPU, which the CPU tests hold
to the reference.  ``time_case`` times each lowering with CUDA events and
reads its device time and kernels a call (torch.profiler); ``sw`` at
1024 threads launches ~2k-33k kernels a call, so only two of its
programs are profiled there.
On the card ``sw`` pays launches per lane and statement, so SW/HW
measures launch-bound serialisation against a few fused calls, not SimX's
IPC (the reference benchmark has no whole-program timing).

Program factories take a :class:`Namespace` (the IR module, ``WarpConfig``,
dtypes and a cast), so one definition yields the port's program and,
in the CPU tests, the reference's jnp program.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.bench.fig5_microbench import cuda_us, device_profile
from repro_torch.core import ir as torch_ir
from repro_torch.core.pr_transform import run as run_program
from repro_torch.core.pr_transform import transform_report
from repro_torch.core.warp import WarpConfig
from repro_torch.device import DeviceLike, resolve_device

BLOCKS = (WarpConfig(warp_size=8, num_warps=4), WarpConfig(warp_size=32, num_warps=32))
LOWERINGS = ("kernel", "hw", "sw")
KERNEL_SUM_TOL = dict(rtol=1e-6, atol=0.0)    # another butterfly order
SW_SUM_TOL = dict(rtol=1e-5, atol=0.0)        # the reference test's bound
FIG3_REPORT = dict(n_regions_serialized=2, n_collectives=1, n_fissioned_ifs=1)
ITERS = 20                                    # timed calls, as Fig. 5's
SW_ITERS_WIDE = 3                             # sw at >= 256 threads
SW_PROFILED_WIDE = ("fig3", "load_edges")     # sw profiled at >= 256 threads


@dataclasses.dataclass(frozen=True)
class Namespace:
    """What a program factory takes from a package."""

    ir: Any                 # the module holding ThreadProgram, Assign, ...
    WarpConfig: Any
    int32: Any
    float32: Any
    bool_: Any
    cast: Callable          # (value, dtype) -> value in dtype


TORCH = Namespace(ir=torch_ir, WarpConfig=WarpConfig, int32=torch.int32,
                  float32=torch.float32, bool_=torch.bool,
                  cast=lambda x, dtype: x.to(dtype))


@dataclasses.dataclass(frozen=True)
class Case:
    """A program factory ``make(ns, warp)`` and how its outputs compare."""

    name: str
    make: Callable
    takes_input: bool = True      # an "inp" of block_size values in [0, 2)
    sums: Tuple[str, ...] = ()    # f32 sums: equal within rounding
    diverge: Tuple[str, ...] = () # HW and SW follow their own memory rule


# ---------------------------------------------------------------------------
# The reference test's programs (generalised from WarpConfig(8, 4))
# ---------------------------------------------------------------------------

def fig3(ns, warp):
    """Figure 3a: tile<4> partition, divergent tile work, tile.any vote."""
    ir = ns.ir
    return ir.ThreadProgram(
        warp=warp,
        locals={"groupId": ns.int32, "gtid": ns.int32, "x": ns.float32, "r": ns.bool_},
        buffers={"out": ((warp.block_size,), ns.float32)},
        stmts=[
            ir.TilePartition(4),
            ir.Assign("groupId", lambda env, tid, ctx: tid // 4),
            ir.If(lambda env, tid, ctx: env["groupId"] == 0, [
                ir.Assign("gtid", lambda env, tid, ctx: tid % 4),
                ir.Assign("x", lambda env, tid, ctx: env["inp"] * 2.0),
                ir.Sync("tile"),
                ir.Collective("r", "vote_any", lambda env, tid, ctx: env["x"] > 2.0),
            ]),
            ir.Sync("block"),
            ir.Store("out", lambda env, tid, ctx: tid, lambda env, tid, ctx: env["x"]),
        ],
    )


def if_else(ns, warp):
    """if/else spanning a sync boundary: both arms survive fission."""
    ir = ns.ir
    return ir.ThreadProgram(
        warp=warp,
        locals={"a": ns.float32, "b": ns.float32},
        stmts=[
            ir.If(lambda env, tid, ctx: tid % 2 == 0,
                  [ir.Assign("a", lambda env, tid, ctx: env["inp"] + 1.0),
                   ir.Sync("block"),
                   ir.Assign("b", lambda env, tid, ctx: env["a"] * 3.0)],
                  [ir.Assign("a", lambda env, tid, ctx: env["inp"] - 1.0),
                   ir.Sync("block"),
                   ir.Assign("b", lambda env, tid, ctx: env["a"] * 5.0)]),
        ],
    )


def special_vars(ns, warp):
    """threadIdx -> loop index / outer * warpSize + inner (paper step 5)."""
    ir = ns.ir
    return ir.ThreadProgram(
        warp=warp, locals={"t": ns.int32, "w": ns.int32, "l": ns.int32},
        stmts=[
            ir.Assign("t", lambda env, tid, ctx: tid),
            ir.Assign("w", lambda env, tid, ctx: tid // ctx.warp.warp_size),
            ir.Assign("l", lambda env, tid, ctx: tid % ctx.warp.warp_size),
        ],
    )


def smem_reduce(ns, warp):
    """Cross-warp reduction through a shared buffer (the 'reduce' pattern)."""
    ir = ns.ir
    ws, nw = warp.warp_size, warp.num_warps
    return ir.ThreadProgram(
        warp=warp,
        locals={"v": ns.float32, "partial": ns.float32, "total": ns.float32},
        buffers={"smem": ((nw,), ns.float32)},
        stmts=[
            ir.Assign("v", lambda env, tid, ctx: env["inp"]),
            ir.Collective("partial", "warp_reduce",
                          lambda env, tid, ctx: env["v"], {"op": "sum"}),
            ir.If(lambda env, tid, ctx: tid % ws == 0, [
                ir.Store("smem", lambda env, tid, ctx: tid // ws,
                         lambda env, tid, ctx: env["partial"]),
            ]),
            ir.Sync("block"),
            ir.Load("total", "smem", lambda env, tid, ctx: tid % nw),
        ],
    )


def collective(kind: str, params: Dict[str, Any]):
    """One collective over ``inp`` (``inp > 1`` for votes) into an f32 target."""
    def make(ns, warp):
        ir = ns.ir
        if kind.startswith("vote"):
            operand = lambda env, tid, ctx: env["x"] > 1.0  # noqa: E731
        else:
            operand = lambda env, tid, ctx: env["x"]  # noqa: E731
        return ir.ThreadProgram(
            warp=warp, locals={"x": ns.float32, "r": ns.float32},
            stmts=[ir.Assign("x", lambda env, tid, ctx: env["inp"]),
                   ir.Collective("r", kind, operand, params)],
        )
    return make


def tile_reconfig(ns, warp):
    """vx_tile(..., 4) ... vx_tile(..., warp_size): the reset restores
    full-warp collectives, as Figure 3b's epilogue."""
    ir = ns.ir
    return ir.ThreadProgram(
        warp=warp, locals={"r4": ns.float32, "r8": ns.float32},
        stmts=[
            ir.TilePartition(4),
            ir.Collective("r4", "warp_reduce", lambda env, tid, ctx: env["inp"],
                          {"op": "sum"}),
            ir.TilePartition(warp.warp_size),
            ir.Collective("r8", "warp_reduce", lambda env, tid, ctx: env["inp"],
                          {"op": "sum"}),
        ],
    )


# the reference test's eight kinds, in its order
REFERENCE_KINDS = (
    ("shfl_up", {"delta": 2}),
    ("shfl_down", {"delta": 3}),
    ("shfl_xor", {"mask": 1}),
    ("vote_all", {}),
    ("vote_any", {}),
    ("vote_ballot", {}),
    ("warp_reduce", {"op": "max"}),
    ("warp_scan", {"op": "sum"}),
)
MORE_KINDS = (
    ("shfl_idx", {"src_lane": 3}),
    ("vote_uni", {}),
    ("warp_reduce", {"op": "sum"}),
    ("warp_reduce", {"op": "min"}),
)


def kind_name(kind: str, params: Dict[str, Any]) -> str:
    return " ".join([kind] + [f"{k}={v}" for k, v in params.items()])


# ---------------------------------------------------------------------------
# Edges: divergence, dtypes, memory rules
# ---------------------------------------------------------------------------

def lane0_inactive(ns, warp):
    """A vote_uni over 4-lane tiles and warp-wide ballots (into f32 and
    int32 targets) with lane 0 of each segment inactive: the member set
    starts at lane 1, and lane 0's value differs from the members'."""
    ir = ns.ir
    off = lambda env, tid, ctx: tid % 4 != 0  # noqa: E731
    return ir.ThreadProgram(
        warp=warp, locals={"u": ns.bool_, "bf": ns.float32, "bi": ns.int32},
        stmts=[
            ir.TilePartition(4),
            ir.If(off, [ir.Collective(
                "u", "vote_uni", lambda env, tid, ctx:
                ns.cast((tid % 4 == 0) | (env["inp"] > 1.6), ns.int32))]),
            ir.TilePartition(warp.warp_size),
            ir.If(off, [
                ir.Collective("bf", "vote_ballot", lambda env, tid, ctx: env["inp"] > 1.0),
                ir.Collective("bi", "vote_ballot", lambda env, tid, ctx: env["inp"] > 1.0),
            ]),
        ],
    )


def int_reduce(ns, warp):
    """int32 sum / max / min over the warp, and a max with a third of the
    lanes inactive (the iinfo neutral)."""
    ir = ns.ir
    xi = lambda env, tid, ctx: env["xi"]  # noqa: E731
    return ir.ThreadProgram(
        warp=warp,
        locals={"xi": ns.int32, "s": ns.int32, "hi": ns.int32, "lo": ns.int32,
                "mhi": ns.int32},
        stmts=[
            ir.Assign("xi", lambda env, tid, ctx:
                      ns.cast(env["inp"] * 1000.0, ns.int32) - 1000),
            ir.Collective("s", "warp_reduce", xi, {"op": "sum"}),
            ir.Collective("hi", "warp_reduce", xi, {"op": "max"}),
            ir.Collective("lo", "warp_reduce", xi, {"op": "min"}),
            ir.If(lambda env, tid, ctx: tid % 3 != 0, [
                ir.Collective("mhi", "warp_reduce", xi, {"op": "max"})]),
        ],
    )


def shfl_words(ns, warp):
    """Shuffles of int32 and bool words, a butterfly whose mask is the
    warp size (every partner out of range), and a predicated shuffle."""
    ir = ns.ir
    return ir.ThreadProgram(
        warp=warp,
        locals={"xi": ns.int32, "a": ns.int32, "b": ns.bool_, "c": ns.float32,
                "d": ns.float32},
        stmts=[
            ir.Assign("xi", lambda env, tid, ctx: ns.cast(env["inp"] * 1000.0, ns.int32)),
            ir.Collective("a", "shfl_down", lambda env, tid, ctx: env["xi"], {"delta": 1}),
            ir.Collective("b", "shfl_xor", lambda env, tid, ctx: env["inp"] > 1.0,
                          {"mask": 2}),
            ir.Collective("c", "shfl_xor", lambda env, tid, ctx: env["inp"],
                          {"mask": warp.warp_size}),
            ir.If(lambda env, tid, ctx: tid % 2 == 0, [
                ir.Collective("d", "shfl_up", lambda env, tid, ctx: env["inp"],
                              {"delta": 1})]),
        ],
    )


def dup_store(ns, warp):
    """Every lane stores to slot tid % 4 of a 4-slot buffer, the top two
    lanes inactive: the highest active tid wins each slot."""
    ir = ns.ir
    bs = warp.block_size
    return ir.ThreadProgram(
        warp=warp, locals={"got": ns.float32},
        buffers={"buf": ((4,), ns.float32)},
        stmts=[
            ir.If(lambda env, tid, ctx: tid < bs - 2, [
                ir.Store("buf", lambda env, tid, ctx: tid % 4,
                         lambda env, tid, ctx: env["inp"])]),
            ir.Sync("block"),
            ir.Load("got", "buf", lambda env, tid, ctx: tid % 4),
        ],
    )


def load_edges(ns, warp):
    """Loads before the start and past the end of a 4-slot buffer: a
    negative index wraps once, then the index clamps."""
    ir = ns.ir
    return ir.ThreadProgram(
        warp=warp, locals={"neg": ns.float32, "past": ns.float32, "far": ns.float32},
        buffers={"buf": ((4,), ns.float32)},
        stmts=[
            ir.If(lambda env, tid, ctx: tid < 4, [
                ir.Store("buf", lambda env, tid, ctx: tid,
                         lambda env, tid, ctx: env["inp"])]),
            ir.Sync("block"),
            ir.Load("neg", "buf", lambda env, tid, ctx: tid - 2),
            ir.Load("past", "buf", lambda env, tid, ctx: tid + 2),
            ir.Load("far", "buf", lambda env, tid, ctx: tid - 9),
        ],
    )


def oob_store(ns, warp):
    """Stores past the end and before the start of 4-slot buffers: HW
    drops them (a negative index after its one wrap), SW clamps them."""
    ir = ns.ir
    return ir.ThreadProgram(
        warp=warp,
        buffers={"buf": ((4,), ns.float32), "low": ((4,), ns.float32)},
        stmts=[
            ir.Store("buf", lambda env, tid, ctx: tid + 2, lambda env, tid, ctx: env["inp"]),
            ir.Store("low", lambda env, tid, ctx: -tid - 5, lambda env, tid, ctx: env["inp"]),
        ],
    )


def carry(ns, warp):
    """A load of the previous lane's slot before the store in the same
    region: the serialised loop's lane t sees lane t - 1's store (the
    carry), the vectorised block sees the buffer before the region."""
    ir = ns.ir
    return ir.ThreadProgram(
        warp=warp, locals={"prev": ns.float32},
        buffers={"buf": ((warp.block_size,), ns.float32)},
        stmts=[
            ir.Load("prev", "buf", lambda env, tid, ctx: tid - 1),
            ir.Store("buf", lambda env, tid, ctx: tid, lambda env, tid, ctx: env["inp"]),
        ],
    )


CASES: Dict[str, Case] = {c.name: c for c in [
    Case("fig3", fig3),
    Case("if_else", if_else),
    Case("special_vars", special_vars, takes_input=False),
    Case("smem_reduce", smem_reduce, sums=("partial", "smem", "total")),
    *[Case(kind_name(k, p), collective(k, p),
           sums=("r",) if p.get("op") == "sum" else ())
      for k, p in REFERENCE_KINDS + MORE_KINDS],
    Case("tile_reconfig", tile_reconfig, sums=("r4", "r8")),
    Case("lane0_inactive", lane0_inactive),
    Case("int_reduce", int_reduce),
    Case("shfl_words", shfl_words),
    Case("dup_store", dup_store),
    Case("load_edges", load_edges),
    Case("oob_store", oob_store, diverge=("buf", "low")),
    Case("carry", carry, diverge=("prev",)),
]}


# ---------------------------------------------------------------------------
# Checks and timing
# ---------------------------------------------------------------------------

def block_name(warp: WarpConfig) -> str:
    return f"{warp.warp_size}x{warp.num_warps}"


def make_inputs(case: Case, warp: WarpConfig, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    if not case.takes_input:
        return {}
    return {"inp": torch.rand(warp.block_size, generator=gen, device=gen.device) * 2.0}


def _agree(got: torch.Tensor, want: torch.Tensor, tol) -> bool:
    if tol == "exact":
        return got.dtype == want.dtype and torch.equal(got, want)
    return torch.allclose(got.float(), want.float(), **tol)


def _gate(label: str, got: torch.Tensor, want: torch.Tensor, tol):
    if not _agree(got, want, tol):
        err = (got.double() - want.double()).abs().max().item()
        raise AssertionError(f"{label}: differ beyond {tol} (max abs {err:.3e})")


def check(case: Case, warp: WarpConfig, inputs: Dict[str, torch.Tensor],
          device: DeviceLike = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Run ``case`` at ``warp`` by every lowering and hold them together;
    returns each lowering's outputs.  Raises AssertionError on a failed gate."""
    dev = resolve_device(device)
    program = case.make(TORCH, warp)
    outs = {low: run_program(program, inputs, low, dev) for low in LOWERINGS}
    label = f"{case.name} at {block_name(warp)}"
    for name, hw in outs["hw"].items():
        summed = name in case.sums
        _gate(f"{label}: {name} kernel vs hw", outs["kernel"][name], hw,
              KERNEL_SUM_TOL if summed else "exact")
        if name not in case.diverge:
            _gate(f"{label}: {name} sw vs hw", outs["sw"][name], hw,
                  SW_SUM_TOL if summed else "exact")
    if dev.type != "cpu" and case.diverge:
        cpu_in = {k: v.cpu() for k, v in inputs.items()}
        for low in LOWERINGS:
            want = run_program(program, cpu_in, low, "cpu")
            for name in case.diverge:
                _gate(f"{label}: {name} {low} on {dev.type} vs the CPU",
                      outs[low][name].cpu(), want[name], "exact")
    if case.name == "fig3":
        rep = dataclasses.asdict(transform_report(program))
        if any(rep[k] != v for k, v in FIG3_REPORT.items()):
            raise AssertionError(f"fig3 transform_report {rep} != {FIG3_REPORT}")
    return outs


def check_all(seed: int = 0,
              device: DeviceLike = None) -> Dict[Tuple[str, str], Dict[str, torch.Tensor]]:
    """``check`` every case at every block size; returns the inputs each
    ran on, keyed by (case, block), for ``time_all``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    inputs = {}
    for warp in BLOCKS:
        for case in CASES.values():
            x = make_inputs(case, warp, gen)
            check(case, warp, x, dev)
            inputs[(case.name, block_name(warp))] = x
    return inputs


def time_case(case: Case, warp: WarpConfig, inputs: Dict[str, torch.Tensor]) -> Dict:
    """Each lowering's event-timed ms and, from ``device_profile``, its
    device µs and kernels a call (None where no whole trace was taken, and
    for ``sw`` at >= 256 threads outside ``SW_PROFILED_WIDE``)."""
    program = case.make(TORCH, warp)
    row = dict(program=case.name, block=block_name(warp), threads=warp.block_size)
    for low in LOWERINGS:
        fn = lambda low=low: run_program(program, inputs, low, "cuda")  # noqa: E731
        wide_sw = low == "sw" and warp.block_size >= 256
        iters = SW_ITERS_WIDE if wide_sw else ITERS
        row[low] = dict(ms=cuda_us(fn, (), iters) / 1e3, iters=iters)
        if not wide_sw or case.name in SW_PROFILED_WIDE:
            row[low]["profile"] = device_profile(fn, 1 if wide_sw else 3)
    row["sw_over_kernel"] = row["sw"]["ms"] / row["kernel"]["ms"]
    dev = [row[low].get("profile", {}).get("device_us") for low in ("sw", "kernel")]
    row["sw_over_kernel_device"] = None if None in dev else dev[0] / dev[1]
    return row


def time_all(inputs: Dict[Tuple[str, str], Dict[str, torch.Tensor]]) -> List[Dict]:
    """``time_case`` for every (case, block) that ``check_all`` ran."""
    blocks = {block_name(w): w for w in BLOCKS}
    return [time_case(CASES[name], blocks[block], x) for (name, block), x in inputs.items()]


def _format_profile(p) -> str:
    if p is None:
        return "not profiled"
    if not p["whole"]:
        return (f"device n/a: {p['traced']:.0f} kernel records of "
                f"{p['launch_calls']:.0f} launch calls")
    return f"{p['device_us']:.1f} us, {p['kernels']:.0f} kernels"


def format_row(r: Dict) -> str:
    dev = r["sw_over_kernel_device"]
    return (f"{r['program']} {r['block']}: " + "; ".join(
        f"{low} {r[low]['ms']:.4f} ms ({_format_profile(r[low].get('profile'))})"
        for low in LOWERINGS)
        + f"; SW/HW {r['sw_over_kernel']:.2f}, device "
        + ("n/a" if dev is None else f"{dev:.2f}"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    inputs = check_all(args.seed)
    print(f"== PR transformation on {torch.cuda.get_device_name(0)}: kernel / hw / sw "
          "executors, every gate held ==")
    for r in time_all(inputs):
        print(format_row(r))


if __name__ == "__main__":
    main()
