"""Figure 5 on the GPU: HW vs SW implementation of the six microbenchmarks.

    python -m repro_torch.bench.fig5_microbench [--seed N]

Counterpart of ``benchmarks/fig5_microbench.py``.  The paper (Vortex,
SimX cycles) finds vote / shfl / reduce / reduce_tile ~4x faster in HW,
matmul ~1.3x (serialisation overhead only), and mse_forward faster in SW
(loop serialisation fuses the reduction); geomean HW/SW 2.42x.

Each benchmark has three lowerings here:
  - ``kernel``: the HW path's fused form, the hand-written warp-intrinsic
    CUDA kernels of ``repro_torch.kernels`` (vote -> ``vote(x > 0, "any")``,
    shfl -> ``shfl(., "bfly", m)`` + add for m = 1, 2, 4, reduce ->
    ``tile_reduce(., 8)``, reduce_tile -> ``tile_reduce(., 4)``,
    mse_forward -> ``mse_partial_sum(warp_size=8) / n``, matmul ->
    ``matmul``); on a CPU tensor each wrapper runs its plain version;
  - ``hw``: the plain vectorised form (``core.hw_backend`` through
    ``core.primitives``, ``a @ b`` for matmul);
  - ``sw``: the PR-transformation form (``core.sw_backend``; for
    mse_forward one serial pass over the lanes, for matmul one "thread"
    per output row).

``run`` asserts that every lowering agrees with the kernel within 2e-4,
as the reference does, and on a CUDA device times each with CUDA events.
SW/HW is the ratio of the sw and kernel times.  On the card an eager SW
lane loop pays one or more kernel launches per lane, so the ratio
measures launch-bound serialisation against one fused kernel, not SimX's
IPC.  The reference's cycle proxy (``trace_cost``) and HLO op counts
have no PyTorch meaning and are left out.  On the CPU no time is taken
(the fields are None): a CPU run checks agreement only.
"""

from __future__ import annotations

import argparse
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import primitives as P
from repro_torch.core.warp import TileGroup, WarpConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.mse.ops import mse_partial_sum
from repro_torch.kernels.tile_reduce.ops import tile_reduce
from repro_torch.kernels.warp_ops.ops import shfl, vote

# The paper's evaluation config: eight threads per warp, four warps per
# thread block, one core.
WARP = WarpConfig(warp_size=8, num_warps=4)
TILE4 = TileGroup(size=4, warp=WARP)
N_BLOCKS = 8192  # blocks of work per call (the lattice's leading axis)
MATMUL_DIM = 64
LOWERINGS = ("kernel", "hw", "sw")
TOL = dict(rtol=2e-4, atol=2e-4)  # the reference's HW == SW check
ITERS = 20                        # timed calls per lowering, as the reference

PAPER_BANDS = {  # from Fig. 5: expected HW/SW IPC uplift ranges
    "vote": (2.0, 6.0), "shfl": (2.0, 6.0), "reduce": (2.0, 6.0),
    "reduce_tile": (2.0, 6.0), "matmul": (1.05, 2.5),
    "mse_forward": (0.2, 1.1),
}


# ---------------------------------------------------------------------------
# The six microbenchmarks.  Data layout: (N_BLOCKS * num_warps, warp_size).
# ---------------------------------------------------------------------------

def bench_vote(lowering: str) -> Callable:
    if lowering == "kernel":
        return lambda x: vote(x > 0, "any")
    return lambda x: P.vote_any(x > 0, backend=lowering)


def bench_shfl(lowering: str) -> Callable:
    masks = [m for m in (1, 2, 4, 8, 16) if m < WARP.warp_size]

    def fn(x):
        # the cuda-samples shfl test: a butterfly exchange sweep
        y = x
        for m in masks:
            y = y + (shfl(y, "bfly", m) if lowering == "kernel"
                     else P.shfl_xor(y, m, backend=lowering))
        return y
    return fn


def bench_reduce(lowering: str) -> Callable:
    if lowering == "kernel":
        return lambda x: tile_reduce(x, WARP.warp_size, "sum")
    return lambda x: P.warp_reduce(x, "sum", backend=lowering)


def bench_reduce_tile(lowering: str) -> Callable:
    if lowering == "kernel":
        return lambda x: tile_reduce(x, TILE4.size, "sum")
    return lambda x: P.tile_reduce(x, TILE4, "sum", backend=lowering)


def bench_mse(lowering: str) -> Callable:
    def kernel(pred, tgt):
        return mse_partial_sum(pred, tgt, warp_size=WARP.warp_size) / pred.numel()

    def hw(pred, tgt):
        # shuffle_down tree reduction (unet.cu mse_forward), then lane-0 sum
        d = pred - tgt
        acc = d * d
        delta = WARP.warp_size // 2
        while delta >= 1:
            acc = acc + P.shfl_down(acc, delta, backend="hw")
            delta //= 2
        return acc[..., 0].sum() / pred.numel()

    def sw(pred, tgt):
        # the PR pass serialises the whole kernel: after dead-code
        # elimination only lane 0's chain of the shuffle tree is live, one
        # serial pass over the warp's lanes (why the paper's SW path wins)
        acc = torch.zeros(pred.shape[:-1], dtype=pred.dtype, device=pred.device)
        for i in range(WARP.warp_size):
            d = pred[..., i] - tgt[..., i]
            acc = acc + d * d
        return acc.sum() / pred.numel()

    return {"kernel": kernel, "hw": hw, "sw": sw}[lowering]


def bench_matmul(lowering: str) -> Callable:
    # no warp collectives: pure serialisation overhead.  The PR pass
    # serialises the thread loop only; each thread computes its output row.
    if lowering == "kernel":
        return matmul
    if lowering == "hw":
        return lambda a, b: a @ b
    return lambda a, b: torch.stack([a[i] @ b for i in range(a.shape[0])])


BENCHES: Dict[str, Dict] = {
    "vote": dict(make=bench_vote, n_args=1),
    "shfl": dict(make=bench_shfl, n_args=1),
    "reduce": dict(make=bench_reduce, n_args=1),
    "reduce_tile": dict(make=bench_reduce_tile, n_args=1),
    "mse_forward": dict(make=bench_mse, n_args=2),
    "matmul": dict(make=bench_matmul, n_args=2, matmul=True),
}


def make_inputs(seed: int = 0, device: DeviceLike = None,
                n_blocks: int = N_BLOCKS) -> Dict[str, tuple]:
    """Each benchmark's f32 inputs, standard normal from ``seed`` (numpy,
    so the JAX benchmark can take the same arrays)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lattice = (n_blocks * WARP.num_warps, WARP.warp_size)
    out = {}
    for name, spec in BENCHES.items():
        shape = (MATMUL_DIM, MATMUL_DIM) if spec.get("matmul") else lattice
        out[name] = tuple(
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
            for _ in range(spec["n_args"]))
    return out


def cuda_us(fn, args, iters: int = ITERS) -> float:
    """Mean time of one call over ``iters`` back-to-back calls on the
    device's clock (CUDA events, after a warm-up call): device work plus
    any gap the host leaves between launches."""
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def kernel_us(evt) -> float:
    """Device time of a profiler event (CPU-side ops, whose device time
    repeats their kernels', count 0)."""
    from torch.autograd import DeviceType

    if evt.device_type != DeviceType.CUDA:
        return 0.0
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0) or 0)


LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
COPY_RECORDS = ("Memcpy", "Memset")   # device records that are no kernel
PROFILE_TRIES = 3


def device_profile(fn: Callable, n: int) -> Dict:
    """Device µs and kernels a call of ``fn`` over ``n`` calls under
    torch.profiler, after one traced warm-up call whose records are dropped.

    A trace can lose records of a short window, so a trace counts only
    when it is whole: its kernel records equal its launch API calls, a
    multiple of ``n``, and no fewer than the port's wrappers counted
    (``kernels.launch_counts``) over the same calls.  Up to
    ``PROFILE_TRIES`` traces are taken; if none is whole, ``device_us``
    and ``kernels`` are None and ``traced`` / ``launch_calls`` say what
    the last trace held."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import kernels as _kernels

    def counted():
        return sum(_kernels.launch_counts().values())

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=n, repeat=1)) as prof:
            for i in range(1 + n):
                if i == 1:
                    before = counted()
                fn()
                torch.cuda.synchronize()
                prof.step()
            wrapped = counted() - before
        events = prof.key_averages()
        traced = sum(e.count for e in events if e.device_type == DeviceType.CUDA
                     and not e.key.startswith(COPY_RECORDS))
        calls = sum(e.count for e in events if e.key in LAUNCH_APIS)
        whole = traced == calls and calls % n == 0 and calls >= wrapped
        if whole:
            break
    return dict(device_us=sum(kernel_us(e) for e in events) / n if whole else None,
                kernels=traced / n if whole else None, whole=whole,
                traced=traced / n, launch_calls=calls / n, wrapper_launches=wrapped / n)


def run(seed: int = 0, device: DeviceLike = None,
        n_blocks: int = N_BLOCKS) -> List[Dict]:
    """One row per benchmark (and a GEOMEAN row).  Raises AssertionError
    if a lowering disagrees with the kernel beyond 2e-4.  Times (us) are
    taken only on a CUDA device; on the CPU they are None."""
    dev = resolve_device(device)
    timed = dev.type == "cuda"
    inputs = make_inputs(seed, dev, n_blocks)
    rows = []
    for name, spec in BENCHES.items():
        args = inputs[name]
        fns = {low: spec["make"](low) for low in LOWERINGS}
        outs = {low: fn(*args).to(torch.float32) for low, fn in fns.items()}
        err = 0.0
        for low in ("hw", "sw"):
            if not torch.allclose(outs[low], outs["kernel"], **TOL):
                raise AssertionError(f"fig5 {name}: the {low} lowering differs from "
                                     f"the kernel beyond {TOL}")
            err = max(err, (outs[low] - outs["kernel"]).abs().max().item())
        t = ({low: cuda_us(fn, args) for low, fn in fns.items()}
             if timed else dict.fromkeys(LOWERINGS))
        rows.append(_row(name, t, err, torch.cuda.get_device_name(dev) if timed else "cpu"))
    rows.append(_geomean_row(rows))
    return rows


def _row(name: str, t: Dict[str, Optional[float]], err: float, device: str) -> Dict:
    """One benchmark's row from its lowerings' times (us, or None)."""
    lo, hi = PAPER_BANDS[name]
    speedup = None if t["kernel"] is None else t["sw"] / t["kernel"]
    return {
        "bench": name,
        "t_hw_us": t["kernel"],
        "t_hw_plain_us": t["hw"],
        "t_sw_us": t["sw"],
        "hw_over_sw_speedup": speedup,
        "paper_band": f"{lo}-{hi}x",
        "in_band": None if speedup is None else lo <= speedup <= hi,
        "max_abs_err": err,
        "device": device,
    }


def _geomean_row(rows: List[Dict]) -> Dict:
    ratios = [r["hw_over_sw_speedup"] for r in rows]
    geo = (None if None in ratios else
           math.exp(sum(math.log(s) for s in ratios) / len(ratios)))
    return {"bench": "GEOMEAN", "hw_over_sw_speedup": geo,
            "paper_band": "2.42x (paper)", "in_band": None}


def format_rows(rows: List[Dict]) -> List[str]:
    def us(v):
        return f"{v:10.1f}" if v is not None else f"{'n/a':>10s}"

    lines = [f"{'bench':12s} {'t_hw us':>10s} {'t_plain us':>10s} {'t_sw us':>10s} "
             f"{'SW/HW':>7s} {'paper':>14s} {'in band':>7s}"]
    for r in rows:
        s = r["hw_over_sw_speedup"]
        ratio = f"{s:7.2f}" if s is not None else f"{'n/a':>7s}"
        if r["bench"] == "GEOMEAN":
            lines.append(f"{'GEOMEAN':12s} {'':>10s} {'':>10s} {'':>10s} {ratio} "
                         f"{r['paper_band']:>14s}")
        else:
            lines.append(f"{r['bench']:12s} {us(r['t_hw_us'])} {us(r['t_hw_plain_us'])} "
                         f"{us(r['t_sw_us'])} {ratio} {r['paper_band']:>14s} "
                         f"{str(r['in_band']):>7s}")
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    rows = run(ap.parse_args().seed)
    print(f"== Fig. 5 on {rows[0]['device']}: HW (warp-intrinsic kernels) vs SW "
          "(PR-transformation lane loops) ==")
    print("\n".join(format_rows(rows)))


if __name__ == "__main__":
    main()
