"""Table IV analogue: the static footprint of the HW warp-feature path.

    python -m repro_torch.bench.table4_overhead [--device cpu]

Counterpart of ``benchmarks/table4_overhead.py``.  The paper synthesises
Vortex with and without the warp-feature hardware and reports ~2 % CLB
area per core.  A GPU has no area to add, so the reference counts a
program's static footprint instead; its PyTorch analogue has two parts:

  - ATen ops dispatched for one call (a ``TorchDispatchMode`` counter),
    at the site level (the RMSNorm row reduce at 256 x 1024 f32 in the
    plain, ``hw_warp`` and ``sw`` forms; the kernel form beside them) and
    the model level (one forward of the reduced qwen2 config, batch 2 x 64,
    f32, with the norms in the ``kernel``, ``hw`` (plain), ``hw_warp`` and
    ``sw`` forms, warp_size 64 as the reference's; attention takes its
    plain path in all four, so only the norm differs), with the overhead
    against the plain form (site) and the kernel form (model) beside the
    paper's 2 %.  The count is the same on any device, except the kernel
    form's: on a CUDA tensor its launch is no ATen op.
  - On CUDA only: the kernels of the same calls (torch.profiler's kernel
    records, kept only from a whole trace, one record a launch call:
    ``fig5_microbench.device_profile``), and each HW kernel's registers
    and static and dynamic shared memory (``warp_ops``, ``tile_reduce``, ``mse``,
    ``rmsnorm``'s one-warp-a-row branch; ptxas's report,
    ``kernel_ab.ptxas_report``), with its share of one H100 SM's 228 KB
    of shared memory and 64 K registers at the block size it launches
    with.  This replaces the reference's "% of 128 MB VMEM".

Left out: optimised-HLO op counts, compiled code bytes and Fig. 5's cycle
proxy, which have no PyTorch meaning.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import reduced_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import WarpFeatureConfig, rmsnorm
from repro_torch.models.lm import Model

ARCH = "qwen2-1.5b"             # the model level's config, reduced
SITE_SHAPE = (256, 1024)
SITE_WARP = 128                 # lanes a group at the site, as the reference
MODEL_WARP = 64                 # lanes a group in the model forms, as the reference
MODEL_BATCH = (2, 64)
EPS = 1e-6
PAPER_OVERHEAD_PCT = 2.0
SM_SMEM_BYTES = 228 * 1024      # H100: shared memory an SM
SM_REGISTERS = 64 * 1024        # H100: 32-bit registers an SM
SITE_FORMS = {"plain": "hw", "kernel": None, "hw_warp": "hw_warp", "sw": "sw"}
MODEL_FORMS = {"kernel": None, "hw": "hw", "hw_warp": "hw_warp", "sw": "sw"}
# (source, kernel) as ptxas names them -> threads a block and dynamic shared
# bytes as launched at widths <= 32 (the PR phase's, Fig. 5's) and for
# rmsnorm's warp branch, read from each source's launch code
FOOTPRINT_KERNELS = (
    ("warp_ops.cu", "shfl_lanes_kernel", 256, 0),
    ("warp_ops.cu", "vote_kernel", 256, 0),
    ("tile_reduce.cu", "tile_reduce_kernel", 256, 0),
    ("mse.cu", "mse_kernel", 256, 0),
    ("rmsnorm.cu", "rmsnorm_warp_kernel", 128, 0),
)


class _OpCounter(TorchDispatchMode):
    """Counts the ATen ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def aten_ops(fn) -> int:
    with torch.no_grad(), _OpCounter() as counter:
        fn()
    return counter.n


def _pct(a: int, base: int) -> float:
    return 100.0 * (a - base) / max(base, 1)


def footprint(report: Dict[str, Dict]) -> List[Dict]:
    """One row per HW kernel instance in ptxas's ``report``: registers,
    shared memory, and their shares of one SM at its launch's block size."""
    rows = []
    for name, r in sorted(report.items()):
        for source, kernel, threads, dynamic in FOOTPRINT_KERNELS:
            if name.startswith(source) and kernel in name:
                smem = r.get("static_smem", 0) + dynamic
                regs = r.get("registers", 0)
                rows.append(dict(kernel=name, registers=regs, threads=threads,
                                 static_smem=r.get("static_smem", 0), dynamic_smem=dynamic,
                                 spills=r.get("spills"), smem_share=smem / SM_SMEM_BYTES,
                                 register_share=regs * threads / SM_REGISTERS))
    return rows


def run(device: DeviceLike = None, ptxas: Optional[Dict[str, Dict]] = None) -> Dict:
    """The table's fields.  On CUDA ``ptxas`` (a ``kernel_ab.ptxas_report``)
    is computed here when not given; on the CPU the CUDA-only fields are None."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(*SITE_SHAPE, generator=gen, device=dev)
    w = 1.0 + 0.1 * torch.randn(SITE_SHAPE[1], generator=gen, device=dev)
    site = {name: (lambda b=b: rmsnorm(x, w, EPS, wf=WarpFeatureConfig(b, SITE_WARP)))
            for name, b in SITE_FORMS.items()}

    cfg = reduced_config(ARCH)
    models = {name: Model(cfg, device=dev, dtype=torch.float32, attn_backend="torch",
                          wf=WarpFeatureConfig(b, MODEL_WARP), remat=False)
              for name, b in MODEL_FORMS.items()}
    params = models["kernel"].init(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab, MODEL_BATCH, generator=gen, device=dev)}
    model = {name: (lambda m=m: m.forward(params, batch)) for name, m in models.items()}

    site_ops = {name: aten_ops(fn) for name, fn in site.items()}
    model_ops = {name: aten_ops(fn) for name, fn in model.items()}
    out = dict(
        arch=ARCH, device=dev.type if dev.type == "cpu" else torch.cuda.get_device_name(dev),
        site_shape=SITE_SHAPE, site_aten_ops=site_ops,
        site_hw_overhead_pct=_pct(site_ops["hw_warp"], site_ops["plain"]),
        site_sw_overhead_pct=_pct(site_ops["sw"], site_ops["plain"]),
        model_aten_ops=model_ops,
        model_hw_overhead_pct=_pct(model_ops["hw_warp"], model_ops["kernel"]),
        model_sw_overhead_pct=_pct(model_ops["sw"], model_ops["kernel"]),
        paper_overhead_pct=PAPER_OVERHEAD_PCT,
        site_launches=None, model_launches=None, footprint=None)
    if dev.type == "cuda":
        from repro_torch.bench.fig5_microbench import device_profile

        with torch.no_grad():
            out["site_launches"] = {n: device_profile(fn, 3)["kernels"]
                                    for n, fn in site.items()}
            out["model_launches"] = {n: device_profile(fn, 1)["kernels"]
                                     for n, fn in model.items()}
        if ptxas is None:
            from repro_torch.bench.kernel_ab import ptxas_report

            ptxas = ptxas_report(Path(__file__).resolve().parents[1] / "kernels")
        out["footprint"] = footprint(ptxas)
    return out


def format_lines(r: Dict) -> List[str]:
    s, m = r["site_aten_ops"], r["model_aten_ops"]
    sl, ml = r["site_launches"] or {}, r["model_launches"] or {}

    def launches(d, k):
        if k not in d:
            return ""
        return ", kernels n/a (no whole trace)" if d[k] is None else f", {d[k]:.0f} kernels"

    lines = [
        f"site (RMSNorm row reduce {r['site_shape'][0]}x{r['site_shape'][1]} f32) on "
        f"{r['device']}: " + "; ".join(f"{k} {v} ATen ops{launches(sl, k)}" for k, v in s.items())
        + f"; hw_warp +{r['site_hw_overhead_pct']:.1f}%, sw +{r['site_sw_overhead_pct']:.1f}% "
        f"over plain (paper HW area ~{r['paper_overhead_pct']:.0f}%)",
        f"model {r['arch']} (reduced, one forward {MODEL_BATCH[0]}x{MODEL_BATCH[1]} f32): "
        + "; ".join(f"{k} {v} ATen ops{launches(ml, k)}" for k, v in m.items())
        + f"; hw_warp +{r['model_hw_overhead_pct']:.1f}%, sw +{r['model_sw_overhead_pct']:.1f}% "
        f"over the kernel form (paper ~{r['paper_overhead_pct']:.0f}%/core)",
    ]
    # one line a kernel: the range over its template instances
    for source, kernel, threads, dynamic in FOOTPRINT_KERNELS:
        rows = [f for f in r["footprint"] or [] if f["kernel"].startswith(source)
                and kernel in f["kernel"]]
        if not rows:
            continue

        def span(key, scale=1.0, fmt="{:.0f}"):
            lo, hi = (min(f[key] for f in rows) * scale, max(f[key] for f in rows) * scale)
            return fmt.format(lo) if lo == hi else fmt.format(lo) + "-" + fmt.format(hi)

        lines.append(
            f"footprint {source}: {kernel} ({len(rows)} instances): "
            f"{span('registers')} registers x {threads} threads = "
            f"{span('register_share', 100, '{:.2f}')}% of an SM's 64 K registers; smem "
            f"{span('static_smem')} B static + {dynamic} B dynamic = "
            f"{span('smem_share', 100, '{:.3f}')}% of its 228 KB")
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    r = run(ap.parse_args().device)
    print("== Table IV analogue: static footprint of warp-feature support ==")
    print("\n".join(format_lines(r)))


if __name__ == "__main__":
    main()
