"""Variants of the port's matmul kernel (or of another source), built from
textual edits of ``matmul.cu`` and measured on one NVIDIA GPU by
``src/repro_torch/bench/kernel_ab.py``: what the f32 branch's split, its
slice sums and the pipeline's depth cost in time and buy in error.

    python scripts/matmul_variants.py [--iters N] [--source REL] [VARIANT ...]
        [--only GROUP ...]

VARIANT is a name of VARIANTS below or NAME=old=>new[@@old=>new...] (every
occurrence of old in the source is replaced, and old must occur).  The
source is ``matmul/matmul.cu`` unless ``--source`` names another under
``src/repro_torch/kernels/`` (e.g. ``--source warp_ops/warp_ops.cu
e8='kLaneElems = 4;=>kLaneElems = 8;' --only shfl``); ``--only``, after
the variants, passes kernel_ab.py's groups on.
``base``, the source as it is, comes first.  Each variant is a copy of
``src/repro_torch`` under ``build/matmul_variants/NAME`` (git-ignored);
``kernel_ab.py --ptxas`` runs on each copy in a process of its own, which
builds the copy's kernels (registers, spills, HMMA count; the times; the
f32 error at 2048^3 against float64), then again for each in reverse
order, times only.  One JSON line a variant and round.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "matmul_variants"
AB = ROOT / "src" / "repro_torch" / "bench" / "kernel_ab.py"

# the running accumulator takes every product: no slice sums, so 64 fewer
# registers a thread, and with them two blocks a SM
RUNNING = [("    float part[kMT][kNT][4] = {};", "    float (&part)[kMT][kNT][4] = acc;"),
           ("        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];",
            "        for (int e = 0; e < 4; ++e) {}")]
TWO_BLOCKS = [("std::is_same_v<T, float> ? 1 : 2", "2")]

# big = rna(x) through cvt.rna.tf32.f32, which ptxas expands with a NaN
# test and a select, in place of the integer arithmetic on x's bits
CVT_SPLIT = [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
              '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n'
              "  return r & 0xffffe000u;")]

VARIANTS = {
    "cvt-split": CVT_SPLIT,
    # small = x - big as it is: the tensor cores drop its low 13 bits
    "small-unrounded": [("  small = tf32_rna(x - __uint_as_float(big));",
                         "  small = __float_as_uint(x - __uint_as_float(big));")],
    "stages4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "running-sums": RUNNING,
    "running-sums-2blocks": RUNNING + TWO_BLOCKS,
    # 16 warps of 32x32 over the same 128x128 tile: half the registers a
    # thread, twice the warps a SM to hide latency, more loads a product
    "warps16": [("constexpr int kWM = 64, kWN = 32;", "constexpr int kWM = 32, kWN = 32;"),
                ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;"),
                ("std::is_same_v<T, float> ? 1 : 2", "1")],
}


def parse_spec(spec: str):
    if spec in VARIANTS:
        return spec, VARIANTS[spec]
    name, _, rest = spec.partition("=")
    edits = [tuple(e.split("=>", 1)) for e in filter(None, rest.split("@@"))]
    if not edits or any(len(e) != 2 for e in edits):
        raise ValueError(f"{spec!r} is neither a known variant nor NAME=old=>new...")
    return name, edits


def make_copy(name: str, edits, source: str = "matmul/matmul.cu") -> Path:
    dest = OUT / name
    shutil.rmtree(dest, ignore_errors=True)
    pkg = dest / "src" / "repro_torch"
    shutil.copytree(ROOT / "src" / "repro_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = pkg / "kernels" / source
    text = cu.read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} does not occur in {source}")
        text = text.replace(old, new)
    cu.write_text(text)
    return dest


def measure(name: str, dest: Path, iters: int, ptxas: bool, only=None):
    cmd = [sys.executable, str(AB), str(dest / "src"), "--iters", str(iters)]
    cmd += ["--only", *only] if only else []
    out = subprocess.run(cmd + (["--ptxas"] if ptxas else []), capture_output=True,
                         text=True)
    if out.returncode:
        print(json.dumps(dict(variant=name, error=out.stderr[-4000:])), flush=True)
        return
    row = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps(dict(variant=name, **row)), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--source", default="matmul/matmul.cu",
                    help="the edited source, under src/repro_torch/kernels/")
    ap.add_argument("--only", nargs="+", help="kernel_ab.py's groups to time")
    a = ap.parse_args()
    named = [("base", [])] + [parse_spec(s) for s in a.variants]
    dests = [(name, make_copy(name, edits, a.source)) for name, edits in named]
    for name, dest in dests:
        measure(name, dest, a.iters, ptxas=True, only=a.only)
    for name, dest in reversed(dests):
        measure(name, dest, a.iters, ptxas=False, only=a.only)


if __name__ == "__main__":
    main()
