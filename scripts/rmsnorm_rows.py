"""Where rmsnorm's rows wider than 2048 stand against the bytes they move,
measured on one NVIDIA GPU for the package tree whose ``src/`` is SRC: at
MiniCPM3-4B's 2048 x 2560 (prefill) and 8192 x 2560 under an fp32 weight
(training), Qwen1.5-32B's 2048 x 5120 (prefill) and 8192 x 5120, whose
84 MB of rows the 50 MB L2 cannot hold (no model path), bf16 rows:

- ``kernel`` / ``library``: the port's ``rmsnorm`` and ``F.rms_norm`` on
  the same inputs, warm in L2, as ``kernel_ab.py`` times them;
- ``copy``: ``y.copy_(x)``, the same bytes read and written;
- ``rotated`` / ``rotated_library``: both calls cycling through ROTATE
  inputs, so every call reads its rows from device memory (L2-cold).

    python scripts/rmsnorm_rows.py SRC [--iters N]

One JSON line of ms, every call queued behind a spin on the card
(``kernel_ab.cuda_ms(queued=True)``: the card's time).  Compare two trees
by turns in one call: parent, change, change, parent.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import torch

SHAPES = {"2048x2560": (2048, 2560, torch.bfloat16),
          "8192x2560_f32w": (8192, 2560, torch.float32),
          "2048x5120": (2048, 5120, torch.bfloat16),
          "8192x5120": (8192, 5120, torch.bfloat16)}
ROTATE = 6


def time_rows(iters: int) -> dict:
    import torch.nn.functional as F

    from repro_torch.bench.kernel_ab import cuda_ms
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, (n, d, w_dtype) in SHAPES.items():
        xs = [torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(ROTATE)]
        x, y = xs[0], torch.empty_like(xs[0])
        w = torch.randn(d, generator=gen, device="cuda").to(w_dtype)
        cycle = itertools.cycle(xs)
        calls = dict(kernel=lambda: rmsnorm(x, w, 1e-6),
                     library=lambda: F.rms_norm(x, (d,), w, 1e-6),
                     copy=lambda: y.copy_(x),
                     rotated=lambda: rmsnorm(next(cycle), w, 1e-6),
                     rotated_library=lambda: F.rms_norm(next(cycle), (d,), w, 1e-6))
        for key, fn in calls.items():
            out[f"{name}_{key}"] = cuda_ms(fn, iters, queued=True)
        del xs, x, y, cycle
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="the package tree's src/ directory")
    ap.add_argument("--iters", type=int, default=100, help="calls timed a case")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: these timings need an NVIDIA GPU")
    sys.path.insert(0, a.src)
    print(json.dumps(dict(src=a.src, **time_rows(a.iters))), flush=True)


if __name__ == "__main__":
    main()
