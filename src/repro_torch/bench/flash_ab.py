"""A/B timings of the port's flash kernels on one NVIDIA GPU (bf16,
qwen2-1.5b's 12 query heads over 2 KV heads, d_head 128).

    python src/repro_torch/bench/flash_ab.py SRC [--iters N]

flash_attention_fwd at serving prefill's 4 x 512 and training's B 2 x
S 4096, and flash_attention_bwd at B 2 x S 4096, for the package tree
whose ``src/`` is SRC (one JSON line).  Run it by path, so that the
package is imported from SRC; compare two commits on one machine by
turns: parent, change, change, parent.  Times are CUDA-event means over
back-to-back calls (inputs warm in L2).  Needs nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

HEADS = (12, 2, 128)          # query heads, KV heads, d_head


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _inputs(gen, b, s, with_do=False):
    hq, hkv, d = HEADS

    def randn(h):
        return torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v = randn(hq), randn(hkv), randn(hkv)
    return (q, k, v, randn(hq)) if with_do else (q, k, v)


def time_kernels(iters_long: int) -> dict:
    """ms of the three main-path calls through the imported package."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = _inputs(gen, 4, 512)
    out = {"fwd_4x512": cuda_ms(lambda: flash_attention_fwd(q, k, v), 50)}
    q, k, v, do = _inputs(gen, 2, 4096, with_do=True)
    out["fwd_2x4096"] = cuda_ms(lambda: flash_attention_fwd(q, k, v), iters_long)
    o, lse = flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    out["bwd_2x4096"] = cuda_ms(
        lambda: flash_attention_bwd(q, k, v, do, lse, delta), iters_long, 1)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="the package tree's src/ directory")
    ap.add_argument("--iters", type=int, default=20,
                    help="calls timed at B 2 x S 4096")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: these timings need an NVIDIA GPU")
    sys.path.insert(0, a.src)
    print(json.dumps(dict(src=a.src, **time_kernels(a.iters))), flush=True)


if __name__ == "__main__":
    main()
