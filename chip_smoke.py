"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``src/repro_torch/kernels`` and drives
its two paths:

1. Kernels.  Each kernel against its plain PyTorch version on the card
   (max error, times, the least time the card could take, and one PyTorch
   library call as a yardstick): the four serving kernels at the serving
   path's shapes, the five warp-feature kernels (shfl, vote, tile_reduce,
   mse_partial_sum, matmul) at sizes where launch latency does not
   dominate.
2. The paper's layer: Figure 5 (``repro_torch.bench.fig5_microbench``) at
   the reference's size, HW through the warp-intrinsic kernels against SW
   through the PR-transformation lane loops; it fails if they disagree or
   if a warp kernel never launched.  A profile of each lowering then
   splits its time into device kernel time and kernel launches per call.
3. Serving: 8 requests greedily with full-width qwen2-1.5b (random bf16
   weights from the seed) on the dense and on the paged cache layout, the
   paged pool small enough to force preemption.  It checks that every
   request finishes with its token count and that every serving kernel
   launched; teacher-forcing one request's tokens, the plain-version path
   and the models whose norms reduce through the paper's ``hw_warp`` and
   ``sw`` forms must give the kernel path's logits within a bf16
   tolerance (and, for the forms, the same greedy tokens).  Last, it
   times one full-batch decode step and one prefill against their summed
   kernel time (torch.profiler) to show where the time goes.

Details land in ``build/chip_smoke.json`` (git-ignored).  The
second-to-last lines are the kernels' JSON record and the card's name and
power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check exits non-zero before that line.  Imports no JAX.
Without CUDA, or without the repository's ``src/`` beside it, it fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DETAILS = ROOT / "build" / "chip_smoke.json"

# published peaks of one H100 SXM (dense): bf16 tensor cores, fp32 CUDA cores
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
F32_FLOPS_S = 67e12

# bf16 kernel vs plain version: both accumulate in fp32 and round the
# output to bf16 once, so they may differ by a couple of bf16 ulps
# (2^-8 relative) of the output's magnitude
KERNEL_TOL = dict(atol=2e-2, rtol=2e-2)
# teacher-forced logits, plain path vs kernel path, bf16 through 28 layers:
# the paths differ only in where a bf16 rounding lands inside attention and
# rmsnorm, and random weights carry such 2^-8 relative differences from
# layer to layer; 10% of the step's largest |logit| stays far below what a
# wrong mask, position or page does (those change the logits wholesale)
LOGIT_TOL = 0.1
# mse: f32 sums of squares added in another order, the last ~1000 block
# partials by atomics in no fixed order; each atomic rounds to half an ulp
# of the running sum, so the sums differ by ~4e-7 relative (std) at any
# size.  2e-6 is ~5 of those; at 2^16 elements (one per thread) a lost
# element moves the sum by ~1.5e-5 relative, and at 2^25 a lost thread's
# run (124 elements) by ~4e-6
MSE_TOL = dict(atol=0.0, rtol=2e-6)
# f32 2048^3: each output sums 2048 products of N(0,1) pairs (|c| ~ 45) in
# another order than cuBLAS; f32 rounding leaves ~1e-5 relative, and a
# wrong tile or edge moves an entry by O(1)
MATMUL_TOL = dict(atol=2e-3, rtol=1e-4)
WARP_KERNELS = ("shfl", "vote", "tile_reduce", "mse_partial_sum", "matmul")
WARP_FORM_STEPS = 4
ARCH = "qwen2-1.5b"
SLOTS = 4
MAX_NEW = 32
MAX_SEQ = 576
PAGE_SIZE = 16


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after a warm-up; inputs stay warm in the 50 MB L2)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _words(t: torch.Tensor) -> torch.Tensor:
    """uint32 results (ballots) compared through their int32 view."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def agrees(got: torch.Tensor, want: torch.Tensor, tol) -> bool:
    """``tol`` is "exact" (same dtype and bits) or allclose's keywords."""
    got, want = _words(got), _words(want)
    if tol == "exact":
        return got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    return torch.allclose(got.float(), want.float(), **tol)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (_words(got).double() - _words(want).double()).abs().max().item()


def record_kernel(rows, name, source, replaces, got, want, tol, t_kernel, t_plain,
                  n_bytes, flops, peak, t_lib):
    """Hold a kernel's result against its plain version's, print the line
    and add the kernel's JSON row (launches are filled in by the phase
    that drives the main path)."""
    torch.cuda.synchronize()
    err = max_err(got, want)
    ok = agrees(got, want, tol)
    b_ms, b_by = bound(n_bytes, flops, peak)
    rows[name] = dict(name=name, route="cuda", source=source,
                      replaces=replaces, launches=0, max_abs_err=err,
                      ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms,
                      bound_by=b_by, library_ms=t_lib)
    lib = "none" if t_lib is None else f"{t_lib:.4f}"
    print(f"kernel {name}: max_abs_err={err:.3e} tol={tol} ok={ok} "
          f"ms={t_kernel:.4f} plain_ms={t_plain:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"library_ms={lib}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version beyond {tol}")


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def check_kernels(cfg, gen: torch.Generator) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import flash_decode, paged_flash_decode
    from repro_torch.kernels.decode_attention.ref import (
        flash_decode_ref,
        paged_flash_decode_ref,
    )
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    dev, bf = "cuda", torch.bfloat16
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = hq // hkv
    b, s = SLOTS, 512                              # a full prefill batch
    bs = 2                                         # bf16 bytes

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    rows = {}

    def record(name, source, replaces, got, want, *args):
        record_kernel(rows, name, source, replaces, got, want, KERNEL_TOL, *args)

    # rmsnorm: ln1/ln2 over a prefill batch of 4 x 512 rows
    x, w = randn(b * s, d), randn(d)
    got, want = rmsnorm(x, w, cfg.norm_eps), rmsnorm_ref(x, w, cfg.norm_eps)
    torch.cuda.synchronize()
    record("rmsnorm", "src/repro_torch/kernels/rmsnorm/rmsnorm.cu",
           "src/repro/kernels/rmsnorm/rmsnorm.py:29", got, want,
           cuda_ms(lambda: rmsnorm(x, w, cfg.norm_eps)),
           cuda_ms(lambda: rmsnorm_ref(x, w, cfg.norm_eps)),
           2 * x.numel() * bs + d * bs, 4 * x.numel(), F32_FLOPS_S,
           cuda_ms(lambda: F.rms_norm(x, (d,), w, cfg.norm_eps)))

    # flash forward: causal prefill of 4 x 512 tokens, 12 q heads over 2 kv
    q, k, v = randn(b, s, hq, dh), randn(b, s, hkv, dh), randn(b, s, hkv, dh)
    (got, lse), (want, lse_ref) = (flash_attention_fwd(q, k, v),
                                   flash_attention_ref(q, k, v))
    torch.cuda.synchronize()
    lse_err = (lse - lse_ref).abs().max().item()
    if lse_err > 1e-3:
        fail(f"flash_attention_fwd lse differs from its plain version by {lse_err}")
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    record("flash_attention_fwd",
           "src/repro_torch/kernels/flash_attention/flash_attention.cu",
           "src/repro/kernels/flash_attention/flash_attention.py:123", got, want,
           cuda_ms(lambda: flash_attention_fwd(q, k, v)),
           cuda_ms(lambda: flash_attention_ref(q, k, v)),
           (2 * q.numel() + 2 * k.numel()) * bs + b * hq * s * 4,
           4 * dh * b * hq * s * (s + 1) // 2, BF16_FLOPS_S,
           cuda_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True, enable_gqa=True)))

    # decode at the serving path's positions: one query per slot against
    # the dense cache sliced to the attend bucket (a strided view)
    pos = torch.tensor([543, 400, 300, 64], dtype=torch.int32, device=dev)
    attend = 576
    live = int((pos + 1).sum())
    qd = randn(b, hkv, g, dh)
    kc, vc = randn(b, MAX_SEQ, hkv, dh), randn(b, MAX_SEQ, hkv, dh)
    kv_view, vv_view = kc[:, :attend], vc[:, :attend]
    got, want = flash_decode(qd, kv_view, vv_view, pos), flash_decode_ref(
        qd, kv_view, vv_view, pos)
    torch.cuda.synchronize()
    mask = (torch.arange(attend, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
    q4 = qd.reshape(b, 1, hq, dh).transpose(1, 2)
    dec_bytes = (2 * qd.numel() + 2 * live * hkv * dh) * bs
    dec_flops = 4 * dh * hq * live
    record("flash_decode", "src/repro_torch/kernels/decode_attention/decode_attention.cu",
           "src/repro/kernels/decode_attention/decode_attention.py:108", got, want,
           cuda_ms(lambda: flash_decode(qd, kv_view, vv_view, pos)),
           cuda_ms(lambda: flash_decode_ref(qd, kv_view, vv_view, pos)),
           dec_bytes, dec_flops, BF16_FLOPS_S,
           cuda_ms(lambda: F.scaled_dot_product_attention(
               q4, kv_view.transpose(1, 2), vv_view.transpose(1, 2),
               attn_mask=mask, enable_gqa=True)))

    # paged decode: the same positions through shuffled 16-token pages
    nb = MAX_SEQ // PAGE_SIZE
    n_pages = b * nb + 1
    kp, vp = randn(n_pages, PAGE_SIZE, hkv, dh), randn(n_pages, PAGE_SIZE, hkv, dh)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = perm.reshape(b, nb).to(torch.int32)
    got = paged_flash_decode(qd, kp, vp, bt, pos)
    want = paged_flash_decode_ref(qd, kp, vp, bt, pos)
    torch.cuda.synchronize()
    tables = int((pos // PAGE_SIZE + 1).sum()) * 4
    record("paged_flash_decode",
           "src/repro_torch/kernels/decode_attention/decode_attention.cu",
           "src/repro/kernels/decode_attention/decode_attention.py:189", got, want,
           cuda_ms(lambda: paged_flash_decode(qd, kp, vp, bt, pos)),
           cuda_ms(lambda: paged_flash_decode_ref(qd, kp, vp, bt, pos)),
           dec_bytes + tables, dec_flops, BF16_FLOPS_S, None)
    return rows


def check_warp_kernels(gen: torch.Generator) -> dict:
    """The warp-feature kernels against their plain versions at sizes where
    launch latency does not dominate: (2^20, 32) lane blocks (128 MiB),
    2^25 mse elements, a 2048^3 f32 product; plus one width-128 case of
    each lane kernel, which takes the cross-warp shared-memory step.  The
    sweep over modes, dtypes, widths and ragged shapes is
    tests/test_torch_kernels_cuda.py's."""
    import torch.nn.functional as F

    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.mse.ops import mse_partial_sum
    from repro_torch.kernels.mse.ref import mse_partial_sum_ref
    from repro_torch.kernels.tile_reduce.ops import tile_reduce
    from repro_torch.kernels.tile_reduce.ref import tile_reduce_ref
    from repro_torch.kernels.warp_ops.ops import shfl, vote
    from repro_torch.kernels.warp_ops.ref import shfl_ref, shfl_src, vote_ref

    dev, rows = "cuda", {}
    n, w = 2 ** 20, 32
    x = torch.randn(n, w, generator=gen, device=dev)
    x128 = torch.randn(n // 4, 128, generator=gen, device=dev)
    block_bytes = 2 * x.numel() * 4            # read once, write once

    def check(name, got, want, tol="exact"):
        torch.cuda.synchronize()
        if not agrees(got, want, tol):
            fail(f"{name} disagrees with its plain version ({tol}), "
                 f"max_abs_err {max_err(got, want):.3e}")

    # shfl: Fig. 5's butterfly, bfly 16 timed at width 32
    check("shfl bfly 64 width 128", shfl(x128, "bfly", 64), shfl_ref(x128, "bfly", 64))
    src = shfl_src("bfly", w, 16, dev).expand(n, w)
    record_kernel(rows, "shfl", "src/repro_torch/kernels/warp_ops/warp_ops.cu",
                  "src/repro/kernels/warp_ops/warp_ops.py:90",
                  shfl(x, "bfly", 16), shfl_ref(x, "bfly", 16), "exact",
                  cuda_ms(lambda: shfl(x, "bfly", 16)),
                  cuda_ms(lambda: shfl_ref(x, "bfly", 16)),
                  block_bytes, 0, F32_FLOPS_S,
                  cuda_ms(lambda: torch.gather(x, 1, src)))

    # vote: Fig. 5's "any" without a mask timed; half the rows unanimous
    pred = (x > 0).to(torch.int32)
    pred[: n // 2] = 1
    p128 = (x128 > 0).to(torch.int32)
    p128[: n // 8] = 1
    check("vote uni width 128", vote(p128, "uni"), vote_ref(p128, "uni"))
    record_kernel(rows, "vote", "src/repro_torch/kernels/warp_ops/warp_ops.cu",
                  "src/repro/kernels/warp_ops/warp_ops.py:110",
                  vote(pred, "any"), vote_ref(pred, "any"), "exact",
                  cuda_ms(lambda: vote(pred, "any")),
                  cuda_ms(lambda: vote_ref(pred, "any")),
                  block_bytes, 0, F32_FLOPS_S,
                  cuda_ms(lambda: torch.any(pred, dim=1)))

    # tile_reduce: Fig. 5's reduce, an 8-lane f32 sum, timed; tile 128
    # takes the shared-memory steps.  The library call writes one value
    # per tile, 1/8 of the kernel's output bytes.
    check("tile_reduce sum tile 128", tile_reduce(x128, 128), tile_reduce_ref(x128, 128))
    record_kernel(rows, "tile_reduce", "src/repro_torch/kernels/tile_reduce/tile_reduce.cu",
                  "src/repro/kernels/tile_reduce/tile_reduce.py:43",
                  tile_reduce(x, 8), tile_reduce_ref(x, 8), "exact",
                  cuda_ms(lambda: tile_reduce(x, 8)),
                  cuda_ms(lambda: tile_reduce_ref(x, 8)),
                  block_bytes, 3 * x.numel(), F32_FLOPS_S,
                  cuda_ms(lambda: x.view(n, -1, 8).sum(-1)))

    # mse: f32 atomics in no fixed order, so a relative tolerance; 2^16
    # elements give each thread one, 2^25 (timed) a grid-stride run of 124
    p, t = (torch.randn(2 ** 16, generator=gen, device=dev) for _ in "pt")
    check("mse_partial_sum 2^16", mse_partial_sum(p, t), mse_partial_sum_ref(p, t), MSE_TOL)
    m = 2 ** 25
    p, t = (torch.randn(m, generator=gen, device=dev) for _ in "pt")
    record_kernel(rows, "mse_partial_sum", "src/repro_torch/kernels/mse/mse.cu",
                  "src/repro/kernels/mse/mse.py:45",
                  mse_partial_sum(p, t), mse_partial_sum_ref(p, t), MSE_TOL,
                  cuda_ms(lambda: mse_partial_sum(p, t)),
                  cuda_ms(lambda: mse_partial_sum_ref(p, t)),
                  2 * m * 4 + 4, 3 * m, F32_FLOPS_S,
                  cuda_ms(lambda: F.mse_loss(p, t, reduction="sum")))

    # matmul: 2048^3 in f32 on the CUDA cores against cuBLAS in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    d = 2048
    a, b = (torch.randn(d, d, generator=gen, device=dev) for _ in "ab")
    record_kernel(rows, "matmul", "src/repro_torch/kernels/matmul/matmul.cu",
                  "src/repro/kernels/matmul/matmul.py:39",
                  matmul(a, b), matmul_ref(a, b), MATMUL_TOL,
                  cuda_ms(lambda: matmul(a, b)), cuda_ms(lambda: matmul_ref(a, b)),
                  3 * d * d * 4, 2 * d ** 3, F32_FLOPS_S,
                  cuda_ms(lambda: torch.matmul(a, b)))
    return rows


# ---------------------------------------------------------------------------
# phase 1b: the paper's main path — Fig. 5 through the warp kernels
# ---------------------------------------------------------------------------

def run_fig5(seed: int):
    """Fig. 5 at the reference's size (8192 blocks of WarpConfig(8, 4),
    matmul 64 x 64): HW through the warp-intrinsic kernels, SW through the
    PR-transformation lane loops.  Returns the rows and the launch counts
    of the run."""
    from repro_torch import kernels
    from repro_torch.bench import fig5_microbench as fig5

    torch.cuda.synchronize()
    kernels.reset_launches()
    rows = fig5.run(seed=seed, device="cuda")     # raises if HW != SW
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for line in fig5.format_rows(rows):
        print(f"fig5 {line}", flush=True)
    print(f"fig5 launches {counts}", flush=True)
    for name in WARP_KERNELS:
        if counts[name] == 0:
            fail(f"{name} never launched in the Fig. 5 run")
    return rows, counts


# ---------------------------------------------------------------------------
# phase 2: the main path — serve on both layouts
# ---------------------------------------------------------------------------

def make_requests(seed: int, vocab: int):
    """(uid, prompt, max_new_tokens) for 8 requests of 64-512 tokens."""
    rng = np.random.default_rng(seed)
    lens = [512] + rng.integers(64, 513, 7).tolist()   # the longest goes first
    return [(i, rng.integers(0, vocab, n).tolist(), MAX_NEW)
            for i, n in enumerate(lens)]


def serve(model, params, spec, **kw):
    from repro_torch import kernels
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(model, params, max_seq=MAX_SEQ, batch_slots=SLOTS, **kw)
    reqs = [Request(u, list(p), n) for u, p, n in spec]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for u, _, n in spec:
        s = eng.last_stats[u]
        if s["status"] != "ok" or s["tokens"] != n or len(out.get(u, [])) != n:
            fail(f"request {u}: status {s['status']}, {s.get('tokens')} of {n} tokens")
    n_tok = sum(len(v) for v in out.values())
    return out, eng, counts, wall, n_tok


def teacher_force(model, params, prompt, tokens):
    """Logits of ``model`` for one request (prefill, then decode on the
    served ``tokens``), batch 1: one row per generated position."""
    logits, cache = model.prefill(params, torch.tensor([prompt], device="cuda"), MAX_SEQ)
    steps = [logits[0]]
    for t, tok in enumerate(tokens[:-1]):
        pos = torch.tensor([len(prompt) + t], dtype=torch.int32, device="cuda")
        attend = min(MAX_SEQ, -(-(len(prompt) + t + 1) // 64) * 64)
        logits, cache = model.decode_step(params, cache,
                                          torch.tensor([tok], device="cuda"), pos,
                                          attend_len=attend)
        steps.append(logits[0])
    return torch.stack(steps)


def compare_logits(label, got, want):
    """Max |logit| error per step against LOGIT_TOL of the step's logit
    scale, and argmax agreement; returns (max err, scale, agreement)."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"non-finite logits in the teacher-forced {label} run")
    err = (got - want).abs().max(dim=-1).values
    scale = want.abs().max(dim=-1).values
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"teacher-forced {label}: {got.shape[0]} steps, max |logit err| "
          f"{err.max().item():.4e} (logit scale {scale.max().item():.4e}, worst "
          f"step ratio {(err / scale).max().item():.4e}); argmax agreement "
          f"{agree:.4f}", flush=True)
    if (err > LOGIT_TOL * scale).any():
        fail(f"{label} logits differ from the kernel path's by more than "
             f"{LOGIT_TOL} of the logit scale")
    return err.max().item(), scale.max().item(), agree


def _kernel_us(evt) -> float:
    """Device time of a kernel event (CPU-side ops, whose device time
    repeats their kernels', count 0)."""
    from torch.autograd import DeviceType

    if evt.device_type != DeviceType.CUDA:
        return 0.0
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0) or 0)


def where_time_goes(model, params, gen):
    """Host wall time (with a synchronize) and summed device kernel time
    (torch.profiler) of one full-batch decode step and one 4 x 512 prefill
    on the kernel path; their ratio is the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    pos = torch.tensor([543, 400, 300, 64], dtype=torch.int32, device="cuda")
    tok = torch.zeros(SLOTS, dtype=torch.int32, device="cuda")
    cache = model.init_cache(SLOTS, MAX_SEQ)
    toks = torch.randint(0, model.cfg.vocab, (SLOTS, 512), generator=gen,
                         device="cuda")
    phases = {}
    for name, fn, n in (
            ("decode_step", lambda: model.decode_step(params, cache, tok, pos,
                                                      attend_len=MAX_SEQ), 10),
            ("prefill_4x512", lambda: model.prefill(params, toks, 512), 3)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        dev_ms = sum(_kernel_us(e) for e in events) / 1e3 / n
        top = sorted(events, key=_kernel_us, reverse=True)[:8]
        phases[name] = dict(wall_ms=wall_ms, device_ms=dev_ms, top=[
            (e.key[:70], _kernel_us(e) / 1e3 / n) for e in top
            if _kernel_us(e) > 0])
        busy = f"{dev_ms / wall_ms:.3f}" if dev_ms > 0 else "not measured"
        print(f"time {name}: wall {wall_ms:.3f} ms, device kernels {dev_ms:.3f} ms, "
              f"device busy share {busy}; top: "
              + "; ".join(f"{k} {ms:.3f}" for k, ms in phases[name]["top"]),
              flush=True)
    return phases


def fig5_device_time(seed: int, iters: int = 5) -> dict:
    """Device side of Fig. 5: summed kernel time (torch.profiler) and
    kernel launches per call of each lowering.  Event-timed calls above
    include the host's gaps; this says how much of each is device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bench import fig5_microbench as fig5

    inputs = fig5.make_inputs(seed, "cuda")
    out = {}
    for name, spec in fig5.BENCHES.items():
        out[name] = {}
        for low in fig5.LOWERINGS:
            fn, args = spec["make"](low), inputs[name]
            fn(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn(*args)
                torch.cuda.synchronize()
            events = prof.key_averages()
            out[name][low] = dict(
                device_us=sum(_kernel_us(e) for e in events) / iters,
                kernels=sum(e.count for e in events
                            if e.device_type == DeviceType.CUDA) / iters)
        r = out[name]
        ratio = (r["sw"]["device_us"] / r["kernel"]["device_us"]
                 if r["kernel"]["device_us"] > 0 else float("nan"))
        print(f"fig5 device {name}: " + "; ".join(
            f"{low} {r[low]['device_us']:.1f} us in {r[low]['kernels']:.0f} kernels"
            for low in fig5.LOWERINGS) + f"; SW/HW device {ratio:.2f}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.models.layers import WarpFeatureConfig
        from repro_torch.models.lm import Model
    except ImportError as exc:
        fail(f"cannot import the port from {ROOT / 'src'}: {exc}")

    smi = smi_line()
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.LIB.load()
    print(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({len(build.sources())} sources)", flush=True)

    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = check_kernels(cfg, gen)
    serving_kernels = tuple(rows)
    rows.update(check_warp_kernels(gen))

    fig5_rows, fig5_counts = run_fig5(args.seed)
    for name in WARP_KERNELS:
        rows[name]["launches"] = fig5_counts[name]
    fig5_device = fig5_device_time(args.seed)

    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    params = model.init(torch.Generator(device="cuda").manual_seed(args.seed))
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"model: {ARCH} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_head={cfg.d_head} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} params={n_params} dtype=bf16",
          flush=True)
    spec = make_requests(args.seed, cfg.vocab)
    print(f"requests: {len(spec)} prompts of {[len(p) for _, p, _ in spec]} tokens, "
          f"max_new_tokens={MAX_NEW}, slots={SLOTS}, max_seq={MAX_SEQ}", flush=True)
    # warm-up (cuBLAS handles, allocator): one short request, not counted
    serve(model, params, [(99, spec[1][1][:64], 2)])

    dense, _, dense_counts, dense_wall, dense_tok = serve(model, params, spec)
    print(f"serve dense: {dense_tok} tokens in {dense_wall:.3f} s = "
          f"{dense_tok / dense_wall:.1f} tok/s; launches {dense_counts}", flush=True)
    # the first four prompts fill the pool but for one growth page per
    # slot: the batch cannot grow 32 tokens without preempting
    first = sum(-(-len(p) // PAGE_SIZE) for _, p, _ in spec[:SLOTS])
    num_pages = first + SLOTS - 1 + 1
    paged, eng, paged_counts, paged_wall, paged_tok = serve(
        model, params, spec, cache_layout="paged", page_size=PAGE_SIZE,
        num_pages=num_pages)
    print(f"serve paged: {paged_tok} tokens in {paged_wall:.3f} s = "
          f"{paged_tok / paged_wall:.1f} tok/s; pool {num_pages} pages; "
          f"preemptions {eng.preemptions}; launches {paged_counts}", flush=True)
    if eng.preemptions < 1:
        fail("the paged run was sized to preempt and did not")
    if eng.last_pool_stats.used_pages != 0:
        fail(f"paged run leaked {eng.last_pool_stats.used_pages} pages")
    agree = np.mean([a == b for u in dense for a, b in zip(dense[u], paged[u])])
    print(f"dense vs paged token agreement: {agree:.4f}", flush=True)
    for name in ("rmsnorm", "flash_attention_fwd"):
        if dense_counts[name] == 0 or paged_counts[name] == 0:
            fail(f"{name} never launched while serving")
    if dense_counts["flash_decode"] == 0 or paged_counts["paged_flash_decode"] == 0:
        fail("a decode kernel never launched while serving")
    for name in serving_kernels:
        rows[name]["launches"] = dense_counts[name] + paged_counts[name]

    # teacher-force the plain-version path on request 0's served tokens
    uid, prompt, _ = spec[0]
    plain = Model(cfg, device="cuda", dtype=torch.bfloat16, use_kernels=False)
    k_logits = teacher_force(model, params, prompt, dense[uid])
    p_logits = teacher_force(plain, params, prompt, dense[uid])
    err, scale, _ = compare_logits(f"uid {uid} plain vs kernel path",
                                          p_logits, k_logits)
    agree_served = (p_logits.argmax(-1) == torch.tensor(dense[uid], device="cuda")
                    ).float().mean().item()
    print(f"token agreement plain vs served {agree_served:.4f}", flush=True)

    # the paper's reduction forms inside the full-width model: every norm
    # reduced in 128-lane groups by the HW primitives and by the SW
    # (PR-transformation) lane loops, prefill + WARP_FORM_STEPS decode steps
    warp_forms = {}
    steps = dense[uid][:WARP_FORM_STEPS + 1]
    for form in ("hw_warp", "sw"):
        m = Model(cfg, device="cuda", dtype=torch.bfloat16,
                  wf=WarpFeatureConfig(form))
        t0 = time.perf_counter()
        f_logits = teacher_force(m, params, prompt, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f_err, _, f_agree = compare_logits(f"uid {uid} wf={form} vs kernel path",
                                           f_logits, k_logits[:len(steps)])
        if f_agree < 1.0:
            fail(f"wf={form} changes the greedy token at some step")
        warp_forms[form] = dict(max_err=f_err, argmax_agreement=f_agree, wall_s=wall)
        print(f"wf={form}: prefill + {len(steps) - 1} decode steps in {wall:.2f} s",
              flush=True)

    phases = where_time_goes(model, params, gen)

    result = {"kernels": list(rows.values())}
    DETAILS.parent.mkdir(parents=True, exist_ok=True)
    DETAILS.write_text(json.dumps(dict(
        result, device=smi, phases=phases, dense_tok_s=dense_tok / dense_wall,
        paged_tok_s=paged_tok / paged_wall, dense_counts=dense_counts,
        paged_counts=paged_counts, preemptions=eng.preemptions,
        num_pages=num_pages, teacher_forced_max_err=err, logit_scale=scale,
        fig5=fig5_rows, fig5_counts=fig5_counts, fig5_device=fig5_device,
        warp_forms=warp_forms), indent=1))
    print(json.dumps(result), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
