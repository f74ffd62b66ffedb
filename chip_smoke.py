"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``src/repro_torch/kernels`` and drives
its paths:

1. Kernels.  Each kernel against its plain PyTorch version on the card
   (max error, times, the least time the card could take, and one PyTorch
   library call as a yardstick): the four serving kernels at the serving
   path's shapes, the flash forward and backward at one training layer
   call's shape (each flash row names the dtype branch it ran: bf16 on the
   tensor cores, f32 on the CUDA cores; the forward's share of bf16
   outputs that round otherwise than the plain version's is printed),
   the five warp-feature kernels (shfl, vote, tile_reduce,
   mse_partial_sum, matmul) at sizes where launch latency does not
   dominate, and ``moe_gating`` at OLMoE's prefill shape (512 x 64, bf16,
   top-8) and decode shape (4 x 64), the Pallas kernel's edge rows first
   (ties, a NaN, all -inf, -1e30 below and above the picks, -3e38, +inf,
   +0/-0 ties), held against both plain versions (the rounds and their
   rank closed form) in bf16 and on the same values in f32, and timed
   with the calls queued beside an empty launch queued the same way, and
   the int8 branches of paged decode and verify (``paged_flash_decode[int8]``,
   ``paged_flash_verify[int8]``) at the serving shapes on pages quantized on
   the card, whose bytes must equal the CPU's, each also held against the
   float kernel on the dequantized pages (bf16 and f32 q).  rmsnorm is timed
   at prefill's 4 x 512 rows and training's 8192 rows under an fp32 weight
   (beside ``F.rms_norm``); matmul in f32 (3xTF32 on the tensor cores;
   its bound is the smaller of the f32 CUDA cores' and three TF32
   products', both printed) and in bf16 (beside ``torch.matmul``), at
   2048^3.  The decode rows (dense, paged and int8-paged at qwen2's G = 6,
   and at OLMoE's G = 1 in phase 6) time their calls queued behind a spin
   on the card (the card's time; each call launches the split kernel and
   the combine pass) and print their factor to SDPA's queued time on the
   same slots and positions; so do the verify rows (bf16 and int8, the
   same split kernel over a spec_k = 4 window, beside SDPA on the dense
   view under the window's causal mask), which also print their split
   counts, and T = 1 verify must equal paged decode within 1e-6 (it
   prints whether bit for bit).  ``nvcc -Xptxas -v`` and ``cuobjdump
   -sass`` of ``matmul.cu``, ``rmsnorm.cu``, ``decode_attention.cu``,
   ``verify_attention.cu`` and ``warp_ops.cu`` run beside this phase
   (``ptxas ...`` lines, keyed by source: registers, spills, shared
   memory, HMMA count); it fails unless every matmul kernel has HMMA
   instructions and both decode kernels were reported.
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
   tolerance (and, for the forms, the same greedy tokens).  Each run's
   prefill groups (uids, bucket, lengths) are logged, each request the
   bf16 layouts served otherwise is probed (its prompt rows as the two
   runs' prefill calls computed them), and an fp32 control serves dense
   and on the preempting pool, which must agree on every token (ROADMAP
   C1; the bf16 agreement is reported).  Last, it times one
   full-batch decode step (dense, paged bf16, paged int8) and one prefill
   against their summed kernel time (torch.profiler) to show where the
   time goes; each decode step's profile, and the spec_k = 4 verify
   step's, must hold both split-kernel passes (``decode_split_kernel``,
   ``decode_combine_kernel``), whose times it prints.
4. Speculative serving (``spec ...`` lines): the same 8 requests with
   spec_k = 4 on the paged layout, the verify window through
   ``paged_flash_verify``.  (a) A 14-layer self draft on the random
   weights, the pool sized to preempt; (b) weights damped to a
   near-identity stack with a 1-layer self draft, beside non-speculative
   paged serving of the same weights; (c) request 0's served tokens
   teacher-forced in windows of 4 through ``decode_verify_step``, kernel
   path and plain path, against the decode-step logits.  It fails unless
   every request finishes, the verify kernel launched, (a) preempted and
   both pools drained, and the verify logits stay within the tolerance.
4b. Tiered KV memory (``tiered ...`` lines), int8 pools: (a) the preempting
   pool under ``preempt="requeue"`` and ``"swap"`` (swapped bytes, the
   swap copy time, tok/s beside bf16 paged), (b) an int8 pool of the bf16
   preempting pool's bytes (preemptions beside bf16's), (c) an ample pool,
   (d) spec_k = 4 with the damped self:1 draft on the preempting pool,
   swapping.  Request 0's verify windows over an int8 pool are
   teacher-forced against int8 decode steps (kernel and plain path).  It
   fails unless every request finishes, both int8 branches launched (and
   no float paged kernel), the swap run swapped out and in, every pool
   drained, the ample pool never preempted, the windows stay within the
   logit tolerance, and, in an fp32 control, the swap, requeue and ample
   runs serve identical tokens, bar a request whose prompt the probe
   shows stored with other int8 bytes in the two runs (prefilled in
   another group or bucket); their bf16 agreement, and int8 against bf16
   paged and dense, are reported.
5. Training (``train ...`` lines): full-width, full-depth qwen2-1.5b with
   fp32 master weights and AdamW state, bf16 compute, remat per layer and
   the 8-chunk loss, at the reference's train_4k length (S 4096; batch 2,
   cut from the reference's 256).  First one gradient on one batch twice
   on the same weights, kernel path and plain path (tf32 off), held to
   the loss, global-norm, per-leaf cosine and per-leaf norm-difference
   gates below, and a faulted control that must trip them; then
   ``Trainer.run`` for 4 steps (loss, lr, grad_norm, ms, tokens/s, peak
   memory, launches); then one profiled step.  It fails on a non-finite
   loss or unless every layer's backward went through
   ``flash_attention_bwd``.
6. MoE serving (``moe ...`` lines), before training and after the qwen2
   serving model is freed: full-width OLMoE-1B-7B (16 layers, d_model
   2048, 16/16 heads, 64 experts, top-8; random bf16 weights from the
   seed) serves the same 8 requests on the dense cache, a preempting
   paged pool and an ample one, each prompt prefilled alone at its exact
   length, the router's top-k through ``moe_gating``.  First it holds the
   kernels at OLMoE's own shapes against their plain versions (flash
   forward at G = 1 and S 300, dense and paged decode at G = 1, rmsnorm
   over 512 x 2048 bf16 rows; decode at G = 1 with its bound and beside
   SDPA, for scale).  It fails unless every request finishes,
   every kernel of the path launched, the paged runs serve the dense
   run's tokens, one decode step launches ``moe_gating`` once per layer,
   and the teacher-forced plain path stays within the logit tolerance.  A
   preempted request may differ only where its re-prefill dropped expert
   picks at the prefill capacity (counted in a tapped rerun), and with
   nothing dropped, in fp32, it must agree (a control on the same
   weights; a bf16 control beside it is reported).  The teacher-forced
   paths' expert choices are compared, and the plain path is run again
   with the kernel path's routing replayed.  Last, one prefill and one
   decode step are profiled; each profile must hold ``moe_gating``'s
   device time, which the ``time`` line prints.

Every serving, MoE and training run must normalize through rmsnorm's
one-warp-a-row branch: the run fails if one launched its block-per-row
ragged branch.  The flash rows count the bf16 branch's launches only.  The fp32 controls
(C1, the tiered and the MoE ones) run the f32 branch: its launches are
printed on a line of their own, and the run fails if a bf16 run launched
an f32 flash kernel or an fp32 control a bf16 one.

Details land in ``build/chip_smoke.json`` (git-ignored).  The
second-to-last lines are the kernels' JSON record and the card's name and
power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check exits non-zero before that line.  Imports no JAX.
Without CUDA, or without the repository's ``src/`` beside it, it fails.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DETAILS = ROOT / "build" / "chip_smoke.json"

# published peaks of one H100 SXM (dense): bf16 and TF32 tensor cores, fp32
# CUDA cores
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
TF32_FLOPS_S = 495e12
F32_FLOPS_S = 67e12

# bf16 kernel vs plain version: both accumulate in fp32 and round the
# output to bf16 once, so they may differ by a couple of bf16 ulps
# (2^-8 relative) of the output's magnitude
KERNEL_TOL = dict(atol=2e-2, rtol=2e-2)
# the flash forward at B 2 x S 4096 from N(0, 1) inputs: a row over n keys
# has |o| ~ sqrt(e / n), 0.03 at n ~ 3000, so KERNEL_TOL would pass a wrong
# P.V there.  rtol 8e-3 is one bf16 ulp (<= 2^-7 relative) wherever |o| is
# large, atol 2e-3 a few ulps of the small rows' |o|
FLASH_FWD_TOL = dict(atol=2e-3, rtol=8e-3)
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
MOE_ARCH = "olmoe-1b-7b"
# moe_gating vs its plain version: the same selection from the same f32
# values (a wrong pick moves a mask entry by 1) and weights <= 1 from the
# same exps, summed over the k selected in another order: a few f32 ulps
GATING_TOL = dict(atol=1e-6, rtol=0.0)
NEG_SENTINEL = -1e30          # the Pallas gating kernel's mask-out value
SLOTS = 4
MAX_NEW = 32
MAX_SEQ = 576
PAGE_SIZE = 16
SPEC_K = 4
# the slots' positions in a full decode batch, and their attend bucket
DECODE_POS = (543, 400, 300, 64)
ATTEND = 576
# verify kernel at T = 1 against the paged decode kernel in f32: one split
# kernel on the same split count, so they agree exactly (the gate stays
# at a few f32 ulps)
T1_TOL = 1e-6
# flash backward vs its plain version: both widen the same bf16 inputs
# and return f32 sums over up to 4096 keys (dq) or 6 x 4096 query rows
# (dk/dv) taken in another order, ~1e-5 of the sums' magnitude (<= ~10);
# a wrong mask, tile edge or group sum moves entries by O(0.1-1)
BWD_TOL = dict(atol=1e-3, rtol=1e-3)
# int8 kernels with f32 q: the plain version and the kernel dequantize to
# the same f32 values and sum in another order, to f32 rounding of the
# output (|o| <= max |v| ~ 4)
INT8_F32_TOL = dict(atol=1e-5, rtol=1e-5)
# training: the reference's train_4k sequence (config.py:148); its global
# batch of 256 is a pod's, cut to 2 for one card
TRAIN_SEQ = 4096
TRAIN_BATCH = 2
TRAIN_STEPS = 4
VOCAB_CHUNKS = 8
# one gradient, kernel path vs plain path, bf16 compute through 28
# layers: the paths round to bf16 at the same points and differ only in
# the order of fp32 sums, so an occasional bf16 ulp flips and spreads.
# Each gate was set at ~10x this phase's sound reading on an H100 with the
# CUDA-core flash kernels (PERF.md): loss 2.9e-6, global norm 3.8e-5
# relative, and at layers.attn.bk 1 - cosine 4.1e-5 and a norm difference
# of 9.1e-3 relative.  The tensor-core flash kernels read 1.5e-5, 3.3e-5,
# 4.9e-5 and 9.9e-3; with the one-warp-a-row rmsnorm since (its bf16
# outputs round otherwise than the plain version's at 5.7e-6 of training's
# 8192 x 1536 elements, where the block-per-row kernel's did at 5.1e-6,
# other elements) 2.956e-5, 1.7e-5, 5.1e-5 and 1.0e-2: the loss 1.5 %
# under its gate (src/repro_torch/bench/grad_ab.py on each tree).  Variants
# of the flash kernels with an exact exp, a third bf16 term or fp32 sums
# across tiles read a loss difference of 1.1e-5 to 2.3e-5 whatever their
# own error (scripts/flash_variants.py): it is bf16 rounding noise through
# 28 layers, not a measure of the kernels' error.  The loss cannot see
# the backward (at random weights it sits near ln V whatever attention
# computes) and the cosine is blind to a wrong scale; the per-leaf norm
# difference is not, and a faulted control (dk scaled by GRAD_FAULT_DK
# in the backward) must trip a gate, or the gates are blind and the
# phase fails.
GRAD_LOSS_TOL = 3e-5          # absolute, on a loss of ~12 (ln 151936)
GRAD_NORM_TOL = 4e-4          # global norms, relative
GRAD_COS_MIN = 1 - 4e-4       # smallest per-leaf cosine similarity
GRAD_LEAF_TOL = 0.09          # largest per-leaf |a - b| / |b|
GRAD_FAULT_DK = 1.25          # the control's wrong dk scale
# rmsnorm's calls take the host longer to launch than the card to run:
# their rows are timed with the calls queued behind a spin on the card,
# long enough for a few hundred launches (cycles at a clock above the
# H100's 1.98 GHz)
SPIN_S = 0.02
SPIN_CYCLES_S = 2.0e9
# queued calls a decode or verify row times (its wrapper launches two
# kernels)
DECODE_ITERS = 100
# the decode and verify wrappers' two kernels, as the profiler names them
DECODE_KERNELS = ("decode_split_kernel", "decode_combine_kernel")
# the gating kernel, as the profiler names it
GATING_KERNEL = "moe_gating_kernel"


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


def cuda_ms(fn, iters: int = 20, warmup: int = 3, queued: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after a warm-up; inputs stay warm in the 50 MB L2).  A call
    the host launches more slowly than the card runs it is timed at the
    host's pace; with ``queued`` the calls first queue up behind a spin on
    the card, and the events time the card's work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(int(SPIN_S * SPIN_CYCLES_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn) -> float:
    """A decode or verify row's time: DECODE_ITERS calls queued behind a
    spin on the card, so the events time the card's work alone (such a
    call runs shorter than the host takes to launch one)."""
    return cuda_ms(fn, iters=DECODE_ITERS, queued=True)


def sdpa_factor(name: str, ms: float, sdpa_ms: float):
    """Print a decode row's factor to SDPA's queued time on the same
    slots, positions and dense view (for scale: the port never calls it;
    paged rows read other K/V through their tables, same shapes)."""
    print(f"kernel {name}: ms={ms:.4f} sdpa_ms={sdpa_ms:.4f} (calls queued) "
          f"factor to SDPA {ms / sdpa_ms:.2f}", flush=True)


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


# the branch of the flash kernels that each dtype runs (one C entry point
# dispatches on it)
FLASH_BRANCHES = {torch.bfloat16: "bf16 (tensor cores: mma.sync, split-bf16 P and dS)",
                  torch.float32: "f32 (CUDA cores)"}
# the branch each flash row ran, for the details file
BRANCHES_RUN = {}
# matmul readings beside its row: the bound candidates, the bf16 branch
MATMUL_READINGS = {}


def record_kernel(rows, name, source, replaces, got, want, tol, t_kernel, t_plain,
                  n_bytes, flops, peak, t_lib, branch=None):
    """Hold a kernel's result against its plain version's, print the line
    and add the kernel's JSON row (launches are filled in by the phase
    that drives the main path).  ``branch`` names the kernel's dtype
    branch where it has two."""
    torch.cuda.synchronize()
    err = max_err(got, want)
    ok = agrees(got, want, tol)
    b_ms, b_by = bound(n_bytes, flops, peak)
    rows[name] = dict(name=name, route="cuda", source=source,
                      replaces=replaces, launches=0, max_abs_err=err,
                      ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms,
                      bound_by=b_by, library_ms=t_lib)
    lib = "none" if t_lib is None else f"{t_lib:.4f}"
    ran = ""
    if branch is not None:
        BRANCHES_RUN[name] = branch
        ran = f" branch={branch}"
    print(f"kernel {name}: max_abs_err={err:.3e} tol={tol} ok={ok} "
          f"ms={t_kernel:.4f} plain_ms={t_plain:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"library_ms={lib}{ran}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version beyond {tol}")


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def decode_case(gen: torch.Generator, hkv: int, g: int, dh: int):
    """bf16 decode inputs at the serving path's positions: one query row
    of G heads per slot and KV head, the dense cache sliced to the attend
    bucket (a strided view), and other K/V through shuffled 16-token pages.
    Returns (q, k view, v view, k pages, v pages, block tables, pos)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q = randn(SLOTS, hkv, g, dh)
    kc, vc = randn(SLOTS, MAX_SEQ, hkv, dh), randn(SLOTS, MAX_SEQ, hkv, dh)
    nb = MAX_SEQ // PAGE_SIZE
    n_pages = SLOTS * nb + 1
    kp, vp = randn(n_pages, PAGE_SIZE, hkv, dh), randn(n_pages, PAGE_SIZE, hkv, dh)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    bt = perm.reshape(SLOTS, nb).to(torch.int32)
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device="cuda")
    return q, kc[:, :ATTEND], vc[:, :ATTEND], kp, vp, bt, pos


def check_kernels(cfg, gen: torch.Generator):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import (
        decode_splits,
        flash_decode,
        paged_flash_decode,
    )
    from repro_torch.kernels.decode_attention.ref import (
        flash_decode_ref,
        paged_flash_decode_ref,
    )
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_ref,
    )
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.verify_attention.ops import paged_flash_verify, verify_splits
    from repro_torch.kernels.verify_attention.ref import paged_verify_attention_ref

    dev, bf = "cuda", torch.bfloat16
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = hq // hkv
    b, s = SLOTS, 512                              # a full prefill batch
    bs = 2                                         # bf16 bytes

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    rows = {}

    def record(name, source, replaces, got, want, *args, **kw):
        record_kernel(rows, name, source, replaces, got, want, KERNEL_TOL, *args, **kw)

    def check(name, got, want, tol):
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(f"kernel {name}: max_abs_err={err:.3e} tol={tol}", flush=True)
        if not agrees(got, want, tol):
            fail(f"{name} disagrees with its plain version beyond {tol}")

    def rmsnorm_row(name, x, w):
        """rmsnorm's row: kernel, plain version and F.rms_norm timed with
        their calls queued (the card's time); the kernel's host-paced time
        printed beside them"""
        fns = [lambda: rmsnorm(x, w, cfg.norm_eps), lambda: rmsnorm_ref(x, w, cfg.norm_eps),
               lambda: F.rms_norm(x, (d,), w, cfg.norm_eps)]
        got, want = fns[0](), fns[1]()
        torch.cuda.synchronize()
        print(f"kernel {name}: {tuple(x.shape)} rows, {w.dtype} weight; host-paced "
              f"ms={cuda_ms(fns[0]):.4f} (calls as the host launches them); the row's "
              f"times are the card's, the calls queued", flush=True)
        kernel_ms, plain_ms, library_ms = (cuda_ms(f, iters=100, queued=True) for f in fns)
        record(name, "src/repro_torch/kernels/rmsnorm/rmsnorm.cu",
               "src/repro/kernels/rmsnorm/rmsnorm.py:29", got, want, kernel_ms, plain_ms,
               2 * x.numel() * bs + d * w.element_size(), 4 * x.numel(), F32_FLOPS_S,
               library_ms)

    # training's rmsnorm: bf16 rows of one 2 x 4096 batch, fp32 weight
    rmsnorm_row("rmsnorm (training)", randn(TRAIN_BATCH * TRAIN_SEQ, d),
                torch.randn(d, generator=gen, device=dev))
    # rmsnorm: ln1/ln2 over a prefill batch of 4 x 512 rows
    rmsnorm_row("rmsnorm", randn(b * s, d), randn(d))

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
               qt, kt, vt, is_causal=True, enable_gqa=True)),
           branch=FLASH_BRANCHES[q.dtype])
    check("flash_attention_fwd (the same o at FLASH_FWD_TOL)", got, want, FLASH_FWD_TOL)

    # flash forward and backward at one training layer call, B 2 x S 4096,
    # causal, 12 q heads over 2 kv; the backward's lse and o from the
    # forward kernel
    bt_, st_ = TRAIN_BATCH, TRAIN_SEQ
    qb, dob = randn(bt_, st_, hq, dh), randn(bt_, st_, hq, dh)
    kb, vb = randn(bt_, st_, hkv, dh), randn(bt_, st_, hkv, dh)
    ob, lseb = flash_attention_fwd(qb, kb, vb)
    ob_ref, lseb_ref = flash_attention_ref(qb, kb, vb)
    check("flash_attention_fwd lse (training)", lseb, lseb_ref, dict(atol=1e-3, rtol=0.0))
    qt, kt, vt = (a.transpose(1, 2) for a in (qb, kb, vb))
    pairs = bt_ * hq * st_ * (st_ + 1) // 2      # live (query, key) pairs
    record_kernel(rows, "flash_attention_fwd (training)",
                  "src/repro_torch/kernels/flash_attention/flash_attention.cu",
                  "src/repro/kernels/flash_attention/flash_attention.py:123", ob, ob_ref,
                  FLASH_FWD_TOL, cuda_ms(lambda: flash_attention_fwd(qb, kb, vb), iters=10),
                  cuda_ms(lambda: flash_attention_ref(qb, kb, vb), iters=3, warmup=1),
                  (2 * qb.numel() + 2 * kb.numel()) * bs + bt_ * hq * st_ * 4,
                  4 * dh * pairs, BF16_FLOPS_S,
                  cuda_ms(lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, is_causal=True, enable_gqa=True), iters=10),
                  branch=FLASH_BRANCHES[qb.dtype])
    flips = (ob != ob_ref).double().mean().item()
    print(f"kernel flash_attention_fwd (training): {flips:.4%} of the bf16 outputs "
          f"round to another value than the plain version's", flush=True)
    del ob_ref, lseb_ref
    delta = (dob.float() * ob.float()).sum(-1).transpose(1, 2).contiguous()
    bwd_args = (qb, kb, vb, dob, lseb, delta)
    got = torch.cat([t.flatten() for t in flash_attention_bwd(*bwd_args)])
    want = torch.cat([t.flatten() for t in flash_attention_bwd_ref(*bwd_args)])
    torch.cuda.synchronize()
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_() for a in (qb, kb, vb))
    dot = dob.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    # the function's five products (s, dp, dq, dk, dv) of 2 * D flops per
    # live (query, key) pair
    row_bytes = 2 * bt_ * hq * st_ * 4                 # lse, delta
    record_kernel(rows, "flash_attention_bwd",
                  "src/repro_torch/kernels/flash_attention/flash_attention_bwd.cu",
                  "src/repro/kernels/flash_attention/flash_attention.py:306", got, want,
                  BWD_TOL, cuda_ms(lambda: flash_attention_bwd(*bwd_args), iters=20, warmup=2),
                  cuda_ms(lambda: flash_attention_bwd_ref(*bwd_args), iters=5, warmup=1),
                  (2 * qb.numel() + 2 * kb.numel()) * bs + row_bytes
                  + (qb.numel() + 2 * kb.numel()) * 4,
                  10 * dh * pairs, BF16_FLOPS_S,
                  cuda_ms(sdpa_fwd_bwd, iters=20, warmup=2) - cuda_ms(sdpa, iters=20, warmup=2),
                  branch=FLASH_BRANCHES[qb.dtype])
    del qb, dob, kb, vb, ob, lseb, delta, bwd_args, got, want, qt, kt, vt, dot

    # decode at the serving path's positions
    qd, kv_view, vv_view, kp, vp, bt, pos = decode_case(gen, hkv, g, dh)
    live = int((pos + 1).sum())
    got, want = flash_decode(qd, kv_view, vv_view, pos), flash_decode_ref(
        qd, kv_view, vv_view, pos)
    torch.cuda.synchronize()
    mask = (torch.arange(ATTEND, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
    q4 = qd.reshape(b, 1, hq, dh).transpose(1, 2)
    dec_bytes = (2 * qd.numel() + 2 * live * hkv * dh) * bs
    dec_flops = 4 * dh * hq * live
    # the decode rows' times are the card's: the calls queued (DECODE_ITERS)
    sdpa_ms = queued_ms(lambda: F.scaled_dot_product_attention(
        q4, kv_view.transpose(1, 2), vv_view.transpose(1, 2), attn_mask=mask,
        enable_gqa=True))
    record("flash_decode", "src/repro_torch/kernels/decode_attention/decode_attention.cu",
           "src/repro/kernels/decode_attention/decode_attention.py:108", got, want,
           queued_ms(lambda: flash_decode(qd, kv_view, vv_view, pos)),
           queued_ms(lambda: flash_decode_ref(qd, kv_view, vv_view, pos)),
           dec_bytes, dec_flops, BF16_FLOPS_S, sdpa_ms)
    sdpa_factor("flash_decode", rows["flash_decode"]["ms"], sdpa_ms)

    # paged decode: the same positions through shuffled 16-token pages
    got = paged_flash_decode(qd, kp, vp, bt, pos)
    want = paged_flash_decode_ref(qd, kp, vp, bt, pos)
    torch.cuda.synchronize()
    tables = int((pos // PAGE_SIZE + 1).sum()) * 4
    record("paged_flash_decode",
           "src/repro_torch/kernels/decode_attention/decode_attention.cu",
           "src/repro/kernels/decode_attention/decode_attention.py:189", got, want,
           queued_ms(lambda: paged_flash_decode(qd, kp, vp, bt, pos)),
           queued_ms(lambda: paged_flash_decode_ref(qd, kp, vp, bt, pos)),
           dec_bytes + tables, dec_flops, BF16_FLOPS_S, None)
    sdpa_factor("paged_flash_decode", rows["paged_flash_decode"]["ms"], sdpa_ms)

    # paged verify: a spec_k = 4 window at the same positions, T*G = 24
    # query rows per KV head; keys up to pos + T - 1.  No single PyTorch
    # call reads paged K/V, so no library time; SDPA on the dense view of
    # the same slots with the window's causal mask is printed for scale.
    t_w = SPEC_K
    qv = randn(b, hkv, t_w * g, dh)
    got = paged_flash_verify(qv, kp, vp, bt, pos, t_window=t_w)
    want = paged_verify_attention_ref(qv, kp, vp, bt, pos, t_w)
    torch.cuda.synchronize()
    keys = pos.long() + t_w                            # keys read per row
    ver_bytes = ((2 * qv.numel() + 2 * int(keys.sum()) * hkv * dh) * bs
                 + int(((keys - 1) // PAGE_SIZE + 1).sum()) * 4)
    # row t of the window scores pos + t + 1 keys, for each of hq heads
    ver_flops = 4 * dh * hq * sum(int(p) + t + 1 for p in pos.tolist()
                                  for t in range(t_w))
    record("paged_flash_verify",
           "src/repro_torch/kernels/verify_attention/verify_attention.cu",
           "src/repro/kernels/verify_attention/verify_attention.py:118", got, want,
           queued_ms(lambda: paged_flash_verify(qv, kp, vp, bt, pos, t_window=t_w)),
           queued_ms(lambda: paged_verify_attention_ref(qv, kp, vp, bt, pos, t_w)),
           ver_bytes, ver_flops, BF16_FLOPS_S, None)
    qs = qv.reshape(b, hkv, t_w, g, dh).transpose(2, 3).reshape(b, hq, t_w, dh)
    win_mask = (torch.arange(ATTEND, device=dev)[None, None, :]
                <= (pos[:, None] + torch.arange(t_w, device=dev)[None, :])[:, :, None])
    win_mask = win_mask[:, None].expand(b, hq, t_w, ATTEND)
    verify_sdpa_ms = queued_ms(lambda: F.scaled_dot_product_attention(
        qs, kv_view.transpose(1, 2), vv_view.transpose(1, 2), attn_mask=win_mask,
        enable_gqa=True))
    sdpa_factor("paged_flash_verify", rows["paged_flash_verify"]["ms"], verify_sdpa_ms)
    n_keys_max = bt.shape[1] * PAGE_SIZE
    print(f"kernel paged_flash_verify: library_ms none (no single PyTorch call "
          f"reads paged K/V); splits {verify_splits(b, hkv, t_w * g, t_w, n_keys_max)} "
          f"at T={t_w}, {verify_splits(b, hkv, g, 1, n_keys_max)} at T=1 (paged decode's "
          f"{decode_splits(b, hkv, n_keys_max)})", flush=True)

    # T = 1 verify is one-token paged decode: the two kernels in f32
    q1 = torch.randn(b, hkv, g, dh, generator=gen, device=dev)
    kpf, vpf = kp.float(), vp.float()
    t1 = paged_flash_verify(q1, kpf, vpf, bt, pos, t_window=1)
    d1 = paged_flash_decode(q1, kpf, vpf, bt, pos)
    torch.cuda.synchronize()
    t1_err = max_err(t1, d1)
    print(f"kernel paged_flash_verify T=1 vs paged_flash_decode (f32): "
          f"max_abs_err={t1_err:.3e} tol={T1_TOL} bit for bit: {torch.equal(t1, d1)}",
          flush=True)
    if not t1_err <= T1_TOL:
        fail(f"T = 1 verify differs from paged decode by {t1_err:.3e}")
    int8 = check_int8_kernels(rows, qd, qv, q1, kp, vp, bt, pos)
    return rows, t1_err, int8


def check_int8_kernels(rows, qd, qv, q1, kp, vp, bt, pos) -> dict:
    """The int8 branches of the two paged kernels at the serving shapes
    (the same positions, tables and query rows as the bf16 rows): the
    pages quantized on the card, whose bytes must equal the CPU's for the
    same f32 rows; each kernel against its plain version (bf16 q within
    KERNEL_TOL, f32 q within INT8_F32_TOL) and against the float kernel
    on the dequantized pages."""
    from repro_torch.kernels.decode_attention.ops import paged_flash_decode
    from repro_torch.kernels.decode_attention.ref import paged_flash_decode_ref
    from repro_torch.kernels.verify_attention.ops import paged_flash_verify
    from repro_torch.kernels.verify_attention.ref import paged_verify_attention_ref
    from repro_torch.serve.kv_cache import dequantize_kv, quantize_kv_rows

    kq, ks = quantize_kv_rows(kp.float())
    vq, vs = quantize_kv_rows(vp.float())
    torch.cuda.synchronize()

    def bits(t):     # scales compared by their bit patterns
        return t.cpu().view(torch.int32) if t.dtype == torch.float32 else t.cpu()

    cpu = (*quantize_kv_rows(kp.float().cpu()), *quantize_kv_rows(vp.float().cpu()))
    same = all(torch.equal(bits(a), bits(b)) for a, b in zip((kq, ks, vq, vs), cpu))
    print(f"kernel int8 pages: {kq.shape[0]} pages quantized on the card store the "
          f"CPU's bytes: {same}", flush=True)
    if not same:
        fail("int8 pages quantized on the card differ from the CPU's bytes")
    sc = dict(k_scales=ks, v_scales=vs)
    kf, vf = dequantize_kv(kq, ks), dequantize_kv(vq, vs)
    hkv, dh = kp.shape[2], kp.shape[3]
    t_w = qv.shape[2] // qd.shape[2]
    live = int((pos + 1).sum())
    keys = pos.long() + t_w
    bs = 2

    def kv_bytes(n_rows, n_blocks):
        # int8 values, one f32 scale per row, for K and V; the table entries
        return 2 * n_rows * (hkv * dh + 4) + n_blocks * 4

    out = {}
    for name, fn, ref, q, extra, n_bytes, flops, replaces in (
            ("paged_flash_decode[int8]", paged_flash_decode, paged_flash_decode_ref,
             qd, {}, 2 * qd.numel() * bs + kv_bytes(live, int((pos // PAGE_SIZE + 1).sum())),
             4 * dh * qd.shape[1] * qd.shape[2] * live,
             "src/repro/kernels/decode_attention/decode_attention.py:189"),
            ("paged_flash_verify[int8]", paged_flash_verify, paged_verify_attention_ref,
             qv, {"t_window": t_w},
             2 * qv.numel() * bs + kv_bytes(int(keys.sum()),
                                            int(((keys - 1) // PAGE_SIZE + 1).sum())),
             4 * dh * qd.shape[1] * qd.shape[2] * sum(int(p) + t + 1 for p in pos.tolist()
                                                      for t in range(t_w)),
             "src/repro/kernels/verify_attention/verify_attention.py:118")):
        got = fn(q, kq, vq, bt, pos, **extra, **sc)
        want = ref(q, kq, vq, bt, pos, **extra, **sc)
        source = ("src/repro_torch/kernels/decode_attention/decode_attention.cu"
                  if "decode" in name else
                  "src/repro_torch/kernels/verify_attention/verify_attention.cu")
        # the calls queued (the card's time)
        record_kernel(rows, name, source, replaces, got, want, KERNEL_TOL,
                      queued_ms(lambda: fn(q, kq, vq, bt, pos, **extra, **sc)),
                      queued_ms(lambda: ref(q, kq, vq, bt, pos, **extra, **sc)),
                      n_bytes, flops, BF16_FLOPS_S, None)
        print(f"kernel {name}: library_ms none (no PyTorch call reads int8 paged "
              f"K/V)", flush=True)
        # f32 q: the same arithmetic as the plain version's dequantized f32
        qf = q1 if "decode" in name else qv.float()
        checks = {
            "f32 q vs plain": (fn(qf, kq, vq, bt, pos, **extra, **sc),
                               ref(qf, kq, vq, bt, pos, **extra, **sc), INT8_F32_TOL),
            "f32 q vs the f32 kernel on the dequantized pages": (
                fn(qf, kq, vq, bt, pos, **extra, **sc),
                fn(qf, kf, vf, bt, pos, **extra), INT8_F32_TOL),
            "bf16 q vs the bf16 kernel on the dequantized pages": (
                got, fn(q, kf.to(q.dtype), vf.to(q.dtype), bt, pos, **extra),
                KERNEL_TOL)}
        out[name] = {}
        for label, (a, b, tol) in checks.items():
            torch.cuda.synchronize()
            err = max_err(a, b)
            print(f"kernel {name} {label}: max_abs_err={err:.3e} tol={tol}", flush=True)
            if not agrees(a, b, tol):
                fail(f"{name} ({label}) disagrees beyond {tol}")
            out[name][label] = err
    return out


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

    # matmul: 2048^3 in f32 (3xTF32 on the tensor cores) against cuBLAS in
    # full f32.  An f32-accurate product has two ways through the card, 2MNK
    # on the f32 CUDA cores or three TF32 products on the tensor cores: the
    # row's bound is the smaller of the two, and both are printed
    torch.backends.cuda.matmul.allow_tf32 = False
    d = 2048
    a, b = (torch.randn(d, d, generator=gen, device=dev) for _ in "ab")
    mm_bytes, mm_flops = 3 * d * d * 4, 2 * d ** 3
    ways = {"f32 CUDA cores": (mm_flops, F32_FLOPS_S),
            "3xTF32 tensor cores": (3 * mm_flops, TF32_FLOPS_S)}
    bounds = {way: bound(mm_bytes, *fp)[0] for way, fp in ways.items()}
    way = min(bounds, key=bounds.get)
    print("kernel matmul: bound candidates " + "; ".join(
        f"{w} {ms:.4f} ms" for w, ms in bounds.items()) + f"; the row takes {way}",
        flush=True)
    record_kernel(rows, "matmul", "src/repro_torch/kernels/matmul/matmul.cu",
                  "src/repro/kernels/matmul/matmul.py:39",
                  matmul(a, b), matmul_ref(a, b), MATMUL_TOL,
                  cuda_ms(lambda: matmul(a, b)), cuda_ms(lambda: matmul_ref(a, b)),
                  mm_bytes, *ways[way], cuda_ms(lambda: torch.matmul(a, b)))
    MATMUL_READINGS["f32 bound candidates ms"] = bounds

    # the bf16 branch at 2048^3 beside torch.matmul in bf16 (Fig. 5 runs
    # f32 only, so this branch has no row of its own)
    ah, bh = a.to(torch.bfloat16), b.to(torch.bfloat16)
    got, want = matmul(ah, bh), matmul_ref(ah, bh)
    check("matmul bf16 2048^3", got, want, KERNEL_TOL)
    r = dict(max_abs_err=max_err(got, want), ms=cuda_ms(lambda: matmul(ah, bh)),
             plain_ms=cuda_ms(lambda: matmul_ref(ah, bh)),
             bound_ms=bound(3 * d * d * 2, mm_flops, BF16_FLOPS_S)[0],
             library_ms=cuda_ms(lambda: torch.matmul(ah, bh)))
    print(f"kernel matmul bf16 2048^3: max_abs_err={r['max_abs_err']:.3e} tol={KERNEL_TOL} "
          f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
          f"(operations) library_ms={r['library_ms']:.4f}", flush=True)
    MATMUL_READINGS["bf16 2048^3"] = r
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
    no_ragged_rmsnorm("a serving run", counts)
    for u, _, n in spec:
        s = eng.last_stats[u]
        if s["status"] != "ok" or s["tokens"] != n or len(out.get(u, [])) != n:
            fail(f"request {u}: status {s['status']}, {s.get('tokens')} of {n} tokens")
    n_tok = sum(len(v) for v in out.values())
    return out, eng, counts, wall, n_tok


def no_ragged_rmsnorm(label: str, counts: dict):
    """Every serving, MoE and training run normalizes whole 16-byte rows:
    rmsnorm's block-per-row ragged branch must not have launched."""
    if counts["rmsnorm[ragged]"]:
        fail(f"{label} launched rmsnorm's ragged branch "
             f"{counts['rmsnorm[ragged]']} times")


def add_counts(a: dict, b: dict) -> dict:
    return {n: a[n] + b[n] for n in a}


F32_FLASH = ("flash_attention_fwd[f32]", "flash_attention_bwd[f32]")
BF16_FLASH = ("flash_attention_fwd", "flash_attention_bwd")


def flash_branch_launches(bf16_runs: dict, fp32_runs: dict):
    """The flash kernels' dtype branches apart: the bf16 runs (whose counts
    fill the kernel rows) must launch no f32 flash kernel, and the fp32
    controls no bf16 one.  Prints the controls' f32 launches."""
    for label, c in bf16_runs.items():
        if any(c[n] for n in F32_FLASH):
            fail(f"{label} (bf16) launched the flash kernels' f32 branch: "
                 f"{ {n: c[n] for n in F32_FLASH} }")
    for label, c in fp32_runs.items():
        if any(c[n] for n in BF16_FLASH) or not c[F32_FLASH[0]]:
            fail(f"{label} launched the flash kernels' bf16 branch or no f32 "
                 f"forward: { {n: c[n] for n in BF16_FLASH + F32_FLASH} }")
    f32 = {label: c[F32_FLASH[0]] for label, c in fp32_runs.items()}
    print(f"flash_attention_fwd[f32] (CUDA cores) launches in the fp32 controls, "
          f"kept out of the bf16 kernel rows: {f32}; total {sum(f32.values())}",
          flush=True)


def layout_agreement(label, dense, paged, eng):
    """Token agreement of a paged run with the dense run: overall, per
    request, and which requests the paged run preempted; prints the line."""
    agree = float(np.mean([a == b for u in dense for a, b in zip(dense[u], paged[u])]))
    per_req = {u: float(np.mean([a == b for a, b in zip(dense[u], paged[u])]))
               for u in dense}
    preempted = [u for u in dense if eng.last_stats[u]["preemptions"]]
    print(f"{label}: {agree:.4f}; per request {per_req}; preempted {preempted}",
          flush=True)
    return agree, per_req, preempted


def prefilled(model, params, prompt, layout="dense", kv_dtype=None):
    """One request's prompt prefilled, batch 1: (logits, cache), the dense
    cache or a paged pool (of ``kv_dtype``) whose block table maps the
    logical blocks to pages 1, 2, ... in order."""
    from repro_torch.serve.kv_cache import scatter_prefill

    toks = torch.tensor([prompt], device="cuda")
    if layout == "dense":
        return model.prefill(params, toks, MAX_SEQ)
    cache = model.init_cache(1, MAX_SEQ, layout="paged", page_size=PAGE_SIZE,
                             kv_dtype=kv_dtype)
    nb = cache["block_tables"].shape[1]
    cache["block_tables"][0] = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")
    logits, pcache = model.prefill(params, toks, len(prompt))
    scatter_prefill(cache, pcache, cache["block_tables"][:, :-(-len(prompt) // PAGE_SIZE)])
    return logits, cache


def teacher_force(model, params, prompt, tokens, kv_dtype=None):
    """Logits of ``model`` for one request (prefill, then decode on the
    served ``tokens``), batch 1: one row per generated position.  With
    ``kv_dtype`` the decode steps read a paged pool of that dtype."""
    logits, cache = prefilled(model, params, prompt,
                              "dense" if kv_dtype is None else "paged", kv_dtype)
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


# ---------------------------------------------------------------------------
# phase 3: speculative serving through the verify kernel
# ---------------------------------------------------------------------------

def _scaled(tree, factor: float):
    if isinstance(tree, dict):
        return {k: _scaled(v, factor) for k, v in tree.items()}
    return tree * factor


def preempting_pool(spec) -> int:
    """Pages for the first SLOTS prompts plus one growth page for all but
    one slot (and the trash page): the batch cannot grow without
    preempting."""
    first = sum(-(-len(p) // PAGE_SIZE) for _, p, _ in spec[:SLOTS])
    return first + SLOTS - 1 + 1


def spec_report(label, spec, out, eng, counts, wall, n_tok):
    """Print a speculative run's line and check what every one must show:
    the verify kernel launched and the pool drained.  Returns its record."""
    acc = [eng.last_stats[u]["accept_rate"] for u, _, _ in spec]
    disables = sum(eng.last_stats[u].get("spec_auto_disables", 0) for u, _, _ in spec)
    pool = eng.last_pool_stats
    print(f"spec {label}: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s; "
          f"accept_rate per request {[round(a, 3) for a in acc]} mean "
          f"{np.mean(acc):.3f}; auto-disables {disables}; preemptions "
          f"{eng.preemptions}; pool {pool}; launches {counts}", flush=True)
    if counts["paged_flash_verify"] == 0:
        fail(f"paged_flash_verify never launched in the spec {label} run")
    if counts["flash_decode"] == 0:
        fail(f"the draft's flash_decode never launched in the spec {label} run")
    if pool.used_pages != 0:
        fail(f"spec {label} run leaked {pool.used_pages} pages")
    return dict(tok_s=n_tok / wall, wall_s=wall, tokens=n_tok, accept_rate=acc,
                mean_accept_rate=float(np.mean(acc)), auto_disables=disables,
                preemptions=eng.preemptions, retracts=pool.retracts,
                counts=counts)


def verify_force(model, params, prompt, tokens, n_win, kv_dtype=None):
    """Logits of ``model`` for one request's served ``tokens`` taken in
    windows of SPEC_K through ``decode_verify_step`` on a paged cache of
    ``kv_dtype`` (batch 1): row i predicts tokens[i + 1], n_win * SPEC_K
    rows."""
    _, cache = prefilled(model, params, prompt, "paged", kv_dtype)
    rows = []
    for w in range(n_win):
        p0 = len(prompt) + SPEC_K * w
        win = torch.tensor([tokens[SPEC_K * w:SPEC_K * (w + 1)]], device="cuda")
        attend = min(MAX_SEQ, -(-(p0 + SPEC_K) // 64) * 64)
        logits, _ = model.decode_verify_step(
            params, cache, win, torch.tensor([p0], dtype=torch.int32, device="cuda"),
            attend)
        rows.append(logits[0])
    return torch.cat(rows)


def run_spec(cfg, model, params, spec, paged_tok_s):
    """The speculative phase: (a) self:14 on the random weights with a
    preempting pool, (b) damped weights with self:1 beside non-speculative
    paged serving, (c) teacher-forced verify windows.  Returns the record
    and the verify kernel's launches in (a) and (b)."""
    from repro_torch.models.lm import Model

    paged = dict(cache_layout="paged", page_size=PAGE_SIZE)
    num_pages = preempting_pool(spec)
    out, eng, counts, wall, n_tok = serve(model, params, spec, num_pages=num_pages,
                                          spec_k=SPEC_K, draft="self:14", **paged)
    a = spec_report("a self:14", spec, out, eng, counts, wall, n_tok)
    print(f"spec a: pool {num_pages} pages; non-spec paged {paged_tok_s:.1f} tok/s",
          flush=True)
    if eng.preemptions < 1:
        fail("the spec (a) run was sized to preempt and did not")
    launches = counts["paged_flash_verify"]

    damped = dict(params, layers=_scaled(params["layers"], 0.05))
    base, _, _, b_wall, b_tok = serve(model, damped, spec, **paged)
    print(f"spec b non-spec paged (damped weights): {b_tok} tokens in "
          f"{b_wall:.3f} s = {b_tok / b_wall:.1f} tok/s", flush=True)
    d_out, d_eng, d_counts, d_wall, d_tok = serve(model, damped, spec, spec_k=SPEC_K,
                                                  draft="self:1", **paged)
    b = spec_report("b damped self:1", spec, d_out, d_eng, d_counts, d_wall, d_tok)
    agree = np.mean([x == y for u in base for x, y in zip(base[u], d_out[u])])
    b.update(nonspec_tok_s=b_tok / b_wall, token_agreement=float(agree),
             speedup=b["tok_s"] / (b_tok / b_wall))
    print(f"spec b: spec vs non-spec token agreement {agree:.4f}; tok/s ratio "
          f"{b['speedup']:.3f}", flush=True)
    launches += d_counts["paged_flash_verify"]
    del damped

    # (c) request 0's served tokens, windows of SPEC_K, kernel and plain path
    uid, prompt, _ = spec[0]
    toks = out[uid]
    n_win = (len(toks) - 1) // SPEC_K
    dec = teacher_force(model, params, prompt, toks)[1:1 + n_win * SPEC_K]
    plain = Model(cfg, device="cuda", dtype=torch.bfloat16, use_kernels=False)
    c = {}
    for label, m in (("kernel", model), ("plain", plain)):
        v = verify_force(m, params, prompt, toks, n_win)
        err, scale, agree = compare_logits(
            f"uid {uid} verify windows ({label} path) vs decode steps", v, dec)
        served = (v.argmax(-1) == torch.tensor(toks[1:1 + n_win * SPEC_K],
                                               device="cuda")).float().mean().item()
        print(f"spec c {label}: argmax agreement with decode steps {agree:.4f}, "
              f"with served tokens {served:.4f}", flush=True)
        c[label] = dict(max_err=err, logit_scale=scale, argmax_agreement=agree,
                        served_agreement=served, rows=n_win * SPEC_K)
    return dict(a=a, b=b, c=c, num_pages=num_pages), launches


# ---------------------------------------------------------------------------
# phase 3a: ROADMAP C1, dense vs the preempting pool in fp32 compute
# ---------------------------------------------------------------------------

def fp32_model(cfg, params):
    """The serving model in fp32 compute with the bf16 weights widened
    (the same values; 6.2 GB at full width)."""
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import tree_map

    return (Model(cfg, device="cuda", dtype=torch.float32),
            tree_map(lambda t: t.float(), params))


def prefill_rows(model, params, spec, out, groups, uid):
    """The K/V rows of request ``uid``'s prompt as the last prefill call
    of a run that held it computed them: that call's group prefilled
    again, at its batch and bucket (``groups`` is the run's
    ``last_prefill_groups``; a resumed member's folded prompt is rebuilt
    from the run's tokens ``out``).  Returns (k, v), (L, n, Hkv, D)."""
    prompts = {u: p for u, p, _ in spec}
    uids, bucket, lens = [g for g in groups if uid in g[0]][-1]
    toks = torch.zeros(len(uids), bucket, dtype=torch.long, device="cuda")
    for i, (m, n) in enumerate(zip(uids, lens)):
        toks[i, :n] = torch.tensor(prompts[m] + out[m][:n - len(prompts[m])])
    last = torch.tensor([n - 1 for n in lens], device="cuda")
    _, cache = model.prefill(params, toks, bucket, last)
    i, n0 = uids.index(uid), len(prompts[uid])
    return cache["k"][:, i, :n0], cache["v"][:, i, :n0]


def stored_difference(model, params, spec, run_x, run_y, uid, quantized) -> dict:
    """How request ``uid``'s prompt rows differ between two runs' prefill
    calls (``run_*`` = (tokens, prefill groups)): float elements whose
    bits differ, and with ``quantized`` the int8 values and row scales
    that the pool then stores otherwise."""
    from repro_torch.serve.kv_cache import quantize_kv_rows

    rec = {}
    for name, a, b in zip("kv", prefill_rows(model, params, spec, *run_x, uid),
                          prefill_rows(model, params, spec, *run_y, uid)):
        rec[f"{name}_float_elements"] = int((a != b).sum())
        rec[f"{name}_max_abs"] = (a.float() - b.float()).abs().max().item()
        if quantized:
            (qa, sa), (qb, sb) = quantize_kv_rows(a), quantize_kv_rows(b)
            rec[f"{name}_int8_values"] = int((qa != qb).sum())
            rec[f"{name}_scales"] = int((sa != sb).sum())
    rec["elements"] = int(a.numel())
    return rec


def c1_control(cfg, model, params, spec, num_pages, dense, paged, dense_groups,
               paged_groups) -> dict:
    """ROADMAP C1.  Each bf16 request that the paged run served otherwise
    than dense is probed: its prompt rows as the two runs' prefill calls
    computed them (reported).  Then dense against the preempting paged
    pool at full width in fp32 compute, each run's prefill groups logged:
    a request that is never preempted can prefill in another
    right-padded group at another bucket after a preemption, and round
    otherwise in bf16; in fp32 the two layouts must serve the same
    tokens, or paged admission or decode is at fault."""
    probes = {u: stored_difference(model, params, spec, (dense, dense_groups),
                                   (paged, paged_groups), u, False)
              for u in dense if dense[u] != paged[u]}
    print(f"C1 bf16 probe, prompt rows of the requests dense and paged served "
          f"otherwise, as the two runs' prefill calls computed them: {probes}",
          flush=True)
    model32, params32 = fp32_model(cfg, params)
    dense, d_eng, d_counts, _, _ = serve(model32, params32, spec)
    paged, p_eng, p_counts, _, _ = serve(model32, params32, spec, cache_layout="paged",
                                         page_size=PAGE_SIZE, num_pages=num_pages)
    print(f"C1 control fp32 prefill groups (uids, bucket, lengths): dense "
          f"{d_eng.last_prefill_groups}; paged {p_eng.last_prefill_groups}", flush=True)
    agree, per_req, preempted = layout_agreement(
        "C1 control fp32: dense vs preempting paged", dense, paged, p_eng)
    if not preempted:
        fail("the C1 control was sized to preempt and did not")
    if agree < 1.0:
        fail("in fp32 the preempting paged pool served other tokens than dense: "
             "a port fault in paged admission or decode (ROADMAP C1)")
    return dict(agreement=agree, per_request=per_req, preempted=preempted,
                dense_groups=d_eng.last_prefill_groups,
                paged_groups=p_eng.last_prefill_groups, bf16_probes=probes,
                launches=add_counts(d_counts, p_counts))


# ---------------------------------------------------------------------------
# phase 3c: tiered KV memory, int8 pages and host swap
# ---------------------------------------------------------------------------

def agreement(a, b) -> float:
    return float(np.mean([x == y for u in a for x, y in zip(a[u], b[u])]))


def swap_copy_ms(model, n_blocks: int, n: int = 5):
    """Host-clock ms of one swap-out (gather to a device tensor, then a
    synchronous copy into pinned host memory) and one swap-in (host to the
    pool, then a synchronize) of ``n_blocks`` int8 pages, means of ``n``
    after a warm-up; and the bytes moved each way."""
    from repro_torch.serve.kv_cache import swap_in_pages, swap_out_pages

    pool = model.init_cache(SLOTS, MAX_SEQ, layout="paged", page_size=PAGE_SIZE,
                            kv_dtype="int8")
    pool.pop("block_tables")
    src, dst = list(range(1, n_blocks + 1)), list(range(n_blocks + 1, 2 * n_blocks + 1))
    swap_in_pages(pool, swap_out_pages(pool, src), dst)
    torch.cuda.synchronize()
    t_out = t_in = 0.0
    for _ in range(n):
        t0 = time.perf_counter()
        host = swap_out_pages(pool, src)
        t1 = time.perf_counter()
        swap_in_pages(pool, host, dst)
        torch.cuda.synchronize()
        t_out, t_in = t_out + t1 - t0, t_in + time.perf_counter() - t1
    nbytes = sum(t.numel() * t.element_size() for t in host.values())
    return t_out * 1e3 / n, t_in * 1e3 / n, nbytes


def run_tiered(cfg, model, params, spec, dense, paged, paged_tok_s, num_pages,
               bf16_preemptions):
    """Greedy serving on int8 pools: (a) the preempting pool under requeue
    and swap, (b) an int8 pool of the bf16 preempting pool's bytes, (c) an
    ample one, (d) spec_k = 4 with the damped self:1 draft on the
    preempting pool, swapping; the verify windows on an int8 pool
    teacher-forced against int8 decode steps; and the fp32 control, whose
    swap, requeue and ample runs must serve the same tokens.  Returns the
    record (the fp32 control's launch counts in it) and the launch counts
    summed over the bf16 runs."""
    from repro_torch.models.lm import Model

    int8 = dict(cache_layout="paged", page_size=PAGE_SIZE, kv_dtype="int8")
    runs, counts, control_counts = {}, {}, {}

    def run(label, m, p, **kw):
        out, eng, c, wall, n_tok = serve(m, p, spec, **int8, **kw)
        pool = eng.last_pool_stats
        print(f"tiered {label}: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} "
              f"tok/s; pool {eng.num_pages} pages; preemptions {eng.preemptions}; "
              f"swap_outs {pool.swap_outs} swap_ins {pool.swap_ins}; swapped out "
              f"{pool.swapped_out_bytes} B, in {pool.swapped_in_bytes} B; prefill "
              f"groups {eng.last_prefill_groups}; launches "
              f"{ {k: v for k, v in c.items() if v} }", flush=True)
        if pool.used_pages != 0:
            fail(f"the tiered {label} run leaked {pool.used_pages} pages")
        into = control_counts if label.startswith("fp32 control") else counts
        for k, v in c.items():
            into[k] = into.get(k, 0) + v
        runs[label] = dict(tok_s=n_tok / wall, wall_s=wall, tokens=n_tok,
                           num_pages=eng.num_pages, preemptions=eng.preemptions,
                           swap_outs=pool.swap_outs, swap_ins=pool.swap_ins,
                           swapped_out_bytes=pool.swapped_out_bytes,
                           swapped_in_bytes=pool.swapped_in_bytes,
                           prefill_groups=eng.last_prefill_groups)
        return out, eng

    # (a) the bf16 run's preempting pool, stored int8
    requeue, r_eng = run("a requeue", model, params, num_pages=num_pages)
    swap, s_eng = run("a swap", model, params, num_pages=num_pages, preempt="swap")
    if r_eng.preemptions < 1 or s_eng.preemptions < 1:
        fail("the tiered (a) runs were sized to preempt and did not")
    sp = s_eng.last_pool_stats
    if sp.swap_outs < 1 or sp.swap_ins < 1:
        fail(f"the swap run swapped out {sp.swap_outs} and in {sp.swap_ins} times")
    hkv, dh, L = cfg.n_kv_heads, cfg.d_head, cfg.n_layers
    int8_page = 2 * L * PAGE_SIZE * (hkv * dh + 4)          # values + row scales
    bf16_page = 2 * L * PAGE_SIZE * hkv * dh * 2
    blocks = max(1, round(sp.swapped_out_bytes / sp.swap_outs / int8_page))
    out_ms, in_ms, moved = swap_copy_ms(model, blocks)
    print(f"tiered a: tok/s int8 requeue {runs['a requeue']['tok_s']:.1f}, int8 swap "
          f"{runs['a swap']['tok_s']:.1f}, bf16 paged (requeue) {paged_tok_s:.1f}; "
          f"swap copy of {blocks} pages ({moved} B): out {out_ms:.3f} ms "
          f"({moved / out_ms / 1e6:.2f} GB/s), in {in_ms:.3f} ms "
          f"({moved / in_ms / 1e6:.2f} GB/s)", flush=True)

    # (b) the capacity half of the trade: the bf16 pool's bytes, int8 pages
    same_pages = (num_pages * bf16_page) // int8_page
    _, e_eng = run("b equal bytes", model, params, num_pages=same_pages)
    print(f"tiered b: {int8_page} B a page int8 against {bf16_page} B bf16 "
          f"({int8_page / PAGE_SIZE:.0f} against {bf16_page / PAGE_SIZE:.0f} B a token); "
          f"{same_pages} int8 pages in the bytes of {num_pages} bf16 pages; "
          f"preemptions int8 {e_eng.preemptions}, bf16 {bf16_preemptions}", flush=True)

    # (c) a pool that never preempts
    ample, a_eng = run("c ample", model, params)
    if a_eng.preemptions:
        fail("the ample int8 pool preempted")

    # (d) speculation on the preempting int8 pool, swapping
    damped = dict(params, layers=_scaled(params["layers"], 0.05))
    _, d_eng = run("d spec_k=4 damped self:1 swap", model, damped, num_pages=num_pages,
                   preempt="swap", spec_k=SPEC_K, draft="self:1")
    acc = [d_eng.last_stats[u]["accept_rate"] for u, _, _ in spec]
    runs["d spec_k=4 damped self:1 swap"]["mean_accept_rate"] = float(np.mean(acc))
    print(f"tiered d: accept_rate mean {np.mean(acc):.3f}", flush=True)
    del damped

    for name in ("paged_flash_decode[int8]", "paged_flash_verify[int8]"):
        if counts.get(name, 0) == 0:
            fail(f"{name} never launched while serving on int8 pools")
    if counts["paged_flash_decode"] or counts["paged_flash_verify"]:
        fail("a float paged kernel launched while serving on int8 pools")

    # reported, not gated: bf16 rounds otherwise at another prefill bucket,
    # and int8 stores other values than bf16 (the reference's own int8 ==
    # dense test fails)
    reports = {"swap vs requeue": agreement(requeue, swap),
               "ample vs requeue": agreement(requeue, ample),
               "int8 requeue vs bf16 paged": agreement(requeue, paged),
               "int8 ample vs dense": agreement(ample, dense)}
    print(f"tiered bf16 token agreement (reported, not gated): {reports}", flush=True)

    # the verify windows over an int8 pool against int8 decode steps:
    # request 0's tokens of the requeue run, the serving weights
    uid, prompt, _ = spec[0]
    toks = requeue[uid]
    n_win = (len(toks) - 1) // SPEC_K
    dec = teacher_force(model, params, prompt, toks, kv_dtype="int8")[1:1 + n_win * SPEC_K]
    windows = {}
    for label, m in (("kernel", model), ("plain", Model(cfg, device="cuda",
                                                         dtype=torch.bfloat16,
                                                         use_kernels=False))):
        v = verify_force(m, params, prompt, toks, n_win, kv_dtype="int8")
        err, scale, agree = compare_logits(
            f"int8 uid {uid} verify windows ({label} path) vs int8 decode steps", v, dec)
        windows[label] = dict(max_err=err, logit_scale=scale, argmax_agreement=agree)

    # the fp32 control: a request stores the same bytes in the swap, the
    # requeue and the ample run, and so serves the same tokens, wherever
    # its rows were computed from the same shapes.  A request prefilled in
    # another group or bucket gets fp32 rows that may differ in their last
    # bits (cuBLAS picks its kernel by the product's shape), and one int8
    # rounding flip moves a value by a whole quantization step: such a
    # request may differ only if the probe shows its prompt stored with
    # other int8 bytes in the two runs.
    model32, params32 = fp32_model(cfg, params)
    c = {label: run(f"fp32 control {label}", model32, params32, **kw)[0]
         for label, kw in (("requeue", dict(num_pages=num_pages)),
                           ("swap", dict(num_pages=num_pages, preempt="swap")),
                           ("ample", {}))}
    control, probes = {}, {}
    for x, y in (("swap", "requeue"), ("ample", "requeue")):
        per_req = {u: float(np.mean([a == b for a, b in zip(c[x][u], c[y][u])]))
                   for u in c[y]}
        control[f"{x} vs {y}"] = dict(all=agreement(c[x], c[y]), per_request=per_req)
        for u in (u for u, a in per_req.items() if a < 1.0):
            p = stored_difference(model32, params32, spec,
                                  (c[x], runs[f"fp32 control {x}"]["prefill_groups"]),
                                  (c[y], runs[f"fp32 control {y}"]["prefill_groups"]),
                                  u, True)
            probes[f"{x} vs {y}, request {u}"] = p
            if p["k_int8_values"] + p["v_int8_values"] + p["k_scales"] + p["v_scales"] == 0:
                fail(f"in fp32 request {u} served other tokens in the int8 {x} and "
                     f"{y} runs though its prompt was stored with the same bytes")
    print(f"tiered fp32 control token agreement: {control}; probe of the requests "
          f"that differ, their prompt rows as the two runs' prefill calls computed "
          f"them: {probes}", flush=True)
    del model32, params32
    return dict(runs=runs, swap_copy=dict(blocks=blocks, bytes=moved, out_ms=out_ms,
                                          in_ms=in_ms),
                int8_page_bytes=int8_page, bf16_page_bytes=bf16_page,
                equal_bytes_pages=same_pages, bf16_preemptions=bf16_preemptions,
                agreement_bf16=reports, agreement_fp32=control, fp32_probes=probes,
                verify_windows=windows, fp32_control_launches=control_counts), counts


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
    (torch.profiler) of one full-batch decode step (dense, paged bf16 and
    paged int8), one 4 x 512 prefill,
    and the two halves of a speculative step (a 14-layer self-draft decode
    step, three per window, and one spec_k = 4 verify step over the paged
    cache) on the kernel path; their ratio is the device's busy share."""
    from repro_torch.serve.spec_decode import make_self_draft

    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device="cuda")
    tok = torch.zeros(SLOTS, dtype=torch.int32, device="cuda")
    cache = model.init_cache(SLOTS, MAX_SEQ)
    toks = torch.randint(0, model.cfg.vocab, (SLOTS, 512), generator=gen,
                         device="cuda")
    draft, dparams = make_self_draft(model, params, 14)
    dcache = draft.init_cache(SLOTS, MAX_SEQ)
    pcache = model.init_cache(SLOTS, MAX_SEQ, layout="paged", page_size=PAGE_SIZE)
    nb = pcache["block_tables"].shape[1]
    pcache["block_tables"] = torch.arange(1, SLOTS * nb + 1, dtype=torch.int32,
                                          device="cuda").reshape(SLOTS, nb)
    qcache = model.init_cache(SLOTS, MAX_SEQ, layout="paged", page_size=PAGE_SIZE,
                              kv_dtype="int8")
    qcache["block_tables"] = pcache["block_tables"]
    win = torch.zeros(SLOTS, SPEC_K, dtype=torch.int32, device="cuda")
    phases = {}
    for name, fn, n in (
            ("decode_step", lambda: model.decode_step(params, cache, tok, pos,
                                                      attend_len=MAX_SEQ), 10),
            ("paged_decode_step", lambda: model.decode_step(
                params, pcache, tok, pos, attend_len=MAX_SEQ), 10),
            ("paged_decode_step_int8", lambda: model.decode_step(
                params, qcache, tok, pos, attend_len=MAX_SEQ), 10),
            ("prefill_4x512", lambda: model.prefill(params, toks, 512), 3),
            ("draft_step_self14", lambda: draft.decode_step(
                dparams, dcache, tok, pos, attend_len=MAX_SEQ), 10),
            ("verify_step_T4", lambda: model.decode_verify_step(
                params, pcache, win, pos, attend_len=MAX_SEQ), 10)):
        phases[name] = profile_phase(name, fn, n)
    require_decode_kernels(phases, ("decode_step", "paged_decode_step",
                                    "paged_decode_step_int8", "draft_step_self14",
                                    "verify_step_T4"))
    return phases


def profile_phase(name, fn, n: int) -> dict:
    """Host wall time of ``n`` calls of ``fn`` after one warm-up call,
    ended by a synchronize, then the summed device kernel time of ``n``
    more under torch.profiler; prints the ``time`` line and returns both,
    the busy share and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

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
    decode = {k: sum(_kernel_us(e) for e in events if k in e.key) / 1e3 / n
              for k in DECODE_KERNELS}
    gating = sum(_kernel_us(e) for e in events if GATING_KERNEL in e.key) / 1e3 / n
    rec = dict(wall_ms=wall_ms, device_ms=dev_ms, decode_kernels=decode, gating_ms=gating,
               top=[(e.key[:70], _kernel_us(e) / 1e3 / n) for e in top if _kernel_us(e) > 0])
    busy = f"{dev_ms / wall_ms:.3f}" if dev_ms > 0 else "not measured"
    print(f"time {name}: wall {wall_ms:.3f} ms, device kernels {dev_ms:.3f} ms, "
          f"device busy share {busy}; decode kernels "
          + ", ".join(f"{k} {ms:.3f}" for k, ms in decode.items())
          + f"; {GATING_KERNEL} {gating:.4f}; top: "
          + "; ".join(f"{k} {ms:.3f}" for k, ms in rec["top"]), flush=True)
    return rec


def require_decode_kernels(phases: dict, names):
    """Fail unless each decode- or verify-step profile (where the profiler
    saw device time at all) holds both kernels, the split and the combine
    (the verify step's are its paged_flash_verify calls)."""
    for name in names:
        r = phases[name]
        if r["device_ms"] > 0 and not all(r["decode_kernels"][k] > 0 for k in DECODE_KERNELS):
            fail(f"the {name} profile holds no {DECODE_KERNELS} time: "
                 f"{r['decode_kernels']}")


# ---------------------------------------------------------------------------
# phase 3b: MoE serving through moe_gating
# ---------------------------------------------------------------------------

def gating_edges(e: int) -> torch.Tensor:
    """f32 router-logit rows (9, E) at the Pallas kernel's edges, each
    with the experts its rounds select at top_k >= 4 where they do not
    depend on k: all ties (the lowest ids); a NaN (nothing, NaN weights);
    all -inf (expert 0); -inf with 2, +0 and -0 above -1e30 and -1e30
    itself below and above them (those three and, exact in f32 only, the
    -1e30 below: 1, 9, 10, 12); -inf with one value and -1e30 only above
    it (3); -3e38 with -inf at id 0 (1: nothing above -1e30, the lowest
    id of the max); +inf among normals (NaN weights); +0/-0 ties behind
    two ones; all -1e30 (0)."""
    g = torch.Generator().manual_seed(e)
    x = torch.full((9, e), float("-inf"))
    x[0] = 0.0
    x[1] = torch.randn(e, generator=g) * 2
    x[1, e // 3] = float("nan")
    x[3, [1, 9, 10, 12, e - 1]] = torch.tensor([NEG_SENTINEL, 2.0, -0.0, 0.0, NEG_SENTINEL])
    x[4, [3, 5, 7]] = torch.tensor([1.0, NEG_SENTINEL, -3e38])
    x[5] = -3e38
    x[5, 0] = float("-inf")
    x[6] = torch.randn(e, generator=g) * 2
    x[6, 4] = float("inf")
    x[7, 0::2], x[7, 1::2] = 0.0, -0.0
    x[7, e - 2:] = 1.0
    x[8] = NEG_SENTINEL
    return x


# the edge rows' selections that do not depend on bf16 rounding: row ->
# the selected ids in f32 ("k": the lowest k ids) and in bf16, where
# -1e30 rounds to -1.00026e30, below the sentinel
GATING_EDGE_PICKS = {0: ("k", "k"), 1: ((), ()), 2: ((0,), (0,)),
                     3: ((1, 9, 10, 12), (9, 10, 12)), 4: ((3,), (3,)),
                     5: ((1,), (1,)), 8: ((0,), (0,))}


def gating_logits(gen: torch.Generator, t: int, e: int) -> torch.Tensor:
    """f32 router logits (t, E), N(0, 4), the edge rows first as far as t
    allows (``gating_edges``); the caller rounds them to bf16, which ties
    many more lanes."""
    x = torch.randn(t, e, generator=gen, device="cuda") * 2
    edges = gating_edges(e)[:t].cuda()
    x[:len(edges)] = edges
    return x


def gating_agreement(x: torch.Tensor, k: int) -> dict:
    """The kernel against both plain versions (the rounds and the rank
    closed form): masks equal, weights within GATING_TOL and NaN where
    they have NaN; the plain versions against each other bit for bit; and
    the edge rows' picks (GATING_EDGE_PICKS)."""
    from repro_torch.kernels.moe_gating.ops import moe_gating
    from repro_torch.kernels.moe_gating.ref import moe_gating_rank_ref, moe_gating_ref

    w, m = moe_gating(x, k)
    (wr, mr), (wq, mq) = moe_gating_ref(x, k), moe_gating_rank_ref(x, k)
    torch.cuda.synchronize()
    out = {name: torch.equal(m, mp) and torch.allclose(w, wp, equal_nan=True, **GATING_TOL)
           for name, (wp, mp) in (("rounds", (wr, mr)), ("rank", (wq, mq)))}
    out["plain_bits"] = (torch.equal(mr, mq)
                         and torch.equal(wr.nan_to_num(nan=-1.0), wq.nan_to_num(nan=-1.0)))
    picks = []
    for row, want in GATING_EDGE_PICKS.items():
        if row < x.shape[0]:
            ids = want[x.dtype == torch.bfloat16]
            ids = tuple(range(k)) if ids == "k" else ids
            picks.append(m[row].nonzero().flatten().tolist() == list(ids))
    nan_rows = [r for r in (1, 6) if r < x.shape[0]]
    out["edge_rows"] = all(picks) and bool(torch.isnan(w[nan_rows]).all())
    out["max_abs_err"] = max_err(w.nan_to_num(nan=-1.0), wr.nan_to_num(nan=-1.0))
    return out


def check_moe_gating(cfg, gen: torch.Generator) -> dict:
    """``moe_gating`` at OLMoE's decode shape (4 slots) and its prefill
    shape (512 tokens), bf16, the edge rows first: held against both plain
    versions there and on the same values in f32 (where -1e30 is exact);
    each shape timed with the calls queued (the card's time), beside an
    empty launch queued the same way, the host-paced time, the wrapper's
    host time a call, the bound and the plain time.  Returns the prefill
    shape's kernel row and the readings of both shapes."""
    from repro_torch.kernels.moe_gating.ops import moe_gating
    from repro_torch.kernels.moe_gating.ref import moe_gating_ref

    e, k = cfg.n_experts, cfg.top_k
    empty_ms = queued_ms(lambda: torch.cuda._sleep(0))
    readings, rows = {}, {}
    for shape, t in (("decode", SLOTS), ("prefill", 512)):
        xf = gating_logits(gen, t, e)
        x = xf.to(torch.bfloat16)
        agree = {dt: gating_agreement(v, k) for dt, v in (("bf16", x), ("f32", xf))}
        n = 1000
        t0 = time.perf_counter()
        for _ in range(n):
            moe_gating(x, k)
        host_ms = (time.perf_counter() - t0) * 1e3 / n
        # bytes: bf16 logits in, f32 weights and int32 mask out;
        # operations: two compares (>, ==) a rival for each expert's rank,
        # ~4 for the softmax
        r = dict(ms=queued_ms(lambda: moe_gating(x, k)),
                 host_paced_ms=cuda_ms(lambda: moe_gating(x, k)), host_ms=host_ms,
                 empty_launch_ms=empty_ms, plain_ms=cuda_ms(lambda: moe_gating_ref(x, k)),
                 agreement=agree)
        r["bound_ms"], r["bound_by"] = bound(t * e * (2 + 4 + 4), t * e * (2 * e + 4),
                                             F32_FLOPS_S)
        readings[shape] = r
        print(f"kernel moe_gating {shape} {t} x {e} bf16 k {k}: ms={r['ms']:.4f} (calls "
              f"queued) empty_launch_ms={empty_ms:.4f} host_paced_ms="
              f"{r['host_paced_ms']:.4f} host_ms={host_ms:.4f} (wrapper, a call) "
              f"bound_ms={r['bound_ms']:.7f} ({r['bound_by']}) plain_ms={r['plain_ms']:.4f}; "
              + "; ".join(f"{dt}: {a}" for dt, a in agree.items()), flush=True)
        if not all(a[c] for a in agree.values()
                   for c in ("rounds", "rank", "plain_bits", "edge_rows")):
            fail(f"moe_gating disagrees with a plain version or an edge rule at the "
                 f"{shape} shape")

    def flat(wm):      # NaN weights as -1, which no weight takes
        return torch.cat([wm[0].nan_to_num(nan=-1.0).flatten(), wm[1].float().flatten()])

    def library():   # the same selection by other means: 3 calls, ties unordered
        v, i = torch.topk(x.float(), k)
        return torch.zeros(x.shape, device="cuda").scatter_(1, i, torch.softmax(v, -1))

    pre = readings["prefill"]
    record_kernel(rows, "moe_gating", "src/repro_torch/kernels/moe_gating/moe_gating.cu",
                  "src/repro/kernels/moe_gating/moe_gating.py:48",
                  flat(moe_gating(x, k)), flat(moe_gating_ref(x, k)), GATING_TOL,
                  pre["ms"], pre["plain_ms"], x.shape[0] * e * (2 + 4 + 4),
                  x.shape[0] * e * (2 * e + 4), F32_FLOPS_S, None)
    print(f"kernel moe_gating: library_ms none (no one PyTorch call computes it: "
          f"torch.topk + softmax + scatter_ is three, and topk orders ties its own "
          f"way); those three take {queued_ms(library):.4f} ms queued, for scale",
          flush=True)
    return rows, readings


def check_moe_shapes(cfg, gen: torch.Generator) -> dict:
    """The serving kernels at the shapes OLMoE gives them, which the kernel
    phase (qwen2's shapes) does not reach: the flash forward at G = 1 and
    an exact, odd prompt length; dense and paged decode at G = 1 (one
    query head per KV head: 16/16, d_head 128) at the serving positions;
    rmsnorm over one 512-token prompt's bf16 rows of d_model 2048.  Each
    against its plain version at KERNEL_TOL, timed; dense decode also
    beside SDPA on the same inputs (for scale) and its bound.  Returns the
    readings by name."""
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

    hkv, dh = cfg.n_kv_heads, cfg.d_head
    g = cfg.n_heads // hkv
    out = {}

    def check(name, fn, ref, *args, tol=KERNEL_TOL, queued=False):
        got, want = fn(*args), ref(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ms, plain_ms = (cuda_ms(lambda: f(*args), iters=DECODE_ITERS if queued else 20,
                                queued=queued)
                        for f in (fn, ref))
        print(f"kernel {name} (OLMoE): max_abs_err={err:.3e} tol={tol} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f}", flush=True)
        if not agrees(got, want, tol):
            fail(f"{name} disagrees with its plain version at OLMoE's shape")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v = (randn(1, 300, hkv * g, dh) for _ in "qkv")
    check("flash_attention_fwd G=1 S 300", lambda *a: flash_attention_fwd(*a)[0],
          lambda *a: flash_attention_ref(*a)[0], q, k, v)
    check("flash_attention_fwd lse G=1 S 300", lambda *a: flash_attention_fwd(*a)[1],
          lambda *a: flash_attention_ref(*a)[1], q, k, v, tol=dict(atol=1e-3, rtol=0.0))
    qd, kv_view, vv_view, kp, vp, bt, pos = decode_case(gen, hkv, g, dh)
    # every decode time here is the card's (the calls queued); for scale
    # only (the port never calls it): SDPA on the same slots, positions and
    # cache view, and the least time the card could take
    check(f"flash_decode G={g}", flash_decode, flash_decode_ref, qd, kv_view, vv_view, pos,
          queued=True)
    mask = (torch.arange(ATTEND, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
    q4 = qd.reshape(SLOTS, 1, hkv * g, dh).transpose(1, 2)
    live = int((pos + 1).sum())
    dec_bytes = (2 * qd.numel() + 2 * live * hkv * dh) * 2
    sdpa_ms = queued_ms(lambda: F.scaled_dot_product_attention(
        q4, kv_view.transpose(1, 2), vv_view.transpose(1, 2), attn_mask=mask,
        enable_gqa=True))
    check(f"paged_flash_decode G={g}", paged_flash_decode, paged_flash_decode_ref,
          qd, kp, vp, bt, pos, queued=True)
    tables = int((pos // PAGE_SIZE + 1).sum()) * 4
    for name, n_bytes, lib in ((f"flash_decode G={g}", dec_bytes, sdpa_ms),
                               (f"paged_flash_decode G={g}", dec_bytes + tables, None)):
        r = out[name]
        r["library_ms"], r["sdpa_ms"] = lib, sdpa_ms
        r["bound_ms"], r["bound_by"] = bound(n_bytes, 4 * dh * hkv * g * live, BF16_FLOPS_S)
        print(f"kernel {name} (OLMoE): bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={'none' if lib is None else f'{lib:.4f}'}", flush=True)
        sdpa_factor(f"{name} (OLMoE)", r["ms"], sdpa_ms)
    x, w = randn(512, cfg.d_model), randn(cfg.d_model)
    check(f"rmsnorm 512 x {cfg.d_model}", lambda *a: rmsnorm(*a, cfg.norm_eps),
          lambda *a: rmsnorm_ref(*a, cfg.norm_eps), x, w, queued=True)
    return out


@contextlib.contextmanager
def moe_tap(replay=None):
    """While open, taps the MoE layer of ``repro_torch.models.moe``: each
    gating call's (weights, mask) lands in ``["gatings"]`` (or, with
    ``replay``, the recorded outputs are returned in order instead of
    gating), and each dispatch's (tokens S, capacity C, dropped picks) in
    ``["dispatches"]``: a pick is dropped where its place in its expert's
    buffer, the running count of the group's earlier picks, is C or more
    (``models/moe.py``'s arithmetic).  Syncs once a dispatch."""
    from repro_torch.models import moe

    gating, dispatch = moe.gating_topk, moe._moe_dispatch
    rec = dict(gatings=[], dispatches=[])

    def tap_gating(logits, top_k, use_kernel=True):
        if replay is not None:
            out = replay[len(rec["gatings"])]
        else:
            out = gating(logits, top_k, use_kernel)
        rec["gatings"].append(out)
        return out

    def tap_dispatch(params, x, cfg, capacity_factor, use_kernel):
        y = dispatch(params, x, cfg, capacity_factor, use_kernel)
        s = x.shape[1]
        cf = capacity_factor or cfg.capacity_factor
        cap = max(int(s * cfg.top_k * cf / cfg.n_experts), 1)
        mask = rec["gatings"][-1][1]
        place = torch.cumsum(mask.to(torch.int32), dim=1) - 1
        rec["dispatches"].append((s, cap, int((mask & (place >= cap)).sum())))
        return y

    moe.gating_topk, moe._moe_dispatch = tap_gating, tap_dispatch
    try:
        yield rec
    finally:
        moe.gating_topk, moe._moe_dispatch = gating, dispatch


def prefill_drops(rec, n_layers: int) -> list:
    """(length, capacity, dropped picks over all layers) of each prefill
    in a tapped run, in order: its dispatches of more than one token, one
    per layer."""
    calls = [d for d in rec["dispatches"] if d[0] > 1]
    return [(calls[i][0], calls[i][1], sum(c[2] for c in calls[i:i + n_layers]))
            for i in range(0, len(calls), n_layers)]


def routing_flips(a, b) -> dict:
    """Token rows whose selected experts differ between two tapped runs of
    the same forwards, in the prefill and in the decode steps, and the
    first gating call (in order: forward x layers) where one does."""
    n = dict(prefill=0, prefill_rows=0, decode=0, decode_rows=0, first_call=None)
    for i, ((_, ma), (_, mb)) in enumerate(zip(a["gatings"], b["gatings"])):
        ma, mb = ma.reshape(-1, ma.shape[-1]), mb.reshape(-1, mb.shape[-1])
        phase = "prefill" if ma.shape[0] > SLOTS else "decode"
        flips = int((ma != mb).any(-1).sum())
        n[phase] += flips
        n[phase + "_rows"] += ma.shape[0]
        if flips and n["first_call"] is None:
            n["first_call"] = i
    return n


def preemption_control(label, model, params, spec, num_pages) -> dict:
    """One weights/dtype/capacity setting served dense and on the
    preempting pool: per-request token agreement and the preempted."""
    dense, _, d_counts, _, _ = serve(model, params, spec)
    paged, eng, p_counts, _, _ = serve(model, params, spec, cache_layout="paged",
                                       page_size=PAGE_SIZE, num_pages=num_pages)
    _, per_req, preempted = layout_agreement(
        f"moe control {label}: dense vs preempting paged", dense, paged, eng)
    if not preempted:
        fail(f"the MoE control {label} was sized to preempt and did not")
    return dict(per_request=per_req, preempted=preempted,
                launches=add_counts(d_counts, p_counts))


def run_moe(seed: int, gen: torch.Generator):
    """Full-width OLMoE-1B-7B serving on both layouts, the plain path
    teacher-forced, one decode step's gating launches, and the profile of
    one prefill and one decode step.  Returns the record and the launch
    counts of the two serve runs."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import leaves

    cfg = get_config(MOE_ARCH)
    shapes = check_moe_shapes(cfg, gen)

    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    n_params = sum(p.numel() for p in leaves(params))
    print(f"moe model: {MOE_ARCH} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_head={cfg.d_head} experts="
          f"{cfg.n_experts} top_k={cfg.top_k} d_ff={cfg.d_ff} vocab={cfg.vocab} "
          f"params={n_params} dtype=bf16; weights {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    spec = make_requests(seed, cfg.vocab)
    print(f"moe requests: {len(spec)} prompts of {[len(p) for _, p, _ in spec]} tokens, "
          f"each prefilled alone at its length", flush=True)
    serve(model, params, [(99, spec[1][1][:64], 2)])           # warm-up
    torch.cuda.reset_peak_memory_stats()
    dense, _, d_counts, d_wall, d_tok = serve(model, params, spec)
    print(f"moe serve dense: {d_tok} tokens in {d_wall:.3f} s = {d_tok / d_wall:.1f} "
          f"tok/s; launches {d_counts}", flush=True)
    num_pages = preempting_pool(spec)
    paged, eng, p_counts, p_wall, p_tok = serve(
        model, params, spec, cache_layout="paged", page_size=PAGE_SIZE,
        num_pages=num_pages)
    peak = torch.cuda.max_memory_allocated()
    print(f"moe serve paged: {p_tok} tokens in {p_wall:.3f} s = {p_tok / p_wall:.1f} "
          f"tok/s; pool {num_pages} pages; preemptions {eng.preemptions}; launches "
          f"{p_counts}; peak memory {peak / 2 ** 30:.2f} GiB", flush=True)
    if eng.preemptions < 1:
        fail("the MoE paged run was sized to preempt and did not")
    if eng.last_pool_stats.used_pages != 0:
        fail(f"the MoE paged run leaked {eng.last_pool_stats.used_pages} pages")
    agree, per_req, preempted = layout_agreement("moe dense vs paged token agreement",
                                                 dense, paged, eng)
    ample, _, _, a_wall, a_tok = serve(model, params, spec, cache_layout="paged",
                                       page_size=PAGE_SIZE)
    agree_ample = np.mean([a == b for u in dense for a, b in zip(dense[u], ample[u])])
    print(f"moe serve paged, a pool that never preempts: {a_tok / a_wall:.1f} tok/s; "
          f"token agreement with dense {agree_ample:.4f}", flush=True)
    if agree_ample < 1.0:
        fail("paged serving without preemption served other tokens than dense")
    for name in ("rmsnorm", "flash_attention_fwd", "moe_gating"):
        if d_counts[name] == 0 or p_counts[name] == 0:
            fail(f"{name} never launched while serving MoE")
    if d_counts["flash_decode"] == 0 or p_counts["paged_flash_decode"] == 0:
        fail("a decode kernel never launched while serving MoE")

    # Why a preempted request differs.  Every row is its own MoE group, so
    # only a preempted request can: its re-prefill runs prompt and
    # generated tokens through prefill at the prefill capacity C = S k cf
    # / E (cf = infer_capacity_factor), where the dense run took decode
    # steps that drop nothing.  (i) The preempting run again, tapped: the
    # picks each prefill drops.  (ii) Controls on the same weights, dense
    # against the preempting pool, with cf = E / k (C = S: nothing drops),
    # in bf16 and in fp32 compute.
    with moe_tap() as tap:
        again, _, _, _, _ = serve(model, params, spec, cache_layout="paged",
                                  page_size=PAGE_SIZE, num_pages=num_pages)
    drops = prefill_drops(tap, cfg.n_layers)
    resumed = {u: [d for d in drops if len(p) < d[0] < len(p) + MAX_NEW]
               for u, p, _ in spec if u in preempted}
    print(f"moe prefill drops (length, capacity, dropped picks over "
          f"{cfg.n_layers} layers): {drops}; re-prefills of the preempted {resumed}; "
          f"tapped rerun serves the same tokens {again == paged}", flush=True)
    del tap
    nodrop = dataclasses.replace(cfg, infer_capacity_factor=cfg.n_experts / cfg.top_k)
    controls = {label: preemption_control(label, Model(nodrop, device="cuda", dtype=dt),
                                          params, spec, num_pages)
                for label, dt in (("bf16 no drops", torch.bfloat16),
                                  ("fp32 no drops", torch.float32))}
    # the fp32 control gates; the bf16 one is reported: its re-prefill
    # still rounds otherwise than the decode steps, and a router near-tie
    # may turn that into another token on another card
    for label, c in controls.items():
        if label.startswith("fp32") and min(c["per_request"].values()) < 1.0:
            fail(f"with nothing dropped and fp32 compute ({label}) a preempted "
                 f"request still served other tokens paged than dense")
    # the exemption: a preempted request whose re-prefill dropped picks
    for u in dense:
        if per_req[u] < 1.0 and not (u in preempted and any(d[2] for d in resumed[u])):
            fail(f"request {u} served other tokens paged than dense, and no "
                 f"dropped pick of a re-prefill accounts for it")

    # the plain path teacher-forced, with each path's routing tapped; then
    # the plain path again with the kernel path's routing replayed, which
    # leaves only attention's and rmsnorm's bf16 rounding between them
    uid, prompt, _ = spec[0]
    plain = Model(cfg, device="cuda", dtype=torch.bfloat16, use_kernels=False)
    with moe_tap() as k_tap:
        k_logits = teacher_force(model, params, prompt, dense[uid])
    with moe_tap() as p_tap:
        p_logits = teacher_force(plain, params, prompt, dense[uid])
    err, scale, t_agree = compare_logits(f"moe uid {uid} plain vs kernel path",
                                         p_logits, k_logits)
    flips = routing_flips(k_tap, p_tap)
    first = flips["first_call"]
    print(f"moe teacher-forced routing, plain vs kernel path: {flips['prefill']} of "
          f"{flips['prefill_rows']} prefill token-layer rows and {flips['decode']} of "
          f"{flips['decode_rows']} decode rows select other experts; first at "
          f"{'none' if first is None else f'forward {first // cfg.n_layers} layer {first % cfg.n_layers}'}",
          flush=True)
    with moe_tap(replay=k_tap["gatings"]):
        r_logits = teacher_force(plain, params, prompt, dense[uid])
    r_err, _, r_agree = compare_logits(
        f"moe uid {uid} plain vs kernel path, the kernel path's routing replayed",
        r_logits, k_logits)
    del plain, k_logits, p_logits, r_logits, k_tap, p_tap

    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device="cuda")
    tok = torch.zeros(SLOTS, dtype=torch.int32, device="cuda")
    cache = model.init_cache(SLOTS, MAX_SEQ)
    torch.cuda.synchronize()
    kernels.reset_launches()
    model.decode_step(params, cache, tok, pos, attend_len=MAX_SEQ)
    torch.cuda.synchronize()
    per_step = kernels.launch_counts()["moe_gating"]
    print(f"moe decode step: moe_gating launched {per_step} times "
          f"({cfg.n_layers} layers)", flush=True)
    if per_step != cfg.n_layers:
        fail(f"a decode step launched moe_gating {per_step} times, not once per layer")
    toks = torch.randint(0, cfg.vocab, (1, 512), generator=gen, device="cuda")
    phases = {
        "moe_decode_step": profile_phase("moe_decode_step", lambda: model.decode_step(
            params, cache, tok, pos, attend_len=MAX_SEQ), 10),
        "moe_prefill_1x512": profile_phase("moe_prefill_1x512",
                                           lambda: model.prefill(params, toks, 512), 3)}
    require_decode_kernels(phases, ("moe_decode_step",))
    for name, r in phases.items():
        if r["device_ms"] > 0 and r["gating_ms"] <= 0:
            fail(f"the {name} profile holds no {GATING_KERNEL} time")
    print(f"moe gating device time: decode step {phases['moe_decode_step']['gating_ms']:.4f} "
          f"ms in {cfg.n_layers} calls, prefill 1 x 512 "
          f"{phases['moe_prefill_1x512']['gating_ms']:.4f} ms", flush=True)
    counts = add_counts(d_counts, p_counts)
    return dict(n_params=n_params, dense_tok_s=d_tok / d_wall, paged_tok_s=p_tok / p_wall,
                dense_counts=d_counts, paged_counts=p_counts, num_pages=num_pages,
                preemptions=eng.preemptions, token_agreement=agree,
                token_agreement_per_request=per_req, preempted=preempted,
                token_agreement_no_preemption=float(agree_ample),
                prefill_drops=drops, resumed_prefill_drops=resumed,
                preemption_controls=controls, kernels_at_olmoe_shapes=shapes,
                peak_bytes=peak, teacher_forced_max_err=err, logit_scale=scale,
                teacher_forced_argmax_agreement=t_agree, routing_flips=flips,
                replayed_routing_max_err=r_err, replayed_routing_argmax_agreement=r_agree,
                gating_per_decode_step=per_step, phases=phases), counts


# ---------------------------------------------------------------------------
# phase 4: training through the flash backward
# ---------------------------------------------------------------------------

def grad_readings(k_loss, k_grads, p_loss, p_grads) -> dict:
    """Kernel-path loss and gradients against the plain path's: the loss
    difference, the global norms' relative difference, and per leaf the
    cosine similarity and the relative norm of the difference."""
    from repro_torch.optim.optimizer import global_norm, named_leaves

    k_norm, p_norm = global_norm(k_grads).item(), global_norm(p_grads).item()
    p_named = dict(named_leaves(p_grads))
    cos, rel = {}, {}
    for path, a in named_leaves(k_grads):
        a, b = a.flatten().double(), p_named[path].flatten().double()
        cos[path] = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        rel[path] = ((a - b).norm() / b.norm()).item()
    worst_cos, worst_rel = min(cos, key=cos.get), max(rel, key=rel.get)
    return dict(kernel_loss=k_loss, plain_loss=p_loss,
                loss_diff=abs(k_loss - p_loss), kernel_grad_norm=k_norm,
                plain_grad_norm=p_norm, grad_norm_rel_diff=abs(k_norm - p_norm) / p_norm,
                min_cosine=cos[worst_cos], min_cosine_leaf=worst_cos,
                max_leaf_rel_diff=rel[worst_rel], max_leaf_rel_diff_leaf=worst_rel,
                cosines=cos, leaf_rel_diffs=rel)


def tripped_gates(r: dict) -> list:
    """The gradient gates that reading ``r`` does not pass."""
    gates = [("loss", r["loss_diff"] <= GRAD_LOSS_TOL),
             ("global norm", r["grad_norm_rel_diff"] <= GRAD_NORM_TOL),
             ("leaf cosine", r["min_cosine"] >= GRAD_COS_MIN),
             ("leaf norm difference", r["max_leaf_rel_diff"] <= GRAD_LEAF_TOL)]
    return [name for name, ok in gates if not ok]


def print_readings(label: str, r: dict):
    print(f"train grad check {label} (tf32 off): loss kernel {r['kernel_loss']:.6f} "
          f"plain {r['plain_loss']:.6f} diff {r['loss_diff']:.3e} (tol {GRAD_LOSS_TOL}); "
          f"grad norm kernel {r['kernel_grad_norm']:.6f} plain "
          f"{r['plain_grad_norm']:.6f} rel diff {r['grad_norm_rel_diff']:.3e} "
          f"(tol {GRAD_NORM_TOL}); min leaf cosine 1 - {1 - r['min_cosine']:.3e} at "
          f"{r['min_cosine_leaf']} (min 1 - {1 - GRAD_COS_MIN:.1e}); max leaf norm "
          f"difference {r['max_leaf_rel_diff']:.3e} at {r['max_leaf_rel_diff_leaf']} "
          f"(tol {GRAD_LEAF_TOL}); gates tripped {tripped_gates(r)}", flush=True)


def compare_grads(model, plain, params, batch) -> dict:
    """One gradient on one batch through the kernel path and through the
    plain path, same weights, held to the gates; then the faulted control
    (the kernel path with dk scaled by GRAD_FAULT_DK in every layer's
    backward), which must trip a gate."""
    from repro_torch.kernels.flash_attention.ops import FlashAttention
    from repro_torch.train.step import make_grad_fn

    def grads(m):
        loss, g = make_grad_fn(m, vocab_chunks=VOCAB_CHUNKS)(params, batch)
        return loss.item(), g

    p_loss, p_grads = grads(plain)
    sound = grad_readings(*grads(model), p_loss, p_grads)
    print_readings("sound", sound)
    if not (np.isfinite(sound["kernel_loss"]) and np.isfinite(p_loss)):
        fail("non-finite loss in the gradient check")
    if tripped_gates(sound):
        fail(f"kernel-path gradients fail the gates {tripped_gates(sound)}")

    backward = FlashAttention.backward

    def faulted(ctx, do):
        dq, dk, *rest = backward(ctx, do)
        return (dq, dk * GRAD_FAULT_DK, *rest)

    FlashAttention.backward = staticmethod(faulted)
    try:
        control = grad_readings(*grads(model), p_loss, p_grads)
    finally:
        FlashAttention.backward = staticmethod(backward)
    print_readings(f"control (dk x {GRAD_FAULT_DK})", control)
    if not tripped_gates(control):
        fail(f"the gradient gates pass a backward with dk x {GRAD_FAULT_DK}")
    return dict(sound=sound, control=control)


def run_training(cfg, seed: int):
    """Full-width qwen2-1.5b training on one card: the gradient check,
    TRAIN_STEPS Trainer steps, one profiled step.  Returns the record and
    the launch counts of the Trainer run."""
    from repro_torch import kernels
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import AdamWConfig, init_adamw, leaves
    from repro_torch.train.step import TrainState, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 products in full fp32
    kw = dict(device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32)
    model = Model(cfg, **kw)                           # remat on, as the reference
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    n_params = sum(p.numel() for p in leaves(params))
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=seed))
    print(f"train model: {ARCH} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"params={n_params} fp32 master weights + AdamW, bf16 compute, remat, "
          f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, {VOCAB_CHUNKS} vocab chunks",
          flush=True)
    batch = {k: v.cuda() for k, v in data.batch_at(0).items()}
    grads = compare_grads(model, Model(cfg, use_kernels=False, **kw), params, batch)

    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    trainer = Trainer(model, data, opt, TrainerConfig(total_steps=TRAIN_STEPS,
                                                      vocab_chunks=VOCAB_CHUNKS))
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def log(step, m):
        print(f"train step {step}: loss {m['loss']:.6f} lr {m['lr']:.3e} grad_norm "
              f"{m['grad_norm']:.6f} {m['step_time_s'] * 1e3:.1f} ms "
              f"{tokens / m['step_time_s']:.1f} tokens/s", flush=True)

    start = TrainState(params, init_adamw(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()    # weights, AdamW state, leftovers
    kernels.reset_launches()
    state, hist = trainer.run(start_state=start, on_metrics=log)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"train: {len(hist)} steps, peak memory {peak / 2 ** 30:.2f} GiB "
          f"({before / 2 ** 30:.2f} GiB allocated before the run); launches "
          f"rmsnorm {counts['rmsnorm']} flash_attention_fwd "
          f"{counts['flash_attention_fwd']} ({counts['flash_attention_fwd'] // TRAIN_STEPS} "
          f"a step) flash_attention_bwd {counts['flash_attention_bwd']} "
          f"({counts['flash_attention_bwd'] // TRAIN_STEPS} a step)", flush=True)
    losses = [m["loss"] for _, m in hist]
    if len(hist) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"training gave losses {losses}")
    if counts["flash_attention_bwd"] != cfg.n_layers * TRAIN_STEPS:
        fail(f"flash_attention_bwd launched {counts['flash_attention_bwd']} times, "
             f"not once per layer per step")
    if counts["flash_attention_fwd"] != 2 * cfg.n_layers * TRAIN_STEPS:
        fail(f"flash_attention_fwd launched {counts['flash_attention_fwd']} times, "
             f"not twice (forward, remat) per layer per step")
    if counts["rmsnorm"] == 0:
        fail("rmsnorm never launched while training")
    no_ragged_rmsnorm("training", counts)

    step_fn = make_train_step(model, opt, vocab_chunks=VOCAB_CHUNKS)
    batch = {k: v.cuda() for k, v in data.batch_at(TRAIN_STEPS).items()}
    profile = profile_phase("train_step", lambda: step_fn(state, batch), 1)
    times = [m["step_time_s"] for _, m in hist]
    return dict(grad_check=grads, history=hist, peak_bytes=peak,
                allocated_before_bytes=before, n_params=n_params,
                step_ms=[t * 1e3 for t in times],
                tokens_s=[tokens / t for t in times], profile=profile,
                counts=counts), counts


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


# a decode split kernel's template arguments: q type, cache type, D, GR
DECODE_TEMPLATE = re.compile(r"decode_split_kernel<([^,]+), ([^,]+), (\d+), (\d+),")
CACHE_BYTES = {"signed char": 1, "char": 1, "__nv_bfloat16": 2, "float": 4}


def print_ptxas(report: dict, build) -> dict:
    """Print ptxas's registers, spills and shared memory (static, and the
    matmul and split kernels' dynamic bytes from the library) and the
    HMMA count of each kernel of matmul.cu, rmsnorm.cu,
    decode_attention.cu, verify_attention.cu and warp_ops.cu; fail unless
    every matmul kernel runs on the tensor cores and ptxas reported both
    decode kernels."""
    smem = build.LIB.fn("repro_matmul_smem_bytes", [build.I])
    decode_smem = build.LIB.fn("repro_decode_smem_bytes", [build.I] * 3)
    for name, r in sorted(report.items()):
        if "matmul_tc_kernel" in name:
            r["dynamic_smem"] = smem(1 if "bfloat16" in name else 0)
        t = DECODE_TEMPLATE.search(name)
        if t:
            r["dynamic_smem"] = decode_smem(CACHE_BYTES[t.group(2).strip()],
                                            int(t.group(3)), int(t.group(4)))
        print(f"ptxas {name}: registers={r.get('registers')} {r.get('spills')}; "
              f"static smem {r.get('static_smem')} B, dynamic smem "
              f"{r.get('dynamic_smem', 0)} B; HMMA {r.get('hmma', 0)}", flush=True)
    mm = [n for n in report if "matmul_tc_kernel" in n]
    if len(mm) != 4 or any(not report[n].get("hmma") for n in mm):
        fail(f"the matmul kernels do not all run on the tensor cores: "
             f"{ {n: report[n].get('hmma', 0) for n in mm} }")
    for k in DECODE_KERNELS:
        if not any(k in n for n in report):
            fail(f"ptxas reported no {k}")
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.bench.kernel_ab import ptxas_report
        from repro_torch.kernels import build
        from repro_torch.models.layers import WarpFeatureConfig
        from repro_torch.models.lm import Model
        from repro_torch.optim.optimizer import leaves
    except ImportError as exc:
        fail(f"cannot import the port from {ROOT / 'src'}: {exc}")

    smi = smi_line()
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.LIB.load()
    print(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({len(build.sources())} sources)", flush=True)

    # ptxas's view of the redesigned kernels, compiled beside the kernel phase
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ptxas_job = pool.submit(ptxas_report, ROOT / "src" / "repro_torch" / "kernels")

    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows, t1_err, int8_checks = check_kernels(cfg, gen)
    serving_kernels = ("rmsnorm", "flash_attention_fwd", "flash_decode",
                       "paged_flash_decode")
    rows.update(check_warp_kernels(gen))
    ptxas = print_ptxas(ptxas_job.result(), build)
    pool.shutdown()
    gating_rows, gating_readings = check_moe_gating(get_config(MOE_ARCH), gen)
    rows.update(gating_rows)

    fig5_rows, fig5_counts = run_fig5(args.seed)
    for name in WARP_KERNELS:
        rows[name]["launches"] = fig5_counts[name]
    fig5_device = fig5_device_time(args.seed)

    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    params = model.init(torch.Generator(device="cuda").manual_seed(args.seed))
    n_params = sum(p.numel() for p in leaves(params))
    print(f"model: {ARCH} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_head={cfg.d_head} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} params={n_params} dtype=bf16",
          flush=True)
    spec = make_requests(args.seed, cfg.vocab)
    print(f"requests: {len(spec)} prompts of {[len(p) for _, p, _ in spec]} tokens, "
          f"max_new_tokens={MAX_NEW}, slots={SLOTS}, max_seq={MAX_SEQ}", flush=True)
    # warm-up (cuBLAS handles, allocator): one short request, not counted
    serve(model, params, [(99, spec[1][1][:64], 2)])

    dense, dense_eng, dense_counts, dense_wall, dense_tok = serve(model, params, spec)
    print(f"serve dense: {dense_tok} tokens in {dense_wall:.3f} s = "
          f"{dense_tok / dense_wall:.1f} tok/s; launches {dense_counts}", flush=True)
    # the first four prompts fill the pool but for one growth page per
    # slot: the batch cannot grow 32 tokens without preempting
    num_pages = preempting_pool(spec)
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
    print(f"prefill groups (uids, bucket, lengths): dense {dense_eng.last_prefill_groups}; "
          f"paged {eng.last_prefill_groups}", flush=True)
    # reported, not gated: after a preemption a request may prefill in
    # another right-padded group at another bucket and round otherwise in
    # bf16; the fp32 control below gates (ROADMAP C1)
    layout_agreement("dense vs paged token agreement", dense, paged, eng)
    c1 = c1_control(cfg, model, params, spec, num_pages, dense, paged,
                    dense_eng.last_prefill_groups, eng.last_prefill_groups)
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

    spec_rec, verify_launches = run_spec(cfg, model, params, spec,
                                         paged_tok / paged_wall)
    rows["paged_flash_verify"]["launches"] = verify_launches

    tiered_rec, tiered_counts = run_tiered(cfg, model, params, spec, dense, paged,
                                           paged_tok / paged_wall, num_pages,
                                           eng.preemptions)
    for name in serving_kernels + ("paged_flash_decode[int8]", "paged_flash_verify[int8]"):
        rows[name]["launches"] += tiered_counts[name]

    phases = where_time_goes(model, params, gen)

    # the serving weights, engine and logits make way for training's
    preemptions = eng.preemptions
    del model, params, plain, m, eng, k_logits, p_logits, f_logits
    torch.cuda.empty_cache()
    moe_rec, moe_counts = run_moe(args.seed, gen)
    for name in ("rmsnorm", "flash_attention_fwd", "flash_decode", "paged_flash_decode",
                 "moe_gating"):
        rows[name]["launches"] += moe_counts[name]
    phases.update(moe_rec.pop("phases"))
    torch.cuda.empty_cache()      # the MoE weights make way for training's
    train_rec, train_counts = run_training(cfg, args.seed)
    phases["train_step"] = train_rec.pop("profile")
    flash_branch_launches(
        {"serve dense": dense_counts, "serve paged": paged_counts,
         "tiered bf16 runs": tiered_counts, "moe serve": moe_counts, "train": train_counts},
        {"C1 control fp32": c1["launches"],
         "tiered fp32 control": tiered_rec["fp32_control_launches"],
         "moe control fp32 no drops": moe_rec["preemption_controls"]["fp32 no drops"]["launches"]})
    # training's launches belong to the training-shape rows
    rows["rmsnorm (training)"]["launches"] = train_counts["rmsnorm"]
    rows["flash_attention_bwd"]["launches"] += train_counts["flash_attention_bwd"]
    rows["flash_attention_fwd (training)"]["launches"] = train_counts["flash_attention_fwd"]

    result = {"kernels": list(rows.values())}
    DETAILS.parent.mkdir(parents=True, exist_ok=True)
    DETAILS.write_text(json.dumps(dict(
        result, device=smi, phases=phases, dense_tok_s=dense_tok / dense_wall,
        paged_tok_s=paged_tok / paged_wall, dense_counts=dense_counts,
        paged_counts=paged_counts, preemptions=preemptions, train=train_rec,
        num_pages=num_pages, teacher_forced_max_err=err, logit_scale=scale,
        fig5=fig5_rows, fig5_counts=fig5_counts, fig5_device=fig5_device,
        warp_forms=warp_forms, spec=spec_rec, verify_t1_err=t1_err, moe=moe_rec,
        c1_control=c1, tiered=tiered_rec, int8_kernel_checks=int8_checks,
        moe_gating=gating_readings, flash_branches=BRANCHES_RUN,
        matmul=MATMUL_READINGS, ptxas=ptxas),
        indent=1))
    print(json.dumps(result), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
