"""A/B timings of the port's matmul, rmsnorm, decode, verify, shfl and gating kernels on one NVIDIA GPU.

    python src/repro_torch/bench/kernel_ab.py SRC [--iters N] [--ptxas] [--only GROUP ...]

For the package tree whose ``src/`` is SRC, one JSON line:

- ``matmul``: f32 and bf16 at 2048^3 and f32 at Fig. 5's 64^3 (ms), and
  the f32 kernel's error at 2048^3 against a float64 product (max, RMS
  relative, and shrink: mean((got - want) * sign(want)) / mean(|want|),
  below 0 when the sums come out smaller), beside cuBLAS in full f32 and
  an emulated plain TF32 product on the same inputs;
- ``rmsnorm`` on bf16 rows: 4 x 1536 (decode), 2048 x 1536 (prefill),
  8192 x 1536 under an fp32 weight (training) and 512 x 2048 (OLMoE);
- ``decode`` at the serving path's slots and positions (543/400/300/64,
  attend 576, shuffled 16-token pages, bf16): G = 1 dense and paged at
  OLMoE-1B-7B's 16 KV heads, G = 6 dense, paged and int8-paged at
  qwen2-1.5b's 2 (``flash_decode``, ``paged_flash_decode``);
- ``verify``: ``paged_flash_verify`` at the same slots and pages, G = 6,
  a spec_k = 4 window over bf16 and int8 pages and a window of one (f32,
  beside paged decode on the same inputs, with ``verify_t1_bits``: the two
  outputs equal bit for bit); where SRC has ``verify_splits``, the T = 4
  cases also on paged decode's split count (``..._decode_splits``);
- ``shfl``: Fig. 5's butterfly (bfly 16) on a (2^20, 32) f32 block, beside
  ``torch.gather`` of the same permutation;
- ``gating``: ``moe_gating`` on bf16 router logits, top-8, at OLMoE's
  decode (4 x 64) and 512-token prefill (512 x 64) and Granite-MoE's
  prefill (512 x 32): queued (``_device``), host-paced, and the wrapper's
  host time a call (``_host``: the host clock over back-to-back calls, no
  synchronize); beside them an empty launch queued the same way
  (``empty_launch_device``, ``torch.cuda._sleep(0)``), the floor a launch
  sets on the card.  The logits are ``chip_smoke.gating_logits``' (the
  Pallas kernel's edge rows first).  ``gating_digest`` hashes each
  shape's weights and mask bytes, and those of 16 f32 rows where -1e30 is
  exact, so two trees' outputs can be compared bit for bit;
- ``step``: one spec_k = 4 verify step (``Model.decode_verify_step``) of
  full-width qwen2-1.5b on random bf16 weights over a paged cache at the
  same positions, its device kernel ms by ``torch.profiler`` and the
  verify attention's share of it (every kernel whose name holds
  ``verify_kernel``, ``decode_split_kernel`` or ``decode_combine_kernel``);
- ``moe_step``: one decode step of full-width OLMoE-1B-7B on random bf16
  weights over a dense cache at the same positions, its device kernel ms
  by ``torch.profiler`` and ``moe_gating``'s share of it (16 calls).

Small calls are host-paced: the Python wrapper takes longer to launch one
than the card to run it.  So rmsnorm, decode, gating and the 64^3 matmul
are also timed with the calls queued first behind a spin on the card
(``..._device``): the card's time alone.

``--only`` times the named groups alone.  With ``--ptxas``, also ``nvcc
-Xptxas -v`` of SRC's ``matmul.cu``, ``rmsnorm.cu``,
``decode_attention.cu``, ``verify_attention.cu``, ``warp_ops.cu`` and
``moe_gating.cu``: registers, spills and static shared memory of each
kernel, keyed by its source, and its HMMA (tensor-core) instruction count
from ``cuobjdump -sass``.
Run it by path, so that the package is imported from SRC; compare two
commits on one machine by turns: parent, change, change, parent.  Times
are CUDA-event means over back-to-back calls (inputs warm in L2).  Needs
nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
MATMUL_SHAPES = {"f32_2048": (2048, torch.float32), "bf16_2048": (2048, torch.bfloat16),
                 "f32_64": (64, torch.float32)}
# (rows, d, weight dtype) on bf16 rows
RMSNORM_SHAPES = {"4x1536": (4, 1536, torch.bfloat16),
                  "2048x1536": (2048, 1536, torch.bfloat16),
                  "8192x1536_f32w": (8192, 1536, torch.float32),
                  "512x2048": (512, 2048, torch.bfloat16)}
# decode: (Hkv, G) at D 128 over the serving path's slots and positions
DECODE_SHAPES = {"g1": (16, 1), "g6": (2, 6)}
DECODE_POS = (543, 400, 300, 64)
DECODE_ATTEND, DECODE_MAX_SEQ, DECODE_PAGE = 576, 576, 16
VERIFY_T = 4
SHFL_SHAPE = (2 ** 20, 32)
# moe_gating: (tokens, experts) of bf16 router logits at top_k GATING_TOP_K
GATING_SHAPES = {"4x64": (4, 64), "512x64": (512, 64), "512x32": (512, 32)}
GATING_TOP_K = 8
GROUPS = ("matmul", "rmsnorm", "decode", "verify", "shfl", "gating", "step", "moe_step")
# the verify attention's kernels, as the profiler names them in either tree
VERIFY_KERNELS = ("verify_kernel", "decode_split_kernel", "decode_combine_kernel")
# the spin that queues timed calls: long enough for the host to launch a
# few hundred small calls, in cycles at a clock above the H100's 1.98 GHz
SPIN_S = 0.02
SPIN_CYCLES_S = 2.0e9
KERNELS = re.compile(r"(matmul_tc_kernel|matmul_kernel|rmsnorm_\w*kernel|decode_\w*kernel"
                     r"|verify_kernel|shfl_\w*kernel|moe_gating_kernel)")
# the sources whose kernels --ptxas reports
PTXAS_SOURCES = ("matmul/matmul.cu", "rmsnorm/rmsnorm.cu",
                 "decode_attention/decode_attention.cu",
                 "verify_attention/verify_attention.cu", "warp_ops/warp_ops.cu",
                 "moe_gating/moe_gating.cu")


def cuda_ms(fn, iters: int, warmup: int = 3, queued: bool = False) -> float:
    """Mean ms a call between CUDA events around ``iters`` back-to-back
    calls.  Where the host takes longer to launch a call than the card to
    run it, that is the host's pace; with ``queued`` the calls are first
    queued behind a spin on the card (``SPIN_S``), so the events time the
    card's work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if queued:
        torch.cuda._sleep(int(SPIN_S * SPIN_CYCLES_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    """max, RMS relative and shrink of got against want (float64)."""
    diff = got.double() - want
    return dict(max_err=diff.abs().max().item(),
                rms_rel_err=(diff.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item(),
                shrink=((diff * want.sign()).mean() / want.abs().mean()).item())


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32, ties away from zero (the arithmetic of the
    kernel's split, kept here so that a tree without it can be timed)."""
    return torch.bitwise_and(x.view(torch.int32) + 0x1000, -0x2000).view(torch.float32)


def time_decode(iters: int, gen: torch.Generator) -> dict:
    """ms of each decode case (host-paced, and ``_device`` queued)."""
    from repro_torch.kernels.decode_attention.ops import flash_decode, paged_flash_decode
    from repro_torch.serve.kv_cache import quantize_kv_rows

    b, d, nb = len(DECODE_POS), 128, DECODE_MAX_SEQ // DECODE_PAGE
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device="cuda")
    out = {}
    for name, (hkv, g) in DECODE_SHAPES.items():
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

        q = randn(b, hkv, g, d)
        kc, vc = randn(b, DECODE_MAX_SEQ, hkv, d), randn(b, DECODE_MAX_SEQ, hkv, d)
        kv, vv = kc[:, :DECODE_ATTEND], vc[:, :DECODE_ATTEND]
        kp, vp = randn(b * nb + 1, DECODE_PAGE, hkv, d), randn(b * nb + 1, DECODE_PAGE, hkv, d)
        bt = (torch.randperm(b * nb, generator=gen, device="cuda") + 1).reshape(b, nb).int()
        cases = {"dense": lambda: flash_decode(q, kv, vv, pos),
                 "paged": lambda: paged_flash_decode(q, kp, vp, bt, pos)}
        if g > 1:
            (kq, ks), (vq, vs) = quantize_kv_rows(kp.float()), quantize_kv_rows(vp.float())
            cases["int8"] = lambda: paged_flash_decode(q, kq, vq, bt, pos, k_scales=ks,
                                                       v_scales=vs)
        for case, fn in cases.items():
            out[f"decode_{name}_{case}"] = cuda_ms(fn, iters * 5)
            out[f"decode_{name}_{case}_device"] = cuda_ms(fn, iters * 5, queued=True)
    return out


def time_verify(iters: int, gen: torch.Generator) -> dict:
    """ms of each verify case (host-paced, and ``_device`` queued) at
    qwen2-1.5b's heads over DECODE_SHAPES' slots and pages."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.verify_attention import ops as verify_ops
    from repro_torch.serve.kv_cache import quantize_kv_rows

    paged_flash_verify = verify_ops.paged_flash_verify
    hkv, g = DECODE_SHAPES["g6"]
    b, d, nb = len(DECODE_POS), 128, DECODE_MAX_SEQ // DECODE_PAGE
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device="cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q = randn(b, hkv, VERIFY_T * g, d).to(torch.bfloat16)
    kp, vp = randn(b * nb + 1, DECODE_PAGE, hkv, d), randn(b * nb + 1, DECODE_PAGE, hkv, d)
    bt = (torch.randperm(b * nb, generator=gen, device="cuda") + 1).reshape(b, nb).int()
    (kq, ks), (vq, vs) = quantize_kv_rows(kp), quantize_kv_rows(vp)
    kb, vb = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    q1 = randn(b, hkv, g, d)
    cases = {
        "bf16": lambda: paged_flash_verify(q, kb, vb, bt, pos, t_window=VERIFY_T),
        "int8": lambda: paged_flash_verify(q, kq, vq, bt, pos, t_window=VERIFY_T,
                                           k_scales=ks, v_scales=vs),
        "t1_f32": lambda: paged_flash_verify(q1, kp, vp, bt, pos, t_window=1),
        "t1_f32_paged_decode": lambda: decode_ops.paged_flash_decode(q1, kp, vp, bt, pos)}
    out = {"verify_t1_bits": bool(torch.equal(cases["t1_f32"](),
                                              cases["t1_f32_paged_decode"]()))}
    for case, fn in cases.items():
        out[f"verify_{case}"] = cuda_ms(fn, iters * 5)
        out[f"verify_{case}_device"] = cuda_ms(fn, iters * 5, queued=True)
    if hasattr(verify_ops, "verify_splits"):
        # the T = 4 cases again on paged decode's count (the rows' blocks
        # not counted)
        chosen = verify_ops.verify_splits
        verify_ops.verify_splits = lambda b_, h_, rows, t, n: decode_ops.decode_splits(b_, h_, n)
        try:
            for case in ("bf16", "int8"):
                out[f"verify_{case}_decode_splits_device"] = cuda_ms(cases[case], iters * 5,
                                                                     queued=True)
        finally:
            verify_ops.verify_splits = chosen
        out["verify_splits"] = chosen(b, hkv, VERIFY_T * g, VERIFY_T, nb * DECODE_PAGE)
    return out


def time_shfl(iters: int, gen: torch.Generator) -> dict:
    """ms of the shfl butterfly and of ``torch.gather`` of the same lanes,
    each also queued (``_device``), and whether the two agree bit for
    bit."""
    from repro_torch.kernels.warp_ops.ops import shfl
    from repro_torch.kernels.warp_ops.ref import shfl_src

    n, w = SHFL_SHAPE
    x = torch.randn(n, w, generator=gen, device="cuda")
    src = shfl_src("bfly", w, 16, "cuda").expand(n, w)
    out = {"shfl_bits": bool(torch.equal(shfl(x, "bfly", 16), torch.gather(x, 1, src)))}
    for case, fn in (("shfl", lambda: shfl(x, "bfly", 16)),
                     ("shfl_gather", lambda: torch.gather(x, 1, src))):
        out[case] = cuda_ms(fn, iters * 5)
        out[f"{case}_device"] = cuda_ms(fn, iters * 5, queued=True)
    return out


def time_gating(iters: int, gen: torch.Generator) -> dict:
    """ms of ``moe_gating`` at each of GATING_SHAPES (host-paced,
    ``_device`` queued, ``_host`` the wrapper's host time a call) and of
    an empty launch queued; digests of the outputs."""
    import hashlib

    from repro_torch.kernels.moe_gating.ops import moe_gating

    sys.path.insert(1, str(ROOT))
    from chip_smoke import gating_logits      # the smoke's edge rows first

    def digest(x):
        w, m = moe_gating(x, GATING_TOP_K)
        torch.cuda.synchronize()
        return hashlib.sha256(w.cpu().numpy().tobytes() + m.cpu().numpy().tobytes()
                              ).hexdigest()[:16]

    out = {"empty_launch_device": cuda_ms(lambda: torch.cuda._sleep(0), iters * 5,
                                          queued=True)}
    digests = {"edges_f32_16x64": digest(gating_logits(gen, 16, 64))}
    for name, (t, e) in GATING_SHAPES.items():
        x = gating_logits(gen, t, e).to(torch.bfloat16)
        digests[name] = digest(x)
        out[f"gating_{name}"] = cuda_ms(lambda: moe_gating(x, GATING_TOP_K), iters * 5)
        out[f"gating_{name}_device"] = cuda_ms(lambda: moe_gating(x, GATING_TOP_K),
                                               iters * 5, queued=True)
        n = iters * 50
        t0 = time.perf_counter()
        for _ in range(n):
            moe_gating(x, GATING_TOP_K)
        out[f"gating_{name}_host"] = (time.perf_counter() - t0) * 1e3 / n
        torch.cuda.synchronize()
    out["gating_digest"] = digests
    return out


def step_kernel_ms(step, iters: int, names) -> tuple:
    """Device kernel ms of ``step`` (mean of ``iters`` profiled calls after
    one warm-up) and, of that, the ms of every kernel whose name holds one
    of ``names``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def ms(evts):
        return sum(getattr(e, "self_device_time_total", 0) for e in evts) / 1e3 / iters

    return ms(kernels), ms([e for e in kernels if any(k in e.key for k in names)])


def time_verify_step(iters: int, gen: torch.Generator) -> dict:
    """Device kernel ms of one spec_k = 4 verify step of full-width
    qwen2-1.5b (mean of ``iters`` profiled steps) and, of that, the verify
    attention's kernels' ms."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model

    model = Model(get_config("qwen2-1.5b"), device="cuda", dtype=torch.bfloat16)
    params = model.init(gen)
    b = len(DECODE_POS)
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device="cuda")
    cache = model.init_cache(b, DECODE_MAX_SEQ, layout="paged", page_size=DECODE_PAGE)
    nb = cache["block_tables"].shape[1]
    cache["block_tables"] = torch.arange(1, b * nb + 1, dtype=torch.int32,
                                         device="cuda").reshape(b, nb)
    win = torch.zeros(b, VERIFY_T, dtype=torch.int32, device="cuda")
    total, attention = step_kernel_ms(
        lambda: model.decode_verify_step(params, cache, win, pos, attend_len=DECODE_MAX_SEQ),
        iters, VERIFY_KERNELS)
    return {"verify_step_kernel_ms": total, "verify_step_attention_ms": attention}


def time_moe_step(iters: int, gen: torch.Generator) -> dict:
    """Device kernel ms of one full-batch decode step of full-width
    OLMoE-1B-7B (random bf16 weights, dense cache, DECODE_POS; mean of
    ``iters`` profiled steps) and, of that, ``moe_gating``'s 16 calls."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model

    model = Model(get_config("olmoe-1b-7b"), device="cuda", dtype=torch.bfloat16)
    params = model.init(gen)
    b = len(DECODE_POS)
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device="cuda")
    tok = torch.zeros(b, dtype=torch.int32, device="cuda")
    cache = model.init_cache(b, DECODE_MAX_SEQ)
    total, gating = step_kernel_ms(
        lambda: model.decode_step(params, cache, tok, pos, attend_len=DECODE_MAX_SEQ),
        iters, ("moe_gating_kernel",))
    return {"moe_step_kernel_ms": total, "moe_step_gating_ms": gating}


def time_kernels(iters: int, only=GROUPS) -> dict:
    """ms of each case of the groups ``only`` through the imported
    package, and the f32 matmul's error at 2048^3."""
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, (d, dtype) in (MATMUL_SHAPES.items() if "matmul" in only else ()):
        a, b = (torch.randn(d, d, generator=gen, device="cuda").to(dtype) for _ in "ab")
        out[f"matmul_{name}"] = cuda_ms(lambda: matmul(a, b), iters)
        if name == "f32_64":
            out[f"matmul_{name}_device"] = cuda_ms(lambda: matmul(a, b), iters * 5, queued=True)
        if name == "f32_2048":
            exact = a.double() @ b.double()
            out["matmul_f32_2048_error"] = dict(
                kernel=errors(matmul(a, b), exact),
                cublas_f32=errors(a @ b, exact),
                tf32_emulated=errors(_tf32(a) @ _tf32(b), exact))
            del exact
    for name, (n, d, w_dtype) in (RMSNORM_SHAPES.items() if "rmsnorm" in only else ()):
        x = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn(d, generator=gen, device="cuda").to(w_dtype)
        out[f"rmsnorm_{name}"] = cuda_ms(lambda: rmsnorm(x, w, 1e-6), iters * 5)
        out[f"rmsnorm_{name}_device"] = cuda_ms(lambda: rmsnorm(x, w, 1e-6), iters * 5,
                                                queued=True)
    for group, fn in (("decode", time_decode), ("verify", time_verify), ("shfl", time_shfl),
                      ("gating", time_gating), ("step", time_verify_step),
                      ("moe_step", time_moe_step)):
        if group in only:
            out.update(fn(iters, gen))
    return out


def ptxas_report(kernel_dir: Path) -> dict:
    """Registers, spills, static shared memory and HMMA instructions of
    each kernel in PTXAS_SOURCES under ``kernel_dir`` (all compiled at
    once, with the build's flags plus -Xptxas -v).  A source missing from
    an older tree is skipped."""
    from repro_torch.kernels import build

    nvcc = build._nvcc()
    tools = Path(nvcc).parent
    report = {}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        procs = []
        for src in (kernel_dir / rel for rel in PTXAS_SOURCES):
            if not src.is_file():
                continue
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(kernel_dir), "-c",
                   str(src), "-o", str(obj)]
            procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        for obj, p in procs:
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"{obj.stem}.cu failed to build:\n{log}")
            kernel = None
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    kernel = f"{obj.stem}.cu: " + _demangle(tools, line.split("'")[1])
                elif kernel and "bytes stack frame" in line:
                    report.setdefault(kernel, {})["spills"] = line.strip()
                elif kernel and "Used" in line and "registers" in line:
                    k = report.setdefault(kernel, {})
                    k["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
                    smem = re.search(r"(\d+) bytes smem", line)
                    k["static_smem"] = int(smem.group(1)) if smem else 0
            sass = subprocess.run([str(tools / "cuobjdump"), "-sass", str(obj)],
                                  capture_output=True, text=True, check=True).stdout
            kernel = None
            for line in sass.splitlines():
                if "Function :" in line:
                    kernel = (f"{obj.stem}.cu: "
                              + _demangle(tools, line.split("Function :")[1].strip()))
                elif kernel and "HMMA" in line:
                    k = report.setdefault(kernel, {})
                    k["hmma"] = k.get("hmma", 0) + 1
    return {k: v for k, v in report.items() if KERNELS.search(k)}


def _demangle(tools: Path, name: str) -> str:
    """``void kernel<T, ...>`` from a mangled name: cu++filt's output
    without its namespace, template argument casts and parameter list."""
    out = subprocess.run([str(tools / "cu++filt"), name], capture_output=True, text=True)
    full = out.stdout.strip() if out.returncode == 0 and out.stdout.strip() else name
    full = re.sub(r"<unnamed>::|\(anonymous namespace\)::|\((?:bool|int)\)", "", full)
    return re.sub(r"\(.*\)$", "", full)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="the package tree's src/ directory")
    ap.add_argument("--iters", type=int, default=20, help="calls timed a matmul case "
                    "(five times as many a rmsnorm case)")
    ap.add_argument("--ptxas", action="store_true",
                    help="also ptxas registers/spills and HMMA counts of the sources")
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=GROUPS,
                    help="time these groups alone")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: these timings need an NVIDIA GPU")
    sys.path.insert(0, a.src)
    row = dict(src=a.src, **time_kernels(a.iters, a.only))
    if a.ptxas:
        row["ptxas"] = ptxas_report(Path(a.src) / "repro_torch" / "kernels")
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
