"""Variants of the port's bf16 flash kernels, built from textual edits of
their sources and measured on one NVIDIA GPU: which part of the design
sets the kernels' distance from the plain versions, and what a tile
choice costs.

    python scripts/flash_variants.py [--grads] [--iters N] VARIANT ...

VARIANT is a name of VARIANTS below, NAME=EDIT[@@EDIT...] with EDIT
``file:old=>new`` (file is fwd, bwd or tc; every occurrence of old is
replaced, and old must occur), or NAME=@TREE for another checkout's
package as it is (e.g. the parent unpacked by ``git archive``).  ``base``,
the sources as they are, is measured first.  Each variant is a copy of
``src/repro_torch`` with its edits under ``build/flash_variants/``
(git-ignored), measured in a process of its own, which builds the copy's
kernels:

- ptxas registers and spills of each tensor-core flash kernel, and its
  static HMMA (tensor-core) instruction count (cuobjdump -sass);
- at B 2 x S 4096, 12/2 heads, D 128, bf16, causal: the forward's error
  against the plain version, the share of its bf16 outputs that round to
  another value and, of those, the share rounded toward zero; the
  backward's (on the forward's o and lse) max error, RMS error relative to
  the plain version's RMS, and shrink (mean of (got - want) * sign(want)
  over mean |want|: below 0 when the kernel's sums come out smaller);
- with --grads, chip_smoke.py's gradient readings: one gradient of
  full-width qwen2-1.5b at S 4096, batch 2, kernel path against plain path;
- the three timings of ``src/repro_torch/bench/flash_ab.py``, and again in
  a second round, the variants in reverse order.

One JSON line a variant and round.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_variants"
FILES = {"fwd": "flash_attention.cu", "bwd": "flash_attention_bwd.cu", "tc": "tc.cuh"}
TC_KERNEL = re.compile(r"flash_(?:fwd|bwd_dq|bwd_dkv)_tc_kernelILi\d+")
SYNC = "    __syncthreads();  // this stage is consumed before the next copy refills it\n"

# An edit is (file, old, new, which): which None replaces every
# occurrence of old, an int only that one (counted from 0).

# the forward's exp2 through the math library's exp2f, not ex2.approx.ftz
EXP2F = [("fwd", "tc::exp2_fast(", "exp2f(", None)]

# every exp2 of both kernels in double precision, rounded once to fp32
EXACT_EXP = [
    ("tc", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
     "y = static_cast<float>(exp2(static_cast<double>(x)));", None),
    ("bwd", "exp2f(", "tc::exp2_fast(", None),
]

# P (forward and backward) and dS as hi + mid + lo: the split's residue
# falls from 2^-18 to 2^-26 of each term
SPLIT3 = r"""// x as hi + mid + lo, each a bf16 pair
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

__device__ __forceinline__ void split3_a(const float (&c0)[4], const float (&c1)[4],
                                         uint32_t (&hi)[4], uint32_t (&mid)[4],
                                         uint32_t (&lo)[4]) {
  split3(c0[0], c0[1], hi[0], mid[0], lo[0]);
  split3(c0[2], c0[3], hi[1], mid[1], lo[1]);
  split3(c1[0], c1[1], hi[2], mid[2], lo[2]);
  split3(c1[2], c1[3], hi[3], mid[3], lo[3]);
}

"""


def _third(acc: str, b: str) -> str:
    return (f"        tc::mma({acc}[dn], t3, {b}[0], {b}[1]);\n"
            f"        tc::mma({acc}[dn + 1], t3, {b}[2], {b}[3]);\n")


P3 = [
    ("tc", "// 2^x on the special function unit alone", SPLIT3 + "// 2^x on the special function unit alone", None),
    ("fwd", "uint32_t ph[4], pl[4];\n      tc::split_a(s[2 * kk], s[2 * kk + 1], ph, pl);",
     "uint32_t ph[4], pl[4], t3[4];\n      tc::split3_a(s[2 * kk], s[2 * kk + 1], ph, pl, t3);", None),
    ("fwd", "        tc::mma(acc[dn + 1], pl, bv[2], bv[3]);\n",
     "        tc::mma(acc[dn + 1], pl, bv[2], bv[3]);\n" + _third("acc", "bv"), None),
    ("bwd", "uint32_t hi[4], lo[4];\n      tc::split_a(s[2 * kk], s[2 * kk + 1], hi, lo);",
     "uint32_t hi[4], lo[4], t3[4];\n      tc::split3_a(s[2 * kk], s[2 * kk + 1], hi, lo, t3);", None),
    ("bwd", "        tc::mma(acc[dn + 1], lo, bk[2], bk[3]);\n",
     "        tc::mma(acc[dn + 1], lo, bk[2], bk[3]);\n" + _third("acc", "bk"), None),
    ("bwd", "uint32_t hi[4], lo[4];\n      tc::split_a(st[2 * kq], st[2 * kq + 1], hi, lo);",
     "uint32_t hi[4], lo[4], t3[4];\n      tc::split3_a(st[2 * kq], st[2 * kq + 1], hi, lo, t3);", None),
    ("bwd", "        tc::mma(dva[dn + 1], lo, bd[2], bd[3]);\n",
     "        tc::mma(dva[dn + 1], lo, bd[2], bd[3]);\n" + _third("dva", "bd"), None),
    ("bwd", "tc::split_a(dpt[2 * kq], dpt[2 * kq + 1], hi, lo);",
     "tc::split3_a(dpt[2 * kq], dpt[2 * kq + 1], hi, lo, t3);", None),
    ("bwd", "        tc::mma(dka[dn + 1], lo, bq[2], bq[3]);\n",
     "        tc::mma(dka[dn + 1], lo, bq[2], bq[3]);\n" + _third("dka", "bq"), None),
]

# the second products' tensor-core sums start from 0 in every tile, and
# the running sums O, dq, dk, dv take each tile's by an fp32 add
FOLD = "#pragma unroll\n    for (int dt = 0; dt < ND; ++dt)\n#pragma unroll\n"
FADD = [
    ("fwd", "    // O += P V with P = hi + lo", "    float pv[ND][4] = {};\n    // O += P V with P = hi + lo", None),
    ("fwd", "tc::mma(acc[dn", "tc::mma(pv[dn", None),
    ("fwd", SYNC, FOLD + "      for (int e = 0; e < 4; ++e) acc[dt][e] += pv[dt][e];\n" + SYNC,
     None),
    ("bwd", "    // dq += dS K with dS = hi + lo", "    float pv[ND][4] = {};\n    // dq += dS K with dS = hi + lo", None),
    ("bwd", "tc::mma(acc[dn", "tc::mma(pv[dn", None),
    ("bwd", SYNC, FOLD + "      for (int e = 0; e < 4; ++e) acc[dt][e] += pv[dt][e];\n" + SYNC,
     0),
    ("bwd", "    // dv += P^T dO and dk += dS^T Q",
     "    float dvt[ND][4] = {}, dkt[ND][4] = {};\n    // dv += P^T dO and dk += dS^T Q", None),
    ("bwd", "tc::mma(dva[dn", "tc::mma(dvt[dn", None),
    ("bwd", "tc::mma(dka[dn", "tc::mma(dkt[dn", None),
    ("bwd", SYNC, FOLD + "      for (int e = 0; e < 4; ++e) {\n"
                  "        dva[dt][e] += dvt[dt][e];\n"
                  "        dka[dt][e] += dkt[dt][e];\n"
                  "      }\n" + SYNC, 1),
]

VARIANTS = {
    "exp2f": EXP2F,
    "exact-exp": EXACT_EXP,
    "p3": P3,
    "fadd": FADD,
    "p3+exact-exp+fadd": P3 + EXACT_EXP + FADD,
}


def parse_spec(spec: str):
    """A VARIANTS name, or NAME=file:old=>new@@... -> (name, edits)."""
    if spec in VARIANTS:
        return spec, VARIANTS[spec]
    name, _, rest = spec.partition("=")
    if rest.startswith("@"):
        return name, Path(rest[1:]).resolve()
    edits = []
    for edit in filter(None, rest.split("@@")):
        which, body = edit.split(":", 1)
        old, new = body.split("=>", 1)
        edits.append((which, old, new, None))
    if not edits:
        raise ValueError(f"{spec!r} is neither a known variant nor NAME=EDIT...")
    return name, edits


def make_copy(name: str, edits) -> Path:
    """``src/repro_torch`` under OUT/name/src with the edits applied; each
    ``old`` must occur (its ``which``-th occurrence, where given).  Edits
    that are a path copy that tree's package unedited."""
    dest = OUT / name
    shutil.rmtree(dest, ignore_errors=True)
    pkg = dest / "src" / "repro_torch"
    tree = edits if isinstance(edits, Path) else ROOT
    shutil.copytree(tree / "src" / "repro_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    if tree is not ROOT:
        return dest
    kdir = pkg / "kernels" / "flash_attention"
    texts = {f: (kdir / n).read_text() for f, n in FILES.items()}
    for f, old, new, which in edits:
        text = texts[f]
        n = text.count(old)
        if n == 0 or (which is not None and which >= n):
            raise ValueError(f"variant {name}: {old!r} occurs {n} times in {FILES[f]}")
        if which is None:
            texts[f] = text.replace(old, new)
        else:
            at = -1
            for _ in range(which + 1):
                at = text.index(old, at + 1)
            texts[f] = text[:at] + new + text[at + len(old):]
    for f, n in FILES.items():
        (kdir / n).write_text(texts[f])
    return dest


def start_ptxas(dest: Path):
    """nvcc -Xptxas -v of the copy's two flash sources, started."""
    from repro_torch.kernels import build

    kdir = dest / "src" / "repro_torch" / "kernels"
    procs = []
    for n in FILES["fwd"], FILES["bwd"]:
        obj = dest / (n + ".o")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(kdir),
               "-c", str(kdir / "flash_attention" / n), "-o", str(obj)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    return procs


def ptxas_report(procs) -> dict:
    """Registers, spills and HMMA instructions of each tensor-core kernel."""
    from repro_torch.kernels import build

    cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
    report = {}
    for obj, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{obj.name} failed to build:\n{log}")
        kernel = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                found = TC_KERNEL.search(line)
                kernel = found.group(0) if found else None
            elif kernel and "bytes stack frame" in line:
                report.setdefault(kernel, {})["spills"] = line.strip()
            elif kernel and "Used" in line and "registers" in line:
                report.setdefault(kernel, {})["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
        sass = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True,
                              text=True, check=True).stdout
        kernel = None
        for line in sass.splitlines():
            if "Function :" in line:
                found = TC_KERNEL.search(line)
                kernel = found.group(0) if found else None
            elif kernel and "HMMA" in line:
                k = report.setdefault(kernel, {})
                k["hmma"] = k.get("hmma", 0) + 1
    return report


def _errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    diff = got - want
    return dict(max_err=diff.abs().max().item(),
                rms_rel_err=(diff.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item(),
                shrink=((diff * want.sign()).mean() / want.abs().mean()).item())


def numerics(grads: bool) -> dict:
    """The flash kernels' errors at the training shape and, with
    ``grads``, chip_smoke.py's gradient readings, for the imported package."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(h):
        return torch.randn(2, 4096, h, 128, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, do = randn(12), randn(2), randn(2), randn(12)
    o, lse = flash_attention_fwd(q, k, v)
    o_ref, lse_ref = flash_attention_ref(q, k, v)
    flipped = o != o_ref
    toward_zero = o.float().abs() < o_ref.float().abs()
    out = dict(fwd_max_err=(o.float() - o_ref.float()).abs().max().item(),
               lse_max_err=(lse - lse_ref).abs().max().item(),
               fwd_flipped_share=flipped.double().mean().item(),
               fwd_flips_toward_zero=(toward_zero & flipped).sum().item()
               / max(1, flipped.sum().item()))
    del o_ref, lse_ref
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    got = flash_attention_bwd(q, k, v, do, lse, delta)
    want = flash_attention_bwd_ref(q, k, v, do, lse, delta)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        out.update({f"{name}_{key}": val for key, val in _errors(g, w).items()})
    del q, k, v, do, o, lse, delta, got, want
    torch.cuda.empty_cache()
    if grads:
        out.update(grad_readings())
    return out


def grad_readings() -> dict:
    """chip_smoke.py's sound gradient check: its seed, batch and readings."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.lm import Model
    from repro_torch.train.step import make_grad_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(smoke.ARCH)
    kw = dict(device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32)
    model = Model(cfg, **kw)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=smoke.TRAIN_SEQ,
                                        global_batch=smoke.TRAIN_BATCH, seed=0))
    batch = {k: v.cuda() for k, v in data.batch_at(0).items()}

    def grads(m):
        loss, g = make_grad_fn(m, vocab_chunks=smoke.VOCAB_CHUNKS)(params, batch)
        return loss.item(), g

    p_loss, p_grads = grads(Model(cfg, use_kernels=False, **kw))
    r = smoke.grad_readings(*grads(model), p_loss, p_grads)
    keep = ("loss_diff", "grad_norm_rel_diff", "min_cosine", "min_cosine_leaf",
            "max_leaf_rel_diff", "max_leaf_rel_diff_leaf")
    return dict({f"grad_{k}": r[k] for k in keep}, grad_gates_tripped=smoke.tripped_gates(r))


def child(dest: Path, grads: bool, times_only: bool, iters: int):
    sys.path.insert(0, str(dest / "src"))
    sys.path.insert(1, str(ROOT / "src" / "repro_torch" / "bench"))
    from flash_ab import time_kernels  # this tree's, timing the copy's package
    from repro_torch.kernels import build

    build.LIB.load()
    out = dict(variant=dest.name, **time_kernels(iters))
    if not times_only:
        out.update(numerics(grads))
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--grads", action="store_true",
                    help="also chip_smoke.py's gradient readings (full width)")
    ap.add_argument("--iters", type=int, default=20, help="calls timed at B 2 x S 4096")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--times-only", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    if a.child:
        child(a.child, a.grads, a.times_only, a.iters)
        return
    sys.path.insert(0, str(ROOT / "src"))
    named = [("base", [])] + [parse_spec(s) for s in a.variants]
    dests = [make_copy(name, edits) for name, edits in named]
    procs = {d.name: start_ptxas(d) for d in dests}
    for name, p in procs.items():
        print(json.dumps(dict(variant=name, ptxas=ptxas_report(p))), flush=True)

    def run(d, *flags):
        subprocess.run([sys.executable, __file__, "--child", str(d), "--iters", str(a.iters),
                        *flags], check=True)

    for d in dests:
        run(d, *(["--grads"] if a.grads else []))
    for d in reversed(dests):
        run(d, "--times-only")


if __name__ == "__main__":
    main()
