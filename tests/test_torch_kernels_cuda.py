"""The port's CUDA kernels against their plain versions on the card
(``cuda`` marker: skipped without a GPU), and the no-fallback guards that
run anywhere: the port imports neither JAX nor ``repro``, a non-CPU tensor
never reaches a plain version, a missing nvcc is an error, and the entry
points refuse to drift onto the CPU.  Imports no JAX, so it runs on the
card's machine too."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import requires_cuda  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    flash_decode,
    paged_flash_decode,
)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    flash_decode_ref,
    paged_flash_decode_ref,
)
from repro_torch.kernels.flash_attention.ops import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.testing import paged_decode_case  # noqa: E402


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (on the card only)
# ---------------------------------------------------------------------------

# bf16: both sides accumulate in fp32 and round once to bf16, so they may
# differ by one or two bf16 ulps (2^-8 relative) of the output
CUDA_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


def _cuda(a, dtype):
    return torch.as_tensor(np.asarray(a)).to("cuda", dtype)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 1536), (2048, 1536), (3, 5, 256)])
def test_cuda_rmsnorm_matches_plain(shape, dtype):
    requires_cuda()
    rng = np.random.default_rng(0)
    x, w = _cuda(_rand(rng, *shape), dtype), _cuda(_rand(rng, shape[-1]), dtype)
    before = rmsnorm.launches
    got = rmsnorm(x, w, 1e-6)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    _close(got, rmsnorm_ref(x, w, 1e-6), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,hq,hkv,d,kv_len,causal", [
    (2, 37, 4, 2, 64, [37, 20], True),
    (1, 200, 12, 2, 128, None, True),
    (2, 19, 4, 1, 64, [0, 11], True),
    (2, 21, 4, 2, 128, [21, 6], False),
])
def test_cuda_flash_matches_plain(b, s, hq, hkv, d, kv_len, causal, dtype):
    requires_cuda()
    rng = np.random.default_rng(1)
    q, k, v = (_cuda(_rand(rng, b, s, h, d), dtype) for h in (hq, hkv, hkv))
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32,
                                                    device="cuda")
    o, lse = flash_attention_fwd(q, k, v, lens, causal=causal)
    torch.cuda.synchronize()
    want_o, want_lse = flash_attention_ref(q, k, v, lens, causal=causal)
    _close(o, want_o, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,g", [(64, 4), (128, 6)])
def test_cuda_flash_decode_matches_plain_on_a_strided_view(d, g, dtype):
    requires_cuda()
    rng = np.random.default_rng(2)
    b, smax, hkv, attend = 4, 160, 2, 96
    q = _cuda(_rand(rng, b, hkv, g, d), dtype)
    k = _cuda(_rand(rng, b, smax, hkv, d), dtype)
    v = _cuda(_rand(rng, b, smax, hkv, d), dtype)
    v[:, attend - 8:] = float("nan")               # tail garbage past pos
    pos = torch.tensor([0, 31, 32, attend - 9], dtype=torch.int32, device="cuda")
    kv, vv = k[:, :attend], v[:, :attend]          # strided, not copied
    assert not kv.is_contiguous()
    got = flash_decode(q, kv, vv, pos)
    torch.cuda.synchronize()
    _close(got, flash_decode_ref(q, kv, vv, pos), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_paged_decode_matches_plain(dtype):
    requires_cuda()
    rng = np.random.default_rng(4)
    q, kp, vp, bt, pos = paged_decode_case(rng, d=128, g=6)
    args = [_cuda(a, dtype) for a in (q, kp, vp)]
    bt_c = torch.as_tensor(bt, device="cuda")
    pos_c = torch.as_tensor(pos, device="cuda")
    got = paged_flash_decode(*args, bt_c, pos_c)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close(got, paged_flash_decode_ref(*args, bt_c, pos_c), dtype)
    with pytest.raises(NotImplementedError, match="A9"):
        scales = torch.ones(kp.shape[:2], device="cuda")
        paged_flash_decode(*args, bt_c, pos_c, k_scales=scales, v_scales=scales)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(),
    dict(cache_layout="paged", page_size=8, num_pages=5),   # forces preemption
], ids=["dense", "paged-preempt"])
def test_cuda_serve_through_kernels_matches_cpu_plain_path(kw):
    """The slice as a whole: the engine on the card, every attention and
    norm through its kernel, gives the greedy tokens of the same engine on
    the CPU (plain versions).  Reduced qwen2 in fp32, so the two paths
    differ by summation order only (~1e-6 on logits)."""
    requires_cuda()
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = reduced_config("qwen2-1.5b")
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    params = cpu.init(torch.Generator().manual_seed(0))

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        return tree.to("cuda")

    rng = np.random.default_rng(3)
    spec = [(i, rng.integers(0, cfg.vocab, int(rng.integers(3, 20))).tolist(),
             int(rng.integers(2, 9))) for i in range(6)]

    def serve(model, p):
        eng = ServeEngine(model, p, max_seq=48, batch_slots=3, **kw)
        return eng.serve([Request(u, list(t), n) for u, t, n in spec]), eng

    want, want_eng = serve(cpu, params)
    kernels.reset_launches()
    got, eng = serve(Model(cfg, dtype=torch.float32), to_cuda(params))
    counts = kernels.launch_counts()
    assert got == want
    assert eng.preemptions == want_eng.preemptions
    assert eng.preemptions >= (1 if kw else 0)
    decode = "paged_flash_decode" if kw else "flash_decode"
    for name in ("rmsnorm", "flash_attention_fwd", decode):
        assert counts[name] > 0, name


# ---------------------------------------------------------------------------
# no-fallback guards
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(len(mods))\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": src},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc -> KernelBuildError, and a non-CPU tensor reaches the kernel
    route (never the plain version) even then."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "LIB", build._Library())
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(build.KernelBuildError):
        rmsnorm(x, torch.empty(8, device="meta"))


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.models.lm import Model
    from repro_torch.testing import params_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(reduced_config("qwen2-1.5b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"embed": np.zeros(2)}, device="cuda")
    assert resolve_device("cpu").type == "cpu"
