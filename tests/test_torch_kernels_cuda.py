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

from repro_torch.bench import pr_transform_bench as prb  # noqa: E402
from repro_torch.core.warp import WarpConfig  # noqa: E402
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
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_bwd,
    flash_attention_fwd,
    flash_mha,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from repro_torch.kernels.matmul.ops import matmul  # noqa: E402
from repro_torch.kernels.moe_gating.ops import moe_gating  # noqa: E402
from repro_torch.kernels.moe_gating.ref import (  # noqa: E402
    moe_gating_rank_ref,
    moe_gating_ref,
)
from repro_torch.kernels.matmul.ref import (  # noqa: E402
    matmul_1xtf32_emulated,
    matmul_ref,
)
from repro_torch.kernels.mse.ops import mse_partial_sum  # noqa: E402
from repro_torch.kernels.mse.ref import mse_partial_sum_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.tile_reduce.ops import tile_reduce  # noqa: E402
from repro_torch.kernels.tile_reduce.ref import tile_reduce_ref  # noqa: E402
from repro_torch.kernels.verify_attention.ops import (  # noqa: E402
    paged_flash_verify,
    verify_splits,
)
from repro_torch.kernels.verify_attention.ref import (  # noqa: E402
    paged_flash_verify_split_emulated,
    paged_verify_attention_ref,
)
from repro_torch.kernels.warp_ops.ops import shfl, vote  # noqa: E402
from repro_torch.kernels.warp_ops.ref import shfl_ref, vote_ref  # noqa: E402
from repro_torch.serve.kv_cache import (  # noqa: E402
    dequantize_kv,
    quantize_kv_rows,
    swap_in_pages,
    swap_out_pages,
)
from repro_torch.testing import (  # noqa: E402
    VERIFY_SPLIT_NB,
    VERIFY_SPLIT_PAGE,
    paged_decode_case,
    paged_verify_case,
    quantized_pool_from_numpy,
    verify_long_case,
    verify_split_case,
)


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


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    return tree.to("cuda")


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
    # OLMoE's 16/16 heads (G = 1) at exact, odd MoE prefill lengths
    (1, 82, 16, 16, 128, None, True),
    (1, 300, 16, 16, 128, None, True),
    # the main path's shapes: many key tiles, a partly masked diagonal
    # tile and kv_len inside a tile; serving prefill
    (2, 1024, 12, 2, 128, [1024, 700], True),
    (4, 512, 12, 2, 128, None, True),
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


# MLA's (D, Dv) = (96, 64) instance: MiniCPM3's q/k heads of 64 nope + 32
# rope dims over v heads of 64, v a strided view into the (.., nope + v)
# row of the decompressed latent, as the model passes it
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,kv_len,causal", [
    (2, 37, 4, [37, 20], True),       # ragged S, kv_len inside a tile
    (2, 21, 4, [21, 6], False),
    (1, 200, 40, None, True),         # MiniCPM3's 40 heads
    (4, 512, 40, None, True),         # its serving prefill
])
def test_cuda_flash_dv_branch_matches_plain(b, s, h, kv_len, causal, dtype):
    requires_cuda()
    rng = np.random.default_rng(21)
    q, k = (_cuda(_rand(rng, b, s, h, 96), dtype) for _ in "qk")
    v = _cuda(_rand(rng, b, s, h, 128), dtype)[..., 64:]
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32,
                                                    device="cuda")
    counter = "launches_dv" if dtype == torch.bfloat16 else "launches_dv_f32"
    others = ("launches", "launches_f32")
    before = [getattr(flash_attention_fwd, c) for c in (counter, *others)]
    o, lse = flash_attention_fwd(q, k, v, lens, causal=causal)
    torch.cuda.synchronize()
    after = [getattr(flash_attention_fwd, c) for c in (counter, *others)]
    assert after == [before[0] + 1, *before[1:]]
    assert o.shape == (b, s, h, 64) and o.dtype == dtype
    want_o, want_lse = flash_attention_ref(q, k, v, lens, causal=causal)
    _close(o, want_o, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_refuses_unbuilt_head_dims(dtype):
    """A (D, Dv) pair without an instance, such as (48, 32), raises
    ``ValueError`` in the forward and in the backward, before any launch."""
    requires_cuda()
    from repro_torch import kernels

    rng = np.random.default_rng(22)
    q, k = (_cuda(_rand(rng, 1, 16, 2, 48), dtype) for _ in "qk")
    v, do = (_cuda(_rand(rng, 1, 16, 2, 32), dtype) for _ in "vo")
    lse, delta = (torch.zeros(1, 2, 16, device="cuda") for _ in "ld")
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="value head"):
        flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="value head"):
        flash_attention_bwd(q, k, v, do, lse, delta)
    assert kernels.launch_counts() == before


def _dv_bwd_case(rng, b, s, hq, hkv, kv_len, causal, dtype, strided):
    """The backward's inputs at MLA's (96, 64): q/k heads of 96, v and dO
    of 64; with ``strided`` v is a view into a (.., 64 + 64) row at column
    64, as ``mla_block_kv`` passes it.  K/V rows past kv_len hold NaN."""
    q, do = _cuda(_rand(rng, b, s, hq, 96), dtype), _cuda(_rand(rng, b, s, hq, 64), dtype)
    k, v = _rand(rng, b, s, hkv, 96), _rand(rng, b, s, hkv, 128 if strided else 64)
    lens = None
    if kv_len is not None:
        for i, n in enumerate(kv_len):
            k[i, n:], v[i, n:] = np.nan, np.nan
        lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    k, v = _cuda(k, dtype), _cuda(v, dtype)
    if strided:
        v = v[..., 64:]
    o, lse = flash_attention_fwd(q, k, v, lens, causal=causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, lens


# MLA training's backward, the (96, 64) instance: G = 1 (MiniCPM3) and G >
# 1 (the group sum over Dv columns), causal and not, kv_len inside a tile,
# v strided as the model passes it or contiguous
DV_BWD_CASES = [
    (2, 37, 4, 4, [37, 20], True, True),
    (2, 21, 4, 2, [21, 6], False, False),
    (2, 45, 8, 2, [45, 9], False, True),
    (2, 64, 6, 1, None, True, True),
    (1, 200, 40, 40, None, True, True),
    (2, 1024, 40, 40, [1024, 700], True, True),
]
DV_BWD_IDS = ["g1-ragged-len", "g2-noncausal-len", "g4-noncausal-len-strided",
              "g6-whole-tiles", "minicpm3-heads", "minicpm3-s1024-len"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,hq,hkv,kv_len,causal,strided", DV_BWD_CASES, ids=DV_BWD_IDS)
def test_cuda_flash_bwd_dv_branch_matches_plain(b, s, hq, hkv, kv_len, causal, strided,
                                                dtype):
    """The backward's (96, 64) instance against its plain version: dq of
    96 columns, dk of 96 and dv of 64, each KV head's group summed; only
    the dtype branch's ``[dv]`` counter moves."""
    requires_cuda()
    from repro_torch import kernels

    rng = np.random.default_rng(31)
    args = _dv_bwd_case(rng, b, s, hq, hkv, kv_len, causal, dtype, strided)
    moved = "flash_attention_bwd[dv]" if dtype == torch.bfloat16 else \
        "flash_attention_bwd[dv,f32]"
    before = kernels.launch_counts()
    got = flash_attention_bwd(*args, causal=causal)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {moved: 1}
    want = flash_attention_bwd_ref(*args, causal=causal)
    for name, g, w, width in zip(("dq", "dk", "dv"), got, want, (96, 96, 64)):
        assert g.dtype == torch.float32 and g.shape[-1] == width, name
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, **BWD_TOL, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_bwd_dv_branch_is_deterministic(dtype):
    """No atomics at (96, 64) either: two calls give the same bits."""
    requires_cuda()
    rng = np.random.default_rng(32)
    args = _dv_bwd_case(rng, 2, 1024, 8, 2, [1024, 700], True, dtype, True)
    first = flash_attention_bwd(*args)
    second = flash_attention_bwd(*args)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b_), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv_len,causal", [(None, True), ([29, 12], False)])
def test_cuda_flash_mha_grads_at_mla_dims_match_cpu_plain_path(kv_len, causal, dtype):
    """``flash_mha``'s output and gradients at (96, 64) on the card (both
    kernels' (96, 64) instances; v a strided view) against the same
    Function on the CPU (both plain versions) on the same values."""
    requires_cuda()
    rng = np.random.default_rng(33)
    q, k = _rand(rng, 2, 29, 4, 96), _rand(rng, 2, 29, 4, 96)
    kv = _rand(rng, 2, 29, 4, 128)
    g = _rand(rng, 2, 29, 4, 64)
    lens = None if kv_len is None else np.asarray(kv_len, np.int32)

    def grads(device):
        leaves = [torch.tensor(a, device=device).to(dtype).requires_grad_()
                  for a in (q, k, kv)]
        ln = None if lens is None else torch.tensor(lens, device=device)
        o = flash_mha(leaves[0], leaves[1], leaves[2][..., 64:], ln, causal=causal)
        o.backward(torch.tensor(g, device=device).to(dtype))
        return [o.detach().cpu()] + [t.grad.cpu() for t in leaves]

    counter = "launches_dv" if dtype == torch.bfloat16 else "launches_dv_f32"
    before = getattr(flash_attention_bwd, counter), getattr(flash_attention_fwd, counter)
    got = grads("cuda")
    assert (getattr(flash_attention_bwd, counter), getattr(flash_attention_fwd, counter)) \
        == (before[0] + 1, before[1] + 1)
    want = grads("cpu")
    assert (got[3][..., :64] == 0).all()            # the nope half of kv gets no v gradient
    tol = BWD_TOL if dtype == torch.float32 else CUDA_TOL[dtype]
    for name, a, b_ in zip(("o", "dq", "dk", "dkv"), got, want):
        torch.testing.assert_close(a.float(), b_.float(), **tol, msg=name)


@pytest.mark.cuda
def test_cuda_mla_train_steps_match_cpu_plain_path():
    """MLA training as a whole at MiniCPM3's head dims (nope 64, rope 32, v
    64; ranks and depth cut): three Trainer steps on the card, the latent
    norms through rmsnorm and attention through both (96, 64) flash
    instances (forward, remat recompute, backward), against the same
    steps on the CPU's plain versions, fp32 from the same weights and
    batches (tolerances of ``test_cuda_train_steps_match_cpu_plain_path``)."""
    requires_cuda()
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.step import TrainState
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(reduced_config("minicpm3-4b"), n_layers=2,
                              qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64)
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=48, global_batch=2,
                                        seed=4))
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    base = Model(cfg, device="cpu", dtype=torch.float32).init(
        torch.Generator().manual_seed(0))

    def run(device, params):       # the steps update params in place
        model = Model(cfg, device=device, dtype=torch.float32)
        tr = Trainer(model, data, opt, TrainerConfig(total_steps=3, vocab_chunks=4))
        _, hist = tr.run(start_state=TrainState(params, init_adamw(params)))
        return [m["loss"] for _, m in hist]

    kernels.reset_launches()
    got = run("cuda", _to_cuda(base))
    counts = kernels.launch_counts()
    want = run("cpu", base)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert counts["flash_attention_bwd[dv,f32]"] == 3 * cfg.n_layers
    assert counts["flash_attention_fwd[dv,f32]"] == 2 * 3 * cfg.n_layers   # with remat
    assert not any(counts[n] for n in ("flash_attention_fwd", "flash_attention_bwd",
                                       "flash_attention_fwd[f32]", "flash_attention_bwd[f32]",
                                       "flash_attention_fwd[dv]", "flash_attention_bwd[dv]"))
    assert counts["rmsnorm"] > 0


@pytest.mark.cuda
def test_cuda_mla_serving_matches_cpu_plain_path():
    """MLA serving on the card at MiniCPM3's head dims (nope 64, rope 32,
    v 64; ranks and depth cut), fp32: prefill through the f32 (96, 64)
    flash instance, decode's latent einsums and the latent norms through
    rmsnorm, greedy engine tokens (captured steps) equal to the CPU's
    plain versions on the same weights, and prefill logits within fp32
    summation order."""
    requires_cuda()
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(reduced_config("minicpm3-4b"), n_layers=2,
                              qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64)
    base = Model(cfg, device="cpu", dtype=torch.float32).init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(23)
    spec = [(i, rng.integers(0, cfg.vocab, int(n)).tolist(), 6)
            for i, n in enumerate(rng.integers(5, 40, 4))]
    toks = torch.tensor([spec[0][1]])

    def run(device, params):
        model = Model(cfg, device=device, dtype=torch.float32)
        logits, _ = model.prefill(params, toks, 64)
        eng = ServeEngine(model, params, max_seq=64, batch_slots=2)
        return logits.cpu(), eng.serve([Request(u, list(p), n) for u, p, n in spec])

    kernels.reset_launches()
    got_logits, got = run("cuda", _to_cuda(base))
    counts = kernels.launch_counts()
    want_logits, want = run("cpu", base)
    assert got == want
    torch.testing.assert_close(got_logits, want_logits, atol=1e-4, rtol=1e-4)
    assert counts["flash_attention_fwd[dv,f32]"] > 0 and counts["rmsnorm"] > 0
    assert counts["flash_attention_fwd"] == counts["flash_attention_fwd[f32]"] == 0
    assert counts["flash_attention_fwd[dv]"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1536), (2048, 1536), (3, 5, 256)])
def test_cuda_rmsnorm_fp32_weight_under_bf16_rows(shape):
    """Training's fp32 master weight under bf16 activations: the kernel
    multiplies by w in fp32, as the plain version does."""
    requires_cuda()
    rng = np.random.default_rng(2)
    x = _cuda(_rand(rng, *shape), torch.bfloat16)
    w = _cuda(_rand(rng, shape[-1]), torch.float32)
    before = rmsnorm.launches
    got = rmsnorm(x, w, 1e-6)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1 and got.dtype == torch.bfloat16
    _close(got, rmsnorm_ref(x, w, 1e-6), torch.bfloat16)


def _rmsnorm_branch(x, w):
    """rmsnorm(x, w) and the branch whose counter moved (exactly one, by 1)."""
    counters = ("launches", "launches_wide", "launches_ragged")
    before = [getattr(rmsnorm, c) for c in counters]
    got = rmsnorm(x, w, 1e-6)
    torch.cuda.synchronize()
    moved = tuple(getattr(rmsnorm, c) - b for c, b in zip(counters, before))
    assert sorted(moved) == [0, 0, 1], moved
    return got, ("warp", "wide", "ragged")[moved.index(1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,w_f32,branch", [
    ((512, 2048), False, "warp"),     # OLMoE's d_model: 8 bf16 vectors a lane
    ((8192, 1536), True, "warp"),     # training: rows under an fp32 weight
    ((33, 1024), False, "warp"),      # Granite-MoE's d_model
    ((5, 264), False, "warp"),        # lanes holding unequal numbers of vectors
    ((37, 70), False, "ragged"),      # not a whole number of 16-byte vectors
    ((64, 1538), False, "ragged"),
    ((16, 4096), False, "wide"),      # wider than one warp a row holds
    ((4, 5120), False, "wide"),       # Qwen1.5-32B's decode rows
    ((2048, 5120), False, "wide"),    # its 4 x 512 prefill
    ((2048, 2560), False, "wide"),    # MiniCPM3-4B's prefill
    ((8192, 2560), True, "wide"),     # its training rows under an fp32 weight
    ((3, 8192), False, "wide"),       # the widest the branch holds
    ((5, 2056), False, "wide"),       # threads holding unequal numbers of vectors
    ((2, 8200), False, "ragged"),     # wider than the wide branch holds
])
def test_cuda_rmsnorm_branches_match_plain(shape, w_f32, branch, dtype):
    """Which branch each width takes, and each against the plain version."""
    requires_cuda()
    rng = np.random.default_rng(shape[-1])
    x = _cuda(_rand(rng, *shape), dtype)
    w = _cuda(_rand(rng, shape[-1]), torch.float32 if w_f32 else dtype)
    got, ran = _rmsnorm_branch(x, w)
    assert ran == branch and got.dtype == dtype and got.shape == x.shape
    _close(got, rmsnorm_ref(x, w, 1e-6), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,aligned", [(1536, "warp"), (5120, "wide")])
def test_cuda_rmsnorm_offset_views(d, aligned, dtype):
    """A contiguous view whose base sits one element into its storage is
    not 16-byte aligned (ragged branch); one whole row in, it is (the
    width's warp or wide branch)."""
    requires_cuda()
    n = 300
    flat = _cuda(_rand(np.random.default_rng(7), (n + 2) * d), dtype)
    w = _cuda(_rand(np.random.default_rng(8), d), dtype)
    for offset, branch in ((1, "ragged"), (d, aligned)):
        x = flat[offset:offset + n * d].view(n, d)
        got, ran = _rmsnorm_branch(x, w)
        assert ran == branch
        _close(got, rmsnorm_ref(x, w, 1e-6), dtype)


@pytest.mark.cuda
def test_cuda_rmsnorm_wide_branch_counts_in_graph_replays():
    """A captured call of the wide branch: each replay writes what the
    eager call does and adds its launch to ``rmsnorm[wide]``."""
    requires_cuda()
    from repro_torch import kernels
    from repro_torch.serve.step_graph import StepGraphs

    rng = np.random.default_rng(5120)
    x = _cuda(_rand(rng, 4, 5120), torch.bfloat16)
    w = _cuda(_rand(rng, 5120), torch.bfloat16)
    want = rmsnorm(x, w, 1e-6)
    graphs = StepGraphs("cuda", enabled=True)
    graphs.run("wide", lambda: rmsnorm(x, w, 1e-6))   # captured, then replayed once
    kernels.reset_launches()
    for _ in range(3):
        got = graphs.run("wide", lambda: rmsnorm(x, w, 1e-6))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    counts = kernels.launch_counts()
    assert counts["rmsnorm[wide]"] == 3 and graphs.replays == 4
    assert counts["rmsnorm"] == counts["rmsnorm[ragged]"] == 0


# the backward's outputs are f32 on both sides, from the same inputs (bf16
# ones widened exactly): sums over up to 200 keys or 6 x 200 rows taken in
# another order, and expf against torch.exp, leave ~1e-6 relative
BWD_TOL = dict(atol=1e-4, rtol=1e-4)


def _bwd_case(rng, b, sq, skv, hq, hkv, d, kv_len, causal, dtype):
    """(q, k, v, do, lse, delta, lens) on the card: K/V rows past kv_len
    poisoned with NaN (no kernel may read them), lse from the forward
    kernel, delta = rowsum(dO * O)."""
    q, do = (_cuda(_rand(rng, b, sq, hq, d), dtype) for _ in "qo")
    k, v = (_rand(rng, b, skv, hkv, d) for _ in "kv")
    lens = None
    if kv_len is not None:
        for i, n in enumerate(kv_len):
            k[i, n:], v[i, n:] = np.nan, np.nan
        lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    k, v = _cuda(k, dtype), _cuda(v, dtype)
    o, lse = flash_attention_fwd(q, k, v, lens, causal=causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,kv_len,causal", [
    (2, 37, 37, 4, 2, 64, [37, 20], True),      # G 2, ragged S, kv_len
    (1, 200, 200, 12, 2, 128, None, True),      # the model's G 6, D 128
    (2, 19, 19, 4, 4, 64, [0, 11], True),       # G 1; a row with no key
    (2, 21, 21, 6, 1, 128, [21, 6], False),     # G 6, non-causal
    (2, 17, 45, 4, 2, 64, [45, 9], False),      # non-causal, Sq != Skv
    (1, 64, 64, 6, 1, 128, None, False),        # whole tiles, non-causal
    (2, 1024, 1024, 12, 2, 128, [1024, 700], True),  # many tiles, kv_len in a tile
    (4, 512, 512, 12, 2, 128, None, True),      # serving prefill's shape
], ids=["g2-ragged-len", "g6-d128", "g1-empty-row", "g6-noncausal-len",
        "noncausal-rect", "g6-noncausal", "g6-s1024-len", "prefill-4x512"])
def test_cuda_flash_bwd_matches_plain(b, sq, skv, hq, hkv, d, kv_len, causal, dtype):
    requires_cuda()
    rng = np.random.default_rng(11)
    args = _bwd_case(rng, b, sq, skv, hq, hkv, d, kv_len, causal, dtype)
    # each dtype branch counts its own launches
    counter = "launches" if dtype == torch.bfloat16 else "launches_f32"
    before = getattr(flash_attention_bwd, counter)
    got = flash_attention_bwd(*args, causal=causal)
    torch.cuda.synchronize()
    assert getattr(flash_attention_bwd, counter) == before + 1
    want = flash_attention_bwd_ref(*args, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, **BWD_TOL, msg=name)


@pytest.mark.cuda
def test_cuda_flash_bwd_refuses_what_it_cannot_take():
    requires_cuda()
    rng = np.random.default_rng(12)
    q, k, v, do, lse, delta, _ = _bwd_case(rng, 1, 8, 8, 2, 1, 64, None, True,
                                           torch.float32)
    with pytest.raises(TypeError):
        flash_attention_bwd(q, k, v, do.to(torch.bfloat16), lse, delta)
    with pytest.raises(ValueError, match="contiguous float32"):
        flash_attention_bwd(q, k, v, do, lse, delta.double())
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_bwd(*(t[..., :32] for t in (q, k, v, do)), lse, delta)


@pytest.mark.cuda
def test_cuda_flash_bf16_bwd_is_deterministic():
    """No atomics: two backward calls on the same inputs give the same bits
    (the G per-query-head dk/dv partials are summed in a fixed order)."""
    requires_cuda()
    rng = np.random.default_rng(16)
    args = _bwd_case(rng, 2, 1024, 1024, 12, 2, 128, [1024, 700], True,
                     torch.bfloat16)
    first = flash_attention_bwd(*args)
    second = flash_attention_bwd(*args)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b_), name


@pytest.mark.cuda
def test_cuda_flash_bf16_refuses_a_misaligned_view():
    """The bf16 kernels stage rows with 16-byte copies: a view whose base
    is one element off raises instead of reading astray."""
    requires_cuda()
    rng = np.random.default_rng(17)
    q, k, v, do, lse, delta, _ = _bwd_case(rng, 1, 16, 16, 2, 1, 64, None, True,
                                           torch.bfloat16)
    buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_fwd(shifted, k, v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd(shifted, k, v, do, lse, delta)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len,causal", [(None, True), ([29, 12], False)])
def test_cuda_flash_attention_grads_match_cpu_plain_path(kv_len, causal):
    """FlashAttention's gradients on the card (both kernels) against the
    same Function on the CPU (both plain versions), f32."""
    requires_cuda()
    rng = np.random.default_rng(13)
    q = _rand(rng, 2, 29, 6, 64)
    k, v = _rand(rng, 2, 29, 2, 64), _rand(rng, 2, 29, 2, 64)
    g = _rand(rng, 2, 29, 6, 64)
    lens = None if kv_len is None else np.asarray(kv_len, np.int32)

    def grads(device):
        ts = [torch.tensor(a, device=device, requires_grad=True) for a in (q, k, v)]
        ln = None if lens is None else torch.tensor(lens, device=device)
        o = flash_mha(*ts, ln, causal=causal)
        o.backward(torch.tensor(g, device=device))
        return [o.detach().cpu()] + [t.grad.cpu() for t in ts]

    before = flash_attention_bwd.launches_f32
    got = grads("cuda")
    assert flash_attention_bwd.launches_f32 == before + 1
    for a, b_ in zip(got, grads("cpu")):
        torch.testing.assert_close(a, b_, **BWD_TOL)


@pytest.mark.cuda
def test_cuda_train_steps_match_cpu_plain_path():
    """The training slice as a whole: three reduced-qwen2 Trainer steps on
    the card, every norm and attention (forward, remat recompute,
    backward) through its kernel, against the same steps on the CPU's
    plain versions, fp32 from the same weights and batches.  The paths
    differ by summation order (~1e-6 on the loss); AdamW then amplifies
    gradient differences on near-zero moments, so later losses get 1e-4."""
    requires_cuda()
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.step import TrainState
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = reduced_config("qwen2-1.5b")
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=48, global_batch=2,
                                        seed=4))
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)

    base = Model(cfg, device="cpu", dtype=torch.float32).init(
        torch.Generator().manual_seed(0))

    def run(device, params):       # the steps update params in place
        model = Model(cfg, device=device, dtype=torch.float32)
        tr = Trainer(model, data, opt, TrainerConfig(total_steps=3, vocab_chunks=4))
        _, hist = tr.run(start_state=TrainState(params, init_adamw(params)))
        return [m["loss"] for _, m in hist]

    kernels.reset_launches()
    got = run("cuda", _to_cuda(base))
    counts = kernels.launch_counts()
    want = run("cpu", base)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # fp32: the f32 branch of both flash kernels, never the bf16 one
    assert counts["flash_attention_bwd[f32]"] == 3 * cfg.n_layers
    assert counts["flash_attention_fwd[f32]"] == 2 * 3 * cfg.n_layers   # with remat
    assert counts["flash_attention_fwd"] == counts["flash_attention_bwd"] == 0
    assert counts["rmsnorm"] > 0


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
    with pytest.raises(ValueError, match="both"):
        scales = torch.ones(kp.shape[:2], device="cuda")
        paged_flash_decode(*args, bt_c, pos_c, k_scales=scales)


def _verify_args(t, g, d, dtype, seed=5, **kw):
    q, kp, vp, bt, pos = paged_verify_case(np.random.default_rng(seed), t=t,
                                           g=g, d=d, **kw)
    return ([_cuda(a, dtype) for a in (q, kp, vp)]
            + [torch.as_tensor(a, device="cuda") for a in (bt, pos)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 6])
@pytest.mark.parametrize("t", [1, 2, 4])
def test_cuda_paged_verify_matches_plain(t, g, d, dtype):
    """Garbage (1e6 keys, NaN values) in the trash page, in the rows past
    a window's last position and in a stale mapping past it; one slot's
    window ends on the table's last position and one runs past it."""
    requires_cuda()
    args = _verify_args(t, g, d, dtype)
    before = paged_flash_verify.launches
    got = paged_flash_verify(*args, t_window=t)
    torch.cuda.synchronize()
    assert paged_flash_verify.launches == before + 1
    assert got.shape == args[0].shape and torch.isfinite(got).all()
    _close(got, paged_verify_attention_ref(*args, t), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_paged_verify_row_limit(dtype):
    """T*G = 32 rows (6 row blocks of the split kernel) is the largest the
    split kernel takes; 33 rows go to the long-window branch, and both
    agree with the plain version."""
    requires_cuda()
    args = _verify_args(4, 8, 128, dtype, hkv=1)
    before = paged_flash_verify.launches
    got = paged_flash_verify(*args, t_window=4)
    torch.cuda.synchronize()
    assert paged_flash_verify.launches == before + 1
    _close(got, paged_verify_attention_ref(*args, 4), dtype)
    args = _verify_args(3, 11, 64, dtype, hkv=1)
    before = paged_flash_verify.launches_long
    got = paged_flash_verify(*args, t_window=3)
    torch.cuda.synchronize()
    assert paged_flash_verify.launches_long == before + 1
    _close(got, paged_verify_attention_ref(*args, 3), dtype)
    with pytest.raises(ValueError, match="multiple of t_window"):
        paged_flash_verify(*args, t_window=2)
    scales = torch.ones(args[1].shape[:2], device="cuda")
    with pytest.raises(ValueError, match="both"):
        paged_flash_verify(*args, t_window=3, v_scales=scales)


def _int8_pages(kp, vp, zero_rows=((1, 0), (2, 3))):
    """Float numpy pages (P, ps, Hkv, D) -> int8 pages and f32 row scales
    on the card, quantized on the CPU; the (page, row) pairs in
    ``zero_rows`` hold zeros (scale 0) in K and V."""
    kp, vp = kp.copy(), vp.copy()
    for page, row in zero_rows:
        kp[page, row] = vp[page, row] = 0.0
    pool = quantized_pool_from_numpy(np.stack([kp[None], vp[None]]), device="cpu")
    return [pool[n][0].to("cuda") for n in ("k_pages", "v_pages", "k_scales", "v_scales")]


def _dequantized(kq, vq, ks, vs):
    return dequantize_kv(kq, ks), dequantize_kv(vq, vs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("d,g", [(64, 1), (64, 6), (128, 1), (128, 6)])
def test_cuda_int8_paged_decode_matches_plain(d, g, ps, dtype):
    """int8 pages through the kernel's int8 branch against the plain
    version on the same pages, and against the float kernel on the
    dequantized pages; zero-scale rows, garbage in the trash page and a
    stale mapping, and row 0's pos on the first row of a page."""
    requires_cuda()
    q, kp, vp, bt, pos = paged_decode_case(np.random.default_rng(6), d=d, g=g, ps=ps)
    pos[0] = 2 * ps
    kq, vq, ks, vs = _int8_pages(kp, vp)
    qc = _cuda(q, dtype)
    bt_c, pos_c = torch.as_tensor(bt, device="cuda"), torch.as_tensor(pos, device="cuda")
    before = (paged_flash_decode.launches, paged_flash_decode.launches_int8)
    got = paged_flash_decode(qc, kq, vq, bt_c, pos_c, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert (paged_flash_decode.launches, paged_flash_decode.launches_int8) == (
        before[0], before[1] + 1)
    assert got.dtype == dtype and torch.isfinite(got).all()
    _close(got, paged_flash_decode_ref(qc, kq, vq, bt_c, pos_c, k_scales=ks,
                                       v_scales=vs), dtype)
    kf, vf = _dequantized(kq, vq, ks, vs)
    _close(got, paged_flash_decode(qc, kf.to(dtype), vf.to(dtype), bt_c, pos_c), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 6])
@pytest.mark.parametrize("t", [1, 4])
def test_cuda_int8_paged_verify_matches_plain(t, g, d, ps, dtype):
    """The verify kernel's int8 branch against its plain version and
    against the float kernel on the dequantized pages (garbage past the
    windows, zero-scale rows)."""
    requires_cuda()
    q, kp, vp, bt, pos = paged_verify_case(np.random.default_rng(7), t=t, g=g, d=d,
                                           ps=ps)
    kq, vq, ks, vs = _int8_pages(kp, vp, zero_rows=((int(bt[1, 0]), 0),
                                                    (int(bt[1, 1]), ps - 1)))
    qc = _cuda(q, dtype)
    bt_c, pos_c = torch.as_tensor(bt, device="cuda"), torch.as_tensor(pos, device="cuda")
    before = paged_flash_verify.launches_int8
    got = paged_flash_verify(qc, kq, vq, bt_c, pos_c, t_window=t, k_scales=ks,
                             v_scales=vs)
    torch.cuda.synchronize()
    assert paged_flash_verify.launches_int8 == before + 1
    assert got.shape == qc.shape and torch.isfinite(got).all()
    _close(got, paged_verify_attention_ref(qc, kq, vq, bt_c, pos_c, t, k_scales=ks,
                                           v_scales=vs), dtype)
    kf, vf = _dequantized(kq, vq, ks, vs)
    kf, vf = (torch.nan_to_num(a).to(dtype) for a in (kf, vf))   # garbage stays unread
    _close(got, paged_flash_verify(qc, kf, vf, bt_c, pos_c, t_window=t), dtype)


@pytest.mark.cuda
def test_cuda_int8_kernels_refuse_what_they_cannot_take():
    requires_cuda()
    q, kp, vp, bt, pos = paged_decode_case(np.random.default_rng(8), d=64)
    kq, vq, ks, vs = _int8_pages(kp, vp)
    qc, bt_c = _cuda(q, torch.float32), torch.as_tensor(bt, device="cuda")
    pos_c = torch.as_tensor(pos, device="cuda")
    with pytest.raises(ValueError, match="both"):
        paged_flash_decode(qc, kq, vq, bt_c, pos_c, k_scales=ks)
    with pytest.raises(ValueError, match="row scales"):
        paged_flash_decode(qc, kq, vq, bt_c, pos_c, k_scales=ks.double(), v_scales=vs)
    with pytest.raises(TypeError, match="int8"):      # float pages with scales
        paged_flash_decode(qc, kq.float(), vq.float(), bt_c, pos_c, k_scales=ks,
                           v_scales=vs)
    with pytest.raises(TypeError):                    # int8 pages without scales
        paged_flash_decode(qc, kq, vq, bt_c, pos_c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_quantize_rows_equal_cpu_bytes(dtype):
    """Rows quantized on the card store the CPU's bytes, ties included."""
    requires_cuda()
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((4096, 2, 128))
         * rng.uniform(1e-3, 1e3, (4096, 1, 1))).astype(np.float32)
    x[:2] = 0.0
    x[2, 0, 0], x[2, 1, :8] = 127.0, np.arange(8) + 0.5
    xt = torch.from_numpy(x).to(dtype)
    q, s = quantize_kv_rows(xt.to("cuda"))
    q_cpu, s_cpu = quantize_kv_rows(xt)
    assert torch.equal(q.cpu(), q_cpu)
    assert torch.equal(s.cpu().view(torch.int32), s_cpu.view(torch.int32))


@pytest.mark.cuda
def test_cuda_swap_roundtrip_through_pinned_buffers():
    requires_cuda()
    rng = np.random.default_rng(10)
    kv = rng.standard_normal((2, 2, 9, 16, 2, 64)).astype(np.float32)
    pool = quantized_pool_from_numpy(kv, device="cuda")
    before = {n: t.clone() for n, t in pool.items()}
    host = swap_out_pages(pool, [1, 4, 5])
    for n, t in host.items():
        assert t.device.type == "cpu" and t.is_pinned(), n
        assert torch.equal(t, before[n][:, [1, 4, 5]].cpu()), n
    for n in pool:                                    # the pages are reused
        pool[n][:, [1, 4, 5]] = 0
    swap_in_pages(pool, host, [2, 7, 8])
    torch.cuda.synchronize()
    for n, t in pool.items():
        assert torch.equal(t[:, [2, 7, 8]], before[n][:, [1, 4, 5]]), n


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(preempt="requeue"),
    dict(preempt="swap"),
    dict(preempt="swap", spec_k=4, draft="self:2"),
], ids=["requeue", "swap", "spec-swap"])
def test_cuda_int8_serve_through_kernels_matches_cpu_plain_path(kw):
    """The slice as a whole on the card: an int8 pool small enough to
    preempt, decode and verify through the int8 kernels, gives the greedy
    tokens of the CPU plain path's int8 requeue engine.  Reduced qwen2 in
    fp32."""
    requires_cuda()
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = reduced_config("qwen2-1.5b")
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    params = cpu.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    spec = [(i, rng.integers(0, cfg.vocab, int(rng.integers(3, 20))).tolist(),
             int(rng.integers(2, 9))) for i in range(6)]

    def serve(model, p, **extra):
        eng = ServeEngine(model, p, max_seq=48, batch_slots=3, cache_layout="paged",
                          page_size=8, num_pages=5, kv_dtype="int8", **extra)
        return eng.serve([Request(u, list(t), n) for u, t, n in spec]), eng

    want, _ = serve(cpu, params, preempt="requeue")
    kernels.reset_launches()
    got, eng = serve(Model(cfg, dtype=torch.float32), _to_cuda(params), **kw)
    counts = kernels.launch_counts()
    assert got == want
    assert eng.preemptions >= 1 and eng.last_pool_stats.used_pages == 0
    if kw["preempt"] == "swap":
        assert eng.last_pool_stats.swap_outs == eng.last_pool_stats.swap_ins >= 1
    branch = "paged_flash_verify[int8]" if kw.get("spec_k") else "paged_flash_decode[int8]"
    assert counts[branch] > 0
    assert counts["paged_flash_decode"] == counts["paged_flash_verify"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 6])
def test_cuda_verify_window_of_one_is_paged_decode(g):
    """T = 1 verify against the paged decode kernel in f32: one split
    kernel on the same split count, so the same bits (the reference's
    bitwise form of this property fails on the reference itself)."""
    requires_cuda()
    args = _verify_args(1, g, 128, torch.float32)
    got = paged_flash_verify(*args, t_window=1)
    want = paged_flash_decode(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def _verify_split_args(t, g, d, int8, dtype=torch.bfloat16, hkv=2, seed=11):
    """verify_split_case on the card: (q, k pages, v pages, tables, pos)
    and the int8 pages' scales as keywords (zeros past the window)."""
    q, kp, vp, bt, pos = verify_split_case(np.random.default_rng(seed), t, hkv, g, d)
    head = [_cuda(q, dtype)]
    tail = [torch.as_tensor(bt, device="cuda"), torch.as_tensor(pos, device="cuda")]
    if int8:
        kq, vq, ks, vs = _int8_pages(np.nan_to_num(kp), np.nan_to_num(vp))
        ks[0], vs[0] = float("nan"), float("nan")
        return head + [kq, vq] + tail, dict(k_scales=ks, v_scales=vs)
    return head + [_cuda(kp, dtype), _cuda(vp, dtype)] + tail, {}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("t,g,d", [(4, 6, 128), (2, 6, 64), (8, 1, 128), (4, 1, 64)])
def test_cuda_verify_split_edges_match_plain(t, g, d, int8, dtype):
    """Windows across page and split edges, a row limit inside a split, a
    split wholly past an early row's limit and a window past the table's
    end (verify_split_case), over float and int8 pages with NaN past each
    window: against the plain version, and in f32 against the plain
    emulation of the split kernel on the wrapper's split count; one launch
    a call."""
    requires_cuda()
    from repro_torch import kernels

    args, sc = _verify_split_args(t, g, d, int8, dtype)
    before = kernels.launch_counts()
    got = paged_flash_verify(*args, t_window=t, **sc)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    counter = "paged_flash_verify[int8]" if int8 else "paged_flash_verify"
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {counter: 1}
    assert got.dtype == dtype and torch.isfinite(got).all()
    _close(got, paged_verify_attention_ref(*args, t, **sc), dtype)
    if dtype == torch.float32:
        b, hkv = args[0].shape[:2]
        splits = verify_splits(b, hkv, t * g, t, VERIFY_SPLIT_NB * VERIFY_SPLIT_PAGE)
        _close(got, paged_flash_verify_split_emulated(*args, t, splits, **sc), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cuda_verify_repeats_bit_for_bit(int8):
    """The combine pass adds partials in split order, no atomics: two
    launches give the same bits."""
    requires_cuda()
    args, sc = _verify_split_args(4, 6, 128, int8)
    first = paged_flash_verify(*args, t_window=4, **sc)
    second = paged_flash_verify(*args, t_window=4, **sc)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# ---------------------------------------------------------------------------
# the long-window branch of paged_flash_verify (T * G > 32 rows a KV head)
# ---------------------------------------------------------------------------

def _verify_long_args(t, g, dtype, int8, at_end=False, d=128, seed=21):
    """verify_long_case on the card: (q, k pages, v pages, tables, pos) and
    int8 pages' scales as keywords (NaN scales on the trash page)."""
    q, kp, vp, bt, pos = verify_long_case(np.random.default_rng(seed + t), t, g, d=d,
                                          at_end=at_end)
    head = [_cuda(q, dtype)]
    tail = [torch.as_tensor(bt, device="cuda"), torch.as_tensor(pos, device="cuda")]
    if int8:
        kq, vq, ks, vs = _int8_pages(np.nan_to_num(kp), np.nan_to_num(vp))
        ks[0], vs[0] = float("nan"), float("nan")
        return head + [kq, vq] + tail, dict(k_scales=ks, v_scales=vs)
    return head + [_cuda(kp, dtype), _cuda(vp, dtype)] + tail, {}


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "f32", "int8-bf16q", "int8-f32q"])
@pytest.mark.parametrize("at_end", [False, True], ids=["pos0-midpage", "past-table"])
@pytest.mark.parametrize("t,g", [(3, 11), (16, 6), (256, 6), (512, 6)],
                         ids=["tg33", "tg96", "tg1536", "tg3072"])
def test_cuda_verify_long_matches_plain(t, g, at_end, pages):
    """T*G = 33, 96, 1536 and 3072 rows a KV head: slot 0's window from pos
    0, slot 1's from mid-page (or, past-table, running past the table's
    end), garbage in the trash page and past each window; the key axis on
    the wrapper's split rule (verify_long_splits); against the plain
    version, one long-branch launch a call and nothing else."""
    requires_cuda()
    from repro_torch import kernels

    dtype = torch.float32 if "f32" in pages else torch.bfloat16
    int8 = pages.startswith("int8")
    args, sc = _verify_long_args(t, g, dtype, int8, at_end)
    before = kernels.launch_counts()
    got = paged_flash_verify(*args, t_window=t, **sc)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    counter = "paged_flash_verify[long,int8]" if int8 else "paged_flash_verify[long]"
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {counter: 1}
    assert got.dtype == dtype and got.shape == args[0].shape and torch.isfinite(got).all()
    _close(got, paged_verify_attention_ref(*args, t, **sc), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_verify_long_head_dim_64(dtype):
    """D = 64 (the reduced configs' head), a 96-row window."""
    requires_cuda()
    args, _ = _verify_long_args(16, 6, dtype, False, d=64)
    got = paged_flash_verify(*args, t_window=16)
    torch.cuda.synchronize()
    _close(got, paged_verify_attention_ref(*args, 16), dtype)


def _long_splits(args, pages):
    """The split count the long branch's rule gives the wrapper's call."""
    from repro_torch.kernels.verify_attention import ops as vops

    q, kp, _, bt, _ = args
    b, hkv, rows, _ = q.shape
    return vops.verify_long_splits(b, hkv, rows, bt.shape[1] * kp.shape[1],
                                   vops.long_rows_per_block(q.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "f32", "int8-bf16q", "int8-f32q"])
@pytest.mark.parametrize("t,g", [(16, 6), (256, 6), (512, 6)],
                         ids=["tg96", "tg1536", "tg3072"])
def test_cuda_verify_long_one_split_matches_the_rule(t, g, pages, monkeypatch):
    """The same inputs with the key axis forced into one split (the kernel
    finalizes in place, no combine), on the rule's count and forced into 5
    (partials and split.cuh's combine; the rule gives 1 to f32 q at T*G
    3072 here): within 1e-5 of one split on f32 q, within the bf16
    tolerance on bf16 q; each against the plain version too."""
    requires_cuda()
    from repro_torch.kernels.verify_attention import ops as vops

    dtype = torch.float32 if "f32" in pages else torch.bfloat16
    int8 = pages.startswith("int8")
    args, sc = _verify_long_args(t, g, dtype, int8, at_end=True)
    assert _long_splits(args, pages) > 1 or (dtype == torch.float32 and t == 512)
    got = {"rule": paged_flash_verify(*args, t_window=t, **sc)}
    for n in (1, 5):
        monkeypatch.setattr(vops, "verify_long_splits", lambda *a, n=n: n)
        got[n] = paged_flash_verify(*args, t_window=t, **sc)
    torch.cuda.synchronize()
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else CUDA_TOL[dtype]
    want = paged_verify_attention_ref(*args, t, **sc)
    for key in ("rule", 5):
        torch.testing.assert_close(got[key].float(), got[1].float(), **tol)
    for o in got.values():
        _close(o, want, dtype)


@pytest.mark.cuda
def test_cuda_verify_long_int8_runs_the_tensor_cores():
    """int8 pages under bf16 q take the tensor-core kernel: its int8
    counter moves once, the profiler sees verify_long_tc_kernel<signed
    char, ...> (and split.cuh's combine) and no CUDA-core kernel, and the
    ptxas/SASS report of verify_attention.cu shows HMMA in every
    verify_long_tc_kernel instance, bf16 and int8 pages at D 64 and 128."""
    requires_cuda()
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.bench.kernel_ab import ptxas_report

    args, sc = _verify_long_args(256, 6, torch.bfloat16, True)
    assert _long_splits(args, "int8-bf16q") > 1
    paged_flash_verify(*args, t_window=256, **sc)          # build and warm up
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        paged_flash_verify(*args, t_window=256, **sc)
        torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {
        "paged_flash_verify[long,int8]": 1}
    names = [e.key for e in prof.key_averages()]
    assert any("verify_long_tc_kernel" in n and "char" in n for n in names), names
    assert any("decode_combine_kernel" in n for n in names), names
    assert not any("verify_long_core_kernel" in n for n in names), names
    kdir = Path(kernels.__file__).resolve().parent
    report = {n: r for n, r in ptxas_report(kdir).items() if "verify_long_tc_kernel" in n}
    assert len(report) == 4 and sum("char" in n for n in report) == 2, report
    assert all(r.get("hmma", 0) > 0 for r in report.values()), report


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cuda_verify_long_repeats_bit_for_bit(int8):
    """The key axis split across blocks (the rule's count at this shape is
    above 1), the partials reduced in split order by the combine pass, no
    atomics: two launches give the same bits."""
    requires_cuda()
    args, sc = _verify_long_args(256, 6, torch.bfloat16, int8)
    assert _long_splits(args, "int8-bf16q" if int8 else "bf16") > 1
    first = paged_flash_verify(*args, t_window=256, **sc)
    second = paged_flash_verify(*args, t_window=256, **sc)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cuda_verify_short_window_dispatch_unchanged(int8):
    """T*G <= 32 (the smoke's spec_k 4 window at G = 6) still runs the
    split kernel: the wrapper's output equals, bit for bit, a direct call
    of the split kernel's entry point on the wrapper's split count, and
    no long-branch counter moves."""
    requires_cuda()
    from repro_torch.kernels.decode_attention.ops import _work
    from repro_torch.kernels.verify_attention import ops as vops

    args, sc = _verify_split_args(4, 6, 128, int8)
    q, kp, vp, bt, pos = args
    longs = (paged_flash_verify.launches_long, paged_flash_verify.launches_long_int8)
    got = paged_flash_verify(*args, t_window=4, **sc)
    b, hkv, rows, d = q.shape
    splits = verify_splits(b, hkv, rows, 4, bt.shape[1] * kp.shape[1])
    work, o = _work(q, splits), torch.empty_like(q)
    bt32, pos32 = bt.to(torch.int32), pos.to(torch.int32)
    shape = (b, bt.shape[1], kp.shape[1], hkv, rows, 4, d, d ** -0.5, vops._DTYPES[q.dtype],
             work.data_ptr(), splits)
    if int8:
        ks, vs = sc["k_scales"], sc["v_scales"]
        build.launch("repro_paged_flash_verify_int8", vops._INT8_ARGS, q.device,
                     q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
                     vs.data_ptr(), bt32.data_ptr(), pos32.data_ptr(), o.data_ptr(),
                     *kp.stride()[:3], *vp.stride()[:3], *ks.stride(), *vs.stride(),
                     bt32.stride(0), *shape)
    else:
        build.launch("repro_paged_flash_verify", vops._ARGS, q.device, q.data_ptr(),
                     kp.data_ptr(), vp.data_ptr(), bt32.data_ptr(), pos32.data_ptr(),
                     o.data_ptr(), *kp.stride()[:3], *vp.stride()[:3], bt32.stride(0), *shape)
    torch.cuda.synchronize()
    assert torch.equal(got, o)
    assert (paged_flash_verify.launches_long, paged_flash_verify.launches_long_int8) == longs


@pytest.mark.cuda
def test_cuda_prefix_sharing_serve_matches_cpu_plain_path():
    """Prefix-sharing serving on the card (reduced qwen2 in fp32, G = 4:
    each suffix prefill is a 16-token bucket, 64 rows a KV head, through
    the long branch's f32 kernel) gives the greedy tokens of the same
    engine on the CPU, and of unshared serving on the card."""
    requires_cuda()
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = reduced_config("qwen2-1.5b")
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    params = cpu.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, cfg.vocab, 16).tolist()
    spec = [(i, prefix + rng.integers(0, cfg.vocab, int(rng.integers(1, 20))).tolist(),
             int(rng.integers(2, 9))) for i in range(5)] + [(5, list(prefix), 4)]
    kw = dict(max_seq=64, batch_slots=3, cache_layout="paged", page_size=8, num_pages=12)

    def serve(model, p, **extra):
        eng = ServeEngine(model, p, **kw, **extra)
        return eng.serve([Request(u, list(t), n) for u, t, n in spec]), eng

    want, _ = serve(cpu, params, prefix_sharing=True)
    gpu = Model(cfg, dtype=torch.float32)
    unshared, _ = serve(gpu, _to_cuda(params))
    kernels.reset_launches()
    got, eng = serve(gpu, _to_cuda(params), prefix_sharing=True)
    counts = kernels.launch_counts()
    assert got == want == unshared
    assert counts["paged_flash_verify[long]"] > 0
    p = eng.last_pool_stats
    assert p.cow_forks >= 1 and p.cached_prefix_tokens > 0 and p.sharing_ratio > 1


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

    rng = np.random.default_rng(3)
    spec = [(i, rng.integers(0, cfg.vocab, int(rng.integers(3, 20))).tolist(),
             int(rng.integers(2, 9))) for i in range(6)]

    def serve(model, p):
        eng = ServeEngine(model, p, max_seq=48, batch_slots=3, **kw)
        return eng.serve([Request(u, list(t), n) for u, t, n in spec]), eng

    want, want_eng = serve(cpu, params)
    kernels.reset_launches()
    got, eng = serve(Model(cfg, dtype=torch.float32), _to_cuda(params))
    counts = kernels.launch_counts()
    assert got == want
    assert eng.preemptions == want_eng.preemptions
    assert eng.preemptions >= (1 if kw else 0)
    decode = "paged_flash_decode" if kw else "flash_decode"
    for name in ("rmsnorm", "flash_attention_fwd[f32]", decode):
        assert counts[name] > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("num_pages", [None, 5], ids=["paged", "paged-preempt"])
def test_cuda_spec_serve_through_kernels_matches_cpu_plain_path(num_pages):
    """Speculative serving on the card, the verify window through
    paged_flash_verify and the draft through flash_decode, gives exactly
    the greedy tokens of the CPU plain path's non-speculative engine.
    Reduced qwen2 in fp32, spec_k = 4, a 2-layer self draft."""
    requires_cuda()
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = reduced_config("qwen2-1.5b")
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    params = cpu.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    spec = [(i, rng.integers(0, cfg.vocab, int(rng.integers(3, 20))).tolist(),
             int(rng.integers(2, 9))) for i in range(6)]

    def serve(model, p, **kw):
        eng = ServeEngine(model, p, max_seq=48, batch_slots=3, **kw)
        return eng.serve([Request(u, list(t), n) for u, t, n in spec]), eng

    want, _ = serve(cpu, params)
    kernels.reset_launches()
    got, eng = serve(Model(cfg, dtype=torch.float32), _to_cuda(params),
                     cache_layout="paged", page_size=8, num_pages=num_pages,
                     spec_k=4, draft="self:2")
    counts = kernels.launch_counts()
    assert got == want
    assert eng.preemptions >= (1 if num_pages else 0)
    assert eng.last_pool_stats.used_pages == 0
    for name in ("rmsnorm", "flash_attention_fwd[f32]", "flash_decode",
                 "paged_flash_verify"):
        assert counts[name] > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_kernels_at_olmoe_heads(dtype):
    """Dense and paged decode with OLMoE's 16 KV heads of one query head
    each (G = 1), D 128."""
    requires_cuda()
    rng = np.random.default_rng(6)
    q, kp, vp, bt, pos = paged_decode_case(rng, hkv=16, g=1, d=128)
    args = [_cuda(a, dtype) for a in (q, kp, vp)]
    bt_c, pos_c = torch.as_tensor(bt, device="cuda"), torch.as_tensor(pos, device="cuda")
    got = paged_flash_decode(*args, bt_c, pos_c)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close(got, paged_flash_decode_ref(*args, bt_c, pos_c), dtype)
    k = _cuda(_rand(rng, 2, 96, 16, 128), dtype)
    v = _cuda(_rand(rng, 2, 96, 16, 128), dtype)
    qd, pd = args[0], torch.tensor([40, 95], dtype=torch.int32, device="cuda")
    got = flash_decode(qd, k, v, pd)
    torch.cuda.synchronize()
    _close(got, flash_decode_ref(qd, k, v, pd), dtype)


# decode's split kernel and combine pass.  At B 8 x Hkv 16 the grid takes
# 3 splits, so a row of n <= 96 keys splits into 32-key pieces, 97..192
# into 64 and 193..200 into 96: pos 0 and 31 leave later splits empty,
# the rest sit on split edges (chunk - 1, chunk, chunk + 1) or end the
# view.  Garbage (NaN) fills every row past pos and the trash page 0.
SPLIT_POS = [0, 31, 32, 33, 127, 128, 129, 199]
SPLIT_S = 200


def _split_case(g, d, hkv=16, seed=7):
    """Dense numpy q, k, v (NaN past pos) and pos at the split edges."""
    rng = np.random.default_rng(seed)
    b = len(SPLIT_POS)
    q, k, v = _rand(rng, b, hkv, g, d), _rand(rng, b, SPLIT_S, hkv, d), _rand(rng, b, SPLIT_S, hkv, d)
    for i, p in enumerate(SPLIT_POS):
        k[i, p + 1:], v[i, p + 1:] = np.nan, np.nan
    return q, k, v, np.asarray(SPLIT_POS, np.int32)


def _split_pages(k, v, ps, extra_cols=0, seed=8):
    """The dense rows in shuffled pages behind a NaN trash page 0; table
    columns past a row's last live page, and ``extra_cols`` more, point at
    the trash page."""
    rng = np.random.default_rng(seed)
    b, s = k.shape[:2]
    nb = -(-s // ps)
    kp = np.full((b * nb + 1, ps) + k.shape[2:], np.nan, np.float32)
    vp = kp.copy()
    bt = np.zeros((b, nb + extra_cols), np.int32)
    bt[:, :nb] = (rng.permutation(b * nb) + 1).reshape(b, nb)
    for i in range(b):
        for j in range(nb):
            rows = slice(j * ps, min((j + 1) * ps, s))
            n = rows.stop - rows.start
            kp[bt[i, j], :n], vp[bt[i, j], :n] = k[i, rows], v[i, rows]
        bt[i, SPLIT_POS[i] // ps + 1:] = 0
    return kp, vp, bt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 6, 16])
@pytest.mark.parametrize("layout", ["dense", "paged8", "paged16", "int8-8", "int8-16"])
def test_cuda_decode_split_edges_match_plain(layout, g, d, dtype):
    """Dense, paged (8- and 16-token pages) and int8-paged decode at pos on
    split edges against their plain versions; one launch a call; NaN past
    pos and in the trash page leaves the output finite."""
    requires_cuda()
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention.ops import decode_splits

    q, k, v, pos = _split_case(g, d)
    assert decode_splits(len(SPLIT_POS), 16, SPLIT_S) == 3
    qc, pos_c = _cuda(q, dtype), torch.as_tensor(pos, device="cuda")
    before = kernels.launch_counts()
    if layout == "dense":
        args = (qc, _cuda(k, dtype), _cuda(v, dtype), pos_c)
        got, want = flash_decode(*args), flash_decode_ref(*args)
        counter = "flash_decode"
    else:
        kp, vp, bt = _split_pages(k, v, int(layout.split("-")[-1].removeprefix("paged")))
        bt_c = torch.as_tensor(bt, device="cuda")
        if layout.startswith("int8"):
            kq, ks = quantize_kv_rows(torch.as_tensor(kp, device="cuda"))
            vq, vs = quantize_kv_rows(torch.as_tensor(vp, device="cuda"))
            args, kw = (qc, kq, vq, bt_c, pos_c), dict(k_scales=ks, v_scales=vs)
            counter = "paged_flash_decode[int8]"
        else:
            args, kw = (qc, _cuda(kp, dtype), _cuda(vp, dtype), bt_c, pos_c), {}
            counter = "paged_flash_decode"
        got, want = paged_flash_decode(*args, **kw), paged_flash_decode_ref(*args, **kw)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {counter: 1}
    assert got.dtype == dtype and torch.isfinite(got).all()
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("g,hkv", [(1, 16), (6, 2)])
def test_cuda_decode_repeats_bit_for_bit(g, hkv):
    """The combine pass adds partials in split order, no atomics: two
    launches give the same bits (bf16 dense, paged and int8 pages)."""
    requires_cuda()
    q, k, v, pos = _split_case(g, 128, hkv=hkv)
    kp, vp, bt = _split_pages(k, v, 16)
    qc, pos_c, bt_c = (_cuda(q, torch.bfloat16), torch.as_tensor(pos, device="cuda"),
                       torch.as_tensor(bt, device="cuda"))
    kq, ks = quantize_kv_rows(torch.as_tensor(kp, device="cuda"))
    vq, vs = quantize_kv_rows(torch.as_tensor(vp, device="cuda"))
    calls = [lambda: flash_decode(qc, _cuda(k, torch.bfloat16), _cuda(v, torch.bfloat16), pos_c),
             lambda: paged_flash_decode(qc, _cuda(kp, torch.bfloat16), _cuda(vp, torch.bfloat16),
                                        bt_c, pos_c),
             lambda: paged_flash_decode(qc, kq, vq, bt_c, pos_c, k_scales=ks, v_scales=vs)]
    for call in calls:
        first, second = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g,hkv", [(1, 16), (6, 2), (16, 1)])
def test_cuda_dense_equals_paged_bit_for_bit(g, hkv, d):
    """In f32 dense and paged decode add the same products in the same
    order: equal bits on the same rows, whatever the dense view's width or
    the table's (a row's split reads only its own length)."""
    requires_cuda()
    q, k, v, pos = _split_case(g, d, hkv=hkv)
    qc, pos_c = _cuda(q, torch.float32), torch.as_tensor(pos, device="cuda")
    wide = np.full((k.shape[0], 2 * SPLIT_S) + k.shape[2:], np.nan, np.float32)
    kw_, vw_ = wide.copy(), wide.copy()
    kw_[:, :SPLIT_S], vw_[:, :SPLIT_S] = k, v
    dense = flash_decode(qc, _cuda(k, torch.float32), _cuda(v, torch.float32), pos_c)
    outs = [flash_decode(qc, _cuda(kw_, torch.float32), _cuda(vw_, torch.float32), pos_c)]
    for ps, extra in ((8, 0), (16, 0), (16, 9)):
        kp, vp, bt = _split_pages(k, v, ps, extra_cols=extra)
        outs.append(paged_flash_decode(qc, _cuda(kp, torch.float32), _cuda(vp, torch.float32),
                                       torch.as_tensor(bt, device="cuda"), pos_c))
    torch.cuda.synchronize()
    assert torch.isfinite(dense).all()
    for out in outs:
        assert torch.equal(out, dense)


@pytest.mark.cuda
def test_cuda_decode_refuses_unaligned_rows():
    """The kernels copy whole rows in 16-byte pieces: a head stride that is
    not a multiple of 16 bytes raises, it never falls back."""
    requires_cuda()
    q = torch.randn(2, 2, 1, 64, device="cuda")
    k = torch.randn(2, 32, 2, 65, device="cuda")[..., :64]
    pos = torch.tensor([3, 20], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        flash_decode(q, k, k, pos)


def _gating_logits(t, e, dtype, rng):
    """Random logits with special rows: all ties, a NaN lane, all -inf,
    one value above -inf, (bf16) rows of small integers tied many times
    over, and (t > 16) the Pallas kernel's sentinel edges: -1e30 below and
    above the values above it, -3e38, +inf, +0/-0 ties, all -1e30, and
    -1e30 on every even id under one value (bf16 rounds -1e30 to
    -1.00026e30, below the sentinel)."""
    x = (rng.standard_normal((t, e)) * 2).astype(np.float32)
    x[0] = 0.0
    x[1 % t, e // 3] = np.nan
    x[2 % t] = -np.inf
    x[3 % t, :] = -np.inf
    x[3 % t, e - 1] = 1.5
    if t > 8:
        x[4:8] = rng.integers(-3, 4, (4, e)) * 0.5
    if t > 16:
        x[8:10] = x[15] = -np.inf
        x[8, [1, 9, 10, 12, e - 1]] = (-1e30, 2.0, -0.0, 0.0, -1e30)
        x[9, [3, 5, 7]] = (1.0, -1e30, -3e38)
        x[10] = -3e38
        x[10, 0] = -np.inf
        x[11, 4] = np.inf
        x[12, 0::2], x[12, 1::2] = 0.0, -0.0
        x[12, e - 2:] = 1.0
        x[13] = -1e30
        x[15, 0::2] = -1e30
        x[15, e - 1] = 0.5
    return _cuda(x, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,e,k", [(2048, 64, 8), (4, 64, 8), (512, 32, 8),
                                   (128, 128, 2), (512, 64, 1), (256, 16, 16),
                                   (256, 32, 32), (256, 64, 64), (256, 128, 128),
                                   (256, 16, 5), (256, 128, 10)])
def test_cuda_moe_gating_matches_plain(t, e, k, dtype):
    """Masks exactly and weights within 1e-6 (a few f32 ulps of values
    <= 1 summed in another order), NaN where the plain version has NaN,
    against both plain versions (the Pallas kernel's rounds and their
    rank closed form, which agree bit for bit): a NaN row selects
    nothing, an all -inf row only expert 0."""
    requires_cuda()
    x = _gating_logits(t, e, dtype, np.random.default_rng(t + e + k))
    before = moe_gating.launches
    w, m = moe_gating(x, k)
    torch.cuda.synchronize()
    assert moe_gating.launches == before + 1
    assert w.dtype == torch.float32 and m.dtype == torch.int32
    (w_ref, m_ref), (w_rank, m_rank) = moe_gating_ref(x, k), moe_gating_rank_ref(x, k)
    assert torch.equal(m_ref, m_rank)
    assert torch.equal(w_ref.nan_to_num(nan=-1.0), w_rank.nan_to_num(nan=-1.0))
    assert torch.equal(m, m_ref)
    torch.testing.assert_close(w, w_ref, atol=1e-6, rtol=0, equal_nan=True)
    assert m[0, :k].all() and m[0].sum() == k                  # ties: lowest ids
    if t > 1:
        assert m[1].sum() == 0 and torch.isnan(w[1]).all()     # NaN row
    if t > 2:
        assert m[2].tolist() == [1] + [0] * (e - 1)             # all -inf
    if t > 16 and k >= 4:
        exact = dtype == torch.float32                          # -1e30 kept
        assert m[8].nonzero().flatten().tolist() == ([1] if exact else []) + [9, 10, 12]
        assert m[9].nonzero().flatten().tolist() == [3]
        assert m[10].nonzero().flatten().tolist() == [1]
        assert m[13].nonzero().flatten().tolist() == [0]
        assert m[15].nonzero().flatten().tolist() == ([0] if exact else []) + [e - 1]


@pytest.mark.cuda
def test_cuda_moe_gating_refuses_what_it_cannot_take():
    requires_cuda()
    with pytest.raises(ValueError, match="128"):
        moe_gating(torch.zeros(4, 129, device="cuda"), 2)
    # a router that needs a gradient goes through MoEGating: the kernel's
    # forward (one launch), a gradient zero off the selected experts
    x = torch.randn(4, 64, device="cuda", requires_grad=True)
    before = moe_gating.launches
    w, m = moe_gating(x, 8)
    assert moe_gating.launches == before + 1
    assert type(w.grad_fn).__name__ == "MoEGatingBackward"
    (w * torch.randn_like(w)).sum().backward()
    assert x.grad.abs().sum() > 0 and (x.grad[m == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,e,k", [(8192, 32, 8), (512, 64, 8)],
                         ids=["granite-train", "olmoe-prefill"])
def test_cuda_moe_gating_backward_matches_autograd_of_plain(t, e, k, dtype):
    """MoEGating on the card (the kernel's forward, the torch backward)
    against autograd through moe_gating_ref on the same logits on the
    card, half the rows small integers tied many times over: masks equal,
    weights within 1e-6, gradients within a few f32 ulps (f32 logits) or
    one bf16 ulp (bf16 logits: each side rounds its f32 gradient once)."""
    requires_cuda()
    gen = torch.Generator(device="cuda").manual_seed(t + e)
    x = torch.randn(t, e, device="cuda", generator=gen)
    x[::2] = torch.round(x[::2] * 1.5)
    x = x.to(dtype)
    g = torch.randn(t, e, device="cuda", generator=gen)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    before = moe_gating.launches
    w, m = moe_gating(a, k)
    (w * g).sum().backward()
    assert moe_gating.launches == before + 1
    pw, pm = moe_gating_ref(b, k)
    (pw * g).sum().backward()
    torch.cuda.synchronize()
    assert torch.equal(m, pm)
    torch.testing.assert_close(w, pw.detach(), atol=1e-6, rtol=0)
    assert a.grad.dtype == dtype
    tol = dict(atol=1e-6, rtol=0) if dtype == torch.float32 else dict(atol=1e-6, rtol=2 ** -7)
    torch.testing.assert_close(a.grad.float(), b.grad.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(),
    dict(cache_layout="paged", page_size=8, num_pages=5),   # forces preemption
], ids=["dense", "paged-preempt"])
def test_cuda_moe_serve_through_kernels_matches_cpu_plain_path(kw):
    """Reduced OLMoE on the card, gating through moe_gating and attention
    and norms through their kernels, gives the greedy tokens of the same
    engine on the CPU (plain versions); fp32, so the paths differ by
    summation order only."""
    requires_cuda()
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = reduced_config("olmoe-1b-7b")
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    params = cpu.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    spec = [(i, rng.integers(0, cfg.vocab, int(rng.integers(3, 12))).tolist(),
             int(rng.integers(2, 10))) for i in range(4)]

    def serve(model, p):
        eng = ServeEngine(model, p, max_seq=48, batch_slots=3, **kw)
        return eng.serve([Request(u, list(t), n) for u, t, n in spec]), eng

    want, want_eng = serve(cpu, params)
    kernels.reset_launches()
    got, eng = serve(Model(cfg, dtype=torch.float32), _to_cuda(params))
    counts = kernels.launch_counts()
    assert got == want
    assert eng.preemptions == want_eng.preemptions
    assert eng.preemptions >= (1 if kw else 0)
    decode = "paged_flash_decode" if kw else "flash_decode"
    for name in ("rmsnorm", "flash_attention_fwd[f32]", decode, "moe_gating"):
        assert counts[name] > 0, name
    # one gating launch per layer of every prefill and decode step, as
    # one attention launch is (fp32: the flash kernel's f32 branch)
    assert counts["moe_gating"] == counts["flash_attention_fwd[f32]"] + counts[decode]


# ---------------------------------------------------------------------------
# the warp-feature kernels (vx_shfl / vx_vote / vx_tile, mse, matmul)
# ---------------------------------------------------------------------------

# 37 rows: never a whole number of 256-thread blocks, so the last block
# is partial at every width
WARP_WIDTHS = [8, 32, 64, 128]


def _exact(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.uint32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


# the shuffle's lane path moves several elements a thread: row counts
# whose n * width is no multiple of a block's elements (1024 or 2048), so
# the last block ends inside a thread's elements
SHFL_TAIL_ROWS = [37, 3001]


@pytest.mark.cuda
@pytest.mark.parametrize("n", SHFL_TAIL_ROWS)
@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("mode", ["up", "down", "bfly", "idx"])
def test_cuda_shfl_lane_path_tail(mode, width, n):
    requires_cuda()
    assert n * width % 1024 and n * width % 2048
    rng = np.random.default_rng(n + width)
    x = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (n, width), dtype=np.int64)
                        .astype(np.int32), device="cuda")
    imms = {"up": (1, width // 2, width), "down": (1, width - 1, 2 * width),
            "bfly": (1, width // 2, width - 1), "idx": (0, width - 1, -1)}[mode]
    for imm in imms:
        got = shfl(x, mode, imm)
        torch.cuda.synchronize()
        _exact(got, shfl_ref(x, mode, imm))


@pytest.mark.cuda
@pytest.mark.parametrize("width", WARP_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_cuda_shfl_matches_plain(width, dtype):
    requires_cuda()
    rng = np.random.default_rng(width)
    x = _cuda(_rand(rng, 37, width) * 100, dtype)
    for mode, imms in (("up", (0, 1, 3, width - 1, width, 5 * width)),
                       ("down", (1, 5, width - 1, width + 1)),
                       ("bfly", (1, width // 2, width - 1)),
                       ("idx", (0, 7, width + 3, -1))):
        for imm in imms:
            before = shfl.launches
            got = shfl(x, mode, imm)
            torch.cuda.synchronize()
            assert shfl.launches == before + 1
            _exact(got, shfl_ref(x, mode, imm))


@pytest.mark.cuda
@pytest.mark.parametrize("width", WARP_WIDTHS)
def test_cuda_vote_matches_plain(width):
    """All four modes, without and with a member mask that leaves lane 0
    out; float predicates go through the int32 cast (0.5 is false)."""
    requires_cuda()
    rng = np.random.default_rng(width + 1)
    pred = torch.as_tensor(rng.integers(0, 2, (37, width)), device="cuda")
    pred[:9] = 1                                    # rows where all/uni hold
    pred[9:12] = 0
    fpred = torch.as_tensor(rng.choice([0.0, 0.5, 1.0, -1.7], (37, width)),
                            dtype=torch.float32, device="cuda")
    member = torch.as_tensor(rng.integers(0, 2, (37, width)), device="cuda")
    member[:, 0] = 0
    lane_member = member[3]                          # one mask for every row
    modes = ["all", "any", "uni"] + (["ballot"] if width <= 32 else [])
    for mode in modes:
        for p in (pred, fpred):
            for mm in (None, member, lane_member):
                got = vote(p, mode, mm)
                torch.cuda.synchronize()
                _exact(got, vote_ref(p, mode, mm))
    if width > 32:
        with pytest.raises(ValueError, match="one 32-bit word"):
            vote(pred, "ballot")


@pytest.mark.cuda
@pytest.mark.parametrize("width", WARP_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_cuda_tile_reduce_matches_plain(width, dtype):
    """Bit for bit, bf16 sums included: kernel and plain version both
    round to bf16 after every butterfly step."""
    requires_cuda()
    rng = np.random.default_rng(width + 2)
    x = _cuda(_rand(rng, 37, width) * 8, dtype)
    for tile in sorted({1, 4, 8, 32, width} & set(range(1, width + 1))):
        for op in ("sum", "max", "min"):
            before = tile_reduce.launches
            got = tile_reduce(x, tile, op)
            torch.cuda.synchronize()
            assert tile_reduce.launches == before + 1
            _exact(got, tile_reduce_ref(x, tile, op))


@pytest.mark.cuda
@pytest.mark.parametrize("warp_size", [8, 32, 128])
@pytest.mark.parametrize("n", [256, 1000 * 128, 3 * 2 ** 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mse_matches_plain(warp_size, n, dtype):
    """f32 sums in another order (grid-stride, 32-lane trees, atomics in
    no fixed order): relative 1e-5."""
    requires_cuda()
    rng = np.random.default_rng(n)
    p, t = _cuda(_rand(rng, n), dtype), _cuda(_rand(rng, n), dtype)
    before = mse_partial_sum.launches
    got = mse_partial_sum(p, t, warp_size=warp_size)
    torch.cuda.synchronize()
    assert mse_partial_sum.launches == before + 1
    assert got.dtype == torch.float32 and got.dim() == 0
    torch.testing.assert_close(got, mse_partial_sum_ref(p, t, warp_size),
                               rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# the PR transformation's kernel lowering (core.pr_transform, path="kernel")
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("block", [(8, 4), (32, 32)], ids=["8x4", "32x32"])
@pytest.mark.parametrize("name", list(prb.CASES))
def test_cuda_pr_transform_lowerings_agree(name, block):
    """Each program of the smoke's pr_transform phase on the card: kernel
    == hw bit for bit (f32 sums within rtol 1e-6), sw == hw (f32 sums
    within 1e-5), the out-of-range store and the carry each path against
    the same path on the CPU (``check`` raises on a failed gate)."""
    requires_cuda()
    case, warp = prb.CASES[name], WarpConfig(*block)
    gen = torch.Generator(device="cuda").manual_seed(sum(map(ord, name)))
    outs = prb.check(case, warp, prb.make_inputs(case, warp, gen), "cuda")
    assert all(v.device.type == "cuda" for o in outs.values() for v in o.values())


@pytest.mark.cuda
def test_cuda_pr_transform_kernel_lowering_launches_each_warp_kernel():
    """The kernel lowering reaches all three wrappers on CUDA tensors; the
    hw and sw lowerings reach none."""
    requires_cuda()
    from repro_torch import kernels

    gen = torch.Generator(device="cuda").manual_seed(0)
    warp = prb.BLOCKS[0]
    for low in prb.LOWERINGS:
        kernels.reset_launches()
        for case in prb.CASES.values():
            prb.run_program(case.make(prb.TORCH, warp), prb.make_inputs(case, warp, gen),
                            low, "cuda")
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for name in ("shfl", "vote", "tile_reduce"):
            assert (counts[name] > 0) == (low == "kernel"), (low, name)


@pytest.mark.cuda
def test_cuda_pr_transform_kernel_route_raises_rather_than_falls_back():
    """A collective the table sends to a kernel reaches the kernel on a
    CUDA tensor, so an argument the kernel refuses raises."""
    requires_cuda()
    from repro_torch.core import ir
    from repro_torch.core.pr_transform import run

    prog = ir.ThreadProgram(
        warp=WarpConfig(8, 4), locals={"r": torch.float32},
        stmts=[ir.Collective("r", "shfl_up", lambda env, tid, ctx: env["inp"],
                             {"delta": -1})])
    with pytest.raises(ValueError, match="imm >= 0"):
        run(prog, {"inp": torch.ones(32, device="cuda")}, "kernel", "cuda")


def _matmul_tol(k, dtype):
    return dict(atol=1e-4 * k ** 0.5, rtol=1e-5) if dtype == torch.float32 else CUDA_TOL[dtype]


def _check_matmul(a, b):
    """matmul(a, b) against cuBLAS in full f32 (TF32 off): one launch, a's
    dtype and shape, within the tolerance; returns the max error."""
    torch.backends.cuda.matmul.allow_tf32 = False
    (m, k), n = a.shape, b.shape[1]
    before = matmul.launches
    got = matmul(a, b)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    assert got.dtype == a.dtype and got.shape == (m, n)
    want = matmul_ref(a, b)
    torch.testing.assert_close(got.float(), want.float(), **_matmul_tol(k, a.dtype))
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (1, 1, 1), (37, 19, 70),
                                   (200, 333, 129), (512, 1024, 256),
                                   (128, 128, 128), (1024, 1024, 1024),
                                   (256, 2048, 384), (130, 72, 136)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_matmul_matches_plain(m, k, n, dtype):
    """Ragged edges (130 x 72 x 136: partial tiles and a partial K slice
    through the 16-byte copies) and whole tiles; f32 (3xTF32 on the tensor cores)
    against cuBLAS in full f32 (TF32 off), both accumulating K products in
    f32 in different orders; bf16 products are exact in f32."""
    requires_cuda()
    rng = np.random.default_rng(m + k + n)
    _check_matmul(_cuda(_rand(rng, m, k), dtype), _cuda(_rand(rng, k, n), dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(300, 257, 259), (130, 66, 1030)])
def test_cuda_matmul_narrow_copies(m, k, n, dtype):
    """K and N not multiples of 16 bytes: the kernel's element-by-element
    copy branch, over several K slices and partial tiles."""
    requires_cuda()
    rng = np.random.default_rng(m * k)
    _check_matmul(_cuda(_rand(rng, m, k), dtype), _cuda(_rand(rng, k, n), dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_matmul_offset_views(dtype):
    """Contiguous views one element into their storage: bases not 16-byte
    aligned (the narrow branch), with K and N that would allow the wide one."""
    requires_cuda()
    m, k, n = 256, 512, 384
    rng = np.random.default_rng(11)
    fa, fb = _cuda(_rand(rng, m * k + 1), dtype), _cuda(_rand(rng, k * n + 1), dtype)
    a, b = fa[1:].view(m, k), fb[1:].view(k, n)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    _check_matmul(a, b)
    _check_matmul(a, fb[:-1].view(k, n))   # one aligned operand


@pytest.mark.cuda
def test_cuda_matmul_f32_keeps_the_small_terms():
    """At 1024^3 the kernel's error against cuBLAS f32 is at least 10x
    below a plain TF32 product's (big.big alone, emulated with TF32 off):
    a kernel that dropped the small terms would fail."""
    requires_cuda()
    rng = np.random.default_rng(12)
    a, b = (_cuda(_rand(rng, 1024, 1024), torch.float32) for _ in "ab")
    err = _check_matmul(a, b)
    want = matmul_ref(a, b)
    err_1x = (matmul_1xtf32_emulated(a, b) - want).abs().max().item()
    assert err_1x >= 10 * err, (err_1x, err)


# ---------------------------------------------------------------------------
# captured serving steps (serve/step_graph.py) against the same step eager
# ---------------------------------------------------------------------------

STEP_KINDS_ON_CARD = ("dense", "paged", "paged_int8", "spec", "spec_int8")
STEP_ATTEND = 64


def _step_state(kind: str, seed: int = 0, temperature: float = 0.0, masks=None,
                draft_layers: int = 1) -> dict:
    """A mid-session serving state on the card for one step kind, made
    from ``seed`` (two calls give equal states): the reduced qwen2 in fp32,
    a cache or pool of random rows (int8 pools quantized on the card) with
    each slot's pages in its own table row, tok / pos / remaining / uids,
    the output buffer, and the step's closure over all of them (sampled
    at ``temperature`` > 0 with the engine's keys).  ``masks``: the
    engine's (2, slots) bool fault-mask buffer (nan, collapse) for the
    step to read; ``draft_layers`` the spec kinds' self-draft depth."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model
    from repro_torch.serve import sampling, spec_decode, step_graph
    from repro_torch.serve.kv_cache import quantize_kv_rows

    cfg = reduced_config("qwen2-1.5b")
    model = Model(cfg, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init(gen)
    slots, max_seq, page = 2, 96, 8
    int8 = kind.endswith("int8")
    if kind == "dense":
        cache = model.init_cache(slots, max_seq)
        for leaf in cache.values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    else:
        cache = model.init_cache(slots, max_seq, layout="paged", page_size=page,
                                 kv_dtype="int8" if int8 else None)
        nb = cache["block_tables"].shape[1]
        cache["block_tables"].copy_(torch.arange(1, slots * nb + 1, dtype=torch.int32,
                                                 device="cuda").reshape(slots, nb))
        for name in ("k_pages", "v_pages"):
            rows = torch.randn(cache[name].shape, generator=gen, device="cuda")
            if int8:
                cache[name], cache[name[0] + "_scales"][...] = quantize_kv_rows(rows)
            else:
                cache[name].copy_(rows)
    st = dict(model=model, params=params, cache=cache, restore=None,
              tok=torch.randint(0, cfg.vocab, (slots,), generator=gen, device="cuda",
                                dtype=torch.int32),
              pos=torch.tensor([21, 40], dtype=torch.int32, device="cuda"),
              remaining=torch.tensor([30, 30], dtype=torch.int32, device="cuda"),
              uids=torch.tensor([3, 11], dtype=torch.int32, device="cuda"))
    sampler = (sampling.StepSampler(sampling.prng_key(7, "cuda"), temperature)
               if temperature > 0.0 else None)
    spec_k = 4 if kind.startswith("spec") else 1
    st["out"] = torch.zeros(3 + spec_k, slots, dtype=torch.int32, device="cuda")
    st["restore"] = (st["tok"], st["pos"], st["remaining"])
    if spec_k == 1:
        st["fn"] = step_graph.decode_step_fn(model, params, cache, st["tok"], st["pos"],
                                             st["remaining"], st["out"], STEP_ATTEND,
                                             max_seq, uids=st["uids"], sampler=sampler,
                                             nan_mask=None if masks is None else masks[0])
        return st
    draft, dparams = spec_decode.make_self_draft(model, params, draft_layers)
    dcache = draft.init_cache(slots, max_seq)
    for leaf in dcache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    st["cache"] = dict(cache, draft_k=dcache["k"], draft_v=dcache["v"])
    mask = torch.tensor([True, False], device="cuda")
    step = spec_decode.build_spec_step(model, draft, max_seq=max_seq, spec_k=spec_k,
                                       sampler=sampler)
    pool = {k: v for k, v in cache.items() if k != "block_tables"}
    mkw = {} if masks is None else dict(nan_mask=masks[0], collapse_mask=masks[1])
    st["fn"] = lambda: step(params, dparams, pool, dcache, cache["block_tables"],
                            st["tok"], st["pos"], st["remaining"], st["uids"], mask,
                            STEP_ATTEND, st["out"], **mkw)
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kind", STEP_KINDS_ON_CARD)
def test_cuda_captured_step_replays_eager_step(kind, temperature):
    """Each step kind captured and replayed against the same step run
    eagerly from the same state, in fp32, greedy and sampled (the keys
    computed inside the graph from uids and pos): the output buffer, the
    logits, tok / pos / remaining and every cache leaf (the rows the step
    wrote) bit for bit, step after step; and n replays count the launches
    of n eager steps."""
    requires_cuda()
    from repro_torch import kernels
    from repro_torch.serve.step_graph import StepGraphs

    eager = _step_state(kind, temperature=temperature)
    cap = _step_state(kind, temperature=temperature)
    graphs = StepGraphs("cuda", enabled=True)
    for _ in range(3):
        want = eager["fn"]()
        got = graphs.run((kind, STEP_ATTEND), cap["fn"], restore=cap["restore"])
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for name in ("out", "tok", "pos", "remaining"):
            assert torch.equal(cap[name], eager[name]), name
        for name, leaf in cap["cache"].items():
            assert torch.equal(leaf, eager["cache"][name]), name
    assert len(graphs.graphs) == 1 and graphs.replays == 3
    n = 4
    kernels.reset_launches()
    for _ in range(n):
        graphs.run((kind, STEP_ATTEND), cap["fn"])
    replayed = kernels.launch_counts()
    kernels.reset_launches()
    for _ in range(n):
        eager["fn"]()
    torch.cuda.synchronize()
    assert replayed == kernels.launch_counts()
    attn = ("flash_decode" if kind == "dense" else "paged_flash_verify"
            if kind.startswith("spec") else "paged_flash_decode")
    if kind.endswith("int8"):
        attn += "[int8]"
    assert replayed["rmsnorm"] > 0 and replayed[attn] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(cache_layout="paged", page_size=8, num_pages=5),
    dict(cache_layout="paged", page_size=8, num_pages=5, kv_dtype="int8",
         preempt="swap"),
    dict(cache_layout="paged", page_size=8, num_pages=5, preempt="swap", spec_k=4,
         draft="self:2"),
    dict(cache_layout="paged", page_size=8, prefix_sharing=True),
], ids=["dense", "paged-preempt", "int8-swap", "spec-swap", "shared"])
def test_cuda_pipelined_engine_matches_serial(kw, temperature):
    """The engine on the card, pipelined (captured steps, queued swap
    copies) against serial (eager), reduced qwen2 in fp32, greedy and
    sampled: the same tokens and preemptions; the pipelined run replayed graphs, counted
    their kernels' launches, and materialized every swap copy; a second
    session on the warmed engine captures nothing and serves the same."""
    requires_cuda()
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = reduced_config("qwen2-1.5b")
    model = Model(cfg, dtype=torch.float32)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab, 16).tolist() if kw.get("prefix_sharing") else []
    spec = [(i, prefix + rng.integers(0, cfg.vocab, int(rng.integers(3, 20))).tolist(),
             int(rng.integers(2, 9))) for i in range(6)]

    def serve(eng):
        kernels.reset_launches()
        out = eng.serve([Request(u, list(t), n) for u, t, n in spec])
        torch.cuda.synchronize()
        return out, kernels.launch_counts()

    kw = dict(kw, temperature=temperature, seed=5)
    serial = ServeEngine(model, params, max_seq=48, batch_slots=3, pipeline=False, **kw)
    want, _ = serve(serial)
    eng = ServeEngine(model, params, max_seq=48, batch_slots=3, **kw)
    got, counts = serve(eng)
    assert got == want
    assert eng.preemptions == serial.preemptions
    g = eng.last_graph_stats
    assert g["enabled"] and g["graphs"] >= 1 and g["replays"] >= 1
    assert serial.last_graph_stats["replays"] == 0
    per = g["launches_per_replay"]
    assert per and all(d.get("rmsnorm", 0) > 0 for d in per.values())
    assert counts["rmsnorm"] >= sum(d["rmsnorm"] for d in per.values())
    if kw.get("preempt") == "swap":
        assert eng.last_pool_stats.swap_ins >= 1
    again, _ = serve(eng)
    assert again == want
    assert eng.last_graph_stats["captured"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "serial"])
def test_cuda_open_loop_round_clock_streams_equal_closed_serve(pipeline):
    """Open-loop serving on the card, reduced qwen2 in fp32 on a preempting
    paged pool: Poisson arrivals on the round clock stream the tokens a
    closed ``serve()`` of the same requests returns, every status is OK,
    the pool drains clean, and (pipelined) the session replayed captured
    steps created by its first admissions."""
    requires_cuda()
    import asyncio
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.async_engine import serve_open_loop
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.workload import make_workload

    cfg = reduced_config("qwen2-1.5b")
    model = Model(cfg, dtype=torch.float32)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    wl = make_workload("poisson", 10, vocab=cfg.vocab, seed=5, rate=1.0, prompt_median=8,
                       prompt_max=24, out_median=6, out_max=12)
    kw = dict(max_seq=48, batch_slots=3, cache_layout="paged", page_size=8, num_pages=7,
              pipeline=pipeline)
    eng = ServeEngine(model, params, **kw)
    ok = asyncio.run(serve_open_loop(eng, wl, clock="round"))
    torch.cuda.synchronize()
    sts = {t.request.uid: eng.last_stats[t.request.uid]["status"] for t in wl}
    assert set(sts.values()) == {"ok"}
    p = eng.last_pool_stats
    assert p.audit_ok and p.used_pages == 0
    if pipeline:
        g = eng.last_graph_stats
        assert g["captured"] >= 1 and g["replays"] >= 1
    closed = ServeEngine(model, params, **kw).serve(
        [dataclasses.replace(t.request, generated=None) for t in wl])
    assert ok == closed


@pytest.mark.cuda
def test_cuda_calibrate_times_on_the_device(monkeypatch):
    """``calibrate`` on a CUDA model times with CUDA events on the card (no
    host clock is read) and returns positive measured figures, which
    ``preempt_calibrate=True`` installs."""
    requires_cuda()
    import time

    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model
    from repro_torch.serve import calibrate
    from repro_torch.serve.engine import ServeEngine

    cfg = reduced_config("qwen2-1.5b")
    model = Model(cfg, dtype=torch.float32)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    events = []
    real_event = torch.cuda.Event

    def event(*a, **k):
        events.append(k.get("enable_timing"))
        return real_event(*a, **k)

    def no_host_clock():
        raise AssertionError("a CUDA model's calibration read the host's clock")

    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(time, "perf_counter", no_host_clock)
    cm = calibrate.calibrate(model, params, max_seq=48, repeats=2)
    monkeypatch.undo()
    assert cm.source == "measured" and cm.swap_gbps > 0 and cm.decode_flops_s > 0
    assert events.count(True) == 8          # two repeats of two events, two figures
    eng = ServeEngine(model, params, max_seq=48, batch_slots=2, cache_layout="paged",
                      page_size=8, preempt="auto", preempt_calibrate=True)
    assert eng.cost_model.source == "measured" and eng.cost_model.decode_flops_s > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "serial"])
def test_cuda_chunked_prefill_parks_rows_in_captured_steps(pipeline):
    """Chunked prefill on the card, reduced qwen2 in fp32: a 60-token
    prompt written in 16-token chunks (T * G = 64 rows a KV head: verify's
    long branch) while a short request decodes in captured steps, the
    chunked row parked at max_seq - 1 beyond the live rows' attend
    bucket.  The tokens are the unchunked run's, every step
    synchronizes clean, and the long branch launched."""
    requires_cuda()
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = reduced_config("qwen2-1.5b")
    model = Model(cfg, dtype=torch.float32)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(7)
    spec = [(0, rng.integers(0, cfg.vocab, 5).tolist(), 24),
            (1, rng.integers(0, cfg.vocab, 60).tolist(), 6),
            (2, rng.integers(0, cfg.vocab, 40).tolist(), 4)]
    kw = dict(max_seq=96, batch_slots=2, cache_layout="paged", page_size=8,
              pipeline=pipeline)

    def serve(eng):
        kernels.reset_launches()
        out = eng.serve([Request(u, list(t), n) for u, t, n in spec])
        torch.cuda.synchronize()
        return out, kernels.launch_counts()

    want, _ = serve(ServeEngine(model, params, **kw))
    eng = ServeEngine(model, params, prefill_budget=16, prompt_block=16, **kw)
    parked = []
    dispatch = eng._dispatch_step

    def checked_dispatch(st):
        pending = dispatch(st)
        torch.cuda.synchronize()    # a read out of range faults here
        if st.prefilling:
            parked.append(sorted(st.prefilling))
            assert all(int(st.pos[s]) == 96 for s in st.prefilling)   # stepped once
        return pending

    eng._dispatch_step = checked_dispatch
    got, counts = serve(eng)
    assert got == want
    assert parked, "no step ran beside a parked mid-chunk row"
    assert eng.last_stats[1]["prefill_chunks"] == 4
    assert counts["paged_flash_verify[long]"] > 0
    if pipeline:
        assert eng.last_graph_stats["replays"] > 0
    p = eng.last_pool_stats
    assert p.used_pages == 0


@pytest.mark.cuda
def test_cuda_sampler_bits_equal_cpu():
    """The sampler on the card against the CPU at the full vocabulary:
    keys, random bits, uniforms and both roundings of the scaled logits
    ``torch.equal``; the Gumbel values within GUMBEL_ATOL; the draw
    captured in a CUDA graph equals the eager draw."""
    requires_cuda()
    from repro_torch.serve import sampling

    vocab = 151936
    uids = torch.tensor([0, 1, 7, -3], dtype=torch.int32)
    pos = torch.tensor([544, 401, 301, 65], dtype=torch.int32)
    logits = torch.randn(4, vocab, generator=torch.Generator().manual_seed(0)) * 3
    out = {}
    for dev in ("cpu", "cuda"):
        keys = sampling.fold_in(sampling.fold_in(sampling.prng_key(3, dev), uids.to(dev)),
                                pos.to(dev))
        bits = sampling.random_bits(keys, (vocab,))
        out[dev] = dict(keys=keys, bits=bits,
                        uniform=sampling.uniform_from_bits(bits, sampling.F32_TINY),
                        div=sampling.scale_logits(logits.to(dev), 0.7),
                        mul=sampling.scale_logits(logits.to(dev), 0.7, reciprocal=True),
                        gumbel=sampling.gumbel(keys, (vocab,)))
    for name in ("keys", "bits", "uniform", "div", "mul"):
        assert torch.equal(out["cuda"][name].cpu(), out["cpu"][name]), name
    gdiff = (out["cuda"]["gumbel"].cpu() - out["cpu"]["gumbel"]).abs().max()
    assert gdiff <= sampling.GUMBEL_ATOL

    base = sampling.prng_key(3, "cuda")
    lg, p, u = logits.cuda(), pos.cuda(), uids.cuda()
    want = sampling.sample_at(lg, p, u, base, 0.7, reciprocal=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sampling.sample_at(lg, p, u, base, 0.7, reciprocal=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = sampling.sample_at(lg, p, u, base, 0.7, reciprocal=True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)



# ---------------------------------------------------------------------------
# faults on the card: the captured steps' masks, poison, the degrade, and
# the rows a reused poisoned page still holds
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["paged", "spec"])
def test_cuda_captured_nan_mask_fails_only_its_row(kind):
    """A captured step reading the fault-mask buffer: with row 0 masked,
    the replay flags row 0 alone as bad, row 1's outputs equal an
    unmasked replay's bit for bit, and so does every cache row (the mask
    poisons logits, after the writes); zeroed again, the next replay
    flags nothing."""
    requires_cuda()
    from repro_torch.serve.step_graph import StepGraphs

    masks = torch.zeros(2, 2, dtype=torch.bool, device="cuda")
    plain, masked = _step_state(kind), _step_state(kind, masks=masks)
    graphs = StepGraphs("cuda", enabled=True)
    graphs.run(("plain", STEP_ATTEND), plain["fn"], restore=plain["restore"])
    masks[0, 0] = True
    graphs.run(("masked", STEP_ATTEND), masked["fn"], restore=masked["restore"])
    masks.zero_()
    torch.cuda.synchronize()
    t = masked["out"].shape[0] - 3
    assert masked["out"][t + 2].tolist() == [1, 0]
    assert plain["out"][t + 2].tolist() == [0, 0]
    assert torch.equal(masked["out"][:, 1], plain["out"][:, 1])
    for name, leaf in masked["cache"].items():
        assert torch.equal(leaf, plain["cache"][name]), name
    graphs.run(("masked", STEP_ATTEND), masked["fn"])
    torch.cuda.synchronize()
    assert masked["out"][t + 2].tolist() == [0, 0]


@pytest.mark.cuda
def test_cuda_capture_runs_no_garbage_collection():
    """A captured graph that dies inside another capture (a dropped
    engine's graphs in a reference cycle, freed by the collector) destroys
    its executable mid-capture and invalidates that capture: StepGraphs
    holds the collector off until the capture ends.  With the collector
    set to run at every allocation, collections run in the warm-up and
    none starts while the stream captures."""
    requires_cuda()
    import gc

    from repro_torch.serve.step_graph import StepGraphs

    x = torch.ones(1024, device="cuda")
    seen = []

    def watch(phase, info):
        if phase == "start":
            seen.append(torch.cuda.is_current_stream_capturing())

    thresholds = gc.get_threshold()
    gc.callbacks.append(watch)
    try:
        gc.set_threshold(1)
        graphs = StepGraphs("cuda", enabled=True)
        out = graphs.run("k", lambda: [(x + 1) * 3 for _ in range(50)][-1])
        torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(watch)
        gc.set_threshold(*thresholds)
    assert torch.equal(out, torch.full_like(x, 6.0))
    assert seen and not any(seen)


@pytest.mark.cuda
def test_cuda_captured_spec_collapse_commits_one_token():
    """The spec step with a full-depth self-draft (the target itself, so
    an unmasked window accepts every draft token), captured: a
    collapse-masked speculating row commits one token, the target's own,
    where the unmasked replay commits the window; the other row is
    untouched."""
    requires_cuda()
    from repro_torch.configs import reduced_config
    from repro_torch.serve.step_graph import StepGraphs

    depth = reduced_config("qwen2-1.5b").n_layers
    masks = torch.zeros(2, 2, dtype=torch.bool, device="cuda")
    plain = _step_state("spec", draft_layers=depth)
    collapsed = _step_state("spec", masks=masks, draft_layers=depth)
    for st in (plain, collapsed):
        # the draft's dense cache holds the target's paged rows (slot s's
        # pages are 1 + s * nb .. in its table row), so it sees what the
        # target sees
        c = st["cache"]
        nb = c["block_tables"].shape[1]
        for name in ("k", "v"):
            pages, dense = c[f"{name}_pages"], c[f"draft_{name}"]
            for slot in range(dense.shape[1]):
                rows = pages[:, 1 + slot * nb:1 + (slot + 1) * nb].flatten(1, 2)
                dense[:, slot].copy_(rows[:, :dense.shape[2]])
    graphs = StepGraphs("cuda", enabled=True)
    graphs.run(("plain", STEP_ATTEND), plain["fn"], restore=plain["restore"])
    masks[1, 0] = True
    graphs.run(("collapse", STEP_ATTEND), collapsed["fn"], restore=collapsed["restore"])
    masks.zero_()
    torch.cuda.synchronize()
    t = 4
    assert plain["out"][t, 0].item() == t          # the draft is the target
    assert collapsed["out"][t, 0].item() == 1
    assert collapsed["out"][0, 0] == plain["out"][0, 0]
    assert torch.equal(collapsed["out"][:, 1], plain["out"][:, 1])
    assert collapsed["out"][t + 2].tolist() == [0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_cuda_poison_pages_bytes_equal_cpu(kind):
    """``poison_pages`` on a pool on the card writes the CPU version's
    bytes: NaN in bf16 values and in int8 pools' f32 scales, 0 in int8
    values."""
    requires_cuda()
    from repro_torch.serve.faults import poison_pages

    rows = torch.randn(2, 2, 7, 4, 2, 128, generator=torch.Generator().manual_seed(1))
    if kind == "int8":
        cpu = {}
        for i, name in enumerate("kv"):
            cpu[f"{name}_pages"], cpu[f"{name}_scales"] = quantize_kv_rows(rows[i])
    else:
        cpu = {f"{n}_pages": rows[i].to(torch.bfloat16) for i, n in enumerate("kv")}
    card = {n: t.cuda() for n, t in cpu.items()}
    ptrs = {n: t.data_ptr() for n, t in card.items()}
    poison_pages(cpu, [2, 5])
    poison_pages(card, [2, 5])
    torch.cuda.synchronize()
    assert {n: t.data_ptr() for n, t in card.items()} == ptrs
    for name, leaf in cpu.items():
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}[leaf.element_size()]
        assert torch.equal(card[name].cpu().view(ints), leaf.view(ints)), name


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [1, 4, 16], ids=["decode", "verify", "verify-long"])
def test_cuda_reused_poisoned_page_yields_finite_outputs(t, dtype, quantized):
    """A page poisoned, freed and reused: its new owner wrote rows [0, pos
    + t); the rest of it and the next page still hold NaN (int8: 0 values
    under NaN scales).  ``paged_flash_decode`` (T 1), ``paged_flash_verify``
    (T 4, the split kernel; T 16 = T*G 96, the long branch) and their int8
    branches must never read them: finite outputs, bit for bit those with
    the poison replaced by finite garbage, and the plain version's within
    the kernel tolerance."""
    requires_cuda()
    from repro_torch.testing import reused_poisoned_case

    q, pool, bt, pos = reused_poisoned_case(np.random.default_rng(3), t=t, quantized=quantized,
                                            dtype=dtype, device="cuda")
    assert any(torch.isnan(v).any() for v in pool.values() if v.is_floating_point())
    clean = {k: torch.nan_to_num(v, nan=7.0) if v.is_floating_point() else v
             for k, v in pool.items()}

    def attend(p, plain=False):
        scales = {k: p[k] for k in ("k_scales", "v_scales") if k in p}
        if t == 1:
            fn = paged_flash_decode_ref if plain else paged_flash_decode
            return fn(q, p["k_pages"], p["v_pages"], bt, pos, **scales)
        if plain:
            return paged_verify_attention_ref(q, p["k_pages"], p["v_pages"], bt, pos, t,
                                              **scales)
        return paged_flash_verify(q, p["k_pages"], p["v_pages"], bt, pos, t_window=t,
                                  **scales)

    got = attend(pool)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, attend(clean))
    _close(got, attend(pool, plain=True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "serial"])
def test_cuda_kernel_wrapper_error_escapes_on_the_kernels(pipeline, monkeypatch):
    """A real kernel failure is not an injected one: a RuntimeError from
    the paged decode wrapper on the card escapes serve() with no recovery
    and no degrade (every request failed as aborted, the pool drained
    audit-clean), and with the wrapper repaired the next session gives
    the fault-free tokens through the hand-written kernels."""
    requires_cuda()
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models import attention
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import STATUS_FAILED, Request, ServeEngine

    cfg = reduced_config("qwen2-1.5b")
    model = Model(cfg, dtype=torch.float32)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(3)
    spec = [(i, rng.integers(0, cfg.vocab, int(rng.integers(3, 20))).tolist(), 8)
            for i in range(4)]

    def serve(eng):
        kernels.reset_launches()
        out = eng.serve([Request(u, list(p), n) for u, p, n in spec])
        torch.cuda.synchronize()
        return out, kernels.launch_counts()

    kw = dict(max_seq=48, batch_slots=2, cache_layout="paged", page_size=8,
              pipeline=pipeline)
    want, _ = serve(ServeEngine(model, params, **kw))
    eng = ServeEngine(model, params, **kw)
    real, calls = attention.paged_flash_decode, []

    def broken(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("paged_flash_decode: launch failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(attention, "paged_flash_decode", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        serve(eng)
    assert eng.recoveries == 0 and not eng.backend_degraded
    assert eng.model.use_kernels and eng.verify_backend != "torch"
    assert {eng.last_stats[u]["status"] for u, _, _ in spec} == {STATUS_FAILED}
    assert eng.last_pool_stats.audit_ok and eng.last_pool_stats.used_pages == 0
    monkeypatch.setattr(attention, "paged_flash_decode", real)
    got, counts = serve(eng)
    assert got == want
    assert counts["paged_flash_decode"] > 0, counts
    assert eng.recoveries == 0 and not eng.backend_degraded


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "serial"])
def test_cuda_kernel_fault_drops_graphs_and_recaptures_plain(pipeline):
    """A ``kernel`` fault mid-decode on the card, reduced qwen2 in fp32:
    the engine recovers once and degrades (``use_kernels`` off, verify on
    the plain version); the pipelined engine drops its graphs and
    captures again, and no re-captured graph launches a hand-written
    serving kernel; a session after it launches none; the tokens are the
    fault-free kernel run's."""
    requires_cuda()
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.faults import Fault, FaultSchedule

    cfg = reduced_config("qwen2-1.5b")
    model = Model(cfg, dtype=torch.float32)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(3)
    spec = [(i, rng.integers(0, cfg.vocab, int(rng.integers(3, 20))).tolist(), 8)
            for i in range(4)]

    def serve(eng, faults=None):
        kernels.reset_launches()
        out = eng.serve([Request(u, list(p), n) for u, p, n in spec], faults=faults)
        torch.cuda.synchronize()
        return out, kernels.launch_counts()

    kw = dict(max_seq=48, batch_slots=2, cache_layout="paged", page_size=8,
              pipeline=pipeline)
    want, _ = serve(ServeEngine(model, params, **kw))
    eng = ServeEngine(model, params, **kw)
    assert serve(eng)[0] == want and not eng.backend_degraded
    got, _ = serve(eng, FaultSchedule([Fault("kernel", step=4)]))
    assert got == want
    assert eng.backend_degraded and eng.recoveries == 1
    assert not eng.model.use_kernels and eng.verify_backend == "torch"
    g = eng.last_graph_stats
    names = ("rmsnorm", "flash_attention_fwd", "flash_decode", "paged_flash_decode")
    if pipeline:
        assert g["dropped"] >= 1 and g["captured"] >= 1 and g["graphs"] >= 1
        for d in g["launches_per_replay"].values():
            assert not any(d.get(n, 0) for n in names), d
    again, counts = serve(eng)
    assert again == want
    assert not any(counts[n] for n in names), counts
    assert eng.last_pool_stats.audit_ok and eng.last_pool_stats.used_pages == 0


# ---------------------------------------------------------------------------
# A14a, A12: the MoE target's verify window, the fleet
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cuda_verify_at_olmoe_shape_matches_plain(int8):
    """The MoE target's speculative window: OLMoE's G = 1 (Hkv = Hq = 16),
    T 4, D 128, on ``paged_verify_case``'s shuffled pages and garbage,
    bf16 q over bf16 pages or int8 pages, against the plain version."""
    requires_cuda()
    args = _verify_args(4, 1, 128, torch.bfloat16, seed=9, hkv=16)
    q, kp, vp, bt, pos = args
    sc = {}
    if int8:
        kp, ks = quantize_kv_rows(kp.float())
        vp, vs = quantize_kv_rows(vp.float())
        sc = dict(k_scales=ks, v_scales=vs)
    before = paged_flash_verify.launches + paged_flash_verify.launches_int8
    got = paged_flash_verify(q, kp, vp, bt, pos, t_window=4, **sc)
    torch.cuda.synchronize()
    assert paged_flash_verify.launches + paged_flash_verify.launches_int8 == before + 1
    assert torch.isfinite(got).all()
    _close(got, paged_verify_attention_ref(q, kp, vp, bt, pos, 4, **sc), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("disaggregate", [False, True], ids=["mixed", "disaggregated"])
def test_cuda_fleet_matches_direct_engine(disaggregate):
    """A fleet on the card (reduced qwen2 in fp32, pipelined workers
    replaying captured steps): 2 mixed replicas behind the cache-aware
    router, or 1 prefill + 1 decode replica joined by the SwapHandle
    handoff, serve one direct engine's tokens; the fleet audits clean and
    a handoff restores its pages."""
    requires_cuda()
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.cluster import make_cluster
    from repro_torch.serve.engine import Request, ServeEngine

    model = Model(reduced_config("qwen2-1.5b"), dtype=torch.float32)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(4)
    spec = [(i, rng.integers(0, 512, int(rng.integers(3, 20))).tolist(),
             int(rng.integers(2, 9))) for i in range(6)]
    kw = dict(max_seq=48, batch_slots=2, cache_layout="paged", page_size=8)
    want = ServeEngine(model, params, **kw).serve([Request(u, list(p), n)
                                                   for u, p, n in spec])
    c = make_cluster(model, params, replicas=2, disaggregate=disaggregate, **kw)
    got = c.serve([Request(u, list(p), n) for u, p, n in spec])
    assert got == want
    assert c.audit_report.ok
    assert any(w.engine.last_graph_stats.get("replays", 0) for w in c.workers.values())
    if disaggregate:
        assert c.last_stats["router"]["handoffs"] == len(spec)
        assert c.last_pool_stats[1].swap_ins == len(spec)


# ---------------------------------------------------------------------------
# no-fallback guards
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(' '.join(mods))\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": src},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 30
    for name in ("core", "core.primitives", "core.sw_backend", "bench",
                 "bench.fig5_microbench", "kernels.warp_ops.ops",
                 "kernels.tile_reduce.ops", "kernels.mse.ops", "kernels.matmul.ops",
                 "kernels.verify_attention.ops", "serve.spec_decode",
                 "optim.optimizer", "train.step", "train.trainer",
                 "data.pipeline", "launch.train", "models.moe",
                 "kernels.moe_gating.ops", "kernels.moe_gating.ref",
                 "configs.olmoe_1b_7b", "configs.granite_moe_1b_a400m",
                 "serve.calibrate", "serve.kv_cache", "serve.prefix_index",
                 "serve.engine", "serve.step_graph", "core.ir", "core.pr_transform",
                 "bench.pr_transform_bench", "bench.table4_overhead", "quickstart",
                 "serve.sampling", "serve_lm", "serve.sla", "serve.async_engine",
                 "launch.serve", "checkpoint.checkpoint", "checkpoint._manifest_codec",
                 "train_lm", "serve.cluster", "serve.cluster.worker",
                 "serve.cluster.router", "serve.cluster.controller",
                 "configs.qwen1_5_32b", "configs.qwen1_5_110b", "configs.minicpm3_4b"):
        assert f"repro_torch.{name}" in mods, name


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
        params_from_numpy({"embed": np.zeros(2)}, reduced_config("qwen2-1.5b"),
                          device="cuda")
    assert resolve_device("cpu").type == "cpu"


# ---------------------------------------------------------------------------
# A14c: head dim 80 (Zamba2's shared attention), RWKV6 and Zamba2 serving
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,hq,hkv,kv_len,causal", [
    (1, 512, 32, 32, None, True),          # Zamba2's prefill call
    (2, 77, 8, 2, [77, 30], True),         # ragged length, kv_len in a tile, G 4
    (2, 64, 4, 4, [64, 0], False),         # non-causal, a fully masked row
], ids=["zamba2-prefill", "g4-kv-len", "noncausal-empty-row"])
def test_cuda_flash_fwd_d80_matches_plain(b, s, hq, hkv, kv_len, causal, dtype):
    """The forward's (80, 80) instance, each dtype branch, against the
    plain version on the same inputs; K/V rows past kv_len hold NaN, which
    the kernel never reads.  Counted in ``launches_d80`` /
    ``launches_d80_f32`` alone."""
    requires_cuda()
    from repro_torch import kernels

    rng = np.random.default_rng(31)
    q = _cuda(_rand(rng, b, s, hq, 80), dtype)
    k, v = _rand(rng, b, s, hkv, 80), _rand(rng, b, s, hkv, 80)
    lens = None
    if kv_len is not None:
        for i, n in enumerate(kv_len):
            k[i, n:], v[i, n:] = np.nan, np.nan
        lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    k, v = _cuda(k, dtype), _cuda(v, dtype)
    before = kernels.launch_counts()
    o, lse = flash_attention_fwd(q, k, v, lens, causal=causal)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    key = "flash_attention_fwd[d80]" if dtype == torch.bfloat16 else "flash_attention_fwd[d80,f32]"
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {key: 1}
    want_o, want_lse = flash_attention_ref(q.float(), torch.nan_to_num(k.float()),
                                           torch.nan_to_num(v.float()), lens, causal=causal)
    assert torch.isfinite(o).all()
    _close(o.float(), want_o, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hkv,g,s,pos", [
    (4, 32, 1, 576, [575, 300, 128, 7]),   # Zamba2's decode, G 1
    (3, 2, 4, 200, [0, 63, 199]),          # grouped, a split edge
    (2, 4, 6, 100, [99, 40]),
], ids=["zamba2-g1", "g4", "g6"])
def test_cuda_flash_decode_d80_matches_plain(b, hkv, g, s, pos, dtype):
    """Dense decode's D = 80 instance (16 lanes a key row, 6 idle) against
    the plain version; keys past pos hold NaN, never read.  Counted in
    ``flash_decode.launches_d80`` alone."""
    requires_cuda()
    from repro_torch import kernels

    rng = np.random.default_rng(32)
    q = _cuda(_rand(rng, b, hkv, g, 80), dtype)
    k, v = _rand(rng, b, s, hkv, 80), _rand(rng, b, s, hkv, 80)
    for i, p in enumerate(pos):
        k[i, p + 1:], v[i, p + 1:] = np.nan, np.nan
    k, v = _cuda(k, dtype), _cuda(v, dtype)
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    before = kernels.launch_counts()
    got = flash_decode(q, k, v, p)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {
        "flash_decode[d80]": 1}
    want = flash_decode_ref(q.float(), torch.nan_to_num(k.float()),
                            torch.nan_to_num(v.float()), p)
    assert torch.isfinite(got).all()
    _close(got.float(), want, dtype)


# Zamba2 training's backward, the (80, 80) instance: its shared block's
# G = 1 (32 / 32 heads), a grouped G 4, causal and not, kv_len inside a
# tile, a fully masked row, sequence lengths off every tile size
D80_BWD_CASES = [
    (1, 512, 32, 32, None, True),
    (2, 77, 8, 2, [77, 30], True),
    (2, 45, 4, 4, [45, 9], False),
    (2, 64, 4, 4, [64, 0], False),
    (2, 1024, 8, 8, [1024, 700], True),
]
D80_BWD_IDS = ["zamba2-heads", "g4-ragged-len", "g1-noncausal-len", "noncausal-empty-row",
               "s1024-len"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,hq,hkv,kv_len,causal", D80_BWD_CASES, ids=D80_BWD_IDS)
def test_cuda_flash_bwd_d80_matches_plain(b, s, hq, hkv, kv_len, causal, dtype):
    """The backward's (80, 80) instance against its plain version: dq, dk
    and dv of 80 columns, each KV head's group summed, and columns 64-79
    held on their own (the f32 kernels' lanes 0-15 own a third column
    there, the bf16 kernels' last k16 step and n8 tiles); only the dtype
    branch's ``[d80]`` counter moves."""
    requires_cuda()
    from repro_torch import kernels

    rng = np.random.default_rng(35)
    args = _bwd_case(rng, b, s, s, hq, hkv, 80, kv_len, causal, dtype)
    moved = "flash_attention_bwd[d80]" if dtype == torch.bfloat16 else \
        "flash_attention_bwd[d80,f32]"
    before = kernels.launch_counts()
    got = flash_attention_bwd(*args, causal=causal)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {moved: 1}
    want = flash_attention_bwd_ref(*args, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape[-1] == 80, name
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, **BWD_TOL, msg=name)
        tail = w[..., 64:]
        assert tail.abs().max() > 1e-3, name                   # the columns carry gradient
        torch.testing.assert_close(g[..., 64:], tail, **BWD_TOL, msg=f"{name}[..., 64:]")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_bwd_d80_is_deterministic(dtype):
    """No atomics at (80, 80) either: two calls give the same bits."""
    requires_cuda()
    rng = np.random.default_rng(36)
    args = _bwd_case(rng, 2, 1024, 1024, 8, 2, 80, [1024, 700], True, dtype)
    first = flash_attention_bwd(*args)
    second = flash_attention_bwd(*args)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b_), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv_len,causal", [(None, True), ([29, 12], False)])
def test_cuda_flash_mha_grads_at_d80_match_cpu_plain_path(kv_len, causal, dtype):
    """``flash_mha``'s output and gradients at (80, 80) on the card (both
    kernels' (80, 80) instances) against the same Function on the CPU
    (both plain versions) on the same values."""
    requires_cuda()
    rng = np.random.default_rng(37)
    q, k, v, g = (_rand(rng, 2, 29, 4, 80) for _ in "qkvg")
    lens = None if kv_len is None else np.asarray(kv_len, np.int32)

    def grads(device):
        leaves = [torch.tensor(a, device=device).to(dtype).requires_grad_()
                  for a in (q, k, v)]
        ln = None if lens is None else torch.tensor(lens, device=device)
        o = flash_mha(*leaves, ln, causal=causal)
        o.backward(torch.tensor(g, device=device).to(dtype))
        return [o.detach().cpu()] + [t.grad.cpu() for t in leaves]

    counter = "launches_d80" if dtype == torch.bfloat16 else "launches_d80_f32"
    before = getattr(flash_attention_bwd, counter), getattr(flash_attention_fwd, counter)
    got = grads("cuda")
    assert (getattr(flash_attention_bwd, counter), getattr(flash_attention_fwd, counter)) \
        == (before[0] + 1, before[1] + 1)
    want = grads("cpu")
    tol = BWD_TOL if dtype == torch.float32 else CUDA_TOL[dtype]
    for name, a, b_ in zip(("o", "dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b_.float(), **tol, msg=name)


@pytest.mark.cuda
def test_cuda_d80_unbuilt_sites_raise():
    """Head dim 80 exists for the flash forward, the flash backward (since
    Zamba2's training) and dense decode: paged decode and the verify
    window still raise ``ValueError`` at 80 (no paged family has heads of
    80), and so does a pair with no instance, (80, 64), in the backward
    and the forward, each before any launch."""
    requires_cuda()
    from repro_torch import kernels

    rng = np.random.default_rng(33)
    q, k, v, do = (_cuda(_rand(rng, 1, 16, 2, 80), torch.float32) for _ in "qkvo")
    v64, do64 = (_cuda(_rand(rng, 1, 16, 2, 64), torch.float32) for _ in "vo")
    lse, delta = (torch.zeros(1, 2, 16, device="cuda") for _ in "ld")
    qd = _cuda(_rand(rng, 1, 2, 1, 80), torch.float32)
    pages = _cuda(_rand(rng, 3, 8, 2, 80), torch.float32)
    bt = torch.tensor([[1, 2]], dtype=torch.int32, device="cuda")
    pos = torch.tensor([9], dtype=torch.int32, device="cuda")
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_bwd(q, k, v64, do64, lse, delta)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_fwd(q, k, v64)
    with pytest.raises(ValueError, match="head dims"):
        paged_flash_decode(qd, pages, pages, bt, pos)
    with pytest.raises(ValueError, match="head dims"):
        paged_flash_verify(qd, pages, pages, bt, pos, t_window=1)
    assert kernels.launch_counts() == before
    flash_attention_bwd(q, k, v, do, lse, delta)            # (80, 80) is built
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_bwd[d80,f32]"] == (
        before["flash_attention_bwd[d80,f32]"] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_cuda_recurrent_train_steps_match_cpu_plain_path(arch):
    """Recurrent training as a whole on the card: three fp32 Trainer steps
    of the reduced config (RWKV6 cut to 2 layers; Zamba2's shared block at
    heads of 80, so its attention runs the flash forward's and backward's
    (80, 80) f32 instances, forward, remat and backward; the scans'
    backward is autograd over the time loop) against the same steps on the
    CPU's plain versions, from the same weights and batches (the
    tolerances of ``test_cuda_train_steps_match_cpu_plain_path``)."""
    requires_cuda()
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.step import TrainState
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = reduced_config(arch)
    cfg = (dataclasses.replace(cfg, n_layers=2) if arch == "rwkv6-7b"
           else dataclasses.replace(cfg, d_head=80))
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2,
                                        seed=4))
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    base = Model(cfg, device="cpu", dtype=torch.float32).init(
        torch.Generator().manual_seed(0))

    def run(device, params):       # the steps update params in place
        model = Model(cfg, device=device, dtype=torch.float32)
        tr = Trainer(model, data, opt, TrainerConfig(total_steps=3, vocab_chunks=4))
        _, hist = tr.run(start_state=TrainState(params, init_adamw(params)))
        return [m["loss"] for _, m in hist]

    kernels.reset_launches()
    got = run("cuda", _to_cuda(base))
    counts = kernels.launch_counts()
    want = run("cpu", base)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert counts["rmsnorm"] > 0 and counts["rmsnorm[ragged]"] == 0
    flash = {n: c for n, c in counts.items() if n.startswith("flash") and c}
    if arch == "zamba2-2.7b":
        groups = cfg.n_layers // cfg.hybrid_attn_every
        # the shared block is not rematted: one forward, one backward a group
        assert flash == {"flash_attention_fwd[d80,f32]": 3 * groups,
                         "flash_attention_bwd[d80,f32]": 3 * groups}
    else:
        assert flash == {}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_cuda_recurrent_serving_matches_cpu_plain_path(arch):
    """Reduced RWKV6 / Zamba2 served on the card in fp32 (the scans in
    plain torch, the norms through rmsnorm, Zamba2's attention through
    the flash forward and flash_decode, the decode steps captured as
    graphs): greedy tokens equal to the CPU's plain versions on the same
    weights, and prefill logits within fp32 summation order."""
    requires_cuda()
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = reduced_config(arch)
    base = Model(cfg, device="cpu", dtype=torch.float32).init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(34)
    spec = [(i, rng.integers(0, cfg.vocab, int(n)).tolist(), 6)
            for i, n in enumerate(rng.integers(5, 40, 3))]
    toks = torch.tensor([spec[0][1]])

    def run(device, params):
        model = Model(cfg, device=device, dtype=torch.float32)
        logits, _ = model.prefill(params, toks, 64)
        eng = ServeEngine(model, params, max_seq=64, batch_slots=2)
        return logits.cpu(), eng.serve([Request(u, list(p), n) for u, p, n in spec]), eng

    kernels.reset_launches()
    got_logits, got, eng = run("cuda", _to_cuda(base))
    counts = kernels.launch_counts()
    want_logits, want, _ = run("cpu", base)
    assert got == want
    torch.testing.assert_close(got_logits, want_logits, atol=1e-4, rtol=1e-4)
    assert counts["rmsnorm"] > 0 and counts["rmsnorm[ragged]"] == 0
    assert eng.last_graph_stats.get("replays", 0) > 0
    if arch == "zamba2-2.7b":
        assert counts["flash_attention_fwd[f32]"] > 0 and counts["flash_decode"] > 0
    else:
        assert counts["flash_attention_fwd[f32]"] == counts["flash_decode"] == 0


def test_recurrent_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("rwkv6-7b", "zamba2-2.7b"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(reduced_config(arch))
    # a CPU tensor takes the plain version at head dim 80, a CUDA request raises
    q = torch.zeros(1, 4, 2, 80)
    assert flash_attention_fwd(q, q, q)[0].shape == (1, 4, 2, 80)
