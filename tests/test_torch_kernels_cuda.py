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
    before = rmsnorm.launches, rmsnorm.launches_ragged
    got = rmsnorm(x, w, 1e-6)
    torch.cuda.synchronize()
    moved = rmsnorm.launches - before[0], rmsnorm.launches_ragged - before[1]
    assert moved in ((1, 0), (0, 1)), moved
    return got, "warp" if moved[0] else "ragged"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,w_f32,branch", [
    ((512, 2048), False, "warp"),     # OLMoE's d_model: 8 bf16 vectors a lane
    ((8192, 1536), True, "warp"),     # training: rows under an fp32 weight
    ((33, 1024), False, "warp"),      # Granite-MoE's d_model
    ((5, 264), False, "warp"),        # lanes holding unequal numbers of vectors
    ((37, 70), False, "ragged"),      # not a whole number of 16-byte vectors
    ((64, 1538), False, "ragged"),
    ((16, 4096), False, "ragged"),    # wider than the warp branch holds
])
def test_cuda_rmsnorm_branches_match_plain(shape, w_f32, branch, dtype):
    """Which branch each width takes, and both against the plain version."""
    requires_cuda()
    rng = np.random.default_rng(shape[-1])
    x = _cuda(_rand(rng, *shape), dtype)
    w = _cuda(_rand(rng, shape[-1]), torch.float32 if w_f32 else dtype)
    got, ran = _rmsnorm_branch(x, w)
    assert ran == branch and got.dtype == dtype and got.shape == x.shape
    _close(got, rmsnorm_ref(x, w, 1e-6), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_rmsnorm_offset_views(dtype):
    """A contiguous view whose base sits one element into its storage is
    not 16-byte aligned (ragged branch); one whole row in, it is (warp)."""
    requires_cuda()
    n, d = 300, 1536
    flat = _cuda(_rand(np.random.default_rng(7), (n + 2) * d), dtype)
    w = _cuda(_rand(np.random.default_rng(8), d), dtype)
    for offset, branch in ((1, "ragged"), (d, "warp")):
        x = flat[offset:offset + n * d].view(n, d)
        got, ran = _rmsnorm_branch(x, w)
        assert ran == branch
        _close(got, rmsnorm_ref(x, w, 1e-6), dtype)


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
    kernel takes; above it the wrapper raises."""
    requires_cuda()
    args = _verify_args(4, 8, 128, dtype, hkv=1)
    got = paged_flash_verify(*args, t_window=4)
    torch.cuda.synchronize()
    _close(got, paged_verify_attention_ref(*args, 4), dtype)
    args = _verify_args(3, 11, 64, dtype, hkv=1)
    with pytest.raises(ValueError, match="<= 32"):
        paged_flash_verify(*args, t_window=3)
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
    x = torch.zeros(4, 64, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        moe_gating(x, 8)


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
                 "serve.calibrate", "serve.kv_cache"):
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
