"""The split-bf16 arithmetic of the port's tensor-core flash kernels, on the
CPU, where the kernels cannot run.

The bf16 branches of ``flash_attention.cu`` and ``flash_attention_bwd.cu``
take q, k, v and dO as bf16 operands of m16n8k16 products (exact products,
fp32 sums) and feed P and dS into their second products as hi + lo, two
bf16 values: hi = bf16(x), lo = bf16(x - hi).  These tests pin that down:
the split gives x back to 2^-16, a plain emulation of the kernels'
products matches the reference's Pallas forward and backward (interpret
mode) within the card tests' BWD_TOL, and the same emulation with hi alone
is at least 10x further off, which is why the kernels carry lo.  The
cases include MLA's (D, Dv) = (96, 64) instance, where dP and dv run over
the value head dim, and Zamba2's (80, 80), five k16 steps a product."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_bwd as jax_flash_bwd,
)
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_fwd as jax_flash_fwd,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    FULLY_MASKED_LSE,
    MASK_VALUE,
)

# the card tests' tolerance for the backward (tests/test_torch_kernels_cuda.py)
BWD_TOL = dict(atol=1e-4, rtol=1e-4)
# hi alone must be at least this many times further from the reference
HI_ONLY_FACTOR = 10


def split(x: torch.Tensor):
    """fp32 x -> (hi, lo) as the kernels form them (round to nearest even),
    returned widened to fp32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round to bf16 and widen back: the kernels' operands, exactly."""
    return torch.as_tensor(a).to(torch.bfloat16).float().numpy()


def _product(a, b, lo: bool):
    """a @ b with a entering as hi + lo (or hi alone): two products of
    bf16 operands with fp32 sums, as the kernels' mma.sync pairs."""
    hi, lo_part = split(a)
    out = hi @ b
    return out + lo_part @ b if lo else out


def _valid(bh, s, lens, causal):
    ki = torch.arange(s)
    valid = torch.ones(bh, s, s, dtype=torch.bool)
    if causal:
        valid &= (torch.arange(s)[:, None] >= ki[None, :])[None]
    if lens is not None:
        valid &= (ki[None, None, :] < torch.as_tensor(lens)[:, None, None])
    return valid


def emulate_fwd(q, k, v, lens, causal, lo=True):
    """The forward kernel's products on head-flat (BH, S, D) fp32 arrays
    holding bf16 values: S = Q K^T exact, the masked softmax in fp32, P as
    hi + lo into P V.  Returns (o, lse) in fp32."""
    q, k, v = map(torch.as_tensor, (q, k, v))
    bh, s, d = q.shape
    valid = _valid(bh, s, lens, causal)
    sc = torch.where(valid, q @ k.transpose(1, 2) * d ** -0.5, MASK_VALUE)
    m = sc.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(sc - m), 0.0)
    l = p.sum(-1, keepdim=True)
    safe = torch.where(l == 0.0, 1.0, l)
    o = _product(p, v, lo) / safe
    lse = torch.where(l == 0.0, FULLY_MASKED_LSE, m + torch.log(safe))[..., 0]
    return o.numpy(), lse.numpy()


def emulate_bwd(q, k, v, do, lse, delta, lens, causal, lo=True):
    """The dq and dk/dv kernels' products: S and dP exact, p rebuilt from
    lse under the mask, ds = p (dP - delta) scale; dq = ds K, dk = ds^T Q
    and dv = p^T dO with p and ds as hi + lo.  Per head-flat row, so dk/dv
    are the per-query-head partials the dk/dv kernel writes."""
    q, k, v, do, lse, delta = map(torch.as_tensor, (q, k, v, do, lse, delta))
    bh, s, d = q.shape
    scale = d ** -0.5
    valid = _valid(bh, s, lens, causal)
    p = torch.where(valid, torch.exp(q @ k.transpose(1, 2) * scale - lse[..., None]), 0.0)
    ds = p * (do @ v.transpose(1, 2) - delta[..., None]) * scale
    dq = _product(ds, k, lo)
    dk = _product(ds.transpose(1, 2), q, lo)
    dv = _product(p.transpose(1, 2), do, lo)
    return dq.numpy(), dk.numpy(), dv.numpy()


def _case(rng, b, hkv, g, s, d, dv, kv_len):
    """Head-flat bf16-valued q, k (head dim d), v, dO (head dim dv; K/V
    repeated per query head, as the reference's flash_mha does) and
    per-head valid lengths."""
    hq = hkv * g

    def rand(*shape):
        return _bf16(rng.standard_normal(shape).astype(np.float32))

    q, do = rand(b * hq, s, d), rand(b * hq, s, dv)
    k, v = rand(b * hkv, s, d), rand(b * hkv, s, dv)
    k, v = (np.repeat(x.reshape(b, hkv, s, x.shape[-1]), g, axis=1)
            .reshape(b * hq, s, x.shape[-1]) for x in (k, v))
    lens = None if kv_len is None else np.repeat(np.asarray(kv_len, np.int32), hq)
    return q, k, v, do, lens


def _pallas_fwd(q, k, v, lens, causal, block):
    o, lse = jax_flash_fwd(*map(jnp.asarray, (q, k, v)),
                           None if lens is None else jnp.asarray(lens),
                           causal=causal, block_q=block, block_k=block, interpret=True)
    return np.array(o), np.array(lse)


def _max_err(got, want) -> float:
    return max(float(np.abs(np.asarray(a, np.float64) - np.asarray(w, np.float64)).max())
               for a, w in zip(got, want))


# (B, Hkv, G, S, D, Dv, kv_len, causal, Pallas block): G 1 (OLMoE,
# MiniCPM3, Zamba2) and 6 (qwen2), D 64 and 128, MLA's D 96 over Dv 64,
# Zamba2's D = Dv = 80, kv_len inside a block, non-causal calls
CASES = [
    (1, 1, 1, 256, 64, 64, None, True, 128),
    (1, 1, 6, 128, 128, 128, None, True, 64),
    (2, 1, 6, 128, 64, 64, [128, 77], True, 64),
    (2, 1, 1, 128, 128, 128, [93, 128], False, 128),
    (1, 2, 1, 128, 96, 64, None, True, 64),
    (2, 1, 4, 128, 96, 64, [101, 128], False, 64),
    (1, 2, 1, 128, 80, 80, None, True, 64),
    (2, 1, 1, 128, 80, 80, [77, 128], False, 64),
]
CASE_IDS = ["g1-d64-s256", "g6-d128", "g6-d64-kvlen", "g1-d128-noncausal-kvlen",
            "g1-d96-dv64", "g4-d96-dv64-noncausal-kvlen", "g1-d80", "g1-d80-noncausal-kvlen"]


@pytest.mark.parametrize("kind", ["p-in-unit", "signed-ds", "ties-and-zeros"])
def test_split_gives_x_back_to_2_pow_minus_16(kind):
    """hi and lo are bf16 values, x - float(hi) is exact in fp32, and
    hi + lo gives back x to 2^-16 relative (2^-17 in fact); ties round to
    even, as __floats2bfloat162_rn does."""
    rng = np.random.default_rng(0)
    n = 1 << 16
    if kind == "p-in-unit":                 # softmax probabilities
        x = np.concatenate([rng.uniform(0.0, 1.0, n), [0.0, 1.0, 2.0 ** -126]])
    elif kind == "signed-ds":               # ds over many magnitudes
        x = rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 3, n)
    else:                                   # halfway between bf16 neighbours
        mant = rng.integers(128, 256, n)    # 8-bit significands of [1, 2)
        x = (mant + 0.5) / 128.0 * 2.0 ** rng.integers(-40, 40, n)
        x = np.concatenate([x * rng.choice([-1.0, 1.0], n), [0.0, -0.0]])
    x = torch.tensor(x, dtype=torch.float32)
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    lo = r.to(torch.bfloat16)
    assert torch.equal(r.double(), x.double() - hi.double())          # exact in fp32
    for h in (hi, lo):                                                 # bf16 values
        assert torch.equal(h.float().to(torch.bfloat16), h)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -16 * x.double().abs()).all()
    if kind == "ties-and-zeros":
        ties = x != 0
        assert ((hi[ties].view(torch.int16) & 1) == 0).all()           # to even
        assert (err[ties] == 0).all()                                  # lo is the half ulp
        assert (hi[~ties] == 0).all() and (lo[~ties] == 0).all()


@pytest.mark.parametrize("b,hkv,g,s,d,dv,kv_len,causal,block", CASES, ids=CASE_IDS)
def test_split_forward_matches_pallas(b, hkv, g, s, d, dv, kv_len, causal, block):
    """The forward kernel's products, P as hi + lo, against the Pallas
    forward on the same bf16-valued inputs (fp32 arithmetic): o and lse
    within BWD_TOL; with hi alone o is >= 10x further off."""
    rng = np.random.default_rng(s + g + d)
    q, k, v, _, lens = _case(rng, b, hkv, g, s, d, dv, kv_len)
    want_o, want_lse = _pallas_fwd(q, k, v, lens, causal, block)
    o, lse = emulate_fwd(q, k, v, lens, causal)
    np.testing.assert_allclose(o, want_o, **BWD_TOL)
    np.testing.assert_allclose(lse, want_lse, **BWD_TOL)
    o_hi, _ = emulate_fwd(q, k, v, lens, causal, lo=False)
    err, err_hi = _max_err([o], [want_o]), _max_err([o_hi], [want_o])
    assert err_hi >= HI_ONLY_FACTOR * err, (err, err_hi)


@pytest.mark.parametrize("b,hkv,g,s,d,dv,kv_len,causal,block", CASES, ids=CASE_IDS)
def test_split_backward_matches_pallas(b, hkv, g, s, d, dv, kv_len, causal, block):
    """The dq and dk/dv kernels' products, p and ds as hi + lo, against
    the Pallas backward (both of its kernels, interpret mode) on the same
    inputs, lse and delta: dq, dk, dv within BWD_TOL; with hi alone they
    are >= 10x further off.  At (96, 64) dv has the value head dim (the
    Pallas backward's (block_k, dv) specs, flash_attention.py:400-416)."""
    rng = np.random.default_rng(s + g + d + 1)
    q, k, v, do, lens = _case(rng, b, hkv, g, s, d, dv, kv_len)
    o, lse = _pallas_fwd(q, k, v, lens, causal, block)
    delta = (do * o).sum(-1)
    want = [np.array(w) for w in jax_flash_bwd(
        *map(jnp.asarray, (q, k, v, do, lse, delta)),
        None if lens is None else jnp.asarray(lens),
        causal=causal, block_q=block, block_k=block, interpret=True)]
    got = emulate_bwd(q, k, v, do, lse, delta, lens, causal)
    assert [a.shape[-1] for a in got] == [w.shape[-1] for w in want] == [d, d, dv]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, w, **BWD_TOL, err_msg=name)
    hi_only = emulate_bwd(q, k, v, do, lse, delta, lens, causal, lo=False)
    err, err_hi = _max_err(got, want), _max_err(hi_only, want)
    assert err_hi >= HI_ONLY_FACTOR * err, (err, err_hi)
