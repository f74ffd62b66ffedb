"""The 3xTF32 arithmetic of the port's f32 matmul kernel, on the CPU, where
the kernel cannot run.

The f32 branch of ``matmul.cu`` splits every operand element x into
big = tf32(x) and small = tf32(x - big) (``cvt.rna.tf32.f32``: round to
nearest, ties away from zero) and sums small_a.big_b + big_a.small_b +
big_a.big_b on the tensor cores.  These tests pin that down: the bit
arithmetic of ``tf32_rna`` against an independent rounding in float64, the
split's exactness, the emulated three-product sum against the reference's
Pallas ``matmul`` (interpret mode) on the same numpy inputs, and big.big
alone (plain TF32, which is not a port of the function) at least 10x
further off, which is why the kernel carries the small terms."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.matmul.ops import matmul_op  # noqa: E402
from repro_torch.kernels.matmul.ops import matmul  # noqa: E402
from repro_torch.kernels.matmul.ref import (  # noqa: E402
    matmul_1xtf32_emulated,
    matmul_3xtf32_emulated,
    split_tf32,
    tf32_rna,
)

# the card tests' form (atol ~ sqrt(k), rtol 1e-5) at a tenth of their
# constant: the dropped small.small term is <= 2^-22 of each product, and
# k of them with random signs grow as sqrt(k) (~2.4e-7 sqrt(k)); the rest
# is f32 rounding of the sums in two orders, which read <= 3.4e-6 sqrt(k)
# at these sizes.  1xTF32 reads ~1.2e-3 sqrt(k), a hundred times over.
SPLIT_ATOL_PER_SQRT_K = 1e-5
SPLIT_RTOL = 1e-5
# big.big alone must be at least this many times further from the reference
ONE_TERM_FACTOR = 10
SHAPES = [(64, 64, 64), (37, 70, 96), (128, 256, 64), (200, 333, 129)]


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.float().contiguous().view(torch.int32).numpy()


def _tf32_oracle(x: np.ndarray) -> np.ndarray:
    """Round normal f32 values to 11 significant bits, ties away from zero,
    in float64 arithmetic (no bit tricks)."""
    x = x.astype(np.float64)
    e = np.floor(np.log2(np.abs(x)))
    ulp = np.exp2(e - 10)
    return np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_tf32_rna_keeps_zeros_and_their_signs():
    x = torch.tensor([0.0, -0.0])
    assert (_bits(tf32_rna(x)) == _bits(x)).all()


@pytest.mark.parametrize("scale", [1e-30, 1.0, 3e4, 1e30])
def test_tf32_rna_keeps_values_already_in_tf32(scale):
    x = torch.from_numpy(_rand(0, (4096,), scale))
    x = torch.bitwise_and(x.view(torch.int32), -0x2000).view(torch.float32)  # low 13 bits clear
    assert (_bits(tf32_rna(x)) == _bits(x)).all()


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_tf32_rna_rounds_ties_away_from_zero(sign):
    """A value halfway between two TF32 neighbours goes to the one of
    larger magnitude, for either sign; just below or above the tie it goes
    to the nearer one."""
    base = torch.from_numpy(np.abs(_rand(1, (1024,)))) + 0.5
    base = torch.bitwise_and(base.view(torch.int32), -0x2000)   # TF32 magnitudes
    up = (base + 0x2000).view(torch.float32)                    # the next TF32 value
    tie = (base + 0x1000).view(torch.float32)
    below, above = (base + 0x0fff).view(torch.float32), (base + 0x1001).view(torch.float32)
    lo = base.view(torch.float32)
    assert torch.equal(tf32_rna(sign * tie), sign * up)
    assert torch.equal(tf32_rna(sign * below), sign * lo)
    assert torch.equal(tf32_rna(sign * above), sign * up)


@pytest.mark.parametrize("scale", [1e-30, 1.0, 3e4, 1e30])
def test_tf32_rna_matches_float64_rounding(scale):
    x = _rand(2, (8192,), scale)
    got = tf32_rna(torch.from_numpy(x)).double().numpy()
    np.testing.assert_array_equal(got, _tf32_oracle(x))
    assert (_bits(tf32_rna(torch.from_numpy(x))) & 0x1fff == 0).all()


def test_tf32_rna_passes_nan_and_inf_through():
    x = torch.tensor([float("nan"), float("inf"), -float("inf")])
    got = tf32_rna(x)
    assert torch.isnan(got[0]) and got[1] == float("inf") and got[2] == -float("inf")


def test_split_gives_x_back_to_2_pow_minus_22():
    """big and small are TF32 values; x - big is exact in f32 and big +
    small leaves at most ~2^-22 of x, where big alone leaves up to 2^-11."""
    x = torch.from_numpy(_rand(3, (65536,)))
    big, small = split_tf32(x)
    assert ((_bits(big) & 0x1fff) == 0).all() and ((_bits(small) & 0x1fff) == 0).all()
    xd, bd, sd = x.double(), big.double(), small.double()
    assert torch.equal((x - big).double(), xd - bd)
    assert ((xd - bd - sd).abs() <= 2.0 ** -22 * xd.abs()).all()
    assert (xd - bd).abs().max() > 2.0 ** -13 * xd.abs().max()


def test_bf16_operands_split_exactly():
    """bf16 values are TF32 values: small is 0 and the three products are
    the plain product (the bf16 branch needs no split)."""
    x = torch.from_numpy(_rand(4, (4096,))).to(torch.bfloat16).float()
    big, small = split_tf32(x)
    assert torch.equal(big, x) and not small.any()


def _pallas(a, b):
    return np.asarray(matmul_op(jnp.asarray(a), jnp.asarray(b), interpret=True), np.float32)


@pytest.mark.parametrize("m,k,n", SHAPES + [(1, 1, 1)])
def test_3xtf32_emulation_matches_pallas(m, k, n):
    a, b = _rand(m + 1, (m, k)), _rand(n + 2, (k, n))
    want = _pallas(a, b)
    got = matmul_3xtf32_emulated(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=SPLIT_RTOL,
                               atol=SPLIT_ATOL_PER_SQRT_K * k ** 0.5)
    # and the port's plain version, the CPU path of the wrapper
    np.testing.assert_allclose(got.numpy(), matmul(torch.from_numpy(a), torch.from_numpy(b)),
                               rtol=SPLIT_RTOL, atol=SPLIT_ATOL_PER_SQRT_K * k ** 0.5)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_big_terms_alone_are_at_least_10x_further_off(m, k, n):
    a, b = _rand(m + 1, (m, k)), _rand(n + 2, (k, n))
    want = _pallas(a, b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    err3 = np.abs(matmul_3xtf32_emulated(ta, tb).numpy() - want).max()
    err1 = np.abs(matmul_1xtf32_emulated(ta, tb).numpy() - want).max()
    assert err1 >= ONE_TERM_FACTOR * err3, (err1, err3)
    # plain TF32 fails the tolerance the three products hold
    assert err1 > SPLIT_ATOL_PER_SQRT_K * k ** 0.5 + SPLIT_RTOL * np.abs(want).max()
