"""The port's warp-feature kernel wrappers on the CPU (their plain versions)
against the reference's Pallas kernels in interpret mode, on the same numpy
inputs and at the shapes of the reference's own kernel tests: shfl and vote
(vx_shfl / vx_vote), tile_reduce (vx_tile + cg::reduce), mse_partial_sum
and matmul.  Bit for bit, except mse and matmul (stated tolerances).

Where the reference's Pallas kernels and its ``ref.py`` oracles disagree,
the port follows the kernel; three tests pin those cases down."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.matmul.ops import matmul_op  # noqa: E402
from repro.kernels.mse.ops import mse_op  # noqa: E402
from repro.kernels.mse.mse import mse_partial_sum as jax_mse_partial_sum  # noqa: E402
from repro.kernels.tile_reduce.ops import tile_reduce_op  # noqa: E402
from repro.kernels.tile_reduce.ref import tile_reduce_ref as jax_tile_reduce_ref  # noqa: E402
from repro.kernels.warp_ops.ops import shfl_op, vote_op  # noqa: E402
from repro.kernels.warp_ops.ref import vote_ref as jax_vote_ref  # noqa: E402
from repro_torch.kernels.matmul.ops import matmul  # noqa: E402
from repro_torch.kernels.mse.ops import mse, mse_partial_sum  # noqa: E402
from repro_torch.kernels.tile_reduce.ops import tile_reduce  # noqa: E402
from repro_torch.kernels.warp_ops.ops import shfl, vote  # noqa: E402


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _exact(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# warp_ops: shfl and vote
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,w", [(8, 32), (64, 32), (32, 64), (16, 128)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_shfl_matches_pallas(n, w, dtype):
    x = (_rand(n + w, (n, w)) * 10).astype(dtype)
    for mode, imm in (("up", 3), ("down", 5), ("bfly", 4), ("idx", 7), ("up", w),
                      ("idx", -1)):
        _exact(shfl(_t(x), mode, imm), shfl_op(jnp.asarray(x), mode, imm, interpret=True))


def test_shfl_bfly_past_the_width_is_refused():
    """The reference kernel reads outside its block there (NaN in
    interpret mode): undefined, so the port raises instead."""
    x = _rand(0, (4, 8))
    assert np.isnan(np.asarray(shfl_op(jnp.asarray(x), "bfly", 8, interpret=True))).all()
    for imm in (8, 9):
        with pytest.raises(ValueError, match="imm < width"):
            shfl(_t(x), "bfly", imm)
    with pytest.raises(ValueError, match="imm >= 0"):
        shfl(_t(x), "up", -1)
    with pytest.raises(ValueError, match="power of two"):
        shfl(_t(_rand(0, (4, 12))), "up", 1)


@pytest.mark.parametrize("n,w", [(8, 32), (64, 32), (16, 8), (16, 64)])
@pytest.mark.parametrize("masked", [False, True])
def test_vote_matches_pallas(n, w, masked):
    rng = np.random.default_rng(n + w)
    pred = rng.integers(0, 2, (n, w)).astype(np.int32)
    pred[: n // 2] = 1                                  # some uniform warps
    member = None
    if masked:
        member = rng.integers(0, 2, (n, w)).astype(np.int32)
        member[:, 0] = 1                                # lane 0 a member
    for mode in ("all", "any", "uni") + (("ballot",) if w <= 32 else ()):
        want = vote_op(jnp.asarray(pred), mode,
                       None if member is None else jnp.asarray(member), interpret=True)
        _exact(vote(_t(pred), mode, None if member is None else _t(member)), want)
    if w > 32:
        with pytest.raises(ValueError, match="one 32-bit word"):
            vote(_t(pred), "ballot")


def test_vote_uni_compares_with_lane_0_like_the_kernel():
    """Lane 0 outside the member mask: the Pallas kernel compares the
    members with lane 0 (0 here), the reference oracle with the first
    member (1 here).  The port follows the kernel."""
    pred = np.array([[5, 3, 3, 3, 3, 3, 3, 3]], np.int32)
    member = np.array([[0, 1, 1, 1, 1, 1, 1, 1]], np.int32)
    kernel = vote_op(jnp.asarray(pred), "uni", jnp.asarray(member), interpret=True)
    oracle = jax_vote_ref(jnp.asarray(pred), "uni", jnp.asarray(member))
    assert np.asarray(kernel).max() == 0 and np.asarray(oracle).min() == 1
    _exact(vote(_t(pred), "uni", _t(member)), kernel)


def test_vote_casts_float_predicates_like_the_kernel():
    """The Pallas wrapper casts pred to int32 first: 0.5 and 0.7 both
    become 0, so ``uni`` holds (1) where the oracle, comparing the floats,
    says 0, and ``any`` over values in (-1, 1) is 0."""
    pred = np.array([[0.5, 0.7, 0.2, 0.9, 0.5, 0.5, 0.1, 0.3]], np.float32)
    for mode, value in (("uni", 1), ("any", 0), ("all", 0), ("ballot", 0)):
        kernel = vote_op(jnp.asarray(pred), mode, interpret=True)
        assert int(np.asarray(kernel).max()) == value
        _exact(vote(_t(pred), mode), kernel)
    assert np.asarray(jax_vote_ref(jnp.asarray(pred), "uni")).max() == 0


def test_vote_member_mask_excludes_lanes():
    pred = np.array([[1, 0, 1, 1, 1, 1, 1, 1]], np.int32)
    member = np.array([[1, 0, 1, 1, 1, 1, 1, 1]], np.int32)
    assert bool(vote(_t(pred), "all", _t(member)).all())
    assert not bool(vote(_t(pred), "all").any())
    assert vote(_t(pred), "ballot", _t(member)).view(torch.int32).item() == 0b11111101


# ---------------------------------------------------------------------------
# tile_reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,w", [(16, 32), (128, 64), (32, 128)])
@pytest.mark.parametrize("tile", [4, 8, 32])
def test_tile_reduce_matches_pallas(n, w, tile):
    x = _rand(n + tile, (n, w), scale=4)
    for op in ("sum", "max", "min"):
        _exact(tile_reduce(_t(x), tile, op),
               tile_reduce_op(jnp.asarray(x), tile, op, interpret=True))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_tile_reduce_dtypes_match_pallas(dtype, op):
    xj = (jnp.asarray(_rand(3, (32, 32))) * 8).astype(dtype)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(
        {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
         jnp.int32: torch.int32}[dtype])
    want = tile_reduce_op(xj, 8, op, interpret=True)
    got = tile_reduce(xt, 8, op)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_tile_reduce_bf16_sum_rounds_every_step_like_the_kernel():
    """The kernel rounds to bf16 after every butterfly step; the reference
    oracle sums the tile and rounds once.  The port equals the kernel bit
    for bit, and the oracle differs from it by more than a bf16 ulp."""
    xj = (jnp.asarray(_rand(5, (64, 32))) * 8).astype(jnp.bfloat16)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    kernel = np.asarray(tile_reduce_op(xj, 8, "sum", interpret=True), np.float32)
    oracle = np.asarray(jax_tile_reduce_ref(xj, 8, "sum"), np.float32)
    np.testing.assert_array_equal(tile_reduce(xt, 8, "sum").float().numpy(), kernel)
    assert np.abs(kernel - oracle).max() >= 0.125


def test_tile_reduce_validates_the_tile():
    x = _t(_rand(0, (4, 32)))
    for bad in (3, 64, -4):
        with pytest.raises(ValueError, match="power of two"):
            tile_reduce(x, bad)
    with pytest.raises(ValueError, match="whole number"):
        tile_reduce(_t(_rand(0, (4, 24))), 16)
    torch.testing.assert_close(tile_reduce(x, 1), x, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# mse (unet.cu mse_forward) and matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1024, 8192, 65536])
@pytest.mark.parametrize("warp_size", [8, 32, 128])
def test_mse_matches_pallas(n, warp_size):
    """f32 sums of n squares in another order: relative 1e-5."""
    p, t = _rand(1, (n,)), _rand(2, (n,))
    want = mse_op(jnp.asarray(p), jnp.asarray(t), warp_size=warp_size, interpret=True)
    got = mse(_t(p), _t(t), warp_size=warp_size)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want_sum = jax_mse_partial_sum(jnp.asarray(p), jnp.asarray(t), warp_size=warp_size,
                                   interpret=True)
    np.testing.assert_allclose(float(mse_partial_sum(_t(p), _t(t), warp_size=warp_size)),
                               float(want_sum), rtol=1e-5)


def test_mse_validates_the_warp_size():
    p = _t(_rand(0, (96,)))
    for bad in (64, 0, 3):
        with pytest.raises(ValueError, match="power of two dividing"):
            mse_partial_sum(p, p, warp_size=bad)
    with pytest.raises(ValueError, match="differ"):
        mse_partial_sum(p, p[:32])


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 512, 128), (512, 256, 256)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_matmul_matches_pallas(m, k, n, dtype):
    """The reference test's tolerances: f32 1e-4, bf16 3e-2 (atol x8)."""
    a = jnp.asarray(_rand(m, (m, k))).astype(dtype)
    b = jnp.asarray(_rand(n, (k, n))).astype(dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    want = matmul_op(a, b, block_m=128, block_n=128, block_k=128, interpret=True)
    got = matmul(*(_t(np.asarray(v.astype(jnp.float32))).to(tdt) for v in (a, b)))
    assert got.dtype == tdt and got.shape == (m, n)
    tol = 1e-4 if dtype == jnp.float32 else 3e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 8)
    with pytest.raises(ValueError, match=r"\(M, K\) and \(K, N\)"):
        matmul(torch.zeros(2, 3), torch.zeros(4, 2))
