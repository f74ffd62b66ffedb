"""The split arithmetic of the port's verify kernel, on the CPU, where the
kernel cannot run.

``verify_attention.cu`` runs decode's split kernel and combine pass
(``decode_attention/split.cuh``) over a T-position window: the window's
n = min(pos + T, NB * page_size) live keys are cut into
``split_keys(n, splits)`` keys a split, row r scores keys <= pos + r // G,
and a split wholly past an early row's limit leaves that row the partial
(m = MASK_VALUE, l = 0, acc = 0), which the combine weighs by exactly 0.
These tests pin the wrapper's split count (``verify_splits``: decode's at
T = 1, the row blocks counted for T > 1) and hold a plain emulation of the
partials and the combine (``kernels/verify_attention/ref.py``) against the
reference's Pallas ``paged_flash_verify`` in interpret mode and
``paged_verify_attention_ref``: T 1, 2, 4 and 8, G 1 and 6, D 64 and 128,
windows across split and page edges, a window past the table's end, int8
pages and NaN past the window.  At T = 1 the emulation is paged decode's,
bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.verify_attention.verify_attention import (  # noqa: E402
    paged_flash_verify as jax_paged_flash_verify,
)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    SPLIT_BLOCKS,
    TILE_KEYS,
    decode_splits,
    split_keys,
)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    paged_flash_decode_split_emulated,
)
from repro_torch.kernels.verify_attention.ops import (  # noqa: E402
    MAX_ROWS,
    row_blocks,
    verify_splits,
)
from repro_torch.kernels.verify_attention.ref import (  # noqa: E402
    paged_flash_verify_split_emulated,
    paged_verify_attention_ref,
)
from repro_torch.testing import (  # noqa: E402
    VERIFY_SPLIT_NB,
    VERIFY_SPLIT_PAGE,
    VERIFY_SPLIT_POS,
    quantized_pool_from_numpy,
    verify_split_case,
)

# the tolerances of test_torch_decode_split.py: fp32 on both sides, another
# summation order; int8 pages as test_paged_decode_int8_plain_matches_pallas
TOL = dict(atol=1e-5, rtol=1e-5)
INT8_TOL = dict(atol=2e-5, rtol=1e-4)


def _ceil(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# the split count
# ---------------------------------------------------------------------------

# (B, Hkv, T, G, n_keys_max): chip_smoke's qwen2-1.5b verify row (spec_k 4,
# attend 576), its T = 1 row, OLMoE's heads, the card tests' shapes, and a
# long context
VERIFY_SHAPES = [(4, 2, 4, 6, 576), (4, 2, 1, 6, 576), (4, 16, 4, 1, 576), (3, 2, 4, 2, 80),
                 (3, 2, 1, 6, 80), (1, 1, 4, 8, 80), (5, 2, 8, 1, 160), (4, 2, 2, 6, 32768)]


@pytest.mark.parametrize("rows,blocks", [(1, 1), (2, 1), (4, 1), (5, 1), (6, 1), (8, 2),
                                         (12, 2), (24, 4), (32, 6)])
def test_row_blocks_follow_the_register_blocks(rows, blocks):
    """GR = 1 for one row, 4 up to four, else 6 (split.cuh's by_rows)."""
    assert row_blocks(rows) == blocks
    assert rows <= MAX_ROWS


@pytest.mark.parametrize("b,hkv,t,g,n_max", VERIFY_SHAPES)
def test_verify_splits_rule(b, hkv, t, g, n_max):
    """A window of one takes paged decode's count; a longer window counts
    its row blocks in the grid's target; either way the splits tile the
    window's live keys in whole 32-key tiles within the grid."""
    splits = verify_splits(b, hkv, t * g, t, n_max)
    if t == 1:
        assert splits == decode_splits(b, hkv, n_max)
    else:
        assert splits == decode_splits(b * row_blocks(t * g), hkv, n_max)
    blocks = b * hkv * row_blocks(t * g) * splits
    if _ceil(n_max, TILE_KEYS) * b * hkv * row_blocks(t * g) >= SPLIT_BLOCKS:
        assert blocks >= SPLIT_BLOCKS
    for n in range(0, n_max + 1, max(1, n_max // 512)):
        chunk = split_keys(n, splits)
        assert chunk % TILE_KEYS == 0 and _ceil(n, chunk) <= splits


def test_verify_splits_at_the_smoke_shape():
    """qwen2-1.5b's spec_k = 4 verify (B 4, Hkv 2, T*G 24, 576 keys): 9
    splits of 64 keys, 4 row blocks, 288 blocks; at T = 1, decode's 18."""
    assert verify_splits(4, 2, 24, 4, 576) == 9
    assert split_keys(576, 9) == 64
    assert 4 * 2 * row_blocks(24) * 9 == 288
    assert verify_splits(4, 2, 6, 1, 576) == decode_splits(4, 2, 576) == 18


# ---------------------------------------------------------------------------
# the emulated partials and combine against the Pallas kernel
# ---------------------------------------------------------------------------

SPLITS = 3
S_LEN = VERIFY_SPLIT_PAGE * VERIFY_SPLIT_NB
POS = list(VERIFY_SPLIT_POS)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pallas(q, kp, vp, bt, pos, t, **scales):
    return np.asarray(jax_paged_flash_verify(
        *map(jnp.asarray, (q, kp, vp, bt, pos)), t_window=t, interpret=True,
        **{n: jnp.asarray(s.numpy()) for n, s in scales.items()}))


def test_a_split_lies_wholly_past_an_early_row():
    """The data of the tests below (``verify_split_case``) holds the case
    decode never meets, and the last window runs past the table."""
    assert POS[-1] + 4 > S_LEN
    p, t = POS[2], 4
    n = p + t
    chunk = split_keys(n, SPLITS)
    assert (n - 1) // chunk == 1                        # the second split: keys 32, 33
    assert p + 1 < chunk <= p + t - 1                   # rows t = 0, 1 attend none of them


@pytest.mark.parametrize("t,g,d", [(1, 6, 128), (2, 6, 64), (4, 6, 128), (4, 1, 64),
                                   (8, 1, 128)])
def test_verify_split_emulation_matches_pallas(t, g, d):
    rng = np.random.default_rng(40 + 10 * t + g)
    q, kp, vp, bt, pos = verify_split_case(rng, t, 2, g, d)
    args = (_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    want = _pallas(q, kp, vp, bt, pos, t)
    plain = paged_verify_attention_ref(*args, t)
    for splits in (SPLITS, verify_splits(len(POS), 2, t * g, t, S_LEN)):
        got = paged_flash_verify_split_emulated(*args, t, splits)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("g", [1, 6])
@pytest.mark.parametrize("splits", [SPLITS, None])
def test_window_of_one_is_paged_decode_bit_for_bit(g, splits):
    """T = 1: the emulation takes decode's arithmetic, with the count the
    wrappers pick (the same for both) or any other."""
    rng = np.random.default_rng(60 + g)
    q, kp, vp, bt, pos = verify_split_case(rng, 1, 2, g, 64)
    args = (_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    if splits is None:
        splits = verify_splits(len(POS), 2, g, 1, S_LEN)
        assert splits == decode_splits(len(POS), 2, S_LEN)
    got = paged_flash_verify_split_emulated(*args, 1, splits)
    assert torch.equal(got, paged_flash_decode_split_emulated(*args, splits))


def test_verify_split_emulation_matches_pallas_int8_pages():
    """int8 pages with row scales (a zero row keeps scale 0), T 4, G 6,
    D 64; NaN scales in the trash page must not reach a sum."""
    rng = np.random.default_rng(70)
    q, kp, vp, bt, pos = verify_split_case(rng, 4, 1, 6, 64)
    kp, vp = np.nan_to_num(kp), np.nan_to_num(vp)
    kp[bt[1, 0], 3] = vp[bt[1, 0], 3] = 0.0
    pool = quantized_pool_from_numpy(np.stack([kp[None], vp[None]]), device="cpu")
    kq, ks, vq, vs = (pool[n][0] for n in ("k_pages", "k_scales", "v_pages", "v_scales"))
    ks[0], vs[0] = float("nan"), float("nan")
    sc = dict(k_scales=ks, v_scales=vs)
    args = (_t(q), kq, vq, _t(bt), _t(pos))
    want = _pallas(q, kq.numpy(), vq.numpy(), bt, pos, 4, **sc)
    for splits in (SPLITS, verify_splits(len(POS), 1, 24, 4, S_LEN)):
        got = paged_flash_verify_split_emulated(*args, 4, splits, **sc)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, **INT8_TOL)
        np.testing.assert_allclose(got.numpy(), paged_verify_attention_ref(*args, 4, **sc).numpy(),
                                   **INT8_TOL)
