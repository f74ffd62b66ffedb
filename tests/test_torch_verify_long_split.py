"""The split arithmetic of verify's long-window branch, on the CPU, where the
kernels cannot run.

Past T * G = 32 query rows a KV head (a shared prefix's suffix prefill),
``verify_attention.cu`` splits the key axis across blocks as decode does:
the wrapper picks the count from the shapes alone (``verify_long_splits``,
the row blocks of the tensor-core tile or the CUDA-core kernel counted
toward that kernel's grid target), split s takes keys [s * chunk, (s + 1) *
chunk) of the window's n = min(pos + T, NB * page_size) live keys with
chunk = ``split_keys(n, splits)``, and ``split.cuh``'s combine pass
reduces the partials.  These tests pin the count at the smoke's and the
card tests' shapes, hold the plain emulation of the partials and the
combine (``kernels/verify_attention/ref.py``) at long windows against the
reference's Pallas ``paged_flash_verify`` in interpret mode (T * G <= 96)
and ``paged_verify_attention_ref`` (T * G 33, 96 and 1536), and hold the
int8 scale fold of the tensor-core tile ((q . k8) * ks, (p * vs) . v8)
to the dequantize-first oracle."""

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
    split_keys,
)
from repro_torch.kernels.verify_attention.ops import (  # noqa: E402
    LONG_CORE_ROWS,
    LONG_TC_ROWS,
    MAX_ROWS,
    MAX_SPLITS,
    long_rows_per_block,
    verify_long_splits,
)
from repro_torch.kernels.verify_attention.ref import (  # noqa: E402
    paged_flash_verify_split_emulated,
    paged_verify_attention_ref,
    paged_verify_attention_scale_fold_emulated,
)
from repro_torch.testing import (  # noqa: E402
    VERIFY_LONG_PAGE,
    quantized_pool_from_numpy,
    verify_long_case,
)

# fp32 on both sides, another summation order (test_torch_verify_split.py's)
TOL = dict(atol=1e-5, rtol=1e-5)
INT8_TOL = dict(atol=2e-5, rtol=1e-4)
# bf16 outputs: one or two bf16 ulps (2^-8 relative), the card tests' bound
BF16_TOL = dict(atol=2e-2, rtol=2e-2)

# the smoke's suffix prefill: B 1, qwen2's Hkv 2 and G 6, a 576-key table
SMOKE = dict(b=1, hkv=2, g=6, n_keys_max=576)
# the card tests' windows (T, G) in verify_long_case, B 2, Hkv 2
CASES = [(3, 11), (16, 6), (256, 6), (512, 6)]


def _ceil(a, b):
    return -(-a // b)


def _case_keys(t):
    """n_keys_max (NB * page_size) of verify_long_case at window T."""
    ps = VERIFY_LONG_PAGE
    return (_ceil(3 * ps + 5 + t, ps) + 1) * ps


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the split count
# ---------------------------------------------------------------------------

def test_rows_per_block_follow_the_kernels():
    """bf16 q: the tensor-core tile's 64 rows; f32 q: the CUDA-core
    kernel's 16."""
    assert long_rows_per_block(torch.bfloat16) == LONG_TC_ROWS == 64
    assert long_rows_per_block(torch.float32) == LONG_CORE_ROWS == 16


# each kernel's rows a block -> (its grid target in blocks, keys a tile):
# the tensor-core tile two blocks an SM, the CUDA-core kernel five
KERNELS = {LONG_TC_ROWS: (SPLIT_BLOCKS, 64), LONG_CORE_ROWS: (5 * 132, TILE_KEYS)}


@pytest.mark.parametrize("t,rpb,want", [(16, 64, 9), (64, 64, 9), (256, 64, 6), (512, 64, 3),
                                        (16, 16, 18), (64, 16, 14), (256, 16, 4),
                                        (512, 16, 2)])
def test_verify_long_splits_at_the_smoke_shape(t, rpb, want):
    """B 1, Hkv 2, G 6, 576 keys: on the tensor-core tile T 16 and 64 are
    2 and 6 row blocks a KV head, so one 64-key tile a split (9); T 256 is
    24 (48 blocks: 6 splits); T 512 is 48 (3).  The CUDA-core kernel's
    16-row blocks count toward five blocks an SM: 18 one-tile splits at T
    16, then 14, 4 and 2."""
    s = SMOKE
    assert verify_long_splits(s["b"], s["hkv"], t * s["g"], s["n_keys_max"], rpb) == want


@pytest.mark.parametrize("rpb", [LONG_TC_ROWS, LONG_CORE_ROWS])
@pytest.mark.parametrize("t,g", CASES, ids=["tg33", "tg96", "tg1536", "tg3072"])
def test_verify_long_splits_properties(t, g, rpb):
    """At the card tests' shapes and beyond: at least one split, no more
    than the table's key tiles or MAX_SPLITS, at least the grid target
    where the keys allow it, and 1 where the row blocks alone fill it;
    the window's live keys cut into whole 32-key tiles within the count."""
    target, tile = KERNELS[rpb]
    for b, hkv, n_max in ((2, 2, _case_keys(t)), (1, 2, 576), (4, 16, 32768), (64, 8, 4096),
                          (1, 1, 2 ** 20)):
        rows = t * g
        splits = verify_long_splits(b, hkv, rows, n_max, rpb)
        blocks = b * hkv * _ceil(rows, rpb)
        assert 1 <= splits <= min(_ceil(n_max, tile), MAX_SPLITS)
        if blocks >= target:
            assert splits == 1
        elif min(_ceil(n_max, tile), MAX_SPLITS) * blocks >= target:
            assert blocks * splits >= target
        for n in range(1, n_max + 1, max(1, n_max // 256)):
            chunk = split_keys(n, splits)
            assert chunk % TILE_KEYS == 0 and _ceil(n, chunk) <= splits


@pytest.mark.parametrize("t,g", CASES, ids=["tg33", "tg96", "tg1536", "tg3072"])
def test_verify_long_splits_at_the_card_tests_shapes(t, g):
    """verify_long_case (B 2, Hkv 2): every window there is long."""
    assert t * g > MAX_ROWS
    n_max = _case_keys(t)
    for rpb, (target, tile) in KERNELS.items():
        blocks = 2 * 2 * _ceil(t * g, rpb)
        want = max(1, min(_ceil(target, blocks), _ceil(n_max, tile)))
        assert verify_long_splits(2, 2, t * g, n_max, rpb) == want


# ---------------------------------------------------------------------------
# the emulated partials and combine at long windows
# ---------------------------------------------------------------------------

def _case(t, g, d, at_end, seed):
    return verify_long_case(np.random.default_rng(seed), t, g, d=d, at_end=at_end)


def _counts(t, g, n_max):
    """The rule's split counts (both kernels) and another: the table's
    one-tile splits, so that splits lie wholly past early rows."""
    rule = {verify_long_splits(2, 2, t * g, n_max, rpb) for rpb in KERNELS}
    return sorted(rule | {_ceil(n_max, TILE_KEYS)})


def test_a_split_lies_wholly_past_early_rows():
    """verify_long_case at T 16: slot 1's window (pos 53, 69 live keys)
    takes 32-key splits on one-tile counts, and its third split (keys 64
    to 68) lies past the limits of window positions 0 to 10."""
    q, kp, vp, bt, pos = _case(16, 6, 64, False, 0)
    p, t = int(pos[1]), 16
    n = p + t
    chunk = split_keys(n, _ceil(_case_keys(t), TILE_KEYS))
    assert chunk == 32 and (n - 1) // chunk == 2
    assert p + 10 < 2 * chunk <= p + t - 1


def test_a_window_runs_past_the_table():
    """at_end: slot 1's window runs past NB * page_size, where n clamps."""
    for t in (3, 16, 256):
        _, _, _, bt, pos = _case(t, 6, 64, True, 0)
        assert int(pos[1]) + t > bt.shape[1] * VERIFY_LONG_PAGE


def _pallas(q, kp, vp, bt, pos, t, **scales):
    return np.asarray(jax_paged_flash_verify(
        *map(jnp.asarray, (q, kp, vp, bt, pos)), t_window=t, interpret=True,
        **{n: jnp.asarray(s.numpy()) for n, s in scales.items()}))


@pytest.mark.parametrize("at_end", [False, True], ids=["pos0-midpage", "past-table"])
@pytest.mark.parametrize("t,g,d", [(3, 11, 64), (16, 6, 128)], ids=["tg33", "tg96"])
def test_long_split_emulation_matches_pallas(t, g, d, at_end):
    """T * G 33 and 96 against the Pallas kernel in interpret mode and the
    plain version, on the rule's count and on one-tile splits."""
    q, kp, vp, bt, pos = _case(t, g, d, at_end, 80 + t)
    args = (_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    want = _pallas(q, kp, vp, bt, pos, t)
    plain = paged_verify_attention_ref(*args, t).numpy()
    np.testing.assert_allclose(plain, want, **TOL)
    for splits in _counts(t, g, bt.shape[1] * VERIFY_LONG_PAGE):
        got = paged_flash_verify_split_emulated(*args, t, splits).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("at_end", [False, True], ids=["pos0-midpage", "past-table"])
@pytest.mark.parametrize("t,g", [(3, 11), (16, 6), (256, 6)], ids=["tg33", "tg96", "tg1536"])
def test_long_split_emulation_matches_plain(t, g, at_end):
    """T * G 33, 96 and 1536 (the smoke's T 256) against the plain
    version, on the rule's count, one-tile splits and 5 (a count that
    divides nothing evenly)."""
    q, kp, vp, bt, pos = _case(t, g, 64, at_end, 90 + t)
    args = (_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    plain = paged_verify_attention_ref(*args, t).numpy()
    for splits in _counts(t, g, bt.shape[1] * VERIFY_LONG_PAGE) + [5]:
        got = paged_flash_verify_split_emulated(*args, t, splits).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, plain, **TOL)


def _int8(kp, vp):
    """int8 pages and f32 row scales of float pages (NaN scales on the
    trash page, which no live key reads)."""
    pool = quantized_pool_from_numpy(np.stack([np.nan_to_num(kp)[None],
                                               np.nan_to_num(vp)[None]]), device="cpu")
    kq, ks, vq, vs = (pool[n][0] for n in ("k_pages", "k_scales", "v_pages", "v_scales"))
    ks[0], vs[0] = float("nan"), float("nan")
    return kq, vq, dict(k_scales=ks, v_scales=vs)


@pytest.mark.parametrize("t,g", [(16, 6), (256, 6)], ids=["tg96", "tg1536"])
def test_long_split_emulation_int8_pages(t, g):
    """int8 pages at long windows: the emulated split and combine against
    the plain version (both dequantize first), one-tile splits included."""
    q, kp, vp, bt, pos = _case(t, g, 64, True, 100 + t)
    kq, vq, sc = _int8(kp, vp)
    args = (_t(q), kq, vq, _t(bt), _t(pos))
    plain = paged_verify_attention_ref(*args, t, **sc).numpy()
    for splits in _counts(t, g, bt.shape[1] * VERIFY_LONG_PAGE):
        got = paged_flash_verify_split_emulated(*args, t, splits, **sc).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, plain, **INT8_TOL)


# ---------------------------------------------------------------------------
# the int8 scale fold of the tensor-core tile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("at_end", [False, True], ids=["pos0-midpage", "past-table"])
@pytest.mark.parametrize("t,g,d", [(3, 11, 64), (16, 6, 128), (256, 6, 64)],
                         ids=["tg33", "tg96", "tg1536"])
def test_scale_fold_matches_dequantize_first(t, g, d, at_end):
    """(q . k8) * ks and (p * vs) . v8 against (q . (k8 * ks)) and p . (v8
    * vs) on bf16-rounded q: within the card's bf16 tolerance as bf16
    outputs, and within 1e-5 in f32 (the same products in another order,
    one rounding of each scale product apart)."""
    q, kp, vp, bt, pos = _case(t, g, d, at_end, 110 + t)
    kq, vq, sc = _int8(kp, vp)
    qb = _t(q).to(torch.bfloat16)
    for qx, tol in ((qb, BF16_TOL), (qb.float(), TOL)):
        args = (qx, kq, vq, _t(bt), _t(pos))
        got = paged_verify_attention_scale_fold_emulated(*args, t, **sc)
        want = paged_verify_attention_ref(*args, t, **sc)
        assert got.dtype == qx.dtype and torch.isfinite(got).all()
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **tol)


def test_scale_fold_matches_pallas_int8():
    """The fold against the Pallas kernel's dequantize-first int8 path in
    interpret mode, T * G 96, bf16-rounded q in f32."""
    q, kp, vp, bt, pos = _case(16, 6, 64, True, 120)
    kq, vq, sc = _int8(kp, vp)
    qf = _t(q).to(torch.bfloat16).float()
    got = paged_verify_attention_scale_fold_emulated(qf, kq, vq, _t(bt), _t(pos), 16, **sc)
    want = _pallas(qf.numpy(), kq.numpy(), vq.numpy(), bt, pos, 16, **sc)
    np.testing.assert_allclose(got.numpy(), want, **INT8_TOL)
