"""The split arithmetic of the port's decode kernels, on the CPU, where the
kernels cannot run.

``decode_attention.cu`` splits each row's live keys across blocks: the
wrapper picks the split count from the shapes alone (``decode_splits``),
and a row with n live keys takes ``split_keys(n, splits)`` keys a split.
Each block writes a partial (m, l, acc) and a combine pass reduces a row's
used splits in order.  These tests pin that down: the splits tile every
row's keys in whole 32-key tiles, a row's split depends on its own length
and B * Hkv only (so dense and paged decode sum alike whatever the table's
width or the batch), and a plain emulation of the partials and the combine
(``kernels/decode_attention/ref.py``) matches the reference's Pallas
kernels in interpret mode, and ``flash_decode_ref``, at split edges, with
empty later splits, G 1 and 6, D 64 and 128, int8 pages, and NaN past pos."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.decode_attention import (  # noqa: E402
    flash_decode as jax_flash_decode,
    paged_flash_decode as jax_paged_flash_decode,
)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    SPLIT_BLOCKS,
    TILE_KEYS,
    decode_splits,
    split_keys,
)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    flash_decode_ref,
    flash_decode_split_emulated,
    paged_flash_decode_ref,
    paged_flash_decode_split_emulated,
)
from repro_torch.testing import quantized_pool_from_numpy  # noqa: E402

# the tolerance of test_flash_decode_plain_matches_pallas_at_block_edges
# (test_torch_kernels.py): fp32 on both sides, another summation order
TOL = dict(atol=1e-5, rtol=1e-5)
# int8 pages: the same, as test_paged_decode_int8_plain_matches_pallas
INT8_TOL = dict(atol=2e-5, rtol=1e-4)

# (B, Hkv, n_keys_max): chip_smoke's qwen2-1.5b and OLMoE-1B-7B decode rows
# (attend 576), the card tests' shapes, a 32k context, and batches that
# fill the card without a split
SMOKE_SHAPES = [(4, 2, 576), (4, 16, 576)]
SHAPES = SMOKE_SHAPES + [(2, 2, 64), (2, 2, 80), (4, 2, 96), (4, 2, 160), (2, 16, 80),
                         (1, 1, 1), (1, 1, 0), (3, 1, 208), (4, 2, 32768), (64, 16, 4096)]


def _ceil(a, b):
    return -(-a // b)


@pytest.mark.parametrize("b,hkv,n_max", SHAPES)
def test_decode_splits_tile_every_row(b, hkv, n_max):
    splits = decode_splits(b, hkv, n_max)
    assert splits >= 1
    if _ceil(n_max, TILE_KEYS) >= _ceil(SPLIT_BLOCKS, b * hkv):
        assert b * hkv * splits >= SPLIT_BLOCKS            # two blocks an SM
    else:
        assert splits == max(1, _ceil(n_max, TILE_KEYS))   # a tile a split
    step = max(1, n_max // 2048)
    for n in list(range(0, n_max + 1, step)) + [n_max]:
        chunk = split_keys(n, splits)
        used = _ceil(n, chunk)
        assert chunk % TILE_KEYS == 0 and chunk >= TILE_KEYS
        assert used <= splits                    # within the grid
        assert used * chunk >= n                 # the used splits cover n
        assert n == 0 or (used - 1) * chunk < n  # none starts at or past n
        # the row's split reads neither the table's width nor the batch's
        # attend bucket: any n_keys_max >= n gives the same keys a split
        for m in {max(n, 1), _ceil(max(n, 1), TILE_KEYS) * TILE_KEYS, n_max}:
            assert split_keys(n, decode_splits(b, hkv, m)) == chunk


@pytest.mark.parametrize("b,hkv,n_max", SMOKE_SHAPES)
def test_decode_splits_at_the_smoke_shapes(b, hkv, n_max):
    """At the smoke's shapes a full row uses every split of the grid."""
    splits = decode_splits(b, hkv, n_max)
    assert _ceil(n_max, split_keys(n_max, splits)) == splits
    assert {(4, 2): 18, (4, 16): 5}[(b, hkv)] == splits


# ---------------------------------------------------------------------------
# the emulated partials and combine against the Pallas kernels
# ---------------------------------------------------------------------------

# splits = 3 over S = 200: rows of n <= 96 keys take 32-key splits, of
# 97..192 keys 64-key splits.  pos 0 and 31 leave the later splits empty;
# 32/33, 63/64/65 and 127/128/129 sit on split edges (chunk - 1, chunk,
# chunk + 1 and 2 * chunk - 1 ..); 199 is the last key.
SPLITS = 3
POS = [0, 31, 32, 33, 64, 127, 128, 199]
S_LEN = 200


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _dense_case(rng, hkv, g, d):
    b = len(POS)
    q, k, v = _rand(rng, b, hkv, g, d), _rand(rng, b, S_LEN, hkv, d), _rand(rng, b, S_LEN, hkv, d)
    for i, p in enumerate(POS):                 # garbage past pos
        k[i, p + 1:], v[i, p + 1:] = np.nan, np.nan
    return q, k, v, np.asarray(POS, np.int32)


def _to_pages(rng, k, v, ps):
    """Dense rows (B, S, H, D) into shuffled pages behind a NaN trash page
    0; table columns past a row's last live page point at the trash page."""
    b, s = k.shape[:2]
    nb = s // ps
    n_pages = b * nb + 1
    kp = np.full((n_pages, ps) + k.shape[2:], np.nan, np.float32)
    vp = kp.copy()
    bt = (rng.permutation(b * nb) + 1).reshape(b, nb).astype(np.int32)
    for i in range(b):
        for j in range(nb):
            kp[bt[i, j]], vp[bt[i, j]] = k[i, j * ps:(j + 1) * ps], v[i, j * ps:(j + 1) * ps]
        bt[i, POS[i] // ps + 1:] = 0
    return kp, vp, bt


@pytest.mark.parametrize("g,d", [(1, 128), (6, 64)])
def test_split_emulation_matches_pallas_dense(g, d):
    rng = np.random.default_rng(10 + g)
    q, k, v, pos = _dense_case(rng, 2, g, d)
    want = np.asarray(jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(pos), block_k=40, interpret=True))
    got = flash_decode_split_emulated(_t(q), _t(k), _t(v), _t(pos), SPLITS)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), flash_decode_ref(_t(q), _t(k), _t(v), _t(pos)),
                               **TOL)
    # the wrapper's own split count (one 32-key tile a split here)
    splits = decode_splits(len(POS), 2, S_LEN)
    got = flash_decode_split_emulated(_t(q), _t(k), _t(v), _t(pos), splits)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("g,d,ps", [(6, 128, 8), (1, 64, 40)])
def test_split_emulation_matches_pallas_paged(g, d, ps):
    """Paged rows give the dense rows' bits (the kernels' dense = paged
    property), and the Pallas paged kernel's output."""
    rng = np.random.default_rng(20 + g)
    q, k, v, pos = _dense_case(rng, 1, g, d)
    kp, vp, bt = _to_pages(rng, k, v, ps)
    got = paged_flash_decode_split_emulated(_t(q), _t(kp), _t(vp), _t(bt), _t(pos), SPLITS)
    dense = flash_decode_split_emulated(_t(q), _t(k), _t(v), _t(pos), SPLITS)
    assert torch.equal(got, dense)
    want = np.asarray(jax_paged_flash_decode(*map(jnp.asarray, (q, kp, vp, bt, pos)),
                                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), paged_flash_decode_ref(_t(q), _t(kp), _t(vp), _t(bt), _t(pos)), **TOL)


def test_split_emulation_matches_pallas_int8_pages():
    """int8 pages with row scales (zero rows keep scale 0), G 6, D 64,
    8-token pages; NaN scales in the trash page must not reach a sum."""
    rng = np.random.default_rng(30)
    q, k, v, pos = _dense_case(rng, 1, 6, 64)
    kp, vp, bt = _to_pages(rng, np.nan_to_num(k), np.nan_to_num(v), 8)
    kp[1, 3] = vp[1, 3] = 0.0
    pool = quantized_pool_from_numpy(np.stack([kp[None], vp[None]]), device="cpu")
    kq, ks, vq, vs = (pool[n][0] for n in ("k_pages", "k_scales", "v_pages", "v_scales"))
    ks[0], vs[0] = float("nan"), float("nan")
    sc = dict(k_scales=ks, v_scales=vs)
    got = paged_flash_decode_split_emulated(_t(q), kq, vq, _t(bt), _t(pos), SPLITS, **sc)
    assert np.isfinite(got.numpy()).all()
    want = np.asarray(jax_paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()), jnp.asarray(bt),
        jnp.asarray(pos), k_scales=jnp.asarray(ks.numpy()), v_scales=jnp.asarray(vs.numpy()),
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **INT8_TOL)
    np.testing.assert_allclose(
        got.numpy(), paged_flash_decode_ref(_t(q), kq, vq, _t(bt), _t(pos), **sc), **INT8_TOL)
