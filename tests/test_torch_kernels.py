"""The port's kernels on the CPU: each plain version against the
reference Pallas kernel (interpret mode) on the same numpy inputs.  The
CUDA kernels are held against these plain versions on the card by
``test_torch_kernels_cuda.py``, which imports no JAX."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.decode_attention import (  # noqa: E402
    flash_decode as jax_flash_decode,
    paged_flash_decode as jax_paged_flash_decode,
)
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_fwd as jax_flash_attention_fwd,
)
from repro.kernels.rmsnorm.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.models.attention import decode_attention as jax_decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    flash_decode,
    paged_flash_decode,
)
from repro_torch.kernels.flash_attention.ops import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import FULLY_MASKED_LSE  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.models.attention import decode_attention  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    paged_decode_case,
    quantized_pool_from_numpy,
)

# fp32 on both sides, same algorithm, different summation order
TOL = dict(atol=1e-5, rtol=1e-5)
# lse is log of a sum of up to S exponentials: absolute 1e-5 on values ~5
LSE_TOL = dict(atol=2e-5, rtol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# plain versions vs the reference Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 256), (2, 5, 256), (3, 1536)])
def test_rmsnorm_plain_matches_pallas(shape):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, *shape), _rand(rng, shape[-1])
    want = jax_rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6, interpret=True)
    got = rmsnorm(_t(x), _t(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_flash(q, k, v, kv_len, causal, block=16):
    """The reference forward as ``flash_mha`` drives it: KV heads repeated
    to query heads, (B*H, S, D) rows padded to the block and masked by a
    per-row valid length."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    k, v = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
    flat = [a.transpose(0, 2, 1, 3).reshape(b * hq, s, d) for a in (q, k, v)]
    pad = -(-s // block) * block - s
    flat = [jnp.pad(jnp.asarray(a), ((0, 0), (0, pad), (0, 0))) for a in flat]
    lens = np.full((b,), s) if kv_len is None else np.minimum(kv_len, s)
    o, lse = jax_flash_attention_fwd(
        *flat, jnp.asarray(np.repeat(lens, hq), jnp.int32), causal=causal,
        block_q=block, block_k=block, interpret=True)
    o = np.asarray(o)[:, :s].reshape(b, hq, s, d).transpose(0, 2, 1, 3)
    return o, np.asarray(lse)[:, :s].reshape(b, hq, s)


@pytest.mark.parametrize("b,s,hq,hkv,d,kv_len,causal", [
    (2, 32, 2, 2, 64, None, True),         # causal, block multiple, G=1
    (2, 37, 4, 2, 64, [37, 20], True),     # non-multiple length, kv_len < S
    (1, 24, 6, 2, 128, None, True),        # G=3, the full model's head dim
    (2, 19, 4, 1, 64, [0, 11], True),      # row 0 fully masked, G=4
    (2, 21, 4, 2, 64, [21, 6], False),     # non-causal, valid length only
])
def test_flash_plain_matches_pallas(b, s, hq, hkv, d, kv_len, causal):
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, b, s, hq, d), _rand(rng, b, s, hkv, d), _rand(rng, b, s, hkv, d)
    lens = None if kv_len is None else np.asarray(kv_len, np.int32)
    want_o, want_lse = _jax_flash(q, k, v, lens, causal)
    got_o, got_lse = flash_attention_fwd(
        _t(q), _t(k), _t(v), None if lens is None else _t(lens), causal=causal)
    np.testing.assert_allclose(got_o.numpy(), want_o, **TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, **LSE_TOL)
    if lens is not None and (lens == 0).any():
        row = int(np.argmin(lens))
        assert (got_o[row] == 0).all()
        assert (got_lse[row] == FULLY_MASKED_LSE).all()


@pytest.mark.parametrize("pos", [[0, 15], [16, 63], [31, 32]])
def test_flash_decode_plain_matches_pallas_at_block_edges(pos):
    rng = np.random.default_rng(2)
    b, s, hkv, g, d = 2, 64, 2, 3, 64
    q, k, v = _rand(rng, b, hkv, g, d), _rand(rng, b, s, hkv, d), _rand(rng, b, s, hkv, d)
    p = np.asarray(pos, np.int32)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(p), block_k=16, interpret=True)
    got = flash_decode(_t(q), _t(k), _t(v), _t(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_attention_attend_len_matches_pallas():
    """The model-level decode reads ``cache[:, :attend_len]`` (a strided
    view in the port) and must equal the reference's kernel path."""
    rng = np.random.default_rng(3)
    b, smax, hq, hkv, d, attend = 3, 96, 4, 1, 64, 40
    q = _rand(rng, b, 1, hq, d)
    k, v = _rand(rng, b, smax, hkv, d), _rand(rng, b, smax, hkv, d)
    pos = np.asarray([0, 17, 39], np.int32)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos), attend_len=attend,
                                backend="kernel")
    got = decode_attention(_t(q), _t(k), _t(v), _t(pos), attend_len=attend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_decode_plain_matches_pallas():
    rng = np.random.default_rng(4)
    q, kp, vp, bt, pos = paged_decode_case(rng)
    want = jax_paged_flash_decode(*map(jnp.asarray, (q, kp, vp, bt, pos)),
                                  interpret=True)
    got = paged_flash_decode(*map(_t, (q, kp, vp, bt, pos)))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_decode_int8_plain_matches_pallas():
    """On int8 pages with row scales the wrapper's plain version gives the
    Pallas kernel's output, and one scale without the other raises."""
    rng = np.random.default_rng(5)
    q, kp, vp, bt, pos = paged_decode_case(rng)
    pool = quantized_pool_from_numpy(np.stack([kp[None], vp[None]]), device="cpu")
    pages = [pool[n][0] for n in ("k_pages", "k_scales", "v_pages", "v_scales")]
    want = jax_paged_flash_decode(
        jnp.asarray(q), *(jnp.asarray(pages[i].numpy()) for i in (0, 2)),
        jnp.asarray(bt), jnp.asarray(pos), k_scales=jnp.asarray(pages[1].numpy()),
        v_scales=jnp.asarray(pages[3].numpy()), interpret=True)
    got = paged_flash_decode(_t(q), pages[0], pages[2], _t(bt), _t(pos),
                             k_scales=pages[1], v_scales=pages[3])
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="both"):
        paged_flash_decode(_t(q), pages[0], pages[2], _t(bt), _t(pos),
                           k_scales=pages[1])
