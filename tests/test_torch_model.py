"""The port's dense model against the reference on the same weights:
the weight bridge, prefill logits and K/V cache (right-padded rows with
last_pos included), ten decode steps on the dense and the paged layout,
and greedy tokens.  Reduced qwen2-1.5b in fp32 on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.serve.kv_cache import PagedCacheManager as JaxManager  # noqa: E402
from repro.serve.kv_cache import scatter_prefill as jax_scatter_prefill  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.serve.kv_cache import PagedCacheManager, scatter_prefill  # noqa: E402
from repro_torch.testing import DENSE_LEAVES, leaf_paths, params_from_numpy  # noqa: E402

# fp32 through 4 layers on both sides; XLA and PyTorch block their matmuls
# and reductions differently, which moves logits of magnitude ~1 by a few
# 1e-6.  1e-4 leaves an order of magnitude of headroom and still catches
# any real divergence (a wrong mask or rope shifts logits by >1e-2).
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "qwen2-1.5b"
_CACHE = {}


def _models():
    if not _CACHE:
        jm = JaxModel(jax_reduced_config(ARCH), compute_dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(1))
        np_params = jax.tree.map(np.asarray, jp)
        tm = Model(reduced_config(ARCH), device="cpu", dtype=torch.float32)
        _CACHE.update(jm=jm, jp=jp, tm=tm, np=np_params,
                      tp=params_from_numpy(np_params, device="cpu"))
    return _CACHE


def test_config_matches_reference():
    from repro.configs.registry import get_config as jax_get_config
    from repro_torch.configs import get_config

    fields = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "d_head", "qkv_bias", "rope_theta", "norm_eps")
    for got, want in ((reduced_config(ARCH), jax_reduced_config(ARCH)),
                      (get_config(ARCH), jax_get_config(ARCH))):
        for f in fields:
            assert getattr(got, f) == getattr(want, f), f


def test_bridge_maps_every_leaf():
    m = _models()
    assert leaf_paths(m["np"]) == sorted(DENSE_LEAVES)
    assert leaf_paths(m["tp"]) == sorted(DENSE_LEAVES)
    for path in DENSE_LEAVES:
        ref, got = m["np"], m["tp"]
        for key in path.split("."):
            ref, got = ref[key], got[key]
        assert tuple(got.shape) == ref.shape, path
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=path)
    # the port's own init draws the same shapes
    own = m["tm"].init(torch.Generator().manual_seed(0))
    assert leaf_paths(own) == sorted(DENSE_LEAVES)
    with pytest.raises(ValueError, match="dense-family"):
        params_from_numpy({"embed": m["np"]["embed"]}, device="cpu")


def _prompts(seed=0, b=3, s=13):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (b, s)).astype(np.int32)
    last = np.asarray([s - 1, 6, 2][:b], np.int32)   # right-padded rows
    return toks, last


def test_prefill_logits_and_cache_match_reference():
    m = _models()
    toks, last = _prompts()
    want, wcache = m["jm"].prefill(m["jp"], {"tokens": jnp.asarray(toks)}, 24,
                                   jnp.asarray(last))
    got, gcache = m["tm"].prefill(m["tp"], torch.as_tensor(toks), 24,
                                  torch.as_tensor(last))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        assert tuple(gcache[name].shape) == wcache[name].shape
        np.testing.assert_allclose(gcache[name].numpy(),
                                   np.asarray(wcache[name]), **TOL)
    # without last_pos: the last column's logits; a one-token prompt takes
    # the materialized-softmax path instead of the flash kernel
    for t in (toks, toks[:, :1]):
        want, _ = m["jm"].prefill(m["jp"], {"tokens": jnp.asarray(t)}, 13)
        got, _ = m["tm"].prefill(m["tp"], torch.as_tensor(t), 13)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sq,skv,causal,q_offset,lens", [
    (1, 1, True, 0, None),          # one-token query: not the flash shape
    (4, 9, True, 5, [9, 7]),        # offset causal window with valid lengths
    (6, 6, True, 0, [6, 3]),        # the flash shape, with valid lengths
    (5, 8, False, 0, [8, 2]),       # non-causal (flash, non-square)
])
def test_gqa_attention_matches_reference(sq, skv, causal, q_offset, lens):
    from repro.models.attention import gqa_attention as jax_gqa_attention
    from repro_torch.models.attention import gqa_attention

    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, sq, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 2, 64)).astype(np.float32) for _ in "kv")
    lens = None if lens is None else np.asarray(lens, np.int32)
    want = jax_gqa_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                             q_offset=q_offset, backend="jnp",
                             kv_valid_len=None if lens is None else jnp.asarray(lens))
    got = gqa_attention(*map(torch.as_tensor, (q, k, v)), causal=causal,
                        q_offset=q_offset,
                        kv_valid_len=None if lens is None else torch.as_tensor(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_paged(jm, pcache, b, s, max_seq, ps):
    paged = jm.init_cache(b, max_seq, layout="paged", page_size=ps)
    mgr = JaxManager(paged["k_pages"].shape[1], ps, b, max_seq)
    for slot in range(b):
        mgr.admit(slot, s)
    nb = max_seq // ps
    idx = jnp.asarray(np.stack([mgr.prefill_page_idx(i, nb) for i in range(b)]))
    pool = jax_scatter_prefill({"k_pages": paged["k_pages"],
                                "v_pages": paged["v_pages"]},
                               {"k": pcache["k"], "v": pcache["v"]}, idx)
    return dict(pool, block_tables=mgr.device_tables()), mgr


def _torch_paged(tm, pcache, b, s, max_seq, ps):
    paged = tm.init_cache(b, max_seq, layout="paged", page_size=ps)
    mgr = PagedCacheManager(paged["k_pages"].shape[1], ps, b, max_seq)
    for slot in range(b):
        mgr.admit(slot, s)
    nb = max_seq // ps
    idx = torch.as_tensor(np.stack([mgr.prefill_page_idx(i, nb) for i in range(b)]))
    scatter_prefill(paged, pcache, idx)
    paged["block_tables"] = mgr.device_tables("cpu")
    return paged, mgr


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_ten_decode_steps_match_reference(layout):
    """Ten greedy decode steps from a shared prefill: logits within the
    fp32 tolerance and the same tokens, on both cache layouts."""
    m = _models()
    jm, jp, tm, tp = m["jm"], m["jp"], m["tm"], m["tp"]
    b, s, max_seq, ps = 2, 9, 32, 8
    toks = np.random.default_rng(1).integers(0, 512, (b, s)).astype(np.int32)
    _, wcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq)
    _, gcache = tm.prefill(tp, torch.as_tensor(toks), max_seq)
    if layout == "paged":
        wcache, wmgr = _jax_paged(jm, wcache, b, s, max_seq, ps)
        gcache, gmgr = _torch_paged(tm, gcache, b, s, max_seq, ps)
    wtok = jnp.asarray(toks[:, -1])
    gtok = torch.as_tensor(toks[:, -1])
    pos = np.full((b,), s, np.int32)
    for step in range(10):
        attend = 16 if pos.max() < 16 else 32
        if layout == "paged":
            for slot in range(b):
                wmgr.ensure_block(slot, int(pos[0]) // ps)
                gmgr.ensure_block(slot, int(pos[0]) // ps)
            wcache["block_tables"] = wmgr.device_tables()
            gcache["block_tables"] = gmgr.device_tables("cpu")
            np.testing.assert_array_equal(gmgr.tables, wmgr.tables)
            want, wcache = jm.decode_step(jp, wcache, wtok, jnp.asarray(pos),
                                          attend_len=attend)
        else:
            want, wcache = jm.decode_step(jp, wcache, wtok, jnp.asarray(pos),
                                          attend_len=attend, unroll=True)
        got, gcache = tm.decode_step(tp, gcache, gtok, torch.as_tensor(pos),
                                     attend_len=attend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {step}")
        wtok = jnp.argmax(want, axis=-1).astype(jnp.int32)
        gtok = torch.argmax(got, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(gtok.numpy(), np.asarray(wtok))
        pos = pos + 1


def test_plain_path_equals_kernel_route_on_cpu():
    """``use_kernels=False`` (the chip run's reference path) computes the
    same function as the default route through the kernel wrappers."""
    m = _models()
    plain = Model(reduced_config(ARCH), device="cpu", dtype=torch.float32,
                  use_kernels=False)
    toks, last = _prompts(seed=2)
    a, ca = m["tm"].prefill(m["tp"], torch.as_tensor(toks), 16, torch.as_tensor(last))
    b, cb = plain.prefill(m["tp"], torch.as_tensor(toks), 16, torch.as_tensor(last))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    pos = torch.as_tensor(last + 1)
    tok = torch.argmax(a, dim=-1)
    la, _ = m["tm"].decode_step(m["tp"], ca, tok, pos, attend_len=16)
    lb, _ = plain.decode_step(m["tp"], cb, tok, pos, attend_len=16)
    torch.testing.assert_close(la, lb, atol=0, rtol=0)


@pytest.mark.parametrize("backend", ["hw_warp", "sw"])
def test_warp_feature_norms_match_reference(backend):
    """The paper's reduction forms inside the model: every RMSNorm reduced
    in 64-lane groups by the HW primitives (``hw_warp``) or the
    PR-transformation loops (``sw``), prefill and three decode steps,
    against the reference ``Model(wf=...)`` on the same weights."""
    from repro.models.layers import WarpFeatureConfig as JaxWarpFeatureConfig
    from repro_torch.models.layers import WarpFeatureConfig

    m = _models()
    jm = JaxModel(jax_reduced_config(ARCH), JaxWarpFeatureConfig(backend, warp_size=64),
                  compute_dtype=jnp.float32)
    tm = Model(reduced_config(ARCH), device="cpu", dtype=torch.float32,
               wf=WarpFeatureConfig(backend, warp_size=64))
    b, s, max_seq = 2, 7, 16
    toks = np.random.default_rng(5).integers(0, 512, (b, s)).astype(np.int32)
    want, wcache = jm.prefill(m["jp"], {"tokens": jnp.asarray(toks)}, max_seq)
    got, gcache = tm.prefill(m["tp"], torch.as_tensor(toks), max_seq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pos = np.full((b,), s, np.int32)
    for step in range(3):
        wtok = jnp.argmax(want, axis=-1).astype(jnp.int32)
        gtok = torch.argmax(got, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(gtok.numpy(), np.asarray(wtok))
        want, wcache = jm.decode_step(m["jp"], wcache, wtok, jnp.asarray(pos),
                                      attend_len=max_seq, unroll=True)
        got, gcache = tm.decode_step(m["tp"], gcache, gtok, torch.as_tensor(pos),
                                     attend_len=max_seq)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {step}")
        pos = pos + 1
    # the forms compute the default path's function
    base, _ = m["tm"].prefill(m["tp"], torch.as_tensor(toks), max_seq)
    again, _ = tm.prefill(m["tp"], torch.as_tensor(toks), max_seq)
    torch.testing.assert_close(again, base, atol=1e-5, rtol=1e-5)


def test_warp_feature_config_is_validated_and_plain_path_wins():
    from repro_torch.models.layers import WarpFeatureConfig, rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    with pytest.raises(ValueError, match="reduction_backend"):
        WarpFeatureConfig("pallas")
    x, w = torch.randn(3, 256), torch.randn(256)
    sw = WarpFeatureConfig("sw", warp_size=32)
    torch.testing.assert_close(rmsnorm(x, w, 1e-6, wf=sw), rmsnorm_ref(x, w, 1e-6),
                               atol=1e-6, rtol=1e-5)
    # use_kernel=False is the plain version whatever the config; so are
    # 'hw' and, on a CPU tensor, the kernel route (None / 'kernel')
    torch.testing.assert_close(rmsnorm(x, w, 1e-6, use_kernel=False, wf=sw),
                               rmsnorm_ref(x, w, 1e-6), atol=0, rtol=0)
    for form in ("hw", "kernel", None):
        torch.testing.assert_close(rmsnorm(x, w, 1e-6, wf=WarpFeatureConfig(form)),
                                   rmsnorm_ref(x, w, 1e-6), atol=0, rtol=0)
    # a width that is no whole number of groups reduces the row directly
    x2, w2 = torch.randn(2, 96), torch.randn(96)
    torch.testing.assert_close(rmsnorm(x2, w2, 1e-6, wf=WarpFeatureConfig("hw_warp", 64)),
                               rmsnorm_ref(x2, w2, 1e-6), atol=1e-6, rtol=1e-5)
