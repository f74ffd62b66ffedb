"""The port's speculative decoding against the reference on the CPU:
plain verify attention against the reference's jnp path and its Pallas
kernel (interpret mode), the window's attention properties,
``decode_verify_step`` logits against the reference's and against T
sequential decode steps, the drafts, the allocator's write-then-retract,
and the speculative engine giving exactly the reference's
non-speculative greedy tokens (both spec_k, mixed batches, forced
preemption with rejection, a high-acceptance draft).  Reduced qwen2-1.5b
in fp32."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels.verify_attention.ref import (  # noqa: E402
    paged_verify_attention_ref as jax_verify_oracle,
)
from repro.models.attention import (  # noqa: E402
    paged_verify_attention as jax_paged_verify_attention,
)
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.kv_cache import PagedCacheManager as JaxPagedCacheManager  # noqa: E402
from repro.serve.kv_cache import scatter_prefill as jax_scatter_prefill  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    paged_decode_attention,
    paged_verify_attention,
)
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import PagedCacheManager, scatter_prefill  # noqa: E402
from repro_torch.serve.spec_decode import make_self_draft, resolve_draft  # noqa: E402
from repro_torch.testing import params_from_numpy  # noqa: E402

ARCH = "qwen2-1.5b"
_CACHE = {}


def _models(damp=None):
    """(JAX model, JAX params, port model, port params), the port's
    carried over from the reference's; ``damp`` scales the layer leaves
    (a near-identity stack on which a 1-layer draft agrees)."""
    if damp not in _CACHE:
        jm = JaxModel(jax_reduced_config(ARCH), compute_dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(1))
        if damp is not None:
            jp = dict(jp, layers=jax.tree.map(lambda a: a * damp, jp["layers"]))
        tm = Model(reduced_config(ARCH), device="cpu", dtype=torch.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), reduced_config(ARCH), device="cpu")
        _CACHE[damp] = (jm, jp, tm, tp)
    return _CACHE[damp]


# ---------------------------------------------------------------------------
# verify attention: plain version against the reference
# ---------------------------------------------------------------------------

def _rand_paged(seed=0, b=3, t=4, hq=4, hkv=2, d=64, p=9, ps=8, nb=5):
    """The reference's ``tests/test_spec_decode.py`` shapes, as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, hq, d)).astype(np.float32)
    kp = rng.normal(size=(p, ps, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(p, ps, hkv, d)).astype(np.float32)
    bt = rng.integers(1, p, size=(b, nb)).astype(np.int32)
    pos = rng.integers(0, nb * ps - t, size=(b,)).astype(np.int32)
    return q, kp, vp, bt, pos


def _port(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("use_kernel", [True, False], ids=["wrapper", "plain"])
@pytest.mark.parametrize("t", [1, 2, 4])
def test_verify_attention_matches_reference(t, use_kernel):
    """The port's verify attention (the wrapper on CPU tensors runs the
    plain version) against the reference's jnp path and its Pallas kernel
    in interpret mode, within 1e-5."""
    args = _rand_paged(seed=t, t=t)
    got = paged_verify_attention(*_port(*args), use_kernel=use_kernel).numpy()
    for backend in ("jnp", "kernel"):
        want = jax_paged_verify_attention(*map(jnp.asarray, args), backend=backend)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=backend)


def test_plain_verify_against_reference_oracle():
    """How far the port's masking (the Pallas kernel's: -0.7*f32max scores,
    V rows past the window zeroed) and the reference oracle's (-1e30, plain
    softmax) agree: within 1e-6 on finite pages; garbage past the window
    (NaN values) poisons the oracle and not the port."""
    q, kp, vp, bt, pos = _rand_paged(seed=11)
    got = paged_verify_attention(*_port(q, kp, vp, bt, pos), use_kernel=False)
    want = jax_verify_oracle(*map(jnp.asarray, (q, kp, vp, bt, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # row 0 on private pages whose positions past its window hold NaN
    ps, t, nb = kp.shape[1], q.shape[1], bt.shape[1]
    private = kp.shape[0] + np.arange(nb)
    kp = np.concatenate([kp, kp[1:1 + nb]])
    vp = np.concatenate([vp, vp[1:1 + nb]])
    bt[0] = private
    flat = vp[private].reshape(nb * ps, *vp.shape[2:])
    flat[pos[0] + t:] = np.nan
    vp[private] = flat.reshape(nb, ps, *vp.shape[2:])
    got = paged_verify_attention(*_port(q, kp, vp, bt, pos), use_kernel=False)
    want = np.asarray(jax_verify_oracle(*map(jnp.asarray, (q, kp, vp, bt, pos))))
    assert torch.isfinite(got).all()
    assert np.isnan(want[0]).all() and np.isfinite(want[1:]).all()


def test_verify_causal_within_window():
    """Row t does not see window rows > t: perturbing the K/V at window
    offset 3 leaves rows 0-2 bitwise unchanged."""
    q, kp, vp, _, pos = _rand_paged(seed=7, t=4, nb=5, ps=8, p=16)
    rng = np.random.default_rng(7)
    bt = (1 + rng.permutation(15)).reshape(3, 5).astype(np.int32)
    base = paged_verify_attention(*_port(q, kp, vp, bt, pos), use_kernel=False)
    page = bt[np.arange(3), (pos + 3) // 8]
    off = (pos + 3) % 8
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[page, off] = 99.0
    vp2[page, off] = 99.0
    pert = paged_verify_attention(*_port(q, kp2, vp2, bt, pos), use_kernel=False)
    assert torch.equal(base[:, :3], pert[:, :3])
    assert not torch.equal(base[:, 3], pert[:, 3])


def test_verify_attend_len_bounds_table_walk():
    """attend_len cuts the table at ceil(attend_len / page_size) columns:
    the result is unchanged, and columns past the cut are never read
    (pointing them at a NaN page changes nothing)."""
    q, kp, vp, bt, pos = _rand_paged(seed=9, nb=5, ps=8)
    pos = np.minimum(pos, 8)                 # windows end within 2 blocks
    full = paged_verify_attention(*_port(q, kp, vp, bt, pos), use_kernel=False)
    kp2, vp2, bt2 = kp.copy(), vp.copy(), bt.copy()
    kp2[0], vp2[0] = np.nan, np.nan
    bt2[:, 2:] = 0
    bounded = paged_verify_attention(*_port(q, kp2, vp2, bt2, pos),
                                     attend_len=16, use_kernel=False)
    torch.testing.assert_close(bounded, full, rtol=1e-6, atol=1e-6)


def test_verify_window_of_one_is_paged_decode():
    """T = 1 against the port's paged decode, within 1e-6 (the reference's
    bitwise form of this property fails on the reference itself)."""
    args = _port(*_rand_paged(seed=4, t=1))
    ver = paged_verify_attention(*args, use_kernel=False)
    dec = paged_decode_attention(*args, use_kernel=False)
    torch.testing.assert_close(ver, dec, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# model: the verify window against the reference and sequential decode
# ---------------------------------------------------------------------------

SLOTS, MAX_SEQ, PS, PROMPT = 2, 48, 8, 7


def _paged_caches(t_window, rng):
    """The same prefilled paged cache on both sides, and the window."""
    jm, jp, tm, tp = _models()
    vocab = tm.cfg.vocab
    toks = rng.integers(0, vocab, (SLOTS, PROMPT)).astype(np.int32)
    num_pages = SLOTS * (MAX_SEQ // PS) + 1
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, PROMPT)
    jmgr = JaxPagedCacheManager(num_pages, PS, SLOTS, MAX_SEQ)
    mgr = PagedCacheManager(num_pages, PS, SLOTS, MAX_SEQ)
    for s in range(SLOTS):
        jmgr.admit(s, PROMPT + t_window)
        mgr.admit(s, PROMPT + t_window)
    assert (jmgr.tables == mgr.tables).all()
    nb = -(-PROMPT // PS)
    page_idx = np.stack([mgr.prefill_page_idx(s, nb) for s in range(SLOTS)])

    def jax_cache():
        c = jm.init_cache(SLOTS, MAX_SEQ, layout="paged", page_size=PS,
                          num_pages=num_pages)
        pool = jax_scatter_prefill({"k_pages": c["k_pages"], "v_pages": c["v_pages"]},
                                   {"k": jcache["k"], "v": jcache["v"]},
                                   jnp.asarray(page_idx))
        return dict(pool, block_tables=jnp.asarray(jmgr.tables))

    def port_cache():
        c = tm.init_cache(SLOTS, MAX_SEQ, layout="paged", page_size=PS,
                          num_pages=num_pages)
        _, pcache = tm.prefill(tp, torch.as_tensor(toks), PROMPT)
        scatter_prefill(c, pcache, torch.as_tensor(page_idx))
        c["block_tables"] = torch.as_tensor(mgr.tables)
        return c

    window = rng.integers(0, vocab, (SLOTS, t_window)).astype(np.int32)
    return jax_cache, port_cache, window


@pytest.mark.parametrize("t_window", [2, 4])
def test_decode_verify_step_matches_reference_and_sequential_decode(t_window):
    jm, jp, tm, tp = _models()
    jax_cache, port_cache, window = _paged_caches(t_window, np.random.default_rng(0))
    pos = np.full((SLOTS,), PROMPT, np.int32)
    want, _ = jm.decode_verify_step(jp, jax_cache(), jnp.asarray(window),
                                    jnp.asarray(pos), 32, "jnp")
    got, _ = tm.decode_verify_step(tp, port_cache(), torch.as_tensor(window),
                                   torch.as_tensor(pos), 32)
    assert got.shape == (SLOTS, t_window, tm.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    cache, seq = port_cache(), []
    for i in range(t_window):
        lg, cache = tm.decode_step(tp, cache, torch.as_tensor(window[:, i]),
                                   torch.as_tensor(pos + i), 32)
        seq.append(lg)
    seq = torch.stack(seq, dim=1)
    torch.testing.assert_close(got, seq, rtol=1e-4, atol=1e-4)
    assert torch.equal(got.argmax(-1), seq.argmax(-1))
    plain, _ = tm.decode_verify_step(tp, port_cache(), torch.as_tensor(window),
                                     torch.as_tensor(pos), 32, "torch")
    torch.testing.assert_close(plain, got)


def test_decode_verify_step_refuses_a_dense_cache_and_unknown_backends():
    _, _, tm, tp = _models()
    window, pos = torch.zeros(2, 2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="paged"):
        tm.decode_verify_step(tp, tm.init_cache(2, 32), window, pos)
    with pytest.raises(ValueError, match="verify_backend"):
        tm.decode_verify_step(tp, tm.init_cache(2, 32, layout="paged"), window,
                              pos, verify_backend="jnp")


# ---------------------------------------------------------------------------
# drafts
# ---------------------------------------------------------------------------

def test_self_draft_views_target_params():
    _, _, tm, tp = _models()
    dm, dp = make_self_draft(tm, tp, 2)
    assert dm.cfg.n_layers == 2 and dm.use_kernels == tm.use_kernels
    for name in ("embed", "ln_f", "lm_head"):
        assert dp[name] is tp[name]
    leaf, full = dp["layers"]["attn"]["wq"], tp["layers"]["attn"]["wq"]
    assert leaf.shape[0] == 2 and leaf.data_ptr() == full.data_ptr()   # a view
    # the full-depth draft is the target
    dm_full, dp_full = make_self_draft(tm, tp, tm.cfg.n_layers)
    x = torch.tensor([[1, 2, 3]])
    assert torch.equal(dm_full.prefill(dp_full, x, 8)[0], tm.prefill(tp, x, 8)[0])


def test_resolve_draft_variants():
    _, _, tm, tp = _models()
    dm, _ = resolve_draft(tm, tp, None)
    assert dm.cfg.n_layers == tm.cfg.n_layers // 2
    assert resolve_draft(tm, tp, "self")[0].cfg.n_layers == tm.cfg.n_layers // 2
    assert resolve_draft(tm, tp, "self:3")[0].cfg.n_layers == 3
    pair = (tm, tp)
    assert resolve_draft(tm, tp, pair) is pair
    dm2, dp2 = resolve_draft(tm, tp, ARCH, seed=3)
    assert dm2.cfg.vocab == tm.cfg.vocab
    assert not torch.equal(dp2["layers"]["attn"]["wq"][0], tp["layers"]["attn"]["wq"][0])
    assert torch.equal(resolve_draft(tm, tp, ARCH, seed=3)[1]["embed"], dp2["embed"])
    with pytest.raises(KeyError):
        resolve_draft(tm, tp, "whisper-small")
    with pytest.raises(ValueError):
        make_self_draft(tm, tp, tm.cfg.n_layers + 1)


# ---------------------------------------------------------------------------
# allocator: ensure_span / retract_above (test_spec_decode.py, replayed)
# ---------------------------------------------------------------------------

def test_manager_ensure_span_and_retract():
    mgr = PagedCacheManager(num_pages=8, page_size=4, slots=2, max_seq=32)
    assert mgr.admit(0, 5) is not None            # blocks 0,1 (pos 0..7)
    assert mgr.ensure_span(0, 5, 12)              # blocks 1,2,3
    assert mgr.allocator.used == 4
    assert mgr.retract_above(0, 6) == 2           # keep blocks 0,1
    assert mgr.allocator.used == 2
    assert mgr.tables[0, 2] == 0 and mgr.tables[0, 3] == 0
    assert mgr.dirty
    assert mgr.retract_above(0, 6) == 0
    assert mgr.stats().retracts == 2
    assert mgr.ensure_span(0, 32, 40)             # past the table: trash
    assert mgr.allocator.used == 2
    assert mgr.admit(1, 20) is not None           # 5 blocks, pool exhausted
    assert not mgr.ensure_span(0, 8, 16)


# ---------------------------------------------------------------------------
# engine: speculative == the reference's non-speculative greedy tokens
# ---------------------------------------------------------------------------

def _reqs(n, seed=3, plo=3, phi=12, mlo=2, mhi=9):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, int(rng.integers(plo, phi))).tolist(),
             int(rng.integers(mlo, mhi))) for i in range(n)]


PREEMPT_REQS = [(0, list(range(1, 9)), 12), (1, list(range(9, 17)), 12)]


def _jax_serve(spec, damp=None, **kw):
    """The reference's non-speculative dense engine, once per case."""
    key = ("jax", tuple(spec[0][1]), damp, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jm, jp, _, _ = _models(damp)
        eng = JaxServeEngine(jm, jp, temperature=0.0, seed=0, **kw)
        _CACHE[key] = eng.serve([JaxRequest(u, list(p), n) for u, p, n in spec])
    return _CACHE[key]


def _port_serve(spec, damp=None, spec_flags=None, **kw):
    _, _, tm, tp = _models(damp)
    eng = ServeEngine(tm, tp, **kw)
    reqs = [Request(u, list(p), n) for u, p, n in spec]
    for r, flag in zip(reqs, spec_flags or [True] * len(reqs)):
        r.spec = flag
    out = eng.serve(copy.deepcopy(reqs))
    pool = eng.last_pool_stats
    assert pool.used_pages == 0 and pool.allocs == pool.frees > 0   # drained
    for u, _, n in spec:
        s = eng.last_stats[u]
        assert s["status"] == "ok" and len(out[u]) == n
        # the first token, and the first after each resume, come from prefill
        assert s["spec_tokens"] == n - 1 - s["preemptions"]
        assert 1.0 <= s["accept_rate"] <= kw["spec_k"]
    return out, eng


PAGED = dict(max_seq=48, batch_slots=2, cache_layout="paged", page_size=8)


@pytest.mark.parametrize("spec_k,verify_backend", [(2, None), (4, None), (4, "torch")])
def test_spec_greedy_matches_reference_nonspec(spec_k, verify_backend):
    spec = _reqs(5)
    want = _jax_serve(spec, max_seq=48, batch_slots=2)
    got, eng = _port_serve(spec, spec_k=spec_k, draft="self:2",
                           verify_backend=verify_backend, **PAGED)
    assert got == want
    assert eng.last_pool_stats.retracts > 0


def test_spec_mixed_batch_matches_reference_nonspec():
    spec = _reqs(5)
    flags = [i % 2 == 0 for i in range(len(spec))]
    want = _jax_serve(spec, max_seq=48, batch_slots=2)
    got, eng = _port_serve(spec, spec_flags=flags, spec_k=2, draft="self:2", **PAGED)
    assert got == want
    for (u, _, _), flag in zip(spec, flags):
        if not flag:
            assert eng.last_stats[u]["accept_rate"] == 1.0


def test_spec_forced_preempt_and_rejection_matches_reference():
    """A pool too small for two growing sequences preempts while windows
    are written and retracted; tokens stay the reference's."""
    want = _jax_serve(PREEMPT_REQS, max_seq=48, batch_slots=2)
    got, eng = _port_serve(PREEMPT_REQS, spec_k=2, draft="self:2",
                           **dict(PAGED, num_pages=5))
    assert got == want
    assert eng.preemptions >= 1
    assert any(s["accept_rate"] < 2 for s in eng.last_stats.values())   # rejections


def test_spec_high_acceptance_still_exact():
    """Damped layers: the 1-layer draft mostly agrees, windows commit
    several tokens, and the tokens stay the reference's."""
    spec = _reqs(4, seed=5, mlo=8, mhi=13)
    want = _jax_serve(spec, damp=0.05, max_seq=64, batch_slots=2)
    got, eng = _port_serve(spec, damp=0.05, spec_k=4, draft="self:1",
                           **dict(PAGED, max_seq=64))
    assert got == want
    assert any(eng.last_stats[u]["accept_rate"] > 1.5 for u, _, _ in spec)


def test_spec_engine_refusals():
    _, _, tm, tp = _models()
    with pytest.raises(NotImplementedError, match="A6"):
        ServeEngine(tm, tp, temperature=0.8, spec_k=4, **PAGED)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tm, tp, max_seq=48, batch_slots=2, spec_k=2)
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(tm, tp, spec_k=0, **PAGED)
    with pytest.raises(ValueError, match="verify_backend"):
        ServeEngine(tm, tp, spec_k=2, verify_backend="jnp", **PAGED)
    eng = ServeEngine(tm, tp, spec_k=4, **dict(PAGED, num_pages=3))
    with pytest.raises(ValueError, match="overhang"):
        eng.serve([Request(0, list(range(10)), 5)])


def test_spec_governor_disables_and_rearms():
    """An independent random draft that never agrees: after
    SPEC_DISABLE_WINDOW one-token windows the governor stops a request's
    speculation, re-arms it SPEC_COOLDOWN steps later, and stops it again;
    the tokens stay the reference's."""
    from repro_torch.serve.engine import SPEC_COOLDOWN, SPEC_DISABLE_WINDOW

    n_new = 2 * SPEC_DISABLE_WINDOW + SPEC_COOLDOWN + 4
    spec = [(0, [5, 17, 301, 42], n_new), (1, [7, 7, 99], n_new)]
    want = _jax_serve(spec, max_seq=64, batch_slots=2)
    got, eng = _port_serve(spec, spec_k=3, draft=ARCH, **dict(PAGED, max_seq=64))
    assert got == want
    for u, _, _ in spec:
        assert eng.last_stats[u]["spec_auto_disables"] == 2
