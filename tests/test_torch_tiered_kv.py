"""The port's tiered KV memory against the reference's: int8 quantized
pages (the stored bytes bit for bit, the quantized scatter/gather, int8
paged decode and verify attention against the reference's jnp path and
its Pallas kernels in interpret mode), the host-swap tier (round trip,
manager accounting, format checks), and the engine's greedy tokens on an
int8 pool under requeue, swap and auto preemption and with speculation.
Reduced qwen2-1.5b in fp32 on the CPU; inputs come from numpy seeds."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.models.attention import (  # noqa: E402
    paged_decode_attention as jax_paged_decode_attention,
    paged_verify_attention as jax_paged_verify_attention,
)
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    paged_decode_attention,
    paged_verify_attention,
)
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.serve import kv_cache as tkv  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    params_from_numpy,
    pool_mismatches,
    quantized_pool_from_numpy,
)

ARCH = "qwen2-1.5b"
# the reference's own int8 kernel-vs-jnp gate (test_tiered_kv.py)
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)
_CACHE = {}


def _models():
    if not _CACHE:
        jm = JaxModel(jax_reduced_config(ARCH), compute_dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(1))
        tm = Model(reduced_config(ARCH), device="cpu", dtype=torch.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), reduced_config(ARCH),
                               device="cpu")
        _CACHE.update(jm=jm, jp=jp, tm=tm, tp=tp)
    return _CACHE


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# quantization: the stored bytes equal the reference's
# ---------------------------------------------------------------------------

def _rows(case):
    """(N, H, D) f32 rows for one quantization case."""
    rng = np.random.default_rng(0)
    if case == "random":
        x = rng.standard_normal((64, 2, 64)) * rng.uniform(1e-3, 1e3, (64, 1, 1))
    elif case == "zero":
        x = rng.standard_normal((6, 2, 8))
        x[[0, 3, 5]] = 0.0                       # all-zero rows keep scale 0
    elif case == "ties":
        # amax 127 gives scale 1 exactly: k + 0.5 quotients round half to
        # even, both signs
        x = np.zeros((2, 2, 64))
        x[:, 0, 0] = 127.0
        x[0, 1, :] = np.arange(64) + 0.5
        x[1, 1, :] = -(np.arange(64) + 0.5)
    else:   # "extremes": the amax element maps to +-127, huge and tiny rows
        x = rng.standard_normal((4, 2, 16))
        x[0, 0, 0] = 1e30
        x[1] *= 1e-30
        x[2, 1, 3] = -7.5e4
        x[3] = np.where(x[3] > 0, 3.0, -3.0)
    return x.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "zero", "ties", "extremes"])
def test_quantize_rows_bytes_equal_reference(case):
    x = _rows(case)
    jq, js = jkv.quantize_kv_rows(jnp.asarray(x))
    q, s = tkv.quantize_kv_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    if case == "zero":
        assert (s.numpy()[[0, 3, 5]] == 0).all()
        assert (tkv.dequantize_kv(q, s).numpy()[[0, 3, 5]] == 0).all()
    if case == "ties":
        assert q[0, 1, :4].tolist() == [0, 2, 2, 4]
        assert q[1, 1, :4].tolist() == [0, -2, -2, -4]
    assert int(q.abs().max()) <= 127


def test_quantize_bf16_rows_equal_reference():
    """bf16 rows (the serving compute dtype) are widened to f32 first."""
    x = np.random.default_rng(1).standard_normal((8, 2, 64)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jq, js = jkv.quantize_kv_rows(jnp.asarray(xb.float().numpy(), jnp.bfloat16))
    q, s = tkv.quantize_kv_rows(xb)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_resolve_kv_dtype():
    assert tkv.resolve_kv_dtype(None, torch.float32) == (torch.float32, False)
    assert tkv.resolve_kv_dtype("auto", torch.bfloat16) == (torch.bfloat16, False)
    assert tkv.resolve_kv_dtype("bf16", torch.float32) == (torch.bfloat16, False)
    assert tkv.resolve_kv_dtype("int8", torch.float32) == (torch.int8, True)
    with pytest.raises(ValueError):
        tkv.resolve_kv_dtype("fp4", torch.float32)
    assert tkv.KV_DTYPES == jkv.KV_DTYPES


# ---------------------------------------------------------------------------
# quantized scatter / gather
# ---------------------------------------------------------------------------

def test_quantized_scatter_and_gather_equal_reference():
    L, B, S, H, D, ps, P = 2, 2, 10, 2, 8, 4, 12
    lens = [10, 7]
    mgr = tkv.PagedCacheManager(P, ps, B, 16, kv_dtype="int8")
    jmgr = jkv.PagedCacheManager(P, ps, B, 16, kv_dtype="int8")
    for s, n in enumerate(lens):
        assert mgr.admit(s, n) == jmgr.admit(s, n)
    pool = tkv.init_page_pool(L, P, ps, H, D, torch.float32, "cpu", kv_dtype="int8")
    jpool = jkv.init_page_pool(L, P, ps, H, D, jnp.float32, kv_dtype="int8")
    assert tkv.pool_is_quantized(pool) and pool_mismatches(pool, _np_tree(jpool)) == []
    rng = np.random.default_rng(2)
    pc = {n: rng.standard_normal((L, B, S, H, D)).astype(np.float32) for n in "kv"}
    nb = -(-S // ps)
    idx = np.stack([mgr.prefill_page_idx(s, nb) for s in range(B)])
    tkv.scatter_prefill(pool, {n: torch.from_numpy(a) for n, a in pc.items()},
                        torch.from_numpy(idx))
    jpool = jkv.scatter_prefill(jpool, {n: jnp.asarray(a) for n, a in pc.items()},
                                jnp.asarray(idx))
    assert pool_mismatches(pool, _np_tree(jpool)) == []
    for s, n in enumerate(lens):
        view = tkv.gather_slot(pool, torch.from_numpy(mgr.tables[s]))
        jview = jkv.gather_slot(jpool, jnp.asarray(jmgr.tables[s]), ps)
        for name in ("k", "v"):
            got = view[name].numpy()
            assert got.dtype == np.float32
            # bit for bit, the NaN poison on unmapped blocks included
            np.testing.assert_array_equal(got, np.asarray(jview[name]))
            assert np.isnan(got[:, -(-n // ps) * ps:]).all()


# ---------------------------------------------------------------------------
# int8 paged attention: plain versions vs the reference's jnp path and its
# Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _attn_case(seed, hq=4, hkv=2, d=16, ps=8, nb=3, b=2):
    rng = np.random.default_rng(seed)
    kv = rng.standard_normal((2, 1, 1 + b * nb, ps, hkv, d)).astype(np.float32)
    kv[:, :, 0] = 1e6                      # the trash page holds garbage
    tables = np.arange(1, 1 + b * nb, dtype=np.int32).reshape(b, nb)[:, ::-1].copy()
    pos = np.asarray([ps + 3, 2 * ps + 1], np.int32)[:b]
    pool = quantized_pool_from_numpy(kv, device="cpu")
    return rng, {n: t[0] for n, t in pool.items()}, tables, pos


@pytest.mark.parametrize("backend", ["jnp", "kernel"])
@pytest.mark.parametrize("family", ["decode", "verify"])
def test_int8_paged_attention_matches_reference(family, backend):
    rng, pool, tables, pos = _attn_case(4)
    t_w = 1 if family == "decode" else 3
    q = rng.standard_normal((len(pos), t_w, 4, 16)).astype(np.float32)
    scales = dict(k_scales=pool["k_scales"], v_scales=pool["v_scales"])
    jfn, fn = ((jax_paged_decode_attention, paged_decode_attention)
               if family == "decode"
               else (jax_paged_verify_attention, paged_verify_attention))
    want = jfn(jnp.asarray(q), *(jnp.asarray(pool[n].numpy()) for n in ("k_pages", "v_pages")),
               jnp.asarray(tables), jnp.asarray(pos),
               **{n: jnp.asarray(t.numpy()) for n, t in scales.items()},
               backend=backend)
    for use_kernel in (True, False):      # the wrapper's CPU path, the plain version
        got = fn(torch.from_numpy(q), pool["k_pages"], pool["v_pages"],
                 torch.from_numpy(tables), torch.from_numpy(pos), **scales,
                 use_kernel=use_kernel)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("family", ["decode", "verify"])
def test_fused_dequant_equals_dequantize_then_attend(family):
    """The scale operand changes where the multiply happens, not the math."""
    rng, pool, tables, pos = _attn_case(5)
    t_w = 1 if family == "decode" else 2
    q = torch.from_numpy(rng.standard_normal((len(pos), t_w, 4, 16)).astype(np.float32))
    fn = paged_decode_attention if family == "decode" else paged_verify_attention
    got = fn(q, pool["k_pages"], pool["v_pages"], torch.from_numpy(tables),
             torch.from_numpy(pos), k_scales=pool["k_scales"],
             v_scales=pool["v_scales"])
    kf = tkv.dequantize_kv(pool["k_pages"], pool["k_scales"])
    vf = tkv.dequantize_kv(pool["v_pages"], pool["v_scales"])
    want = fn(q, kf, vf, torch.from_numpy(tables), torch.from_numpy(pos))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_one_scale_alone_raises():
    _, pool, tables, pos = _attn_case(6)
    q = torch.zeros(len(pos), 1, 4, 16)
    with pytest.raises(ValueError, match="both"):
        paged_decode_attention(q, pool["k_pages"], pool["v_pages"],
                               torch.from_numpy(tables), torch.from_numpy(pos),
                               k_scales=pool["k_scales"])
    with pytest.raises(ValueError, match="both"):
        paged_verify_attention(q, pool["k_pages"], pool["v_pages"],
                               torch.from_numpy(tables), torch.from_numpy(pos),
                               v_scales=pool["v_scales"])


# ---------------------------------------------------------------------------
# host-swap tier
# ---------------------------------------------------------------------------

def _small_pool(seed, n_layers=2, n_pages=7, page_size=4):
    kv = np.random.default_rng(seed).standard_normal(
        (2, n_layers, n_pages, page_size, 2, 8)).astype(np.float32)
    return quantized_pool_from_numpy(kv, device="cpu")


def test_swap_pages_roundtrip_bit_exact_into_other_pages():
    pool = _small_pool(7)
    before = {n: t.clone() for n, t in pool.items()}
    host = tkv.swap_out_pages(pool, [1, 4, 5])
    assert set(host) == set(pool)
    for n in pool:                          # the pages are reused meanwhile
        pool[n][:, [1, 4, 5]] = 0
    tkv.swap_in_pages(pool, host, [2, 3, 6])
    for n, t in pool.items():
        assert torch.equal(t[:, [2, 3, 6]], before[n][:, [1, 4, 5]]), n
    # the reference's swap-out of the same pages holds the same bytes
    jhost = jkv.swap_out_pages({n: jnp.asarray(t.numpy()) for n, t in before.items()},
                               np.asarray([1, 4, 5]))
    assert pool_mismatches(host, jhost) == []


def test_manager_swap_out_admit_accounting():
    mgr = tkv.PagedCacheManager(8, 4, 2, 16, kv_dtype="int8")
    assert len(mgr.admit(0, 6)) == 2
    pool = _small_pool(8, n_layers=1, n_pages=8)
    handle = mgr.swap_out(0, pool, 6)
    assert (handle.n_blocks, handle.n_tokens) == (2, 6)
    assert (handle.page_size, handle.kv_dtype) == (4, "int8")
    assert handle.nbytes == sum(t.numel() * t.element_size() for t in handle.data.values())
    assert mgr.allocator.free == 7 and not mgr.owned[0]
    st = mgr.stats()
    assert (st.swap_outs, st.swapped_out_bytes, st.kv_dtype) == (1, handle.nbytes, "int8")
    got = mgr.admit_swapped(1, handle)
    assert got is not None and len(got) == 2 and list(mgr.tables[1, :2]) == got
    st = mgr.stats()
    assert (st.swap_ins, st.swapped_in_bytes, st.used_pages) == (1, handle.nbytes, 2)


def test_admit_swapped_all_or_nothing():
    mgr = tkv.PagedCacheManager(4, 4, 2, 16, kv_dtype="int8")
    mgr.admit(0, 6)                               # 2 of 3 usable pages
    handle = mgr.swap_out(0, _small_pool(9, n_layers=1, n_pages=4), 6)
    assert mgr.admit(0, 9) is not None            # re-take all 3 pages
    assert mgr.admit_swapped(1, handle) is None   # needs 2, none free
    assert mgr.stats().swap_ins == 0 and not mgr.owned[1]


def test_admit_swapped_rejects_another_page_format():
    pool = _small_pool(10, n_layers=1, n_pages=8)
    mgr = tkv.PagedCacheManager(8, 4, 2, 16, kv_dtype="int8")
    mgr.admit(0, 6)
    handle = mgr.swap_out(0, pool, 6)
    with pytest.raises(ValueError, match="page_size"):
        tkv.PagedCacheManager(8, 8, 2, 16, kv_dtype="int8").admit_swapped(0, handle)
    for kv_dtype in (None, "bf16"):
        with pytest.raises(ValueError, match="kv_dtype"):
            tkv.PagedCacheManager(8, 4, 2, 16, kv_dtype=kv_dtype).admit_swapped(0, handle)
    # an unstamped float handle cannot restore into an int8 pool either
    float_handle = tkv.SwapHandle(n_blocks=1, n_tokens=3, data={
        "k_pages": torch.zeros(1, 1, 4, 2, 8), "v_pages": torch.zeros(1, 1, 4, 2, 8)})
    with pytest.raises(ValueError, match="kv_dtype"):
        mgr.admit_swapped(1, float_handle)


# ---------------------------------------------------------------------------
# the engine: int8 greedy tokens equal the reference int8 engine's
# ---------------------------------------------------------------------------

# mixed prompt lengths and budgets on a pool small enough to preempt
ENGINE_KW = dict(max_seq=48, batch_slots=3, cache_layout="paged", page_size=8,
                 num_pages=5, kv_dtype="int8")


def _spec():
    rng = np.random.default_rng(3)
    out = [(i, rng.integers(0, 512, int(rng.integers(3, 20))).tolist(),
            int(rng.integers(2, 9))) for i in range(6)]
    return out + [(6, [1, 2, 3], 1)]


def _jax_serve(preempt):
    key = ("jax", preempt)
    if key not in _CACHE:
        m = _models()
        eng = JaxServeEngine(m["jm"], m["jp"], temperature=0.0, seed=0,
                             pipeline=False, preempt=preempt, **ENGINE_KW)
        out = eng.serve([JaxRequest(u, list(p), n) for u, p, n in _spec()])
        _CACHE[key] = (out, eng.preemptions, eng.last_pool_stats)
    return _CACHE[key]


def _port_serve(**kw):
    m = _models()
    eng = ServeEngine(m["tm"], m["tp"], **{**ENGINE_KW, **kw})
    return eng.serve([Request(u, list(p), n) for u, p, n in _spec()]), eng


@pytest.mark.parametrize("preempt", ["requeue", "swap", "auto"])
def test_int8_engine_tokens_match_reference(preempt):
    want, want_preempt, want_pool = _jax_serve(preempt)
    got, eng = _port_serve(preempt=preempt)
    assert got == want
    assert eng.preemptions == want_preempt >= 1
    pool = eng.last_pool_stats
    assert pool.kv_dtype == "int8" and pool.used_pages == 0
    for field in ("swap_outs", "swap_ins", "swapped_out_bytes", "swapped_in_bytes"):
        assert getattr(pool, field) == getattr(want_pool, field), field
    if preempt != "requeue":              # auto takes the swap at these sizes
        assert pool.swap_outs == pool.swap_ins >= 1
        assert pool.swapped_out_bytes == pool.swapped_in_bytes > 0
        swapped = [u for u, s in eng.last_stats.items()
                   if isinstance(u, int) and s.get("swap_outs")]
        assert swapped and all(eng.last_stats[u]["swap_ins"] >= 1 for u in swapped)


def test_int8_spec_engine_tokens_match_reference():
    """spec_k = 2 on the int8 pool, swapping its preempted requests: the
    verify windows store and read int8 rows, and the committed tokens
    are the reference int8 engine's greedy tokens."""
    want = _jax_serve("requeue")[0]
    got, eng = _port_serve(preempt="swap", spec_k=2, draft="self:2")
    assert got == want
    assert eng.preemptions >= 1 and eng.last_pool_stats.used_pages == 0


def test_engine_ctor_validation():
    m = _models()
    with pytest.raises(ValueError):
        _port_serve(kv_dtype="fp8")
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(m["tm"], m["tp"], max_seq=48, batch_slots=2, kv_dtype="int8")
    with pytest.raises(ValueError):
        _port_serve(preempt="steal")
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(m["tm"], m["tp"], max_seq=48, batch_slots=2, preempt="swap")
    calibrated = ServeEngine(m["tm"], m["tp"], preempt="auto", preempt_calibrate=True,
                             **ENGINE_KW)
    assert calibrated.cost_model.source == "measured"
    with pytest.raises(ValueError, match="paged-layout"):
        m["tm"].init_cache(2, 48, kv_dtype="int8")


def test_int8_pool_bytes_near_half_bf16():
    """int8 values plus a 4-byte scale per row of (Hkv, D) values: at the
    reduced config's Hkv 1, D 64 that is 68 against 128 bytes a row."""
    m = _models()

    def nbytes(kv):
        cache = m["tm"].init_cache(2, 48, layout="paged", page_size=8,
                                   num_pages=13, kv_dtype=kv)
        cache.pop("block_tables")
        return sum(t.numel() * t.element_size() for t in cache.values())

    assert nbytes("int8") / nbytes("bf16") == pytest.approx(68 / 128)
    cfg = reduced_config(ARCH)
    row = cfg.n_kv_heads * cfg.d_head
    assert (row + 4) / (2 * row) == pytest.approx(68 / 128)
    # qwen2-1.5b at full width: 2 KV heads of 128, 14 560 against 28 672
    # bytes a token over 28 layers, K and V
    assert (256 + 4) / 512 == pytest.approx(14560 / 28672)


def test_reserving_the_same_requests_is_fresh():
    """Serving the same Request objects again on the swap tier starts from
    nothing: no handle of the last serve() leaks into the next."""
    m = _models()
    eng = ServeEngine(m["tm"], m["tp"], preempt="swap", **ENGINE_KW)
    reqs = [Request(u, list(p), n) for u, p, n in _spec()]
    first = copy.deepcopy(eng.serve(reqs))
    assert eng.serve(reqs) == first
