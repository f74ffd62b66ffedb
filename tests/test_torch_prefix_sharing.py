"""The port's prefix sharing against the reference's: the radix index
(units, and random operation traces that must match the reference's
index call for call under every eviction policy), the refcounted
allocator and the manager's copy-on-write admission (OOM, the shared
boundary's retract, lazy eviction), ``gather_slot`` on shared pages, the
engine's shared greedy tokens against the reference engine's unshared
ones (admission orders, forced preemption, speculation, eviction
policies), page bounds and stats, ``Model.prefill_suffix`` against the
reference's on the same pool, and the plain verify attention at T * G >
32 (the suffix prefill's shape) against the Pallas kernel in interpret
mode.  Reduced qwen2-1.5b in fp32 on the CPU; inputs come from numpy
seeds."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels.verify_attention.verify_attention import (  # noqa: E402
    paged_flash_verify as pallas_paged_flash_verify,
)
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro.serve import prefix_index as jpi  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels.verify_attention.ref import paged_verify_attention_ref  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import (  # noqa: E402
    TRASH_PAGE,
    PageAllocator,
    PagedCacheManager,
    copy_pages,
    gather_slot,
    init_page_pool,
    scatter_prefill,
)
from repro_torch.serve.prefix_index import (  # noqa: E402
    EVICT_POLICIES,
    PrefixIndex,
    chain_prefix_key,
    page_prefix_keys,
)
from repro_torch.testing import params_from_numpy  # noqa: E402

ARCH = "qwen2-1.5b"
# fp32 on both sides, the same weights: the suffix prefill's logits differ
# only by the order of f32 sums (the reference's own fp32 parity bar)
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
# the reference's int8/float kernel-vs-jnp attention gate (test_tiered_kv.py)
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)
ENGINE_KW = dict(max_seq=48, batch_slots=2, cache_layout="paged", page_size=8)
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


def _shared_spec(n, prefix_len=16, suf_lo=1, suf_hi=8, max_new=5, seed=3,
                 dup_aligned=True):
    """(uid, prompt, max_new) for n requests sharing a ``prefix_len``-token
    prefix with short random suffixes, and optionally one exact
    page-aligned copy of the prefix (the copy-on-write admission)."""
    vocab = reduced_config(ARCH).vocab
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len).tolist()
    spec = [(i, prefix + rng.integers(0, vocab, int(rng.integers(suf_lo, suf_hi))).tolist(),
             max_new) for i in range(n)]
    if dup_aligned:
        spec.append((n, list(prefix), max_new))
    return spec


def _ref_tokens(name, spec, **kw):
    """The reference engine's unshared greedy tokens (cached by name)."""
    key = ("ref", name)
    if key not in _CACHE:
        m = _models()
        eng = JaxServeEngine(m["jm"], m["jp"], temperature=0.0, seed=0,
                             pipeline=False, **{**ENGINE_KW, **kw})
        _CACHE[key] = eng.serve([JaxRequest(u, list(p), n) for u, p, n in spec])
    return _CACHE[key]


def _port_serve(spec, **kw):
    m = _models()
    eng = ServeEngine(m["tm"], m["tp"], **{**ENGINE_KW, **kw})
    return eng.serve([Request(u, list(p), n) for u, p, n in spec]), eng


def _mgr(num_pages, page_size=4, slots=3, max_seq=32):
    return PagedCacheManager(num_pages, page_size, slots, max_seq,
                             prefix_index=PrefixIndex(page_size))


# ---------------------------------------------------------------------------
# the radix index
# ---------------------------------------------------------------------------

def test_index_match_insert_page_granular():
    ix = PrefixIndex(4)
    assert ix.match([1, 2, 3, 4, 5]) == []
    assert ix.insert([1, 2, 3, 4, 5, 6, 7, 8], [10, 11]) == [10, 11] and len(ix) == 2
    assert ix.match([1, 2, 3, 4, 5, 6, 7, 8, 9]) == [10, 11]
    assert ix.match([1, 2, 3, 4, 9, 9, 9, 9]) == [10]   # diverges at page 2
    assert ix.match([1, 2, 3]) == []                    # partial pages never match
    assert ix.match([1, 2, 3, 9, 9]) == []
    # re-insert keeps existing nodes and registers only the new depth
    assert ix.insert([1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 9], [10, 11, 12]) == [12]
    assert len(ix) == 3
    # a private duplicate of an indexed page (a CoW fork) is not registered
    assert ix.insert([1, 2, 3, 4, 5, 6, 7, 8], [10, 77]) == []
    assert ix.match([1, 2, 3, 4, 5, 6, 7, 8]) == [10, 11]


def test_index_evict_leaf_cascade():
    ix = PrefixIndex(2)
    ix.insert([1, 1, 2, 2, 3, 3], [5, 6, 7])     # chain 5 -> 6 -> 7
    ix.insert([1, 1, 9, 9], [5, 8])              # a branch below 5
    held = {6}                                   # a live slot holds page 6

    def can(p):
        return p not in held

    # 7 and 8 are evictable leaves; 6 is pinned, which blocks its parent
    assert set(ix.evict_lru(10, can)) == {7, 8} and len(ix) == 2
    assert ix.evictable(can) == 0
    held.clear()
    assert set(ix.evict(10, can)) == {5, 6} and len(ix) == 0


def test_index_evict_order_and_exclude():
    ix = PrefixIndex(2)
    ix.insert([1, 1], [3])
    ix.insert([2, 2], [4])
    ix.match([1, 1])                             # refresh page 3
    assert ix.evict(1, lambda p: True) == [4]
    # exclude masks pages an admission is about to share
    assert ix.evictable(lambda p: True, exclude={3}) == 0


def test_index_validation_and_min_cached_tokens():
    with pytest.raises(ValueError):
        PrefixIndex(4, policy="mru")
    with pytest.raises(ValueError):
        PrefixIndex(4, min_cached_tokens=-1)
    with pytest.raises(ValueError):
        PrefixIndex(0)
    assert set(EVICT_POLICIES) == {"lru", "lfu", "deepest"} == set(jpi.EVICT_POLICIES)
    ix = PrefixIndex(4, min_cached_tokens=8)
    assert ix.insert([1, 2, 3, 4, 5], [10]) == []       # 1 full page < 8 tokens
    assert len(ix) == 0 and ix.rejected_inserts == 1 and ix.version == 0
    assert ix.match([1, 2, 3, 4]) == []
    assert ix.insert([1, 2, 3, 4, 5, 6, 7, 8], [10, 11]) == [10, 11]
    assert len(ix) == 2 and ix.rejected_inserts == 1 and ix.version == 2


def test_index_lfu_and_deepest_victims():
    ix = PrefixIndex(2, policy="lfu")
    ix.insert([1, 1], [3])
    ix.insert([2, 2], [4])
    ix.match([1, 1])          # page 3: 2 hits
    ix.match([1, 1])
    ix.match([2, 2])          # page 4: 1 hit, more recent
    assert ix.evict(1, lambda p: True) == [4]
    # the shallow leaf is the LRU victim, but deepest prunes the tail
    for policy, victim in (("deepest", [7]), ("lru", [8])):
        ix = PrefixIndex(2, policy=policy)
        ix.insert([9, 9], [8])
        ix.insert([1, 1, 2, 2, 3, 3], [5, 6, 7])
        assert ix.evict(1, lambda p: True) == victim


def test_prefix_keys_equal_reference():
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 1000, 37).tolist()
    assert page_prefix_keys(toks, 8) == jpi.page_prefix_keys(toks, 8)
    assert chain_prefix_key(b"", toks[:8]) == jpi.chain_prefix_key(b"", toks[:8])
    ix, ref = PrefixIndex(8), jpi.PrefixIndex(8)
    for i in range(3):
        p = toks[:8 * (i + 1)] + [i] * 8
        ix.insert(p, list(range(10 * i, 10 * i + 4)))
        ref.insert(p, list(range(10 * i, 10 * i + 4)))
    assert ix.prefix_keys() == ref.prefix_keys()
    assert sorted(ix.pages()) == sorted(ref.pages())


@pytest.mark.parametrize("policy", EVICT_POLICIES)
def test_index_trace_matches_reference(policy):
    """Random insert / match / evict / evictable calls over a few shared
    prefixes give the reference index's answers call for call: the same
    pages, victims, versions and rejections, whatever the policy."""
    rng = np.random.default_rng(len(policy))
    ix = PrefixIndex(2, policy=policy, min_cached_tokens=4)
    ref = jpi.PrefixIndex(2, policy=policy, min_cached_tokens=4)
    bases = [rng.integers(0, 4, 12).tolist() for _ in range(3)]
    pinned = set()
    next_page = 1
    for _ in range(300):
        op = rng.random()
        toks = bases[int(rng.integers(3))][:int(rng.integers(1, 13))]
        toks = toks + rng.integers(0, 4, int(rng.integers(0, 4))).tolist()
        if op < 0.4:
            pages = list(range(next_page, next_page + len(toks) // 2))
            next_page += len(pages)
            assert ix.insert(toks, pages) == ref.insert(toks, pages)
        elif op < 0.7:
            assert ix.match(toks) == ref.match(toks)
        elif op < 0.85:
            pinned = set(rng.choice(max(next_page, 2), size=3).tolist())
            assert (ix.evictable(lambda p: p not in pinned)
                    == ref.evictable(lambda p: p not in pinned))
        else:
            n = int(rng.integers(1, 4))
            assert (ix.evict(n, lambda p: p not in pinned)
                    == ref.evict(n, lambda p: p not in pinned))
        assert (len(ix), ix.version, ix.rejected_inserts) == (
            len(ref), ref.version, ref.rejected_inserts)


# ---------------------------------------------------------------------------
# the refcounted allocator and the manager
# ---------------------------------------------------------------------------

def test_allocator_refcounts():
    a = PageAllocator(6)
    p = a.alloc(2)
    a.share([p[0]])
    assert a.refcount(p[0]) == 2 and a.is_shared(p[0]) and not a.is_shared(p[1])
    assert (a.used, a.logical, a.peak_logical, a.share_count) == (2, 3, 3, 1)
    with pytest.raises(ValueError, match="shared"):
        a.assert_writable(p[0])
    a.assert_writable(p[1])
    assert a.release([p[0]]) == 0 and a.used == 2 and a.logical == 2
    assert a.release(p) == 2 and a.used == 0 and a.free == a.usable
    assert (a.release_count, a.free_count) == (3, 2)
    with pytest.raises(ValueError, match="double free"):
        a.release([p[0]])
    with pytest.raises(ValueError, match="unallocated"):
        a.share([p[1]])
    with pytest.raises(ValueError, match="unallocated"):
        a.assert_writable(p[1])


def test_allocator_share_trace_matches_reference():
    """alloc / share / release in a random order: the same pages,
    refcounts, free counts and high-water marks as the reference's."""
    rng = np.random.default_rng(5)
    a, ref = PageAllocator(13), jkv.PageAllocator(13)
    refs = []                                   # one entry per reference held
    for _ in range(300):
        op = rng.random()
        if refs and op < 0.4:
            p = refs.pop(int(rng.integers(len(refs))))
            assert a.release([p]) == ref.release([p])
        elif refs and op < 0.6:
            p = refs[int(rng.integers(len(refs)))]
            a.share([p])
            ref.share([p])
            refs.append(p)
        else:
            n = int(rng.integers(1, 3))
            got = a.alloc(n)
            assert got == ref.alloc(n)
            refs += got or []
        assert (a.used, a.free, a.logical) == (ref.used, ref.free, ref.logical)
        assert a.used + a.free == a.usable and a.logical == len(refs)
    assert (a.peak_used, a.peak_logical, a.share_count, a.release_count) == (
        ref.peak_used, ref.peak_logical, ref.share_count, ref.release_count)


def test_manager_admit_prefix_shares_pages():
    m = _mgr(num_pages=12)
    prompt = list(range(10))                     # 2 full pages + a partial one
    plan0 = m.plan_admit(prompt)
    assert plan0.cached_tokens == 0 and plan0.private_blocks == 3
    m.admit_prefix(0, plan0)
    assert m.register_prefix(0, prompt) == 2 and len(m.index) == 2
    # the same prompt shares both full pages and allocates only the tail
    plan1 = m.plan_admit(list(prompt))
    assert plan1.cached_tokens == 8 and plan1.private_blocks == 1
    assert plan1.shared_pages == [int(m.tables[0, 0]), int(m.tables[0, 1])]
    m.admit_prefix(1, plan1)
    assert m.tables[1, 0] == m.tables[0, 0] and m.tables[1, 1] == m.tables[0, 1]
    assert m.tables[1, 2] != m.tables[0, 2]      # private tails differ
    # physical 3 + 1; logical: 3 + 3 mappings and 2 index references
    assert m.allocator.used == 4 and m.allocator.logical == 8
    plan2 = m.plan_admit(prompt[:4] + [99] * 6)  # diverges after one page
    assert plan2.cached_tokens == 4 and plan2.shared_pages == [int(m.tables[0, 0])]
    with pytest.raises(ValueError, match="shared"):
        m.prefill_page_idx(1, 3)                  # a scatter onto shared pages


def test_manager_cow_fork_on_aligned_full_match():
    m = _mgr(num_pages=10, slots=2)
    prompt = list(range(8))                      # exactly 2 pages
    m.admit_prefix(0, m.plan_admit(prompt))
    m.register_prefix(0, prompt)
    plan = m.plan_admit(list(prompt))
    # the write frontier lands inside the last matched page: fork it
    assert plan.cow_src == int(m.tables[0, 1]) and plan.cached_tokens == 7
    assert plan.private_blocks == 1 and len(plan.shared_pages) == 1
    m.admit_prefix(1, plan)
    assert plan.cow_dst not in (None, plan.cow_src)
    assert m.tables[1, 0] == m.tables[0, 0] and int(m.tables[1, 1]) == plan.cow_dst
    m.allocator.assert_writable(plan.cow_dst)
    with pytest.raises(ValueError, match="shared"):
        m.allocator.assert_writable(int(m.tables[1, 0]))
    # the source is pinned (slot 0 + index + pin) until the copy is queued
    assert m.allocator.refcount(plan.cow_src) == 3
    m.cow_release(plan)
    assert m.allocator.refcount(plan.cow_src) == 2
    assert m.stats().cow_forks == 1 and m.stats().cached_prefix_tokens == 7
    # a one-token prompt caches nothing, fork or not
    m1 = _mgr(num_pages=4, page_size=1, slots=2)
    m1.admit_prefix(0, m1.plan_admit([5]))
    m1.register_prefix(0, [5])
    one = m1.plan_admit([5])
    assert one.cached_tokens == 0 and one.cow_src is None and one.private_blocks == 1


def test_manager_cow_fork_under_oom():
    """The fork needs a page: with none free and nothing evictable the
    admission fails whole, tables and refcounts unchanged."""
    m = _mgr(num_pages=3, slots=2, max_seq=16)   # 2 usable pages
    prompt = list(range(8))
    m.admit_prefix(0, m.plan_admit(prompt))
    m.register_prefix(0, prompt)
    before = {p: m.allocator.refcount(p) for p in m.owned[0]}
    plan = m.plan_admit(list(prompt))
    assert plan.cow_src is not None and not m.can_admit_plan(plan)
    assert m.admit_prefix(1, plan) is None
    assert not m.owned[1] and all(t == TRASH_PAGE for t in m.tables[1])
    assert {p: m.allocator.refcount(p) for p in m.owned[0]} == before


def test_manager_retract_above_shared_boundary():
    """retract_above never frees a page another slot or the index holds:
    a retract into the shared region drops this slot's references only."""
    m = _mgr(num_pages=12, slots=2)
    prompt = list(range(12))                     # 3 aligned pages
    m.admit_prefix(0, m.plan_admit(prompt))
    m.register_prefix(0, prompt)
    m.admit_prefix(1, m.plan_admit(list(prompt)))   # shares 2, forks 1
    shared_pg = int(m.tables[1, 1])
    assert shared_pg == int(m.tables[0, 1])
    used_before = m.allocator.used
    assert m.retract_above(1, 4) == 2            # blocks 1 (shared) + 2 (fork)
    assert m.tables[1, 1] == TRASH_PAGE and m.tables[1, 2] == TRASH_PAGE
    assert int(m.tables[0, 1]) == shared_pg      # the other slot is untouched
    assert m.allocator.refcount(shared_pg) == 2  # slot 0 + index
    assert m.allocator.used == used_before - 1   # only the fork freed


def test_manager_release_keeps_index_pages_then_eviction_reclaims():
    m = _mgr(num_pages=5, slots=1, max_seq=16)   # 4 usable
    prompt = list(range(8))
    m.admit_prefix(0, m.plan_admit(prompt))
    m.register_prefix(0, prompt)
    m.release(0)
    # the index keeps the released prefix as reusable cache
    assert (m.allocator.used, m.allocator.free, len(m.index)) == (2, 2, 2)
    assert m.plan_admit(list(prompt)).cached_tokens == 7
    # an unrelated admission needing the whole pool evicts the entries
    plan2 = m.plan_admit([99] * 16)
    assert plan2.private_blocks == 4 and m.can_admit_plan(plan2)
    assert m.available() == 4
    assert m.admit_prefix(0, plan2) is not None
    assert m.evictions == 2 and len(m.index) == 0


def test_manager_trace_matches_reference():
    """Plans, admissions, publications, retracts and releases of random
    overlapping prompts on a small pool: the same tables, refcounts,
    evictions and stats as the reference manager's."""
    rng = np.random.default_rng(6)
    kw = dict(num_pages=10, page_size=4, slots=3, max_seq=32)
    m = PagedCacheManager(**kw, prefix_index=PrefixIndex(4, policy="lfu"))
    ref = jkv.PagedCacheManager(**kw, prefix_index=jpi.PrefixIndex(4, policy="lfu"))
    base = rng.integers(0, 3, 20).tolist()
    for _ in range(200):
        slot = int(rng.integers(3))
        if m.owned[slot]:
            if rng.random() < 0.3:
                n = int(rng.integers(0, 20))
                assert m.retract_above(slot, n) == ref.retract_above(slot, n)
            else:
                m.release(slot)
                ref.release(slot)
        else:
            prompt = base[:int(rng.integers(1, 20))] + rng.integers(
                0, 3, int(rng.integers(0, 5))).tolist()
            plan, rplan = m.plan_admit(prompt), ref.plan_admit(prompt)
            assert (plan.shared_pages, plan.cached_tokens, plan.cow_src) == (
                rplan.shared_pages, rplan.cached_tokens, rplan.cow_src)
            ok = m.can_admit_plan(plan, headroom=1)
            assert ok == ref.can_admit_plan(rplan, headroom=1)
            if ok:
                got, want = m.admit_prefix(slot, plan), ref.admit_prefix(slot, rplan)
                assert (got is None) == (want is None)
                if got is not None:
                    assert plan.cow_dst == rplan.cow_dst
                    m.cow_release(plan)
                    ref.cow_release(rplan)
                    assert m.register_prefix(slot, prompt) == ref.register_prefix(slot, prompt)
        np.testing.assert_array_equal(m.tables, ref.tables)
        assert (m.allocator.used, m.allocator.logical) == (ref.allocator.used,
                                                           ref.allocator.logical)
    got, want = m.stats(), ref.stats()
    for field in ("used_pages", "peak_used_pages", "peak_logical_pages", "sharing_ratio",
                  "shares", "cow_forks", "evictions", "index_pages",
                  "cached_prefix_tokens", "retracts", "logical_pages", "physical_pages"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.evictions > 0 and got.cow_forks > 0 and got.sharing_ratio > 1


def test_gather_slot_resolves_shared_and_poisons_unmapped():
    L, H, D, ps, P = 2, 2, 8, 4, 10
    m = PagedCacheManager(P, ps, 2, 16, prefix_index=PrefixIndex(ps))
    prompt = list(range(10))                     # 2 full pages + a partial one
    m.admit_prefix(0, m.plan_admit(prompt))
    pool = init_page_pool(L, P, ps, H, D, torch.float32, "cpu")
    rng = np.random.default_rng(1)
    pcache = {n: torch.from_numpy(rng.standard_normal((L, 1, 12, H, D)).astype(np.float32))
              for n in "kv"}
    # scatter targets must be private: the prefill lands before the
    # prefix is published and shared
    scatter_prefill(pool, pcache, torch.as_tensor(m.prefill_page_idx(0, 3))[None])
    m.register_prefix(0, prompt)
    m.admit_prefix(1, m.plan_admit(list(prompt)))
    v0 = gather_slot(pool, torch.as_tensor(m.tables[0]))
    v1 = gather_slot(pool, torch.as_tensor(m.tables[1]))
    assert torch.equal(v0["k"][:, :8], v1["k"][:, :8])
    assert torch.equal(v0["k"][:, :8], pcache["k"][:, 0, :8])
    # mapped-but-stale rows are real data; unmapped blocks poison to NaN
    assert not v0["k"][:, :12].isnan().any()
    assert v0["k"][:, 16:].isnan().all() and v1["v"][:, 16:].isnan().all()
    # and the reference's view of the same pool and tables is the same
    jpool = {n: jnp.asarray(t.numpy()) for n, t in pool.items()}
    ref = jkv.gather_slot(jpool, jnp.asarray(m.tables[1]), ps)
    np.testing.assert_array_equal(np.asarray(ref["k"]), v1["k"].numpy())


def test_copy_pages_forks_every_leaf_int8_scales_included():
    L, H, D, ps, P = 2, 1, 8, 4, 6
    rng = np.random.default_rng(2)
    pool = init_page_pool(L, P, ps, H, D, torch.float32, "cpu", kv_dtype="int8")
    for name, t in pool.items():
        t.copy_(torch.from_numpy(rng.integers(-127, 128, t.shape)).to(t.dtype))
    want = {n: t.clone() for n, t in pool.items()}
    copy_pages(pool, [2, 4], [5, 1])
    jpool = jkv.copy_pages({n: jnp.asarray(t.numpy()) for n, t in want.items()},
                           jnp.asarray([2, 4], jnp.int32), jnp.asarray([5, 1], jnp.int32))
    for name in want:
        assert torch.equal(pool[name][:, [5, 1]], want[name][:, [2, 4]]), name
        assert torch.equal(pool[name][:, [0, 2, 3, 4]], want[name][:, [0, 2, 3, 4]])
        np.testing.assert_array_equal(pool[name].numpy(), np.asarray(jpool[name]))


# ---------------------------------------------------------------------------
# the engine: shared tokens equal the reference engine's unshared tokens
# ---------------------------------------------------------------------------

def test_shared_matches_reference_unshared_greedy():
    spec = _shared_spec(4)
    want = _ref_tokens("base", spec)
    got, eng = _port_serve(spec, prefix_sharing=True)
    assert got == want
    p = eng.last_pool_stats
    assert p.sharing_ratio > 1.0 and p.cached_prefix_tokens > 0
    assert p.cow_forks >= 1                      # the aligned copy
    # the suffix prefills log their suffix bucket beside the prompt length
    assert any(b < n[0] for _, b, n in eng.last_prefill_groups)
    unshared, eng_off = _port_serve(spec)
    assert unshared == want and eng_off.last_pool_stats.shares == 0


def test_shared_matches_reference_across_admission_orders():
    spec = _shared_spec(5, seed=11)
    want = _ref_tokens("orders", spec, batch_slots=3)
    rng = np.random.default_rng(0)
    for trial in range(3):
        order = list(spec)
        rng.shuffle(order)
        got, _ = _port_serve(order, batch_slots=3, prefix_sharing=True)
        assert got == want, f"trial {trial}"


def test_shared_forced_preemption_matches_reference():
    """A pool too small for the working set forces preempt-and-requeue;
    the resumed request re-matches its own published prefix."""
    spec = [(0, list(range(1, 17)), 12), (1, list(range(1, 17)) + [77, 78], 12)]
    want = _ref_tokens("preempt", spec)
    got, eng = _port_serve(spec, prefix_sharing=True, num_pages=6)
    assert got == want and eng.preemptions >= 1
    # request 1 took request 0's 16 tokens at admission, and its resume
    # re-matched its own published prefix on top
    assert eng.last_stats[1]["cached_prefix_tokens"] == 16
    assert eng.last_pool_stats.cached_prefix_tokens > 16


def test_shared_with_spec_decode_matches_reference():
    """Speculative windows ride shared prefixes: rollback retracts only
    private window pages."""
    spec = _shared_spec(3, seed=7, max_new=6)
    want = _ref_tokens("spec", spec)
    got, eng = _port_serve(spec, prefix_sharing=True, spec_k=2, draft="self:1")
    assert got == want
    assert eng.last_pool_stats.cached_prefix_tokens > 0
    assert eng.last_pool_stats.logical_pages == 0


def test_shared_page_bound():
    """N requests over a page-aligned common prefix hold at most
    prefix_pages + N * suffix_pages physical pages."""
    ps, n = 8, 4
    spec = _shared_spec(n, prefix_len=16, dup_aligned=False)
    want = _ref_tokens("bound", spec)
    got, eng_on = _port_serve(spec, prefix_sharing=True)
    off, eng_off = _port_serve(spec)
    assert got == want == off
    prefix_pages = 16 // ps
    suffix_pages = sum(-(-(len(p) + m - 1) // ps) - prefix_pages for _, p, m in spec)
    p_on, p_off = eng_on.last_pool_stats, eng_off.last_pool_stats
    assert p_on.peak_used_pages <= prefix_pages + suffix_pages
    assert p_on.peak_used_pages < p_off.peak_used_pages
    cached = [eng_on.last_stats[u]["cached_prefix_tokens"] for u, _, _ in spec]
    assert cached[0] == 0 and all(c == 16 for c in cached[1:])


def test_shared_stats_logical_vs_physical():
    spec = _shared_spec(4, seed=3)
    results, eng = _port_serve(spec, prefix_sharing=True)
    assert results == _ref_tokens("base", spec)
    p = eng.last_pool_stats
    assert p.logical_tokens == p.logical_pages * p.page_size
    assert p.physical_tokens == p.physical_pages * p.page_size
    assert p.peak_logical_pages >= p.peak_used_pages and p.sharing_ratio >= 1.0
    # every slot released: what stays is exactly the index's cache
    assert p.logical_pages == 0 and p.physical_pages == 0
    assert p.used_pages == p.index_pages > 0
    assert p.shares > 0 and p.num_pages == eng.num_pages
    for uid in results:
        assert "cached_prefix_tokens" in eng.last_stats[uid]


def test_engine_rejects_sharing_misconfiguration():
    m = _models()
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(m["tm"], m["tp"], max_seq=32, batch_slots=2, prefix_sharing=True)
    moe = Model(reduced_config("olmoe-1b-7b"), device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="family"):
        ServeEngine(moe, {}, max_seq=32, batch_slots=2, cache_layout="paged",
                    prefix_sharing=True)
    with pytest.raises(ValueError, match="evict_policy"):
        _port_serve([], prefix_sharing=True, evict_policy="mru")
    with pytest.raises(ValueError, match="min_cached_tokens"):
        _port_serve([], prefix_sharing=True, min_cached_tokens=-1)


@pytest.mark.parametrize("policy", EVICT_POLICIES)
def test_engine_eviction_policies_greedy_identical(policy):
    """Policies change which pages linger, never the tokens: every policy
    serves the reference engine's unshared tokens on a pool that evicts."""
    vocab = reduced_config(ARCH).vocab
    rng = np.random.default_rng(11)
    prefixes = [rng.integers(0, vocab, 16).tolist() for _ in range(3)]
    spec = [(i, prefixes[i % 3] + rng.integers(0, vocab, 3 + i).tolist(), 4)
            for i in range(6)]
    want = _ref_tokens("policies", spec, num_pages=9)
    got, eng = _port_serve(spec, num_pages=9, prefix_sharing=True,
                           evict_policy=policy, min_cached_tokens=8)
    assert got == want
    p = eng.last_pool_stats
    assert p.evictions >= 1 and p.logical_pages == 0
    assert p.used_pages == p.index_pages


# ---------------------------------------------------------------------------
# Model.prefill_suffix and the long-window verify attention
# ---------------------------------------------------------------------------

def test_prefill_suffix_logits_match_reference():
    """Two rows whose 16- and 8-token prefixes were prefilled into a pool
    by the reference; both models then prefill the right-padded suffixes
    (T = 24, T * G = 96 query rows a KV head) through the same tables,
    from the same pool: the logits agree within 1e-5, and so do the pool
    rows the suffix wrote.  The port's logits also match its own full
    prefill of the whole prompts."""
    m = _models()
    cfg = reduced_config(ARCH)
    rng = np.random.default_rng(9)
    ps, nb, n_pages = 8, 6, 16
    prefix_lens, suffix_lens, t_b = [16, 8], [19, 24], 24
    prompts = [rng.integers(0, cfg.vocab, a + b).tolist()
               for a, b in zip(prefix_lens, suffix_lens)]
    tables = np.zeros((2, nb), np.int32)
    tables[0, :6] = [3, 7, 1, 9, 12, 4]          # shuffled pages, all mapped
    tables[1, :4] = [2, 15, 6, 10]               # row 1's tail stays trash
    jpool = jkv.init_page_pool(cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.d_head,
                               jnp.float32)
    for r, (prompt, n0) in enumerate(zip(prompts, prefix_lens)):
        _, pc = m["jm"].prefill(m["jp"], {"tokens": jnp.asarray([prompt[:n0]])}, n0)
        jpool = jkv.scatter_prefill(jpool, {"k": pc["k"], "v": pc["v"]},
                                    jnp.asarray(tables[r:r + 1, :n0 // ps]))
    toks = np.zeros((2, t_b), np.int32)
    for r, (prompt, n0) in enumerate(zip(prompts, prefix_lens)):
        toks[r, :len(prompt) - n0] = prompt[n0:]
    start = np.asarray(prefix_lens, np.int32)
    last = np.asarray([n - 1 for n in suffix_lens], np.int32)
    tpool = {n: torch.from_numpy(np.array(a)) for n, a in jpool.items()}
    want, jout = m["jm"].prefill_suffix(m["jp"], dict(jpool, block_tables=jnp.asarray(tables)),
                                        jnp.asarray(toks), jnp.asarray(start),
                                        jnp.asarray(last), 48)
    got, tout = m["tm"].prefill_suffix(m["tp"], dict(tpool, block_tables=torch.from_numpy(tables)),
                                       torch.from_numpy(toks).long(), torch.from_numpy(start),
                                       torch.from_numpy(last), 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tout[name].numpy(), np.asarray(jout[name]), **LOGIT_TOL)
    for r, prompt in enumerate(prompts):
        full, _ = m["tm"].prefill(m["tp"], torch.tensor([prompt]), len(prompt))
        np.testing.assert_allclose(got[r].numpy(), full[0].numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("t_window,group,pos", [(16, 4, (0, 21)), (9, 6, (40, 5))])
def test_plain_verify_long_window_matches_pallas(t_window, group, pos):
    """The plain version the CPU path runs, at T * G > 32 (a suffix
    prefill's shape, where the card takes the long-window branch), against
    the Pallas paged_flash_verify in interpret mode: pos 0, mid-page, and
    a window past the table's end (the trash page's rows)."""
    rng = np.random.default_rng(t_window)
    b, hkv, d, ps, nb, n_pages = 2, 2, 32, 8, 6, 14
    q = rng.standard_normal((b, hkv, t_window * group, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32) for _ in "kv")
    bt = np.stack([rng.permutation(np.arange(1, n_pages))[:nb] for _ in range(b)])
    bt = bt.astype(np.int32)
    bt[1, 4:] = TRASH_PAGE
    pos_np = np.asarray(pos, np.int32)
    want = pallas_paged_flash_verify(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                     jnp.asarray(bt), jnp.asarray(pos_np),
                                     t_window=t_window, interpret=True)
    got = paged_verify_attention_ref(torch.from_numpy(q), torch.from_numpy(kp),
                                     torch.from_numpy(vp), torch.from_numpy(bt),
                                     torch.from_numpy(pos_np), t_window)
    assert t_window * group > 32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_reserving_shared_requests_is_fresh():
    """Serving the same Request objects again starts from an empty index:
    the second serve() matches the first, and its first request caches
    nothing."""
    m = _models()
    spec = _shared_spec(3, seed=13, max_new=3)
    eng = ServeEngine(m["tm"], m["tp"], prefix_sharing=True, **ENGINE_KW)
    reqs = [Request(u, list(p), n) for u, p, n in spec]
    first = copy.deepcopy(eng.serve(reqs))
    assert eng.serve(reqs) == first
    assert eng.last_stats[0]["cached_prefix_tokens"] == 0
