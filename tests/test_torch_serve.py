"""The port's serving layer: the page allocator and cache-manager
scenarios of ``test_kv_cache.py`` replayed on the port, and the port's
``ServeEngine`` giving the reference engine's greedy tokens on the dense
and the paged layout, through a forced preempt-and-requeue too.  Reduced
qwen2-1.5b in fp32 on the CPU."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.kv_cache import PageAllocator as JaxPageAllocator  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import (  # noqa: E402
    TRASH_PAGE,
    PageAllocator,
    PagedCacheManager,
    gather_slot,
    scatter_prefill,
)
from repro_torch.testing import params_from_numpy  # noqa: E402

ARCH = "qwen2-1.5b"
_CACHE = {}


# ---------------------------------------------------------------------------
# allocator and manager scenarios (test_kv_cache.py, replayed)
# ---------------------------------------------------------------------------

def test_allocator_alloc_free_reuse():
    a = PageAllocator(8)                      # 7 usable, page 0 is trash
    assert a.usable == 7 and a.free == 7 and a.used == 0
    p1 = a.alloc(3)
    assert p1 is not None and len(p1) == 3 and TRASH_PAGE not in p1
    assert a.used == 3 and a.free == 4
    a.release(p1[:2])
    assert a.used == 1 and a.free == 6
    p2 = a.alloc(2)                           # LIFO reuse
    assert set(p2) == set(p1[:2][::-1])
    assert a.alloc_count == 5 and a.free_count == 2


def test_allocator_all_or_nothing_and_double_free():
    a = PageAllocator(4)
    assert a.alloc(4) is None and a.free == 3 and a.used == 0
    p = a.alloc(3)
    assert a.alloc(1) is None
    a.assert_writable(p[0])
    a.release(p)
    with pytest.raises(ValueError):
        a.release(p)
    with pytest.raises(ValueError):
        a.release([TRASH_PAGE])
    with pytest.raises(ValueError, match="unallocated"):
        a.assert_writable(p[0])


def test_allocator_fragmentation_trace_matches_reference():
    """The same random alloc/release sequence hands out the same pages on
    both allocators, and the accounting identity holds throughout."""
    rng = np.random.default_rng(0)
    a, ref = PageAllocator(17), JaxPageAllocator(17)
    held = []
    for _ in range(200):
        if held and rng.random() < 0.45:
            p = held.pop(int(rng.integers(len(held))))
            a.release(p)
            ref.release(p)
        else:
            n = int(rng.integers(1, 4))
            p = a.alloc(n)
            assert p == ref.alloc(n)
            if p is not None:
                held.append(p)
        assert a.used + a.free == a.usable
        assert a.used == sum(len(h) for h in held) == ref.used
    assert a.peak_used == ref.peak_used


def test_manager_admit_grow_release():
    m = PagedCacheManager(num_pages=9, page_size=4, slots=2, max_seq=32)
    assert m.max_blocks == 8
    pages = m.admit(0, prompt_len=6)          # 2 blocks
    assert len(pages) == 2 and list(m.tables[0, :2]) == pages
    assert all(t == TRASH_PAGE for t in m.tables[0, 2:])
    assert m.ensure_block(0, 2) and m.ensure_block(0, 2)
    assert m.allocator.used == 3
    assert m.ensure_block(0, 99)              # past max_blocks: no-op success
    m.release(0)
    assert m.allocator.used == 0 and all(t == TRASH_PAGE for t in m.tables[0])
    m2 = PagedCacheManager(num_pages=3, page_size=4, slots=1, max_seq=32)
    assert m2.admit(0, prompt_len=100) is None and m2.allocator.used == 0


def test_manager_worst_case_gate():
    m = PagedCacheManager(num_pages=5, page_size=8, slots=1, max_seq=256)
    assert not m.fits_worst_case(10, 30, max_seq=256)
    assert m.fits_worst_case(10, 20, max_seq=256)
    assert m.fits_worst_case(10, 300, max_seq=30)


def test_scatter_prefill_roundtrip():
    L, B, S, H, D, ps, P = 2, 3, 10, 2, 8, 4, 12
    m = PagedCacheManager(num_pages=P, page_size=ps, slots=B, max_seq=16)
    lens = [10, 5, 3]
    for s, ln in enumerate(lens):
        m.admit(s, ln)
    pool = {"k_pages": torch.zeros(L, P, ps, H, D),
            "v_pages": torch.zeros(L, P, ps, H, D)}
    gen = torch.Generator().manual_seed(0)
    pcache = {"k": torch.randn(L, B, S, H, D, generator=gen),
              "v": torch.randn(L, B, S, H, D, generator=gen)}
    nb = -(-S // ps)
    page_idx = torch.as_tensor(np.stack([m.prefill_page_idx(s, nb) for s in range(B)]))
    scatter_prefill(pool, pcache, page_idx)
    for s, ln in enumerate(lens):
        view = gather_slot(pool, torch.as_tensor(m.tables[s]))
        for name in ("k", "v"):
            torch.testing.assert_close(view[name][:, :ln], pcache[name][:, s, :ln])
        assert torch.isnan(view["k"][:, -(-ln // ps) * ps:]).all()   # unmapped


# ---------------------------------------------------------------------------
# engine: greedy tokens equal to the reference engine
# ---------------------------------------------------------------------------

def _models():
    if not _CACHE:
        jm = JaxModel(jax_reduced_config(ARCH), compute_dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(1))
        tm = Model(reduced_config(ARCH), device="cpu", dtype=torch.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), reduced_config(ARCH), device="cpu")
        _CACHE.update(jm=jm, jp=jp, tm=tm, tp=tp)
    return _CACHE


def _reqs(n=6, seed=3):
    """Mixed prompt lengths and budgets, one request completing at
    admission (max_new_tokens=1)."""
    rng = np.random.default_rng(seed)
    out = [(i, rng.integers(0, 512, int(rng.integers(3, 20))).tolist(),
            int(rng.integers(2, 9))) for i in range(n)]
    out.append((n, [1, 2, 3], 1))
    return out


def _jax_serve(spec, **kw):
    m = _models()
    key = ("jax", tuple(sorted(kw.items())))
    if key not in _CACHE:
        eng = JaxServeEngine(m["jm"], m["jp"], temperature=0.0, seed=0, **kw)
        _CACHE[key] = (eng.serve([JaxRequest(u, list(p), n) for u, p, n in spec]),
                       eng.preemptions)
    return _CACHE[key]


def _port_serve(spec, **kw):
    m = _models()
    eng = ServeEngine(m["tm"], m["tp"], **kw)
    return eng.serve([Request(u, list(p), n) for u, p, n in spec]), eng


@pytest.mark.parametrize("kw", [
    dict(max_seq=48, batch_slots=2),
    dict(max_seq=48, batch_slots=3, cache_layout="paged", page_size=8),
    # a pool too small for the batch's growth: forced preempt-and-requeue
    dict(max_seq=48, batch_slots=3, cache_layout="paged", page_size=8,
         num_pages=5),
], ids=["dense", "paged", "paged-preempt"])
def test_serve_greedy_tokens_match_reference(kw):
    spec = _reqs()
    want, want_preempt = _jax_serve(spec, **kw)
    got, eng = _port_serve(spec, **kw)
    assert got == want
    assert eng.preemptions == want_preempt
    if kw.get("num_pages"):
        assert eng.preemptions >= 1
    for u, _, n in spec:
        s = eng.last_stats[u]
        assert s["status"] == "ok" and s["tokens"] == n == len(got[u])
    if kw.get("cache_layout") == "paged":
        p = eng.last_pool_stats
        assert p.used_pages == 0 and p.allocs == p.frees > 0


def test_port_dense_equals_paged_and_reserving_is_fresh():
    spec = _reqs(seed=11)
    dense, _ = _port_serve(spec, max_seq=48, batch_slots=2)
    paged, eng = _port_serve(spec, max_seq=48, batch_slots=2,
                             cache_layout="paged", page_size=8, num_pages=5)
    assert paged == dense
    reqs = [Request(u, list(p), n) for u, p, n in spec]
    first = eng.serve(reqs)
    first_copy = copy.deepcopy(first)
    assert eng.serve(reqs) == first_copy      # same Request objects again
    assert first == first_copy


def test_engine_rejects_what_it_cannot_serve():
    m = _models()
    eng = ServeEngine(m["tm"], m["tp"], max_seq=32, batch_slots=1,
                      cache_layout="paged", page_size=8, num_pages=3)
    with pytest.raises(ValueError, match="never fit"):
        eng.serve([Request(0, list(range(10)), 12)])
    with pytest.raises(ValueError, match="decode room"):
        eng.serve([Request(0, list(range(40)), 2)])
