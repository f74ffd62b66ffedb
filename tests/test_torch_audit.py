"""The port's invariant audit (``serve.audit``), the allocator's fault hook
and ``poison_pages`` against the reference's: the audit cases of
``test_faults.py``, ``test_tiered_kv.py`` and ``test_prefix_sharing.py``.

The same allocator and manager operations (and the same deliberate
corruptions: a leaked refcount, an orphan, a corrupt free list, a double
mapping, index references) drive a manager of each package, and the two
audit reports must be equal, error strings included.  ``audit_pool``'s
structural and value checks run on pools quantized by each package from
the same numpy rows.  ``poison_pages`` must write the reference's bytes:
NaN in float leaves and in int8 pools' scales, 0 in int8 values.  The
engine-level cases (the per-round audit catching a leaky release, the
audit fields of ``last_pool_stats``, the eviction policies under
``audit=True``) run reduced qwen2-1.5b in fp32 on the CPU."""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.serve import audit as jaudit  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro.serve import prefix_index as jpi  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.serve import audit, faults, kv_cache  # noqa: E402
from repro_torch.serve import prefix_index as tpi  # noqa: E402
from repro_torch.serve.engine import STATUS_OK, Request  # noqa: E402
from repro_torch.serve.prefix_index import EVICT_POLICIES  # noqa: E402
from test_torch_faults import ref  # noqa: E402
from test_torch_scheduling import (  # noqa: E402
    ARCH,
    PIPELINES,
    one_intra_op_thread,
    port_engine,
    reqs,
)


def _report(rep):
    return dataclasses.astuple(rep)


def managers(num_pages=8, page_size=4, slots=2, max_seq=16, index=False, kv_dtype=None):
    """A (port, reference) pair of managers of one configuration."""
    return tuple(
        mod.PagedCacheManager(num_pages, page_size, slots, max_seq,
                              prefix_index=pi.PrefixIndex(page_size) if index else None,
                              kv_dtype=kv_dtype)
        for mod, pi in ((kv_cache, tpi), (jkv, jpi)))


def both(pair, fn):
    """Apply ``fn`` to each manager of the pair; the port's result."""
    return [fn(m) for m in pair][0]


def assert_same_audit(pair):
    got, want = (m.audit() for m in pair)
    assert _report(got) == _report(want)
    assert _report(audit.audit_manager(pair[0])) == _report(jaudit.audit_manager(pair[1]))
    return got


# --------------------------------------------------- constructed violations
def test_audit_detects_leaked_refcount():
    pair = managers()
    both(pair, lambda m: m.admit(0, 6))
    assert assert_same_audit(pair).ok

    def leak(m):
        m.allocator._refs[m.owned[0][0]] += 1
        m.allocator._logical += 1
    both(pair, leak)
    rep = assert_same_audit(pair)
    assert not rep.ok and rep.refcount_mismatches == 1
    with pytest.raises(audit.AuditError) as err:
        rep.raise_if_failed()
    assert isinstance(err.value, AssertionError)
    assert str(err.value) == str(jaudit.AuditError(pair[1].audit()))


def test_audit_detects_orphan_page():
    pair = managers()
    both(pair, lambda m: m.admit(0, 6))

    def orphan(m):
        m.owned[0].pop()
        m.tables[0, 1] = 0
    both(pair, orphan)
    rep = assert_same_audit(pair)
    assert not rep.ok and rep.orphan_pages == 1
    assert any(e.startswith("orphan page") for e in rep.errors)


def test_audit_detects_double_mapping():
    pair = managers()
    both(pair, lambda m: m.admit(0, 8))

    def double(m):
        m.tables[0, 1] = m.tables[0, 0]
    both(pair, double)
    rep = assert_same_audit(pair)
    assert any("two logical blocks" in e for e in rep.errors)


@pytest.mark.parametrize("corrupt", [
    "free_and_allocated", "duplicate_free", "trash", "out_of_range", "refcount_zero",
    "logical"])
def test_allocator_audit_matches_reference(corrupt):
    """Each allocator invariant broken the same way in both packages
    gives the same error list (``PageAllocator.audit``)."""
    def run(mod):
        a = mod.PageAllocator(8)
        pages = a.alloc(3)
        assert a.audit() == []
        if corrupt == "free_and_allocated":
            a._free.append(pages[0])
        elif corrupt == "duplicate_free":
            a._free.append(a._free[0])
        elif corrupt == "trash":
            a._free.append(0)
        elif corrupt == "out_of_range":
            a._refs[11] = 1
            a._logical += 1
        elif corrupt == "refcount_zero":
            a._refs[pages[1]] = 0
        else:
            a._logical += 2
        return a.audit()
    got = run(kv_cache)
    assert got and got == run(jkv)


def test_audit_with_prefix_index_matches_reference():
    """A published prefix, a second request sharing it, both released
    (the index alone holds the pages): the clean reports agree at every
    step; then an index page's refcount raised with no holder gives the
    reference's mismatch."""
    pair = managers(num_pages=12, slots=3, max_seq=32, index=True)
    prompt = list(range(1, 11))
    both(pair, lambda m: m.admit(0, len(prompt)))
    both(pair, lambda m: m.register_prefix(0, prompt))
    assert assert_same_audit(pair).ok
    plans = [m.plan_admit(prompt + [99, 98]) for m in pair]
    for m, p in zip(pair, plans):
        assert m.admit_prefix(1, p) is not None
        m.cow_release(p)
    assert assert_same_audit(pair).ok
    both(pair, lambda m: m.release(0))
    both(pair, lambda m: m.release(1))
    rep = assert_same_audit(pair)
    assert rep.ok and pair[0].allocator.used == len(pair[0].index) > 0

    def drop_index_ref(m):
        page = next(iter(m.index.pages()))
        m.allocator._refs[page] += 1
        m.allocator._logical += 1
    both(pair, drop_index_ref)
    rep = assert_same_audit(pair)
    assert not rep.ok and rep.refcount_mismatches == 1


def test_audit_manager_operation_trace_matches_reference():
    """A seeded trace of admissions, growth, spec retraction and releases:
    the two reports agree after every operation and stay clean."""
    rng = np.random.default_rng(7)
    pair = managers(num_pages=14, page_size=4, slots=3, max_seq=40)
    for _ in range(120):
        slot = int(rng.integers(3))
        op = int(rng.integers(4))
        if op == 0 and not pair[0].owned[slot]:
            n = int(rng.integers(1, 13))
            got = [m.admit(slot, n) for m in pair]
            assert (got[0] is None) == (got[1] is None)
        elif op == 1 and pair[0].owned[slot]:
            blk = int(rng.integers(10))
            assert pair[0].ensure_block(slot, blk) == pair[1].ensure_block(slot, blk)
        elif op == 2 and pair[0].owned[slot]:
            n = int(rng.integers(1, 40))
            assert pair[0].retract_above(slot, n) == pair[1].retract_above(slot, n)
        elif op == 3:
            both(pair, lambda m: m.release(slot))
        assert assert_same_audit(pair).ok


def test_audit_fleet_matches_reference():
    fleet = {"a": managers(), "b": managers(), "dense": (None, None)}
    for pair in (fleet["a"], fleet["b"]):
        both(pair, lambda m: m.admit(0, 6))

    def leak(m):
        m.allocator._refs[m.owned[0][0]] += 1
        m.allocator._logical += 1
    both(fleet["b"], leak)
    got = audit.audit_fleet({w: p[0] for w, p in fleet.items()})
    want = jaudit.audit_fleet({w: p[1] for w, p in fleet.items()})
    assert _report(got) == _report(want)
    assert not got.ok and all(e.startswith("[worker b]") for e in got.errors)


# -------------------------------------------------------------- the fault hook
def test_fault_hook_denies_and_raises_as_reference():
    """``fault_hook(n)`` is asked only for n > 0: True denies (None, nothing
    allocated), an exception propagates, and alloc(0) never asks."""
    for mod in (kv_cache, jkv):
        a = mod.PageAllocator(6)
        calls = []

        def hook(n, calls=calls):
            calls.append(n)
            if n == 3:
                raise faults.InjectedFault("hard")
            return n == 2
        a.fault_hook = hook
        assert a.alloc(0) == [] and calls == []
        assert a.alloc(2) is None and a.free == 5
        with pytest.raises(faults.InjectedFault):
            a.alloc(3)
        assert a.alloc(1) == [1] and calls == [2, 3, 1]
        assert a.audit() == []


def test_pool_stats_carry_audit_fields():
    eng = port_engine()
    eng.serve([Request(**r) for r in reqs(3)])
    p = eng.last_pool_stats
    assert p.audit_ok and p.audit_errors == []
    assert p.audit_orphan_pages == 0 and p.audit_refcount_mismatches == 0
    fields = {f.name for f in dataclasses.fields(kv_cache.PagedStats)}
    assert fields == {f.name for f in dataclasses.fields(jkv.PagedStats)}


def test_audit_manager_function_directly():
    pair = managers()
    both(pair, lambda m: m.admit(0, 5))
    both(pair, lambda m: m.admit(1, 4))
    rep = assert_same_audit(pair)
    assert rep.ok and rep.errors == []
    both(pair, lambda m: m.release(0))
    both(pair, lambda m: m.release(1))
    assert assert_same_audit(pair).ok


# ------------------------------------------------------------------ audit_pool
def _pools(rng, n_pages=8, page_size=4):
    """The same random K/V rows quantized into an int8 pool by each
    package: (port pool, reference pool)."""
    kv = rng.normal(size=(2, 1, n_pages, page_size, 2, 8)).astype(np.float32)
    port, refp = {}, {}
    for i, name in enumerate("kv"):
        q, s = kv_cache.quantize_kv_rows(torch.from_numpy(kv[i]))
        port[f"{name}_pages"], port[f"{name}_scales"] = q, s
        jq, js = jkv.quantize_kv_rows(jnp.asarray(kv[i]))
        refp[f"{name}_pages"], refp[f"{name}_scales"] = jq, js
    return port, refp


def _pool_cases(port, refp, mapped):
    """(name, port pool, reference pool) pairs of each corruption."""
    yield "consistent", port, refp
    yield ("bare", {n: port[n] for n in ("k_pages", "v_pages")},
           {n: refp[n] for n in ("k_pages", "v_pages")})
    yield ("scale shape", dict(port, k_scales=port["k_scales"][:, :4]),
           dict(refp, k_scales=refp["k_scales"][:, :4]))
    yield ("scale dtype", dict(port, v_scales=port["v_scales"].half()),
           dict(refp, v_scales=refp["v_scales"].astype(jnp.float16)))
    yield ("value dtype", dict(port, k_pages=port["k_pages"].float()),
           dict(refp, k_pages=refp["k_pages"].astype(jnp.float32)))
    nan_k = port["k_scales"].clone()
    nan_k[:, mapped] = float("nan")
    yield ("nan scale", dict(port, k_scales=nan_k),
           dict(refp, k_scales=refp["k_scales"].at[:, mapped].set(jnp.nan)))
    neg_v = port["v_scales"].clone()
    neg_v[:, mapped] = -1.0
    yield ("negative scale", dict(port, v_scales=neg_v),
           dict(refp, v_scales=refp["v_scales"].at[:, mapped].set(-1.0)))


def test_audit_pool_cases_match_reference():
    """Structure always, values opt-in: every case's two reports (with and
    without the value sweep) are the reference's, error strings included
    (test_tiered_kv.py's consistent-pool and metadata-corruption cases,
    and the value sweep's NaN and negative scales on a mapped page)."""
    pair = managers(kv_dtype="int8")
    both(pair, lambda m: m.admit(0, 6))
    mapped = pair[0].owned[0][0]
    port, refp = _pools(np.random.default_rng(12))
    verdicts = {}
    for name, p, r in _pool_cases(port, refp, mapped):
        for values in (False, True):
            got = audit.audit_pool(pair[0], p, check_values=values)
            want = jaudit.audit_pool(pair[1], r, check_values=values)
            assert _report(got) == _report(want), (name, values)
            verdicts[name, values] = got.ok
    assert verdicts["consistent", False] and verdicts["consistent", True]
    for name in ("bare", "scale shape", "scale dtype", "value dtype"):
        assert not verdicts[name, False]
    for name in ("nan scale", "negative scale"):
        assert verdicts[name, False] and not verdicts[name, True]


def test_audit_pool_quantization_disagreement():
    """A quantized pool under a float manager, and a float pool under an
    int8 one, fail the structural check as in the reference."""
    port, refp = _pools(np.random.default_rng(14))
    for kv_dtype, pick in ((None, lambda p: p),
                           ("int8", lambda p: {n: p[n] for n in ("k_pages", "v_pages")})):
        pair = managers(kv_dtype=kv_dtype)
        got = audit.audit_pool(pair[0], pick(port))
        want = jaudit.audit_pool(pair[1], pick(refp))
        assert not got.ok and _report(got) == _report(want)


# -------------------------------------------------------------- poison_pages
def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_poison_pages_bytes_equal_reference(kind):
    """NaN in float leaves (the reference's NaN bits, bf16's too), 0 in
    int8 values, NaN in their f32 scales; other pages untouched; the
    leaves are written in place, never rebound."""
    rng = np.random.default_rng(5)
    kv = rng.normal(size=(2, 2, 7, 4, 2, 8)).astype(np.float32)
    if kind == "int8":
        port, refp = {}, {}
        for i, name in enumerate("kv"):
            port[f"{name}_pages"], port[f"{name}_scales"] = kv_cache.quantize_kv_rows(
                torch.from_numpy(kv[i]))
            refp[f"{name}_pages"], refp[f"{name}_scales"] = jkv.quantize_kv_rows(
                jnp.asarray(kv[i]))
    else:
        tdt, jdt = ((torch.float32, jnp.float32) if kind == "f32"
                    else (torch.bfloat16, jnp.bfloat16))
        port = {f"{n}_pages": torch.from_numpy(kv[i]).to(tdt) for i, n in enumerate("kv")}
        refp = {f"{n}_pages": jnp.asarray(kv[i]).astype(jdt) for i, n in enumerate("kv")}
    before = {n: t.clone() for n, t in port.items()}
    ptrs = {n: t.data_ptr() for n, t in port.items()}
    out = faults.poison_pages(port, [2, 5])
    want = jfaults.poison_pages(refp, jnp.asarray([2, 5], jnp.int32))
    assert out is port and {n: t.data_ptr() for n, t in port.items()} == ptrs
    for name, leaf in port.items():
        got = leaf.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[leaf.element_size()])
        assert np.array_equal(got.numpy(), _bits(want[name])), name
        assert torch.equal(leaf[:, [0, 1, 3, 4, 6]], before[name][:, [0, 1, 3, 4, 6]])
        if leaf.dtype == torch.int8:
            assert not leaf[:, [2, 5]].any()
        else:
            assert torch.isnan(leaf[:, [2, 5]]).all()


# --------------------------------------------------------- the engine's audit
@PIPELINES
def test_engine_audit_flag_catches_corruption(monkeypatch, pipeline):
    """``audit=True`` sweeps every round: a clean run passes and serves the
    reference's tokens; a release that drops its bookkeeping but keeps the
    references is caught at the round that caused it, as ``AuditError``
    (never recovered)."""
    spec = reqs(3, mlo=4, mhi=7)
    eng = port_engine(pipeline, audit=True)
    out = eng.serve([Request(**r) for r in copy.deepcopy(spec)])
    assert out == ref(spec, audit=True)["tokens"]
    assert all(eng.last_stats[r["uid"]]["status"] == STATUS_OK for r in spec)
    real_release = kv_cache.PagedCacheManager.release

    def leaky_release(self, slot):
        if self.owned[slot]:
            self.owned[slot] = []
            self.tables[slot, :] = 0
            self.dirty = True
            return
        return real_release(self, slot)

    monkeypatch.setattr(kv_cache.PagedCacheManager, "release", leaky_release)
    with pytest.raises(audit.AuditError):
        eng.serve([Request(**r) for r in copy.deepcopy(spec)])
    assert eng.recoveries == 0


@pytest.mark.parametrize("layout", ["paged", "shared", "int8"])
def test_empty_session_pool_audits_clean(layout):
    """serve([]): the pool stats carry a clean audit (the ``audit_ok``
    half of the reference's empty-session case)."""
    kw = {"shared": dict(prefix_sharing=True), "int8": dict(kv_dtype="int8")}.get(layout, {})
    eng = port_engine(**kw)
    assert eng.serve([]) == {}
    p = eng.last_pool_stats
    assert p.audit_ok and p.audit_errors == [] and p.used_pages == 0
    assert eng.last_stats["stragglers"] == []


@PIPELINES
def test_engine_eviction_policies_audit_clean(pipeline):
    """The eviction-policy engine case under ``audit=True``: every policy
    serves the reference's tokens (its lru run, audited), and every
    round's sweep and the final pool are clean."""
    vocab = reduced_config(ARCH).vocab
    rng = np.random.default_rng(11)
    prefixes = [rng.integers(0, vocab, 16).tolist() for _ in range(3)]
    spec = [dict(uid=i, prompt=prefixes[i % 3] + rng.integers(0, vocab, 3 + i).tolist(),
                 max_new_tokens=4) for i in range(6)]
    kw = dict(num_pages=9, prefix_sharing=True, min_cached_tokens=8)
    want = ref(spec, audit=True, **kw)
    assert want["audit_ok"]
    for policy in EVICT_POLICIES:
        eng = port_engine(pipeline, evict_policy=policy, audit=True, **kw)
        assert eng.serve([Request(**r) for r in copy.deepcopy(spec)]) == want["tokens"]
        p = eng.last_pool_stats
        assert p.audit_ok and p.evictions >= 1 and p.used_pages == p.index_pages
