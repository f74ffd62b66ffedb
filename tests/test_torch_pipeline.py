"""The port's overlapped round pipeline (``ServeEngine(pipeline=True)``):
the greedy cases of ``test_pipeline_overlap.py`` replayed on the port.

Both ``pipeline`` settings must give the reference engine's greedy tokens
(plain, preemption under requeue and swap, deferred swap copies,
spec_k=4, an int8 pool, prefix sharing), the pipelined session runs one
more round than the serial one, the phase columns line up, and every
buffer a captured step reads keeps its storage across rounds and
sessions.  Reduced qwen2-1.5b in fp32 on the CPU, at the reference
test's engine settings (max_seq 48, 2 slots, 8-token pages)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import SwapHandle, swap_in_pages  # noqa: E402
from repro_torch.testing import params_from_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The port's reduced models run many small torch ops; on a loaded CPU
    (the suite's parallel workers) intra-op threads wait at every op's
    barrier, so the module runs on one thread and restores the count
    after (as ``test_torch_sampling.py`` does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


try:
    from hypothesis import given, settings
    from hypothesis import strategies as hyp_st
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

ARCH = "qwen2-1.5b"
# the reference test's _EKW, less temperature and seed (greedy only)
_EKW = dict(max_seq=48, batch_slots=2, cache_layout="paged", page_size=8)
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


def _reqs(n, seed=3, plo=3, phi=12, mlo=2, mhi=7, prefix=()):
    """(uid, prompt, max_new_tokens) triples, as the reference test's
    ``_reqs``; ``prefix`` leads every prompt (prefix sharing)."""
    vocab = reduced_config(ARCH).vocab
    rng = np.random.default_rng(seed)
    return [(i, list(prefix) + rng.integers(0, vocab, int(rng.integers(plo, phi))).tolist(),
             int(rng.integers(mlo, mhi))) for i in range(n)]


def _jax_serve(spec, **kw):
    """The reference engine's greedy tokens and preemptions (cached)."""
    m = _models()
    key = (tuple((u, tuple(p), n) for u, p, n in spec), tuple(sorted(kw.items())))
    if key not in _CACHE:
        eng = JaxServeEngine(m["jm"], m["jp"], temperature=0.0, seed=0,
                             **{**_EKW, **kw})
        out = eng.serve([JaxRequest(u, list(p), n) for u, p, n in spec])
        _CACHE[key] = (out, sum(eng.last_stats[u]["preemptions"] for u, _, _ in spec))
    return _CACHE[key]


def _port(spec, pipeline, **kw):
    m = _models()
    eng = ServeEngine(m["tm"], m["tp"], pipeline=pipeline, **{**_EKW, **kw})
    return eng.serve([Request(u, list(p), n) for u, p, n in spec]), eng


def _both(spec, **kw):
    return {p: _port(spec, p, **kw) for p in (False, True)}


PREFIX = list(range(100, 116))      # two full 8-token pages
CASES = {
    "plain": (dict(n=6), {}),
    "requeue": (dict(n=6, mlo=6, mhi=12), dict(num_pages=4, preempt="requeue")),
    "swap": (dict(n=6, mlo=6, mhi=12), dict(num_pages=4, preempt="swap")),
    "spec4": (dict(n=5, mlo=4, mhi=9), dict(spec_k=4)),
    "int8": (dict(n=6, mlo=6, mhi=12), dict(num_pages=4, kv_dtype="int8",
                                           preempt="swap")),
    "prefix": (dict(n=5, prefix=PREFIX, plo=1, phi=9), dict(prefix_sharing=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_parity_with_reference(case):
    """Both pipeline settings serve the reference engine's greedy tokens
    (its pipelined default) with its preemption count."""
    rkw, kw = CASES[case]
    spec = _reqs(**rkw)
    # greedy speculation commits the non-speculative tokens: the
    # reference's spec engine is held to those in its own tests
    ref_kw = {k: v for k, v in kw.items() if k != "spec_k"}
    want, want_pre = _jax_serve(spec, **ref_kw)
    for pipeline, (got, eng) in _both(spec, **kw).items():
        assert got == want, f"pipeline={pipeline}"
        pre = sum(eng.last_stats[u]["preemptions"] for u, _, _ in spec)
        if "num_pages" in kw:
            assert pre == want_pre > 0
        p = eng.last_pool_stats
        assert p.used_pages - p.index_pages == 0
        if case == "spec4":
            assert sum(eng.last_stats[u].get("spec_tokens", 0) for u, _, _ in spec) > 0
        if case == "prefix":
            assert p.cached_prefix_tokens > 0


def test_trailing_round_and_phase_columns():
    """The pipelined session runs exactly one more round (the trailing
    commit); the phase columns have one entry a round, and the serial
    run never overlaps."""
    runs = _both(_reqs(5))
    ts = {p: eng.last_stats["timeseries"] for p, (_, eng) in runs.items()}
    assert ts[True]["round"][-1] == ts[False]["round"][-1] + 1
    for t in ts.values():
        n = len(t["round"])
        assert t["round"] == list(range(n))
        assert len(t["dispatch_s"]) == len(t["commit_s"]) == len(t["overlap_s"]) == n
    assert all(v == 0.0 for v in ts[False]["overlap_s"])
    assert any(v > 0.0 for v in ts[True]["dispatch_s"])
    assert runs[True][1].last_graph_stats["enabled"] is False     # CPU: uncaptured


def test_deferred_swap_materialization():
    """Pipelined swap-outs are queued at preemption and materialized at
    the next commit boundary, before any swap-in restores them; no handle
    is left pending at session end, and the tokens are the serial run's."""
    spec = _reqs(6, mlo=6, mhi=12)
    m = _models()
    eng = ServeEngine(m["tm"], m["tp"], pipeline=True, num_pages=4, preempt="swap",
                      **_EKW)
    seen, states, deferred = [], [], []
    preempt, swapped_in = eng._preempt, eng._admit_swapped_row

    def tap_preempt(st, slot):
        preempt(st, slot)
        states.append(st)
        deferred.append(len(st.pending_swaps))
        seen.extend(h for h in st.swaps.values() if all(h is not x for x in seen))

    def tap_swap_in(st, slot, req):
        handle = st.swaps[req.uid]
        assert all(handle is not x for x in st.pending_swaps)
        assert handle.materialized
        return swapped_in(st, slot, req)

    eng._preempt, eng._admit_swapped_row = tap_preempt, tap_swap_in
    got = eng.serve([Request(u, list(p), n) for u, p, n in spec])
    want, _ = _port(spec, False, num_pages=4, preempt="swap")
    assert got == want
    assert sum(eng.last_stats[u].get("swap_ins", 0) for u, _, _ in spec) > 0
    assert seen and max(deferred) > 0
    assert all(h.materialized for h in seen)
    assert not states[-1].pending_swaps and states[-1].pending is None


def test_swap_in_refuses_unmaterialized_handle():
    """A handle whose queued copy was not waited for raises at restore;
    once materialized it restores."""

    class Copy:
        """An in-flight copy's event stand-in."""
        waited = False

        def synchronize(self):
            Copy.waited = True

    pool = {"k_pages": torch.zeros(1, 4, 2, 1, 2), "v_pages": torch.zeros(1, 4, 2, 1, 2)}
    data = {n: torch.ones(1, 1, 2, 1, 2) for n in pool}
    handle = SwapHandle(n_blocks=1, n_tokens=2, data=data, pending=({}, Copy()))
    assert not handle.materialized
    with pytest.raises(RuntimeError, match="materialized"):
        swap_in_pages(pool, handle, [2])
    assert not Copy.waited and pool["k_pages"].sum() == 0
    assert handle.materialize() is handle and handle.materialized and Copy.waited
    assert handle.materialize() is handle          # idempotent
    swap_in_pages(pool, handle, [2])
    assert pool["k_pages"][:, 2].sum() == 4


@pytest.mark.parametrize("kw", [
    dict(cache_layout="dense"),
    dict(num_pages=4, preempt="swap", kv_dtype="int8", spec_k=2),
], ids=["dense", "int8-spec-swap"])
def test_captured_inputs_keep_their_storage(kw):
    """Every buffer a captured step reads (tok, pos, remaining, the
    block-table buffer, each cache or pool leaf, the draft cache and the
    output) keeps its ``data_ptr()`` across all rounds and across two
    sessions on one engine: a rebound input would leave a graph reading
    the old storage."""
    m = _models()
    eng = ServeEngine(m["tm"], m["tp"], pipeline=True, **{**_EKW, **kw})
    ptrs = []
    dispatch = eng._timed_dispatch

    def tap(st):
        leaves = dict(tok=st.tok, pos=st.pos, remaining=st.remaining,
                      out=eng._dev["out"], bt=st.bt_dev)
        for name in ("cache", "pool", "draft_cache"):
            leaves.update({f"{name}.{k}": v for k, v in (getattr(st, name) or {}).items()})
        ptrs.append({k: v.data_ptr() for k, v in leaves.items() if v is not None})
        return dispatch(st)

    eng._timed_dispatch = tap
    spec = _reqs(6, mlo=6, mhi=12)
    first = eng.serve([Request(u, list(p), n) for u, p, n in spec])
    n_first = len(ptrs)
    second = eng.serve([Request(u, list(p), n) for u, p, n in spec])
    assert second == first
    assert n_first > 1 and len(ptrs) > n_first
    assert all(p == ptrs[0] for p in ptrs)
    if kw.get("kv_dtype"):
        assert {"pool.k_scales", "draft_cache.k", "bt"} <= set(ptrs[0])


if _HAVE_HYPOTHESIS:

    @settings(max_examples=8, deadline=None)
    @given(seed=hyp_st.integers(0, 2**16), n=hyp_st.integers(2, 6),
           pages=hyp_st.sampled_from([4, 6, 12]))
    def test_property_pipeline_toggle_is_invisible(seed, n, pages):
        """Random schedules (prompt and output lengths, pool pressure)
        serve the same greedy tokens and preemptions with the pipeline
        toggled."""
        spec = _reqs(n, seed=seed, mlo=2, mhi=10)
        runs = _both(spec, num_pages=pages)
        (ref, r_eng), (out, p_eng) = runs[False], runs[True]
        assert out == ref
        assert r_eng.preemptions == p_eng.preemptions


def test_fresh_session_after_pipelined_session():
    """A second session on one engine zero-fills the device state and
    serves what a fresh engine serves."""
    spec_a, spec_b = _reqs(4, seed=5), _reqs(5, seed=9)
    m = _models()
    eng = ServeEngine(m["tm"], m["tp"], pipeline=True, **_EKW)
    eng.serve([Request(u, list(p), n) for u, p, n in spec_a])
    got = eng.serve([Request(u, list(p), n) for u, p, n in spec_b])
    want, _ = _port(spec_b, True)
    assert got == want
