"""The port's fault tolerance (``serve.faults`` and the engine's recovery,
degrade, quarantine and watchdog): the cases of ``test_faults.py``,
``test_pipeline_overlap.py`` and ``test_tiered_kv.py`` that inject faults,
replayed on the port.

Each case serves the same trace under the same ``FaultSchedule`` on the
reference engine and on the port (both ``pipeline`` settings where the
reference case runs its default) and holds the port to the reference's
tokens, terminal statuses, retries, preemptions, reasons (up to the
first colon), recoveries, and the audit-clean, drained pool.  Reduced
qwen2-1.5b in fp32 on the CPU, at the reference tests' engine settings
(max_seq 48, 2 slots, 8-token pages).  The reference engines are cached
at module level by the arguments their compiled steps depend on, and
serve every case of those arguments (the recovery budget, the watchdog's
settings and the audit flag are set a call), as the reference tests
share theirs.  A degraded reference engine stays shared: on the CPU both
of its lowerings are the plain ``jnp`` path.  On the CPU the port's
degrade also computes the same plain versions, so the cases check its
flags (``backend_degraded``, ``model.use_kernels``, ``verify_backend``),
not a change of path.

One deviation is allowed, and pinned (:func:`assert_reference`): after a
``page_corruption`` the poisoned page returns to the free list still
holding NaN, and the reference's plain decode and verify on the CPU
multiply the masked rows' V by their zero probability, so 0 x NaN fails
the page's next owner when it reads rows past its position.  The port's
plain versions and kernels select those rows away, so that owner
finishes with the fault-free tokens.  The random schedules, the overlap
cases and a direct check of the stale rows are in
``test_torch_fault_sweeps.py``, which imports the helpers here."""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.serve import faults as jax_faults  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.serve import faults  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    STATUS_FAILED,
    STATUS_OK,
    STATUS_TIMEOUT,
    TERMINAL_STATUSES,
    Request,
    ServeEngine,
)
from repro_torch.serve.faults import (  # noqa: E402
    FAULT_KINDS,
    Fault,
    FaultSchedule,
    InjectedFault,
    KernelBackendError,
)
from repro_torch.testing import params_from_numpy  # noqa: E402
from test_torch_scheduling import (  # noqa: E402
    ARCH,
    EKW,
    PIPELINES,
    _freeze,
    models,
    one_intra_op_thread,
    reqs,
)

_REF = {}        # (spec, faults, seed, kw) -> the reference's figures
_ENGINES = {}    # compile arguments -> a shared reference engine
# engine arguments the reference reads a round, not when compiling: set on
# a shared engine before each call (the constructor's defaults otherwise)
RUNTIME = dict(max_recoveries=2, straggler_factor=3.0, straggler_window=20,
               audit=False)


def grow_reqs(n, max_new=8, **fields):
    """The reference tests' ``_grow_reqs``: 6-token prompts on 8-token
    pages, so the first growth allocation lands at round 2."""
    vocab = reduced_config(ARCH).vocab
    return [dict(uid=i, prompt=[(i * 7 + j) % vocab for j in range(6)],
                 max_new_tokens=max_new, **fields) for i in range(n)]


def _reason(s):
    r = s.get("reason")
    return None if r is None else r.split(":")[0]


def figures(eng, spec, out, recoveries0, exc=None) -> dict:
    """What a case compares: tokens, each request's (status, retries,
    preemptions, reason up to its first colon), the session's recoveries,
    the exception that escaped (its type's name), and the pool's audit
    verdict and pages left in use."""
    st = eng.last_stats
    p = eng.last_pool_stats
    return dict(
        tokens=out,
        ledger={r["uid"]: (st[r["uid"]]["status"], st[r["uid"]]["retries"],
                           st[r["uid"]]["preemptions"], _reason(st[r["uid"]]))
                for r in spec},
        recoveries=eng.recoveries - recoveries0,
        exc=None if exc is None else type(exc).__name__,
        audit_ok=None if p is None else p.audit_ok,
        used_pages=None if p is None else p.used_pages - p.index_pages,
        auto_disables={r["uid"]: st[r["uid"]].get("spec_auto_disables", 0) for r in spec})


def _serve(eng, make_req, make_fs, spec, fault_args, seed, cancel=()):
    for uid in cancel:
        eng.cancel(uid)
    fs = make_fs([f for f in fault_args], seed) if fault_args else None
    r0, exc, out = eng.recoveries, None, None
    try:
        out = eng.serve([make_req(**r) for r in copy.deepcopy(spec)], faults=fs)
    except InjectedFault as e:
        exc = e
    except jax_faults.InjectedFault as e:
        exc = e
    return figures(eng, spec, out, r0, exc)


def ref(spec, fault_args=(), seed=0, cancel=(), params=None, **kw):
    """The reference engine's figures for ``spec`` under the faults
    (``Fault`` keyword dicts), cached; the engine is shared by the
    compile arguments in ``kw`` (and ``params``)."""
    key = (_freeze(spec), _freeze(list(fault_args)), seed, tuple(cancel),
           _freeze(kw), None if params is None else id(params))
    if key not in _REF:
        m = models()
        p = m["jp"] if params is None else params
        compile_kw = {k: v for k, v in kw.items() if k not in RUNTIME}
        ek = (_freeze(compile_kw), id(p))
        if ek not in _ENGINES:
            _ENGINES[ek] = JaxServeEngine(m["jm"], p, **{"temperature": 0.0, "seed": 0,
                                                         **EKW, **compile_kw})
        eng = _ENGINES[ek]
        for k, default in RUNTIME.items():
            setattr(eng, k, kw.get(k, default))
        _REF[key] = _serve(
            eng, JaxRequest,
            lambda fa, s: jax_faults.FaultSchedule([jax_faults.Fault(**f) for f in fa],
                                                   seed=s),
            spec, fault_args, seed, cancel)
    return _REF[key]


def port_engine(pipeline=True, params=None, **kw):
    m = models()
    return ServeEngine(m["tm"], m["tp"] if params is None else params,
                       pipeline=pipeline, **{**EKW, **kw})


def port(eng, spec, fault_args=(), seed=0, cancel=()):
    return _serve(eng, Request,
                  lambda fa, s: FaultSchedule([Fault(**f) for f in fa], seed=s),
                  spec, fault_args, seed, cancel)


def _nan_failed(fig) -> set:
    return {u for u, v in fig["ledger"].items()
            if v[0] == STATUS_FAILED and v[3] == "nan-logits"}


def assert_reference(got, want, base, fault_args):
    """The port's figures are the reference's, or differ only by the
    reference's stale-NaN leak: with a ``page_corruption`` in the schedule,
    some requests the reference failed on NaN logits finish ok in the port
    with the fault-free tokens; every other request ends as in the
    reference, and the session's recoveries, escape and pool are the
    reference's.  (Those survivors hold their slots longer, so the others'
    retries and preemptions may move; their tokens cannot.)"""
    if got == want:
        return
    assert any(f["kind"] == "page_corruption" for f in fault_args), (got, want)
    for key in ("exc", "recoveries", "audit_ok", "used_pages"):
        assert got[key] == want[key], (key, got, want)
    spared = _nan_failed(want) - _nan_failed(got)
    assert spared and _nan_failed(got) < _nan_failed(want), (got, want)
    for u, v in got["ledger"].items():
        if u in spared:
            assert v[0] == STATUS_OK and got["tokens"][u] == base[u], (u, got, want)
        else:
            assert v[0] == want["ledger"][u][0], (u, got, want)
    assert_survivors(got, base)


def check(spec, fault_args, pipeline, seed=0, cancel=(), base=True, **kw) -> tuple:
    """Serve ``spec`` fault-free (``base``) and then under the faults on one
    port engine, against the reference's two runs; returns (port figures,
    reference figures, the port engine, the fault-free tokens)."""
    want_base = ref(spec, **kw)["tokens"] if base else None
    want = ref(spec, fault_args, seed, cancel, **kw)
    eng = port_engine(pipeline, **kw)
    if base:
        assert port(eng, spec)["tokens"] == want_base
    got = port(eng, spec, fault_args, seed, cancel)
    if base:
        assert_reference(got, want, want_base, fault_args)
    else:
        assert got == want, (got, want)
    assert got["audit_ok"] is not False
    if eng.last_pool_stats is not None:
        assert got["used_pages"] == 0
    return got, want, eng, want_base


def assert_survivors(got, base):
    """Every request that finished ok has the fault-free run's tokens."""
    assert got["tokens"] is not None
    for u, toks in got["tokens"].items():
        assert got["ledger"][u][0] == STATUS_OK and toks == base[u]


# ---------------------------------------------------- the schedule (host only)
def test_fault_kinds_and_validation():
    assert FAULT_KINDS == jax_faults.FAULT_KINDS
    with pytest.raises(ValueError):
        Fault("not-a-kind", step=0)
    with pytest.raises(ValueError):
        Fault("nan", step=-1)
    with pytest.raises(ValueError):
        Fault("nan", step=0, span=0)
    f = Fault("nan", step=3, span=2)
    assert [f.active_at(r) for r in range(2, 6)] == [False, True, True, False]
    assert issubclass(KernelBackendError, InjectedFault)
    assert InjectedFault("x", fatal=True).fatal and not InjectedFault("x").fatal


def _flat(fs):
    return [dataclasses.astuple(f) for f in fs.faults]


@pytest.mark.parametrize("seed", [0, 7, 8, 123, 9999])
def test_random_schedule_equals_reference(seed):
    """``FaultSchedule.random`` draws the reference's faults from the same
    seed, for every kind set; it is deterministic and seeds differ."""
    kw = dict(uids=(0, 1, 2), max_step=16)
    a = FaultSchedule.random(seed, **kw)
    assert _flat(a) == _flat(jax_faults.FaultSchedule.random(seed, **kw))
    assert _flat(a) == _flat(FaultSchedule.random(seed, **kw))
    assert _flat(FaultSchedule.random(seed + 1, **kw)) != _flat(a)
    kinds = ("nan", "oom", "kernel")
    assert (_flat(FaultSchedule.random(seed, n_faults=8, kinds=kinds))
            == _flat(jax_faults.FaultSchedule.random(seed, n_faults=8, kinds=kinds)))


@pytest.mark.parametrize("worker", [0, 3, "w1", "prefill-0"])
def test_worker_seeds_equal_reference(worker):
    assert faults.fold_worker_seed(5, worker) == jax_faults.fold_worker_seed(5, worker)
    a = FaultSchedule.random_for_worker(5, worker, uids=(0, 1))
    assert _flat(a) == _flat(jax_faults.FaultSchedule.random_for_worker(5, worker,
                                                                        uids=(0, 1)))
    scoped = FaultSchedule([Fault("page_corruption", step=1)], seed=5).scoped(worker)
    assert scoped.seed == faults.fold_worker_seed(5, worker)
    assert _flat(scoped) == [dataclasses.astuple(Fault("page_corruption", step=1))]


def test_queries_equal_reference():
    """Every query of one mixed schedule, round by round, against the
    reference's."""
    args = [dict(kind="oom", step=1, span=3), dict(kind="oom", step=2, raise_exc=True),
            dict(kind="nan", step=0, uid=1, span=2), dict(kind="nan", step=1),
            dict(kind="straggler", step=2, span=2, sleep_s=0.3),
            dict(kind="spec_collapse", step=3, uid=0, span=4),
            dict(kind="cancel", step=4, uid=2), dict(kind="cancel", step=4),
            dict(kind="deadline", step=5, uid=1), dict(kind="kernel", step=6, fatal=True),
            dict(kind="page_corruption", step=2, page=3)]
    a = FaultSchedule([Fault(**f) for f in args], seed=4)
    b = jax_faults.FaultSchedule([jax_faults.Fault(**f) for f in args], seed=4)
    assert len(a) == len(b) and "seed=4" in repr(a)
    for rnd in range(9):
        assert a.oom_denied(rnd) == b.oom_denied(rnd)
        assert ((a.oom_raise(rnd) is None) == (b.oom_raise(rnd) is None))
        assert ((a.kernel_at(rnd) is None) == (b.kernel_at(rnd) is None))
        assert a.straggler_sleep(rnd) == b.straggler_sleep(rnd)
        assert a.nan_uids(rnd) == b.nan_uids(rnd)
        assert a.collapse_uids(rnd) == b.collapse_uids(rnd)
        assert a.cancels_at(rnd) == b.cancels_at(rnd)
        assert a.deadline_expiries_at(rnd) == b.deadline_expiries_at(rnd)
        assert len(a.corruptions_at(rnd)) == len(b.corruptions_at(rnd))


@pytest.mark.parametrize("seed", [4, 11, 9])
def test_corruption_target_seeded(seed):
    """The seeded pick is the reference's, whatever the mapped pages'
    order; nothing mapped gives None; an explicit page wins."""
    fs = FaultSchedule([Fault("page_corruption", step=1)], seed=seed)
    ref_fs = jax_faults.FaultSchedule([jax_faults.Fault("page_corruption", step=1)],
                                      seed=seed)
    f, rf = fs.faults[0], ref_fs.faults[0]
    for rnd in range(4):
        pick = fs.corruption_target(f, rnd, [5, 9, 2, 14])
        assert pick == fs.corruption_target(f, rnd, [14, 9, 2, 5])
        assert pick == ref_fs.corruption_target(rf, rnd, [5, 9, 2, 14])
        assert pick in (2, 5, 9, 14)
    assert fs.corruption_target(f, 1, []) is None
    assert fs.corruption_target(Fault("page_corruption", step=1, page=7), 1, [1, 2]) == 7


# ------------------------------------------------- quarantine and lifecycle faults
@PIPELINES
def test_forced_deadline_timeout(pipeline):
    spec = reqs(4, mlo=6, mhi=10)
    got, _, eng, base = check(spec, [dict(kind="deadline", step=3, uid=1)], pipeline)
    assert got["ledger"][1][0] == STATUS_TIMEOUT
    assert eng.last_stats[1]["reason"] == "deadline"
    assert_survivors(got, base)


@PIPELINES
def test_cancel_fault_queued_and_live(pipeline):
    """uid 5 cancel()ed before serve() (queued), uid 0 by a cancel fault
    at round 2 (live); the cancel set is consumed."""
    spec = reqs(6, mlo=6, mhi=10)
    got, _, eng, base = check(spec, [dict(kind="cancel", step=2, uid=0)], pipeline,
                              cancel=(5,))
    assert got["ledger"][0][0] == got["ledger"][5][0] == "cancelled"
    assert 0 not in got["tokens"] and 5 not in got["tokens"]
    assert_survivors(got, base)
    assert not eng._cancel_uids


def test_duplicate_uid_rejected():
    with pytest.raises(ValueError, match="duplicate"):
        port_engine().serve([Request(uid=1, prompt=[1, 2], max_new_tokens=2),
                             Request(uid=1, prompt=[3, 4], max_new_tokens=2)])


@PIPELINES
def test_nan_quarantines_only_target(pipeline):
    spec = reqs(6, mlo=6, mhi=10)
    got, _, eng, base = check(spec, [dict(kind="nan", step=1, uid=0, span=2)], pipeline)
    assert got["ledger"][0][0] == STATUS_FAILED
    assert eng.last_stats[0]["reason"] == "nan-logits"
    assert all(v[0] == STATUS_OK for u, v in got["ledger"].items() if u != 0)
    assert_survivors(got, base)
    # the masks are written only in the targeted rounds, zero after them
    assert not eng._dev["masks"].any()


@PIPELINES
def test_nan_untargeted_fails_all_live(pipeline):
    spec = reqs(4, mlo=6, mhi=10)
    got, _, _, _ = check(spec, [dict(kind="nan", step=0, span=64)], pipeline, base=False)
    assert not got["tokens"]
    assert all(v[0] == STATUS_FAILED for v in got["ledger"].values())


@PIPELINES
def test_page_corruption_surfaces_as_quarantine(pipeline):
    spec = reqs(4, mlo=6, mhi=10)
    got, _, _, base = check(spec, [dict(kind="page_corruption", step=2)], pipeline,
                            seed=11)
    assert STATUS_FAILED in {v[0] for v in got["ledger"].values()}
    assert_survivors(got, base)


# ---------------------------------------------------------- exception safety
@PIPELINES
@pytest.mark.parametrize("kind", ["oom", "kernel"])
def test_fatal_fault_aborts_audit_clean(kind, pipeline):
    """A fatal hard OOM (round 2, growth) or kernel fault (round 1)
    escapes serve() (``InjectedFault``, ``KernelBackendError`` for the
    kernel, as the reference's); everything is terminal, some
    request failed, the pool drained and audits clean, and the very next
    serve() on the engine is the fault-free run."""
    spec = grow_reqs(4) if kind == "oom" else reqs(4, mlo=6, mhi=10)
    f = (dict(kind="oom", step=2, raise_exc=True, fatal=True) if kind == "oom"
         else dict(kind="kernel", step=1, fatal=True))
    got, _, eng, base = check(spec, [f], pipeline)
    assert got["exc"] == ("InjectedFault" if kind == "oom" else "KernelBackendError")
    assert got["recoveries"] == 0
    assert all(v[0] in TERMINAL_STATUSES for v in got["ledger"].values())
    assert STATUS_FAILED in {v[0] for v in got["ledger"].values()}
    assert got["ledger"][0][3] == "aborted"
    assert not eng.backend_degraded
    assert eng.serve([Request(**r) for r in copy.deepcopy(spec)]) == base


@PIPELINES
def test_real_exception_escapes_without_recovery(pipeline, monkeypatch):
    """An exception that is not an injected fault (a RuntimeError from the
    paged decode wrapper mid-decode, as a kernel that fails to build or
    launch raises) is never recovered from and never degrades the engine:
    it escapes serve() with no recovery, the model still on the kernel
    lowering, every request failed as aborted and the pool drained
    audit-clean; with the wrapper repaired the next serve() is the
    fault-free run."""
    from repro_torch.models import attention

    spec = reqs(4, mlo=6, mhi=10)
    base = ref(spec)["tokens"]
    eng = port_engine(pipeline)
    real, calls = attention.paged_flash_decode, []

    def broken(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("paged_flash_decode: launch failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(attention, "paged_flash_decode", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.serve([Request(**r) for r in copy.deepcopy(spec)])
    assert eng.recoveries == 0 and not eng.backend_degraded
    assert eng.model.use_kernels and eng.verify_backend != "torch"
    st = eng.last_stats
    assert {st[r["uid"]]["status"] for r in spec} == {STATUS_FAILED}
    assert all(st[r["uid"]]["reason"].startswith("aborted: RuntimeError")
               for r in spec)
    assert eng.last_pool_stats.audit_ok and eng.last_pool_stats.used_pages == 0
    monkeypatch.setattr(attention, "paged_flash_decode", real)
    assert eng.serve([Request(**r) for r in copy.deepcopy(spec)]) == base


# ----------------------------------------------------------------- recovery
@PIPELINES
def test_hard_oom_recovers_bit_identical(pipeline):
    spec = grow_reqs(5)
    got, _, eng, base = check(spec, [dict(kind="oom", step=2, raise_exc=True)], pipeline)
    assert got["recoveries"] == 1 and eng.recoveries == 1
    assert got["tokens"] == base
    assert all(v[0] == STATUS_OK for v in got["ledger"].values())
    assert sum(v[1] for v in got["ledger"].values()) >= 1
    assert not eng.backend_degraded        # an injected OOM restarts on the kernels
    # the recovery's record: its round, and each requeued request's next token
    (entry,) = eng.last_stats["recovery_log"]
    assert entry["round"] == 2 and entry["exc"] == "InjectedFault"
    assert not entry["degraded"]
    assert set(entry["requeued"]) == {u for u, v in got["ledger"].items() if v[1]}
    assert set(entry["next_token_s"]) == set(entry["requeued"])
    assert all(t >= entry["t_s"] for t in entry["next_token_s"].values())


@PIPELINES
def test_retry_budget_exhausts_to_failed(pipeline):
    spec = grow_reqs(3, max_retries=0)
    got, _, eng, _ = check(spec, [dict(kind="oom", step=2, raise_exc=True)], pipeline,
                           base=False, max_recoveries=4)
    assert got["ledger"][0][0] == got["ledger"][1][0] == STATUS_FAILED
    assert got["ledger"][2][0] == STATUS_OK and 2 in got["tokens"]
    assert "retries exhausted" in eng.last_stats[0]["reason"]


@PIPELINES
def test_max_recoveries_cap_propagates(pipeline):
    """Round 2's hard OOM is recovery 1; round 3's re-admission raises
    again, over the cap of 1, and escapes."""
    spec = grow_reqs(3)
    got, _, eng, _ = check(spec, [dict(kind="oom", step=2, raise_exc=True),
                                  dict(kind="oom", step=3, raise_exc=True)], pipeline,
                           base=False, max_recoveries=1)
    assert got["exc"] == "InjectedFault" and eng.recoveries == 1


@PIPELINES
def test_double_recovery_no_double_fold(pipeline):
    """Back-to-back kernel faults requeue already resumed requests: the
    second fold takes only the tokens since the first."""
    spec = reqs(4, seed=4, plo=4, phi=10, mlo=8, mhi=9)
    got, _, eng, base = check(spec, [dict(kind="kernel", step=12),
                                     dict(kind="kernel", step=13, span=3)], pipeline,
                              max_seq=64, max_recoveries=8)
    assert got["recoveries"] >= 2
    assert got["tokens"] == base
    assert all(v[0] == STATUS_OK for v in got["ledger"].values())


@PIPELINES
def test_kernel_fault_degrades_to_sw(pipeline):
    spec = reqs(5, mlo=6, mhi=10)
    eng = port_engine(pipeline)
    base = ref(spec)["tokens"]
    assert port(eng, spec)["tokens"] == base
    assert not eng.backend_degraded and eng.model.use_kernels
    want = ref(spec, [dict(kind="kernel", step=2)])
    got = port(eng, spec, [dict(kind="kernel", step=2)])
    assert got == want
    assert eng.backend_degraded and not eng.model.use_kernels
    assert eng.verify_backend == "torch"
    assert [e["degraded"] for e in eng.last_stats["recovery_log"]] == [True]
    assert got["tokens"] == base
    assert all(v[0] == STATUS_OK for v in got["ledger"].values())
    assert got["audit_ok"] and got["used_pages"] == 0
    # on the CPU no step is captured; the degrade drops what there is
    assert eng.last_graph_stats["dropped"] == 0 and not eng._graphs.graphs
    # a second kernel fault restarts on the plain lowering, no new degrade
    model = eng.model
    assert port(eng, spec, [dict(kind="kernel", step=3)])["tokens"] == base
    assert eng.model is model and eng.recoveries == 2


@PIPELINES
def test_soft_oom_blocks_then_drains(pipeline):
    spec = reqs(5, mlo=6, mhi=10)
    got, _, _, base = check(spec, [dict(kind="oom", step=0, span=3)], pipeline)
    assert got["tokens"] == base and got["recoveries"] == 0


@PIPELINES
def test_mid_flight_soft_oom_preempts_and_resumes(pipeline):
    spec = grow_reqs(2, max_new=10)
    got, _, eng, base = check(spec, [dict(kind="oom", step=2, span=2)], pipeline)
    assert got["tokens"] == base
    assert eng.preemptions >= 1


# --------------------------------------------------------------- the watchdog
@PIPELINES
def test_straggler_watchdog_records_event(pipeline):
    """A 1 s stall at round 12 over steps of a few ms: an event over 3x
    the median, every request ok with the fault-free tokens.  A loaded
    host can add events of its own, so the stall's is the longest."""
    spec = reqs(2, mlo=20, mhi=24)
    base = ref(spec, max_seq=64)["tokens"]
    eng = port_engine(pipeline, max_seq=64, straggler_factor=3.0)
    got = port(eng, spec, [dict(kind="straggler", step=12, sleep_s=1.0)])
    events = eng.last_stats["stragglers"]
    assert len(events) >= 1
    ev = max(events, key=lambda e: e["duration_s"])
    assert ev["duration_s"] > 3.0 * ev["median_s"] and ev["duration_s"] >= 1.0
    assert ev["live_slots"] >= 1
    assert got["tokens"] == base
    assert all(v[0] == STATUS_OK for v in got["ledger"].values())


def test_stragglers_key_always_present():
    """The key is there after every session; with no step over the
    threshold (a factor no host stall reaches) it is empty."""
    eng = port_engine(straggler_factor=1e9)
    eng.serve([Request(**r) for r in reqs(2)])
    assert eng.last_stats["stragglers"] == [] and eng.last_stats["recovery_log"] == []
    eng.serve([])
    assert eng.last_stats["stragglers"] == [] and eng.last_stats["recovery_log"] == []


# ------------------------------------------------------ speculative collapse
def _damped():
    """The reference test's damped layer stack (layers x 0.05, so the
    self-draft tracks the target), in both packages."""
    m = models()
    if "damped" not in m:
        jp = dict(m["jp"], layers=jax.tree.map(lambda a: a * 0.05, m["jp"]["layers"]))
        m["damped"] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             reduced_config(ARCH), device="cpu"))
    return m["damped"]


@PIPELINES
def test_spec_collapse_auto_disables_and_recovers(pipeline):
    """A collapse window on uid 0 drives the governor off (and back on);
    the committed tokens never change, and the next fault-free session
    has it armed again."""
    spec = reqs(2, seed=5, mlo=30, mhi=34)
    jp, tp = _damped()
    kw = dict(max_seq=96, spec_k=4, draft="self:2", spec_disable_window=4,
              spec_cooldown=4)
    f = [dict(kind="spec_collapse", step=0, uid=0, span=6)]
    want_base = ref(spec, params=jp, **kw)
    want = ref(spec, f, params=jp, **kw)
    eng = port_engine(pipeline, params=tp, **kw)
    assert port(eng, spec) == want_base
    got = port(eng, spec, f)
    assert got == want
    assert got["auto_disables"][0] >= 1 and want_base["auto_disables"][0] == 0
    assert eng.last_stats[0].get("spec_rearms", 0) >= 1    # the cooldown re-armed it
    assert got["tokens"] == want_base["tokens"]
    again = port(eng, spec)
    assert again["tokens"] == want_base["tokens"] and again["auto_disables"][0] == 0
