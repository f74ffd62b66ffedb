"""The port's scheduling axes (``ServeEngine``'s priorities, deadlines,
shedding, watermarks, ``cancel()`` and the SLA summary): the lifecycle
cases of ``test_openloop.py``, ``test_faults.py``,
``test_pipeline_overlap.py``, ``test_paged_serving.py`` and
``test_tiered_kv.py`` replayed on the port.

Each case serves the same trace on the reference engine and on the port
(both ``pipeline`` settings where the reference case runs its default)
and holds the port to the reference's tokens, terminal statuses and
preemptions.  Reduced qwen2-1.5b in fp32 on the CPU, at the reference
tests' engine settings (max_seq 48, 2 slots, 8-token pages); the
reference runs are cached at module level.  Chunked prefill and the seed
loop are in ``test_torch_chunked_prefill.py``, which imports the helpers
here."""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.serve import sla as jax_sla  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.faults import Fault, FaultSchedule  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.serve import sla  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    STATUS_CANCELLED,
    STATUS_OK,
    STATUS_SHED,
    STATUS_TIMEOUT,
    TERMINAL_STATUSES,
    Request,
    ServeEngine,
)
from repro_torch.testing import params_from_numpy  # noqa: E402

ARCH = "qwen2-1.5b"
# the reference tests' engine settings (test_openloop.py, test_faults.py)
EKW = dict(max_seq=48, batch_slots=2, cache_layout="paged", page_size=8)
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The engines run many tiny torch ops a step; on a loaded CPU (the
    suite's parallel workers) intra-op threads wait at every op's barrier
    and a reduced serve takes many times longer than on one thread, so
    the module runs on one and restores the count after (as
    ``test_torch_sampling.py`` does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models():
    if not _CACHE:
        jm = JaxModel(jax_reduced_config(ARCH), compute_dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(1))
        tm = Model(reduced_config(ARCH), device="cpu", dtype=torch.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), reduced_config(ARCH),
                               device="cpu")
        _CACHE.update(jm=jm, jp=jp, tm=tm, tp=tp)
    return _CACHE


def reqs(n, seed=3, plo=3, phi=12, mlo=2, mhi=7, prefix=(), **fields):
    """Request fields as dicts, drawn as the reference tests' ``_reqs``;
    ``fields`` go to every request, ``prefix`` leads every prompt."""
    vocab = reduced_config(ARCH).vocab
    rng = np.random.default_rng(seed)
    return [dict(uid=i, prompt=list(prefix) + rng.integers(
                 0, vocab, int(rng.integers(plo, phi))).tolist(),
                 max_new_tokens=int(rng.integers(mlo, mhi)), **fields)
            for i in range(n)]


def edit(spec, **per_uid):
    """A copy of ``spec`` with fields set per uid: ``edit(s, u2=dict(priority=0))``."""
    out = copy.deepcopy(spec)
    for r in out:
        r.update(per_uid.get(f"u{r['uid']}", {}))
    return out


def _freeze(x):
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    return x


def ledger(stats, spec):
    """Each request's status, preemptions and prefill chunks."""
    return {r["uid"]: (stats[r["uid"]]["status"], stats[r["uid"]]["preemptions"],
                       stats[r["uid"]].get("prefill_chunks", 0)) for r in spec}


def jax_serve(spec, cancel=(), faults=(), **kw):
    """The reference engine's tokens and ledger (cached).  ``faults`` are
    ``repro.serve.faults.Fault`` argument tuples."""
    m = models()
    key = (_freeze(spec), _freeze(kw), tuple(cancel), tuple(faults))
    if key not in _CACHE:
        eng = JaxServeEngine(m["jm"], m["jp"], **{"temperature": 0.0, "seed": 0,
                                                  **EKW, **kw})
        for uid in cancel:
            eng.cancel(uid)
        fs = FaultSchedule([Fault(*f) for f in faults]) if faults else None
        out = eng.serve([JaxRequest(**r) for r in copy.deepcopy(spec)], faults=fs)
        _CACHE[key] = (out, ledger(eng.last_stats, spec))
    return _CACHE[key]


def port_engine(pipeline=True, **kw):
    m = models()
    return ServeEngine(m["tm"], m["tp"], pipeline=pipeline, **{**EKW, **kw})


def port_serve(spec, pipeline=True, cancel=(), **kw):
    eng = port_engine(pipeline, **kw)
    for uid in cancel:
        eng.cancel(uid)
    return eng.serve([Request(**r) for r in copy.deepcopy(spec)]), eng


def statuses(eng, spec):
    return {r["uid"]: eng.last_stats[r["uid"]]["status"] for r in spec}


def assert_partition(eng, spec):
    """Every request has exactly one terminal status; an OK one carries
    its full token count; the pool drained."""
    for r in spec:
        s = eng.last_stats[r["uid"]]
        assert s["status"] in TERMINAL_STATUSES
        if s["status"] == STATUS_OK:
            assert s["tokens"] == r["max_new_tokens"]
    if eng.last_pool_stats is not None:
        p = eng.last_pool_stats
        assert p.used_pages - p.index_pages == 0


PIPELINES = pytest.mark.parametrize("pipeline", [False, True], ids=["serial", "pipelined"])


# ------------------------------------------------- priorities (test_openloop.py)
@PIPELINES
def test_priority_classes_schedule_first(pipeline):
    """One slot: the lower priority value finishes first; the tokens are
    the all-default run's (priority moves requests in time, not in
    value), and the reference's."""
    spec = reqs(3, phi=6, mhi=4)
    prio = edit(spec, u0=dict(priority=5), u2=dict(priority=0))
    base, _ = jax_serve(spec, batch_slots=1)
    want, want_ledger = jax_serve(prio, batch_slots=1)
    out, eng = port_serve(prio, pipeline, batch_slots=1)
    fin = {u: eng.last_stats[u]["finished_s"] for u in range(3)}
    assert fin[2] < fin[1] < fin[0]
    assert out == base == want
    assert ledger(eng.last_stats, prio) == want_ledger
    assert eng.last_stats[0]["priority"] == 5


@PIPELINES
def test_queue_watermark_sheds_best_effort_only(pipeline):
    spec = edit(reqs(6, phi=5, mhi=3), u3=dict(priority=2), u4=dict(priority=2),
                u5=dict(priority=2))
    kw = dict(batch_slots=1, queue_watermark=1, shed_priority=2)
    want, want_ledger = jax_serve(spec, **kw)
    out, eng = port_serve(spec, pipeline, **kw)
    sts = statuses(eng, spec)
    assert all(sts[u] == STATUS_OK for u in range(3))
    assert STATUS_SHED in {sts[u] for u in range(3, 6)}
    assert all(s in (STATUS_OK, STATUS_SHED) for s in sts.values())
    assert out == want and ledger(eng.last_stats, spec) == want_ledger
    assert all("queue watermark" in eng.last_stats[u]["reason"]
               for u in range(3, 6) if sts[u] == STATUS_SHED)
    assert_partition(eng, spec)


@PIPELINES
def test_free_page_watermark_defers_but_preserves_outputs(pipeline):
    spec = reqs(5)
    ref, _ = jax_serve(spec)
    want, want_ledger = jax_serve(spec, free_page_watermark=0.3)
    out, eng = port_serve(spec, pipeline, free_page_watermark=0.3)
    assert out == ref == want
    assert statuses(eng, spec) == {u: STATUS_OK for u in range(5)}
    assert ledger(eng.last_stats, spec) == want_ledger


def test_sla_summary_and_timeseries_schema():
    eng = port_engine(queue_watermark=8)
    spec = reqs(5)
    eng.serve([Request(**r) for r in spec])
    s = eng.last_stats["sla"]
    for k in ("p50", "p95", "p99"):
        assert s["ttft_ms"][k] is not None and s["ttft_ms"][k] >= 0
        assert s["tbt_ms"][k] is not None and s["tbt_ms"][k] >= 0
    assert s["requests"] == 5 and sum(s["statuses"].values()) == 5
    assert s["ok_tokens"] == sum(r["max_new_tokens"] for r in spec)
    ts = eng.last_stats["timeseries"]
    n = len(ts["round"])
    assert n > 0
    assert all(len(ts[k]) == n for k in ("t_s", "queue_depth", "live_slots",
                                         "utilization", "free_pages"))
    assert ts["t_s"] == sorted(ts["t_s"])
    assert max(ts["live_slots"]) == 2 and max(ts["utilization"]) == 1.0
    # dense: no pool column
    eng = port_engine(cache_layout="dense")
    eng.serve([Request(**r) for r in spec])
    assert eng.last_stats["timeseries"]["free_pages"] == []


# ------------------------------------------- the pipeline (test_pipeline_overlap.py)
def test_pipeline_timeseries_phases_roll_up():
    """The SLA summary's ``rounds`` block: one round a timeseries row,
    overlap > 0 only when pipelined."""
    spec = reqs(4)
    for pipeline in (True, False):
        _, eng = port_serve(spec, pipeline)
        ts = eng.last_stats["timeseries"]
        rounds = eng.last_stats["sla"]["rounds"]
        assert rounds["n"] == len(ts["round"])
        for col in ("dispatch_s", "commit_s", "overlap_s"):
            assert rounds[f"{col}_mean"] == pytest.approx(float(np.mean(ts[col])))
        if pipeline:
            assert rounds["overlap_s_mean"] > 0
        else:
            assert all(v == 0.0 for v in ts["overlap_s"])


def test_slack_orders_preemption_victims():
    """With priorities equal, the deadline-less request (infinite slack)
    yields its slot before the one racing a deadline, though it is the
    older; without deadlines the newest yields, as before."""
    eng = port_engine()
    st = eng._open_session([])
    for uid, deadline in ((0, None), (1, 10_000.0)):
        req = Request(uid=uid, prompt=[1, 2, 3], max_new_tokens=4, deadline_ms=deadline)
        eng._register(st, req)
        st.live[uid] = req
        st.admit_seq[uid] = uid
    assert eng._preempt_victim(st) == 0
    st.live[1] = dataclasses.replace(st.live[1], deadline_ms=None)
    st.has_deadlines = False
    assert eng._preempt_victim(st) == 1
    # a less important class yields first at equal slack
    st.live[0] = dataclasses.replace(st.live[0], priority=3)
    assert eng._preempt_victim(st) == 0


@PIPELINES
def test_slack_parity_without_deadlines(pipeline):
    """No deadlines: every slack is inf and the victims are the newest,
    as before: the reference's tokens and per-request preemptions."""
    spec = reqs(6, mlo=6, mhi=12)
    want, want_ledger = jax_serve(spec, num_pages=4)
    out, eng = port_serve(spec, pipeline, num_pages=4)
    assert out == want
    assert ledger(eng.last_stats, spec) == want_ledger
    assert eng.preemptions > 0


# -------------------------------------------------- shedding (test_faults.py)
@PIPELINES
def test_shed_reject_newest(pipeline):
    spec = reqs(6)
    base, _ = jax_serve(spec)
    want, want_ledger = jax_serve(spec, max_queue=4, shed_policy="reject-newest")
    out, eng = port_serve(spec, pipeline, max_queue=4, shed_policy="reject-newest")
    sts = statuses(eng, spec)
    assert [sts[u] for u in (4, 5)] == [STATUS_SHED] * 2
    assert all(sts[u] == STATUS_OK for u in (0, 1, 2, 3))
    assert out == {u: base[u] for u in (0, 1, 2, 3)} == want
    assert ledger(eng.last_stats, spec) == want_ledger
    assert "queue overflow" in eng.last_stats[5]["reason"]
    assert_partition(eng, spec)


@PIPELINES
def test_shed_reject_largest(pipeline):
    spec = reqs(6)
    want, want_ledger = jax_serve(spec, max_queue=4, shed_policy="reject-largest")
    out, eng = port_serve(spec, pipeline, max_queue=4, shed_policy="reject-largest")
    sts = statuses(eng, spec)
    sizes = {r["uid"]: len(r["prompt"]) + r["max_new_tokens"] for r in spec}
    shed = {u for u, v in sts.items() if v == STATUS_SHED}
    assert len(shed) == 2
    assert max(sizes[u] for u in set(sts) - shed) <= min(sizes[u] for u in shed)
    assert out == want and ledger(eng.last_stats, spec) == want_ledger


@pytest.mark.parametrize("kw", [
    dict(shed_policy="nope"), dict(max_queue=0), dict(queue_watermark=-1),
    dict(free_page_watermark=1.0), dict(free_page_watermark=-0.1),
    dict(prefill_budget=0)], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_scheduling_arguments_validated(kw):
    with pytest.raises(ValueError):
        port_engine(**kw)


# ------------------------------------------------ deadlines (test_faults.py)
@PIPELINES
def test_wall_clock_deadline(pipeline):
    """A deadline already passed expires at the first round."""
    spec = edit(reqs(3), u1=dict(deadline_ms=0.0))
    want, _ = jax_serve(spec)
    out, eng = port_serve(spec, pipeline)
    sts = statuses(eng, spec)
    assert sts[1] == STATUS_TIMEOUT and 1 not in out
    assert sts[0] == sts[2] == STATUS_OK
    assert eng.last_stats[1]["reason"] == "deadline"
    assert out == want
    assert_partition(eng, spec)


@PIPELINES
def test_ttft_deadline(pipeline):
    """Far-future TTFT deadlines never fire; one already passed ends the
    request before it is admitted."""
    spec = reqs(3, ttft_deadline_ms=1e9)
    eng = port_engine(pipeline)
    out = eng.serve([Request(**r) for r in spec])
    assert set(statuses(eng, spec).values()) == {STATUS_OK}
    assert out == jax_serve(reqs(3))[0]
    spec2 = edit(reqs(3), u2=dict(ttft_deadline_ms=0.0))
    out2 = eng.serve([Request(**r) for r in spec2])
    assert statuses(eng, spec2)[2] == STATUS_TIMEOUT and 2 not in out2
    assert eng.last_stats[2]["reason"] == "ttft_deadline"
    assert "first_token_s" not in eng.last_stats[2]


# --------------------------------------------------- cancel (test_faults.py)
@PIPELINES
def test_cancel_queued_and_live(pipeline):
    """uid 5 cancelled before serve() (queued), uid 0 by cancel() between
    rounds 1 and 2 (live): the reference's cancel fault at round 2.  Both
    end ``cancelled``, the others serve the reference's tokens, and the
    cancel set is consumed."""
    spec = reqs(6, mlo=6, mhi=10)
    base, _ = jax_serve(spec)
    want, want_ledger = jax_serve(spec, cancel=(5,), faults=[("cancel", 2, 0)])
    eng = port_engine(pipeline)
    eng.cancel(5)
    st = eng._open_session([Request(**r) for r in spec])
    run = eng.dispatch_round if pipeline else eng._round
    live_at_cancel = None
    while st.queue or st.live or st.prefilling or st.pending is not None:
        if st.rnd + 1 == 2:
            eng.cancel(0)
            live_at_cancel = 0 in {r.uid for r in st.live.values()}
        run(st)
    out = eng._finalize_session(st)
    sts = statuses(eng, spec)
    assert live_at_cancel
    assert sts[5] == STATUS_CANCELLED and sts[0] == STATUS_CANCELLED
    assert 0 not in out and 5 not in out
    assert out == want == {u: base[u] for u in out}
    assert ledger(eng.last_stats, spec) == want_ledger
    assert not eng._cancel_uids
    assert_partition(eng, spec)


def test_cancel_unknown_uid_kept_until_seen():
    eng = port_engine()
    eng.cancel(99)
    eng.serve([Request(**r) for r in reqs(2)])
    assert eng._cancel_uids == {99}
    eng.serve([Request(**r) for r in reqs(1, seed=5)] + [Request(99, [1, 2, 3], 2)])
    assert eng.last_stats[99]["status"] == STATUS_CANCELLED and not eng._cancel_uids


def test_statuses_partition_or_raise():
    """The finalize check: a request left without a terminal status
    raises."""
    eng = port_engine()
    st = eng._open_session([Request(**r) for r in reqs(2)])
    with pytest.raises(RuntimeError, match="without a terminal status"):
        eng._finalize_session(st)


# ---------------------------------------- per-request figures (test_paged_serving.py)
def test_last_stats_populated():
    """The per-request figures, the reference case less its ``stragglers``
    key (the watchdog waits for ROADMAP A10)."""
    spec = reqs(4, seed=9)
    eng = port_engine(cache_layout="paged", page_size=8)
    results = eng.serve([Request(**r) for r in spec])
    per_req = {u: s for u, s in eng.last_stats.items() if isinstance(u, int)}
    assert set(per_req) == set(results)
    for uid, s in per_req.items():
        assert s["admit_to_first_s"] >= 0.0
        assert s["finished_s"] >= s["first_token_s"]
        assert s["tokens"] == len(results[uid])
        assert s["tok_s"] > 0.0 and s["e2e_tok_s"] > 0.0
        decode_wall = (s["tokens"] - 1) / s["tok_s"]
        e2e_wall = s["tokens"] / s["e2e_tok_s"]
        assert abs(e2e_wall - (s["admit_to_first_s"] + decode_wall)) < 1e-6
        assert s["enqueued_s"] == 0.0 and s["priority"] == 1 and s["retries"] == 0
    p = eng.last_pool_stats
    assert p.used_pages == 0 and p.allocs == p.frees > 0
    assert 0.0 < p.peak_utilization <= 1.0
    assert p.peak_tokens == p.peak_used_pages * p.page_size
    assert p.retracts == 0
    assert results == jax_serve(spec)[0]


def test_one_token_request_has_zero_steady_rate():
    eng = port_engine()
    eng.serve([Request(uid=0, prompt=[1, 2, 3], max_new_tokens=1)])
    s = eng.last_stats[0]
    assert s["tokens"] == 1 and s["tok_s"] == 0.0 and s["e2e_tok_s"] > 0.0
    assert eng.last_stats["sla"]["tbt_ms"]["n"] == 0


def test_paged_and_spec_reject_the_seed_loop():
    """``fused=False`` is the dense baseline (the refusal part of
    ``test_paged_rejects_stateful_family_and_unfused``)."""
    with pytest.raises(ValueError, match="fused=True"):
        port_engine(fused=False)
    with pytest.raises(ValueError, match="fused=True"):
        port_engine(fused=False, spec_k=2)
    port_engine(fused=False, cache_layout="dense")


# -------------------------------------------- empty sessions (test_tiered_kv.py)
@pytest.mark.parametrize("layout", ["dense", "paged", "shared", "int8"])
def test_empty_session_stats_defined(layout):
    """serve([]): the percentiles and the sharing ratio come back defined
    (None-filled, 1.0), never raise or NaN; the reference case less
    ``audit_ok`` (the audit waits for ROADMAP A10)."""
    kw = dict(cache_layout="dense") if layout == "dense" else {}
    if layout == "shared":
        kw.update(prefix_sharing=True)
    if layout == "int8":
        kw.update(kv_dtype="int8")
    eng = port_engine(**kw)
    assert eng.serve([]) == {}
    s = eng.last_stats["sla"]
    assert s["requests"] == 0 and s["statuses"] == {}
    assert s["ok_tokens"] == 0 and np.isfinite(s["goodput_tok_s"])
    for key in ("ttft_ms", "tbt_ms"):
        assert s[key]["n"] == 0 and s[key]["p50"] is None and s[key]["p99"] is None
    assert "rounds" not in s
    if layout != "dense":
        p = eng.last_pool_stats
        assert p.sharing_ratio == 1.0 and np.isfinite(p.sharing_ratio)
        assert p.swap_outs == 0 and p.swap_ins == 0


# ------------------------------------------------------------------- serve.sla
def _ledger_fixture():
    rng = np.random.default_rng(0)
    stats = {}
    for u, status in enumerate(["ok", "ok", "shed", "timeout", "ok", "cancelled",
                                "failed", None]):
        s = {"enqueued_s": float(rng.uniform(0, 0.1)), "status": status,
             "tokens": int(rng.integers(1, 9))}
        if status in ("ok", "failed", "cancelled"):
            s["first_token_s"] = s["enqueued_s"] + float(rng.uniform(0, 0.5))
        stats[u] = s
    stats["timeseries"] = {"round": list(range(5)),
                           "dispatch_s": rng.uniform(0, 1e-3, 5).tolist(),
                           "commit_s": rng.uniform(0, 1e-3, 5).tolist(),
                           "overlap_s": [0.0] * 5}
    return stats, rng.uniform(0, 0.05, 37).tolist()


@pytest.mark.parametrize("samples", [[], [0.5], [3.0, 1.0, 2.0, 0.0, 9.5]])
def test_percentiles_match_reference(samples):
    assert sla.percentiles(samples) == jax_sla.percentiles(samples)


def test_sla_summaries_match_reference():
    """summarize, merge_ledgers, fleet_summary and format_summary against
    the reference module on the same ledgers."""
    stats, tbt = _ledger_fixture()
    ts = stats["timeseries"]
    for kw in (dict(timeseries=ts), {}, dict(timeseries={"round": []})):
        got = sla.summarize(stats, tbt_s=tbt, wall_s=1.25, **kw)
        assert got == jax_sla.summarize(stats, tbt_s=tbt, wall_s=1.25, **kw)
        assert sla.format_summary(got) == jax_sla.format_summary(got)
    empty = sla.summarize({}, tbt_s=[], wall_s=0.0)
    assert empty == jax_sla.summarize({}, tbt_s=[], wall_s=0.0)
    assert sla.format_summary(empty) == jax_sla.format_summary(empty)
    other = {7: {"enqueued_s": 0.0, "status": "ok", "tokens": 3, "first_token_s": 0.2},
             1: {"enqueued_s": 0.0, "status": "failed", "tokens": 0}}
    workers = {"w1": other, "w0": stats}
    assert sla.merge_ledgers([stats, other]) == jax_sla.merge_ledgers([stats, other])
    assert (sla.fleet_summary(workers, tbt_s=tbt, wall_s=2.0)
            == jax_sla.fleet_summary(workers, tbt_s=tbt, wall_s=2.0))
