"""The port's open-loop serving (``serve.async_engine`` and
``ServeEngine._submit_open``): the async cases of ``test_openloop.py``,
its chaos case and ``test_cluster.py``'s single-engine backpressure case,
replayed on the port.

Each case runs one scenario, written once, on the reference's
``AsyncServeEngine`` and on the port's, on the same inputs, and holds
the port's streamed tokens, stream statuses, ledger statuses and reasons
to the reference's; the port's streams are also held to a closed
``serve()`` of the same requests where the reference case does so.
Reduced qwen2-1.5b in fp32 on the CPU with the reference's weights
(``params_from_numpy``), at the reference tests' engine settings (max_seq
48, 2 slots, 8-token pages); the reference engines are cached at module
level by their arguments, and each case calls the reference once.
There is no pytest-asyncio: each case drives its coroutine with
``asyncio.run``.

A prompt of ``max_seq`` tokens or more submitted open-loop on the dense
layout follows the reference's outputs, pinned by
``test_dense_prompt_at_max_seq_follows_the_reference``: the dense layout
enqueues it unchecked (the closed ``serve()`` of the port refuses it up
front), a prompt of exactly ``max_seq`` tokens serves through the
clamped write of a row past the cache, and a longer one fails its
prefill and with it the session."""

import asyncio
import copy
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.serve import async_engine as jax_async  # noqa: E402
from repro.serve import workload as jax_workload  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.faults import Fault as JaxFault  # noqa: E402
from repro.serve.faults import FaultSchedule as JaxFaultSchedule  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.serve import async_engine, workload  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    STATUS_CANCELLED,
    STATUS_FAILED,
    STATUS_OK,
    STATUS_SHED,
    TERMINAL_STATUSES,
    Request,
    ServeEngine,
)
from repro_torch.serve.faults import Fault, FaultSchedule  # noqa: E402
from test_torch_scheduling import (  # noqa: E402
    ARCH,
    EKW,
    _freeze,
    jax_serve,
    models,
    one_intra_op_thread,
    reqs,
)

_REF_ENGINES = {}


def _ref_engine(**kw):
    """A reference engine (shared by its arguments: its jitted steps
    compile once); a session leaves nothing behind for the next."""
    key = _freeze(kw)
    if key not in _REF_ENGINES:
        m = models()
        _REF_ENGINES[key] = JaxServeEngine(
            m["jm"], m["jp"], **{"temperature": 0.0, "seed": 0, **EKW, **kw})
    return _REF_ENGINES[key]


def _port_engine(pipeline=True, **kw):
    m = models()
    return ServeEngine(m["tm"], m["tp"], pipeline=pipeline,
                       **{"temperature": 0.0, "seed": 0, **EKW, **kw})


REF = types.SimpleNamespace(
    Async=jax_async.AsyncServeEngine, serve_open_loop=jax_async.serve_open_loop,
    Request=JaxRequest, Fault=JaxFault, FaultSchedule=JaxFaultSchedule,
    make_workload=jax_workload.make_workload, engine=_ref_engine)


def _port(pipeline=True):
    return types.SimpleNamespace(
        Async=async_engine.AsyncServeEngine, serve_open_loop=async_engine.serve_open_loop,
        Request=Request, Fault=Fault, FaultSchedule=FaultSchedule,
        make_workload=workload.make_workload,
        engine=lambda **kw: _port_engine(pipeline, **kw))


PIPELINES = pytest.mark.parametrize("pipeline", [False, True], ids=["serial", "pipelined"])


def _make(side, spec):
    return [side.Request(**r) for r in copy.deepcopy(spec)]


def _streams(streams):
    """Each stream's (status, tokens)."""
    return {s.uid: (s.status, list(s.tokens)) for s in streams}


def _ledger(eng, uids):
    """Each request's ledger status and reason."""
    return {u: (eng.last_stats[u]["status"], eng.last_stats[u].get("reason"))
            for u in uids}


def _both(scenario, pipeline=True):
    """The scenario's figures on the reference and on the port."""
    return scenario(REF), scenario(_port(pipeline))


def _submit_all(spec, arrival_round=0, cancel=(), faults=None, **kw):
    """Every request submitted at ``arrival_round``, ``cancel`` named right
    after, every stream drained: (engine, streams, tokens)."""
    def scenario(side):
        async def run():
            eng = side.engine(**kw)
            fs = (side.FaultSchedule([side.Fault(**f) for f in faults])
                  if faults else None)
            async with side.Async(eng, faults=fs, clock="round") as srv:
                streams = [await srv.submit(r, arrival_round=arrival_round)
                           for r in _make(side, spec)]
                for uid in cancel:
                    srv.cancel(uid)
                await asyncio.gather(*(s.drain() for s in streams))
                await srv.close()
            return eng, streams

        eng, streams = asyncio.run(run())
        uids = [r["uid"] for r in spec]
        return dict(streams=_streams(streams), ledger=_ledger(eng, uids),
                    preemptions=eng.preemptions,
                    sla=(eng.last_stats["sla"]["statuses"],
                         eng.last_stats["sla"]["ok_tokens"]))
    return scenario


# ------------------------------------------------------- streaming parity
@PIPELINES
def test_streaming_bit_identical_to_batch_serve(pipeline):
    """Streamed tokens equal the reference's streams and a closed serve of
    the same requests; each stream ends OK; the SLA summary covers the
    session (test_openloop.py:79)."""
    spec = reqs(5)
    want, got = _both(_submit_all(spec), pipeline)
    assert got == want
    eng = _port_engine(pipeline)
    closed = eng.serve(_make(_port(), spec))
    assert {u: t for u, (s, t) in got["streams"].items()} == closed
    assert all(s == STATUS_OK for s, _ in got["streams"].values())
    assert got["sla"] == ({"ok": 5}, sum(len(t) for t in closed.values()))


def test_streaming_parity_under_forced_preemption():
    """A pool tight enough to preempt mid-stream moves no streamed token
    (test_openloop.py:103)."""
    spec = [dict(uid=0, prompt=list(range(1, 9)), max_new_tokens=12),
            dict(uid=1, prompt=list(range(9, 17)), max_new_tokens=12)]
    want, got = _both(_submit_all(spec, num_pages=4))
    assert got == want
    assert got["preemptions"] > 0


@PIPELINES
def test_open_loop_arrivals_match_closed_loop(pipeline):
    """Poisson arrivals on the round clock: the OK set and its tokens are
    the reference's, and a closed serve's (test_openloop.py:127)."""
    vocab = reduced_config(ARCH).vocab
    wl_kw = dict(vocab=vocab, seed=5, rate=1.0, prompt_median=6, prompt_max=12,
                 out_median=4, out_max=8)

    def scenario(side):
        async def run():
            eng = side.engine(max_queue=16)
            wl = side.make_workload("poisson", 8, **wl_kw)
            return eng, await side.serve_open_loop(eng, wl, clock="round")

        eng, ok = asyncio.run(run())
        return dict(ok=ok, ledger=_ledger(eng, range(8)))

    want, got = _both(scenario, pipeline)
    assert got == want
    wl = workload.make_workload("poisson", 8, **wl_kw)
    closed = _port_engine(pipeline).serve(
        [dataclasses.replace(t.request, generated=None) for t in wl
         if t.request.uid in got["ok"]])
    assert got["ok"] == closed


def test_pipelined_streams_publish_a_round_later():
    """Pipelined, a decode step's tokens reach the stream at the next
    round's commit; serial, in the round that ran the step (with the
    admission's first token).  The content is the same: the pipelined
    stream after round r + 1 is the serial stream after round r."""
    def run(pipeline):
        seen = []

        class Recording(async_engine.AsyncServeEngine):
            def _publish(self, st):
                super()._publish(st)
                seen.append(list(self._streams[0][0].tokens))

        async def go():
            eng = _port_engine(pipeline, batch_slots=1)
            async with Recording(eng, clock="round") as srv:
                s = await srv.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4))
                await s.drain()
                await srv.close()
            return s

        s = asyncio.run(go())
        assert s.status == STATUS_OK and len(s.tokens) == 4
        return seen

    serial, piped = run(False), run(True)
    assert [len(t) for t in serial] == [2, 3, 4]
    assert [len(t) for t in piped] == [1, 2, 3, 4]
    assert piped[1:] == serial


# ------------------------------------------------------- lifecycle races
def test_cancel_racing_shed_exactly_one_terminal_status():
    """A request cancelled while it is the overflow's shed victim ends
    cancelled: the lifecycle sweep runs before admission control
    (test_openloop.py:148)."""
    spec = reqs(4, phi=6, mhi=4)
    want, got = _both(_submit_all(spec, cancel=(3,), max_queue=1, batch_slots=1))
    assert got == want
    sts = {u: s for u, (s, _) in got["ledger"].items()}
    assert all(s in TERMINAL_STATUSES for s in sts.values())
    assert sts[3] == STATUS_CANCELLED
    assert STATUS_SHED in {sts[1], sts[2]}
    assert {u: s for u, (s, _) in got["streams"].items()} == sts


def test_cancel_racing_deadline_exactly_one_terminal_status():
    """A forced expiry and a cancel on the same round end the request
    cancelled, once (test_openloop.py:171)."""
    spec = reqs(3, phi=6, mlo=4, mhi=8)
    faults = [dict(kind="deadline", step=1, uid=1), dict(kind="cancel", step=1, uid=1),
              dict(kind="deadline", step=1, uid=2)]
    want, got = _both(_submit_all(spec, faults=faults, batch_slots=1))
    assert got == want
    assert got["ledger"][1][0] == STATUS_CANCELLED
    assert got["ledger"][2][0] == "timeout"
    assert got["streams"][1][0] == STATUS_CANCELLED


@pytest.mark.parametrize("case", ["max_seq", "pages"])
def test_never_fits_fails_without_killing_session(case):
    """An impossible open-loop submission on the paged layout ends failed
    with the reference's ``never-fits`` reason; the session serves the
    rest (test_openloop.py:197).  ``max_seq``: a 60-token prompt over
    max_seq 48; ``pages``: a 40-token prompt over a 4-page pool."""
    bad = dict(uid=1, prompt=list(range(60 if case == "max_seq" else 40)), max_new_tokens=3)
    spec = [dict(uid=0, prompt=[1, 2, 3], max_new_tokens=3), bad]
    kw = {} if case == "max_seq" else dict(num_pages=4)
    want, got = _both(_submit_all(spec, arrival_round=None, **kw))
    assert got == want
    assert got["streams"][0][0] == STATUS_OK
    assert got["streams"][1][0] == STATUS_FAILED
    assert got["ledger"][1][1].startswith("never-fits: ")


@pytest.mark.parametrize("length", [48, 60])
def test_dense_prompt_at_max_seq_follows_the_reference(length):
    """The dense layout enqueues an open-loop prompt unchecked, as the
    reference does.  Exactly max_seq tokens: served, OK, the reference's
    tokens (the decode row past the cache writes its last row, clamped).
    Longer: its prefill raises, which fails the session: every request
    ends failed and ``close()`` re-raises the error, on both."""
    spec = [dict(uid=0, prompt=[1, 2, 3], max_new_tokens=3),
            dict(uid=1, prompt=[(7 * i) % reduced_config(ARCH).vocab
                                for i in range(length)], max_new_tokens=3)]

    def scenario(side):
        async def run():
            eng = side.engine(cache_layout="dense")
            srv = side.Async(eng, clock="round")
            streams = [await srv.submit(r) for r in _make(side, spec)]
            drained = await asyncio.gather(*(s.drain() for s in streams),
                                           return_exceptions=True)
            try:
                await srv.close()
                closed = None
            except ValueError as exc:
                closed = type(exc).__name__
            return streams, drained, closed

        streams, drained, closed = asyncio.run(run())
        return dict(streams=_streams(streams), closed=closed,
                    raised=[type(d).__name__ for d in drained if isinstance(d, Exception)])

    want, got = _both(scenario)
    assert got == want
    if length == 48:
        assert got["streams"][1][0] == STATUS_OK and len(got["streams"][1][1]) == 2
    else:
        assert got["closed"] == "ValueError" and got["raised"] == []
        assert {s for s, _ in got["streams"].values()} == {STATUS_FAILED}
    # the closed serve() refuses such a prompt up front
    with pytest.raises(ValueError, match="no decode room"):
        _port_engine(cache_layout="dense").serve(_make(_port(), spec))


def test_duplicate_uid_fails_stream_only():
    """A second submission of a live uid fails its own stream with the
    reference's ValueError; the first serves on (test_openloop.py:216)."""
    spec = [dict(uid=7, prompt=[1, 2, 3], max_new_tokens=3),
            dict(uid=7, prompt=[4, 5, 6], max_new_tokens=3)]

    def scenario(side):
        async def run():
            eng = side.engine()
            async with side.Async(eng, clock="round") as srv:
                a, b = [await srv.submit(r) for r in _make(side, spec)]
                tokens_a = await a.drain()
                try:
                    await b.drain()
                    raised = None
                except ValueError as exc:
                    raised = str(exc)
                await srv.close()
            return a, tokens_a, raised

        a, tokens_a, raised = asyncio.run(run())
        return dict(a=(a.status, tokens_a), raised=raised)

    want, got = _both(scenario)
    assert got == want
    assert got["a"][0] == STATUS_OK and len(got["a"][1]) == 3
    assert got["raised"].startswith("duplicate request uid 7")


# ------------------------------------------------------- chaos under load
@PIPELINES
def test_chaos_under_open_loop_burst(pipeline):
    """Bursty arrivals with a NaN, a kernel fault (the degrade) and a
    cancel: statuses partition and equal the reference's, the pool audits
    clean and drained, and the survivors' tokens are the reference's and a
    fault-free closed serve's (test_openloop.py:314)."""
    vocab = reduced_config(ARCH).vocab
    wl_kw = dict(vocab=vocab, seed=11, rate=2.0, prompt_median=6, prompt_max=12,
                 out_median=4, out_max=8)
    faults = [dict(kind="nan", step=4, uid=2), dict(kind="kernel", step=6),
              dict(kind="cancel", step=3, uid=5)]

    def scenario(side):
        async def run():
            eng = side.engine(max_queue=8, audit=True)
            wl = side.make_workload("bursty", 10, **wl_kw)
            fs = side.FaultSchedule([side.Fault(**f) for f in faults])
            return eng, await side.serve_open_loop(eng, wl, faults=fs, clock="round")

        eng, ok = asyncio.run(run())
        p = eng.last_pool_stats
        return dict(ok=ok, ledger={u: s for u, (s, _) in _ledger(eng, range(10)).items()},
                    audit=(p.audit_ok, p.used_pages), degraded=eng.backend_degraded)

    want, got = _both(scenario, pipeline)
    assert got == want
    assert all(s in TERMINAL_STATUSES for s in got["ledger"].values())
    assert got["audit"] == (True, 0) and got["degraded"]
    assert got["ledger"][5] == STATUS_CANCELLED
    wl = workload.make_workload("bursty", 10, **wl_kw)
    closed = _port_engine(pipeline).serve(
        [dataclasses.replace(t.request, generated=None) for t in wl
         if t.request.uid in got["ok"]])
    assert got["ok"] == closed


def test_real_failure_fails_every_open_stream():
    """An exception that is not an injected fault (here a dispatch that
    raises, as a kernel that fails to launch would) is not recovered: the
    session aborts through ``_abort``, every open stream ends failed with
    the abort's reason, ``close()`` re-raises the error, a later submit
    raises, and the pool is left audit-clean."""
    eng = _port_engine()
    dispatch = eng._timed_dispatch

    def failing(st):
        if st.rnd >= 3:
            raise RuntimeError("launch failed")
        return dispatch(st)

    eng._timed_dispatch = failing
    spec = reqs(4, mlo=6, mhi=8)

    async def run():
        srv = async_engine.AsyncServeEngine(eng, clock="round")
        streams = [await srv.submit(r, arrival_round=0) for r in _make(_port(), spec)]
        drained = await asyncio.gather(*(s.drain() for s in streams), return_exceptions=True)
        with pytest.raises(RuntimeError, match="launch failed"):
            await srv.close()
        with pytest.raises(RuntimeError, match="already failed"):
            await srv.submit(Request(uid=9, prompt=[1], max_new_tokens=1))
        return streams, drained

    streams, drained = asyncio.run(run())
    assert all(isinstance(d, list) for d in drained)
    assert {s.status for s in streams} == {STATUS_FAILED}
    assert all(s.reason.startswith("aborted: RuntimeError: launch failed") for s in streams)
    assert all(eng.last_stats[r["uid"]]["reason"].startswith("aborted: RuntimeError")
               for r in spec)
    assert eng.recoveries == 0 and not eng.backend_degraded
    assert eng.last_pool_stats.audit_ok and eng.last_pool_stats.used_pages == 0


# ---------------------------------------------- backpressure (test_cluster.py)
def test_async_engine_backpressure_bounds_depth():
    """With a watermark, submit() awaits instead of letting the engine shed:
    the waiting queue never exceeds it, every request ends OK with the
    reference's closed tokens; without it the same burst sheds
    (test_cluster.py:433, wall clock)."""
    spec = reqs(10, mlo=2, mhi=4)
    want, _ = jax_serve(spec)

    async def run(watermark):
        eng = _port_engine(max_queue=3, shed_policy="reject-newest")
        peak = 0
        async with async_engine.AsyncServeEngine(
                eng, backpressure_watermark=watermark) as srv:
            streams = []
            for r in _make(_port(), spec):
                streams.append(await srv.submit(r))
                peak = max(peak, srv._depth())
            for s in streams:
                async for _ in s:
                    pass
            await srv.close()
        return ({s.uid: s.tokens for s in streams if s.status == STATUS_OK},
                {s.uid: s.status for s in streams}, peak)

    out, sts, peak = asyncio.run(run(2))
    assert peak <= 2
    assert set(sts.values()) == {STATUS_OK}
    assert out == want
    _, sts, _ = asyncio.run(run(None))
    assert STATUS_SHED in sts.values()


# ---------------------------------------------------------------- wall clock
def test_wall_clock_replay_stamps_arrival_and_matches_closed():
    """The wall clock: each request's TTFT counts from its ingestion, which
    comes no earlier than its arrival; the OK tokens are the reference's
    closed serve of the same requests."""
    vocab = reduced_config(ARCH).vocab
    wl = workload.make_workload("poisson", 6, vocab=vocab, seed=2, rate=40.0,
                                prompt_median=6, prompt_max=12, out_median=4, out_max=8)

    async def run():
        eng = _port_engine()
        return eng, await async_engine.serve_open_loop(eng, wl, clock="wall")

    eng, ok = asyncio.run(run())
    assert set(ok) == set(range(6))
    spec = [dict(uid=t.request.uid, prompt=list(t.request.prompt),
                 max_new_tokens=t.request.max_new_tokens) for t in wl]
    want, _ = jax_serve(spec)
    assert ok == want
    for t in wl:
        s = eng.last_stats[t.request.uid]
        assert s["enqueued_s"] >= t.arrival_s
        assert s["first_token_s"] >= s["enqueued_s"]
    sla = eng.last_stats["sla"]
    assert sla["ttft_ms"]["n"] == 6 and sla["ttft_ms"]["p50"] >= 0.0


def test_constructor_and_session_validation():
    eng = _port_engine()
    with pytest.raises(ValueError, match="clock"):
        async_engine.AsyncServeEngine(eng, clock="tick")
    with pytest.raises(ValueError, match="backpressure_watermark"):
        async_engine.AsyncServeEngine(eng, backpressure_watermark=0)

    async def run():
        srv = async_engine.AsyncServeEngine(eng, clock="round")
        assert await srv.close() == {}             # never started
        s = await srv.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=2))
        srv._closing = True
        with pytest.raises(RuntimeError, match="closing"):
            await srv.submit(Request(uid=1, prompt=[1], max_new_tokens=1))
        out = await srv.close()
        return s, out

    s, out = asyncio.run(run())
    assert s.status == STATUS_OK and out == {0: s.tokens}
