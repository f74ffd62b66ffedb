"""Open-loop serving: an asyncio server over the engine's session primitives.

Counterpart of ``repro.serve.async_engine``.  ``ServeEngine.serve()`` is
closed-loop: it takes a batch and returns when the last request drains.
This module drives the same scheduler open-loop:

  * requests arrive on a clock (``submit()`` at any time; ``run_workload``
    replays a :mod:`repro_torch.serve.workload` arrival process);
  * tokens stream back through per-request async iterators
    (:class:`TokenStream`) as each scheduler round commits them;
  * the engine's rounds interleave with the event loop: one round, which
    blocks the loop while it waits on the step's commit, then a yield, so
    submissions and consumers run between rounds.  It is a cooperative
    server, not a threaded one.

Every scheduling decision (admission order, chunked prefill, preemption,
shedding, fault recovery) is taken inside the engine's own rounds, shared
with the closed-loop path, and sampling keys are (uid, position): so
streamed tokens equal what a closed ``serve()`` of the admitted requests
returns.  With ``engine.pipeline`` (the default) each round commits the
previous round's step and leaves its own in flight, so streams lag one
round, with the same content.

Two clocks:

  wall   (default) ``run_workload`` sleeps real seconds between arrivals:
         honest latencies; an arrival's edge blurs by up to one round
         (the loop is blocked while a round runs).  TTFT counts from the
         arrival's ingestion (``enqueued_s``).
  round  an arrival lands at scheduler round ``int(arrival_s /
         round_time_s)``; idle rounds tick the clock towards the next
         arrival.  Deterministic: the same workload, faults and seed give
         the same admissions, statuses and tokens.

After ``close()``, ``engine.last_stats["sla"]`` and ``["timeseries"]``
cover the session.  One session per ``AsyncServeEngine``; the engine must
not serve another call while the session is live.  An exception that
escapes a round (any that is not a recoverable injected fault: a kernel
that fails to launch, an audit failure) aborts the session through the
engine's ``_abort``: every open stream ends ``failed`` (the abort's
reason), and ``close()`` re-raises the exception.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import time
from collections import deque
from typing import Dict, List, Optional

from repro_torch.serve.engine import STATUS_OK, Request, ServeEngine
from repro_torch.serve.workload import TimedRequest

_DONE = object()


class TokenStream:
    """A request's async iterator: yields its tokens as the scheduler
    commits them and stops once the request reaches a terminal status
    (``.status``, ``.reason``); ``.tokens`` keeps everything delivered."""

    def __init__(self, uid: int):
        self.uid = uid
        self.tokens: List[int] = []
        self.status: Optional[str] = None
        self.reason: Optional[str] = None
        self._q: asyncio.Queue = asyncio.Queue()
        self._sent = 0          # the engine side's cursor into req.generated
        self._closed = False
        self._exhausted = False

    # ---- engine side -------------------------------------------------------
    def _push(self, tok: int):
        self.tokens.append(tok)
        self._q.put_nowait(tok)

    def _close(self, status: str, reason: Optional[str] = None):
        if self._closed:
            return
        self._closed = True
        self.status, self.reason = status, reason
        self._q.put_nowait(_DONE)

    def _fail(self, exc: BaseException):
        if self._closed:
            return
        self._closed = True
        self.status = "failed"
        self.reason = f"{type(exc).__name__}: {exc}"
        self._q.put_nowait(exc)

    # ---- consumer side -----------------------------------------------------
    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        if self._exhausted:
            raise StopAsyncIteration
        item = await self._q.get()
        if item is _DONE:
            self._exhausted = True
            raise StopAsyncIteration
        if isinstance(item, BaseException):
            self._exhausted = True
            raise item
        return item

    async def drain(self) -> List[int]:
        """Consume the rest of the stream; returns every token."""
        async for _ in self:
            pass
        return list(self.tokens)


class AsyncServeEngine:
    """The open-loop server: submissions and token streams around one
    engine session.  Use it as an async context manager, or ``submit()``
    and ``close()`` by hand."""

    def __init__(self, engine: ServeEngine, *, faults=None, clock: str = "wall",
                 round_time_s: float = 1.0, idle_poll_s: float = 0.002,
                 backpressure_watermark: Optional[int] = None):
        if clock not in ("wall", "round"):
            raise ValueError(f"clock must be 'wall' or 'round'; got {clock!r}")
        if backpressure_watermark is not None and backpressure_watermark < 1:
            raise ValueError("backpressure_watermark must be >= 1; "
                             f"got {backpressure_watermark}")
        self.engine = engine
        self.clock = clock
        self.round_time_s = round_time_s
        self.idle_poll_s = idle_poll_s
        # submit() awaits while the waiting queue is at or above this depth,
        # instead of letting the engine shed
        self.backpressure_watermark = backpressure_watermark
        self._round_evt = asyncio.Event()
        self._faults = faults
        self._st = None
        self._task: Optional[asyncio.Task] = None
        self._pending: deque = deque()     # (request, stream, arrival round)
        self._scheduled: list = []         # heap of (round, tie, request, stream)
        self._tiebreak = itertools.count()
        self._streams: Dict[int, tuple] = {}
        self._open: set = set()
        self._wake = asyncio.Event()
        self._closing = False
        self._error: Optional[BaseException] = None
        self._results: Dict[int, List[int]] = {}

    # ------------------------------------------------------------- lifecycle
    async def __aenter__(self) -> "AsyncServeEngine":
        self._ensure_started()
        return self

    async def __aexit__(self, exc_type, exc, tb):
        if exc_type is None:
            await self.close()
        else:
            self._closing = True
            self._wake.set()

    def _ensure_started(self):
        if self._task is not None:
            return
        self._st = self.engine._open_session([], self._faults)
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def close(self) -> Dict[int, List[int]]:
        """Drain every request in flight, finalize the session and return
        {uid: tokens} of the OK ones (also ``.results``).  Raises whatever
        failed the session."""
        if self._task is None:
            return {}
        self._closing = True
        self._wake.set()
        await self._task
        if self._error is not None:
            raise self._error
        return self._results

    @property
    def results(self) -> Dict[int, List[int]]:
        return self._results

    @property
    def last_stats(self):
        return self.engine.last_stats

    # -------------------------------------------------------------- requests
    async def submit(self, request: Request, *,
                     arrival_round: Optional[int] = None) -> TokenStream:
        """Enqueue a request and return its token stream.  Under the round
        clock, ``arrival_round`` (default: now) holds its ingestion until
        that scheduler round.

        With ``backpressure_watermark`` set, the call awaits while the
        waiting queue (submissions not yet ingested included) is at or
        above the watermark: the submitter slows down instead of the
        engine shedding.  Without it, submit never yields, so requests
        submitted back to back land in one ingestion sweep and admit
        together (the round clock's determinism rests on it)."""
        self._ensure_started()
        self._check_live()
        if self.backpressure_watermark is not None:
            while self._depth() >= self.backpressure_watermark:
                self._round_evt.clear()
                self._wake.set()
                await self._round_evt.wait()
                self._check_live()
        stream = TokenStream(request.uid)
        self._pending.append((request, stream, arrival_round))
        self._wake.set()
        # no yield past this point (see the docstring)
        return stream

    def _check_live(self):
        if self._error is not None:
            raise RuntimeError("serving session already failed") from self._error
        if self._closing:
            raise RuntimeError("serving session is closing")

    def _depth(self) -> int:
        """The waiting queue's depth as backpressure counts it: the
        engine's shed-eligible queue plus every submission not ingested
        yet (else a burst of submits would all pass the watermark before
        the loop ingests one)."""
        return (self.engine._queue_depth(self._st)
                + len(self._pending) + len(self._scheduled))

    def cancel(self, uid: int):
        """Cancel ``uid`` (queued, mid-chunk, live, or not ingested yet) at
        the next round; its stream ends ``cancelled``."""
        self.engine.cancel(uid)
        self._wake.set()

    async def run_workload(self, timed: List[TimedRequest]) -> Dict[int, List[int]]:
        """Replay an arrival process: submit each request at its arrival
        (wall sleeps, or scheduler rounds under the round clock), drain
        every stream, return the OK requests' tokens."""
        order = sorted(timed, key=lambda t: t.arrival_s)
        streams = []
        if self.clock == "round":
            for tr in order:
                streams.append(await self.submit(
                    tr.request, arrival_round=int(tr.arrival_s / self.round_time_s)))
        else:
            t0 = time.perf_counter()
            for tr in order:
                delay = tr.arrival_s - (time.perf_counter() - t0)
                if delay > 0:
                    await asyncio.sleep(delay)
                streams.append(await self.submit(tr.request))
        await asyncio.gather(*(s.drain() for s in streams))
        return {s.uid: list(s.tokens) for s in streams if s.status == STATUS_OK}

    # -------------------------------------------------------------- the loop
    async def _run(self):
        eng, st = self.engine, self._st
        try:
            while True:
                self._ingest(st)
                work = bool(st.queue or st.live or st.prefilling
                            or st.pending is not None)
                arrivals = bool(self._scheduled or self._pending)
                if not work and not arrivals:
                    if self._closing:
                        break
                    await self._idle_wait()
                    continue
                if not work and self.clock != "round":
                    # wall clock: nothing runs until the next submit
                    await self._idle_wait()
                    continue
                # the round clock ticks idle rounds to reach the next
                # arrival; otherwise one scheduler round.  Pipelined, the
                # round commits the previous step and leaves its own in
                # flight, and the ingestion and publishing around it are
                # host work the overlap hides
                if eng.pipeline:
                    eng.dispatch_round(st)
                else:
                    eng._round(st)
                self._publish(st)
                self._round_evt.set()      # blocked submitters look again
                await asyncio.sleep(0)
            self._results = eng._finalize_session(st)
        except BaseException as exc:  # noqa: BLE001 - close() re-raises it
            self._error = exc
            try:
                eng._abort(st, exc)
                self._publish(st)
            finally:
                for uid in list(self._open):
                    stream, _ = self._streams[uid]
                    stream._fail(exc)
                    self._open.discard(uid)
        finally:
            # a blocked submitter must not outlive the loop: it wakes, sees
            # the error or the close, and raises
            self._round_evt.set()

    async def _idle_wait(self):
        self._wake.clear()
        try:
            await asyncio.wait_for(self._wake.wait(), self.idle_poll_s)
        except asyncio.TimeoutError:
            pass

    def _ingest(self, st):
        while self._pending:
            req, stream, rnd = self._pending.popleft()
            if rnd is not None and self.clock == "round":
                heapq.heappush(self._scheduled, (rnd, next(self._tiebreak), req, stream))
            else:
                self._admit_now(st, req, stream)
        # an arrival at round r is seen by round r (st.rnd is the round
        # that just ran; the next round is st.rnd + 1)
        while self._scheduled and self._scheduled[0][0] <= st.rnd + 1:
            _, _, req, stream = heapq.heappop(self._scheduled)
            self._admit_now(st, req, stream)

    def _admit_now(self, st, req: Request, stream: TokenStream):
        if req.uid in self._streams or req.uid in st.stats:
            stream._fail(ValueError(
                f"duplicate request uid {req.uid}: the status ledger and "
                f"sampling keys are keyed by uid"))
            return
        self._streams[req.uid] = (stream, req)
        self._open.add(req.uid)
        self.engine._submit_open(st, req, now=time.perf_counter() - st.t0)

    def _publish(self, st):
        """Diff each open request's ``generated`` list into its stream (a
        preemption's or a recovery's resume copy shares that list, so it
        only grows and the cursor never sends a token twice), then close
        the streams whose request reached a terminal status."""
        for uid in list(self._open):
            stream, req = self._streams[uid]
            s = st.stats.get(uid)
            if s is None:
                continue
            status = s.get("status")
            if status is None or status == STATUS_OK:
                gen = req.generated or []
                while stream._sent < len(gen):
                    stream._push(gen[stream._sent])
                    stream._sent += 1
            if status is not None:
                stream._close(status, s.get("reason"))
                self._open.discard(uid)


async def serve_open_loop(engine: ServeEngine, timed: List[TimedRequest], *,
                          faults=None, clock: str = "round",
                          round_time_s: float = 1.0) -> Dict[int, List[int]]:
    """Replay ``timed`` through a fresh session and return the OK
    requests' tokens (``engine.last_stats`` carries the SLA summary)."""
    async with AsyncServeEngine(engine, faults=faults, clock=clock,
                                round_time_s=round_time_s) as srv:
        await srv.run_workload(timed)
        return await srv.close()
