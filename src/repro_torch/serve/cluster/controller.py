"""Cluster controller: placement, the fleet's clock, handoff and retry.

Counterpart of ``repro.serve.cluster.controller``.  The controller is the
one component that sees every replica.  It owns:

  placement    every fresh request goes through the :class:`Router` (load
               and prefix affinity) to a prefill-capable replica; every
               :class:`HandoffTicket` goes to the least loaded
               decode-capable one.
  the clock    ``step()`` advances each live worker one scheduler round,
               in worker-id order: the fleet is deterministic because the
               sweep order is.
  handoff      prefill-role workers return tickets from ``step()``; the
               controller routes and delivers them in the same fleet round
               (disaggregated prefill and decode are two sessions and one
               ``SwapHandle`` apart).
  retry        when a replica dies (an exception escapes its round, or
               :meth:`fail_worker`), the controller re-submits each request
               it lost, from its own pristine copy, to a survivor.  The
               tokens do not change: sampling is keyed by (uid, position),
               so the client's stream resumes where it stopped.
  the ledger   a fleet-level status ledger kept at the routing layer
               (enqueued, first-token and finished in fleet rounds and wall
               seconds, placement, handoffs, reroutes): what a client of
               the cluster sees, beside the workers' own ledgers.

A request's tokens equal a single direct engine's for any replica count,
router policy, disaggregation split or failure schedule: each mechanism
above moves where work runs, and the engine's outputs do not depend on
that.

:class:`AsyncClusterFrontend` wraps a controller in the shape of
``serve.async_engine.AsyncServeEngine``: one ``TokenStream`` a request,
and an awaitable ``submit()`` that holds a request while every eligible
replica's queue is at its watermark (instead of letting one replica shed
while another idles).
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

from repro_torch.serve import sla
from repro_torch.serve.async_engine import TokenStream
from repro_torch.serve.audit import AuditReport, audit_fleet
from repro_torch.serve.cluster.router import Router, route_handoff
from repro_torch.serve.cluster.worker import EngineWorker, HandoffTicket
from repro_torch.serve.engine import STATUS_OK, TERMINAL_STATUSES, Request, ServeEngine
from repro_torch.serve.faults import FaultSchedule
from repro_torch.serve.workload import TimedRequest

_DRAIN_GUARD = 100_000


class ClusterController:
    """A fleet of :class:`EngineWorker` replicas behind one router."""

    def __init__(self, workers: List[EngineWorker], router: Router, *,
                 catalog_refresh: int = 8):
        if not workers:
            raise ValueError("a cluster needs at least one worker")
        ids = [w.worker_id for w in workers]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate worker ids: {ids}")
        self.workers: Dict[Any, EngineWorker] = {w.worker_id: w for w in workers}
        self.order = ids                     # the sweep order
        self.router = router
        self.catalog_refresh = catalog_refresh
        self._validate_parity(workers)
        self.rnd = 0
        self.t0 = time.perf_counter()
        # the fleet ledger: uid -> what the cluster's client sees
        self.fleet: Dict[int, Dict[str, Any]] = {}
        self.results: Dict[int, List[int]] = {}
        self._origin: Dict[int, Request] = {}    # pristine copies (retry)
        self._current: Dict[int, Request] = {}   # the object serving uid now
        self.handoffs = 0
        self.reroutes = 0
        self.last_stats: Dict[Any, Any] = {}
        self.last_pool_stats: Dict[Any, Any] = {}
        self.audit_report: Optional[AuditReport] = None
        self._closed = False

    @staticmethod
    def _validate_parity(workers: List[EngineWorker]):
        """Equal tokens across placements need every replica to sample and
        cache alike: the same seed, temperature, length budget and page
        format.  A mismatched fleet fails here, not as a parity failure
        later."""
        def key(w: EngineWorker):
            e = w.engine
            return (e._seed, e.temperature, e.max_seq, e.page_size, e.kv_dtype, e.spec_k)

        keys = {key(w) for w in workers}
        if len(keys) != 1:
            raise ValueError(
                "replicas disagree on (seed, temperature, max_seq, page_size, "
                f"kv_dtype, spec_k): {sorted(map(str, keys))}; outputs would "
                "depend on placement")

    # ------------------------------------------------------------ placement
    def _stats(self) -> Dict[Any, Any]:
        return {wid: w.stats() for wid, w in self.workers.items() if w.alive}

    def _prefill_capable(self) -> List[Any]:
        return [wid for wid in self.order
                if self.workers[wid].alive
                and self.workers[wid].role in ("prefill", "mixed")]

    def submit(self, req: Request):
        """Route a fresh request to a replica and enter it in the fleet
        ledger."""
        self._require_open()
        if req.uid in self.fleet:
            raise ValueError(f"duplicate request uid {req.uid}")
        wid = self.router.route(req, self._stats(), eligible=self._prefill_capable())
        self.fleet[req.uid] = {
            "status": None, "worker": wid, "enqueued_round": self.rnd,
            "enqueued_s": time.perf_counter() - self.t0, "handoffs": 0, "reroutes": 0,
        }
        self._origin[req.uid] = dataclasses.replace(req, generated=None)
        self._current[req.uid] = req
        self.workers[wid].submit(req)

    # ------------------------------------------------------------- stepping
    def step(self):
        """One fleet round: every live worker steps once (id order),
        handoff tickets are routed and delivered, terminal statuses and
        first tokens enter the fleet ledger, and the prefix catalog
        refreshes from the replicas' advertised keys."""
        self._require_open()
        self.rnd += 1
        for wid in self.order:
            w = self.workers[wid]
            if not w.alive or not (w.has_work or w.lost):
                continue
            try:
                tickets = w.step()
            except Exception as exc:   # noqa: BLE001 - a replica's death
                self._handle_death(wid, exc)
                continue
            for ticket in tickets:
                self._deliver_handoff(ticket)
        # the refresh runs while pipelined workers' steps are in flight:
        # walking the host-side radix indexes rides under the device work
        if self.catalog_refresh and self.rnd % self.catalog_refresh == 0:
            for wid in self.order:
                w = self.workers[wid]
                if w.alive:
                    self.router.advertise(wid, w.prefix_keys())
        for wid in self.order:
            if self.workers[wid].alive:
                self._collect(wid)
        self._watch_first_tokens()

    def _deliver_handoff(self, ticket: HandoffTicket):
        wid = route_handoff(self.order, self._stats())
        self.workers[wid].submit_handoff(ticket)
        entry = self.fleet[ticket.uid]
        entry["worker"] = wid
        entry["handoffs"] += 1
        self._current[ticket.uid] = ticket.request
        self.handoffs += 1

    def _collect(self, wid):
        for uid, status, tokens, reason in self.workers[wid].poll():
            self._record_terminal(uid, status, tokens, reason, wid)

    def _record_terminal(self, uid, status, tokens, reason, wid):
        entry = self.fleet.get(uid)
        if entry is None or entry["status"] is not None:
            return
        entry["status"] = status
        entry["finished_round"] = self.rnd
        entry["finished_s"] = time.perf_counter() - self.t0
        entry["worker"] = wid
        if reason:
            entry["reason"] = reason
        if status == STATUS_OK and tokens is not None:
            self.results[uid] = tokens
            entry["tokens"] = len(tokens)
        else:
            entry["tokens"] = 0

    def _watch_first_tokens(self):
        for uid, entry in self.fleet.items():
            if "first_token_round" in entry:
                continue
            req = self._current.get(uid)
            if req is not None and req.generated:
                entry["first_token_round"] = self.rnd
                entry["first_token_s"] = time.perf_counter() - self.t0

    # -------------------------------------------------------------- failure
    def fail_worker(self, wid, exc: Optional[BaseException] = None):
        """Kill a replica mid-serve: its requests in flight drain through
        the retry path onto the survivors."""
        self._require_open()
        w = self.workers[wid]
        if not w.alive:
            return
        w.fail(exc)
        self._handle_death(wid, exc)

    def _handle_death(self, wid, exc):
        """A replica died: accept the terminal statuses it reached before,
        then re-route everything it lost from the pristine copies."""
        w = self.workers[wid]
        lost = set(w.lost)
        for uid, status, tokens, reason in w.poll():
            if uid not in lost:
                self._record_terminal(uid, status, tokens, reason, wid)
        stats = self._stats()
        if not stats:
            raise RuntimeError(f"worker {wid} died and no replica survives") from exc
        for uid in w.lost:
            entry = self.fleet.get(uid)
            if entry is None or entry["status"] is not None:
                continue
            fresh = dataclasses.replace(self._origin[uid], generated=None)
            target = self.router.route(fresh, stats, eligible=self._prefill_capable())
            entry["worker"] = target
            entry["reroutes"] += 1
            self.reroutes += 1
            self._current[uid] = fresh
            self.workers[target].submit(fresh)

    # ------------------------------------------------------------- draining
    @property
    def pending(self) -> List[int]:
        return [uid for uid, e in self.fleet.items() if e["status"] is None]

    def drain(self):
        """Step until every fleet request is terminal."""
        guard = 0
        while self.pending:
            self.step()
            guard += 1
            if guard > _DRAIN_GUARD:
                raise RuntimeError(f"cluster failed to drain: {self.pending} still "
                                   f"pending after {guard} rounds")

    def serve(self, requests: List[Request]) -> Dict[int, List[int]]:
        """``ServeEngine.serve``'s shape: submit everything, drain, close;
        returns {uid: tokens} of the OK requests (the fleet's figures in
        ``last_stats``)."""
        for req in requests:
            self.submit(req)
        self.drain()
        return self.close()

    def run_workload(self, timed: List[TimedRequest],
                     round_time_s: float = 1.0) -> Dict[int, List[int]]:
        """Replay an arrival process on the fleet's round clock: a request
        whose arrival maps to round r is routed before round r runs."""
        self._require_open()
        arrivals = deque(sorted(timed, key=lambda t: t.arrival_s))
        guard = 0
        while arrivals or self.pending:
            while arrivals and int(arrivals[0].arrival_s / round_time_s) <= self.rnd:
                self.submit(arrivals.popleft().request)
            self.step()
            guard += 1
            if guard > _DRAIN_GUARD:
                raise RuntimeError("cluster failed to drain the workload")
        return dict(self.results)

    # -------------------------------------------------------------- closing
    def close(self) -> Dict[int, List[int]]:
        """Finalize every surviving worker's session, assemble the fleet's
        figures (``last_stats``: the fleet ledger, ``"sla"`` and
        ``"router"``; ``last_pool_stats`` by replica) and run the fleet
        audit (``audit_report``).  Idempotent."""
        if self._closed:
            return dict(self.results)
        missing = [uid for uid, e in self.fleet.items()
                   if e["status"] not in TERMINAL_STATUSES]
        if missing:
            raise RuntimeError(f"cluster requests without a terminal status: {missing}")
        per_worker = {wid: dict(w.ledger) for wid, w in self.workers.items()}
        tbt = [t for wid in self.order for t in self.workers[wid].tbt]
        self.last_stats = dict(self.fleet)
        self.last_stats["sla"] = sla.fleet_summary(
            per_worker, tbt_s=tbt, wall_s=time.perf_counter() - self.t0)
        self.last_stats["router"] = {
            "policy": self.router.policy,
            "decisions": {str(k): v for k, v in self.router.decisions.items()},
            "affinity_hits": self.router.affinity_hits,
            "handoffs": self.handoffs,
            "reroutes": self.reroutes,
            "rounds": self.rnd,
        }
        for wid in self.order:
            w = self.workers[wid]
            if w.alive:
                w.finalize()
        self.last_pool_stats = {wid: w.manager.stats() for wid, w in self.workers.items()
                                if w.manager is not None}
        self.audit_report = audit_fleet({wid: w.manager for wid, w in self.workers.items()})
        self._closed = True
        return dict(self.results)

    def _require_open(self):
        if self._closed:
            raise RuntimeError("cluster controller already closed")


class AsyncClusterFrontend:
    """A streaming front end over a :class:`ClusterController`, in the
    shape of ``AsyncServeEngine``: ``submit()`` returns a
    ``TokenStream``, the controller steps on the event loop, and with
    ``backpressure_watermark`` a submission waits while every
    prefill-capable replica's queue is at or above it (the fleet's version
    of the single engine's awaitable backpressure)."""

    def __init__(self, controller: ClusterController, *,
                 backpressure_watermark: Optional[int] = None,
                 idle_poll_s: float = 0.002):
        self.controller = controller
        self.backpressure_watermark = backpressure_watermark
        self.idle_poll_s = idle_poll_s
        self._streams: Dict[int, TokenStream] = {}
        self._open: set = set()
        self._task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._round_evt = asyncio.Event()
        self._closing = False
        self._error: Optional[BaseException] = None

    async def __aenter__(self) -> "AsyncClusterFrontend":
        self._ensure_started()
        return self

    async def __aexit__(self, exc_type, exc, tb):
        if exc_type is None:
            await self.close()
        else:
            self._closing = True
            self._wake.set()

    def _ensure_started(self):
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    # ------------------------------------------------------------- requests
    async def submit(self, request: Request) -> TokenStream:
        self._ensure_started()
        self._check_live()
        if self.backpressure_watermark is not None:
            while self._saturated():
                self._round_evt.clear()
                self._wake.set()
                await self._round_evt.wait()
                self._check_live()
        stream = TokenStream(request.uid)
        self._streams[request.uid] = stream
        self._open.add(request.uid)
        self.controller.submit(request)
        self._wake.set()
        return stream

    def _saturated(self) -> bool:
        c = self.controller
        depths = [c.workers[wid].stats().queue_depth for wid in c._prefill_capable()]
        return bool(depths) and min(depths) >= self.backpressure_watermark

    def _check_live(self):
        if self._error is not None:
            raise RuntimeError("cluster session already failed") from self._error
        if self._closing:
            raise RuntimeError("cluster session is closing")

    async def close(self) -> Dict[int, List[int]]:
        if self._task is None:
            return {}
        self._closing = True
        self._wake.set()
        await self._task
        if self._error is not None:
            raise self._error
        return self.controller.close()

    # ------------------------------------------------------------- the loop
    async def _run(self):
        c = self.controller
        try:
            while True:
                if not c.pending:
                    if self._closing:
                        break
                    await self._idle_wait()
                    if not c.pending:
                        continue
                c.step()
                self._publish()
                self._round_evt.set()
                await asyncio.sleep(0)
        except BaseException as exc:   # noqa: BLE001 - close() re-raises it
            self._error = exc
            for uid in list(self._open):
                self._streams[uid]._fail(exc)
                self._open.discard(uid)
        finally:
            self._round_evt.set()

    async def _idle_wait(self):
        self._wake.clear()
        try:
            await asyncio.wait_for(self._wake.wait(), self.idle_poll_s)
        except asyncio.TimeoutError:
            pass

    def _publish(self):
        c = self.controller
        for uid in list(self._open):
            stream = self._streams[uid]
            entry = c.fleet.get(uid)
            if entry is None:
                continue
            status = entry["status"]
            if status is None or status == STATUS_OK:
                req = c._current.get(uid)
                gen = (req.generated or []) if req is not None else []
                while stream._sent < len(gen):
                    stream._push(gen[stream._sent])
                    stream._sent += 1
            if status is not None:
                stream._close(status, entry.get("reason"))
                self._open.discard(uid)


def make_cluster(model, params, *, replicas: int = 2,
                 router_policy: str = "cache-aware", disaggregate: bool = False,
                 prefill_workers: int = 1, share_engine: bool = True,
                 faults_seed: Optional[int] = None,
                 worker_faults: Optional[Dict[Any, Any]] = None,
                 catalog_refresh: int = 8, **engine_kw) -> ClusterController:
    """A fleet: ``replicas`` workers over identically configured paged
    engines, a router with ``router_policy``, and a controller.

    Each worker gets a ``ServeEngine`` of its own: the port's engine holds
    one session's device state (pool, block tables, ``tok``/``pos``,
    captured steps read by address), so two workers on one engine would
    zero each other's pools.  The engines all run the same ``model`` over
    the same ``params`` tensors, so no weight is copied; each has its own
    pool and captured graphs.  ``share_engine`` (the reference's flag,
    default True) also shares the first engine's preemption cost model
    with the others, so ``preempt_calibrate=True`` measures once; with
    False each engine is built from ``engine_kw`` alone.

    ``disaggregate=True`` splits roles: the first ``prefill_workers``
    replicas only prefill (their sessions never decode) and the rest only
    decode, joined by ``SwapHandle`` handoff.  ``faults_seed`` gives each
    worker its own deterministic schedule
    (``FaultSchedule.random_for_worker``); ``worker_faults`` maps worker
    id -> schedule for a hand-built one."""
    if replicas < 1:
        raise ValueError(f"need >= 1 replica; got {replicas}")
    if disaggregate and replicas < 2:
        raise ValueError("disaggregation needs >= 2 replicas (at least one "
                         "prefill and one decode)")
    if disaggregate and not 1 <= prefill_workers < replicas:
        raise ValueError(f"prefill_workers must be in [1, {replicas - 1}]; "
                         f"got {prefill_workers}")
    engine_kw.setdefault("cache_layout", "paged")
    engines = [ServeEngine(model, params, **engine_kw)]
    kw = dict(engine_kw)
    if share_engine:
        kw.update(cost_model=engines[0].cost_model, preempt_calibrate=False)
    engines += [ServeEngine(model, params, **kw) for _ in range(replicas - 1)]
    workers = []
    for i in range(replicas):
        role = ("prefill" if i < prefill_workers else "decode") if disaggregate else "mixed"
        faults = None
        if worker_faults is not None:
            faults = worker_faults.get(i)
        elif faults_seed is not None:
            faults = FaultSchedule.random_for_worker(faults_seed, i)
        workers.append(EngineWorker(i, engines[i], role=role, faults=faults))
    router = Router([w.worker_id for w in workers], policy=router_policy,
                    page_size=engines[0].page_size)
    return ClusterController(workers, router, catalog_refresh=catalog_refresh)
