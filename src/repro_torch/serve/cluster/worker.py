"""Engine worker: one ``ServeEngine`` session behind a narrow API.

Counterpart of ``repro.serve.cluster.worker``, the fleet's unit of
replication.  A worker owns one serving session (the ``_open_session`` /
``_round`` or ``dispatch_round`` / ``_finalize_session`` primitives the
async server drives) and answers the four messages a controller sends:

  submit    a fresh request joins this replica's waiting queue
  step      one scheduler round (admission, growth, decode)
  stats     the load snapshot the router scores (queue depth, live
            slots, free pages) and the advertised prefix keys
  migrate   detach a live request as a :class:`HandoffTicket` (the resume
            request and a placement-free ``SwapHandle``), or accept one

Roles give disaggregated prefill and decode on one engine class:

  prefill  admits prompts and samples each request's first token, but
           never decodes: the session runs ``prefill_only`` and every
           live slot is migrated out after its round.  The KV leaves as a
           ``SwapHandle``, page contents in logical block order.
  decode   accepts handoff tickets only (its queue never sees a raw
           prompt); admission restores the pages and decoding goes on as
           if the prefill had run here.
  mixed    both (a classic replica).

A worker's engine must not serve another session at the same time: the
port's engine keeps one session's device state (``ServeEngine`` raises
on a second open session), so each worker has an engine of its own.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.serve.engine import Request, ServeEngine

ROLES = ("prefill", "decode", "mixed")


@dataclasses.dataclass
class HandoffTicket:
    """A live request leaving one replica for another.

    ``request`` is the folded resume copy (generated tokens folded into
    the prompt; it shares the growing ``generated`` list with the
    original, so the destination appends to the stream the client already
    holds).  ``handle`` carries the KV pages placement-free; None means
    the pages died with the source replica and the destination prefills
    the folded prompt again (the same tokens either way).  ``carry`` is
    the source's ledger entry, whose counters the destination
    inherits."""
    uid: int
    request: Request
    handle: Any
    carry: Dict[str, Any]
    src: Any


@dataclasses.dataclass
class WorkerStats:
    """One replica's load snapshot: what the router scores."""
    worker_id: Any
    role: str
    alive: bool
    queue_depth: int
    live_slots: int
    prefilling: int
    free_pages: int
    total_pages: int
    rounds: int


class WorkerDead(RuntimeError):
    """A message reached a worker whose session has been torn down."""


class EngineWorker:
    """One replica: a role, an engine session and a message API."""

    def __init__(self, worker_id, engine: ServeEngine, *, role: str = "mixed",
                 faults=None):
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}; got {role!r}")
        if engine.cache_layout != "paged":
            raise ValueError("cluster workers need cache_layout='paged': "
                             "migration and disaggregation move KV as pages")
        self.worker_id = worker_id
        self.engine = engine
        self.role = role
        self.alive = True
        self.rounds = 0
        self.handoffs_out = 0
        self.handoffs_in = 0
        # uids in flight when this replica died: what the controller
        # re-routes (taken before the abort marks them failed)
        self.lost: List[int] = []
        self._st = engine._open_session([], faults)
        self._reported: set = set()   # uids whose terminal status was polled

    # ------------------------------------------------------------- messages
    def submit(self, req: Request):
        """A fresh request joins this replica's waiting queue."""
        self._require_alive()
        if self.role == "decode":
            raise ValueError(f"worker {self.worker_id} is decode-role: it "
                             "accepts handoff tickets, not raw prompts")
        self.engine._submit_open(self._st, req, now=time.perf_counter() - self._st.t0)

    def submit_handoff(self, ticket: HandoffTicket):
        """A migrated request joins mid-flight: its ``SwapHandle`` pages
        restore at admission instead of a prefill (without a handle the
        folded prompt prefills again: the same tokens)."""
        self._require_alive()
        self.engine._submit_resume(self._st, ticket.request, handle=ticket.handle,
                                   carry=ticket.carry,
                                   now=time.perf_counter() - self._st.t0)
        self.handoffs_in += 1

    def step(self) -> List[HandoffTicket]:
        """One scheduler round.  A prefill-role worker returns the tickets
        of every request whose prompt just finished (first token sampled,
        pages swapped out, slot free); other roles return [].  Whatever
        kills the round is raised, after the worker is torn down: the
        controller treats it as this replica dying."""
        self._require_alive()
        self._st.prefill_only = self.role == "prefill"
        self.rounds += 1
        try:
            # pipelined: this round's step stays in flight while the
            # controller steps the other replicas and refreshes the
            # router's catalog; it commits at the top of our next round
            # (_migrate_out commits first, so a handoff always snapshots
            # settled pages)
            if self.engine.pipeline:
                self.engine.dispatch_round(self._st)
            else:
                self.engine._round(self._st)
        except BaseException as exc:
            self.fail(exc)
            raise
        tickets: List[HandoffTicket] = []
        if self.role == "prefill":
            # every live slot holds just its prefill token: detach it
            for slot in sorted(self._st.live, key=lambda s: self._st.admit_seq[s]):
                req = self._st.live[slot]
                if req.generated:
                    tickets.append(self._detach(req.uid))
        return tickets

    def stats(self) -> WorkerStats:
        st = self._st
        alloc = st.mgr.allocator if st.mgr is not None else None
        return WorkerStats(
            worker_id=self.worker_id, role=self.role, alive=self.alive,
            queue_depth=self.engine._queue_depth(st), live_slots=len(st.live),
            prefilling=len(st.prefilling),
            free_pages=alloc.free if alloc is not None else 0,
            total_pages=alloc.usable if alloc is not None else 0,
            rounds=self.rounds)

    def prefix_keys(self) -> set:
        """The content-addressed keys of every prefix resident on this
        replica (empty without prefix sharing): the catalog's
        advertisement, hashes only."""
        st = self._st
        if st.mgr is None or st.mgr.index is None:
            return set()
        return st.mgr.index.prefix_keys()

    # ------------------------------------------------------------ migration
    def _detach(self, uid: int) -> HandoffTicket:
        resume, handle, carry = self.engine._migrate_out(self._st, uid)
        self.handoffs_out += 1
        return HandoffTicket(uid=uid, request=resume, handle=handle, carry=carry,
                             src=self.worker_id)

    def migrate_out(self, uid: int) -> HandoffTicket:
        """Detach a live request for rebalancing (the controller routes the
        ticket to another replica)."""
        self._require_alive()
        if not any(r.uid == uid for r in self._st.live.values()):
            raise ValueError(f"uid {uid} is not live on worker {self.worker_id} "
                             "(only live requests have a complete page image "
                             "to migrate)")
        return self._detach(uid)

    # ------------------------------------------------------------ lifecycle
    def poll(self) -> List[Tuple[int, str, Optional[List[int]], Any]]:
        """Requests that reached a terminal status since the last poll:
        ``(uid, status, tokens or None, reason)``, tokens for OK requests
        only, as ``serve()`` returns them."""
        out = []
        for uid, s in self._st.stats.items():
            if not isinstance(uid, int) or uid in self._reported:
                continue
            status = s.get("status")
            if status is None:
                continue
            self._reported.add(uid)
            tokens = self._st.results.get(uid)
            out.append((uid, status, list(tokens) if tokens is not None else None,
                        s.get("reason")))
        return out

    def inflight(self) -> List[int]:
        """Uids registered here and not terminal yet: what the controller
        re-routes if this replica dies."""
        return [uid for uid, s in self._st.stats.items()
                if isinstance(uid, int) and s.get("status") is None]

    def fail(self, exc: Optional[BaseException] = None):
        """Tear the replica down (an injected death or an escaped round
        error): every request in flight ends failed, every slot and page
        is released and the pool audits clean; the controller re-routes
        from its own record.  Closes the engine's session."""
        if not self.alive:
            return
        self.lost = self.inflight()
        self.alive = False
        self.engine._abort(self._st, exc if exc is not None
                           else RuntimeError(f"worker {self.worker_id} killed"))

    def finalize(self) -> Dict[int, List[int]]:
        """Close the session (every request must be terminal) and return
        the OK outputs.  A dead worker's session was unwound by
        :meth:`fail`; its results stay readable."""
        if not self.alive:
            return dict(self._st.results)
        self.alive = False
        return self.engine._finalize_session(self._st)

    # --------------------------------------------------------- introspection
    @property
    def ledger(self) -> Dict[Any, Any]:
        """This replica's session ledger (one entry per request)."""
        return self._st.stats

    @property
    def tbt(self) -> List[float]:
        return self._st.tbt

    @property
    def manager(self):
        return self._st.mgr

    @property
    def has_work(self) -> bool:
        st = self._st
        return bool(st.queue or st.live or st.prefilling or st.pending is not None)

    def _require_alive(self):
        if not self.alive:
            raise WorkerDead(f"worker {self.worker_id} is not alive")
