"""Replica routing: load scoring and content-addressed prefix affinity.

Counterpart of ``repro.serve.cluster.router``.  The router makes one
decision, which replica gets a request, from two signals:

  load      queue depth + busy slots (ties by free pages): the
            least-loaded balancer.
  affinity  how much of the prompt's page-granular prefix is resident on
            a replica, measured without moving tokens or KV: a prompt
            hashes into a chain of content-addressed keys
            (``serve.prefix_index.page_prefix_keys``), each replica
            advertises its radix index's key set, and the catalog counts
            the longest leading overlap, one set lookup a page.

Policies:

  round-robin   replicas in id order, both signals ignored: the baseline.
  least-loaded  the least (queue + live + prefilling), then the most free
                pages.
  cache-aware   affinity bonus minus load penalty: a cached prefix page
                counts like free capacity (its prefill is skipped and its
                page shared), so a warm replica wins until its queue is
                genuinely longer.

The catalog is fed optimistically at each decision (the chosen replica
will index this prompt's full pages) and authoritatively from each
worker's ``prefix_keys()`` at a refresh.  A stale optimistic entry costs
a mis-routed request some prefill, never its tokens: the engine's
sampling is keyed by (uid, position).  Scores are integers, ties break
by replica id and no clock is read, so a fleet replays its placements
exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

from repro_torch.serve.cluster.worker import WorkerStats
from repro_torch.serve.engine import Request
from repro_torch.serve.prefix_index import page_prefix_keys

ROUTER_POLICIES = ("round-robin", "least-loaded", "cache-aware")


class Router:
    """Placement policy over a fixed set of replica ids."""

    def __init__(self, worker_ids: Sequence[Any], *, policy: str = "cache-aware",
                 page_size: int = 16, affinity_weight: int = 4, load_weight: int = 1):
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"policy must be one of {ROUTER_POLICIES}; got {policy!r}")
        if not worker_ids:
            raise ValueError("router needs at least one worker id")
        self.policy = policy
        self.page_size = page_size
        # score points per cached prefix page against points per queued or
        # busy request: by default one resident page outweighs up to four
        # queued requests
        self.affinity_weight = affinity_weight
        self.load_weight = load_weight
        self.worker_ids = list(worker_ids)
        self._rr = 0
        self._catalog: Dict[Any, set] = {w: set() for w in self.worker_ids}
        self.decisions: Dict[Any, int] = {w: 0 for w in self.worker_ids}
        self.affinity_hits = 0     # decisions where an overlap was resident

    # -------------------------------------------------------------- catalog
    def advertise(self, worker_id, keys: set):
        """Authoritative refresh: a replica's entry becomes its index's
        advertised key set."""
        self._catalog[worker_id] = set(keys)

    def _note_routed(self, worker_id, keys: List[bytes]):
        """Optimistic update: the chosen replica will publish this prompt's
        full-page prefix after its prefill."""
        self._catalog[worker_id].update(keys)

    def overlap(self, worker_id, keys: Sequence[bytes]) -> int:
        """Leading pages of ``keys`` resident on ``worker_id``."""
        cat = self._catalog[worker_id]
        n = 0
        for k in keys:
            if k not in cat:
                break
            n += 1
        return n

    # ------------------------------------------------------------- routing
    def route(self, req: Request, stats: Dict[Any, WorkerStats],
              eligible: Optional[Iterable[Any]] = None) -> Any:
        """A replica for ``req`` among ``eligible`` (default: every replica
        with stats).  Placement only: the caller delivers the request, the
        router records the decision."""
        cands = [w for w in (eligible if eligible is not None else stats)
                 if w in stats and stats[w].alive]
        if not cands:
            raise RuntimeError("no eligible replica is alive")
        cands.sort(key=self.worker_ids.index)
        keys = page_prefix_keys(req.prompt, self.page_size)
        if self.policy == "round-robin":
            pick = self._round_robin(cands)
        elif self.policy == "least-loaded":
            pick = min(cands, key=lambda w: self._load_key(stats[w]))
        else:
            pick = self._cache_aware(cands, stats, keys)
        self.decisions[pick] += 1
        self._note_routed(pick, keys)
        return pick

    def _round_robin(self, cands: List[Any]) -> Any:
        # cycle the whole id space, so a fixed fleet keeps its rotation
        # while some replicas are briefly ineligible
        for _ in range(len(self.worker_ids)):
            pick = self.worker_ids[self._rr % len(self.worker_ids)]
            self._rr += 1
            if pick in cands:
                return pick
        return cands[0]

    def _load_key(self, s: WorkerStats):
        return (s.queue_depth + s.live_slots + s.prefilling, -s.free_pages,
                self.worker_ids.index(s.worker_id))

    def _cache_aware(self, cands: List[Any], stats: Dict[Any, WorkerStats],
                     keys: List[bytes]) -> Any:
        def score(w):
            s = stats[w]
            return (self.affinity_weight * self.overlap(w, keys)
                    - self.load_weight * (s.queue_depth + s.live_slots + s.prefilling))

        best = max(cands, key=lambda w: (score(w), stats[w].free_pages,
                                         -self.worker_ids.index(w)))
        if self.overlap(best, keys):
            self.affinity_hits += 1
        return best


def route_handoff(worker_ids: Sequence[Any], stats: Dict[Any, WorkerStats]) -> Any:
    """Placement of a handoff ticket: the least loaded decode-capable
    replica.  Affinity plays no part (the KV travels with the ticket):
    only room to admit and queue depth do."""
    cands = [w for w in worker_ids
             if w in stats and stats[w].alive and stats[w].role in ("decode", "mixed")]
    if not cands:
        raise RuntimeError("no decode-capable replica is alive")
    ids = list(worker_ids)
    return min(cands, key=lambda w: (
        stats[w].queue_depth + stats[w].live_slots + stats[w].prefilling,
        -stats[w].free_pages, ids.index(w)))
