"""Serving engine: continuous batching over a dense or a paged KV cache.

Counterpart of ``repro.serve.engine.ServeEngine`` with its serial round
(``pipeline=False``) and greedy sampling.  A fixed pool of batch slots
decodes together, one token per step for every slot; admission happens at
step boundaries and finished slots free at once.

  dense   one (L, slots, max_seq, H, D) pool; admission needs a free slot.
  paged   a shared (L, num_pages, page_size, H, D) pool; admission needs a
          free slot and enough free pages for the prompt (keeping one
          growth page per running slot), pages are mapped on demand as
          sequences grow, and when the pool runs out the newest request is
          preempted and requeued with its generated tokens folded into its
          prompt, so greedy outputs are unchanged.

Admitted requests prefill together as one right-padded batch (bucketed to
``PROMPT_BLOCK``; each row's logits are taken at its last real token).
Each decode step reads attention only up to the live prefix (``attend_len``
bucketed to ``ATTEND_BLOCK``) and makes one device-to-host copy: the
(tokens, done, bad) triple.  A row whose logits are not finite is failed
on its own; the rest of the batch goes on.

Not ported yet: sampling at temperature > 0 (ROADMAP A6), the overlapped
pipeline, speculative decoding, prefix sharing, int8 pages, host swap,
chunked prefill, faults and recovery, priorities and deadlines.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.kv_cache import (
    CACHE_LAYOUTS,
    PagedCacheManager,
    blocks_for,
    cdiv,
    scatter_prefill,
    write_slots,
)

STATUS_OK = "ok"
STATUS_FAILED = "failed"


# shape buckets: attention reads the live prefix rounded up to
# ATTEND_BLOCK positions, admission pads prompts to PROMPT_BLOCK tokens
ATTEND_BLOCK = 64
PROMPT_BLOCK = 16


def _round_up(x: int, block: int) -> int:
    """x rounded up to a positive multiple of block (shape bucketing)."""
    return max(block, -(-x // block) * block)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    generated: Optional[List[int]] = None
    # how many ``generated`` tokens a preemption resume already folded
    # into ``prompt`` (a second preemption folds only the rest)
    folded: int = 0


@dataclasses.dataclass
class _SchedState:
    """Per-serve() scheduler state (host bookkeeping + device slot state)."""
    queue: deque
    t0: float
    mgr: Optional[PagedCacheManager] = None
    live: Dict[int, Request] = dataclasses.field(default_factory=dict)
    results: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    stats: Dict[Any, Any] = dataclasses.field(default_factory=dict)
    admit_seq: Dict[int, int] = dataclasses.field(default_factory=dict)
    next_seq: int = 0
    resumed: set = dataclasses.field(default_factory=set)
    slot_pos: List[int] = dataclasses.field(default_factory=list)
    cache: Any = None          # dense layout: {"k", "v"}
    pool: Any = None           # paged layout: {"k_pages", "v_pages"}
    bt_dev: Any = None         # paged layout: uploaded block tables
    pos: Any = None
    tok: Any = None
    remaining: Any = None


class ServeEngine:
    def __init__(self, model, params, *, max_seq: int, batch_slots: int,
                 temperature: float = 0.0, cache_layout: str = "dense",
                 page_size: int = 16, num_pages: Optional[int] = None):
        if temperature > 0.0:
            raise NotImplementedError(
                "sampling at temperature > 0 needs the reference's threefry "
                "(uid, position) keys and is not ported yet (ROADMAP A6)")
        if cache_layout not in CACHE_LAYOUTS:
            raise ValueError(f"cache_layout must be one of {CACHE_LAYOUTS}; "
                             f"got {cache_layout!r}")
        self.model = model
        self.params = params
        self.device = model.device
        self.max_seq = max_seq
        self.slots = batch_slots
        self.cache_layout = cache_layout
        self.page_size = page_size
        if num_pages is None:
            # capacity parity with the dense pool (+1 for the trash page)
            num_pages = batch_slots * cdiv(max_seq, page_size) + 1
        self.num_pages = num_pages
        # observability, refreshed by every serve() call
        self.last_stats: Dict[Any, Any] = {}
        self.last_pool_stats = None
        self.preemptions = 0

    def _attend_len(self, needed: int) -> int:
        """Attention bound: ``needed`` rounded up to the bucket."""
        return min(self.max_seq, _round_up(needed, ATTEND_BLOCK))

    # ------------------------------------------------- continuous batching
    @torch.no_grad()
    def serve(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Waiting queue -> admission -> joint decode, until every request
        is done.  Returns {uid: generated tokens} for requests that
        finished OK; every request gets a terminal ``status`` and its
        token count in ``self.last_stats[uid]``."""
        st = _SchedState(queue=deque(), t0=time.perf_counter())
        self.last_stats = st.stats
        self.preemptions = 0
        for req in requests:
            if req.uid in st.stats:
                raise ValueError(f"duplicate request uid {req.uid}")
            st.stats[req.uid] = {"status": None, "preemptions": 0}
            st.queue.append(req)
        if self.cache_layout == "paged":
            st.mgr = PagedCacheManager(self.num_pages, self.page_size,
                                       self.slots, self.max_seq)
        for req in st.queue:
            self._check_fits(st, req)
        self._init_device(st)
        while st.queue or st.live:
            self._round(st)
        if st.mgr is not None:
            self.last_pool_stats = st.mgr.stats()
        return st.results

    def _check_fits(self, st: _SchedState, req: Request):
        """Fail fast, before any device work, on a request that could
        never complete (alone, for the paged pool)."""
        if len(req.prompt) >= self.max_seq:
            raise ValueError(
                f"request {req.uid}: prompt of {len(req.prompt)} tokens "
                f"leaves no decode room in max_seq={self.max_seq}")
        if st.mgr is not None and not st.mgr.fits_worst_case(
                len(req.prompt), req.max_new_tokens, self.max_seq):
            longest = min(len(req.prompt) + req.max_new_tokens - 1, self.max_seq)
            raise ValueError(
                f"request {req.uid} can never fit: needs "
                f"{blocks_for(longest, self.page_size)} pages, pool has "
                f"{st.mgr.allocator.usable}")

    def _init_device(self, st: _SchedState):
        if st.mgr is not None:
            st.pool = self.model.init_cache(
                self.slots, self.max_seq, layout="paged",
                page_size=self.page_size, num_pages=self.num_pages)
            st.pool.pop("block_tables")  # the manager owns the mapping
            st.bt_dev = st.mgr.device_tables(self.device)
        else:
            st.cache = self.model.init_cache(self.slots, self.max_seq)
        zeros = dict(dtype=torch.int32, device=self.device)
        st.pos = torch.zeros(self.slots, **zeros)
        st.tok = torch.zeros(self.slots, **zeros)
        st.remaining = torch.zeros(self.slots, **zeros)
        st.slot_pos = [0] * self.slots

    def _round(self, st: _SchedState):
        """One scheduler round: admission, page growth (paged), one decode
        step for every slot."""
        self._admit(st)
        if st.live and st.mgr is not None:
            self._grow_or_preempt(st)
        if st.live:
            self._step(st)

    # --------------------------------------------------------------- steps
    def _step(self, st: _SchedState):
        """Decode one token for every slot, then the one host transfer:
        (next token, done, bad) per slot, accounted to the live slots.
        Finished slots coast along inside the batch; the engine ignores
        their outputs (paged: their writes land in the trash page)."""
        attend = self._attend_len(max(st.slot_pos[s] for s in st.live) + 1)
        if st.mgr is not None:
            if st.mgr.dirty:
                st.bt_dev = st.mgr.device_tables(self.device)
            cache = dict(st.pool, block_tables=st.bt_dev)
        else:
            cache = st.cache
        logits, _ = self.model.decode_step(self.params, cache, st.tok, st.pos,
                                           attend_len=attend)
        bad = ~torch.isfinite(logits).all(dim=-1)
        st.tok = torch.argmax(logits, dim=-1).to(torch.int32)
        st.pos = st.pos + 1
        st.remaining = st.remaining - 1
        done = (st.remaining <= 0) | (st.pos >= self.max_seq - 1)
        nxt_h, done_h, bad_h = torch.stack(
            [st.tok, done.to(torch.int32), bad.to(torch.int32)]).cpu().numpy()
        now = time.perf_counter() - st.t0
        for slot, req in list(st.live.items()):
            if bad_h[slot]:
                self._fail(st, slot, req, "nan-logits")
                continue
            req.generated.append(int(nxt_h[slot]))
            st.slot_pos[slot] += 1
            if done_h[slot]:
                self._finish(st, slot, now)

    def _finish(self, st: _SchedState, slot: int, now: float):
        req = st.live.pop(slot)
        st.results[req.uid] = req.generated
        if st.mgr is not None:
            st.mgr.release(slot)
        s = st.stats[req.uid]
        s.update(status=STATUS_OK, finished_s=now, tokens=len(req.generated))

    def _fail(self, st: _SchedState, slot: int, req: Request, reason: str):
        st.live.pop(slot, None)
        if st.mgr is not None:
            st.mgr.release(slot)
        st.stats[req.uid].update(status=STATUS_FAILED, reason=reason,
                                 finished_s=time.perf_counter() - st.t0,
                                 tokens=len(req.generated or []))

    # ------------------------------------------------------------ admission
    def _admit(self, st: _SchedState):
        """Admit queued requests into free slots, FIFO.  Paged gating: a
        free slot and enough free pages for the prompt beyond one growth
        page per running or just-taken slot."""
        taken: List[tuple] = []
        for slot in range(self.slots):
            if slot in st.live or not st.queue:
                continue
            req = st.queue[0]
            if st.mgr is not None:
                if not st.mgr.can_admit(len(req.prompt),
                                        headroom=len(st.live) + len(taken)):
                    break
                if st.mgr.admit(slot, len(req.prompt)) is None:
                    break
            st.queue.popleft()
            taken.append((slot, req))
        if not taken:
            return
        t_admit = time.perf_counter() - st.t0
        for slot, req in taken:
            # only a preemption resume keeps its generated prefix;
            # re-serving the same Request objects starts fresh
            if id(req) not in st.resumed:
                req.generated = []
            st.live[slot] = req
            st.admit_seq[slot] = st.next_seq
            st.next_seq += 1
            st.slot_pos[slot] = len(req.prompt)
            st.stats[req.uid].setdefault("admitted_s", t_admit)
        self._prefill_group(st, taken)
        now = time.perf_counter() - st.t0
        for slot, req in taken:
            if st.stats[req.uid]["status"] is not None:
                continue
            st.stats[req.uid].setdefault("first_token_s", now)
            if req.max_new_tokens - len(req.generated) <= 0:
                self._finish(st, slot, now)

    def _prefill_group(self, st: _SchedState, group: List[tuple]):
        """One right-padded prefill for the admitted (slot, request) pairs,
        the layout's cache write, then the first token of each row."""
        slots = [s for s, _ in group]
        reqs = [r for _, r in group]
        lens = [len(r.prompt) for r in reqs]
        bucket = min(self.max_seq, _round_up(max(lens), PROMPT_BLOCK))
        toks = np.zeros((len(reqs), bucket), np.int64)
        for i, r in enumerate(reqs):
            toks[i, :lens[i]] = r.prompt
        last_pos = torch.as_tensor([n - 1 for n in lens], device=self.device)
        logits, pcache = self.model.prefill(
            self.params, torch.as_tensor(toks, device=self.device), bucket,
            last_pos)
        if st.mgr is not None:
            n_blocks = cdiv(bucket, self.page_size)
            page_idx = np.stack([st.mgr.prefill_page_idx(s, n_blocks)
                                 for s in slots])
            scatter_prefill(st.pool, pcache, torch.as_tensor(page_idx))
        else:
            # positions past the bucket keep an earlier occupant's rows;
            # decode writes each position before any read reaches it
            write_slots(st.cache, pcache, slots)
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        finite = torch.isfinite(logits).all(dim=-1)
        idx = torch.as_tensor(slots, device=self.device)
        st.pos[idx] = torch.as_tensor(lens, dtype=torch.int32, device=self.device)
        st.tok[idx] = first
        st.remaining[idx] = torch.as_tensor(
            [r.max_new_tokens - len(r.generated) - 1 for r in reqs],
            dtype=torch.int32, device=self.device)
        first_h, finite_h = torch.stack([first, finite.to(torch.int32)]).cpu().numpy()
        for slot, req, f, ok in zip(slots, reqs, first_h, finite_h):
            if not ok:
                self._fail(st, slot, req, "nan-logits")
                continue
            req.generated.append(int(f))

    # ----------------------------------------------------------- preemption
    def _grow_or_preempt(self, st: _SchedState):
        """Step boundary: every live slot's next write position must be
        mapped.  Grow on demand, oldest first; when the pool runs out,
        preempt the newest live request (LIFO: the oldest always makes
        progress)."""
        for slot in sorted(st.live, key=lambda s: st.admit_seq[s]):
            while slot in st.live:
                if st.mgr.ensure_block(slot, st.slot_pos[slot] // self.page_size):
                    break
                self._preempt(st, max(st.live, key=lambda s: st.admit_seq[s]))

    def _preempt(self, st: _SchedState, slot: int):
        """Release the slot and requeue the request at the queue front on a
        copy whose prompt absorbs the tokens generated so far: re-prefilling
        it recreates the exact cache, so greedy output is unchanged."""
        req = st.live.pop(slot)
        st.mgr.release(slot)
        resume = dataclasses.replace(
            req, prompt=list(req.prompt) + req.generated[req.folded:],
            folded=len(req.generated))
        st.resumed.add(id(resume))
        st.queue.appendleft(resume)
        st.stats[req.uid]["preemptions"] += 1
        self.preemptions += 1
