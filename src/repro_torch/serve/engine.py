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

Admitted requests of the dense family prefill together as one
right-padded batch (bucketed to ``PROMPT_BLOCK``; each row's logits are
taken at its last real token).  An MoE request prefills alone at its
exact length: its experts' capacity depends on the row's length, so
padding would change its output.
Each decode step reads attention only up to the live prefix (``attend_len``
bucketed to ``ATTEND_BLOCK``) and makes one device-to-host copy: the
(tokens, done, bad) triple.  A row whose logits are not finite is failed
on its own; the rest of the batch goes on.

Speculative decoding (``spec_k > 1``, paged layout) replaces the one-token
step with a propose + verify window (``serve.spec_decode``): a draft
proposes spec_k - 1 tokens, the target scores all spec_k positions in one
``decode_verify_step``, and the longest prefix matching the target's own
greedy tokens commits, 1..spec_k tokens per step, the same tokens as
non-speculative decode.  Requests with ``spec=False`` ride the same batch
committing one token per step.  The window's page span is mapped before
the step and blocks holding only rejected rows are retracted after it
(a table edit, no copies).  The step's one device-to-host copy is then
(window tokens, commit counts, done, bad).  A governor turns speculation
off for a request whose recent windows commit one token each, and back
on after a cooldown.

Tiered KV memory (paged layout).  ``kv_dtype="int8"`` stores the pool
quantized: int8 values plus one f32 scale per cached row, quantized on
every cache write and dequantized inside both paged attention kernels (and
their plain versions).  Per-row scales make the stored bytes a pure
function of the cached values: a swap resume restores the very bytes the
slot held, and a requeue's recompute stores the bytes of an uninterrupted
run wherever it computes the same values.  (A prefill at another batch
shape may round its matmuls otherwise in the last bits, and one int8
rounding then moves a value by a whole quantization step.)
``preempt="swap"`` pages a
victim's pages out to host buffers before its slot releases them and, at
re-admission, restores them into fresh pages with no prefill;
``preempt="auto"`` takes the swap when moving a resident token's bytes
(``cost_model.swap_gbps``) costs less than recomputing it (2 * parameters
FLOPs over ``cost_model.decode_flops_s``), as the reference decides.

Not ported yet: sampling at temperature > 0 (ROADMAP A6), the overlapped
pipeline and its asynchronous swap copies (A6b), measured cost models
(``preempt_calibrate``, A11), prefix sharing (A9b), chunked prefill,
faults and recovery, priorities and deadlines.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.optim.optimizer import leaves
from repro_torch.serve import calibrate, spec_decode
from repro_torch.serve.kv_cache import (
    CACHE_LAYOUTS,
    PagedCacheManager,
    SwapHandle,
    blocks_for,
    cdiv,
    resolve_kv_dtype,
    scatter_prefill,
    swap_in_pages,
    write_slots,
)

STATUS_OK = "ok"
STATUS_FAILED = "failed"

# preemption-resume policies: requeue recomputes the victim's cache from
# its folded prompt at re-admission; swap pages it to host buffers and
# restores it; auto picks by the cost model
PREEMPT_POLICIES = ("requeue", "swap", "auto")


# shape buckets: attention reads the live prefix rounded up to
# ATTEND_BLOCK positions, admission pads prompts to PROMPT_BLOCK tokens
ATTEND_BLOCK = 64
PROMPT_BLOCK = 16
# acceptance governor: a request whose last SPEC_DISABLE_WINDOW windows
# committed one token each stops speculating for SPEC_COOLDOWN steps
SPEC_DISABLE_WINDOW = 8
SPEC_COOLDOWN = 16
# families for which right-padded, batched prefill is exact (the cache is
# purely positional and nothing but causal attention mixes tokens); MoE
# capacity and grouping depend on the padded length, so the other
# families prefill one request at a time at its exact length
_PADDED_PREFILL_FAMILIES = ("dense",)


def _round_up(x: int, block: int) -> int:
    """x rounded up to a positive multiple of block (shape bucketing)."""
    return max(block, -(-x // block) * block)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    generated: Optional[List[int]] = None
    # take part in speculative windows when the engine runs spec_k > 1;
    # spec=False requests share the batch committing one token per step
    spec: bool = True
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
    swaps: Dict[int, SwapHandle] = dataclasses.field(default_factory=dict)
    draft_cache: Any = None    # speculative decoding: dense draft slot pool
    spec_mask: Any = None      # speculative decoding: per-slot spec flag
    spec_hist: Dict[int, deque] = dataclasses.field(default_factory=dict)
    spec_disabled: Dict[int, int] = dataclasses.field(default_factory=dict)


class ServeEngine:
    def __init__(self, model, params, *, max_seq: int, batch_slots: int,
                 temperature: float = 0.0, cache_layout: str = "dense",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None, preempt: str = "requeue",
                 spec_k: int = 1, draft=None,
                 verify_backend: Optional[str] = None,
                 cost_model: Optional[calibrate.CostModel] = None,
                 preempt_calibrate: bool = False):
        if temperature > 0.0:
            raise NotImplementedError(
                "sampling at temperature > 0 needs the reference's threefry "
                "(uid, position) keys and is not ported yet (ROADMAP A6)")
        if cache_layout not in CACHE_LAYOUTS:
            raise ValueError(f"cache_layout must be one of {CACHE_LAYOUTS}; "
                             f"got {cache_layout!r}")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1; got {spec_k}")
        if spec_k > 1 and cache_layout != "paged":
            raise ValueError("speculative decoding (spec_k > 1) verifies "
                             "against the paged cache; pass "
                             "cache_layout='paged'")
        resolve_kv_dtype(kv_dtype, torch.bfloat16)   # validates the flag early
        if kv_dtype not in (None, "auto") and cache_layout != "paged":
            raise ValueError("kv_dtype selects the paged pool's storage "
                             "format; pass cache_layout='paged'")
        if preempt not in PREEMPT_POLICIES:
            raise ValueError(f"preempt must be one of {PREEMPT_POLICIES}; "
                             f"got {preempt!r}")
        if preempt != "requeue" and cache_layout != "paged":
            raise ValueError("swap-tier preemption pages the paged pool "
                             "to host; pass cache_layout='paged'")
        if cost_model is None and preempt_calibrate:
            raise NotImplementedError(
                "measuring the swap bandwidth and decode rate on the card "
                "is not ported yet (ROADMAP A11); pass cost_model=")
        model.uses_kernel(verify_backend, "verify_backend")   # validates
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
        self.kv_dtype = kv_dtype
        self.preempt = preempt
        self.cost_model = cost_model or calibrate.DEFAULT_COST_MODEL
        # preempt="auto": recompute costs ~2 * params FLOPs a token
        self._n_params = sum(t.numel() for t in leaves(params))
        self.spec_k = spec_k
        self.draft_model = self.draft_params = None
        if spec_k > 1:
            self.draft_model, self.draft_params = spec_decode.resolve_draft(
                model, params, draft)
            self._spec_step = spec_decode.build_spec_step(
                model, self.draft_model, max_seq=max_seq, spec_k=spec_k,
                verify_backend=verify_backend)
        # observability, refreshed by every serve() call
        self.last_stats: Dict[Any, Any] = {}
        self.last_pool_stats = None
        # (uids, bucket, prompt lengths) of every prefill call of the last
        # serve(), in order
        self.last_prefill_groups: List[tuple] = []
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
        self.last_prefill_groups = []
        self.preemptions = 0
        for req in requests:
            if req.uid in st.stats:
                raise ValueError(f"duplicate request uid {req.uid}")
            st.stats[req.uid] = {"status": None, "preemptions": 0}
            st.queue.append(req)
        if self.cache_layout == "paged":
            st.mgr = PagedCacheManager(self.num_pages, self.page_size,
                                       self.slots, self.max_seq,
                                       kv_dtype=self.kv_dtype)
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
        # a speculative window transiently maps up to spec_k - 1 positions
        # past the final token; charge them so the grow span can always be
        # granted to a lone request
        if st.mgr is not None and not st.mgr.fits_worst_case(
                len(req.prompt), req.max_new_tokens + self.spec_k - 1,
                self.max_seq):
            longest = min(len(req.prompt) + req.max_new_tokens
                          + self.spec_k - 2, self.max_seq)
            raise ValueError(
                f"request {req.uid} can never fit: needs "
                f"{blocks_for(longest, self.page_size)} pages "
                + (f"(incl. the spec_k={self.spec_k} window overhang) "
                   if self.spec_k > 1 else "")
                + f", pool has {st.mgr.allocator.usable}")

    def _init_device(self, st: _SchedState):
        if st.mgr is not None:
            st.pool = self.model.init_cache(
                self.slots, self.max_seq, layout="paged",
                page_size=self.page_size, num_pages=self.num_pages,
                kv_dtype=self.kv_dtype)
            st.pool.pop("block_tables")  # the manager owns the mapping
            st.bt_dev = st.mgr.device_tables(self.device)
        else:
            st.cache = self.model.init_cache(self.slots, self.max_seq)
        zeros = dict(dtype=torch.int32, device=self.device)
        st.pos = torch.zeros(self.slots, **zeros)
        st.tok = torch.zeros(self.slots, **zeros)
        st.remaining = torch.zeros(self.slots, **zeros)
        st.slot_pos = [0] * self.slots
        if self.spec_k > 1:
            st.draft_cache = self.draft_model.init_cache(self.slots, self.max_seq)
            st.spec_mask = torch.zeros(self.slots, dtype=torch.bool,
                                       device=self.device)

    def _round(self, st: _SchedState):
        """One scheduler round: admission, page growth (paged), one decode
        step for every slot."""
        self._admit(st)
        if st.live and st.mgr is not None:
            self._grow_or_preempt(st)
        if st.live:
            if self.spec_k > 1:
                self._step_spec(st)
            else:
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

    def _step_spec(self, st: _SchedState):
        """Speculative twin of :meth:`_step`: one propose + verify + accept
        step commits 1..spec_k tokens per live slot, then the one host
        transfer (window tokens, commit, done, bad) per slot.  Pages
        mapped for the window whose rows were all rejected go back to the
        allocator (write-then-retract)."""
        needed = max(st.slot_pos[s] for s in st.live) + self.spec_k
        attend = self._attend_len(needed)
        if st.mgr.dirty:
            st.bt_dev = st.mgr.device_tables(self.device)
        (targets, commit, st.tok, st.pos, st.remaining, done,
         bad) = self._spec_step(
            self.params, self.draft_params, st.pool, st.draft_cache, st.bt_dev,
            st.tok, st.pos, st.remaining, st.spec_mask, attend)
        host = torch.cat([targets, torch.stack(
            [commit, done.to(torch.int32), bad.to(torch.int32)], dim=1)],
            dim=1).cpu().numpy()
        targets_h, (commit_h, done_h, bad_h) = host[:, :-3], host[:, -3:].T
        now = time.perf_counter() - st.t0
        for slot, req in list(st.live.items()):
            if bad_h[slot]:
                self._fail(st, slot, req, "nan-logits")
                continue
            c = int(commit_h[slot])
            req.generated.extend(int(x) for x in targets_h[slot, :c])
            st.slot_pos[slot] += c
            s = st.stats[req.uid]
            s["spec_steps"] = s.get("spec_steps", 0) + 1
            s["spec_tokens"] = s.get("spec_tokens", 0) + c
            self._spec_governor(st, slot, req, c)
            if done_h[slot]:
                self._finish(st, slot, now)
            else:
                st.mgr.retract_above(slot, st.slot_pos[slot])
        self._spec_cooldown_tick(st)

    def _spec_governor(self, st: _SchedState, slot: int, req: Request,
                       committed: int):
        """Per-request acceptance governor: when a speculating request's
        last SPEC_DISABLE_WINDOW windows averaged <= 1 committed token, its
        draft is wasted work; turn speculation off for it (it commits one
        token per step, like spec=False) for SPEC_COOLDOWN steps."""
        if not req.spec or req.uid in st.spec_disabled:
            return
        hist = st.spec_hist.setdefault(req.uid, deque(maxlen=SPEC_DISABLE_WINDOW))
        hist.append(committed)
        if len(hist) == SPEC_DISABLE_WINDOW and sum(hist) <= len(hist):
            st.spec_mask[slot] = False
            st.spec_disabled[req.uid] = SPEC_COOLDOWN
            s = st.stats[req.uid]
            s["spec_auto_disables"] = s.get("spec_auto_disables", 0) + 1
            hist.clear()

    def _spec_cooldown_tick(self, st: _SchedState):
        """Advance the cooldowns; an expired one re-arms its request's
        speculative flag if the request is still live."""
        for uid in list(st.spec_disabled):
            st.spec_disabled[uid] -= 1
            if st.spec_disabled[uid] <= 0:
                del st.spec_disabled[uid]
                for slot, req in st.live.items():
                    if req.uid == uid and req.spec:
                        st.spec_mask[slot] = True

    def _finish(self, st: _SchedState, slot: int, now: float):
        req = st.live.pop(slot)
        st.results[req.uid] = req.generated
        if st.mgr is not None:
            st.mgr.release(slot)
        st.spec_hist.pop(req.uid, None)
        s = st.stats[req.uid]
        s.update(status=STATUS_OK, finished_s=now, tokens=len(req.generated))
        if s.get("spec_steps"):
            # mean committed tokens per window (1..spec_k)
            s["accept_rate"] = s["spec_tokens"] / s["spec_steps"]

    def _fail(self, st: _SchedState, slot: int, req: Request, reason: str):
        st.live.pop(slot, None)
        if st.mgr is not None:
            st.mgr.release(slot)
        st.spec_hist.pop(req.uid, None)
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
            if st.mgr is not None and req.uid in st.swaps:
                # a host-swapped resume restores its pages instead of
                # prefilling; blocked exactly like a too-big prompt
                if not self._admit_swapped_row(st, slot, req):
                    break
                continue
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
            self._bookkeep_admit(st, slot, req, t_admit)
        if self.model.cfg.family in _PADDED_PREFILL_FAMILIES:
            longest = max(len(r.prompt) for _, r in taken)
            self._prefill_group(st, taken, min(self.max_seq,
                                               _round_up(longest, PROMPT_BLOCK)))
        else:
            for slot, req in taken:
                self._prefill_group(st, [(slot, req)], len(req.prompt))
        for slot, req in taken:
            self._finish_admission(st, slot, req)

    def _bookkeep_admit(self, st: _SchedState, slot: int, req: Request,
                        t_admit: float):
        """Admission bookkeeping shared by prefill and swap resumes."""
        # only a preemption resume keeps its generated prefix;
        # re-serving the same Request objects starts fresh
        if id(req) not in st.resumed:
            req.generated = []
        st.live[slot] = req
        st.admit_seq[slot] = st.next_seq
        st.next_seq += 1
        st.slot_pos[slot] = len(req.prompt)
        st.stats[req.uid].setdefault("admitted_s", t_admit)

    def _finish_admission(self, st: _SchedState, slot: int, req: Request):
        """First-token time, and completion of a budget the admission
        already exhausted (no-op for a request prefill failed)."""
        if st.stats[req.uid]["status"] is not None:
            return
        now = time.perf_counter() - st.t0
        st.stats[req.uid].setdefault("first_token_s", now)
        if req.max_new_tokens - len(req.generated) <= 0:
            self._finish(st, slot, now)

    def _admit_swapped_row(self, st: _SchedState, slot: int, req: Request) -> bool:
        """Resume a host-swapped request: map fresh pages under the
        growth-page headroom of the live slots, write the saved pages
        back, and re-arm the slot as it stood at preemption, with no
        prefill and no sampling.  The pending token (``generated[-1]``,
        the folded prompt's last) re-arms as ``tok`` at position
        ``handle.n_tokens``, so the next step replays the step the
        preemption interrupted.  False when the pool cannot grant the
        pages yet (admission blocks, as for a too-big prompt)."""
        handle = st.swaps[req.uid]
        if st.mgr.allocator.free - len(st.live) < handle.n_blocks:
            return False
        pages = st.mgr.admit_swapped(slot, handle)
        if pages is None:
            return False
        del st.swaps[req.uid]
        st.queue.popleft()
        swap_in_pages(st.pool, handle.data, pages)
        self._bookkeep_admit(st, slot, req, time.perf_counter() - st.t0)
        n = handle.n_tokens
        st.slot_pos[slot] = n          # _bookkeep_admit assumed a prefill
        st.pos[slot] = n
        st.tok[slot] = int(req.prompt[-1])
        # no token samples at a swap resume, so no -1 here: the requeue
        # path's prefill charges its sample against this same budget
        st.remaining[slot] = req.max_new_tokens - len(req.generated)
        if self.spec_k > 1:
            st.spec_mask[slot] = bool(req.spec) and req.uid not in st.spec_disabled
            # the draft's dense cache died with the slot: prefill it again
            # from the folded prompt (the draft only steers acceptance)
            bucket = min(self.max_seq, _round_up(len(req.prompt), PROMPT_BLOCK))
            toks = torch.zeros((1, bucket), dtype=torch.int64, device=self.device)
            toks[0, :len(req.prompt)] = torch.as_tensor(req.prompt)
            last = torch.as_tensor([len(req.prompt) - 1], device=self.device)
            _, dcache = self.draft_model.prefill(self.draft_params, toks,
                                                 self.max_seq, last)
            write_slots(st.draft_cache, dcache, [slot])
        s = st.stats[req.uid]
        s["swap_ins"] = s.get("swap_ins", 0) + 1
        self._finish_admission(st, slot, req)
        return True

    def _prefill_group(self, st: _SchedState, group: List[tuple], bucket: int):
        """One prefill for the admitted (slot, request) pairs, right-padded
        to ``bucket`` tokens; the layout's cache write, then the first
        token of each row."""
        slots = [s for s, _ in group]
        reqs = [r for _, r in group]
        lens = [len(r.prompt) for r in reqs]
        self.last_prefill_groups.append(([r.uid for r in reqs], bucket, lens))
        toks = np.zeros((len(reqs), bucket), np.int64)
        for i, r in enumerate(reqs):
            toks[i, :lens[i]] = r.prompt
        last_pos = torch.as_tensor([n - 1 for n in lens], device=self.device)
        toks = torch.as_tensor(toks, device=self.device)
        logits, pcache = self.model.prefill(self.params, toks, bucket, last_pos)
        if st.mgr is not None:
            n_blocks = cdiv(bucket, self.page_size)
            page_idx = np.stack([st.mgr.prefill_page_idx(s, n_blocks)
                                 for s in slots])
            scatter_prefill(st.pool, pcache, torch.as_tensor(page_idx))
        else:
            # positions past the bucket keep an earlier occupant's rows;
            # decode writes each position before any read reaches it
            write_slots(st.cache, pcache, slots)
        if self.spec_k > 1:
            # the draft proposes from its own dense cache: prefill it from
            # the same padded batch (its logits are dropped; the first
            # token is the target's), zeros to max_seq as the reference's
            _, dcache = self.draft_model.prefill(self.draft_params, toks,
                                                 self.max_seq, last_pos)
            write_slots(st.draft_cache, dcache, slots)
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        finite = torch.isfinite(logits).all(dim=-1)
        idx = torch.as_tensor(slots, device=self.device)
        if self.spec_k > 1:
            st.spec_mask[idx] = torch.as_tensor(
                [r.spec and r.uid not in st.spec_disabled for r in reqs],
                device=self.device)
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
        """Step boundary: every live slot's next write span must be mapped,
        one position for plain decode and ``spec_k`` for a speculative
        window (positions past max_seq need no page; their writes land in
        the trash page).  Grow on demand, oldest first; when the pool runs
        out, preempt the newest live request (LIFO: the oldest always makes
        progress)."""
        for slot in sorted(st.live, key=lambda s: st.admit_seq[s]):
            while slot in st.live:
                first = st.slot_pos[slot]
                if st.mgr.ensure_span(slot, first, first + self.spec_k - 1):
                    break
                self._preempt(st, max(st.live, key=lambda s: st.admit_seq[s]))

    def _swap_wins(self, st: _SchedState) -> bool:
        """Should this preemption take the swap tier?  Both resume costs
        are linear in the victim's resident tokens, so ``auto`` compares
        per token: pool bytes over the link's rate against ~2 * params
        FLOPs over the decode rate (``self.cost_model``)."""
        if self.preempt != "auto":
            return self.preempt == "swap"
        bytes_per_token = sum(t.numel() * t.element_size()
                              for t in st.pool.values()) / (
            st.pool["k_pages"].shape[1] * self.page_size)
        return (bytes_per_token / self.cost_model.swap_gbps
                < 2.0 * self._n_params / self.cost_model.decode_flops_s)

    def _preempt(self, st: _SchedState, slot: int):
        """Release the slot and requeue the request at the queue front on a
        copy whose prompt absorbs the tokens generated so far: re-prefilling
        it recreates the exact cache, so greedy output is unchanged.  On
        the swap tier the slot's pages go to host buffers first, and
        admission restores them instead of prefilling (the queue entry is
        the same folded copy under both policies)."""
        req = st.live.pop(slot)
        if self._swap_wins(st):
            st.swaps[req.uid] = st.mgr.swap_out(slot, st.pool, st.slot_pos[slot])
            s = st.stats[req.uid]
            s["swap_outs"] = s.get("swap_outs", 0) + 1
        else:
            st.mgr.release(slot)
        resume = dataclasses.replace(
            req, prompt=list(req.prompt) + req.generated[req.folded:],
            folded=len(req.generated))
        st.resumed.add(id(resume))
        st.queue.appendleft(resume)
        st.stats[req.uid]["preemptions"] += 1
        self.preemptions += 1
