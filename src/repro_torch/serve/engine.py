"""Serving engine: continuous batching over a dense or a paged KV cache.

Counterpart of ``repro.serve.engine.ServeEngine`` with its serial round
(``pipeline=False``), its sampling and ``generate``.  A fixed pool of
batch slots decodes together, one token per step for every slot;
admission happens at step boundaries and finished slots free at once.

  dense   one (L, slots, max_seq, H, D) pool; admission needs a free slot.
  paged   a shared (L, num_pages, page_size, H, D) pool; admission needs a
          free slot and enough free pages for the prompt (keeping one
          growth page per running slot), pages are mapped on demand as
          sequences grow, and when the pool runs out the newest request is
          preempted and requeued with its generated tokens folded into its
          prompt, so outputs are unchanged (greedy or sampled: see below).

Admitted requests of the dense family prefill together as one
right-padded batch (bucketed to ``PROMPT_BLOCK``; each row's logits are
taken at its last real token).  An MoE request prefills alone at its
exact length: its experts' capacity depends on the row's length, so
padding would change its output.
Each decode step reads attention only up to the live prefix (``attend_len``
bucketed to ``ATTEND_BLOCK``) and makes one device-to-host copy: its
fixed ``(3 + T, slots)`` int32 output (tokens, commit, done, bad).  A row
whose logits are not finite is failed on its own; the rest of the batch
goes on.

Sampling.  ``temperature`` 0 is greedy (argmax).  Above 0 each token is
drawn as the reference draws it (``serve.sampling``): row i's key is
``fold_in(fold_in(PRNGKey(seed), uid), P)`` with P the position the
token will occupy (``len(prompt)`` for the first token after a prefill,
pos + 1 in a decode step, pos + i + 1 in a speculative window), so a
request's tokens are a function of (seed, uid, prompt) alone: admission
order, slot count, layout, preemption (a requeued request's folded
prompt puts its next token at the same P) and speculation do not move
them.  The keys are computed on the device from a per-slot ``uids``
buffer and ``pos``, inside the captured step.

Overlapped rounds (``pipeline=True``, the default, as the reference's).
A round is split in two halves: :meth:`ServeEngine.dispatch_round`
issues the step and returns, and the next round's :meth:`commit_round`
waits for it (an event after a ``non_blocking`` copy of the output into
one pinned host buffer), accounts its tokens, and materializes the
swap-out copies queued since the last commit.  Every scheduling decision
lands on the inputs the serial round (``pipeline=False``) gives it, so
the outputs are the serial round's; a session runs one more round, which
commits the last step.  On a CUDA device the pipelined engine replays
each fixed-shape decode or verify step as one captured CUDA graph
(``serve.step_graph``, one per attend bucket); the serial engine runs
its steps eagerly, as the control.  The device state (cache or pool,
block-table buffer, ``tok``/``pos``/``remaining``, the output) lives as
long as the engine, since the graphs read it by address (``uids`` too); a session
zero-fills it in place.  Prefill and the shared suffix prefill stay
eager: their shapes change with every admission.

Speculative decoding (``spec_k > 1``, paged layout) replaces the one-token
step with a propose + verify window (``serve.spec_decode``): a draft
proposes spec_k - 1 tokens, the target scores all spec_k positions in one
``decode_verify_step``, and the longest prefix matching the target's own
tokens (greedy, or sampled with the same (uid, position) keys) commits,
1..spec_k tokens per step, the same tokens as non-speculative decode.
Requests with ``spec=False`` ride the same batch committing one token
per step.  The window's page span is mapped before
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

Prefix sharing (``prefix_sharing=True``, paged layout, dense family)
admits a prompt by resolving its longest cached page-granular prefix in a
radix index (``serve.prefix_index``) and mapping those physical pages into
the new slot's block table: no copies, a reference more in the allocator.
Requests then admit one at a time, each prompt published to the index
before the next is planned, and prefill only the un-cached suffix through
the paged cache (:meth:`Model.prefill_suffix`; a suffix of T tokens is T *
G query rows a KV head in ``paged_flash_verify``).  The admission gate
charges only the private pages, and a released request's prefix lingers
in the index as reclaimable cache (``evict_policy`` picks the victims
under allocation pressure; ``min_cached_tokens`` keeps short prompts
out).  A page-aligned prompt that matches in full forks its last page
copy-on-write.  Outputs (greedy or sampled) are those of unshared paged
serving: sharing lives below the block tables.

:meth:`ServeEngine.generate` runs an equal-length prompt batch on the
dense layout for a fixed number of tokens, row i sampling with uid i.

Not ported yet: measured cost models (``preempt_calibrate``, A11),
chunked prefill, faults and recovery, the straggler watchdog,
priorities and deadlines.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.optim.optimizer import leaves
from repro_torch.serve import calibrate, sampling, spec_decode, step_graph
from repro_torch.serve.kv_cache import (
    CACHE_LAYOUTS,
    TRASH_PAGE,
    AdmitPlan,
    PagedCacheManager,
    SwapHandle,
    TableStaging,
    blocks_for,
    cdiv,
    copy_pages,
    resolve_kv_dtype,
    scatter_prefill,
    swap_in_pages,
    write_slots,
)
from repro_torch.serve.prefix_index import EVICT_POLICIES, PrefixIndex

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


def _int32(x: int) -> int:
    """x mod 2**32 as a signed int32 value (a uid in the int32 buffer;
    the sampler reads it back as uint32, as the reference's cast does)."""
    return ((int(x) + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def sample_token(logits: torch.Tensor, key: torch.Tensor,
                 temperature: float = 0.0) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32.  temperature 0 = greedy; above
    0 one key (``sampling.prng_key``/``fold_in``) draws the whole batch,
    as ``jax.random.categorical(key, logits / T, axis=-1)``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return sampling.categorical(
        key, sampling.scale_logits(logits, temperature)).to(torch.int32)


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
class PendingRound:
    """A decode step in flight: dispatched, its output not fetched yet.
    ``live`` snapshots the dispatch-time slot -> request map, so the
    commit accounts tokens to exactly the requests the step computed them
    for.  ``event`` (CUDA) follows the output's copy into the pinned host
    buffer; the commit waits on it."""
    live: Dict[int, Request]
    spec: bool = False
    event: Any = None


def _empty_timeseries() -> Dict[str, list]:
    """Per-round pipeline phases: host time issuing the dispatch, host
    time blocked in the commit, and host work done in the gap while a
    step was in flight (0.0 when serial).  The reference's other columns
    wait for ROADMAP A6c."""
    return {"round": [], "dispatch_s": [], "commit_s": [], "overlap_s": []}


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
    uids: Any = None           # each slot's request uid (int32), the sampling keys'
    swaps: Dict[int, SwapHandle] = dataclasses.field(default_factory=dict)
    draft_cache: Any = None    # speculative decoding: dense draft slot pool
    spec_mask: Any = None      # speculative decoding: per-slot spec flag
    spec_hist: Dict[int, deque] = dataclasses.field(default_factory=dict)
    spec_disabled: Dict[int, int] = dataclasses.field(default_factory=dict)
    # prefix sharing: the (request, allocator, index) state at which the
    # queue head's gate last failed (it is not planned again until that
    # state moves)
    gate_block: Any = None
    # overlapped round pipeline
    pending: Optional[PendingRound] = None   # step dispatched, not committed
    pending_swaps: List[SwapHandle] = dataclasses.field(
        default_factory=list)   # queued swap-outs awaiting materialization
    rnd: int = -1               # scheduler round
    last_dispatch_s: float = 0.0    # this round's phase timings
    last_commit_s: float = 0.0      # (reset at every round tick)
    last_overlap_s: float = 0.0
    timeseries: Dict[str, list] = dataclasses.field(default_factory=_empty_timeseries)


class ServeEngine:
    def __init__(self, model, params, *, max_seq: int, batch_slots: int,
                 temperature: float = 0.0, seed: int = 0,
                 cache_layout: str = "dense",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None, preempt: str = "requeue",
                 prefix_sharing: bool = False, evict_policy: str = "lru",
                 min_cached_tokens: int = 0, spec_k: int = 1, draft=None,
                 verify_backend: Optional[str] = None,
                 pipeline: bool = True,
                 cost_model: Optional[calibrate.CostModel] = None,
                 preempt_calibrate: bool = False):
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
        if evict_policy not in EVICT_POLICIES:
            raise ValueError(f"evict_policy must be one of {EVICT_POLICIES}; "
                             f"got {evict_policy!r}")
        if min_cached_tokens < 0:
            raise ValueError(f"min_cached_tokens must be >= 0; "
                             f"got {min_cached_tokens}")
        if prefix_sharing:
            if cache_layout != "paged":
                raise ValueError("prefix sharing maps prompt prefixes through "
                                 "the paged block tables; pass "
                                 "cache_layout='paged'")
            if model.cfg.family not in _PADDED_PREFILL_FAMILIES:
                raise ValueError(
                    "prefix sharing resolves prompts by token ids and prefills "
                    f"only the un-cached suffix; family {model.cfg.family!r} "
                    "prefills with length-dependent expert capacity, so cached "
                    "K/V would not be exact: supported family: 'dense'")
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
        self.prefix_sharing = prefix_sharing
        self.evict_policy = evict_policy
        self.min_cached_tokens = min_cached_tokens
        self.verify_backend = verify_backend
        self.cost_model = cost_model or calibrate.DEFAULT_COST_MODEL
        # preempt="auto": recompute costs ~2 * params FLOPs a token
        self._n_params = sum(t.numel() for t in leaves(params))
        self.spec_k = spec_k
        # sampling: keys from (seed, uid, position), see serve.sampling.
        # The first token after a prefill scales as the reference's eager
        # call does (a division by T), a decode or verify step as its
        # jitted step does (a multiply by f32(1/T)); temperature 0 keeps
        # every step's argmax, so greedy graphs hold today's ops
        self.temperature = float(temperature)
        self._base_key = sampling.prng_key(seed, self.device)
        self._sampler = (sampling.StepSampler(self._base_key, self.temperature)
                         if self.temperature > 0.0 else None)
        # overlapped rounds; on a CUDA device also the captured steps.
        # pipeline=False keeps the serial, eager round: the control
        self.pipeline = pipeline
        self._graphs = step_graph.StepGraphs(self.device, enabled=pipeline)
        self._kind = step_graph.step_kind(cache_layout, kv_dtype, spec_k)
        self._dev: Optional[Dict[str, Any]] = None   # device state, see _init_device
        self._gen: Dict[int, Dict[str, Any]] = {}    # generate()'s, by batch
        self.draft_model = self.draft_params = None
        if spec_k > 1:
            self.draft_model, self.draft_params = spec_decode.resolve_draft(
                model, params, draft, seed=seed)
            self._spec_step = spec_decode.build_spec_step(
                model, self.draft_model, max_seq=max_seq, spec_k=spec_k,
                verify_backend=verify_backend, sampler=self._sampler)
        # observability, refreshed by every serve() call
        self.last_stats: Dict[Any, Any] = {}
        self.last_pool_stats = None
        # (uids, bucket, prompt lengths) of every prefill call of the last
        # serve(), in order; a suffix prefill's bucket counts the suffix's
        # tokens alone
        self.last_prefill_groups: List[tuple] = []
        self.preemptions = 0
        # graphs, captures, capture seconds and replays of the last serve()
        self.last_graph_stats: Dict[str, Any] = {}

    def _attend_len(self, needed: int) -> int:
        """Attention bound: ``needed`` rounded up to the bucket."""
        return min(self.max_seq, _round_up(needed, ATTEND_BLOCK))

    # ------------------------------------------------------------ generation
    @torch.no_grad()
    def generate(self, prompts, n_tokens: int) -> torch.Tensor:
        """prompts (B, S): an equal-length batch (ints, any array type).
        Returns (B, n_tokens) int32 tokens on the engine's device.

        Always the dense layout (one fixed batch, no scheduling: paging
        buys nothing here), whatever the engine's ``cache_layout``.  Row i
        samples with uid i: the first token at position S, then each
        decode step's at pos + 1.  The steps read fixed per-batch buffers
        and run as the engine's captured dense step (a pipelined engine on
        CUDA; one graph per batch size and attend bucket)."""
        if not isinstance(prompts, torch.Tensor):
            prompts = torch.as_tensor(np.asarray(prompts))
        prompts = prompts.to(self.device, torch.int64)
        b, s = prompts.shape
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1; got {n_tokens}")
        if s >= self.max_seq:
            raise ValueError(f"prompts of {s} tokens leave no decode room in "
                             f"max_seq={self.max_seq}")
        gen = self._gen_buffers(b)
        logits, pcache = self.model.prefill(self.params, prompts, self.max_seq)
        for name, leaf in gen["cache"].items():
            leaf.copy_(pcache[name][:, :, :self.max_seq])
        gen["uids"].copy_(torch.arange(b, dtype=torch.int32, device=self.device))
        gen["pos"].fill_(s)
        gen["tok"].copy_(sampling.sample_at(logits, gen["pos"], gen["uids"],
                                            self._base_key, self.temperature))
        gen["remaining"].fill_(n_tokens - 1)
        out = [gen["tok"].clone()]
        for i in range(n_tokens - 1):
            attend = self._attend_len(s + i + 1)
            fn = step_graph.decode_step_fn(
                self.model, self.params, gen["cache"], gen["tok"], gen["pos"],
                gen["remaining"], gen["out"], attend, self.max_seq,
                uids=gen["uids"], sampler=self._sampler)
            self._graphs.run(("generate", b, attend), fn,
                             restore=(gen["tok"], gen["pos"], gen["remaining"]))
            out.append(gen["tok"].clone())
        return torch.stack(out, dim=1)

    def _gen_buffers(self, b: int) -> Dict[str, Any]:
        """generate()'s fixed buffers for batch ``b``, kept for the
        engine's lifetime (its captured steps read them by address)."""
        gen = self._gen.get(b)
        if gen is None:
            zeros = dict(dtype=torch.int32, device=self.device)
            gen = self._gen[b] = {
                "cache": self.model.init_cache(b, self.max_seq),
                "tok": torch.zeros(b, **zeros), "pos": torch.zeros(b, **zeros),
                "remaining": torch.zeros(b, **zeros), "uids": torch.zeros(b, **zeros),
                "out": torch.zeros(4, b, **zeros)}
        return gen

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
            index = (PrefixIndex(self.page_size, policy=self.evict_policy,
                                 min_cached_tokens=self.min_cached_tokens)
                     if self.prefix_sharing else None)
            st.mgr = PagedCacheManager(self.num_pages, self.page_size,
                                       self.slots, self.max_seq,
                                       prefix_index=index, kv_dtype=self.kv_dtype)
        for req in st.queue:
            self._check_fits(st, req)
        self._init_device(st)
        g = self._graphs
        n0, t0, r0 = len(g.graphs), g.capture_s, g.replays
        if self.pipeline:
            # overlapped rounds: each round commits the previous round's
            # step before admission; a live slot keeps the loop going
            # until its step commits, so it exits with nothing pending
            while st.queue or st.live or st.pending is not None:
                self.dispatch_round(st)
        else:
            while st.queue or st.live:
                self._round(st)
        # the finalize barrier: never end a session over an in-flight
        # step or an unmaterialized swap copy
        self.commit_round(st)
        st.stats["timeseries"] = st.timeseries
        self.last_graph_stats = dict(
            enabled=g.enabled, graphs=len(g.graphs), captured=len(g.graphs) - n0,
            capture_s=g.capture_s - t0, replays=g.replays - r0,
            launches_per_replay={f"{k[0]}@{k[1]}": v for k, v in g.launches().items()})
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
        """Bind the session to the engine's device state: allocated at the
        first session, zero-filled in place at every later one (the bytes
        a fresh ``init_cache`` gives), never rebound, since captured steps
        read every buffer by address."""
        dev = self._dev
        if dev is None:
            zeros = dict(dtype=torch.int32, device=self.device)
            dev = {"tok": torch.zeros(self.slots, **zeros),
                   "pos": torch.zeros(self.slots, **zeros),
                   "remaining": torch.zeros(self.slots, **zeros),
                   "uids": torch.zeros(self.slots, **zeros),
                   # (3 + T, slots): targets, commit, done, bad
                   "out": torch.zeros(3 + self.spec_k, self.slots, **zeros),
                   "cache": None, "pool": None, "bt": None, "staging": None,
                   "draft_cache": None, "spec_mask": None}
            cuda = self.device.type == "cuda"
            dev["out_host"] = torch.zeros(dev["out"].shape, dtype=torch.int32,
                                          pin_memory=cuda)
            if self.cache_layout == "paged":
                pool = self.model.init_cache(
                    self.slots, self.max_seq, layout="paged",
                    page_size=self.page_size, num_pages=self.num_pages,
                    kv_dtype=self.kv_dtype)
                dev["bt"] = pool.pop("block_tables")   # the manager owns the mapping
                dev["staging"] = TableStaging(dev["bt"].shape, self.device)
                dev["pool"] = pool
            else:
                dev["cache"] = self.model.init_cache(self.slots, self.max_seq)
            if self.spec_k > 1:
                dev["draft_cache"] = self.draft_model.init_cache(self.slots, self.max_seq)
                dev["spec_mask"] = torch.zeros(self.slots, dtype=torch.bool,
                                               device=self.device)
            self._dev = dev
        else:
            for name in ("tok", "pos", "remaining", "uids", "out", "spec_mask"):
                if dev[name] is not None:
                    dev[name].zero_()
            for name in ("cache", "pool", "draft_cache"):
                for leaf in (dev[name] or {}).values():
                    leaf.zero_()
            if dev["bt"] is not None:
                dev["bt"].fill_(TRASH_PAGE)
        st.cache, st.pool, st.bt_dev = dev["cache"], dev["pool"], dev["bt"]
        st.tok, st.pos, st.remaining = dev["tok"], dev["pos"], dev["remaining"]
        st.uids = dev["uids"]
        st.draft_cache, st.spec_mask = dev["draft_cache"], dev["spec_mask"]
        st.slot_pos = [0] * self.slots
        if st.mgr is not None:
            self._upload_tables(st)

    def _upload_tables(self, st: _SchedState):
        """The manager's block tables into the fixed device buffer, in
        place (a queued copy from pinned memory)."""
        st.mgr.upload_tables(st.bt_dev, self._dev["staging"])

    def _round(self, st: _SchedState):
        """One serial scheduler round: admission, page growth (paged), one
        decode step for every slot, dispatched and committed at once."""
        st.rnd += 1
        st.last_dispatch_s = st.last_commit_s = st.last_overlap_s = 0.0
        if self.prefix_sharing:
            self._admit_shared(st)
        else:
            self._admit(st)
        if st.live and st.mgr is not None:
            self._grow_or_preempt(st)
        if st.live:
            self._timed_commit(st, self._timed_dispatch(st))
        self._sample_timeseries(st)

    # ----------------------------------------------------- round pipeline
    def dispatch_round(self, st: _SchedState):
        """Overlapped twin of :meth:`_round`: one round whose step is
        dispatched but not committed; the fetch happens at the top of the
        next round.  In the reference's order:

        1. the round tick;
        2. the overlap gap: host work that the in-flight step's commit
           cannot influence, run while the device computes.  Of the
           reference's gap only the tick exists here: its queue-side
           fault sweeps and queued expiry wait for ROADMAP A10, its
           admission control (shedding, watermarks) for A6c;
        3. :meth:`commit_round`: the one wait, token and terminal
           accounting, the deferred swap-out materialization;
        4. admission (needs the freed slots), growth and preemption (need
           the advanced positions and the spec retraction), then the next
           dispatch.

        The outputs are the serial round's; a session runs one more
        round, which commits the last step."""
        st.rnd += 1
        st.last_dispatch_s = st.last_commit_s = st.last_overlap_s = 0.0
        t_gap = time.perf_counter()
        if st.pending is not None:
            st.last_overlap_s = time.perf_counter() - t_gap
        self.commit_round(st)
        if st.queue or st.live:
            if self.prefix_sharing:
                self._admit_shared(st)
            else:
                self._admit(st)
            if st.live and st.mgr is not None:
                self._grow_or_preempt(st)
            if st.live:
                st.pending = self._timed_dispatch(st)
        self._sample_timeseries(st)

    def commit_round(self, st: _SchedState):
        """Commit the in-flight step, if any (popped before the wait), then
        materialize the swap-out copies queued since the last commit."""
        pending, st.pending = st.pending, None
        if pending is not None:
            self._timed_commit(st, pending)
        self._drain_swaps(st)

    def _drain_swaps(self, st: _SchedState):
        """Wait for the queued swap-out copies (device slices -> pinned
        host buffers).  Idempotent; runs at every commit boundary."""
        for handle in st.pending_swaps:
            handle.materialize()
        st.pending_swaps.clear()

    def _sample_timeseries(self, st: _SchedState):
        ts = st.timeseries
        ts["round"].append(st.rnd)
        ts["dispatch_s"].append(st.last_dispatch_s)
        ts["commit_s"].append(st.last_commit_s)
        ts["overlap_s"].append(st.last_overlap_s)

    def _timed_dispatch(self, st: _SchedState) -> PendingRound:
        """Issue one decode step; the host time it took is the round's
        ``dispatch_s``."""
        t_start = time.perf_counter()
        pending = (self._dispatch_spec(st) if self.spec_k > 1
                   else self._dispatch_step(st))
        st.last_dispatch_s = time.perf_counter() - t_start
        return pending

    def _timed_commit(self, st: _SchedState, pending: PendingRound):
        """Fetch and account one step; the host time (the wait included)
        is the round's ``commit_s``."""
        t_c = time.perf_counter()
        self._commit_step(st, pending)
        st.last_commit_s = time.perf_counter() - t_c

    # --------------------------------------------------------------- steps
    def _run_step(self, st: _SchedState, attend: int, fn) -> PendingRound:
        """Run a step over the fixed buffers (a graph replay on the
        pipelined CUDA engine), then queue the copy of its output into the
        pinned host buffer and an event after it."""
        dev = self._dev
        self._graphs.run((self._kind, attend), fn,
                         restore=(dev["tok"], dev["pos"], dev["remaining"]))
        event = None
        if self.device.type == "cuda":
            dev["out_host"].copy_(dev["out"], non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            dev["out_host"].copy_(dev["out"])
        return PendingRound(live=dict(st.live), spec=self.spec_k > 1, event=event)

    def _dispatch_step(self, st: _SchedState) -> PendingRound:
        """Launch one decode step for every slot (finished slots coast
        along inside the batch; the commit ignores their outputs, and on
        the paged layout their writes land in the trash page)."""
        attend = self._attend_len(max(st.slot_pos[s] for s in st.live) + 1)
        if st.mgr is not None:
            if st.mgr.dirty:
                self._upload_tables(st)
            cache = dict(st.pool, block_tables=st.bt_dev)
        else:
            cache = st.cache
        fn = step_graph.decode_step_fn(self.model, self.params, cache, st.tok,
                                       st.pos, st.remaining, self._dev["out"],
                                       attend, self.max_seq, uids=st.uids,
                                       sampler=self._sampler)
        return self._run_step(st, attend, fn)

    def _dispatch_spec(self, st: _SchedState) -> PendingRound:
        """Speculative twin of :meth:`_dispatch_step`: one step proposes,
        verifies and scores a 1..spec_k token window per slot; the
        committed prefix and the page retraction are the commit's."""
        attend = self._attend_len(max(st.slot_pos[s] for s in st.live) + self.spec_k)
        if st.mgr.dirty:
            self._upload_tables(st)

        def fn():
            return self._spec_step(
                self.params, self.draft_params, st.pool, st.draft_cache, st.bt_dev,
                st.tok, st.pos, st.remaining, st.uids, st.spec_mask, attend,
                self._dev["out"])

        return self._run_step(st, attend, fn)

    def _fetch(self, pending: PendingRound) -> np.ndarray:
        """The step's output on the host: waits on the copy's event."""
        if pending.event is not None:
            pending.event.synchronize()
        return self._dev["out_host"].numpy()

    def _commit_step(self, st: _SchedState, pending: PendingRound):
        """The one host transfer a step, then the token and terminal
        accounting of the slots that were live at dispatch."""
        if pending.spec:
            return self._commit_spec(st, pending)
        host = self._fetch(pending)
        nxt_h, done_h, bad_h = host[0], host[2], host[3]
        now = time.perf_counter() - st.t0
        for slot, req in list(pending.live.items()):
            if bad_h[slot]:
                self._fail(st, slot, req, "nan-logits")
                continue
            req.generated.append(int(nxt_h[slot]))
            st.slot_pos[slot] += 1
            if done_h[slot]:
                self._finish(st, slot, now)

    def _commit_spec(self, st: _SchedState, pending: PendingRound):
        """Commit half of a speculative window: append the committed
        prefix, then retract pages holding only rejected rows
        (write-then-retract, a table edit)."""
        host = self._fetch(pending)
        t = self.spec_k
        targets_h = host[:t].T
        commit_h, done_h, bad_h = host[t], host[t + 1], host[t + 2]
        now = time.perf_counter() - st.t0
        for slot, req in list(pending.live.items()):
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

    def _admit_shared(self, st: _SchedState):
        """Prefix-sharing admission: requests admit one at a time, FIFO,
        and each prompt's prefill publishes its full pages to the index
        before the next request is planned, so identical prompts arriving
        together share with each other, not only with earlier traffic.
        The gate charges only the plan's private pages (the shared prefix
        is resident already), beyond one growth page per live slot.  A
        host-swapped resume bypasses the planner: its pages come back
        verbatim, private, outside the sharing graph."""
        for slot in range(self.slots):
            if slot in st.live or not st.queue:
                continue
            req = st.queue[0]
            if req.uid in st.swaps:
                if not self._admit_swapped_row(st, slot, req):
                    break
                continue
            # the gate is a function of the allocator and the index alone:
            # a blocked head is planned again only once either has moved
            # (planning also refreshes the matched entries' LRU stamps)
            a = st.mgr.allocator
            key = (id(req), a.alloc_count, a.release_count, a.share_count,
                   st.mgr.index.version)
            if st.gate_block == key:
                break
            plan = st.mgr.plan_admit(req.prompt)
            if (not st.mgr.can_admit_plan(plan, headroom=len(st.live))
                    or st.mgr.admit_prefix(slot, plan) is None):
                st.gate_block = key
                break
            st.gate_block = None
            st.queue.popleft()
            self._bookkeep_admit(st, slot, req, time.perf_counter() - st.t0)
            # the first admission's figure: a preemption resume re-matches
            # its own folded prompt, which would count the reuse twice
            st.stats[req.uid].setdefault("cached_prefix_tokens", plan.cached_tokens)
            if plan.cached_tokens > 0:
                self._prefill_suffix_row(st, slot, req, plan)
            else:
                self._prefill_group(st, [(slot, req)], min(
                    self.max_seq, _round_up(len(req.prompt), PROMPT_BLOCK)))
            if st.stats[req.uid]["status"] is None:
                # a failed prefill released the slot: nothing to publish
                st.mgr.register_prefix(slot, req.prompt)
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
        pages yet (admission blocks, as for a too-big prompt).

        Under prefix sharing the gate deviates from the reference's: it
        counts ``available()``, the free pages plus the pages only the
        prefix index holds (reclaimed by ``admit_swapped``'s allocation),
        where the reference counts free pages only (its
        ``allocator.free - _headroom``), which blocks for as long as the
        index holds the pool.  So a resume that only index-held pages let
        in admits here and waits there; the tokens are the same either
        way, since a token is a function of (seed, uid, prompt)."""
        handle = st.swaps[req.uid]
        if st.mgr.available() - len(st.live) < handle.n_blocks:
            return False
        pages = st.mgr.admit_swapped(slot, handle)
        if pages is None:
            return False
        del st.swaps[req.uid]
        st.queue.popleft()
        swap_in_pages(st.pool, handle, pages)
        self._bookkeep_admit(st, slot, req, time.perf_counter() - st.t0)
        n = handle.n_tokens
        st.slot_pos[slot] = n          # _bookkeep_admit assumed a prefill
        st.pos[slot] = n
        st.tok[slot] = int(req.prompt[-1])
        st.uids[slot] = _int32(req.uid)
        # no token samples at a swap resume, so no -1 here: the requeue
        # path's prefill charges its sample against this same budget
        st.remaining[slot] = req.max_new_tokens - len(req.generated)
        if self.spec_k > 1:
            st.spec_mask[slot] = bool(req.spec) and req.uid not in st.spec_disabled
            # the draft's dense cache died with the slot: prefill it again
            # from the folded prompt (the draft only steers acceptance)
            self._draft_prefill_row(st, slot, req.prompt)
        s = st.stats[req.uid]
        s["swap_ins"] = s.get("swap_ins", 0) + 1
        self._finish_admission(st, slot, req)
        return True

    def _draft_prefill_row(self, st: _SchedState, slot: int, prompt: List[int]):
        """Prefill the draft's dense cache of ``slot`` from a whole prompt
        (its logits are dropped: the draft only steers acceptance)."""
        bucket = min(self.max_seq, _round_up(len(prompt), PROMPT_BLOCK))
        toks = torch.zeros((1, bucket), dtype=torch.int64, device=self.device)
        toks[0, :len(prompt)] = torch.as_tensor(prompt)
        last = torch.as_tensor([len(prompt) - 1], device=self.device)
        _, dcache = self.draft_model.prefill(self.draft_params, toks, self.max_seq, last)
        write_slots(st.draft_cache, dcache, [slot])

    def _prefill_suffix_row(self, st: _SchedState, slot: int, req: Request,
                            plan: AdmitPlan):
        """Admission prefill for a prefix-index hit: fork the boundary page
        if the plan says so (the copy is queued before the suffix prefill,
        then the source's pin drops), then compute only the un-cached
        suffix through the paged cache, the cached prefix read through the
        block tables in place."""
        if plan.cow_src is not None:
            copy_pages(st.pool, [plan.cow_src], [plan.cow_dst])
        st.mgr.cow_release(plan)
        suffix = req.prompt[plan.cached_tokens:]
        t_b = _round_up(len(suffix), PROMPT_BLOCK)
        self.last_prefill_groups.append(([req.uid], t_b, [len(req.prompt)]))
        toks = torch.zeros((1, t_b), dtype=torch.int64, device=self.device)
        toks[0, :len(suffix)] = torch.as_tensor(suffix)
        if st.mgr.dirty:
            self._upload_tables(st)
        cache = dict(st.pool, block_tables=st.bt_dev[slot:slot + 1])
        start = torch.tensor([plan.cached_tokens], dtype=torch.int32, device=self.device)
        last = torch.tensor([len(suffix) - 1], device=self.device)
        logits, _ = self.model.prefill_suffix(
            self.params, cache, toks, start, last,
            self._attend_len(plan.cached_tokens + t_b), self.verify_backend)
        if self.spec_k > 1:
            # the draft's cache is a dense slot pool with no sharing: it
            # prefills the whole prompt
            self._draft_prefill_row(st, slot, req.prompt)
        self._commit_prefill(st, [slot], [req], logits)

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
        self._commit_prefill(st, slots, reqs, logits)

    def _commit_prefill(self, st: _SchedState, slots: List[int],
                        reqs: List[Request], logits: torch.Tensor):
        """The slot state after an admission prefill, shared by the full
        and the suffix prefill: each row's first token, sampled at position
        len(prompt) with its uid's key (a requeued request's folded prompt
        puts it at the position of the token it replaces), pos / tok /
        remaining / uids (and the spec flags), then the one host copy; a
        row whose logits are not finite fails on its own."""
        lens = [len(r.prompt) for r in reqs]
        idx = torch.as_tensor(slots, device=self.device)
        st.uids[idx] = torch.as_tensor([_int32(r.uid) for r in reqs],
                                       dtype=torch.int32, device=self.device)
        first = sampling.sample_at(
            logits, torch.as_tensor(lens, device=self.device), st.uids[idx],
            self._base_key, self.temperature)
        finite = torch.isfinite(logits).all(dim=-1)
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
        the same folded copy under both policies).  Pipelined, the swap's
        device-to-host copy is queued and materialized at the next commit
        boundary, so a victim never stalls the next dispatch; its device
        slice is taken before the release, so a same-round admission
        cannot overwrite the snapshot.  Serial, the copy is synchronous."""
        req = st.live.pop(slot)
        if self._swap_wins(st):
            handle = st.mgr.swap_out(slot, st.pool, st.slot_pos[slot],
                                     async_copy=self.pipeline)
            if self.pipeline:
                st.pending_swaps.append(handle)
            st.swaps[req.uid] = handle
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
