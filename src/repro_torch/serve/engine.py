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
right-padded batch (bucketed to ``prompt_block``; each row's logits are
taken at its last real token).  An MoE request prefills alone at its
exact length: its experts' capacity depends on the row's length, so
padding would change its output.
Each decode step reads attention only up to the live prefix (``attend_len``
bucketed to ``attend_block``) and makes one device-to-host copy: its
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
The figures are the reference's defaults unless ``cost_model=`` is given
or ``preempt_calibrate=True`` measures them on the engine's own device and
model at construction (``serve.calibrate.calibrate``).

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

Scheduling.  Every request leaves ``serve()`` with exactly one terminal
status in ``last_stats[uid]["status"]`` (``TERMINAL_STATUSES``):

  ok          finished; its tokens are in the returned dict
  shed        rejected by the bounded queue: above ``max_queue`` at
              enqueue (``shed_policy`` reject-newest or reject-largest),
              or above ``queue_watermark`` in a round, which sheds only
              priority >= ``shed_priority``, most deadline slack first
  timeout     its ``deadline_ms`` (enqueue to finish) or
              ``ttft_deadline_ms`` (enqueue to first token) ran out
  cancelled   :meth:`ServeEngine.cancel` named it, queued or live (or a
              ``cancel`` fault did)
  failed      its logits were not finite (the row fails alone, the batch
              commits on), or its retries ran out across recoveries

Admission takes the lowest ``priority`` first, then arrival order, so
with every request at the default priority it is the FIFO of before.
The paged gate keeps one growth page per running slot free, and while
anything runs also ``free_page_watermark`` of the pool.  Preemption
takes the slot with the most deadline slack, then the least important
class, then the newest (without deadlines: the newest of the least
important class).  ``prefill_budget`` bounds the prompt tokens a round
prefills.  On the paged layout (dense family, no speculation, no
sharing) a prompt longer than one chunk (the budget rounded down to
whole ``prompt_block`` buckets) admits with all its pages mapped and is
written one chunk a round through :meth:`Model.prefill_suffix` (a chunk
of T tokens is T * G query rows a KV head in ``paged_flash_verify``),
interleaved with the other slots' decode steps.  Until its last chunk
samples its first token its row rides the step parked at ``max_seq -
1`` (in place in the step's buffers), where its write lands past the
prompt or in the trash page and no commit reads it.  A mid-chunk victim
always resumes by recompute.  ``last_stats["sla"]`` holds the session's
TTFT and TBT percentiles, goodput and status census (``serve.sla``),
and its timeseries one row a round.

The seed loop (``fused=False``, dense layout, no speculation) prefills
each admitted request alone and decodes with an eager
``Model.decode_step`` over the whole cache plus ``sampling.sample_at``:
the per-token dispatch baseline, never captured.

:meth:`ServeEngine.generate` runs an equal-length prompt batch on the
dense layout for a fixed number of tokens, row i sampling with uid i.

Faults and recovery.  ``serve.faults`` injects every failure mode the
engine survives at a chosen scheduler round (``ServeEngine(faults=)`` or
``serve(requests, faults=)``): soft and hard allocator OOMs, NaN logits,
stragglers, speculative collapse, page corruption, kernel-backend
failures, cancels and deadline expiries.  The NaN and collapse
injections ride two fixed (slots,) bool device buffers that every step
reads by address (a captured step too); they are written only in rounds
a fault targets a live row, and zeroed after that step.  Recovery is
step-restart: a recoverable exception in admission, growth, dispatch or
commit requeues every held request with its generated tokens folded into
its prompt (charging one of its ``Request.max_retries``; none left ->
``failed``), rebuilds the host manager and prefix index from scratch and
zero-fills the device state in place (no buffer is rebound, so every
captured graph stays valid).  An injected kernel-backend failure
(``KernelBackendError``) also degrades the engine onto the plain PyTorch
lowering (``backend_degraded``): the model is rebuilt with
``use_kernels=False``, verify goes to ``"torch"``, and every captured
graph is dropped, to be captured again on the plain lowering.  Only
injected faults are recovered from.  Any other exception (a kernel that
fails to build or launch, a bug in a step, an audit failure), a fatal
fault, or a recovery past ``max_recoveries`` escapes ``serve()``, which
first fails everything still held or queued and leaves an audit-clean
pool: unlike the reference, which recovers from any exception and
degrades on any that is not injected, the port never hides a real
failure behind a recovery or the plain lowering.  Each recovery's round,
time, exception, degrade and requeued uids, with each requeued request's
time to its next token, are in ``last_stats["recovery_log"]``.  The
straggler watchdog records a step whose dispatch-to-commit wall exceeds
``straggler_factor`` times the median of the last ``straggler_window``
in ``last_stats["stragglers"]``.
``audit=True`` commits and sweeps the allocator, block tables, prefix
index and the pool's quantization metadata every round
(``serve.audit``); ``last_pool_stats`` always carries the sweep's
verdict.

Open-loop serving drives the same session primitives: requests join a
live session through ``_submit_open`` and stream their tokens
(``serve.async_engine``).  The fleet (``serve.cluster``) drives them
too, one session per engine, and moves a live request between two
engines' sessions with ``_migrate_out`` (its pages leave as a
placement-free ``SwapHandle``) and ``_submit_resume`` (they restore
without a prefill, or the folded prompt prefills again).  A session with
``prefill_only`` set admits and prefills but never grows or decodes:
the fleet's prefill role.  An engine holds one session at a time: its
device state is one set of buffers that every captured step reads by
address, so ``_open_session`` raises while a session is open, and
``_finalize_session`` and ``_abort`` close it.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.optim.optimizer import leaves
from repro_torch.serve import calibrate, sampling, sla, spec_decode, step_graph
from repro_torch.serve.audit import audit_pool
from repro_torch.serve.faults import InjectedFault, KernelBackendError, poison_pages
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

# terminal request statuses: every request handed to serve() ends in
# exactly one
STATUS_OK = "ok"
STATUS_SHED = "shed"
STATUS_TIMEOUT = "timeout"
STATUS_CANCELLED = "cancelled"
STATUS_FAILED = "failed"
TERMINAL_STATUSES = (STATUS_OK, STATUS_SHED, STATUS_TIMEOUT,
                     STATUS_CANCELLED, STATUS_FAILED)

# bounded-queue shed policies: who is rejected when the waiting queue
# overflows max_queue
SHED_POLICIES = ("reject-newest", "reject-largest")

# preemption-resume policies: requeue recomputes the victim's cache from
# its folded prompt at re-admission; swap pages it to host buffers and
# restores it; auto picks by the cost model
PREEMPT_POLICIES = ("requeue", "swap", "auto")


# the defaults of the shape buckets: attention reads the live prefix
# rounded up to attend_block positions, admission pads prompts to
# prompt_block tokens
ATTEND_BLOCK = 64
PROMPT_BLOCK = 16
# the defaults of the acceptance governor: a request whose last
# spec_disable_window windows committed one token each stops speculating
# for spec_cooldown steps
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
    # wall-clock budgets from enqueue, in ms (None: unbounded): to the
    # finish, and to the first token; either running out -> timeout
    deadline_ms: Optional[float] = None
    ttft_deadline_ms: Optional[float] = None
    # step-restart recoveries this request may ride before it fails
    max_retries: int = 2
    # SLA class: lower admits first and survives shedding and preemption
    # longer; equal classes keep arrival order, so the default (every
    # request at 1) schedules FIFO
    priority: int = 1
    # how many ``generated`` tokens a preemption resume already folded
    # into ``prompt`` (a second preemption folds only the rest)
    folded: int = 0


@dataclasses.dataclass
class PendingRound:
    """A decode step in flight: dispatched, its output not fetched yet.
    ``live`` snapshots the dispatch-time slot -> request map, so the
    commit accounts tokens to exactly the requests the step computed them
    for.  ``event`` (CUDA) follows the output's copy into the pinned host
    buffer; the commit waits on it.  The rest is the watchdog's: the
    clock's start (at dispatch) and the live slots the step served."""
    live: Dict[int, Request]
    spec: bool = False
    event: Any = None
    t_start: float = 0.0
    live_before: int = 0


def _empty_timeseries() -> Dict[str, list]:
    """One row a round: seconds since serve() began, the round, the
    queue depth admission control sees, the busy slots (live and
    mid-chunk) and their share of the slots, the uids decoding at the
    round's end (sorted), the free pages (paged layout only), and the
    pipeline phases: host time issuing the dispatch, host time blocked in
    the commit, and host work done in the gap while a step was in flight
    (0.0 when serial)."""
    return {"t_s": [], "round": [], "queue_depth": [], "live_slots": [],
            "utilization": [], "live_uids": [], "free_pages": [],
            "dispatch_s": [], "commit_s": [], "overlap_s": []}


@dataclasses.dataclass
class _ChunkState:
    """An admitted prompt mid-chunked-prefill: pages mapped, ``done``
    prompt tokens written, not in the decode batch yet."""
    req: Request
    done: int = 0


@dataclasses.dataclass
class _SchedState:
    """Per-serve() scheduler state (host bookkeeping + device slot state)."""
    queue: deque
    t0: float
    mgr: Optional[PagedCacheManager] = None
    live: Dict[int, Request] = dataclasses.field(default_factory=dict)
    # chunked prompts by slot: admitted, pages mapped, not live yet
    prefilling: Dict[int, _ChunkState] = dataclasses.field(default_factory=dict)
    arrival: Dict[int, int] = dataclasses.field(default_factory=dict)
    seq_arrival: int = 0       # the next arrival stamp
    has_deadlines: bool = False
    tbt: List[float] = dataclasses.field(default_factory=list)   # gaps, s
    last_emit: Dict[int, float] = dataclasses.field(default_factory=dict)
    graphs0: tuple = ()        # the graphs' (count, capture s, replays) at open
    results: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    stats: Dict[Any, Any] = dataclasses.field(default_factory=dict)
    admit_seq: Dict[int, int] = dataclasses.field(default_factory=dict)
    next_seq: int = 0
    resumed: set = dataclasses.field(default_factory=set)
    slot_pos: List[int] = dataclasses.field(default_factory=list)
    cache: Any = None          # dense layout: {"k", "v"} (MLA: {"latent", "rope"})
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
    # faults and recovery
    faults: Any = None          # this session's FaultSchedule (or None)
    forced_expired: set = dataclasses.field(default_factory=set)   # deadline faults
    recoveries: int = 0         # step restarts this session
    recovery_log: List[dict] = dataclasses.field(default_factory=list)
    awaiting_next: Dict[int, dict] = dataclasses.field(default_factory=dict)  # uid -> entry
    stragglers: List[dict] = dataclasses.field(default_factory=list)
    durations: List[float] = dataclasses.field(default_factory=list)  # step walls, s
    step_no: int = 0            # steps committed (the watchdog's clock)
    prefill_only: bool = False  # the fleet's prefill role: admit, never decode


class ServeEngine:
    def __init__(self, model, params, *, max_seq: int, batch_slots: int,
                 temperature: float = 0.0, seed: int = 0, fused: bool = True,
                 attend_block: int = ATTEND_BLOCK, prompt_block: int = PROMPT_BLOCK,
                 cache_layout: str = "dense",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None, preempt: str = "requeue",
                 prefix_sharing: bool = False, evict_policy: str = "lru",
                 min_cached_tokens: int = 0, spec_k: int = 1, draft=None,
                 verify_backend: Optional[str] = None,
                 max_queue: Optional[int] = None,
                 shed_policy: str = "reject-newest",
                 queue_watermark: Optional[int] = None,
                 shed_priority: int = 2,
                 free_page_watermark: float = 0.0,
                 prefill_budget: Optional[int] = None,
                 spec_disable_window: int = SPEC_DISABLE_WINDOW,
                 spec_cooldown: int = SPEC_COOLDOWN,
                 pipeline: bool = True,
                 cost_model: Optional[calibrate.CostModel] = None,
                 preempt_calibrate: bool = False, audit: bool = False,
                 faults=None, max_recoveries: int = 2,
                 straggler_factor: float = 3.0, straggler_window: int = 20):
        if cache_layout not in CACHE_LAYOUTS:
            raise ValueError(f"cache_layout must be one of {CACHE_LAYOUTS}; "
                             f"got {cache_layout!r}")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1; got {spec_k}")
        if spec_k > 1 and cache_layout != "paged":
            raise ValueError("speculative decoding (spec_k > 1) verifies "
                             "against the paged cache; pass "
                             "cache_layout='paged'")
        if spec_k > 1 and not fused:
            raise ValueError("speculative decoding requires fused=True")
        if cache_layout == "paged" and not model.supports_paged():
            raise ValueError(
                "paged cache layout needs a plain stacked K/V cache "
                f"(families {model.PAGED_FAMILIES}, non-MLA); "
                f"got {model.cfg.family}/{model.cfg.attn_type}")
        if cache_layout == "paged" and not fused:
            raise ValueError("cache_layout='paged' requires fused=True "
                             "(the seed loop is the dense baseline)")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {SHED_POLICIES}; "
                             f"got {shed_policy!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (or None for "
                             f"unbounded); got {max_queue}")
        if queue_watermark is not None and queue_watermark < 0:
            raise ValueError(f"queue_watermark must be >= 0 (or None to "
                             f"disable soft shedding); got {queue_watermark}")
        if not 0.0 <= free_page_watermark < 1.0:
            raise ValueError(f"free_page_watermark must be in [0, 1); "
                             f"got {free_page_watermark}")
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(f"prefill_budget must be >= 1 (or None for "
                             f"unbounded prefill per round); got "
                             f"{prefill_budget}")
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
        # the preempt="auto" figures: an explicit model wins, else the
        # measured one (preempt_calibrate=True), else the defaults
        if cost_model is not None:
            self.cost_model = cost_model
        elif preempt_calibrate:
            self.cost_model = calibrate.calibrate(model, params, max_seq=max_seq)
        else:
            self.cost_model = calibrate.DEFAULT_COST_MODEL
        # preempt="auto": recompute costs ~2 * params FLOPs a token
        self._n_params = sum(t.numel() for t in leaves(params))
        self.spec_k = spec_k
        self.fused = fused
        self.attend_block = attend_block
        self.prompt_block = prompt_block
        self.spec_disable_window = spec_disable_window
        self.spec_cooldown = spec_cooldown
        # admission control: the hard queue bound and its shed policy, and
        # the soft one, above which classes priority >= shed_priority shed
        # every round
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.queue_watermark = queue_watermark
        self.shed_priority = shed_priority
        # share of the page pool the admission gate keeps free while
        # anything runs (growth headroom under bursts)
        self.free_page_watermark = free_page_watermark
        # prompt tokens prefilled a round; a chunk is a whole number of
        # prompt_block buckets, so mid-chunks carry no padding
        self.prefill_budget = prefill_budget
        self._chunk_tokens = (
            max(prompt_block, prefill_budget // prompt_block * prompt_block)
            if prefill_budget is not None else None)
        # uids cancel() named that no session has seen yet
        self._cancel_uids: set = set()
        # faults and recovery: the default schedule (serve(faults=)
        # overrides it a session), the per-round audit, the recovery budget
        # and the straggler watchdog's threshold and window
        self.audit = audit
        self.faults = faults
        self.max_recoveries = max_recoveries
        self.straggler_factor = straggler_factor
        self.straggler_window = straggler_window
        self.backend_degraded = False   # kernel -> plain lowering engaged
        self.recoveries = 0             # step restarts, over every session
        self._draft_spec = draft
        self._seed = seed
        # sampling: keys from (seed, uid, position), see serve.sampling.
        # The first token after a prefill scales as the reference's eager
        # call does (a division by T), a decode or verify step as its
        # jitted step does (a multiply by f32(1/T)), and a step of the
        # seed loop as its eager one (a division); temperature 0 keeps
        # every step's argmax, so greedy graphs hold today's ops
        self.temperature = float(temperature)
        self._base_key = sampling.prng_key(seed, self.device)
        self._sampler = (sampling.StepSampler(self._base_key, self.temperature,
                                              reciprocal=fused)
                         if self.temperature > 0.0 else None)
        # overlapped rounds; on a CUDA device also the captured steps.
        # pipeline=False keeps the serial, eager round: the control.  The
        # seed loop (fused=False) is never captured
        self.pipeline = pipeline
        self._graphs = step_graph.StepGraphs(self.device, enabled=pipeline and fused)
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
        # the open session, if any: the device state holds one at a time
        self._session: Optional[_SchedState] = None

    def _chunked_capable(self) -> bool:
        """Chunked prefill needs the paged suffix prefill: the whole
        prompt's pages are mapped at admission, then written one bucketed
        chunk a round.  Speculation and prefix sharing drive their own
        admission prefills, so they opt out (the budget still bounds how
        many whole prompts admit a round)."""
        return (self.prefill_budget is not None
                and self.cache_layout == "paged"
                and self.spec_k == 1
                and not self.prefix_sharing
                and self.model.cfg.family in _PADDED_PREFILL_FAMILIES)

    def cancel(self, uid: int):
        """Cancel request ``uid``: queued, it ends ``cancelled`` at the
        next round; live or mid-chunk, its slot is released and its
        partial output dropped.  A uid no session has seen yet is kept
        until one does."""
        self._cancel_uids.add(uid)

    def _attend_len(self, needed: int) -> int:
        """Attention bound: ``needed`` rounded up to the bucket."""
        return min(self.max_seq, _round_up(needed, self.attend_block))

    def _prompt_bucket(self, lens: List[int]) -> int:
        """The prefill length of one group: the dense family pads to the
        prompt bucket, the others prefill one request at its exact
        length."""
        if self.model.cfg.family in _PADDED_PREFILL_FAMILIES:
            return min(self.max_seq, _round_up(max(lens), self.prompt_block))
        return max(lens)

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
        CUDA; one graph per batch size and attend bucket).  The seed loop
        (``fused=False``) runs each step eagerly over the whole cache."""
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
        write_slots(gen["cache"], pcache, range(b))
        gen["uids"].copy_(torch.arange(b, dtype=torch.int32, device=self.device))
        gen["pos"].fill_(s)
        gen["tok"].copy_(sampling.sample_at(logits, gen["pos"], gen["uids"],
                                            self._base_key, self.temperature))
        gen["remaining"].fill_(n_tokens - 1)
        out = [gen["tok"].clone()]
        for i in range(n_tokens - 1):
            attend = self._attend_len(s + i + 1) if self.fused else None
            fn = self._step_fn(gen["cache"], gen["tok"], gen["pos"], gen["remaining"],
                               gen["uids"], gen["out"], attend)
            self._graphs.run(("generate", b, attend), fn,
                             restore=(gen["tok"], gen["pos"], gen["remaining"])
                             + self.model.state_leaves(gen["cache"]))
            out.append(gen["tok"].clone())
        return torch.stack(out, dim=1)

    def _step_fn(self, cache, tok, pos, remaining, uids, out, attend: Optional[int],
                 nan_mask: Optional[torch.Tensor] = None):
        """One decode step over fixed buffers (``step_graph.decode_step_fn``);
        the seed loop's (``fused=False``) has ``attend`` None: it reads the
        whole cache.  ``nan_mask``: the serving steps' fault mask buffer."""
        return step_graph.decode_step_fn(self.model, self.params, cache, tok, pos,
                                         remaining, out, attend, self.max_seq,
                                         uids=uids, sampler=self._sampler,
                                         nan_mask=nan_mask)

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
    def serve(self, requests: List[Request], faults=None) -> Dict[int, List[int]]:
        """Waiting queue -> admission -> joint decode, until every request
        is done.  Returns {uid: generated tokens} for requests that
        finished OK; every request gets one terminal ``status``
        (``TERMINAL_STATUSES``) and its figures in ``self.last_stats[uid]``,
        the session its SLA summary in ``self.last_stats["sla"]``, its
        per-round columns in ``self.last_stats["timeseries"]``, the
        watchdog's events in ``self.last_stats["stragglers"]`` and the
        recoveries in ``self.last_stats["recovery_log"]``; the pool's
        accounting and audit verdict are in ``self.last_pool_stats``.
        ``faults`` (a ``serve.faults.FaultSchedule``) overrides the
        engine's default schedule for this call.  An exception that
        escapes (any that is not an injected fault, a fatal fault, one
        recovery too many) first fails every request still held or
        queued."""
        st = self._open_session(requests, faults)
        try:
            if self.pipeline:
                # overlapped rounds: each round commits the previous round's
                # step before admission; a live slot keeps the loop going
                # until its step commits, so it exits with nothing pending
                while st.queue or st.live or st.prefilling or st.pending is not None:
                    self.dispatch_round(st)
            else:
                while st.queue or st.live or st.prefilling:
                    self._round(st)
        except BaseException as exc:
            # whatever escapes, no slot or page stays held and every
            # request has a terminal status: the next serve() starts clean
            self._abort(st, exc)
            raise
        return self._finalize_session(st)

    # --------------------------------------------------- session primitives
    # serve() drives a session through three primitives: _open_session,
    # the rounds (_round, or dispatch_round / commit_round) and
    # _finalize_session.  The open-loop server (serve.async_engine) drives
    # the same primitives with requests joining mid-session through
    # _submit_open, so streamed tokens are the closed batch's; the fleet's
    # workers (serve.cluster) drive them too, and hand requests between
    # engines with _migrate_out and _submit_resume
    def _open_session(self, requests: List[Request], faults=None) -> _SchedState:
        """Register a (possibly empty) request batch, shed it down to
        ``max_queue``, and bind a fresh manager (with the schedule's OOM
        hook) and the device state; returns the session state the rounds
        advance.  Raises while another session of this engine is open:
        binding the device state zero-fills the buffers that session's
        pool, tables and captured steps live in."""
        if self._session is not None:
            raise RuntimeError(
                "this engine already has an open session: its device state "
                "(pool, block tables, tok/pos, captured steps) holds one "
                "session at a time; finalize or abort it first, or build "
                "another ServeEngine over the same model and params")
        st = _SchedState(queue=deque(), t0=time.perf_counter())
        st.faults = faults if faults is not None else self.faults
        self.last_stats = st.stats
        self.last_prefill_groups = []
        self.preemptions = 0
        for req in requests:
            self._register(st, req)
            st.queue.append(req)
        self._shed_overflow(st)
        self._init_mgr(st)
        for req in st.queue:
            self._check_fits(st, req)
        self._init_device(st)
        g = self._graphs
        st.graphs0 = (g.captures, g.capture_s, g.replays, g.dropped)
        self._session = st
        return st

    def _init_mgr(self, st: _SchedState):
        """A fresh paged-cache manager (and prefix index), with the fault
        schedule's OOM hook: a hard OOM raises ``InjectedFault`` at its
        round, a soft one denies the allocation.  Recovery calls it again:
        a stale index must never point into the zero-filled pool."""
        if self.cache_layout != "paged":
            st.mgr = None
            return
        index = (PrefixIndex(self.page_size, policy=self.evict_policy,
                             min_cached_tokens=self.min_cached_tokens)
                 if self.prefix_sharing else None)
        st.mgr = PagedCacheManager(self.num_pages, self.page_size, self.slots,
                                   self.max_seq, prefix_index=index,
                                   kv_dtype=self.kv_dtype)
        if st.faults is not None:
            fs = st.faults

            def oom_hook(n, _st=st, _fs=fs):
                f = _fs.oom_raise(_st.rnd)
                if f is not None:
                    raise InjectedFault(
                        f"injected allocator OOM (hard) at round {_st.rnd}",
                        fatal=f.fatal)
                return _fs.oom_denied(_st.rnd)

            st.mgr.allocator.fault_hook = oom_hook

    def _register(self, st: _SchedState, req: Request, now: float = 0.0):
        """The request's ledger entry and arrival stamp (one per uid)."""
        if req.uid in st.stats:
            raise ValueError(f"duplicate request uid {req.uid}: the status "
                             "ledger and sampling keys are keyed by uid")
        st.arrival[req.uid] = st.seq_arrival
        st.seq_arrival += 1
        st.stats[req.uid] = {"enqueued_s": now, "preemptions": 0, "retries": 0,
                             "status": None, "priority": req.priority}
        if req.deadline_ms is not None or req.ttft_deadline_ms is not None:
            st.has_deadlines = True

    def _submit_open(self, st: _SchedState, req: Request, now: float = 0.0):
        """An open-loop arrival: register and enqueue mid-session.  On the
        paged layout a request that could never fit ends ``failed``
        (reason ``never-fits: ...``) instead of raising: the server keeps
        serving everyone else.  The dense layout enqueues unchecked, as
        the reference does (a prompt of ``max_seq`` tokens serves through
        the clamped write of a coasting row; a longer one fails the
        session at its prefill)."""
        self._register(st, req, now=now)
        if st.mgr is not None:
            try:
                self._check_fits(st, req)
            except ValueError as exc:
                self._terminal(st, req, STATUS_FAILED, reason=f"never-fits: {exc}")
                return
        st.queue.append(req)

    def _finalize_session(self, st: _SchedState) -> Dict[int, List[int]]:
        """Close a session: the finalize barrier (never end over an
        in-flight step or an unmaterialized swap copy), the check that
        the statuses partition the request set, the SLA summary, and the
        graph and pool figures.  Returns the OK requests' tokens.  The
        session closes whether or not the checks pass."""
        try:
            self.commit_round(st)
            missing = [uid for uid, s in st.stats.items()
                       if s.get("status") not in TERMINAL_STATUSES]
            if missing:
                raise RuntimeError(f"requests left without a terminal status: {missing}")
        finally:
            self._close_session(st)
        self._cancel_uids -= set(st.stats)
        st.stats["stragglers"] = st.stragglers
        st.stats["recovery_log"] = st.recovery_log
        self._attach_observability(st)
        if st.mgr is not None:
            self.last_pool_stats = st.mgr.stats()
        return st.results

    def _close_session(self, st: _SchedState):
        if self._session is st:
            self._session = None

    # ------------------------------------------------- cross-replica handoff
    # The fleet (serve.cluster) moves a live request between two sessions,
    # on two engines, with these two primitives.  The tokens are those of
    # an uninterrupted run for the reasons preemption keeps them: the
    # sampling keys are (uid, position), a folded prompt recreates the
    # exact cache, and a SwapHandle restores page contents anywhere.
    def _migrate_out(self, st: _SchedState, uid: int):
        """Detach live request ``uid`` for a handoff: commit the step in
        flight (its tokens, or its release of the slot, land first), swap
        the slot's pages out synchronously into a placement-free
        ``SwapHandle`` (which releases the slot), and take the request out
        of this session's ledger (the destination registers it again, so
        it must not trip this session's status partition).  Returns
        ``(resume, handle, carry)``: the folded resume copy (it shares the
        growing ``generated`` list), the handle, and the ledger entry
        whose counters the destination inherits."""
        self.commit_round(st)
        slot = next(s for s, r in st.live.items() if r.uid == uid)
        req = st.live.pop(slot)
        handle = st.mgr.swap_out(slot, st.pool, st.slot_pos[slot])
        resume = dataclasses.replace(
            req, prompt=list(req.prompt) + req.generated[req.folded:],
            folded=len(req.generated))
        carry = st.stats.pop(req.uid)
        st.arrival.pop(req.uid, None)
        st.last_emit.pop(req.uid, None)
        st.spec_hist.pop(req.uid, None)
        return resume, handle, carry

    def _submit_resume(self, st: _SchedState, req: Request, *, handle=None,
                       carry=None, now: float = 0.0):
        """Accept a live request handed over from another session: register
        it with ``carry``'s counters (one more ``handoffs``), mark it a
        resume so admission keeps its ``generated`` prefix, and either
        stage ``handle`` for a page restore (no prefill) or, with no
        handle (the pages died with their replica), let the folded prompt
        prefill again.  A resume that can never fit this pool ends
        ``failed`` (``never-fits: resume needs ...``); the gate counts its
        true remaining footprint, since ``_check_fits`` would charge the
        folded tokens twice (in the prompt and in ``max_new_tokens``)."""
        self._register(st, req, now=now)
        s = st.stats[req.uid]
        if carry is not None:
            for k in ("preemptions", "retries", "swap_outs", "swap_ins",
                      "handoffs", "cached_prefix_tokens"):
                if k in carry:
                    s[k] = carry[k]
        s["handoffs"] = s.get("handoffs", 0) + 1
        if st.mgr is not None:
            longest = min(len(req.prompt) + max(req.max_new_tokens - req.folded, 1)
                          + self.spec_k - 2, self.max_seq)
            need = blocks_for(longest, self.page_size)
            if need > st.mgr.allocator.usable:
                self._terminal(st, req, STATUS_FAILED,
                               reason=f"never-fits: resume needs {need} pages, "
                                      f"pool has {st.mgr.allocator.usable}")
                return
        st.resumed.add(id(req))
        if handle is not None:
            st.swaps[req.uid] = handle
        st.queue.append(req)

    def _graph_stats(self, st: _SchedState):
        """The session's graph figures into ``last_graph_stats``: the graphs
        held now, captured, dropped (a degrade) and replayed this session,
        the capture seconds, and each held graph's launches a replay."""
        g = self._graphs
        c0, t0, r0, d0 = st.graphs0
        self.last_graph_stats = dict(
            enabled=g.enabled, graphs=len(g.graphs), captured=g.captures - c0,
            dropped=g.dropped - d0, capture_s=g.capture_s - t0, replays=g.replays - r0,
            launches_per_replay={f"{k[0]}@{k[1]}": v for k, v in g.launches().items()})

    def _attach_observability(self, st: _SchedState):
        """The SLA summary and the timeseries under ``last_stats``'s string
        keys (the requests' entries stay keyed by int uid)."""
        st.stats["sla"] = sla.summarize(st.stats, tbt_s=st.tbt,
                                        wall_s=time.perf_counter() - st.t0,
                                        timeseries=st.timeseries)
        st.stats["timeseries"] = st.timeseries
        self._graph_stats(st)

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
        first session, zero-filled in place at every later one and at a
        recovery (the bytes a fresh ``init_cache`` gives), never rebound,
        since captured steps read every buffer by address."""
        dev = self._dev
        if dev is None:
            zeros = dict(dtype=torch.int32, device=self.device)
            dev = {"tok": torch.zeros(self.slots, **zeros),
                   "pos": torch.zeros(self.slots, **zeros),
                   "remaining": torch.zeros(self.slots, **zeros),
                   "uids": torch.zeros(self.slots, **zeros),
                   # (3 + T, slots): targets, commit, done, bad
                   "out": torch.zeros(3 + self.spec_k, self.slots, **zeros),
                   # the fault masks: row 0 nan, row 1 spec collapse
                   "masks": torch.zeros(2, self.slots, dtype=torch.bool,
                                        device=self.device),
                   "mask_staging": TableStaging((2, self.slots), self.device,
                                                dtype=torch.bool),
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
            for name in ("tok", "pos", "remaining", "uids", "out", "masks", "spec_mask"):
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
        st.gate_block = None
        if st.mgr is not None:
            self._upload_tables(st)

    def _upload_tables(self, st: _SchedState):
        """The manager's block tables into the fixed device buffer, in
        place (a queued copy from pinned memory)."""
        st.mgr.upload_tables(st.bt_dev, self._dev["staging"])

    def _round(self, st: _SchedState):
        """One serial scheduler round: the round's faults, the lifecycle
        sweep, admission control, admission (and the chunks in flight),
        page growth (paged), one decode step for every slot, dispatched and
        committed at once; an exception in admission, growth or the step
        takes the recovery gate, and ``audit=True`` sweeps the pool."""
        st.rnd += 1
        st.last_dispatch_s = st.last_commit_s = st.last_overlap_s = 0.0
        self._apply_round_faults(st)
        self._expire_and_cancel(st)
        self._admission_control(st)
        if st.queue or st.live or st.prefilling:
            try:
                self._admit_and_grow(st)
                if st.live and not st.prefill_only:
                    self._timed_commit(st, self._timed_dispatch(st))
            except Exception as exc:
                self._recover_or_raise(st, exc)
            self._audit_round(st)
        self._sample_timeseries(st)

    def _audit_round(self, st: _SchedState):
        """``audit=True``: the manager's sweep and the pool's structural
        check (structure only: injected page corruption must surface as NaN
        logits, not as an audit failure)."""
        if self.audit and st.mgr is not None:
            st.mgr.audit().raise_if_failed()
            audit_pool(st.mgr, st.pool).raise_if_failed()

    def _admit_and_grow(self, st: _SchedState):
        """Admission (needs the freed slots), then growth and preemption
        (need the advanced positions and the spec retraction).  A
        ``prefill_only`` session stops at admission: its worker migrates
        the admitted slots out after the round, so growth would be wasted
        work."""
        if self.prefix_sharing:
            self._admit_shared(st)
        else:
            self._admit(st)
        if st.live and st.mgr is not None and not st.prefill_only:
            self._grow_or_preempt(st)

    # ----------------------------------------------------- round pipeline
    def dispatch_round(self, st: _SchedState):
        """Overlapped twin of :meth:`_round`: one round whose step is
        dispatched but not committed; the fetch happens at the top of the
        next round.  In the reference's order:

        1. the round tick;
        2. the overlap gap: host work that the in-flight step's commit
           cannot influence, run while the device computes: the round's
           cancel and deadline faults (they only build uid sets), the
           queued requests' cancel and expiry sweep and admission control
           (shedding, watermark), none of which reads a live slot or the
           allocator;
        3. :meth:`commit_round`: the one wait, token and terminal
           accounting, the deferred swap-out materialization;
        4. the page-corruption faults (their target is drawn from the
           pages mapped after the commit's releases), the sweep of the held
           slots (live and mid-chunk: a commit can free or fail them), then
           admission (and the chunks in flight), growth and preemption,
           then the next dispatch.

        An exception in the commit, or in admission, growth or the
        dispatch, takes the recovery gate; the commit pops the pending
        round before its wait, so a recovery never commits a stale round.
        ``audit=True`` commits the step at once and sweeps the pool.  The
        outputs are the serial round's; a session runs one more round,
        which commits the last step."""
        st.rnd += 1
        st.last_dispatch_s = st.last_commit_s = st.last_overlap_s = 0.0
        t_gap = time.perf_counter()
        self._apply_round_faults(st, poison=False)
        self._expire_and_cancel(st, scope="queued")
        self._admission_control(st)
        if st.pending is not None:
            st.last_overlap_s = time.perf_counter() - t_gap
        try:
            self.commit_round(st)
        except Exception as exc:
            self._recover_or_raise(st, exc)
        self._apply_poison_faults(st)
        self._expire_and_cancel(st, scope="held")
        if st.queue or st.live or st.prefilling:
            try:
                self._admit_and_grow(st)
                if st.live and not st.prefill_only:
                    st.pending = self._timed_dispatch(st)
            except Exception as exc:
                self._recover_or_raise(st, exc)
            if self.audit and st.mgr is not None:
                # a debug mode: the step commits now, so the sweep sees a
                # quiescent pool (the spec retraction applied); this round
                # loses its overlap
                try:
                    self.commit_round(st)
                except Exception as exc:
                    self._recover_or_raise(st, exc)
                self._audit_round(st)
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
        host buffers).  Idempotent; runs at every commit boundary.  A
        handle leaves the list only once materialized, so an exception
        leaves the rest queued for the next boundary."""
        while st.pending_swaps:
            st.pending_swaps[0].materialize()
            st.pending_swaps.pop(0)

    def _recover_or_raise(self, st: _SchedState, exc: Exception):
        """The recovery gate of both round drivers: only a recoverable
        injected fault takes step-restart recovery.  Any other exception
        (a kernel that fails to build or launch, a bug in a step, an audit
        failure) escapes, as do a fatal fault and a recovery past
        ``max_recoveries``: ``serve()`` unwinds through ``_abort`` and
        re-raises, so no real failure is hidden behind a recovery."""
        if (not isinstance(exc, InjectedFault) or exc.fatal
                or st.recoveries >= self.max_recoveries):
            raise exc
        self._recover(st, exc)

    def _sample_timeseries(self, st: _SchedState):
        ts = st.timeseries
        ts["t_s"].append(time.perf_counter() - st.t0)
        ts["round"].append(st.rnd)
        ts["queue_depth"].append(self._queue_depth(st))
        busy = len(st.live) + len(st.prefilling)
        ts["live_slots"].append(busy)
        ts["utilization"].append(busy / max(1, self.slots))
        ts["live_uids"].append(sorted(r.uid for r in st.live.values()))
        ts["dispatch_s"].append(st.last_dispatch_s)
        ts["commit_s"].append(st.last_commit_s)
        ts["overlap_s"].append(st.last_overlap_s)
        if st.mgr is not None:
            ts["free_pages"].append(st.mgr.allocator.free)

    # ------------------------------------------------ lifecycle, admission control
    def _queue_depth(self, st: _SchedState) -> int:
        """The waiting queue's depth as admission control counts it:
        preemption requeues are exempt (the bound applies at enqueue)."""
        return sum(1 for r in st.queue if id(r) not in st.resumed)

    def _shed_overflow(self, st: _SchedState):
        """The bounded queue: reject down to ``max_queue``.  reject-newest
        drops the latest arrivals of the least important class (FIFO
        within a class); reject-largest the largest worst-case footprint
        (prompt + budget), newest first among ties.  Requeues are
        exempt."""
        if self.max_queue is None:
            return
        while self._queue_depth(st) > self.max_queue:
            cands = [r for r in st.queue if id(r) not in st.resumed]
            if self.shed_policy == "reject-newest":
                victim = max(cands, key=lambda r: (r.priority, st.arrival[r.uid]))
            else:
                victim = max(cands, key=lambda r: (r.priority,
                                                   len(r.prompt) + r.max_new_tokens,
                                                   st.arrival[r.uid]))
            st.queue.remove(victim)
            self._terminal(st, victim, STATUS_SHED,
                           reason=f"queue overflow (max_queue={self.max_queue}, "
                                  f"policy={self.shed_policy})")

    def _admission_control(self, st: _SchedState):
        """Every round: the hard ``max_queue`` bound (a no-op in serve(),
        which applied it at enqueue), then the soft ``queue_watermark``:
        depth above it sheds only classes priority >= ``shed_priority``,
        most slack first (a request with no deadline has infinite slack),
        then the least important class, then the newest."""
        self._shed_overflow(st)
        if self.queue_watermark is None:
            return
        now_ms = (time.perf_counter() - st.t0) * 1e3
        while self._queue_depth(st) > self.queue_watermark:
            cands = [r for r in st.queue if id(r) not in st.resumed
                     and r.priority >= self.shed_priority]
            if not cands:
                break
            victim = max(cands, key=lambda r: (self._slack_ms(st, r, now_ms),
                                               r.priority, st.arrival[r.uid]))
            st.queue.remove(victim)
            self._terminal(st, victim, STATUS_SHED,
                           reason=f"queue watermark (depth > {self.queue_watermark}, "
                                  f"priority >= {self.shed_priority})")

    def _expired(self, st: _SchedState, req: Request, now_ms: float) -> Optional[str]:
        """Which of the request's deadlines ran out (None if neither): a
        ``deadline`` fault's, or one of its own, both from its enqueue
        time."""
        if req.uid in st.forced_expired:
            return "deadline"
        age_ms = now_ms - st.stats[req.uid]["enqueued_s"] * 1e3
        if req.deadline_ms is not None and age_ms > req.deadline_ms:
            return "deadline"
        if (req.ttft_deadline_ms is not None and age_ms > req.ttft_deadline_ms
                and "first_token_s" not in st.stats[req.uid]):
            return "ttft_deadline"
        return None

    def _expire_and_cancel(self, st: _SchedState, scope: str = "all"):
        """End cancelled and expired requests, queued and held alike; a
        held one's slot frees at once.  The pipelined round splits the
        sweep: ``scope="queued"`` (the waiting queue, which no commit
        changes: it runs in the overlap gap) and ``scope="held"`` (live and
        mid-chunk slots, which a commit can free or fail: after it)."""
        if not (self._cancel_uids or st.forced_expired or st.has_deadlines):
            return
        now_ms = (time.perf_counter() - st.t0) * 1e3

        def sweep(req, slot=None):
            why = self._expired(st, req, now_ms)
            if req.uid in self._cancel_uids:
                self._terminal(st, req, STATUS_CANCELLED, slot=slot, reason="cancelled")
            elif why is not None:
                self._terminal(st, req, STATUS_TIMEOUT, slot=slot, reason=why)
            return st.stats[req.uid]["status"] is None

        if scope in ("all", "queued"):
            st.queue = deque(r for r in list(st.queue) if sweep(r))
        if scope == "queued":
            return
        for slot in list(st.live):
            sweep(st.live[slot], slot)
        for slot in list(st.prefilling):
            sweep(st.prefilling[slot].req, slot)

    def _terminal(self, st: _SchedState, req: Request, status: str, *,
                  slot: Optional[int] = None, reason: Optional[str] = None):
        """A non-OK terminal transition (idempotent): the status and
        reason, and the slot freed if the request held one.  Partial
        output is dropped: only OK requests are in the returned dict."""
        s = st.stats[req.uid]
        if s.get("status") is not None:
            return
        s["status"] = status
        if reason:
            s["reason"] = reason
        s["finished_s"] = time.perf_counter() - st.t0
        s["tokens"] = len(req.generated or [])
        st.spec_hist.pop(req.uid, None)
        st.last_emit.pop(req.uid, None)
        st.swaps.pop(req.uid, None)     # the host snapshot of a dead request
        if slot is not None:
            st.live.pop(slot, None)
            st.prefilling.pop(slot, None)
            if st.mgr is not None:
                st.mgr.release(slot)

    # ------------------------------------------------------- fault plumbing
    def _apply_round_faults(self, st: _SchedState, poison: bool = True):
        """The injections that land at a round's start: cancels, forced
        deadline expiries (both only build uid sets, so they may run in
        the overlap gap) and, unless ``poison`` is False (the pipelined
        round runs it after the commit), page corruption."""
        fs = st.faults
        if fs is None:
            return
        for uid in fs.cancels_at(st.rnd):
            self._cancel_uids.add(uid)
        for uid in fs.deadline_expiries_at(st.rnd):
            st.forced_expired.add(uid)
        if poison:
            self._apply_poison_faults(st)

    def _apply_poison_faults(self, st: _SchedState):
        """This round's page corruptions: each target page (the fault's,
        or a seeded pick among the mapped pages) is overwritten in place
        across every pool leaf (``faults.poison_pages``)."""
        fs = st.faults
        if fs is None or st.mgr is None:
            return
        for f in fs.corruptions_at(st.rnd):
            mapped = sorted({p for owned in st.mgr.owned for p in owned})
            page = fs.corruption_target(f, st.rnd, mapped)
            if page is None or not 0 < page < self.num_pages:
                continue
            poison_pages(st.pool, [page])

    def _fault_mask(self, st: _SchedState, uids: List[Optional[int]]) -> np.ndarray:
        """(slots,) bool over the live rows the targeted uids name (None
        names every live row)."""
        mask = np.zeros((self.slots,), bool)
        for slot, req in st.live.items():
            if any(u is None or u == req.uid for u in uids):
                mask[slot] = True
        return mask

    def _arm_fault_masks(self, st: _SchedState) -> bool:
        """Write this round's nan and (speculative steps) collapse masks into
        the fixed device buffers, a queued copy from pinned memory, when a
        fault targets a live row; returns whether it did (the caller zeroes
        them after the step)."""
        fs = st.faults
        if fs is None:
            return False
        nan = self._fault_mask(st, fs.nan_uids(st.rnd))
        collapse = (self._fault_mask(st, fs.collapse_uids(st.rnd)) if self.spec_k > 1
                    else np.zeros_like(nan))
        if not (nan.any() or collapse.any()):
            return False
        self._dev["mask_staging"].upload(np.stack([nan, collapse]), self._dev["masks"])
        return True

    # ------------------------------------------------------------- recovery
    def _recover(self, st: _SchedState, exc: Exception):
        """Step-restart recovery: requeue every held request (live or mid-
        chunk, newest first to the queue's front) with its tokens since the
        last fold folded into its prompt, charging it one retry (none left:
        ``failed``), then a fresh manager and prefix index and the device
        state zero-filled in place.  The wholesale rebuild is deliberate:
        after an arbitrary exception the pool, the tables and the index
        cannot be trusted to agree.  A queued request's swap handle
        survives (it records page contents, not page numbers).  An
        injected kernel-backend failure first degrades the engine onto the
        plain lowering."""
        st.recoveries += 1
        self.recoveries += 1
        entry = dict(round=st.rnd, t_s=time.perf_counter() - st.t0,
                     exc=type(exc).__name__, requeued={}, next_token_s={})
        st.recovery_log.append(entry)
        if isinstance(exc, KernelBackendError):
            self._degrade_to_sw()
        entry["degraded"] = self.backend_degraded
        held = {**st.live, **{s: cs.req for s, cs in st.prefilling.items()}}
        st.live.clear()
        st.prefilling.clear()
        for slot in sorted(held, key=lambda s: st.admit_seq[s], reverse=True):
            req = held[slot]
            s = st.stats[req.uid]
            if s["retries"] >= req.max_retries:
                self._terminal(st, req, STATUS_FAILED,
                               reason=f"retries exhausted after {type(exc).__name__}: {exc}")
                continue
            s["retries"] += 1
            entry["requeued"][req.uid] = len(req.generated or [])
            st.awaiting_next[req.uid] = entry
            resume = dataclasses.replace(
                req, prompt=list(req.prompt) + req.generated[req.folded:],
                folded=len(req.generated))
            st.resumed.add(id(resume))
            st.queue.appendleft(resume)
        self._init_mgr(st)
        self._init_device(st)

    def _degrade_to_sw(self):
        """Kernel -> plain fallback, once: rebuild the model with
        ``use_kernels=False`` (same device, dtypes, norm form and weights),
        send verify to the plain version, rebuild the draft (a self or
        registry draft follows the target's lowering, as the reference
        re-resolves it; an explicit pair stays) and the speculative step,
        and drop every captured graph, since a graph replays the kernel
        launches it captured; the next steps capture on the plain
        lowering.  The sampling keys do not depend on the model, so the
        tokens stay where both lowerings compute the same logits."""
        if self.backend_degraded:
            return
        from repro_torch.models.lm import Model

        m = self.model
        self.model = Model(m.cfg, device=m.device, dtype=m.dtype,
                           param_dtype=m.param_dtype, use_kernels=False, wf=m.wf,
                           remat=m.remat)
        self.verify_backend = "torch"
        if self.spec_k > 1:
            self.draft_model, self.draft_params = spec_decode.resolve_draft(
                self.model, self.params, self._draft_spec, seed=self._seed)
            self._spec_step = spec_decode.build_spec_step(
                self.model, self.draft_model, max_seq=self.max_seq, spec_k=self.spec_k,
                verify_backend=self.verify_backend, sampler=self._sampler)
        self._graphs.drop()
        self.backend_degraded = True

    def _abort(self, st: _SchedState, exc: BaseException):
        """Unwind on an escaping exception: discard the pending round and
        the queued swap copies without waiting on the device (it may be
        the fault), fail everything held or queued, and leave
        ``last_stats`` and an audit-clean ``last_pool_stats``.  The session
        closes, so a failed session never blocks the next one."""
        self._close_session(st)
        st.pending = None
        st.pending_swaps.clear()
        reason = f"aborted: {type(exc).__name__}: {exc}"
        for slot in list(st.live):
            self._terminal(st, st.live[slot], STATUS_FAILED, slot=slot, reason=reason)
        for slot in list(st.prefilling):
            self._terminal(st, st.prefilling[slot].req, STATUS_FAILED, slot=slot,
                           reason=reason)
        while st.queue:
            self._terminal(st, st.queue.popleft(), STATUS_FAILED, reason=reason)
        st.stats["stragglers"] = st.stragglers
        st.stats["recovery_log"] = st.recovery_log
        self._attach_observability(st)
        if st.mgr is not None:
            st.mgr.allocator.fault_hook = None   # the stats' sweep must not trip it
            self.last_pool_stats = st.mgr.stats()

    # ---------------------------------------------------------------- timing
    def _timed_dispatch(self, st: _SchedState) -> PendingRound:
        """Issue one decode step; the host time it took is the round's
        ``dispatch_s``.  A ``kernel`` fault raises ``KernelBackendError``
        here and a ``straggler`` fault stalls the dispatch, both keyed to
        the dispatching round; the watchdog's clock starts before the
        stall."""
        fs = st.faults
        sleep = 0.0
        if fs is not None:
            f = fs.kernel_at(st.rnd)
            if f is not None:
                raise KernelBackendError(
                    f"injected kernel-backend failure at round {st.rnd}", fatal=f.fatal)
            sleep = fs.straggler_sleep(st.rnd)
        t_start = time.perf_counter()
        if sleep:
            time.sleep(sleep)
        pending = (self._dispatch_spec(st) if self.spec_k > 1
                   else self._dispatch_step(st))
        pending.t_start = t_start
        pending.live_before = len(pending.live)
        st.last_dispatch_s = time.perf_counter() - t_start
        return pending

    def _timed_commit(self, st: _SchedState, pending: PendingRound):
        """Fetch and account one step; the host time (the wait included)
        is the round's ``commit_s``.  The watchdog: a step whose
        dispatch-to-commit wall exceeds ``straggler_factor`` times the
        median of the last ``straggler_window`` (once 5 are known) is an
        event in ``last_stats["stragglers"]``."""
        t_c = time.perf_counter()
        self._commit_step(st, pending)
        t_end = time.perf_counter()
        st.last_commit_s = t_end - t_c
        dt = t_end - pending.t_start
        window = st.durations[-self.straggler_window:]
        if len(window) >= 5:
            med = statistics.median(window)
            if dt > self.straggler_factor * med:
                st.stragglers.append({"step": st.step_no, "duration_s": dt,
                                      "median_s": med,
                                      "live_slots": pending.live_before})
        st.durations.append(dt)
        st.step_no += 1

    # --------------------------------------------------------------- steps
    def _advanced_states(self) -> tuple:
        """The cache leaves a step advances in place (a recurrent target's
        dense states, a recurrent draft's): a capture's warm-up puts them
        back, beside tok / pos / remaining."""
        dev = self._dev
        states = ()
        if dev["cache"] is not None:
            states += self.model.state_leaves(dev["cache"])
        if dev["draft_cache"] is not None:
            states += self.draft_model.state_leaves(dev["draft_cache"])
        return states

    def _run_step(self, st: _SchedState, attend: int, fn) -> PendingRound:
        """Run a step over the fixed buffers (a graph replay on the
        pipelined CUDA engine), with this round's fault masks written
        before it and zeroed after it, then queue the copy of its output
        into the pinned host buffer and an event after it."""
        dev = self._dev
        armed = self._arm_fault_masks(st)
        self._graphs.run((self._kind, attend), fn,
                         restore=(dev["tok"], dev["pos"], dev["remaining"])
                         + self._advanced_states())
        if armed:
            dev["masks"].zero_()
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
        the paged layout their writes land in the trash page; a parked
        mid-chunk row writes at ``max_seq - 1``).  The attend bucket
        covers the live rows only.  The seed loop's step reads the whole
        cache, eagerly."""
        attend = (self._attend_len(max(st.slot_pos[s] for s in st.live) + 1)
                  if self.fused else None)
        if st.mgr is not None:
            if st.mgr.dirty:
                self._upload_tables(st)
            cache = dict(st.pool, block_tables=st.bt_dev)
        else:
            cache = st.cache
        fn = self._step_fn(cache, st.tok, st.pos, st.remaining, st.uids,
                           self._dev["out"], attend, nan_mask=self._dev["masks"][0])
        return self._run_step(st, attend, fn)

    def _dispatch_spec(self, st: _SchedState) -> PendingRound:
        """Speculative twin of :meth:`_dispatch_step`: one step proposes,
        verifies and scores a 1..spec_k token window per slot; the
        committed prefix and the page retraction are the commit's."""
        attend = self._attend_len(max(st.slot_pos[s] for s in st.live) + self.spec_k)
        if st.mgr.dirty:
            self._upload_tables(st)

        masks = self._dev["masks"]

        def fn():
            return self._spec_step(
                self.params, self.draft_params, st.pool, st.draft_cache, st.bt_dev,
                st.tok, st.pos, st.remaining, st.uids, st.spec_mask, attend,
                self._dev["out"], nan_mask=masks[0], collapse_mask=masks[1])

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
                # quarantine: the row fails alone, the batch commits on
                self._terminal(st, req, STATUS_FAILED, slot=slot, reason="nan-logits")
                continue
            req.generated.append(int(nxt_h[slot]))
            st.slot_pos[slot] += 1
            self._record_tbt(st, req.uid, now, 1)
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
                self._terminal(st, req, STATUS_FAILED, slot=slot, reason="nan-logits")
                continue
            c = int(commit_h[slot])
            req.generated.extend(int(x) for x in targets_h[slot, :c])
            st.slot_pos[slot] += c
            self._record_tbt(st, req.uid, now, c)
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
        last ``spec_disable_window`` windows averaged <= 1 committed token,
        its draft is wasted work; turn speculation off for it (it commits
        one token per step, like spec=False) for ``spec_cooldown`` steps."""
        if not req.spec or req.uid in st.spec_disabled:
            return
        hist = st.spec_hist.setdefault(req.uid, deque(maxlen=self.spec_disable_window))
        hist.append(committed)
        if len(hist) == self.spec_disable_window and sum(hist) <= len(hist):
            st.spec_mask[slot] = False
            st.spec_disabled[req.uid] = self.spec_cooldown
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
                        s = st.stats[uid]
                        s["spec_rearms"] = s.get("spec_rearms", 0) + 1

    def _record_tbt(self, st: _SchedState, uid: int, now: float, committed: int):
        """Time-between-token samples for ``committed`` tokens delivered at
        ``now``: one real gap since the request's last emission, and a zero
        for each further token (a speculative window lands its burst at
        once)."""
        if committed <= 0:
            return
        self._note_next_token(st, uid)
        last = st.last_emit.get(uid)
        if last is not None:
            st.tbt.append(now - last)
            st.tbt.extend([0.0] * (committed - 1))
        st.last_emit[uid] = now

    def _finish(self, st: _SchedState, slot: int, now: float):
        req = st.live.pop(slot)
        st.results[req.uid] = req.generated
        if st.mgr is not None:
            st.mgr.release(slot)
        st.spec_hist.pop(req.uid, None)
        st.last_emit.pop(req.uid, None)
        s = st.stats[req.uid]
        n = len(req.generated)
        s.update(status=STATUS_OK, finished_s=now, tokens=n)
        # the steady decode rate: the tokens after the first over the
        # decode interval (admission to first token is its own figure);
        # e2e_tok_s over the whole time since admission
        s["tok_s"] = (n - 1) / max(now - s["first_token_s"], 1e-9) if n > 1 else 0.0
        s["e2e_tok_s"] = n / max(now - s["admitted_s"], 1e-9)
        if s.get("spec_steps"):
            # mean committed tokens per window (1..spec_k)
            s["accept_rate"] = s["spec_tokens"] / s["spec_steps"]

    # ------------------------------------------------------------ admission
    def _next_candidate(self, st: _SchedState) -> Request:
        """Admission order: the lowest priority class first, then arrival
        (equal classes keep FIFO; the head of the line blocks, which keeps
        admission deterministic)."""
        return min(st.queue, key=lambda r: (r.priority, st.arrival[r.uid]))

    def _headroom(self, st: _SchedState, extra: int) -> int:
        """Pages the admission gate leaves free: one growth page per
        running, mid-chunk and just-taken slot, so admission never hands
        out a page an older sequence needs at the next boundary, plus the
        ``free_page_watermark`` reserve whenever anything runs (never on
        an idle pool, so a lone request always admits)."""
        n = len(st.live) + len(st.prefilling) + extra
        if n and self.free_page_watermark > 0.0:
            n += int(np.ceil(self.free_page_watermark * st.mgr.allocator.usable))
        return n

    def _admit(self, st: _SchedState):
        """Admit queued requests into free slots, priority then arrival.
        Paged gating: a free slot and enough free pages for the prompt
        beyond ``_headroom``.  Under a ``prefill_budget`` at most that
        many prompt tokens prefill a round (the chunks in flight advance
        first, and an idle engine always admits one), and a prompt longer
        than one chunk admits through the chunked path."""
        used = self._advance_prefilling(st)
        budget = self.prefill_budget
        taken: List[tuple] = []
        for slot in range(self.slots):
            if slot in st.live or slot in st.prefilling or not st.queue:
                continue
            if budget is not None and used >= budget and (
                    st.live or st.prefilling or taken):
                break
            req = self._next_candidate(st)
            if st.mgr is not None and req.uid in st.swaps:
                # a host-swapped resume restores its pages instead of
                # prefilling; blocked exactly like a too-big prompt
                if not self._admit_swapped_row(st, slot, req):
                    break
                continue
            if st.mgr is not None:
                if not st.mgr.can_admit(len(req.prompt),
                                        headroom=self._headroom(st, len(taken))):
                    break
                if st.mgr.admit(slot, len(req.prompt)) is None:
                    break
                if self._chunkable(req):
                    # the whole prompt is mapped now and written one chunk
                    # a round, between the other slots' decode steps
                    st.queue.remove(req)
                    self._bookkeep_chunked(st, slot, req)
                    used += self._prefill_chunk(st, slot)
                    continue
            st.queue.remove(req)
            taken.append((slot, req))
            used += len(req.prompt)
        if taken:
            t_admit = time.perf_counter() - st.t0
            for slot, req in taken:
                self._bookkeep_admit(st, slot, req, t_admit)
            # the dense family prefills the group as one right-padded batch;
            # the seed loop and the other families one request at a time
            if self.fused and self.model.cfg.family in _PADDED_PREFILL_FAMILIES:
                groups = [taken]
            else:
                groups = [[t] for t in taken]
            for group in groups:
                self._prefill_group(st, group, self._prompt_bucket(
                    [len(r.prompt) for _, r in group]))
            for slot, req in taken:
                self._finish_admission(st, slot, req)
        self._park_prefilling(st)

    # ----------------------------------------------------- chunked prefill
    def _chunkable(self, req: Request) -> bool:
        return self._chunked_capable() and len(req.prompt) > self._chunk_tokens

    def _bookkeep_chunked(self, st: _SchedState, slot: int, req: Request):
        """Admission bookkeeping of a chunked prompt: the slot is reserved
        (pages mapped, an admission number) but not live; it joins the
        decode batch when its last chunk commits."""
        if id(req) not in st.resumed:
            req.generated = []
        st.prefilling[slot] = _ChunkState(req)
        st.admit_seq[slot] = st.next_seq
        st.next_seq += 1
        st.slot_pos[slot] = len(req.prompt)
        st.stats[req.uid].setdefault("admitted_s", time.perf_counter() - st.t0)

    def _advance_prefilling(self, st: _SchedState) -> int:
        """One chunk of each prompt in flight, in slot order, until the
        round's budget is spent (the first always advances: a budget below
        a chunk must not stall).  Returns the prompt tokens written."""
        used = 0
        for slot in sorted(st.prefilling):
            if self.prefill_budget is not None and used >= self.prefill_budget:
                break
            used += self._prefill_chunk(st, slot)
        return used

    def _prefill_chunk(self, st: _SchedState, slot: int) -> int:
        """Write the slot's next prompt chunk through its block-table row,
        as the suffix of the chunks already resident
        (:meth:`Model.prefill_suffix`, the prefix-sharing suffix prefill
        aimed at admission).  The final chunk's logits sample the first
        token, as a whole prefill's do; a mid-chunk is whole prompt_block
        buckets (no padding) and its logits are dropped.  Returns the
        chunk's tokens."""
        cs = st.prefilling[slot]
        req = cs.req
        chunk = req.prompt[cs.done:cs.done + self._chunk_tokens]
        final = cs.done + len(chunk) >= len(req.prompt)
        t_b = _round_up(len(chunk), self.prompt_block)
        self.last_prefill_groups.append(([req.uid], t_b, [len(req.prompt)]))
        logits = self._prefill_window(st, slot, chunk, cs.done, t_b)
        cs.done += len(chunk)
        s = st.stats[req.uid]
        s["prefill_chunks"] = s.get("prefill_chunks", 0) + 1
        if final:
            del st.prefilling[slot]
            st.live[slot] = req
            self._commit_prefill(st, [slot], [req], logits)
            self._finish_admission(st, slot, req)
        return len(chunk)

    def _prefill_window(self, st: _SchedState, slot: int, toks: List[int],
                        start: int, t_b: int) -> torch.Tensor:
        """Prefill ``toks`` at positions ``start`` on, right-padded to
        ``t_b``, through the slot's block-table row; the rows before
        ``start`` are read in place.  Returns the last real token's
        logits (1, V)."""
        window = torch.zeros((1, t_b), dtype=torch.int64, device=self.device)
        window[0, :len(toks)] = torch.as_tensor(toks)
        if st.mgr.dirty:
            self._upload_tables(st)
        cache = dict(st.pool, block_tables=st.bt_dev[slot:slot + 1])
        logits, _ = self.model.prefill_suffix(
            self.params, cache, window,
            torch.tensor([start], dtype=torch.int32, device=self.device),
            torch.tensor([len(toks) - 1], device=self.device),
            self._attend_len(start + t_b), self.verify_backend)
        return logits

    def _park_prefilling(self, st: _SchedState):
        """Pin the mid-chunk slots out of the decode step's way: position
        ``max_seq - 1`` puts the row's write past its prompt (in its last
        mapped page or the trash page), where no read reaches it before
        decode overwrites it, and a huge ``remaining`` keeps its done flag
        meaningless.  Written in place into the step's buffers (a captured
        step reads them by address) before every step, since a step
        advances ``pos``."""
        if not st.prefilling:
            return
        idx = torch.as_tensor(sorted(st.prefilling), device=self.device)
        st.pos[idx] = self.max_seq - 1
        st.remaining[idx] = 1 << 30

    def _admit_shared(self, st: _SchedState):
        """Prefix-sharing admission: requests admit one at a time, priority
        then arrival, and each prompt's prefill publishes its full pages to
        the index before the next request is planned, so identical prompts
        arriving together share with each other, not only with earlier
        traffic.  The gate charges only the plan's private pages (the
        shared prefix is resident already), beyond ``_headroom``.  A
        ``prefill_budget`` charges the un-cached suffix tokens, the ones
        the admission prefills.  A host-swapped resume bypasses the
        planner: its pages come back verbatim, private, outside the
        sharing graph, and charge nothing."""
        used = 0
        budget = self.prefill_budget
        for slot in range(self.slots):
            if slot in st.live or not st.queue:
                continue
            if budget is not None and used >= budget and (st.live or used):
                break
            req = self._next_candidate(st)
            if req.uid in st.swaps:
                if not self._admit_swapped_row(st, slot, req):
                    break
                continue
            # the gate is a function of the allocator and the index alone:
            # a blocked head is planned again only once either has moved
            # (planning also refreshes the matched entries' LRU stamps)
            a = st.mgr.allocator
            # under a fault schedule the gate also depends on the round (the
            # OOM hook), so the key must not outlive it
            key = (id(req), a.alloc_count, a.release_count, a.share_count,
                   st.mgr.index.version, st.rnd if st.faults is not None else None)
            if st.gate_block == key:
                break
            plan = st.mgr.plan_admit(req.prompt)
            if (not st.mgr.can_admit_plan(plan, headroom=self._headroom(st, 0))
                    or st.mgr.admit_prefix(slot, plan) is None):
                st.gate_block = key
                break
            st.gate_block = None
            st.queue.remove(req)
            used += len(req.prompt) - plan.cached_tokens
            self._bookkeep_admit(st, slot, req, time.perf_counter() - st.t0)
            # the first admission's figure: a preemption resume re-matches
            # its own folded prompt, which would count the reuse twice
            st.stats[req.uid].setdefault("cached_prefix_tokens", plan.cached_tokens)
            if plan.cached_tokens > 0:
                self._prefill_suffix_row(st, slot, req, plan)
            else:
                self._prefill_group(st, [(slot, req)],
                                    self._prompt_bucket([len(req.prompt)]))
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
        """First-token time, admission to first token, the TBT clock, and
        completion of a budget the admission already exhausted (no-op for a
        request prefill failed).  A resume keeps its first token's time
        and its last emission, so a preemption's stall is one honest
        gap."""
        s = st.stats[req.uid]
        if s["status"] is not None:
            return
        now = time.perf_counter() - st.t0
        s.setdefault("first_token_s", now)
        s["admit_to_first_s"] = s["first_token_s"] - s["admitted_s"]
        st.last_emit.setdefault(req.uid, s["first_token_s"])
        if req.max_new_tokens - len(req.generated) <= 0:
            self._finish(st, slot, now)

    def _admit_swapped_row(self, st: _SchedState, slot: int, req: Request) -> bool:
        """Resume a host-swapped request: map fresh pages under the
        admission gate's ``_headroom``, write the saved pages
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
        if st.mgr.available() - self._headroom(st, 0) < handle.n_blocks:
            return False
        pages = st.mgr.admit_swapped(slot, handle)
        if pages is None:
            return False
        del st.swaps[req.uid]
        st.queue.remove(req)
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
        bucket = min(self.max_seq, _round_up(len(prompt), self.prompt_block))
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
        t_b = _round_up(len(suffix), self.prompt_block)
        self.last_prefill_groups.append(([req.uid], t_b, [len(req.prompt)]))
        logits = self._prefill_window(st, slot, suffix, plan.cached_tokens, t_b)
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
                self._terminal(st, req, STATUS_FAILED, slot=slot, reason="nan-logits")
                continue
            req.generated.append(int(f))
            self._note_next_token(st, req.uid)

    def _note_next_token(self, st: _SchedState, uid: int):
        """A requeued request's first token since its recovery: its time in
        that recovery's ``last_stats["recovery_log"]`` entry."""
        entry = st.awaiting_next.pop(uid, None)
        if entry is not None:
            entry["next_token_s"][uid] = time.perf_counter() - st.t0

    # ----------------------------------------------------------- preemption
    def _grow_or_preempt(self, st: _SchedState):
        """Step boundary: every live slot's next write span must be mapped,
        one position for plain decode and ``spec_k`` for a speculative
        window (positions past max_seq need no page; their writes land in
        the trash page).  Grow on demand, oldest first; when the pool runs
        out, preempt :meth:`_preempt_victim` (without deadlines the newest
        of the least important class: the oldest always makes progress)."""
        for slot in sorted(st.live, key=lambda s: st.admit_seq[s]):
            while slot in st.live:
                first = st.slot_pos[slot]
                if st.mgr.ensure_span(slot, first, first + self.spec_k - 1):
                    break
                self._preempt(st, self._preempt_victim(st))

    def _slack_ms(self, st: _SchedState, req: Request, now_ms: float) -> float:
        """The request's deadline slack in ms, the least over its deadlines
        still running (inf with none), from its own enqueue time as in
        :meth:`_expired`."""
        dls = []
        age_ms = now_ms - st.stats[req.uid]["enqueued_s"] * 1e3
        if req.deadline_ms is not None:
            dls.append(req.deadline_ms - age_ms)
        if (req.ttft_deadline_ms is not None
                and "first_token_s" not in st.stats[req.uid]):
            dls.append(req.ttft_deadline_ms - age_ms)
        return min(dls) if dls else float("inf")

    def _preempt_victim(self, st: _SchedState) -> int:
        """The most slack first (a request with no deadline, or the most
        time to spare, yields before one about to miss), then the least
        important class, then the newest, live or mid-chunk alike (a
        chunked prompt holds its whole page span).  Without deadlines every
        slack is inf and, at equal priorities, this is the newest slot."""
        now_ms = (time.perf_counter() - st.t0) * 1e3

        def key(slot):
            req = st.live[slot] if slot in st.live else st.prefilling[slot].req
            return (self._slack_ms(st, req, now_ms), req.priority, st.admit_seq[slot])
        return max([*st.live, *st.prefilling], key=key)

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
        cannot overwrite the snapshot.  Serial, the copy is synchronous.
        A mid-chunk prompt has no complete page image worth keeping: it
        always resumes by recompute."""
        if slot in st.prefilling:
            req, swap = st.prefilling.pop(slot).req, False
        else:
            req, swap = st.live.pop(slot), self._swap_wins(st)
        if swap:
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
