"""Paged KV cache: block pool, host-side page allocator, block tables,
and the two memory tiers (int8 pages, host swap).

Counterpart of ``repro.serve.kv_cache`` for what admission, growth,
speculative write-then-retract, release, quantized storage and host-swap
preemption use.  Layout contract (paged):

  cache = {"k_pages": (L, P, page_size, Hkv, D),
           "v_pages": (L, P, page_size, Hkv, D),
           "block_tables": (slots, max_blocks) int32}

``block_tables[s, j]`` is the page holding slot s positions
[j * page_size, (j + 1) * page_size).  Page 0 is the TRASH page: never
allocated, and every dead or unmapped table entry points at it, so the
writes of finished slots (which keep "decoding" inside the batched step)
land there instead of in pages reused by live slots.

The allocator is host-side and synchronous: pages move at step
boundaries (admission, growth, preemption, completion), never inside a
decode step.  Device-side writes here are in place (the reference
donates buffers to get the same effect).

Tiered memory:

  kv_dtype  ``"int8"`` stores pages symmetric-quantized, with one float32
            scale per cached row of every page in ``k_scales`` /
            ``v_scales`` (L, P, page_size) beside the values.  The scale
            is absmax(row) / 127 over the row's (Hkv, D) values, so a
            row's stored bytes depend only on that row's values (not on
            its neighbours): the same values store the same bytes through
            prefill, a decode write or a requeue's recompute, equal to
            the reference's bit for bit, and a swap-in restores them
            exactly.  Both paged attention kernels dequantize inside
            their gather.
  swap      :meth:`PagedCacheManager.swap_out` copies a preempted slot's
            pages (values and scales) into host buffers, pinned on CUDA,
            before it releases them; :meth:`PagedCacheManager.admit_swapped`
            and :func:`swap_in_pages` restore them into fresh pages.
            With ``async_copy=True`` the device-to-host copy is queued
            (``non_blocking``) behind an on-device slice of the pages and
            an event; :meth:`SwapHandle.materialize` waits on the event
            (the pipelined engine does so at its next commit boundary), and
            the handle keeps the device slice alive until then, so the
            source pages may be released and overwritten at once.

Prefix sharing.  Pages are refcounted, so slots whose prompts share a
page-aligned prefix map the same physical pages (``serve.prefix_index``
resolves the prefix, :meth:`PagedCacheManager.admit_prefix` maps it).
The ownership rules are hard errors, not best effort:

  * a page frees only when its refcount reaches 0 (``release`` is a
    decrement; releasing a free page raises);
  * a shared page (refcount > 1) is read-only: every write span must be
    private (:meth:`PageAllocator.assert_writable`);
  * a writer landing inside a shared page forks it copy-on-write: a
    private page, the rows copied (:func:`copy_pages`), the table
    remapped.  By construction that happens only to the last page of a
    fully matched, page-aligned prompt; decode growth and the suffix
    prefill always write private pages.

Audit.  :meth:`PagedCacheManager.audit` sweeps the allocator, the block
tables and the prefix index against each other (``serve.audit``), and
every :meth:`PagedCacheManager.stats` carries the verdict in its
``audit_*`` fields.  ``PageAllocator.fault_hook`` is where the engine's
fault schedule denies or fails an allocation (``serve.faults``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serve.prefix_index import PrefixIndex

CACHE_LAYOUTS = ("dense", "paged")

# storage tiers for the paged pool; None / "auto" keeps the model's
# compute dtype
KV_DTYPES = ("bf16", "int8")

# page index every dead / unmapped block-table entry points at; the
# allocator never hands it out
TRASH_PAGE = 0

# the f32 reciprocal the reference's scale multiplies by (jnp promotes the
# Python float 1/127 to the row's f32)
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def blocks_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` positions."""
    return cdiv(max(n_tokens, 0), page_size)


def resolve_kv_dtype(kv_dtype, default: torch.dtype):
    """``kv_dtype`` flag -> (pool value dtype, quantized?)."""
    if kv_dtype in (None, "auto"):
        return default, False
    if kv_dtype == "bf16":
        return torch.bfloat16, False
    if kv_dtype == "int8":
        return torch.int8, True
    raise ValueError(f"kv_dtype must be one of {KV_DTYPES} or None/'auto'; "
                     f"got {kv_dtype!r}")


def quantize_kv_rows(x: torch.Tensor):
    """Symmetric int8 quantization of K/V rows: ``x`` is (..., H, D), and
    each leading-index row quantizes alone with its own absmax scale.
    Returns ``(q int8 (..., H, D), scale float32 (...))``, q * scale ~= x.

    The bytes equal the reference's (``quantize_kv_rows``) bit for bit:
    the row in f32, amax jointly over (H, D), scale = amax * f32(1/127)
    (a multiply by the reciprocal, not a division by 127),
    round(x / scale) half to even, clipped to +-127.  An all-zero row
    keeps scale 0 (it dequantizes to exact 0)."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    scale = amax * _INV_127
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None, None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows`: q (..., H, D), scale (...)."""
    return q.float() * scale[..., None, None]


class PageAllocator:
    """Refcounted free-list allocator over pages [1, num_pages).

    ``alloc(n)`` is all-or-nothing and LIFO: freed pages are reused
    most-recently-freed first, which keeps the working set of hot pages
    small.  Every allocated page carries a refcount: ``alloc`` starts it at
    1, ``share`` adds one (prefix sharing maps the same physical page into
    another table), ``release`` takes one away and frees the page only at
    0.  Releasing a page that is not allocated, sharing one, or writing to
    a shared one (:meth:`assert_writable`) is a hard error.

    ``used`` counts physical pages (a page shared by N holders counts
    once; ``used + free == usable``) and ``logical`` counts references:
    ``logical - used`` pages are what sharing saves."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the trash "
                             f"page); got {num_pages}")
        self.num_pages = num_pages
        # LIFO free list; initialized so page 1 is handed out first
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self._logical = 0
        # fault injection (None by default): called as fault_hook(n) before
        # an allocation of n > 0 pages is granted; True denies it as if the
        # pool were exhausted, and an exception raised inside propagates (a
        # hard OOM).  The engine installs it per session from its schedule
        self.fault_hook = None
        self.alloc_count = 0      # pages ever handed out
        self.free_count = 0       # pages ever returned to the free list
        self.share_count = 0      # references ever added by sharing
        self.release_count = 0    # references ever dropped (freed or not)
        self.peak_used = 0
        self.peak_logical = 0

    @property
    def usable(self) -> int:
        return self.num_pages - 1

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        """Physical pages allocated: a shared page counts once."""
        return len(self._refs)

    @property
    def logical(self) -> int:
        """Sum of the refcounts: the pages the holders together believe
        they own."""
        return self._logical

    def utilization(self) -> float:
        return self.used / self.usable

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def is_shared(self, page: int) -> bool:
        return self.refcount(page) > 1

    def assert_writable(self, page: int):
        """Write spans must target private pages: a shared page is
        read-only until copy-on-write forks it."""
        r = self.refcount(page)
        if r != 1:
            kind = "shared" if r > 1 else "unallocated"
            raise ValueError(f"write to {kind} page {page} (refcount {r})")

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages at refcount 1, or None if fewer than n are free (nothing
        allocated)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > 0 and self.fault_hook is not None and self.fault_hook(n):
            return None     # injected OOM: denied despite free pages
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self._logical += n
        self.alloc_count += n
        self.peak_used = max(self.peak_used, self.used)
        self.peak_logical = max(self.peak_logical, self._logical)
        return pages

    def share(self, pages: Sequence[int]):
        """Add one reference to each page (all must be allocated)."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"share of unallocated page {p}")
        for p in pages:
            self._refs[p] += 1
        self._logical += len(pages)
        self.share_count += len(pages)
        self.peak_logical = max(self.peak_logical, self._logical)

    def release(self, pages: Sequence[int]) -> int:
        """Drop one reference a page; pages reaching refcount 0 return to
        the free list.  Returns how many were freed."""
        freed = 0
        for p in pages:
            r = self._refs.get(p)
            if r is None:
                raise ValueError(f"double free / foreign page {p}")
            if r == 1:
                del self._refs[p]
                self._free.append(p)
                freed += 1
            else:
                self._refs[p] = r - 1
        self._logical -= len(pages)
        self.free_count += freed
        self.release_count += len(pages)
        return freed

    def audit(self) -> List[str]:
        """The allocator's own invariants (``serve.audit``): the errors
        found, [] when consistent."""
        from repro_torch.serve.audit import audit_allocator

        return audit_allocator(self)


@dataclasses.dataclass
class PagedStats:
    """Pool accounting snapshot (see :meth:`PagedCacheManager.stats`).

    ``peak_used_pages`` / ``peak_tokens`` / ``peak_utilization`` are the
    pool's physical high-water marks (a page shared by N slots counts
    once; with prefix sharing, the end-of-serve ``used_pages`` are what
    the prefix index still caches).  ``logical_*`` count every slot's
    mapping apart, and ``sharing_ratio`` is the high-water logical /
    physical ratio of the slots' mappings (1.0 when nothing is shared).
    ``cow_forks`` counts pages forked copy-on-write at admission,
    ``evictions`` index entries reclaimed under allocation pressure,
    ``cached_prefix_tokens`` prompt tokens admissions took from cache."""
    num_pages: int
    page_size: int
    used_pages: int
    free_pages: int
    peak_used_pages: int
    peak_tokens: int
    utilization: float
    peak_utilization: float
    allocs: int
    frees: int
    retracts: int     # pages taken back by speculative write-then-retract
    # prefix sharing
    logical_pages: int = 0
    physical_pages: int = 0
    logical_tokens: int = 0
    physical_tokens: int = 0
    peak_logical_pages: int = 0
    sharing_ratio: float = 1.0
    shares: int = 0
    cow_forks: int = 0
    evictions: int = 0
    index_pages: int = 0
    cached_prefix_tokens: int = 0
    # tiered memory: storage dtype and host-swap traffic
    kv_dtype: Optional[str] = None
    swap_outs: int = 0
    swap_ins: int = 0
    swapped_out_bytes: int = 0
    swapped_in_bytes: int = 0
    # the invariant audit (serve.audit), swept by stats(): leak freedom
    # is a field to read, not something to rebuild from internals
    audit_ok: bool = True
    audit_orphan_pages: int = 0
    audit_refcount_mismatches: int = 0
    audit_errors: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class AdmitPlan:
    """One prompt's admission, resolved against the prefix index
    (:meth:`PagedCacheManager.plan_admit`): the indexed pages the slot
    will share, whether the boundary page is forked copy-on-write
    (``cow_src`` -> ``cow_dst``, the latter filled at admission), how many
    prompt positions come from cache (``cached_tokens``: prefill computes
    only the rest), and how many private pages admission allocates (the
    only pages the admission gate charges)."""
    prompt_len: int
    n_blocks: int
    shared_pages: List[int]
    cached_tokens: int
    private_blocks: int
    cow_src: Optional[int] = None
    cow_dst: Optional[int] = None


class PagedCacheManager:
    """Host mirror of the paged cache: allocator + per-slot block tables.

    The engine owns the device pool; this class owns the mapping and hands
    the engine a fresh (slots, max_blocks) table whenever it changed
    (``dirty``), one small host-to-device copy per change, not per token.

    With a ``prefix_index`` it also owns prefix sharing: :meth:`plan_admit`
    resolves a prompt to its longest cached prefix, :meth:`admit_prefix`
    maps those pages into the slot's table (refcount + 1, no copies), and
    :meth:`register_prefix` publishes a prompt's full pages after its
    prefill.  The index holds a reference of its own on every published
    page, so a released request's prefix lingers as reusable cache;
    pages only the index holds are reclaimed, in the index's victim
    order, when an allocation would otherwise fail."""

    def __init__(self, num_pages: int, page_size: int, slots: int, max_seq: int,
                 prefix_index: Optional[PrefixIndex] = None,
                 kv_dtype: Optional[str] = None):
        self.page_size = page_size
        self.max_blocks = cdiv(max_seq, page_size)
        self.allocator = PageAllocator(num_pages)
        self.tables = np.full((slots, self.max_blocks), TRASH_PAGE, np.int32)
        self.owned: List[List[int]] = [[] for _ in range(slots)]
        self.index = prefix_index
        self.kv_dtype = kv_dtype
        self.dirty = True
        self.retract_count = 0    # pages taken back by speculative rollback
        self.cow_forks = 0
        self.evictions = 0
        self.cached_tokens_total = 0
        self.peak_logical_pages = 0
        self.peak_sharing_ratio = 1.0
        self.swap_outs = 0
        self.swap_ins = 0
        self.swapped_out_bytes = 0
        self.swapped_in_bytes = 0

    # ----------------------------------------------------------- internals
    def _evictable_pred(self, page: int) -> bool:
        # reclaimable when the index holds the only reference
        return self.allocator.refcount(page) == 1

    def _alloc(self, n: int) -> Optional[List[int]]:
        """``allocator.alloc`` with lazy index eviction: when the free list
        cannot cover ``n``, reclaim index-only entries first."""
        pages = self.allocator.alloc(n)
        if pages is None and self.index is not None:
            evicted = self.index.evict(n - self.allocator.free, self._evictable_pred)
            if evicted:
                self.allocator.release(evicted)
                self.evictions += len(evicted)
                pages = self.allocator.alloc(n)
        return pages

    def _probe(self):
        """Track the slots' logical / physical high-water marks."""
        logical = sum(len(o) for o in self.owned)
        self.peak_logical_pages = max(self.peak_logical_pages, logical)
        distinct = len({p for o in self.owned for p in o})
        if distinct:
            self.peak_sharing_ratio = max(self.peak_sharing_ratio, logical / distinct)

    def _map(self, slot: int, pages: Sequence[int]):
        if self.owned[slot]:
            raise ValueError(f"slot {slot} already mapped")
        self.tables[slot, :len(pages)] = pages
        self.owned[slot] = list(pages)
        self.dirty = True
        self._probe()

    # ------------------------------------------------------------- queries
    def can_admit(self, prompt_len: int, headroom: int = 0) -> bool:
        """Enough free pages for a prompt, keeping ``headroom`` pages in
        reserve (the engine passes one growth page per live slot)."""
        return (self.allocator.free
                >= blocks_for(prompt_len, self.page_size) + headroom)

    def can_admit_plan(self, plan: AdmitPlan, headroom: int = 0) -> bool:
        """The prefix-sharing gate: only the plan's private pages are
        charged (the shared ones are resident already), and index-only
        entries count as reclaimable, bar the pages this plan is about to
        share or fork from."""
        pinned = set(plan.shared_pages)
        if plan.cow_src is not None:
            pinned.add(plan.cow_src)
        return self.available(exclude=pinned) >= plan.private_blocks + headroom

    def available(self, exclude: Optional[set] = None) -> int:
        """Pages an allocation can get now: the free ones, and with an
        index the entries only it holds (bar ``exclude``)."""
        avail = self.allocator.free
        if self.index is not None:
            avail += self.index.evictable(self._evictable_pred, exclude=exclude)
        return avail

    def fits_worst_case(self, prompt_len: int, max_new: int, max_seq: int) -> bool:
        """Can this request ever complete alone in the pool?  Positions
        written: the prompt plus one per decode step (the last sampled
        token is never written), capped by max_seq.  (Index-held pages do
        not shrink this: alone in the pool, every one is evictable.)"""
        longest = min(prompt_len + max(max_new - 1, 0), max_seq)
        return blocks_for(longest, self.page_size) <= self.allocator.usable

    # ----------------------------------------------------------- mutation
    def admit(self, slot: int, prompt_len: int) -> Optional[List[int]]:
        """Map blocks for a prompt; None (nothing changed) if pages lack."""
        if self.owned[slot]:
            raise ValueError(f"slot {slot} already mapped")
        pages = self._alloc(blocks_for(prompt_len, self.page_size))
        if pages is None:
            return None
        self._map(slot, pages)
        return pages

    def plan_admit(self, prompt: Sequence[int]) -> AdmitPlan:
        """Resolve a prompt against the prefix index (its longest cached
        page-granular prefix); nothing is allocated or shared until
        :meth:`admit_prefix`.

        The write frontier is always private: when the match covers every
        page of a page-aligned prompt, the last matched page would take
        the suffix's recompute and the first decode row, so the plan forks
        it copy-on-write (``cow_src``) instead of sharing it: one page
        allocated and copied, ``cached_tokens`` all but the last token.
        Otherwise the suffix (at least one token, from the first
        un-cached position) prefills into fresh private pages."""
        p = len(prompt)
        n_blocks = blocks_for(p, self.page_size)
        if self.index is None:
            return AdmitPlan(prompt_len=p, n_blocks=n_blocks, shared_pages=[],
                             cached_tokens=0, private_blocks=n_blocks)
        matched = self.index.match(prompt)
        cow_src = None
        if matched and len(matched) * self.page_size == p:
            if p == 1:
                # a one-token prompt: a fork would cache 0 tokens
                matched, cached = [], 0
            else:
                cow_src = matched[-1]
                matched = matched[:-1]
                cached = p - 1
        else:
            cached = len(matched) * self.page_size
        return AdmitPlan(prompt_len=p, n_blocks=n_blocks, shared_pages=list(matched),
                         cached_tokens=cached, private_blocks=n_blocks - len(matched),
                         cow_src=cow_src)

    def admit_prefix(self, slot: int, plan: AdmitPlan) -> Optional[AdmitPlan]:
        """Map a planned admission: share the cached prefix pages into the
        slot's table, allocate the private pages (and the fork's target,
        returned in ``plan.cow_dst``; the engine copies the page).
        All-or-nothing: when pages lack, the shares are rolled back and
        nothing changed (None).

        ``cow_src`` is pinned (an extra reference) from here until
        :meth:`cow_release`: without the pin the fork's source could sit
        at refcount 1 (index only), and an allocation before the copy
        could evict and reuse the very page the copy reads."""
        if self.owned[slot]:
            raise ValueError(f"slot {slot} already mapped")
        pins = list(plan.shared_pages)
        if plan.cow_src is not None:
            pins.append(plan.cow_src)
        if pins:
            self.allocator.share(pins)
        pages = self._alloc(plan.private_blocks)
        if pages is None:
            if pins:
                self.allocator.release(pins)
            return None
        if plan.cow_src is not None:
            plan.cow_dst = pages[0]
            self.cow_forks += 1
        self._map(slot, list(plan.shared_pages) + pages)
        self.cached_tokens_total += plan.cached_tokens
        return plan

    def cow_release(self, plan: AdmitPlan):
        """Drop the fork-source pin :meth:`admit_prefix` took; call it once
        the copy into ``cow_dst`` is queued."""
        if plan.cow_src is not None:
            self.allocator.release([plan.cow_src])

    def register_prefix(self, slot: int, prompt: Sequence[int]) -> int:
        """Publish a prompt's full pages to the index (after its prefill
        wrote them).  The index takes a reference of its own on each page
        it newly holds, so the prefix outlives the request; pages already
        indexed (the shared prefix, or a CoW fork whose original sits at
        that node) are left as they are.  Returns the pages newly
        published."""
        if self.index is None:
            return 0
        fp = len(prompt) // self.page_size
        if fp == 0:
            return 0
        new = self.index.insert(list(prompt), [int(self.tables[slot, j]) for j in range(fp)])
        if new:
            self.allocator.share(new)
        return len(new)

    def ensure_block(self, slot: int, block: int) -> bool:
        """Map logical block ``block`` for ``slot`` (growth at a step
        boundary).  True if already mapped or newly allocated.  A mapped
        block must be private: growth spans are write spans (decode growth
        lands past a shared prefix by construction)."""
        if block >= self.max_blocks:
            return True  # position cap: decode stops at max_seq anyway
        page = int(self.tables[slot, block])
        if page != TRASH_PAGE:
            self.allocator.assert_writable(page)
            return True
        pages = self._alloc(1)
        if pages is None:
            return False
        self.tables[slot, block] = pages[0]
        self.owned[slot].append(pages[0])
        self.dirty = True
        self._probe()
        return True

    def ensure_span(self, slot: int, first_pos: int, last_pos: int) -> bool:
        """Map every block covering positions [first_pos, last_pos], the
        speculative window's write span.  False as soon as a block cannot
        be granted (the engine preempts and retries); blocks mapped before
        that stay mapped, since the retry needs them anyway."""
        for blk in range(first_pos // self.page_size,
                         last_pos // self.page_size + 1):
            if not self.ensure_block(slot, blk):
                return False
        return True

    def retract_above(self, slot: int, n_tokens: int) -> int:
        """Speculative rollback: unmap every block holding only positions
        >= ``n_tokens`` (write-then-retract).  A window maps blocks up to
        pos + k - 1 before the verify step; when fewer tokens commit, the
        tail blocks hold only rejected rows and a table edit hands their
        pages back, no copies.  Stale rows in the kept boundary block are
        overwritten by the next window (masked until then).  Retraction is
        a refcount release: a page another slot or the index still holds
        leaves this slot's table but not the pool.  Returns the number of
        pages retracted from the slot."""
        keep = blocks_for(n_tokens, self.page_size)   # blocks [0, keep)
        dropped = []
        for blk in range(keep, self.max_blocks):
            page = int(self.tables[slot, blk])
            if page == TRASH_PAGE:
                continue
            self.tables[slot, blk] = TRASH_PAGE
            self.owned[slot].remove(page)
            dropped.append(page)
        if dropped:
            self.allocator.release(dropped)
            self.retract_count += len(dropped)
            self.dirty = True
            self._probe()
        return len(dropped)

    def release(self, slot: int):
        """Drop the slot's reference on every page it maps and point its
        table at trash.  Pages shared with other slots or published to the
        index stay allocated until their last holder lets go."""
        if self.owned[slot]:
            self.allocator.release(self.owned[slot])
            self.owned[slot] = []
            self.tables[slot, :] = TRASH_PAGE
            self.dirty = True
            self._probe()

    # ----------------------------------------------------- host-swap tier
    def swap_out(self, slot: int, pool: Dict[str, torch.Tensor],
                 n_tokens: int, async_copy: bool = False) -> "SwapHandle":
        """Page a slot out to host buffers: copy every mapped page of the
        slot (values and scales) device-to-host, then release the slot's
        references.  The copy comes strictly before the release, so a
        same-round admission cannot overwrite pages still being copied.
        Shared pages are copied like private ones: a swap-in restores them
        into fresh private pages, outside the sharing graph.

        ``async_copy=True`` queues the copy (:func:`swap_out_pages_async`)
        and returns a handle that must be materialized
        (:meth:`SwapHandle.materialize`) before it is restored; its device
        slice of the pages is taken before the release, in stream order,
        so later writes to the released pages cannot reach it."""
        blocks = [int(p) for p in self.tables[slot] if p != TRASH_PAGE]
        if async_copy:
            data, pending = swap_out_pages_async(pool, blocks)
        else:
            data, pending = swap_out_pages(pool, blocks), None
        handle = SwapHandle(n_blocks=len(blocks), n_tokens=n_tokens, data=data,
                            page_size=self.page_size, kv_dtype=self.kv_dtype,
                            pending=pending)
        self.swap_outs += 1
        self.swapped_out_bytes += handle.nbytes
        self.release(slot)
        return handle

    def admit_swapped(self, slot: int, handle: "SwapHandle") -> Optional[List[int]]:
        """Map fresh private pages for a swapped-out slot (the engine then
        writes ``handle.data`` into them with :func:`swap_in_pages`).
        All-or-nothing like :meth:`admit`: None when pages lack.  The
        handle may come from another manager, but its page format must
        match: another ``page_size`` or ``kv_dtype`` raises instead of
        casting quantized bytes."""
        if handle.page_size is not None and handle.page_size != self.page_size:
            raise ValueError(
                f"swap handle page_size={handle.page_size} cannot restore "
                f"into a page_size={self.page_size} pool")
        if ((handle.kv_dtype is not None and handle.kv_dtype != self.kv_dtype)
                or ("k_scales" in handle.data) != (self.kv_dtype == "int8")):
            raise ValueError(
                f"swap handle kv_dtype={handle.kv_dtype!r} cannot restore "
                f"into a kv_dtype={self.kv_dtype!r} pool (quantized bytes "
                "do not cast)")
        if self.owned[slot]:
            raise ValueError(f"slot {slot} already mapped")
        pages = self._alloc(handle.n_blocks)
        if pages is None:
            return None
        self._map(slot, pages)
        self.swap_ins += 1
        self.swapped_in_bytes += handle.nbytes
        return pages

    def device_tables(self, device) -> torch.Tensor:
        self.dirty = False
        return torch.as_tensor(self.tables, device=device)

    def upload_tables(self, out: torch.Tensor, staging: "TableStaging"):
        """Write the block tables into the fixed device buffer ``out`` in
        place (a captured step reads it by address), through ``staging``'s
        pinned host copy: a queued, non-blocking upload."""
        self.dirty = False
        staging.upload(self.tables, out)

    def prefill_page_idx(self, slot: int, n_blocks: int) -> np.ndarray:
        """(n_blocks,) page indices for a slot's first blocks, trash-padded
        past what the slot owns (scatter targets for padded prefill).
        Scatter targets are writes, so every page must be private: a
        shared-prefix admission scatters nothing (its suffix prefill
        writes through the block tables), and a shared page here raises."""
        idx = np.full((n_blocks,), TRASH_PAGE, np.int32)
        m = min(n_blocks, len(self.owned[slot]))
        for j in range(m):
            self.allocator.assert_writable(int(self.tables[slot, j]))
        idx[:m] = self.tables[slot, :m]
        return idx

    def audit(self):
        """The cross-layer invariant sweep over allocator, block tables and
        prefix index (``serve.audit.audit_manager``): an ``AuditReport``."""
        from repro_torch.serve.audit import audit_manager

        return audit_manager(self)

    def stats(self) -> PagedStats:
        a = self.allocator
        logical = sum(len(o) for o in self.owned)
        distinct = len({p for o in self.owned for p in o})
        report = self.audit()
        return PagedStats(
            audit_ok=report.ok, audit_orphan_pages=report.orphan_pages,
            audit_refcount_mismatches=report.refcount_mismatches,
            audit_errors=report.errors,
            num_pages=a.num_pages, page_size=self.page_size,
            used_pages=a.used, free_pages=a.free, peak_used_pages=a.peak_used,
            peak_tokens=a.peak_used * self.page_size, utilization=a.utilization(),
            peak_utilization=a.peak_used / a.usable, allocs=a.alloc_count,
            frees=a.free_count, retracts=self.retract_count,
            logical_pages=logical, physical_pages=distinct,
            logical_tokens=logical * self.page_size,
            physical_tokens=distinct * self.page_size,
            peak_logical_pages=self.peak_logical_pages,
            sharing_ratio=self.peak_sharing_ratio, shares=a.share_count,
            cow_forks=self.cow_forks, evictions=self.evictions,
            index_pages=len(self.index) if self.index is not None else 0,
            cached_prefix_tokens=self.cached_tokens_total, kv_dtype=self.kv_dtype,
            swap_outs=self.swap_outs, swap_ins=self.swap_ins,
            swapped_out_bytes=self.swapped_out_bytes,
            swapped_in_bytes=self.swapped_in_bytes)


# ---------------------------------------------------------------------------
# device-side pool helpers (in place)
# ---------------------------------------------------------------------------

def init_page_pool(n_layers: int, num_pages: int, page_size: int,
                   n_kv_heads: int, d_head: int, dtype: torch.dtype,
                   device, kv_dtype: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The shared block pool: (L, P, page_size, Hkv, D) per K and V.
    ``kv_dtype="int8"`` stores the values quantized and adds ``k_scales``
    / ``v_scales`` (L, P, page_size) float32, zero-initialized: an
    unwritten row dequantizes to exact 0, as the float pools' zeros."""
    val_dtype, quantized = resolve_kv_dtype(kv_dtype, dtype)
    shape = (n_layers, num_pages, page_size, n_kv_heads, d_head)
    pool = {"k_pages": torch.zeros(shape, dtype=val_dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=val_dtype, device=device)}
    if quantized:
        pool["k_scales"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        pool["v_scales"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
    return pool


def pool_is_quantized(pages: Dict[str, torch.Tensor]) -> bool:
    """True when the pool carries int8 values and per-row scale leaves."""
    return "k_scales" in pages


def scatter_prefill(pages: Dict[str, torch.Tensor],
                    pcache: Dict[str, torch.Tensor],
                    page_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write a dense prefilled cache {"k"/"v": (L, B, S, H, D)} through
    ``page_idx`` (B, ceil(S / page_size)) into the pool, in place.  Rows'
    tails past their prompt point at the trash page (duplicate trash
    targets may collide; only padding lands there).  A quantized pool
    stores each row quantized (:func:`quantize_kv_rows`) and its scale."""
    ps = pages["k_pages"].shape[2]
    quantized = pool_is_quantized(pages)
    flat = page_idx.reshape(-1).to(device=pages["k_pages"].device, dtype=torch.long)
    for name, src_name in (("k_pages", "k"), ("v_pages", "v")):
        src = pcache[src_name]
        l, b, s, h, d = src.shape
        nb = cdiv(s, ps)
        if nb * ps != s:
            src = torch.nn.functional.pad(src, (0, 0, 0, 0, 0, nb * ps - s))
        src = src.reshape(l, b * nb, ps, h, d)
        if quantized:
            q, scale = quantize_kv_rows(src)               # scale (l, b*nb, ps)
            pages[name][:, flat] = q
            pages[name[0] + "_scales"][:, flat] = scale
        else:
            pages[name][:, flat] = src.to(pages[name].dtype)
    return pages


def copy_pages(pages: Dict[str, torch.Tensor], src_idx: Sequence[int],
               dst_idx: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Copy-on-write fork: copy physical pages ``src_idx`` into ``dst_idx``
    across every layer of every pool leaf (a quantized pool's row scales
    too), in place.  One page copy a fork, against recomputing the whole
    prefix without sharing."""
    for leaf in pages.values():
        src = torch.as_tensor(list(src_idx), dtype=torch.long, device=leaf.device)
        dst = torch.as_tensor(list(dst_idx), dtype=torch.long, device=leaf.device)
        leaf.index_copy_(1, dst, leaf.index_select(1, src))
    return pages


def write_slots(cache: Dict[str, torch.Tensor], pcache: Dict[str, torch.Tensor],
                slots: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Copy a k-row prefilled dense cache (L, k, S, H, D) into positions
    [0, S) of slots ``slots`` of the dense pool, in place."""
    idx = torch.as_tensor(list(slots), dtype=torch.long,
                          device=next(iter(cache.values())).device)
    for name, pool in cache.items():
        src = pcache[name]
        pool[:, idx, :src.shape[2]] = src.to(pool.dtype)
    return cache


def gather_slot(pages: Dict[str, torch.Tensor], table_row: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """Debug/test helper: one slot's dense (L, NB * ps, H, D) K/V view
    through its block-table row; unmapped (trash) entries read as NaN.
    Shared pages resolve like private ones: sharing lives in the tables
    alone.  A quantized pool comes back dequantized (float32), poison
    included."""
    idx = table_row.to(device=pages["k_pages"].device, dtype=torch.long)
    unmapped = idx == TRASH_PAGE
    out = {}
    for name, dense in (("k_pages", "k"), ("v_pages", "v")):
        g = pages[name].index_select(1, idx)                 # (L, NB, ps, H, D)
        if pool_is_quantized(pages):
            g = dequantize_kv(g, pages[name[0] + "_scales"].index_select(1, idx))
        g = torch.where(unmapped[None, :, None, None, None],
                        torch.tensor(float("nan"), dtype=g.dtype, device=g.device), g)
        l, nb, ps, h, d = g.shape
        out[dense] = g.reshape(l, nb * ps, h, d)
    return out


# ---------------------------------------------------------------------------
# host-swap tier: page-out / page-in between the device pool and host RAM
# ---------------------------------------------------------------------------

class TableStaging:
    """A pinned host copy of the block tables (or another small host
    array, of ``dtype``: the engine's fault masks) for queued uploads into
    a fixed device buffer.  The host copy is rewritten only after the
    previous upload has run (an event fences it), since a queued copy
    reads pinned memory when it executes, not when it is issued.  On
    CPU the upload is a plain copy."""

    def __init__(self, shape, device, dtype: torch.dtype = torch.int32):
        cuda = torch.device(device).type == "cuda"
        self.host = torch.empty(shape, dtype=dtype, pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None
        self._queued = False

    def upload(self, tables: np.ndarray, out: torch.Tensor):
        if self._queued:
            self.event.synchronize()
        self.host.numpy()[...] = tables
        out.copy_(self.host, non_blocking=self.event is not None)
        if self.event is not None:
            self.event.record()
            self._queued = True


@dataclasses.dataclass
class SwapHandle:
    """A slot's cache, held in host memory while it is preempted.

    ``data`` maps every pool leaf name to a host tensor sliced along the
    page axis in logical block order: ``data["k_pages"][:, j]`` is the
    page that held positions [j * page_size, (j + 1) * page_size).
    Restoring it into any n fresh pages reproduces the slot's cache bytes
    (values and scales), so a swap resume continues exactly where the
    slot stopped.  ``n_tokens`` is the slot's valid prefix at swap time.
    ``page_size`` / ``kv_dtype`` stamp the producing pool's page format,
    which :meth:`PagedCacheManager.admit_swapped` checks.  ``pending``
    holds a queued copy's (device slices, event) until
    :meth:`materialize`: ``data`` is not to be read before then."""
    n_blocks: int
    n_tokens: int
    data: Dict[str, torch.Tensor]
    page_size: Optional[int] = None
    kv_dtype: Optional[str] = None
    pending: Optional[Any] = None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.data.values())

    @property
    def materialized(self) -> bool:
        return self.pending is None

    def materialize(self) -> "SwapHandle":
        """Wait for a queued swap-out copy (``swap_out(...,
        async_copy=True)``) to land in ``data``, then drop the device
        slice it read.  Idempotent; returns self."""
        if self.pending is not None:
            self.pending[1].synchronize()
            self.pending = None
        return self


def swap_out_pages(pool: Dict[str, torch.Tensor],
                   page_idx: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Copy pages ``page_idx`` of every pool leaf into host tensors
    (pinned on CUDA), synchronously: the copies are complete when this
    returns.  The result records page contents, not page numbers."""
    out = {}
    for name, leaf in pool.items():
        idx = torch.as_tensor(list(page_idx), dtype=torch.long, device=leaf.device)
        src = leaf.index_select(1, idx)              # a fresh tensor, on device
        if leaf.device.type == "cpu":
            out[name] = src
        else:
            out[name] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            out[name].copy_(src)
    return out


def swap_out_pages_async(pool: Dict[str, torch.Tensor], page_idx: Sequence[int]):
    """Queued twin of :func:`swap_out_pages`: slice the pages out on
    the device (a fresh tensor, so releasing and overwriting the source
    pages afterwards cannot reach it), then queue a ``non_blocking`` copy
    into pinned host tensors and record an event after it.  Returns
    ``(host tensors, (device slices, event))``; the second item is what
    :meth:`SwapHandle.materialize` waits on and keeps alive until then.
    On CPU the copy is synchronous and the second item is None."""
    if next(iter(pool.values())).device.type == "cpu":
        return swap_out_pages(pool, page_idx), None
    host, dev = {}, {}
    for name, leaf in pool.items():
        idx = torch.as_tensor(list(page_idx), dtype=torch.long, device=leaf.device)
        dev[name] = leaf.index_select(1, idx)
        host[name] = torch.empty(dev[name].shape, dtype=leaf.dtype, pin_memory=True)
        host[name].copy_(dev[name], non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, (dev, event)


def swap_in_pages(pool: Dict[str, torch.Tensor], host,
                  page_idx: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Write host buffers from :func:`swap_out_pages` (or a
    :class:`SwapHandle`'s) into pages ``page_idx`` of the pool, in place:
    the resume half of swap-tier preemption.  A handle whose queued copy
    was not materialized raises: its host buffers may not hold the pages
    yet, and waiting here would hide a missed commit boundary."""
    if isinstance(host, SwapHandle):
        if not host.materialized:
            raise RuntimeError("swap handle restored before its queued copy "
                               "was materialized (SwapHandle.materialize)")
        host = host.data
    for name, leaf in pool.items():
        idx = torch.as_tensor(list(page_idx), dtype=torch.long, device=leaf.device)
        leaf.index_copy_(1, idx, host[name].to(device=leaf.device, dtype=leaf.dtype))
    return pool
