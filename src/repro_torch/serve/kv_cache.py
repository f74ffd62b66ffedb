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

Not ported yet: prefix sharing and its refcounted pages with
copy-on-write (ROADMAP A9b), and the asynchronous
``swap_out_pages_async`` / ``SwapHandle.materialize`` pair, which belongs
to the pipelined engine (ROADMAP A6b); the swap copies here are
synchronous.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

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
    """Free-list allocator over pages [1, num_pages).

    ``alloc(n)`` is all-or-nothing and LIFO: freed pages are reused
    most-recently-freed first, which keeps the working set of hot pages
    small.  Releasing a page that is not allocated, or writing to one
    (:meth:`assert_writable`), is a hard error.  (The reference refcounts
    pages for prefix sharing; that arrives with ROADMAP A9b.)"""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the trash "
                             f"page); got {num_pages}")
        self.num_pages = num_pages
        # LIFO free list; initialized so page 1 is handed out first
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._used: set = set()
        self.alloc_count = 0      # pages ever handed out
        self.free_count = 0       # pages ever returned to the free list
        self.peak_used = 0

    @property
    def usable(self) -> int:
        return self.num_pages - 1

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return len(self._used)

    def assert_writable(self, page: int):
        """Write spans must target allocated pages."""
        if page not in self._used:
            raise ValueError(f"write to unallocated page {page}")

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages, or None if fewer than n are free (nothing allocated)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._used.update(pages)
        self.alloc_count += n
        self.peak_used = max(self.peak_used, self.used)
        return pages

    def release(self, pages: Sequence[int]):
        """Return pages to the free list."""
        for p in pages:
            if p not in self._used:
                raise ValueError(f"double free / foreign page {p}")
            self._used.remove(p)
            self._free.append(p)
        self.free_count += len(pages)


@dataclasses.dataclass
class PagedStats:
    """Pool accounting snapshot (see :meth:`PagedCacheManager.stats`)."""
    used_pages: int
    free_pages: int
    peak_used_pages: int
    allocs: int
    frees: int
    retracts: int     # pages taken back by speculative write-then-retract
    # tiered memory: storage dtype and host-swap traffic
    kv_dtype: Optional[str] = None
    swap_outs: int = 0
    swap_ins: int = 0
    swapped_out_bytes: int = 0
    swapped_in_bytes: int = 0


class PagedCacheManager:
    """Host mirror of the paged cache: allocator + per-slot block tables.

    The engine owns the device pool; this class owns the mapping and hands
    the engine a fresh (slots, max_blocks) table whenever it changed
    (``dirty``), one small host-to-device copy per change, not per token."""

    def __init__(self, num_pages: int, page_size: int, slots: int, max_seq: int,
                 kv_dtype: Optional[str] = None):
        self.page_size = page_size
        self.max_blocks = cdiv(max_seq, page_size)
        self.allocator = PageAllocator(num_pages)
        self.tables = np.full((slots, self.max_blocks), TRASH_PAGE, np.int32)
        self.owned: List[List[int]] = [[] for _ in range(slots)]
        self.kv_dtype = kv_dtype
        self.dirty = True
        self.retract_count = 0    # pages taken back by speculative rollback
        self.swap_outs = 0
        self.swap_ins = 0
        self.swapped_out_bytes = 0
        self.swapped_in_bytes = 0

    def can_admit(self, prompt_len: int, headroom: int = 0) -> bool:
        """Enough free pages for a prompt, keeping ``headroom`` pages in
        reserve (the engine passes one growth page per live slot)."""
        return (self.allocator.free
                >= blocks_for(prompt_len, self.page_size) + headroom)

    def fits_worst_case(self, prompt_len: int, max_new: int, max_seq: int) -> bool:
        """Can this request ever complete alone in the pool?  Positions
        written: the prompt plus one per decode step (the last sampled
        token is never written), capped by max_seq."""
        longest = min(prompt_len + max(max_new - 1, 0), max_seq)
        return blocks_for(longest, self.page_size) <= self.allocator.usable

    def admit(self, slot: int, prompt_len: int) -> Optional[List[int]]:
        """Map blocks for a prompt; None (nothing changed) if pages lack."""
        pages = self.allocator.alloc(blocks_for(prompt_len, self.page_size))
        if pages is None:
            return None
        if self.owned[slot]:
            raise ValueError(f"slot {slot} already mapped")
        self.tables[slot, :len(pages)] = pages
        self.owned[slot] = list(pages)
        self.dirty = True
        return pages

    def ensure_block(self, slot: int, block: int) -> bool:
        """Map logical block ``block`` for ``slot`` (growth at a step
        boundary).  True if already mapped or newly allocated."""
        if block >= self.max_blocks:
            return True  # position cap: decode stops at max_seq anyway
        page = int(self.tables[slot, block])
        if page != TRASH_PAGE:
            self.allocator.assert_writable(page)
            return True
        pages = self.allocator.alloc(1)
        if pages is None:
            return False
        self.tables[slot, block] = pages[0]
        self.owned[slot].append(pages[0])
        self.dirty = True
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
        overwritten by the next window (masked until then).  Returns the
        number of pages retracted."""
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
        return len(dropped)

    def release(self, slot: int):
        """Drop the slot's pages and point its table at trash."""
        if self.owned[slot]:
            self.allocator.release(self.owned[slot])
            self.owned[slot] = []
            self.tables[slot, :] = TRASH_PAGE
            self.dirty = True

    # ----------------------------------------------------- host-swap tier
    def swap_out(self, slot: int, pool: Dict[str, torch.Tensor],
                 n_tokens: int) -> "SwapHandle":
        """Page a slot out to host buffers: copy every mapped page of the
        slot (values and scales) device-to-host, then release the slot's
        pages.  The copy comes strictly before the release, so a
        same-round admission cannot overwrite pages still being copied."""
        blocks = [int(p) for p in self.tables[slot] if p != TRASH_PAGE]
        handle = SwapHandle(n_blocks=len(blocks), n_tokens=n_tokens,
                            data=swap_out_pages(pool, blocks),
                            page_size=self.page_size, kv_dtype=self.kv_dtype)
        self.swap_outs += 1
        self.swapped_out_bytes += handle.nbytes
        self.release(slot)
        return handle

    def admit_swapped(self, slot: int, handle: "SwapHandle") -> Optional[List[int]]:
        """Map fresh pages for a swapped-out slot (the engine then writes
        ``handle.data`` into them with :func:`swap_in_pages`).
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
        pages = self.allocator.alloc(handle.n_blocks)
        if pages is None:
            return None
        if self.owned[slot]:
            raise ValueError(f"slot {slot} already mapped")
        self.tables[slot, :len(pages)] = pages
        self.owned[slot] = list(pages)
        self.swap_ins += 1
        self.swapped_in_bytes += handle.nbytes
        self.dirty = True
        return pages

    def device_tables(self, device) -> torch.Tensor:
        self.dirty = False
        return torch.as_tensor(self.tables, device=device)

    def prefill_page_idx(self, slot: int, n_blocks: int) -> np.ndarray:
        """(n_blocks,) page indices for a slot's first blocks, trash-padded
        past what the slot owns (scatter targets for padded prefill)."""
        idx = np.full((n_blocks,), TRASH_PAGE, np.int32)
        m = min(n_blocks, len(self.owned[slot]))
        for j in range(m):
            self.allocator.assert_writable(int(self.tables[slot, j]))
        idx[:m] = self.tables[slot, :m]
        return idx

    def stats(self) -> PagedStats:
        a = self.allocator
        return PagedStats(used_pages=a.used, free_pages=a.free,
                          peak_used_pages=a.peak_used, allocs=a.alloc_count,
                          frees=a.free_count, retracts=self.retract_count,
                          kv_dtype=self.kv_dtype, swap_outs=self.swap_outs,
                          swap_ins=self.swap_ins,
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
    through its block-table row; unmapped (trash) entries read as NaN.  A
    quantized pool comes back dequantized (float32), poison included."""
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
    which :meth:`PagedCacheManager.admit_swapped` checks."""
    n_blocks: int
    n_tokens: int
    data: Dict[str, torch.Tensor]
    page_size: Optional[int] = None
    kv_dtype: Optional[str] = None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.data.values())


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


def swap_in_pages(pool: Dict[str, torch.Tensor], host: Dict[str, torch.Tensor],
                  page_idx: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Write host buffers from :func:`swap_out_pages` into pages
    ``page_idx`` of the pool, in place: the resume half of swap-tier
    preemption."""
    for name, leaf in pool.items():
        idx = torch.as_tensor(list(page_idx), dtype=torch.long, device=leaf.device)
        leaf.index_copy_(1, idx, host[name].to(device=leaf.device, dtype=leaf.dtype))
    return pool
