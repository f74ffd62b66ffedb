"""Paged KV cache: block pool, host-side page allocator, block tables.

Counterpart of ``repro.serve.kv_cache`` for what admission, growth,
speculative write-then-retract and release use.  Layout contract (paged):

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
donates buffers to get the same effect).  Prefix sharing, copy-on-write,
host swap and int8 pages are not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

CACHE_LAYOUTS = ("dense", "paged")

# page index every dead / unmapped block-table entry points at; the
# allocator never hands it out
TRASH_PAGE = 0


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def blocks_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` positions."""
    return cdiv(max(n_tokens, 0), page_size)


class PageAllocator:
    """Free-list allocator over pages [1, num_pages).

    ``alloc(n)`` is all-or-nothing and LIFO: freed pages are reused
    most-recently-freed first, which keeps the working set of hot pages
    small.  Releasing a page that is not allocated, or writing to one
    (:meth:`assert_writable`), is a hard error.  (The reference refcounts
    pages for prefix sharing; that arrives with ROADMAP A9.)"""

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


class PagedCacheManager:
    """Host mirror of the paged cache: allocator + per-slot block tables.

    The engine owns the device pool; this class owns the mapping and hands
    the engine a fresh (slots, max_blocks) table whenever it changed
    (``dirty``), one small host-to-device copy per change, not per token."""

    def __init__(self, num_pages: int, page_size: int, slots: int, max_seq: int):
        self.page_size = page_size
        self.max_blocks = cdiv(max_seq, page_size)
        self.allocator = PageAllocator(num_pages)
        self.tables = np.full((slots, self.max_blocks), TRASH_PAGE, np.int32)
        self.owned: List[List[int]] = [[] for _ in range(slots)]
        self.dirty = True
        self.retract_count = 0    # pages taken back by speculative rollback

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
                          frees=a.free_count, retracts=self.retract_count)


# ---------------------------------------------------------------------------
# device-side pool helpers (in place)
# ---------------------------------------------------------------------------

def init_page_pool(n_layers: int, num_pages: int, page_size: int,
                   n_kv_heads: int, d_head: int, dtype: torch.dtype,
                   device) -> Dict[str, torch.Tensor]:
    """The shared block pool: (L, P, page_size, Hkv, D) per K and V."""
    shape = (n_layers, num_pages, page_size, n_kv_heads, d_head)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def scatter_prefill(pages: Dict[str, torch.Tensor],
                    pcache: Dict[str, torch.Tensor],
                    page_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write a dense prefilled cache {"k"/"v": (L, B, S, H, D)} through
    ``page_idx`` (B, ceil(S / page_size)) into the pool, in place.  Rows'
    tails past their prompt point at the trash page (duplicate trash
    targets may collide; only padding lands there)."""
    ps = pages["k_pages"].shape[2]
    flat = page_idx.reshape(-1).to(device=pages["k_pages"].device, dtype=torch.long)
    for name, src_name in (("k_pages", "k"), ("v_pages", "v")):
        src = pcache[src_name]
        l, b, s, h, d = src.shape
        nb = cdiv(s, ps)
        if nb * ps != s:
            src = torch.nn.functional.pad(src, (0, 0, 0, 0, 0, nb * ps - s))
        pages[name][:, flat] = src.reshape(l, b * nb, ps, h, d).to(pages[name].dtype)
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
    through its block-table row; unmapped (trash) entries read as NaN."""
    idx = table_row.to(device=pages["k_pages"].device, dtype=torch.long)
    unmapped = idx == TRASH_PAGE
    out = {}
    for name, dense in (("k_pages", "k"), ("v_pages", "v")):
        g = pages[name].index_select(1, idx)                 # (L, NB, ps, H, D)
        g = torch.where(unmapped[None, :, None, None, None],
                        torch.tensor(float("nan"), dtype=g.dtype, device=g.device), g)
        l, nb, ps, h, d = g.shape
        out[dense] = g.reshape(l, nb * ps, h, d)
    return out
