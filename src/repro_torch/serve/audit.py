"""Allocator, block-table and prefix-index invariant audit.

Counterpart of ``repro.serve.audit`` (the port keeps its own copy; the
error strings are the reference's word for word).  The paged cache's
correctness rests on invariants no single class can check alone: the
allocator knows refcounts, the manager which slot maps which page, the
prefix index which pages it keeps alive.  A leak (a page whose refcount
says two holders where one table entry points at it, or an allocated
page nobody maps) stays invisible to all three until the pool runs dry
sessions later.  One sweep checks all of it, so a leak is caught at the
step that caused it:

  * allocator internals: ``used + free == usable``, no duplicate in the
    free list, no allocated (or trash) page in it, every refcount >= 1,
    ``logical`` the refcount sum;
  * tables against ownership: each slot's non-trash table entries are
    exactly its ``owned`` pages, no page mapped twice by one slot;
  * refcounts: every allocated page's refcount is the number of slots
    mapping it, plus 1 if the prefix index holds it;
  * orphans: allocated pages nobody holds;
  * the pool's quantization metadata (:func:`audit_pool`): int8 value
    leaves travel with f32 per-row scale leaves of the matching shape,
    the manager's ``kv_dtype`` agrees with the pool, and (the opt-in
    value sweep) every mapped page's scales are finite and >= 0.

The sweep is host-side and O(pages + slots x blocks); the structural
pool check reads only shapes and dtypes.  The engine runs it every round
under ``audit=True``, and :meth:`PagedCacheManager.stats` after every
session (the report rides in ``last_pool_stats``).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List

import numpy as np
import torch


class AuditError(AssertionError):
    """An invariant violation found by the sweep.  An AssertionError on
    purpose: corrupt accounting is a bug, never a runtime condition the
    engine's recovery should paper over."""

    def __init__(self, report: "AuditReport"):
        super().__init__("allocator audit failed:\n  " + "\n  ".join(report.errors))
        self.report = report


@dataclasses.dataclass
class AuditReport:
    """One sweep's result (``ok`` iff ``errors`` is empty)."""
    ok: bool
    errors: List[str] = dataclasses.field(default_factory=list)
    orphan_pages: int = 0
    refcount_mismatches: int = 0

    def raise_if_failed(self):
        if not self.ok:
            raise AuditError(self)


def audit_allocator(alloc) -> List[str]:
    """Internal consistency of one :class:`PageAllocator` (no tables)."""
    from repro_torch.serve.kv_cache import TRASH_PAGE

    errors: List[str] = []
    free = list(alloc._free)
    refs = dict(alloc._refs)
    if alloc.used + alloc.free != alloc.usable:
        errors.append(f"accounting: used {alloc.used} + free {alloc.free} "
                      f"!= usable {alloc.usable}")
    if len(set(free)) != len(free):
        dup = [p for p, c in Counter(free).items() if c > 1]
        errors.append(f"free list holds duplicates: {sorted(dup)}")
    if TRASH_PAGE in set(free) or TRASH_PAGE in refs:
        errors.append("trash page entered circulation")
    overlap = set(free) & set(refs)
    if overlap:
        errors.append(f"pages both free and allocated: {sorted(overlap)}")
    out_of_range = [p for p in list(refs) + free if not 0 < p < alloc.num_pages]
    if out_of_range:
        errors.append(f"pages outside [1, {alloc.num_pages}): "
                      f"{sorted(set(out_of_range))}")
    bad_refs = {p: r for p, r in refs.items() if r < 1}
    if bad_refs:
        errors.append(f"non-positive refcounts: {bad_refs}")
    if alloc.logical != sum(refs.values()):
        errors.append(f"logical {alloc.logical} != refcount sum {sum(refs.values())}")
    return errors


def audit_manager(mgr) -> AuditReport:
    """The whole sweep over allocator, block tables and prefix index."""
    from repro_torch.serve.kv_cache import TRASH_PAGE

    errors = audit_allocator(mgr.allocator)
    refs = dict(mgr.allocator._refs)

    # tables against ownership, slot by slot
    expected: Counter = Counter()
    for slot, owned in enumerate(mgr.owned):
        row = [int(p) for p in mgr.tables[slot] if p != TRASH_PAGE]
        if Counter(row) != Counter(owned):
            errors.append(f"slot {slot}: table maps {sorted(row)} but "
                          f"owns {sorted(owned)}")
        dup = [p for p, c in Counter(row).items() if c > 1]
        if dup:
            errors.append(f"slot {slot}: pages mapped at two logical "
                          f"blocks: {sorted(dup)}")
        expected.update(set(row) | set(owned))

    # the index holds one reference a page it keeps alive
    index_pages = list(mgr.index.pages()) if mgr.index is not None else []
    dup = [p for p, c in Counter(index_pages).items() if c > 1]
    if dup:
        errors.append(f"prefix index references pages twice: {sorted(dup)}")
    expected.update(set(index_pages))

    # refcounts against holders, and orphans
    mismatches = 0
    orphans = 0
    for page in sorted(set(refs) | set(expected)):
        want, have = expected.get(page, 0), refs.get(page, 0)
        if want == have:
            continue
        if have and not want:
            orphans += 1
            errors.append(f"orphan page {page}: refcount {have}, "
                          f"no slot or index holds it")
        else:
            mismatches += 1
            errors.append(f"page {page}: refcount {have} but "
                          f"{want} holders (slots + index)")
    return AuditReport(ok=not errors, errors=errors, orphan_pages=orphans,
                       refcount_mismatches=mismatches)


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype as the reference's messages spell a dtype."""
    return str(dtype).removeprefix("torch.")


def audit_pool(mgr, pool, *, check_values: bool = False) -> AuditReport:
    """The pool's quantization metadata: structure always, values opt-in.

    Structure (shapes and dtypes, no device read): the pool's
    quantization agrees with the manager's ``kv_dtype``, and an int8
    pool's ``k_pages`` / ``v_pages`` are int8, each beside an f32 scale
    leaf shaped like its leading (layers, pages, page_size) dims.

    ``check_values=True`` also copies the mapped pages' scales to the host
    (one copy a leaf) and requires them finite and >= 0.  Opt-in, since
    the engine's per-round audit must keep passing while a fault schedule
    poisons live pages on purpose: that corruption is to surface as NaN
    logits in the step, not as an audit failure."""
    from repro_torch.serve.kv_cache import TRASH_PAGE, pool_is_quantized

    errors: List[str] = []
    quantized = pool_is_quantized(pool)
    want_quant = getattr(mgr, "kv_dtype", None) == "int8"
    if quantized != want_quant:
        errors.append(f"pool quantization {quantized} disagrees with "
                      f"manager kv_dtype {getattr(mgr, 'kv_dtype', None)!r}")
    if quantized:
        for name in ("k_pages", "v_pages"):
            leaf = pool.get(name)
            sname = name[0] + "_scales"
            scales = pool.get(sname)
            if leaf is None or scales is None:
                errors.append(f"quantized pool missing {name}/{sname}")
                continue
            if leaf.dtype != torch.int8:
                errors.append(f"{name}: quantized pool holds "
                              f"{_dtype_name(leaf.dtype)}, expected int8")
            if scales.dtype != torch.float32:
                errors.append(f"{sname}: scales are {_dtype_name(scales.dtype)}, "
                              f"expected float32")
            if tuple(scales.shape) != tuple(leaf.shape[:3]):
                errors.append(f"{sname}: shape {tuple(scales.shape)} != "
                              f"value leading dims {tuple(leaf.shape[:3])}")
        if check_values and not errors:
            mapped = sorted({int(p) for owned in mgr.owned for p in owned
                             if p != TRASH_PAGE})
            if mapped:
                for sname in ("k_scales", "v_scales"):
                    leaf = pool[sname]
                    idx = torch.as_tensor(mapped, dtype=torch.long, device=leaf.device)
                    s = leaf.index_select(1, idx).cpu().numpy()
                    if not np.all(np.isfinite(s)):
                        errors.append(f"{sname}: non-finite scale on a "
                                      f"mapped page")
                    elif np.any(s < 0):
                        errors.append(f"{sname}: negative scale on a "
                                      f"mapped page")
    return AuditReport(ok=not errors, errors=errors)


def audit_fleet(managers) -> AuditReport:
    """One report over every replica of a fleet: each worker's manager
    gets :func:`audit_manager`, its errors prefixed with the worker id.
    ``managers`` maps worker id -> manager (None entries, dense workers
    or dead replicas, are skipped)."""
    errors: List[str] = []
    orphans = mismatches = 0
    for wid in sorted(managers, key=str):
        mgr = managers[wid]
        if mgr is None:
            continue
        rep = audit_manager(mgr)
        errors.extend(f"[worker {wid}] {e}" for e in rep.errors)
        orphans += rep.orphan_pages
        mismatches += rep.refcount_mismatches
    return AuditReport(ok=not errors, errors=errors, orphan_pages=orphans,
                       refcount_mismatches=mismatches)
