"""Deterministic fault injection for the serving engine.

Counterpart of ``repro.serve.faults`` (that module imports JAX, so the
port keeps its own copy).  The paper's HW-vs-SW result is that a software
path can stand in for a hardware feature when the hardware path is
unavailable; the engine carries the same pairs (hand-written kernel vs
plain PyTorch lowering, paged vs dense cache, speculative vs plain
decode), and a fallback is only real if it can be exercised.  Every
failure mode the engine claims to survive is injectable here,
deterministically, at a chosen scheduler round:

  oom               the page allocator reports exhaustion although pages
                    are free: drives the admission gate, growth
                    preemption and (``raise_exc=True``) step-restart
                    recovery
  nan               a request's logits turn NaN inside the step: drives
                    the NaN quarantine (only the targeted request fails)
  straggler         a decode step stalls ``sleep_s`` wall seconds: drives
                    the serve loop's watchdog
  spec_collapse     a request's draft proposals are perturbed so verify
                    rejects them: drives the per-request speculative
                    auto-disable and cooldown
  page_corruption   a live physical page is overwritten (NaN in float
                    leaves and in int8 pools' scales): surfaces as NaN
                    logits in whoever reads the page
  kernel            the step dispatch raises: drives the kernel -> plain
                    PyTorch degrade (the paper's HW->SW story as a runtime
                    policy)
  cancel            the request is cancelled at that round
  deadline          the request's deadline counts as expired at that
                    round: a deterministic ``timeout``

Faults are keyed on the engine's scheduler round, a counter that advances
once a round whether or not a step ran, so a fault window always expires
even while admission is blocked.  A :class:`FaultSchedule` is a pure
function of (kind, round): replaying one schedule against the same
requests makes the same injections, which is what lets the tests hold
every surviving request to the fault-free run's tokens.  An engine with
no schedule never calls into this module from its rounds.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

FAULT_KINDS = ("oom", "nan", "straggler", "spec_collapse",
               "page_corruption", "kernel", "cancel", "deadline")


def fold_worker_seed(seed: int, worker_id) -> int:
    """Fold a worker id into a fault seed, deterministically and stably
    across processes and platforms (blake2b, not ``hash()``, which is
    randomized per process), so every replica of a fleet derives its own
    schedule, and the same one on every run."""
    h = hashlib.blake2b(f"{int(seed)}|{worker_id}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") % (2 ** 31)


class InjectedFault(RuntimeError):
    """An injected failure surfacing as an exception.  ``fatal=True``
    marks it unrecoverable: recovery lets it propagate, and the engine
    releases every slot and page on the way out."""

    def __init__(self, msg: str, *, fatal: bool = False):
        super().__init__(msg)
        self.fatal = fatal


class KernelBackendError(InjectedFault):
    """An injected failure of the kernel backend's dispatch.  The engine
    rebuilds its model on the plain PyTorch lowering and replays the
    interrupted work: requests see latency, not the failure.  A real
    kernel failure is never turned into one: it escapes ``serve()``."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected failure.

    ``step`` is the round it first fires at; window faults (oom, nan,
    straggler, spec_collapse) stay active ``span`` rounds, point faults
    (cancel, deadline, kernel, page_corruption and ``raise_exc`` ooms)
    fire once, at ``step``.  ``uid`` targets one request where that
    makes sense (nan, spec_collapse, cancel, deadline); None hits every
    live request."""
    kind: str
    step: int
    uid: Optional[int] = None
    span: int = 1
    page: Optional[int] = None      # page_corruption target (None: seeded)
    sleep_s: float = 0.05           # straggler stall
    raise_exc: bool = False         # oom: raise instead of soft-denying
    fatal: bool = False             # raised faults: unrecoverable

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"pick from {FAULT_KINDS}")
        if self.step < 0 or self.span < 1:
            raise ValueError(f"fault needs step >= 0, span >= 1; "
                             f"got step={self.step} span={self.span}")

    def active_at(self, rnd: int) -> bool:
        return self.step <= rnd < self.step + self.span


class FaultSchedule:
    """A deterministic set of faults, queried by (kind, round).  It keeps
    no record of what fired, so one schedule replays across ``serve()``
    calls (the round counter restarts a session, and point faults fire
    again at the same rounds)."""

    def __init__(self, faults: Iterable[Fault] = (), seed: int = 0):
        self.faults: List[Fault] = list(faults)
        self.seed = seed

    def __len__(self) -> int:
        return len(self.faults)

    def __repr__(self) -> str:
        return f"FaultSchedule(seed={self.seed}, faults={self.faults!r})"

    # ------------------------------------------------------------- queries
    def active(self, kind: str, rnd: int) -> List[Fault]:
        return [f for f in self.faults if f.kind == kind and f.active_at(rnd)]

    def oom_denied(self, rnd: int) -> bool:
        """Soft OOM: the allocator pretends exhaustion this round."""
        return any(not f.raise_exc for f in self.active("oom", rnd))

    def oom_raise(self, rnd: int) -> Optional[Fault]:
        """Hard OOM: the allocator raises (at ``step`` only)."""
        for f in self.faults:
            if f.kind == "oom" and f.raise_exc and f.step == rnd:
                return f
        return None

    def kernel_at(self, rnd: int) -> Optional[Fault]:
        for f in self.faults:
            if f.kind == "kernel" and f.step == rnd:
                return f
        return None

    def straggler_sleep(self, rnd: int) -> float:
        return sum(f.sleep_s for f in self.active("straggler", rnd))

    def nan_uids(self, rnd: int) -> List[Optional[int]]:
        return [f.uid for f in self.active("nan", rnd)]

    def collapse_uids(self, rnd: int) -> List[Optional[int]]:
        return [f.uid for f in self.active("spec_collapse", rnd)]

    def cancels_at(self, rnd: int) -> List[int]:
        return [f.uid for f in self.faults
                if f.kind == "cancel" and f.step == rnd and f.uid is not None]

    def deadline_expiries_at(self, rnd: int) -> List[int]:
        return [f.uid for f in self.faults
                if f.kind == "deadline" and f.step == rnd and f.uid is not None]

    def corruptions_at(self, rnd: int) -> List[Fault]:
        return [f for f in self.faults
                if f.kind == "page_corruption" and f.step == rnd]

    def corruption_target(self, fault: Fault, rnd: int,
                          mapped_pages: Sequence[int]) -> Optional[int]:
        """A corruption fault's physical page: the explicit target if
        given, else a seeded choice among the mapped pages (None when
        nothing is mapped)."""
        if fault.page is not None:
            return fault.page
        if not mapped_pages:
            return None
        rng = np.random.default_rng((self.seed, rnd))
        return int(sorted(mapped_pages)[rng.integers(len(mapped_pages))])

    # ------------------------------------------------------ worker scoping
    def scoped(self, worker_id) -> "FaultSchedule":
        """The same faults, re-seeded for one worker of a fleet: seeded
        choices (the corruption target) stop aliasing across replicas,
        the written rounds and kinds stay."""
        return FaultSchedule(self.faults, seed=fold_worker_seed(self.seed, worker_id))

    @classmethod
    def random_for_worker(cls, seed: int, worker_id, *, n_faults: int = 4,
                          max_step: int = 24, uids: Sequence[int] = (),
                          kinds: Sequence[str] = FAULT_KINDS) -> "FaultSchedule":
        """A seeded random schedule of its own for each worker, reproducible
        from (seed, worker_id) (:func:`fold_worker_seed`)."""
        return cls.random(fold_worker_seed(seed, worker_id), n_faults=n_faults,
                          max_step=max_step, uids=uids, kinds=kinds)

    # ---------------------------------------------------------- generation
    @classmethod
    def random(cls, seed: int, *, n_faults: int = 4, max_step: int = 24,
               uids: Sequence[int] = (),
               kinds: Sequence[str] = FAULT_KINDS) -> "FaultSchedule":
        """A seeded random schedule over ``kinds``, drawn as the
        reference's (the same seed gives the same faults).  Raised OOMs
        come out non-fatal: fatal faults are for the targeted exception
        tests, not the sweep."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(int(rng.integers(1, n_faults + 1))):
            kind = kinds[int(rng.integers(len(kinds)))]
            step = int(rng.integers(0, max_step))
            uid = (int(rng.choice(list(uids)))
                   if len(uids) and kind in ("nan", "spec_collapse", "cancel", "deadline")
                   else None)
            faults.append(Fault(
                kind=kind, step=step, uid=uid, span=int(rng.integers(1, 4)),
                sleep_s=float(rng.uniform(0.01, 0.04)),
                raise_exc=bool(kind == "oom" and rng.integers(2))))
        return cls(faults, seed=seed)


def poison_pages(pool: Dict[str, torch.Tensor], page_idx) -> Dict[str, torch.Tensor]:
    """Overwrite physical pages ``page_idx`` of every pool leaf, in place:
    the page-corruption injection.  Float leaves (bf16 / f32 values, an
    int8 pool's f32 ``k_scales`` / ``v_scales``) take NaN; int8 value
    leaves, which cannot hold a NaN, take 0 (the bytes the reference's
    float -> int8 convert of NaN writes).  So the corruption surfaces
    through an int8 pool's dequant as through a float pool.  No leaf is
    rebound: captured steps read the pool by address."""
    for leaf in pool.values():
        idx = torch.as_tensor(page_idx, dtype=torch.long, device=leaf.device).reshape(-1)
        leaf[:, idx] = float("nan") if leaf.is_floating_point() else 0
    return pool
