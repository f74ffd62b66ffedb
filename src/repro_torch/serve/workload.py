"""Open-loop workload generators: arrival processes for the serving engine.

Counterpart of ``repro.serve.workload`` (numpy only; the port keeps its
own copy, built on the port's :class:`~repro_torch.serve.engine.Request`).
Closed-loop drivers (hand the engine N requests, wait) measure the
engine at its own pace; production traffic is open-loop: requests arrive
on a clock that does not care whether the server keeps up.  This module
generates that clock deterministically:

  closed   every request at t=0 (the batch, for baselines)
  poisson  exponential inter-arrivals at a constant rate, the memoryless
           baseline of queueing results
  bursty   two-state Markov-modulated Poisson process (MMPP-2): a calm
           state and a burst state, each with its own rate, switching
           after a geometric dwell

Prompt and output lengths draw from clipped lognormals (heavy-tailed),
an optional shared-prefix mixture routes a fraction of prompts through a
few common prefixes (the radix index and copy-on-write pages under
load), and an optional priority mixture tags requests with SLA classes.
Everything derives from one ``numpy`` Generator seeded by the caller:
the same (kind, n, seed, params) is the same workload, byte for byte,
and the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.engine import Request

WORKLOAD_KINDS = ("closed", "poisson", "bursty")


@dataclasses.dataclass(frozen=True)
class TimedRequest:
    """A request plus its open-loop arrival time (seconds from session
    start; the async driver maps it to wall sleeps or scheduler
    rounds)."""
    arrival_s: float
    request: Request


def poisson_arrivals(n: int, rate: float,
                     rng: np.random.Generator) -> np.ndarray:
    """n arrival times at ``rate`` req/s (exponential inter-arrivals)."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0; got {rate}")
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def bursty_arrivals(n: int, rate: float, rng: np.random.Generator, *,
                    burst_factor: float = 4.0,
                    mean_dwell: float = 8.0) -> np.ndarray:
    """MMPP-2 arrival times: calm state at ``rate / burst_factor``,
    burst state at ``rate * burst_factor``, switching after a geometric
    dwell of ``mean_dwell`` arrivals on average."""
    if burst_factor < 1.0:
        raise ValueError(f"burst_factor must be >= 1; got {burst_factor}")
    rates = (rate / burst_factor, rate * burst_factor)
    state = 0
    p_switch = 1.0 / max(mean_dwell, 1.0)
    t, out = 0.0, []
    for _ in range(n):
        t += rng.exponential(1.0 / rates[state])
        out.append(t)
        if rng.random() < p_switch:
            state = 1 - state
    return np.asarray(out)


def lognormal_lengths(n: int, rng: np.random.Generator, *, median: float,
                      sigma: float, lo: int, hi: int) -> np.ndarray:
    """Heavy-tailed integer lengths: clipped lognormal with the given
    median (the mode of user behavior) and log-space sigma (the tail)."""
    raw = rng.lognormal(mean=np.log(median), sigma=sigma, size=n)
    return np.clip(np.round(raw).astype(int), lo, hi)


def _pick_priorities(n: int, rng: np.random.Generator,
                     mix: Optional[Sequence[Tuple[int, float]]]) -> List[int]:
    if not mix:
        return [1] * n
    classes = [c for c, _ in mix]
    w = np.asarray([p for _, p in mix], np.float64)
    idx = rng.choice(len(classes), size=n, p=w / w.sum())
    return [classes[i] for i in idx]


def make_workload(kind: str, n: int, *, vocab: int, seed: int = 0,
                  rate: float = 8.0, burst_factor: float = 4.0,
                  mean_dwell: float = 8.0,
                  prompt_median: float = 12.0, prompt_sigma: float = 0.6,
                  prompt_min: int = 2, prompt_max: int = 64,
                  out_median: float = 10.0, out_sigma: float = 0.5,
                  out_min: int = 2, out_max: int = 48,
                  shared_prefix_frac: float = 0.0, n_prefixes: int = 2,
                  prefix_len: int = 12,
                  priority_mix: Optional[Sequence[Tuple[int, float]]] = None,
                  deadline_ms: Optional[float] = None,
                  ttft_deadline_ms: Optional[float] = None,
                  uid_base: int = 0) -> List[TimedRequest]:
    """Deterministic open-loop workload: ``n`` requests with arrival
    times from the ``kind`` process and lengths/priorities from the
    mixtures above.  ``rate`` is req/s in whatever clock the driver
    maps ``arrival_s`` onto (wall seconds, or scheduler rounds via
    ``round_time_s=1``)."""
    if kind not in WORKLOAD_KINDS:
        raise ValueError(f"kind must be one of {WORKLOAD_KINDS}; "
                         f"got {kind!r}")
    rng = np.random.default_rng(seed)
    if kind == "closed":
        arrivals = np.zeros(n)
    elif kind == "poisson":
        arrivals = poisson_arrivals(n, rate, rng)
    else:
        arrivals = bursty_arrivals(n, rate, rng,
                                   burst_factor=burst_factor,
                                   mean_dwell=mean_dwell)
    plens = lognormal_lengths(n, rng, median=prompt_median,
                              sigma=prompt_sigma, lo=prompt_min,
                              hi=prompt_max)
    olens = lognormal_lengths(n, rng, median=out_median, sigma=out_sigma,
                              lo=out_min, hi=out_max)
    priorities = _pick_priorities(n, rng, priority_mix)
    prefixes = [rng.integers(0, vocab, size=prefix_len).tolist()
                for _ in range(max(1, n_prefixes))]
    out: List[TimedRequest] = []
    for i in range(n):
        plen = int(plens[i])
        if shared_prefix_frac > 0.0 and rng.random() < shared_prefix_frac:
            pre = prefixes[int(rng.integers(0, len(prefixes)))]
            # keep the drawn total length; at least one private token so
            # identical-prompt collisions stay the exception
            plen = max(plen, prefix_len + 1)
            prompt = pre + rng.integers(
                0, vocab, size=plen - prefix_len).tolist()
        else:
            prompt = rng.integers(0, vocab, size=plen).tolist()
        out.append(TimedRequest(
            arrival_s=float(arrivals[i]),
            request=Request(uid=uid_base + i, prompt=prompt,
                            max_new_tokens=int(olens[i]),
                            priority=priorities[i],
                            deadline_ms=deadline_ms,
                            ttft_deadline_ms=ttft_deadline_ms)))
    return out


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Normalized Zipf popularity over ``n`` ranks: weight of rank r is
    1 / (r+1)^s.  s=0 is uniform; s around 1 is the classic web-traffic
    skew where a couple of tenants dominate."""
    if n < 1:
        raise ValueError(f"need n >= 1 ranks; got {n}")
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), max(s, 0.0))
    return w / w.sum()


def make_tenant_workload(kind: str, n: int, *, vocab: int,
                         n_tenants: int = 4, zipf_s: float = 1.1,
                         system_len: int = 16, seed: int = 0,
                         rate: float = 8.0, burst_factor: float = 4.0,
                         mean_dwell: float = 8.0,
                         suffix_median: float = 6.0,
                         suffix_sigma: float = 0.5,
                         suffix_min: int = 1, suffix_max: int = 24,
                         out_median: float = 8.0, out_sigma: float = 0.5,
                         out_min: int = 2, out_max: int = 32,
                         priority_mix: Optional[Sequence[
                             Tuple[int, float]]] = None,
                         uid_base: int = 0,
                         ) -> Tuple[List[TimedRequest], Dict[int, int]]:
    """Multi-tenant traffic mixture: every request belongs to a tenant
    drawn from a seeded Zipf popularity over ``n_tenants``, and opens
    with that tenant's fixed ``system_len``-token system prompt followed
    by a private heavy-tailed suffix.

    This is the workload shape a cache-aware router exists for: tenant
    popularity is skewed (a few system prompts are hot), the shared part
    of each prompt is page-aligned-ish and long relative to the suffix,
    and *which replica* a request lands on decides whether its system
    prompt prefills from the radix cache or from scratch.  Returns
    ``(timed_requests, tenant_of_uid)`` so benchmarks can slice results
    per tenant."""
    if kind not in WORKLOAD_KINDS:
        raise ValueError(f"kind must be one of {WORKLOAD_KINDS}; "
                         f"got {kind!r}")
    if system_len < 1:
        raise ValueError(f"system_len must be >= 1; got {system_len}")
    rng = np.random.default_rng(seed)
    if kind == "closed":
        arrivals = np.zeros(n)
    elif kind == "poisson":
        arrivals = poisson_arrivals(n, rate, rng)
    else:
        arrivals = bursty_arrivals(n, rate, rng,
                                   burst_factor=burst_factor,
                                   mean_dwell=mean_dwell)
    system_prompts = [rng.integers(0, vocab, size=system_len).tolist()
                     for _ in range(n_tenants)]
    tenants = rng.choice(n_tenants, size=n,
                         p=zipf_weights(n_tenants, zipf_s))
    slens = lognormal_lengths(n, rng, median=suffix_median,
                              sigma=suffix_sigma, lo=suffix_min,
                              hi=suffix_max)
    olens = lognormal_lengths(n, rng, median=out_median, sigma=out_sigma,
                              lo=out_min, hi=out_max)
    priorities = _pick_priorities(n, rng, priority_mix)
    out: List[TimedRequest] = []
    tenant_of: Dict[int, int] = {}
    for i in range(n):
        tenant = int(tenants[i])
        uid = uid_base + i
        tenant_of[uid] = tenant
        prompt = (system_prompts[tenant]
                  + rng.integers(0, vocab, size=int(slens[i])).tolist())
        out.append(TimedRequest(
            arrival_s=float(arrivals[i]),
            request=Request(uid=uid, prompt=prompt,
                            max_new_tokens=int(olens[i]),
                            priority=priorities[i])))
    return out, tenant_of


def describe(timed: List[TimedRequest]) -> Dict[str, float]:
    """Quick census of a workload (benchmark JSON / CLI banner)."""
    if not timed:
        return {"n": 0}
    arr = np.asarray([t.arrival_s for t in timed])
    plens = np.asarray([len(t.request.prompt) for t in timed])
    olens = np.asarray([t.request.max_new_tokens for t in timed])
    span = float(arr.max() - arr.min())
    return {
        "n": len(timed),
        "span_s": span,
        "mean_rate": len(timed) / span if span > 0 else float("inf"),
        "prompt_mean": float(plens.mean()), "prompt_max": int(plens.max()),
        "out_mean": float(olens.mean()), "out_max": int(olens.max()),
        "priorities": {int(p): int(c) for p, c in zip(
            *np.unique([t.request.priority for t in timed],
                       return_counts=True))},
    }
