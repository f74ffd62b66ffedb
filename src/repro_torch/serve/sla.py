"""SLA accounting for the serving engine.

Counterpart of ``repro.serve.sla`` (host-side numpy, kept as a copy of
its own: ``repro.serve`` imports JAX).  Two latency figures define a
serving SLA and neither is a mean:

  TTFT  time to first token, enqueue -> first sampled token: queueing,
        admission and prefill, what a user staring at a blank screen
        waits.
  TBT   time between tokens, the gap between consecutive token
        emissions of one request: the decode cadence a user watching
        tokens stream feels.  A speculative window that commits k tokens
        at once contributes one real gap and k - 1 zeros (the burst is
        how the tokens arrived).

Both are summarized as p50/p95/p99 percentiles (the tail is the SLA),
beside goodput (tokens a second delivered by requests that finished
``ok``: shed, timed-out, cancelled and failed work is not good) and the
terminal-status census.  ``ServeEngine`` attaches the summary to
``last_stats["sla"]`` at the end of every session, an empty one
included.

The input is the engine's ``last_stats`` ledger (int keys are the
per-request entries), not the engine itself.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

PERCENTILES = (50, 95, 99)


def percentiles(samples: List[float]) -> Dict[str, Optional[float]]:
    """p50/p95/p99, mean and max over ``samples``, and their count; the
    figures are None when there are no samples, so a row formats without
    a special case."""
    out: Dict[str, Optional[float]] = {f"p{p}": None for p in PERCENTILES}
    out.update(mean=None, max=None, n=len(samples))
    if samples:
        a = np.asarray(samples, np.float64)
        for p in PERCENTILES:
            out[f"p{p}"] = float(np.percentile(a, p))
        out["mean"] = float(a.mean())
        out["max"] = float(a.max())
    return out


def _census(per: Dict[int, dict]) -> Dict[str, int]:
    """Requests by terminal status ("in-flight" for none yet)."""
    statuses: Dict[str, int] = {}
    for s in per.values():
        key = s.get("status") or "in-flight"
        statuses[key] = statuses.get(key, 0) + 1
    return statuses


def summarize(stats: Dict[Any, Any], *, tbt_s: List[float], wall_s: float,
              timeseries: Optional[Dict[str, list]] = None) -> Dict[str, Any]:
    """One SLA summary from an engine's session ledger.

    ``stats``: int keys are requests (dicts with ``enqueued_s``,
    ``first_token_s``, ``status``, ``tokens``); string keys are ignored.
    ``tbt_s``: the raw time-between-token gaps, seconds.  ``wall_s``: the
    session's wall time, goodput's denominator.  ``timeseries``: the
    engine's per-round columns; with rounds in it the summary gains a
    ``rounds`` block, the means of the pipeline phase columns
    (``dispatch_s``, ``commit_s``, ``overlap_s``): host time issuing the
    step, blocked in the commit, and hidden under a step in flight."""
    per = {u: s for u, s in stats.items() if isinstance(u, int)}
    ttft = [s["first_token_s"] - s.get("enqueued_s", 0.0)
            for s in per.values() if "first_token_s" in s]
    ok_tokens = sum(int(s.get("tokens", 0)) for s in per.values()
                    if s.get("status") == "ok")
    out = {
        "requests": len(per),
        "statuses": _census(per),
        "ttft_ms": percentiles([t * 1e3 for t in ttft]),
        "tbt_ms": percentiles([t * 1e3 for t in tbt_s]),
        "ok_tokens": ok_tokens,
        "goodput_tok_s": ok_tokens / max(wall_s, 1e-9),
        "wall_s": wall_s,
    }
    if timeseries and timeseries.get("round"):
        rounds: Dict[str, Any] = {"n": len(timeseries["round"])}
        for col in ("dispatch_s", "commit_s", "overlap_s"):
            vals = timeseries.get(col) or []
            rounds[f"{col}_mean"] = float(np.mean(vals)) if vals else None
        out["rounds"] = rounds
    return out


def merge_ledgers(ledgers: List[Dict[Any, Any]]) -> Dict[Any, Any]:
    """Per-worker ledgers merged into one fleet ledger (int keys only).
    Uids are fleet-unique; a uid in several ledgers (a request re-served
    elsewhere after its replica failed) takes the later ledger's entry,
    so pass re-routes after their source."""
    merged: Dict[Any, Any] = {}
    for ledger in ledgers:
        for uid, entry in ledger.items():
            if isinstance(uid, int):
                merged[uid] = entry
    return merged


def fleet_summary(per_worker: Dict[Any, Dict[Any, Any]], *, tbt_s: List[float],
                  wall_s: float) -> Dict[str, Any]:
    """The fleet's SLA: one :func:`summarize` over the merged ledgers of
    every worker (in the order of their ids as strings), plus each
    replica's requests and terminal statuses."""
    order = sorted(per_worker, key=str)
    fleet = summarize(merge_ledgers([per_worker[w] for w in order]),
                      tbt_s=tbt_s, wall_s=wall_s)
    replicas = {}
    for wid in order:
        per = {u: s for u, s in per_worker[wid].items() if isinstance(u, int)}
        replicas[str(wid)] = {"requests": len(per), "statuses": _census(per)}
    fleet["replicas"] = replicas
    return fleet


def format_summary(sla: Dict[str, Any]) -> str:
    """The summary as a few human-readable lines."""
    def row(name, pct):
        cells = " ".join(
            f"{k}={pct[k]:8.2f}ms" if pct[k] is not None else f"{k}=     n/a"
            for k in ("p50", "p95", "p99"))
        return f"  {name:<6} {cells}  (n={pct['n']})"

    statuses = " ".join(f"{k}={v}" for k, v in sorted(sla["statuses"].items()))
    return "\n".join([
        row("ttft", sla["ttft_ms"]),
        row("tbt", sla["tbt_ms"]),
        f"  goodput {sla['goodput_tok_s']:.1f} tok/s "
        f"({sla['ok_tokens']} ok tokens / {sla['wall_s']:.2f}s)",
        f"  statuses: {statuses}",
    ])
