"""Serving launcher.  Counterpart of ``repro.launch.serve``, with its flags.

A continuous-batching ``ServeEngine`` over the dense or the paged cache,
serving one closed batch (``--workload closed``, the default) or
replaying an open-loop arrival process through the streaming server
(``--workload poisson|bursty``, ``serve.async_engine``; ``--clock round``
makes the replay deterministic in scheduler rounds, ``--clock wall``
sleeps real seconds).  Like the reference it takes the reduced config
and computes in fp32, from random weights drawn from ``--seed``.  Runs on
``cuda`` unless ``--device cpu``; on the card an MLA config keeps its
full head dims (the flash forward's (96, 64) instance; the reduced
config's (48, 32) has none).

The engine's flags are the reference's: ``--no-fused`` (the seed loop),
``--cache-layout``, ``--page-size``, ``--num-pages``, ``--kv-dtype``,
``--preempt requeue|swap|auto`` with ``--preempt-calibrate`` (the swap
bandwidth and the decode rate measured on the device at construction;
the measured figures are printed), ``--prefix-sharing`` /
``--shared-prefix``, ``--spec-k`` / ``--draft``, the lifecycle flags
(``--deadline-ms``, ``--ttft-deadline-ms``, ``--max-retries``,
``--max-queue``, ``--shed-policy``, ``--queue-watermark``,
``--shed-priority``, ``--free-page-watermark``, ``--prefill-budget``),
``--audit``, ``--pipeline`` and ``--inject-faults SEED``.
``--attn-backend`` and ``--verify-backend`` pick the kernel or the plain
PyTorch lowering of prefill and verify attention (``jnp``, the
reference's name, means the plain one).  Every run ends with the SLA
block (TTFT / TBT p50/p95/p99, goodput, the status census), the
lifecycle line and, on the paged layout, the pool's.

Multi-replica serving (``serve.cluster``): ``--replicas N`` runs the
batch through N engine workers behind a router (``--router
round-robin|least-loaded|cache-aware``; cache-aware scores the
content-addressed prompt-prefix overlap against load), and
``--disaggregate`` splits roles: the first replica only prefills, the
rest only decode, joined by a KV handoff on swap handles.  Both need
``--cache-layout paged``.  Each worker has an engine of its own over the
same model and weights.  The tokens are those of ``--replicas 1`` for
any topology; the run ends with the per-request fleet table, the fleet
SLA, each replica's census and pool, the router's decisions and the
fleet audit.  With ``--inject-faults`` each worker runs its own schedule
derived from the seed.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --requests 6 --prompt-len 16 --max-new 12 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --cache-layout paged --workload poisson --clock round --requests 12 \\
      --preempt auto --preempt-calibrate
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --cache-layout paged --replicas 3 --disaggregate
"""

from __future__ import annotations

import argparse
import asyncio
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.registry import reduced_config, with_kernel_head_dims
from repro_torch.device import resolve_device
from repro_torch.models.lm import Model
from repro_torch.serve.async_engine import serve_open_loop
from repro_torch.serve.cluster import ROUTER_POLICIES, make_cluster
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.faults import FaultSchedule
from repro_torch.serve.sla import format_summary
from repro_torch.serve.workload import WORKLOAD_KINDS, describe, make_workload

def _backend(name: str) -> Optional[str]:
    """A lowering flag's value as a ``Model`` backend: auto = the model's
    default, jnp (the reference's plain path) = torch."""
    return {"auto": None, "jnp": "torch"}.get(name, name)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-fused", action="store_true",
                    help="the seed per-token loop instead of the fused step")
    ap.add_argument("--attn-backend", default="auto",
                    choices=["auto", "kernel", "torch", "jnp"],
                    help="prefill attention lowering (auto: the flash kernel, "
                         "its plain version on the CPU; torch or jnp: plain)")
    ap.add_argument("--cache-layout", default="dense", choices=["dense", "paged"])
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged layout)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool pages incl. the trash page (default: the dense "
                         "pool's capacity)")
    ap.add_argument("--kv-dtype", default="auto", choices=["auto", "bf16", "int8"],
                    help="paged pool storage: bf16, or int8 with per-row f32 "
                         "scales (auto: the model's cache dtype)")
    ap.add_argument("--preempt", default="requeue", choices=["requeue", "swap", "auto"],
                    help="pool-exhaustion preemption: recompute at re-admission, "
                         "page to host, or compare the two costs a token")
    ap.add_argument("--evict-policy", default="lru", choices=["lru", "lfu", "deepest"])
    ap.add_argument("--min-cached-tokens", type=int, default=0)
    ap.add_argument("--prefix-sharing", default=False,
                    action=argparse.BooleanOptionalAction,
                    help="share page-aligned prompt prefixes (paged layout)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="every prompt shares its first N tokens (0: random)")
    ap.add_argument("--spec-k", type=int, default=1,
                    help="speculative window (paged layout); 1 disables")
    ap.add_argument("--draft", default=None,
                    help="draft for --spec-k > 1: 'self', 'self:N' or an arch")
    ap.add_argument("--verify-backend", default="auto",
                    choices=["auto", "kernel", "torch", "jnp"],
                    help="k-token verify lowering (auto: the verify kernel, its "
                         "plain version on the CPU; torch or jnp: plain)")
    ap.add_argument("--attend-block", type=int, default=64)
    ap.add_argument("--prompt-block", type=int, default=16)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--ttft-deadline-ms", type=float, default=None)
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--shed-policy", default="reject-newest",
                    choices=["reject-newest", "reject-largest"])
    ap.add_argument("--workload", default="closed", choices=list(WORKLOAD_KINDS),
                    help="closed: one batch at t=0; poisson / bursty: an "
                         "open-loop arrival process through the streaming server")
    ap.add_argument("--arrival-rate", type=float, default=8.0,
                    help="mean arrival rate, requests a second (or a round)")
    ap.add_argument("--burst-factor", type=float, default=4.0,
                    help="MMPP-2 burst intensity for --workload bursty")
    ap.add_argument("--clock", default="wall", choices=["wall", "round"],
                    help="open-loop clock: real sleeps, or scheduler rounds")
    ap.add_argument("--queue-watermark", type=int, default=None)
    ap.add_argument("--shed-priority", type=int, default=2)
    ap.add_argument("--free-page-watermark", type=float, default=0.0)
    ap.add_argument("--prefill-budget", type=int, default=None)
    ap.add_argument("--audit", action="store_true",
                    help="sweep the pool's invariants every scheduler round")
    ap.add_argument("--pipeline", action=argparse.BooleanOptionalAction, default=True,
                    help="overlapped rounds (captured steps on CUDA); "
                         "--no-pipeline keeps the serial round")
    ap.add_argument("--preempt-calibrate", action="store_true",
                    help="measure the swap bandwidth and the decode rate at "
                         "construction and drive preempt=auto from them")
    ap.add_argument("--inject-faults", type=int, default=None, metavar="SEED",
                    help="a seeded random fault schedule against the requests; "
                         "with --replicas each worker derives its own")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine workers behind the router; the tokens stay "
                         "those of --replicas 1 (needs --cache-layout paged)")
    ap.add_argument("--router", default="cache-aware", choices=list(ROUTER_POLICIES),
                    help="replica placement: rotation, the least queue + busy "
                         "slots, or prefix affinity over content-addressed "
                         "prompt hashes against load")
    ap.add_argument("--disaggregate", action="store_true",
                    help="replica 0 only prefills, the rest only decode, joined "
                         "by a KV handoff (needs --replicas >= 2)")
    return ap


def _requests(args, cfg):
    """The closed batch (random prompts, an optional shared prefix) or the
    open-loop workload: (timed requests or None, requests)."""
    if args.workload != "closed":
        timed = make_workload(
            args.workload, args.requests, vocab=cfg.vocab, seed=args.seed,
            rate=args.arrival_rate, burst_factor=args.burst_factor,
            prompt_median=args.prompt_len, prompt_max=2 * args.prompt_len,
            out_median=args.max_new, out_max=2 * args.max_new,
            shared_prefix_frac=0.5 if args.shared_prefix else 0.0,
            prefix_len=args.shared_prefix, deadline_ms=args.deadline_ms,
            ttft_deadline_ms=args.ttft_deadline_ms)
        d = describe(timed)
        print(f"workload: {args.workload} n={d['n']} span={d['span_s']:.2f}s "
              f"rate={d['mean_rate']:.1f} req/s prompts~{d['prompt_mean']:.0f} "
              f"(max {d['prompt_max']}), {args.clock} clock")
        return timed, [t.request for t in timed]
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab, min(args.shared_prefix, args.prompt_len)).tolist()
    reqs = [Request(uid=i, prompt=shared + rng.integers(
                        0, cfg.vocab, args.prompt_len - len(shared)).tolist(),
                    max_new_tokens=args.max_new, deadline_ms=args.deadline_ms,
                    ttft_deadline_ms=args.ttft_deadline_ms,
                    max_retries=args.max_retries)
            for i in range(args.requests)]
    return None, reqs


def _report(args, cfg, engine, results, dt):
    """The per-request table, the throughput line, the SLA block, the
    lifecycle line and the pool's lines, as the reference prints them."""
    n_tok = sum(len(v) for v in results.values())
    per_req = {u: s for u, s in engine.last_stats.items() if isinstance(u, int)}
    print(f"{'req':>4s} {'status':>9s} {'tokens':>7s} {'cached':>7s} "
          f"{'admit->first(ms)':>17s} {'decode tok/s':>13s} {'e2e tok/s':>10s} "
          f"{'accept':>7s} {'preempts':>9s}")
    for uid in sorted(per_req):
        s = per_req[uid]
        if uid not in results:          # shed, timeout, cancelled, failed
            print(f"{uid:4d} {s['status']:>9s} {'—':>7s} {'—':>7s} "
                  f"{s.get('reason', ''):>17s}")
            continue
        acc = f"{s['accept_rate']:7.2f}" if "accept_rate" in s else f"{'—':>7s}"
        print(f"{uid:4d} {s['status']:>9s} {len(results[uid]):7d} "
              f"{int(s.get('cached_prefix_tokens', 0)):7d} "
              f"{1e3 * s['admit_to_first_s']:17.1f} {s['tok_s']:13.1f} "
              f"{s['e2e_tok_s']:10.1f} {acc} {int(s['preemptions']):9d}")
    spec = f", spec-k={args.spec_k}" if args.spec_k > 1 else ""
    loop = f", {args.workload} open-loop" if args.workload != "closed" else ""
    print(f"\n{n_tok} tokens in {dt:.2f}s = {n_tok / dt:.1f} tok/s "
          f"({args.slots} slots, {args.cache_layout} cache{spec}{loop}, "
          f"{cfg.name}, {engine.device})")
    print("SLA:")
    print(format_summary(engine.last_stats["sla"]))
    counts = {}
    for s in per_req.values():
        counts[s["status"]] = counts.get(s["status"], 0) + 1
    lifecycle = " ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    print(f"lifecycle: {lifecycle}, {engine.recoveries} recoveries, "
          f"{len(engine.last_stats['stragglers'])} straggler events"
          + (", backend degraded to the plain lowering" if engine.backend_degraded else ""))
    p = engine.last_pool_stats
    if p is None:
        return
    if args.audit:
        print(f"audit: {'clean' if p.audit_ok else p.audit_errors} "
              f"(per-round sweep enabled)")
    print(f"pool: {p.num_pages} pages x {p.page_size} tok, peak {p.peak_used_pages} "
          f"pages / {p.peak_tokens} tok ({100 * p.peak_utilization:.0f}% util "
          f"high-water), {p.allocs} allocs / {p.frees} frees / {p.retracts} retracts, "
          f"{engine.preemptions} preemptions")
    if p.kv_dtype is not None or p.swap_outs or p.swap_ins:
        print(f"tiered: kv_dtype={p.kv_dtype or 'auto'}, {p.swap_outs} swap-outs / "
              f"{p.swap_ins} swap-ins ({p.swapped_out_bytes / 1e6:.2f} MB out, "
              f"{p.swapped_in_bytes / 1e6:.2f} MB in)")
    if args.prefix_sharing:
        print(f"sharing: {p.peak_logical_pages} logical pages peak vs "
              f"{p.peak_used_pages} physical ({p.sharing_ratio:.2f}x high-water), "
              f"{p.cached_prefix_tokens} prompt tokens served from cache, {p.shares} "
              f"shares / {p.cow_forks} CoW forks / {p.evictions} evictions, "
              f"{p.index_pages} pages left in the index")


def _serve_cluster(args, model, params, cfg, engine_kw, timed, reqs) -> dict:
    """The fleet path: N engine workers behind the router, closed batch or
    the arrival process on the fleet's round clock; prints the fleet
    table, the fleet SLA, each replica's census and pool, the router's
    figures and the fleet audit, as the reference's CLI does."""
    if args.inject_faults is not None:
        print(f"injecting: per-worker schedules derived from seed {args.inject_faults}")
    roles = (f"1 prefill + {args.replicas - 1} decode" if args.disaggregate
             else f"{args.replicas} mixed")
    print(f"cluster: {roles}, router={args.router}")
    cluster = make_cluster(model, params, replicas=args.replicas,
                           router_policy=args.router, disaggregate=args.disaggregate,
                           faults_seed=args.inject_faults, **engine_kw)
    t0 = time.perf_counter()
    if timed is not None:
        results = cluster.run_workload(timed)
        cluster.close()
    else:
        results = cluster.serve(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in results.values())
    fleet = {u: e for u, e in cluster.fleet.items() if isinstance(u, int)}
    print(f"{'req':>4s} {'status':>9s} {'tokens':>7s} {'replica':>8s} "
          f"{'handoffs':>9s} {'reroutes':>9s} {'first_tok@':>11s}")
    for uid in sorted(fleet):
        e = fleet[uid]
        first = f"round {e['first_token_round']}" if "first_token_round" in e else "—"
        print(f"{uid:4d} {e['status']:>9s} {e['tokens']:7d} {str(e['worker']):>8s} "
              f"{e['handoffs']:9d} {e['reroutes']:9d} {first:>11s}")
    router = cluster.last_stats["router"]
    print(f"\n{n_tok} tokens in {dt:.2f}s = {n_tok / dt:.1f} tok/s "
          f"({args.replicas} replicas x {args.slots} slots, {router['rounds']} fleet "
          f"rounds, {cfg.name}, {model.device})")
    print(f"router: decisions={router['decisions']} "
          f"affinity_hits={router['affinity_hits']} "
          f"handoffs={router['handoffs']} reroutes={router['reroutes']}")
    sla = cluster.last_stats["sla"]
    print("fleet SLA:")
    print(format_summary(sla))
    for wid, census in sorted(sla["replicas"].items()):
        statuses = " ".join(f"{k}={v}" for k, v in sorted(census["statuses"].items()))
        pool = cluster.last_pool_stats.get(int(wid))
        pool_s = (f", pool peak {pool.peak_used_pages}/{pool.num_pages} pages, "
                  f"{pool.allocs} allocs" if pool is not None else "")
        print(f"  replica {wid}: {census['requests']} requests "
              f"({statuses or 'idle'}){pool_s}")
    rep = cluster.audit_report
    print(f"fleet audit: {'clean' if rep.ok else rep.errors}")
    for uid in sorted(results):
        print(f"req {uid}: {results[uid]}")
    return dict(results=results, sla=sla, cluster=cluster)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    cluster_mode = args.replicas > 1 or args.disaggregate
    if cluster_mode and args.cache_layout != "paged":
        ap.error("--replicas > 1 / --disaggregate move KV as pages; "
                 "pass --cache-layout paged")
    if args.disaggregate and args.replicas < 2:
        ap.error("--disaggregate needs --replicas >= 2 (at least one prefill "
                 "and one decode worker)")

    cfg = reduced_config(args.arch)
    device = resolve_device(args.device)
    if device.type == "cuda":
        cfg = with_kernel_head_dims(cfg)
    model = Model(cfg, device=device, dtype=torch.float32,
                  attn_backend=_backend(args.attn_backend))
    params = model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    engine_kw = dict(
        max_seq=args.max_seq, batch_slots=args.slots,
        temperature=args.temperature, seed=args.seed, fused=not args.no_fused,
        attend_block=args.attend_block, prompt_block=args.prompt_block,
        cache_layout=args.cache_layout, page_size=args.page_size,
        num_pages=args.num_pages,
        kv_dtype=None if args.kv_dtype == "auto" else args.kv_dtype,
        preempt=args.preempt, prefix_sharing=args.prefix_sharing,
        evict_policy=args.evict_policy, min_cached_tokens=args.min_cached_tokens,
        spec_k=args.spec_k, draft=args.draft,
        verify_backend=_backend(args.verify_backend), max_queue=args.max_queue,
        shed_policy=args.shed_policy, queue_watermark=args.queue_watermark,
        shed_priority=args.shed_priority,
        free_page_watermark=args.free_page_watermark,
        prefill_budget=args.prefill_budget, audit=args.audit,
        pipeline=args.pipeline, preempt_calibrate=args.preempt_calibrate)
    if cluster_mode:
        timed, reqs = _requests(args, cfg)
        return _serve_cluster(args, model, params, cfg, engine_kw, timed, reqs)
    engine = ServeEngine(model, params, **engine_kw)
    if args.preempt_calibrate:
        cm = engine.cost_model
        print(f"calibrated cost model: swap {cm.swap_gbps / 1e9:.2f} GB/s, "
              f"decode {cm.decode_flops_s / 1e9:.1f} GFLOP/s ({cm.source}, "
              f"{engine.device})")

    timed, reqs = _requests(args, cfg)
    faults = None
    if args.inject_faults is not None:
        faults = FaultSchedule.random(args.inject_faults, uids=tuple(r.uid for r in reqs))
        print(f"injecting (seed {args.inject_faults}): "
              + ", ".join(f.kind + (f"@{f.step}" if f.span == 1 else f"@{f.step}+{f.span}")
                          for f in faults.faults))
    t0 = time.perf_counter()
    if timed is not None:
        results = asyncio.run(serve_open_loop(engine, timed, faults=faults,
                                              clock=args.clock))
    else:
        results = engine.serve(reqs, faults=faults)
    dt = time.perf_counter() - t0
    _report(args, cfg, engine, results, dt)
    for uid in sorted(results):
        print(f"req {uid}: {results[uid]}")
    return dict(results=results, sla=engine.last_stats["sla"],
                cost_model=engine.cost_model, engine=engine)


if __name__ == "__main__":
    main()
