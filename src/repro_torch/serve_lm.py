"""Serving example: batched generation and the slot scheduler, sampled.

    python -m repro_torch.serve_lm [--device cpu] [--layers N]

Counterpart of ``examples/serve_lm.py``: a small dense model with random
weights (seeded) behind a ``ServeEngine`` at temperature 0.8, seed 3.
(1) ``generate`` of a (4, 16) prompt batch for 24 tokens, row i sampling
with uid i; (2) nine requests of mixed lengths and budgets over four
slots through ``serve``.  Each token is drawn with the reference's
threefry (uid, position) key, so the tokens do not depend on the
admission order.  Runs on the GPU by default (the decode steps replayed
as captured CUDA graphs), in seconds on the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import Model
from repro_torch.serve.engine import Request, ServeEngine

MAX_SEQ = 128


def demo_config(n_layers: int = 4) -> ModelConfig:
    """The example's model: dense, d_model 256, 4 query heads over 2 KV
    heads, vocab 4096."""
    return ModelConfig(name="demo-serve", family="dense", n_layers=n_layers,
                       d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=4096)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args(argv)

    cfg = demo_config(args.layers)
    model = Model(cfg, device=args.device, dtype=torch.float32)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    engine = ServeEngine(model, params, max_seq=MAX_SEQ, batch_slots=4,
                         temperature=0.8, seed=3)

    # --- batch generate (equal-length prompts) -----------------------------
    prompts = torch.randint(0, cfg.vocab, (4, 16),
                            generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    out = engine.generate(prompts, n_tokens=24).cpu()
    dt = time.perf_counter() - t0
    print(f"batch generate: {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({out.numel() / dt:.0f} tok/s)")
    print("sample:", out[0, :12].tolist())

    # --- continuous batching: mixed lengths, more requests than slots ------
    rng = np.random.default_rng(7)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(4, 24)).tolist(),
                    max_new_tokens=int(rng.integers(4, 16)))
            for i in range(9)]
    t0 = time.perf_counter()
    results = engine.serve(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in results.values())
    print(f"\nslot scheduler: {len(reqs)} requests over 4 slots, "
          f"{n_tok} tokens in {dt:.1f}s")
    for uid in sorted(results):
        print(f"  req {uid}: {len(results[uid])} tokens")
    if set(results) != {r.uid for r in reqs}:
        raise AssertionError("not every request was served")
    print("all requests served.")
    return dict(generate_shape=tuple(out.shape), generate=out, results=results,
                requests=len(reqs), served=len(results), tokens=n_tok,
                recoveries=engine.recoveries, backend_degraded=engine.backend_degraded)


if __name__ == "__main__":
    main()
