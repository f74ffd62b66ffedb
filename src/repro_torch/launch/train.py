"""Training launcher.  Counterpart of ``repro.launch.train``, with its flags.

Like the reference it always takes the reduced config (its ``--reduced``
flag cannot be turned off) and trains in fp32; the full-width run on the
card is ``chip_smoke.py``'s training phase.  Runs on ``cuda`` unless
``--device cpu``.  ``--ckpt-dir`` raises until checkpoints are ported
(ROADMAP A13); the reference's ``--ckpt-every`` comes with them.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 50 --batch 8 --seq 128 [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.models.layers import WarpFeatureConfig
from repro_torch.models.lm import Model
from repro_torch.optim.optimizer import AdamWConfig, leaves
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="not ported yet: raises (ROADMAP A13)")
    ap.add_argument("--warp-backend", default="auto",
                    choices=["auto", "hw", "sw", "kernel"],
                    help="rmsnorm reduction lowering (auto: the CUDA kernel, "
                         "which runs its plain version on the CPU)")
    ap.add_argument("--attn-backend", default="auto",
                    choices=["auto", "kernel", "torch"],
                    help="training attention lowering (auto: the flash "
                         "kernels, plain versions on the CPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    wf = WarpFeatureConfig(
        reduction_backend=None if args.warp_backend == "auto" else args.warp_backend)
    model = Model(cfg, device=args.device, dtype=torch.float32, wf=wf,
                  attn_backend=None if args.attn_backend == "auto"
                  else args.attn_backend)
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch, seed=args.seed))
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    trainer = Trainer(model, data, opt, TrainerConfig(
        total_steps=args.steps, checkpoint_dir=args.ckpt_dir,
        accum_steps=args.accum, vocab_chunks=4))

    def log(step, m):
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {m['loss']:.4f}  "
                  f"lr {m['lr']:.2e}  gnorm {m['grad_norm']:.3f}  "
                  f"{m['step_time_s'] * 1e3:.0f} ms", flush=True)

    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    state, history = trainer.run(gen, on_metrics=log)
    first, last = history[0][1]["loss"], history[-1][1]["loss"]
    n_params = sum(p.numel() for p in leaves(state.params))
    print(f"loss {first:.4f} -> {last:.4f} over {len(history)} steps "
          f"({cfg.name}, {n_params:,} params, {model.device})")
    if trainer.straggler_events:
        print(f"straggler events: {len(trainer.straggler_events)}")
    return history


if __name__ == "__main__":
    main()
