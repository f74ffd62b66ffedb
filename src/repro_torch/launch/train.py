"""Training launcher.  Counterpart of ``repro.launch.train``, with its flags.

Like the reference it always takes the reduced config (its ``--reduced``
flag cannot be turned off) and trains in fp32; the full-width runs on the
card are ``chip_smoke.py``'s training phases.  Trains the dense family
(qwen2-1.5b, and minicpm3-4b's MLA attention), the MoE family
(granite-moe-1b-a400m, olmoe-1b-7b), RWKV6 (rwkv6-7b) and the Mamba2
hybrid (zamba2-2.7b).  Runs on ``cuda`` unless ``--device cpu``; on the
card an MLA config keeps its full head dims (the flash kernels' (96, 64)
instance; the reduced config's (48, 32) has none).  The reduced Zamba2's
shared block has 4 heads of 64, so on the card its attention runs the
flash kernels' (64, 64) instance; the full config's heads of 80 run (80,
80) (``chip_smoke.py``'s ``recurrent train`` phase).  RWKV6 runs no
attention.  With ``--ckpt-dir`` it commits a checkpoint every
``--ckpt-every`` steps and, run again on the same folder, resumes from
the newest committed step.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 50 --batch 8 --seq 128 [--ckpt-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import (
    get_config,
    reduced_config,
    with_kernel_head_dims,
)
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
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
    device = resolve_device(args.device)
    if device.type == "cuda":
        cfg = with_kernel_head_dims(cfg)
    wf = WarpFeatureConfig(
        reduction_backend=None if args.warp_backend == "auto" else args.warp_backend)
    model = Model(cfg, device=device, dtype=torch.float32, wf=wf,
                  attn_backend=None if args.attn_backend == "auto"
                  else args.attn_backend)
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch, seed=args.seed))
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    trainer = Trainer(model, data, opt, TrainerConfig(
        total_steps=args.steps, checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every, accum_steps=args.accum,
        vocab_chunks=4))

    def log(step, m):
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {m['loss']:.4f}  "
                  f"lr {m['lr']:.2e}  gnorm {m['grad_norm']:.3f}  "
                  f"{m['step_time_s'] * 1e3:.0f} ms", flush=True)

    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    state, history = trainer.run(gen, on_metrics=log)
    if not history:
        print(f"nothing to do: {args.ckpt_dir} holds a step at or past {args.steps}")
        return history
    if history[0][0] > 0:
        print(f"resumed at step {history[0][0]} from the committed checkpoint "
              f"in {args.ckpt_dir}")
    first, last = history[0][1]["loss"], history[-1][1]["loss"]
    n_params = sum(p.numel() for p in leaves(state.params))
    print(f"loss {first:.4f} -> {last:.4f} over {len(history)} steps "
          f"({cfg.name}, {n_params:,} params, {model.device})")
    if trainer.straggler_events:
        print(f"straggler events: {len(trainer.straggler_events)}")
    return history


if __name__ == "__main__":
    main()
