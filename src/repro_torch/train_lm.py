"""Training example: a ~100M-parameter LM, checkpointed, then restarted.

    python -m repro_torch.train_lm [--steps 200] [--batch 8] [--seq 256]
                                   [--ckpt DIR] [--device cpu]

Counterpart of ``examples/train_lm.py``: the same ``demo-100m`` model
(12 layers x 768, 12 query heads over 4 KV heads, d_ff 2048, vocab 32000,
q/k/v biases) in fp32 on the synthetic pipeline (seed 17), AdamW at 6e-4
with 20 warm-up steps, the 4-chunk loss, a checkpoint every
min(50, steps // 2) steps.  Then the restart drill: a second ``Trainer``
on the same folder, asked for up to 20 more steps, resumes from the last
committed step instead of starting over.  The checkpoint folder (a fresh
temporary one unless ``--ckpt``) is removed before and after.  Runs on
the GPU by default.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
from typing import List, Optional

import torch

from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import Model
from repro_torch.optim.optimizer import AdamWConfig, leaves
from repro_torch.train.trainer import Trainer, TrainerConfig

# ~100M params: 12L x 768d GQA transformer (a qwen2-family shape)
DEMO_100M = ModelConfig(
    name="demo-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32000, qkv_bias=True)


def main(argv: Optional[List[str]] = None, cfg: ModelConfig = None) -> dict:
    """Train, then restart from the checkpoint; ``cfg`` replaces
    ``DEMO_100M`` (a test's smaller model).  Returns both histories and
    the step the restart resumed at."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = cfg or DEMO_100M
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_train_lm_")

    model = Model(cfg, device=args.device, dtype=torch.float32)
    print(f"model: {cfg.name} ({model.device})")
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch, seed=17))
    opt = AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps)
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt_every = min(50, max(args.steps // 2, 1))
    trainer = Trainer(model, data, opt, TrainerConfig(
        total_steps=args.steps, checkpoint_every=ckpt_every,
        checkpoint_dir=ckpt, vocab_chunks=4))

    def log(step, m):
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {m['loss']:.4f}  lr {m['lr']:.2e}  "
                  f"gnorm {m['grad_norm']:.2f}  {m['step_time_s'] * 1e3:.0f} ms",
                  flush=True)

    try:
        state, history = trainer.run(torch.Generator(device=model.device).manual_seed(0),
                                     on_metrics=log)
        n_params = sum(p.numel() for p in leaves(state.params))
        del state
        losses = [m["loss"] for _, m in history]
        print(f"\nloss: {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"(improved {losses[0] - losses[-1]:.4f}; {n_params / 1e6:.1f}M params)")
        if args.steps >= 150 and not losses[-1] < losses[0]:
            raise AssertionError("training must reduce loss")

        # --- restart drill: resume from the last committed checkpoint ------
        print("\n-- simulated preemption: restarting from checkpoint --")
        trainer2 = Trainer(model, data, opt, TrainerConfig(
            total_steps=min(args.steps + 20, args.steps * 2),
            checkpoint_every=ckpt_every, checkpoint_dir=ckpt, vocab_chunks=4))
        _, hist2 = trainer2.run(torch.Generator(device=model.device).manual_seed(0),
                                on_metrics=log)
        if hist2:
            print(f"resumed at step {hist2[0][0]} (from committed checkpoint), "
                  f"final loss {hist2[-1][1]['loss']:.4f}")
        else:
            print("checkpoint already at/after target step — nothing to do "
                  "(exact-resume contract held)")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return dict(history=history, resumed=hist2, resumed_at=hist2[0][0] if hist2 else None)


if __name__ == "__main__":
    main()
