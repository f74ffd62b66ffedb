"""The smoke run's training gradient check for one package tree on one NVIDIA GPU.

    python src/repro_torch/bench/grad_ab.py SRC [--seed N]

For the package tree whose ``src/`` is SRC: full-width qwen2-1.5b with
fp32 master weights, bf16 compute and remat, one gradient on the smoke
run's first batch (S 4096, batch 2, 8 vocab chunks, tf32 off) through the
plain path and then the kernel path on the same weights, as
``chip_smoke.py``'s ``compare_grads`` takes it; its readings
(``chip_smoke.grad_readings``: loss difference, global norms, per-leaf
cosine and norm difference) and the gates they trip.  Beside them,
rmsnorm's kernel against its plain version at training's shape, 8192 x
1536 bf16 rows under an fp32 weight (N(0, 1) both): the share of bf16
outputs whose bits differ, and the largest difference.  One JSON line.

Run it by path, so that the package is imported from SRC, once a tree,
e.g. on ``git archive`` trees of several commits in one call; the gates
and the reading functions come from the ``chip_smoke.py`` beside this
script's repository.  Needs nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]


def rmsnorm_flips(gen: torch.Generator) -> dict:
    """rmsnorm kernel vs plain at 8192 x 1536 bf16 rows, fp32 weight."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    x = torch.randn(8192, 1536, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(1536, generator=gen, device="cuda")
    got, want = rmsnorm(x, w, 1e-6), rmsnorm_ref(x, w, 1e-6)
    torch.cuda.synchronize()
    return dict(rmsnorm_bits_differ_share=(got != want).float().mean().item(),
                rmsnorm_max_abs_diff=(got.float() - want.float()).abs().max().item())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="the package tree's src/ directory")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this check needs an NVIDIA GPU")
    sys.path[:0] = [a.src, str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.lm import Model
    from repro_torch.train.step import make_grad_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(smoke.ARCH)
    kw = dict(device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32)
    model, plain = Model(cfg, **kw), Model(cfg, use_kernels=False, **kw)
    params = model.init(torch.Generator(device="cuda").manual_seed(a.seed))
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=smoke.TRAIN_SEQ,
                                        global_batch=smoke.TRAIN_BATCH, seed=a.seed))
    batch = {k: v.cuda() for k, v in data.batch_at(0).items()}

    def grads(m):
        loss, g = make_grad_fn(m, vocab_chunks=smoke.VOCAB_CHUNKS)(params, batch)
        return loss.item(), g

    p_loss, p_grads = grads(plain)
    r = smoke.grad_readings(*grads(model), p_loss, p_grads)
    smoke.print_readings(a.src, r)
    del p_grads, params
    row = dict(src=a.src, device=torch.cuda.get_device_name(0),
               gates_tripped=smoke.tripped_gates(r),
               **{k: v for k, v in r.items() if k not in ("cosines", "leaf_rel_diffs")},
               **rmsnorm_flips(torch.Generator(device="cuda").manual_seed(a.seed)))
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
