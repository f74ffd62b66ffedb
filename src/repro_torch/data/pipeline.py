"""Deterministic synthetic token pipeline.  Counterpart of
``repro.data.pipeline``.

``batch_at(step)`` is a pure function of (seed, step): a restart at step N
replays the same stream with no pipeline state to save.  It draws from a
CPU ``torch.Generator`` seeded from (seed, step), so its stream differs
from the reference's ``jax.random`` one (tests hand both packages the same
numpy batch instead), and the batch lives on the CPU; the trainer moves it
to the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_frontend_tokens: int = 0   # > 0 raises: the frontend families are A14


class SyntheticPipeline:
    """Markov-flavoured synthetic LM data (not uniform noise, so losses
    move): base tokens repeated 4 times, 10 % of positions replaced by
    random tokens."""

    def __init__(self, cfg: DataConfig):
        if cfg.n_frontend_tokens:
            raise NotImplementedError("frontend embeddings come with the vlm "
                                      "and encdec families (ROADMAP A14)")
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        seed = np.random.SeedSequence([cfg.seed, step]).generate_state(1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(seed))
        b, s = cfg.global_batch, cfg.seq_len
        base = torch.randint(0, cfg.vocab, (b, (s + 3) // 4), generator=gen)
        toks = base.repeat_interleave(4, dim=1)[:, :s]
        noise = torch.randint(0, cfg.vocab, toks.shape, generator=gen)
        flip = torch.rand(toks.shape, generator=gen) < 0.1
        return {"tokens": torch.where(flip, noise, toks).to(torch.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
