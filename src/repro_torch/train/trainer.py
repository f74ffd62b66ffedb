"""Training loop with a straggler watchdog and a preemption hook.
Counterpart of ``repro.train.trainer``.

Each step's wall time is read after a device synchronize, so it is the
step's and not its enqueue's.  A step slower than ``straggler_factor``
times the rolling median is recorded in ``straggler_events`` (the
reference's simulated backup-step hook).  Not here yet: checkpoints (the
reference's npz + msgpack layout, and the card's machine has no msgpack;
ROADMAP A13), so ``checkpoint_dir`` raises; ``reshard_state`` comes with
the sharded path (ROADMAP A15); the MoE family, whose gating has no
backward yet (ROADMAP A14), is refused.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.optim.optimizer import AdamWConfig
from repro_torch.train.step import TrainState, init_train_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_dir: Optional[str] = None   # not ported yet: raises
    vocab_chunks: int = 8
    accum_steps: int = 1
    straggler_factor: float = 3.0   # step > factor x median -> straggler
    straggler_window: int = 20


class Trainer:
    """Single-device training loop: ``run`` steps ``model`` over
    ``data.batch_at(step)``."""

    def __init__(self, model, data, opt_cfg: AdamWConfig,
                 cfg: TrainerConfig = TrainerConfig()):
        if model.cfg.family != "dense":
            raise NotImplementedError(
                f"training the {model.cfg.family!r} family is not ported yet "
                "(ROADMAP A14: the MoE gating has no backward kernel, and "
                "aux_load_balance_loss is not ported)")
        if cfg.checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoints are not ported yet (ROADMAP A13: the reference's "
                "npz + msgpack layout, and no msgpack on the card's machine)")
        self.model = model
        self.data = data
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self._step = make_train_step(model, opt_cfg, vocab_chunks=cfg.vocab_chunks,
                                     accum_steps=cfg.accum_steps)
        self.straggler_events: List[Dict] = []
        self._durations: List[float] = []

    def _sync(self):
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def run(self, gen: Optional[torch.Generator] = None,
            start_state: Optional[TrainState] = None, start_step: int = 0,
            on_metrics: Optional[Callable[[int, Dict], None]] = None,
            should_stop: Optional[Callable[[], bool]] = None):
        """Steps from ``start_step`` (or 0) to ``total_steps`` from
        ``start_state``, or from fresh weights drawn from ``gen``.
        Returns (state, history of (step, metrics)); metrics hold loss,
        lr, grad_norm and step_time_s as floats.  should_stop: polled
        after each step; when it fires the loop returns early."""
        if start_state is None:
            if gen is None:
                raise ValueError("run needs a generator or a start state")
            state = init_train_state(self.model, gen)
        else:
            state = start_state
        history = []
        for step in range(start_step, self.cfg.total_steps):
            batch = {k: v.to(self.model.device)
                     for k, v in self.data.batch_at(step).items()}
            self._sync()
            t0 = time.perf_counter()
            state, metrics = self._step(state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            metrics = {k: float(v) for k, v in metrics.items()}
            self._watchdog(step, dt)
            metrics["step_time_s"] = dt
            history.append((step, metrics))
            if on_metrics:
                on_metrics(step, metrics)
            if should_stop and should_stop():
                break
        return state, history

    def _watchdog(self, step: int, dt: float):
        w = self._durations[-self.cfg.straggler_window:]
        if len(w) >= 5:
            med = statistics.median(w)
            if dt > self.cfg.straggler_factor * med:
                self.straggler_events.append(
                    {"step": step, "duration": dt, "median": med})
        self._durations.append(dt)
