"""Fault-tolerant training loop: checkpoint/restart, stragglers, the
preemption hook.  Counterpart of ``repro.train.trainer``.

  * checkpoints are atomic (tmp + rename, ``repro_torch.checkpoint``) and
    carry the step, so a restart resumes from the newest *committed* step
    with a bit-identical stream (the data pipeline is a pure function of
    the step);
  * each step's wall time is read after a device synchronize, so it is
    the step's and not its enqueue's; a step slower than
    ``straggler_factor`` times the rolling median is recorded in
    ``straggler_events`` (the reference's simulated backup-step hook).

Not here yet: ``reshard_state``, which comes with the sharded path
(ROADMAP A15).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    prune_old,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.optim.optimizer import AdamWConfig
from repro_torch.train.step import TrainState, init_train_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    log_every: int = 10
    vocab_chunks: int = 8
    accum_steps: int = 1
    straggler_factor: float = 3.0   # step > factor x median -> straggler
    straggler_window: int = 20
    async_checkpoint: bool = False  # overlap serialization with training


class Trainer:
    """Single-device training loop: ``run`` steps ``model`` over
    ``data.batch_at(step)``."""

    def __init__(self, model, data, opt_cfg: AdamWConfig,
                 cfg: TrainerConfig = TrainerConfig()):
        self.model = model
        self.data = data
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self._step = make_train_step(model, opt_cfg, vocab_chunks=cfg.vocab_chunks,
                                     accum_steps=cfg.accum_steps)
        self.straggler_events: List[Dict] = []
        self._durations: List[float] = []
        self._async_ckpt: Optional[AsyncCheckpointer] = None
        if cfg.async_checkpoint and cfg.checkpoint_dir:
            self._async_ckpt = AsyncCheckpointer(cfg.checkpoint_dir,
                                                 keep=cfg.keep_checkpoints)

    def _sync(self):
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def init_or_restore(self, gen: torch.Generator) -> Tuple[TrainState, int]:
        """(state, start_step): fresh weights drawn from ``gen``, replaced
        by the newest committed checkpoint where ``checkpoint_dir`` has
        one."""
        state = init_train_state(self.model, gen)
        ckpt = self.cfg.checkpoint_dir
        if ckpt and latest_step(ckpt) is not None:
            state, step, _meta = restore_checkpoint(ckpt, state)
            return state, int(step)
        return state, 0

    def run(self, gen: Optional[torch.Generator] = None,
            start_state: Optional[TrainState] = None,
            start_step: Optional[int] = None,
            on_metrics: Optional[Callable[[int, Dict], None]] = None,
            should_stop: Optional[Callable[[], bool]] = None):
        """Steps to ``total_steps`` from ``start_state`` at ``start_step``
        (or 0), or from :meth:`init_or_restore` of ``gen``.  Returns
        (state, history of (step, metrics)); metrics hold loss, lr,
        grad_norm and step_time_s as floats.  Every ``checkpoint_every``
        steps the state is committed (metadata: loss, preempted).
        should_stop: the preemption hook, polled after each step; when it
        fires the loop commits a checkpoint and returns early, and a
        restart resumes bit-identically from it."""
        if start_state is None:
            if gen is None:
                raise ValueError("run needs a generator or a start state")
            state, step0 = self.init_or_restore(gen)
        else:
            state, step0 = start_state, int(start_step or 0)
        history = []
        for step in range(step0, self.cfg.total_steps):
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
            preempted = bool(should_stop and should_stop())
            if (self.cfg.checkpoint_dir
                    and ((step + 1) % self.cfg.checkpoint_every == 0 or preempted)):
                self._checkpoint(step + 1, state,
                                 {"loss": metrics["loss"], "preempted": preempted})
            if preempted:
                break
        if self._async_ckpt is not None:
            self._async_ckpt.wait()  # commit in-flight saves before return
        return state, history

    def _checkpoint(self, step: int, state: TrainState, meta: Dict):
        if self._async_ckpt is not None:
            self._async_ckpt.save(step, state, metadata=meta)
        else:
            save_checkpoint(self.cfg.checkpoint_dir, step, state, metadata=meta)
            prune_old(self.cfg.checkpoint_dir, self.cfg.keep_checkpoints)

    def _watchdog(self, step: int, dt: float):
        w = self._durations[-self.cfg.straggler_window:]
        if len(w) >= 5:
            med = statistics.median(w)
            if dt > self.cfg.straggler_factor * med:
                self.straggler_events.append(
                    {"step": step, "duration": dt, "median": med})
        self._durations.append(dt)
