"""AdamW with a cosine schedule and global-norm clipping, on plain dicts of
tensors.  Counterpart of ``repro.optim.optimizer``.

Where the reference returns new pytrees, :func:`adamw_update` updates
params, m and v in place (one leaf at a time, so the temporaries stay one
leaf large) and returns them: at qwen2-1.5b the fp32 state is ~28 GB, and
a second copy would not be free.  Not ``torch.optim.AdamW``: weight decay
goes by the **stacked** leaf's rank (``p.ndim >= 2``, ``optimizer.py:78``),
so the stacked (L, d) norm weights and (L, .) biases are decayed and the
(d,) final norm is not, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) for every tensor of a nested dict, in
    sorted-key order (the order of ``jax.tree.leaves`` on the same dict)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in ``named_leaves`` order."""
    return [t for _, t in named_leaves(tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_adamw(params) -> AdamWState:
    return AdamWState(step=0,
                      m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
                      v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup to ``cfg.lr``, then cosine decay to
    ``min_lr_ratio * lr`` at ``total_steps``."""
    warm = step / max(cfg.warmup_steps, 1)
    progress = min(max((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + math.cos(math.pi * progress))
    return cfg.lr * (warm if step < cfg.warmup_steps else cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor on
    the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """grads scaled by min(1, max_norm / (norm + 1e-9)), in fp32 (in place
    where they already are), and the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float().mul_(scale), grads), norm


def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params
                 ) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """One AdamW step.  Returns (params, state, metrics), params and the
    state's m, v updated in place; metrics hold ``lr`` (a float) and
    ``grad_norm`` (a 0-d tensor, the norm before clipping)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    with torch.no_grad():
        for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v),
                              leaves(params)):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            if p.ndim >= 2:  # decoupled weight decay on (stacked) matrices only
                delta.add_(p.float(), alpha=cfg.weight_decay)
            p.sub_(delta.mul_(lr))      # in fp32, rounded once to p's dtype
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics
