"""Loss and train step: vocab-chunked cross entropy, microbatch
accumulation.  Counterpart of ``repro.train.step``.

The loss never holds the full (B, S, V) logits: the backbone produces
hidden states once, then each sequence chunk's logits are computed inside
its own ``torch.utils.checkpoint``, so the backward pass recomputes them
chunk by chunk and live memory is one (B, chunk, V) tile.  At qwen2-1.5b
with S = 4096 and 8 chunks that tile is 0.62 GB in fp32 instead of 5 GB.

Gradients are ``torch.autograd.grad`` of the loss with respect to detached
views of the parameter leaves: the parameters themselves never carry
``requires_grad``, so the optimizer updates them in place.  The
reference's ``grad_sync_fn`` and ``cast_bf16`` exist for its sharded path
and come with ROADMAP A15.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.optim.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    init_adamw,
    leaves,
    tree_map,
)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_train_state(model, gen: torch.Generator) -> TrainState:
    params = model.init(gen)
    return TrainState(params=params, opt=init_adamw(params))


# ---------------------------------------------------------------------------
# Vocab-chunked cross entropy
# ---------------------------------------------------------------------------

def _chunk_loss(xc: torch.Tensor, w_head: torch.Tensor, tc: torch.Tensor,
                mc: torch.Tensor, real_vocab: Optional[int]) -> torch.Tensor:
    logits = (xc @ w_head.to(xc.dtype)).float()
    v_pad = w_head.shape[-1]
    if real_vocab is not None and real_vocab < v_pad:
        col = torch.arange(v_pad, device=logits.device)
        logits = torch.where(col < real_vocab, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return torch.sum((lse - ll) * mc)


def chunked_xent_loss(x: torch.Tensor, w_head: torch.Tensor,
                      targets: torch.Tensor, mask: torch.Tensor,
                      n_chunks: int = 8,
                      real_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean next-token cross entropy without the full logits.

    x (B, S, d) hidden states; w_head (d, V); targets/mask (B, S).
    n_chunks falls back to 1 when it does not divide S.  real_vocab: when
    the head is padded, columns >= it are left out of the logsumexp."""
    s = x.shape[1]
    if s % n_chunks != 0:
        n_chunks = 1
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    if n_chunks == 1:
        return _chunk_loss(x, w_head, targets, mask, real_vocab) / denom
    c = s // n_chunks
    total = x.new_zeros((), dtype=torch.float32)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        # recompute the chunk's logits in the backward pass
        total = total + checkpoint(_chunk_loss, x[:, sl], w_head, targets[:, sl],
                                   mask[:, sl], real_vocab, use_reentrant=False,
                                   preserve_rng_state=False)
    return total / denom


def make_loss_fn(model, *, vocab_chunks: int = 8) -> Callable:
    """batch = {'tokens': (B, S)} -> scalar loss (autograd on)."""
    cfg = model.cfg

    def loss_fn(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = model.backbone(params, batch)
        # the final norm before the head, as serving applies it
        x = model._norm(x, params["ln_f"])
        tokens = batch["tokens"].to(x.device)
        targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        mask = torch.ones(tokens.shape, dtype=torch.float32, device=x.device)
        mask[:, -1] = 0.0
        # the head is embed.T when tied; a padded head's columns past
        # cfg.vocab stay out of the logsumexp
        return chunked_xent_loss(x, model.head_weight(params), targets, mask,
                                 vocab_chunks, real_vocab=cfg.vocab)

    return loss_fn


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def value_and_grad(loss_fn: Callable) -> Callable:
    """(params, batch) -> (loss, grads): ``jax.value_and_grad`` of a loss
    over a dict of parameter leaves.  The grads are fresh tensors in the
    params' nesting; the loss is detached."""

    def fn(params, batch):
        flat = leaves(params)
        live = {id(p): p.detach().requires_grad_(True) for p in flat}
        tracked = tree_map(lambda p: live[id(p)], params)
        with torch.enable_grad():
            loss = loss_fn(tracked, batch)
            grads = torch.autograd.grad(loss, [live[id(p)] for p in flat])
        by_id = dict(zip((id(p) for p in flat), grads))
        return loss.detach(), tree_map(lambda p: by_id[id(p)], params)

    return fn


def make_grad_fn(model, *, vocab_chunks: int = 8, accum_steps: int = 1
                 ) -> Callable:
    """(params, batch) -> (loss, grads).  accum_steps > 1 splits the batch
    into that many microbatches, sums their fp32 gradients and losses and
    averages (peak activation memory / accum_steps)."""
    grad_fn = value_and_grad(make_loss_fn(model, vocab_chunks=vocab_chunks))

    def compute_grads(params, batch):
        if accum_steps == 1:
            return grad_fn(params, batch)
        b = batch["tokens"].shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} does not split into {accum_steps} "
                             "microbatches")
        loss, grads = None, None
        for i, mb in enumerate(zip(*(v.chunk(accum_steps) for v in batch.values()))):
            l, g = grad_fn(params, dict(zip(batch, mb)))
            g = tree_map(lambda t: t.float(), g)
            if i == 0:
                loss, grads = l, g
            else:
                loss = loss + l
                for a, t in zip(leaves(grads), leaves(g)):
                    a.add_(t)
        inv = 1.0 / accum_steps
        return loss * inv, tree_map(lambda t: t.mul_(inv), grads)

    return compute_grads


def make_train_step(model, opt_cfg: AdamWConfig, *, vocab_chunks: int = 8,
                    accum_steps: int = 1) -> Callable:
    """train_step(state, batch) -> (state, metrics); the state's params and
    optimizer moments are updated in place.  metrics: loss, lr, grad_norm
    (tensors and floats; the caller reads them)."""
    compute_grads = make_grad_fn(model, vocab_chunks=vocab_chunks,
                                 accum_steps=accum_steps)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, grads = compute_grads(state.params, batch)
        params, opt, metrics = adamw_update(opt_cfg, grads, state.opt, state.params)
        return TrainState(params=params, opt=opt), dict(metrics, loss=loss)

    return train_step
