"""Speculative decoding: a draft model proposes, the target verifies a
k-token window in one pass over the paged cache.

Counterpart of ``repro.serve.spec_decode``.  Single-token serving pays one
pass of launches per token; here a cheap draft proposes k - 1 tokens and
the target scores all k window positions in one ``decode_verify_step``
(its attention is the ``paged_flash_verify`` kernel), so up to k tokens
commit for one pass of the target's launches.

Acceptance is the longest prefix of the draft matching the target's own
tokens: the target token at position p comes from logits that see only
positions < p, and is drawn with the (uid, p) key whatever the window's
shape, so the draft cannot change it.  A draft token is kept iff it
equals that token; the first mismatch is replaced by the target's token
and the step ends.  The committed stream therefore equals
non-speculative decode, greedy or sampled; the draft only sets how many
tokens each step commits.  The draft samples with the same keys, so a
well-matched draft reproduces the target's draws.

Drafts (``resolve_draft``):

  self-speculation   the target's first N layers with its own embedding,
                     final norm and LM head: no extra parameters, the
                     draft's stacked layer leaves are views of the
                     target's.
  independent draft  a registry architecture at reduced shapes with fresh
                     parameters from a ``torch.Generator``.

The draft keeps a dense slot cache and is prefilled at admission beside
the target.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def make_self_draft(model, params, n_layers: int) -> Tuple[object, dict]:
    """The target's first ``n_layers`` layers as a draft: returns
    ``(draft_model, draft_params)``.  Embedding, ``ln_f`` and ``lm_head``
    are the target's tensors; the stacked layer leaves are ``[:n_layers]``
    views (no copy)."""
    from repro_torch.models.lm import Model

    cfg = model.cfg
    if not 1 <= n_layers <= cfg.n_layers:
        raise ValueError(f"self-draft depth {n_layers} outside "
                         f"[1, {cfg.n_layers}]")
    draft_cfg = dataclasses.replace(cfg, n_layers=n_layers,
                                    name=f"{cfg.name}-draft{n_layers}")
    draft_model = Model(draft_cfg, device=model.device, dtype=model.dtype,
                        param_dtype=model.param_dtype,
                        use_kernels=model.use_kernels, wf=model.wf)

    def head_layers(tree):
        if isinstance(tree, dict):
            return {k: head_layers(v) for k, v in tree.items()}
        return tree[:n_layers]

    draft_params = dict(params)
    draft_params["layers"] = head_layers(params["layers"])
    return draft_model, draft_params


def resolve_draft(model, params, draft, *, seed: int = 0):
    """Draft spec -> ``(draft_model, draft_params)``.

    draft: ``None`` / ``'self'`` (half-depth self-speculation), ``'self:N'``
    (N-layer prefix), an architecture name from the registry (reduced
    shapes, the target's vocabulary, fresh parameters drawn from a
    ``torch.Generator`` seeded with ``seed``), or an explicit
    ``(draft_model, draft_params)`` pair passed through unchanged."""
    if isinstance(draft, tuple):
        return draft
    if draft is None or draft == "self":
        return make_self_draft(model, params, max(1, model.cfg.n_layers // 2))
    if isinstance(draft, str) and draft.startswith("self:"):
        return make_self_draft(model, params, int(draft.split(":", 1)[1]))
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import Model

    cfg = reduced_config(draft)
    if cfg.vocab != model.cfg.vocab:
        # proposals must live in the target's vocabulary
        cfg = dataclasses.replace(cfg, vocab=model.cfg.vocab)
    draft_model = Model(cfg, device=model.device, dtype=model.dtype,
                        use_kernels=model.use_kernels)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return draft_model, draft_model.init(gen)


def build_spec_step(model, draft_model, *, max_seq: int, spec_k: int,
                    verify_backend=None, sampler=None):
    """The propose + verify + accept step as a plain function:

      (params, draft_params, pool, draft_cache, block_tables, tok, pos,
       remaining, uids, spec_mask, attend_len, out, nan_mask=None,
       collapse_mask=None) -> window logits (B, T, V)

    ``sampler`` (``serve.sampling.StepSampler``) draws the draft's row i
    and the target's window row i at pos + i + 1 with each slot's
    ``uids`` key: the step draws the Gumbel noise of the window's T
    positions once, and the draft's row i and the target's row i add
    the same noise row; None is greedy (argmax).

    Every output lands in place, so that one captured CUDA graph holds
    draft, verify and accept (``serve.step_graph``): the pool and the
    draft cache take the window's rows, ``tok``, ``pos`` and
    ``remaining`` advance by each row's commit, and ``out`` ((3 + T, B)
    int32, ``step_graph.write_out``) takes the target tokens (rows
    [0, T)), the commit counts, done and bad.  A quantized pool's
    ``k_scales``/``v_scales`` ride in ``pool`` beside the values, so the
    verify window stores its rows quantized and reads them through the
    int8 kernel (the reference rebuilds the donated pool leaf by leaf for
    the same reason).  ``spec_mask`` rows
    that are False commit exactly one token (the target's), which is how
    non-speculative requests ride the same batch; their window rows are
    overwritten before they are ever attended, like a rejected draft tail.
    ``bad`` flags rows whose window logits are not finite anywhere: the
    engine fails those requests instead of committing garbage.

    The fault masks ((B,) bool fixed buffers the engine writes in rounds
    a fault targets, see ``serve.faults``): ``nan_mask`` rows get their
    verify logits poisoned to NaN before the guard; ``collapse_mask`` rows
    get each draft proposal moved to ``(token + 1) % vocab`` (fed on to
    the next draft step, as the reference's), so their windows reject at
    the first draft row and commit one token, the target's own, without
    changing any committed value."""
    from repro_torch.serve.step_graph import poison_rows, write_out

    t_window = spec_k
    vocab = model.cfg.vocab

    def spec_step(params, draft_params, pool, draft_cache, block_tables, tok,
                  pos, remaining, uids, spec_mask, attend_len, out, nan_mask=None,
                  collapse_mask=None):
        # propose: T - 1 draft decode steps on the dense draft cache,
        # drawn with the keys the target uses at the same positions
        window = [tok]
        dtok = tok
        if sampler is not None:
            rows = torch.arange(1, t_window + 1, dtype=pos.dtype, device=pos.device)
            noise = sampler.noise(pos[:, None] + rows, uids[:, None],
                                  model.cfg.vocab)                # (B, T, V)
        for i in range(t_window - 1):
            dlogits, _ = draft_model.decode_step(draft_params, draft_cache, dtok,
                                                 pos + i, attend_len)
            if sampler is None:
                dtok = torch.argmax(dlogits, dim=-1).to(torch.int32)
            else:
                dtok = sampler.draw(noise[:, i], dlogits)
            if collapse_mask is not None:
                dtok = torch.where(collapse_mask, (dtok + 1) % vocab, dtok)
            window.append(dtok)
        win = torch.stack(window, dim=1)                          # (B, T)

        # verify: every window position scored in one pass; the window's
        # K/V rows are written through the block tables first
        cache = dict(pool, block_tables=block_tables)
        logits, _ = model.decode_verify_step(params, cache, win, pos, attend_len,
                                             verify_backend)
        if nan_mask is not None:
            logits = poison_rows(logits, nan_mask)
        bad = ~torch.isfinite(logits).all(dim=-1).all(dim=-1)

        # accept: the target's token per position, longest matching prefix
        if sampler is None:
            targets = torch.argmax(logits, dim=-1).to(torch.int32)    # (B, T)
        else:
            targets = sampler.draw(noise, logits)
        if t_window > 1:
            match = (win[:, 1:] == targets[:, :-1]).to(torch.int32)
            lead = torch.cumprod(match, dim=1).sum(dim=1)
        else:
            lead = torch.zeros_like(tok)
        commit = torch.where(spec_mask, lead + 1, 1)
        # never overrun the token budget or the position cap (finished
        # slots coast at commit = 1, as in the non-speculative step)
        commit = torch.minimum(commit, torch.clamp(remaining, min=1))
        commit = torch.clamp(torch.minimum(commit, max_seq - 1 - pos), min=1)
        commit = commit.to(torch.int32)
        tok.copy_(torch.gather(targets, 1, (commit - 1).long()[:, None])[:, 0])
        pos.add_(commit)
        remaining.sub_(commit)
        done = (remaining <= 0) | (pos >= max_seq - 1)
        write_out(out, targets, commit, done, bad)
        return logits

    return spec_step
