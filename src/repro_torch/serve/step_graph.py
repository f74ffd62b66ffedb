"""Captured decode and verify steps: the port's counterpart of the
reference engine's jit cache (``repro.serve.engine``'s fused, paged and
speculative steps, one executable per attend bucket).

A serving step has fixed shapes once its attend bucket is known: the
batch is the engine's slots, the cache and the block tables are fixed
buffers.  So each (step kind, attend bucket) pair is captured once as a
``torch.cuda.CUDAGraph`` and every later step of that pair is one
replay: the hand-written kernels (``rmsnorm``, the decode or verify
split kernel and its combine, ``moe_gating``), cuBLAS and the
elementwise ops of the whole step, launched by one call instead of about
30 eager launches a layer through Python.

The step functions read fixed buffers and write all their state in place
(:func:`decode_step_fn`, ``spec_decode.build_spec_step``): the cache or
pool rows, ``tok``, ``pos``, ``remaining`` and one ``(3 + T, slots)``
int32 output (:func:`write_out`).  A sampled step (temperature > 0) also
reads the per-slot ``uids`` buffer and derives every row's threefry key
from it and ``pos`` on the device (``serve.sampling``), so the graph
holds the sampler too and no replay needs the host.  A buffer the engine
rebound would leave a graph reading the old storage, so the engine keeps
every captured input for its lifetime.

:class:`StepGraphs` holds one engine's graphs over one shared graph
memory pool.  A pair's first use warms the step up on a side stream (the
library's first load and ``cudaFuncSetAttribute`` happen there, outside
capture), puts ``tok``/``pos``/``remaining`` back as they were (the
cache rows it wrote are rewritten identically by the replay), captures,
then replays.  A capture or replay that fails raises: nothing runs the
step eagerly instead.  Off CUDA (or with graphs off) the same step
function runs uncaptured.

Launch counters: the kernel wrappers count on the host, and a replay
calls no wrapper.  A capture therefore reads ``kernels.launch_counts()``
before and after, takes back what the capture added (nothing launched),
and every replay adds that difference (``kernels.add_launches``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Optional, Sequence

import torch

from repro_torch import kernels

# the captured step kinds: one per cache layout and pool dtype, and the
# speculative step (draft, verify and accept) on either pool
STEP_KINDS = ("dense", "paged", "paged_int8", "spec", "spec_int8")


def step_kind(cache_layout: str, kv_dtype, spec_k: int) -> str:
    """The step kind an engine of this configuration replays."""
    if cache_layout == "dense":
        return "dense"
    base = "spec" if spec_k > 1 else "paged"
    return base + "_int8" if kv_dtype == "int8" else base


def write_out(out: torch.Tensor, targets: torch.Tensor, commit, done: torch.Tensor,
              bad: torch.Tensor):
    """Fill a step's output ``out`` (3 + T, B) int32 in place: rows
    [0, T) the target tokens (``targets`` (B, T)), row T the commit count
    (an int for every row, or (B,)), T + 1 done, T + 2 bad."""
    t = targets.shape[1]
    out[:t].copy_(targets.t())
    if isinstance(commit, int):
        out[t].fill_(commit)
    else:
        out[t].copy_(commit)
    out[t + 1].copy_(done)
    out[t + 2].copy_(bad)


def decode_step_fn(model, params, cache: Dict[str, torch.Tensor], tok: torch.Tensor,
                   pos: torch.Tensor, remaining: torch.Tensor, out: torch.Tensor,
                   attend_len: int, max_seq: int, uids: Optional[torch.Tensor] = None,
                   sampler: Optional[Callable] = None) -> Callable[[], torch.Tensor]:
    """One decode step for every slot as a closure over fixed buffers:
    the K/V rows at ``pos`` (dense cache, or the pool through its
    ``block_tables``), then ``tok`` <- the next token, ``pos`` += 1,
    ``remaining`` -= 1 and ``out`` (new token, commit 1, done, bad), all
    in place.  The next token is the argmax, or with ``sampler``
    (``serve.sampling.StepSampler``: logits, positions, uids -> tokens)
    each row's draw at position pos + 1 with its ``uids`` key.  The
    closure returns the logits (B, V)."""

    def step() -> torch.Tensor:
        logits, _ = model.decode_step(params, cache, tok, pos, attend_len=attend_len)
        bad = ~torch.isfinite(logits).all(dim=-1)
        if sampler is None:
            tok.copy_(torch.argmax(logits, dim=-1))
        else:
            tok.copy_(sampler(logits, pos + 1, uids))
        pos.add_(1)
        remaining.sub_(1)
        done = (remaining <= 0) | (pos >= max_seq - 1)
        write_out(out, tok[:, None], 1, done, bad)
        return logits

    return step


class StepGraphs:
    """One engine's captured steps, keyed by (step kind, attend bucket),
    over one shared graph memory pool.  ``enabled`` False (CPU, or the
    serial engine) runs every step uncaptured.

    Sharing the pool is safe because a step writes everything it keeps
    into buffers allocated outside the graphs; what a graph allocates is
    dead when its replay ends, bar its returned logits, which the entry
    keeps alive (so no later capture takes their memory)."""

    def __init__(self, device, enabled: bool):
        self.device = torch.device(device)
        self.enabled = enabled and self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.enabled else None
        # key -> (graph, launches a replay, the graph's logits)
        self.graphs: Dict[Hashable, tuple] = {}
        self.capture_s = 0.0
        self.replays = 0

    def run(self, key: Hashable, fn: Callable[[], torch.Tensor],
            restore: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        """Run ``fn`` (one step over fixed buffers): captured at its key's
        first use and replayed, or uncaptured when disabled.  ``restore``
        lists the state tensors the warm-up must leave as it found them
        (those ``fn`` advances rather than rewrites).  Returns the logits
        (a graph's static output: valid until its next replay)."""
        if not self.enabled:
            return fn()
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(fn, restore)
        graph, delta, logits = entry
        graph.replay()
        kernels.add_launches(delta)
        self.replays += 1
        return logits

    def _capture(self, fn, restore) -> tuple:
        t0 = time.perf_counter()
        saved = [t.clone() for t in restore]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn()
        main.wait_stream(side)
        for t, s in zip(restore, saved):
            t.copy_(s)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            logits = fn()
        after = kernels.launch_counts()
        delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        kernels.add_launches({k: -n for k, n in delta.items()})
        self.capture_s += time.perf_counter() - t0
        return graph, delta, logits

    def launches(self) -> Dict[Hashable, Dict[str, int]]:
        """Each graph's launches a replay, by key."""
        return {key: dict(entry[1]) for key, entry in self.graphs.items()}
