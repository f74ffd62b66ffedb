"""The cost model behind ``ServeEngine(preempt="auto")``, and its one-shot
measurement.

Counterpart of ``repro.serve.calibrate`` (that module imports JAX, so the
port keeps its own copy).  ``preempt="auto"`` decides between host swap
and requeue-recompute by comparing transfer seconds per resident token
(pool bytes per token over ``swap_gbps``) against recompute seconds per
token (2 * parameters FLOPs over ``decode_flops_s``).  The defaults are
the reference's planning figures, so an engine that does not calibrate
decides as the reference does.  ``ServeEngine(preempt_calibrate=True)``
(``--preempt-calibrate`` on ``repro_torch.launch.serve``) measures both on
the engine's own device and model instead:

- :func:`measure_swap_bandwidth` times the copies the swap tier issues, a
  device slice into pinned host memory (``kv_cache.swap_out``) and back
  (``swap_in_pages``), and reports bytes/s;
- :func:`measure_decode_flops_s` times a warmed single-slot
  ``decode_step`` of the engine's model on a fresh dense cache, best of
  N, and reports 2 * parameters / seconds.

On a CUDA device both are timed with CUDA events on that device; on the
CPU with ``time.perf_counter``.  The decode figure is the eager step,
which the host paces on the card (a launch at a time): the reference
times one compiled dispatch, so the port's figure is the lower one and
leans ``auto`` towards the swap.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.optim.optimizer import leaves

# conservative planning figures for a host link and a mid-size accelerator
DEFAULT_SWAP_GBPS = 8e9           # bytes/s across the device<->host link
DEFAULT_DECODE_FLOPS_S = 5e10     # effective decode FLOPs/s


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Figures the ``preempt="auto"`` comparison runs on, plus where they
    came from (``"default"``, ``"measured"`` or anything a caller stamps on
    its own)."""
    swap_gbps: float
    decode_flops_s: float
    source: str = "default"


DEFAULT_COST_MODEL = CostModel(DEFAULT_SWAP_GBPS, DEFAULT_DECODE_FLOPS_S)


def _best_seconds(fn, repeats: int, device: torch.device) -> float:
    """The fastest of ``repeats`` calls of ``fn``: CUDA events on a CUDA
    device (the card's clock, synchronized on the end event), else the
    host's ``perf_counter``."""
    best = float("inf")
    for _ in range(max(1, repeats)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return max(best, 1e-9)


def measure_swap_bandwidth(nbytes: int = 4 << 20, repeats: int = 3,
                           device="cuda") -> float:
    """Effective device<->host bandwidth in bytes/s: the best of N round
    trips of an ``nbytes`` float32 buffer, a copy into pinned host memory
    and a copy back, as ``swap_out`` and ``swap_in_pages`` issue them (the
    swap tier pays both directions: out at preemption, back at
    re-admission)."""
    device = torch.device(device)
    n = max(1, nbytes // 4)
    buf = torch.zeros(n, dtype=torch.float32, device=device)
    host = torch.empty(n, dtype=torch.float32, pin_memory=device.type == "cuda")

    def round_trip():
        host.copy_(buf)
        buf.copy_(host.to(device=device))

    round_trip()                 # warm: the first copies set up the path
    return 2 * n * 4 / _best_seconds(round_trip, repeats, device)


@torch.no_grad()
def measure_decode_flops_s(model, params, *, max_seq: int, repeats: int = 3) -> float:
    """Effective decode throughput in FLOPs/s: a single-slot ``decode_step``
    on a fresh dense cache, warmed once, then the best of N, scored with
    the ~2 FLOPs a parameter a token that the auto policy's recompute
    estimate uses."""
    n_params = sum(t.numel() for t in leaves(params))
    cache = model.init_cache(1, max_seq)
    tok = torch.zeros(1, dtype=torch.int32, device=model.device)
    pos = torch.zeros(1, dtype=torch.int32, device=model.device)

    def step():
        model.decode_step(params, cache, tok, pos)

    step()                       # warm: allocator, cuBLAS handles
    return 2.0 * n_params / _best_seconds(step, repeats, model.device)


def calibrate(model, params, *, max_seq: int, repeats: int = 3) -> CostModel:
    """Measure both halves of the preemption cost comparison on the
    model's device and return a ``source="measured"`` model.  A few small
    copies and a few decode steps; nothing of the engine is touched."""
    return CostModel(
        swap_gbps=measure_swap_bandwidth(repeats=repeats, device=model.device),
        decode_flops_s=measure_decode_flops_s(model, params, max_seq=max_seq,
                                              repeats=repeats),
        source="measured")
