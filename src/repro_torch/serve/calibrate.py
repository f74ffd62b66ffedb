"""The cost model behind ``ServeEngine(preempt="auto")``.

Counterpart of the figures in ``repro.serve.calibrate`` (that module
imports JAX, so the port keeps its own copy).  ``preempt="auto"`` decides
between host swap and requeue-recompute by comparing transfer seconds per
resident token (pool bytes per token over ``swap_gbps``) against
recompute seconds per token (2 * parameters FLOPs over
``decode_flops_s``).  The defaults are the reference's planning figures,
so the port decides as the reference does.  Measuring them on the card
(the reference's ``measure_swap_bandwidth`` / ``measure_decode_flops_s``
and ``preempt_calibrate=True``) waits for open-loop serving (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses

# conservative planning figures for a host link and a mid-size accelerator
DEFAULT_SWAP_GBPS = 8e9           # bytes/s across the device<->host link
DEFAULT_DECODE_FLOPS_S = 5e10     # effective decode FLOPs/s


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Figures the ``preempt="auto"`` comparison runs on, plus where they
    came from (``"default"`` or anything a caller stamps on its own)."""
    swap_gbps: float
    decode_flops_s: float
    source: str = "default"


DEFAULT_COST_MODEL = CostModel(DEFAULT_SWAP_GBPS, DEFAULT_DECODE_FLOPS_S)
