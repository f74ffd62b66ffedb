"""Hand-written Hopper kernels, one directory per reference Pallas kernel.

Each directory keeps the reference's split: ``<name>.cu`` (the CUDA
kernel), ``ops.py`` (the wrapper: kernel on a CUDA tensor, plain version
on a CPU tensor, never a fallback) and ``ref.py`` (the plain PyTorch
version).  ``build.py`` compiles every ``.cu`` into one library at first
use.  Each wrapper counts its kernel launches in ``<wrapper>.launches``
(the two paged attention wrappers count their int8 branch apart, in
``.launches_int8``, the two flash wrappers their f32 branch, in
``.launches_f32``, and rmsnorm its block-per-row ragged branch, in
``.launches_ragged``); :func:`launch_counts` / :func:`reset_launches` read
and clear them all.
"""

from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.kernels.decode_attention.ops import flash_decode, paged_flash_decode
from repro_torch.kernels.flash_attention.ops import (
    flash_attention_bwd,
    flash_attention_fwd,
)
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.moe_gating.ops import moe_gating
from repro_torch.kernels.mse.ops import mse_partial_sum
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.tile_reduce.ops import tile_reduce
from repro_torch.kernels.verify_attention.ops import paged_flash_verify
from repro_torch.kernels.warp_ops.ops import shfl, vote

WRAPPERS = {
    # the serving path
    "rmsnorm": rmsnorm,
    "flash_attention_fwd": flash_attention_fwd,
    "flash_decode": flash_decode,
    "paged_flash_decode": paged_flash_decode,
    "paged_flash_verify": paged_flash_verify,
    "moe_gating": moe_gating,
    # the training path
    "flash_attention_bwd": flash_attention_bwd,
    # the paper's warp-feature layer (Fig. 5)
    "shfl": shfl,
    "vote": vote,
    "tile_reduce": tile_reduce,
    "mse_partial_sum": mse_partial_sum,
    "matmul": matmul,
}


# every launch counter: (wrapper, attribute) by the name the counts use
COUNTERS: Dict[str, Tuple[object, str]] = {
    **{name: (fn, "launches") for name, fn in WRAPPERS.items()},
    "paged_flash_decode[int8]": (paged_flash_decode, "launches_int8"),
    "paged_flash_verify[int8]": (paged_flash_verify, "launches_int8"),
    "flash_attention_fwd[f32]": (flash_attention_fwd, "launches_f32"),
    "flash_attention_bwd[f32]": (flash_attention_bwd, "launches_f32"),
    "rmsnorm[ragged]": (rmsnorm, "launches_ragged"),
}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def reset_launches():
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
