"""Hand-written Hopper kernels, one directory per reference Pallas kernel.

Each directory keeps the reference's split: ``<name>.cu`` (the CUDA
kernel), ``ops.py`` (the wrapper: kernel on a CUDA tensor, plain version
on a CPU tensor, never a fallback) and ``ref.py`` (the plain PyTorch
version).  ``build.py`` compiles every ``.cu`` into one library at first
use.  Each wrapper counts its kernel launches in ``<wrapper>.launches``;
:func:`launch_counts` / :func:`reset_launches` read and clear them all.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels.decode_attention.ops import flash_decode, paged_flash_decode
from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.mse.ops import mse_partial_sum
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.tile_reduce.ops import tile_reduce
from repro_torch.kernels.warp_ops.ops import shfl, vote

WRAPPERS = {
    # the serving path
    "rmsnorm": rmsnorm,
    "flash_attention_fwd": flash_attention_fwd,
    "flash_decode": flash_decode,
    "paged_flash_decode": paged_flash_decode,
    # the paper's warp-feature layer (Fig. 5)
    "shfl": shfl,
    "vote": vote,
    "tile_reduce": tile_reduce,
    "mse_partial_sum": mse_partial_sum,
    "matmul": matmul,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launches():
    for fn in WRAPPERS.values():
        fn.launches = 0
