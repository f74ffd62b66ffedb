"""Verify-attention wrapper: the CUDA kernel (``verify_attention.cu``) on
CUDA tensors, the plain version (``ref.py``) on CPU tensors.  Counterpart
of ``repro.kernels.verify_attention.verify_attention.paged_flash_verify``,
with the same layouts, int8 pages with f32 row scales included (counted
apart in ``paged_flash_verify.launches_int8``)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ops import _check, check_scales
from repro_torch.kernels.verify_attention.ref import (
    _group,
    paged_verify_attention_ref,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 32   # T * G query rows per KV head, one warp each
_ARGS = ([build.P] * 6 + [build.I64] * 7 + [build.I] * 7
         + [build.F, build.I, build.P])
_INT8_ARGS = ([build.P] * 8 + [build.I64] * 11 + [build.I] * 7
              + [build.F, build.I, build.P])


def paged_flash_verify(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       pos: torch.Tensor, *, t_window: int,
                       k_scales: Optional[torch.Tensor] = None,
                       v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Hkv, T*G, D), T window rows x G grouped queries, t-major;
    pages (P, page_size, Hkv, D); block_tables (B, NB) int32 (page 0 is
    the trash page); pos (B,) the window's first position, whose K/V rows
    pos..pos+T-1 are written before the call.  Row t*G+g attends keys
    <= pos + t.  Returns (B, Hkv, T*G, D).  ``k_scales``/``v_scales``
    ((P, page_size) float32, both or neither) mark int8 pages, dequantized
    inside the kernel's gather."""
    quantized = check_scales(k_scales, v_scales, k_pages, "paged_flash_verify")
    if q.device.type == "cpu":
        return paged_verify_attention_ref(q, k_pages, v_pages, block_tables,
                                          pos, t_window, k_scales=k_scales,
                                          v_scales=v_scales)
    b, hkv, rows, d = q.shape
    _group(rows, t_window)
    q, pos = _check(q, k_pages, v_pages, pos, "paged_flash_verify (one warp "
                    "per query row T*G)", max_group=MAX_ROWS, quantized=quantized)
    if (block_tables.device != q.device or block_tables.dim() != 2
            or block_tables.shape[0] != b):
        raise ValueError("block_tables must be (B, NB) on the device of q")
    bt = block_tables.to(torch.int32)
    if bt.stride(-1) != 1:
        bt = bt.contiguous()
    o = torch.empty_like(q)
    shape = (b, bt.shape[1], k_pages.shape[1], hkv, rows, t_window, d,
             d ** -0.5, _DTYPES[q.dtype])
    if quantized:
        build.launch("repro_paged_flash_verify_int8", _INT8_ARGS, q.device,
                     q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     k_scales.data_ptr(), v_scales.data_ptr(), bt.data_ptr(),
                     pos.data_ptr(), o.data_ptr(), *k_pages.stride()[:3],
                     *v_pages.stride()[:3], *k_scales.stride(), *v_scales.stride(),
                     bt.stride(0), *shape)
        paged_flash_verify.launches_int8 += 1
        return o
    build.launch("repro_paged_flash_verify", _ARGS, q.device,
                 q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 bt.data_ptr(), pos.data_ptr(), o.data_ptr(),
                 *k_pages.stride()[:3], *v_pages.stride()[:3], bt.stride(0), *shape)
    paged_flash_verify.launches += 1
    return o


paged_flash_verify.launches = 0
paged_flash_verify.launches_int8 = 0
