"""Verify-attention wrapper: the CUDA kernels (``verify_attention.cu``) on
CUDA tensors, the plain version (``ref.py``) on CPU tensors.  Counterpart
of ``repro.kernels.verify_attention.verify_attention.paged_flash_verify``,
with the same layouts, int8 pages with f32 row scales included (counted
apart in ``paged_flash_verify.launches_int8``).

A call launches decode's split kernel over the window's rows and its
combine pass (``decode_attention/split.cuh``), and counts as one launch.
The split count comes from the shapes alone (:func:`verify_splits`)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ops import (
    _TAIL,
    _check,
    _check_rows,
    _work,
    check_scales,
    decode_splits,
)
from repro_torch.kernels.verify_attention.ref import (
    _group,
    paged_verify_attention_ref,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 32   # T * G query rows a KV head
_ARGS = [build.P] * 6 + [build.I64] * 7 + [build.I] * 7 + _TAIL
_INT8_ARGS = [build.P] * 8 + [build.I64] * 11 + [build.I] * 7 + _TAIL


def row_blocks(rows: int) -> int:
    """Register blocks of the split kernel for ``rows`` query rows a KV
    head: GR = 1, 4 or 6 rows a block (``split.cuh``'s ``by_rows``)."""
    gr = 1 if rows == 1 else 4 if rows <= 4 else 6
    return -(-rows // gr)


def verify_splits(b: int, hkv: int, rows: int, t_window: int, n_keys_max: int) -> int:
    """Splits of the KV axis for a window of ``t_window`` positions and
    ``rows`` = T * G query rows a KV head.  A window of one is decode, and
    takes paged decode's count (:func:`decode_splits`), so the two run the
    same arithmetic.  A longer window counts its row blocks in the grid's
    target of two blocks an SM: at qwen2's B 4, Hkv 2, T * G = 24 and 576
    keys that is 9 splits (288 blocks, a wave) where decode's count gives
    18 one-tile splits (576 blocks, 2.2 waves); the 9 ran 13 % faster on
    an H100 (``bench/kernel_ab.py``'s ``verify_*_decode_splits`` cases)."""
    if t_window == 1:
        return decode_splits(b, hkv, n_keys_max)
    return decode_splits(b * row_blocks(rows), hkv, n_keys_max)


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
    q, pos = _check(q, k_pages, v_pages, pos, "paged_flash_verify",
                    max_group=MAX_ROWS, quantized=quantized)
    _check_rows(k_pages, v_pages, "paged_flash_verify")
    if (block_tables.device != q.device or block_tables.dim() != 2
            or block_tables.shape[0] != b):
        raise ValueError("block_tables must be (B, NB) on the device of q")
    bt = block_tables.to(torch.int32)
    if bt.stride(-1) != 1:
        bt = bt.contiguous()
    o = torch.empty_like(q)
    splits = verify_splits(b, hkv, rows, t_window, bt.shape[1] * k_pages.shape[1])
    work = _work(q, splits)
    shape = (b, bt.shape[1], k_pages.shape[1], hkv, rows, t_window, d,
             d ** -0.5, _DTYPES[q.dtype], work.data_ptr(), splits)
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
