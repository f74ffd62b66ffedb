"""Verify-attention wrapper: the CUDA kernels (``verify_attention.cu``) on
CUDA tensors, the plain version (``ref.py``) on CPU tensors.  Counterpart
of ``repro.kernels.verify_attention.verify_attention.paged_flash_verify``,
with the same layouts, int8 pages with f32 row scales included (counted
apart in ``paged_flash_verify.launches_int8``).

A window of T * G <= 32 query rows a KV head (``MAX_ROWS``; speculative
windows) launches decode's split kernel over the window's rows and its
combine pass (``decode_attention/split.cuh``), and counts as one launch;
the split count comes from the shapes alone (:func:`verify_splits`).  A
longer window (a shared prefix's suffix prefill: 16-token buckets at G =
6 are 96 rows and up) launches the long-window branch: tensor-core tiles
under bf16 q (bf16 and int8 pages), CUDA cores under f32 q
(``verify_attention.cu``), the key axis split across blocks
(:func:`verify_long_splits`) and the partials reduced by decode's combine
pass, counted apart in ``paged_flash_verify.launches_long`` and
``.launches_long_int8``, one a call.  There is no fallback between the
branches: a failed build or launch raises."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ops import (
    _TAIL,
    SPLIT_BLOCKS,
    TILE_KEYS,
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
MAX_ROWS = 32   # T * G query rows a KV head the split kernel takes
_ARGS = [build.P] * 6 + [build.I64] * 7 + [build.I] * 7 + _TAIL
_INT8_ARGS = [build.P] * 8 + [build.I64] * 11 + [build.I] * 7 + _TAIL
# the long-window branch's kernels: query rows a block, keys a tile, and
# the grid's target in blocks (those an SM holds at once x 132 SMs): the
# tensor-core tile (bf16 q; 87 KB of shared memory, two an SM) and the
# CUDA-core kernel (f32 q; 41 KB and 95 registers a thread, five an SM)
LONG_TC_ROWS, LONG_CORE_ROWS = 64, 16
_LONG_KERNELS = {LONG_TC_ROWS: (SPLIT_BLOCKS, 64), LONG_CORE_ROWS: (5 * 132, TILE_KEYS)}
MAX_SPLITS = 264   # split.cuh's kMaxSplits


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


def long_rows_per_block(dtype: torch.dtype) -> int:
    """Query rows a block of the long-window branch takes: the tensor-core
    tile's 64 under bf16 q, the CUDA-core kernel's 16 under f32 q."""
    return LONG_TC_ROWS if dtype == torch.bfloat16 else LONG_CORE_ROWS


def verify_long_splits(b: int, hkv: int, rows: int, n_keys_max: int,
                       rows_per_block: int) -> int:
    """Splits of the key axis for the long-window branch, the counterpart
    of :func:`verify_splits`: the B * Hkv * ceil(rows / rows_per_block)
    row blocks count toward the kernel's grid target (two tensor-core
    blocks an SM, five CUDA-core ones), capped at one of its key tiles a
    split of ``n_keys_max`` (64 keys, 32) and at MAX_SPLITS; 1 where the
    row blocks alone fill the target.  The rule comes from a sweep of
    forced counts on an H100 (``bench/kernel_ab.py``'s ``verify_long``
    group, in PERF.md): at the smoke's suffix prefill (B 1, Hkv 2, G 6,
    576 keys) it gives the tensor-core tile 9, 9, 6 and 3 splits at T 16,
    64, 256 and 512, and the CUDA-core kernel 18, 14, 4 and 2."""
    target, tile_keys = _LONG_KERNELS[rows_per_block]
    want = -(-target // (b * hkv * -(-rows // rows_per_block)))
    return max(1, min(want, -(-n_keys_max // tile_keys), MAX_SPLITS))


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
    long_window = rows > MAX_ROWS
    q, pos = _check(q, k_pages, v_pages, pos, "paged_flash_verify",
                    max_group=rows if long_window else MAX_ROWS, quantized=quantized)
    _check_rows(k_pages, v_pages, "paged_flash_verify")
    if (block_tables.device != q.device or block_tables.dim() != 2
            or block_tables.shape[0] != b):
        raise ValueError("block_tables must be (B, NB) on the device of q")
    bt = block_tables.to(torch.int32)
    if bt.stride(-1) != 1:
        bt = bt.contiguous()
    if long_window:
        return _verify_long(q, k_pages, v_pages, bt, pos, t_window, k_scales, v_scales)
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


def _verify_long(q, k_pages, v_pages, bt, pos, t_window, k_scales, v_scales):
    """The long-window branch (T * G > MAX_ROWS): the split kernel and, at
    more than one split, the combine pass, one launch counted a call; the
    operands are checked by :func:`paged_flash_verify`."""
    b, hkv, rows, d = q.shape
    if q.data_ptr() % 16:          # the tensor-core tile copies 16-byte rows
        q = q.clone()
    o = torch.empty_like(q)
    splits = verify_long_splits(b, hkv, rows, bt.shape[1] * k_pages.shape[1],
                                long_rows_per_block(q.dtype))
    work = _work(q, splits) if splits > 1 else None   # one split: no partials
    shape = (b, bt.shape[1], k_pages.shape[1], hkv, rows, t_window, d, d ** -0.5,
             _DTYPES[q.dtype], None if work is None else work.data_ptr(), splits)
    if k_scales is not None:
        build.launch("repro_paged_flash_verify_long_int8", _INT8_ARGS, q.device,
                     q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     k_scales.data_ptr(), v_scales.data_ptr(), bt.data_ptr(),
                     pos.data_ptr(), o.data_ptr(), *k_pages.stride()[:3],
                     *v_pages.stride()[:3], *k_scales.stride(), *v_scales.stride(),
                     bt.stride(0), *shape)
        paged_flash_verify.launches_long_int8 += 1
        return o
    build.launch("repro_paged_flash_verify_long", _ARGS, q.device,
                 q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), bt.data_ptr(),
                 pos.data_ptr(), o.data_ptr(), *k_pages.stride()[:3],
                 *v_pages.stride()[:3], bt.stride(0), *shape)
    paged_flash_verify.launches_long += 1
    return o


paged_flash_verify.launches = 0
paged_flash_verify.launches_int8 = 0
paged_flash_verify.launches_long = 0
paged_flash_verify.launches_long_int8 = 0
