"""Decode-attention wrappers, dense and paged: the CUDA kernels
(``decode_attention.cu``) on CUDA tensors, the plain versions
(``ref.py``) on CPU tensors.  Counterparts of
``repro.kernels.decode_attention.decode_attention``'s ``flash_decode``
and ``paged_flash_decode``, with the same layouts.  The paged wrapper
takes int8 pages with their f32 row scales too, and counts those
launches apart (``paged_flash_decode.launches_int8``).

Each call launches two kernels, the split kernel over a (B * Hkv,
splits) grid and the combine pass; it counts as one launch.  The split
count comes from the shapes alone (:func:`decode_splits`), never from
``pos`` (which lives on the card), and the keys a split takes from the
row's own live length (:func:`split_keys`, mirrored in the kernel)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (
    flash_decode_ref,
    paged_flash_decode_ref,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 16
# ... scale, dtype, work (the partials' scratch), splits, stream
_TAIL = [build.F, build.I, build.P, build.I, build.P]
_DENSE_ARGS = [build.P] * 5 + [build.I64] * 6 + [build.I] * 5 + _TAIL
_PAGED_ARGS = [build.P] * 6 + [build.I64] * 7 + [build.I] * 6 + _TAIL
_PAGED_INT8_ARGS = [build.P] * 8 + [build.I64] * 11 + [build.I] * 6 + _TAIL
# the split kernel's grid: two blocks for each of the H100's 132 SMs,
# where the keys allow it; a split takes a multiple of one 32-key tile
SPLIT_BLOCKS = 264
TILE_KEYS = 32


def decode_splits(b: int, hkv: int, n_keys_max: int) -> int:
    """Splits of the KV axis, the split kernel's grid height: enough for
    B * Hkv * splits >= SPLIT_BLOCKS, but no more than 32-key tiles in
    ``n_keys_max`` (the dense view's S, or NB * page_size), and at least
    one."""
    want = -(-SPLIT_BLOCKS // max(1, b * hkv))
    return max(1, min(want, -(-n_keys_max // TILE_KEYS)))


def split_keys(n_keys: int, splits: int) -> int:
    """Keys a split takes of a row with ``n_keys`` live keys
    (min(pos + 1, n_keys_max)): the least multiple of 32 that covers them
    in ``splits`` pieces.  It reads neither the layout nor n_keys_max
    beyond ``splits``: where ``decode_splits`` caps the count at the
    table's tiles, every row's split is one tile whatever the cap, so a
    row's sums depend only on its own length and B * Hkv."""
    per = -(-n_keys // splits)
    return max(TILE_KEYS, -(-per // TILE_KEYS) * TILE_KEYS)


def check_scales(k_scales, v_scales, k_pages, name):
    """Both row-scale operands or neither; True when both are given.  With
    both, each scale must be (P, page_size) f32 on the pages' device (the
    kernel route then also demands int8 pages, in ``_check``)."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales or neither")
    if k_scales is None:
        return False
    for s in (k_scales, v_scales):
        if (s.dtype != torch.float32 or tuple(s.shape) != tuple(k_pages.shape[:2])
                or s.device != k_pages.device):
            raise ValueError(f"{name}: row scales must be (P, page_size) = "
                             f"{tuple(k_pages.shape[:2])} float32 on "
                             f"{k_pages.device}; got {tuple(s.shape)} {s.dtype} "
                             f"on {s.device}")
    return True


def _check(q, k, v, pos, name, max_group=_MAX_GROUP, quantized=False):
    b, hkv, g, d = q.shape
    cache = torch.int8 if quantized else q.dtype
    if q.dtype not in _DTYPES or k.dtype != cache or v.dtype != cache:
        raise TypeError(f"{name} takes f32/bf16 q and a cache of q's dtype, or "
                        f"int8 pages with row scales; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS or g > max_group:
        raise ValueError(f"{name} is built for head dims {_HEAD_DIMS} and "
                         f"query rows <= {max_group}; got D={d}, rows={g}")
    if k.shape[2] != hkv or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match cache "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if (any(t.device != q.device for t in (k, v, pos))
            or k.stride(-1) != 1 or v.stride(-1) != 1):
        raise ValueError(f"{name}: tensors must share a device and the cache "
                         "head dim must be contiguous")
    if pos.shape != (b,):
        raise ValueError(f"{name}: pos must be ({b},); got {tuple(pos.shape)}")
    return q.contiguous(), pos.to(torch.int32).contiguous()


def _check_rows(k, v, name):
    """The decode kernels copy whole cache rows in 16-byte pieces: each
    base and each batch/seq/head stride (of a dim longer than 1) must be
    a multiple of 16 bytes.  Every cache the models allocate is."""
    for t in (k, v):
        if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                    for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(f"{name}: the cache's base and its batch/seq/head "
                             f"strides must be 16-byte aligned; got strides "
                             f"{t.stride()} of {t.dtype}")


def _work(q: torch.Tensor, splits: int) -> torch.Tensor:
    """Scratch for the split kernel's partials: (m, l) and D sums for each
    (B * Hkv, split, G) row."""
    b, hkv, g, d = q.shape
    return torch.empty(b * hkv * splits * g * (d + 2), dtype=torch.float32,
                       device=q.device)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """q (B, Hkv, G, D); k/v (B, S, Hkv, D), any 16-byte batch/seq/head
    strides (a ``[:, :attend_len]`` view of the cache is read in place); pos (B,)
    int32 with keys <= pos[b] live.  Returns (B, Hkv, G, D)."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, pos)
    q, pos = _check(q, k, v, pos, "flash_decode")
    _check_rows(k, v, "flash_decode")
    b, hkv, g, d = q.shape
    o = torch.empty_like(q)
    splits = decode_splits(b, hkv, k.shape[1])
    work = _work(q, splits)
    build.launch("repro_flash_decode", _DENSE_ARGS, q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                 o.data_ptr(), *k.stride()[:3], *v.stride()[:3],
                 b, k.shape[1], hkv, g, d, d ** -0.5, _DTYPES[q.dtype],
                 work.data_ptr(), splits)
    flash_decode.launches += 1
    return o


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       pos: torch.Tensor, *,
                       k_scales: Optional[torch.Tensor] = None,
                       v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Hkv, G, D); pages (P, page_size, Hkv, D); block_tables (B, NB)
    int32, logical block j of row b in page block_tables[b, j] (page 0 is
    the trash page); pos (B,).  ``k_scales``/``v_scales`` ((P, page_size)
    float32, both or neither) mark int8 pages: each row is dequantized
    (value * its row's scale) inside the kernel's gather."""
    quantized = check_scales(k_scales, v_scales, k_pages, "paged_flash_decode")
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, k_pages, v_pages, block_tables, pos,
                                      k_scales=k_scales, v_scales=v_scales)
    q, pos = _check(q, k_pages, v_pages, pos, "paged_flash_decode",
                    quantized=quantized)
    _check_rows(k_pages, v_pages, "paged_flash_decode")
    if (block_tables.device != q.device or block_tables.dim() != 2
            or block_tables.shape[0] != q.shape[0]):
        raise ValueError("block_tables must be (B, NB) on the device of q")
    bt = block_tables.to(torch.int32)
    if bt.stride(-1) != 1:
        bt = bt.contiguous()
    b, hkv, g, d = q.shape
    o = torch.empty_like(q)
    splits = decode_splits(b, hkv, bt.shape[1] * k_pages.shape[1])
    work = _work(q, splits)
    shape = (b, bt.shape[1], k_pages.shape[1], hkv, g, d, d ** -0.5, _DTYPES[q.dtype],
             work.data_ptr(), splits)
    if quantized:
        build.launch("repro_paged_flash_decode_int8", _PAGED_INT8_ARGS, q.device,
                     q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     k_scales.data_ptr(), v_scales.data_ptr(), bt.data_ptr(),
                     pos.data_ptr(), o.data_ptr(), *k_pages.stride()[:3],
                     *v_pages.stride()[:3], *k_scales.stride(), *v_scales.stride(),
                     bt.stride(0), *shape)
        paged_flash_decode.launches_int8 += 1
        return o
    build.launch("repro_paged_flash_decode", _PAGED_ARGS, q.device,
                 q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 bt.data_ptr(), pos.data_ptr(), o.data_ptr(),
                 *k_pages.stride()[:3], *v_pages.stride()[:3], bt.stride(0), *shape)
    paged_flash_decode.launches += 1
    return o


flash_decode.launches = 0
paged_flash_decode.launches = 0
paged_flash_decode.launches_int8 = 0
