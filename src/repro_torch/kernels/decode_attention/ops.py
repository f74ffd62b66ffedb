"""Decode-attention wrappers, dense and paged: the CUDA kernels
(``decode_attention.cu``) on CUDA tensors, the plain versions
(``ref.py``) on CPU tensors.  Counterparts of
``repro.kernels.decode_attention.decode_attention``'s ``flash_decode``
and ``paged_flash_decode``, with the same layouts.  The paged wrapper
takes int8 pages with their f32 row scales too, and counts those
launches apart (``paged_flash_decode.launches_int8``)."""

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
_DENSE_ARGS = ([build.P] * 5 + [build.I64] * 6 + [build.I] * 5
               + [build.F, build.I, build.P])
_PAGED_ARGS = ([build.P] * 6 + [build.I64] * 7 + [build.I] * 6
               + [build.F, build.I, build.P])
_PAGED_INT8_ARGS = ([build.P] * 8 + [build.I64] * 11 + [build.I] * 6
                    + [build.F, build.I, build.P])


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


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """q (B, Hkv, G, D); k/v (B, S, Hkv, D), any batch/seq/head strides
    (a ``[:, :attend_len]`` view of the cache is read in place); pos (B,)
    int32 with keys <= pos[b] live.  Returns (B, Hkv, G, D)."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, pos)
    q, pos = _check(q, k, v, pos, "flash_decode")
    b, hkv, g, d = q.shape
    o = torch.empty_like(q)
    build.launch("repro_flash_decode", _DENSE_ARGS, q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                 o.data_ptr(), *k.stride()[:3], *v.stride()[:3],
                 b, k.shape[1], hkv, g, d, d ** -0.5, _DTYPES[q.dtype])
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
    if (block_tables.device != q.device or block_tables.dim() != 2
            or block_tables.shape[0] != q.shape[0]):
        raise ValueError("block_tables must be (B, NB) on the device of q")
    bt = block_tables.to(torch.int32)
    if bt.stride(-1) != 1:
        bt = bt.contiguous()
    b, hkv, g, d = q.shape
    o = torch.empty_like(q)
    shape = (b, bt.shape[1], k_pages.shape[1], hkv, g, d, d ** -0.5, _DTYPES[q.dtype])
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
