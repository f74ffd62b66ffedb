"""Flash-attention forward wrapper: the CUDA kernel
(``flash_attention.cu``) on CUDA tensors, the plain version (``ref.py``)
on CPU tensors.  Counterpart of ``repro.kernels.flash_attention``'s
``flash_attention_fwd`` behind ``ops.flash_mha`` — in the model layout,
with the GQA head grouping done by the kernel instead of a K/V repeat."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_ARGS = ([build.P] * 6 + [build.I64] * 9 + [build.I] * 7
         + [build.F, build.I, build.P])


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[torch.Tensor] = None, *,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D), Hq % Hkv == 0; kv_len (B,)
    int32 (keys at positions >= kv_len[b] are masked).  Causal attention
    must be square.  Returns (o (B, Sq, Hq, D), lse (B, Hq, Sq) f32)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if causal and sq != skv:
        raise ValueError(f"causal flash requires sq == skv, got {sq}/{skv}")
    if hq % hkv or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not form a GQA call")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kv_len, causal=causal)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes f32/bf16 q, k, v of one dtype; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head dims {_HEAD_DIMS}; got {d}")
    if any(t.stride(-1) != 1 or t.device != q.device for t in (q, k, v)):
        raise ValueError("q, k, v must share a device and have a contiguous "
                         "head dim")
    if kv_len is None:
        kv_len = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    else:
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty(b, sq, hq, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    build.launch("repro_flash_attention_fwd", _ARGS, q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 o.data_ptr(), lse.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 b, sq, skv, hq, hkv, d, int(causal), d ** -0.5,
                 _DTYPES[q.dtype])
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
