"""Flash-attention wrappers: the CUDA kernels (``flash_attention.cu``,
``flash_attention_bwd.cu``) on CUDA tensors, the plain versions
(``ref.py``) on CPU tensors.  Counterparts of
``repro.kernels.flash_attention``'s ``flash_attention_fwd`` and
``flash_attention_bwd`` behind ``ops.flash_mha``, in the model layout,
with the GQA head grouping done by the kernels instead of a K/V repeat.
:class:`FlashAttention` is ``flash_mha``'s ``custom_vjp``: the forward
kernel, then the backward kernel on the saved lse.

Each kernel has two branches, chosen by dtype in one C entry point: bf16
runs the tensor-core kernels (mma.sync, cp.async; they need 16-byte
aligned bases and B/S/H strides in multiples of 8 elements, and raise
otherwise), f32 the CUDA-core kernels.  The bf16 backward writes dk/dv
per query head; the wrapper sums each KV head's group.  Each wrapper
counts the branches apart: ``.launches`` the bf16 (tensor-core) kernels,
``.launches_f32`` the f32 ones."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref,
    flash_attention_ref,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_ARGS = ([build.P] * 6 + [build.I64] * 9 + [build.I] * 7
         + [build.F, build.I, build.P])
_BWD_ARGS = ([build.P] * 10 + [build.I64] * 12 + [build.I] * 7
             + [build.F, build.I, build.P])


def _check_shapes(q, k, v, causal: bool):
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if causal and sq != skv:
        raise ValueError(f"causal flash requires sq == skv, got {sq}/{skv}")
    if hq % hkv or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not form a GQA call")


def _check_kernel_args(tensors, d: int):
    """What the kernels take: f32/bf16 of one dtype, D in _HEAD_DIMS, a
    contiguous head dim, one device.  Raises on anything else."""
    dt, dev = tensors[0].dtype, tensors[0].device
    if dt not in _DTYPES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"flash kernels take f32/bf16 inputs of one dtype; "
                        f"got {[t.dtype for t in tensors]}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernels are built for head dims {_HEAD_DIMS}; got {d}")
    if any(t.stride(-1) != 1 or t.device != dev for t in tensors):
        raise ValueError("inputs must share a device and have a contiguous "
                         "head dim")
    # the bf16 kernels stage rows with 16-byte copies
    if dt == torch.bfloat16 and any(
            t.data_ptr() % 16
            or any(st % 8 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)
            for t in tensors):
        raise ValueError("bf16 flash kernels need 16-byte aligned inputs "
                         "whose B, S and H strides are multiples of 8")


def _kv_len(kv_len: Optional[torch.Tensor], b: int, skv: int, device):
    if kv_len is None:
        return torch.full((b,), skv, dtype=torch.int32, device=device)
    return kv_len.to(device=device, dtype=torch.int32).contiguous()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[torch.Tensor] = None, *,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D), Hq % Hkv == 0; kv_len (B,)
    int32 (keys at positions >= kv_len[b] are masked).  Causal attention
    must be square.  Returns (o (B, Sq, Hq, D), lse (B, Hq, Sq) f32)."""
    _check_shapes(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kv_len, causal=causal)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _check_kernel_args((q, k, v), d)
    kv_len = _kv_len(kv_len, b, skv, q.device)
    o = torch.empty(b, sq, hq, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    build.launch("repro_flash_attention_fwd", _ARGS, q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 o.data_ptr(), lse.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 b, sq, skv, hq, hkv, d, int(causal), d ** -0.5,
                 _DTYPES[q.dtype])
    if q.dtype == torch.bfloat16:
        flash_attention_fwd.launches += 1
    else:
        flash_attention_fwd.launches_f32 += 1
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_f32 = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                        kv_len: Optional[torch.Tensor] = None, *,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, do (B, Sq, Hq, D); k/v (B, Skv, Hkv, D); lse, delta (B, Hq, Sq)
    f32, delta = rowsum(dO * O); kv_len (B,) int32.  Returns (dq (B, Sq,
    Hq, D), dk, dv (B, Skv, Hkv, D)) in f32, dk/dv summed over each KV
    head's group of query heads."""
    _check_shapes(q, k, v, causal)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if do.shape != q.shape or lse.shape != (b, hq, sq) or delta.shape != lse.shape:
        raise ValueError(f"do {tuple(do.shape)}, lse {tuple(lse.shape)} and "
                         f"delta {tuple(delta.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, do, lse, delta, kv_len,
                                       causal=causal)
    _check_kernel_args((q, k, v, do), d)
    if any(t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device
           for t in (lse, delta)):
        raise ValueError("lse and delta must be contiguous float32 on the "
                         "device of q")
    kv_len = _kv_len(kv_len, b, skv, q.device)
    dq = torch.empty(b, sq, hq, d, dtype=torch.float32, device=q.device)
    # the bf16 kernel writes dk/dv per query head (B, Skv, Hq, D)
    h_out = hq if q.dtype == torch.bfloat16 else hkv
    dk = torch.empty(b, skv, h_out, d, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    build.launch("repro_flash_attention_bwd", _BWD_ARGS, q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), kv_len.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *do.stride()[:3], b, sq, skv, hq, hkv, d, int(causal),
                 d ** -0.5, _DTYPES[q.dtype])
    if q.dtype == torch.bfloat16:
        flash_attention_bwd.launches += 1
    else:
        flash_attention_bwd.launches_f32 += 1
    if h_out != hkv:    # the group sum, in a fixed order
        g = hq // hkv
        dk = dk.view(b, skv, hkv, g, d).sum(3)
        dv = dv.view(b, skv, hkv, g, d).sum(3)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_f32 = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the reference's ``_flash``
    custom_vjp, ``ops.py:24-51``).  Forward: the forward kernel, saving
    q, k, v, o and lse.  Backward: delta = rowsum(dO * O) in plain torch,
    then the backward kernel; dq/dk/dv cast to the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal):
        o, lse = flash_attention_fwd(q, k, v, kv_len, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kv_len, ctx.causal = kv_len, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, delta, ctx.kv_len,
                                         causal=ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_len: Optional[torch.Tensor] = None, *,
              causal: bool = True) -> torch.Tensor:
    """q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D) -> o (B, Sq, Hq, D),
    differentiable in q, k, v (the reference's ``flash_mha``)."""
    return FlashAttention.apply(q, k, v, kv_len, causal)
