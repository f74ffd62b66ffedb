"""Shared layers: RMSNorm (a kernel site), RoPE, SwiGLU, initializers.

Counterpart of ``repro.models.layers`` for the dense family.  ``rmsnorm``
routes to the CUDA kernel wrapper, which runs the plain version on CPU
tensors; ``use_kernel=False`` calls the plain version directly on any
device (the reference path a chip run compares the kernel path with).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            use_kernel: bool = True) -> torch.Tensor:
    return rmsnorm_kernel(x, w, eps) if use_kernel else rmsnorm_ref(x, w, eps)


# ---------------------------------------------------------------------------
# Initializers (same distributions as the reference; torch draws differ
# from jax.random, so parity tests carry weights over with the bridge)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, device,
               dtype) -> torch.Tensor:
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn(d_in, d_out, generator=gen, device=device) * scale
    return w.to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, *, device,
               dtype) -> torch.Tensor:
    return (torch.randn(vocab, d, generator=gen, device=device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RoPE (split-half layout)
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, positions: torch.Tensor):
    """positions (..., S) int -> cos/sin (..., S, d_head // 2) float32."""
    inv = 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                        device=positions.device) / d_head))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (B, S, H, D); cos/sin (B, S, D//2) or (S, D//2), cast to x.dtype
    before the multiply like the reference."""
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
