"""Shared layers: RMSNorm (a kernel and warp-feature site), RoPE, SwiGLU,
initializers.

Counterpart of ``repro.models.layers`` for the dense family.  RMSNorm is
the paper technique's site in the model: its row reduction is a warp/tile
reduction.  ``WarpFeatureConfig.reduction_backend`` picks how it runs:
  - None / 'kernel': the CUDA rmsnorm kernel (its wrapper runs the plain
    version on CPU tensors); the reference's None / 'pallas';
  - 'hw':      the plain vectorised form (``rmsnorm_ref``), kept as the
    reference's spelling; it is an alias of ``use_kernel=False``;
  - 'hw_warp': explicit warp_size-lane groups reduced by the HW
    primitives (``core.hw_backend``), the vx_* instruction form;
  - 'sw':      the same groups reduced by the PR-transformation form
    (``core.sw_backend``: a loop over lanes and memory arrays).
``use_kernel=False`` calls the plain version whatever the config (the
reference path a chip run compares the kernel path with).  Every form is
differentiable: the kernel through ``rmsnorm.ops.RMSNorm`` (the
reference's closed-form backward), the rest through autograd.  Weights
are cast to the activations' dtype at use (fp32 master weights under
bf16 compute), except the norm weight, which every form multiplies in
fp32, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import primitives as P
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

REDUCTION_BACKENDS = (None, "kernel", "hw", "hw_warp", "sw")


@dataclasses.dataclass(frozen=True)
class WarpFeatureConfig:
    """Deployment knob: the paper's HW-vs-SW choice for the norm reductions.

    reduction_backend: one of ``REDUCTION_BACKENDS`` (None = 'kernel').
    warp_size: lanes per group in the 'hw_warp' and 'sw' forms.
    """

    reduction_backend: Optional[str] = None
    warp_size: int = 128

    def __post_init__(self):
        if self.reduction_backend not in REDUCTION_BACKENDS:
            raise ValueError(f"reduction_backend must be one of {REDUCTION_BACKENDS}; "
                             f"got {self.reduction_backend!r}")


DEFAULT_WF = WarpFeatureConfig()


def _rmsnorm_warp(x: torch.Tensor, w: torch.Tensor, eps: float, backend: str,
                  warp_size: int) -> torch.Tensor:
    """RMSNorm through explicit warp-group reductions (HW or SW primitive
    path): the row of width d is d / warp_size lane groups, each reduced
    by the primitive, and the group partials are then added (the
    cross-warp shared-memory step of the reduce benchmark)."""
    d = x.shape[-1]
    xf = x.float()
    sq = xf * xf
    if d % warp_size == 0 and d >= warp_size:
        g = sq.reshape(x.shape[:-1] + (d // warp_size, warp_size))
        partial = P.warp_reduce(g, "sum", backend=backend)[..., 0]  # (.., n_warps)
        ms = partial.sum(-1, keepdim=True) / d
    else:
        ms = sq.mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            use_kernel: bool = True, wf: WarpFeatureConfig = DEFAULT_WF) -> torch.Tensor:
    backend = wf.reduction_backend
    if not use_kernel or backend == "hw":
        return rmsnorm_ref(x, w, eps)
    if backend == "sw":
        return _rmsnorm_warp(x, w, eps, "sw", wf.warp_size)
    if backend == "hw_warp":
        return _rmsnorm_warp(x, w, eps, "hw", wf.warp_size)
    return rmsnorm_op(x, w, eps)


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
    dt = x.dtype
    return (F.silu(x @ w_gate.to(dt)) * (x @ w_up.to(dt))) @ w_down.to(dt)
