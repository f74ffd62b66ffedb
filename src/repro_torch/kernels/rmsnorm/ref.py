"""Plain PyTorch RMSNorm: the CPU path and the kernel's oracle."""

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)
