"""Plain PyTorch matmul with f32 accumulation: the CPU path and the CUDA
kernel's oracle (the reference's ``matmul_ref``).  On a CUDA tensor it
runs in full f32 only while ``torch.backends.cuda.matmul.allow_tf32`` is
False (PyTorch's default), which the callers that compare set."""

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)
