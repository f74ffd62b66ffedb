"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package mirrors its
module names (``models/``, ``serve/``, ``kernels/<name>/``) and layouts,
imports ``torch`` only, and replaces every Pallas TPU kernel on its path
with a CUDA C++ kernel written for ``sm_90a`` (``kernels/build.py`` builds
them with ``nvcc`` at first use).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CPU tensor each kernel wrapper runs its plain PyTorch version, which
is what the CPU tests hold against the JAX package.
"""
