"""Build the port's CUDA kernels into one shared library and load it.

Every ``kernels/**/*.cu`` source is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a``, then linked into one shared
library with a plain C interface, loaded with ``ctypes``.  No PyTorch
headers are involved, so a cold build takes seconds.  The library lands
in ``build/torch_kernels/`` at the repository root (git-ignored) under a
name keyed by the sources' hash, so an edited source never loads a stale
build.  Nothing is built at import time: the first kernel launch builds.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception naming the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; carries the compiler output."""


def sources() -> List[Path]:
    return sorted(KERNEL_DIR.rglob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise KernelBuildError(
        f"nvcc not found on PATH or at {cand}: the CUDA kernels cannot be "
        "built, and a CUDA tensor never falls back to the plain PyTorch "
        "version")


def _digest(srcs: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(KERNEL_DIR.rglob("*.cuh")):
        h.update(str(s.relative_to(KERNEL_DIR)).encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the shared library's path."""
    srcs = sources()
    lib = BUILD_DIR / f"libreprotorch_{_digest(srcs)}.so"
    if lib.is_file():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(KERNEL_DIR), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(str(obj))
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"--- {src.name} (exit {p.returncode})\n{out}")
        if failed:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run([nvcc, "-shared", *objs, "-o", str(tmp_lib)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)   # atomic: a concurrent loader sees all or nothing
    return lib


class _Library:
    """The loaded library and its C entry points, ``argtypes`` declared
    once per entry point."""

    def __init__(self):
        self._lib: Optional[ctypes.CDLL] = None
        self._fns: Dict[str, ctypes._CFuncPtr] = {}

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self._lib = ctypes.CDLL(str(build()))
            self._lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            self._lib.repro_cuda_error_string.restype = ctypes.c_char_p
        return self._lib

    def fn(self, name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
        f = self._fns.get(name)
        if f is None:
            f = getattr(self.load(), name)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            self._fns[name] = f
        return f

    def check(self, name: str, code: int):
        if code != 0:
            msg = self.load().repro_cuda_error_string(code).decode()
            raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                               f"error {code} ({msg})")


LIB = _Library()

# ctypes signatures: every pointer and the stream as c_void_p (a bare
# Python int would be passed as a 32-bit int and cut the pointer)
P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_int64
F = ctypes.c_float


def launch(name: str, argtypes: Sequence, device, *args):
    """Call C entry point ``name`` with ``args`` followed by ``device``'s
    current stream, and raise if its launch failed.  The library is built
    (or found) before anything touches the device."""
    import torch

    fn = LIB.fn(name, argtypes)
    LIB.check(name, fn(*args, torch.cuda.current_stream(device).cuda_stream))
