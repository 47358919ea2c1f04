"""Build and load the port's CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C entry point. On
first use it is compiled by `nvcc` for sm_90a into a shared library under
`kernels/_build/`, named by a hash of the source and the flags, and loaded
with ctypes. Nothing here runs at import time, so the CPU tests import the
package on machines without `nvcc`. A failed build raises with the
compiler's output; a good one keeps it (`ptxas -v`: registers, shared
memory and spills per kernel) beside the library, see `build_log`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "kernels", "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _compile(name: str, out: str) -> None:
    # PyTorch's own toolkit lookup: $CUDA_HOME, then nvcc on PATH, then
    # /usr/local/cuda.
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "dpig_tpu_torch are built on first use on a "
                           "machine with the CUDA toolkit")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS, "-o", tmp,
         os.path.join(CSRC, f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    with open(f"{out}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_log(name: str) -> str:
    """What nvcc printed when it built `csrc/<name>.cu` ('' if unknown)."""
    path = f"{library_path(name)}.log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The kernel library of `csrc/<name>.cu`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            _compile(name, path)
        lib = _loaded[name] = ctypes.CDLL(path)
    return lib
