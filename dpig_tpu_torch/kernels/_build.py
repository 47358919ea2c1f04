"""Build and load the port's native code: the CUDA kernels and the host
C++ of the data path.

Each CUDA kernel is one `csrc/<name>.cu` file with a plain C entry point.
On first use it is compiled by `nvcc` for sm_90a into a shared library
under `kernels/_build/`, named by a hash of the source and the flags, and
loaded with ctypes (`load`). Host code is one `csrc/<name>.cc` file, built
the same way by `g++` (`load_host`). Nothing here runs at import time, so
the CPU tests import the package on machines without `nvcc`. A failed
build raises with the compiler's output; nothing falls back. A good one
keeps that output (`ptxas -v`: registers, shared memory and spills per
kernel) beside the library, see `build_log`.
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
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _flags(source: str):
    return NVCC_FLAGS if source.endswith(".cu") else HOST_FLAGS


def library_path(name: str, source: str = "") -> str:
    """Where the library of `csrc/<source>` (default `<name>.cu`) lives."""
    source = source or f"{name}.cu"
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(source)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _compiler(source: str) -> str:
    if not source.endswith(".cu"):
        return "g++"
    # PyTorch's own toolkit lookup: $CUDA_HOME, then nvcc on PATH, then
    # /usr/local/cuda.
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "dpig_tpu_torch are built on first use on a "
                           "machine with the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _compile(source: str, out: str) -> None:
    compiler = _compiler(source)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(
            [compiler, *_flags(source), "-o", tmp,
             os.path.join(CSRC, source)], capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"{compiler} not found: {source} of "
                           "dpig_tpu_torch is built on first use") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed for {source}"
                           f" (exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
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


def _load(name: str, source: str) -> ctypes.CDLL:
    lib = _loaded.get(source)
    if lib is None:
        path = library_path(name, source)
        if not os.path.exists(path):
            _compile(source, path)
        lib = _loaded[source] = ctypes.CDLL(path)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The kernel library of `csrc/<name>.cu`, built on first use."""
    return _load(name, f"{name}.cu")


def load_host(name: str) -> ctypes.CDLL:
    """The host library of `csrc/<name>.cc`, built by g++ on first use."""
    return _load(name, f"{name}.cc")
