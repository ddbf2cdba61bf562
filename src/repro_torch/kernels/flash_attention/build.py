"""Build the flash_attention CUDA kernel at first use and load it.

``nvcc`` compiles ``csrc/flash_attention.cu`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, which ``ctypes`` loads.  The
library lands in ``build/flash_attention/`` at the repository root, named
by a hash of the source, so an edited source is rebuilt and an unchanged
one is reused.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "flash_attention"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
build_log = ""          # nvcc's output of the last build (ptxas register use)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("flash_attention: nvcc not found (PATH, CUDA_HOME)")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libflash_attention_{digest}.so"


def build() -> Path:
    """Compile the kernel unless a library of this source already exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"flash_attention: nvcc failed\n{build_log}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        fn = handle.fa_forward
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p,                     # q, k, v, o
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,          # B, H, KV, S, hd
                       ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int,                        # scale, causal,
                       ctypes.c_void_p]                     # window, dtype, stream
        fn.restype = ctypes.c_int
        _lib = handle
    return _lib
