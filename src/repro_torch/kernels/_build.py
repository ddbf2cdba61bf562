"""One build route for every CUDA kernel of the port.

``nvcc`` compiles a kernel's ``csrc/<name>.cu`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, which ``ctypes`` loads.
The library lands in ``build/<name>/`` at the repository root, named by a
hash of the source, the headers (``*.cuh``) beside it and in the shared
``kernels/include/`` (on nvcc's include path; ``mma_bf16.cuh`` lives
there) and the flags, so an edited source or header is rebuilt and an
unchanged one is reused.
Nothing here runs at import time: a kernel's wrapper calls ``load``
inside the function that launches it.

    lib = load("collective_codec", SOURCE, {"cc_select": [c_void_p, ...]})
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
INCLUDE_DIR = Path(__file__).resolve().parent / "include"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}     # nvcc's output per name (ptxas use)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME)")
    return path


def library_path(name: str, source: Path) -> Path:
    source = Path(source)
    headers = (sorted(source.parent.glob("*.cuh"))
               + sorted(INCLUDE_DIR.glob("*.cuh")))
    data = source.read_bytes() + b"".join(h.read_bytes() for h in headers)
    digest = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_ROOT / name / f"lib{name}_{digest}.so"


def compile_to(name: str, source: Path, out: Path) -> None:
    """nvcc ``source`` into the library ``out``; raises on failure."""
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR),
                           "-o", str(out), str(source)],
                          capture_output=True, text=True)
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{build_logs[name]}")


def build(name: str, source: Path) -> Path:
    """Compile ``source`` unless a library of this source already exists."""
    out = library_path(name, source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    compile_to(name, source, tmp)
    os.replace(tmp, out)
    return out


def bind(lib: ctypes.CDLL, signatures: Dict[str, List]) -> ctypes.CDLL:
    """Set each exported C function's ctypes argument types; every
    function returns an int (``cudaGetLastError()`` after the launch)."""
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load(name: str, source: Path,
         signatures: Dict[str, List]) -> ctypes.CDLL:
    """The loaded library ``name``, built on first call.  ``signatures``
    maps each exported C function to its ctypes argument types; every
    function returns an int (``cudaGetLastError()`` after the launch)."""
    lib = _libs.get(name)
    if lib is None:
        lib = bind(ctypes.CDLL(str(build(name, source))), signatures)
        _libs[name] = lib
    return lib
