"""Build the port's CUDA library from ``csrc/*.cu`` and load it.

The sources have a plain C interface, so they are compiled by ``nvcc``
alone into one shared library and bound with ``ctypes``; no PyTorch
header is compiled. The library goes into ``siriltpu_torch/_build/``
under a name keyed by a hash of the sources and flags, and is built at
first use: importing this module needs no ``nvcc``. A missing compiler
or a failed build raises; there is nothing to fall back to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# -fmad=false: no product may be fused into an add, so the f32 sd combine
# rounds exactly as the JAX package's does. No fast math: IEEE div/sqrt.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.is_file():
        raise RuntimeError(f"nvcc not found under CUDA_HOME={CUDA_HOME}")
    return str(nvcc)


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsiriltpu_torch_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the library unless it is already built. Returns the path,
    whether it was compiled now, the seconds it took and nvcc's output
    (``-Xptxas -v``: registers and shared memory of each kernel)."""
    out = library_path()
    if out.is_file():
        return {"path": out, "built": False, "seconds": 0.0, "log": ""}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return {"path": out, "built": True,
            "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded library with every C function's signature declared."""
    lib = ctypes.CDLL(str(build()["path"]))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.reject_sigma_u16.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i64,
                                     ctypes.c_float, ctypes.c_float, ptr]
    lib.reject_sigma_u16.restype = ctypes.c_int
    return lib


__all__ = ["build", "library", "library_path", "CSRC_DIR", "BUILD_DIR"]
