"""Build the port's CUDA library from ``csrc/`` and load it.

The sources have a plain C interface, so they are compiled by ``nvcc``
alone and bound with ``ctypes``; no PyTorch header is compiled. Every
``*.cu`` is compiled to an object by its own ``nvcc``, all started
together, and the objects are linked into one shared library. The library
goes into ``siriltpu_torch/_build/`` under a name keyed by a hash of every
file under ``csrc/`` (sources and the headers they share) and of the
flags, and is built at first use: importing this module needs no
``nvcc``. A missing compiler or a failed build raises; there is nothing
to fall back to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: the rejection kernels of the library: each has the C entries
#: reject_<name>_u16 (the launch) and reject_<name>_plan (its block, shared
#: memory, scratch and occupancy). The library also has align_shift_u16.
KERNELS = ("sigma", "median", "percentile", "sigmedian", "winsorized")
#: every kernel with a plan entry: KERNELS and linear-fit clipping
#: (csrc/reject_linearfit.cu), whose launch reject_linearfit_u16 takes its
#: sigs as doubles, the table of x moments and a counter buffer
PLANNED = KERNELS + ("linearfit",)

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -fmad=false: no product may be fused into an add, so the f32 sd combine
# rounds exactly as the JAX package's does. No fast math: IEEE div/sqrt.
COMPILE_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                 "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*_ARCH, "-shared")
_SUFFIXES = (".cu", ".cuh", ".h")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.is_file():
        raise RuntimeError(f"nvcc not found under CUDA_HOME={CUDA_HOME}")
    return str(nvcc)


def _files(csrc_dir: Path):
    """Every source and header under ``csrc_dir``, sorted."""
    files = sorted(p for p in csrc_dir.rglob("*")
                   if p.is_file() and p.suffix in _SUFFIXES)
    if not any(p.suffix == ".cu" for p in files):
        raise RuntimeError(f"no CUDA sources under {csrc_dir}")
    return files


def library_path(csrc_dir: Path = CSRC_DIR) -> Path:
    """Where the library for the files under ``csrc_dir`` and the flags
    lives."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for path in _files(csrc_dir):
        h.update(str(path.relative_to(csrc_dir)).encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libsiriltpu_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands concurrently; raise with the output of any that
    fails. Returns their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build(force: bool = False) -> dict:
    """Compile the library unless it is already built (``force``: compile
    it all the same, so that nvcc's output is there to read). Returns the
    path, whether it was compiled now, the seconds it took and nvcc's
    output (``-Xptxas -v``: registers, spills and stack frame of each
    kernel entry)."""
    out = library_path()
    if out.is_file() and not force:
        return {"path": out, "built": False, "seconds": 0.0, "log": ""}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile into a private directory, then rename the library into
    # place: concurrent builds never load a half-written one
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    srcs = [p for p in _files(CSRC_DIR) if p.suffix == ".cu"]
    objs = [tmp / f"{s.stem}.o" for s in srcs]
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *COMPILE_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in zip(srcs, objs)])
        lib = tmp / out.name
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", str(lib), *map(str, objs)]])
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"path": out, "built": True,
            "seconds": time.perf_counter() - t0, "log": log}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded library with every C function's signature declared."""
    lib = ctypes.CDLL(str(build()["path"]))
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    for name in KERNELS:
        fn = getattr(lib, f"reject_{name}_u16")
        # vals, ld, scratch, scratch_bytes, mean, degen, rejl, rejh, f, p,
        # tile, siglow, sighigh, stream
        fn.argtypes = [ptr, i64, ptr, i64, ptr, ptr, ptr, ptr, i64, i64, i64,
                       f32, f32, ptr]
        fn.restype = ctypes.c_int
    # vals, ld, scratch, scratch_bytes, moments, mean, rejl, rejh, f, p,
    # siglow, sighigh, counters, smem_limit, scratch_limit, stream
    lib.reject_linearfit_u16.argtypes = [ptr, i64, ptr, i64, ptr, ptr, ptr, ptr,
                                         i64, i64, ctypes.c_double,
                                         ctypes.c_double, ptr, i64, i64, ptr]
    lib.reject_linearfit_u16.restype = ctypes.c_int
    for name in PLANNED:
        plan = getattr(lib, f"reject_{name}_plan")
        # f, p, smem_limit, scratch_limit, out (7 int64)
        plan.argtypes = [i64, i64, i64, i64, ctypes.POINTER(i64)]
        plan.restype = ctypes.c_int
    # src, sx, sy, out, f, h, w, stream (csrc/align_shift.cu)
    lib.align_shift_u16.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.align_shift_u16.restype = ctypes.c_int
    return lib


__all__ = ["build", "library", "library_path", "KERNELS", "PLANNED", "CSRC_DIR",
           "BUILD_DIR"]
