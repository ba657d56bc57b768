"""Build and load the native C++ component library.

Port of ``siriltpu.utils.native``. The sources are the JAX package's own,
``siril-0.9_tpu/native/*.cpp`` (the AVI writer and the lossless-JPEG,
Nikon, Pentax, Olympus, Panasonic and Canon CRW raw decoders), host C++
with a plain C interface loaded with ctypes; the port reads them and never
writes there. Every source but ``film_codec.cpp`` compiles into one
library (``g++ -O3 -shared -fPIC``, at first use); ``film_codec.cpp``
links against the system's libav and builds into a second one, so the
core components never depend on ffmpeg.

Where the JAX package builds ``native/libsirilnative.so`` in place when it
looks stale, the port builds into ``siriltpu_torch/_build/`` under a name
keyed by a hash of the sources and the flags (as ``utils.build`` does for
the CUDA library), compiling into a private directory and renaming the
result into place: two processes building at once never load a torn file,
and the JAX package's file is never touched. No compiler means None, and
the callers fall back to Python (the AVI writer) or refuse (the native raw
decoders), as in the reference.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

from siriltpu_torch.utils.build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
# film_codec.cpp links against the system libav* stack
_FILM_SOURCES = ("film_codec.cpp",)
FILM_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")


def _sources(film: bool):
    return sorted(p for p in NATIVE_DIR.glob("*.cpp")
                  if (p.name in _FILM_SOURCES) == film)


def library_path(stem: str, sources: Sequence[Path], flags: Sequence[str]) -> Path:
    """Where the library built from ``sources`` with ``flags`` lives."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _build(stem: str, sources, libs=()) -> Optional[Path]:
    """Compile ``sources`` unless built; None when g++ is missing or
    refuses (a missing libav for the film bridge)."""
    out = library_path(stem, sources, CXX_FLAGS + tuple(libs))
    if out.is_file():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    except OSError:
        return None
    try:
        lib = tmp / out.name
        subprocess.run(["g++", *CXX_FLAGS, *map(str, sources), "-o", str(lib),
                        *libs], check=True, capture_output=True)
        os.replace(lib, out)
    except (subprocess.CalledProcessError, OSError):
        return None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _load(path: Optional[Path]) -> Optional[ctypes.CDLL]:
    if path is None:
        return None
    try:
        return ctypes.CDLL(str(path))
    except OSError:
        return None


@functools.lru_cache(maxsize=1)
def load_native() -> Optional[ctypes.CDLL]:
    """The shared native library, compiled at first use. None when no
    compiler is available (callers fall back to Python)."""
    return _load(_build("libsirilnative", _sources(film=False)))


@functools.lru_cache(maxsize=1)
def load_film_native() -> Optional[ctypes.CDLL]:
    """The libav-backed film codec bridge (H.264/VP9/... decode, MP4/
    WEBM encode: the mp4_output.c / ffms2 films.c replacement). None
    when libavformat/libavcodec are not installed on this system."""
    return _load(_build("libsirilfilm", _sources(film=True), FILM_LIBS))


__all__ = ["load_native", "load_film_native", "library_path", "NATIVE_DIR"]
