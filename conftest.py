"""Repository-wide pytest hooks.

The JAX package builds its native libraries (``siril-0.9_tpu/native/*.so``)
in place the first time a process asks for them, and a process that finds
the build failing, or loads a half-written file, gives up on them for the
rest of its life: ``tests/test_film_codec.py`` then skips all its tests.
Under pytest-xdist every worker imports every test module while it
collects, so on a fresh checkout the workers race to build the same files.
Building them here, once, in the process that starts the workers and
before any of them starts, leaves the workers finished files to load.
Where g++ or libav is missing the loaders return None and nothing fails.
"""

import os
import sys

_PKG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "siril-0.9_tpu")


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the files are built
        return
    if _PKG not in sys.path:
        sys.path.insert(0, _PKG)
    # imports no JAX: tests/conftest.py still configures it before its import
    from siriltpu.utils.native import load_film_native, load_native

    load_native()
    load_film_native()
