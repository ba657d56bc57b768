"""The top-level API of siriltpu_torch against siriltpu's
(``siriltpu/__init__.py``): the same names, each the port's counterpart of
the JAX name, resolved lazily; ``enable_compilation_cache`` is the one
name the port leaves out (``utils/compcache.py`` is not ported)."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import siriltpu  # noqa: E402

import siriltpu_torch  # noqa: E402

PKG_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "siril-0.9_tpu")
#: every lazy name of siriltpu's API (siriltpu/__init__.py:26-56)
JAX_API = ["statistics", "stack_frames", "stack_sequence", "register_shift_dft",
           "register_ecc", "register_onestar", "register_global_star", "peaker",
           "read_fits", "write_fits", "check_seq", "seq_preprocess",
           "register_and_stack", "autostretch", "read_raw", "read_raw_cfa",
           "convert_dir", "export_sequence", "film_sequence", "init_distributed",
           "make_multihost_register_stack", "enable_compilation_cache"]
PORTED = [n for n in JAX_API if n != "enable_compilation_cache"]


@pytest.mark.parametrize("name", PORTED + ["Frame", "ImStats", "Rect"])
def test_name_resolves_to_its_module_attribute(name):
    import importlib

    mod, attr = siriltpu_torch.API[name]
    assert getattr(siriltpu_torch, name) is getattr(importlib.import_module(mod), attr)
    assert name in dir(siriltpu_torch)


@pytest.mark.parametrize("name", PORTED + ["Frame", "ImStats", "Rect"])
def test_name_is_the_counterpart_of_the_jax_name(name):
    """The same module path under the port's package, the same name."""
    port, ref = getattr(siriltpu_torch, name), getattr(siriltpu, name)
    assert port is not ref
    assert port.__name__ == ref.__name__ == name
    assert port.__module__ == ref.__module__.replace("siriltpu.", "siriltpu_torch.", 1)


def test_api_covers_the_jax_api():
    assert sorted(PORTED + ["Frame", "ImStats", "Rect"]) == sorted(siriltpu_torch.API)
    for name in JAX_API:
        getattr(siriltpu, name)      # every listed name is the JAX package's


def test_enable_compilation_cache_is_left_out():
    with pytest.raises(AttributeError, match="compcache.py is not ported"):
        siriltpu_torch.enable_compilation_cache
    assert not hasattr(siriltpu_torch, "enable_compilation_cache")
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        siriltpu_torch.nope


def test_frame_types_are_the_ports_own():
    from siriltpu_torch.core import frame

    assert siriltpu_torch.Frame is frame.Frame and siriltpu_torch.Rect is frame.Rect
    assert siriltpu_torch.ImStats is frame.ImStats
    assert siriltpu_torch.Frame is not siriltpu.Frame


def test_import_is_light():
    """``import siriltpu_torch`` imports none of its submodules; asking for
    a name imports that name's module."""
    code = ("import sys, siriltpu_torch\n"
            "assert not [k for k in sys.modules if k.startswith('siriltpu_torch.')]\n"
            "siriltpu_torch.Rect\n"
            "assert 'siriltpu_torch.core.frame' in sys.modules\n"
            "assert 'siriltpu_torch.stacking.api' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=PKG_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
