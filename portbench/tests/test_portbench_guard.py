"""The import guard compares top-level names whole: siriltpu_torch passes,
siriltpu, jax, jaxlib and flax fail; a run that finds one loaded once its
window has closed prints no result."""

import sys
from pathlib import Path

import pytest

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[2])]

import tiny  # noqa: E402
from portbench.core.guard import forbidden_modules  # noqa: E402


@pytest.mark.parametrize("names, found", [
    (["siriltpu_torch", "siriltpu_torch.ops.fftreg", "numpy", "jaxtyping"], []),
    (["siriltpu", "siriltpu_torch"], ["siriltpu"]),
    (["siriltpu.ops.pallas.reject_stack"], ["siriltpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
])
def test_names_are_compared_whole(names, found):
    assert forbidden_modules(names) == found


@pytest.mark.parametrize("module, rc", [("siriltpu_torch.ops.fftreg", 0), ("siriltpu", 4)])
def test_a_run_that_loads_the_jax_package_prints_no_result(tmp_path, module, rc):
    root = tiny.make_root(tmp_path)
    patch = ("import types; import siriltpu_torch.pipelines.register_stack as _rs\n"
             "_orig = _rs.register_and_stack\n"
             "def _late(*a, **k):\n"
             f"    sys.modules.setdefault({module!r}, types.ModuleType({module!r}))\n"
             "    return _orig(*a, **k)\n"
             "_rs.register_and_stack = _late")
    code, result, err = tiny.run_cpu(
        root, ["--workload", "tiny.resident", "--seed", "5", "--seconds", "0.2",
               "--trace", "0"], patch=patch)
    assert code == rc
    assert (result is None) == (rc != 0)
    if rc:
        assert "loaded siriltpu" in err
