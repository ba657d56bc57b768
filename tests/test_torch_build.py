"""siriltpu_torch.utils.build: what the library's name is keyed by, and
that every kernel has its source. Nothing here compiles: the build needs
nvcc and runs at first CUDA use."""

import shutil

import pytest

pytest.importorskip("torch")

from siriltpu_torch.utils import build  # noqa: E402


@pytest.mark.parametrize("name", ["reject_common.cuh", "reject_sigma.cu"])
def test_library_path_changes_with_any_csrc_file(tmp_path, name):
    """Touching a header that several kernels share, or one source,
    names another library, so a stale one is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    before = build.library_path(csrc)
    assert before == build.library_path(csrc)
    assert before == build.library_path()
    with open(csrc / name, "a") as fh:
        fh.write("\n// touched\n")
    after = build.library_path(csrc)
    assert after != before
    assert after.parent == build.BUILD_DIR


def test_library_path_changes_with_a_new_header(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    before = build.library_path(csrc)
    (csrc / "extra.h").write_text("#pragma once\n")
    assert build.library_path(csrc) != before
    (csrc / "notes.txt").write_text("not a source\n")
    assert build.library_path(csrc) == build.library_path(csrc)


def test_every_kernel_has_its_source():
    for name in build.KERNELS:
        src = build.CSRC_DIR / f"reject_{name}.cu"
        assert src.is_file(), src
        text = src.read_text()
        assert f"SIRILTPU_REJECT_ENTRY({name}," in text
        assert '#include "reject_common.cuh"' in text
