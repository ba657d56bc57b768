"""A run with its timed path broken underneath comes out not correct: once
for each fault a register + stack sequence can have. Half of the frames
left out of the stack, the mean taken over the rest; a stacked word, a
shift or a quality altered where it is produced. (The faults of training
and of the exchange between cards have no place in these one-card cells.)"""

import sys
from pathlib import Path

import pytest

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[2])]

import tiny  # noqa: E402

RS = "import siriltpu_torch.pipelines.register_stack as _m\n"
API = "import siriltpu_torch.stacking.api as _m\n"
TR = "import siriltpu_torch.registration.translation as _m\n"


def wrap(module: str, attr: str, body: str) -> str:
    return (module + f"_orig = _m.{attr}\n"
            f"def _broken(*a, **k):\n{body}\n"
            f"_m.{attr} = _broken\n")


FAULTS = {
    "resident": {
        "half_the_frames": wrap(RS, "stack_rejected",
                                "    return _orig(a[0][: a[0].shape[0] // 2].contiguous(), *a[1:], **k)"),
        "a_word_altered": wrap(RS, "stack_rejected",
                               "    out = _orig(*a, **k)\n    out.view(_m.torch.int16)[7] ^= 1\n    return out"),
        "a_shift_altered": wrap(RS, "compute_shifts",
                                "    sx, sy = _orig(*a, **k)\n    sx[1] += 1\n    return sx, sy"),
        "a_quality_altered": wrap(RS, "quality_estimate_batch",
                                  "    q = _orig(*a, **k)\n    q[2] *= 1.01\n    return q"),
    },
    "ser": {
        "half_the_frames": wrap(API, "reject_stack",
                                "    return _orig(a[0][: a[0].shape[0] // 2].contiguous(), *a[1:], **k)"),
        "a_word_altered": wrap(API, "reject_stack",
                               "    out = _orig(*a, **k)\n    out[0].view(_m.torch.int16)[7] ^= 1\n    return out"),
        "a_shift_altered": wrap(TR, "register_shift_frames",
                                "    sx, sy = _orig(*a, **k)\n    sx[1] += 1\n    return sx, sy"),
        "a_quality_altered": (TR + "_orig = _m.quality_estimate\n_n = [0]\n"
                              "def _broken(*a, **k):\n    _n[0] += 1\n"
                              "    return _orig(*a, **k) * (1.01 if _n[0] % 8 == 3 else 1.0)\n"
                              "_m.quality_estimate = _broken\n"),
    },
}


@pytest.mark.parametrize("kind, fault", [(k, f) for k in FAULTS for f in FAULTS[k]])
def test_a_broken_timed_path_is_not_correct(tmp_path, kind, fault):
    root = tiny.make_root(tmp_path)
    code, result, err = tiny.run_cpu(
        root, ["--workload", f"tiny.{kind}", "--seed", "77", "--seconds", "0.3",
               "--trace", "0"], patch=FAULTS[kind][fault])
    assert code == 0, err
    assert result["correct"] is False and result["failed"] == 1
    assert any(v["value"] > v["limit"] for v in result["compared"].values())
