"""Traffic kind ``ser``: the configuration's frames, made on the device
from the seed, are written in set-up as a mono 16-bit SER file under
``TMPDIR``, as a capture program leaves them (the file then sits in the
page cache). Each sequence of the closed loop opens the file
(``ser_sequence``), registers it (``register_shift_dft`` over the central
square selection) and stacks it (``stack_sequence`` with the
configuration's method, rejection and normalization, ``stream`` at its
default), the stack ending in host memory.

Set-up runs one whole sequence on a SER of the first ``WARMUP_FRAMES``
frames: the same frame shape, and the same split of the registration's
frames into chunks of 64 (104 is 64 more than 1000 modulo 64). A traced
run's profiler covers the whole window (``TRACE_SECONDS`` None).
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from portbench.core import frames as gen
from portbench.core import reference as ref
from portbench.core.check import largest_gap, words_off

WARMUP_FRAMES = 104
TRACE_SECONDS = None

#: (module, attribute, span name, device time) wrapped in a traced run; the
#: opened sequence's reads are wrapped in each sequence
SPANS = (("siriltpu_torch.registration.translation", "register_shift_dft",
          "register_shift_dft", False),
         ("siriltpu_torch.stacking.api", "sequence_normalization",
          "sequence_normalization", False))
READS = ("read_frame", "read_frame_part")


class State:
    def __init__(self, config, params, seed, device):
        self.config, self.params, self.device = config, params, device
        self.frames, self.truth = gen.make_frames(config, seed, device)
        h, w, s = config["height"], config["width"], config["selection"]
        # the selection as a Rect (bottom-up x, y, w, h) and as the rows and
        # columns of the bottom-up frames it covers (select_area,
        # statistics.c:31-45)
        self.rect = ((w - s) // 2, (h - s) // 2, s, s)
        self.sel = ((w - s) // 2, h - (h - s) // 2 - s, s)
        self.dir = tempfile.mkdtemp(prefix="portbench_")
        self.path = os.path.join(self.dir, "capture.ser")
        gen.write_ser(self.path, self.frames)


def setup(config: dict, params: dict, seed: int, device) -> State:
    state = State(config, params, seed, device)
    n = min(WARMUP_FRAMES, config["frames"])
    warm = os.path.join(state.dir, "warmup.ser")
    gen.write_ser(warm, state.frames[:n])
    run_file(state, warm, None)
    os.unlink(warm)
    return state


def run_file(state: State, path: str, spans):
    from siriltpu_torch.core.frame import Rect
    from siriltpu_torch.io.sequence import ser_sequence
    from siriltpu_torch.registration import translation
    from siriltpu_torch.stacking import api

    c = state.config
    seq = ser_sequence(path)
    if spans is not None:
        for name in READS:
            spans.wrap(seq, name, name, device_time=False)
    translation.register_shift_dft(seq, 0, Rect(*state.rect), device=state.device)
    res = api.stack_sequence(seq, device=state.device, method=c["method"],
                             rejection=c["rejection"], sig=tuple(c["sig"]),
                             normalize=c["normalize"])
    quality = np.array([r.quality for r in seq.regparam[0]], dtype=np.float64)
    counts = (int(res.rejection_low[0]), int(res.rejection_high[0]))
    return res.data[0], seq.reg_shifts(0), quality, counts


def sequence(state: State, spans):
    return run_file(state, state.path, spans), state.config["frames"]


def reference(state: State, prec: ref.Precision):
    """(stack (H, W) uint16, shifts (F, 2), normalized quality (F,),
    (low, high) rejections) as the plain reference makes them from the
    frames that were written."""
    c = state.config
    shifts = ref.phase_shifts(state.frames, state.sel, prec)
    quality = ref.normalize_quality(ref.qualities(state.frames, state.sel, prec))
    flat = ref.normalized_flat(state.frames, shifts, c["normalize"], prec)
    mean, low, high = ref.stack(flat, c["rejection"], c["sig"], prec)
    return (gen.u16_to_numpy(mean).reshape(c["height"], c["width"]), shifts,
            quality, (low, high))


def compare(got, want) -> dict:
    """The integer output words (stacked pixels and shift components) that
    differ, the rejection counts' gap, and the largest gap of a normalized
    quality."""
    return {
        "words_off": words_off(got, want),
        "rejections_off": abs(got[3][0] - want[3][0]) + abs(got[3][1] - want[3][1]),
        "quality_gap": largest_gap(got[2], want[2], relative=False),
    }


def close(state: State) -> None:
    shutil.rmtree(state.dir, ignore_errors=True)


__all__ = ["SPANS", "WARMUP_FRAMES", "TRACE_SECONDS", "setup", "sequence", "reference", "compare",
           "close"]
