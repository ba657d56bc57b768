"""Traffic kind ``resident``: the configuration's frames are made on the
device once, in set-up; each sequence of the closed loop registers and
stacks all of them with ``register_and_stack`` and its default return,
so that the stack, the shifts and the quality come back to the host.

Set-up runs ``WARMUP_SEQUENCES`` whole sequences; a traced run's profiler
covers the first ``TRACE_SECONDS`` of the window.
"""

from __future__ import annotations

import numpy as np

from portbench.core import frames as gen
from portbench.core.check import largest_gap, words_off
from portbench.core import reference as ref

WARMUP_SEQUENCES = 3
TRACE_SECONDS = 3.0

_RS = "siriltpu_torch.pipelines.register_stack"
#: (module, attribute, span name, device time) wrapped in a traced run
SPANS = ((_RS, "compute_shifts", "compute_shifts", True),
         (_RS, "quality_estimate_batch", "quality_estimate_batch", True),
         (_RS, "align_frames_auto", "align_frames_auto", True),
         (_RS, "stack_rejected", "stack_rejected", True))


class State:
    def __init__(self, config, params, seed, device):
        self.config, self.params, self.device = config, params, device
        self.frames, self.truth = gen.make_frames(config, seed, device)
        s = config["selection"]
        self.sel = ((config["width"] - s) // 2, (config["height"] - s) // 2, s)


def setup(config: dict, params: dict, seed: int, device) -> State:
    state = State(config, params, seed, device)
    for _ in range(WARMUP_SEQUENCES):
        sequence(state, None)
    return state


def sequence(state: State, spans):
    from siriltpu_torch.pipelines.register_stack import register_and_stack

    c = state.config
    out = register_and_stack(state.frames, sel=state.sel,
                             rejection=c["rejection"], sig=tuple(c["sig"]))
    return out, c["frames"]


def reference(state: State, prec: ref.Precision):
    """(stack (H, W) uint16, shifts (F, 2) int32, quality (F,)) as the plain
    reference makes them from the same frames."""
    c = state.config
    shifts = ref.phase_shifts(state.frames, state.sel, prec)
    quality = ref.qualities(state.frames, state.sel, prec)
    flat = ref.align(state.frames, shifts).reshape(c["frames"], -1)
    mean, _, _ = ref.stack(flat, c["rejection"], c["sig"], prec)
    return (gen.u16_to_numpy(mean).reshape(c["height"], c["width"]), shifts,
            quality)


def compare(got, want) -> dict:
    """The numbers compared with their limits: the integer output words
    (stacked pixels and shift components) that differ, and the largest
    relative gap of a frame's quality."""
    return {
        "words_off": words_off(got, want),
        "quality_gap": largest_gap(got[2], want[2], relative=True),
    }


def close(state: State) -> None:
    pass


__all__ = ["SPANS", "WARMUP_SEQUENCES", "TRACE_SECONDS", "setup", "sequence", "reference", "compare",
           "close"]
