"""Traffic kind ``linearfit``: ``resident``'s closed loop with linear-fit
clipping. The configuration's frames are made on the device once, in
set-up; each sequence registers and stacks all of them with
``register_and_stack`` (the configuration's rejection, ``linearfit``, and
its sig) and its default return, so that the stack, the shifts and the
quality come back to the host. Set-up, the sequence, the comparison and
the close are ``resident``'s own functions.

The reference is ``resident``'s registration, quality and align, then
Siril's linear fit in float64 (``core/reference_linearfit.py``). The fit
is carried by the ``ikss`` stage of a ``Precision``: ``Precision()``
computes it in float64, and the configuration states ``ikss`` float64
for this path (the program settles every knife-edge pixel in float64), so
the control, ``Precision.below``, runs the fit in float32; its other
stages step down as ``resident``'s do.

A traced run also wraps the program's float64 settle of the knife-edge
pixels, ``linearfit_settle`` as ``ops/cuda/reject_stack.py`` looks it up;
its profiler covers the first ``TRACE_SECONDS`` of the window, at least
two whole sequences of the deep-sky linear fit.
"""

from __future__ import annotations

from pathlib import Path

from portbench.core import frames as gen
from portbench.core import reference as ref
from portbench.core import reference_linearfit as lref
from portbench.core.spec import load_module

resident = load_module(Path(__file__).with_name("resident.py"),
                       "portbench_traffic_resident")

WARMUP_SEQUENCES = resident.WARMUP_SEQUENCES
TRACE_SECONDS = 6.0

#: (module, attribute, span name, device time) wrapped in a traced run
SPANS = resident.SPANS + (
    ("siriltpu_torch.ops.cuda.reject_stack", "linearfit_settle",
     "linearfit_settle", True),)

State = resident.State
setup = resident.setup
sequence = resident.sequence
compare = resident.compare
close = resident.close


def reference(state: State, prec: ref.Precision):
    """(stack (H, W) uint16, shifts (F, 2) int32, quality (F,)) as the plain
    reference makes them from the same frames."""
    c = state.config
    shifts = ref.phase_shifts(state.frames, state.sel, prec)
    quality = ref.qualities(state.frames, state.sel, prec)
    flat = ref.align(state.frames, shifts).reshape(c["frames"], -1)
    mean, _, _ = lref.stack(flat, c["sig"], prec)
    return (gen.u16_to_numpy(mean).reshape(c["height"], c["width"]), shifts,
            quality)


__all__ = ["SPANS", "WARMUP_SEQUENCES", "TRACE_SECONDS", "State", "setup",
           "sequence", "reference", "compare", "close"]
