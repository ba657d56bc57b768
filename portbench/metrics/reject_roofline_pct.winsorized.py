"""The winsorized rejection stack's share of the card's memory roofline:
the bytes of every ``register_stack.stack_rejected`` call with winsorized
rejection (each (F, P) uint16 input word read once, each output word
written once) over their CUDA-event time, at NVIDIA's published HBM rate."""

from portbench.core.roofline import stack_share_pct

LAYER, UNIT, MOVES = "rejection kernels", "%", "frames_per_s"


def read(run):
    return stack_share_pct(run, "winsorized")
