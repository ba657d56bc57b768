"""The linear-fit rejection stack's share of the card's memory roofline:
the bytes of every ``register_stack.stack_rejected`` call with linearfit
rejection (each (F, P) uint16 input word read once, each output word
written once, as the sigma and winsorized shares count them) over their
CUDA-event time, the float32 fit's passes and the float64 settle of its
knife-edge pixels included, at NVIDIA's published HBM rate."""

from portbench.core.roofline import stack_share_pct

LAYER, UNIT, MOVES = "rejection kernels", "%", "frames_per_s"


def read(run):
    return stack_share_pct(run, "linearfit")
