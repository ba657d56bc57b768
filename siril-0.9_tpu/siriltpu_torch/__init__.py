"""siriltpu_torch — the PyTorch + CUDA port of siriltpu for NVIDIA Hopper.

The package mirrors ``siriltpu``'s module paths so that every function has
an obvious counterpart:

- ``utils.rounding``            <- ``siriltpu.utils.rounding``
- ``ops.sortnet``               <- ``siriltpu.ops.sortnet``
- ``ops.rejection``             <- ``siriltpu.ops.rejection`` (sigma subset)
- ``ops.cuda.reject_stack``     <- ``siriltpu.ops.pallas.reject_stack``
- ``ops.fftreg``                <- ``siriltpu.ops.fftreg``
- ``ops.quality``               <- ``siriltpu.ops.quality``
- ``pipelines.register_stack``  <- ``siriltpu.pipelines.register_stack``

It imports torch and numpy only, never JAX or ``siriltpu``. The CUDA
sources under ``csrc/`` are compiled with ``nvcc`` at first CUDA use
(``utils.build``), so the package imports on a machine without a GPU.
"""

__version__ = "0.1.0"
