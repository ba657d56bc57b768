"""siriltpu_torch — the PyTorch + CUDA port of siriltpu for NVIDIA Hopper.

The package mirrors ``siriltpu``'s module paths so that every function has
an obvious counterpart in ``siriltpu.<same path>``:

- ``core.frame``, ``core.memory``: frames, sequence records, memory budgets;
- ``io.fits``, ``io.ser``, ``io.seqfile``, ``io.sequence``: FITS and SER
  files (a CFA SER debayered on read), ``.seq`` files, sequences (films
  aside);
- ``ops.rejection`` (every rejection, linearfit included), ``ops.sortnet``,
  ``ops.stack``, ``ops.shift``, ``ops.stats``: stacking's per-pixel work;
- ``ops.cuda.reject_stack`` <- ``siriltpu.ops.pallas.reject_stack``: the
  five CUDA rejection kernels of ``csrc/``;
- ``ops.fftreg``, ``ops.quality``, ``ops.interp``, ``ops.ecc``: DFT and ECC
  registration and frame quality;
- ``ops.wavelets``, ``ops.psf``, ``ops.photometry``, ``ops.starfind``: star
  detection;
- ``ops.warp``: the perspective warp of global registration (gather only);
- ``ops.demosaic`` (host methods, and VNG and AHD as torch programs),
  ``ops.imops``, ``ops.cosmetic``, ``pipelines.preprocess``: calibration
  and demosaicing;
- ``ops.background``, ``ops.histogram_ops``, ``ops.display``: background
  extraction, the autostretch and display remaps (host NumPy);
- ``parallel.engine``: the map-over-frames engine;
- ``registration.translation``, ``registration.onestar``,
  ``registration.matching``, ``registration.ransac``,
  ``registration.global_star``: the registration entry points;
- ``stacking.api``, ``pipelines.register_stack``: the stacking entry points;
- ``pipelines.full``: BASELINE config 5 as one call, ``config5_pipeline``;
- ``verify.oracle``: the rejection part of the NumPy oracle and its shift
  gather;
- ``utils.rounding``; and, of the port alone, ``utils.interop`` (data
  crossing between the packages, uint16 at the boundary) and ``utils.build``
  (the CUDA build).

It imports torch and numpy only, never JAX or ``siriltpu``. The CUDA
sources under ``csrc/`` are compiled with ``nvcc`` at first CUDA use
(``utils.build``), so the package imports on a machine without a GPU.
"""

__version__ = "0.1.0"
