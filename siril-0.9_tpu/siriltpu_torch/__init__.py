"""siriltpu_torch — the PyTorch + CUDA port of siriltpu for NVIDIA Hopper.

The package mirrors ``siriltpu``'s module paths so that every function has
an obvious counterpart in ``siriltpu.<same path>``:

- ``core.frame``, ``core.memory``: frames, sequence records, memory budgets;
- ``io.fits``, ``io.ser``, ``io.seqfile``, ``io.sequence``: FITS and SER
  files (a CFA SER debayered on read), ``.seq`` files, sequences;
- ``io.films``, ``io.avi``, ``io.mp4``, ``io.film_codec``: films (DIB and
  MJPEG AVI, MJPEG MP4, other codecs through libav where it is);
  ``io.raw``, ``io.rawproc``: camera raw files and libraw's postprocess;
  ``io.export``: sequence export; ``io.formats``, ``io.conversion``: image
  files and conversion;
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
- ``cli``, ``core.config``, ``core.undo``: Siril's command line
  (``python -m siriltpu_torch``), its settings and undo history;
- ``verify.oracle``: the rejection part of the NumPy oracle, its shift
  gather, and libraw's postprocess stages;
- ``utils.rounding``, ``utils.timing``, ``utils.native`` (the host C++ of
  ``siril-0.9_tpu/native/``, built into ``_build/``); ``testing``: synthetic
  frames and the raw file writers; and, of the port alone,
  ``utils.interop`` (data crossing between the packages, uint16 at the
  boundary) and ``utils.build`` (the CUDA build).

It imports torch and numpy only, never JAX or ``siriltpu``. The CUDA
sources under ``csrc/`` are compiled with ``nvcc`` at first CUDA use
(``utils.build``), so the package imports on a machine without a GPU.
"""

__version__ = "0.1.0"
