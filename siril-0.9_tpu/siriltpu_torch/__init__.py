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
- ``parallel.engine``: the map-over-frames engine; ``parallel.mesh``
  (device meshes, sharding descriptors, ``run_frames_sharded``, which the
  ``mesh=`` of ``peaker_batch``, ``warp_batch_dev``,
  ``register_global_star``, ``global_align_batch`` and
  ``config5_pipeline`` runs through), ``parallel.sharded`` (the sharded
  sum stack, register + stack and row-slab stack) and
  ``parallel.multihost`` (``torch.distributed``: process groups,
  per-process frame feeding, the multi-process register + stack;
  ``parallel._mh_worker`` is its worker, ``parallel.dryrun`` the
  ``dryrun_multichip`` of the repository's entry file);
- ``registration.translation``, ``registration.onestar``,
  ``registration.matching``, ``registration.ransac``,
  ``registration.global_star``: the registration entry points;
- ``stacking.api``, ``pipelines.register_stack``: the stacking entry points;
- ``pipelines.full``: BASELINE config 5 as one call, ``config5_pipeline``;
- ``cli``, ``core.config``, ``core.undo``: Siril's command line
  (``python -m siriltpu_torch``), its settings and undo history;
- ``verify.oracle``: the NumPy oracle (the stacks, the per-pixel
  rejection, normalization, the noise estimate, the shift gather, and
  libraw's postprocess stages);
- ``utils.rounding``, ``utils.timing``, ``utils.native`` (the host C++ of
  ``siril-0.9_tpu/native/``, built into ``_build/``); ``testing``: synthetic
  frames and the raw file writers; and, of the port alone,
  ``utils.interop`` (data crossing between the packages, uint16 at the
  boundary) and ``utils.build`` (the CUDA build).

The top-level API is ``siriltpu``'s: ``Frame``, ``ImStats``, ``Rect`` and
the entry points below, each imported from its module when first asked
for, so ``import siriltpu_torch`` imports no submodule.
``enable_compilation_cache`` is not among them: the port has no
compilation cache (XLA's; the CUDA build keys ``_build/`` by a hash of its
sources instead).

It imports torch and numpy only, never JAX or ``siriltpu``. The CUDA
sources under ``csrc/`` are compiled with ``nvcc`` at first CUDA use
(``utils.build``), so the package imports on a machine without a GPU.
"""

__version__ = "0.1.0"

#: the top-level API: name -> (module, attribute), as ``siriltpu``'s
API = {
    "Frame": ("siriltpu_torch.core.frame", "Frame"),
    "ImStats": ("siriltpu_torch.core.frame", "ImStats"),
    "Rect": ("siriltpu_torch.core.frame", "Rect"),
    "statistics": ("siriltpu_torch.ops.stats", "statistics"),
    "stack_frames": ("siriltpu_torch.stacking.api", "stack_frames"),
    "stack_sequence": ("siriltpu_torch.stacking.api", "stack_sequence"),
    "register_shift_dft": ("siriltpu_torch.registration.translation",
                           "register_shift_dft"),
    "register_ecc": ("siriltpu_torch.registration.translation", "register_ecc"),
    "register_onestar": ("siriltpu_torch.registration.onestar", "register_onestar"),
    "register_global_star": ("siriltpu_torch.registration.global_star",
                             "register_global_star"),
    "peaker": ("siriltpu_torch.ops.starfind", "peaker"),
    "read_fits": ("siriltpu_torch.io.fits", "read_fits"),
    "write_fits": ("siriltpu_torch.io.fits", "write_fits"),
    "check_seq": ("siriltpu_torch.io.sequence", "check_seq"),
    "seq_preprocess": ("siriltpu_torch.pipelines.preprocess", "seq_preprocess"),
    "register_and_stack": ("siriltpu_torch.pipelines.register_stack",
                           "register_and_stack"),
    "autostretch": ("siriltpu_torch.ops.histogram_ops", "autostretch"),
    "read_raw": ("siriltpu_torch.io.raw", "read_raw"),
    "read_raw_cfa": ("siriltpu_torch.io.raw", "read_raw_cfa"),
    "convert_dir": ("siriltpu_torch.io.conversion", "convert_dir"),
    "export_sequence": ("siriltpu_torch.io.export", "export_sequence"),
    "film_sequence": ("siriltpu_torch.io.films", "film_sequence"),
    "init_distributed": ("siriltpu_torch.parallel.multihost", "init_distributed"),
    "make_multihost_register_stack": ("siriltpu_torch.parallel.multihost",
                                      "make_multihost_register_stack"),
}


def __getattr__(name):
    """The lazy top-level API (keeps ``import siriltpu_torch`` light)."""
    if name in API:
        import importlib

        mod, attr = API[name]
        return getattr(importlib.import_module(mod), attr)
    if name == "enable_compilation_cache":
        raise AttributeError(
            "siriltpu_torch has no enable_compilation_cache: it caches no XLA "
            "programs (siriltpu's utils/compcache.py is not ported); its CUDA "
            "library is built once into _build/, keyed by its sources' hash")
    raise AttributeError(f"module 'siriltpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(API))
