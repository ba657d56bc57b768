#!/usr/bin/env python3
"""Smoke run of siriltpu_torch's main paths on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA card and
nvcc:  python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compile the CUDA library from siril-0.9_tpu/siriltpu_torch/csrc
   (one nvcc per source, all started together; anew even where it is
   already built), print what ptxas says of each kernel entry's registers
   and spills (any local memory, or a source with no entry, fails the run),
   and the warps the winsorized kernel keeps resident per SM at F = 1000
   (its wires form, at least MIN_WARPS_F1000), with that entry's
   registers, the sigma kernel at F = 100 (its team form, at least
   MIN_WARPS_SIGMA_F100, with its entry's registers; every team entry
   must be there) and the median, percentile and sigmedian kernels at
   F = 50;
3. kernels vs plain: each of the five CUDA rejection kernels (sigma,
   median, percentile, sigmedian, winsorized) against its plain PyTorch
   version on the card, bit for bit, for F in {3, 5, 12, 25, 64, 100, 256,
   1000} (sigma also 7) and at the borders of their designs, F in {31,
   32, 33, 63, 65, 127, 128, 129, 511, 512, 1024, 1025}, at P = 32768
   (outliers at 0 and 60000, real 65535 values, degenerate geomspace
   columns), and on the device-memory scratch path (sigma at F = 4000;
   median, percentile, sigmedian and winsorized at F = 2000 with no
   shared memory); then the dispatcher
   against reject_and_mean (masked_median for median), under
   torch.cuda.set_sync_debug_mode("error"), so a host sync fails the run;
   every sigma launch at F <= 128 must take the team form;
4. register + sigma stack: register_and_stack on a 100 x 4096 x 4096
   uint16 sequence made on the card (shifts in [-20, 20]): exact shifts,
   the kernel's launch count (one, in the team form), and the stacked image
   and counters bit-equal to the plain version run in 2^20-pixel chunks;
5. its timing: frames/s end to end (mean of 3 warm runs) and per-stage ms
   (CUDA events, median of 3 warm runs), with the plain version's ms for
   the kernel and for the whole stack stage at the same shape; then the
   align kernel (align_shift; phase 4's register_and_stack must have made
   exactly one launch of it) against align_frames_slice, its plain
   version, word for word, its device ms a launch back to back beside its
   bound (each frame word read once and written once) and beside the bytes
   the shifts need, the ms of one call, and the ms of align_frames_slice
   (its host read of the shifts included);
6. config 2: stack_frames on 50 x 1 x 2048 x 2048 frames made on the card
   (shifts in [-20, 20]): the median stack, then the mean stack with sigma
   (3, 3), percentile (0.2, 0.1) and sigmedian (3, 3), no normalization;
   and the sigma kernel's time at this shape (its team form at F = 50;
   the kernels line carries it beside its bound, and the ms at 100 x
   4096 x 4096),
   and the sigmedian kernel's at sigmas of 50, where no pixel flags (its
   first pass alone);
7. config 3: stack_frames(mean, winsorized (3, 3), additive_scaling) on
   1000 x 1 x 480 x 640 frames made on the card (shifts in [-20, 20]),
   with the block loop's time alone and what the exact re-run of the
   degenerate pixels costs inside the kernel; then register_and_stack on
   these frames, the planetary cell's shape (winsorized (3, 3)): one align
   launch and one winsorized launch in its wires form, its stack equal to
   the winsorized kernel over align_frames_slice; and the align kernel
   timed as in phase 5. The kernels line carries the align kernel's
   launches, words that differ, and this shape's ms, align_frames_slice
   ms and bound, and for the winsorized kernel, beside its ms at this
   shape, its form, registers and resident warps per SM at F = 1000;
8. the sequence path, in a temporary directory that is removed at the end:
   the frames of config 3 written as a mono 16-bit SER file with SerFile,
   opened with ser_sequence, registered with register_shift_dft on a
   square central selection (the recovered shifts must equal the generated
   ones), and stacked with stack_sequence(mean, winsorized (3, 3),
   additive_scaling), once with the frames read whole and once streamed in
   row blocks; then the frames of config 2, whose BASELINE definition has
   no registration: their SER file is opened through a .seq file that
   holds the generated shifts (read_seqfile), and put through the median
   stack and the sigma (3, 3) mean stack, whole and streamed. Every
   result, image and
   counters, must be bit-equal to stack_frames' result of phases 6-7 on
   the frames in memory with the generated shifts, and its kernel must
   have launched. Config 3's .seq file (write_seqfile) must read back with
   the same shifts, qualities and statistics, and its stack written with
   write_fits must read back equal. Each run prints its frames/s from the
   open of the file to the result on the host, with the seconds of its
   registration, its normalization, its file reads and the rest of its
   stack, and, streamed, the seconds the main thread waited for the
   reader: one run each on the host clock, the file fresh in the page
   cache;
9. the paths that run no hand-written kernel (plain PyTorch on the card;
   every check holds the card's result to other code or to the host):
   a. linearfit: stack_frames(mean, linearfit (3, 3), no normalization) on
      config 2's frames. The image and the rejection totals must equal the
      same (F, P) data, built with other code, put through reject_linearfit
      in 2^20-pixel chunks with every knife-edge pixel settled by the
      per-pixel oracle (verify/oracle.py:c_reject_block); the batched
      float64 settle, on the card and on the host (linearfit_exact), must
      give the oracle's mean and both counters on every knife-edge pixel;
      reject_stack(linearfit), the main path's route, on the whole flat
      must give the same words and counters on every pixel; the fit must
      equal the oracle on 2,000 seeded others. Prints the knife-edge
      pixels, the seconds of the stack's fix-up, of the route, of the
      batched settle on the card and on the host and of the oracle a
      pixel, frames/s, and reject_linearfit's ms at 50 x 4.19M beside its
      device-memory bound and torch.sort's ms;
   b. ECC: 500 frames of 480 x 640 in the 8-bit range (a disc with
      detail, peak under 255, 2 counts of noise, whole-pixel drifts in
      [-20, 20]) written as a SER file, registered with register_ecc (the
      shifts must equal the generated ones and no frame may fail), then
      stack_sequence(mean, sigma (3, 3)) bit-equal to stack_frames on the
      frames in memory with the generated shifts. Prints the seconds of
      the file reads, the host quality estimates and the device loop;
   c. stars: 16 frames of 2048 x 3072 made on the card (sky 1000 with
      noise, 500 Gaussian stars at sub-pixel positions, whole-pixel drifts
      in [-8, 8]): peaker on one frame and peaker_batch on all. At least
      95% of the planted stars must be found within 0.1 px in every frame,
      the batch's list must equal peaker's, and the card's stars must equal
      the same code's on device="cpu" (matched by position: within 0.01 px
      and 0.002 mag). Then register_onestar on a box round the brightest
      star through internal_sequence: the shifts must equal the generated
      ones. Prints ms a frame for the host statistics, detection,
      selection, box gather and fit.
10. global star registration, BASELINE config 4 (plain PyTorch on the card
    but for the sigma kernel of its stacks):
    a. 50 RGB frames of 2048 x 3072 made on the card (sky 1000 with noise
       10 in each channel, 500 round Gaussian stars with channel gains
       1.0, 0.8 and 0.6; each frame the star positions moved through a
       planted homography, rotation in [-0.5, 0.5] degrees and sub-pixel
       shift in [-8, 8] px, frame 0 the identity), registered in memory
       by register_global_star (linear) and stacked by stack_frames(mean,
       sigma (3, 3)). Every frame must register, every homography map the
       frame's corners within 0.1 px of the planted one's,
       global_align_batch give the same homographies and pixels on the
       first 8 frames, the stack equal the plain version (image and
       counters, every channel) and stay sharp: the mean FWHM of the
       stars peaker finds on its layer 0 within 10% of frame 0's.
    b. the same from disk, cut to layer 0 of the first 16 frames (50 RGB
       frames would write 3.8 GB): FITS files in a temporary directory,
       check_seq, register_global_star writing the r_ sequence and its
       .seq, stack_sequence(mean, sigma (3, 3)) on it. The r_ frames must
       read back equal to an in-memory run's output and the stack equal
       stack_frames of those frames.
    c. the warp alone on one 2048 x 3072 layer: nearest, linear, cubic
       and lanczos4 timed beside the bytes bound and torch's grid_sample
       (a yardstick the port does not call), and the card's words against
       the same code on device="cpu" for two frames: equal, lanczos4
       within 1 LSB.
    Prints frames/s of each registration with the seconds of its file
    reads, host statistics, peaker_batch on the card, host matching and
    RANSAC, warp, copy to the host and output, and the stack's seconds.
11. BASELINE config 5, SER convert -> background extraction -> register ->
    rejection stack -> autostretch (plain PyTorch and host NumPy but for
    the winsorized kernel of its stack):
    a. 4 RGB frames of 6144 x 4096 made on the card (sky 800 with noise 6
       in each channel, a linear sky gradient of up to ~3900 counts, 400
       round Gaussian stars with phase 10's channel gains, each frame's
       stars moved through a planted homography: rotation in [-0.5, 0.5]
       degrees, shift in [-5, 5] px), mosaiced to RGGB and written as a
       CFA SER in a temporary directory, then config5_pipeline(debayer=True,
       layer 1, winsorized (3, 3), bg_order 4) on the card. Every frame must
       register, every homography map the frame's corners within 0.1 px
       of the planted one's, the bkg_ frames' corner-to-corner spread stay
       under 10% of the raw frames', the winsorized stack of the r_
       frames (stack_frames) equal its plain version on the card (image
       and counters), the output FITS equal that stack stretched by hand,
       and each channel of the stack, stretched alone, have its median in
       0.15-0.40 x 65535 (the pipeline's stretch links the channels, whose
       backgrounds the debayer's black border sets tens of counts apart, so
       its output's median lies far from the target, as in the reference).
       Prints the stage and overlap seconds, frames/s from the open of
       the file to the written FITS, and the size of the bkg_ and r_
       files, which are removed at the phase's end;
    b. demosaicing one such CFA frame: bilinear, nearest and super-pixel
       on the host (host clock), VNG and AHD on the card (vng_torch,
       ahd_torch; CUDA events), median of 3 warm runs, beside the bytes
       bound of the card's methods; the card's VNG bit-equal to the NumPy
       vng, its AHD equal to the NumPy ahd on all but 1e-5 of the words
       (the float32 colour transform's knife-edges, PARITY.md #7).
12. a scripted session through the command line (CONFIG12: 4 darks and 8
    lights of 4096 x 4096 uint16 mono, BASELINE config 1's frame size),
    in a temporary directory removed at the end (its size printed):
    a. darks/dark.ser (a fixed pattern near 150 with 0.1% hot pixels, plus
       fresh read noise) and lights/light.ser (make_frames' sky, drifts in
       [-20, 20], no per-frame outliers, plus the dark pattern and fresh
       read noise), written frame by frame. SESSION12 (convert the darks,
       their median stack, preprocess the lights with it, register dft on
       phase 5's central 512 x 512 selection, the sigma (3, 3) mean stack,
       bgextract, autostretch, save as FITS, BMP and PNM) runs through
       `python -m siriltpu_torch -d DIR -s session.ssf` in a subprocess on
       the card (it must exit 0, its pp_light.seq hold the planted
       shifts), then line by line in this process through process_command
       (each line timed on the host clock, the card synchronized; the
       launch counts read over the whole session: the median and sigma
       kernels must run). Both runs' d_stacked.fit, pp_light_stacked.fit,
       final.fit (but their DATE card), final.bmp and final.pgm must be
       equal; d_stacked.fit the plain median of the darks on the card;
       pp_light_stacked.fit stack_sequence composed by hand and the plain
       sigma version (image, and the kernel's outputs against its plain
       version at 8 x 16.8M); final.fit the stack's background subtracted
       and stretched by hand; final.bmp and final.pgm what _to_display8
       and save_pnm make of it. Prints frames/s from the first line to
       `save final` for the 8 lights;
    b. POST12 on that result in the same state, each line timed: fftd and
       ffti (within 1 LSB of NumPy's fft2 of the same 16-bit quantized
       modulus and phase, by hand; the distance from the image itself is
       printed, as the quantization's loss), wavelet 4 and wrecons (within
       1 LSB of the image; the card's planes within 0.02 of the CPU's),
       three planes saved as R, G and B, rgbcomp with the image as
       luminance, satu, rmgreen and savebmp: the colour image equal to
       compose, enhance_saturation and scnr applied by hand.

13. films, camera raw files and export through the command line, each part
    in a temporary directory removed at its end:
    a. the planetary film: phase 9b's disc frames at BASELINE config 3's
       shape (1000 x 480 x 640, 8-bit, planted drifts) written as an
       uncompressed DIB AVI by the native writer (30 fps, lo 0, hi 255: every
       word through unchanged; its first 16 frames equal to the Python
       writer's file); FILM13 (seqload of the AVI, register ecc, the
       winsorized (3, 3) additive_scaling stack, seqexport to SER, a 256 x 256
       boxselect and seqexport to AVI) through `python -m siriltpu_torch` in a
       subprocess, then line by line in this process (each line timed; the
       winsorized kernel must launch). The film reader's 1000 frames must
       equal the planted ones (the dib backend), the ECC shifts the planted
       ones, both runs' files be equal, the stack (image and counters) equal
       stack_frames of the frames in memory with the planted shifts, the
       kernel its plain version at this shape, jup.ser's frames shift_gather
       of the planted frames and jupc.avi's frames _frame_to_dib of their
       crop. Prints film frames/s from seqload to the written stack, with the
       seconds of the ECC reads, host quality and device loop, and of the
       normalization;
    b. a DSLR raw night: 12 RGGB lights of 4000 x 6000, 14-bit (phase 10's
       star frames with planted homographies, shifted down two bits,
       mosaiced as phase 11's), written as uncompressed DNG files; RAW13
       (convert -debayer with the default settings, AHD on the card;
       seqload, register global, the r_ sequence's sigma (3, 3) stack, a
       1024 x 1024 boxselect and seqexport to SER) line by line through
       the command line's dispatcher. Each converted FITS must equal read_raw
       of its DNG composed by hand, AHD run on the card once a light
       (ahd_device's calls counted), every light register with its corners
       within 0.1 px of the planted homography, the stack equal its plain
       version (image and counters, three channels) and rc.ser's frames the
       r_ lights' crop. Prints s a command, s a light of convert, frames/s;
    c. every raw decoder that runs native code (CR2 and lossless DNG through
       lj92, NEF, PEF, ORF, RW2, CRW) and the ARW2, MRW and RAF readers, on a
       512 x 768 file each from the port's writers: each must decode to its
       planted plane and pattern, the native library be built under
       siriltpu_torch/_build/ and nothing under siril-0.9_tpu/native/ change.
       Prints whether the libav film bridge builds (either answer passes).
14. the multi-device layer (parallel/) inside a process group of world
    size 1 on NCCL (init_distributed; NCCL cannot place two ranks on one
    card), its meshes repeating the one card:
    a. make_sharded_register_stack over a 4-shard frames mesh on phase 4's
       100 x 4096 x 4096 frames: the planted shifts exactly, the sigma
       kernel launched once a row slab, the result bit-equal to
       stack_frames(mean, sigma (3, 3)) with the same shifts, both timed
       by CUDA events; make_multihost_register_stack over the same mesh,
       read_frame over a host copy of the frames (each frame read once,
       the frames all-gathered on NCCL as int32), bit-equal to that
       result, its sigma launches counted and its run timed; then
       make_rows_sigma_stack over a (1, 4) (frames, rows) mesh on the
       aligned frames cut to 4094 rows (a short last slab), bit-equal to
       one reject_stack of the whole frame and to reject_plain;
    b. make_sharded_sum_stack on 16 x 2048 x 2048 frames with shifts over
       4 shards, the partials all-reduced on NCCL, bit-equal to
       oracle.stack_sum; peaker_batch on phase 9c's 16 frames and
       global_align_batch on 8 of phase 10's layers, over 2 shards, each
       equal to its unsharded call.

Each stack of phases 6-7 runs once with every launch count set to 0: its
kernel must have launched, and the image and per-channel counters must be
bit-equal to the same y-shifted, normalized, x-shifted (F, P) data, built
here with other code, put through reject_and_mean (the masked formulation
of percentile, sigmedian and winsorized; masked_median for the median) in
blocks of 2^14 pixels (masked_reference).
A second, warm run gives its frames/s (a stack with normalization runs
once: its one run is timed). Each kernel's ms and its plain
version's ms are taken at its configuration's full shape (CUDA events,
median of 3 warm runs), beside its device-memory bound, the time of
torch.sort(dim=0) at that shape (a yardstick for the sort alone) and, for
the median, of torch.quantile(midpoint), the one PyTorch call that
computes the same function. The port calls neither.

The line before the last holds one JSON object describing each kernel;
the last line is {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "siril-0.9_tpu"))

DEVICE = "cuda"
SIZE, NFRAMES, SIG = 4096, 100, 3.0
#: pixels of each phase-3 case (cut from 65536 to leave phase 13 its time;
#: every case still plants over 300 degenerate columns)
CASE_P = 32768
CASE_FS = (3, 5, 12, 25, 64, 100, 256, 1000)
#: the kernels also run at the borders of their designs: the register
#: sorts of 32, 64 or 128 wires up to F = 128 (sigma, median, percentile,
#: sigmedian), winsorized's 32-slot chunks and mask words
BORDERED = ("sigma", "median", "percentile", "sigmedian", "winsorized")
BORDER_FS = (31, 32, 33, 63, 65, 127, 128, 129, 511, 512, 1024, 1025)
#: the device-memory scratch path: sigma past its shared-memory bound, the
#: others at F = 2000 with the shared memory a block may use set to 0
SCRATCH_CASES = (("sigma", 4000), ("median", 2000), ("percentile", 2000),
                 ("sigmedian", 2000), ("winsorized", 2000))
CONFIG2 = (50, 2048, 2048)   # frames, height, width
CONFIG3 = (1000, 480, 640)
#: side of the square central registration selection of phase 8 (config 3)
SEL3 = 256
#: phase 9: the ECC sequence, the star frames and their planted stars,
#: and the pixels of the linearfit stack held to the oracle beside its
#: knife-edge pixels
#: (the ECC sequence is cut from config 3's 1000 frames to 500: phase 13a
#: runs register_ecc on all 1000 of its film)
CONFIG_ECC = (500, 480, 640)
CONFIG_STARS = (16, 2048, 3072)
NSTARS = 500
STAR_DRIFT = 8
#: phase 10: BASELINE config 4 (frames, layers, height, width), the frames
#: of its run from disk, the planted rotation (degrees) and shift (px)
#: bounds, the channel gains, and the frames global_align_batch repeats
#: (cut from BASELINE's 100 frames to 50 to leave phase 13 its time)
CONFIG4 = (50, 3, 2048, 3072)
CONFIG4_DISK = 16
ROT4, SHIFT4 = 0.5, 8.0
GAINS4 = (1.0, 0.8, 0.6)
BATCH4 = 8
#: phase 11: BASELINE config 5 (frames, layers, height, width), its stars,
#: sky, noise, planted shift bound (px) and the sky gradient's slopes (a
#: fraction of 65535 across the width and across the height) (cut from
#: BASELINE's 12 frames to 4 to leave phase 13 its time)
CONFIG5 = (4, 3, 4096, 6144)
NSTARS5 = 400
SKY5, NOISE5, SHIFT5 = 800.0, 6.0, 5.0
GRAD5 = (0.04, 0.02)
#: phase 12: a scripted session of darks and lights (mono, BASELINE config 1's
#: frame size; cut from 16 darks and 32 lights to leave phase 13 its time)
CONFIG12 = (4, 8, 4096, 4096)
#: phase 13: the crops of the film's and the raw night's exports (square,
#: about the centre); the raw night (lights, height, width of a 24 MP
#: APS-C sensor) and its stars; the size of each native decoder's file
CROP13 = (256, 1024)
CONFIG13 = (12, 4000, 6000)
NSTARS13 = 500
NATIVE13 = (512, 768)
LF_SAMPLE = 2000
CHUNK = 1 << 20
#: pixels a call of the masked reference loops takes (masked_reference, at
#: the many frames of phases 3, 6 and 7): each loop runs until its slowest
#: pixel settles, so a small block keeps the many fast pixels from paying
#: for the few slow ones; the result is per pixel, the same in any blocking
REF_CHUNK = 1 << 14
REPS = 3
#: warm runs of the align kernel timed (a launch takes well under 1 ms)
ALIGN_REPS = 20
#: device-memory rate of one H100 SXM (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
#: least warps the winsorized kernel keeps resident per SM at F = 1000:
#: its wires form, 8 warps a block, 4 blocks while its 32-wire entry takes
#: at most 64 registers (57 with nvcc 12.8); fewer warps would leave the
#: latency of its shuffles and warp sums less to hide behind
MIN_WARPS_F1000 = 32
#: the winsorized kernel's entry at F = 1000 (32 wires a lane, H = 16), as
#: its mangled name holds it
WIRES_F1000 = "winsorized_wiresILi16E"
#: least warps the sigma kernel keeps resident per SM at F = 100: its team
#: form's 8-warp blocks, 3 to an SM while its entry takes at most 80
#: registers (78 with nvcc 12.8)
MIN_WARPS_SIGMA_F100 = 24
#: the sigma kernel's team entries (T lanes a pixel, H registers a lane),
#: as their mangled names hold them, and the one of F = 100 (T = 2, H = 32)
TEAM_ENTRIES = ("sigma_teamILi1ELi2E", "sigma_teamILi1ELi4E", "sigma_teamILi1ELi8E",
                "sigma_teamILi1ELi16E", "sigma_teamILi1ELi32E", "sigma_teamILi2ELi32E")
TEAM_F100 = "sigma_teamILi2ELi32E"
PALLAS = "siril-0.9_tpu/siriltpu/ops/pallas/reject_stack.py"
#: first line of each kernel's branch of _make_kernel
REPLACES = {"sigma": 797, "median": 255, "percentile": 271, "sigmedian": 297,
            "winsorized": 611}
#: what the align kernel replaces: XLA's align in the JAX package
ALIGN_REPLACES = "siril-0.9_tpu/siriltpu/pipelines/register_stack.py:_align_frames_auto_impl"
#: (siglow, sighigh) of each kernel's full-size run; percentile takes
#: (plow, phigh)
SIGS = {"sigma": (SIG, SIG), "median": (0.0, 0.0), "percentile": (0.2, 0.1),
        "sigmedian": (3.0, 3.0), "winsorized": (3.0, 3.0)}
#: sigma of the phase-3 cases by frame count (small F clips harder)
CASE_SIG = {3: 2.0, 5: 1.5, 7: 2.0, 12: 2.5, 25: 2.5}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def make_case(f: int, p: int, degen_every: int, seed: int) -> np.ndarray:
    """(F, P) uint16 noise around 1000 with cold (0) and hot (60000)
    outliers, real 65535 values, and geomspace columns every
    ``degen_every`` pixels that end on the degenerate path."""
    rng = np.random.default_rng(seed)
    v = np.clip(rng.normal(1000, 30, size=(f, p)), 0, 65535).astype(np.uint16)
    v[rng.integers(0, f, p // 8), rng.integers(0, p, p // 8)] = 0
    v[rng.integers(0, f, p // 8), rng.integers(0, p, p // 8)] = 60000
    v[: min(2, f), ::13] = 65535
    v[:, ::degen_every] = np.geomspace(1, 65535, f).astype(np.uint16)[:, None]
    return v


def make_frames(f: int, h: int, w: int, seed: int, dev, outliers: int = 1000):
    """(F, 1, H, W) uint16 sky made on the card from ``seed``: a background
    near 1000 with a per-frame level in [-40, 40], 300 point sources, each
    frame drifted by a shift in [-20, 20] with zero fill, fresh noise, and
    cold (0) and hot (60000) outliers in one of every ``outliers`` of each
    frame's pixels each (0.1% by default, none for 0). Returns the frames and the
    (F, 2) int32 registration shifts (shiftx, shifty) that undo the drift."""
    import torch
    from siriltpu_torch.ops.shift import shift_into
    from siriltpu_torch.utils.interop import i32_to_u16

    rng = np.random.default_rng(seed)
    drift = rng.integers(-20, 21, (f, 2))
    drift[0] = 0
    level = rng.integers(-40, 41, f)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    kw = dict(generator=g, device=dev)
    base = 1000.0 + 15.0 * torch.randn((h, w), **kw)
    npts = 300
    ys = torch.randint(0, h, (npts,), **kw)
    xs = torch.randint(0, w, (npts,), **kw)
    base.index_put_((ys, xs), 3000.0 + 37000.0 * torch.rand((npts,), **kw),
                    accumulate=True)
    frames = torch.empty((f, h * w), dtype=torch.int16, device=dev)
    shifted = torch.empty_like(base)
    nout = h * w // outliers if outliers else 0
    for i in range(f):
        shifted.zero_()
        shift_into(shifted, base, int(drift[i, 0]), int(drift[i, 1]))
        noisy = shifted + float(level[i]) + 10.0 * torch.randn((h, w), **kw)
        frames[i] = i32_to_u16(torch.clamp(noisy, 0, 65535)).view(torch.int16).reshape(-1)
        for value in (0, 60000):
            idx = torch.randint(0, h * w, (nout,), **kw)
            frames[i, idx] = int(np.uint16(value).view(np.int16))
    return frames.view(torch.uint16).reshape(f, 1, h, w), (-drift).astype(np.int32)


def max_abs_diff(got, want) -> int:
    import torch
    from siriltpu_torch.utils.interop import u16_to_i32

    def wide(x):
        return (u16_to_i32(x) if x.dtype == torch.uint16 else x).to(torch.int64)
    return int((wide(got) - wide(want)).abs().max())


def masked_reference(vals, rejection: str, sig):
    """reject_and_mean of (F, P) values, REF_CHUNK pixels a call: the masked
    formulation (the JAX package's) of percentile, sigmedian and winsorized,
    the hybrid of sigma. Returns the mean and both counters, each (P,)."""
    import torch
    from siriltpu_torch.ops.rejection import reject_and_mean

    parts = [reject_and_mean(vals[:, a:a + REF_CHUNK], rejection, sig)
             for a in range(0, vals.shape[1], REF_CHUNK)]
    mean = torch.cat([p[0].view(torch.int16) for p in parts]).view(torch.uint16)
    return (mean, torch.cat([p[1] for p in parts]), torch.cat([p[2] for p in parts]))


def cuda_ms(fn, reps: int = REPS):
    """Median device time of ``fn()`` over ``reps`` warm runs, by CUDA
    events around each run, and the last run's result."""
    import torch
    out = fn()  # warm-up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), out


def chunked(fn, flat):
    """A function that runs ``fn`` on ``flat``'s 2^20-pixel chunks."""
    def run():
        for a in range(0, flat.shape[1], CHUNK):
            fn(flat[:, a:a + CHUNK])
    return run


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def hbm_bound(f: int, p: int):
    """The bytes a rejection kernel must move at (F, P), each input value
    read once and each output (a uint16 mean and three int32) written once,
    and their time at the card's device-memory rate in ms."""
    nbytes = 2 * f * p + 14 * p
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


class Record:
    """Per kernel: the launches of the main paths, the largest difference
    from its plain version, its and the plain version's ms, its bound and
    the ms of one PyTorch call that computes the same function (None where
    there is none)."""

    def __init__(self, names):
        self.launches = dict.fromkeys(names, 0)
        self.err = dict.fromkeys(names, 0)
        self.ms = {}
        self.bound = {}
        self.library = dict.fromkeys(names)
        #: the align kernel: launches of the main paths, words that differ
        #: from align_frames_slice, and at the planetary shape (phase 7)
        #: its ms, align_frames_slice's ms and its bound
        self.align = {"launches": 0, "err": 0}
        #: per kernel, the form, registers and resident warps of its launch
        #: at the shape it is timed at, where reported
        self.plan = {}

    def check(self, name: str, errs, what: str):
        self.err[name] = max(self.err[name], *errs)
        if any(errs):
            fail(f"{what}: max|diff| {errs}")

    def count(self, launches: dict, paths: str, kernel: str):
        """Add a main path's launch counts; its kernel must have run."""
        for k, n in launches.items():
            self.launches[k] += n
        if launches[kernel] < 1:
            fail(f"{paths} did not launch the {kernel} kernel")


def entry_registers(log) -> dict:
    """Registers of each kernel entry, by its mangled name, as ptxas
    reports them in ``log`` (its lines)."""
    regs, entry = {}, None
    for line in log:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            regs[entry] = int(m.group(1))
            entry = None
    return regs


def reset_counts() -> None:
    """Set the program's counters (``utils.timing``) to 0."""
    from siriltpu_torch.utils import timing
    timing.reset()


def counted(name: str):
    """One of the program's counters, counted since ``reset_counts``."""
    from siriltpu_torch.utils import timing
    return timing.counters().get(name, 0)


def kernel_launches() -> dict:
    """Each rejection kernel's launches since ``reset_counts``."""
    from siriltpu_torch.utils.build import KERNELS
    return {k: counted(f"reject.launches.{k}") for k in KERNELS}


@contextlib.contextmanager
def stage_seconds():
    """The program's spans on around a block: the dict it yields holds,
    once the block has ended, each stage's host seconds by span name."""
    from siriltpu_torch.utils import timing
    seconds = {}
    timing.collect()
    timing.enable()
    try:
        yield seconds
    finally:
        timing.disable()
        seconds.update(timing.totals(timing.collect()))


def sort_yardstick(flat):
    """The time of torch.sort(dim=0) on (F, P) uint16 values, and the dtype
    it sorted them as."""
    import torch
    from siriltpu_torch.utils.interop import u16_to_i32

    try:
        sort_ms, _ = cuda_ms(lambda: torch.sort(flat, dim=0))
        sorted_as = "uint16"
    except (RuntimeError, NotImplementedError):
        wide = u16_to_i32(flat)
        sort_ms, _ = cuda_ms(lambda: torch.sort(wide, dim=0))
        sorted_as = "int32 (no uint16 sort on this card)"
        del wide
    torch.cuda.empty_cache()
    return sort_ms, sorted_as


def yardsticks(rec, card, kernel: str, flat):
    """The kernel's device-memory bound at the full shape of its path, the
    time of torch.sort(vals, dim=0) at that shape (a yardstick for the sort
    phase only), and for the median the time of the one PyTorch call that
    computes the same function. The port calls neither."""
    import torch
    from siriltpu_torch.utils.interop import u16_to_i32

    f, p = flat.shape
    nbytes, bound = hbm_bound(f, p)
    rec.bound[kernel] = bound
    sort_ms, sorted_as = sort_yardstick(flat)
    print(f"yardstick [{card}] {kernel} at {f}x{p}: bound {bound:.4f} ms "
          f"({nbytes} bytes at {HBM_BYTES_PER_S:.3g} B/s); torch.sort(dim=0) "
          f"of the {sorted_as} values {sort_ms:.3f} ms", flush=True)
    if kernel == "median":
        x = u16_to_i32(flat).to(torch.float32)
        lib_ms, _ = cuda_ms(lambda: torch.quantile(x, 0.5, dim=0,
                                                   interpolation="midpoint"))
        del x
        torch.cuda.empty_cache()
        rec.library[kernel] = lib_ms
        print(f"yardstick [{card}] median: torch.quantile(midpoint) of the "
              f"float32 values {lib_ms:.3f} ms", flush=True)


def phase3(rs, rec, dev):
    import torch
    from siriltpu_torch.ops.rejection import masked_median
    from siriltpu_torch.utils.build import KERNELS
    from siriltpu_torch.utils.interop import frames_from_numpy

    cases = [(r, f, CASE_P) for r in KERNELS
             for f in sorted(set(CASE_FS) | ({7} if r == "sigma" else set())
                             | (set(BORDER_FS) if r in BORDERED else set()))]
    cases += [(r, f, CASE_P) for r, f in SCRATCH_CASES]
    smem_limit = rs.SMEM_LIMIT
    for rej, f, p in cases:
        sig = CASE_SIG.get(f, 3.0)
        lo, hi = (0.2, 0.1) if rej == "percentile" else (sig, sig)
        vals = frames_from_numpy(make_case(f, p, 3 if f == 25 else 97, seed=f), dev)
        if (rej, f) in SCRATCH_CASES:
            rs.SMEM_LIMIT = 0
        plan = rs.launch_plan(rej, f, p)
        if plan.scratch != ((rej, f) in SCRATCH_CASES):
            fail(f"{rej} at F={f}: scratch path {plan.scratch}")
        teams = counted("reject.form.sigma.team")
        got = rs.reject_cuda(vals, rej, lo, hi)
        torch.cuda.synchronize()
        if rej == "sigma" and f <= 128 and not plan.scratch and (
                plan.form != "team" or counted("reject.form.sigma.team") != teams + 1):
            fail(f"sigma at F={f}: form {plan.form}, not the team form")
        want = rs.reject_plain(vals, rej, lo, hi)
        torch.cuda.synchronize()
        errs = [max_abs_diff(g, w) for g, w in zip(got, want)]
        # the dispatcher makes no host sync: any would raise here
        torch.cuda.set_sync_debug_mode("error")
        try:
            fin = rs.reject_stack(vals, rej, lo, hi, with_counters=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            rs.SMEM_LIMIT = smem_limit
        torch.cuda.synchronize()
        ref = ((masked_median(vals),) if rej == "median"
               else masked_reference(vals, rej, (lo, hi)))
        torch.cuda.synchronize()
        ferrs = [max_abs_diff(g, w) for g, w in zip(fin, ref)]
        print(f"phase3 {rej} F={f} P={p} sig=({lo}, {hi}) "
              f"{'scratch' if plan.scratch else f'smem={plan.smem}'} "
              f"degenerate={int(got[1].sum())} "
              f"kernel-vs-plain max|diff| mean/degen/rejl/rejh={errs} "
              f"final-vs-reject_and_mean={ferrs}", flush=True)
        rec.check(rej, errs + ferrs, f"{rej} kernel at F={f}")


def phase4_5(rs, rec, dev, card):
    import torch
    from siriltpu_torch.ops.quality import quality_estimate_batch
    from siriltpu_torch.ops.rejection import reject_and_mean
    from siriltpu_torch.pipelines import register_stack as prs
    from siriltpu_torch.utils.interop import shifts_to_numpy

    bench = prs.RegisterStackBench(size=SIZE, nframes=NFRAMES, seed=0, device=dev)
    t0 = time.perf_counter()
    frames = bench.frames()
    torch.cuda.synchronize()
    print(f"phase4 frames {tuple(frames.shape)} {frames.dtype} made on the card "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    reset_counts()
    stacked, (sx, sy), quality = prs.register_and_stack(
        frames, sel=bench.sel, sig=(SIG, SIG), return_device=True)
    torch.cuda.synchronize()
    launches = kernel_launches()
    rec.count(launches, "register_and_stack", "sigma")
    if counted("reject.form.sigma.team") != 1:
        fail("phase4 register_and_stack did not stack in the sigma team form")
    align_launched(rec, "phase4 register_and_stack")
    if not np.array_equal(shifts_to_numpy(sx, sy), -bench.shifts):
        fail("recovered shifts differ from the negated generated ones")
    if tuple(stacked.shape) != (SIZE, SIZE) or stacked.dtype != torch.uint16:
        fail(f"stacked image {tuple(stacked.shape)} {stacked.dtype}")
    if quality.shape != (NFRAMES,) or not bool(torch.isfinite(quality).all()):
        fail("quality is not finite of shape (F,)")
    # the plain reference aligns with align_frames_slice (the main path
    # used the align kernel) and stacks in 2^20-pixel chunks
    flat = prs.align_frames_slice(frames, sx, sy).reshape(NFRAMES, -1)
    kmean, krejl, krejh = rs.reject_stack(flat, "sigma", SIG, SIG, with_counters=True)
    torch.cuda.synchronize()
    errs = [max_abs_diff(kmean, stacked.reshape(-1))]
    for a in range(0, flat.shape[1], CHUNK):
        pm, pl, ph = reject_and_mean(flat[:, a:a + CHUNK], "sigma", (SIG, SIG))
        errs += [max_abs_diff(kmean[a:a + CHUNK], pm),
                 max_abs_diff(krejl[a:a + CHUNK], pl),
                 max_abs_diff(krejh[a:a + CHUNK], ph)]
    ndeg = int(rs.reject_cuda(flat, "sigma", SIG, SIG)[1].sum())
    torch.cuda.synchronize()
    print(f"phase4 main path {NFRAMES}x{SIZE}x{SIZE}: shifts exact, "
          f"kernel launches={launches}, degenerate pixels={ndeg}, "
          f"rejected low={int(krejl.sum())} high={int(krejh.sum())}, "
          f"stacked+counters vs plain max|diff|={max(errs)}", flush=True)
    rec.check("sigma", errs, "register_and_stack vs the plain version")
    del kmean, krejl, krejh

    # ---- 5. timing
    t0 = time.perf_counter()
    for _ in range(REPS):
        prs.register_and_stack(frames, sel=bench.sel, sig=(SIG, SIG),
                               return_device=True)
    torch.cuda.synchronize()
    fps = NFRAMES * REPS / (time.perf_counter() - t0)
    sel_frames = prs._selection(frames, bench.sel)
    ms = {}
    ms["shifts"], (sx, sy) = cuda_ms(lambda: prs.compute_shifts(frames, 0, bench.sel))
    ms["quality"], _ = cuda_ms(lambda: quality_estimate_batch(sel_frames))
    ms["align"], aligned = cuda_ms(lambda: prs.align_frames_auto(frames, sx, sy))
    flat = aligned.reshape(NFRAMES, -1)
    ms["kernel"], _ = cuda_ms(lambda: rs.reject_cuda(flat, "sigma", SIG, SIG))
    # the kernel's plain version, and the whole stack stage's (with the
    # exact re-run of degenerate pixels), in 2^20-pixel chunks
    ms["plain_kernel"], _ = cuda_ms(chunked(
        lambda v: rs.reject_plain(v, "sigma", SIG, SIG), flat))
    ms["plain_stack"], _ = cuda_ms(chunked(
        lambda v: reject_and_mean(v, "sigma", (SIG, SIG)), flat))
    print(f"timing [{card}] register+stack {NFRAMES}x{SIZE}x{SIZE}: "
          f"{fps:.3f} frames/s end to end (mean of {REPS} warm runs); "
          + " ".join(f"{k}_ms={v:.3f}" for k, v in ms.items()), flush=True)
    rec.ms["sigma"] = (ms["kernel"], ms["plain_kernel"])
    yardsticks(rec, card, "sigma", flat)
    del aligned, flat
    torch.cuda.empty_cache()
    align_timing(rec, card, "phase5", frames, sx, sy)


def align_launched(rec, what: str):
    """A main path since ``reset_counts`` must have made exactly one align
    launch; it adds to the kernel's launches."""
    n = counted("align.launches")
    if n != 1:
        fail(f"{what} made {n} align launches, not 1")
    rec.align["launches"] += n


def launch_ms(fn, n: int = ALIGN_REPS, groups: int = REPS):
    """Device ms of one ``fn()`` launched back to back: one launch queued
    first, then ``n`` launches between one pair of CUDA events, so the host's
    time to launch hides behind the card's work; the median of ``groups``."""
    import torch
    times = []
    for _ in range(groups):
        fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def align_timing(rec, card, label: str, frames, sx, sy):
    """The align kernel on (F, H, W) frames and their shifts on the card:
    word-equal to align_frames_slice, its plain version; its device ms a
    launch (back to back) beside its bound and beside the bytes these
    shifts need, the ms of one call (CUDA events around it from an idle
    card, so the wrapper's host time is in it), and the ms of
    align_frames_slice. Returns the kernel's ms, the slice's ms and the
    bound's ms."""
    import torch
    from siriltpu_torch.ops.cuda.align_shift import align_shift
    from siriltpu_torch.pipelines import register_stack as prs

    f, h, w = frames.shape
    ms = {}
    ms["kernel"] = launch_ms(lambda: align_shift(frames, sx, sy))
    ms["call"], got = cuda_ms(lambda: align_shift(frames, sx, sy), reps=ALIGN_REPS)
    ms["slice"], want = cuda_ms(lambda: prs.align_frames_slice(frames, sx, sy))
    err = int((got.view(torch.int16) != want.view(torch.int16)).sum())
    rec.align["err"] = max(rec.align["err"], err)
    del got, want
    torch.cuda.empty_cache()
    nbytes = 4 * f * h * w
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    # the words a frame's shift leaves inside it are read once, every word
    # is written once: the bound counts the zero fill as read too
    cx = np.clip(np.abs(sx.cpu().numpy().astype(np.int64)), 0, w)
    cy = np.clip(np.abs(sy.cpu().numpy().astype(np.int64)), 0, h)
    needed = 2 * f * h * w + 2 * int(((h - cy) * (w - cx)).sum())
    print(f"{label} align_shift [{card}] {f}x{h}x{w}: kernel vs "
          f"align_frames_slice words that differ={err}; kernel_ms={ms['kernel']:.4f} "
          f"a launch back to back, bound {bound:.4f} ms ({nbytes} bytes at "
          f"{HBM_BYTES_PER_S:.3g} B/s, {100 * bound / ms['kernel']:.1f}% of it; "
          f"these shifts need {needed} bytes, "
          f"{100 * needed / nbytes * bound / ms['kernel']:.1f}%); one call_ms="
          f"{ms['call']:.4f}; plain slice_ms={ms['slice']:.3f}", flush=True)
    if err:
        fail(f"{label}: the align kernel differs from align_frames_slice")
    return ms["kernel"], ms["slice"], bound


def phase7_align(rs, rec, card, frames, shifts):
    """The planetary shape through the main path: register_and_stack
    (winsorized (3, 3), the cell's centred 256 selection) makes one align
    launch and equals the winsorized kernel over align_frames_slice of its
    shifts; then the align kernel's timing at this shape."""
    import torch
    from siriltpu_torch.pipelines import register_stack as prs

    f, h, w = frames.shape
    sel = ((w - SEL3) // 2, (h - SEL3) // 2, SEL3)
    reset_counts()
    stacked, (sx, sy), _ = prs.register_and_stack(
        frames, sel=sel, rejection="winsorized", sig=(3.0, 3.0),
        return_device=True)
    torch.cuda.synchronize()
    align_launched(rec, "phase7 register_and_stack")
    rec.count(kernel_launches(), "phase7 register_and_stack", "winsorized")
    if counted("reject.form.winsorized.wires") != 1:
        fail("phase7 register_and_stack did not stack in the winsorized wires form")
    want = rs.reject_stack(prs.align_frames_slice(frames, sx, sy).reshape(f, -1),
                           "winsorized", 3.0, 3.0)
    err = max_abs_diff(stacked.reshape(-1), want)
    print(f"phase7 register_and_stack [{card}] {f}x{h}x{w} winsorized (3, 3): "
          f"align launches={counted('align.launches')}, winsorized launches in the "
          f"wires form={counted('reject.form.winsorized.wires')}; stack vs winsorized "
          f"kernel over align_frames_slice max|diff|={err}", flush=True)
    rec.check("winsorized", [err], "phase7 register_and_stack")
    del stacked, want
    torch.cuda.empty_cache()
    k_ms, s_ms, bound = align_timing(
        rec, card, "phase7", frames,
        *(torch.from_numpy(shifts[:, i].copy()).to(frames.device) for i in (0, 1)))
    rec.align.update(shape=[f, h, w], ms=k_ms, plain_ms=s_ms, bound_ms=bound)


def reference_flat(frames, shifts, method: str, coeffs):
    """The (F, H * W) uint16 values a stack_frames run puts through its
    kernel, built with other code than its block loop: the y-shift with
    zero fill, the additive normalization of every value (y fill
    included) by ``coeffs`` = (offset, mul, scale) unless it is None, then
    the x-shift with zero fill (stacking.c:1546-1651). The median stack
    applies no shift."""
    import torch
    from siriltpu_torch.pipelines.register_stack import align_frames_slice
    from siriltpu_torch.utils.interop import i32_to_u16, u16_to_i32
    from siriltpu_torch.utils.rounding import round_to_word_f

    f = frames.shape[0]
    dev = frames.device
    zero = torch.zeros(f, dtype=torch.int64, device=dev)
    sx, sy = (torch.from_numpy(shifts[:, k].astype(np.int64)).to(dev) for k in (0, 1))
    if method == "median":
        sx = sy = zero
    vals = align_frames_slice(frames[:, 0], zero, sy)
    if coeffs is not None:
        off, _, scale = (torch.tensor(c, dtype=torch.float32, device=dev)[:, None, None]
                         for c in coeffs)
        x = round_to_word_f(u16_to_i32(vals).to(torch.float32) * scale - off)
        vals = i32_to_u16(x.to(torch.int32))
    return align_frames_slice(vals, sx, zero).reshape(f, -1)


def exact_cost(rs, card, label, kernel, sig, flat, loop_s):
    """What the degenerate pixels' exact re-run costs inside the kernel:
    its time on ``flat`` less its time on a copy whose degenerate columns
    are replaced by a column that is not degenerate; and that difference's
    share of the block loop's ``loop_s``."""
    import torch

    degen = rs.reject_cuda(flat, kernel, *sig)[1].bool()
    idx = torch.nonzero(degen).flatten()
    good = int(torch.nonzero(~degen).flatten()[0])
    clean = flat.clone()
    clean.view(torch.int16)[:, idx] = flat.view(torch.int16)[:, good:good + 1]
    left = int(rs.reject_cuda(clean, kernel, *sig)[1].sum())
    with_ms, _ = cuda_ms(lambda: rs.reject_cuda(flat, kernel, *sig))
    without_ms, _ = cuda_ms(lambda: rs.reject_cuda(clean, kernel, *sig))
    cost = with_ms - without_ms
    print(f"{label} fix-up of {idx.numel()} degenerate pixels, inside the "
          f"{kernel} kernel: {cost:.3f} ms ({with_ms:.3f} ms with them, "
          f"{without_ms:.3f} ms with their columns replaced, {left} left "
          f"degenerate), {100 * cost / (1e3 * loop_s):.3f}% of the block loop "
          f"[{card}]", flush=True)


def first_pass_cost(rs, rec, card, flat, k_ms):
    """The sigmedian kernel at sigmas of 50, where no pixel flags: the
    sort and its first pass alone. The difference to its time at (3, 3),
    k_ms, is what the pixels that flag cost: the merge and the later
    passes, while the other lanes of their warps wait."""
    import torch

    sig = (50.0, 50.0)
    got = rs.reject_cuda(flat, "sigmedian", *sig)
    want = rs.reject_plain(flat, "sigmedian", *sig)
    torch.cuda.synchronize()
    rec.check("sigmedian", [max_abs_diff(g, w) for g, w in zip(got, want)],
              f"sigmedian at sigmas {sig}")
    nflag = int(got[2].sum()) + int(got[3].sum())
    ms, _ = cuda_ms(lambda: rs.reject_cuda(flat, "sigmedian", *sig))
    print(f"timing [{card}] sigmedian kernel at {'x'.join(map(str, flat.shape))}, "
          f"sigmas {sig} ({nflag} values flagged): {ms:.3f} ms, the first pass "
          f"alone; the pixels that flag at (3.0, 3.0) add {k_ms - ms:.3f} ms "
          f"(median of {REPS} warm runs)", flush=True)


def stack_config(rs, rec, dev, card, label, frames, shifts, method, rejection,
                 normalize):
    """One stack_frames run of a configuration, held to the plain version;
    then a warm run for its frames/s, and its kernel's time at this shape."""
    import torch
    from siriltpu_torch.ops.rejection import masked_median
    from siriltpu_torch.stacking.api import (compute_normalization, ikss_stats,
                                             stack_frames)
    from siriltpu_torch.utils.interop import frames_from_numpy

    f, c, h, w = frames.shape
    kernel = "median" if method == "median" else rejection
    sig = SIGS[kernel]
    kw = dict(device=dev, method=method, shifts=shifts, rejection=rejection,
              sig=sig, normalize=normalize)
    reset_counts()
    t0 = time.perf_counter()
    res = stack_frames(frames, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = kernel_launches()
    name = f"stack_frames({method}" + (
        f", {rejection} {sig}" if method == "mean" else "") + f", normalize={normalize})"
    rec.count(launches, name, kernel)
    if res.data.shape != (c, h, w) or res.data.dtype != np.uint16:
        fail(f"{name}: result {res.data.shape} {res.data.dtype}")
    coeffs, norm = None, ""
    if normalize != "none":
        if not normalize.startswith("additive"):
            fail(f"no reference for normalization {normalize}")
        t0 = time.perf_counter()
        coeffs = compute_normalization(ikss_stats(frames), 0, normalize)
        norm = f"; its normalization alone {time.perf_counter() - t0:.3f} s"
    flat = reference_flat(frames, shifts, method, coeffs)
    got = frames_from_numpy(res.data[0], dev).reshape(-1)
    errs, rl, rh = [], 0, 0
    for a in range(0, flat.shape[1], CHUNK):
        v = flat[:, a:a + CHUNK]
        if method == "median":
            errs.append(max_abs_diff(got[a:a + CHUNK], masked_median(v)))
            continue
        pm, pl, ph = masked_reference(v, rejection, sig)
        errs.append(max_abs_diff(got[a:a + CHUNK], pm))
        rl += int(pl.sum())
        rh += int(ph.sum())
    errs += [abs(int(res.rejection_low[0]) - rl), abs(int(res.rejection_high[0]) - rh)]
    ndeg = int(rs.reject_cuda(flat, kernel, *sig)[1].sum())
    torch.cuda.synchronize()
    if coeffs is None:
        t0 = time.perf_counter()
        stack_frames(frames, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    print(f"{label} {name} {f}x{c}x{h}x{w}: launches={launches}, degenerate "
          f"pixels={ndeg}, rejected low={int(res.rejection_low[0])} "
          f"high={int(res.rejection_high[0])}, image+counters vs plain "
          f"max|diff|={max(errs)}; {'its one' if coeffs is not None else 'warm'} "
          f"run {sec:.3f} s, {f / sec:.3f} frames/s{norm} [{card}]", flush=True)
    rec.check(kernel, errs, f"{name} vs the plain version")
    if coeffs is not None:
        # the stack stage alone: the block loop with the coefficients given
        t0 = time.perf_counter()
        stack_frames(frames, coeffs=coeffs, **kw)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        print(f"{label} block loop (stack_frames with its coefficients given) "
              f"{loop_s:.3f} s [{card}]", flush=True)
        if ndeg:
            exact_cost(rs, card, label, kernel, sig, flat, loop_s)
    k_ms, _ = cuda_ms(lambda: rs.reject_cuda(flat, kernel, *sig))
    if kernel in rec.ms:
        # sigma's own row is the north star's; this shape is the one of the
        # percentile and sigmedian kernels, and the kernels line carries it
        # beside its bound
        _, bound = hbm_bound(f, h * w)
        rec.plan.setdefault(kernel, {}).update(
            {f"ms_f{f}": k_ms, f"bound_ms_f{f}": bound})
        print(f"timing [{card}] {kernel} kernel at {f}x{h * w}: {k_ms:.3f} ms, "
              f"bound {bound:.4f} ms (median of {REPS} warm runs)", flush=True)
    else:
        p_ms, _ = cuda_ms(chunked(lambda v: rs.reject_plain(v, kernel, *sig), flat))
        rec.ms[kernel] = (k_ms, p_ms)
        print(f"timing [{card}] {kernel} kernel at {f}x{h * w}: {k_ms:.3f} ms, "
              f"plain version {p_ms:.3f} ms (median of {REPS} warm runs)", flush=True)
        yardsticks(rec, card, kernel, flat)
    if kernel == "sigmedian":
        first_pass_cost(rs, rec, card, flat, k_ms)
    return res


class Clock:
    """Seconds spent inside wrapped calls, on the main thread and (summed
    over them) on other threads."""

    def __init__(self):
        self.main = self.others = 0.0
        self.lock = threading.Lock()

    def wrap(self, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                with self.lock:
                    if threading.current_thread() is threading.main_thread():
                        self.main += dt
                    else:
                        self.others += dt
        return timed

    def take(self):
        got = self.main, self.others
        self.main = self.others = 0.0
        return got


def write_ser(path: str, frames) -> float:
    """Write (F, 1, H, W) uint16 frames on the card as a mono 16-bit SER
    file; returns the seconds it took."""
    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.io.ser import SerFile
    from siriltpu_torch.utils.interop import u16_to_numpy

    t0 = time.perf_counter()
    host = u16_to_numpy(frames)
    ser = SerFile.create(path, host.shape[3], host.shape[2])
    for fr in host:
        ser.write_frame(Frame(fr))
    ser.write_and_close()
    return time.perf_counter() - t0


def check_seqfile(seq, directory: str, label: str):
    """The sequence's .seq file reads back with the same frames, shifts,
    qualities and cached statistics (as %g prints them)."""
    from siriltpu_torch.io.seqfile import read_seqfile, write_seqfile

    def printed(x):
        return float(f"{x:g}")

    back = read_seqfile(write_seqfile(seq, directory))
    if (back.number, back.selnum, back.seqtype) != (seq.number, seq.selnum, seq.seqtype):
        fail(f"{label}: the .seq file reads back as another sequence")
    if not np.array_equal(back.reg_shifts(0), seq.reg_shifts(0)):
        fail(f"{label}: the .seq file reads back with other shifts")
    # a selection with no pixel over the estimate's threshold has quality NaN
    if not np.array_equal([printed(r.quality) for r in seq.regparam[0]],
                          [r.quality for r in back.regparam[0]], equal_nan=True):
        fail(f"{label}: the .seq file reads back with other qualities")
    nstats = 0
    for a, b in zip(seq.imgparam, back.imgparam):
        if (a.stats is None) != (b.stats is None) or a.incl != b.incl:
            fail(f"{label}: the .seq file reads back with other image data")
        if a.stats is not None:
            nstats += 1
            for key in ("mean", "median", "sigma", "avgdev", "mad", "sqrtbwmv",
                        "location", "scale", "min", "max"):
                if printed(getattr(a.stats, key)) != getattr(b.stats, key):
                    fail(f"{label}: the .seq file reads back with other {key}")
    nfinite = int(np.isfinite([r.quality for r in seq.regparam[0]]).sum())
    print(f"{label} .seq file: {seq.number} frames, their shifts and qualities "
          f"({nfinite} finite) and {nstats} cached statistics read back equal",
          flush=True)


def sequence_config(rs, rec, dev, card, label, tmp, frames, shifts, side, stacks):
    """One configuration from a SER file: ``frames`` written to disk, then,
    once with the frames read whole and once streamed, the file opened,
    registered on a central ``side`` x ``side`` selection (``side`` None:
    opened through a .seq file that holds ``shifts`` instead) and put
    through each of ``stacks``: (method, rejection, normalize, the
    stack_frames result it must equal). Returns the last sequence and
    result."""
    import torch
    from siriltpu_torch.core.frame import Rect
    from siriltpu_torch.io.seqfile import read_seqfile, write_seqfile
    from siriltpu_torch.io.sequence import ser_sequence
    from siriltpu_torch.registration.translation import register_shift_dft
    from siriltpu_torch.stacking import api

    f, _, h, w = frames.shape
    path = os.path.join(tmp, label.replace(" ", "_") + ".ser")
    wrote = write_ser(path, frames)
    print(f"{label} {f}x{h}x{w} written as {path} ({os.path.getsize(path)} bytes) "
          f"in {wrote:.3f} s", flush=True)
    if side is None:
        seq = ser_sequence(path)
        for r, (sx, sy) in zip(seq.ensure_regparam(0), shifts):
            r.shiftx, r.shifty = int(sx), int(sy)
        seqfile = write_seqfile(seq, tmp)
        how = "shifts read from its .seq file"
    else:
        sel = Rect((w - side) // 2, (h - side) // 2, side, side)
        how = "shifts exact"
    reads = Clock()
    for stream in (False, True):
        t0 = time.perf_counter()
        seq = ser_sequence(path) if side is not None else read_seqfile(seqfile)
        seq.read_frame = reads.wrap(seq.read_frame)
        seq.read_frame_part = reads.wrap(seq.read_frame_part)
        if side is not None:
            register_shift_dft(seq, 0, sel, device=dev)
        reg_s = time.perf_counter() - t0
        reg_reads, _ = reads.take()
        if not np.array_equal(seq.reg_shifts(0), shifts):
            fail(f"{label}: recovered shifts differ from the generated ones")
        for method, rejection, normalize, want in stacks:
            kernel = "median" if method == "median" else rejection
            reset_counts()
            with stage_seconds() as stages:
                t0 = time.perf_counter()
                res = api.stack_sequence(seq, device=dev, method=method,
                                         rejection=rejection, sig=SIGS[kernel],
                                         normalize=normalize, stream=stream)
                stack_s = time.perf_counter() - t0
            name = (f"stack_sequence({method}, {rejection}, {normalize}, "
                    f"stream={stream})")
            rec.count(kernel_launches(), name, kernel)
            errs = [int(np.abs(res.data.astype(np.int64) - want.data).max()),
                    int(np.abs(res.rejection_low - want.rejection_low).max()),
                    int(np.abs(res.rejection_high - want.rejection_high).max())]
            rec.check(kernel, errs, f"{label} {name} vs stack_frames")
            read_main, read_others = reads.take()
            norm_s = stages.get('stack.normalize', 0.0)
            waited = (f", the main thread waited {stages.get('stack.wait', 0.0):.3f} s "
                      f"for the reader over {counted('stack.blocks')} blocks"
                      if stream else "")
            print(f"{label} {name}: {how}, launches={kernel_launches()}, "
                  f"image+counters vs stack_frames max|diff|={max(errs)}; "
                  f"{f / (reg_s + stack_s):.3f} frames/s from the open of the file "
                  f"(one run, host clock): open and registration {reg_s:.3f} s (file reads "
                  f"{reg_reads:.3f}), stack {stack_s:.3f} s (normalization "
                  f"{norm_s:.3f}, its and the stack's file reads on the main "
                  f"thread {read_main:.3f} and summed over other threads "
                  f"{read_others:.3f}, the rest "
                  f"{stack_s - norm_s - (0.0 if stream else read_main):.3f})"
                  f"{waited} [{card}]", flush=True)
    os.unlink(path)
    torch.cuda.empty_cache()
    return seq, res


def phase8(rs, rec, dev, card, config2, config3):
    """The sequence path: each configuration is (frames, shifts, stacks)."""
    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.io.fits import read_fits, write_fits

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        seq, res = sequence_config(rs, rec, dev, card, "phase8 config3", tmp,
                                   *config3[:2], SEL3, config3[2])
        check_seqfile(seq, tmp, "phase8 config3")
        out = os.path.join(tmp, "stack.fit")
        write_fits(out, Frame(res.data))
        if not np.array_equal(read_fits(out).data, res.data):
            fail("phase8: the stack written by write_fits reads back different")
        print(f"phase8 config3 stack written as FITS ({os.path.getsize(out)} "
              f"bytes) reads back equal", flush=True)
        sequence_config(rs, rec, dev, card, "phase8 config2", tmp,
                        *config2[:2], None, config2[2])


def oracle_words(cols: np.ndarray, sig):
    """verify/oracle.py:c_reject_block's linearfit on every column of a
    (F, K) uint16 array: (mean, rejlow, rejhigh) int64 arrays, the mean
    the survivors' rounded to a WORD."""
    from siriltpu_torch.utils.rounding import np_round_to_word
    from siriltpu_torch.verify.oracle import c_reject_block

    out = np.zeros((3, cols.shape[1]), np.int64)
    for j in range(cols.shape[1]):
        surv, rej = c_reject_block(cols[:, j], "linearfit", sig)
        mean = surv.astype(np.float64).sum() / surv.size if surv.size else 0.0
        out[:, j] = int(np_round_to_word(mean)), rej[0], rej[1]
    return out


def phase9a(dev, card):
    """linearfit on config 2: stack_frames against reject_linearfit in
    chunks plus the NumPy oracle, and the timing that decides whether
    linearfit gets a kernel."""
    import torch
    from siriltpu_torch.ops import rejection
    from siriltpu_torch.ops.rejection import (_mean_of_survivors,
                                              linearfit_exact, linearfit_settle,
                                              reject_linearfit)
    from siriltpu_torch.ops.cuda.reject_stack import reject_stack
    from siriltpu_torch.stacking import api
    from siriltpu_torch.utils.interop import frames_from_numpy, u16_to_i32

    sig = (3.0, 3.0)
    frames, shifts = make_frames(*CONFIG2, seed=2, dev=dev)
    f, c, h, w = frames.shape
    reset_counts()
    with stage_seconds() as stages:
        t0 = time.perf_counter()
        res = api.stack_frames(frames, device=dev, method="mean", shifts=shifts,
                               rejection="linearfit", sig=sig, normalize="none")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    knife_n = counted("linearfit.knife")
    if res.data.shape != (c, h, w) or res.data.dtype != np.uint16:
        fail(f"phase9a: result {res.data.shape} {res.data.dtype}")

    # the same values, assembled by other code, through the f32 fit in
    # chunks; then every knife-edge pixel through the NumPy oracle
    flat = reference_flat(frames, shifts, "mean", None)
    del frames
    mean = torch.empty(h * w, dtype=torch.int32, device=dev)
    rl, rh = torch.empty_like(mean), torch.empty_like(mean)
    knife = torch.empty(h * w, dtype=torch.bool, device=dev)
    for a in range(0, h * w, CHUNK):
        valid, v, rl[a:a + CHUNK], rh[a:a + CHUNK], knife[a:a + CHUNK] = \
            reject_linearfit(flat[:, a:a + CHUNK], *sig)
        mean[a:a + CHUNK] = u16_to_i32(_mean_of_survivors(v, valid))
    del valid, v
    kidx = torch.nonzero(knife)[:, 0]
    kcols = flat.view(torch.int16)[:, kidx].cpu().numpy().view(np.uint16)
    t0 = time.perf_counter()
    km, kl, kh = oracle_words(kcols, sig)
    per_pixel_s = (time.perf_counter() - t0) / max(1, kidx.numel())
    # the batched float64 settle, on the host (linearfit_exact, its NumPy
    # face) and on the card as reject_stack runs it, each against the
    # oracle on every knife-edge pixel
    t0 = time.perf_counter()
    hm, hl, hh = linearfit_exact(kcols, sig)
    exact_s = time.perf_counter() - t0
    herrs = [int(np.abs(t.astype(np.int64) - o).max(initial=0))
             for t, o in ((hm, km), (hl, kl), (hh, kh))]
    if any(herrs):
        fail(f"phase9a: linearfit_exact vs c_reject_block on {kidx.numel()} "
             f"knife-edge pixels: max|diff| mean/rejl/rejh {herrs}")
    cols = flat.view(torch.int16)[:, kidx].view(torch.uint16)
    linearfit_settle(cols[:, :8], sig)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dm, dl, dh = linearfit_settle(cols, sig)
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    derrs = [int(np.abs(t.cpu().numpy().astype(np.int64) - o).max(initial=0))
             for t, o in ((dm.view(torch.int16).to(torch.int32) & 0xFFFF, km),
                          (dl, kl), (dh, kh))]
    if any(derrs):
        fail(f"phase9a: linearfit_settle on the card vs c_reject_block on "
             f"{kidx.numel()} knife-edge pixels: max|diff| mean/rejl/rejh {derrs}")
    flips = int((mean[kidx].cpu().numpy() != km).sum())
    for dst, src in ((mean, km), (rl, kl), (rh, kh)):
        dst[kidx] = torch.from_numpy(src.astype(np.int32)).to(dev)
    got = u16_to_i32(frames_from_numpy(res.data[0], dev).reshape(-1))
    errs = [int((got - mean).abs().max()),
            abs(int(res.rejection_low[0]) - int(rl.sum())),
            abs(int(res.rejection_high[0]) - int(rh.sum()))]
    if any(errs):
        fail(f"phase9a: stack_frames(linearfit) vs the chunked fit with the "
             f"oracle on {kidx.numel()} knife-edge pixels (the stack re-ran "
             f"{knife_n}): max|diff| image/rejlow/rejhigh {errs}")
    # the main path's route (register_and_stack's): reject_stack on the
    # whole (F, P) flat, every word and counter against the same
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sm, sl, sh = reject_stack(flat, "linearfit", *sig, with_counters=True)
    torch.cuda.synchronize()
    route_s = time.perf_counter() - t0
    route_knife = counted("linearfit.knife")
    rerrs = [int((u16_to_i32(sm) - mean).abs().max()), int((sl - rl).abs().max()),
             int((sh - rh).abs().max())]
    if any(rerrs):
        fail(f"phase9a: reject_stack(linearfit) on {f}x{h * w} vs the chunked "
             f"fit with the oracle on {kidx.numel()} knife-edge pixels (the "
             f"route settled {route_knife}): max|diff| mean/rejl/rejh {rerrs}")
    del sm, sl, sh
    # the f32 fit off the knife edge against the oracle, on seeded pixels
    rng = np.random.default_rng(9)
    sample = torch.from_numpy(rng.choice(h * w, LF_SAMPLE, replace=False)).to(dev)
    sample = sample[~knife[sample]]
    om, ol, oh = oracle_words(
        flat.view(torch.int16)[:, sample].cpu().numpy().view(np.uint16), sig)
    serrs = [int(np.abs(t[sample].cpu().numpy() - o).max())
             for t, o in ((mean, om), (rl, ol), (rh, oh))]
    if any(serrs):
        fail(f"phase9a: reject_linearfit vs the oracle on {sample.numel()} "
             f"pixels off the knife edge: max|diff| mean/rejl/rejh {serrs}")
    print(f"phase9a stack_frames(mean, linearfit {sig}, normalize=none) "
          f"{f}x{c}x{h}x{w}: image and rejection totals (low "
          f"{int(res.rejection_low[0])} high {int(res.rejection_high[0])}) vs the "
          f"chunked fit + oracle max|diff|={max(errs)}; mean and both counters "
          f"vs c_reject_block on {kidx.numel()} knife-edge pixels (the f32 fit "
          f"alone differs on {flips}) and {sample.numel()} others "
          f"max|diff|={max(serrs)}; its one run {sec:.3f} s, {f / sec:.3f} "
          f"frames/s, of which the fix-up of {knife_n} knife-edge pixels "
          f"{stages.get('stack.linearfit_fixup', 0.0):.3f} s (their host "
          f"normalization and the settle on the card); reject_stack(linearfit) "
          f"on the whole flat {route_s:.3f} s, {route_knife} settled, every "
          f"word and counter equal; the batched settle of {kidx.numel()} "
          f"knife-edge columns on the card {settle_s:.4f} s and on the host "
          f"{exact_s:.3f} s, both equal to c_reject_block "
          f"({per_pixel_s * 1e3:.3f} ms a pixel) [{card}]", flush=True)
    del mean, rl, rh, knife
    torch.cuda.empty_cache()

    ms, _ = cuda_ms(chunked(lambda v: reject_linearfit(v, *sig), flat))
    # its passes (each ends on one host check of ``done.all()``), counted
    # in one more run, and what such a check costs on its own
    passes = []
    stale_pass = rejection._stale_pass
    rejection._stale_pass = lambda *a: passes.append(0) or stale_pass(*a)
    try:
        chunked(lambda v: reject_linearfit(v, *sig), flat)()
    finally:
        rejection._stale_pass = stale_pass
    done = torch.zeros(CHUNK, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        bool(done.all())
    check_us = (time.perf_counter() - t0) * 1e4
    nbytes = 2 * f * h * w + 11 * h * w
    sort_ms, sorted_as = sort_yardstick(flat)
    print(f"timing [{card}] reject_linearfit at {f}x{h * w} in 2^20-pixel "
          f"chunks: {ms:.3f} ms (median of {REPS} warm runs), {len(passes)} "
          f"passes over its chunks, {ms / len(passes):.3f} ms a pass, each "
          f"with one host check of done.all() ({check_us:.1f} us on an idle "
          f"card); bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} bytes: "
          f"uint16 values in, a uint16 mean, two int32 counters and a flag out, "
          f"at {HBM_BYTES_PER_S:.3g} B/s); torch.sort(dim=0) of the {sorted_as} "
          f"values {sort_ms:.3f} ms", flush=True)


def make_disc_frames(f: int, h: int, w: int, seed: int, dev):
    """(F, 1, H, W) uint16 frames in the 8-bit range, made on the card: a
    planetary disc with bands and spots over a sky of 25, peak under 255,
    each frame a crop of the scene drifted by whole pixels in [-20, 20]
    with fresh noise of 2 counts. Returns the frames and the (F, 2) int32
    registration shifts that undo the drift."""
    import torch
    from siriltpu_torch.utils.interop import i32_to_u16

    rng = np.random.default_rng(seed)
    drift = rng.integers(-20, 21, (f, 2))
    drift[0] = 0
    pad = 20
    yy = torch.arange(h + 2 * pad, dtype=torch.float32, device=dev)[:, None] - pad
    xx = torch.arange(w + 2 * pad, dtype=torch.float32, device=dev)[None, :] - pad
    r = torch.sqrt((yy - h / 2) ** 2 + (xx - w / 2) ** 2)
    detail = 1.0 + 0.12 * torch.sin(yy / 9.0) * torch.cos(xx / 31.0)
    for cy, cx, rad in rng.uniform(-0.6, 0.6, (12, 3)):
        spot = (yy - h / 2 - cy * h / 4) ** 2 + (xx - w / 2 - cx * h / 4) ** 2
        detail = detail - 0.25 * torch.exp(-spot / (40.0 + 60.0 * abs(rad)))
    scene = 25.0 + 180.0 * detail / (1 + torch.exp(r - h / 4))
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    frames = torch.empty((f, h, w), dtype=torch.int16, device=dev)
    for i, (dx, dy) in enumerate(drift):
        crop = scene[pad - dy:pad - dy + h, pad - dx:pad - dx + w]
        noisy = crop + 2.0 * torch.randn((h, w), generator=g, device=dev)
        frames[i] = i32_to_u16(torch.round(noisy).clamp(0, 255)).view(torch.int16)
    return frames.view(torch.uint16).reshape(f, 1, h, w), (-drift).astype(np.int32)


def phase9b(rs, rec, dev, card):
    """ECC registration of a SER sequence, then its sigma stack."""
    import torch
    from siriltpu_torch.io.sequence import ser_sequence
    from siriltpu_torch.registration import translation
    from siriltpu_torch.stacking import api

    frames, shifts = make_disc_frames(*CONFIG_ECC, seed=4, dev=dev)
    f, _, h, w = frames.shape
    peak = int(frames.view(torch.int16).max())
    if peak >= 255:
        fail(f"phase9b: the frames' peak {peak} is not under 255")
    sig = SIGS["sigma"]
    kw = dict(method="mean", rejection="sigma", sig=sig, normalize="none")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "ecc.ser")
        wrote = write_ser(path, frames)
        with stage_seconds() as stats:
            t0 = time.perf_counter()
            seq = ser_sequence(path)
            report = translation.register_ecc(seq, 0, device=dev)
            torch.cuda.synchronize()
            reg_s = time.perf_counter() - t0
        if report.failed or len(seq.included_indices()) != f:
            fail(f"phase9b: register_ecc excluded {report.failed} frames")
        if not np.array_equal(seq.reg_shifts(0), shifts):
            bad = int((seq.reg_shifts(0) != shifts).any(axis=1).sum())
            fail(f"phase9b: {bad} recovered shifts differ from the generated ones")
        reset_counts()
        t0 = time.perf_counter()
        res = api.stack_sequence(seq, device=dev, stream=False, **kw)
        stack_s = time.perf_counter() - t0
        rec.count(kernel_launches(), "stack_sequence(mean, sigma) after register_ecc",
                  "sigma")
    want = api.stack_frames(frames, device=dev, shifts=shifts, **kw)
    errs = [int(np.abs(res.data.astype(np.int64) - want.data).max()),
            int(np.abs(res.rejection_low - want.rejection_low).max()),
            int(np.abs(res.rejection_high - want.rejection_high).max())]
    rec.check("sigma", errs, "phase9b stack_sequence vs stack_frames")
    print(f"phase9b register_ecc {f}x{h}x{w} from a SER file ({wrote:.3f} s to "
          f"write; peak {peak}): shifts exact, no frame excluded, best frame "
          f"{report.best_frame}; {reg_s:.3f} s, {f / reg_s:.3f} frames/s (one run, "
          f"host clock): file reads {stats['ecc.read']:.3f} s, host quality "
          f"estimates {stats['ecc.quality']:.3f} s, the device loop with its copies "
          f"{stats['ecc.device']:.3f} s; then stack_sequence(mean, sigma {sig}) "
          f"{stack_s:.3f} s, launches={kernel_launches()}, image+counters vs "
          f"stack_frames max|diff|={max(errs)}; {f / (reg_s + stack_s):.3f} "
          f"frames/s from the open of the file [{card}]", flush=True)


def make_star_frames(f: int, h: int, w: int, seed: int, dev):
    """(F, H, W) uint16 bottom-up frames made on the card: a sky of 1000
    with noise of 10 counts and NSTARS round Gaussian stars (the PSF fit's
    model, B + A exp(-r^2 / S)) at sub-pixel positions at least 48 px
    apart, each frame the scene drifted by whole pixels in [-STAR_DRIFT,
    STAR_DRIFT]. Returns the frames, the (NSTARS, 4) table (x, y bottom-up
    in frame 0, A, S) sorted brightest first, and the (F, 2) int32 drift
    (dx, dy) of each frame."""
    import torch
    from siriltpu_torch.utils.interop import i32_to_u16

    rng = np.random.default_rng(seed)
    pad = STAR_DRIFT
    margin = 40
    pos = np.zeros((0, 2))
    while len(pos) < NSTARS:
        cand = rng.uniform((margin, margin), (w - margin, h - margin), (1, 2))
        if not len(pos) or np.hypot(*(pos - cand).T).min() >= 48:
            pos = np.concatenate([pos, cand])
    amp = np.sort(rng.uniform(4000, 40000, NSTARS))[::-1]
    table = np.column_stack([pos, amp, rng.uniform(4.0, 12.0, NSTARS)])
    drift = rng.integers(-STAR_DRIFT, STAR_DRIFT + 1, (f, 2))
    drift[0] = 0
    # every star rendered in a 31 x 31 window of a padded scene
    span = torch.arange(-15, 16, device=dev)
    t = torch.tensor(table, dtype=torch.float64, device=dev)
    cx, cy = torch.round(t[:, 0]).long(), torch.round(t[:, 1]).long()
    ys = (cy[:, None] + span[None, :])[:, :, None].expand(-1, -1, 31)
    xs = (cx[:, None] + span[None, :])[:, None, :].expand(-1, 31, -1)
    r2 = (ys - t[:, 1, None, None]) ** 2 + (xs - t[:, 0, None, None]) ** 2
    stars = t[:, 2, None, None] * torch.exp(-r2 / t[:, 3, None, None])
    scene = torch.full((h + 2 * pad, w + 2 * pad), 1000.0, device=dev)
    scene.index_put_((ys + pad, xs + pad), stars.to(torch.float32), accumulate=True)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    frames = torch.empty((f, h, w), dtype=torch.int16, device=dev)
    for i, (dx, dy) in enumerate(drift):
        crop = scene[pad - dy:pad - dy + h, pad - dx:pad - dx + w]
        noisy = crop + 10.0 * torch.randn((h, w), generator=g, device=dev)
        frames[i] = i32_to_u16(torch.round(noisy).clamp(0, 65535)).view(torch.int16)
    return frames.view(torch.uint16), table, drift.astype(np.int32)


def nearest(stars, x, y):
    """Distance from each (x, y) to the nearest star of the list, and that
    star's index."""
    sx = np.array([s.xpos for s in stars])
    sy = np.array([s.ypos for s in stars])
    d = np.hypot(x[:, None] - sx[None, :], y[:, None] - sy[None, :])
    return d.min(axis=1), d.argmin(axis=1)


def phase9c(dev, card):
    """Star detection on full frames, and one-star registration."""
    import torch
    from siriltpu_torch.core.frame import Frame, Rect
    from siriltpu_torch.io.sequence import internal_sequence
    from siriltpu_torch.ops import starfind
    from siriltpu_torch.ops.psf import fit_psf_batch
    from siriltpu_torch.registration.onestar import register_onestar
    from siriltpu_torch.utils.interop import frames_from_numpy, u16_to_numpy

    if torch.get_float32_matmul_precision() != "highest":
        fail("float32 matmul precision is not 'highest': the PSF fit's "
             "normal equations must not run in TF32")
    frames_dev, table, drift = make_star_frames(*CONFIG_STARS, seed=5, dev=dev)
    f, h, w = frames_dev.shape
    layers = u16_to_numpy(frames_dev)
    del frames_dev
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    one = starfind.peaker(layers[0], device=dev)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = starfind.peaker_batch(layers, device=dev)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    if batch[0] != one:
        fail("phase9c: peaker_batch's list of frame 0 differs from peaker's")
    found = []
    for i, stars in enumerate(batch):
        # planted positions, top-down, in frame i
        d, _ = nearest(stars, table[:, 0] + drift[i, 0],
                       (h - 1) - (table[:, 1] + drift[i, 1]))
        found.append(float((d < 0.1).mean()))
        if found[-1] < 0.95:
            fail(f"phase9c: frame {i}: {100 * found[-1]:.1f}% of the planted "
                 f"stars found within 0.1 px ({len(stars)} stars in its list)")
    t0 = time.perf_counter()
    host = starfind.peaker(layers[0], device="cpu")
    cpu_s = time.perf_counter() - t0
    d, k = nearest(host, np.array([s.xpos for s in one]),
                   np.array([s.ypos for s in one]))
    dmag = np.abs(np.array([s.mag for s in one]) - np.array([host[j].mag for j in k]))
    if len(host) != len(one) or d.max() > 0.01 or dmag.max() > 0.002:
        fail(f"phase9c: the card's {len(one)} stars against the CPU's "
             f"{len(host)}: max distance {d.max():.5f} px, max |dmag| {dmag.max():.5f}")
    print(f"phase9c peaker {h}x{w}: {len(one)} stars of {NSTARS} planted in "
          f"{one_s:.3f} s (first call); peaker_batch {f} frames in {batch_s:.3f} s, "
          f"{f / batch_s:.3f} frames/s, list of frame 0 equal to peaker's, "
          f"{min(len(b) for b in batch)}-{max(len(b) for b in batch)} stars a "
          f"frame, planted stars found within 0.1 px "
          f"{100 * min(found):.1f}%-{100 * max(found):.1f}%; the same code on "
          f"device=cpu ({cpu_s:.3f} s): {len(host)} stars, max distance "
          f"{d.max():.5f} px, max |dmag| {dmag.max():.6f} [{card}]", flush=True)

    # where a frame's time goes: the host statistics on the host clock, the
    # stages on the card by CUDA events (median of 3 warm runs)
    sf = starfind.StarFinderParams()
    t0 = time.perf_counter()
    threshold, norm, bg = starfind._threshold(layers[0], sf)
    stats_ms = (time.perf_counter() - t0) * 1e3
    layer_dev = frames_from_numpy(layers[0], dev)
    ms = {}
    ms["wavelet"], wave = cuda_ms(lambda: starfind._wavelet_td(layer_dev))
    ms["peaks"], mask = cuda_ms(lambda: starfind._detect_peaks(
        wave, threshold, norm, sf.radius, (0, 0, w, h)))
    ms["selection"], (ys, xs) = cuda_ms(lambda: starfind._select_candidates(
        wave, mask, starfind.MAX_CANDIDATES))
    real_td = layer_dev.view(torch.int16).flip(0).view(torch.uint16)
    ms["box_gather"], boxes = cuda_ms(lambda: starfind._gather_boxes(
        real_td, ys, xs, sf.radius))
    bgs = torch.full((ys.numel(),), bg, dtype=torch.float32, device=dev)
    ms["fit"], _ = cuda_ms(lambda: fit_psf_batch(boxes, bgs, norm=float(norm)))
    print(f"timing [{card}] star-find a frame of {h}x{w}: host statistics "
          f"{stats_ms:.3f} ms (host clock, one run); on the card (CUDA events, "
          f"median of {REPS} warm runs) "
          + " ".join(f"{k}_ms={v:.3f}" for k, v in ms.items())
          + f"; {int(mask.sum())} peaks, {ys.numel()} candidates fitted",
          flush=True)
    del layer_dev, wave, mask, real_td, boxes
    torch.cuda.empty_cache()

    # one-star registration on a box round the brightest star
    x0, y0 = int(round(table[0, 0])), int(round((h - 1) - table[0, 1]))
    side = 48
    seq = internal_sequence([Frame(layer[None]) for layer in layers])
    t0 = time.perf_counter()
    best, fwhm, results = register_onestar(
        seq, 0, Rect(x0 - side // 2, y0 - side // 2, side, side), device=dev)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    if not all(r.ok for r in results) or not np.array_equal(seq.reg_shifts(0), -drift):
        fail(f"phase9c: register_onestar's shifts differ from the generated ones "
             f"({sum(r.ok for r in results)} of {f} fits valid)")
    print(f"phase9c register_onestar on a {side}x{side} box, {f} frames: shifts "
          f"exact, best frame {best} with FWHM {fwhm:.4f} px, {sec:.3f} s "
          f"[{card}]", flush=True)


def planted_homographies(f: int, rng, shift: float = SHIFT4) -> np.ndarray:
    """(F, 3, 3) top-down homographies frame -> reference: a rotation in
    [-ROT4, ROT4] degrees about the origin and a shift in [-shift, shift]
    px, scale 1; frame 0 the identity."""
    ang = np.deg2rad(rng.uniform(-ROT4, ROT4, f))
    Hs = np.tile(np.eye(3), (f, 1, 1))
    Hs[:, 0, 0] = Hs[:, 1, 1] = np.cos(ang)
    Hs[:, 0, 1], Hs[:, 1, 0] = -np.sin(ang), np.sin(ang)
    Hs[:, :2, 2] = rng.uniform(-shift, shift, (f, 2))
    Hs[0] = np.eye(3)
    return Hs


def make_config4_frames(f: int, c: int, h: int, w: int, seed: int, dev, *,
                        nstars: int = NSTARS, sky: float = 1000.0,
                        noise: float = 10.0, shift: float = SHIFT4, gradient=None):
    """(F, C, H, W) uint16 bottom-up frames made on the card: in each
    channel a sky of ``sky`` (plus ``gradient``, an (H, W) tensor, if
    given) with noise of ``noise`` counts and ``nstars`` round Gaussian
    stars (B + gain A exp(-r^2 / S)) at least 48 px apart, each frame's star
    positions the reference's moved through the inverse of its planted
    homography (planted_homographies). Returns the frames and the (F, 3, 3)
    homographies frame -> reference, top-down."""
    import torch
    from siriltpu_torch.utils.interop import i32_to_u16

    rng = np.random.default_rng(seed)
    margin = 64
    pos = np.zeros((0, 2))
    while len(pos) < nstars:
        cand = rng.uniform((margin, margin), (w - margin, h - margin), (1, 2))
        if not len(pos) or np.hypot(*(pos - cand).T).min() >= 48:
            pos = np.concatenate([pos, cand])
    amp = rng.uniform(4000, 40000, nstars)
    spread = rng.uniform(4.0, 12.0, nstars)
    Hs = planted_homographies(f, rng, shift)
    pad = 64
    span = torch.arange(-15, 16, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    frames = torch.empty((f, c, h, w), dtype=torch.int16, device=dev)
    ref_td = np.column_stack([pos, np.ones(nstars)])
    for i in range(f):
        ph = ref_td @ np.linalg.inv(Hs[i]).T
        x, y_td = ph[:, 0] / ph[:, 2], ph[:, 1] / ph[:, 2]
        t = torch.tensor(np.column_stack([x, (h - 1) - y_td, amp, spread]),
                         dtype=torch.float64, device=dev)
        cx, cy = torch.round(t[:, 0]).long(), torch.round(t[:, 1]).long()
        ys = (cy[:, None] + span[None, :])[:, :, None].expand(-1, -1, 31)
        xs = (cx[:, None] + span[None, :])[:, None, :].expand(-1, 31, -1)
        r2 = (ys - t[:, 1, None, None]) ** 2 + (xs - t[:, 0, None, None]) ** 2
        stars = t[:, 2, None, None] * torch.exp(-r2 / t[:, 3, None, None])
        scene = torch.zeros((h + 2 * pad, w + 2 * pad), device=dev)
        scene.index_put_((ys + pad, xs + pad), stars.to(torch.float32), accumulate=True)
        core = scene[pad:pad + h, pad:pad + w]
        for ch, gain in enumerate(GAINS4[:c]):
            noisy = sky + gain * core + noise * torch.randn((h, w), generator=g, device=dev)
            if gradient is not None:
                noisy += gradient
            frames[i, ch] = i32_to_u16(torch.round(noisy).clamp(0, 65535)).view(torch.int16)
    return frames.view(torch.uint16), Hs


def corner_error(H, planted, h: int, w: int) -> float:
    """Largest distance between where H and the planted homography send the
    four frame corners (top-down)."""
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float64)

    def move(m):
        ph = np.column_stack([corners, np.ones(4)]) @ m.T
        return ph[:, :2] / ph[:, 2:]
    return float(np.hypot(*(move(H) - move(planted)).T).max())


def registration_line(gstats, stats_s: float, frames: int, sec: float) -> str:
    """frames/s of one register_global_star run and where its seconds went."""
    return (f"{sec:.3f} s, {frames / sec:.3f} frames/s (one run, host clock): "
            f"frame reads {gstats['global.read']:.3f} s (loader thread; the main "
            f"thread waited {gstats['global.wait']:.3f}), peaker_batch "
            f"{gstats['global.starfind']:.3f} (host statistics {stats_s:.3f}, the "
            f"rest on the card {gstats['global.starfind'] - stats_s:.3f}), host "
            f"matching and RANSAC {gstats['global.match']:.3f}, warp "
            f"{gstats['global.warp']:.3f}, copy to the host {gstats['global.copy']:.3f}, "
            f"output {gstats['global.write']:.3f}")


def timed_registration(dev, seq, **kw):
    """register_global_star on ``seq``, with the seconds its peaker_batch
    calls spent in the host statistics. Returns the report, the seconds,
    the seconds of its stages by span name and the statistics' seconds."""
    import torch
    from siriltpu_torch.ops import starfind
    from siriltpu_torch.registration import global_star

    clock = Clock()
    threshold, batch = starfind._threshold, starfind.peaker_batch
    inside = [0.0]

    def timed_batch(*args, **kwargs):
        clock.take()
        try:
            return batch(*args, **kwargs)
        finally:
            inside[0] += clock.take()[0]

    starfind._threshold = clock.wrap(threshold)
    starfind.peaker_batch = timed_batch
    try:
        with stage_seconds() as stages:
            t0 = time.perf_counter()
            report = global_star.register_global_star(seq, 0, device=dev, **kw)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
    finally:
        starfind._threshold, starfind.peaker_batch = threshold, batch
    return report, sec, stages, inside[0]


def mean_fwhm(stars) -> float:
    return float(np.mean([s.fwhmx for s in stars]))


def phase10a(rs, rec, dev, card, host, planted):
    """Config 4 in memory: register_global_star, global_align_batch on the
    first frames, the sigma stack against its plain version, sharpness."""
    import torch
    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.io.sequence import internal_sequence
    from siriltpu_torch.ops import starfind
    from siriltpu_torch.ops.rejection import reject_and_mean
    from siriltpu_torch.registration import global_star
    from siriltpu_torch.stacking import api
    from siriltpu_torch.utils.interop import frames_from_numpy

    f, c, h, w = host.shape
    out = []
    report, reg_s, gstats, stats_s = timed_registration(
        dev, internal_sequence([Frame(fr) for fr in host]), write_output=False,
        output_frames=out)
    if report.registered != f or report.failed:
        fail(f"phase10a: {report.registered} of {f} frames registered, "
             f"{report.failed} failed")
    errs = [corner_error(H, p, h, w) for H, p in zip(report.homographies, planted)]
    if max(errs) > 0.1:
        fail(f"phase10a: frame {int(np.argmax(errs))}'s homography moves a corner "
             f"{max(errs):.4f} px from the planted one's")
    print(f"phase10a register_global_star {f}x{c}x{h}x{w} in memory (linear): "
          f"{f} registered, corners within {max(errs):.5f} px of the planted "
          f"homographies (median {np.median(errs):.5f}); "
          + registration_line(gstats, stats_s, f, reg_s) + f" [{card}]", flush=True)

    aligned, brep = global_star.global_align_batch(host[:BATCH4, 0], 0, device=dev,
                                                   nmax=2048)
    for i in range(BATCH4):
        if not np.array_equal(brep.homographies[i], report.homographies[i]):
            fail(f"phase10a: global_align_batch's homography of frame {i} differs")
        if not np.array_equal(aligned[i], out[i].data[0]):
            fail(f"phase10a: global_align_batch's pixels of frame {i} differ")
    print(f"phase10a global_align_batch on the first {BATCH4} frames: the same "
          f"homographies and pixels as register_global_star", flush=True)
    del aligned

    sig = SIGS["sigma"]
    stacked = np.stack([fr.data for fr in out])
    del out
    reset_counts()
    t0 = time.perf_counter()
    res = api.stack_frames(stacked, device=dev, method="mean", rejection="sigma",
                           sig=sig, normalize="none")
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    launches = kernel_launches()
    rec.count(launches, "stack_frames after register_global_star", "sigma")
    vals = frames_from_numpy(stacked, dev).view(torch.int16)
    errs = []
    for ch in range(c):
        flat = vals[:, ch].reshape(f, -1).view(torch.uint16)
        got = frames_from_numpy(res.data[ch], dev).reshape(-1)
        rl = rh = 0
        for a in range(0, flat.shape[1], CHUNK):
            pm, pl, ph = reject_and_mean(flat[:, a:a + CHUNK], "sigma", sig)
            errs.append(max_abs_diff(got[a:a + CHUNK], pm))
            rl += int(pl.sum())
            rh += int(ph.sum())
        errs += [abs(int(res.rejection_low[ch]) - rl),
                 abs(int(res.rejection_high[ch]) - rh)]
    del vals, flat
    torch.cuda.empty_cache()
    rec.check("sigma", errs, "phase10a stack_frames after register_global_star")
    ref_stars = starfind.peaker(host[0, 0], device=dev)
    stack_stars = starfind.peaker(res.data[0], device=dev)
    ratio = mean_fwhm(stack_stars) / mean_fwhm(ref_stars)
    if abs(ratio - 1.0) > 0.10:
        fail(f"phase10a: the stack's mean FWHM is {ratio:.4f} times frame 0's")
    print(f"phase10a stack_frames(mean, sigma {sig}) of the aligned "
          f"{f}x{c}x{h}x{w}: launches={launches}, image+counters of every "
          f"channel vs plain max|diff|={max(errs)}, rejected low "
          f"{res.rejection_low.tolist()} high {res.rejection_high.tolist()}; "
          f"{stack_s:.3f} s (one run, host clock); layer 0's mean FWHM "
          f"{mean_fwhm(stack_stars):.4f} px over {len(stack_stars)} stars, frame "
          f"0's {mean_fwhm(ref_stars):.4f} px over {len(ref_stars)} (ratio "
          f"{ratio:.4f}); {f / (reg_s + stack_s):.3f} frames/s registration and "
          f"stack [{card}]", flush=True)


def phase10b(rs, rec, dev, card, disk):
    """Config 4 from FITS files, cut to ``disk`` (F, 1, H, W): the r_
    sequence and its stack against an in-memory run."""
    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.io.fits import write_fits
    from siriltpu_torch.io.sequence import check_seq, internal_sequence
    from siriltpu_torch.registration import global_star
    from siriltpu_torch.stacking import api

    f, _, h, w = disk.shape
    sig = SIGS["sigma"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        for i, fr in enumerate(disk):
            write_fits(os.path.join(tmp, f"light_{i + 1:05d}.fit"), Frame(fr))
        wrote = time.perf_counter() - t0
        t0 = time.perf_counter()
        seq = check_seq(tmp)[0]
        open_s = time.perf_counter() - t0
        report, reg_s, gstats, stats_s = timed_registration(dev, seq)
        if report.registered != f:
            fail(f"phase10b: {report.registered} of {f} frames registered")
        rseq = [s for s in check_seq(tmp) if s.seqname == report.new_seqname]
        if len(rseq) != 1 or rseq[0].number != f or \
                not os.path.exists(os.path.join(tmp, report.new_seqname + ".seq")):
            fail("phase10b: the r_ sequence or its .seq file is missing")
        rseq = rseq[0]
        reset_counts()
        t0 = time.perf_counter()
        res = api.stack_sequence(rseq, device=dev, method="mean", rejection="sigma",
                                 sig=sig, stream=False)
        stack_s = time.perf_counter() - t0
        launches = kernel_launches()
        rec.count(launches, "stack_sequence of the r_ sequence", "sigma")
        mem = []
        global_star.register_global_star(
            internal_sequence([Frame(fr) for fr in disk]), 0, device=dev,
            write_output=False, output_frames=mem)
        for i in range(f):
            if not np.array_equal(rseq.read_frame(i).data, mem[i].data):
                fail(f"phase10b: r_ frame {i} differs from the in-memory run's")
    want = api.stack_frames(np.stack([m.data for m in mem]), device=dev,
                            method="mean", rejection="sigma", sig=sig,
                            normalize="none")
    errs = [int(np.abs(res.data.astype(np.int64) - want.data).max()),
            int(np.abs(res.rejection_low - want.rejection_low).max()),
            int(np.abs(res.rejection_high - want.rejection_high).max())]
    rec.check("sigma", errs, "phase10b stack_sequence vs stack_frames")
    print(f"phase10b {f}x{h}x{w} FITS files ({wrote:.3f} s to write): check_seq "
          f"{open_s:.3f} s; register_global_star writing the r_ sequence: "
          + registration_line(gstats, stats_s, f, reg_s)
          + f"; r_ frames read back equal to the in-memory run's; "
          f"stack_sequence(mean, sigma {sig}) {stack_s:.3f} s, launches={launches}, "
          f"image+counters vs stack_frames max|diff|={max(errs)}; "
          f"{f / (open_s + reg_s + stack_s):.3f} frames/s from the open [{card}]",
          flush=True)


def phase10c(dev, card, host, planted):
    """The warp alone at config 4's layer size: times, and the card against
    the CPU."""
    import torch
    from siriltpu_torch.ops import warp
    from siriltpu_torch.utils.interop import frames_from_numpy, u16_to_numpy

    _, _, h, w = host.shape
    layer = frames_from_numpy(host[1, 0], dev)
    H = planted[1]
    nbytes = 2 * 2 * h * w
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    names = {warp.INTER_NEAREST: "nearest", warp.INTER_LINEAR: "linear",
             warp.INTER_CUBIC: "cubic", warp.INTER_LANCZOS4: "lanczos4"}
    ms = {}
    for interp, name in names.items():
        ms[name], _ = cuda_ms(lambda: warp.warp_layer_dev(layer, H, (h, w), interp))
    # a yardstick the port does not call: one fused library sampler on the
    # same source coordinates (align_corners=True maps pixel centres)
    Hinv = torch.from_numpy(np.linalg.inv(H).astype(np.float32)).to(dev)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    den = Hinv[2, 0] * xx + Hinv[2, 1] * yy + Hinv[2, 2]
    xs = (Hinv[0, 0] * xx + Hinv[0, 1] * yy + Hinv[0, 2]) / den
    ys = (Hinv[1, 0] * xx + Hinv[1, 1] * yy + Hinv[1, 2]) / den
    grid = torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], -1)[None]
    img = layer.view(torch.int16).flip(0).to(torch.int32).bitwise_and(0xFFFF)
    img = img.to(torch.float32)[None, None]
    lib = {}
    for mode in ("nearest", "bilinear", "bicubic"):
        lib[mode], _ = cuda_ms(lambda: torch.nn.functional.grid_sample(
            img, grid, mode=mode, padding_mode="zeros", align_corners=True))
    print(f"timing [{card}] warp_layer_dev of one {h}x{w} layer (CUDA events, "
          f"median of {REPS} warm runs): "
          + " ".join(f"{k}_ms={v:.3f}" for k, v in ms.items())
          + f"; bound {bound:.4f} ms ({nbytes} bytes: a uint16 read and a uint16 "
          f"write a pixel at {HBM_BYTES_PER_S:.3g} B/s); torch grid_sample on "
          f"float32 (not called by the port) "
          + " ".join(f"{k}_ms={v:.3f}" for k, v in lib.items()), flush=True)
    del layer, img, grid, xs, ys, den
    torch.cuda.empty_cache()

    two, Hs = host[1:3, 0], planted[1:3]
    diffs = {}
    for interp in (0, 1, 2, 3, 4):
        t0 = time.perf_counter()
        got = u16_to_numpy(warp.warp_batch_dev(two, Hs, (h, w), interp, device=dev))
        want = u16_to_numpy(warp.warp_batch_dev(two, Hs, (h, w), interp, device="cpu"))
        d = np.abs(got.astype(np.int64) - want)
        diffs[interp] = (int(d.max()), int((d != 0).sum()),
                         round(time.perf_counter() - t0, 3))
        if d.max() > (1 if interp == warp.INTER_LANCZOS4 else 0):
            fail(f"phase10c: the card's warp (interpolation {interp}) against the "
                 f"CPU's: max|diff| {d.max()} on {int((d != 0).sum())} words")
    print(f"phase10c warp_batch_dev of 2 frames of {h}x{w}, card against "
          f"device=cpu, per interpolation (max|diff|, words differing, s of both): "
          f"{diffs}", flush=True)


def phase10(rs, rec, dev, card):
    import torch
    from siriltpu_torch.utils.interop import u16_to_numpy

    t0 = time.perf_counter()
    frames, planted = make_config4_frames(*CONFIG4, seed=6, dev=dev)
    host = u16_to_numpy(frames)
    del frames
    torch.cuda.empty_cache()
    print(f"phase10 frames {host.shape} made on the card and copied to the host "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    phase10a(rs, rec, dev, card, host, planted)
    phase10b(rs, rec, dev, card, np.ascontiguousarray(host[:CONFIG4_DISK, :1]))
    phase10c(dev, card, host, planted)


def kept_calls(module, name: str):
    """Wrap ``module.name`` so that each call's result is kept; returns the
    list and a function that puts the original back."""
    calls, fn = [], getattr(module, name)

    def kept(*args, **kwargs):
        calls.append(fn(*args, **kwargs))
        return calls[-1]
    setattr(module, name, kept)
    return calls, lambda: setattr(module, name, fn)


def cli_subprocess(tmp: str, script: str, label: str) -> float:
    """``python -m siriltpu_torch -d tmp -s script`` on DEVICE; any exit
    but 0 fails the run. Returns its seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "siril-0.9_tpu")] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "siriltpu_torch", "--device", DEVICE, "-d", tmp,
           "-s", script]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        fail(f"{label}: python -m siriltpu_torch exited {proc.returncode}: "
             f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    return time.perf_counter() - t0


def mosaic_rggb_bu(frame):
    """An RGGB mosaic of a (3, H, W) bottom-up uint16 tensor, laid over
    the top-down rows a SER file stores: (H, W) int16 bits, bottom-up
    again."""
    import torch
    td = frame.view(torch.int16).flip(1)
    m = torch.empty(td.shape[1:], dtype=torch.int16, device=td.device)
    m[0::2, 0::2] = td[0, 0::2, 0::2]
    m[0::2, 1::2] = td[1, 0::2, 1::2]
    m[1::2, 0::2] = td[1, 1::2, 0::2]
    m[1::2, 1::2] = td[2, 1::2, 1::2]
    return m.flip(0)


def make_config5_ser(path: str, dev):
    """CONFIG5's RGB star frames made on the card, mosaiced to RGGB and
    written as a CFA SER at ``path``. Returns the (F, 3, 3) planted
    homographies and the seconds to make and to write the file."""
    import torch
    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.io.ser import SER_BAYER_RGGB, SerFile
    from siriltpu_torch.utils.interop import u16_to_numpy

    f, c, h, w = CONFIG5
    t0 = time.perf_counter()
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    gradient = GRAD5[0] * (xx * 65535.0 / w) + GRAD5[1] * (yy * 65535.0 / h)
    frames, planted = make_config4_frames(f, c, h, w, seed=11, dev=dev, nstars=NSTARS5,
                                          sky=SKY5, noise=NOISE5, shift=SHIFT5,
                                          gradient=gradient)
    cfa = u16_to_numpy(torch.stack([mosaic_rggb_bu(fr) for fr in frames]).view(torch.uint16))
    del frames, gradient
    torch.cuda.empty_cache()
    made = time.perf_counter() - t0
    t0 = time.perf_counter()
    ser = SerFile.create(path, width=w, height=h, color_id=SER_BAYER_RGGB)
    for fr in cfa:
        ser.write_frame(Frame(fr[None]))
    ser.write_and_close()
    return planted, cfa[0, ::-1].copy(), made, time.perf_counter() - t0


def corner_spread(img) -> float:
    """|median of the top-left 20 x 20 corner - median of the bottom-right
    one|, inside the 1-pixel border the bilinear debayer leaves black (the
    JAX test's criterion, tests/test_full_pipeline.py)."""
    img = img.astype(np.float64)
    return abs(float(np.median(img[2:22, 2:22])) - float(np.median(img[-22:-2, -22:-2])))


def phase11a(rs, rec, dev, card, tmp):
    """Config 5 from a CFA SER: config5_pipeline on the card, and its
    checks. Returns the planted homographies' CFA frame 0 (top-down) for
    phase 11b."""
    import torch
    from siriltpu_torch.io.fits import read_fits
    from siriltpu_torch.io.sequence import ser_sequence
    from siriltpu_torch.ops.histogram_ops import autostretch
    from siriltpu_torch.ops.rejection import reject_and_mean
    from siriltpu_torch.pipelines.full import config5_pipeline
    from siriltpu_torch.registration import global_star
    from siriltpu_torch.stacking import api
    from siriltpu_torch.utils.interop import frames_from_numpy

    f, c, h, w = CONFIG5
    path = os.path.join(tmp, "lights.ser")
    planted, cfa0, made_s, wrote_s = make_config5_ser(path, dev)
    print(f"phase11a {f} RGB frames of {w}x{h} made on the card and mosaiced in "
          f"{made_s:.2f} s; the RGGB SER ({os.path.getsize(path)} bytes) written in "
          f"{wrote_s:.2f} s; {shutil.disk_usage(tmp).free} bytes free there [{card}]",
          flush=True)

    # the registration's report, which config5_pipeline keeps to itself
    reports, put_back = kept_calls(global_star, "register_global_star")
    sig = SIGS["winsorized"]
    reset_counts()
    try:
        with stage_seconds() as stages:
            t0 = time.perf_counter()
            rep = config5_pipeline(path, device=dev, layer=1, rejection="winsorized",
                                   sig=sig, debayer=True)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
    finally:
        put_back()
    launches = kernel_launches()
    rec.count(launches, "config5_pipeline", "winsorized")
    gstats = {k: v for k, v in stages.items() if k.startswith("global.")}
    if rep.registered != f or rep.failed:
        fail(f"phase11a: {rep.registered} of {f} frames registered, {rep.failed} failed")
    errs = [corner_error(H, p, h, w) for H, p in zip(reports[0].homographies, planted)]
    if max(errs) > 0.1:
        fail(f"phase11a: frame {int(np.argmax(errs))}'s homography moves a corner "
             f"{max(errs):.4f} px from the planted one's")
    sizes = {name: os.path.getsize(os.path.join(tmp, name))
             for name in ("bkg_lights.ser", "r_bkg_lights.ser")}
    print(f"phase11a config5_pipeline {f}x{c}x{h}x{w} from the RGGB SER (debayer "
          f"bilinear, bg_order 4, global registration on layer 1, mean winsorized "
          f"{sig}): {sec:.3f} s, {f / sec:.4f} frames/s from the open of the file to "
          f"the written FITS (one run, host clock); stage_seconds "
          f"{ {k: round(v, 3) for k, v in rep.stage_seconds.items()} }; overlap_seconds "
          f"of bgextract { {k: round(v, 3) for k, v in rep.overlap_seconds.items()} }; "
          f"registration {({k: round(v, 3) for k, v in gstats.items()})}; launches="
          f"{launches}; {f} registered, corners within {max(errs):.5f} px of the planted "
          f"homographies (median {np.median(errs):.5f}); autostretch m "
          f"{[round(m, 6) for m in rep.autostretch_m]}; intermediate files {sizes} "
          f"bytes [{card}]", flush=True)

    raw0 = ser_sequence(path, debayer=True, debayer_device=dev).read_frame(0).data
    bkg0 = ser_sequence(os.path.join(tmp, "bkg_lights.ser")).read_frame(0).data
    spreads = [(corner_spread(bkg0[ch]), corner_spread(raw0[ch])) for ch in range(c)]
    if any(b >= 0.1 * r for b, r in spreads):
        fail(f"phase11a: bkg_ frame 0's corner spread against the raw frame's, per "
             f"channel: {spreads}")
    del raw0, bkg0

    rseq = ser_sequence(os.path.join(tmp, "r_bkg_lights.ser"))
    regged = np.stack([rseq.read_frame(i).data for i in range(rseq.number)])
    t0 = time.perf_counter()
    res = api.stack_frames(regged, device=dev, method="mean", rejection="winsorized",
                           sig=sig, normalize="none")
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    vals = frames_from_numpy(regged, dev).view(torch.int16)
    del regged
    perrs = []
    t0 = time.perf_counter()
    for ch in range(c):
        flat = vals[:, ch].reshape(f, -1).view(torch.uint16)
        got = frames_from_numpy(res.data[ch], dev).reshape(-1)
        rl = rh = 0
        for a in range(0, flat.shape[1], CHUNK):
            pm, pl, ph = reject_and_mean(flat[:, a:a + CHUNK], "winsorized", sig)
            perrs.append(max_abs_diff(got[a:a + CHUNK], pm))
            rl += int(pl.sum())
            rh += int(ph.sum())
        perrs += [abs(int(res.rejection_low[ch]) - rl), abs(int(res.rejection_high[ch]) - rh)]
    plain_s = time.perf_counter() - t0
    del vals, flat
    torch.cuda.empty_cache()
    rec.check("winsorized", perrs, "phase11a stack_frames of the r_ frames")
    out = read_fits(rep.output_path).data
    if not np.array_equal(out, autostretch(res.data)):
        fail("phase11a: the output FITS differs from the r_ stack stretched by hand")
    # the autostretch links the channels (one (m, lo, hi) for all), and the
    # debayer's black border sets each channel's offset in bgextract (its
    # |min|) tens of counts apart, against a noise of ~2 counts: the linked
    # result's median lands far from the 0.25 target, as in the reference.
    # Each channel stretched alone must land near it.
    med = float(np.median(out))
    alone = [float(np.median(autostretch(res.data[ch:ch + 1]))) for ch in range(c)]
    if not all(0.15 * 65535 < m < 0.40 * 65535 for m in alone):
        fail(f"phase11a: each channel's stack stretched alone has median {alone}")
    print(f"phase11a bkg_ frame 0's corner spread per channel "
          f"{[round(b, 1) for b, _ in spreads]} against the raw frame's "
          f"{[round(r, 1) for _, r in spreads]}; stack_frames(mean, winsorized {sig}) of "
          f"the r_ frames {stack_s:.3f} s, image+counters vs plain max|diff|="
          f"{max(perrs)} (plain {plain_s:.3f} s), rejected low "
          f"{res.rejection_low.tolist()} high {res.rejection_high.tolist()}; output FITS "
          f"equal to it stretched by hand; medians of the output {med:.1f} "
          f"({med / 65535:.4f} x 65535), per channel "
          f"{[float(np.median(out[ch])) for ch in range(c)]}, of each channel's stack "
          f"stretched alone {alone}; the stack's channel medians "
          f"{[float(np.median(res.data[ch])) for ch in range(c)]} [{card}]", flush=True)
    return cfa0


def host_ms(fn, reps: int = REPS):
    """Median host-clock ms of ``fn()`` over ``reps`` warm runs, and the
    last run's result."""
    out = fn()  # warm-up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def phase11b(dev, card, cfa):
    """Demosaicing one config-5 CFA frame (top-down, as a SER stores it):
    the host methods and the card's, timed; the card's against the NumPy
    programs."""
    import torch
    from siriltpu_torch.ops import demosaic
    from siriltpu_torch.utils.interop import frames_from_numpy, u16_to_numpy

    h, w = cfa.shape
    ms = {m: host_ms(lambda m=m: getattr(demosaic, m)(cfa, "RGGB"))[0]
          for m in ("bilinear", "nearest", "super_pixel")}
    t = frames_from_numpy(cfa, dev)
    vng_ms, vout = cuda_ms(lambda: demosaic.vng_torch(t, "RGGB"))
    ahd_ms, aout = cuda_ms(lambda: demosaic.ahd_torch(t, "RGGB"))
    vout, aout = u16_to_numpy(vout), u16_to_numpy(aout)
    del t
    torch.cuda.empty_cache()
    nbytes = (2 + 3 * 2) * h * w
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"timing [{card}] demosaic of one {w}x{h} RGGB frame (median of {REPS} warm "
          f"runs): on the host (host clock) "
          + " ".join(f"{k}_ms={v:.3f}" for k, v in ms.items())
          + f"; on the card (CUDA events) vng_torch_ms={vng_ms:.3f} "
          f"ahd_torch_ms={ahd_ms:.3f}; bytes bound of a card method {bound:.4f} ms "
          f"({nbytes} bytes: the uint16 CFA read once, three uint16 planes written "
          f"once, at {HBM_BYTES_PER_S:.3g} B/s)", flush=True)
    t0 = time.perf_counter()
    vh = demosaic.vng(cfa, "RGGB")
    vng_s = time.perf_counter() - t0
    if not np.array_equal(vout, vh):
        fail(f"phase11b: the card's VNG differs from the NumPy vng on "
             f"{int((vout != vh).sum())} words")
    del vh
    t0 = time.perf_counter()
    ah = demosaic.ahd(cfa, "RGGB")
    ahd_s = time.perf_counter() - t0
    d = np.abs(aout.astype(np.int64) - ah)
    ndiff = int((d != 0).sum())
    if ndiff > 1e-5 * d.size:
        fail(f"phase11b: the card's AHD differs from the NumPy ahd on {ndiff} words "
             f"(max {int(d.max())})")
    print(f"phase11b card against the host: vng_torch equal to the NumPy vng "
          f"({vng_s:.3f} s on the host); ahd_torch against the NumPy ahd ({ahd_s:.3f} s "
          f"on the host): {ndiff} of {d.size} words differ, max|diff| {int(d.max())} "
          f"[{card}]", flush=True)


def phase11(rs, rec, dev, card):
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfa0 = phase11a(rs, rec, dev, card, tmp)
    print("phase11a the temporary directory and its files removed", flush=True)
    phase11b(dev, card, cfa0)


#: the phase-12 session, as a user types it; its boxselect is phase 5's
#: 512 x 512 central selection (x = y = 1792 at 4096 x 4096)
SESSION12 = """cd darks
convert d
seqload d
stack median
cd ../lights
seqload light
preprocess -dark=../darks/d_stacked
seqload pp_light
boxselect {x} {y} 512 512
register dft
stack mean sigma 3 3
bgextract
autostretch
save final
savebmp final
savepnm final
"""
#: phase 12b: post-processing of ``final`` through the same state
POST12 = ("fftd mod pha", "ffti mod pha", "load final", "wavelet 4",
          "wrecons 1 1 1 1", "load final", "save R", "gauss 2", "save G",
          "load final", "unsharp 2 0.5", "save B", "rgbcomp R G B final",
          "satu 0.5", "rmgreen 0", "savebmp colour")


def make_session12(tmp: str, dev):
    """A mono CMOS night of CONFIG12 in ``tmp``: ``darks/dark.ser`` (a fixed
    pattern near 150 with 0.1% hot pixels, plus fresh read noise each
    frame) and ``lights/light.ser`` (make_frames' sky with its drifts, no
    per-frame outliers, plus the same dark pattern and fresh read noise),
    written frame by frame as a capture program writes SER. Returns the
    lights' registration shifts and the seconds to make and write them."""
    import torch
    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.io.ser import SerFile
    from siriltpu_torch.utils.interop import i32_to_u16, u16_to_i32, u16_to_numpy

    ndark, nlight, h, w = CONFIG12
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    kw = dict(generator=g, device=dev)
    pattern = 150.0 + 3.0 * torch.randn((h, w), **kw)
    nhot = h * w // 1000
    hot = torch.randint(0, h * w, (nhot,), **kw)
    pattern.view(-1)[hot] += 2000.0 + 20000.0 * torch.rand((nhot,), **kw)
    lights, shifts = make_frames(nlight, h, w, seed=12, dev=dev, outliers=0)

    def word(x):
        return u16_to_numpy(i32_to_u16(torch.round(x).clamp(0, 65535)))

    for sub, name, n in (("darks", "dark.ser", ndark), ("lights", "light.ser", nlight)):
        os.makedirs(os.path.join(tmp, sub))
        ser = SerFile.create(os.path.join(tmp, sub, name), width=w, height=h)
        for i in range(n):
            x = pattern + 4.0 * torch.randn((h, w), **kw)
            if sub == "lights":
                x += u16_to_i32(lights[i, 0])
            ser.write_frame(Frame(word(x)[None]))
        ser.write_and_close()
    del lights, pattern
    torch.cuda.empty_cache()
    return shifts, time.perf_counter() - t0


def fits_sans_date(path: str) -> bytes:
    """A FITS file's bytes with the value of its DATE card (the time it was
    written) blanked."""
    raw = bytearray(open(path, "rb").read())
    for off in range(0, len(raw), 80):
        if raw[off:off + 8] == b"DATE    ":
            raw[off + 10:off + 30] = b" " * 20
            break
    return bytes(raw)


def run_lines(state, lines, label: str, card: str):
    """Each line through process_command, on the host clock with the card
    synchronized after it; any line that fails fails the run. Returns the
    seconds of each line."""
    import torch
    from siriltpu_torch.cli.commands import process_command

    secs = []
    for line in lines:
        t0 = time.perf_counter()
        rc = process_command(state, line)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if rc != 0:
            fail(f"{label}: '{line}' failed: {state.log_lines[-1:]}")
        print(f"{label} {secs[-1]:.3f} s  {line} [{card}]", flush=True)
    return secs


def stack_against_plain(rs, rec, dev, frames, shifts, kernel: str, got):
    """Hold a session stack to the plain version: the (F, P) values built
    with other code (reference_flat) through the kernel's plain PyTorch
    version in 2^20-pixel chunks, against the stack's words ``got``; and the
    kernel itself against its plain version at this shape. Returns the
    kernel's and the plain version's ms there."""
    import torch
    from siriltpu_torch.ops.rejection import masked_median, reject_and_mean
    from siriltpu_torch.utils.interop import frames_from_numpy

    method, sig = ("median", SIGS["median"]) if kernel == "median" else ("mean", SIGS[kernel])
    flat = reference_flat(frames, shifts, method, None)
    img = frames_from_numpy(got, dev).reshape(-1)
    kout = rs.reject_cuda(flat, kernel, *sig)
    errs = []
    for a in range(0, flat.shape[1], CHUNK):
        v = flat[:, a:a + CHUNK]
        want = (masked_median(v),) if kernel == "median" else reject_and_mean(v, kernel, sig)
        errs.append(max_abs_diff(img[a:a + CHUNK], want[0]))
        plain = rs.reject_plain(v, kernel, *sig)
        errs += [max_abs_diff(k[a:a + CHUNK], p) for k, p in zip(kout, plain)]
    torch.cuda.synchronize()
    rec.check(kernel, errs, f"phase12 {kernel} stack of the session against the plain version")
    k_ms, _ = cuda_ms(lambda: rs.reject_cuda(flat, kernel, *sig))
    p_ms, _ = cuda_ms(chunked(lambda v: rs.reject_plain(v, kernel, *sig), flat))
    del flat, kout
    torch.cuda.empty_cache()
    return k_ms, p_ms


def phase12a(rs, rec, dev, card, tmp):
    """The scripted session: through ``python -m siriltpu_torch`` in a
    subprocess, then line by line in this process; and its checks."""
    import torch
    from siriltpu_torch.cli.main import make_state
    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.io.fits import read_fits
    from siriltpu_torch.io.formats import _to_display8, load_bmp, load_pnm, save_pnm
    from siriltpu_torch.io.seqfile import read_seqfile
    from siriltpu_torch.io.sequence import ser_sequence
    from siriltpu_torch.ops.background import BackgroundParams, subtract_background
    from siriltpu_torch.ops.histogram_ops import autostretch
    from siriltpu_torch.stacking.api import stack_sequence
    from siriltpu_torch.utils.interop import frames_from_numpy

    ndark, nlight, h, w = CONFIG12
    shifts, made_s = make_session12(tmp, dev)
    print(f"phase12a {ndark} darks and {nlight} lights of {w}x{h} made on the card and "
          f"written as SER files in {made_s:.2f} s; {shutil.disk_usage(tmp).free} bytes "
          f"free there [{card}]", flush=True)
    session = SESSION12.format(x=(w - 512) // 2, y=(h - 512) // 2)
    script = os.path.join(tmp, "session.ssf")
    with open(script, "w") as f:
        f.write(session)
    darks, lights = os.path.join(tmp, "darks"), os.path.join(tmp, "lights")

    # ---- the session as a user runs it
    torch.cuda.empty_cache()
    sub_s = cli_subprocess(tmp, script, "phase12a")
    seq = read_seqfile(os.path.join(lights, "pp_light.seq"))
    if not np.array_equal(seq.reg_shifts(0), shifts):
        fail("phase12a: the subprocess's pp_light.seq holds other shifts than the "
             "planted ones")
    outs = {name: fits_sans_date(os.path.join(d, name)) for d, name in (
        (darks, "d_stacked.fit"), (lights, "pp_light_stacked.fit"), (lights, "final.fit"))}
    outs.update({name: open(os.path.join(lights, name), "rb").read()
                 for name in ("final.bmp", "final.pgm")})
    print(f"phase12a python -m siriltpu_torch -d DIR -s session.ssf: exit 0 in {sub_s:.3f} s "
          f"(the interpreter's start and torch's import included); shifts in pp_light.seq "
          f"equal the planted ones [{card}]", flush=True)

    # ---- the same lines in this process, each timed
    lines = [l for l in session.splitlines() if l.strip()]
    state = make_state(tmp, device=dev)
    reset_counts()
    secs = run_lines(state, lines, "phase12a", card)
    launches = kernel_launches()
    rec.count(launches, "the scripted session", "median")
    if launches["sigma"] < 1:
        fail("the scripted session did not launch the sigma kernel")
    upto = lines.index("save final") + 1
    print(f"phase12a the session in this process: launches={launches}; "
          f"{nlight / sum(secs[:upto]):.4f} frames/s from its first line to 'save final' "
          f"({sum(secs[:upto]):.3f} s for {nlight} lights, one run, host clock); by command "
          + ", ".join(f"{l.split()[0]} {s:.3f}" for l, s in zip(lines, secs))
          + f" [{card}]", flush=True)
    for name, want in outs.items():
        path = os.path.join(darks if name.startswith("d_") else lights, name)
        got = fits_sans_date(path) if name.endswith(".fit") else open(path, "rb").read()
        if got != want:
            fail(f"phase12a: this process's {name} differs from the subprocess's")
    if not np.array_equal(state.seq.reg_shifts(0), shifts):
        fail("phase12a: register dft recovered other shifts than the planted ones")

    # ---- the master dark: the plain median of the darks on the card
    dseq = ser_sequence(os.path.join(darks, "dark.ser"))
    dvals = frames_from_numpy(np.stack([dseq.read_frame(i).data for i in range(ndark)]), dev)
    master = read_fits(os.path.join(darks, "d_stacked.fit")).data
    med_ms = stack_against_plain(rs, rec, dev, dvals, np.zeros((ndark, 2), np.int32),
                                 "median", master[0])
    del dvals

    # ---- the lights' stack: the library chain by hand, and the plain version
    stack = read_fits(os.path.join(lights, "pp_light_stacked.fit")).data
    t0 = time.perf_counter()
    res = stack_sequence(read_seqfile(os.path.join(lights, "pp_light.seq")), device=dev,
                         method="mean", rejection="sigma", sig=SIGS["sigma"])
    hand_s = time.perf_counter() - t0
    if not np.array_equal(res.data, stack):
        fail("phase12a: pp_light_stacked.fit differs from stack_sequence composed by hand")
    pseq = ser_sequence(os.path.join(lights, "pp_light.ser"))
    pvals = frames_from_numpy(np.stack([pseq.read_frame(i).data for i in range(nlight)]), dev)
    sig_ms = stack_against_plain(rs, rec, dev, pvals, shifts, "sigma", stack[0])
    del pvals
    torch.cuda.empty_cache()

    # ---- the stretched result and its 8- and 16-bit files
    final = read_fits(os.path.join(lights, "final.fit")).data
    if not np.array_equal(final, autostretch(subtract_background(
            stack, BackgroundParams(order=4)))):
        fail("phase12a: final.fit differs from autostretch(subtract_background(stack))")
    if not np.array_equal(load_bmp(os.path.join(lights, "final.bmp")).data,
                          np.repeat(_to_display8(Frame(final)), 3, axis=0)):
        fail("phase12a: final.bmp reads back other than _to_display8(final)")
    pnm = os.path.join(tmp, "check.pgm")
    save_pnm(pnm, Frame(final))
    if (open(pnm, "rb").read() != outs["final.pgm"]
            or not np.array_equal(load_pnm(pnm).data, final)):
        fail("phase12a: final.pgm differs from save_pnm(final)")
    print(f"phase12a checks: the subprocess's and this process's d_stacked.fit, "
          f"pp_light_stacked.fit, final.fit (but their DATE), final.bmp and final.pgm "
          f"equal; d_stacked.fit equals the plain median of the {ndark} darks (median kernel "
          f"{med_ms[0]:.3f} ms, plain {med_ms[1]:.3f} ms at {ndark}x{h * w}); "
          f"pp_light_stacked.fit equals stack_sequence composed by hand ({hand_s:.3f} s) "
          f"and the plain sigma version (sigma kernel {sig_ms[0]:.3f} ms, plain "
          f"{sig_ms[1]:.3f} ms at {nlight}x{h * w}); final.fit equals the stack's background "
          f"subtracted and stretched by hand, median {float(np.median(final)):.1f}; final.bmp "
          f"and final.pgm read back as _to_display8 and save_pnm make them [{card}]",
          flush=True)
    return state, final


def phase12b(dev, card, state, final):
    """Post-processing of the session's 4096 x 4096 result, line by line in
    the same state."""
    import torch
    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.io.fits import read_fits
    from siriltpu_torch.ops.colors import enhance_saturation, scnr
    from siriltpu_torch.ops.wavelets import atrous_transform
    from siriltpu_torch.pipelines.compositing import CompositionLayer, compose
    from siriltpu_torch.utils.rounding import np_round_to_word

    def off(img):
        d = np.abs(img.astype(np.int64) - final)
        return int(d.max()), float((d != 0).mean())

    secs = run_lines(state, POST12[:2], "phase12b", card)
    fft_err = off(state.image.data)
    # fftd stores the modulus in 16 bits of its largest value (the DC term),
    # so the round trip loses what lies under that step: the JAX test's 1 LSB
    # holds at 16 x 16 only. Held instead to the same quantization by hand,
    # NumPy's fft2 of the square image (no transpose, no quadrant swap)
    t0 = time.perf_counter()
    spec = np.fft.fft2(final[0].astype(np.float64))
    top = np.abs(spec).max()
    mod = np_round_to_word(np.abs(spec) * 65535.0 / top) * (top / 65535.0)
    pha = np_round_to_word((np.angle(spec) + np.pi) * 65535.0 / (2 * np.pi))
    back = np_round_to_word(np.fft.ifft2(mod * np.exp(1j * (pha * (2 * np.pi) / 65535.0
                                                             - np.pi))).real)
    fft_hand_s = time.perf_counter() - t0
    dh = np.abs(state.image.data[0].astype(np.int64) - back)
    del spec, mod, pha, back
    secs += run_lines(state, POST12[2:5], "phase12b", card)
    wav_err = off(state.image.data)
    if dh.max() > 1 or wav_err[0] > 1:
        fail(f"phase12b: fftd/ffti {int(dh.max())} LSB from the quantized transform by "
             f"hand, or wavelet/wrecons {wav_err} (max|diff|, share of words off) from "
             f"final, beyond 1 LSB")
    t0 = time.perf_counter()
    cpu = atrous_transform(torch.from_numpy(final[0].astype(np.int32)), 4).numpy()
    cpu_s = time.perf_counter() - t0
    plane_err = float(np.abs(state._wavelets[0] - cpu).max())
    if plane_err > 0.02:
        fail(f"phase12b: the card's wavelet planes differ from the CPU's by {plane_err}")
    secs += run_lines(state, POST12[5:], "phase12b", card)
    d = state.cwd
    planes = [read_fits(os.path.join(d, f"{n}.fit")).data for n in ("R", "G", "B")]
    t0 = time.perf_counter()
    want = compose([CompositionLayer(Frame(p), c) for p, c in
                    zip(planes, ((1.0, 0, 0), (0, 1.0, 0), (0, 0, 1.0)))],
                   luminance=Frame(final)).data
    want = scnr(enhance_saturation(want, 0.5), 0)
    hand_s = time.perf_counter() - t0
    if not np.array_equal(state.image.data, want):
        fail("phase12b: the colour result differs from compose, enhance_saturation and "
             "scnr applied by hand")
    print(f"phase12b post-processing of the {final.shape[2]}x{final.shape[1]} result: "
          f"fftd+ffti {int(dh.max())} LSB from the 16-bit quantized transform by hand on "
          f"{float((dh != 0).mean()):.3e} of the words ({fft_hand_s:.3f} s), {fft_err[0]} LSB "
          f"from final on {fft_err[1]:.3e} of them; "
          f"wavelet+wrecons {wav_err[0]} LSB on {wav_err[1]:.3e} of the words; the card's "
          f"planes within {plane_err:.3g} of the CPU's ({cpu_s:.3f} s there); RGB "
          f"composition, saturation and SCNR equal the host functions by hand "
          f"({hand_s:.3f} s); by command "
          + ", ".join(f"{l.split()[0]} {s:.3f}" for l, s in zip(POST12, secs))
          + f" [{card}]", flush=True)


def phase12(rs, rec, dev, card):
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        state, final = phase12a(rs, rec, dev, card, tmp)
        phase12b(dev, card, state, final)
        state.undo.flush()
        size = sum(os.path.getsize(os.path.join(r, n))
                   for r, _, names in os.walk(tmp) for n in names)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase12 {size} bytes of input and output files removed", flush=True)


#: phase 13a: the planetary film's script (BASELINE config 3 as a DIB AVI)
FILM13 = """seqload jupiter.avi
register ecc
stack mean winsorized 3 3 additive_scaling
seqexport jup ser
boxselect {x} {y} {s} {s}
seqexport jupc avi
"""
#: phase 13b: the DSLR raw night's script
RAW13 = """convert light -debayer
seqload light
register global
seqload r_light
stack mean sigma 3 3
boxselect {x} {y} {s} {s}
seqexport rc ser
"""


def write_dng(path: str, cfa, pattern: str = "RGGB", lj92: bool = False) -> None:
    """A one-strip CFA DNG of the (H, W) top-down uint16 plane: 16-bit
    little-endian words, or (``lj92``) one lossless-JPEG stream of two
    components (predictor 1, the port's CR2 encoder). Its tags are those of
    tests/test_raw.py's ``write_dng``."""
    import struct
    from siriltpu_torch.testing.cr2 import encode_sof3

    h, w = cfa.shape
    data = encode_sof3(cfa, 2, precision=16) if lj92 else cfa.astype("<u2").tobytes()
    tags = [(254, 4, [0]), (256, 4, [w]), (257, 4, [h]), (258, 3, [16]),
            (259, 3, [7 if lj92 else 1]), (262, 3, [32803]), (273, 4, [0]),
            (277, 3, [1]), (278, 4, [h]), (279, 4, [len(data)]), (33421, 3, [2, 2]),
            (33422, 1, ["RGB".index(c) for c in pattern]), (50706, 1, [1, 4, 0, 0])]
    data_off = 8 + 2 + 12 * len(tags) + 4
    ifd = struct.pack("<H", len(tags))
    for tag, typ, vals in tags:
        vals = [data_off] if tag == 273 else vals
        raw = b"".join(struct.pack("<" + {1: "B", 3: "H", 4: "I"}[typ], v) for v in vals)
        ifd += struct.pack("<HHI", tag, typ, len(vals)) + raw.ljust(4, b"\0")
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 8) + ifd + struct.pack("<I", 0) + data)


def phase13a(rs, rec, dev, card, tmp):
    """The planetary film: BASELINE config 3's frames as a DIB AVI, through
    the command line in a subprocess and line by line, and its checks."""
    import torch
    from siriltpu_torch.cli.main import make_state
    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.io import avi
    from siriltpu_torch.io.films import FilmFile
    from siriltpu_torch.io.fits import read_fits
    from siriltpu_torch.io.ser import SerFile
    from siriltpu_torch.registration import translation
    from siriltpu_torch.stacking import api
    from siriltpu_torch.utils.interop import u16_to_numpy
    from siriltpu_torch.verify.oracle import shift_gather

    frames_dev, shifts = make_disc_frames(*CONFIG3, seed=13, dev=dev)
    frames = u16_to_numpy(frames_dev)
    f, _, h, w = frames.shape
    path = os.path.join(tmp, "jupiter.avi")
    t0 = time.perf_counter()
    wtr = avi.AviWriter(path, w, h, fps=30.0)
    if not wtr.native:
        fail("phase13a: the AVI writer fell back to Python: no native library")
    for fr in frames:
        wtr.write_frame(Frame(fr), 0, 255)
    wtr.close()
    wrote_s = time.perf_counter() - t0
    # the native writer's bytes are the Python writer's, on the first 16 frames
    pair, load = [], avi._load_native
    for native in (True, False):
        p = os.path.join(tmp, f"first16_{native}.avi")
        if not native:
            avi._load_native = lambda: None
        try:
            wtr16 = avi.AviWriter(p, w, h, fps=30.0)
            if wtr16.native != native:
                fail(f"phase13a: the AVI writer's native={wtr16.native}, wanted {native}")
            for fr in frames[:16]:
                wtr16.write_frame(Frame(fr), 0, 255)
            wtr16.close()
        finally:
            avi._load_native = load
        pair.append(open(p, "rb").read())
        os.unlink(p)
    if pair[0] != pair[1]:
        fail("phase13a: the native AVI writer's 16 frames differ from the Python writer's")
    film = FilmFile.open(path)
    if film._backend != "dib" or (film.nb_frames, film.width, film.height) != (f, w, h):
        fail(f"phase13a: the film opened as {film._backend} with "
             f"{(film.nb_frames, film.width, film.height)}")
    t0 = time.perf_counter()
    for i in range(f):
        if not np.array_equal(film.read_frame(i).data, frames[i]):
            fail(f"phase13a: the film reader's frame {i} differs from the planted one")
    read_s = time.perf_counter() - t0
    print(f"phase13a {f} frames of {w}x{h} (peak {int(frames.max())}) written as a DIB "
          f"AVI of {os.path.getsize(path)} bytes by the native writer in {wrote_s:.3f} s "
          f"(its 16-frame file equal to the Python writer's); the film reader's {f} "
          f"frames equal the planted ones ({read_s:.3f} s, backend {film._backend}) "
          f"[{card}]", flush=True)

    script = FILM13.format(x=(w - CROP13[0]) // 2, y=(h - CROP13[0]) // 2, s=CROP13[0])
    with open(os.path.join(tmp, "film.ssf"), "w") as fh:
        fh.write(script)
    sub_s = cli_subprocess(tmp, os.path.join(tmp, "film.ssf"), "phase13a")
    outs = {"jupiter_stacked.fit": fits_sans_date(os.path.join(tmp, "jupiter_stacked.fit"))}
    outs.update({n: open(os.path.join(tmp, n), "rb").read() for n in ("jup.ser", "jupc.avi")})
    print(f"phase13a python -m siriltpu_torch -d DIR -s film.ssf: exit 0 in {sub_s:.3f} s "
          f"[{card}]", flush=True)

    lines = [line for line in script.splitlines() if line.strip()]
    state = make_state(tmp, device=dev)
    stacks, put_stack = kept_calls(api, "stack_sequence")
    reset_counts()
    try:
        with stage_seconds() as ecc:
            secs = run_lines(state, lines, "phase13a", card)
    finally:
        put_stack()
    launches = kernel_launches()
    rec.count(launches, "the film's script", "winsorized")
    to_stack = sum(secs[:3])
    print(f"phase13a the film's script in this process: launches={launches}; {f / to_stack:.3f} "
          f"film frames/s from 'seqload' to the written stack ({to_stack:.3f} s, one run, "
          f"host clock): ECC file reads {ecc['ecc.read']:.3f} s, host quality "
          f"{ecc['ecc.quality']:.3f} s, device loop {ecc['ecc.device']:.3f} s, normalization "
          f"{ecc.get('stack.normalize', 0.0):.3f} s; by command "
          + ", ".join(f"{l.split()[0]} {s:.3f}" for l, s in zip(lines, secs))
          + f" [{card}]", flush=True)
    for name, want in outs.items():
        got = (fits_sans_date(os.path.join(tmp, name)) if name.endswith(".fit")
               else open(os.path.join(tmp, name), "rb").read())
        if got != want:
            fail(f"phase13a: this process's {name} differs from the subprocess's")
    if not np.array_equal(state.seq.reg_shifts(0), shifts):
        bad = int((state.seq.reg_shifts(0) != shifts).any(axis=1).sum())
        fail(f"phase13a: {bad} ECC shifts differ from the planted ones")

    # the stack against stack_frames in memory with the planted shifts, and
    # the kernel at this shape against its plain version
    res = stacks[0]
    sig = SIGS["winsorized"]
    t0 = time.perf_counter()
    want = api.stack_frames(frames_dev, device=dev, shifts=shifts, method="mean",
                            rejection="winsorized", sig=sig, normalize="additive_scaling")
    torch.cuda.synchronize()
    mem_s = time.perf_counter() - t0
    errs = [int(np.abs(res.data.astype(np.int64) - want.data).max()),
            int(np.abs(res.rejection_low - want.rejection_low).max()),
            int(np.abs(res.rejection_high - want.rejection_high).max())]
    rec.check("winsorized", errs, "phase13a the film's stack vs stack_frames in memory")
    if not np.array_equal(read_fits(os.path.join(tmp, "jupiter_stacked.fit")).data, res.data):
        fail("phase13a: jupiter_stacked.fit differs from the stack")
    coeffs = api.compute_normalization(api.ikss_stats(frames_dev), 0, "additive_scaling")
    flat = reference_flat(frames_dev, shifts, "mean", coeffs)
    kout = rs.reject_cuda(flat, "winsorized", *sig)
    kerrs = []
    for a in range(0, flat.shape[1], CHUNK):
        plain = rs.reject_plain(flat[:, a:a + CHUNK], "winsorized", *sig)
        kerrs += [max_abs_diff(k[a:a + CHUNK], p) for k, p in zip(kout, plain)]
    rec.check("winsorized", kerrs, "phase13a the kernel vs its plain version")
    k_ms, _ = cuda_ms(lambda: rs.reject_cuda(flat, "winsorized", *sig))
    del flat, kout, frames_dev
    torch.cuda.empty_cache()

    # the exports: the SER is shift_gather of the planted frames, the
    # cropped AVI _frame_to_dib's mapping of their crop
    ser = SerFile.open(os.path.join(tmp, "jup.ser"))
    crop = os.path.join(tmp, "jupc.avi")
    cfilm = FilmFile.open(crop)
    s = CROP13[0]
    if ser.frame_count != f or cfilm.nb_frames != f or (cfilm.width, cfilm.height) != (s, s):
        fail(f"phase13a: exports of {ser.frame_count} and {cfilm.nb_frames} frames")
    x0, y0 = (w - s) // 2, h - (h - s) // 2 - s   # the top-down selection, bottom-up
    t0 = time.perf_counter()
    for i in range(f):
        moved = shift_gather(frames[i], int(shifts[i, 0]), int(shifts[i, 1]), fill=0,
                             skip_origin=False)
        if not np.array_equal(ser.read_frame(i).data, moved):
            fail(f"phase13a: jup.ser's frame {i} is not shift_gather of the planted frame")
        dib = np.frombuffer(avi._frame_to_dib(
            Frame(moved[:, y0:y0 + s, x0:x0 + s])), np.uint8).reshape(s, s, 3)
        want_c = dib[..., ::-1].transpose(2, 0, 1)   # BGR rows to RGB planes
        if (want_c == want_c[:1]).all():             # grey: the reader's one layer
            want_c = want_c[:1]
        if not np.array_equal(cfilm.read_frame(i).data, want_c):
            fail(f"phase13a: jupc.avi's frame {i} is not _frame_to_dib of the crop")
    check_s = time.perf_counter() - t0
    print(f"phase13a checks: ECC shifts equal the planted ones; the subprocess's and this "
          f"process's jupiter_stacked.fit (but its DATE), jup.ser and jupc.avi equal; the "
          f"stack (image+counters) equals stack_frames of the frames in memory with the "
          f"planted shifts, max|diff|={max(errs)} ({mem_s:.3f} s), rejected low "
          f"{int(res.rejection_low[0])} high {int(res.rejection_high[0])}; the winsorized "
          f"kernel at {f}x{h * w} {k_ms:.3f} ms (median of {REPS} warm runs), equal to its "
          f"plain version; jup.ser's {f} frames equal shift_gather of the planted frames, "
          f"jupc.avi's {f} frames _frame_to_dib of their {s}x{s} crop ({check_s:.3f} s) "
          f"[{card}]", flush=True)


def make_raw_night(tmp: str, dev):
    """CONFIG13's lights as uncompressed 14-bit RGGB DNG files in ``tmp``:
    phase 10's star frames (sky 250, noise 2.5, 500 stars, planted
    homographies; the 16-bit frames shifted down by two bits), mosaiced as
    phase 11 does. Returns the planted homographies and the seconds it
    took."""
    import torch
    from siriltpu_torch.utils.interop import i32_to_u16, u16_to_i32, u16_to_numpy

    f, h, w = CONFIG13
    t0 = time.perf_counter()
    frames, planted = make_config4_frames(f, 3, h, w, seed=13, dev=dev, nstars=NSTARS13)
    for i in range(f):
        cfa = mosaic_rggb_bu(i32_to_u16(u16_to_i32(frames[i]) >> 2)).flip(0)
        write_dng(os.path.join(tmp, f"L_{i + 1:04d}.dng"),
                  u16_to_numpy(cfa.view(torch.uint16)))
    del frames
    torch.cuda.empty_cache()
    return planted, time.perf_counter() - t0


def phase13b(rs, rec, dev, card, tmp):
    """A DSLR raw night through the command line, line by line, and its
    checks."""
    import torch
    from siriltpu_torch.cli.main import make_state
    from siriltpu_torch.core.config import Settings
    from siriltpu_torch.io.fits import read_fits
    from siriltpu_torch.io.raw import read_raw
    from siriltpu_torch.io.ser import SerFile
    from siriltpu_torch.ops import demosaic
    from siriltpu_torch.ops.rejection import reject_and_mean
    from siriltpu_torch.registration import global_star
    from siriltpu_torch.stacking import api
    from siriltpu_torch.utils.interop import frames_from_numpy

    f, h, w = CONFIG13
    planted, made_s = make_raw_night(tmp, dev)
    dngs = sorted(n for n in os.listdir(tmp) if n.endswith(".dng"))
    print(f"phase13b {f} RGGB lights of {w}x{h} (14-bit) made on the card and written "
          f"as DNG files ({sum(os.path.getsize(os.path.join(tmp, n)) for n in dngs)} "
          f"bytes) in {made_s:.2f} s; {shutil.disk_usage(tmp).free} bytes free there "
          f"[{card}]", flush=True)
    s = CROP13[1]
    script = RAW13.format(x=(w - s) // 2, y=(h - s) // 2, s=s)
    lines = [line for line in script.splitlines() if line.strip()]
    state = make_state(tmp, device=dev)
    on_card = []
    ahd = demosaic.ahd_device

    def counted(cfa, pattern, *, device):
        on_card.append(str(device))
        return ahd(cfa, pattern, device=device)
    demosaic.ahd_device = counted
    reports, put_reg = kept_calls(global_star, "register_global_star")
    stacks, put_stack = kept_calls(api, "stack_sequence")
    reset_counts()
    try:
        with stage_seconds() as stages:
            secs = run_lines(state, lines, "phase13b", card)
    finally:
        demosaic.ahd_device = ahd
        put_reg()
        put_stack()
    launches = kernel_launches()
    rec.count(launches, "the raw night's script", "sigma")
    if on_card != [str(torch.device(dev))] * f:
        fail(f"phase13b: convert's AHD ran {on_card}, not once a light on {dev}")
    to_stack = sum(secs[:5])
    print(f"phase13b the raw night's script in this process: launches={launches}; "
          f"convert {secs[0] / f:.3f} s a light (decode, AHD on the card, FITS written), "
          f"{f / to_stack:.4f} frames/s from 'convert' to the written stack "
          f"({to_stack:.3f} s, one run, host clock); registration "
          f"{({k: round(v, 3) for k, v in stages.items() if k.startswith('global.')})}; by command "
          + ", ".join(f"{l.split()[0]} {s:.3f}" for l, s in zip(lines, secs))
          + f" [{card}]", flush=True)

    # each converted FITS is read_raw's frame composed by hand
    t0 = time.perf_counter()
    for k, name in enumerate(dngs):
        got = read_fits(os.path.join(tmp, f"light{k + 1:05d}.fit")).data
        if not np.array_equal(got, read_raw(os.path.join(tmp, name), settings=Settings(),
                                            device=dev).data):
            fail(f"phase13b: light{k + 1:05d}.fit differs from read_raw of {name}")
    raw_s = time.perf_counter() - t0
    rep = reports[0]
    if rep.registered != f or rep.failed:
        fail(f"phase13b: {rep.registered} of {f} lights registered, {rep.failed} failed")
    errs = [corner_error(H, p, h, w) for H, p in zip(rep.homographies, planted)]
    if max(errs) > 0.1:
        fail(f"phase13b: light {int(np.argmax(errs))}'s homography moves a corner "
             f"{max(errs):.4f} px from the planted one's")

    # the sigma stack of the r_ lights against the plain version
    res = stacks[0]
    sig = SIGS["sigma"]
    regged = np.stack([read_fits(os.path.join(tmp, f"r_light{k + 1:05d}.fit")).data
                       for k in range(f)])
    vals = frames_from_numpy(regged, dev).view(torch.int16)
    perrs = []
    for ch in range(3):
        flat = vals[:, ch].reshape(f, -1).view(torch.uint16)
        img = frames_from_numpy(res.data[ch], dev).reshape(-1)
        rl = rh = 0
        for a in range(0, flat.shape[1], CHUNK):
            pm, pl, ph = reject_and_mean(flat[:, a:a + CHUNK], "sigma", sig)
            perrs.append(max_abs_diff(img[a:a + CHUNK], pm))
            rl += int(pl.sum())
            rh += int(ph.sum())
        perrs += [abs(int(res.rejection_low[ch]) - rl), abs(int(res.rejection_high[ch]) - rh)]
    del vals, flat
    torch.cuda.empty_cache()
    rec.check("sigma", perrs, "phase13b the sigma stack of the r_ lights vs the plain version")
    if not np.array_equal(read_fits(os.path.join(tmp, "r_light_stacked.fit")).data, res.data):
        fail("phase13b: r_light_stacked.fit differs from the stack")

    # the exported crop is the r_ lights' crop (a top-down selection)
    x0, y0 = (w - s) // 2, h - (h - s) // 2 - s
    ser = SerFile.open(os.path.join(tmp, "rc.ser"))
    if ser.frame_count != f:
        fail(f"phase13b: rc.ser holds {ser.frame_count} frames")
    for k in range(f):
        if not np.array_equal(ser.read_frame(k).data,
                              regged[k][:, y0:y0 + s, x0:x0 + s]):
            fail(f"phase13b: rc.ser's frame {k} is not the r_ light's crop")
    print(f"phase13b checks: each lightNNNNN.fit equals read_raw of its DNG composed by "
          f"hand ({raw_s:.3f} s), AHD on {dev} once a light; {f} of {f} registered, "
          f"corners within {max(errs):.5f} px of the planted homographies (median "
          f"{np.median(errs):.5f}); the sigma stack (image+counters, 3 channels) equals "
          f"the plain version, max|diff|={max(perrs)}, rejected low "
          f"{res.rejection_low.tolist()} high {res.rejection_high.tolist()}; rc.ser's {f} "
          f"frames equal the r_ lights' {s}x{s} crop [{card}]", flush=True)


def phase13c(card, tmp):
    """Every raw decoder that runs native code (and the three that do not),
    on files the port's writers make, and the native build's place."""
    import hashlib
    from siriltpu_torch.io import film_codec
    from siriltpu_torch.io.raw import read_raw_cfa
    from siriltpu_torch.testing import arw, cr2, crw, mrw, nef, orf, pef, raf, rw2
    from siriltpu_torch.utils import native

    def tree():
        return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
                for p in sorted(native.NATIVE_DIR.iterdir()) if p.is_file()}
    before = tree()
    h, w = NATIVE13
    rng = np.random.default_rng(130)
    img14 = rng.integers(0, 1 << 14, (h, w)).astype(np.uint16)
    img12 = rng.integers(0, 1 << 12, (h, w)).astype(np.uint16)
    smooth = np.clip(rng.integers(300, 700) + np.cumsum(rng.integers(-9, 10, (h, w)), axis=1),
                     0, 4095).astype(np.uint16)
    # Sony blocks whose 16 same-parity pixels span <= 127 values are exact
    base = rng.integers(0, 0x7FF - 127, (h, w // 32, 2))
    pix = np.repeat(base.reshape(h, -1), 16, axis=1).reshape(h, w // 32, 2, 16)
    pix = pix + rng.integers(0, 128, pix.shape)
    sony = np.zeros((h, w), np.int64)
    cols = (32 * np.arange(w // 32)[:, None] + 2 * np.arange(16)[None, :]).ravel()
    sony[:, cols] = pix[:, :, 0, :].reshape(h, -1)
    sony[:, cols + 1] = pix[:, :, 1, :].reshape(h, -1)

    def p(name):
        return os.path.join(tmp, name)
    cases = {   # name -> (writer, the plane it must decode to, its pattern)
        "lj92.cr2": (lambda: cr2.write_cr2(p("lj92.cr2"), img14), img14, "RGGB"),
        "lj92.dng": (lambda: write_dng(p("lj92.dng"), img14, "GRBG", lj92=True),
                     img14, "GRBG"),
        "nikon.nef": (lambda: nef.write_nef(p("nikon.nef"), img14, bps=14, lossless=True),
                      img14, "RGGB"),
        "pentax.pef": (lambda: pef.write_pef(p("pentax.pef"), img12, bps=12), img12, "BGGR"),
        "olympus.orf": (lambda: orf.write_orf(p("olympus.orf"), img12), img12, "GRBG"),
        "panasonic.rw2": (lambda: rw2.write_rw2(p("panasonic.rw2"), img12), None, "BGGR"),
        "canon.crw": (lambda: crw.write_crw(p("canon.crw"), smooth, lowbits=True),
                      smooth, "RGGB"),
        "sony.arw": (lambda: arw.write_arw(p("sony.arw"), arw.encode_arw2(sony), h, w),
                     (sony << 3).astype(np.uint16), "RGGB"),
        "minolta.mrw": (lambda: mrw.write_mrw(p("minolta.mrw"), img12), img12, "RGGB"),
        "fuji.raf": (lambda: raf.write_raf(p("fuji.raf"), img14), img14, "GBRG"),
    }
    secs = {}
    for name, (write, want, pattern) in cases.items():
        t0 = time.perf_counter()
        tracked = write()
        t1 = time.perf_counter()
        got = read_raw_cfa(p(name))
        secs[name] = (t1 - t0, time.perf_counter() - t1)
        # the Panasonic scheme quantizes random content: its encoder's own
        # tracked decode is what a decoder must return
        want = tracked if want is None else want
        if got.meta["bayer_pattern"] != pattern or not np.array_equal(got.data[0][::-1], want):
            fail(f"phase13c: {name} decodes to another plane or pattern "
                 f"({got.meta['bayer_pattern']})")
    lib = native.load_native()
    if lib is None or os.path.dirname(os.path.realpath(lib._name)) != os.path.realpath(
            str(native.BUILD_DIR)):
        fail(f"phase13c: the native library is {lib and lib._name}, not under _build/")
    if tree() != before:
        fail("phase13c: files under siril-0.9_tpu/native/ changed")
    print(f"phase13c {len(cases)} raw files of {w}x{h} decoded to their planted planes and "
          f"patterns (write s, decode s: "
          + ", ".join(f"{n} {a:.2f}/{b:.3f}" for n, (a, b) in secs.items())
          + f"); the native library {os.path.basename(lib._name)} under _build/; nothing "
          f"under native/ changed; the libav film bridge "
          f"{'builds' if film_codec.available() else 'is not available (no libav)'} "
          f"[{card}]", flush=True)


def phase13(rs, rec, dev, card):
    for part, run in (("a", lambda tmp: phase13a(rs, rec, dev, card, tmp)),
                      ("b", lambda tmp: phase13b(rs, rec, dev, card, tmp)),
                      ("c", lambda tmp: phase13c(card, tmp))):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            t0 = time.perf_counter()
            run(tmp)
            size = sum(os.path.getsize(os.path.join(r, n))
                       for r, _, names in os.walk(tmp) for n in names)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(f"phase13{part} {time.perf_counter() - t0:.1f} s; {size} bytes of input and "
              f"output files removed", flush=True)


#: phase 14: the sum stack's sequence (frames, height, width), the shards
#: of each mesh on the one card, and the north star's rows cut so that the
#: row-slab stack's last slab is short (4094 % 4 != 0)
CONFIG14_SUM = (16, 2048, 2048)
SHARDS14 = 4
ROWS14 = 4094


def phase14a(rs, rec, dev, card):
    """The sharded register + sigma stack at the north star's shape over a
    4-shard frames mesh on the card, against the unsharded stack_frames; the
    same stack fed per process (make_multihost_register_stack); the
    row-slab stack over a (1, 4) mesh with a height that 4 does not
    divide."""
    import torch
    from siriltpu_torch.ops.rejection import reject_and_mean
    from siriltpu_torch.parallel.mesh import make_mesh
    from siriltpu_torch.parallel.multihost import make_multihost_register_stack
    from siriltpu_torch.parallel.sharded import (make_rows_sigma_stack,
                                                 make_sharded_register_stack)
    from siriltpu_torch.pipelines import register_stack as prs
    from siriltpu_torch.stacking.api import stack_frames
    from siriltpu_torch.utils.interop import frames_from_numpy, u16_to_numpy

    bench = prs.RegisterStackBench(size=SIZE, nframes=NFRAMES, seed=0, device=dev)
    frames = bench.frames()
    mesh = make_mesh(("frames",), devices=[dev] * SHARDS14)
    run = make_sharded_register_stack(mesh, bench.sel, "sigma", (SIG, SIG))
    reset_counts()
    out, shifts = run(frames)
    torch.cuda.synchronize()
    launches = kernel_launches()
    rec.count(launches, "make_sharded_register_stack", "sigma")
    if not np.array_equal(shifts, -bench.shifts):
        fail("phase14: the sharded registration's shifts differ from the planted ones")
    if out.shape != (SIZE, SIZE) or out.dtype != np.uint16:
        fail(f"phase14: sharded stack {out.shape} {out.dtype}")
    def unsharded():
        return stack_frames(frames.reshape(NFRAMES, 1, SIZE, SIZE), device=dev,
                            method="mean", shifts=shifts, rejection="sigma",
                            sig=(SIG, SIG))

    want = unsharded()
    diff = int(np.abs(out.astype(np.int64) - want.data[0]).max())
    if diff:
        fail(f"phase14: make_sharded_register_stack against stack_frames: max|diff| {diff}")
    print(f"phase14a make_sharded_register_stack {NFRAMES}x{SIZE}x{SIZE} over "
          f"{SHARDS14} shards on {dev}, NCCL world size 1: shifts exact, kernel "
          f"launches={launches}, bit-equal to stack_frames", flush=True)
    # warm runs: the first call above also set up NCCL's communicator and
    # cuFFT's plans
    sharded_ms, _ = cuda_ms(lambda: run(frames), reps=1)
    plain_ms, _ = cuda_ms(unsharded, reps=1)
    print(f"timing [{card}] phase14a (CUDA events, one warm run each, the result "
          f"to the host included): make_sharded_register_stack {sharded_ms:.3f} ms, "
          f"{NFRAMES / sharded_ms * 1e3:.3f} frames/s (registration, alignment and "
          f"stack); unsharded stack_frames with the same shifts {plain_ms:.3f} ms "
          f"(alignment and stack)", flush=True)
    del want

    # the same stack fed per process: read_frame over the host copy, the
    # frames all-gathered on NCCL as int32, then the sharded stack
    host = u16_to_numpy(frames)
    fed = []

    def read_frame(i):
        fed.append(i)
        return host[i]

    mh = make_multihost_register_stack(mesh, bench.sel, "sigma", (SIG, SIG))
    reset_counts()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    got = mh(read_frame, NFRAMES, (SIZE, SIZE))
    b.record()
    torch.cuda.synchronize()
    launches = kernel_launches()
    rec.count(launches, "make_multihost_register_stack", "sigma")
    if fed != list(range(NFRAMES)) or not np.array_equal(got, out):
        fail(f"phase14: make_multihost_register_stack read frames {fed[:3]}... and "
             f"differs from make_sharded_register_stack by "
             f"{int(np.abs(got.astype(np.int64) - out).max())}")
    print(f"timing [{card}] phase14a make_multihost_register_stack {NFRAMES}x{SIZE}x"
          f"{SIZE} over {SHARDS14} shards, NCCL world size 1: {a.elapsed_time(b):.3f} ms "
          f"(CUDA events, one run, from the host frames to the host result: reads, "
          f"int32 all_gather, registration and stack); kernel launches={launches}; "
          f"bit-equal to make_sharded_register_stack", flush=True)
    del host, got
    torch.cuda.empty_cache()

    # the row-slab stack of the aligned frames, cut to ROWS14 rows
    sx = torch.from_numpy(shifts[:, 0]).to(dev)
    sy = torch.from_numpy(shifts[:, 1]).to(dev)
    aligned = prs.align_frames_slice(frames, sx, sy)[:, :ROWS14]
    del frames, bench
    torch.cuda.empty_cache()
    slab = make_rows_sigma_stack(make_mesh(("frames", "rows"), (1, SHARDS14),
                                           devices=[dev] * SHARDS14))
    reset_counts()
    got = slab(aligned)
    torch.cuda.synchronize()
    launches = kernel_launches()
    rec.count(launches, "make_rows_sigma_stack", "sigma")
    rows_ms, _ = cuda_ms(lambda: slab(aligned), reps=1)
    flat = aligned.reshape(NFRAMES, -1).contiguous()   # a copy of the cut rows
    whole = rs.reject_stack(flat, "sigma", SIG, SIG, with_counters=True)
    torch.cuda.synchronize()
    got_dev = frames_from_numpy(got.reshape(-1), dev)
    errs = [max_abs_diff(got_dev, whole[0])]
    for a in range(0, flat.shape[1], CHUNK):
        pm = rs.reject_plain(flat[:, a:a + CHUNK], "sigma", SIG, SIG)[0]
        errs.append(max_abs_diff(got_dev[a:a + CHUNK], pm))
    torch.cuda.synchronize()
    print(f"phase14a make_rows_sigma_stack {NFRAMES}x{ROWS14}x{SIZE} over a (1, "
          f"{SHARDS14}) (frames, rows) mesh: kernel launches={launches}; against one "
          f"reject_stack of the whole frame and reject_plain in 2^20-pixel chunks "
          f"max|diff| {max(errs)}; {rows_ms:.3f} ms (CUDA events, one warm run, "
          f"the result to the host included) [{card}]", flush=True)
    rec.check("sigma", errs, "make_rows_sigma_stack vs one stack and the plain version")
    del aligned, flat, whole, got_dev
    torch.cuda.empty_cache()


def phase14b(rs, rec, dev, card):
    """The sharded sum stack, all-reduced, against the NumPy oracle; the
    star finder and the batched global alignment over a 2-shard mesh against
    their unsharded calls."""
    import torch
    from siriltpu_torch.ops import starfind
    from siriltpu_torch.parallel.mesh import make_mesh
    from siriltpu_torch.parallel.sharded import make_sharded_sum_stack
    from siriltpu_torch.registration.global_star import global_align_batch
    from siriltpu_torch.utils.interop import u16_to_numpy
    from siriltpu_torch.verify import oracle

    frames, shifts = make_frames(*CONFIG14_SUM, seed=14, dev=dev)
    f, _, h, w = frames.shape
    run = make_sharded_sum_stack(make_mesh(("frames",), devices=[dev] * SHARDS14))
    sum_ms, (got, hi) = cuda_ms(lambda: run(frames[:, 0], shifts), reps=1)
    host = u16_to_numpy(frames)
    del frames
    t0 = time.perf_counter()
    want, hi_w = oracle.stack_sum(host, shifts)
    oracle_s = time.perf_counter() - t0
    diff = int(np.abs(got.astype(np.int64) - want[0]).max())
    if diff or hi != hi_w:
        fail(f"phase14b: make_sharded_sum_stack against oracle.stack_sum: "
             f"max|diff| {diff}, hi {hi} against {hi_w}")
    print(f"timing [{card}] phase14b make_sharded_sum_stack {f}x{h}x{w} over "
          f"{SHARDS14} shards, partials all-reduced on NCCL: {sum_ms:.3f} ms (CUDA "
          f"events, one warm run, the result to the host included), bit-equal to "
          f"oracle.stack_sum (hi {hi}; the oracle {oracle_s:.3f} s on the host)",
          flush=True)
    del host
    torch.cuda.empty_cache()

    mesh2 = make_mesh(("frames",), devices=[dev] * 2)
    frames_dev, _, _ = make_star_frames(*CONFIG_STARS, seed=5, dev=dev)
    layers = u16_to_numpy(frames_dev)
    del frames_dev
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plain = starfind.peaker_batch(layers, device=dev)
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = starfind.peaker_batch(layers, device=dev, mesh=mesh2)
    sharded_s = time.perf_counter() - t0
    if sharded != plain:
        fail("phase14b: peaker_batch over 2 shards differs from the unsharded call")
    frames4, _ = make_config4_frames(BATCH4, 1, *CONFIG4[2:], seed=6, dev=dev)
    layers4 = u16_to_numpy(frames4[:, 0])
    del frames4
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    a_un, r_un = global_align_batch(layers4, 0, device=dev)
    align_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    a_sh, r_sh = global_align_batch(layers4, 0, device=dev, mesh=mesh2)
    align_sh_s = time.perf_counter() - t0
    if r_sh.registered != BATCH4 or r_sh.failed or not np.array_equal(a_sh, a_un) \
            or any(not np.array_equal(p, q)
                   for p, q in zip(r_sh.homographies, r_un.homographies)):
        fail("phase14b: global_align_batch over 2 shards differs from the "
             "unsharded call")
    print(f"phase14b peaker_batch {layers.shape} over 2 shards: lists equal to "
          f"the unsharded call's ({sum(map(len, plain))} stars), {sharded_s:.3f} s "
          f"against {plain_s:.3f} s; global_align_batch {layers4.shape} over 2 "
          f"shards: frames and homographies equal, {align_sh_s:.3f} s against "
          f"{align_s:.3f} s (host clock) [{card}]", flush=True)


def phase14(rs, rec, dev, card):
    """The multi-device layer on one card inside a process group of world
    size 1 on NCCL (two ranks cannot share a card under NCCL)."""
    import torch.distributed as dist
    from siriltpu_torch.parallel.multihost import init_distributed

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        init_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", 1, 0,
                         backend="nccl")
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            fail("phase14: no NCCL group of world size 1")
        phase14a(rs, rec, dev, card)
        phase14b(rs, rec, dev, card)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--phases", default="", metavar="N,N",
        help="run only these of the phases 3 to 14, after the device and "
             "build phases (to compare two trees in one call; phase 8 "
             "brings phases 6 and 7 with it); such a run prints its timing "
             "lines and no result")
    args = parser.parse_args(argv)
    only = {int(n) for n in args.phases.split(",") if n}

    def wanted(*phases):
        return not only or bool(only & set(phases))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from siriltpu_torch.ops.cuda import reject_stack as rs
    from siriltpu_torch.utils import build

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()
    # ---- 1. device
    card = card_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    # compiled anew even where a library is already built, so that ptxas's
    # lines for every kernel entry are there to check
    info = build.build(force=True)
    build.library()
    print(f"build: {info['path'].name} built={info['built']} "
          f"nvcc {info['seconds']:.2f} s, total {time.perf_counter() - t0:.2f} s",
          flush=True)
    log = info["log"].splitlines()
    for line in log:
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"build: ptxas {line.strip()}")
    # no kernel keeps anything in local memory: no spills, and no stack
    # frame (a register array indexed at run time would take one); every
    # source has entries, and every entry its stack frame line
    entries = [line for line in log if "Compiling entry" in line]
    frames = [line.strip() for line in log if "bytes stack frame" in line]
    missing = [k for k in build.KERNELS
               if not any(f"reject_{k}_cu" in line for line in entries)]
    if missing or len(frames) != len(entries):
        fail(f"ptxas reports {len(entries)} kernel entries and {len(frames)} "
             f"stack frame lines, none for {missing}")
    spills = [line for line in frames
              if line != "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"]
    if spills:
        fail(f"ptxas reports local memory: {spills}")
    print(f"build: ptxas checked {len(entries)} kernel entries: no local memory",
          flush=True)

    plans = {k: rs.launch_plan(k, f) for k, f in (
        ("winsorized", 1000), ("sigma", 100), ("median", 50), ("percentile", 50),
        ("sigmedian", 50))}
    regs = entry_registers(log)
    wires = [n for e, n in regs.items() if WIRES_F1000 in e]
    teams = {t: [n for e, n in regs.items() if t in e] for t in TEAM_ENTRIES}
    print(f"occupancy: resident warps per SM {({k: v.warps for k, v in plans.items()})} "
          f"(winsorized at F = 1000 with {plans['winsorized'].tile} pixels a block, "
          f"form {plans['winsorized'].form}, {wires} registers, "
          f"sigma at F = 100, median, percentile and sigmedian at F = 50; pixels a block "
          f"and shared memory {({k: (v.tile, v.smem) for k, v in plans.items()})}; "
          f"forms {({k: v.form for k, v in plans.items()})})",
          flush=True)
    if plans["winsorized"].warps < MIN_WARPS_F1000:
        fail(f"winsorized keeps {plans['winsorized'].warps} warps per SM at F = 1000")
    if plans["winsorized"].form != "wires" or len(wires) != 1:
        fail(f"winsorized at F = 1000: form {plans['winsorized'].form}, "
             f"registers {wires} of entry {WIRES_F1000}")
    print(f"occupancy: sigma team entries' registers {teams}", flush=True)
    if any(len(n) != 1 for n in teams.values()):
        fail(f"ptxas does not report every sigma team entry once: {teams}")
    if plans["sigma"].form != "team" or plans["sigma"].warps < MIN_WARPS_SIGMA_F100:
        fail(f"sigma at F = 100: form {plans['sigma'].form}, "
             f"{plans['sigma'].warps} warps per SM")
    rec = Record(build.KERNELS)
    rec.plan["winsorized"] = {"form": plans["winsorized"].form, "registers": wires[0],
                              "warps": plans["winsorized"].warps}
    rec.plan["sigma"] = {"form": plans["sigma"].form, "registers": teams[TEAM_F100][0],
                         "warps": plans["sigma"].warps}
    # ---- 3. every kernel vs its plain version
    if wanted(3):
        phase3(rs, rec, dev)
        print(f"phase3 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 4-5. register + sigma stack, and its timing
    if wanted(4, 5):
        phase4_5(rs, rec, dev, card)
        torch.cuda.empty_cache()
        print(f"phase5 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 6. config 2: median and mean stacks of 50 x 2048 x 2048
    if wanted(6, 8):
        frames, shifts = make_frames(*CONFIG2, seed=2, dev=dev)
        stacks = [(method, rejection, "none",
                   stack_config(rs, rec, dev, card, "phase6", frames, shifts,
                                method, rejection, "none"))
                  for method, rejection in (("median", "none"), ("mean", "sigma"),
                                            ("mean", "percentile"),
                                            ("mean", "sigmedian"))]
        # phase 8 stacks the median and the sigma mean from the file
        config2 = frames, shifts, stacks[:2]
        del frames
        torch.cuda.empty_cache()
        print(f"phase6 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 7. config 3: winsorized mean stack of 1000 x 480 x 640
    if wanted(7, 8):
        frames, shifts = make_frames(*CONFIG3, seed=3, dev=dev)
        config3 = frames, shifts, [
            ("mean", "winsorized", "additive_scaling",
             stack_config(rs, rec, dev, card, "phase7", frames, shifts, "mean",
                          "winsorized", "additive_scaling"))]
        phase7_align(rs, rec, card, frames.reshape(*CONFIG3), shifts)
        del frames
        torch.cuda.empty_cache()
        print(f"phase7 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 8. configs 3 and 2 from SER files: register, stack, write
    if wanted(8):
        phase8(rs, rec, dev, card, config2, config3)
        del config2, config3
        torch.cuda.empty_cache()
        print(f"phase8 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 9. linearfit, ECC and the star pipeline: plain PyTorch on the card
    if wanted(9):
        phase9a(dev, card)
        print(f"phase9a done at {time.perf_counter() - t_start:.1f} s", flush=True)
        phase9b(rs, rec, dev, card)
        print(f"phase9b done at {time.perf_counter() - t_start:.1f} s", flush=True)
        phase9c(dev, card)
        print(f"phase9c done at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 10. global star registration: BASELINE config 4
    if wanted(10):
        phase10(rs, rec, dev, card)
        torch.cuda.empty_cache()
        print(f"phase10 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 11. BASELINE config 5: debayer, bgextract, register, stack, stretch
    if wanted(11):
        phase11(rs, rec, dev, card)
        torch.cuda.empty_cache()
        print(f"phase11 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 12. a scripted session through the command line, and post-processing
    if wanted(12):
        phase12(rs, rec, dev, card)
        torch.cuda.empty_cache()
        print(f"phase12 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 13. a planetary film and a DSLR raw night through the command line
    if wanted(13):
        phase13(rs, rec, dev, card)
        torch.cuda.empty_cache()
        print(f"phase13 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 14. the multi-device layer: sharded stacks in an NCCL group
    if wanted(14):
        phase14(rs, rec, dev, card)
        torch.cuda.empty_cache()
        print(f"phase14 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    if only:
        print(f"chip_smoke: phases {sorted(only)} only: no result", flush=True)
        return 0

    kernels = {"kernels": [{
        "name": f"reject_{k}", "route": "cuda",
        "source": f"siril-0.9_tpu/siriltpu_torch/csrc/reject_{k}.cu",
        "replaces": f"{PALLAS}:{REPLACES[k]}", "launches": rec.launches[k],
        "max_abs_err": rec.err[k], "ms": rec.ms[k][0], "plain_ms": rec.ms[k][1],
        "bound_ms": rec.bound[k], "bound_by": "bytes", "bound": "hbm",
        "library_ms": rec.library[k], **rec.plan.get(k, {})}
        for k in build.KERNELS] + [{
        "name": "align_shift", "route": "cuda",
        "source": "siril-0.9_tpu/siriltpu_torch/csrc/align_shift.cu",
        "replaces": f"{ALIGN_REPLACES} (XLA, no Pallas kernel)",
        "launches": rec.align["launches"], "max_abs_err": rec.align["err"],
        "shape": rec.align["shape"], "ms": rec.align["ms"],
        "plain_ms": rec.align["plain_ms"], "plain": "align_frames_slice",
        "bound_ms": rec.align["bound_ms"], "bound_by": "bytes", "bound": "hbm",
        "library_ms": None}]}
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
