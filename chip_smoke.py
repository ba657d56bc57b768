#!/usr/bin/env python3
"""Smoke run of siriltpu_torch's main path on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA card and
nvcc:  python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compile the CUDA library from siril-0.9_tpu/siriltpu_torch/csrc;
3. kernel vs plain: the CUDA sigma kernel against its plain PyTorch
   version (reject_sigma_window) on the card, bit for bit, for F in
   {5, 7, 12, 25, 64, 100, 256} and P = 65536 (outliers at 0 and 60000,
   real 65535 values, degenerate geomspace columns), then the wrapper
   with its degenerate fix-up against reject_and_mean("sigma");
4. main path: register_and_stack on a 100 x 4096 x 4096 uint16 sequence
   made on the card (shifts in [-20, 20]): exact shifts, the kernel's
   launch count, and the stacked image and counters bit-equal to the plain
   version run in 2^20-pixel chunks;
5. timing: frames/s end to end (mean of 3 warm runs) and per-stage ms
   (CUDA events, median of 3 warm runs), with the plain version's ms for
   the kernel and for the whole stack stage at the same shape.

The line before the last holds one JSON object describing each kernel;
the last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "siril-0.9_tpu"))

DEVICE = "cuda"
SIZE, NFRAMES, SIG = 4096, 100, 3.0
CASE_P = 65536
CHUNK = 1 << 20
REPS = 3
KERNEL_SOURCE = "siril-0.9_tpu/siriltpu_torch/csrc/reject_sigma.cu"
KERNEL_REPLACES = "siril-0.9_tpu/siriltpu/ops/pallas/reject_stack.py:797"


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


def max_abs_diff(got, want) -> int:
    import torch
    from siriltpu_torch.utils.interop import u16_to_i32

    def wide(x):
        return (u16_to_i32(x) if x.dtype == torch.uint16 else x).to(torch.int64)
    return int((wide(got) - wide(want)).abs().max())


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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from siriltpu_torch.ops.cuda import reject_stack as rs
    from siriltpu_torch.ops.quality import quality_estimate_batch
    from siriltpu_torch.ops.rejection import reject_and_mean
    from siriltpu_torch.pipelines import register_stack as prs
    from siriltpu_torch.utils import build
    from siriltpu_torch.utils.interop import frames_from_numpy, shifts_to_numpy

    dev = torch.device(DEVICE)
    # ---- 1. device
    card = card_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    info = build.build()
    build.library()
    print(f"build: {info['path'].name} built={info['built']} "
          f"nvcc {info['seconds']:.2f} s, total {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"build: ptxas {line.strip()}")

    # ---- 3. kernel vs plain on the card
    max_err = 0
    cases = [(5, 1.5, 97), (7, 2.0, 97), (12, 2.5, 97), (25, 2.5, 3),
             (64, 3.0, 97), (100, 3.0, 97), (256, 3.0, 97)]
    for f, sig, every in cases:
        vals = frames_from_numpy(make_case(f, CASE_P, every, seed=f), dev)
        got = rs.reject_sigma_cuda(vals, sig, sig)
        torch.cuda.synchronize()
        want = rs.reject_sigma_plain(vals, sig, sig)
        torch.cuda.synchronize()
        errs = [max_abs_diff(g, w) for g, w in zip(got, want)]
        fin = rs.reject_stack(vals, sig, sig, with_counters=True)
        torch.cuda.synchronize()
        ref = reject_and_mean(vals, "sigma", (sig, sig))
        torch.cuda.synchronize()
        ferrs = [max_abs_diff(g, w) for g, w in zip(fin, ref)]
        ndeg = int(got[1].sum())
        print(f"phase3 F={f} P={CASE_P} sig={sig} degenerate={ndeg} "
              f"kernel-vs-plain max|diff| mean/degen/rejl/rejh={errs} "
              f"final-vs-reject_and_mean mean/rejl/rejh={ferrs}", flush=True)
        max_err = max(max_err, *errs, *ferrs)
        if any(errs) or any(ferrs):
            fail(f"kernel disagrees with its plain version at F={f}")
    if max_err:
        fail("phase 3 mismatch")

    # ---- 4. main path at full size
    bench = prs.RegisterStackBench(size=SIZE, nframes=NFRAMES, seed=0, device=dev)
    t0 = time.perf_counter()
    frames = bench.frames()
    torch.cuda.synchronize()
    print(f"phase4 frames {tuple(frames.shape)} {frames.dtype} made on the card "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    rs.launches = 0
    stacked, (sx, sy), quality = prs.register_and_stack(
        frames, sel=bench.sel, sig=(SIG, SIG), return_device=True)
    torch.cuda.synchronize()
    launches = rs.launches
    if not np.array_equal(shifts_to_numpy(sx, sy), -bench.shifts):
        fail("recovered shifts differ from the negated generated ones")
    if launches < 1:
        fail("the main path did not launch the sigma kernel")
    if tuple(stacked.shape) != (SIZE, SIZE) or stacked.dtype != torch.uint16:
        fail(f"stacked image {tuple(stacked.shape)} {stacked.dtype}")
    if quality.shape != (NFRAMES,) or not bool(torch.isfinite(quality).all()):
        fail("quality is not finite of shape (F,)")
    # the plain reference aligns with the gather form (the main path used
    # the slice form) and stacks in 2^20-pixel chunks
    flat = prs.align_frames_gather(frames, sx, sy).reshape(NFRAMES, -1)
    kmean, krejl, krejh = rs.reject_stack(flat, SIG, SIG, with_counters=True)
    torch.cuda.synchronize()
    errs = [max_abs_diff(kmean, stacked.reshape(-1))]
    for a in range(0, flat.shape[1], CHUNK):
        pm, pl, ph = reject_and_mean(flat[:, a:a + CHUNK], "sigma", (SIG, SIG))
        errs += [max_abs_diff(kmean[a:a + CHUNK], pm),
                 max_abs_diff(krejl[a:a + CHUNK], pl),
                 max_abs_diff(krejh[a:a + CHUNK], ph)]
    ndeg = int(rs.reject_sigma_cuda(flat, SIG, SIG)[1].sum())
    torch.cuda.synchronize()
    print(f"phase4 main path {NFRAMES}x{SIZE}x{SIZE}: shifts exact, "
          f"sigma kernel launches={launches}, degenerate pixels={ndeg}, "
          f"rejected low={int(krejl.sum())} high={int(krejh.sum())}, "
          f"stacked+counters vs plain max|diff|={max(errs)}", flush=True)
    max_err = max(max_err, *errs)
    if max_err:
        fail("the stacked image or counters differ from the plain version")
    del kmean, krejl, krejh

    # ---- 5. timing
    fps = bench.run(repeats=REPS)
    sel_frames = prs._selection(frames, bench.sel)
    ms = {}
    ms["shifts"], (sx, sy) = cuda_ms(lambda: prs.compute_shifts(frames, 0, bench.sel))
    ms["quality"], _ = cuda_ms(lambda: quality_estimate_batch(sel_frames))
    ms["align"], aligned = cuda_ms(lambda: prs.align_frames_auto(frames, sx, sy))
    flat = aligned.reshape(NFRAMES, -1)
    ms["kernel"], raw = cuda_ms(lambda: rs.reject_sigma_cuda(flat, SIG, SIG))
    # the fix-up writes in place, and writes the same values every run
    ms["fixup"], _ = cuda_ms(lambda: rs.fix_degenerate(flat, *raw, SIG, SIG))

    def plain(fn):
        def run():
            for a in range(0, flat.shape[1], CHUNK):
                fn(flat[:, a:a + CHUNK])
        return run

    # the kernel's plain version, and the whole stack stage's (with the
    # exact re-run of degenerate pixels), in 2^20-pixel chunks
    ms["plain_kernel"], _ = cuda_ms(plain(
        lambda v: rs.reject_sigma_plain(v, SIG, SIG)))
    ms["plain_stack"], _ = cuda_ms(plain(
        lambda v: reject_and_mean(v, "sigma", (SIG, SIG))))
    print(f"timing [{card}] register+stack {NFRAMES}x{SIZE}x{SIZE}: "
          f"{fps:.3f} frames/s end to end (mean of {REPS} warm runs); "
          + " ".join(f"{k}_ms={v:.3f}" for k, v in ms.items()), flush=True)

    kernels = {"kernels": [{
        "name": "reject_sigma", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": ms["kernel"], "plain_ms": ms["plain_kernel"]}]}
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
