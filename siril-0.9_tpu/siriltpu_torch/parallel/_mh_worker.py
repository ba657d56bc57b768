"""Multi-process worker of the register + stack.

Port of ``siriltpu.parallel._mh_worker``. Run as ``python -m
siriltpu_torch.parallel._mh_worker PORT PID NPROCS NDEV_PER_PROC
OUTDIR`` in NPROCS parallel processes. PORT is a port on localhost, or an
``init_method`` URL (``tcp://host:port``, ``file:///path``: a file under
OUTDIR needs no free port). Each process:

1. joins the gloo process group on the CPU,
2. builds the GLOBAL frames mesh of NPROCS x NDEV_PER_PROC CPU entries,
3. reads ONLY its own shard of the shared deterministic sequence
   (``local_frame_indices``: per-process input feeding), from
   OUTDIR/mh_input.ser where that file exists, else made in memory,
4. runs the multi-process register + stack and writes the result, the
   same on every process, to OUTDIR/out_PID.npy.

tests/test_torch_multihost.py launches it and holds every process's
output to the single-process result.
"""

from __future__ import annotations

import os
import sys

import numpy as np

F, H, W = 16, 64, 64
SEL = (16, 16, 32)


def synth_frames(n: int = F, h: int = H, w: int = W, seed: int = 0) -> np.ndarray:
    """The shared deterministic test sequence: n shifted noisy frames of
    one starfield, (n, h, w) uint16."""
    rng = np.random.default_rng(seed)
    base = np.clip(rng.normal(1000, 50, (h, w)), 0, 65535)
    base[20:24, 30:34] += 20000
    return np.stack([
        np.clip(np.roll(base, (i % 3 - 1, i % 5 - 2), axis=(0, 1)) +
                rng.normal(0, 5, (h, w)), 0, 65535).astype(np.uint16)
        for i in range(n)])


def write_test_ser(path: str) -> None:
    """Persist the shared sequence as a real SER file so workers can
    exercise the DISK-fed per-process input pipeline (SURVEY §5.8: each
    process reads only its own shard from shared storage)."""
    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.io.ser import SerFile

    sw = SerFile.create(path, width=W, height=H, color_id=0)
    for f in synth_frames():
        sw.write_frame(Frame(f[None]))
    sw.write_and_close()


def singlehost_expected() -> np.ndarray:
    """The single-process result the workers must reproduce exactly."""
    from siriltpu_torch.parallel.sharded import register_stack_step
    from siriltpu_torch.utils.interop import frames_from_numpy, u16_to_numpy

    out, _, _ = register_stack_step(SEL)(frames_from_numpy(synth_frames(), "cpu"))
    return u16_to_numpy(out)


def main(port: str, pid: int, nprocs: int, ndev: int, outdir: str) -> None:
    import torch.distributed as dist

    from siriltpu_torch.parallel.mesh import make_mesh
    from siriltpu_torch.parallel.multihost import (init_distributed,
                                                   make_multihost_register_stack)

    address = port if "://" in port else f"localhost:{int(port)}"
    init_distributed(address, num_processes=nprocs, process_id=pid, backend="gloo")
    try:
        assert dist.get_world_size() == nprocs
        mesh = make_mesh(("frames",), devices=["cpu"] * ndev)  # spans ALL processes
        assert mesh.size == nprocs * ndev, mesh
        touched = []
        ser_path = os.path.join(outdir, "mh_input.ser")
        if os.path.exists(ser_path):
            # disk-fed mode: every frame this process feeds is a partial
            # read of the shared SER file (the reference's "each thread
            # reads its own block through a locked fd" pattern)
            from siriltpu_torch.io.ser import SerFile

            ser = SerFile.open(ser_path)

            def read_frame(i):
                touched.append(i)
                return ser.read_frame(i).data[0]
        else:
            frames = synth_frames()

            def read_frame(i):
                touched.append(i)
                return frames[i]

        run = make_multihost_register_stack(mesh, SEL)
        out = run(read_frame, F, (H, W))

        # per-process feeding really happened: this process read only its shard
        lo, hi = pid * (F // nprocs), (pid + 1) * (F // nprocs)
        assert touched == list(range(lo, hi)), (pid, touched)

        np.save(os.path.join(outdir, f"out_{pid}.npy"), out)
        print(f"mh_worker {pid}/{nprocs}: OK entries={mesh.size} "
              f"local={ndev} backend=gloo fed frames [{lo},{hi})", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5])
