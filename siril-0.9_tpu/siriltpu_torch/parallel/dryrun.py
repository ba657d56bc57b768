"""A dry run of the multi-device paths over an n-entry mesh.

The port's counterpart of ``dryrun_multichip`` in the repository's
``__graft_entry__.py``: the fused register + sigma stack over an n-entry
``frames`` mesh, the row-slab stack over a 2-D ``("frames", "rows")``
mesh, and the batched global star alignment, each on tiny shapes and each
held to its unsharded run bit for bit. Run as ``python -m
siriltpu_torch.parallel.dryrun [N] [DEVICE]`` (default 8 entries on the
visible cards; DEVICE ``cpu`` runs it off the card).
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> None:
    """Run the sharded paths over an ``n_devices``-entry mesh of
    ``device`` (default: the visible cards, repeated round-robin to fill
    the entries; none visible raises). Raises on any failed check."""
    import torch

    from siriltpu_torch.parallel._mh_worker import synth_frames
    from siriltpu_torch.parallel.mesh import make_mesh
    from siriltpu_torch.parallel.sharded import (make_rows_sigma_stack,
                                                 make_sharded_register_stack)
    from siriltpu_torch.registration.global_star import global_align_batch
    from siriltpu_torch.testing.synth import starfield

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device is visible; "
                               "pass device='cpu' to run it on the CPU")
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        cards = [torch.device(device)]
    devices = [cards[i % len(cards)] for i in range(n_devices)]
    mesh = make_mesh(("frames",), devices=devices)
    single = make_mesh(("frames",), devices=devices[:1])

    # the fused register + stack: frames sharded for registration, row
    # slabs for the cross-frame rejection
    frames = synth_frames(2 * n_devices)
    h, w = frames.shape[1:]
    sel = (16, 16, 32)
    out, shifts = make_sharded_register_stack(mesh, sel)(frames)
    if out.shape != (h, w) or not 900 < int(out[40, 40]) < 1100:
        raise RuntimeError(f"stacked image {out.shape}, background "
                           f"{int(out[40, 40])}")
    want, want_shifts = make_sharded_register_stack(single, sel)(frames)
    if not (np.array_equal(out, want) and np.array_equal(shifts, want_shifts)):
        raise RuntimeError("sharded register + stack differs from one entry")

    # 2-D mesh: frames axis (data-parallel registration) x rows axis
    # (spatial slab stacking, the reference's P3 pattern at mesh scale)
    if n_devices % 2 == 0:
        mesh2 = make_mesh(("frames", "rows"), shape=(2, n_devices // 2),
                          devices=devices)
        out2 = make_rows_sigma_stack(mesh2)(frames)
        want2 = make_rows_sigma_stack(single)(frames)
        if out2.shape != (h, w) or not np.array_equal(out2, want2):
            raise RuntimeError("row-slab stack differs from one entry")

    # star pipeline over the frames mesh: batched star find + triangle
    # match + RANSAC + batched warp, sharded == unsharded bit for bit
    srng = np.random.default_rng(7)
    sh = sw = 96
    sbase = np.column_stack([
        srng.uniform(15, sw - 15, 12), srng.uniform(15, sh - 15, 12),
        srng.uniform(9000, 28000, 12), srng.uniform(3.5, 5.5, 12)])
    layers = []
    for _ in range(n_devices):
        st = sbase.copy()
        st[:, 0] += srng.uniform(-3, 3)
        st[:, 1] += srng.uniform(-3, 3)
        sdata, _ = starfield(sh, sw, 12, seed=7, background=880,
                             noise_sigma=4.0, stars=st)
        layers.append(sdata[0])
    layers = np.stack(layers)
    a_sh, r_sh = global_align_batch(layers, 0, nmax=64, mesh=mesh,
                                    device=devices[0])
    a_un, _ = global_align_batch(layers, 0, nmax=64, device=devices[0])
    if r_sh.failed or r_sh.registered != n_devices:
        raise RuntimeError(f"star alignment: {r_sh.registered} registered, "
                           f"{r_sh.failed} failed")
    if not np.array_equal(a_sh, a_un):
        raise RuntimeError("sharded star alignment differs from unsharded")
    print(f"dryrun_multichip OK on {n_devices} entries "
          f"({', '.join(sorted({str(d) for d in devices}))}): {out.shape}")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     sys.argv[2] if len(sys.argv) > 2 else None)
