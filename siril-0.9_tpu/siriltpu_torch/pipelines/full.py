"""The BASELINE config-5 chain as ONE pipeline:

    SER convert → per-frame background extraction → register →
    mean-with-rejection stack → autostretch → FITS

Port of ``siriltpu.pipelines.full``: the same wiring on the port's
stages, the registration and the stack on ``device``, the debayering of a
CFA SER by VNG or AHD too (the default bilinear, the background model and
the autostretch run on the host, as in the JAX package). ``mesh``
(``parallel.mesh``) shards the global registration's frames over it.

Each stage is the same code the individual CLI verbs run (convert /
bgextract / register / stack / autostretch); this module owns the
WIRING — intermediate sequences, write-back naming (``bkg_``/``r_``
prefixes mirroring the reference's sequence-prefix convention,
e.g. seqpreprocess's ``pp_``, src/core/siril.c:1144), and the final
stretch+save — so the whole chain runs end to end with one call.

The reference has no single entry point for this chain (a user chains
GUI actions); BASELINE.md's config 5 defines it as the full-pipeline
eval, which is what this reproduces.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

from siriltpu_torch.core.frame import Frame


@dataclass
class Config5Report:
    frames: int = 0
    registered: int = 0
    failed: int = 0
    output_path: str = ""
    autostretch_m: List[float] = field(default_factory=list)
    rejection_percent: tuple = (0.0, 0.0)
    stage_seconds: dict = field(default_factory=dict)
    # per-component times of the overlapped bgextract stage
    # (read_s + compute_s + save_s > wall_s when threads overlapped)
    overlap_seconds: dict = field(default_factory=dict)


def config5_pipeline(ser_path: str, *, device, layer: int = 1,
                     bg_order: int = 4,
                     register_method: str = "global",
                     rejection: str = "winsorized",
                     sig=(3.0, 3.0), normalize: str = "none",
                     output: Optional[str] = None,
                     debayer: bool = False,
                     mesh=None) -> Config5Report:
    """Run the full config-5 chain on an RGB (or to-debayer) SER, the
    registration and the stack on ``device``.

    ``layer``: registration layer (green = 1 for RGB, the reference's
    usual choice). ``register_method``: ``global`` (star alignment,
    deep-sky) or ``dft`` (translation via phase correlation on a
    centered square selection). Returns a Config5Report; the stacked,
    background-subtracted, autostretched result is written to
    ``output`` (default ``<ser-dir>/<name>_result.fit``).
    """
    import time

    from siriltpu_torch.core.frame import Rect
    from siriltpu_torch.io import fits as fits_io
    from siriltpu_torch.io.ser import SER_MONO, SER_RGB, SerFile
    from siriltpu_torch.io.sequence import ser_sequence
    from siriltpu_torch.ops.background import BackgroundParams, subtract_background
    from siriltpu_torch.ops.histogram_ops import autostretch, find_midtones_balance
    from siriltpu_torch.parallel.engine import SequenceEngine
    from siriltpu_torch.stacking.api import stack_sequence

    if register_method not in ("global", "dft"):
        raise ValueError(f"unknown register method {register_method}")
    rep = Config5Report()
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        rep.stage_seconds[name] = now - t
        t = now

    # 1) convert: open the SER as a sequence (debayering on read when
    # asked — the reference's convert + debayer_if_needed path)
    seq = ser_sequence(ser_path, debayer=debayer, debayer_device=device)
    rep.frames = seq.number
    seq.read_frame(0)
    lap("convert")

    # 2) per-frame background extraction into a new bkg_ SER (the
    # seq-apply form of bgextract, gradient.c's poly model per frame),
    # through the sequence engine: a reader thread prefetches the next
    # chunk and a writer thread writes results while the current frame is
    # computed — the reference's P5 loader pattern (ser.c:671-683) across
    # the stage's read/compute/write boundaries. rep.overlap_seconds
    # records the component times (read+compute+save > bgextract wall
    # when the overlap engaged). The engine keeps no output frame.
    d = seq.seq_dir
    bkg_path = os.path.join(d, f"bkg_{seq.seqname}.ser")
    bkg = SerFile.create(bkg_path, width=seq.rx, height=seq.ry,
                         color_id=SER_MONO if seq.nb_layers == 1 else SER_RGB)
    bg_params = BackgroundParams(order=bg_order)
    eng = SequenceEngine(chunk=4)
    eng.map_frames(
        seq,
        lambda i, fr: Frame(subtract_background(fr.data, bg_params),
                            dict(fr.meta)),
        filter_fn=lambda i: True,
        save_hook=lambda i, out: bkg.write_frame(out),
        async_save=True, stats=rep.overlap_seconds)
    bkg.write_and_close()
    bseq = ser_sequence(bkg_path)
    lap("bgextract")

    # 3) register
    if register_method == "global":
        from siriltpu_torch.registration.global_star import register_global_star
        greport = register_global_star(bseq, layer, device=device, mesh=mesh)
        rep.registered = greport.registered
        rep.failed = greport.failed
        rseq = ser_sequence(os.path.join(d, greport.new_seqname + ".ser"))
    else:
        from siriltpu_torch.registration.translation import register_shift_dft
        sq = min(512, seq.rx // 2, seq.ry // 2)
        register_shift_dft(bseq, layer, Rect((seq.rx - sq) // 2,
                                             (seq.ry - sq) // 2, sq, sq),
                           device=device)
        rep.registered = bseq.number
        rseq = bseq
    lap("register")

    # 4) rejection stack (blockwise streaming when large)
    res = stack_sequence(rseq, device=device, method="mean", layer_shifts=layer,
                         filter_type="all", rejection=rejection, sig=sig,
                         normalize=normalize)
    rep.rejection_percent = res.rejection_percent(0)
    lap("stack")

    # 5) autostretch (findMidtonesBalance + MTF, histogram.c:684-740)
    for c in range(res.data.shape[0]):
        m, lo, hi = find_midtones_balance(res.data[c:c + 1])
        rep.autostretch_m.append(m)
    stretched = autostretch(res.data)
    lap("autostretch")

    if output is None:
        output = os.path.join(d, f"{seq.seqname}_result.fit")
    fits_io.write_fits(output, Frame(stretched))
    rep.output_path = output
    lap("save")
    return rep


__all__ = ["config5_pipeline", "Config5Report"]
