"""Sequence export: registered/normalized frames → SER, AVI, or MP4.

Reference: ``export_sequence`` (src/io/sequence.c:1132-1500 area):
per frame — apply registration shifts, optional additive normalization
from IKSS stats, optional crop (top-down selection) and resize; write to
the chosen container. MP4/WEBM go through ffmpeg when available
(src/io/mp4_output.c); AVI uses the native DIB writer.

Port of ``siriltpu.io.export``: copied, but ``export_sequence`` takes the
``device`` that a resize runs on (``ops.imops.resize``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from siriltpu_torch.core.frame import Frame, Rect
from siriltpu_torch.io.avi import AviWriter
from siriltpu_torch.io.ser import SerFile
from siriltpu_torch.ops import imops
from siriltpu_torch.utils.rounding import np_round_to_word
from siriltpu_torch.verify.oracle import shift_gather


@dataclass
class ExportArgs:
    """exportseq_args (sequence.c:1132-1146)."""
    basename: str = "export"
    fmt: str = "ser"             # ser | avi | mp4 | webm | fits
    normalize: bool = False
    fps: float = 25.0
    quality: int = 3
    crop: Optional[Rect] = None
    resize: Optional[Tuple[int, int]] = None  # (width, height)
    filter_included: bool = True


def export_sequence(seq, args: ExportArgs, layer: int = 0,
                    directory: Optional[str] = None, *, device) -> str:
    """Export the sequence; returns the output path. A resize runs on
    ``device``."""
    from siriltpu_torch.stacking.api import sequence_normalization

    directory = directory or seq.seq_dir
    indices = (seq.included_indices() if args.filter_included
               else list(range(seq.number)))
    shifts = seq.reg_shifts(layer)

    coeffs = None
    if args.normalize:
        off, mul, scale = sequence_normalization(seq, layer, indices,
                                                 "additive_scaling")
        coeffs = (off, mul, scale)

    if not seq.rx or seq.nb_layers < 0:
        seq.read_frame(indices[0])  # discovered/film sequences are lazy
        # about geometry (incl. nb_layers) until a frame is read
        # (check_seq parity; film_sequence leaves nb_layers = -1)
    out_w = args.crop.w if args.crop else seq.rx
    out_h = args.crop.h if args.crop else seq.ry
    if args.resize:
        out_w, out_h = args.resize

    fmt = args.fmt.lower()
    ext = "avi" if fmt == "mjpeg" else fmt
    path = os.path.join(directory, f"{args.basename}.{ext}")
    writer = None
    mp4 = None
    if fmt == "ser":
        writer = SerFile.create(path, width=out_w, height=out_h,
                                color_id=100 if seq.nb_layers == 3 else 0)
    elif fmt == "avi":
        writer = AviWriter(path, out_w, out_h, args.fps)
    elif fmt == "mjpeg":
        # compressed movie export without ffmpeg: MJPEG-in-AVI, quality
        # 1..5 like the MP4 dialog (sequence.c exportseq quality knob)
        writer = AviWriter(path, out_w, out_h, args.fps, codec="mjpeg",
                           jpeg_quality=min(55 + 9 * args.quality, 100))
        fmt = "avi"
    elif fmt in ("mp4", "webm"):
        # native libav encoder: H.264 for mp4, VP9 for webm, with the
        # reference's settings (mp4_output.c:403 mp4_create). Falls back
        # to the dependency-free MJPEG-in-MP4 muxer (io/mp4.py) when
        # libavformat/libavcodec are absent or the geometry is odd
        # (yuv420p requires even dimensions, mp4_output.c:411).
        from siriltpu_torch.io import film_codec
        if (film_codec.available() and out_w % 2 == 0 and out_h % 2 == 0):
            # resize happens INSIDE the encoder via swscale, exactly
            # like the reference (mp4_create takes src_w/src_h and
            # rescales during the yuv420p conversion, mp4_output.c:293)
            src_w = args.crop.w if args.crop else seq.rx
            src_h = args.crop.h if args.crop else seq.ry
            writer = film_codec.FilmEncoder(
                path, out_w, out_h, args.fps, seq.nb_layers,
                quality=max(1, min(args.quality, 5)),
                src_w=src_w, src_h=src_h)
            fmt = "film"
        elif fmt == "mp4":
            from siriltpu_torch.io.mp4 import Mp4Writer
            writer = Mp4Writer(path, out_w, out_h, args.fps)
        else:
            try:
                import imageio.v2 as iio
                mp4 = iio.get_writer(path, fps=args.fps)
            except Exception as e:
                raise RuntimeError(
                    "WEBM output is not supported: ffmpeg backend "
                    f"missing ({e})") from e
    elif fmt != "fits":
        raise ValueError(f"unknown export format {args.fmt}")

    for k, i in enumerate(indices):
        frame = seq.read_frame(i)
        data = shift_gather(frame.data, int(shifts[i, 0]),
                            int(shifts[i, 1]), fill=0, skip_origin=False)
        if coeffs is not None:
            off, mul, scale = coeffs
            pos = indices.index(i)
            x = data.astype(np.float64) * scale[pos]
            data = np_round_to_word(x - off[pos])
        if args.crop:
            data = imops.crop(data, args.crop.x, args.crop.y,
                              args.crop.w, args.crop.h)
        if args.resize and fmt != "film":
            # the reference exports with OPENCV_CUBIC = value 3
            # (sequence.c:1436), which the real OpenCV executes as
            # INTER_AREA (PARITY.md "interpolation enum"); the film
            # encoder instead rescales internally via swscale like
            # mp4_add_frame does
            data = imops.resize(data, out_w, out_h, interpolation=3,
                                device=device)
        out = Frame(data, dict(frame.meta))
        if fmt == "ser":
            writer.write_frame(out)
        elif fmt == "avi":
            writer.write_frame(out)
        elif fmt == "film":
            # WORD → BYTE linear map + bottom-up → top-down packing,
            # the fill_rgb_image conversion (mp4_output.c:225-276)
            img8 = np.clip(out.data.astype(np.float64) * (255.0 / 65535.0)
                           + 0.5, 0, 255).astype(np.uint8)
            arr = (img8[0] if out.nlayers == 1
                   else img8.transpose(1, 2, 0))[::-1]
            writer.add_frame(np.ascontiguousarray(arr))
        elif fmt == "mp4":
            from siriltpu_torch.io.avi import _frame_to_jpeg
            quality = min(55 + 9 * args.quality, 100)
            writer.add_frame(_frame_to_jpeg(out, quality))
        elif mp4 is not None:
            img8 = (np.clip(out.data.astype(np.float64) / 257.0 + 0.5,
                            0, 255).astype(np.uint8))
            arr = (img8[0] if out.nlayers == 1
                   else img8.transpose(1, 2, 0))[::-1]
            mp4.append_data(arr)
        else:  # fits sequence
            from siriltpu_torch.io import fits as fits_io
            fits_io.write_fits(
                os.path.join(directory, f"{args.basename}{k+1:05d}.fit"),
                out)
    if fmt == "ser":
        writer.write_and_close()
    elif fmt in ("avi", "mp4", "film"):
        writer.close()
    elif mp4 is not None:
        mp4.close()
    return path


__all__ = ["export_sequence", "ExportArgs"]
