"""What crosses between siriltpu and the port, and uint16 at the boundary.

There are no learned weights in this system: what the two packages
exchange is data — (F, H, W) uint16 frames, (F, 2) int32 shifts, the
(siglow, sighigh) pair, star lists and PSF fits (``stars_to_fields``,
``psf_fit_to_numpy``), the settings of calibration and background
extraction (``PreproConfig``, ``BackgroundParams``: ``config_to_fields``),
the CLI's ``Settings`` (``settings_from_fields``), compositing's layers
(``composition_layers_to_fields``)
and a master dark's deviant pixels (``deviants_to_fields``), and a
sequence's state: its registration data, selection and cached statistics. On disk that state is the ``.seq`` file
beside the SER or FITS files, which either package reads and writes; in
memory it crosses as a dict of plain fields (``sequence_to_fields``,
``sequence_from_fields``). Tests hand both packages the same seeded NumPy
frames through these helpers.

torch's op support for ``torch.uint16`` is thin (arithmetic and
reductions raise on some builds), so the port keeps uint16 only at the
public boundary and in kernel pointers. Conversions go through a
bit-preserving ``int16`` view, which every build supports for data
movement (copy, index, pad, ``where``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from siriltpu_torch.core.frame import Frame, ImStats, ImgParam, RegData


def u16_to_i32(x: torch.Tensor) -> torch.Tensor:
    """Widen a uint16 tensor to int32 (values 0..65535)."""
    if x.dtype != torch.uint16:
        raise TypeError(f"expected uint16, got {x.dtype}")
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def to_float32(x: torch.Tensor) -> torch.Tensor:
    """Any real tensor -> float32 (uint16 through int32)."""
    if x.dtype == torch.uint16:
        x = u16_to_i32(x)
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def i32_to_u16(x: torch.Tensor) -> torch.Tensor:
    """Narrow an integer tensor holding values 0..65535 to uint16."""
    return x.to(torch.int32).to(torch.int16).view(torch.uint16)


def frames_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """(F, H, W) (or any shape) uint16 NumPy array -> uint16 tensor on
    ``device``."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint16:
        raise TypeError(f"expected uint16 frames, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int16)).to(device).view(torch.uint16)


def u16_to_numpy(x: torch.Tensor) -> np.ndarray:
    """uint16 tensor on any device -> uint16 NumPy array."""
    return x.view(torch.int16).cpu().numpy().view(np.uint16)


def shifts_to_numpy(sx: torch.Tensor, sy: torch.Tensor) -> np.ndarray:
    """Per-frame (sx, sy) tensors -> (F, 2) int32 array, columns (x, y)."""
    return np.stack([sx.cpu().numpy(), sy.cpu().numpy()],
                    axis=1).astype(np.int32)


#: a sequence's scalar fields, its per-frame registration columns and the
#: numeric fields of its cached statistics, as the dict form lists them
SEQUENCE_SCALARS = ("seqname", "seqtype", "beg", "end", "number", "selnum",
                    "fixed", "reference_image", "nb_layers", "rx", "ry", "ext",
                    "seq_dir")
REG_COLUMNS = ("shiftx", "shifty", "rot_centre_x", "rot_centre_y", "angle",
               "fwhm", "quality")
STATS_COLUMNS = ("total", "ngoodpix", "mean", "median", "sigma", "avgdev",
                 "mad", "sqrtbwmv", "bgnoise", "min", "max", "location",
                 "scale", "norm_value")


def sequence_to_fields(seq) -> dict:
    """The plain fields of a ``Sequence`` of either package, as a dict of
    scalars and NumPy arrays: the scalars of ``SEQUENCE_SCALARS``;
    ``filenum`` (N,) int64, ``incl`` (N,) bool and ``date_obs`` (a list);
    ``reg``, a dict from layer to an (N, 7) float64 array of
    ``REG_COLUMNS``; ``stats``, an (N, 14) float64 array of
    ``STATS_COLUMNS`` with NaN rows for the frames without cached
    statistics, and their ``layername`` (a list)."""
    fields = {k: getattr(seq, k) for k in SEQUENCE_SCALARS}
    fields["filenum"] = np.array([p.filenum for p in seq.imgparam], np.int64)
    fields["incl"] = np.array([bool(p.incl) for p in seq.imgparam], bool)
    fields["date_obs"] = [p.date_obs for p in seq.imgparam]
    fields["reg"] = {
        layer: np.array([[getattr(r, c) for c in REG_COLUMNS] for r in reg],
                        np.float64).reshape(len(reg), len(REG_COLUMNS))
        for layer, reg in seq.regparam.items()}
    fields["stats"] = np.array(
        [[np.nan] * len(STATS_COLUMNS) if p.stats is None
         else [getattr(p.stats, c) for c in STATS_COLUMNS]
         for p in seq.imgparam], np.float64).reshape(-1, len(STATS_COLUMNS))
    fields["layername"] = [None if p.stats is None else p.stats.layername
                           for p in seq.imgparam]
    return fields


def sequence_from_fields(fields: dict, frames=None):
    """The port's ``Sequence`` with the state ``sequence_to_fields`` took
    from a sequence of either package. A ``ser`` or ``regular`` sequence
    reads its files under ``seq_dir``; an ``internal`` one takes its
    ``frames``, (C, H, W) uint16 arrays."""
    from siriltpu_torch.io.sequence import Sequence

    seq = Sequence(**{k: fields[k] for k in SEQUENCE_SCALARS})
    for i, num in enumerate(fields["filenum"]):
        row = fields["stats"][i]
        stats = None
        if not np.isnan(row).all():
            vals = {c: float(v) for c, v in zip(STATS_COLUMNS, row)}
            vals["total"], vals["ngoodpix"] = int(row[0]), int(row[1])
            stats = ImStats(layername=fields["layername"][i], **vals)
        seq.imgparam.append(ImgParam(filenum=int(num), incl=bool(fields["incl"][i]),
                                     stats=stats, date_obs=fields["date_obs"][i]))
    for layer, rows in fields["reg"].items():
        seq.regparam[int(layer)] = [
            RegData(int(r[0]), int(r[1]), *(float(v) for v in r[2:])) for r in rows]
    if frames is not None:
        seq.internal_frames = [Frame(np.asarray(fr)) for fr in frames]
    return seq


#: the fields of a ``Star`` of either package, as the dict form lists them
STAR_COLUMNS = ("xpos", "ypos", "mag", "fwhmx", "fwhmy", "A", "B", "sx", "sy",
                "angle", "rmse", "layer")


def stars_to_fields(stars) -> dict:
    """A star list of either package (``ops.starfind.Star``) as a dict of
    (N,) NumPy columns, one per name of ``STAR_COLUMNS``: float64, but
    ``layer`` int64. The list's order is kept."""
    return {c: np.array([getattr(s, c) for s in stars],
                        np.int64 if c == "layer" else np.float64)
            for c in STAR_COLUMNS}


def stars_from_fields(fields: dict) -> list:
    """The port's star list from the columns ``stars_to_fields`` made."""
    from siriltpu_torch.ops.starfind import Star

    n = len(fields["xpos"])
    return [Star(**{c: (int if c == "layer" else float)(fields[c][i])
                    for c in STAR_COLUMNS}) for i in range(n)]


def psf_fit_to_numpy(fit) -> dict:
    """A ``PSFFit`` of either package (a named tuple of (N,) device
    arrays) as a dict of NumPy arrays on the host."""
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in fit._asdict().items()}


def config_to_fields(cfg) -> dict:
    """A ``PreproConfig``, ``BackgroundParams`` or ``core.config.Settings``
    of either package as a dict of its fields."""
    return dataclasses.asdict(cfg)


def prepro_config_from_fields(fields: dict):
    """The port's ``PreproConfig`` from ``config_to_fields``' dict."""
    from siriltpu_torch.pipelines.preprocess import PreproConfig

    return PreproConfig(**fields)


def background_params_from_fields(fields: dict):
    """The port's ``BackgroundParams`` from ``config_to_fields``' dict."""
    from siriltpu_torch.ops.background import BackgroundParams

    return BackgroundParams(**fields)


def settings_from_fields(fields: dict):
    """The port's ``core.config.Settings`` from ``config_to_fields``' dict
    of either package's ``Settings``, field by field."""
    from siriltpu_torch.core.config import Settings

    return Settings(**fields)


def composition_layers_to_fields(layers) -> dict:
    """A ``pipelines.compositing.CompositionLayer`` list of either package
    as ``data``, a list of (C, H, W) uint16 arrays, ``meta``, a list of
    the frames' header dicts, and ``color``, an (N, 3) float64 array."""
    return {"data": [np.asarray(lay.frame.data) for lay in layers],
            "meta": [dict(lay.frame.meta) for lay in layers],
            "color": np.array([lay.color for lay in layers],
                              np.float64).reshape(-1, 3)}


def composition_layers_from_fields(fields: dict) -> list:
    """The port's ``CompositionLayer`` list from
    ``composition_layers_to_fields``' dict."""
    from siriltpu_torch.pipelines.compositing import CompositionLayer

    return [CompositionLayer(Frame(np.array(d), dict(m)), tuple(float(v) for v in c))
            for d, m, c in zip(fields["data"], fields["meta"], fields["color"])]


#: the fields of a cosmetic ``DeviantPixel`` of either package
DEVIANT_COLUMNS = ("x", "y", "type")


def deviants_to_fields(devs) -> dict:
    """A deviant-pixel list of either package (``ops.cosmetic``) as a
    dict of (N,) int64 columns, one per name of ``DEVIANT_COLUMNS``, in
    the list's (scan) order."""
    return {c: np.array([getattr(d, c) for d in devs], np.int64)
            for c in DEVIANT_COLUMNS}


def deviants_from_fields(fields: dict) -> list:
    """The port's deviant-pixel list from ``deviants_to_fields``' dict."""
    from siriltpu_torch.ops.cosmetic import DeviantPixel

    return [DeviantPixel(*(int(fields[c][i]) for c in DEVIANT_COLUMNS))
            for i in range(len(fields["x"]))]


__all__ = ["u16_to_i32", "to_float32", "i32_to_u16", "frames_from_numpy",
           "u16_to_numpy", "shifts_to_numpy", "sequence_to_fields",
           "sequence_from_fields", "SEQUENCE_SCALARS", "REG_COLUMNS",
           "STATS_COLUMNS", "stars_to_fields", "stars_from_fields",
           "psf_fit_to_numpy", "STAR_COLUMNS", "config_to_fields",
           "prepro_config_from_fields", "background_params_from_fields",
           "DEVIANT_COLUMNS", "deviants_to_fields", "deviants_from_fields",
           "settings_from_fields", "composition_layers_to_fields",
           "composition_layers_from_fields"]
