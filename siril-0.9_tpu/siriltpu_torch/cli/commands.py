"""The command layer: the reference's ~70 text commands plus the
sequence pipelines (register/stack/preprocess) the reference exposes
through GUI buttons.

Reference: src/core/command.c (table :66-185, dispatcher
``processcommand``), handlers ``process_*``. One command = one line,
whitespace-split into at most 16 words (command.h).

Port of ``siriltpu.cli.commands``: the same verbs with the same syntax,
output files and messages. Every verb that reaches the card passes
``state.device`` on (registration, stacking, PSF and star finding, the
blurs, resize and rotate, the wavelet verbs, ``align_rgb``), after it has
checked its arguments and state (``convert`` and ``seqexport`` too: a raw
file's debayer, an export's resize). The dispatcher catches what the JAX
package's catches (``CommandError``, ``ValueError``,
``FileNotFoundError``); anything else, a CUDA error say, reaches the
caller.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np

from siriltpu_torch.cli.state import CommandError, SirilState
from siriltpu_torch.core.frame import Frame, Rect
from siriltpu_torch.io import fits as fits_io
from siriltpu_torch.io.seqfile import read_seqfile, write_seqfile
from siriltpu_torch.io.sequence import check_seq, ser_sequence
from siriltpu_torch.ops import colors, imops
from siriltpu_torch.ops.stats import STATS_MAIN, statistics
from siriltpu_torch.utils.interop import frames_from_numpy
from siriltpu_torch.utils.rounding import np_round_to_word

COMMANDS: Dict[str, dict] = {}


def command(name: str, nbargs: int, usage: str):
    def deco(fn: Callable):
        COMMANDS[name] = {"fn": fn, "nbargs": nbargs, "usage": usage}
        return fn
    return deco


def process_command(state: SirilState, line: str) -> int:
    """Dispatcher (``processcommand``): split, look up, check arg count."""
    words = line.split()
    if not words:
        return 0
    name = words[0].lower()
    if name.startswith("#"):
        return 0
    entry = COMMANDS.get(name)
    if entry is None:
        state.log(f"Unknown command: '{name}' or not implemented yet")
        return 1
    if len(words) - 1 < entry["nbargs"]:
        state.log(f"Usage: {entry['usage']}")
        return 1
    try:
        entry["fn"](state, words[1:])
        return 0
    except (CommandError, ValueError, FileNotFoundError) as e:
        state.log(f"Error: {e}")
        return 1



def _read_fits_arg(state, name: str):
    """Resolve a FITS filename like stat_file does (extension priority)."""
    path = state.path(name)
    if not os.path.exists(path):
        for ext in (state.settings.fits_extension, "fit", "fits", "fts"):
            if os.path.exists(path + "." + ext):
                path = path + "." + ext
                break
    return fits_io.read_fits(path)


# ------------------------------------------------------------- file / basic

@command("load", 1, "load filename.[ext]")
def process_load(state, args):
    path = state.path(args[0])
    if not os.path.exists(path):
        for ext in (state.settings.fits_extension, "fit", "fits", "fts"):
            if os.path.exists(path + "." + ext):
                path = path + "." + ext
                break
    state.set_image(fits_io.read_fits(path), save_undo=False)
    state.image_name = os.path.basename(path)
    state.log(f"Reading FITS: file {state.image_name}, "
              f"{state.image.nlayers} layer(s), "
              f"{state.image.rx}x{state.image.ry} pixels")


@command("save", 1, "save filename (save current image in fit)")
def process_save(state, args):
    img = state.require_image()
    name = args[0]
    if not any(name.endswith("." + e) for e in ("fit", "fits", "fts")):
        name += "." + state.settings.fits_extension
    fits_io.write_fits(state.path(name), img)
    state.log(f"Saving FITS: file {name}")


@command("savebmp", 1, "savebmp filename")
def process_savebmp(state, args):
    from siriltpu_torch.io.formats import save_bmp
    # the reference appends ".bmp" unconditionally (command.c:246)
    save_bmp(state.path(args[0]) + ".bmp", state.require_image())


@command("savejpg", 1, "savejpg filename [quality]")
def process_savejpg(state, args):
    from siriltpu_torch.io.formats import save_jpg
    quality = int(args[1]) if len(args) > 1 else 100
    save_jpg(state.path(args[0]), state.require_image(), quality)


@command("savepnm", 1, "savepnm filename")
def process_savepnm(state, args):
    from siriltpu_torch.io.formats import save_pnm
    save_pnm(state.path(args[0]), state.require_image())


@command("savetif", 1, "savetif filename (16-bit)")
def process_savetif(state, args):
    from siriltpu_torch.io.formats import save_tiff
    save_tiff(state.path(args[0]), state.require_image(), bits=16)


@command("savetif8", 1, "savetif8 filename (8-bit)")
def process_savetif8(state, args):
    from siriltpu_torch.io.formats import save_tiff
    save_tiff(state.path(args[0]), state.require_image(), bits=8)


@command("new", 3, "new width height nb_layers")
def process_new(state, args):
    w, h, nb = int(args[0]), int(args[1]), int(args[2])
    state.set_image(Frame(np.zeros((nb, h, w), dtype=np.uint16)),
                    save_undo=False)


@command("cd", 1, "cd directory")
def process_cd(state, args):
    path = os.path.expanduser(args[0])
    if not os.path.isabs(path):
        path = os.path.join(state.cwd, path)
    if not os.path.isdir(path):
        raise CommandError(f"No such directory: {path}")
    state.cwd = os.path.normpath(path)
    state.log(f"Setting CWD (Current Working Directory) to '{state.cwd}'")


@command("cdg", 0, "cdg")
def process_cdg(state, args):
    state.log(state.cwd)


@command("ls", 0, "ls")
def process_ls(state, args):
    for name in sorted(os.listdir(state.cwd)):
        state.log(name)


@command("exit", 0, "exit")
def process_exit(state, args):
    state.undo.flush()
    raise SystemExit(0)


@command("help", 0, "help")
def process_help(state, args):
    for name in sorted(COMMANDS):
        state.log(COMMANDS[name]["usage"])


# -------------------------------------------------------------- arithmetic

def _imoper_cmd(oper):
    def fn(state, args):
        img = state.require_image()
        other = _read_fits_arg(state, args[0])
        state.set_image(img.with_data(
            imops.imoper(img.data, other.data, oper)))
    return fn


command("iadd", 1, "iadd filename")(_imoper_cmd(imops.OPER_ADD))
command("isub", 1, "isub filename")(_imoper_cmd(imops.OPER_SUB))
command("imul", 1, "imul filename")(_imoper_cmd(imops.OPER_MUL))
command("idiv", 1, "idiv filename")(_imoper_cmd(imops.OPER_DIV))


@command("fdiv", 2, "fdiv filename scalar")
def process_fdiv(state, args):
    img = state.require_image()
    other = _read_fits_arg(state, args[0])
    out, overflow = imops.fdiv(img.data, other.data, float(args[1]))
    if overflow:
        state.log("fdiv: overflow detected")
    state.set_image(img.with_data(out))


@command("fmul", 1, "fmul scalar")
def process_fmul(state, args):
    img = state.require_image()
    state.set_image(img.with_data(
        imops.soper(img.data, float(args[0]), imops.OPER_MUL)))


@command("offset", 1, "offset value")
def process_offset(state, args):
    img = state.require_image()
    state.set_image(img.with_data(imops.off(img.data, float(args[0]))))


@command("addmax", 1, "addmax filename")
def process_addmax(state, args):
    img = state.require_image()
    other = _read_fits_arg(state, args[0])
    state.set_image(img.with_data(imops.addmax(img.data, other.data)))


@command("threshlo", 1, "threshlo level")
def process_threshlo(state, args):
    img = state.require_image()
    state.set_image(img.with_data(imops.threshlo(img.data, int(args[0]))))


@command("threshhi", 1, "threshhi level")
def process_threshhi(state, args):
    img = state.require_image()
    state.set_image(img.with_data(imops.threshhi(img.data, int(args[0]))))


@command("thresh", 2, "thresh hi lo")
def process_thresh(state, args):
    img = state.require_image()
    data = imops.threshlo(img.data, int(args[0]))
    state.set_image(img.with_data(imops.threshhi(data, int(args[1]))))


@command("nozero", 1, "nozero level")
def process_nozero(state, args):
    img = state.require_image()
    state.set_image(img.with_data(imops.nozero(img.data, int(args[0]))))


@command("fill", 1, "fill value [x y w h]")
def process_fill(state, args):
    img = state.require_image()
    rect = _rect_from(args[1:]) or state.selection
    state.set_image(img.with_data(imops.fill(img.data, int(args[0]), rect)))


@command("fill2", 1, "fill2 value [x y w h] (fills rect and its symmetric)")
def process_fill2(state, args):
    img = state.require_image()
    rect = _rect_from(args[1:]) or state.selection
    if rect is None:
        raise CommandError("Select an area first")
    data = imops.fill(img.data, int(args[0]), rect)
    sym = Rect(img.rx - rect.x - rect.w, img.ry - rect.y - rect.h,
               rect.w, rect.h)
    state.set_image(img.with_data(imops.fill(data, int(args[0]), sym)))


def _rect_from(args) -> Optional[Rect]:
    if len(args) >= 4:
        return Rect(int(args[0]), int(args[1]), int(args[2]), int(args[3]))
    return None


# ------------------------------------------------------------- geometric

@command("crop", 0, "crop [x y width height]")
def process_crop(state, args):
    img = state.require_image()
    rect = _rect_from(args) or state.selection
    if rect is None:
        raise CommandError("Crop: select a region or provide x y w h")
    state.set_image(img.with_data(
        imops.crop(img.data, rect.x, rect.y, rect.w, rect.h)))
    state.selection = None


@command("mirrorx", 0, "mirrorx")
def process_mirrorx(state, args):
    img = state.require_image()
    state.set_image(img.with_data(imops.mirrorx(img.data)))


@command("mirrory", 0, "mirrory")
def process_mirrory(state, args):
    img = state.require_image()
    state.set_image(img.with_data(imops.mirrory(img.data)))


@command("rotatepi", 0, "rotatePi")
def process_rotatepi(state, args):
    img = state.require_image()
    state.set_image(img.with_data(imops.rotate_pi(img.data)))


@command("rotate", 1, "rotate angle")
def process_rotate(state, args):
    img = state.require_image()
    state.set_image(img.with_data(imops.rotate(
        img.data, float(args[0]),
        interpolation=state.settings.registration_interpolation,
        device=state.device)))


@command("resample", 1, "resample factor")
def process_resample(state, args):
    img = state.require_image()
    factor = float(args[0])
    if not 0.1 <= factor <= 5.0:
        raise CommandError("The ratio must be in the [0.1, 5.0] range")
    from siriltpu_torch.utils.rounding import np_round_to_int
    state.set_image(img.with_data(imops.resize(
        img.data, int(np_round_to_int(img.rx * factor)),
        int(np_round_to_int(img.ry * factor)), device=state.device)))


@command("shift", 2, "shift sx sy")
def process_shift(state, args):
    img = state.require_image()
    state.set_image(img.with_data(
        imops.shift_image(img.data, int(args[0]), int(args[1]))))


# --------------------------------------------------------------- filtering

@command("gauss", 1, "gauss sigma")
def process_gauss(state, args):
    img = state.require_image()
    state.set_image(img.with_data(
        imops.unsharp(img.data, float(args[0]), 0.0, device=state.device)))


@command("unsharp", 2, "unsharp sigma multi")
def process_unsharp(state, args):
    img = state.require_image()
    state.set_image(img.with_data(
        imops.unsharp(img.data, float(args[0]), float(args[1]),
                      device=state.device)))


@command("fmedian", 2, "fmedian ksize modulation")
def process_fmedian(state, args):
    img = state.require_image()
    state.set_image(img.with_data(
        imops.median_filter(img.data, int(args[0]), float(args[1]))))


@command("fixbanding", 2, "fixbanding amount sigma")
def process_fixbanding(state, args):
    img = state.require_image()
    state.set_image(img.with_data(imops.banding_reduction(
        img.data, float(args[1]), float(args[0]))))


@command("ddp", 3, "ddp level coef sigma")
def process_ddp(state, args):
    img = state.require_image()
    state.set_image(img.with_data(imops.ddp(
        img.data, int(args[0]), float(args[1]), float(args[2]),
        device=state.device)))


@command("log", 0, "log")
def process_log(state, args):
    img = state.require_image()
    state.set_image(img.with_data(imops.loglut(img.data)))


# ------------------------------------------------------------- measurement


@command("cdg", 0, "cdg (center of gravity)")
def process_cdg(state, args):
    """command.c:1165-1172 process_cdg: FindCentre then flip y back to
    top-down for display ("FITS are stored bottom to top")."""
    from siriltpu_torch.ops.quality import find_centre
    img = state.require_image()
    maxi = int(img.data.max())
    res = find_centre(img.data[0], eightbit=(maxi <= 255))
    if res is None:
        raise CommandError("Not enough significant pixels to find the "
                           "center of gravity")
    x_avg, y_avg = res
    y_avg = img.ry - y_avg
    state.log(f"Center of gravity coordinates are ({x_avg:.3f}, {y_avg:.3f})")


@command("stat", 0, "stat")
def process_stat(state, args):
    img = state.require_image()
    for layer in range(img.nlayers):
        st = statistics(img, layer, selection=state.selection,
                        option=STATS_MAIN, nullcheck=True)
        if st is None:
            continue
        state.log(f"{st.layername}: Mean: {st.mean:0.1f}, Median: "
                  f"{st.median:0.1f}, Sigma: {st.sigma:0.1f}, AvgDev: "
                  f"{st.avgdev:0.1f}, Min: {st.min:0.1f}, Max: {st.max:0.1f}")


@command("bg", 0, "bg (background level)")
def process_bg(state, args):
    img = state.require_image()
    for layer in range(img.nlayers):
        st = statistics(img, layer, selection=state.selection,
                        nullcheck=True)
        state.log(f"Background value (channel: #{layer}): {int(st.median)}")


@command("bgnoise", 0, "bgnoise")
def process_bgnoise(state, args):
    img = state.require_image()
    sigmas = imops.background_noise(img.data, device=state.device)
    for i, s in enumerate(sigmas):
        norm = 255.0 if int(img.data.max()) <= 255 else 65535.0
        state.log(f"Background noise value (channel: #{i}): "
                  f"{s:0.3f} ({s / norm:.3e})")


@command("entropy", 0, "entropy")
def process_entropy(state, args):
    img = state.require_image()
    e = sum(imops.entropy(img.data[c], rect=state.selection)
            for c in range(img.nlayers))
    state.log(f"Entropy: {e:.3f}")


@command("contrast", 0, "contrast")
def process_contrast(state, args):
    img = state.require_image()
    for layer in range(img.nlayers):
        st = statistics(img, layer, selection=state.selection, nullcheck=True)
        c = imops.contrast(img.data[layer], st.mean)
        state.log(f"Contrast (channel: #{layer}): {c:.1f}")


@command("histo", 1, "histo layer")
def process_histo(state, args):
    img = state.require_image()
    layer = int(args[0])
    counts = np.bincount(img.data[layer].reshape(-1), minlength=65536)
    name = state.image_name or "image"
    out = state.path(f"histo_{['red','green','blue'][layer] if img.nlayers==3 else 'bw'}.dat")
    with open(out, "w") as f:
        for i, v in enumerate(counts):
            if v:
                f.write(f"{i} {v}\n")
    state.log(f"The file {out} has been created")


@command("psf", 0, "psf (fit the selection)")
def process_psf(state, args):
    from siriltpu_torch.core.frame import select_area
    from siriltpu_torch.ops.psf import fit_psf_single
    img = state.require_image()
    if state.selection is None:
        raise CommandError("Select an area first")
    z = select_area(img.data[0 if img.nlayers == 1 else 1], state.selection)
    st = statistics(z, nullcheck=True)
    fit = fit_psf_single(z, st.median if st else 0.0, fit_angle=True,
                         device=state.device)
    if fit is None:
        raise CommandError("PSF minimisation failed")
    state.log(f"PSF fit Result:\n"
              f"x0={fit['x0'] + state.selection.x:0.2f} px, "
              f"y0={state.selection.y + state.selection.h - fit['y0']:0.2f} px\n"
              f"FWHM X={fit['fwhmx']:0.2f}px, FWHM Y={fit['fwhmy']:0.2f}px\n"
              f"Angle={fit['angle']:0.2f} deg\n"
              f"Background value={fit['B']:0.6f}\n"
              f"Maximal intensity={fit['A']:0.6f}\n"
              f"Magnitude (relative)={fit['mag'] + state.mag_offset:0.2f}\n"
              f"RMSE={fit['rmse']:.3e}")


@command("findstar", 0, "findstar")
def process_findstar(state, args):
    from siriltpu_torch.ops.starfind import peaker
    img = state.require_image()
    layer = 1 if img.nlayers == 3 else 0
    state.stars = peaker(img.data[layer], layer_index=layer,
                         device=state.device)
    state.log(f"Found {len(state.stars)} stars in image, channel #{layer}")


@command("clearstar", 0, "clearstar")
def process_clearstar(state, args):
    state.stars = []


@command("setmag", 1, "setmag magnitude")
def process_setmag(state, args):
    # reference: offset = given magnitude - measured magnitude of selection
    from siriltpu_torch.core.frame import select_area
    from siriltpu_torch.ops.psf import fit_psf_single
    img = state.require_image()
    if state.selection is None:
        raise CommandError("Select an area first")
    z = select_area(img.data[0 if img.nlayers == 1 else 1], state.selection)
    st = statistics(z, nullcheck=True)
    fit = fit_psf_single(z, st.median if st else 0.0, device=state.device)
    if fit is None:
        raise CommandError("PSF minimisation failed")
    state.mag_offset = float(args[0]) - fit["mag"]
    state.log(f"Relative magnitude: {fit['mag']:.3f}, "
              f"True reduced magnitude: {float(args[0]):.3f}, "
              f"Offset: {state.mag_offset:.3f}")


@command("unsetmag", 0, "unsetmag")
def process_unsetmag(state, args):
    state.mag_offset = 0.0


# ----------------------------------------------------------------- color

@command("rmgreen", 1, "rmgreen type (SCNR)")
def process_rmgreen(state, args):
    img = state.require_image()
    if img.nlayers != 3:
        raise CommandError("rmgreen needs an RGB image")
    state.set_image(img.with_data(colors.scnr(img.data, int(args[0]))))


@command("satu", 1, "satu coeff")
def process_satu(state, args):
    img = state.require_image()
    state.set_image(img.with_data(
        colors.enhance_saturation(img.data, float(args[0]))))


@command("split", 3, "split R G B")
def process_split(state, args):
    img = state.require_image()
    if img.nlayers != 3:
        raise CommandError("Siril cannot split layers. Make sure your image is in RGB mode.")
    for i, name in enumerate(args[:3]):
        fits_io.write_fits(
            state.path(name + "." + state.settings.fits_extension),
            Frame(img.data[i : i + 1].copy()))


@command("neutralize", 0, "neutralize (background neutralization)")
def process_neutralize(state, args):
    img = state.require_image()
    if state.selection is None:
        raise CommandError("Select the background area first")
    state.set_image(img.with_data(
        colors.background_neutralize(img.data, state.selection)))


# ----------------------------------------------------------------- FFT

@command("fftd", 2, "fftd magnitude phase")
def process_fftd(state, args):
    from siriltpu_torch.ops.fftops import fftd
    img = state.require_image()
    mod, pha = fftd(img)
    ext = "." + state.settings.fits_extension
    fits_io.write_fits(state.path(args[0] + ext), mod)
    fits_io.write_fits(state.path(args[1] + ext), pha)


@command("ffti", 2, "ffti magnitude phase")
def process_ffti(state, args):
    from siriltpu_torch.ops.fftops import ffti
    ext = "." + state.settings.fits_extension
    mod = fits_io.read_fits(state.path(args[0] + ext)
                            if not os.path.exists(state.path(args[0]))
                            else state.path(args[0]))
    pha = fits_io.read_fits(state.path(args[1] + ext)
                            if not os.path.exists(state.path(args[1]))
                            else state.path(args[1]))
    state.set_image(ffti(mod, pha))


# -------------------------------------------------------------- wavelets

@command("wavelet", 1, "wavelet nbr_plan [type]")
def process_wavelet(state, args):
    from siriltpu_torch.ops.wavelets import atrous_transform, max_nplanes
    img = state.require_image()
    nplanes = int(args[0])
    kind = int(args[1]) if len(args) > 1 else 2
    maxp = max_nplanes(img.rx, img.ry)
    if not 1 < nplanes <= maxp:
        raise CommandError(f"Wavelet: maximum number of plans for this "
                           f"image size is {maxp}")
    import tempfile
    from siriltpu_torch.ops.wave_io import wave_write
    names = ["r", "g", "b"]
    state._wavelets = []
    for c in range(img.nlayers):
        tr = atrous_transform(frames_from_numpy(img.data[c], state.device),
                              nplanes, kind).cpu().numpy()
        state._wavelets.append(tr)
        # reference persists to [rgb]_rawdata.wave in tmp (command.c:484-530)
        wave_write(os.path.join(tempfile.gettempdir(),
                                f"{names[c]}_rawdata.wave"), tr, kind)
    state.log(f"Wavelet: {nplanes} planes computed")


@command("wrecons", 1, "wrecons c1 c2 c3 ...")
def process_wrecons(state, args):
    import torch
    from siriltpu_torch.ops.imops import _ieee_float32_matmul
    from siriltpu_torch.ops.wavelets import atrous_reconstruct
    img = state.require_image()
    tr = getattr(state, "_wavelets", None)
    if not tr:
        # reload from the .wave swap files (reference behavior)
        import tempfile
        from siriltpu_torch.ops.wave_io import wave_read
        names = ["r", "g", "b"]
        tr = []
        try:
            for c in range(img.nlayers):
                planes, _ = wave_read(os.path.join(
                    tempfile.gettempdir(), f"{names[c]}_rawdata.wave"))
                tr.append(planes)
        except (OSError, ValueError):
            raise CommandError("Run wavelet first")
    weights = np.ones(tr[0].shape[0], dtype=np.float32)
    for i, a in enumerate(args[: tr[0].shape[0]]):
        weights[i] = float(a)
    w = torch.from_numpy(weights).to(state.device)
    out = np.empty_like(img.data)
    for c in range(img.nlayers):
        # the weighted sum is a matmul: full float32 on the card, never TF32
        with _ieee_float32_matmul():
            rec = atrous_reconstruct(torch.from_numpy(tr[c]).to(state.device),
                                     w).cpu().numpy()
        out[c] = np_round_to_word(rec.astype(np.float64))
    state.set_image(img.with_data(out))


@command("extract", 1, "extract NbPlans")
def process_extract(state, args):
    from siriltpu_torch.ops.wavelets import atrous_transform
    img = state.require_image()
    nplanes = int(args[0])
    ext = "." + state.settings.fits_extension
    for c in range(img.nlayers):
        tr = atrous_transform(frames_from_numpy(img.data[c], state.device),
                              nplanes, 2).cpu().numpy()
        for p in range(nplanes):
            mx = tr[p].max()
            ratio = 65535.0 / mx if mx > 65535.0 else 1.0
            plane = np_round_to_word(tr[p].astype(np.float64) * ratio)
            fits_io.write_fits(state.path(f"layer{c}_{p:02d}{ext}"),
                               Frame(plane[None]))
    state.log(f"Extracted {nplanes} planes")


# ------------------------------------------------------------ deviant pixels

@command("find_hot", 3, "find_hot filename cold_sigma hot_sigma")
def process_findhot(state, args):
    from siriltpu_torch.ops.cosmetic import find_deviant_pixels
    img = state.require_image()
    devs, icold, ihot = find_deviant_pixels(
        img.data[0], (float(args[1]), float(args[2])))
    path = state.path(args[0] + ".lst")
    with open(path, "w") as f:
        for d in devs:
            # reference lst format: P x y type (y top-down)
            f.write(f"P {d.x} {img.ry - 1 - d.y} "
                    f"{'H' if d.type else 'C'}\n")
    state.log(f"{icold + ihot} pixels ({icold} + {ihot}) found in {path}")


@command("cosme", 1, "cosme filename.lst")
def process_cosme(state, args):
    _cosme(state, args, is_cfa=False)


@command("cosme_cfa", 1, "cosme_cfa filename.lst")
def process_cosme_cfa(state, args):
    _cosme(state, args, is_cfa=True)


def _cosme(state, args, is_cfa):
    from siriltpu_torch.ops.cosmetic import (COLD_PIXEL, HOT_PIXEL, DeviantPixel,
                                       cosmetic_correction, fix_line)
    img = state.require_image()
    path = state.path(args[0] if args[0].endswith(".lst") else args[0] + ".lst")
    data = img.data.copy()
    npix = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "P":
                x, y_td = int(parts[1]), int(parts[2])
                typ = HOT_PIXEL if (len(parts) > 3 and parts[3] == "H") else COLD_PIXEL
                dev = DeviantPixel(x=x, y=img.ry - 1 - y_td, type=typ)
                data[0] = cosmetic_correction(data[0], [dev], is_cfa)
                npix += 1
            elif parts[0] == "L":
                row_td = int(parts[1])
                data[0] = fix_line(data[0], img.ry - 1 - row_td, is_cfa)
                npix += 1
            elif parts[0] == "C":  # column; fix via transpose
                col = int(parts[1])
                data[0] = fix_line(data[0].T.copy(), col, is_cfa).T.copy()
                npix += 1
    state.set_image(img.with_data(data))
    state.log(f"{npix} corrections applied")


@command("find_cosme", 2, "find_cosme cold_sigma hot_sigma")
def process_find_cosme(state, args):
    from siriltpu_torch.ops.cosmetic import auto_detect_and_fix
    img = state.require_image()
    data = img.data.copy()
    data[0], icold, ihot = auto_detect_and_fix(
        img.data[0], (float(args[0]), float(args[1])))
    state.set_image(img.with_data(data))
    state.log(f"{icold + ihot} pixels corrected ({icold} + {ihot})")


command("find_cosme_cfa", 2, "find_cosme_cfa cold hot")(
    COMMANDS["find_cosme"]["fn"])


# --------------------------------------------------------------- sequences

@command("seqfind_cosme", 2, "seqfind_cosme cold_sigma hot_sigma")
def process_seqfind_cosme(state, args):
    from siriltpu_torch.ops.cosmetic import auto_detect_and_fix
    seq = state.require_seq()
    total = 0
    for i in range(seq.number):
        frame = seq.read_frame(i)
        data = frame.data.copy()
        data[0], icold, ihot = auto_detect_and_fix(
            data[0], (float(args[0]), float(args[1])))
        total += icold + ihot
        fits_io.write_fits(
            state.path("cc_" + seq.image_filename(i)), frame.with_data(data))
    state.log(f"{total} pixels corrected across {seq.number} images (cc_ prefix)")


command("seqfind_cosme_cfa", 2, "seqfind_cosme_cfa cold hot")(
    COMMANDS["seqfind_cosme"]["fn"])


@command("select", 2, "select from to")
def process_select(state, args):
    seq = state.require_seq()
    for i in range(int(args[0]), min(int(args[1]) + 1, seq.number)):
        seq.set_included(i, True)
    state.log(f"Selected images {args[0]} to {args[1]}")


@command("unselect", 2, "unselect from to")
def process_unselect(state, args):
    seq = state.require_seq()
    for i in range(int(args[0]), min(int(args[1]) + 1, seq.number)):
        seq.set_included(i, False)
    state.log(f"Unselected images {args[0]} to {args[1]}")


@command("seqload", 1, "seqload seqname (load a sequence)")
def process_seqload(state, args):
    name = args[0]
    from siriltpu_torch.io.films import FILM_EXTENSIONS, film_sequence
    if name.endswith(".ser") or os.path.exists(state.path(name + ".ser")):
        p = state.path(name if name.endswith(".ser") else name + ".ser")
        state.seq = ser_sequence(p)
    elif (name.lower().endswith(tuple("." + e for e in FILM_EXTENSIONS))
          and os.path.exists(state.path(name))):
        # film as a sequence — the reference's SEQ_AVI type
        # (sequence.c seq_check_basic_data / films.c film_open_file)
        state.seq = film_sequence(state.path(name))
    else:
        seqpath = state.path(name[:-4] if name.endswith(".seq") else name)
        if not os.path.exists(seqpath + ".seq"):
            # discover sequences like the reference does after conversion
            # (check_seq builds the .seq sidecars, sequence.c:145)
            check_seq(state.cwd)
        if os.path.exists(seqpath + ".seq"):
            state.seq = read_seqfile(seqpath + ".seq")
        else:
            # last resort for a bare basename: a film of that name.
            # AFTER the .seq check, so a converted sequence always wins
            # over re-reading the raw container it came from.
            film_ext = next(
                (e for e in FILM_EXTENSIONS
                 if os.path.exists(state.path(f"{name}.{e}"))), None)
            if film_ext is None:
                raise CommandError(
                    f"No sequence '{name}' found in {state.cwd}")
            state.seq = film_sequence(state.path(f"{name}.{film_ext}"))
    state.seq.seq_dir = state.cwd
    state.log(f"Sequence loaded: {state.seq.seqname} "
              f"({state.seq.number} images)")


@command("seqcrop", 0, "seqcrop [x y w h]")
def process_seqcrop(state, args):
    seq = state.require_seq()
    rect = _rect_from(args) or state.selection
    if rect is None:
        raise CommandError("Crop: select a region first")
    for i in range(seq.number):
        frame = seq.read_frame(i)
        out = frame.with_data(imops.crop(frame.data, rect.x, rect.y,
                                         rect.w, rect.h))
        fits_io.write_fits(
            state.path("cropped_" + seq.image_filename(i)), out)
    state.log(f"Cropped sequence saved with prefix cropped_")


@command("seqpsf", 0, "seqpsf")
def process_seqpsf(state, args):
    from siriltpu_torch.registration.onestar import seqpsf
    seq = state.require_seq()
    if state.selection is None:
        raise CommandError("Select an area first")
    res = seqpsf(seq, 0, state.selection, for_registration=False,
                 device=state.device)
    for r in res:
        if r.ok:
            state.log(f"Image {r.image_index}: x={r.xpos:.2f} y={r.ypos:.2f} "
                      f"fwhm={r.fwhmx:.2f} mag={r.mag:.3f}")


@command("setmagseq", 1, "setmagseq magnitude")
def process_setmagseq(state, args):
    state.mag_offset = float(args[0])
    state.log(f"Magnitude offset for the sequence: {state.mag_offset}")


@command("unsetmagseq", 0, "unsetmagseq")
def process_unsetmagseq(state, args):
    state.mag_offset = 0.0


@command("stackall", 0, "stackall (sum-stack every sequence in cwd)")
def process_stackall(state, args):
    from siriltpu_torch.stacking.api import stack_sequence
    seqs = check_seq(state.cwd)
    for seq in seqs:
        res = stack_sequence(seq, method="sum", filter_type="all",
                             device=state.device)
        out = f"{seq.seqname}_stacked.{state.settings.fits_extension}"
        fits_io.write_fits(os.path.join(state.cwd, out), Frame(res.data))
        state.log(f"Stacked {seq.seqname} -> {out}")


# ---------------------------------------- pipelines (GUI buttons -> verbs)

@command("register", 1, "register method (dft|onestar|global|ecc) [layer]")
def process_register(state, args):
    from siriltpu_torch.registration.global_star import register_global_star
    from siriltpu_torch.registration.onestar import register_onestar
    from siriltpu_torch.registration.translation import (register_ecc,
                                                   register_shift_dft)
    seq = state.require_seq()
    method = args[0].lower()
    layer = int(args[1]) if len(args) > 1 else (1 if seq.nb_layers == 3 else 0)
    if method == "dft":
        if state.selection is None:
            raise CommandError("DFT registration needs a square selection")
        rep = register_shift_dft(seq, layer, state.selection,
                                 device=state.device)
        state.log(f"Registration finished. Best frame: #{rep.best_frame}.")
    elif method == "onestar":
        if state.selection is None:
            raise CommandError("One-star registration needs a selection")
        best, fwhm, _ = register_onestar(seq, layer, state.selection,
                                         device=state.device)
        state.log(f"Registration finished. Best frame: #{best} "
                  f"with fwhm={fwhm:.3g}.")
    elif method == "global":
        rep = register_global_star(seq, layer, device=state.device)
        state.log(f"Registration finished. {rep.registered} registered, "
                  f"{rep.failed} failed -> sequence {rep.new_seqname}")
    elif method == "ecc":
        rep = register_ecc(seq, layer, device=state.device)
        state.log(f"Registration finished. Best frame: #{rep.best_frame}. "
                  f"{rep.failed} frames excluded.")
    else:
        raise CommandError(f"unknown registration method {method}")
    write_seqfile(seq, state.cwd)


@command("stack", 1, "stack method (sum|mean|median|max|min) "
                     "[rejection] [siglow] [sighigh] [norm]")
def process_stack(state, args):
    from siriltpu_torch.stacking.api import (filter_indices, stack_sequence,
                                       stack_summary)
    seq = state.require_seq()
    method = args[0].lower()
    rejection = args[1] if len(args) > 1 else "none"
    sig = (float(args[2]) if len(args) > 2 else 3.0,
           float(args[3]) if len(args) > 3 else 3.0)
    norm = args[4] if len(args) > 4 else "none"
    nb = len(filter_indices(seq, filter_type="included"))
    for line in stack_summary(nb, method, rejection, sig, norm):
        state.log(line)
    res = stack_sequence(seq, method=method, rejection=rejection, sig=sig,
                         normalize=norm, filter_type="included",
                         device=state.device)
    lo, hi = res.rejection_percent(0)
    if method == "mean":
        state.log(f"Pixel rejection in channel #0: {lo:.3f}% - {hi:.3f}%")
    out = Frame(res.data)
    state.set_image(out, save_undo=False)
    name = f"{seq.seqname}_stacked.{state.settings.fits_extension}"
    fits_io.write_fits(os.path.join(state.cwd, name), out)
    state.log(f"Stacked -> {name}")
    write_seqfile(seq, state.cwd)


@command("preprocess", 0, "preprocess [-bias=f] [-dark=f] [-flat=f] "
                          "[-opt] [-cosme] [-cfa]")
def process_preprocess(state, args):
    from siriltpu_torch.pipelines.preprocess import PreproConfig, seq_preprocess
    seq = state.require_seq()
    cfg = PreproConfig()
    offset = dark = flat = None
    for a in args:
        if a.startswith("-bias=") or a.startswith("-offset="):
            offset = _read_fits_arg(state, a.split("=", 1)[1])
            cfg.use_offset = True
        elif a.startswith("-dark="):
            dark = _read_fits_arg(state, a.split("=", 1)[1])
            cfg.use_dark = True
        elif a.startswith("-flat="):
            flat = _read_fits_arg(state, a.split("=", 1)[1])
            cfg.use_flat = True
        elif a == "-opt":
            cfg.use_dark_optim = True
        elif a == "-cosme":
            cfg.use_cosmetic = True
        elif a == "-cfa":
            cfg.is_cfa = True
    seq_preprocess(seq, offset=offset, dark=dark, flat=flat, config=cfg)
    state.log(f"Preprocessing complete (prefix {cfg.prefix})")


@command("bgextract", 0, "bgextract [order]")
def process_bgextract(state, args):
    from siriltpu_torch.ops.background import BackgroundParams, subtract_background
    img = state.require_image()
    order = int(args[0]) if args else 4
    state.set_image(img.with_data(
        subtract_background(img.data, BackgroundParams(order=order))))
    state.log("Background extracted and subtracted")


@command("autostretch", 0, "autostretch (STF display stretch)")
def process_autostretch(state, args):
    from siriltpu_torch.ops.histogram_ops import autostretch
    img = state.require_image()
    state.set_image(img.with_data(autostretch(img.data)))


@command("mtf", 3, "mtf low mid high")
def process_mtf(state, args):
    from siriltpu_torch.ops.histogram_ops import apply_mtf
    img = state.require_image()
    state.set_image(img.with_data(apply_mtf(
        img.data, float(args[1]), float(args[0]), float(args[2]))))


@command("histeq", 0, "histeq (histogram equalization)")
def process_histeq(state, args):
    from siriltpu_torch.ops.histogram_ops import histeq
    img = state.require_image()
    state.set_image(img.with_data(histeq(img.data)))


@command("convert", 1, "convert basename [-ser] [-debayer] "
                       "(all images in cwd -> FITS sequence or one SER)")
def process_convert(state, args):
    from siriltpu_torch.io.conversion import convert_dir
    # flags mirror the GUI conversion options (conversion.c CONVDSTSER
    # destination-SER checkbox and the debayer toggle)
    to_ser = "-ser" in args
    debayer = "-debayer" in args
    n = convert_dir(state.cwd, args[0], to_ser=to_ser, debayer=debayer,
                    fits_ext=state.settings.fits_extension,
                    settings=state.settings, device=state.device)
    state.log(f"Converted {n} files to sequence {args[0]}")


@command("boxselect", 4, "boxselect x y w h (set the selection)")
def process_boxselect(state, args):
    state.selection = Rect(int(args[0]), int(args[1]), int(args[2]),
                           int(args[3]))
    state.log(f"Selection: {state.selection}")


@command("visu", 2, "visu low high (display cutoffs)")
def process_visu(state, args):
    img = state.require_image()
    lo, hi = int(args[0]), int(args[1])
    if lo < 0 or lo > 65535 or hi < 1 or hi > 65535:
        raise CommandError("visu: bad cutoff values")
    img.meta["lo"], img.meta["hi"] = lo, hi
    state.log(f"Display cutoffs: [{lo}, {hi}]")


@command("setcpu", 1, "setcpu number")
def process_setcpu(state, args):
    state.settings.max_threads = int(args[0])
    state.log(f"Using now {args[0]} logical processors")


@command("undo", 0, "undo")
def process_undo(state, args):
    img = state.require_image()
    prev = state.undo.undo(img)
    if prev is None:
        raise CommandError("Nothing to undo")
    state.image = prev


@command("redo", 0, "redo")
def process_redo(state, args):
    img = state.require_image()
    nxt = state.undo.redo(img)
    if nxt is None:
        raise CommandError("Nothing to redo")
    state.image = nxt



@command("seqexport", 2, "seqexport basename format "
                         "(ser|avi|mjpeg|mp4|webm|fits) [fps] [-norm]")
def process_seqexport(state, args):
    from siriltpu_torch.io.export import ExportArgs, export_sequence
    seq = state.require_seq()
    fps = float(args[2]) if len(args) > 2 and not args[2].startswith("-") else 25.0
    norm = "-norm" in args
    ea = ExportArgs(basename=args[0], fmt=args[1], fps=fps, normalize=norm,
                    crop=state.selection)
    path = export_sequence(seq, ea, directory=state.cwd, device=state.device)
    state.log(f"Exported sequence -> {path}")


@command("rgbcomp", 3, "rgbcomp r_file g_file b_file [lum_file]")
def process_rgbcomp(state, args):
    from siriltpu_torch.pipelines.compositing import CompositionLayer, compose
    layers = []
    for name, color in zip(args[:3], ((1.0, 0, 0), (0, 1.0, 0), (0, 0, 1.0))):
        f = _read_fits_arg(state, name)
        layers.append(CompositionLayer(Frame(f.data[:1].copy()), color))
    lum = None
    if len(args) > 3:
        lf = _read_fits_arg(state, args[3])
        lum = Frame(lf.data[:1].copy())
    state.set_image(compose(layers, luminance=lum), save_undo=False)
    state.log("Composition done")


@command("lightcurve", 0, "lightcurve [outfile.dat] (seqpsf photometry)")
def process_lightcurve(state, args):
    from siriltpu_torch.pipelines.plots import (export_light_curve_dat,
                                          light_curve, plot_svg)
    from siriltpu_torch.registration.onestar import seqpsf
    seq = state.require_seq()
    if state.selection is None:
        raise CommandError("Select the star area first")
    res = seqpsf(seq, 0, state.selection, for_registration=False,
                 device=state.device)
    out = state.path(args[0] if args else "light_curve.dat")
    export_light_curve_dat(res, out)
    # rendered artifact alongside the data (gui/plot.c:751 + gnuplot_i
    # deliver a drawn curve in the reference)
    svg = os.path.splitext(out)[0] + ".svg"
    plot_svg(light_curve(res), svg, ylabel="magnitude", err_column=2,
             title="Light curve")
    n = sum(1 for r in res if r.ok and r.photometry is not None)
    state.log(f"Light curve with {n} points -> {out} (+ {svg})")


@command("regplot", 0, "regplot [outfile.dat] [layer] (quality/FWHM curve)")
def process_regplot(state, args):
    """Export the registration quality/FWHM-vs-frame data the reference
    plots in gui/plot.c (kplot) as gnuplot-ready columns AND a rendered
    SVG curve (the kplot-artifact counterpart)."""
    from siriltpu_torch.pipelines.plots import (export_registration_dat,
                                          plot_svg, registration_curve)
    seq = state.require_seq()
    out = state.path(args[0] if args else "registration.dat")
    layer = int(args[1]) if len(args) > 1 else 0
    if not seq.regparam.get(layer):
        raise CommandError("No registration data for this layer")
    export_registration_dat(seq, out, layer)
    svg = os.path.splitext(out)[0] + ".svg"
    plot_svg(registration_curve(seq, layer), svg, ylabel="quality",
             title="Registration quality")
    state.log(f"Registration curve ({seq.number} frames) -> {out} "
              f"(+ {svg})")


@command("align_rgb", 0, "align_rgb (align the 3 channels of the image)")
def process_align_rgb(state, args):
    from siriltpu_torch.pipelines.compositing import align_rgb
    img = state.require_image()
    state.set_image(align_rgb(img, device=state.device))
    state.log("RGB channels aligned")

__all__ = ["COMMANDS", "process_command"]
