"""Configuration: one flat settings object covering the reference's
``~/.siril/siril.cfg`` knobs (src/core/initfile.c, 8 sections:
working-directory, libraw, debayer, prepro, registration, stacking,
photometry, misc), persisted as JSON.

Port of ``siriltpu.core.config``, copied without change.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Tuple


@dataclass
class Settings:
    # working directory (initfile.c working-directory section)
    working_directory: str = "."
    # libraw settings (struct libraw_config siril.h:447-453; defaults
    # conversion.c:233-245) — drive the demosaiced raw path's
    # postprocess (io/rawproc.py): WB multipliers, brightness, gamma
    # pair, black-point, interpolation quality
    raw_mul_0: float = 1.0       # red multiplier (green fixed at 1)
    raw_mul_2: float = 1.0       # blue multiplier
    raw_bright: float = 1.0
    raw_auto_mul: bool = True    # daylight/default multipliers
    raw_cam_wb: bool = False     # camera white balance when available
    raw_auto_wb: bool = False    # gray-world auto white balance
    raw_user_qual: int = 1       # 0 bilinear, 1 AHD, 2 VNG, 3 PPG->VNG
    raw_user_black: bool = False  # force black level to 0 (dcraw -k 0)
    raw_gamm_0: float = 1.0      # user gamma (libraw gets 1/gamm_0)
    raw_gamm_1: float = 1.0      # toe slope
    # debayer settings (siril.h:462-468)
    debayer_use_header: bool = True
    debayer_pattern: str = "RGGB"
    debayer_method: str = "bilinear"
    debayer_open: bool = False
    # prepro settings
    prepro_cfa: bool = False
    prepro_sigma: Tuple[float, float] = (3.0, 3.0)
    # registration settings
    registration_interpolation: int = 1  # bilinear
    # stacking settings (struct stack_config, siril.h:470-475)
    stack_method: str = "sum"
    stack_rejection: str = "winsorized"
    stack_normalization: str = "none"
    stack_sigma_low: float = 3.0
    stack_sigma_high: float = 3.0
    stack_memory_percent: float = 0.9
    # photometry settings (siril.h:456-460)
    phot_inner: float = 20.0
    phot_outer: float = 30.0
    phot_gain: float = 2.3
    # misc
    fits_extension: str = "fit"
    swap_dir: str = "/tmp"
    max_threads: int = 0  # 0 = all

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "Settings":
        if not os.path.exists(path):
            return cls()
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in raw.items() if k in known}
        if "prepro_sigma" in kw:
            kw["prepro_sigma"] = tuple(kw["prepro_sigma"])
        return cls(**kw)


_SIRIL_PATTERNS = {0: "RGGB", 1: "BGGR", 2: "GBRG", 3: "GRBG"}
_SIRIL_INTERS = {0: "bilinear", 1: "nearest", 2: "vng", 3: "ahd",
                 4: "super_pixel"}
_SIRIL_STACK_METHODS = {0: "sum", 1: "mean", 2: "median", 3: "max", 4: "min"}
_SIRIL_REJECTIONS = {0: "none", 1: "percentile", 2: "sigma", 3: "sigmedian",
                     4: "winsorized", 5: "linearfit"}
_SIRIL_NORMS = {0: "none", 1: "additive", 2: "multiplicative",
                3: "additive_scaling", 4: "multiplicative_scaling"}


def _parse_libconfig(text: str) -> dict:
    """Minimal libconfig reader for the subset siril.cfg uses: top-level
    ``key = value;`` plus one level of ``group : { key = value; ... };``
    (initfile.c:312-420 writes exactly this shape). Values: quoted
    strings, ints, floats, booleans."""
    import re

    def conv(v: str):
        v = v.strip()
        if v.startswith('"') and v.endswith('"'):
            return v[1:-1]
        if v.lower() in ("true", "false"):
            return v.lower() == "true"
        try:
            return int(v)
        except ValueError:
            try:
                return float(v)
            except ValueError:
                return v

    out: dict = {}
    # strip comments
    text = re.sub(r"//[^\n]*|#[^\n]*|/\*.*?\*/", "", text, flags=re.S)
    for gm in re.finditer(r"([\w-]+)\s*[:=]\s*\{(.*?)\}\s*;", text, re.S):
        group = {}
        for km in re.finditer(r"([\w-]+)\s*[:=]\s*([^;{}]+);", gm.group(2)):
            group[km.group(1)] = conv(km.group(2))
        out[gm.group(1)] = group
    flat = re.sub(r"[\w-]+\s*[:=]\s*\{.*?\}\s*;", "", text, flags=re.S)
    for km in re.finditer(r"([\w-]+)\s*=\s*([^;{}]+);", flat):
        out[km.group(1)] = conv(km.group(2))
    return out


def from_siril_cfg(path: str) -> Settings:
    """Import a REFERENCE ``~/.siril/siril.cfg`` (libconfig format,
    initfile.c) into Settings — the switch-over path for existing Siril
    users. Unknown keys are ignored. The libraw-settings section
    (initfile.c:70-91) maps onto the raw_* knobs that drive the
    demosaiced raw path's postprocess (io/rawproc.py)."""
    with open(path) as f:
        cfg = _parse_libconfig(f.read())
    s = Settings()
    wd = cfg.get("working-directory")
    if isinstance(wd, str) and wd:
        s.working_directory = wd
    raw = cfg.get("libraw-settings", {})
    if isinstance(raw, dict):
        s.raw_mul_0 = float(raw.get("mul_0", s.raw_mul_0))
        s.raw_mul_2 = float(raw.get("mul_2", s.raw_mul_2))
        s.raw_bright = float(raw.get("bright", s.raw_bright))
        s.raw_auto_mul = bool(raw.get("auto", s.raw_auto_mul))
        s.raw_cam_wb = bool(raw.get("cam_wb", s.raw_cam_wb))
        s.raw_auto_wb = bool(raw.get("auto_wb", s.raw_auto_wb))
        if isinstance(raw.get("user_qual"), int):
            s.raw_user_qual = raw["user_qual"]
        s.raw_user_black = bool(raw.get("user_black", s.raw_user_black))
        s.raw_gamm_0 = float(raw.get("gamm_0", s.raw_gamm_0))
        s.raw_gamm_1 = float(raw.get("gamm_1", s.raw_gamm_1))
    bay = cfg.get("debayer-settings", {})
    if isinstance(bay, dict):
        s.debayer_use_header = bool(bay.get("ser_use_bayer_header",
                                            s.debayer_use_header))
        s.debayer_pattern = _SIRIL_PATTERNS.get(bay.get("pattern"),
                                                s.debayer_pattern)
        s.debayer_method = _SIRIL_INTERS.get(bay.get("inter"),
                                             s.debayer_method)
    pre = cfg.get("prepro-settings", {})
    if isinstance(pre, dict):
        s.prepro_cfa = bool(pre.get("cfa", s.prepro_cfa))
    stk = cfg.get("stacking-settings", {})
    if isinstance(stk, dict):
        s.stack_method = _SIRIL_STACK_METHODS.get(stk.get("method"),
                                                  s.stack_method)
        s.stack_rejection = _SIRIL_REJECTIONS.get(stk.get("rejection"),
                                                  s.stack_rejection)
        s.stack_normalization = _SIRIL_NORMS.get(stk.get("normalisation"),
                                                 s.stack_normalization)
        mem = stk.get("maxmem")
        if isinstance(mem, (int, float)) and mem > 0.0001:
            s.stack_memory_percent = float(mem)
    pho = cfg.get("photometry-settings", {})
    if isinstance(pho, dict):
        s.phot_gain = float(pho.get("gain", s.phot_gain))
        s.phot_inner = float(pho.get("inner-radius", s.phot_inner))
        s.phot_outer = float(pho.get("outer-radius", s.phot_outer))
    misc = cfg.get("misc-settings", {})
    if isinstance(misc, dict):
        sw = misc.get("swap_directory")
        if isinstance(sw, str) and sw:
            s.swap_dir = sw
        ext = misc.get("extension")
        if isinstance(ext, str) and ext:
            s.fits_extension = ext.lstrip(".")
    return s


DEFAULT_CONFIG_PATH = os.path.expanduser("~/.siriltpu/config.json")


def load_default() -> Settings:
    return Settings.load(DEFAULT_CONFIG_PATH)


__all__ = ["Settings", "load_default", "DEFAULT_CONFIG_PATH"]
