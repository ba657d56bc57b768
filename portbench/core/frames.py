"""The benchmark's inputs: a drifting sequence of uint16 frames made on the
device from a seed, and the SER file a capture program would have written
for it.

The frame generator follows ``chip_smoke.py:make_frames`` (a background
near 1000 with a per-frame level, point sources, a whole-pixel drift with
zero fill, fresh noise, cold and hot outliers), written here in plain
PyTorch so that nothing of the program under test makes its inputs. The
number of point sources and the outlier rate come from the configuration.
The noise is drawn in a few large calls, not frame by frame.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

#: frames whose noise is drawn in one call: at most this many values
_CHUNK_VALUES = 1 << 28


def shift_into(out: torch.Tensor, src: torch.Tensor, sx: int, sy: int) -> None:
    """out[y, x] = src[y - sy, x - sx] where that lies inside src; the rest
    of ``out`` is left as it is."""
    h, w = src.shape
    y0, y1 = max(0, sy), min(h, h + sy)
    x0, x1 = max(0, sx), min(w, w + sx)
    if y0 < y1 and x0 < x1:
        out[y0:y1, x0:x1] = src[y0 - sy:y1 - sy, x0 - sx:x1 - sx]


def to_u16(x: torch.Tensor) -> torch.Tensor:
    """Integer-valued tensor in 0..65535 -> uint16 (through int32 and int16,
    since torch converts to uint16 from few types)."""
    return x.to(torch.int32).to(torch.int16).view(torch.uint16)


def u16_to_i32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def u16_to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16).cpu().numpy().view(np.uint16)


def make_frames(config: dict, seed: int, device):
    """(F, H, W) uint16 frames on ``device`` and the (F, 2) int32 shifts
    (shiftx, shifty) that undo each frame's drift, from ``seed``.

    ``config`` gives ``frames``, ``height``, ``width``, ``drift`` (each
    frame moves by a whole-pixel shift in [-drift, drift], frame 0 by
    none), ``points`` (bright point sources of the static sky) and
    ``outlier_every`` (each frame gets cold (0) and hot (60000) pixels in
    one of every ``outlier_every`` of its pixels each; 0 for none)."""
    f, h, w = config["frames"], config["height"], config["width"]
    rng = np.random.default_rng(seed)
    drift = rng.integers(-config["drift"], config["drift"] + 1, (f, 2))
    drift[0] = 0
    level = torch.from_numpy(rng.integers(-40, 41, f).astype(np.float32)).to(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    kw = dict(generator=g, device=device)
    base = 1000.0 + 15.0 * torch.randn((h, w), **kw)
    npts = config["points"]
    ys = torch.randint(0, h, (npts,), **kw)
    xs = torch.randint(0, w, (npts,), **kw)
    base.index_put_((ys, xs), 3000.0 + 37000.0 * torch.rand((npts,), **kw),
                    accumulate=True)
    frames = torch.empty((f, h, w), dtype=torch.int16, device=device)
    every = config["outlier_every"]
    nout = h * w // every if every else 0
    step = max(1, _CHUNK_VALUES // (h * w))
    for a in range(0, f, step):
        b = min(a + step, f)
        sky = torch.zeros((b - a, h, w), device=device)
        for i in range(a, b):
            shift_into(sky[i - a], base, int(drift[i, 0]), int(drift[i, 1]))
        sky += level[a:b, None, None]
        sky += 10.0 * torch.randn((b - a, h, w), **kw)
        block = to_u16(sky.clamp_(0, 65535)).view(torch.int16).reshape(b - a, -1)
        del sky
        if nout:
            rows = torch.arange(b - a, device=device)[:, None]
            for value in (0, 60000):
                idx = torch.randint(0, h * w, (b - a, nout), **kw)
                block[rows, idx] = int(np.uint16(value).view(np.int16))
        frames[a:b] = block.reshape(b - a, h, w)
    return frames.view(torch.uint16), (-drift).astype(np.int32)


# SER: a 178-byte little-endian header, then the frames top-down, 16-bit
# little-endian (the format's LittleEndian flag 0 says so, in the inverted
# meaning Siril and the first writers gave it)
_SER_HEADER = "<14siiiiiiI40s40s40sqq"


def write_ser(path: str, frames: torch.Tensor, chunk: int = 64) -> int:
    """Write (F, H, W) uint16 frames, bottom-up rows as Siril holds them, as
    a mono 16-bit SER file. Returns the bytes written."""
    f, h, w = frames.shape
    header = struct.pack(_SER_HEADER, b"LUCAM-RECORDER", 0, 0, 0, w, h, 16, f,
                         b"", b"", b"", 0, 0)
    with open(path, "wb") as out:
        out.write(header)
        for a in range(0, f, chunk):
            block = frames[a:a + chunk].flip(1).contiguous()
            out.write(block.view(torch.int16).cpu().numpy().astype("<i2").tobytes())
    return os.path.getsize(path)


__all__ = ["make_frames", "write_ser", "shift_into", "to_u16", "u16_to_i32",
           "u16_to_numpy"]
