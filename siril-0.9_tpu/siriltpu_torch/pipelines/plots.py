"""Registration-quality / FWHM plots and photometry light curves.

Port of ``siriltpu.pipelines.plots``, copied without change: the
``.dat`` and ``.svg`` files are equal byte for byte. ``plot_png`` imports
matplotlib only when called.

Reference: src/gui/plot.c (quality and FWHM curves via the vendored
kplot library) and the gnuplot light-curve export (src/gui/gnuplot_i/).
Here: plain ``.dat`` exports (gnuplot-compatible, like the reference's
light-curve files) plus optional PNG rendering through matplotlib when
available.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def registration_curve(seq, layer: int = 0):
    """(frame index, quality, fwhm) rows for plotting (plot.c data)."""
    reg = seq.regparam.get(layer) or []
    rows = []
    for i, r in enumerate(reg):
        rows.append((i, r.quality, r.fwhm))
    return np.asarray(rows, dtype=np.float64).reshape(-1, 3)


def export_registration_dat(seq, path: str, layer: int = 0) -> str:
    rows = registration_curve(seq, layer)
    with open(path, "w") as f:
        f.write("# frame quality fwhm\n")
        for i, q, fw in rows:
            f.write(f"{int(i)} {q:g} {fw:g}\n")
    return path


def light_curve(results, use_julian: bool = False):
    """(index_or_time, mag, err) from seqpsf photometry results
    (the light-curve data exported through gnuplot in the reference)."""
    rows = []
    for r in results:
        if not r.ok or r.photometry is None:
            continue
        rows.append((r.image_index, r.photometry.mag, r.photometry.s_mag))
    return np.asarray(rows, dtype=np.float64).reshape(-1, 3)


def export_light_curve_dat(results, path: str) -> str:
    rows = light_curve(results)
    with open(path, "w") as f:
        f.write("# frame magnitude error\n")
        for i, m, e in rows:
            f.write(f"{int(i)} {m:g} {e:g}\n")
    return path


def plot_svg(rows: np.ndarray, path: str, *, ylabel: str = "quality",
             column: int = 1, err_column: Optional[int] = None,
             title: str = "") -> str:
    """Render a curve to SVG with a dependency-free writer — the
    rendered-artifact counterpart of what the reference draws via the
    vendored kplot (gui/plot.c:751: x/y axes, tick labels, a point-line
    series) and exports via gnuplot (gui/gnuplot_i/). Optional
    ``err_column`` draws vertical error bars (light curves).
    """
    rows = np.asarray(rows, np.float64).reshape(len(rows), -1)
    W, H = 800, 400
    ml, mr, mt, mb = 64, 16, 28 if title else 16, 40
    pw, ph = W - ml - mr, H - mt - mb

    xs = rows[:, 0] if len(rows) else np.zeros(0)
    ys = rows[:, column] if len(rows) else np.zeros(0)
    es = (rows[:, err_column] if err_column is not None and len(rows)
          else np.zeros_like(ys))
    if len(rows):
        x0, x1 = float(xs.min()), float(xs.max())
        ylo = float((ys - es).min())
        yhi = float((ys + es).max())
    else:
        x0, x1, ylo, yhi = 0.0, 1.0, 0.0, 1.0
    if x1 == x0:
        x1 = x0 + 1.0
    if yhi == ylo:
        yhi = ylo + 1.0
    pad = 0.05 * (yhi - ylo)
    ylo -= pad
    yhi += pad

    def px(x):
        return ml + (x - x0) / (x1 - x0) * pw

    def py(y):
        return mt + (yhi - y) / (yhi - ylo) * ph

    def ticks(lo, hi, n=6):
        span = hi - lo
        step = 10.0 ** np.floor(np.log10(span / n))
        for m in (1, 2, 5, 10):
            if span / (step * m) <= n:
                step *= m
                break
        t0 = np.ceil(lo / step) * step
        return np.arange(t0, hi + step / 2, step)

    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" '
           f'height="{H}" viewBox="0 0 {W} {H}">',
           f'<rect width="{W}" height="{H}" fill="white"/>']
    if title:
        out.append(f'<text x="{W / 2:.0f}" y="18" text-anchor="middle" '
                   f'font-family="sans-serif" font-size="14">{title}</text>')
    # grid + tick labels
    for tx in ticks(x0, x1):
        X = px(tx)
        out.append(f'<line x1="{X:.1f}" y1="{mt}" x2="{X:.1f}" '
                   f'y2="{mt + ph}" stroke="#ddd"/>')
        out.append(f'<text x="{X:.1f}" y="{mt + ph + 16}" '
                   f'text-anchor="middle" font-family="sans-serif" '
                   f'font-size="11">{tx:g}</text>')
    for ty in ticks(ylo, yhi):
        Y = py(ty)
        out.append(f'<line x1="{ml}" y1="{Y:.1f}" x2="{ml + pw}" '
                   f'y2="{Y:.1f}" stroke="#ddd"/>')
        out.append(f'<text x="{ml - 6}" y="{Y + 4:.1f}" text-anchor="end" '
                   f'font-family="sans-serif" font-size="11">{ty:g}</text>')
    # axes
    out.append(f'<rect x="{ml}" y="{mt}" width="{pw}" height="{ph}" '
               f'fill="none" stroke="black"/>')
    out.append(f'<text x="{ml + pw / 2:.0f}" y="{H - 6}" '
               f'text-anchor="middle" font-family="sans-serif" '
               f'font-size="12">frame</text>')
    out.append(f'<text x="14" y="{mt + ph / 2:.0f}" text-anchor="middle" '
               f'font-family="sans-serif" font-size="12" '
               f'transform="rotate(-90 14 {mt + ph / 2:.0f})">'
               f'{ylabel}</text>')
    # error bars
    if err_column is not None:
        for x, y, e in zip(xs, ys, es):
            out.append(f'<line x1="{px(x):.1f}" y1="{py(y - e):.1f}" '
                       f'x2="{px(x):.1f}" y2="{py(y + e):.1f}" '
                       f'stroke="#888"/>')
    # series polyline + point markers (kplot's point-line style)
    if len(rows) > 1:
        pts = " ".join(f"{px(x):.1f},{py(y):.1f}" for x, y in zip(xs, ys))
        out.append(f'<polyline points="{pts}" fill="none" '
                   f'stroke="#1a6fb4" stroke-width="1.5"/>')
    for x, y in zip(xs, ys):
        out.append(f'<circle cx="{px(x):.1f}" cy="{py(y):.1f}" r="2.5" '
                   f'fill="#1a6fb4"/>')
    out.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(out))
    return path


def plot_png(rows: np.ndarray, path: str, *, ylabel: str = "quality",
             column: int = 1) -> Optional[str]:
    """Render a curve to PNG via matplotlib (None if unavailable)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(rows[:, 0], rows[:, column], "o-")
    ax.set_xlabel("frame")
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


__all__ = ["registration_curve", "export_registration_dat", "light_curve",
           "export_light_curve_dat", "plot_png", "plot_svg"]
