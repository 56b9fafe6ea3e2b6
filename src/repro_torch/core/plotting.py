"""Log-log instruction roofline figures (paper Figs 4-7 style) as SVG —
port of ``repro/core/plotting.py``.

The JAX module draws a PNG through matplotlib, which the card's machine
does not have.  This one writes the same figure with the standard
library: log-log axes over the same ranges, every ceiling as a line
across them, every point as a marker, a legend of the ceilings' and
points' labels, decade grid lines, the axis titles and the model's
title.  The root element carries the plot box and both ranges
(``data-box``, ``data-x-range``, ``data-y-range``), so a reader can map
any coordinate back to intensity and GIPS.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple
from xml.sax.saxutils import escape, quoteattr

from repro_torch.core.irm import InstructionRooflineModel

WIDTH, HEIGHT = 720, 520
BOX = (80.0, 50.0, 440.0, 400.0)        # left, top, width, height
COLORS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
          "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")
SERIES_MARK = {"HBM": "circle", "TC": "square", "WARP": "triangle",
               "L1": "triangle", "L2": "square"}


def x_range_of(model: InstructionRooflineModel) -> Tuple[float, float]:
    """The JAX figure's x range: a decade beyond the points, and beyond
    the knee."""
    xs = [p.intensity for p in model.points if p.intensity > 0]
    lo = min(xs) / 10 if xs else 1e-3
    hi = max(xs) * 10 if xs else 1e2
    knee = model.knee()
    return min(lo, knee / 10), max(hi, knee * 10)


def y_range_of(model: InstructionRooflineModel,
               x_range: Tuple[float, float]) -> Tuple[float, float]:
    """Every ceiling at both ends of the x range and every point, with
    a factor of 2 of margin."""
    ys = [c.y_at(x) for c in model.ceilings for x in x_range]
    ys += [p.gips for p in model.points if p.gips > 0]
    ys = [y for y in ys if y > 0]
    return min(ys) / 2, max(ys) * 2


def to_svg(v: float, rng: Tuple[float, float], start: float, span: float,
           flip: bool) -> float:
    """Log mapping of ``v`` in ``rng`` onto [start, start + span]
    (from the far end when ``flip``: the SVG y axis points down)."""
    f = (math.log10(v) - math.log10(rng[0])) / (
        math.log10(rng[1]) - math.log10(rng[0]))
    return start + span * (1 - f if flip else f)


def _marker(kind: str, x: float, y: float, color: str, attrs: str) -> str:
    if kind == "square":
        return (f'<rect {attrs} x="{x - 5:.3f}" y="{y - 5:.3f}" width="10" '
                f'height="10" fill="{color}"/>')
    if kind == "triangle":
        pts = f"{x:.3f},{y - 6:.3f} {x - 6:.3f},{y + 5:.3f} " \
              f"{x + 6:.3f},{y + 5:.3f}"
        return f'<polygon {attrs} points="{pts}" fill="{color}"/>'
    return f'<circle {attrs} r="5" fill="{color}"/>'


def plot_irm(model: InstructionRooflineModel, path: str,
             x_range: Optional[tuple] = None) -> str:
    """Write the figure of ``model`` to ``path`` (which must end in
    ``.svg``); returns the path."""
    if not path.lower().endswith(".svg"):
        raise ValueError(f"plot_irm writes SVG: {path!r} does not end in "
                         f".svg")
    xr = tuple(x_range) if x_range is not None else x_range_of(model)
    yr = y_range_of(model, xr)
    left, top, w, h = BOX

    def X(v):
        return to_svg(v, xr, left, w, False)

    def Y(v):
        return to_svg(v, yr, top, h, True)

    out: List[str] = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{WIDTH}" '
        f'height="{HEIGHT}" viewBox="0 0 {WIDTH} {HEIGHT}" '
        f'data-box="{left} {top} {w} {h}" '
        f'data-x-range="{xr[0]!r} {xr[1]!r}" '
        f'data-y-range="{yr[0]!r} {yr[1]!r}">',
        f'<rect x="0" y="0" width="{WIDTH}" height="{HEIGHT}" fill="white"/>',
        f'<text x="{left + w / 2}" y="28" text-anchor="middle" '
        f'font-size="14">{escape(model.title)}</text>']
    for axis, rng in (("x", xr), ("y", yr)):
        for k in range(math.floor(math.log10(rng[0])),
                       math.ceil(math.log10(rng[1])) + 1):
            v = 10.0 ** k
            if not rng[0] <= v <= rng[1]:
                continue
            if axis == "x":
                p = X(v)
                out.append(f'<line class="grid" x1="{p:.3f}" y1="{top}" '
                           f'x2="{p:.3f}" y2="{top + h}" stroke="#ddd"/>')
                out.append(f'<text x="{p:.3f}" y="{top + h + 16}" '
                           f'text-anchor="middle" font-size="10">1e{k}'
                           f'</text>')
            else:
                p = Y(v)
                out.append(f'<line class="grid" x1="{left}" y1="{p:.3f}" '
                           f'x2="{left + w}" y2="{p:.3f}" stroke="#ddd"/>')
                out.append(f'<text x="{left - 6}" y="{p + 4:.3f}" '
                           f'text-anchor="end" font-size="10">1e{k}</text>')
    out.append(f'<rect x="{left}" y="{top}" width="{w}" height="{h}" '
               f'fill="none" stroke="black"/>')
    out.append(f'<text x="{left + w / 2}" y="{top + h + 36}" '
               f'text-anchor="middle" font-size="12">Instruction intensity '
               f'(instructions / byte)</text>')
    out.append(f'<text x="20" y="{top + h / 2}" text-anchor="middle" '
               f'font-size="12" transform="rotate(-90 20 {top + h / 2})">'
               f'Performance (GIPS)</text>')
    out.append(f'<clipPath id="box"><rect x="{left}" y="{top}" '
               f'width="{w}" height="{h}"/></clipPath>')
    legend = []
    for i, c in enumerate(model.ceilings):
        color = COLORS[i % len(COLORS)]
        pts = " ".join(f"{X(x):.6f},{Y(c.y_at(x)):.6f}" for x in xr)
        out.append(f'<polyline class="ceiling" data-label='
                   f'{quoteattr(c.label)} points="{pts}" fill="none" '
                   f'stroke="{color}" stroke-width="1.6" '
                   f'clip-path="url(#box)"/>')
        legend.append((f'<line x1="0" y1="0" x2="16" y2="0" '
                       f'stroke="{color}" stroke-width="2"/>', c.label))
    for i, p in enumerate(model.points):
        if p.intensity <= 0 or p.gips <= 0:
            continue
        color = COLORS[(i + len(model.ceilings)) % len(COLORS)]
        kind = SERIES_MARK.get(p.series, "circle")
        x, y = X(p.intensity), Y(p.gips)
        attrs = (f'class="point" data-label={quoteattr(p.label)} '
                 f'data-series={quoteattr(p.series)} '
                 f'data-cx="{x:.6f}" data-cy="{y:.6f}"'
                 + (f' cx="{x:.6f}" cy="{y:.6f}"' if kind == "circle"
                    else ""))
        out.append(_marker(kind, x, y, color, attrs))
        legend.append((_marker(kind, 8, 0, color, 'class="key"'), p.label))
    lx = left + w + 16
    for j, (mark, label) in enumerate(legend):
        ly = top + 8 + 16 * j
        out.append(f'<g transform="translate({lx} {ly})">{mark}'
                   f'<text x="22" y="4" font-size="10">{escape(label)}'
                   f'</text></g>')
    out.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path
