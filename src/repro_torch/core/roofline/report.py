"""Roofline reporting for the primitive studies: the log-log ASCII
roofline (the paper communicates through roofline plots: kernel dots
under a compute / memory roof)."""

from __future__ import annotations

import math
from typing import Sequence, Tuple


def fmt_si(x: float, unit: str = "") -> str:
    """``x`` with an SI prefix, 3 significant digits."""
    if x == 0:
        return f"0{unit}"
    if x != x or x in (float("inf"), float("-inf")):
        return str(x)
    for scale, suffix in ((1e15, "P"), (1e12, "T"), (1e9, "G"), (1e6, "M"),
                          (1e3, "K")):
        if abs(x) >= scale:
            return f"{x / scale:.3g}{suffix}{unit}"
    if abs(x) >= 1:
        return f"{x:.3g}{unit}"
    for scale, suffix in ((1e-3, "m"), (1e-6, "u"), (1e-9, "n")):
        if abs(x) >= scale:
            return f"{x / scale:.3g}{suffix}{unit}"
    return f"{x:.3g}{unit}"


def ascii_roofline(points: Sequence[Tuple[str, float, float]], *,
                   peak_flops: float, mem_bw: float, width: int = 72,
                   height: int = 20) -> str:
    """Log-log ASCII roofline of ``points``: (label, arithmetic intensity
    in FLOP/B, attained FLOP/s) under the roof min(peak_flops, AI *
    mem_bw)."""
    if not points:
        return "(no points)"
    ais = [max(p[1], 1e-6) for p in points]
    xmin = min(min(ais) / 4, peak_flops / mem_bw / 16)
    xmax = max(max(ais) * 4, peak_flops / mem_bw * 16)
    ymax = peak_flops * 2
    ymin = min(min(max(p[2], 1.0) for p in points) / 4, peak_flops / 1e5)
    lx0, lx1 = math.log10(xmin), math.log10(xmax)
    ly0, ly1 = math.log10(ymin), math.log10(ymax)
    grid = [[" "] * width for _ in range(height)]

    def to_col(x):
        return int((math.log10(max(x, 1e-12)) - lx0) / (lx1 - lx0)
                   * (width - 1))

    def to_row(y):
        r = int((math.log10(max(y, 1e-12)) - ly0) / (ly1 - ly0)
                * (height - 1))
        return height - 1 - max(0, min(height - 1, r))

    for col in range(width):                       # roof: min(pi, I beta)
        x = 10 ** (lx0 + (lx1 - lx0) * col / (width - 1))
        y = min(peak_flops, x * mem_bw)
        grid[to_row(y)][col] = "-" if y >= peak_flops * 0.999 else "/"

    marks = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    legend = []
    for i, (label, ai, perf) in enumerate(points):
        m = marks[i % len(marks)]
        grid[to_row(perf)][max(0, min(width - 1, to_col(ai)))] = m
        legend.append(
            f"  {m} = {label}: AI={ai:.1f} F/B, attained="
            f"{fmt_si(perf, 'FLOP/s')} "
            f"({perf / min(peak_flops, ai * mem_bw) * 100:.1f}% of roof)")
    header = (f"roofline: peak={fmt_si(peak_flops, 'FLOP/s')}  "
              f"bw={fmt_si(mem_bw, 'B/s')}  ridge AI="
              f"{peak_flops / mem_bw:.1f} F/B")
    axis = (f"AI: {xmin:.2g} .. {xmax:.2g} F/B (log)   perf: {ymin:.2g} .. "
            f"{ymax:.2g} FLOP/s (log)")
    return "\n".join([header] + ["".join(r) for r in grid] + [axis]
                     + legend)
