"""Roofline reporting: tables, the log-log ASCII roofline and one-cell
reports.  The paper communicates through roofline plots (kernel dots
under a compute / memory roof); the tables carry the hierarchical and
time-based rooflines (arXiv 2009.05257 / 2009.04598) and the live
attainment windows of ``obs.attainment``, with the reference's columns
and formats."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .hardware import MEMORY_LEVELS
from .model import (LevelBetas, PhaseTraffic, RooflineTerms,
                    attribution_residual, overlapped_budget,
                    time_attribution)


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


def _fmt_s(x: float) -> str:
    return fmt_si(x, "s")


TERMS_HEADER = [
    "cell", "scope", "compute", "memory", "ici", "dcn",
    "bound", "AI(F/B)", "useful", "roofline%",
]


def terms_row(label: str, t: RooflineTerms) -> List[str]:
    rf = t.roofline_fraction
    ur = t.useful_ratio
    return [
        label, t.scope, _fmt_s(t.compute_s), _fmt_s(t.memory_s),
        _fmt_s(t.ici_s), _fmt_s(t.dcn_s), t.bound_class(),
        f"{t.arithmetic_intensity:.1f}",
        f"{ur:.2f}" if ur is not None else "-",
        f"{rf * 100:.1f}%" if rf is not None else "-",
    ]


COMM_HEADER = [
    "cell", "scope", "I_hbm", "I_ici", "hbm roof", "ici roof",
    "binds", "attainable",
]


def comm_terms_row(label: str, t: RooflineTerms) -> List[str]:
    """The HBM intensity beside the card-to-card intensity, each roof's
    ceiling and which binds (the paper's local vs remote-traffic roofs).
    A step that moves no ``ici`` bytes (one card) renders ``unbound``."""
    roofs = t.roofs()
    ici_i = t.ici_intensity
    return [
        label, t.scope, f"{t.arithmetic_intensity:.1f}",
        "unbound" if ici_i == float("inf") else f"{ici_i:.1f}",
        fmt_si(roofs["hbm"], "F/s"),
        fmt_si(roofs["ici"], "F/s") if "ici" in roofs else "unbound",
        t.binding_roof, fmt_si(t.attainable_flops_comm, "F/s"),
    ]


MIGRATION_HEADER = [
    "cell", "scope", "link", "mig bytes/dev", "I_mig", "mig roof",
    "mig time", "binds",
]


def migration_row(label: str, t: RooflineTerms) -> List[str]:
    """The KV-migration roof of one step: its bytes, the link that carried
    them, the intensity and ceiling beside the binding roof; a step that
    migrated nothing renders ``unbound``."""
    roofs = t.roofs()
    b = t.migration_bytes_dev
    intensity = t.flops_dev / b if b > 0 else float("inf")
    return [
        label, t.scope, t.migration_link,
        fmt_si(b, "B") if b > 0 else "0B",
        "unbound" if intensity == float("inf") else f"{intensity:.1f}",
        fmt_si(roofs["migration"], "F/s") if "migration" in roofs
        else "unbound",
        _fmt_s(t.migration_s), t.binding_roof,
    ]


HIERARCHY_HEADER = [
    "cell", "level", "bytes/dev", "beta", "I (F/B)", "roof", "time",
]


def hierarchy_rows(label: str, t: RooflineTerms) -> List[List[str]]:
    """Every memory level's bytes, beta, intensity, ceiling and time for
    one step's terms.  Unbound levels (zero bytes) keep their row,
    rendered ``unbound``, so the table shows the whole ladder; a level
    with bytes and no beta has no roof (``unbound``) and no time."""
    times = {"vmem": t.vmem_s, "hbm": t.memory_s, "ici": t.ici_s,
             "dcn": t.dcn_s, "host": t.host_s}
    pi = t.chip.flops_for(t.dtype)
    rows = [[label, "compute", "-", fmt_si(pi, "F/s"), "-",
             fmt_si(pi, "F/s"), _fmt_s(t.compute_s)]]
    for level in MEMORY_LEVELS:
        b = t.level_bytes(level)
        beta = fmt_si(t.chip.level_bw(level), "B/s")
        if b <= 0:
            rows.append([label, level, "0B", beta, "unbound", "unbound",
                         "0s"])
            continue
        roof = t.level_roof(level)
        rows.append([
            label, level, fmt_si(b, "B"), beta,
            f"{t.level_intensity(level):.1f}",
            fmt_si(roof, "F/s") if roof is not None else "unbound",
            _fmt_s(times[level]),
        ])
    return rows


TIME_BUDGET_HEADER = [
    "phase", "steps", "tokens", "wall", "compute", "vmem", "hbm", "ici",
    "dcn", "host", "dispatch", "residual",
]

TIME_BUDGET_OVERLAP_HEADER = TIME_BUDGET_HEADER + ["serial", "overlapped"]


def _budget_row(name: str, ph: PhaseTraffic, betas: LevelBetas,
                dispatch_s_per_step: float,
                overlap: Optional[Dict[str, float]]) -> List[str]:
    att = time_attribution(ph, betas, dispatch_s_per_step)
    res = attribution_residual(ph, betas, dispatch_s_per_step)
    row = [
        name, str(ph.steps), str(ph.tokens), _fmt_s(ph.wall_s),
        _fmt_s(att["compute"]),
        *[_fmt_s(att[lvl]) for lvl in MEMORY_LEVELS],
        _fmt_s(att["dispatch"]),
        f"{res * 100:+.1f}%" if res == res else "-",
    ]
    if overlap is not None:
        row.append(_fmt_s(sum(att.values())))
        row.append(_fmt_s(overlapped_budget(att, overlap)))
    return row


def time_budget_rows(phases: Dict[str, PhaseTraffic], betas: LevelBetas,
                     dispatch_s_per_step: float = 0.0,
                     overlap: Optional[Dict[str, float]] = None
                     ) -> List[List[str]]:
    """One row per serving phase: its measured wall decomposed into
    per-level ``bytes / beta`` terms plus the dispatch floor, and the
    signed share of the wall left unexplained (``residual``); then a
    ``total`` row.  With ``overlap`` (per-level fractions,
    :func:`model.overlapped_budget`) every row gains the serial and the
    overlapped budget (:data:`TIME_BUDGET_OVERLAP_HEADER`)."""
    rows = []
    total = PhaseTraffic()
    for name, ph in phases.items():
        if ph.steps == 0 and ph.wall_s == 0:
            continue
        rows.append(_budget_row(name, ph, betas, dispatch_s_per_step,
                                overlap))
        total.add(flops=ph.flops, vmem=ph.vmem, hbm=ph.hbm, ici=ph.ici,
                  dcn=ph.dcn, host=ph.host, wall_s=ph.wall_s,
                  steps=ph.steps, tokens=ph.tokens)
    if rows:
        rows.append(_budget_row("total", total, betas, dispatch_s_per_step,
                                overlap))
    return rows


ATTAINMENT_HEADER = [
    "window", "pid", "dt", "tokens", "tok/s", "attained", "roof",
    "binds", "frac", "per-level",
]


def attainment_rows(windows: Sequence) -> List[List[str]]:
    """One row per closed attainment window (``obs.attainment.
    AttainmentWindow``, duck-typed): its attained FLOP/s against the roof
    that bound it, and the fraction of every level's roof."""
    rows = []
    for w in windows:
        ladder = " ".join(
            f"{lvl}={w.attainment[lvl] * 100:.2g}%"
            for lvl in sorted(w.attainment))
        rows.append([
            str(w.index), str(w.pid), _fmt_s(w.dt_s), str(w.tokens),
            f"{w.tokens / w.dt_s:.0f}" if w.dt_s > 0 else "-",
            fmt_si(w.flops_per_s, "F/s"),
            fmt_si(w.roofs[w.binding_roof], "F/s"),
            w.binding_roof, f"{w.fraction * 100:.2g}%", ladder,
        ])
    return rows


def markdown_table(rows: Sequence[Sequence[str]],
                   header: Sequence[str]) -> str:
    out = ["| " + " | ".join(header) + " |",
           "|" + "|".join(["---"] * len(header)) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(c) for c in r) + " |")
    return "\n".join(out)


def text_table(rows: Sequence[Sequence[str]], header: Sequence[str]) -> str:
    widths = [len(h) for h in header]
    for r in rows:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(str(c)))

    def line(cells):
        return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths))
    sep = "  ".join("-" * w for w in widths)
    return "\n".join([line(header), sep] + [line(r) for r in rows])


def render_report(label: str, t: RooflineTerms,
                  extra: Iterable[str] = ()) -> str:
    """One cell's terms as a short text report."""
    lines = [
        f"== roofline: {label} ==",
        f"  scope={t.scope} chips={t.n_chips} dtype={t.dtype}",
        f"  W   (flops/dev)      = {fmt_si(t.flops_dev, 'F')}   -> compute "
        f"{_fmt_s(t.compute_s)}",
        f"  Q   (hbm bytes/dev)  = {fmt_si(t.hbm_bytes_dev, 'B')}   -> "
        f"memory  {_fmt_s(t.memory_s)}",
        f"  C   (ici bytes/dev)  = {fmt_si(t.ici_wire_bytes_dev, 'B')}   "
        f"-> ici     {_fmt_s(t.ici_s)}",
        f"  C   (dcn bytes/dev)  = {fmt_si(t.dcn_wire_bytes_dev, 'B')}   "
        f"-> dcn     {_fmt_s(t.dcn_s)}",
        f"  bound: {t.bound_class()}  t_lower={_fmt_s(t.t_lower)}  "
        f"t_upper={_fmt_s(t.t_upper)}",
        f"  AI={t.arithmetic_intensity:.2f} F/B (ridge "
        f"{t.ridge_intensity:.1f})",
    ]
    if t.useful_ratio is not None:
        lines.append(
            f"  model_flops/counted_flops = {t.useful_ratio:.3f}"
            f"   roofline fraction = {t.roofline_fraction * 100:.2f}%")
    lines.extend(f"  {e}" for e in extra)
    return "\n".join(lines)


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
