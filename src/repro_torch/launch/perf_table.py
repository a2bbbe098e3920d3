"""The perf-lever comparison table from the port's dry run: the torch leg
of the JAX package's ``benchmarks/perf_table.py`` (baseline vs variants
vs the flash-attention substitution, for its chosen cells).

    PYTHONPATH=src python -m repro_torch.launch.perf_table
    PYTHONPATH=src python -m repro_torch.launch.perf_table --metrics-diff BASE.prom CUR.prom

Reads ``results/dryrun_torch/*.json`` (``launch/dryrun.py --variant
...``); a train cell gets a second row with its ``fused_attention``
scope's bytes replaced by the flash kernel's (``core/roofline/
substitute.py::substitute_flash``, priced on the H100's data sheet).
Written to ``results/perf_table_torch.md``.  ``--metrics-diff`` diffs
two Prometheus snapshots of the serve telemetry (``launch/serve.py
--metrics-snapshot``) and warns, never fails, when a throughput gauge
fell more than 20%.  Every number is analytic: nothing is timed.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

from ..core.roofline.substitute import substitute_flash
from ..models.common import SHAPES
from . import reanalyze

# the reference's cells and variants
CELLS = [
    ("qwen3-14b", "train_4k", "pod",
     ["baseline", "tp_oproj", "remat_dots", "tp_oproj+remat_dots"]),
    ("kimi-k2-1t-a32b", "train_4k", "pod",
     ["baseline", "tp_oproj", "tp_oproj+remat_dots", "cf1.0", "localmoe",
      "localmoe+remat_dots"]),
    ("kimi-k2-1t-a32b", "train_4k", "multipod",
     ["baseline", "compress", "localmoe+compress"]),
    ("deepseek-v2-236b", "decode_32k", "pod",
     ["baseline", "absorb", "absorb+localmoe"]),
    ("deepseek-v2-236b", "train_4k", "pod", ["baseline", "localmoe"]),
]


def load(arch, shape, mesh, variant) -> Optional[Dict]:
    suffix = "" if variant == "baseline" else f"__{variant}"
    path = os.path.join(reanalyze.RESULTS_DIR,
                        f"{arch}__{shape}__{mesh}{suffix}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    return d if d.get("status") == "ok" else None


def fmt(d: Dict) -> List[str]:
    return [
        d.get("variant", "baseline"),
        f"{d['compute_s']:.2f}",
        f"{d['memory_s']:.2f}",
        f"{d['ici_s']:.2f}",
        f"{d['dcn_s']:.2f}",
        d["dominant"],
        f"{d['t_lower_s']:.2f}",
        f"{d['roofline_fraction'] * 100:.2f}%" if d.get("roofline_fraction")
        else "-",
    ]


HEADER = ["variant", "compute_s", "memory_s", "ici_s", "dcn_s", "dominant",
          "t_lower_s", "roofline%"]


def table() -> List[str]:
    out_lines: List[str] = []
    for arch, shape, mesh, variants in CELLS:
        rows = []
        for v in variants:
            d = load(arch, shape, mesh, v)
            if d:
                rows.append(fmt(d))
                # the flash kernel's substitution on top of each variant
                sub = substitute_flash(d, SHAPES[shape].seq_len)
                if sub is not None and shape.startswith("train"):
                    rows.append(fmt(sub))
        if not rows:
            continue
        out_lines.append(f"\n#### {arch} / {shape} / {mesh}\n")
        out_lines.append("| " + " | ".join(HEADER) + " |")
        out_lines.append("|" + "---|" * len(HEADER))
        for r in rows:
            out_lines.append("| " + " | ".join(r) + " |")
    return out_lines


def parse_prom(path: str) -> Dict[Tuple[str, str], float]:
    """Prometheus text exposition as {(name, labels): value}, the labels
    kept as their raw ``{...}`` string (or "")."""
    out: Dict[Tuple[str, str], float] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            head, _, val = line.rpartition(" ")
            if not head:
                continue
            if "{" in head:
                name, _, rest = head.partition("{")
                labels = "{" + rest
            else:
                name, labels = head, ""
            try:
                out[(name, labels)] = float(val)
            except ValueError:
                continue
    return out


def metrics_diff(baseline_path: str, current_path: str,
                 threshold: float = 0.20) -> List[str]:
    """WARN lines for every throughput gauge of ``current_path`` that fell
    more than ``threshold`` below ``baseline_path``'s."""
    base = parse_prom(baseline_path)
    cur = parse_prom(current_path)
    watched = ("serve_tokens_per_s", "serve_attained_flops_per_s")
    warnings = []
    for key, b in sorted(base.items()):
        name, labels = key
        if name not in watched or b <= 0:
            continue
        c = cur.get(key)
        if c is None:
            warnings.append(f"WARN {name}{labels}: present in baseline "
                            f"but missing from {current_path}")
            continue
        drop = (b - c) / b
        if drop > threshold:
            warnings.append(
                f"WARN {name}{labels}: {c:.3g} is {drop:.0%} below the "
                f"baseline {b:.3g} (threshold {threshold:.0%})")
    return warnings


def run_metrics_diff(baseline_path: str, current_path: str) -> None:
    warnings = metrics_diff(baseline_path, current_path)
    if warnings:
        print(f"[perf_table/metrics-diff] {baseline_path} -> "
              f"{current_path}:")
        for w in warnings:
            print("  " + w)
        print("  (warn-only: smoke throughput is noisy; investigate if "
              "this repeats across runs)")
    else:
        print(f"[perf_table/metrics-diff] {current_path} holds the line "
              f"vs {baseline_path}: no watched metric down >20%")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--metrics-diff", nargs=2,
                    metavar=("BASELINE.prom", "CURRENT.prom"), default=None,
                    help="diff two serve telemetry snapshots; warn (never "
                         "fail) on >20%% throughput regression")
    args = ap.parse_args(argv)
    if args.metrics_diff:
        run_metrics_diff(*args.metrics_diff)
        return
    text = "\n".join(table())
    print(text)
    out = os.path.dirname(reanalyze.RESULTS_DIR)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "perf_table_torch.md"), "w") as f:
        f.write(text + "\n")


if __name__ == "__main__":
    main()
