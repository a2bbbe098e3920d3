"""The 40-cell (arch x shape) roofline table from the port's dry run: the
torch leg of the JAX package's ``benchmarks/bench_arch_roofline.py``.

    PYTHONPATH=src python -m repro_torch.launch.arch_roofline

Reads ``results/dryrun_torch/*.json`` (``launch/dryrun.py``) and prints,
per mesh, the three terms, the dominant bound, the intensity, the
useful ratio (MODEL_FLOPS over the walk's FLOPs), the roofline fraction
and a what-would-move-it note; a ``not_ported`` cell is shown as such
with the ROADMAP item of its reason.  The tables are also written to
``results/roofline_table_torch_<mesh>.md``.  Every number is analytic:
a walk priced on the H100's roofs, nothing timed.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..configs import ALL_ARCHS
from ..models.common import SHAPES
from . import reanalyze


def load_cell(arch: str, shape: str, mesh: str) -> Optional[Dict]:
    path = os.path.join(reanalyze.RESULTS_DIR,
                        f"{arch}__{shape}__{mesh}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _fmt_ms(s: Optional[float]) -> str:
    if s is None:
        return "-"
    if s >= 1.0:
        return f"{s:.2f}s"
    return f"{s * 1e3:.1f}ms"


def bottleneck_note(d: Dict) -> str:
    """The reference's note, with the card's words for its compute
    units."""
    dom = d.get("dominant")
    scopes = d.get("scopes", {})
    attn_b = scopes.get("fused_attention", {}).get("bytes", 0.0)
    if dom == "memory" and attn_b > 0.4 * d.get("hbm_bytes_dev", 1):
        return "attn scores dominate Q -> flash-attention kernel"
    if dom == "memory":
        return "activation/remat traffic -> fuse + recompute policy"
    if dom == "ici":
        return "TP/EP collectives -> reshard or overlap (collective matmul)"
    if dom == "dcn":
        return "cross-pod grads -> compress (bf16) / overlap with bwd"
    return "compute-bound -> raise tensor-core occupancy (larger tiles)"


def table(mesh: str = "pod") -> List[str]:
    header = ("| arch | shape | compute | memory | ici | dcn | bound "
              "| AI | useful | roofline% | bottleneck note |")
    sep = "|" + "---|" * 11
    lines = [header, sep]
    for arch in ALL_ARCHS:
        for shape in SHAPES:
            d = load_cell(arch, shape, mesh)
            if d is None:
                continue
            status = d.get("status")
            if status in ("skipped", "not_ported"):
                lines.append(
                    f"| {arch} | {shape} | - | - | - | - | {status} | - | - "
                    f"| - | {d.get('reason', '')} |")
                continue
            if status != "ok":
                lines.append(
                    f"| {arch} | {shape} | - | - | - | - | ERROR | - | - "
                    f"| - | {d.get('error', '')[:60]} |")
                continue
            ur = d.get("useful_ratio")
            rf = d.get("roofline_fraction")
            lines.append(
                "| {a} | {s} | {c} | {m} | {i} | {d} | {b} | {ai:.1f} "
                "| {ur} | {rf} | {note} |".format(
                    a=arch, s=shape,
                    c=_fmt_ms(d.get("compute_s")),
                    m=_fmt_ms(d.get("memory_s")),
                    i=_fmt_ms(d.get("ici_s")),
                    d=_fmt_ms(d.get("dcn_s")),
                    b=d.get("dominant"),
                    ai=d.get("arithmetic_intensity", 0.0),
                    ur=f"{ur:.2f}" if ur else "-",
                    rf=f"{rf * 100:.2f}%" if rf else "-",
                    note=bottleneck_note(d)))
    return lines


def main() -> None:
    count_ok = 0
    for mesh in ("pod", "multipod"):
        lines = table(mesh)
        print(f"\n### Roofline table (port, analytic on the H100) — "
              f"{mesh} mesh\n")
        print("\n".join(lines))
        out = os.path.dirname(reanalyze.RESULTS_DIR)
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"roofline_table_torch_{mesh}.md"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
        count_ok += sum(all(f"| {s} |" not in row
                            for s in ("skipped", "not_ported", "ERROR"))
                        for row in lines[2:])
    print(f"arch_roofline.cells,0.0,rows_emitted={count_ok}")


if __name__ == "__main__":
    main()
