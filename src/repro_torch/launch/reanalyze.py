"""Re-price every archived dry-run cell without walking it again: the JAX
package's ``launch/reanalyze.py`` for the port (the paper's "better
counter, same measurements" workflow).

    PYTHONPATH=src python -m repro_torch.launch.reanalyze [--chip measured]

Each ``ok`` cell of ``results/dryrun_torch/`` has its walk's record
beside it (``<cell>.ops.json.gz``, ``launch/dryrun.py``); this prices the
record again with the current rules (``core/roofline/op_cost.py::
price``, the collectives' ring model) on the cell's mesh scope and the
chosen chip, and updates the cell's JSON.  No model is built or
imported: the record is all it reads.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
from typing import Optional

from ..core.analysis import analyze_records
from ..core.roofline.hardware import H100_SXM, ChipSpec
from ..core.roofline.op_cost import records_from_json

# the dry run's cells, and beside them the tables built from them:
# dryrun, arch_roofline and perf_table read this one name at call time
RESULTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch"))


def chip_spec(chip: str) -> ChipSpec:
    """``sheet``: the H100's data sheet; ``measured``: the card's
    microbenchmark roofs (``microbench.card_measurement`` of
    ``results/microbench_torch.json``), read on any host:
    the walk runs on the CPU, the price is the card's.  With no
    measurement of a card this raises: the CPU is never measured in its
    place."""
    if chip == "sheet":
        return H100_SXM
    if chip != "measured":
        raise ValueError(f"chip {chip!r} not in ('sheet', 'measured')")
    from ..core.roofline import microbench
    return microbench.card_measurement(microbench.DEFAULT_CACHE
                                       ).to_chipspec()


def archive_path(json_path: str) -> str:
    """The walk's record beside a cell's JSON."""
    return json_path[:-len(".json")] + ".ops.json.gz"


def load_record(json_path: str) -> Optional[dict]:
    """The walk's record archived beside ``json_path``, its ops decoded
    (None when there is none)."""
    path = archive_path(json_path)
    if not os.path.exists(path):
        return None
    with gzip.open(path, "rt") as zf:
        record = json.load(zf)
    record["ops"] = records_from_json(record["ops"])
    return record


def reprice(json_path: str, chip: ChipSpec) -> Optional[dict]:
    """One cell's JSON with its archived walk priced again on ``chip``
    (the file is left as it is); None for a cell that is not ``ok`` or
    has no archive."""
    with open(json_path) as f:
        d = json.load(f)
    if d.get("status") != "ok":
        return None
    record = load_record(json_path)
    if record is None:
        return None
    report = analyze_records(
        record, d["mesh_shape"], label=d["label"], chip=chip,
        dtype=d.get("dtype", "bfloat16"),
        model_flops=d.get("model_flops_total"),
        walk_seconds=d.get("walk_seconds", 0.0))
    d.update(report.as_dict())
    return d


def reanalyze_cell(json_path: str, chip: ChipSpec) -> bool:
    """Re-price one cell on ``chip`` and rewrite its JSON; False for a
    cell that is not ``ok`` or has no archive."""
    d = reprice(json_path, chip)
    if d is None:
        return False
    d["chip"] = chip.name
    with open(json_path, "w") as f:
        json.dump(d, f, indent=2, default=float)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chip", choices=["sheet", "measured"],
                    default="sheet")
    args = ap.parse_args(argv)
    chip = chip_spec(args.chip)
    n = 0
    for path in sorted(glob.glob(os.path.join(RESULTS_DIR, "*.json"))):
        if reanalyze_cell(path, chip):
            n += 1
            print(f"[reanalyze] {os.path.basename(path)}")
    print(f"[reanalyze] updated {n} cells on {chip.name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
