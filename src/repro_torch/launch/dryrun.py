"""The production-mesh dry run: walk one rank of every (arch x shape) cell
on the reference's meshes and record its roofline, the JAX package's
``launch/dryrun.py`` for the port.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Where the reference lowers and compiles each cell on 256 or 512 forced
host devices and reads the partitioned HLO, the port walks one rank
(rank 0) of a fake process group of the whole mesh
(``launch/mesh.py::make_production_mesh``) on fake CPU tensors
(``launch/specs.py``): the rank's real train step, prefill or decode
step (over its block of the dense cache) runs every aten op and every
collective on shapes without storage, so nothing is
allocated or computed, and the op walk (``core/analysis.py::
analyze_step``) records W, Q and the collectives by axis.  Each cell is
priced on the H100 (``--chip sheet``: ``H100_SXM``; ``--chip
measured``: the card's microbenchmark roofs from its cache, read on any
host and never the CPU's, ``launch/reanalyze.py::chip_spec``) and
written with the reference's keys (``walk_seconds`` in place of
``compile_seconds``) to ``results/dryrun_torch/<arch>__<shape>__<mesh>
[__<variant>].json``, its walk's record beside it as ``.ops.json.gz`` so
that ``launch/reanalyze.py`` re-prices it without building a model.

A cell's status is the reference's ``ok`` / ``skipped`` (``long_500k``
on quadratic attention) / ``error`` (a failing cell is a bug, recorded
with its traceback), plus ``not_ported`` for a cell whose path the port
still lacks, its reason naming the ROADMAP item: the recurrent archs
(item 21).  The summary counts each; the exit code is 1 only on an
error.  A train cell's walked ``model`` bytes are held against
``train.step.tp_wire_bytes``, a decode cell's against
``decode_wire_bytes`` (``tp_wire_model_bytes`` in its result).
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import ALL_ARCHS, get_config
from ..core.analysis import analyze_step
from ..core.roofline.hardware import H100_SXM, ChipSpec
from ..core.roofline.op_cost import records_to_json
from ..models import decode_step, prefill
from ..models.common import SHAPES, ModelConfig
from ..models.transformer import has_recurrent
from ..parallel.mesh import use_mesh
from ..train.step import (TrainConfig, decode_local_config,
                          decode_wire_bytes, make_train_step, tp_wire_bytes,
                          train_local_config)
from . import specs as specs_mod
from .mesh import make_production_mesh, mesh_name
from . import reanalyze
from .reanalyze import archive_path, chip_spec

STATUSES = ("ok", "skipped", "not_ported", "error")


def _apply_variant(cfg: ModelConfig, tcfg: TrainConfig, variant: str
                   ) -> Tuple[ModelConfig, TrainConfig]:
    """The reference's named perf levers, '+'-joined, on top of the
    baseline config and train config."""
    for piece in variant.split("+"):
        if piece in ("", "baseline"):
            continue
        elif piece == "absorb":
            cfg = dataclasses.replace(cfg, mla_absorb=True)
        elif piece == "tp_oproj":
            cfg = dataclasses.replace(cfg, tp_attn_inner=True)
        elif piece == "remat_dots":
            cfg = dataclasses.replace(cfg, remat="dots")
        elif piece == "remat_none":
            cfg = dataclasses.replace(cfg, remat="none")
        elif piece == "compress":
            tcfg = dataclasses.replace(tcfg, compress_pod_grads=True)
        elif piece.startswith("chunk"):
            cfg = dataclasses.replace(cfg, attn_chunk=int(piece[len("chunk"):]))
        elif piece == "localmoe":
            cfg = dataclasses.replace(cfg, moe_dispatch="local")
        elif piece.startswith("cf"):
            cfg = dataclasses.replace(cfg, capacity_factor=float(piece[2:]))
        else:
            raise ValueError(f"unknown variant piece {piece!r}")
    return cfg, tcfg


def result_path(arch: str, shape: str, mesh_label: str,
                variant: str = "baseline") -> str:
    os.makedirs(reanalyze.RESULTS_DIR, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant}"
    return os.path.join(reanalyze.RESULTS_DIR,
                        f"{arch}__{shape}__{mesh_label}{suffix}.json")


def not_run_reason(cfg: ModelConfig, shape: str
                   ) -> Optional[Tuple[str, str]]:
    """(status, reason) of a cell that is not walked, None for one that
    is: recurrent mixers (ROADMAP item 21), ``long_500k`` on quadratic
    attention (the reference's skip)."""
    if has_recurrent(cfg):
        return ("not_ported", "recurrent mixers have no tensor-parallel "
                "edges in training, prefill or decode at model > 1: "
                "ROADMAP queue 1 item 21")
    if shape == "long_500k" and not cfg.subquadratic:
        return ("skipped", "quadratic full attention; see DESIGN.md §5")
    return None


def _walk(cfg: ModelConfig, tcfg: TrainConfig, shape: str, mesh, *,
          label: str, chip: ChipSpec):
    """The analysis report of rank ``mesh.rank``'s step of one cell, and
    the ``model`` wire bytes ``tp_wire_bytes`` (a train step) or
    ``decode_wire_bytes`` (a decode step) predicts (None for prefill)."""
    cell = SHAPES[shape]
    flops = specs_mod.cell_flops(cfg, cell)
    if cell.kind == "train":
        args, _, _ = specs_mod.train_specs(cfg, cell, mesh)
        fn = make_train_step(cfg, tcfg, mesh)
        wire = tp_wire_bytes(cfg, mesh.sizes, cell.global_batch,
                             cell.seq_len, tcfg)["model"]
    elif cell.kind == "decode":
        args, _, _ = specs_mod.decode_specs(cfg, cell, mesh)
        local = decode_local_config(cfg, mesh)

        def fn(params, caches, token, pos):
            with use_mesh(mesh, process_wide=True), torch.no_grad():
                return decode_step(params, local, caches, token, pos)
        wire = decode_wire_bytes(cfg, mesh.sizes, cell.global_batch,
                                 cell.seq_len)["model"]
    else:
        args, _, _ = specs_mod.prefill_specs(cfg, cell, mesh)
        local = train_local_config(cfg, mesh)
        src = ("enc_embeds" if cfg.is_encoder_decoder else
               "img_embeds" if cfg.n_image_tokens else None)

        def fn(params, tokens, *source):
            kw = {src: source[0]} if source else {}
            with use_mesh(mesh, process_wide=True), torch.no_grad():
                return prefill(params, local, tokens, cache_blocks=True,
                               **kw)
        wire = None
    report = analyze_step(fn, args=args, mesh=mesh, label=label, chip=chip,
                          dtype=cfg.dtype, model_flops=flops)
    return report, wire


def run_cell(arch: str, shape: str, mesh, *, verbose: bool = True,
             force: bool = False, variant: str = "baseline",
             chip: ChipSpec = H100_SXM) -> Dict[str, Any]:
    """Walk one cell on ``mesh`` (a rank of ``make_production_mesh``),
    priced on ``chip``, and return its result dict, also written to its
    JSON (a cached one is returned as it is unless ``force``)."""
    label = f"{arch}/{shape}/{mesh_name(mesh)}/{variant}"
    path = result_path(arch, shape, mesh_name(mesh), variant)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    reason = not_run_reason(cfg, shape)
    if reason is not None:
        result = {"label": label, "status": reason[0], "reason": reason[1],
                  "arch": arch, "shape": shape, "variant": variant}
        if verbose:
            print(f"[dryrun] {label}: {reason[0].upper()} ({reason[1]})")
    else:
        t0 = time.time()
        try:
            vcfg, tcfg = _apply_variant(cfg, TrainConfig(), variant)
            report, wire = _walk(vcfg, tcfg, shape, mesh, label=label,
                                 chip=chip)
            with gzip.open(archive_path(path), "wt") as zf:
                json.dump({**report.record,
                           "ops": records_to_json(report.record["ops"])},
                          zf, separators=(",", ":"))
            result = report.as_dict()
            result.update(status="ok", arch=arch, shape=shape,
                          variant=variant, chip=chip.name,
                          rank=mesh.rank)
            if wire is not None:
                result["tp_wire_model_bytes"] = wire
            if verbose:
                print(f"[dryrun] {label}: walked in "
                      f"{report.walk_seconds:.1f}s")
                print(report.render())
                sys.stdout.flush()
        except Exception as e:  # a failing cell is a bug: record it loudly
            result = {"label": label, "status": "error", "arch": arch,
                      "shape": shape, "variant": variant,
                      "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()[-4000:],
                      "seconds": time.time() - t0}
            if verbose:
                print(f"[dryrun] {label}: FAILED — {type(e).__name__}: {e}")
                sys.stdout.flush()
    with open(path, "w") as f:
        json.dump(result, f, indent=2, default=float)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ALL_ARCHS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="walk again even if a cached result exists")
    ap.add_argument("--variant", default="baseline",
                    help="'+'-joined perf levers, e.g. tp_oproj+remat_dots")
    ap.add_argument("--chip", choices=["sheet", "measured"],
                    default="sheet",
                    help="price on the H100's data sheet or on the "
                         "card's measured roofs (the microbench cache)")
    args = ap.parse_args(argv)
    chip = chip_spec(args.chip)    # "measured" with no card's cache raises
    archs = list(ALL_ARCHS) if (args.all or args.arch is None) \
        else [args.arch]
    shapes = [args.shape] if args.shape else list(SHAPES)
    multi = {"pod": [False], "multipod": [True],
             "both": [False, True]}[args.mesh]
    counts = dict.fromkeys(STATUSES, 0)
    t0 = time.time()
    for multi_pod in multi:
        with make_production_mesh(multi_pod=multi_pod) as mesh:
            for arch in archs:
                for shape in shapes:
                    res = run_cell(arch, shape, mesh, force=args.force,
                                   variant=args.variant, chip=chip)
                    counts[res.get("status", "error")] += 1
    print("[dryrun] " + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f" in {time.time() - t0:.1f}s")
    if counts["error"]:
        print(f"[dryrun] {counts['error']} cell(s) FAILED")
        return 1
    print("[dryrun] all requested cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
