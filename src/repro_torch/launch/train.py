"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 50 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --device cpu --steps 20 --batch 4 --seq 64

Pre-flight: the train step is walked op by op on fake tensors of the
run's shapes (``core/analysis.py::analyze_step``: the forward, the
backward the autograd engine runs, a checkpointed layer's recompute and
the optimizer's update) and its roofline report printed *before* the
first batch: the predicted bound and the per-scope breakdown, priced on
the data sheet (``--chip sheet``) or on the card's measured roofs
(``--chip measured``: core/roofline/microbench.py).  Then ``TrainLoop``
runs (resume from the latest checkpoint under ``--ckpt-dir``, async
checkpoints every ``--ckpt-every`` steps) and the loss history and any
straggler events are printed.

Runs on the card by default (``--device cuda``); ``--device cpu`` runs
the plain PyTorch path (use ``--smoke`` there).  ``--layers`` cuts depth
only (a dense-FFN prologue stays).  One device: ``--data`` more than 1
(data-parallel training) is ROADMAP queue 1 item 19.
"""

from __future__ import annotations

import argparse
import dataclasses

from ..configs import ALL_ARCHS, get_config, smoke
from ..core.analysis import analyze_step
from ..core.roofline import microbench
from ..core.roofline.hardware import H100_SXM
from ..device import resolve_device
from ..launch import specs as specs_mod
from ..models.common import ShapeCell, model_flops
from ..parallel.mesh import single_device_mesh
from ..train import (CheckpointManager, LoopConfig, OptConfig,
                     SyntheticLMData, TrainConfig, TrainLoop,
                     make_initial_state, make_train_step)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ALL_ARCHS), default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0 = all)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel ways (one device: 1)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chip", choices=["sheet", "measured"], default="sheet",
                    help="price the pre-flight on the data sheet (H100 SXM) "
                         "or on the card's measured roofs (microbench)")
    return ap


def main(argv=None) -> dict:
    """Run the CLI on ``argv``; returns {"report": the pre-flight
    AnalysisReport, "loop": the TrainLoop (its history and watchdog),
    "out": TrainLoop.run's result (the final state and step)}."""
    args = _parser().parse_args(argv)
    if args.data > 1:
        raise NotImplementedError(
            f"--data {args.data}: data-parallel training over "
            "torch.distributed is ROADMAP queue 1 item 19")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    schedule = "wsd" if args.arch == "minicpm-2b" else "cosine"
    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                      total_steps=args.steps, schedule=schedule),
        grad_accum=args.grad_accum)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                          log_every=max(args.steps // 20, 1), train=tcfg)
    step = make_train_step(cfg, tcfg)

    # -- pre-flight roofline (the paper's feature) ---------------------
    mesh = single_device_mesh()
    chip = (microbench.run_microbench(device=dev).to_chipspec()
            if args.chip == "measured" else H100_SXM)
    cell = ShapeCell("preflight", args.seq, args.batch, "train")
    spec_args, _, _ = specs_mod.train_specs(cfg, cell, mesh)
    report = analyze_step(
        step, args=spec_args, mesh=mesh,
        label=f"{cfg.name} train preflight", chip=chip, dtype=cfg.dtype,
        model_flops=model_flops(cfg, args.seq, args.batch, "train"))
    print(report.render(), flush=True)

    data = SyntheticLMData(cfg, args.batch, args.seq, device=dev)
    loop = TrainLoop(
        cfg, loop_cfg, data,
        CheckpointManager(f"{args.ckpt_dir}/{cfg.name}", keep=2),
        make_initial_state(cfg, device=dev), step_fn=step)
    out = loop.run()
    print(f"[train] finished at step {out['step']} on {dev}; history:")
    for h in loop.history[-10:]:
        print(f"  step {h['step']:>5}  loss {h['loss']:.4f}  "
              f"dt {h['dt'] * 1e3:.0f}ms")
    if loop.watchdog.events:
        print(f"[train] straggler events: {len(loop.watchdog.events)}")
    return {"report": report, "loop": loop, "out": out}


if __name__ == "__main__":
    main()
