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
only (a dense-FFN prologue stays).

Data parallel: ``--data N`` starts N ranks (``parallel.mesh.spawn``) on
a ``(data N, model 1)`` mesh, each training on its rows of the global
``--batch`` with the data-parallel step (train/step.py: the gradient
reduce, ZeRO-1 moments, the global MoE dispatch and aux); ``--data 0``
(the default, the reference's) takes every visible card, one on the
CPU.  The backend is NCCL when each rank has a card of its own, gloo on
the CPU or when ranks share a card (``--data 2`` on one card: two gloo
ranks on it), printed before the ranks start.  Each rank walks its own
step for the pre-flight, whose report then carries the step's
collectives by mesh axis; rank 0 prints it and the history.  The
reference's CLI has no ``model`` option, and neither has this one: the
tensor-parallel step (a ``model`` axis beside ``data`` and ``pod``) is
reached through ``train.make_train_step(..., mesh=)`` directly.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs import ALL_ARCHS, get_config, smoke
from ..core.analysis import analyze_step
from ..core.roofline import microbench
from ..core.roofline.hardware import H100_SXM
from ..device import resolve_device
from ..launch import specs as specs_mod
from ..models.common import ShapeCell, model_flops
from ..models.params import tree_paths
from ..parallel.mesh import (batch_shard, batch_shards, dp_backend,
                             make_host_mesh, single_device_mesh, spawn)
from ..train import (CheckpointManager, LoopConfig, OptConfig,
                     SyntheticLMData, TrainConfig, TrainLoop,
                     make_initial_state, make_train_step)
from ..train.loop import state_shards


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
    ap.add_argument("--data", type=int, default=0,
                    help="data-parallel ranks (0 = every visible card; "
                         "1 on the CPU)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chip", choices=["sheet", "measured"], default="sheet",
                    help="price the pre-flight on the data sheet (H100 SXM) "
                         "or on the card's measured roofs (microbench)")
    return ap


def main(argv=None) -> dict:
    """Run the CLI on ``argv``.  On one device returns {"report": the
    pre-flight AnalysisReport, "loop": the TrainLoop (its history and
    watchdog), "out": TrainLoop.run's result (the final state and
    step)}; with more ranks, rank 0's :func:`_rank_main` summary."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    n = args.data or (torch.cuda.device_count() if dev.type == "cuda"
                      else 1)
    if n > 1:
        backend = dp_backend(dev.type, n)
        print(f"[train] data {n}: {n} ranks over {backend} on "
              f"{dev.type}", flush=True)
        threads = (max(torch.get_num_threads() // n, 1)
                   if dev.type == "cpu" else None)
        return spawn(_rank_main, n, device=dev.type, backend=backend,
                     args=(list(argv) if argv is not None else None,),
                     threads=threads)
    return _run(args, dev, None)


def _rank_main(rank: int, world: int, argv) -> dict:
    """One rank of ``--data`` > 1: {"history" (rank 0's), "step",
    "preempted", "stragglers", "collectives" (the pre-flight's wire bytes
    by axis), "backend", and every rank's "moment_bytes" and
    "peak_bytes" (the card's peak allocation; None on the CPU)}."""
    import torch.distributed as dist
    args = _parser().parse_args(argv)
    cuda = args.device != "cpu"
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    res = _run(args, dev, make_host_mesh(world))
    opt = res["out"]["state"]["opt"]
    mine = (sum(t.numel() * t.element_size() for k in ("mu", "nu")
                for _, t in tree_paths(opt[k])),
            torch.cuda.max_memory_allocated() if cuda else None)
    every = [None] * world
    dist.all_gather_object(every, mine)
    print(f"[train] rank {rank}: moments {mine[0] / 1e9:.3f} GB"
          + (f", peak {mine[1] / 1e9:.2f} GB" if cuda else ""), flush=True)
    return {"history": res["loop"].history, "step": res["out"]["step"],
            "preempted": res["out"]["preempted"],
            "stragglers": len(res["loop"].watchdog.events),
            "collectives": {"+".join(k): v for k, v in
                            res["report"].character.collectives
                            .by_axes.items()},
            "backend": dist.get_backend(),
            "moment_bytes": [m for m, _ in every],
            "peak_bytes": [p for _, p in every]}


def _run(args, dev: torch.device, mesh) -> dict:
    lead = mesh is None or mesh.rank == 0
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
    step = make_train_step(cfg, tcfg, mesh)

    # -- pre-flight roofline (the paper's feature) ---------------------
    walk_mesh = mesh if mesh is not None else single_device_mesh()
    chip = (microbench.run_microbench(device=dev).to_chipspec()
            if args.chip == "measured" else H100_SXM)
    cell = ShapeCell("preflight", args.seq, args.batch, "train")
    spec_args, _, _ = specs_mod.train_specs(cfg, cell, walk_mesh)
    report = analyze_step(
        step, args=spec_args, mesh=walk_mesh,
        label=f"{cfg.name} train preflight", chip=chip, dtype=cfg.dtype,
        model_flops=model_flops(cfg, args.seq, args.batch, "train"))
    if lead:
        print(report.render(), flush=True)

    shards = batch_shards(walk_mesh)
    data = SyntheticLMData(cfg, args.batch, args.seq, device=dev,
                           shard=batch_shard(walk_mesh), shards=shards,
                           micro=args.grad_accum)
    loop = TrainLoop(
        cfg, loop_cfg, data,
        CheckpointManager(f"{args.ckpt_dir}/{cfg.name}", keep=2, mesh=mesh,
                          shards=state_shards(cfg, mesh)),
        make_initial_state(cfg, device=dev, mesh=mesh), step_fn=step,
        mesh=mesh)
    out = loop.run()
    if lead:
        where = f"{dev}" if mesh is None else f"{shards} ranks ({dev.type})"
        print(f"[train] finished at step {out['step']} on {where}; "
              "history:")
        for h in loop.history[-10:]:
            print(f"  step {h['step']:>5}  loss {h['loss']:.4f}  "
                  f"dt {h['dt'] * 1e3:.0f}ms")
    if loop.watchdog.events:
        print(f"[train] straggler events: {len(loop.watchdog.events)}"
              + ("" if mesh is None else f" (rank {mesh.rank})"))
    return {"report": report, "loop": loop, "out": out}


if __name__ == "__main__":
    main()
