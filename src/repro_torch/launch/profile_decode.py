"""Where a decode step's time goes on the card: a torch.profiler window
over steady-state engine steps.

    python -m repro_torch.launch.profile_decode [--steps 8]
    python -m repro_torch.launch.profile_decode --arch deepseek-v2-236b \
        --layers 4
    python -m repro_torch.launch.profile_decode --arch xlstm-350m
    python -m repro_torch.launch.profile_decode --arch jamba-v0.1-52b \
        --layers 8
    python -m repro_torch.launch.profile_decode --arch qwen3-14b \
        --spec draft --draft-arch qwen3-0.6b --spec-k 4
    python -m repro_torch.launch.profile_decode --pipeline double
    python -m repro_torch.launch.profile_decode --kv-dtype int8
    python -m repro_torch.launch.profile_decode --graph off
    python -m repro_torch.launch.profile_decode --no-kernel --graph off

Builds a full-width model (qwen3-0.6b by default; ``--layers`` cuts
depth only) with random weights, seeded, fills all slots with decoding
requests, then profiles ``--steps`` engine steps that only decode.
With ``--spec ngram|draft`` the engine is the speculative one and a step
is a round of propose (the draft model's passes, with ``draft``) and one
verify pass; the draft/verify split of the window's wall time is printed
too.  ``--pipeline double`` runs the paged-attention ring kernels;
``--kv-dtype int8|fp8_e4m3`` quantizes the KV pages (under either
pipeline).  ``--graph on`` (the default) replays the captured step graphs
(serve/graphs.py), ``--graph off`` runs the steps eagerly.
``--no-kernel`` profiles the config's no-kernel twin instead
(``serve.engine.no_kernel_cfg``: every width floored, the same op
graph), the paper's dispatch-floor run.
Prints the window's wall time, the device kernels in it and the host's
launch calls (``cudaLaunchKernel`` and ``cudaGraphLaunch``), the summed
device time of every kernel (the device busy share is its ratio to the
wall), the kernels with the most device time and the host ops with the
most self time, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..device import resolve_device
from ..models import init_params
from ..obs.clock import now
from ..serve import (Engine, EngineConfig, GenerateConfig, SpecConfig,
                     SpecEngine)
from ..serve.engine import no_kernel_cfg


# the host calls that put work on the card: one kernel each, or one graph
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0 = all)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--spec", choices=["off", "ngram", "draft"],
                    default="off")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--draft-arch", default="qwen3-0.6b")
    ap.add_argument("--pipeline", choices=["off", "double"], default="off")
    ap.add_argument("--kv-dtype", choices=["bf16", "int8", "fp8_e4m3"],
                    default=None)
    ap.add_argument("--graph", choices=["on", "off"], default="on",
                    help="replay captured CUDA graphs of the steps (on) or "
                    "run them eagerly (off)")
    ap.add_argument("--no-kernel", action="store_true",
                    help="profile the no-kernel twin of the config")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.no_kernel:
        cfg = no_kernel_cfg(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    # a speculative round commits up to k+1 tokens
    new_tokens = (args.steps + 16) * (args.spec_k + 1 if args.spec != "off"
                                      else 1)
    ecfg = EngineConfig(num_slots=args.slots,
                        max_len=args.prompt_len + new_tokens,
                        pipeline=args.pipeline, kv_dtype=args.kv_dtype,
                        cuda_graphs=args.graph == "on", device=dev)
    if args.spec == "off":
        engine = Engine(cfg, params, ecfg)
    else:
        dcfg = get_config(args.draft_arch) if args.spec == "draft" else None
        dparams = None if dcfg is None else init_params(
            dcfg, torch.Generator(device=dev).manual_seed(0), dev)
        engine = SpecEngine(cfg, params, ecfg, SpecConfig(
            k=args.spec_k, proposer=args.spec, draft_cfg=dcfg,
            draft_params=dparams))
    rng = np.random.default_rng(0)
    gen = GenerateConfig(max_new_tokens=new_tokens)
    for _ in range(args.slots):
        engine.submit(rng.integers(0, cfg.vocab_size, args.prompt_len), gen)
    for _ in range(4):              # admit, prefill, warm decode, capture
        engine.step()
    if len(engine._sched.decode_requests()) != args.slots:
        raise RuntimeError("slots did not fill before the profiled window")
    torch.cuda.synchronize(dev)
    walls = {ph: engine.phases[ph].wall_s for ph in ("verify", "draft")}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = now()
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize(dev)
        wall = now() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    host_launches = sum(e.name in HOST_LAUNCHES for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CPU)
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    print(card)
    print(f"[profile] {cfg.name} (pipeline {args.pipeline}, kv_dtype "
          f"{engine.cfg.kv_dtype}, graph {args.graph}), {args.slots} "
          f"slots decoding, context "
          f"~{args.prompt_len}: {args.steps} steps in {wall * 1e3:.3f} ms "
          f"({wall / args.steps * 1e3:.3f} ms/step); {len(kernels)} kernel "
          f"launches ({len(kernels) / args.steps:.0f}/step) from "
          f"{host_launches} host launch calls "
          f"({host_launches / args.steps:.0f}/step); device busy "
          f"{busy_us / 1e3:.3f} ms = {busy_us / 1e6 / wall:.1%} of the "
          f"window")
    if args.spec != "off":
        split = {ph: (engine.phases[ph].wall_s - w) / args.steps * 1e3
                 for ph, w in walls.items()}
        print(f"[profile] speculative ({args.spec}, k {args.spec_k}): "
              f"verify {split['verify']:.3f} ms/step, propose "
              f"{split['draft']:.3f} ms/step of the window (synchronized "
              "walls)")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :args.top]:
        print(f"[profile] {t / 1e3:9.3f} ms {t / busy_us:6.1%} "
              f"{n / args.steps:6.1f}/step  {name[:90]}")
    host = sorted((e for e in prof.key_averages()
                   if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:args.top]
    for e in host:
        print(f"[profile] host {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"{e.self_cpu_time_total / 1e6 / wall:6.1%} of the window "
              f"{e.count / args.steps:7.1f}/step  {e.key[:70]}")


if __name__ == "__main__":
    main()
