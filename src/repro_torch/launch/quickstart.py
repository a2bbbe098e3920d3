"""Quickstart: build a model, characterize its training step on the
roofline before running it (the paper's methodology as a library), train
a few steps, decode: the JAX package's ``examples/quickstart.py`` on the
port.

    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.launch.quickstart     # the card

qwen3-0.6b's smoke config (float32, CPU scale): the train step's op walk
on fake tensors (``core/analysis.py::analyze_step``, priced on the H100's
data sheet), 5 steps on ``SyntheticLMData``, then ``Engine.generate`` of
8 tokens for 2 prompts (on the card through the paged-attention kernel).
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

from ..configs import get_config, smoke
from ..core.analysis import analyze_step
from ..core.roofline.hardware import H100_SXM
from ..device import resolve_device
from ..launch import specs as specs_mod
from ..models.common import ShapeCell, model_flops
from ..models.params import tree_leaves
from ..parallel.mesh import single_device_mesh
from ..serve import Engine, EngineConfig, GenerateConfig
from ..train import (OptConfig, SyntheticLMData, TrainConfig,
                     make_initial_state, make_train_step)

B, S = 4, 64
TRAIN_STEPS = 5
PROMPTS, PROMPT_LEN, NEW = 2, 8, 8


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a reduced qwen3 (same family structure, CPU scale)
    cfg = smoke(get_config("qwen3-0.6b"))
    state = make_initial_state(cfg, 0, dev)()
    n = sum(t.numel() for t in tree_leaves(state["params"]))
    print(f"model: {cfg.name}, {n / 1e6:.2f}M params")

    # 2. roofline-characterize the train step BEFORE running it
    step = make_train_step(cfg, TrainConfig(opt=OptConfig(lr=1e-3)))
    mesh = single_device_mesh()
    spec_args, _, _ = specs_mod.train_specs(
        cfg, ShapeCell("quickstart", S, B, "train"), mesh)
    report = analyze_step(step, args=spec_args, mesh=mesh,
                          label="quickstart train step", chip=H100_SXM,
                          dtype=cfg.dtype,
                          model_flops=model_flops(cfg, S, B, "train"))
    print(report.render())

    # 3. train a few steps on synthetic data
    data = SyntheticLMData(cfg, B, S, device=dev)
    losses = []
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, data.batch_at(i))
        losses.append(float(metrics["loss"]))
        print(f"  step {i}: loss={losses[-1]:.4f} "
              f"lr={float(metrics['lr']):.2e}")

    # 4. decode with the serving engine
    engine = Engine(cfg, state["params"], EngineConfig(device=dev))
    prompts = torch.ones((PROMPTS, PROMPT_LEN), dtype=torch.int32)
    out = engine.generate(prompts, GenerateConfig(max_new_tokens=NEW))
    print("decoded:", out["tokens"][0, PROMPT_LEN:].tolist())
    return {"report": report, "losses": losses, "tokens": out["tokens"]}


if __name__ == "__main__":
    main()
