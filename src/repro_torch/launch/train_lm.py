"""End-to-end training driver: a ~100M-param LM for a few hundred steps
with checkpointing, resume, straggler watch and a cosine schedule (the
JAX package's ``examples/train_lm.py`` on the port).

The default run is small (qwen3-0.6b smoke, 40 steps); ``--full`` trains
the ~100M-parameter ``qwen3-100m`` config (12 layers, d_model 640,
float32, 300 steps, batch 8 x 512):

    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_lm --full   # card

Checkpoints go to ``results/ckpt/<config>`` under the working directory;
a second run resumes from the latest.  Runs on the card by default
(``--device cuda``).
"""

from __future__ import annotations

import argparse
import dataclasses

from ..configs import get_config, smoke
from ..device import resolve_device
from ..models.common import ModelConfig
from ..train import (CheckpointManager, LoopConfig, OptConfig,
                     SyntheticLMData, TrainConfig, TrainLoop,
                     make_initial_state)


def hundred_m_config() -> ModelConfig:
    """~100M-param llama-like config (qwen3 family, scaled)."""
    base = get_config("qwen3-0.6b")
    return dataclasses.replace(
        base, name="qwen3-100m", n_layers=12, d_model=640, n_heads=10,
        n_kv_heads=2, head_dim=64, d_ff=1792, vocab_size=32768,
        dtype="float32", remat="none", max_seq_len=2048)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.full:
        cfg = hundred_m_config()
        steps = args.steps or 300
        batch, seq = 8, 512
    else:
        cfg = smoke(get_config("qwen3-0.6b"))
        steps = args.steps or 40
        batch, seq = 4, 64

    loop_cfg = LoopConfig(
        total_steps=steps, ckpt_every=max(steps // 4, 10),
        log_every=max(steps // 20, 1),
        train=TrainConfig(opt=OptConfig(
            lr=6e-4, warmup_steps=max(steps // 10, 5), total_steps=steps)))
    data = SyntheticLMData(cfg, batch, seq, device=dev)
    loop = TrainLoop(cfg, loop_cfg, data,
                     CheckpointManager(f"results/ckpt/{cfg.name}", keep=2),
                     make_initial_state(cfg, device=dev))
    out = loop.run()
    print(f"finished at step {out['step']} on {dev}")
    first, last = loop.history[0], loop.history[-1]
    print(f"loss: {first['loss']:.4f} (step {first['step']}) -> "
          f"{last['loss']:.4f} (step {last['step']})")
    if not last["loss"] < first["loss"]:
        raise SystemExit("training did not reduce loss")
    return loop


if __name__ == "__main__":
    main()
