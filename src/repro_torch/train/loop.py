"""The training loop: resumable, failure-tolerant, straggler-aware: the
JAX package's ``train/loop.py`` in PyTorch.

* deterministic resume — state and data position restored, so a
  restarted job replays bitwise (on the card under deterministic
  algorithms: the embedding gather's, ``take_along_dim``'s and the MoE
  combine's backward add with atomics otherwise),
* bounded retry on step failure (transient-fault policy), emergency
  checkpoint on SIGTERM (preemption),
* straggler watchdog — per-step wall-time EMA / variance; outlier steps
  are recorded and handed to the (pluggable) mitigation hook,
* async checkpoint every N steps with keep-K retention.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import time
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from ..device import resolve_device, synchronize
from ..models import (abstract_params, drop_cast, init_params,
                      model_param_defs)
from ..models.common import ModelConfig
from .checkpoint import CheckpointManager
from .data import SyntheticLMData
from .optimizer import abstract_opt_state, init_opt_state
from .step import TrainConfig, make_train_step


@dataclasses.dataclass
class StragglerEvent:
    step: int
    dt: float
    mean: float
    threshold: float


class StragglerWatchdog:
    """EMA mean/variance of step time; flags dt > mean + k*std (and > min
    floor so warm-up jitter doesn't alarm)."""

    def __init__(self, k: float = 3.0, decay: float = 0.95,
                 warmup: int = 5, floor_s: float = 1e-4,
                 rel_floor: float = 1.5):
        self.k, self.decay, self.warmup, self.floor = k, decay, warmup, floor_s
        self.rel_floor = rel_floor       # never flag below mean * rel_floor
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.events: List[StragglerEvent] = []

    def update(self, step: int, dt: float) -> Optional[StragglerEvent]:
        self.n += 1
        if self.n <= self.warmup:
            if self.n == 1:
                self.mean = dt
            else:
                d = dt - self.mean
                self.mean += (1 - self.decay) * d
                self.var = self.decay * (self.var + (1 - self.decay) * d * d)
            return None
        thresh = max(self.mean + self.k * math.sqrt(max(self.var, 1e-12)),
                     self.mean * self.rel_floor,
                     self.floor)
        event = None
        if dt > thresh:
            event = StragglerEvent(step, dt, self.mean, thresh)
            self.events.append(event)
        else:
            # only non-outlier steps update the stats (else stragglers
            # poison their own detector)
            d = dt - self.mean
            self.mean += (1 - self.decay) * d
            self.var = self.decay * (self.var + (1 - self.decay) * d * d)
        return event


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    max_retries: int = 2
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def abstract_state(cfg: ModelConfig) -> Dict[str, Any]:
    """The train state of ``cfg`` as meta tensors (what
    :func:`make_initial_state` builds: parameters in their dtypes,
    float32 moments, an int32 step)."""
    return {"params": abstract_params(cfg),
            "opt": abstract_opt_state(model_param_defs(cfg))}


class TrainLoop:
    """Steps ``data`` from the latest checkpoint of ``ckpt`` (or from
    ``init_state_fn()``, a state of :func:`abstract_state`'s structure)
    to ``loop_cfg.total_steps``, on ``data``'s device."""

    def __init__(self, cfg: ModelConfig, loop_cfg: LoopConfig,
                 data: SyntheticLMData, ckpt: CheckpointManager,
                 init_state_fn: Callable[[], Dict[str, Any]],
                 step_fn: Optional[Callable] = None,
                 failure_injector: Optional[Callable[[int], None]] = None,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None):
        self.cfg = cfg
        self.loop_cfg = loop_cfg
        self.data = data
        self.ckpt = ckpt
        self.init_state_fn = init_state_fn
        self.step_fn = step_fn or make_train_step(cfg, loop_cfg.train)
        self.failure_injector = failure_injector
        self.on_straggler = on_straggler
        self.watchdog = StragglerWatchdog()
        self.history: List[Dict[str, float]] = []
        self._sigterm = False

    # -- lifecycle ----------------------------------------------------------
    def _state_and_start(self):
        latest = self.ckpt.latest_step()
        if latest is not None:
            state, manifest = self.ckpt.restore(
                abstract_state(self.cfg), latest, device=self.data.device)
            return state, int(manifest["step"])
        return self.init_state_fn(), 0

    def _install_sigterm(self):
        def handler(signum, frame):
            self._sigterm = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # non-main thread (tests)

    def run(self) -> Dict[str, Any]:
        self._install_sigterm()
        state, start = self._state_and_start()
        step = start
        while step < self.loop_cfg.total_steps:
            if self._sigterm:
                self.ckpt.save(state, step, {"reason": "sigterm"})
                return {"state": state, "step": step, "preempted": True}
            batch = self.data.batch_at(step)
            t0 = time.perf_counter()
            for attempt in range(self.loop_cfg.max_retries + 1):
                try:
                    if self.failure_injector is not None:
                        self.failure_injector(step)
                    state, metrics = self.step_fn(state, batch)
                    synchronize(self.data.device)
                    break
                except _TransientError:
                    if attempt == self.loop_cfg.max_retries:
                        # persistent failure: checkpoint and abort (the
                        # scheduler restarts us; resume is deterministic)
                        self.ckpt.save(state, step, {"reason": "failure"})
                        raise
            dt = time.perf_counter() - t0
            event = self.watchdog.update(step, dt)
            if event and self.on_straggler:
                self.on_straggler(event)
            step += 1
            if step % self.loop_cfg.log_every == 0 or step == 1:
                self.history.append(
                    {"step": step, "loss": float(metrics["loss"]),
                     "dt": dt})
            if step % self.loop_cfg.ckpt_every == 0:
                self.ckpt.save_async(state, step)
        self.ckpt.wait()
        self.ckpt.save(state, step, {"reason": "final"})
        return {"state": state, "step": step, "preempted": False}


class _TransientError(RuntimeError):
    """Raised by failure injectors to simulate recoverable node faults."""


def make_initial_state(cfg: ModelConfig, seed: int = 0,
                       device: Union[str, torch.device] = "cuda"):
    """A function building the initial train state on ``device``: the
    parameters drawn from a generator seeded ``seed`` (without the tied
    embedding's cached cast, which training leaves out) and zero
    moments."""
    dev = resolve_device(device)

    def init():
        g = torch.Generator(device=dev).manual_seed(seed)
        params = drop_cast(init_params(cfg, g, dev))
        return {"params": params, "opt": init_opt_state(params)}

    return init
