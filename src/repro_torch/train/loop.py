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

Data and tensor parallel (``mesh=``): every rank runs the loop over its
rows (``SyntheticLMData(shard=, shards=)``; the ranks of one ``model``
row take the same ones) with the mesh's step, and the ranks agree before
each attempt of a step on a preemption and on a failure (one all-reduce
of two flags), so they save, retry and stop together; checkpoints are
collective (``CheckpointManager(mesh=, shards=)``), the restore's step
is rank 0's, rank 0 alone keeps the history, and each rank keeps its own
straggler watchdog.
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
                      model_param_defs, param_shardings)
from ..models.common import ModelConfig
from ..models.params import tree_map
from ..parallel.mesh import Mesh, holds_blocks
from ..parallel.sharding import leaf_block
from .checkpoint import CheckpointManager
from .data import SyntheticLMData
from .optimizer import abstract_opt_state, init_opt_state, moment_shards
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


def _moment_shards(cfg: ModelConfig, mesh: Optional[Mesh]):
    return moment_shards(model_param_defs(cfg), mesh) \
        if holds_blocks(mesh) else None


def abstract_state(cfg: ModelConfig, mesh: Optional[Mesh] = None
                   ) -> Dict[str, Any]:
    """The train state of ``cfg`` as meta tensors (what
    :func:`make_initial_state` builds: parameters in their dtypes,
    float32 moments, an int32 step); on a ``mesh`` with ranks the
    parameters are this rank's blocks (``models.param_shardings``) and
    the moments their ZeRO-1 blocks."""
    return {"params": abstract_params(cfg, mesh if holds_blocks(mesh)
                                      else None),
            "opt": abstract_opt_state(model_param_defs(cfg),
                                      _moment_shards(cfg, mesh))}


def state_shards(cfg: ModelConfig, mesh: Optional[Mesh]):
    """The train state's tree of ``parallel.sharding.Block`` (None for a
    whole leaf) on ``mesh``: each parameter's block under its spec, each
    moment's ``optimizer.moment_shards`` block (the parameter's plus the
    data piece); a checkpoint manager's ``shards``."""
    defs = model_param_defs(cfg)
    if not holds_blocks(mesh):
        none = tree_map(lambda d: None, defs)
        return {"params": none,
                "opt": {"mu": none, "nu": none, "step": None}}
    moment = moment_shards(defs, mesh)
    return {"params": tree_map(lambda d, sp: leaf_block(sp, mesh), defs,
                               param_shardings(cfg, mesh)),
            "opt": {"mu": moment, "nu": moment, "step": None}}


class TrainLoop:
    """Steps ``data`` from the latest checkpoint of ``ckpt`` (or from
    ``init_state_fn()``, a state of :func:`abstract_state`'s structure)
    to ``loop_cfg.total_steps``, on ``data``'s device; with ``mesh``,
    on every rank of it together (the module docstring)."""

    def __init__(self, cfg: ModelConfig, loop_cfg: LoopConfig,
                 data: SyntheticLMData, ckpt: CheckpointManager,
                 init_state_fn: Callable[[], Dict[str, Any]],
                 step_fn: Optional[Callable] = None,
                 failure_injector: Optional[Callable[[int], None]] = None,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.loop_cfg = loop_cfg
        self.data = data
        self.ckpt = ckpt
        self.init_state_fn = init_state_fn
        self.mesh = mesh
        self.step_fn = step_fn or make_train_step(cfg, loop_cfg.train, mesh)
        self.failure_injector = failure_injector
        self.on_straggler = on_straggler
        self.watchdog = StragglerWatchdog()
        self.history: List[Dict[str, float]] = []
        self._sigterm = False
        self._ranks = holds_blocks(mesh)

    # -- agreement across ranks -----------------------------------------------
    def _agree(self, *flags: bool) -> List[bool]:
        """Each flag set on any rank (an all-reduce of their max over the
        world; as given on one device)."""
        if not self._ranks:
            return list(flags)
        import torch.distributed as dist
        t = torch.tensor([int(f) for f in flags], dtype=torch.int32,
                         device=self.data.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return [bool(x) for x in t.tolist()]

    def _latest(self) -> Optional[int]:
        """The latest checkpoint's step, rank 0's on a mesh."""
        latest = self.ckpt.latest_step()
        if not self._ranks:
            return latest
        import torch.distributed as dist
        t = torch.tensor([-1 if latest is None else latest],
                         dtype=torch.int64, device=self.data.device)
        dist.broadcast(t, src=0)
        return None if int(t) < 0 else int(t)

    # -- lifecycle ----------------------------------------------------------
    def _state_and_start(self):
        latest = self._latest()
        if latest is not None:
            state, manifest = self.ckpt.restore(
                abstract_state(self.cfg, self.mesh), latest,
                device=self.data.device)
            return state, int(manifest["step"])
        return self.init_state_fn(), 0

    def _install_sigterm(self):
        def handler(signum, frame):
            self._sigterm = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # non-main thread (tests)

    def _inject(self, step: int) -> Optional[_TransientError]:
        try:
            if self.failure_injector is not None:
                self.failure_injector(step)
        except _TransientError as e:
            return e
        return None

    def run(self) -> Dict[str, Any]:
        self._install_sigterm()
        state, start = self._state_and_start()
        step = start
        lead = self.mesh is None or self.mesh.rank == 0
        while step < self.loop_cfg.total_steps:
            batch = self.data.batch_at(step)
            t0 = time.perf_counter()
            for attempt in range(self.loop_cfg.max_retries + 1):
                err = self._inject(step)
                stop, failed = self._agree(self._sigterm, err is not None)
                if stop:
                    self.ckpt.save(state, step, {"reason": "sigterm"})
                    return {"state": state, "step": step, "preempted": True}
                if not failed:
                    try:
                        state, metrics = self.step_fn(state, batch)
                        synchronize(self.data.device)
                        break
                    except _TransientError as e:
                        if self._ranks:    # the other ranks are mid-step
                            raise
                        err = e
                if attempt == self.loop_cfg.max_retries:
                    # persistent failure: checkpoint and abort (the
                    # scheduler restarts us; resume is deterministic)
                    self.ckpt.save(state, step, {"reason": "failure"})
                    raise err if err is not None else _TransientError(
                        f"another rank failed step {step}")
            dt = time.perf_counter() - t0
            event = self.watchdog.update(step, dt)
            if event and self.on_straggler:
                self.on_straggler(event)
            step += 1
            if lead and (step % self.loop_cfg.log_every == 0 or step == 1):
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
                       device: Union[str, torch.device] = "cuda",
                       mesh: Optional[Mesh] = None):
    """A function building the initial train state on ``device``: the
    parameters drawn from a generator seeded ``seed`` (without the tied
    embedding's cached cast, which training leaves out; the same weights
    on every rank, each holding its blocks on a ``mesh`` with ranks:
    ``init_params(..., specs=, mesh=)``) and zero moments (this rank's
    ZeRO-1 blocks of them on a ``mesh`` with a data axis)."""
    dev = resolve_device(device)
    shards = _moment_shards(cfg, mesh)
    specs = param_shardings(cfg, mesh) if holds_blocks(mesh) else None

    def init():
        g = torch.Generator(device=dev).manual_seed(seed)
        params = drop_cast(init_params(cfg, g, dev, specs=specs, mesh=mesh))
        return {"params": params, "opt": init_opt_state(params, shards)}

    return init
