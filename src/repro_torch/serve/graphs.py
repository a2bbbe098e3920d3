"""Fixed-shape engine steps as captured CUDA graphs: the port's
counterpart of the reference's jitted steps.

The reference runs each engine step as one compiled program dispatched
once a step: the decode step, the speculative verify step, a draft
model's catch-up and draft steps, and a prefill chunk of each length and
a whole-prompt bucket of each padded length (one compile per shape).
Run eagerly, the same step is one Python-dispatched launch per op
(thousands a step).  On CUDA, :class:`StepGraphs` captures each step
body once with ``torch.cuda.graph`` and replays it at every later call:

* ``decode``, ``verify``, ``catchup``, ``draft``: one graph each (the
  static engine's ``decode`` step runs over its dense caches, on a
  :class:`StepGraphs` of its own for each ``generate`` call);
* ``prefill_chunk:T``: one paged prefill chunk of T tokens, once per T;
* ``prefill_bucket:S``: a whole prompt padded to S tokens with the
  scatter of its states into the pages, once per S (the engine's, and
  the draft model's on its own :class:`StepGraphs`).

A step body is a function of no arguments that reads only persistent
tensors: the weights, the page pools (mutated in place, never replaced)
and the :class:`StaticInput` buffers its owner fills before each step
from pinned host staging, outside the graph (a prefill's are one
:class:`PrefillInputs`).  Its shapes never change (slots idle this step
point at the trash page and keep their state rows through the decode
step's active mask; a prefill's slot, offset and length are device
scalars).  Its first call runs the body eagerly on a side stream, which
is that step's real work and also builds the kernels and makes their
one-time settings (shared-memory opt-ins); then the body is captured,
and every later call replays it.  Every replay adds to each kernel
wrapper's ``launches`` what the capture counted, so launch counts mean
what they mean eagerly.  A capture or a replay that fails raises: there
is no fallback to the eager body.  On the CPU there are no graphs and the
same body runs eagerly every step.

All graphs of one :class:`StepGraphs` share one memory pool, so a
graph's output may be overwritten by the next replay of any of them:
each owner reads a step's output before it replays another step.

The GQA core counts arrivals in a buffer whose pointer a graph keeps, so
each :class:`StepGraphs` holds one of its own, sized at construction for
its largest step (``kernels.paged_attention.hold_gqa_counters``).
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..kernels import ops
from ..kernels import paged_attention as pa
from ..obs.clock import now


def graphs_enabled(flag: Optional[bool], device: torch.device) -> bool:
    """``EngineConfig.cuda_graphs`` resolved for ``device``: None means on
    for CUDA and off for the CPU; True on the CPU raises."""
    if flag is None:
        return device.type == "cuda"
    if flag and device.type != "cuda":
        raise ValueError(f"cuda_graphs=True needs a CUDA device, not "
                         f"{device}; CUDA graphs cannot run on the CPU")
    return bool(flag)


def launch_counters() -> list:
    """The kernel wrappers that count their launches (every registered
    CUDA kernel and ring)."""
    out = []
    for impls in ops.registered_kernels().values():
        for fn in impls.values():
            if hasattr(fn, "launches") and fn not in out:
                out.append(fn)
    return out


class StaticInput:
    """A persistent device buffer a step body reads, filled before each
    step from host staging (pinned on CUDA, so the copy is asynchronous;
    on the CPU the buffer itself).  :meth:`set` waits until the previous
    copy has read the staging before writing it again."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        self.tensor = torch.zeros(shape, dtype=dtype, device=device)
        self._cuda = device.type == "cuda"
        self._host = (torch.zeros(shape, dtype=dtype, pin_memory=True)
                      if self._cuda else self.tensor)
        self._staged = self._host.numpy()
        self._copied = torch.cuda.Event() if self._cuda else None

    def set(self, values: np.ndarray) -> torch.Tensor:
        """Fill the buffer with ``values`` (host array of its shape);
        returns the device buffer."""
        if self._cuda:
            self._copied.synchronize()
        self._staged[...] = values
        if self._cuda:
            self.tensor.copy_(self._host, non_blocking=True)
            self._copied.record()
        return self.tensor


class PrefillInputs:
    """The persistent inputs of one engine's (or draft model's) captured
    prefill bodies: the request's block-table row (n_blocks,), its 0-d
    slot (the state rows a recurrent mixer reads and writes, so one chunk
    graph per T serves every slot), a 0-d offset (a chunk's first
    position), a 0-d length (a bucket's true prompt length) and a (1, T)
    token buffer for each chunk or bucket length T, made at its first
    use."""

    def __init__(self, n_blocks: int, device: torch.device):
        self.device = device
        self.row = StaticInput((n_blocks,), torch.int32, device)
        self.slot = StaticInput((), torch.int32, device)
        self.offset = StaticInput((), torch.int32, device)
        self.length = StaticInput((), torch.int32, device)
        self._tokens: Dict[int, StaticInput] = {}

    def tokens(self, T: int) -> StaticInput:
        if T not in self._tokens:
            self._tokens[T] = StaticInput((1, T), torch.int64, self.device)
        return self._tokens[T]


class StepGraph:
    """One step: its body run eagerly on a side stream at the first call,
    then captured; the graph replayed at every later call.  ``out`` is the
    captured output, overwritten by each replay.  The body is not kept: a
    bound method of the graph's owner would make a reference cycle that
    holds the owner's weights and pools until a garbage collection."""

    def __init__(self, device: torch.device, pool, counters: torch.Tensor):
        self.device = device
        self.pool = pool
        self.counters = counters
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Dict[Callable, int] = {}
        self.capture_s = 0.0

    def __call__(self, body: Callable[[], torch.Tensor]) -> torch.Tensor:
        if self.graph is None:
            return self._warm_and_capture(body)
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n
        return self.out

    def _warm_and_capture(self, body: Callable[[], torch.Tensor]
                          ) -> torch.Tensor:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side), pa.hold_gqa_counters(self.counters):
            out = body()                   # this step's work, eagerly
        cur.wait_stream(side)
        out.record_stream(cur)
        t0 = now()
        counters = launch_counters()
        before = [fn.launches for fn in counters]
        graph = torch.cuda.CUDAGraph()
        # only this thread's work may reach the capture: no other thread's
        # CUDA call (a profiler's activity flush) invalidates it, and no
        # garbage collection frees a dead engine's buffers inside it
        # (torch.cuda.graph collects just before it begins)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with pa.hold_gqa_counters(self.counters), torch.cuda.graph(
                    graph, pool=self.pool,
                    capture_error_mode="thread_local"):
                self.out = body()
        finally:
            if collecting:
                gc.enable()
        # the capture launched nothing: its counts are what a replay adds
        for fn, n0 in zip(counters, before):
            if fn.launches != n0:
                self.launches[fn] = fn.launches - n0
                fn.launches = n0
        self.graph = graph
        self.capture_s = now() - t0
        return out


class StepGraphs:
    """The captured steps of one engine or draft proposer of model ``cfg``,
    by name, over one memory pool and one held GQA counter buffer sized
    for ``slots`` x ``tokens`` queries (its largest step); with
    ``enabled`` False, :meth:`run` calls the body."""

    def __init__(self, device: torch.device, enabled: bool, cfg,
                 slots: int, tokens: int):
        self.device = device
        self.enabled = enabled
        self.graphs: Dict[str, StepGraph] = {}
        self.pool = self.counters = None
        if enabled:
            self.pool = torch.cuda.graph_pool_handle()
            kv = max(cfg.n_kv_heads, 1)
            self.counters = pa.gqa_counters(pa.gqa_row_groups(
                slots, tokens, kv, max(cfg.n_heads // kv, 1)), device)

    def run(self, name: str, body: Callable[[], torch.Tensor]
            ) -> torch.Tensor:
        """The step ``name``: ``body()`` eagerly when graphs are off, else
        its graph (captured from ``body`` at the first call)."""
        if not self.enabled:
            return body()
        g = self.graphs.get(name)
        if g is None:
            g = self.graphs[name] = StepGraph(self.device, self.pool,
                                              self.counters)
        return g(body)

    @property
    def capture_s(self) -> float:
        """Seconds spent capturing (the first call's eager run excluded)."""
        return sum(g.capture_s for g in self.graphs.values())
