"""Serve-stack observability: span tracing, metrics, live attainment.

One :class:`Telemetry` bundle ties the three pieces together:

* :class:`~repro_torch.obs.trace.Tracer`: Chrome trace-event spans for
  every lifecycle edge the stack already stamps (Perfetto /
  chrome://tracing);
* :class:`~repro_torch.obs.metrics.Registry`: counters, gauges and
  histograms projected from the ledgers, pool stats and latency stamps
  the stack already keeps, with Prometheus text exposition;
* :class:`~repro_torch.obs.attainment.AttainmentTracker`: windowed
  roofline attainment ("what fraction of which roof, right now") from
  ledger deltas.

An ``Engine`` owns a private bundle when ``EngineConfig.telemetry`` is
on; a ``Cluster`` builds one shared bundle and attaches it to every
replica, so the replicas land on one timeline (pid = replica index) and
one registry.  Everything here is observation-only: the hooks are host-side list
appends and dict updates behind ``if obs is not None``, never a device
op, a synchronize or a read-back, so token streams and launch counts are
the same with telemetry on or off, graphed or eager.  :mod:`.clock` is
the one clock every stamp reads.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from . import clock
from .attainment import AttainmentTracker, AttainmentWindow
from .metrics import Registry, harvest_serve
from .trace import (ENGINE_TID, LIFECYCLE_TID, ROUTER_PID, SLOT_TID0,
                    Tracer, validate_trace)

__all__ = [
    "Telemetry", "Tracer", "validate_trace", "Registry", "harvest_serve",
    "AttainmentTracker", "AttainmentWindow", "clock",
    "ENGINE_TID", "LIFECYCLE_TID", "SLOT_TID0", "ROUTER_PID",
]


class Telemetry:
    """The bundle an engine or a cluster threads through its hooks.

    ``on_step`` is the per-step path: a pool-occupancy counter sample and
    an attainment tick; everything else happens on lifecycle edges or at
    harvest time.  The bundle keeps no reference to any engine: an engine
    is passed in to each call.
    """

    def __init__(self, window_steps: int = 4,
                 epoch: Optional[float] = None):
        self.tracer = Tracer(epoch=epoch)
        self.registry = Registry()
        self.attainment = AttainmentTracker(window_steps=window_steps)
        self._seen: set = set()        # request ids already observed

    # -- per-step ---------------------------------------------------------

    def on_step(self, engine) -> None:
        pid = getattr(engine, "_obs_pid", 0)
        t = clock.now()
        kv = getattr(engine, "_kv", None)
        if kv is not None:
            self.tracer.counter(
                "pool_pages", pid, t,
                {"in_use": kv.pool.num_pages - 1 - kv.pool.free_page_count})
        w = self.attainment.tick(engine, pid)
        if w is not None:
            self._publish(w)

    def _publish(self, w: AttainmentWindow) -> None:
        self.tracer.counter(
            "roofline_attainment", w.pid, w.t_end,
            {"fraction_of_binding": w.fraction})
        self.attainment.publish(self.registry, w)

    # -- harvest / export -------------------------------------------------

    def harvest(self, source) -> None:
        """Fold a serving source (an engine, or a Cluster's replicas)
        into the registry, closing each engine's partial attainment
        window first so short runs still report at least one."""
        from .metrics import _engines
        for i, eng in enumerate(_engines(source)):
            w = self.attainment.flush(eng, getattr(eng, "_obs_pid", i))
            if w is not None:
                self._publish(w)
        harvest_serve(self.registry, source, seen=self._seen)

    def export_trace(self, path: Optional[str] = None) -> Dict[str, Any]:
        return self.tracer.export(path)

    def snapshot(self, path: Optional[str] = None) -> str:
        text = self.registry.expose()
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text
