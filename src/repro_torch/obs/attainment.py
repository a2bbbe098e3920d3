"""Roofline attainment as a live, windowed metric.

Every ``window_steps`` engine steps, the delta of the engine's aggregate
:class:`~repro_torch.serve.scheduler.RooflineLedger` over the window is
folded into :class:`~repro_torch.core.roofline.model.RooflineTerms` (the
ledger's analytic terms over a window instead of a request) and divided
by the window's wall time:

    attained FLOP/s        = terms.flops_dev / dt
    attainment[level]      = attained FLOP/s / terms.roofs()[level]
    binding roof           = terms.binding_roof   (the lowest roof)

``roofs()`` prices each level's ceiling at the window's own byte mix
(paper eq. 1 per level: ``min(pi, I_level * beta_level)``) on the
engine's ``EngineConfig.chip``: the data sheet by default, the card's
measured betas when the caller passes ``MicrobenchResult.to_chipspec()``.
So ``attainment[binding]`` is "what fraction of the attainable ceiling
is the server on right now", and the binding key names the level to
blame.  All host-side arithmetic on counters the ledger already keeps.

Duck-typed over the engine (``aggregate_ledger`` / ``cfg`` /
``ecfg.chip`` / ``_ledger_chips``), so it imports nothing of ``serve``.
State is keyed by ``id(engine)`` and holds ledgers, never the engine: a
bundle owned by an engine refers to nothing that keeps it alive.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from . import clock


@dataclasses.dataclass
class AttainmentWindow:
    """One closed measurement window on one engine (pid = its trace
    process)."""
    index: int
    pid: int
    t_end: float                      # clock.now() stamp at window close
    dt_s: float
    tokens: int                       # decode tokens committed in-window
    flops_per_s: float                # attained, per device
    bytes_per_s: Dict[str, float]     # attained per level, per device
    roofs: Dict[str, float]           # FLOP/s ceilings at this byte mix
    binding_roof: str
    attainment: Dict[str, float]      # flops_per_s / roofs[level]

    @property
    def fraction(self) -> float:
        """Attained fraction of the binding (lowest) roof."""
        return self.attainment.get(self.binding_roof, float("nan"))


def _ledger_delta(cur, prev):
    """Field-wise difference of two aggregate ledgers (generic over the
    dataclass so new ledger fields are picked up automatically; the one
    string field, the migration link, is carried, not subtracted)."""
    out = type(cur)()
    for f in dataclasses.fields(type(cur)):
        v = getattr(cur, f.name)
        if isinstance(v, str):
            setattr(out, f.name, v)
        else:
            setattr(out, f.name, v - getattr(prev, f.name))
    return out


class AttainmentTracker:
    """Window the live ledger stream of one or more engines.

    The engine calls :meth:`tick` at the end of every step; every
    ``window_steps`` ticks the tracker closes a window (skipping windows
    with no decode work — a pure-admission step has no roof to be on).
    :meth:`flush` closes the in-progress window early, so short runs
    still report.  State is keyed per engine, so cluster replicas can
    share one tracker (and one ``windows`` list) through the shared
    Telemetry bundle."""

    def __init__(self, window_steps: int = 4):
        if window_steps < 1:
            raise ValueError("window_steps must be >= 1")
        self.window_steps = window_steps
        self.windows: List[AttainmentWindow] = []
        self._state: Dict[int, list] = {}   # id(engine) -> [n, t0, ledger]

    def tick(self, engine, pid: int = 0) -> Optional[AttainmentWindow]:
        key = id(engine)
        st = self._state.get(key)
        if st is None:
            # baseline: everything before the first tick is warm-up from
            # this tracker's point of view
            self._state[key] = [0, clock.now(), engine.aggregate_ledger()]
            return None
        st[0] += 1
        if st[0] < self.window_steps:
            return None
        return self._close(engine, pid, st)

    def flush(self, engine, pid: int = 0) -> Optional[AttainmentWindow]:
        """Close the current partial window (end of run / snapshot
        time); None when the engine never ticked or the remainder holds
        no decode work."""
        st = self._state.get(id(engine))
        if st is None or st[0] == 0:
            return None
        return self._close(engine, pid, st)

    def rebase(self, engine) -> None:
        """Forget the engine's open window, so its next tick is a new
        baseline: for a caller that idles an engine between runs and
        wants no window to span the idle gap (the reference has no such
        call; its windows always run on)."""
        self._state.pop(id(engine), None)

    def _close(self, engine, pid: int,
               st: list) -> Optional[AttainmentWindow]:
        t = clock.now()
        led = engine.aggregate_ledger()
        delta = _ledger_delta(led, st[2])
        dt = t - st[1]
        st[0], st[1], st[2] = 0, t, led
        if dt <= 0.0 or delta.decode_tokens <= 0 or delta.decode_bytes <= 0:
            return None
        terms = delta.terms(engine.cfg, engine.ecfg.chip,
                            n_chips=engine._ledger_chips())
        roofs = terms.roofs()
        flops_ps = terms.flops_dev / dt
        w = AttainmentWindow(
            index=len(self.windows), pid=pid, t_end=t, dt_s=dt,
            tokens=int(delta.decode_tokens), flops_per_s=flops_ps,
            bytes_per_s={lvl: terms.level_bytes(lvl) / dt
                         for lvl in roofs if lvl not in
                         ("compute", "migration")},
            roofs=roofs, binding_roof=terms.binding_roof,
            attainment={lvl: (flops_ps / roof if roof > 0
                              else float("nan"))
                        for lvl, roof in roofs.items()})
        self.windows.append(w)
        return w

    def publish(self, registry, window: AttainmentWindow) -> None:
        """Set the live-attainment gauges from one closed window (the
        "right now" view a scraper sees)."""
        g = registry.gauge("serve_roofline_attainment",
                           "attained FLOP/s / per-level roof, last window",
                           ("level",))
        for lvl, frac in window.attainment.items():
            g.set(frac, level=lvl)
        b = registry.gauge("serve_roofline_binding",
                           "1 on the binding roof of the last window",
                           ("roof",))
        b.clear()
        b.set(1.0, roof=window.binding_roof)
        registry.gauge("serve_attained_flops_per_s",
                       "attained FLOP/s per device, last window"
                       ).set(window.flops_per_s)
        bp = registry.gauge("serve_attained_bytes_per_s",
                            "attained bytes/s per level per device, "
                            "last window", ("level",))
        for lvl, v in window.bytes_per_s.items():
            bp.set(v, level=lvl)
        registry.gauge("serve_tokens_per_s",
                       "decode tokens/s, last window"
                       ).set(window.tokens / window.dt_s)
        registry.gauge("serve_attainment_windows",
                       "closed attainment windows so far"
                       ).set(len(self.windows))
