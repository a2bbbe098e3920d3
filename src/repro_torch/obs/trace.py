"""Host-side span tracer with Chrome trace-event export.

The serve stack already synchronizes and stamps every edge worth seeing:
the prefill chunk and the decode / verify step bracket their device
window with two :func:`obs.clock.now` stamps around an existing fence
(the token read-back), the draft round ends at its synchronize, swaps
time their copies.  The tracer only records those stamps as events (a
list append per edge; no device op, no added fence), so tracing is
observation-only by construction: token streams are byte-identical with
it on or off, graphed or eager.

Export is the Chrome trace-event JSON format (``chrome://tracing`` or
https://ui.perfetto.dev): one *process* per engine (pid = replica index
in a cluster; the router's front door has a pid of its own), one
*thread* per track (the engine's step track, a request-lifecycle track,
one track per decode slot), so a run opens as a timeline with prefill
chunks and decode steps as slices, migrations as flow arrows between
replica processes and pool / attainment counters above them.

Event vocabulary (small, so the validator can be strict):

* ``X`` duration slices for serially-executed device windows only
  (prefill chunks, decode / verify / propose steps, swap and migrate
  copies); on one track they never partially overlap (they may nest),
  which :func:`validate_trace` enforces;
* ``b`` / ``e`` async pairs (per request id) for request lifetimes;
* ``i`` instants for point edges: submit, dispatch, enqueue, migrate,
  placement, first token, preemption;
* ``s`` / ``f`` flow pairs linking a migration's export on the source
  replica to its restore on the destination;
* ``C`` counters (pool pages in use, live roofline attainment);
* ``M`` metadata naming every process and thread.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional

from . import clock

# Track (tid) layout inside each replica process.  Slot tracks start at
# SLOT_TID0 so engine/lifecycle tracks sort above them in the viewer.
ENGINE_TID = 0          # packed device steps: decode/verify/propose
LIFECYCLE_TID = 1       # request instants + async request spans
SLOT_TID0 = 10          # per-slot prefill/swap/migrate spans
ROUTER_PID = 999        # the front door is its own process


class Tracer:
    """Append-only event recorder over the shared monotonic clock.

    All ``t``/``t0``/``t1`` arguments are raw :func:`obs.clock.now`
    stamps; the tracer subtracts its ``epoch`` (set at construction, or
    shared explicitly so multi-replica timelines align) and renders
    microseconds, the trace-event unit."""

    def __init__(self, epoch: Optional[float] = None):
        self.epoch = clock.now() if epoch is None else epoch
        self.events: List[Dict[str, Any]] = []
        self._named: set = set()          # de-dup (kind, pid, tid) metadata

    # -- time ------------------------------------------------------------

    def _us(self, t: float) -> float:
        return max((t - self.epoch) * 1e6, 0.0)

    # -- metadata --------------------------------------------------------

    def process(self, pid: int, name: str) -> None:
        key = ("process", pid)
        if key in self._named:
            # re-announce: the last metadata event wins in the viewer
            self.events.append({"ph": "M", "name": "process_name",
                                "pid": pid, "tid": 0, "ts": 0,
                                "args": {"name": name}})
            return
        self._named.add(key)
        self.events.append({"ph": "M", "name": "process_name", "pid": pid,
                            "tid": 0, "ts": 0, "args": {"name": name}})

    def thread(self, pid: int, tid: int, name: str) -> None:
        key = ("thread", pid, tid)
        if key in self._named:
            return
        self._named.add(key)
        self.events.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tid, "ts": 0, "args": {"name": name}})

    # -- events ----------------------------------------------------------

    def span(self, name: str, pid: int, tid: int, t0: float, t1: float,
             **args) -> None:
        self.events.append({"ph": "X", "name": name, "pid": pid,
                            "tid": tid, "ts": self._us(t0),
                            "dur": max((t1 - t0) * 1e6, 0.0),
                            "args": args})

    def instant(self, name: str, pid: int, tid: int, t: float,
                **args) -> None:
        self.events.append({"ph": "i", "name": name, "pid": pid,
                            "tid": tid, "ts": self._us(t), "s": "t",
                            "args": args})

    def counter(self, name: str, pid: int, t: float,
                values: Dict[str, float]) -> None:
        self.events.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                            "ts": self._us(t), "args": dict(values)})

    def async_begin(self, name: str, pid: int, tid: int, id_: int,
                    t: float, **args) -> None:
        self.events.append({"ph": "b", "cat": "serve", "name": name,
                            "pid": pid, "tid": tid, "id": id_,
                            "ts": self._us(t), "args": args})

    def async_end(self, name: str, pid: int, tid: int, id_: int,
                  t: float, **args) -> None:
        self.events.append({"ph": "e", "cat": "serve", "name": name,
                            "pid": pid, "tid": tid, "id": id_,
                            "ts": self._us(t), "args": args})

    def flow_start(self, name: str, pid: int, tid: int, id_: int,
                   t: float, **args) -> None:
        self.events.append({"ph": "s", "cat": "serve", "name": name,
                            "pid": pid, "tid": tid, "id": id_,
                            "ts": self._us(t), "args": args})

    def flow_finish(self, name: str, pid: int, tid: int, id_: int,
                    t: float, **args) -> None:
        self.events.append({"ph": "f", "cat": "serve", "name": name,
                            "pid": pid, "tid": tid, "id": id_, "bp": "e",
                            "ts": self._us(t), "args": args})

    # -- export ----------------------------------------------------------

    def export(self, path: Optional[str] = None) -> Dict[str, Any]:
        """The Chrome trace-event document; written to ``path`` when
        given.  Exports a copy — the tracer keeps recording."""
        doc = {"displayTimeUnit": "ms",
               "traceEvents": list(self.events)}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


_REQUIRED = ("ph", "name", "pid", "tid")


def validate_trace(doc: Dict[str, Any]) -> List[str]:
    """Schema check for an exported trace.

    Returns a list of human-readable problems (empty = valid):

    * top-level shape (``traceEvents`` list + ``displayTimeUnit``),
    * every event carries ph/name/pid/tid and a finite ``ts >= 0``,
    * duration slices have finite ``dur >= 0`` and, per track, never
      *partially* overlap (proper nesting is fine — that is the
      trace-viewer stacking contract; a partial overlap means two
      "serial" device windows claimed the same wall time),
    * every pid/tid that carries events is named by ``M`` metadata,
    * async ``b``/``e`` pairs balance per (name, id) with ``e`` no
      earlier than ``b``; flow ``s``/``f`` ids pair up with ``f`` no
      earlier than ``s`` — no orphan ids anywhere.
    """
    errors: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["trace document must be a dict with a 'traceEvents' list"]
    if "displayTimeUnit" not in doc:
        errors.append("missing displayTimeUnit")
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        return errors + ["traceEvents must be a non-empty list"]

    named_p, named_t = set(), set()
    used_p, used_t = set(), set()
    spans: Dict[tuple, List[tuple]] = {}
    asyncs: Dict[tuple, List[tuple]] = {}
    flows: Dict[Any, Dict[str, List[float]]] = {}
    for i, ev in enumerate(events):
        missing = [k for k in _REQUIRED if k not in ev]
        if missing:
            errors.append(f"event {i}: missing keys {missing}")
            continue
        ph, name = ev["ph"], ev["name"]
        pid, tid = ev["pid"], ev["tid"]
        if ph == "M":
            if name == "process_name":
                named_p.add(pid)
            elif name == "thread_name":
                named_t.add((pid, tid))
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or not math.isfinite(ts) \
                or ts < 0:
            errors.append(f"event {i} ({name!r}): bad ts {ts!r}")
            continue
        used_p.add(pid)
        used_t.add((pid, tid))
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or not math.isfinite(dur) \
                    or dur < 0:
                errors.append(f"event {i} ({name!r}): bad dur {dur!r}")
                continue
            spans.setdefault((pid, tid), []).append((ts, ts + dur, name))
        elif ph in ("b", "e"):
            asyncs.setdefault((name, ev.get("id")), []).append((ts, ph))
        elif ph in ("s", "f"):
            flows.setdefault(ev.get("id"), {"s": [], "f": []})[ph].append(ts)
        elif ph not in ("i", "C"):
            errors.append(f"event {i} ({name!r}): unknown phase {ph!r}")

    for pid in sorted(used_p):
        if pid not in named_p:
            errors.append(f"pid {pid} has events but no process_name")
    for pid, tid in sorted(used_t):
        if (pid, tid) not in named_t:
            errors.append(f"pid {pid} tid {tid} has events but no "
                          "thread_name")

    # monotone-span check: per track, sorted slices must nest like a
    # call stack — a slice starting inside its predecessor must also end
    # inside it
    for (pid, tid), sl in spans.items():
        sl.sort()
        stack: List[tuple] = []
        for t0, t1, name in sl:
            while stack and t0 >= stack[-1][1]:
                stack.pop()
            if stack and t1 > stack[-1][1] + 1e-6:
                errors.append(
                    f"pid {pid} tid {tid}: span {name!r} "
                    f"[{t0:.1f}, {t1:.1f}]us partially overlaps "
                    f"{stack[-1][2]!r} ending at {stack[-1][1]:.1f}us")
            stack.append((t0, t1, name))

    for (name, id_), evs in asyncs.items():
        n_b = sum(1 for _, ph in evs if ph == "b")
        n_e = len(evs) - n_b
        if n_b != n_e:
            errors.append(f"async {name!r} id {id_}: {n_b} begins vs "
                          f"{n_e} ends (orphan id)")
        elif evs and max(ts for ts, ph in evs if ph == "e") < \
                min(ts for ts, ph in evs if ph == "b"):
            errors.append(f"async {name!r} id {id_}: end precedes begin")
    for id_, ends in flows.items():
        if not ends["s"] or not ends["f"]:
            errors.append(f"flow id {id_}: orphan "
                          f"({len(ends['s'])} starts, "
                          f"{len(ends['f'])} finishes)")
        elif min(ends["f"]) < min(ends["s"]) - 1e-6:
            errors.append(f"flow id {id_}: finish precedes start")
    return errors
