"""Metrics registry: counters / gauges / histograms with Prometheus
text exposition, filled from the serve stack's existing accounting.

Nothing here measures anything new: the registry is a projection of state
the port already keeps: the per-request
:class:`~repro_torch.serve.scheduler.RooflineLedger` (token counts,
per-level bytes, speculation accept / propose), the block pool's
``PoolStats`` (dedup / copy-on-write / eviction / swap counters) and the
:class:`~repro_torch.serve.scheduler.Request` latency stamps (the
telescoping TTFT breakdown and inter-token gaps).  :func:`harvest_serve`
reads them duck-typed (anything with ``aggregate_ledger``), so this
module imports nothing of ``serve`` and the scheduler can import
``obs.clock`` without a cycle.

``Registry.expose()`` renders the Prometheus text-exposition format
(``# HELP`` / ``# TYPE`` and samples with sorted, escaped labels), the
reference's text for the same operations.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# latency-ish buckets (seconds): 100us .. 30s, roughly x3 apart
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0,
                   3.0, 10.0, 30.0)


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _labels_str(names: Sequence[str], values: Tuple[str, ...],
                extra: str = "") -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(x: float) -> str:
    if isinstance(x, float) and math.isnan(x):
        return "NaN"
    if x == math.inf:
        return "+Inf"
    return repr(float(x)) if isinstance(x, float) else str(x)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def samples(self) -> Iterable[Tuple[str, str, float]]:
        for key in sorted(self.values):
            yield self.name, _labels_str(self.labelnames, key), \
                self.values[key]


class Counter(_Metric):
    """Monotone counter.  ``set_total`` exists because every source in
    this repo is already cumulative (ledgers, pool stats) — re-reading a
    total and clamping monotone is idempotent, so harvest can run any
    number of times without double counting."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        self.values[key] = self.values.get(key, 0.0) + amount

    def set_total(self, value: float, **labels) -> None:
        key = self._key(labels)
        self.values[key] = max(self.values.get(key, 0.0), float(value))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self.values[self._key(labels)] = float(value)

    def clear(self) -> None:
        self.values.clear()


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_, labelnames)
        self.buckets = tuple(sorted(buckets))
        self.counts: Dict[Tuple[str, ...], List[int]] = {}
        self.sums: Dict[Tuple[str, ...], float] = {}
        self.totals: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        if key not in self.counts:
            self.counts[key] = [0] * len(self.buckets)
            self.sums[key] = 0.0
            self.totals[key] = 0
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.counts[key][i] += 1
        self.totals[key] += 1
        if math.isfinite(value):
            self.sums[key] += float(value)

    def samples(self) -> Iterable[Tuple[str, str, float]]:
        for key in sorted(self.totals):
            for i, ub in enumerate(self.buckets):
                yield (self.name + "_bucket",
                       _labels_str(self.labelnames, key,
                                   extra=f'le="{_fmt(float(ub))}"'),
                       self.counts[key][i])
            yield (self.name + "_bucket",
                   _labels_str(self.labelnames, key, extra='le="+Inf"'),
                   self.totals[key])
            yield (self.name + "_sum",
                   _labels_str(self.labelnames, key), self.sums[key])
            yield (self.name + "_count",
                   _labels_str(self.labelnames, key), self.totals[key])


class Registry:
    """Named metric families, create-or-get semantics."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help_: str, labelnames, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help_, labelnames, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"{name} already registered as {m.kind}")
        return m

    def counter(self, name: str, help_: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help_, labelnames)

    def gauge(self, name: str, help_: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help_, labelnames)

    def histogram(self, name: str, help_: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, labelnames,
                         buckets=buckets)

    def expose(self) -> str:
        """Prometheus text-exposition snapshot of every family."""
        out: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for sname, labels, value in m.samples():
                out.append(f"{sname}{labels} {_fmt(value)}")
        return "\n".join(out) + "\n" if out else ""


# -- serve-stack harvest --------------------------------------------------


def _engines(source) -> list:
    """The engines of a serving source: a Cluster's replicas, or the one
    engine."""
    reps = getattr(source, "replicas", None)
    return list(reps) if reps is not None else [source]


def harvest_serve(registry: Registry, source,
                  seen: Optional[set] = None) -> None:
    """Project a serving source (an ``Engine`` or a ``Cluster``,
    duck-typed: ``aggregate_ledger``, and ``_kv`` / ``_sched`` on each of
    its engines) into ``registry``.

    Safe to call repeatedly: cumulative sources land through
    ``Counter.set_total`` (idempotent), per-request latency observations
    are de-duplicated through ``seen`` (request ids the caller keeps
    between harvests; the Telemetry bundle owns one).  The ``ici`` level
    is the tensor-parallel wire bytes the ledger charged (0 on one card);
    the migration families count the cluster's cross-replica moves and
    their packed bytes on the link that carried them.
    """
    led = source.aggregate_ledger()

    c = registry.counter("serve_decode_tokens_total",
                         "tokens committed by decode/verify steps")
    c.set_total(led.decode_tokens)
    fl = registry.counter("serve_flops_total",
                          "model FLOPs by phase (ledger)", ("phase",))
    fl.set_total(led.prefill_flops, phase="prefill")
    fl.set_total(led.decode_flops, phase="decode")
    fl.set_total(led.draft_flops, phase="draft")
    by = registry.counter("serve_level_bytes_total",
                          "decode bytes moved per memory level (ledger)",
                          ("level",))
    by.set_total(led.decode_vmem_bytes, level="vmem")
    by.set_total(led.decode_bytes, level="hbm")
    by.set_total(led.decode_ici_bytes, level="ici")
    by.set_total(led.swap_bytes, level="host")
    registry.counter("serve_kv_bytes_total",
                     "KV-line bytes decode attention walked"
                     ).set_total(led.decode_kv_bytes)
    registry.counter("serve_preemptions_total",
                     "requests evicted under pool pressure"
                     ).set_total(led.preemptions)
    registry.counter("serve_migrations_total",
                     "cross-replica KV migrations"
                     ).set_total(led.migrations)
    registry.counter(
        "serve_migration_bytes_total",
        "packed SwapSnapshot bytes moved between replicas", ("link",)
    ).set_total(led.migration_bytes, link=led.migration_link)
    registry.counter("serve_prefix_cached_tokens_total",
                     "prompt tokens served from the prefix cache"
                     ).set_total(led.prefix_cached_tokens)
    registry.counter("serve_spec_proposed_total",
                     "draft tokens proposed").set_total(led.proposed)
    registry.counter("serve_spec_accepted_total",
                     "draft tokens accepted").set_total(led.accepted)
    if led.proposed > 0:
        registry.gauge("serve_spec_acceptance_rate",
                       "accepted / proposed draft tokens"
                       ).set(led.acceptance_rate)

    # block-pool capacity counters + live occupancy, summed over pools
    pool_tot: Dict[str, int] = {}
    in_use = peak = total = 0
    for eng in _engines(source):
        kv = getattr(eng, "_kv", None)
        if kv is None:
            continue
        pool = kv.pool
        in_use += pool.num_pages - 1 - pool.free_page_count
        peak += pool.stats.peak_in_use
        total += pool.num_pages - 1
        for k, v in pool.stats.as_dict().items():
            pool_tot[k] = pool_tot.get(k, 0) + v
    if total:
        registry.gauge("serve_pool_pages_in_use",
                       "referenced pool pages right now").set(in_use)
        registry.gauge("serve_pool_pages_peak",
                       "high-water mark of referenced pages").set(peak)
        registry.gauge("serve_pool_pages_total",
                       "allocatable pool pages (excl. trash)").set(total)
        pc = registry.counter("serve_pool_events_total",
                              "block-pool events (PoolStats)", ("event",))
        for k in ("dedup_hits", "cow_copies", "evictions", "freezes",
                  "swap_dmas", "swap_transfers_saved"):
            pc.set_total(pool_tot.get(k, 0), event=k)

    # per-request latency: TTFT breakdown + inter-token gaps.  Requests
    # observe once (the seen set): histograms are not idempotent like the
    # cumulative counters above.
    th = registry.histogram(
        "serve_ttft_seconds",
        "time to first token, split into its telescoping segments",
        ("segment",))
    ih = registry.histogram("serve_itl_seconds",
                            "inter-token latency (pooled gaps)")
    gaps: List[float] = []
    done = {}
    for eng in _engines(source):
        sched = getattr(eng, "_sched", None)
        if sched is not None:
            for req in sched.finished:
                done[req.request_id] = req
    for rid, req in sorted(done.items()):
        tt = [req.token_times[i + 1] - req.token_times[i]
              for i in range(len(req.token_times) - 1)]
        gaps.extend(tt)
        if seen is not None and rid in seen:
            continue
        if seen is not None:
            seen.add(rid)
        if not req.token_times:
            continue
        bd = req.ttft_breakdown()
        th.observe(bd["queue_wait_s"], segment="queue_wait")
        th.observe(bd["prefill_s"], segment="prefill")
        th.observe(bd["first_decode_s"], segment="first_decode")
        th.observe(req.ttft, segment="total")
        for g in tt:
            ih.observe(g)
    if gaps:
        gaps.sort()
        registry.gauge("serve_itl_p50_seconds",
                       "median inter-token gap over finished requests"
                       ).set(gaps[len(gaps) // 2])
        registry.gauge("serve_itl_p95_seconds",
                       "p95 inter-token gap over finished requests"
                       ).set(gaps[min(len(gaps) - 1,
                                      int(0.95 * len(gaps)))])
