"""The port's serve telemetry (``repro_torch.obs``) against the JAX
package's ``repro.obs``, on the same inputs:

* the tracer: the same sequence of calls exports the same Chrome
  trace-event document; the validator gives the same verdicts (the same
  error lists) on the same malformed documents;
* the metrics registry: the same operations expose the same Prometheus
  text, and refuse the same misuse;
* the attainment tracker: a duck-typed engine with fixed ledgers and a
  fixed clock closes the same windows (binding roof, fractions, rates);
* the engines (eager, on the CPU): greedy streams byte-identical with
  telemetry on and off for ``Engine`` and ``SpecEngine`` (n-gram and
  self-draft), equal launch counts and the same number of
  ``device.synchronize`` calls, a valid trace whose events (by phase and
  name) count the same as the reference engine's on the same requests,
  a TTFT breakdown that sums to TTFT, and a harvest whose decode-token
  total equals the aggregate ledger's.

Held against the reference's ``pipeline="off"`` engines only.  No
wall-clock overhead test here: the 1.25x bar is held on the card
(``chip_smoke.py``'s ``[telemetry]`` phase).
"""

import collections
import dataclasses
import functools
import json
import math
import weakref

import jax
import numpy as np
import pytest

import repro.configs as jcfg
import repro.models as jm
import repro.obs as jobs
import repro.serve as jserve
from repro.core.roofline import hardware as jhw
from repro.obs import metrics as jmet
from repro.obs import trace as jtr
from repro.serve import scheduler as jsch
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.obs as tobs
import repro_torch.serve as tserve
from repro_torch import bridge
from repro_torch.core.roofline import hardware as thw
from repro_torch.kernels import paged_attention as tpa
from repro_torch.obs import attainment as tatt
from repro_torch.obs import metrics as tmet
from repro_torch.obs import trace as ttr
from repro_torch.serve import engine as teng_mod
from repro_torch.serve import kv_cache as tkv_mod
from repro_torch.serve import scheduler as tsch
from repro_torch.serve import spec as tspec_mod

REL = 1e-12


# --------------------------------------------------------------------------
# tracer
# --------------------------------------------------------------------------

def _trace_script(mod):
    """One fixed sequence of Tracer calls covering every event kind."""
    tr = mod.Tracer(epoch=10.0)
    tr.process(0, "engine")
    tr.process(0, "engine (renamed)")               # re-announce
    tr.thread(0, mod.ENGINE_TID, "steps")
    tr.thread(0, mod.ENGINE_TID, "steps again")     # de-duplicated
    tr.thread(0, mod.LIFECYCLE_TID, "lifecycle")
    tr.thread(0, mod.SLOT_TID0 + 1, "slot 1")
    tr.span("decode_step", 0, mod.ENGINE_TID, 10.001, 10.0045, batch=3)
    tr.span("inner", 0, mod.ENGINE_TID, 10.002, 10.003)
    tr.span("pre", 0, mod.ENGINE_TID, 9.0, 9.5)      # before the epoch
    tr.span("backward", 0, mod.SLOT_TID0 + 1, 10.02, 10.01)
    tr.instant("submit", 0, mod.LIFECYCLE_TID, 10.0001, request=7)
    tr.counter("pool_pages", 0, 10.003, {"in_use": 5})
    tr.async_begin("request", 0, mod.LIFECYCLE_TID, 7, 10.0001)
    tr.async_end("request", 0, mod.LIFECYCLE_TID, 7, 10.05, tokens=4,
                 reason="length")
    tr.flow_start("migrate", 0, mod.LIFECYCLE_TID, 3, 10.01, link="dcn")
    tr.flow_finish("migrate", 0, mod.LIFECYCLE_TID, 3, 10.04)
    return tr


def test_tracer_export_equals_reference(tmp_path):
    got = _trace_script(ttr).export(str(tmp_path / "t.json"))
    want = _trace_script(jtr).export()
    assert got == want
    assert json.loads((tmp_path / "t.json").read_text()) == want
    assert ttr.validate_trace(got) == jtr.validate_trace(want) == []
    assert (ttr.ENGINE_TID, ttr.LIFECYCLE_TID, ttr.SLOT_TID0,
            ttr.ROUTER_PID) == (jtr.ENGINE_TID, jtr.LIFECYCLE_TID,
                                jtr.SLOT_TID0, jtr.ROUTER_PID)


def _named(events):
    meta = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "ts": 0, "args": {"name": "e"}}]
    for tid in (0, 1):
        meta.append({"ph": "M", "name": "thread_name", "pid": 0,
                     "tid": tid, "ts": 0, "args": {"name": str(tid)}})
    return {"displayTimeUnit": "ms", "traceEvents": meta + events}


def _x(name, ts, dur, tid=0):
    return {"ph": "X", "name": name, "pid": 0, "tid": tid, "ts": ts,
            "dur": dur}


MALFORMED = {
    "not_a_dict": [],
    "no_events": {"traceEvents": []},
    "no_time_unit": {"traceEvents": [_x("a", 1.0, 1.0)]},
    "missing_keys": {"displayTimeUnit": "ms",
                     "traceEvents": [{"ph": "X", "name": "x"}]},
    "bad_ts": _named([_x("a", -1.0, 1.0), _x("b", float("nan"), 1.0)]),
    "bad_dur": _named([_x("a", 1.0, -2.0), _x("b", 1.0, None)]),
    "partial_overlap": _named([_x("a", 1.0, 2.0), _x("b", 2.0, 2.0)]),
    "nesting_is_fine": _named([_x("a", 1.0, 3.0), _x("b", 2.0, 1.0)]),
    "unknown_phase": _named([{"ph": "Q", "name": "q", "pid": 0, "tid": 0,
                              "ts": 1.0}]),
    "unnamed_tracks": {"displayTimeUnit": "ms", "traceEvents": [
        {"ph": "i", "name": "submit", "pid": 3, "tid": 7, "ts": 1.0}]},
    "orphan_async": _named([{"ph": "b", "name": "request", "pid": 0,
                             "tid": 1, "id": 1, "ts": 1.0}]),
    "async_end_first": _named([
        {"ph": "b", "name": "request", "pid": 0, "tid": 1, "id": 2,
         "ts": 5.0},
        {"ph": "e", "name": "request", "pid": 0, "tid": 1, "id": 2,
         "ts": 1.0}]),
    "orphan_flow": _named([{"ph": "s", "name": "migrate", "pid": 0,
                            "tid": 1, "id": 9, "ts": 1.0}]),
    "flow_finish_first": _named([
        {"ph": "s", "name": "migrate", "pid": 0, "tid": 1, "id": 4,
         "ts": 5.0},
        {"ph": "f", "name": "migrate", "pid": 0, "tid": 1, "id": 4,
         "ts": 1.0}]),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_validator_verdicts_equal_reference(case):
    doc = MALFORMED[case]
    want = jtr.validate_trace(doc)
    assert ttr.validate_trace(doc) == want
    assert (want == []) == (case == "nesting_is_fine")


# --------------------------------------------------------------------------
# metrics registry
# --------------------------------------------------------------------------

def _labels_and_escapes(m):
    reg = m.Registry()
    c = reg.counter("serve_x_total", "things", ("kind", "where"))
    c.inc(2.0, kind="a", where="b")
    c.inc(kind="a", where="b")
    c.inc(0.5, kind='q"uote', where="new\nline\\slash")
    reg.gauge("serve_g", "").set(1.5)
    return reg


def _histograms(m):
    reg = m.Registry()
    h = reg.histogram("serve_lat_seconds", "latency", ("segment",),
                      buckets=(1.0, 0.1, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0, float("inf")):
        h.observe(v, segment="total")
    h.observe(0.2, segment="prefill")
    reg.histogram("serve_itl_seconds", "gaps").observe(3e-3)
    return reg


def _gauges_and_totals(m):
    reg = m.Registry()
    g = reg.gauge("serve_binding", "one-hot", ("roof",))
    g.set(1.0, roof="hbm")
    g.clear()
    g.set(1.0, roof="vmem")
    reg.gauge("serve_nan", "a NaN").set(float("nan"))
    reg.gauge("serve_inf", "an inf").set(float("inf"))
    t = reg.counter("serve_total", "cumulative")
    t.set_total(5)
    t.set_total(3.0)                         # never rewinds
    t.set_total(7)
    reg.counter("serve_total", "cumulative")  # create-or-get
    return reg


def _empty(m):
    return m.Registry()


@pytest.mark.parametrize("script", [_labels_and_escapes, _histograms,
                                    _gauges_and_totals, _empty],
                         ids=lambda f: f.__name__.strip("_"))
def test_registry_exposition_equals_reference(script):
    assert script(tmet).expose() == script(jmet).expose()


@pytest.mark.parametrize("misuse", ["negative_inc", "wrong_labels",
                                    "kind_clash"])
def test_registry_refuses_what_the_reference_refuses(misuse):
    for m in (tmet, jmet):
        reg = m.Registry()
        c = reg.counter("serve_c_total", "c", ("kind",))
        if misuse == "negative_inc":
            with pytest.raises(ValueError, match="only go up"):
                c.inc(-1.0, kind="a")
        elif misuse == "wrong_labels":
            with pytest.raises(ValueError, match="labels"):
                c.inc(1.0, other="a")
        else:
            with pytest.raises(TypeError, match="already registered"):
                reg.gauge("serve_c_total")


# --------------------------------------------------------------------------
# attainment tracker: duck-typed engines, fixed ledgers, fixed clock
# --------------------------------------------------------------------------

def _chips():
    """A chip with the same numbers in each package, every level priced."""
    kw = dict(name="probe", peak_flops=7e14,
              peak_flops_by_dtype={"bfloat16": 7e14, "float32": 6e13},
              hbm_bw=3e12, hbm_bytes=80 * 10**9, vmem_bw=9e12,
              host_bw=5e10, ici_bw=4e11, dcn_bw=2.5e10)
    j = jhw.ChipSpec(ici_links=1, vmem_bytes=50 * 10**6, **kw)
    return j, thw.ChipSpec(**kw)


def _ledger_stream(sch, cfg, n):
    """``n + 1`` cumulative aggregate ledgers of one decode stream: each
    step adds decode tokens (a verify step every third) and now and then
    a swap, at growing context."""
    led = sch.RooflineLedger()
    out = [dataclasses.replace(led)]
    for i in range(n):
        ctx, batch = 20 + 3 * i, 1 + i % 4
        if i % 3 == 2:
            led.add_verify_step(cfg, ctx, 4, 3, 2, 3, batch,
                                vmem_bytes=1.5e6 * (i + 1))
        elif i % 5 != 4:                     # i % 5 == 4: admission only
            for _ in range(batch):
                led.add_decode_token(cfg, ctx, batch,
                                     vmem_bytes=1e6 * (i + 1))
        if i == 6:
            led.swap_bytes += 3.0e6
        out.append(dataclasses.replace(led))
    return out


class _DuckEngine:
    def __init__(self, cfg, chip, ledgers):
        self.cfg = cfg
        self.ecfg = type("E", (), {"chip": chip})()
        self._ledgers = iter(ledgers)

    def aggregate_ledger(self):
        return next(self._ledgers)

    def _ledger_chips(self):
        return 1


def _windows(obs_mod, sch, cfg, chip, monkeypatch, n=14, window=3):
    stamps = iter(0.25 + 0.004 * i + 1e-4 * i * i for i in range(1000))
    monkeypatch.setattr(obs_mod.clock, "now", lambda: next(stamps))
    reg = obs_mod.Registry()
    tracker = obs_mod.AttainmentTracker(window_steps=window)
    lead = _ledger_stream(sch, cfg, n)
    # tick() reads a ledger at the baseline and at each close: feed the
    # ledger of the step that just ended
    eng = _DuckEngine(cfg, chip, [])
    for i in range(n):
        eng._ledgers = iter([lead[i + 1]] * 2)
        w = tracker.tick(eng, pid=2)
        if w is not None:
            tracker.publish(reg, w)
    w = tracker.flush(eng, pid=2)
    if w is not None:
        tracker.publish(reg, w)
    return tracker.windows, reg.expose()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_attainment_windows_equal_reference(arch, monkeypatch):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    jchip, tchip = _chips()
    want, want_text = _windows(jobs, jsch, jc, jchip, monkeypatch)
    got, got_text = _windows(tobs, tsch, tc, tchip, monkeypatch)
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert (g.index, g.pid, g.tokens, g.binding_roof) == (
            w.index, w.pid, w.tokens, w.binding_roof)
        assert g.dt_s == pytest.approx(w.dt_s, rel=REL)
        assert g.flops_per_s == pytest.approx(w.flops_per_s, rel=REL)
        for a, b in ((g.roofs, w.roofs), (g.attainment, w.attainment),
                     (g.bytes_per_s, w.bytes_per_s)):
            assert set(a) == set(b)
            for k in b:
                assert a[k] == pytest.approx(b[k], rel=REL), k
        assert g.fraction == pytest.approx(w.fraction, rel=REL)
    assert {w.binding_roof for w in got} >= {"hbm"}
    assert got_text == want_text


def test_ledger_delta_is_generic_over_fields():
    a, b = tsch.RooflineLedger(), tsch.RooflineLedger()
    cfg = tcfg.smoke(tcfg.get_config("qwen3-0.6b"))
    a.add_decode_token(cfg, 10, 2, vmem_bytes=5.0)
    b.add_decode_token(cfg, 10, 2, vmem_bytes=5.0)
    b.add_decode_token(cfg, 11, 2, vmem_bytes=7.0)
    b.migration_link = "ici"
    d = tatt._ledger_delta(b, a)
    for f in dataclasses.fields(tsch.RooflineLedger):
        if isinstance(getattr(b, f.name), str):   # the link: carried
            assert getattr(d, f.name) == getattr(b, f.name)
            continue
        assert getattr(d, f.name) == getattr(b, f.name) - getattr(a, f.name)
    assert d.decode_tokens == 1 and d.decode_vmem_bytes == 7.0
    assert d.migration_link == "ici"


def test_tracker_refuses_empty_windows():
    with pytest.raises(ValueError):
        tatt.AttainmentTracker(window_steps=0)


# --------------------------------------------------------------------------
# Request latency stamps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_tokens", [0, 1, 5])
def test_latency_stats_and_breakdown_equal_reference(n_tokens):
    stamps = dict(submit_time=1.0, prefill_start_time=1.25,
                  prefill_end_time=1.5)
    times = [1.75 + 0.01 * i * i for i in range(n_tokens)]
    j = jsch.Request(prompt=np.zeros(3, np.int32), token_times=list(times),
                     **stamps)
    t = tsch.Request(prompt=np.zeros(3, np.int32), token_times=list(times),
                     **stamps)
    for got, want in ((t.ttft_breakdown(), j.ttft_breakdown()),
                      (t.latency_stats(), j.latency_stats())):
        assert set(got) == set(want)
        for k in want:
            assert (math.isnan(got[k]) and math.isnan(want[k])) or \
                got[k] == want[k], k
    if n_tokens:
        assert sum(t.ttft_breakdown().values()) == pytest.approx(t.ttft,
                                                                 abs=1e-12)


# --------------------------------------------------------------------------
# engines, eager on the CPU
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model():
    jc = jcfg.smoke(jcfg.get_config("qwen3-0.6b"))
    tc = tcfg.smoke(tcfg.get_config("qwen3-0.6b"))
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.prepare_params(
        bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu"), tc)
    return jc, tc, jp, tp


def _prompts(cfg, n=3, repetitive=False):
    rng = np.random.RandomState(700)
    out = []
    for i in range(n):
        if repetitive:
            out.append(np.tile(rng.randint(0, cfg.vocab_size, 3), 4)
                       .astype(np.int32))
        else:
            out.append(rng.randint(0, cfg.vocab_size, 5 + i)
                       .astype(np.int32))
    return out


ECFG = dict(num_slots=2, page_size=4, max_len=32)


def _scfg(mod, cfg, params, proposer):
    if proposer == "draft":
        return mod.SpecConfig(k=3, proposer="draft", draft_cfg=cfg,
                              draft_params=params)
    return mod.SpecConfig(k=3, proposer="ngram")


def _port_run(telemetry, proposer=None, **ecfg_kw):
    """Serve the prompts on the port; returns the engine, the streams,
    the synchronize calls made and each paged kernel's launches."""
    _, tc, _, tp = _model()
    ecfg = tserve.EngineConfig(device="cpu", telemetry=telemetry,
                               telemetry_window=2, **{**ECFG, **ecfg_kw})
    eng = (tserve.SpecEngine(tc, tp, ecfg, _scfg(tserve, tc, tp, proposer))
           if proposer else tserve.Engine(tc, tp, ecfg))
    reqs = [eng.submit(p, tserve.GenerateConfig(max_new_tokens=6))
            for p in _prompts(tc, repetitive=proposer == "ngram")]
    kernels = [tpa.paged_attention, tpa.paged_attention_verify,
               tpa.paged_attention_ring]
    for k in kernels:
        k.launches = 0
    syncs = _count_syncs.calls = 0
    eng.run()
    syncs = _count_syncs.calls
    return (eng, [list(r.generated) for r in reqs], syncs,
            [k.launches for k in kernels], reqs)


def _count_syncs(device):
    _count_syncs.calls += 1


_count_syncs.calls = 0


@pytest.fixture
def counted_syncs(monkeypatch):
    for mod in (teng_mod, tspec_mod, tkv_mod):
        monkeypatch.setattr(mod, "synchronize", _count_syncs)


def _ref_events(proposer=None):
    """Event (phase, name) counts of the reference engine's trace on the
    same requests."""
    jc, _, jp, _ = _model()
    ecfg = jserve.EngineConfig(telemetry=True, telemetry_window=2, **ECFG)
    eng = (jserve.SpecEngine(jc, jp, ecfg, _scfg(jserve, jc, jp, proposer))
           if proposer else jserve.Engine(jc, jp, ecfg))
    reqs = [eng.submit(p, jserve.GenerateConfig(max_new_tokens=6))
            for p in _prompts(jc, repetitive=proposer == "ngram")]
    eng.run()
    doc = eng.obs.export_trace()
    return (collections.Counter((e["ph"], e["name"])
                                for e in doc["traceEvents"]),
            [[int(x) for x in r.generated] for r in reqs])


@pytest.mark.parametrize("proposer", [None, "ngram", "draft"],
                         ids=["engine", "spec-ngram", "spec-self-draft"])
def test_engine_telemetry_is_observation_only(proposer, counted_syncs):
    _, base, syncs_off, launches_off, _ = _port_run(False, proposer)
    eng, traced, syncs_on, launches_on, reqs = _port_run(True, proposer)
    assert traced == base
    assert launches_on == launches_off
    assert syncs_on == syncs_off > 0
    doc = eng.obs.export_trace()
    assert ttr.validate_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"prefill_chunk", "submit", "place", "first_token",
            "request"} <= names
    assert ({"propose", "verify"} if proposer else {"decode_step"}) <= names
    spans = collections.Counter(e["name"] for e in doc["traceEvents"]
                                if e["ph"] == "X")
    if proposer:
        assert spans["verify"] == spans["propose"] == eng.verify_steps
    else:
        assert spans["decode_step"] == eng.decode_steps
    for r in reqs:
        assert sum(r.ttft_breakdown().values()) == pytest.approx(
            r.ttft, abs=1e-9)
    eng.obs.harvest(eng)
    text = eng.obs.snapshot()
    total = eng.aggregate_ledger().decode_tokens
    assert f"serve_decode_tokens_total {float(total)!r}" in text
    assert total == sum(len(s) - 1 for s in traced)


@pytest.mark.parametrize("proposer", [None, "ngram"],
                         ids=["engine", "spec-ngram"])
def test_trace_events_count_as_the_reference(proposer):
    want, jstreams = _ref_events(proposer)
    eng, streams, _, _, _ = _port_run(True, proposer)
    assert streams == jstreams
    got = collections.Counter((e["ph"], e["name"])
                              for e in eng.obs.export_trace()["traceEvents"])
    assert got == want


def test_harvest_is_idempotent_and_names_the_binding_roof():
    eng, _, _, _, _ = _port_run(True)
    eng.obs.harvest(eng)
    text = eng.obs.snapshot()
    for fam in ("serve_decode_tokens_total", 'serve_flops_total{phase="decode"}',
                'serve_level_bytes_total{level="hbm"}',
                "serve_kv_bytes_total", "serve_pool_pages_in_use",
                "serve_itl_seconds_count", "serve_roofline_attainment{level=",
                "serve_roofline_binding{roof=", "serve_attained_flops_per_s"):
        assert fam in text, fam
    for seg in ("queue_wait", "prefill", "first_decode", "total"):
        assert f'serve_ttft_seconds_bucket{{segment="{seg}"' in text
    eng.obs.harvest(eng)
    assert eng.obs.snapshot() == text
    windows = eng.obs.attainment.windows
    assert windows
    for w in windows:
        assert w.binding_roof in w.roofs and w.dt_s > 0 and w.tokens > 0
        assert w.fraction == pytest.approx(max(w.attainment.values()))
        assert w.fraction == pytest.approx(
            w.flops_per_s / w.roofs[w.binding_roof])


def test_telemetry_default_off_leaves_no_hooks():
    _, tc, _, tp = _model()
    eng = tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu", **ECFG))
    assert eng.obs is None
    eng.submit(_prompts(tc, n=1)[0], tserve.GenerateConfig(max_new_tokens=4))
    eng.run()
    assert eng._sched.obs is None


def test_dropped_engine_frees_itself_with_telemetry_on():
    """The engine owns its bundle and nothing in the bundle refers back to
    the engine, so dropping the engine frees it (and its weights) without
    waiting for a garbage collection."""
    import gc
    gc.disable()
    try:
        eng, _, _, _, _ = _port_run(True)
        eng.obs.harvest(eng)
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_dispatch_twin_runs_without_telemetry():
    eng, _, _, _, _ = _port_run(True)
    n_events = len(eng.obs.tracer.events)
    assert eng.measure_dispatch_overhead(repeats=2) > 0
    assert len(eng.obs.tracer.events) == n_events


def test_preemption_spans_validate():
    """Swap preemption under a small pool: swap_out / swap_in spans and
    preempt instants land on their tracks and the trace still validates;
    streams equal telemetry off."""
    kw = dict(num_pages=6, max_len=24)
    _, base, _, _, _ = _port_run(False, **kw)
    eng, traced, _, _, _ = _port_run(True, **kw)
    assert traced == base
    assert eng._sched.preempt_count > 0
    doc = eng.obs.export_trace()
    assert ttr.validate_trace(doc) == []
    names = collections.Counter(e["name"] for e in doc["traceEvents"])
    assert names["preempt"] == eng._sched.preempt_count
    assert names["swap_out"] == names["swap_in"] == names["preempt"]
    eng.obs.harvest(eng)
    assert "serve_preemptions_total" in eng.obs.snapshot()
