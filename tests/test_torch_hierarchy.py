"""The port's hierarchical, time-based roofline core against the JAX
package's (``repro.core.roofline``), on the same inputs and a chip spec
with equal numbers in each package:

* ``RooflineTerms``: ``roofs``, ``binding_roof``, ``level_times``,
  ``t_overlapped``, ``t_lower`` / ``t_upper``, ``bound_class`` and the
  rest, from hand-set terms and from the same ledger (rel 1e-12);
* the time budget: ``time_attribution``, ``overlapped_budget`` and
  ``attribution_residual``;
* the report rows and tables, string for string;
* the unbound / unpriced conventions: a zero-byte level has no roof, no
  time and no inf / NaN cell; the data sheet's ``ici`` / ``dcn`` betas
  are NVLink's and one NIC's, and one card moves no bytes on them;
* the microbench's new per-level betas and overlap fractions: cache
  round trip, the schema guard (a foreign cache falls back to the data
  sheet without measuring), ``measure_ici_bandwidth`` None off a
  multi-card host, the data sheet's levels;
* ``Engine.hierarchy_report``'s level ladder equal to the reference
  engine's on the same requests.
"""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest

import repro.configs as jcfg
import repro.models as jm
import repro.serve as jserve
from repro.core.roofline import hardware as jhw
from repro.core.roofline import model as jmodel
from repro.core.roofline import report as jrep
from repro.serve import scheduler as jsch
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.serve as tserve
from repro_torch import bridge
from repro_torch.core.roofline import hardware as thw
from repro_torch.core.roofline import microbench as tmb
from repro_torch.core.roofline import model as tmodel
from repro_torch.core.roofline import report as trep
from repro_torch.serve import crosscheck as txc
from repro_torch.serve import scheduler as tsch

REL = 1e-12


def _chips(**over):
    """A chip with the same numbers in each package, every level priced."""
    kw = dict(name="probe", peak_flops=7e14,
              peak_flops_by_dtype={"bfloat16": 7e14, "float32": 6e13},
              hbm_bw=3e12, hbm_bytes=80 * 10**9, vmem_bw=9e12,
              host_bw=5e10, ici_bw=4e11, dcn_bw=2.5e10)
    kw.update(over)
    return (jhw.ChipSpec(ici_links=1, vmem_bytes=50 * 10**6, **kw),
            thw.ChipSpec(**kw))


def _both_terms(chips=None, **kw):
    jchip, tchip = chips or _chips()
    base = dict(dtype="bfloat16", flops_dev=3.2e9, hbm_bytes_dev=1.1e9,
                ici_wire_bytes_dev=0.0, dcn_wire_bytes_dev=0.0)
    base.update(kw)
    return (jmodel.make_terms(scope=jhw.chip_scope(jchip), **base),
            tmodel.make_terms(scope=thw.chip_scope(tchip), **base))


TERMS_CASES = {
    "hbm_only": {},
    "all_levels": dict(vmem_bytes_dev=2.3e9, host_bytes_dev=4e7,
                       ici_wire_bytes_dev=2e7, dcn_wire_bytes_dev=1e6,
                       model_flops_total=2.9e9),
    "compute_bound": dict(flops_dev=9e14, hbm_bytes_dev=1e8,
                          model_flops_total=9e14),
    "host_bound": dict(host_bytes_dev=8e8, vmem_bytes_dev=1e9),
    "vmem_bound": dict(vmem_bytes_dev=9e10),
    "overlap": dict(vmem_bytes_dev=2e9, host_bytes_dev=2e8,
                    overlap={"host": 0.7, "hbm": 1.0, "vmem": 0.3}),
    "overlap_clamped": dict(host_bytes_dev=3e8,
                            overlap={"host": 1.7, "hbm": -0.5}),
    "float32": dict(dtype="float32", flops_dev=4e12, vmem_bytes_dev=3e9),
    "zero_flops": dict(flops_dev=0.0, hbm_bytes_dev=5e8),
}


def _close(got, want, key=""):
    if want is None or isinstance(want, str):
        assert got == want, key
    elif isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            _close(got[k], want[k], f"{key}.{k}")
    elif isinstance(want, float) and math.isinf(want):
        assert got == want, key
    else:
        assert got == pytest.approx(want, rel=REL, abs=0.0), key


@pytest.mark.parametrize("case", sorted(TERMS_CASES))
def test_terms_equal_reference(case):
    j, t = _both_terms(**TERMS_CASES[case])
    for name in ("compute_s", "memory_s", "ici_s", "dcn_s", "vmem_s",
                 "host_s", "collective_s", "migration_s", "dominant",
                 "t_lower", "t_upper", "t_overlapped", "arithmetic_intensity",
                 "ridge_intensity", "attainable_flops",
                 "attainable_flops_comm", "binding_roof", "ici_intensity",
                 "dcn_intensity", "useful_ratio", "roofline_fraction",
                 "hardware_fraction"):
        _close(getattr(t, name), getattr(j, name), name)
    _close(t.roofs(), j.roofs(), "roofs")
    _close(t.level_times(), j.level_times(), "level_times")
    assert t.bound_class() == j.bound_class()
    for level in thw.MEMORY_LEVELS:
        _close(t.level_bytes(level), j.level_bytes(level), level)
        _close(t.level_intensity(level), j.level_intensity(level), level)
        _close(t.level_roof(level), j.level_roof(level), level)


@pytest.mark.parametrize("case", sorted(TERMS_CASES))
def test_report_rows_equal_reference(case):
    j, t = _both_terms(**TERMS_CASES[case])
    assert trep.terms_row("c", t) == jrep.terms_row("c", j)
    assert trep.comm_terms_row("c", t) == jrep.comm_terms_row("c", j)
    assert trep.migration_row("c", t) == jrep.migration_row("c", j)
    assert trep.hierarchy_rows("c", t) == jrep.hierarchy_rows("c", j)
    for header in ("TERMS_HEADER", "COMM_HEADER", "MIGRATION_HEADER",
                   "HIERARCHY_HEADER", "TIME_BUDGET_HEADER",
                   "TIME_BUDGET_OVERLAP_HEADER", "ATTAINMENT_HEADER"):
        assert getattr(trep, header) == getattr(jrep, header)
    rows = trep.hierarchy_rows("c", t)
    assert trep.text_table(rows, trep.HIERARCHY_HEADER) == \
        jrep.text_table(rows, jrep.HIERARCHY_HEADER)
    assert trep.markdown_table(rows, trep.HIERARCHY_HEADER) == \
        jrep.markdown_table(rows, jrep.HIERARCHY_HEADER)
    # render_report: the reference's lines, its HLO wording aside
    got = trep.render_report("c", t, extra=["x"]).splitlines()
    want = jrep.render_report("c", j, extra=["x"]).splitlines()
    assert [g for g in got if "model_flops/" not in g] == \
        [w for w in want if "model_flops/" not in w]


@pytest.mark.parametrize("arch,verify", [
    ("qwen3-0.6b", False), ("qwen3-0.6b", True), ("qwen3-14b", True),
    ("deepseek-v2-236b", False), ("deepseek-v2-236b", True),
    ("xlstm-350m", False), ("xlstm-350m", True),
    ("jamba-v0.1-52b", False), ("jamba-v0.1-52b", True)])
def test_terms_from_the_same_ledger_equal_reference(arch, verify):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    jl, tl = jsch.RooflineLedger(), tsch.RooflineLedger()
    for ctx, batch in [(17, 1), (60, 3), (200, 4), (511, 2)]:
        if verify:
            v = jsch.verify_step_vmem_bytes(jc, ctx, 5, batch, 16)
            jl.add_verify_step(jc, ctx, 5, 4, 3, 4, batch, vmem_bytes=v)
            tl.add_verify_step(tc, ctx, 5, 4, 3, 4, batch, vmem_bytes=v)
        else:
            v = jsch.decode_token_vmem_bytes(jc, ctx, batch, 16)
            jl.add_decode_token(jc, ctx, batch, vmem_bytes=v)
            tl.add_decode_token(tc, ctx, batch, vmem_bytes=v)
    jl.swap_bytes = tl.swap_bytes = 6.5e6
    for f in ("decode_flops", "decode_bytes", "decode_kv_bytes",
              "decode_vmem_bytes"):
        assert getattr(tl, f) == getattr(jl, f), f
    jchip, tchip = _chips()
    j, t = jl.terms(jc, jchip, n_chips=1), tl.terms(tc, tchip, n_chips=1)
    for name in ("t_lower", "t_upper", "t_overlapped", "binding_roof",
                 "roofline_fraction", "attainable_flops_comm"):
        _close(getattr(t, name), getattr(j, name), name)
    _close(t.roofs(), j.roofs(), "roofs")
    _close(t.level_times(), j.level_times(), "level_times")
    assert t.bound_class() == j.bound_class()
    assert trep.hierarchy_rows("d", t) == jrep.hierarchy_rows("d", j)
    # the tensor-parallel scope: weights and FLOPs split, KV by the
    # shard fraction, equal to the reference's
    j2, t2 = jl.terms(jc, jchip, n_chips=2), tl.terms(tc, tchip, n_chips=2)
    assert t2.scope == j2.scope == "tp2" and t2.n_chips == 2
    for name in ("hbm_bytes_dev", "flops_dev", "t_lower", "t_upper",
                 "binding_roof"):
        _close(getattr(t2, name), getattr(j2, name), name)
    _close(t2.level_times(), j2.level_times(), "level_times")


def _phases(mod):
    out = {"prefill": mod.PhaseTraffic(), "decode": mod.PhaseTraffic(),
           "swap": mod.PhaseTraffic(), "idle": mod.PhaseTraffic()}
    out["prefill"].add(flops=4e12, hbm=2e9, wall_s=8e-3, tokens=128)
    out["decode"].add(flops=6e10, vmem=4e10, hbm=3e10, wall_s=1.4e-2,
                      steps=1, tokens=4)
    out["decode"].add(flops=6.2e10, vmem=4.1e10, hbm=3.1e10, wall_s=1.3e-2,
                      tokens=4)
    out["swap"].add(host=5e7, wall_s=2e-3)
    out["swap"].add(host=2e7, ici=1e6, dcn=3e5, wall_s=0.0, steps=0)
    return out


@pytest.mark.parametrize("overlap", [None, {}, {"host": 0.6, "hbm": 1.0},
                                     {"vmem": 2.0, "host": -1.0}])
@pytest.mark.parametrize("dispatch", [0.0, 3.4e-3])
def test_time_budget_equals_reference(overlap, dispatch):
    jchip, tchip = _chips()
    jb = jmodel.LevelBetas.from_chip(jchip, dtype="bfloat16",
                                     source="measured")
    tb = tmodel.LevelBetas.from_chip(tchip, dtype="bfloat16",
                                     source="measured")
    assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
    jp, tp = _phases(jmodel), _phases(tmodel)
    for name in jp:
        got = tmodel.time_attribution(tp[name], tb, dispatch)
        want = jmodel.time_attribution(jp[name], jb, dispatch)
        _close(got, want, name)
        _close(tmodel.overlapped_budget(got, overlap),
               jmodel.overlapped_budget(want, overlap), name)
        r_t = tmodel.attribution_residual(tp[name], tb, dispatch)
        r_j = jmodel.attribution_residual(jp[name], jb, dispatch)
        assert (math.isnan(r_t) and math.isnan(r_j)) or \
            r_t == pytest.approx(r_j, rel=REL)
    assert trep.time_budget_rows(tp, tb, dispatch, overlap) == \
        jrep.time_budget_rows(jp, jb, dispatch, overlap)


def test_attainment_rows_equal_reference():
    from repro.obs.attainment import AttainmentWindow as JW
    from repro_torch.obs.attainment import AttainmentWindow as TW
    kw = [dict(index=i, pid=0, t_end=1.0 + i, dt_s=0.05 * (i + 1),
               tokens=24 + i, flops_per_s=3e11 * (i + 1),
               bytes_per_s={"hbm": 2.1e12, "vmem": 2.9e12},
               roofs={"compute": 7e14, "hbm": 4e12 / (i + 1),
                      "vmem": 9e12},
               binding_roof="hbm",
               attainment={"compute": 4e-4, "hbm": 0.07 * (i + 1),
                           "vmem": 0.03})
          for i in range(3)]
    assert trep.attainment_rows([TW(**k) for k in kw]) == \
        jrep.attainment_rows([JW(**k) for k in kw])


def test_unbound_levels_render_unbound_and_finite():
    _, t = _both_terms()
    roofs = t.roofs()
    assert set(roofs) == {"compute", "hbm"}
    for level in ("vmem", "ici", "dcn", "host"):
        assert t.level_roof(level) is None
        assert t.level_times()[level] == 0.0
    assert t.binding_roof in roofs
    flat = " ".join(" ".join(r) for r in trep.hierarchy_rows("d", t))
    assert "inf" not in flat and "nan" not in flat
    assert "unbound" in trep.comm_terms_row("d", t)


def test_data_sheet_prices_no_card_link_and_leaves_vmem_unpriced():
    assert thw.MEMORY_LEVELS == jhw.MEMORY_LEVELS
    chip = thw.H100_SXM
    # the card-to-card and network links are data-sheet values (NVLink 4
    # each way, one 400 Gb/s NIC); one card moves no bytes on them
    assert (chip.level_bw("ici"), chip.level_bw("dcn")) == (450e9, 50e9)
    assert chip.level_bw("vmem") == 0.0 and chip.level_bw("host") == 64e9
    with pytest.raises(ValueError, match="unknown memory level"):
        chip.level_bw("l3")
    t = tmodel.make_terms(scope=thw.chip_scope(chip), dtype="bfloat16",
                          flops_dev=1e9, hbm_bytes_dev=1e9,
                          vmem_bytes_dev=2e9)
    # bytes on an unpriced level: counted, no roof, no time, no inf
    assert "vmem" not in t.roofs() and "vmem" not in t.terms()
    assert t.level_times()["vmem"] == 0.0 and t.level_roof("vmem") is None
    assert t.bound_class() == "memory-bound"
    b = tmodel.LevelBetas.from_chip(chip)
    assert (b.pi, b.ici, b.dcn, b.source) == (989e12, 450e9, 50e9,
                                              "analytic")
    times = tmodel.time_attribution(
        dataclasses.replace(tmodel.PhaseTraffic(), vmem=3e9, hbm=1e9),
        b)
    assert times["vmem"] == 0.0 and math.isfinite(sum(times.values()))


# --------------------------------------------------------------------------
# microbench: per-level betas and overlap
# --------------------------------------------------------------------------

def test_measured_levels_reach_the_chipspec_and_betas():
    res = tmb.MicrobenchResult(
        fma_flops=6e13, matmul_flops={"float32": 5e13, "bfloat16": 7.9e14},
        bandwidth={"copy": 3e12, "fill": 2.9e12, "triad": 3.1e12,
                   "best": 3.1e12},
        level_bw={"vmem": 7.5e12, "hbm": 3.1e12, "host": 5.2e10},
        overlap={"host": 0.85}, fingerprint={"device_kind": "card"})
    chip = res.to_chipspec()
    assert (chip.vmem_bw, chip.hbm_bw, chip.host_bw) == (7.5e12, 3.1e12,
                                                         5.2e10)
    # no probe reached the card-to-card link: the data sheet's stands
    assert (chip.ici_bw, chip.dcn_bw) == (thw.H100_SXM.ici_bw,
                                          thw.H100_SXM.dcn_bw)
    b = res.level_betas()
    assert (b.vmem, b.hbm, b.host, b.ici, b.source) == (
        7.5e12, 3.1e12, 5.2e10, thw.H100_SXM.ici_bw, "measured")
    # levels no probe reached fall back to the data sheet
    bare = dataclasses.replace(res, level_bw={})
    assert bare.level_betas().host == thw.H100_SXM.host_bw
    assert bare.to_chipspec().vmem_bw == thw.H100_SXM.vmem_bw
    an = tmb.MicrobenchResult.analytic()
    assert set(an.level_bw) == set(thw.MEMORY_LEVELS)
    assert an.to_chipspec().host_bw == thw.H100_SXM.host_bw


def test_cpu_probes(tmp_path):
    dev = tmb.resolve_device("cpu")
    assert tmb.measure_ici_bandwidth(dev) is None
    assert tmb.measure_compute_transfer_overlap(dev) == {}
    assert tmb.measure_cache_bandwidth(dev, nbytes=1 << 16, inner=4,
                                       repeats=2) > 0
    assert tmb.measure_host_link_bandwidth(dev, nbytes=1 << 16,
                                           repeats=2) > 0
    assert tmb._overlap_fraction(1.0, 0.5, 1.0) == 1.0
    assert tmb._overlap_fraction(1.0, 0.5, 1.5) == 0.0
    assert tmb._overlap_fraction(1.0, 0.5, 1.25) == pytest.approx(0.5)
    assert tmb._overlap_fraction(0.0, 0.5, 1.0) == 0.0


def test_cache_carries_levels_and_overlap(tmp_path):
    cache = tmp_path / "microbench.json"
    first = tmb.run_microbench(cache_path=cache, device="cpu")
    assert tmb.CACHE_SCHEMA == 2
    assert set(first.level_bw) == {"vmem", "hbm", "host"}
    assert all(v > 0 for v in first.level_bw.values())
    assert first.overlap == {}            # no second engine on the CPU
    again = tmb.run_microbench(cache_path=cache, device="cpu")
    assert again == first
    d = json.loads(cache.read_text())
    assert d["level_bw"] == first.level_bw


def test_foreign_schema_falls_back_without_measuring(tmp_path, monkeypatch):
    cache = tmp_path / "microbench.json"
    old = tmb.MicrobenchResult(
        fma_flops=1.0, matmul_flops={"float32": 1.0, "bfloat16": 1.0},
        bandwidth={"copy": 1.0, "fill": 1.0, "triad": 1.0, "best": 1.0},
        level_bw={"vmem": 1.0, "hbm": 1.0, "host": 1.0},
        fingerprint={"schema": tmb.CACHE_SCHEMA - 1, "device_kind": "cpu",
                     "n_devices": 1})
    cache.write_text(json.dumps(dataclasses.asdict(old)))
    before = cache.read_text()

    def refuse(*a, **k):
        raise AssertionError("measured again")
    for name in ("measure_peak_flops", "measure_peak_bandwidth",
                 "measure_cache_bandwidth", "measure_host_link_bandwidth",
                 "measure_compute_transfer_overlap"):
        monkeypatch.setattr(tmb, name, refuse)
    with pytest.warns(UserWarning, match="falling back to the analytic"):
        res = tmb.run_microbench(cache_path=cache, device="cpu")
    assert res.source == "analytic"
    assert res.level_betas().host == thw.H100_SXM.host_bw
    assert res.to_chipspec().hbm_bw == thw.H100_SXM.hbm_bw
    assert cache.read_text() == before


# --------------------------------------------------------------------------
# Engine.hierarchy_report against the reference engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    jc = jcfg.smoke(jcfg.get_config("qwen3-0.6b"))
    tc = tcfg.smoke(tcfg.get_config("qwen3-0.6b"))
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.prepare_params(
        bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu"), tc)
    return jc, tc, jp, tp


def test_hierarchy_report_ladder_equals_reference(qwen, monkeypatch):
    # the ledger's on-chip term is the CUDA kernels' count: the reference's
    # ledger is priced with the launch-grid walk of those kernels, so the
    # rest of it stays the baseline and the term is held against the walk
    monkeypatch.setattr(jsch, "attn_kernel_vmem_bytes",
                        txc.kernel_walk_vmem_bytes)
    jc, tc, jp, tp = qwen
    jchip, tchip = _chips()
    kw = dict(num_slots=2, page_size=4, max_len=32, prefill_chunk=3)
    jeng = jserve.Engine(jc, jp, jserve.EngineConfig(chip=jchip, **kw))
    teng = tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu",
                                                     chip=tchip, **kw))
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, tc.vocab_size, n).astype(np.int32)
               for n in (5, 9, 7)]
    for eng, mod in ((jeng, jserve), (teng, tserve)):
        for p in prompts:
            eng.submit(p, mod.GenerateConfig(max_new_tokens=5))
        eng.run()
    got = teng.hierarchy_report().split("-- time budget")[0]
    want = jeng.hierarchy_report().split("-- time budget")[0]
    assert got == want
    assert "vmem" in got and "host" in got
    # the time table: one row a phase and a total, with the overlap
    # columns when fractions are given
    report = teng.hierarchy_report(overlap={"host": 0.5})
    tail = report.split("-- time budget")[1].splitlines()
    assert tail[1].split() == trep.TIME_BUDGET_OVERLAP_HEADER
    assert [r.split()[0] for r in tail[3:]] == ["prefill", "decode",
                                               "total"]
    assert teng.roofline_terms(teng._sched.finished[0]).binding_roof == \
        jeng.roofline_terms(jeng._sched.finished[0]).binding_roof
