"""The port's production-mesh dry run on the CPU (no card): the fake
process group and the production meshes, ``launch/dryrun.py::run_cell``
on smoke configs (2 layers, 4 heads) at the reference's mesh shapes and
real ``SHAPES`` (fake tensors: nothing is allocated), one cell per
status, the archive re-priced by ``launch/reanalyze.py`` (its own numbers
exactly, then under a patched pricing rule in a process that imports no
model), the counterpart of ``tests/test_dryrun_small.py``'s mini dry run,
and the two tables' rows against the reference modules' rows on the same
JSON files (theirs and ``reanalyze.RESULTS_DIR`` pointed at a tmp dir;
``benchmarks/`` is not edited), and ``--chip measured`` reading the
card's microbench cache on this host, never measuring the CPU.

Every rank of a fake world is this process; collectives return at once
and move nothing, but are dispatched, so the walk attributes them.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.configs as tcfg
from repro_torch.core.analysis import analyze_step
from repro_torch.launch import arch_roofline, dryrun, perf_table, reanalyze
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_production_mesh, mesh_name
from repro_torch.models.common import SHAPES, LocalLayout, ShapeCell
from repro_torch.parallel.mesh import fake_world, make_host_mesh
from repro_torch.train.step import (TrainConfig, make_train_step,
                                    train_local_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke(arch: str):
    return tcfg.smoke(tcfg.get_config(arch))


@pytest.fixture
def results(tmp_path, monkeypatch):
    """The results dir (``reanalyze.RESULTS_DIR``, which every launch
    module reads) in a tmp dir, and the dry run on smoke configs."""
    d = str(tmp_path / "dryrun_torch")
    monkeypatch.setattr(reanalyze, "RESULTS_DIR", d)
    monkeypatch.setattr(dryrun, "get_config", smoke)
    return d


# --------------------------------------------------------------------------
# the fake world and the production meshes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("multi,ranks", [(False, (0, 17, 255)),
                                         (True, (0, 273, 511))],
                         ids=["pod", "multipod"])
def test_production_mesh_coordinates_and_groups(multi, ranks):
    names = ("pod", "data", "model") if multi else ("data", "model")
    shape = (2, 16, 16) if multi else (16, 16)
    world = 512 if multi else 256
    for r in ranks:
        with make_production_mesh(multi_pod=multi, rank=r) as mesh:
            assert dist.get_backend() == "fake"
            assert dist.get_world_size() == world and dist.get_rank() == r
            assert mesh.axis_names == names and mesh.shape == shape
            assert mesh.rank == r and mesh_name(mesh) == (
                "multipod" if multi else "pod")
            coords = dict(zip(names, (int(c) for c in
                                      np.unravel_index(r, shape))))
            for axis in names:
                assert mesh.coord(axis) == coords[axis]
                g = mesh.group(axis)
                members = dist.get_process_group_ranks(g)
                assert len(members) == mesh.sizes[axis]
                assert r in members and dist.get_rank(g) == coords[axis]
                # the row through r along the axis: the other coords fixed
                stride = int(np.prod(shape[names.index(axis) + 1:]))
                start = r - coords[axis] * stride
                assert members == [start + i * stride
                                   for i in range(mesh.sizes[axis])]
        assert not dist.is_initialized()


def test_fake_world_refuses_a_live_group():
    with fake_world(4, rank=1):
        with pytest.raises(RuntimeError, match="already initialized"):
            with fake_world(4):
                pass
        with pytest.raises(RuntimeError, match="already initialized"):
            with make_production_mesh():
                pass
        assert dist.get_world_size() == 4
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with fake_world(4, rank=4):
            pass


@pytest.mark.parametrize("arch", ["qwen3-14b", "minicpm-2b", "minitron-4b",
                                  "whisper-small"])
def test_heads_that_do_not_divide_16_run_context_parallel(arch):
    cfg = tcfg.get_config(arch)
    assert cfg.n_heads % 16
    with make_production_mesh() as mesh:
        local = train_local_config(cfg, mesh)
    assert local.layout == LocalLayout(context_parallel=True)
    assert (local.n_heads, local.n_kv_heads) == (cfg.n_heads, cfg.n_kv_heads)
    assert local.d_ff == cfg.d_ff // 16


# --------------------------------------------------------------------------
# run_cell: one cell per status
# --------------------------------------------------------------------------

def _reference_keys():
    """The reference's ``AnalysisReport.as_dict`` keys (a report built by
    hand: the keys do not depend on the numbers)."""
    from repro.core.analysis import AnalysisReport
    from repro.core.roofline import make_terms, scope_for_mesh
    from repro.core.roofline.extract import MemoryFootprint, StepCharacter
    from repro.core.roofline.hlo import CollectiveSummary
    char = StepCharacter(1.0, 1.0, 0.0,
                         CollectiveSummary(0.0, 0.0, 0.0, {}, {}, 0, []),
                         MemoryFootprint(0, 0, 0, 0), {}, {})
    terms = make_terms(scope=scope_for_mesh({"data": 1, "model": 1}),
                       dtype="bfloat16", flops_dev=1.0, hbm_bytes_dev=1.0,
                       ici_wire_bytes_dev=0.0, dcn_wire_bytes_dev=0.0,
                       model_flops_total=1.0)
    return set(AnalysisReport("x", char, terms, 0.0, {}).as_dict())


# (arch, shape, multi_pod, variant) -> the status it must have
CELLS = {
    ("qwen3-14b", "train_4k", True, "baseline"): "ok",
    ("qwen3-14b", "prefill_32k", False, "baseline"): "ok",
    ("qwen3-14b", "long_500k", False, "baseline"): "skipped",
    ("qwen3-14b", "decode_32k", False, "baseline"): "ok",
    ("xlstm-350m", "train_4k", False, "baseline"): "not_ported",
    ("qwen3-14b", "train_4k", False, "bogus"): "error",
}


def _path(d: str, arch: str, shape: str, multi: bool, variant: str) -> str:
    suffix = "" if variant == "baseline" else f"__{variant}"
    return os.path.join(d, f"{arch}__{shape}__"
                        f"{'multipod' if multi else 'pod'}{suffix}.json")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Every CELLS entry walked once (smoke configs, 2 layers each), in
    a module-wide tmp results dir: {key: result}, and that dir."""
    d = str(tmp_path_factory.mktemp("cells") / "dryrun_torch")
    patch = pytest.MonkeyPatch()
    patch.setattr(reanalyze, "RESULTS_DIR", d)
    patch.setattr(dryrun, "get_config", smoke)
    out = {}
    try:
        for multi in (False, True):
            with make_production_mesh(multi_pod=multi) as mesh:
                for key in CELLS:
                    arch, shape, m, variant = key
                    if m == multi:
                        out[key] = dryrun.run_cell(
                            arch, shape, mesh, variant=variant,
                            verbose=False)
    finally:
        patch.undo()
    return out, d


@pytest.mark.parametrize("key", list(CELLS), ids=lambda k: "/".join(
    (k[0], k[1], "multipod" if k[2] else "pod", k[3])))
def test_run_cell_status(cells, key):
    res = cells[0][key]
    assert res["status"] == CELLS[key], res
    assert res["arch"] == key[0] and res["shape"] == key[1]
    if res["status"] == "not_ported":
        assert "item 21" in res["reason"]
    if res["status"] == "skipped":
        assert res["reason"] == "quadratic full attention; see DESIGN.md §5"
    if res["status"] == "error":
        assert "bogus" in res["error"] and "Traceback" in res["traceback"]
    with open(_path(cells[1], *key)) as f:
        assert json.load(f) == json.loads(json.dumps(res, default=float))


@pytest.mark.parametrize("key", [k for k, v in CELLS.items() if v == "ok"],
                         ids=lambda k: f"{k[1]}/{'multipod' if k[2] else 'pod'}")
def test_ok_cell_keys_links_and_flops(cells, key):
    from repro.configs import get_config as jget, smoke as jsmoke
    from repro.launch.specs import cell_flops as ref_cell_flops
    res = cells[0][key]
    want = _reference_keys() - {"compile_seconds"} | {"walk_seconds"}
    assert want <= set(res), want - set(res)
    extra = set(res) - want
    assert extra <= {"status", "arch", "shape", "variant", "chip", "rank",
                     "tp_wire_model_bytes", "bytes_by_category"}, extra
    arch, shape, multi, _ = key
    axes = res["collective_by_axes"]
    assert axes.get("model", 0) > 0
    ici = sum(v for k, v in axes.items() if k in ("model", "data"))
    assert res["collective_ici_bytes_dev"] == pytest.approx(ici, rel=1e-12)
    assert res["collective_dcn_bytes_dev"] == pytest.approx(
        axes.get("pod", 0.0), rel=1e-12, abs=0)
    if multi and SHAPES[shape].kind == "train":
        assert axes["pod"] > 0
    # MODEL_FLOPS exactly the reference's cell_flops
    ref = ref_cell_flops(jsmoke(jget(arch)), SHAPES[shape])
    assert res["model_flops_total"] == ref
    assert res["n_chips"] == (512 if multi else 256)
    if "tp_wire_model_bytes" in res:
        assert axes["model"] == pytest.approx(res["tp_wire_model_bytes"],
                                              rel=1e-12)
    # the walk's record is archived beside the JSON
    assert os.path.exists(reanalyze.archive_path(_path(cells[1], *key)))


def test_prefill_specs_are_one_ranks_blocks():
    cfg = smoke("qwen3-14b")
    cell = SHAPES["prefill_32k"]
    with make_production_mesh(multi_pod=True, rank=300) as mesh:
        args, in_specs, out_specs = tspecs.prefill_specs(cfg, cell, mesh)
        tokens = args[1]
        assert tuple(tokens.shape) == (cell.global_batch // 32,
                                       cell.seq_len)
        wq = args[0]["segments"][0]["b0"]["mixer"]["wq"]
        # 4 heads do not divide model 16: wq whole on every rank
        assert tuple(wq.shape) == (2, cfg.d_model, cfg.n_heads, cfg.hd)
        w_up = args[0]["segments"][0]["b0"]["ffn"]["w_up"]
        assert tuple(w_up.shape) == (2, cfg.d_model, cfg.d_ff // 16)
        k_spec = out_specs[1][0]["b0"]["k"]
        # (layers, batch, kv_seq, kv_heads, head_dim): lines on model
        assert k_spec == (None, ("pod", "data"), "model")


# --------------------------------------------------------------------------
# the counterpart of tests/test_dryrun_small.py's mini dry run
# --------------------------------------------------------------------------

def test_mini_dryrun_with_collective_attribution():
    cfg = smoke("qwen3-0.6b")
    with fake_world(8, rank=5):
        mesh = make_host_mesh(data=2, model=2, pod=2)
        cell = ShapeCell("t", 32, 8, "train")
        args, _, _ = tspecs.train_specs(cfg, cell, mesh)
        report = analyze_step(make_train_step(cfg, TrainConfig(), mesh),
                              args=args, mesh=mesh, label="mini")
    d = report.as_dict()
    assert d["flops_dev"] > 0
    assert d["n_collective_ops"] > 0, "a sharded step must dispatch some"
    axes = d["collective_by_axes"]
    assert any("model" in k for k in axes), axes
    # the pod axis carries the gradient reduce -> DCN bytes > 0
    assert d["collective_dcn_bytes_dev"] > 0, axes


# --------------------------------------------------------------------------
# reanalyze
# --------------------------------------------------------------------------

def test_reanalyze_gives_the_walks_own_numbers(results):
    with make_production_mesh() as mesh:
        res = dryrun.run_cell("qwen3-14b", "train_4k", mesh, verbose=False)
    path = dryrun.result_path("qwen3-14b", "train_4k", "pod")
    assert res["status"] == "ok"
    assert reanalyze.reanalyze_cell(path, dryrun.chip_spec("sheet"))
    with open(path) as f:
        again = json.load(f)
    want = json.loads(json.dumps(res, default=float))
    for k, v in want.items():
        if k != "walk_seconds":
            assert again[k] == v, k
    assert again["walk_seconds"] == want["walk_seconds"]
    assert reanalyze.main([]) == 0


_PATCHED = textwrap.dedent("""
    import json, sys
    from repro_torch.core.roofline import op_cost
    from repro_torch.launch import reanalyze
    base = op_cost._flops
    # a patched pricing rule: every FLOP counted twice
    op_cost._flops = lambda *a: tuple(2 * x for x in base(*a))
    assert reanalyze.reanalyze_cell(sys.argv[1],
                                    reanalyze.chip_spec("sheet"))
    leaked = [m for m in sys.modules if m.startswith("repro_torch.models")
              or m.startswith("repro_torch.train") or m == "jax"]
    print("RESULT", json.dumps({"leaked": leaked}))
""")


def test_reanalyze_reprices_under_a_patched_rule_without_a_model(results):
    with make_production_mesh() as mesh:
        res = dryrun.run_cell("qwen3-14b", "prefill_32k", mesh,
                              verbose=False)
    path = dryrun.result_path("qwen3-14b", "prefill_32k", "pod")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _PATCHED, path], env=env,
                         capture_output=True, text=True, timeout=300)
    assert "RESULT" in out.stdout, out.stderr[-3000:]
    assert json.loads(out.stdout.split("RESULT", 1)[1])["leaked"] == []
    with open(path) as f:
        again = json.load(f)
    assert again["flops_dev"] == 2 * res["flops_dev"]
    assert again["hbm_bytes_dev"] == res["hbm_bytes_dev"]
    assert again["compute_s"] == pytest.approx(2 * res["compute_s"],
                                               rel=1e-12)


# --------------------------------------------------------------------------
# --chip measured: the card's cache, read on a host without a card
# --------------------------------------------------------------------------

CARD = "NVIDIA H100 80GB HBM3"


def _cache(path, kind: str = CARD, **over) -> dict:
    """A microbench cache as the card writes it (data-sheet values with
    the bf16 matmul roof at 7e14), ``over`` replacing top-level keys."""
    from repro_torch.core.roofline import microbench
    d = dataclasses.asdict(microbench.MicrobenchResult.analytic())
    d["matmul_flops"]["bfloat16"] = 7e14
    d.update(source="measured", fingerprint={
        "schema": microbench.CACHE_SCHEMA, "device_kind": kind,
        "n_devices": 1})
    d.update(over)
    path.write_text(json.dumps(d))
    return d


def _no_card(tmp_path, monkeypatch):
    """This host without a card, its microbench cache in ``tmp_path``."""
    from repro_torch.core.roofline import microbench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cache = tmp_path / "microbench_torch.json"
    monkeypatch.setattr(microbench, "DEFAULT_CACHE", cache)
    return cache


def test_measured_chip_reads_the_cards_cache_on_the_cpu(tmp_path,
                                                        monkeypatch):
    cache = _no_card(tmp_path, monkeypatch)
    before = json.dumps(_cache(cache))
    chip = reanalyze.chip_spec("measured")
    assert chip.name == f"{CARD} (measured)"
    assert chip.flops_for("bfloat16") == 7e14
    assert json.dumps(json.loads(cache.read_text())) == before


@pytest.mark.parametrize("case", ["none", "cpu", "schema", "analytic"])
def test_measured_chip_never_measures_the_cpu_nor_falls_back(
        case, tmp_path, monkeypatch):
    """No cache, the CPU's, another schema's or the data sheet's: each
    raises, and nothing is measured or written."""
    cache = _no_card(tmp_path, monkeypatch)
    if case == "cpu":
        _cache(cache, kind="cpu")
    elif case == "schema":
        d = _cache(cache)
        d["fingerprint"]["schema"] -= 1
        cache.write_text(json.dumps(d))
    elif case == "analytic":
        _cache(cache, source="analytic")
    before = cache.read_text() if cache.exists() else None
    with pytest.raises(RuntimeError, match="microbench"):
        reanalyze.chip_spec("measured")
    assert (cache.read_text() if cache.exists() else None) == before


def test_dryrun_measured_without_a_card_cache_stops_before_any_walk(
        results, tmp_path, monkeypatch):
    _no_card(tmp_path, monkeypatch)
    with pytest.raises(RuntimeError, match="no measurement of the card"):
        dryrun.main(["--arch", "qwen3-14b", "--shape", "train_4k",
                     "--chip", "measured"])
    assert not os.path.exists(results) or os.listdir(results) == []


# --------------------------------------------------------------------------
# the tables against the reference modules' on the same JSON files
# --------------------------------------------------------------------------

def _bench(name: str):
    sys.path.insert(0, REPO)
    try:
        return __import__(f"benchmarks.{name}", fromlist=["x"])
    finally:
        sys.path.remove(REPO)


def test_roofline_table_rows_equal_the_reference_modules(cells, monkeypatch):
    ref = _bench("bench_arch_roofline")
    d = cells[1]
    monkeypatch.setattr(ref, "RESULTS", d)
    monkeypatch.setattr(reanalyze, "RESULTS_DIR", d)
    for mesh in ("pod", "multipod"):
        mine, theirs = arch_roofline.table(mesh), ref.table(mesh)
        assert mine[:2] == theirs[:2] and len(mine) == len(theirs) > 2
        for a, b, key in zip(mine[2:], theirs[2:], [
                k for k in sorted(CELLS, key=lambda k: (
                    tcfg.ALL_ARCHS.index(k[0]), list(SHAPES).index(k[1])))
                if k[3] == "baseline" and k[2] == (mesh == "multipod")]):
            if CELLS[key] == "not_ported":
                # the reference shows a non-ok status as ERROR
                assert "| not_ported |" in a and "ERROR" in b
                assert "ROADMAP queue 1 item" in a
            else:
                assert a == b.replace("raise MXU occupancy",
                                      "raise tensor-core occupancy")


def test_perf_table_rows_equal_the_reference_modules(cells, tmp_path,
                                                     monkeypatch):
    ref = _bench("perf_table")
    from repro.core.roofline.substitute import substitute_flash as ref_sub
    from repro_torch.core.roofline.substitute import substitute_flash
    d = str(tmp_path / "variants")
    os.makedirs(d)
    base = cells[0][("qwen3-14b", "train_4k", True, "baseline")]
    # the same cell under two of the reference's variants of its first row
    for v in ("baseline", "tp_oproj"):
        suffix = "" if v == "baseline" else f"__{v}"
        with open(os.path.join(d, f"qwen3-14b__train_4k__pod{suffix}.json"),
                  "w") as f:
            json.dump(dict(base, variant=v), f)
    monkeypatch.setattr(ref, "RESULTS", d)
    monkeypatch.setattr(reanalyze, "RESULTS_DIR", d)
    for v in ("baseline", "tp_oproj"):
        got, want = (perf_table.load("qwen3-14b", "train_4k", "pod", v),
                     ref.load("qwen3-14b", "train_4k", "pod", v))
        assert perf_table.fmt(got) == ref.fmt(want)
        mine, theirs = substitute_flash(got, 4096), ref_sub(want, 4096)
        # the substituted bytes agree; the time is priced on each chip
        assert mine["hbm_bytes_dev"] == theirs["hbm_bytes_dev"]
        assert mine["memory_s"] == pytest.approx(
            mine["hbm_bytes_dev"] / 3.35e12, rel=1e-12)
    lines = perf_table.table()
    assert lines[0] == "\n#### qwen3-14b / train_4k / pod\n"
    assert lines[1] == "| " + " | ".join(ref.HEADER) + " |"
    assert sum(line.startswith("| baseline |") for line in lines) == 1
    assert sum("flash(modeled)" in line for line in lines) == 2


def test_metrics_diff_warns_as_the_reference(tmp_path):
    ref = _bench("perf_table")
    a, b = tmp_path / "a.prom", tmp_path / "b.prom"
    a.write_text('serve_tokens_per_s{arch="x"} 100\n'
                 'serve_attained_flops_per_s 5e12\nother 1\n')
    b.write_text('serve_tokens_per_s{arch="x"} 70\nother 0\n')
    got = perf_table.metrics_diff(str(a), str(b))
    assert got == ref.metrics_diff(str(a), str(b)) and len(got) == 2
