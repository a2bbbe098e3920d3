"""The port's multi-replica serving tier (``serve/{cluster,router}.py``)
against the JAX package's ``repro.serve.{Cluster,Router}`` on the same
bridged weights and numpy prompts, with the contracts of the reference's
tests/test_router_cluster.py:

* streams: a request prefilled on one replica and decoded on another
  (disaggregated roles, or a mid-decode rescue after preemption) emits
  the reference's tokens, and one port engine's, for GQA (qwen3-0.6b
  smoke) and MLA (the reference tests' MoE-free ``mla-dense-smoke``); a
  mixed cluster migrates nothing;
* the migration ledger: per-request ``migration_bytes`` / ``_pages``
  equal to the reference's, within 15% of the analytic page model, and
  a ``migration`` roof in the fleet's ``roofline_terms()``;
* the TTFT split telescoping through the front door; ``capacity_report``
  over a cluster equal to the reference's key for key; the admission
  depth; ``stream()`` yielding every token once;
* ``RoleConfig``, ``Cluster`` and ``parallel.mesh.dp_submeshes``
  validation.

The JAX side of each pair runs once a module (``lru_cache``).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

import repro.configs as jcfg
import repro.models as jm
import repro.serve as jserve
from repro.models.common import BlockDef as JBlockDef
from repro.serve.crosscheck import capacity_report as ref_capacity_report
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.serve as tserve
from repro_torch import bridge
from repro_torch.core.roofline.hardware import H100_SXM
from repro_torch.models import BlockDef
from repro_torch.parallel.mesh import dp_submeshes
from repro_torch.serve.crosscheck import capacity_report
from repro_torch.serve.scheduler import kv_line_bytes, state_bytes

# the MoE-free MLA config of the reference's tests: expert capacity
# depends on which rows batch together, and migration changes that
MLA_DENSE = dict(name="mla-dense-smoke", mla_absorb=True, n_experts=0,
                 moe_top_k=0, moe_d_ff=0, n_shared_experts=0,
                 moe_first_dense=0, n_layers=2)


@functools.lru_cache(maxsize=None)
def _pair(kind):
    arch = "qwen3-0.6b" if kind == "gqa" else "deepseek-v2-236b"
    jc = jcfg.smoke(jcfg.get_config(arch))
    tc = tcfg.smoke(tcfg.get_config(arch))
    if kind == "mla":
        jc = dataclasses.replace(
            jc, block_pattern=(JBlockDef("mla", "dense"),), **MLA_DENSE)
        tc = dataclasses.replace(
            tc, block_pattern=(BlockDef("mla", "dense"),), **MLA_DENSE)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.prepare_params(
        bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu"), tc)
    return jc, tc, jp, tp


def _prompts(n=3, seed=500, vocab=256):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, 5 + i).astype(np.int32) for i in range(n)]


def _ecfg(mod, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_len", 32)
    if mod is tserve:
        # the reference's chip memory, so capacity_report's B_max compares
        kw.setdefault("device", "cpu")
        kw.setdefault("chip", dataclasses.replace(
            H100_SXM, hbm_bytes=jserve.EngineConfig().chip.hbm_bytes))
    return mod.EngineConfig(**kw)


def _router_run(mod, cfg, params, ecfg, prompts, gen, roles, **kw):
    cluster = mod.Cluster(cfg, params, ecfg,
                          mesh_shape=(len(roles.roles), 1), roles=roles)
    router = mod.Router(cluster, **kw)
    reqs = [router.submit(p, gen) for p in prompts]
    done = router.run()
    assert len(done) == len(prompts)
    return cluster, router, reqs


def _single_tokens(mod, cfg, params, ecfg, prompts, gen):
    eng = mod.Engine(cfg, params, ecfg)
    reqs = [eng.submit(p, gen) for p in prompts]
    eng.run()
    return [list(r.generated) for r in reqs]


def _disagg(mod, kind):
    jc, tc, jp, tp = _pair(kind)
    cfg, params = (jc, jp) if mod is jserve else (tc, tp)
    seed = 500 if kind == "gqa" else 600
    return _router_run(mod, cfg, params, _ecfg(mod, prefix_cache=True),
                       _prompts(seed=seed),
                       mod.GenerateConfig(max_new_tokens=6),
                       mod.RoleConfig.disaggregated(1, 1))


@functools.lru_cache(maxsize=None)
def _ref_disagg(kind):
    return _disagg(jserve, kind)


def _rescue(mod, kind):
    """The reference test's mid-decode migration: prefill and first
    tokens on the home replica, preempt (pages parked in a snapshot),
    move to the other replica, finish there."""
    jc, tc, jp, tp = _pair(kind)
    cfg, params = (jc, jp) if mod is jserve else (tc, tp)
    cluster = mod.Cluster(cfg, params, _ecfg(mod), mesh_shape=(2, 1),
                          roles=mod.RoleConfig.mixed(2))
    router = mod.Router(cluster)
    seed = 700 if kind == "gqa" else 800
    req = router.submit(_prompts(n=1, seed=seed)[0],
                        mod.GenerateConfig(max_new_tokens=8))
    router.step()
    home = router.home[req.request_id]
    assert req.state is mod.RequestState.RUNNING and len(req.generated) >= 2
    cluster.replicas[home]._sched.preempt(req)
    assert req.swap_snapshot is not None
    router._move(req, home, 1 - home)
    router.run()
    return router, req


@functools.lru_cache(maxsize=None)
def _ref_rescue(kind):
    router, req = _rescue(jserve, kind)
    return router.migrations, req


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_disaggregated_streams_equal_reference(kind):
    _, router, reqs = _disagg(tserve, kind)
    _, ref_router, ref_reqs = _ref_disagg(kind)
    _, tc, _, tp = _pair(kind)
    got = [list(r.generated) for r in reqs]
    assert got == [list(r.generated) for r in ref_reqs]
    seed = 500 if kind == "gqa" else 600
    assert got == _single_tokens(tserve, tc, tp, _ecfg(tserve,
                                                       prefix_cache=True),
                                 _prompts(seed=seed),
                                 tserve.GenerateConfig(max_new_tokens=6))
    assert router.migrations == ref_router.migrations >= len(reqs)
    assert router.migration_bytes == ref_router.migration_bytes > 0
    for r, j in zip(reqs, ref_reqs):
        assert r.ledger.migrations == j.ledger.migrations >= 1
        assert r.ledger.migration_bytes == j.ledger.migration_bytes
        assert r.ledger.migration_pages == j.ledger.migration_pages
        assert r.ledger.migration_link == j.ledger.migration_link == "dcn"


def test_mixed_cluster_equal_streams_no_migration():
    _, tc, _, tp = _pair("gqa")
    _, _, ref_reqs = _ref_disagg("gqa")
    _, router, reqs = _router_run(
        tserve, tc, tp, _ecfg(tserve), _prompts(),
        tserve.GenerateConfig(max_new_tokens=6), tserve.RoleConfig.mixed(2))
    # greedy streams do not depend on the roles or on prefix sharing
    assert [list(r.generated) for r in reqs] == [
        list(r.generated) for r in ref_reqs]
    assert router.migrations == 0 and router.migration_bytes == 0.0
    assert sorted(router.cluster.replicas[i]._sched is not None
                  for i in range(2)) == [True, True]


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_mid_decode_migration_after_preemption(kind):
    router, req = _rescue(tserve, kind)
    ref_migrations, ref_req = _ref_rescue(kind)
    assert list(req.generated) == list(ref_req.generated)
    assert req.ledger.preemptions == ref_req.ledger.preemptions == 1
    assert req.ledger.migrations == ref_req.ledger.migrations == 1
    assert req.ledger.migration_bytes == ref_req.ledger.migration_bytes > 0
    assert req.ledger.migration_pages == ref_req.ledger.migration_pages
    assert req.ledger.swap_bytes == ref_req.ledger.swap_bytes
    assert router.migrations == ref_migrations == 1
    _, tc, _, tp = _pair(kind)
    seed = 700 if kind == "gqa" else 800
    assert list(req.generated) == _single_tokens(
        tserve, tc, tp, _ecfg(tserve), _prompts(n=1, seed=seed),
        tserve.GenerateConfig(max_new_tokens=8))[0]


def test_migration_bytes_match_analytic():
    """Packed-snapshot bytes within 15% of the analytic wire model (pages
    x page x KV line bytes + the state a move carries)."""
    cluster, _, reqs = _disagg(tserve, "gqa")
    cfg, page = cluster.cfg, cluster.ecfg.page_size
    led = cluster.aggregate_ledger()
    assert led.migrations >= len(reqs) and led.migration_pages > 0
    analytic = (led.migration_pages * page * kv_line_bytes(cfg)
                + led.migrations * state_bytes(cfg))
    ratio = analytic / led.migration_bytes
    assert 1 / 1.15 <= ratio <= 1.15, ratio
    ref_led = _ref_disagg("gqa")[0].aggregate_ledger()
    assert led.migration_bytes == ref_led.migration_bytes
    assert led.migration_pages == ref_led.migration_pages


def test_migration_roof_nameable():
    """roofs() takes the migration bytes out of the carrying link's roof
    and names them; scaling them up makes "migration" bind."""
    cluster, _, _ = _disagg(tserve, "gqa")
    t = cluster.roofline_terms()
    assert t.migration_bytes_dev > 0 and t.migration_link == "dcn"
    roofs = t.roofs()
    assert "migration" in roofs
    assert t.dcn_wire_bytes_dev >= t.migration_bytes_dev
    heavy_bytes = (10.0 * t.flops_dev * t.chip.level_bw("dcn")
                   / min(roofs.values()))
    heavy = dataclasses.replace(
        t, migration_bytes_dev=heavy_bytes,
        dcn_wire_bytes_dev=(t.dcn_wire_bytes_dev - t.migration_bytes_dev
                            + heavy_bytes))
    assert heavy.binding_roof == "migration", heavy.roofs()
    assert heavy.migration_s > t.migration_s
    # on "ici" the same bytes ride the card-to-card link
    led = cluster.aggregate_ledger()
    led.migration_link = "ici"
    ti = led.terms(cluster.cfg, cluster.ecfg.chip)
    assert ti.dcn_wire_bytes_dev == 0.0
    assert ti.ici_wire_bytes_dev == ti.migration_bytes_dev > 0


@pytest.mark.parametrize("roles", ["mixed", "disagg"])
def test_ttft_breakdown_telescopes(roles):
    _, tc, _, tp = _pair("gqa")
    rc = (tserve.RoleConfig.mixed(2) if roles == "mixed"
          else tserve.RoleConfig.disaggregated(1, 1))
    _, _, reqs = _router_run(tserve, tc, tp, _ecfg(tserve), _prompts(),
                             tserve.GenerateConfig(max_new_tokens=4), rc)
    for r in reqs:
        bd = r.ttft_breakdown()
        assert abs(sum(bd.values()) - r.ttft) < 1e-9
        assert min(bd.values()) >= 0
        assert r.submit_time <= r.dispatch_time <= r.prefill_start_time


def test_capacity_report_equals_reference():
    cluster, _, reqs = _disagg(tserve, "gqa")
    got = capacity_report(cluster)
    want = ref_capacity_report(_ref_disagg("gqa")[0])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])
    assert [r["role"] for r in got["replicas"]] == ["prefill", "decode"]
    assert got["replicas_live"] == 2
    assert got["migrations"] >= len(reqs) and got["migration_bytes"] > 0
    for key in ("pages_in_use", "pages_peak", "pages_total",
                "capacity_max_batch"):
        assert got[key] == sum(r[key] for r in got["replicas"])


def test_admission_depth_bounds_replica_backlog():
    _, tc, _, tp = _pair("gqa")
    cluster = tserve.Cluster(tc, tp, _ecfg(tserve), mesh_shape=(1, 1),
                             roles=tserve.RoleConfig.mixed(1))
    router = tserve.Router(cluster, admit_depth=1)
    prompts = _prompts(n=4)
    gen = tserve.GenerateConfig(max_new_tokens=4)
    reqs = [router.submit(p, gen) for p in prompts]
    router._dispatch()
    assert len(router.queue) == 3
    assert len(cluster.replicas[0]._sched.waiting) == 1
    assert len(router.run()) == 4
    assert [list(r.generated) for r in reqs] == _single_tokens(
        tserve, tc, tp, _ecfg(tserve), prompts, gen)
    with pytest.raises(ValueError, match="admit_depth"):
        tserve.Router(cluster, admit_depth=0)


def test_stream_yields_every_token_once():
    _, tc, _, tp = _pair("gqa")
    cluster = tserve.Cluster(tc, tp, _ecfg(tserve), mesh_shape=(2, 1),
                             roles=tserve.RoleConfig.disaggregated(1, 1))
    router = tserve.Router(cluster)
    reqs = [router.submit(p, tserve.GenerateConfig(max_new_tokens=5))
            for p in _prompts()]
    streamed = {r.request_id: [] for r in reqs}
    for rid, tok in router.stream():
        streamed[rid].append(tok)
    for r in reqs:
        assert streamed[r.request_id] == list(r.generated)
        assert len(r.generated) == 5
    assert router.migrations >= len(reqs)


def test_role_config_validation():
    for mod in (tserve, jserve):
        with pytest.raises(ValueError, match="unknown roles"):
            mod.RoleConfig(("mixed", "verifier"))
        with pytest.raises(ValueError, match="prefill-capable"):
            mod.RoleConfig(("decode", "decode"))
        with pytest.raises(ValueError, match="migrate into"):
            mod.RoleConfig(("prefill", "prefill"))
        with pytest.raises(ValueError, match="link"):
            mod.RoleConfig(("mixed",), link="pcie")
        assert mod.RoleConfig.disaggregated(1, 2).roles == (
            "prefill", "decode", "decode")
        assert not mod.RoleConfig.mixed(3).disaggregates
        assert mod.RoleConfig(("mixed", "decode")).disaggregates


def test_cluster_validation():
    _, tc, _, tp = _pair("gqa")
    with pytest.raises(ValueError, match="names 1 replicas"):
        tserve.Cluster(tc, tp, _ecfg(tserve), mesh_shape=(2, 1),
                       roles=tserve.RoleConfig.mixed(1))
    with pytest.raises(ValueError, match="colocate"):
        tserve.Cluster(tc, tp, _ecfg(tserve), mesh_shape=(2, 4),
                       colocate=True)
    with pytest.raises(ValueError, match=">= 1"):
        tserve.Cluster(tc, tp, _ecfg(tserve), mesh_shape=(0, 1))
    # the CPU is one device: two replicas colocate and read one copy of
    # the weights
    cl = tserve.Cluster(tc, tp, _ecfg(tserve), mesh_shape=(2, 1))
    assert cl.colocated
    a, b = (e.params["embed"]["tok"] for e in cl.replicas)
    assert a.data_ptr() == b.data_ptr()
    assert [e.replica_id for e in cl.replicas] == [0, 1]


def test_dp_submeshes_need_devices():
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        dp_submeshes(2, 1, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        dp_submeshes(0, 1, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        dp_submeshes(1, 0, device="cpu")
    rows = dp_submeshes(1, 1, device="cpu")
    assert len(rows) == 1 and str(rows[0][0]) == "cpu"
