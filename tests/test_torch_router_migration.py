"""KV-page migration through the port's serving tier, port-only checks
(smoke configs, CPU):

* the migration itself is exact: a request's pages gathered through the
  destination's block table right after the restore equal the source's
  gathered just before the export, bit for bit, for GQA pages (with
  prefix pages aliased from the destination's index), int8 pages with
  their scale slabs, and MLA latent pages;
* a sampled stream through a disaggregated router equals one engine's
  (sampling is request-level: ``row_generator(seed, step)``);
* an n-gram speculative cluster equals one ``SpecEngine``; a draft-model
  cluster releases the proposer's mirrored slot at export;
* a rescue: a replica whose small pool preempts by swap spills its
  preemptees to a decode replica, streams equal to a fully backed engine;
* a migration that cannot land raises;
* ``harvest_serve``'s migration families and the trace's flow arrows;
* ``launch/serve.py --mesh 2,1 --router --roles disagg`` on the CPU.
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
import repro_torch.serve as tserve
from repro_torch.launch import serve as serve_cli
from repro_torch.models import BlockDef, init_params
from repro_torch.models.params import tree_leaves
from repro_torch.obs import validate_trace
from repro_torch.serve.kv_cache import gather_slot_pages
from repro_torch.serve.scheduler import RequestState, Scheduler


def _cfg(kind):
    if kind == "gqa":
        return tcfg.smoke(tcfg.get_config("qwen3-0.6b"))
    return dataclasses.replace(
        tcfg.smoke(tcfg.get_config("deepseek-v2-236b")),
        name="mla-dense-smoke", mla_absorb=True, n_experts=0, moe_top_k=0,
        moe_d_ff=0, n_shared_experts=0, moe_first_dense=0, n_layers=2,
        block_pattern=(BlockDef("mla", "dense"),))


def _params(cfg, seed=0):
    return init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _ecfg(**kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_len", 40)
    return tserve.EngineConfig(device="cpu", **kw)


def _prompts(n=3, seed=500, vocab=256, shared=0):
    rs = np.random.RandomState(seed)
    head = rs.randint(0, vocab, shared)
    return [np.concatenate([head, rs.randint(0, vocab, 5 + i)]).astype(
        np.int32) for i in range(n)]


def _serve_router(cfg, params, ecfg, prompts, gen, roles, scfg=None,
                  seeds=None):
    cluster = tserve.Cluster(cfg, params, ecfg, scfg,
                             mesh_shape=(len(roles.roles), 1), roles=roles)
    router = tserve.Router(cluster)
    seeds = seeds or [None] * len(prompts)
    reqs = [router.submit(p, gen, seed=s) for p, s in zip(prompts, seeds)]
    router.run()
    return cluster, router, reqs


def _serve_one(cfg, params, ecfg, prompts, gen, scfg=None, seeds=None):
    eng = (tserve.Engine(cfg, params, ecfg) if scfg is None
           else tserve.SpecEngine(cfg, params, ecfg, scfg))
    seeds = seeds or [None] * len(prompts)
    reqs = [eng.submit(p, gen, seed=s) for p, s in zip(prompts, seeds)]
    eng.run()
    return [list(r.generated) for r in reqs]


def _slot_pages(kv, slot):
    """The slot's pages of every paged leaf (and its state rows) gathered
    through its block table, as bytes."""
    phys = torch.as_tensor(kv.block_tables[slot][:kv.slot_pages(slot)],
                           dtype=torch.long)
    return [t.contiguous().view(torch.uint8) for t in tree_leaves(
        gather_slot_pages(kv.pools, phys, kv._paged, slot))]


@pytest.fixture
def page_spy(monkeypatch):
    """Pages of every migrating request on the source just before its
    export and on the destination right after its restore."""
    before, after = {}, {}
    detach, resume = Scheduler.detach, Scheduler._resume

    def spy_detach(self, req, link="dcn"):
        if req.state is RequestState.RUNNING:
            before[req.request_id] = _slot_pages(self.kv, req.slot)
        return detach(self, req, link)

    def spy_resume(self, req):
        moving = req.migrating
        ok = resume(self, req)
        if ok and moving:
            after[req.request_id] = _slot_pages(self.kv, req.slot)
        return ok

    monkeypatch.setattr(Scheduler, "detach", spy_detach)
    monkeypatch.setattr(Scheduler, "_resume", spy_resume)
    return before, after


@pytest.mark.parametrize("kind,kv_dtype,shared", [
    ("gqa", None, 8), ("gqa", "int8", 0), ("mla", None, 8)])
def test_migration_pages_bit_exact(page_spy, kind, kv_dtype, shared):
    before, after = page_spy
    cfg = _cfg(kind)
    params = _params(cfg)
    ecfg = _ecfg(kv_dtype=kv_dtype, prefix_cache=shared > 0)
    prompts = _prompts(shared=shared)
    gen = tserve.GenerateConfig(max_new_tokens=6)
    cluster, router, reqs = _serve_router(
        cfg, params, ecfg, prompts, gen,
        tserve.RoleConfig.disaggregated(1, 1))
    assert router.migrations == len(prompts)
    assert sorted(before) == sorted(after) == [r.request_id for r in reqs]
    for rid in before:
        assert len(before[rid]) == len(after[rid])
        for a, b in zip(before[rid], after[rid]):
            assert torch.equal(a, b), rid
    if kv_dtype:
        names = [n for seg in cluster.replicas[1]._kv.pools
                 for blk in seg.values() for n in blk]
        assert any(n.endswith("_scale") for n in names)
    if shared:
        # the later requests' prefix pages were aliased on arrival
        dst = cluster.replicas[1]._kv.pool.stats
        assert dst.dedup_hits > 0
    assert [list(r.generated) for r in reqs] == _serve_one(
        cfg, params, ecfg, prompts, gen)


def test_sampled_stream_disaggregated_equals_one_engine():
    cfg = _cfg("gqa")
    params = _params(cfg)
    gen = tserve.GenerateConfig(max_new_tokens=8, temperature=0.8,
                                top_k=50, top_p=0.9)
    prompts, seeds = _prompts(n=4), [11, 12, 13, 14]
    _, router, reqs = _serve_router(
        cfg, params, _ecfg(), prompts, gen,
        tserve.RoleConfig.disaggregated(1, 1), seeds=seeds)
    got = [list(r.generated) for r in reqs]
    assert router.migrations == len(prompts)
    assert got == _serve_one(cfg, params, _ecfg(), prompts, gen,
                             seeds=seeds)
    assert got != _serve_one(cfg, params, _ecfg(), prompts,
                             dataclasses.replace(gen, temperature=0.0))


def test_ngram_spec_cluster_equals_spec_engine():
    cfg = _cfg("gqa")
    params = _params(cfg)
    scfg = tserve.SpecConfig(k=3, proposer="ngram")
    # prompts that repeat themselves, so the n-gram proposer drafts
    rs = np.random.RandomState(3)
    prompts = [np.tile(rs.randint(0, 256, 4), 3).astype(np.int32)
               for _ in range(3)]
    gen = tserve.GenerateConfig(max_new_tokens=10)
    cluster, router, reqs = _serve_router(
        cfg, params, _ecfg(), prompts, gen,
        tserve.RoleConfig.disaggregated(1, 1), scfg=scfg)
    assert router.migrations == len(prompts)
    assert [list(r.generated) for r in reqs] == _serve_one(
        cfg, params, _ecfg(), prompts, gen, scfg=scfg)
    assert cluster.aggregate_ledger().proposed > 0
    assert all(isinstance(e, tserve.SpecEngine) for e in cluster.replicas)


def test_draft_spec_cluster_releases_proposer_slot():
    cfg = _cfg("gqa")
    params = _params(cfg)
    draft = dataclasses.replace(cfg, n_layers=1)
    scfg = tserve.SpecConfig(k=2, proposer="draft", draft_cfg=draft,
                             draft_params=_params(draft, 1))
    prompts = _prompts()
    gen = tserve.GenerateConfig(max_new_tokens=6)
    released = []
    cluster = tserve.Cluster(cfg, params, _ecfg(), scfg, mesh_shape=(2, 1),
                             roles=tserve.RoleConfig.disaggregated(1, 1))
    src = cluster.replicas[0]
    export = src.export_request

    def spy(req, link="dcn"):
        held = req.request_id in src.proposer._slots
        out = export(req, link=link)
        released.append((held, req.request_id in src.proposer._slots))
        return out
    src.export_request = spy
    router = tserve.Router(cluster)
    reqs = [router.submit(p, gen) for p in prompts]
    router.run()
    assert released and all(h and not after for h, after in released)
    assert not src.proposer._slots and not cluster.replicas[1].proposer._slots
    assert [list(r.generated) for r in reqs] == _serve_one(
        cfg, params, _ecfg(), prompts, gen, scfg=scfg)


def test_rescue_spills_preemptees_to_decode_replica():
    """Replica 0 (mixed) takes every fresh request into a pool too small
    for their growth; its swap preemptees move to replica 1 (decode)."""
    cfg = _cfg("gqa")
    params = _params(cfg)
    prompts = _prompts(n=3)
    gen = tserve.GenerateConfig(max_new_tokens=12)
    ecfg = _ecfg(num_slots=3, num_pages=8)
    cluster, router, reqs = _serve_router(
        cfg, params, ecfg, prompts, gen, tserve.RoleConfig(("mixed",
                                                            "decode")))
    led = cluster.aggregate_ledger()
    assert led.preemptions > 0 and router.migrations > 0
    assert cluster.replicas[1]._sched.finished
    assert all(router.home.get(r.request_id) is None for r in reqs)
    full = _serve_one(cfg, params, _ecfg(num_slots=3), prompts, gen)
    assert [list(r.generated) for r in reqs] == full


def test_failed_migration_raises():
    cfg = _cfg("gqa")
    params = _params(cfg)
    cluster = tserve.Cluster(cfg, params, _ecfg(), mesh_shape=(2, 1),
                             roles=tserve.RoleConfig.mixed(2))
    router = tserve.Router(cluster)
    req = router.submit(_prompts(n=1)[0],
                        tserve.GenerateConfig(max_new_tokens=20))
    router.step()
    home = router.home[req.request_id]
    dst = cluster.replicas[1 - home]
    dst.reset(max_len=8)                        # too short for the request
    assert not dst._kv.can_admit(req.budget) and dst._kv.can_admit(8)
    dst.submit(np.arange(3, dtype=np.int32), tserve.GenerateConfig(2))
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        router._move(req, home, 1 - home)
    with pytest.raises(ValueError, match="cannot migrate"):
        cluster.replicas[home]._sched.detach(
            tserve.Request(prompt=np.arange(4, dtype=np.int32)))


def test_harvest_serve_migration_families_and_flows():
    cfg = _cfg("gqa")
    params = _params(cfg)
    cluster, router, reqs = _serve_router(
        cfg, params, _ecfg(telemetry=True), _prompts(),
        tserve.GenerateConfig(max_new_tokens=5),
        tserve.RoleConfig.disaggregated(1, 1, link="ici"))
    obs = cluster.obs
    assert obs is not None and all(e.obs is obs for e in cluster.replicas)
    obs.harvest(cluster)
    text = obs.registry.expose()
    assert f"serve_migrations_total {float(router.migrations)}" in text
    assert (f'serve_migration_bytes_total{{link="ici"}} '
            f"{router.migration_bytes}") in text
    pages = sum(e._kv.num_pages - 1 for e in cluster.replicas)
    assert f"serve_pool_pages_total {float(pages)}" in text
    assert cluster.roofline_terms().ici_wire_bytes_dev > 0
    doc = obs.tracer.export()
    assert validate_trace(doc) == []
    events = doc["traceEvents"]
    names = {e["name"] for e in events}
    assert {"submit", "dispatch", "enqueue", "migrate", "migrate_out",
            "migrate_in"} <= names
    flows = [e for e in events if e["ph"] in ("s", "f")]
    assert len(flows) == 2 * router.migrations
    starts = {e["id"]: e["pid"] for e in flows if e["ph"] == "s"}
    ends = {e["id"]: e["pid"] for e in flows if e["ph"] == "f"}
    assert starts.keys() == ends.keys()
    assert all(starts[i] == 0 and ends[i] == 1 for i in starts)
    json.dumps(doc)
    ph = cluster.replicas[1].phases["migrate"]
    assert ph.host == sum(r.ledger.migration_bytes for r in reqs)


def test_cli_router_disagg(capsys):
    serve_cli.main(["--smoke", "--device", "cpu", "--mesh", "2,1",
                    "--router", "--roles", "disagg", "--batch", "3",
                    "--prompt-len", "12", "--new-tokens", "6", "--slots",
                    "2", "--link", "ici"])
    out = capsys.readouterr().out
    head = re.search(r"\[serve/router\] 3 requests, 18 new tokens .* over "
                     r"dp=2 tp=1 replicas \(colocated.*roles "
                     r"prefill,decode\)", out)
    assert head, out
    assert re.search(r"\[serve/router\] migrations=3 \([\d.]+ kB packed KV "
                     r"over ici\)", out), out
    assert "migration roofline" in out and "[serve/capacity] fleet" in out
    with pytest.raises(SystemExit, match="item 18"):
        serve_cli.main(["--smoke", "--device", "cpu", "--mesh", "2,2"])
