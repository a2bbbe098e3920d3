"""The multi-replica serving tier on the card: replicas colocated on one
card (or one card each where the host has two), their decode steps
replaying captured CUDA graphs through the hand-written paged-attention
kernels, KV pages migrating between their pools.

Needs an NVIDIA card with nvcc (marked ``cuda``; skips elsewhere).  On
the card, from the repo root:

    python -m pytest -m cuda tests/test_torch_router_cuda.py

Exact checks only: pages after a migration against those before it
(``torch.equal`` on their bytes), token streams against one engine's on
the same weights, graphed against eager, per-replica launch counts.
Imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import BlockDef, init_params
from repro_torch.models.params import tree_leaves
from repro_torch.serve import (Cluster, Engine, EngineConfig, GenerateConfig,
                               RoleConfig, Router)
from repro_torch.serve.kv_cache import gather_slot_pages
from repro_torch.serve.scheduler import RequestState, Scheduler

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs, CUDA kernels)")
    return torch.device("cuda")


def _cfg(kind):
    if kind == "gqa":
        return smoke(get_config("qwen3-0.6b"))
    return dataclasses.replace(
        smoke(get_config("deepseek-v2-236b")), name="mla-dense-smoke",
        mla_absorb=True, n_experts=0, moe_top_k=0, moe_d_ff=0,
        n_shared_experts=0, moe_first_dense=0, n_layers=2,
        block_pattern=(BlockDef("mla", "dense"),))


def _params(cfg, dev="cuda"):
    return init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)


def _ecfg(**kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("page_size", 16)
    kw.setdefault("max_len", 128)
    kw.setdefault("prefill_chunk", 32)
    return EngineConfig(device="cuda", **kw)


def _prompts(vocab, n=5, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, m) for m in (9, 17, 33, 48, 70)[:n]]


def _one(cfg, params, ecfg, prompts, gen, seeds=None):
    eng = Engine(cfg, params, ecfg)
    seeds = seeds or [None] * len(prompts)
    reqs = [eng.submit(p, gen, seed=s) for p, s in zip(prompts, seeds)]
    eng.run()
    return [list(r.generated) for r in reqs]


def _router(cfg, params, ecfg, prompts, gen, roles, seeds=None):
    cluster = Cluster(cfg, params, ecfg, mesh_shape=(len(roles.roles), 1),
                      roles=roles)
    router = Router(cluster)
    seeds = seeds or [None] * len(prompts)
    reqs = [router.submit(p, gen, seed=s) for p, s in zip(prompts, seeds)]
    router.run()
    return cluster, router, reqs


def _pages(kv, slot):
    phys = torch.as_tensor(kv.block_tables[slot][:kv.slot_pages(slot)],
                           dtype=torch.long, device=kv.device)
    return [t.contiguous().view(torch.uint8) for t in tree_leaves(
        gather_slot_pages(kv.pools, phys, kv._paged, slot))]


@pytest.fixture
def page_spy(monkeypatch):
    before, after = {}, {}
    detach, resume = Scheduler.detach, Scheduler._resume

    def spy_detach(self, req, link="dcn"):
        if req.state is RequestState.RUNNING:
            before[req.request_id] = _pages(self.kv, req.slot)
        return detach(self, req, link)

    def spy_resume(self, req):
        moving = req.migrating
        ok = resume(self, req)
        if ok and moving:
            after[req.request_id] = _pages(self.kv, req.slot)
        return ok

    monkeypatch.setattr(Scheduler, "detach", spy_detach)
    monkeypatch.setattr(Scheduler, "_resume", spy_resume)
    return before, after


@pytest.mark.parametrize("kind,kv_dtype", [("gqa", None), ("gqa", "int8"),
                                           ("mla", None)])
def test_disaggregated_pages_exact_and_streams_equal(card, page_spy, kind,
                                                     kv_dtype):
    before, after = page_spy
    cfg = _cfg(kind)
    params = _params(cfg)
    ecfg = _ecfg(kv_dtype=kv_dtype)
    prompts = _prompts(cfg.vocab_size)
    gen = GenerateConfig(max_new_tokens=12)
    cluster, router, reqs = _router(cfg, params, ecfg, prompts, gen,
                                    RoleConfig.disaggregated(1, 1))
    assert router.migrations == len(prompts)
    assert sorted(before) == sorted(after) == [r.request_id for r in reqs]
    for rid in before:
        for a, b in zip(before[rid], after[rid], strict=True):
            assert torch.equal(a, b), rid
    assert all(e.device.type == "cuda" and e.graphs
               for e in cluster.replicas)
    assert "decode" in cluster.replicas[1]._graphs.graphs
    assert [list(r.generated) for r in reqs] == _one(cfg, params, ecfg,
                                                     prompts, gen)


def test_graphed_router_equals_eager(card):
    """The restore writes the pools in place and the next step writes the
    destination's block-table rows into the buffer its captured graph
    reads: graphed streams and per-run launches equal eager ones."""
    cfg = _cfg("gqa")
    params = _params(cfg)
    prompts = _prompts(cfg.vocab_size)
    gen = GenerateConfig(max_new_tokens=12)
    out = []
    for graphs in (True, False):
        pa.paged_attention.launches = 0
        cluster, router, reqs = _router(
            cfg, params, _ecfg(cuda_graphs=graphs), prompts, gen,
            RoleConfig.disaggregated(1, 1))
        steps = sum(e.decode_steps for e in cluster.replicas)
        assert pa.paged_attention.launches == cfg.n_layers * steps
        out.append(([list(r.generated) for r in reqs],
                    pa.paged_attention.launches))
    assert out[0] == out[1]


def test_sampled_disaggregated_equals_one_engine(card):
    cfg = _cfg("gqa")
    params = _params(cfg)
    prompts = _prompts(cfg.vocab_size)
    gen = GenerateConfig(max_new_tokens=12, temperature=0.8, top_k=50,
                         top_p=0.9)
    seeds = [21, 22, 23, 24, 25]
    _, router, reqs = _router(cfg, params, _ecfg(), prompts, gen,
                              RoleConfig.disaggregated(1, 1), seeds=seeds)
    assert router.migrations == len(prompts)
    assert [list(r.generated) for r in reqs] == _one(
        cfg, params, _ecfg(), prompts, gen, seeds=seeds)


def test_colocated_replicas_share_weights_on_the_card(card):
    cfg = _cfg("gqa")
    params = _params(cfg)
    n = torch.cuda.device_count()
    cluster = Cluster(cfg, params, _ecfg(), mesh_shape=(n + 1, 1))
    assert cluster.colocated
    for eng in cluster.replicas:
        assert eng.device.type == "cuda"
        assert (eng.params["embed"]["tok"].data_ptr()
                == params["embed"]["tok"].data_ptr())


def test_replicas_on_their_own_cards(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: one replica on each")
    cfg = _cfg("gqa")
    params = _params(cfg)
    prompts = _prompts(cfg.vocab_size)
    gen = GenerateConfig(max_new_tokens=12)
    cluster, router, reqs = _router(cfg, params, _ecfg(), prompts, gen,
                                    RoleConfig.disaggregated(1, 1))
    assert not cluster.colocated
    assert [e.device for e in cluster.replicas] == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    assert router.migrations == len(prompts)
    assert [list(r.generated) for r in reqs] == _one(cfg, params, _ecfg(),
                                                     prompts, gen)
