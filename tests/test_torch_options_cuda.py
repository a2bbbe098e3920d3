"""The engine options on the card, graphed against eager, and the
captured prefill steps against their eager bodies.

Needs an NVIDIA card with nvcc (marked ``cuda``; skips elsewhere).  On
the card, from the repo root:

    python -m pytest -m cuda tests/test_torch_options_cuda.py

* prefix sharing with copy-on-write (an aligned full hit: a T = 1 chunk
  into a shared page), preemption by swap and by recompute, and sampled
  requests (temperature, top-k, top-p, seeded), each served by an engine
  replaying captured graphs and by one running the same bodies eagerly:
  streams, pools outside page 0, launch counts and the capacity report
  equal (deepseek-v2 smoke: preemption and sampling, deterministic
  algorithms; ``prefix_cache=True`` raises);
* a captured prefill chunk at T = 1, at T = ``prefill_chunk`` and at a
  ragged T, each equal bit for bit to its eager body on pools in the
  same state (logits and pools), replayed at a second offset too; a
  captured bucket equal to its eager body outside page 0;
* the sampler on the card: 20 000 seeded draws from one row, none outside
  the kept set, total variation against the filtered, tempered softmax
  within ``sampling.tv_null_bound``.

bf16 smoke widths.  Imports no JAX.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke
from repro_torch.models import init_params
from repro_torch.models.params import tree_leaves
from repro_torch.serve import (Engine, EngineConfig, GenerateConfig,
                               sampling)
from repro_torch.serve import engine as teng_mod
from repro_torch.serve import graphs as tgraphs
from repro_torch.serve.crosscheck import capacity_report

pytestmark = pytest.mark.cuda

PAGE = 8                       # the MLA kernels take pages of 8, 16 or 32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs, CUDA kernels)")
    return torch.device("cuda")


_MODELS: dict = {}


def _model(arch):
    """bf16 smoke config of ``arch`` and its random weights on the card."""
    if arch not in _MODELS:
        cfg = dataclasses.replace(smoke(get_config(arch)), dtype="bfloat16")
        gen = torch.Generator(device="cuda").manual_seed(0)
        _MODELS[arch] = (cfg, init_params(cfg, gen, "cuda"))
    return _MODELS[arch]


@contextlib.contextmanager
def _deterministic(cfg):
    moe = any(b.ffn == "moe" for b in cfg.block_pattern)
    torch.use_deterministic_algorithms(moe, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _counts():
    return {fn.__name__: fn.launches for fn in tgraphs.launch_counters()}


def _pools(engine):
    return [t[:, 1:].clone() for t in tree_leaves(engine._kv.pools)]


def _serve(engine, waves, gen, seeds):
    before = _counts()
    reqs = []
    for prompts in waves:
        reqs += [engine.submit(p, gen, seed=None if seeds is None
                               else seeds[len(reqs) + i])
                 for i, p in enumerate(prompts)]
        engine.run()
    torch.cuda.synchronize()
    after = _counts()
    return reqs, {k: after[k] - before[k] for k in after
                  if after[k] != before[k]}


def _graphed_equals_eager(cfg, params, waves, gen, seeds=None, **ecfg):
    out = {}
    with _deterministic(cfg):
        for graphs in (False, True):
            engine = Engine(cfg, params, EngineConfig(
                num_slots=2, page_size=PAGE, max_len=32, prefill_chunk=8,
                cuda_graphs=graphs, device="cuda", **ecfg))
            reqs, launches = _serve(engine, waves, gen, seeds)
            assert all(r.finish_reason == "length" for r in reqs)
            engine._kv.pool.check(engine._kv.table_refs())
            out[graphs] = ([r.generated for r in reqs], _pools(engine),
                           launches, capacity_report(engine), engine)
    (s_g, p_g, n_g, c_g, eng), (s_e, p_e, n_e, c_e, _) = out[True], out[False]
    assert s_g == s_e
    assert all(torch.equal(a, b) for a, b in zip(p_g, p_e))
    assert n_g == n_e and n_g
    assert c_g == c_e
    assert eng.graphs and all(
        f"prefill_{kind}:{n}" in eng._graphs.graphs
        for kind, n in eng.prefill_shapes)
    return eng, c_g, s_g


def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n) for n in lens]


def test_prefix_sharing_graphed_equals_eager(card):
    cfg, params = _model("qwen3-0.6b")
    shared, repeat = _prompts(cfg, (12, 8), seed=5)
    tails = [np.concatenate([shared, t]) for t in _prompts(cfg, (5, 3, 9))]
    waves = [[tails[0], repeat], [tails[1], tails[2], repeat]]
    eng, cap, _ = _graphed_equals_eager(cfg, params, waves,
                                        GenerateConfig(max_new_tokens=6),
                                        prefix_cache=True)
    assert cap["pages_deduped"] > 0 and cap["cow_copies"] > 0
    assert ("chunk", 1) in eng.prefill_shapes      # the aligned full hit


@pytest.mark.parametrize("mode", ["swap", "recompute"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_preemption_graphed_equals_eager(card, arch, mode):
    cfg, params = _model(arch)
    eng, cap, _ = _graphed_equals_eager(
        cfg, params, [_prompts(cfg, (6, 13, 9))],
        GenerateConfig(max_new_tokens=10), num_pages=5, preempt_mode=mode)
    assert cap["preemptions"] > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_sampled_graphed_equals_eager(card, arch):
    cfg, params = _model(arch)
    prompts = _prompts(cfg, (6, 13, 9))
    gen = GenerateConfig(max_new_tokens=8, temperature=0.8, top_k=50,
                         top_p=0.9)
    _, _, sampled = _graphed_equals_eager(
        cfg, params, [prompts], gen,
        seeds=[sampling.fold_seed(11, b) for b in range(3)])
    _, _, greedy = _graphed_equals_eager(
        cfg, params, [prompts], GenerateConfig(max_new_tokens=8))
    assert sampled != greedy


def test_deepseek_refuses_prefix_cache(card):
    cfg, params = _model("deepseek-v2-236b")
    with pytest.raises(NotImplementedError, match="prefix sharing"):
        Engine(cfg, params, EngineConfig(prefix_cache=True,
                                         device="cuda")).reset()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_captured_chunk_equals_eager_body(card, arch):
    """Chunks of T = 1, T = 8 (the prefill chunk) and T = 5 at offset 3,
    then replayed at offset 13: the graph's logits and pools equal the
    eager body's, run on a second engine's pools in the same state, bit
    for bit."""
    cfg, params = _model(arch)
    engines = {g: Engine(cfg, params, EngineConfig(
        num_slots=2, page_size=PAGE, max_len=32, prefill_chunk=8,
        cuda_graphs=g, device="cuda")) for g in (False, True)}
    for e in engines.values():
        e.reset()
        assert e._kv.alloc(30) == 0
    rng = np.random.default_rng(7)
    with _deterministic(cfg):
        for T, offsets in ((1, (3, 13)), (8, (3, 13)), (5, (3, 13))):
            for off in offsets:
                toks = rng.integers(0, cfg.vocab_size, (1, T))
                got = {}
                for g, e in engines.items():
                    inp = e._prefill_in
                    inp.row.set(e._kv.block_tables[0])
                    inp.offset.set(off)
                    inp.tokens(T).set(toks)
                    got[g] = e._graphs.run(
                        f"prefill_chunk:{T}",
                        functools.partial(e._chunk_body, T)).clone()
                torch.cuda.synchronize()
                assert torch.equal(got[True], got[False]), (T, off)
                assert all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(engines[True]._kv.pools),
                    tree_leaves(engines[False]._kv.pools)))
    held = engines[True]._graphs.graphs
    assert {"prefill_chunk:1", "prefill_chunk:8", "prefill_chunk:5"} <= set(
        held) and all(g.graph is not None for g in held.values())


def test_captured_bucket_equals_eager_body(card):
    """Prompts of 11 and then 9 tokens through one captured bucket of 16:
    logits equal the eager body's bit for bit, pools outside page 0."""
    cfg, params = _model("qwen3-0.6b")
    engines = {g: Engine(cfg, params, EngineConfig(
        num_slots=2, page_size=PAGE, max_len=32, cuda_graphs=g,
        device="cuda")) for g in (False, True)}
    for e in engines.values():
        e.reset()
    rng = np.random.default_rng(9)
    for L in (11, 9):
        toks = np.zeros((1, 16), np.int64)
        toks[0, :L] = rng.integers(0, cfg.vocab_size, L)
        got = {}
        for g, e in engines.items():
            slot = e._kv.alloc(L)
            inp = e._prefill_in
            inp.row.set(e._kv.block_tables[slot])
            inp.length.set(L)
            inp.tokens(16).set(toks)
            got[g] = e._graphs.run("prefill_bucket:16", functools.partial(
                teng_mod.bucket_prefill_body, e.params, e.cfg, e._kv, inp,
                16)).clone()
        torch.cuda.synchronize()
        assert torch.equal(got[True], got[False]), L
        assert all(torch.equal(a, b) for a, b in zip(
            _pools(engines[True]), _pools(engines[False])))
    assert engines[True]._graphs.graphs["prefill_bucket:16"].graph is not None


def test_sampler_distribution_on_the_card(card):
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = torch.randn(151936, generator=gen, device="cuda") * 3
    t, k, p, n, batch = 0.8, 50, 0.9, 20000, 1000
    target = sampling.target_distribution(row, t, k, p)
    draws = [sampling.sample_tokens(
        row[None].expand(batch, -1), np.arange(i, i + batch),
        np.zeros(batch, np.int32), np.full(batch, t, np.float32),
        np.full(batch, k, np.int32), np.full(batch, p, np.float32)).cpu()
        for i in range(0, n, batch)]
    toks = torch.cat(draws).numpy()
    assert target[toks].min() > 0                   # all in the kept set
    freq = np.bincount(toks, minlength=row.numel()) / n
    assert 0.5 * np.abs(freq - target).sum() <= sampling.tv_null_bound(
        target, n)
