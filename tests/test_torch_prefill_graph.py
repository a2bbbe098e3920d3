"""The fixed-shape prefill bodies the port captures as CUDA graphs, held
against the JAX package on the CPU.

The engine runs one body both ways: a prefill chunk of T tokens reads
its tokens, block-table row and offset from persistent buffers (the
offset a 0-d tensor), and a whole prompt bucketed to S tokens reads its
true length as a 0-d tensor and scatters all S collected positions into
the pages, the pad positions onto the trash page (page 0).  On the CPU
the same bodies run eagerly, so here they are held against ``repro``:

* a chunk with a tensor offset (T = 1 included) and a bucket with a
  tensor length against ``repro.models.prefill_chunk_paged`` /
  ``prefill_padded``: last logits and pools at the model tolerance;
* the bucket's fixed-shape scatter: outside page 0 its pools hold the
  collected states it was given at ``[0, true_len)``, bit for bit, and
  nothing else;
* the engines (staggered admission, chunked prefill, prefix cache with
  an aligned full hit, swap and recompute preemption, and the draft
  model's bucketed prefill under a speculative engine): greedy streams
  equal to ``repro``'s, pools equal outside page 0 at the model
  tolerance, and the recorded bucket shapes equal ``repro``'s
  ``Engine.prefill_shapes``;
* capturability: each prefill body, run on meta tensors, makes no host
  sync, no ``nonzero`` and no cross-device copy (the watcher of
  ``test_torch_graph.py``).

Tolerance: float32 on both sides, XLA vs ATen op order, rtol 1e-4 /
atol 1e-5 (``test_torch_models.py``'s).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models as jm
import repro.serve as jserve
from repro.parallel.sharding import tree_instantiate
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.serve as tserve
from repro_torch import bridge
from repro_torch.models.params import tree_leaves
from repro_torch.serve import engine as teng_mod
from repro_torch.serve import graphs as tgraphs
from repro_torch.serve.kv_cache import PagedKVCache
from test_torch_graph import (_capturable, _meta_buffers, _on_meta,
                              stubbed_paged_ops)  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-5)
PAGE = 4


def _load(arch):
    jc = jcfg.smoke(jcfg.get_config(arch))
    tc = tcfg.smoke(tcfg.get_config(arch))
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.prepare_params(
        bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu"), tc)
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def qwen():
    return _load("qwen3-0.6b")


@pytest.fixture(scope="module")
def deepseek():
    return _load("deepseek-v2-236b")


def _prompt(seed, length, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, length).astype(
        np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _pools_close(tpools, jpools, first_page=1):
    """Every pool leaf of the port's and repro's equal at the model
    tolerance from page ``first_page`` on (1: the trash page left out)."""
    got = jax.tree.leaves(bridge.to_numpy(tpools))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jpools))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g[:, first_page:], w[:, first_page:])


# --------------------------------------------------------------------------
# The bodies against repro's model functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen", "deepseek"])
def test_chunk_with_tensor_offset_matches_reference(arch, qwen, deepseek):
    """Chunks (0, 5), (5, 6) (T = 1) and (6, 11) with a 0-d int32 offset:
    last logits and written pools equal repro's prefill_chunk_paged."""
    jc, tc, jp, tp = {"qwen": qwen, "deepseek": deepseek}[arch]
    toks = np.random.RandomState(3).randint(0, jc.vocab_size, (1, 11))
    table = np.array([3, 1, 4, 0, 0], np.int32)
    jpools = tree_instantiate(jm.paged_cache_defs(jc, 2, 6, PAGE),
                              jax.random.key(0))
    tpools = bridge.to_torch(jax.tree.map(np.asarray, jpools), device="cpu")
    for a, b in [(0, 5), (5, 6), (6, 11)]:
        jlog, jpools = jm.prefill_chunk_paged(
            jp, jc, jpools, jnp.asarray(table), jnp.int32(0),
            jnp.asarray(toks[:, a:b]), jnp.int32(a), page_size=PAGE)
        tlog = tm.prefill_chunk_paged(
            tp, tc, tpools, torch.from_numpy(table),
            torch.from_numpy(toks[:, a:b]).long(),
            torch.tensor(a, dtype=torch.int32), page_size=PAGE)
        _close(tlog, jlog)
    _pools_close(tpools, jpools, first_page=0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_bucket_body_matches_reference_and_scatters_to_the_trash(qwen,
                                                                  kv_dtype):
    """The bucket body on an 11-token prompt padded to 16, its length a
    0-d tensor, in a 12-token table: last logits equal repro's
    prefill_padded; outside page 0 the pools hold exactly the collected
    states at positions [0, 11), bit for bit, written line by line here
    (quantized the engine's way), and nothing else: the pad positions
    and those past the table land on page 0 only."""
    jc, tc, jp, tp = qwen
    L, S = 11, 16
    toks = np.zeros((1, S), np.int64)
    toks[0, :L] = np.random.RandomState(4).randint(0, jc.vocab_size, L)
    jlast, _ = jm.prefill_padded(jp, jc, jnp.asarray(toks.astype(np.int32)),
                                 jnp.int32(L))
    cfg = tc if kv_dtype is None else dataclasses.replace(tc,
                                                           kv_dtype=kv_dtype)
    kv = PagedKVCache(cfg, 2, PAGE, 12, torch.device("cpu"))
    want = PagedKVCache(cfg, 2, PAGE, 12, torch.device("cpu"))
    slot = kv.alloc(L)
    assert want.alloc(L) == slot
    inp = tgraphs.PrefillInputs(kv.blocks_per_slot, torch.device("cpu"))
    inp.row.set(kv.block_tables[slot])
    inp.length.set(L)
    inp.tokens(S).set(toks)
    with torch.no_grad():
        last = teng_mod.bucket_prefill_body(tp, cfg, kv, inp, S)
        want_last, states = tm.prefill_padded(tp, cfg,
                                              torch.from_numpy(toks), L)
    _close(last, jlast)
    assert torch.equal(last, want_last)
    row = want.block_tables[slot]
    for pool, state in zip(tree_leaves(want.pools),
                           tree_leaves(want._quantize_states(states))):
        for pos in range(L):
            pool[:, row[pos // PAGE], pos % PAGE] = state[:, 0, pos]
    for got, ref in zip(tree_leaves(kv.pools), tree_leaves(want.pools)):
        assert torch.equal(got[:, 1:], ref[:, 1:])


# --------------------------------------------------------------------------
# Engines against repro's
# --------------------------------------------------------------------------

def _run_both(qwen, prompts, gen, waves=1, **ecfg):
    """Serve ``prompts`` (split into ``waves`` runs on the same engines)
    through repro's Engine and the port's; returns both engines and
    request lists."""
    jc, tc, jp, tp = qwen
    jeng = jserve.Engine(jc, jp, jserve.EngineConfig(**ecfg))
    teng = tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu", **ecfg))
    jreqs, treqs = [], []
    for part in np.array_split(np.arange(len(prompts)), waves):
        jreqs += [jeng.submit(prompts[i], jserve.GenerateConfig(**gen))
                  for i in part]
        treqs += [teng.submit(prompts[i], tserve.GenerateConfig(**gen))
                  for i in part]
        jeng.run()
        teng.run()
    return jeng, teng, jreqs, treqs


SCENARIOS = {
    # name: (prompts, gen, waves, engine config)
    "staggered": ([_prompt(10 + i, s) for i, s in enumerate([5, 8, 6, 8])],
                  dict(max_new_tokens=4), 1,
                  dict(num_slots=2, page_size=PAGE, max_len=16)),
    "chunked": ([_prompt(10 + i, s) for i, s in enumerate([5, 9, 6, 8])],
                dict(max_new_tokens=4), 1,
                dict(num_slots=2, page_size=PAGE, max_len=16,
                     prefill_chunk=3)),
    # a shared 8-token prefix, then the same 8-token prompt twice in a
    # second wave: an aligned full hit recomputes its last token (a T = 1
    # chunk) into the shared page, which copy-on-write copies first
    "prefix": ([np.concatenate([_prompt(100, 8), _prompt(101 + i, 2)])
                for i in range(3)] + [_prompt(100, 8)] * 2,
               dict(max_new_tokens=4), 2,
               dict(num_slots=2, page_size=PAGE, max_len=16,
                    prefix_cache=True, prefill_chunk=4)),
    "swap": ([_prompt(80 + i, 6) for i in range(2)],
             dict(max_new_tokens=8), 1,
             dict(num_slots=2, page_size=PAGE, max_len=16, num_pages=6,
                  preempt_mode="swap")),
    "recompute": ([_prompt(80 + i, 6) for i in range(2)],
                  dict(max_new_tokens=8), 1,
                  dict(num_slots=2, page_size=PAGE, max_len=16, num_pages=6,
                       preempt_mode="recompute", prefill_chunk=4)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_prefill_bodies_match_reference(qwen, name):
    prompts, gen, waves, ecfg = SCENARIOS[name]
    jeng, teng, jreqs, treqs = _run_both(qwen, prompts, gen, waves, **ecfg)
    for j, t in zip(jreqs, treqs):
        assert t.generated == [int(x) for x in j.generated], t.request_id
    _pools_close(teng._kv.pools, jeng._kv.pools)
    buckets = {S for kind, S in teng.prefill_shapes if kind == "bucket"}
    assert buckets == set(jeng.prefill_shapes)
    chunks = {T for kind, T in teng.prefill_shapes if kind == "chunk"}
    assert bool(chunks) == (ecfg.get("prefill_chunk", 0) > 0
                            or name == "prefix")
    if name == "prefix":
        stats = teng._kv.pool.stats
        assert 1 in chunks                     # the aligned full hit
        assert stats.dedup_hits > 0 and stats.cow_copies > 0
        assert stats.cow_copies == jeng._kv.pool.stats.cow_copies
    if name in ("swap", "recompute"):
        assert teng._sched.preempt_count == jeng._sched.preempt_count > 0
    teng._kv.pool.check(teng._kv.table_refs())


def test_draft_bucket_prefill_matches_reference(qwen):
    """The draft model's bucketed prefill (its own graphs and inputs):
    a speculative engine whose pool preempts by recompute, so a resumed
    request re-admits into the draft model at a longer bucket; greedy
    streams and the draft's pools equal repro's (outside page 0)."""
    jc, tc, jp, tp = qwen
    ecfg = dict(num_slots=2, page_size=PAGE, max_len=20, num_pages=9,
                preempt_mode="recompute")
    jeng = jserve.SpecEngine(jc, jp, jserve.EngineConfig(**ecfg),
                             jserve.SpecConfig(k=2, proposer="draft",
                                               draft_cfg=jc, draft_params=jp))
    teng = tserve.SpecEngine(tc, tp, tserve.EngineConfig(device="cpu", **ecfg),
                             tserve.SpecConfig(k=2, proposer="draft",
                                               draft_cfg=tc, draft_params=tp))
    prompts = [_prompt(60 + i, n) for i, n in enumerate([6, 9])]
    gen = dict(max_new_tokens=10)
    teng.reset()
    steps, real = [], teng.proposer._graphs.run
    teng.proposer._graphs.run = lambda name, body: (
        steps.append(name), real(name, body))[1]
    jreqs = [jeng.submit(p, jserve.GenerateConfig(**gen)) for p in prompts]
    treqs = [teng.submit(p, tserve.GenerateConfig(**gen)) for p in prompts]
    jeng.run()
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.generated == [int(x) for x in j.generated], t.request_id
    assert teng._sched.preempt_count == jeng._sched.preempt_count > 0
    buckets = sorted({n for n in steps if n.startswith("prefill_bucket:")})
    assert len(buckets) >= 2, buckets            # the resume's longer one
    _pools_close(teng.proposer.kv.pools, jeng.proposer.kv.pools)


# --------------------------------------------------------------------------
# Capturability
# --------------------------------------------------------------------------

def _meta_engine(eng):
    eng.params = _on_meta(eng.params)
    eng._kv.pools = _on_meta(eng._kv.pools)
    eng._kv.tables.tensor = _on_meta(eng._kv.tables.tensor)


def _meta_prefill_inputs(inp, lengths):
    for T in lengths:
        inp.tokens(T)
    _meta_buffers(inp, ["row", "offset", "length"])
    for s in inp._tokens.values():
        s.tensor = _on_meta(s.tensor)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
@pytest.mark.parametrize("arch", ["qwen", "deepseek"])
def test_prefill_bodies_are_capturable(arch, kv_dtype, qwen, deepseek,
                                       stubbed_paged_ops):
    """The chunk body (T = 1 and 5), the bucket body (S 16; qwen, whose
    FFN is dense) and the draft model's bucket body read only persistent
    buffers: on meta tensors they make no host sync, no nonzero and no
    cross-device copy."""
    _, tc, _, tp = {"qwen": qwen, "deepseek": deepseek}[arch]
    eng = tserve.SpecEngine(
        tc, tp, tserve.EngineConfig(device="cpu", kv_dtype=kv_dtype,
                                    num_slots=2, page_size=PAGE, max_len=16),
        tserve.SpecConfig(k=2, proposer="draft", draft_cfg=tc,
                          draft_params=tp))
    eng.reset()
    prop = eng.proposer
    _meta_engine(eng)
    prop.params = _on_meta(prop.params)
    prop.kv.pools = _on_meta(prop.kv.pools)
    _meta_prefill_inputs(eng._prefill_in, (1, 5, 16))
    _meta_prefill_inputs(prop._prefill_in, (16,))
    bodies = {f"chunk T={T}": functools.partial(eng._chunk_body, T)
              for T in (1, 5)}
    if eng._bucketable:
        bodies["bucket"] = functools.partial(
            teng_mod.bucket_prefill_body, eng.params, eng.cfg, eng._kv,
            eng._prefill_in, 16)
        bodies["draft bucket"] = functools.partial(
            teng_mod.bucket_prefill_body, prop.params, prop.cfg, prop.kv,
            prop._prefill_in, 16)
    for name, body in bodies.items():
        watch = _capturable(body)
        assert watch.ops > 50, name
        assert watch.found == [], (name, watch.found)
