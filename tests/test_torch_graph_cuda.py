"""Captured step graphs against the eager steps on the card, bit for bit.

Needs an NVIDIA card with nvcc (marked ``cuda``; skips elsewhere).  On
the card, from the repo root:

    python -m pytest -m cuda tests/test_torch_graph_cuda.py

Each test serves the same requests through two engines on the same
weights, one replaying captured graphs (``cuda_graphs=True``) and one
running the same step bodies eagerly (``cuda_graphs=False``), and wants
every step's output (decode and verify logits, a draft model's catch-up
and draft logits, every prefill chunk's and bucket's last logits), the
final page pools and the token streams equal by
``torch.equal``, and the kernel wrappers' launch counts equal: at bf16,
int8 and fp8_e4m3 pools, with pipeline off and double, after a
``reset()`` (which recaptures), and after a larger eager verify call on
the same stream (the GQA counters a graph holds are not regrown).
bf16 smoke widths, so the tensor-core cores run.  Imports no JAX.
"""

import contextlib
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import decode_step_verify_paged, init_params
from repro_torch.models.params import tree_leaves
from repro_torch.serve import (Engine, EngineConfig, GenerateConfig,
                               SpecConfig, SpecEngine)
from repro_torch.serve import graphs as tgraphs

pytestmark = pytest.mark.cuda

KV_DTYPES = (None, "int8", "fp8_e4m3")
PROMPTS = (5, 11, 7, 16)


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
    """Deterministic algorithms for an MoE model (its combine's
    ``index_add_``), as ``chip_smoke.py``'s comparisons run."""
    moe = any(b.ffn == "moe" for b in cfg.block_pattern)
    torch.use_deterministic_algorithms(moe, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.fixture
def step_log(monkeypatch):
    """Every step output, as (step name, a copy), in call order."""
    log = []
    real = tgraphs.StepGraphs.run

    def run(self, name, body):
        out = real(self, name, body)
        log.append((name, out.clone()))
        return out

    monkeypatch.setattr(tgraphs.StepGraphs, "run", run)
    return log


def _counts():
    return {fn.__name__: fn.launches for fn in tgraphs.launch_counters()}


def _serve(make, graphs, step_log, prompts=PROMPTS, new=6, reset=False):
    """Serve ``prompts`` on ``make(graphs)``; returns (streams, step
    outputs, launch counts of the run, engine).  With ``reset`` the
    engine serves them, resets (dropping its graphs) and serves them
    again."""
    engine = make(graphs)
    rng = np.random.default_rng(3)
    toks = [rng.integers(0, engine.cfg.vocab_size, n) for n in prompts]
    step_log.clear()
    before = _counts()
    streams = []
    for rnd in range(2 if reset else 1):
        if rnd:
            engine.reset()
        reqs = [engine.submit(t, GenerateConfig(max_new_tokens=new))
                for t in toks]
        engine.run()
        streams.append([list(r.generated) for r in reqs])
    torch.cuda.synchronize()
    after = _counts()
    launches = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    return streams, list(step_log), launches, engine


def _pools(engine):
    """Every page-pool leaf without the trash page 0 (idle lanes' writes
    land there in no fixed order)."""
    out = [t[:, 1:].clone() for t in tree_leaves(engine._kv.pools)]
    prop = getattr(engine, "proposer", None)
    if prop is not None and hasattr(prop, "kv"):
        out += [t[:, 1:].clone() for t in tree_leaves(prop.kv.pools)]
    return out


def _equal(a, b):
    if a.dtype == torch.float8_e4m3fn:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a, b)


def _compare(make, step_log, names, **kw):
    with _deterministic(make(False).cfg):
        s_eager, o_eager, n_eager, e_eager = _serve(make, False, step_log,
                                                    **kw)
        s_graph, o_graph, n_graph, e_graph = _serve(make, True, step_log,
                                                    **kw)
    assert s_graph == s_eager
    assert [n for n, _ in o_graph] == [n for n, _ in o_eager]
    # the prefill chunks and buckets are captured steps too (one a shape)
    steps = {n for n, _ in o_graph}
    assert {n for n in steps if not n.startswith("prefill_")} == set(names)
    for i, ((name, g), (_, e)) in enumerate(zip(o_graph, o_eager)):
        assert _equal(g, e), f"step {i} ({name}) differs"
    for g, e in zip(_pools(e_graph), _pools(e_eager)):
        assert _equal(g, e)
    # launch counts under replay: what the eager steps launched
    assert n_graph == n_eager and n_graph
    graphs = e_graph._graphs.graphs
    assert e_graph.graphs and set(graphs) <= steps
    assert all(g.graph is not None for g in graphs.values())
    return e_graph


@pytest.mark.parametrize("pipeline", ["off", "double"])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_decode_graph_equals_eager_step(card, step_log, arch, kv_dtype,
                                        pipeline):
    cfg, params = _model(arch)

    def make(graphs):
        return Engine(cfg, params, EngineConfig(
            num_slots=3, page_size=16, max_len=48, prefill_chunk=8,
            kv_dtype=kv_dtype, pipeline=pipeline, cuda_graphs=graphs,
            device="cuda"))

    _compare(make, step_log, {"decode"})


@pytest.mark.parametrize("pipeline", ["off", "double"])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("arch,proposer", [("qwen3-0.6b", "draft"),
                                           ("deepseek-v2-236b", "ngram")])
def test_verify_and_draft_graphs_equal_eager_steps(card, step_log, arch,
                                                   proposer, kv_dtype,
                                                   pipeline):
    cfg, params = _model(arch)
    scfg = SpecConfig(k=3, proposer=proposer,
                      draft_cfg=cfg if proposer == "draft" else None,
                      draft_params=params if proposer == "draft" else None)

    def make(graphs):
        return SpecEngine(cfg, params, EngineConfig(
            num_slots=3, page_size=16, max_len=48, prefill_chunk=8,
            kv_dtype=kv_dtype, pipeline=pipeline, cuda_graphs=graphs,
            device="cuda"), scfg)

    names = ({"verify", "catchup", "draft"} if proposer == "draft"
             else {"verify"})
    engine = _compare(make, step_log, names)
    if proposer == "draft":
        held = set(engine.proposer._graphs.graphs)
        buckets = {n for n in held if n.startswith("prefill_bucket:")}
        assert held - buckets == {"catchup", "draft"} and buckets


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_reset_recaptures(card, step_log, arch):
    cfg, params = _model(arch)

    def make(graphs):
        return SpecEngine(cfg, params, EngineConfig(
            num_slots=2, page_size=16, max_len=48, cuda_graphs=graphs,
            device="cuda"), SpecConfig(k=2, proposer="draft", draft_cfg=cfg,
                                       draft_params=params))

    engine = _compare(make, step_log, {"verify", "catchup", "draft"},
                      prompts=(6, 9, 13), reset=True)
    # generate() builds and drops its own pools, and their graphs
    out = engine.generate(np.ones((2, 5), np.int32), GenerateConfig(4))
    assert out["tokens"].shape == (2, 9) and engine._graphs is None


def test_gqa_counters_not_regrown_under_a_held_graph(card, step_log):
    cfg, params = _model("qwen3-0.6b")
    stream = torch.cuda.current_stream().cuda_stream
    big = {}

    class Probed(Engine):
        """After its third decode step (the graph captured and replayed),
        a verify call larger than any before it on the engine's stream,
        on copies of its pools: it needs more row groups than the
        stream's counters hold, so they are replaced."""

        def _decode_sample(self):
            tok = super()._decode_sample()
            if self.graphs and self.decode_steps == 2 and not big:
                held = self._graphs.counters
                big["held"] = (held, held.data_ptr(), held.numel())
                big["old"] = pa._gqa_counters.get((0, stream))
                kv = self._kv
                B, KV = self.ecfg.num_slots, self.cfg.n_kv_heads
                G = self.cfg.n_heads // KV
                have = big["old"].numel() if big["old"] is not None else 0
                tiles = -(-(max(have, 1024) + 1) // (B * KV))
                T = tiles * pa.GQA_ROW_TILE // G
                pools = [{b: {k: t.clone() for k, t in blk.items()}
                          for b, blk in seg.items()} for seg in kv.pools]
                feed = torch.zeros((B, T), dtype=torch.long, device="cuda")
                pos = torch.zeros((B,), dtype=torch.int32, device="cuda")
                n = pa.paged_attention_verify.launches
                decode_step_verify_paged(self.params, self.cfg, pools,
                                         kv.tables.tensor, feed, pos,
                                         page_size=self.ecfg.page_size)
                pa.paged_attention_verify.launches = n   # not the run's
                big["new"] = pa._gqa_counters[(0, stream)]
            return tok

    def make(graphs):
        return Probed(cfg, params, EngineConfig(
            num_slots=3, page_size=16, max_len=48, cuda_graphs=graphs,
            device="cuda"))

    _compare(make, step_log, {"decode"}, new=8)
    held, ptr, n = big["held"]
    assert big["new"] is not big["old"]            # the stream's regrew
    assert big["new"].numel() > n
    assert held.data_ptr() == ptr and held.numel() == n
    assert int(held.abs().sum()) == 0              # every merge reset it


def test_graphed_engines_are_freed_without_a_collection(card):
    """A captured engine holds no reference cycle (its graphs keep no
    bound method of it), so dropping it frees its weights' last
    references and its pools at once, not at the next collection."""
    cfg, params = _model("qwen3-0.6b")
    gc.disable()
    try:
        refs = []
        for make in (
                lambda: Engine(cfg, params, EngineConfig(
                    num_slots=2, page_size=16, max_len=48, device="cuda")),
                lambda: SpecEngine(cfg, params, EngineConfig(
                    num_slots=2, page_size=16, max_len=48, device="cuda"),
                    SpecConfig(k=2, proposer="draft", draft_cfg=cfg,
                               draft_params=params))):
            engine = make()
            engine.submit(np.arange(7) % cfg.vocab_size, GenerateConfig(5))
            engine.run()
            assert engine._graphs.graphs                 # captured
            refs.append(weakref.ref(engine))
            del engine
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_held_counters_refuse_a_larger_call(card):
    rng = np.random.default_rng(0)
    B, KV, G, hd, page, nb = 4, 2, 2, 16, 16, 3
    q = torch.as_tensor(rng.standard_normal((B, KV, G, hd)),
                        dtype=torch.bfloat16, device="cuda")
    k = torch.as_tensor(rng.standard_normal((1 + B * nb, page, KV, hd)),
                        dtype=torch.bfloat16, device="cuda")
    bt = torch.as_tensor(1 + np.arange(B * nb).reshape(B, nb),
                         dtype=torch.int32, device="cuda")
    pos = torch.full((B,), 30, dtype=torch.int32, device="cuda")
    need = pa.gqa_row_groups(B, 1, KV, G)
    with pa.hold_gqa_counters(pa.gqa_counters(need - 1, card)):
        with pytest.raises(ValueError, match="held GQA counters"):
            pa.paged_attention(q, k, k, bt, pos, scale=0.25)
    buf = pa.gqa_counters(need, card)
    with pa.hold_gqa_counters(buf):
        got = pa.paged_attention(q, k, k, bt, pos, scale=0.25)
    want = pa.paged_attention(q, k, k, bt, pos, scale=0.25)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(buf.abs().sum()) == 0
