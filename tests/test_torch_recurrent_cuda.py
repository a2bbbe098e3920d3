"""The recurrent and hybrid archs (xlstm-350m, jamba-v0.1-52b) graphed
against eager on the card, bit for bit.

Needs an NVIDIA card with nvcc (marked ``cuda``; skips elsewhere).  On
the card, from the repo root:

    python -m pytest -m cuda tests/test_torch_recurrent_cuda.py

bf16 smoke widths (jamba's attention layer then runs the GQA core).
Each test serves the same requests through an engine replaying captured
graphs and one running the same step bodies eagerly and wants the token
streams, the final pools and state rows and the kernels' launch counts
equal (``torch.equal``); under staggered admission with chunked prefill
(one chunk graph per length serves every slot), and under swap and
recompute preemption in a small page pool (a swapped stream must equal
an unpreempted run's).  A slot idle through decode steps keeps its state
rows bit for bit.  Imports no JAX.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import init_params
from repro_torch.models.params import tree_leaves
from repro_torch.serve import Engine, EngineConfig, GenerateConfig
from repro_torch.serve.kv_cache import split_leaves

pytestmark = pytest.mark.cuda

ARCHS = ("xlstm-350m", "jamba-v0.1-52b")
PROMPTS = (5, 11, 7, 16, 9)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs, CUDA kernels)")
    return torch.device("cuda")


_MODELS: dict = {}


def _model(arch):
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


def _serve(cfg, params, graphs, **ecfg):
    eng = Engine(cfg, params, EngineConfig(
        device="cuda", cuda_graphs=graphs, **{
            "num_slots": 3, "page_size": 4, "max_len": 40, **ecfg}))
    rng = np.random.default_rng(2)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, n),
                       GenerateConfig(max_new_tokens=6)) for n in PROMPTS]
    pa.paged_attention.launches = 0
    with _deterministic(cfg):
        eng.run()
    torch.cuda.synchronize()
    return eng, [list(r.generated) for r in reqs], pa.paged_attention.launches


@pytest.mark.parametrize("prefill_chunk", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_equals_eager(card, arch, prefill_chunk):
    cfg, params = _model(arch)
    g, g_toks, g_n = _serve(cfg, params, True, prefill_chunk=prefill_chunk)
    e, e_toks, e_n = _serve(cfg, params, False, prefill_chunk=prefill_chunk)
    assert g_toks == e_toks
    assert g_n == e_n
    assert "decode" in g._graphs.graphs
    if prefill_chunk:
        # one chunk graph per length served every slot
        assert {k for k in g._graphs.graphs if k.startswith(
            "prefill_chunk")} == {f"prefill_chunk:{T}"
                                  for _, T in g.prefill_shapes}
    for a, b in zip(tree_leaves(g._kv.pools), tree_leaves(e._kv.pools)):
        assert torch.equal(a, b)
    if any(b.mixer == "attn" for b in cfg.block_pattern):
        assert g_n == g.decode_steps * sum(
            b.mixer == "attn" for b in cfg.block_pattern)
    else:
        assert g_n == 0


@pytest.mark.parametrize("graphs", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_idle_slot_keeps_its_state_rows(card, arch, graphs):
    """A slot whose request finished prefill but is excluded from the
    decode steps keeps its state rows bit for bit."""
    cfg, params = _model(arch)
    eng = Engine(cfg, params, EngineConfig(device="cuda", cuda_graphs=graphs,
                                           num_slots=3, page_size=4,
                                           max_len=40))
    rng = np.random.default_rng(3)
    for n in (6, 9, 7):
        eng.submit(rng.integers(0, cfg.vocab_size, n),
                   GenerateConfig(max_new_tokens=8))
    with _deterministic(cfg):
        eng.step()                     # prefill all three, first tokens
        rows = split_leaves(eng._kv.pools, eng._kv._paged)[1]
        idle = eng._sched.decode_requests()[1]
        before = [t[:, idle.slot].clone() for t in rows]
        others = [r for r in eng._sched.decode_requests() if r is not idle]
        moved = [t[:, others[0].slot].clone() for t in rows]
        for _ in range(3):
            eng._run_decode(others)
        torch.cuda.synchronize()
    for b, t in zip(before, rows):
        assert torch.equal(b, t[:, idle.slot])
    assert any(not torch.equal(m, t[:, others[0].slot])
               for m, t in zip(moved, rows))


@pytest.mark.parametrize("mode", ["swap", "recompute"])
@pytest.mark.parametrize("arch", ARCHS)
def test_preempted_streams_equal_unpreempted(card, arch, mode):
    """In a pool too small for every request, swap and recompute
    preemption run graphed and eagerly with equal streams; a swapped
    stream equals the fully backed run's.  (A recomputed state is the
    whole-context prefill's, which in bf16 rounds otherwise than the
    decode steps that built the preempted one.)"""
    cfg, params = _model(arch)
    _, base, _ = _serve(cfg, params, True, num_slots=2, max_len=24)
    runs = [_serve(cfg, params, g, num_slots=2, max_len=24, num_pages=7,
                   preempt_mode=mode) for g in (True, False)]
    assert runs[0][0]._sched.preempt_count > 0
    assert runs[0][1] == runs[1][1]
    if mode == "swap":
        assert runs[0][1] == base
