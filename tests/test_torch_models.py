"""The port's model functions against the JAX package's, on the same
weights (carried across by repro_torch.bridge) and the same token ids:
layers, whole-prompt prefill, chunked paged prefill and teacher-forced
paged decode, on the smoke configs of four dense archs and two MoE archs
(deepseek-v2: MLA + MoE; kimi-k2: GQA + MoE) at float32.

Tolerance: float32 on both sides, different op order (XLA vs ATen) over
two layers -> |diff| <= 1e-5 + 1e-4 * |ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models as jm
from repro.models import layers as jl
from repro.parallel.sharding import tree_instantiate
import repro_torch.configs as tcfg
import repro_torch.models as tm
from repro_torch import bridge
from repro_torch.models import layers as tl
from repro_torch.models.params import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["qwen3-0.6b", "qwen3-14b", "minicpm-2b", "minitron-4b",
         "deepseek-v2-236b", "kimi-k2-1t-a32b"]
PAGE = 4


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jc = jcfg.smoke(jcfg.get_config(request.param))
    tc = tcfg.smoke(tcfg.get_config(request.param))
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.prepare_params(
        bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu"), tc)
    return jc, tc, jp, tp


def _tokens(cfg, seed, n):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (1, n))


def _pools(jc, tc, n_pages):
    jpools = tree_instantiate(jm.paged_cache_defs(jc, 2, n_pages, PAGE),
                              jax.random.key(0))
    tpools = bridge.to_torch(jax.tree.map(np.asarray, jpools),
                             device="cpu")
    return jpools, tpools


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _without_cast(tp):
    return {**tp, "embed": {k: v for k, v in tp["embed"].items()
                            if k != "tok_cast"}}


def test_params_tree_matches_reference_layout(model):
    """Same leaves, shapes and dtypes in the same order — for bridged
    weights and for the port's own init_params."""
    jc, tc, jp, tp = model
    want = [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(jp)]
    fresh = tm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    for tree in (tp, fresh):
        got = [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
               for t in tree_leaves(_without_cast(tree))]
        assert got == want
    assert tm.param_count(tc) == jm.param_count(jc)


def test_prefill_padded_matches(model):
    jc, tc, jp, tp = model
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = _tokens(jc, 1, 11)
    jl_, js = jm.prefill_padded(jp, jc, jnp.asarray(toks), jnp.int32(11))
    tl_, ts = tm.prefill_padded(tp, tc, torch.from_numpy(toks).long(), 11)
    _close(tl_, jl_)
    for got, want in zip(jax.tree.leaves(bridge.to_numpy(ts)),
                         jax.tree.leaves(jax.tree.map(np.asarray, js))):
        _close(got, want)


def _prefill_both(jc, tc, jp, tp, toks, chunks, n_pages, table):
    jpools, tpools = _pools(jc, tc, n_pages)
    jbt, tbt = jnp.asarray(table), torch.from_numpy(table)
    for a, b in chunks:
        jlog, jpools = jm.prefill_chunk_paged(
            jp, jc, jpools, jbt, jnp.int32(0), jnp.asarray(toks[:, a:b]),
            jnp.int32(a), page_size=PAGE)
        tlog = tm.prefill_chunk_paged(tp, tc, tpools, tbt,
                                      torch.from_numpy(toks[:, a:b]).long(),
                                      a, page_size=PAGE)
        _close(tlog, jlog)
    return jpools, tpools


def test_prefill_chunk_paged_matches(model):
    jc, tc, jp, tp = model
    toks = _tokens(jc, 2, 11)
    table = np.array([3, 1, 4, 0, 0], np.int32)
    jpools, tpools = _prefill_both(jc, tc, jp, tp, toks,
                                   [(0, 5), (5, 9), (9, 11)], 6, table)
    for got, want in zip(jax.tree.leaves(bridge.to_numpy(tpools)),
                         jax.tree.leaves(jax.tree.map(np.asarray, jpools))):
        _close(got, want)


def test_decode_step_paged_teacher_forced_matches(model):
    """Slot 0 decodes after a chunked prefill, slot 1 is an idle lane on
    the trash page; three teacher-forced steps, logits compared each
    step (the live row; the idle row is garbage either way)."""
    jc, tc, jp, tp = model
    toks = _tokens(jc, 3, 14)
    row = np.array([2, 5, 1, 4, 0], np.int32)
    jpools, tpools = _prefill_both(jc, tc, jp, tp, toks[:, :10],
                                   [(0, 10)], 6, row)
    bt = np.stack([row, np.zeros_like(row)])
    for step in range(3):
        p = 10 + step
        tok = np.array([[toks[0, p]], [0]], np.int32)
        pos = np.array([p, 0], np.int32)
        jlog, jpools = jm.decode_step_paged(
            jp, jc, jpools, jnp.asarray(bt), jnp.asarray(tok),
            jnp.asarray(pos), jnp.asarray([True, False]), page_size=PAGE,
            backend="jnp")
        tlog = tm.decode_step_paged(tp, tc, tpools, torch.from_numpy(bt),
                                    torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos), page_size=PAGE)
        _close(tlog[0], jlog[0])
        assert np.isfinite(tlog.numpy()).all()


def test_layers_match():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.randint(0, 500, (2, 5)).astype(np.int32)
    jc, jsn = jl.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
    tc_, tsn = tl.rope_cos_sin(torch.from_numpy(pos), 16, 1e6)
    _close(tc_, jc)
    _close(tsn, jsn)
    _close(tl.apply_rope(torch.from_numpy(x), tc_, tsn),
           jl.apply_rope(jnp.asarray(x), jc, jsn))
    scale = rng.standard_normal((16,)).astype(np.float32)
    _close(tl.rms_head_norm(torch.from_numpy(scale), torch.from_numpy(x),
                            1e-6),
           jl.rms_head_norm(jnp.asarray(scale), jnp.asarray(x), 1e-6))
    h = rng.standard_normal((4, 8)).astype(np.float32)
    g = rng.standard_normal((4, 8)).astype(np.float32)
    for act in ("silu_glu", "gelu_glu", "gelu", "relu2", "silu"):
        _close(tl.activate(torch.from_numpy(h), torch.from_numpy(g), act),
               jl.activate(jnp.asarray(h), jnp.asarray(g), act))
    for norm in ("rms", "layer"):
        cfg_j = jcfg.smoke(jcfg.get_config("qwen3-0.6b"))
        cfg_t = tcfg.smoke(tcfg.get_config("qwen3-0.6b"))
        cfg_j = dataclasses.replace(cfg_j, norm=norm)
        cfg_t = dataclasses.replace(cfg_t, norm=norm)
        p = {"scale": rng.standard_normal((16,)).astype(np.float32),
             "bias": rng.standard_normal((16,)).astype(np.float32)}
        _close(tl.apply_norm(bridge.to_torch(p, device="cpu"),
                             torch.from_numpy(x), cfg_t),
               jl.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             cfg_j))
