"""The static whole-batch path and the encoder-decoder / vision models
against the JAX package, on the CPU: cross attention (full sequence and
cached), the whisper encoder, ``forward_full`` with its collected states,
``decode_step`` over dense caches, ``StaticEngine.generate``, and the
static engine against the port's continuous engine.

Smoke configs in float32; one numpy weight tree (drawn from the port's
parameter defs by a seeded generator) goes into both packages,
``bridge.to_torch`` carrying it into the port, with every cross gate
(init 0, which would hide the cross path) set from a seeded numpy draw
in [0.5, 1.5) first.  The reference's decode step runs jitted.  The
port's dense caches round their sequence axis up to a multiple of 16
(the reference's do not), so caches are compared on the reference's
lines and the rest must stay zero; a source of 13 frames and a context
of 11 tokens hold the rounding.

Tolerances: modules atol = rtol = 1e-5 (float32 sums in other orders),
logits 1e-4 (several layers of them); token streams exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models as jm
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.models.common import BlockDef as JBlockDef
from repro.serve import engine as jengine
import repro_torch.configs as tcfg
import repro_torch.models as tm
from repro_torch import bridge
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.models.common import BlockDef
from repro_torch.models.params import instantiate, tree_leaves
from repro_torch.serve import (Engine, EngineConfig, GenerateConfig,
                               StaticEngine)
from repro_torch.serve.engine import _place_prefill_states

MOD_TOL = dict(atol=1e-5, rtol=1e-5)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)

# config replacements applied to both packages' smoke configs; an MLA
# model with dense FFNs (no MoE, whose capacity depends on the batch) also
# takes the pattern (BlockDef("mla", "dense"),) of each package
MLA_DENSE = dict(name="mla-dense-smoke", mla_absorb=True, n_experts=0,
                 moe_top_k=0, moe_d_ff=0, n_shared_experts=0,
                 moe_first_dense=0, n_layers=2)
VARIANTS = {
    "whisper-small": ("whisper-small", {}),
    "llama-3.2-vision-90b": ("llama-3.2-vision-90b", {}),
    "vision-qk-norm": ("llama-3.2-vision-90b", dict(qk_norm=True)),
    # a source of 13 frames: neither it nor its cache is 16-aligned
    "whisper-13-frames": ("whisper-small", dict(n_audio_frames=13)),
    "qwen3-0.6b": ("qwen3-0.6b", {}),
    "mla-absorb": ("deepseek-v2-236b", dict(mla_absorb=True)),
    "mla-expanded": ("deepseek-v2-236b", dict(mla_absorb=False)),
    "mla-dense-absorb": ("deepseek-v2-236b", MLA_DENSE),
    "xlstm-350m": ("xlstm-350m", {}),
}


def _with_gates(tree, rng):
    """The numpy tree with every ``gate`` leaf drawn in [0.5, 1.5)."""
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
                    if k == "gate" else _with_gates(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_gates(t, rng) for t in tree]
    return tree


_MODELS: dict = {}


def _model(variant):
    """(jc, tc, jax params, torch params) of a VARIANTS entry, cached."""
    if variant not in _MODELS:
        arch, over = VARIANTS[variant]
        jc, tc = jcfg.smoke(jcfg.get_config(arch)), tcfg.smoke(
            tcfg.get_config(arch))
        jover = tover = over
        if over is MLA_DENSE:
            jover = dict(over, block_pattern=(JBlockDef("mla", "dense"),))
            tover = dict(over, block_pattern=(BlockDef("mla", "dense"),))
        jc, tc = (dataclasses.replace(jc, **jover),
                  dataclasses.replace(tc, **tover))
        tree = _with_gates(bridge.to_numpy(instantiate(
            tm.model_param_defs(tc), torch.Generator().manual_seed(0),
            torch.device("cpu"))), np.random.default_rng(7))
        _MODELS[variant] = (
            jc, tc, jax.tree.map(jnp.asarray, tree),
            tm.prepare_params(bridge.to_torch(tree, device="cpu"), tc))
    return _MODELS[variant]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=MOD_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _sources(cfg, B, seed=3):
    """(reference kwargs, port kwargs) of a model's cross source."""
    if cfg.is_encoder_decoder:
        e = _rand(seed, (B, cfg.n_audio_frames, cfg.d_model))
        return {"enc_embeds": jnp.asarray(e)}, {"enc_embeds": _t(e)}
    if cfg.n_image_tokens:
        e = _rand(seed, (B, cfg.n_image_tokens, cfg.d_model))
        return {"img_embeds": jnp.asarray(e)}, {"img_embeds": _t(e)}
    return {}, {}


def _cross_params(variant):
    """The first cross-attention block's parameters of a model (its
    ``cross`` for attn+cross, its ``mixer`` for cross_attn), layer 0."""
    jc, tc, jp, tp = _model(variant)
    for i, b in enumerate(jc.block_pattern):
        if b.mixer in ("cross_attn", "attn+cross"):
            name = "cross" if b.mixer == "attn+cross" else "mixer"
            pick = lambda t: jax.tree.map(lambda a: a[0], t)    # noqa: E731
            return (jc, tc, pick(jp["segments"][0][f"b{i}"][name]),
                    {k: v[0] for k, v in
                     tp["segments"][0][f"b{i}"][name].items()}, b)
    raise AssertionError(variant)


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["whisper-small", "vision-qk-norm"])
def test_cross_multihead_attention_matches_reference(variant):
    jc, tc, jp, tp, _ = _cross_params(variant)
    assert float(tp["gate"]) >= 0.5
    x, src = _rand(0, (2, 5, jc.d_model)), _rand(1, (2, 13, jc.d_model))
    want = jattn.multihead_attention(jp, jnp.asarray(x), jc,
                                     kv_src=jnp.asarray(src), causal=False)
    got, kv = tattn.multihead_attention(tp, _t(x), tc, positions=None,
                                        rope=None, kv_src=_t(src),
                                        causal=False)
    _close(got, want)
    _, jk, jv = jattn._project_qkv(jp, jnp.asarray(x), jnp.asarray(src), jc,
                                   None, None)
    _close(kv["k"], jk)
    _close(kv["v"], jv)


@pytest.mark.parametrize("variant", ["whisper-small", "vision-qk-norm"])
def test_cross_attend_cached_matches_reference(variant):
    """13 source lines in a cache rounded to 16: the kernel's plain
    version over the identity table, pos 12, against the reference's
    unmasked attention over exactly 13 lines (q-norm on q only)."""
    jc, tc, jp, tp, _ = _cross_params(variant)
    x, src = _rand(2, (3, 1, jc.d_model)), _rand(3, (3, 13, jc.d_model))
    jk, jv = jtfm._cross_kv(jp, jnp.asarray(src), jc)
    tk, tv = ttfm._cross_kv(tp, _t(src), tc)
    _close(tk, jk)
    _close(tv, jv)
    want = jtfm._cross_attend_cached(jp, jnp.asarray(x), jk, jv, jc)
    ck = torch.zeros((3, tattn.dense_lines(13)) + tuple(tk.shape[2:]))
    cv = torch.zeros_like(ck)
    ck[:, :13], cv[:, :13] = tk, tv
    got = ttfm._cross_attend_cached(tp, _t(x), ck, cv, tc, 13)
    _close(got, want)


@pytest.mark.parametrize("variant", ["whisper-small", "whisper-13-frames"])
def test_run_encoder_matches_reference(variant):
    jc, tc, jp, tp = _model(variant)
    e = _rand(4, (2, jc.n_audio_frames, jc.d_model))
    _close(ttfm._run_encoder(tp, tc, _t(e)),
           jtfm._run_encoder(jp, jc, jnp.asarray(e)))


@pytest.mark.parametrize("variant", ["whisper-small", "llama-3.2-vision-90b",
                                     "vision-qk-norm", "whisper-13-frames"])
def test_forward_full_with_states_matches_reference(variant):
    jc, tc, jp, tp = _model(variant)
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (2, 11))
    jkw, tkw = _sources(jc, 2)
    jl, _, jst = jtfm.forward_full(jp, jc, jnp.asarray(toks, jnp.int32),
                                   collect_state=True, **jkw)
    with torch.no_grad():
        tl, _, tst = ttfm.forward_full(tp, tc, _t(toks).long(),
                                       collect_state=True, **tkw)
    _close(tl, jl, LOGITS_TOL)
    jleaves = jax.tree.leaves(jst)
    tleaves = tree_leaves(tst)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, LOGITS_TOL)


def test_other_sources_move_the_logits():
    """With the gates set, the cross path is live: another source changes
    the logits (at gate 0 it would not)."""
    for variant in ("whisper-small", "llama-3.2-vision-90b"):
        jc, tc, jp, tp = _model(variant)
        toks = _t(np.random.default_rng(6).integers(0, tc.vocab_size,
                                                    (2, 7))).long()
        with torch.no_grad():
            a, _ = tm.prefill(tp, tc, toks, **_sources(tc, 2, 3)[1])
            b, _ = tm.prefill(tp, tc, toks, **_sources(tc, 2, 4)[1])
        assert float((a - b).abs().max()) > 1e-3, variant


# --------------------------------------------------------------------------
# decode_step over dense caches
# --------------------------------------------------------------------------

def _static_decode(variant, B, S, steps):
    """Prefill then ``steps`` greedy decode steps in both packages; checks
    every step's logits and returns the final caches (reference, port)."""
    jc, tc, jp, tp = _model(variant)
    toks = np.random.default_rng(8).integers(0, jc.vocab_size, (B, S))
    jkw, tkw = _sources(jc, B)
    max_len = S + steps
    jl, jst = jm.prefill(jp, jc, jnp.asarray(toks, jnp.int32), **jkw)
    jcache = jengine._place_prefill_states(
        jc, jm.init_cache(jc, B, max_len), jst, S)
    tcache = tm.init_cache(tc, B, max_len, "cpu")
    with torch.no_grad():
        tl, tst = tm.prefill(tp, tc, _t(toks).long(), **tkw)
        _place_prefill_states(tcache, tst)
    _close(tl, jl, LOGITS_TOL)
    step = jax.jit(lambda p, c, t, pos: jm.decode_step(p, jc, c, t, pos))
    cur = np.argmax(np.asarray(jl), -1)
    for i in range(steps):
        jlg, jcache = step(jp, jcache, jnp.asarray(cur[:, None], jnp.int32),
                           jnp.int32(S + i))
        with torch.no_grad():
            tlg = tm.decode_step(tp, tc, tcache, _t(cur[:, None]).long(),
                                 torch.full((B,), S + i, dtype=torch.int32))
        _close(tlg, jlg, LOGITS_TOL)
        cur = np.argmax(np.asarray(jlg), -1)
    return jcache, tcache


@pytest.mark.parametrize("variant", ["whisper-small", "llama-3.2-vision-90b",
                                     "qwen3-0.6b", "mla-absorb",
                                     "mla-expanded", "xlstm-350m",
                                     "whisper-13-frames"])
def test_decode_step_matches_reference(variant):
    """7 + 4 = 11 tokens of context (and 13 frames for
    whisper-13-frames): no cache axis is 16-aligned in the reference; the
    port's rounded caches hold the reference's lines and zeros after."""
    jcache, tcache = _static_decode(variant, 2, 7, 4)
    for a, b in zip(tree_leaves(tcache), jax.tree.leaves(jcache)):
        b = np.asarray(b)
        if a.dim() >= 3 and a.shape[2] != b.shape[2]:     # (reps, B, S, ...)
            assert a.shape[2] == tattn.dense_lines(b.shape[2])
            assert not a[:, :, b.shape[2]:].any()
            a = a[:, :, :b.shape[2]]
        assert tuple(a.shape) == b.shape
        _close(a, b, LOGITS_TOL)


def test_cache_defs_round_to_the_dense_page():
    tc = _model("whisper-13-frames")[1]
    leaves = tree_leaves(ttfm.cache_defs(tc, 3, 11))
    shapes = sorted({d.shape for d in leaves})
    assert shapes == [(2, 3, 16, tc.n_kv_heads, tc.hd)]
    full = tcfg.get_config("whisper-small")
    cross = ttfm.block_cache_defs(full, full.block_pattern[0], 1, 8)
    assert cross["ck"].shape[1] == 1504 and cross["k"].shape[1] == 16


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["whisper-small", "llama-3.2-vision-90b",
                                     "whisper-13-frames"])
def test_static_engine_greedy_matches_reference(variant):
    jc, tc, jp, tp = _model(variant)
    toks = np.random.default_rng(9).integers(0, jc.vocab_size, (3, 6))
    jkw, tkw = _sources(jc, 3)
    gen = GenerateConfig(max_new_tokens=8)
    want = jengine.StaticEngine(jc, jp).generate(
        jnp.asarray(toks, jnp.int32), jengine.GenerateConfig(
            max_new_tokens=8), **jkw)
    got = StaticEngine(tc, tp).generate(toks, gen, **tkw)
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["finished"],
                                  np.asarray(want["finished"]))


@pytest.mark.parametrize("variant", ["qwen3-0.6b", "mla-dense-absorb"])
@pytest.mark.parametrize("seed", [None, 11], ids=["greedy", "sampled"])
def test_static_equals_continuous(variant, seed):
    """The contract of the reference's StaticEngine: greedy, and sampled
    with row b seeded ``seed + b`` on both sides, byte for byte (no MoE;
    MLA absorbed, the paged decode's form)."""
    _, tc, _, tp = _model(variant)
    toks = np.random.default_rng(10).integers(0, tc.vocab_size, (3, 7))
    gen = GenerateConfig(max_new_tokens=9, temperature=0.9, top_k=20,
                         top_p=0.95)
    cont = Engine(tc, tp, EngineConfig(device="cpu")).generate(toks, gen,
                                                                seed=seed)
    static = StaticEngine(tc, tp).generate(toks, gen, seed=seed)
    np.testing.assert_array_equal(static["tokens"], cont["tokens"])
    if seed is not None:
        greedy = StaticEngine(tc, tp).generate(toks, gen)
        assert not np.array_equal(greedy["tokens"], static["tokens"])


def test_static_stop_token_finishes_rows():
    _, tc, _, tp = _model("qwen3-0.6b")
    toks = np.random.default_rng(12).integers(0, tc.vocab_size, (2, 5))
    first = StaticEngine(tc, tp).generate(toks, GenerateConfig(4))
    stop = int(first["tokens"][0, 6])
    out = StaticEngine(tc, tp).generate(
        toks, GenerateConfig(max_new_tokens=4, stop_token=stop))
    assert out["finished"][0]
    np.testing.assert_array_equal(out["tokens"][0, :7],
                                  first["tokens"][0, :7])


def test_engine_generate_routes_to_the_static_engine():
    """Engine.generate takes the static engine for an arch without a
    paged path, and for any call given a cross source; the continuous
    API refuses such archs."""
    for variant in ("whisper-small", "llama-3.2-vision-90b"):
        _, tc, _, tp = _model(variant)
        eng = Engine(tc, tp, EngineConfig(device="cpu"))
        assert not eng.paged_ok
        toks = np.random.default_rng(13).integers(0, tc.vocab_size, (2, 5))
        src = _sources(tc, 2)[1]
        out = eng.generate(toks, GenerateConfig(max_new_tokens=4), **src)
        want = StaticEngine(tc, tp).generate(
            toks, GenerateConfig(max_new_tokens=4), **src)
        np.testing.assert_array_equal(out["tokens"], want["tokens"])
        assert eng.static_engine() is eng.static_engine()
        assert eng.static_engine().decode_steps == 3
        with pytest.raises(NotImplementedError, match="paged cache"):
            eng.reset()
        with pytest.raises(NotImplementedError, match="paged cache"):
            eng.submit(toks[0], GenerateConfig(max_new_tokens=2))
    _, tc, _, tp = _model("qwen3-0.6b")
    eng = Engine(tc, tp, EngineConfig(device="cpu"))
    assert eng.paged_ok
    toks = np.random.default_rng(14).integers(0, tc.vocab_size, (2, 5))
    eng.generate(toks, GenerateConfig(max_new_tokens=3),
                 img_embeds=torch.zeros(2, 4, tc.d_model))
    assert eng._static is not None and eng._sched is None


def test_static_engine_refuses_graphs_on_the_cpu():
    _, tc, _, tp = _model("qwen3-0.6b")
    with pytest.raises(ValueError, match="CUDA device"):
        StaticEngine(tc, tp, cuda_graphs=True)


def test_serve_cli_static_branch(capsys):
    serve_cli.main(["--arch", "whisper-small", "--smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "6", "--new-tokens",
                    "4"])
    out = capsys.readouterr().out
    assert "[serve/static] 2 seqs x 4 new tokens" in out
    first = out.split("[serve] first sequence:")[1].strip()
    assert len(eval(first)) == 4
    with pytest.raises(SystemExit, match="static engine"):
        serve_cli.main(["--arch", "llama-3.2-vision-90b", "--smoke",
                        "--device", "cpu", "--trace", "t.json"])
