"""The port's MLA and MoE modules against the JAX package's, on the same
weights (carried across by repro_torch.bridge) and the same numpy inputs:
MLA projections, full-sequence attention, paged prefill and decode; the
MoE FFN with and without capacity drops; greedy engine streams on
deepseek-v2 smoke; and the repairs that came with MoE in the engine
(unpadded whole-prompt prefill, prefix sharing refused).

Tolerance: float32 on both sides, different op order (XLA vs ATen) ->
|diff| <= 1e-5 + 1e-4 * |ref|, the dense archs' tolerance.  Expert
choices and capacity drops are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models as jm
import repro.serve as jserve
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.serve import kv_cache as jkv
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.serve as tserve
from repro_torch import bridge
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models.params import tree_map
from repro_torch.serve import engine as tengine
from repro_torch.serve import kv_cache as tkv

TOL = dict(rtol=1e-4, atol=1e-5)
PAGE = 4


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _load(arch, **changes):
    jc = dataclasses.replace(jcfg.smoke(jcfg.get_config(arch)), **changes)
    tc = dataclasses.replace(tcfg.smoke(tcfg.get_config(arch)), **changes)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.prepare_params(
        bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu"), tc)
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def deepseek():
    return _load("deepseek-v2-236b")


def _block(jp, tp, seg, part):
    """Layer 0 of segment ``seg``'s block b0, sub-tree ``part``."""
    return (jax.tree.map(lambda a: a[0], jp["segments"][seg]["b0"][part]),
            tree_map(lambda t: t[0], tp["segments"][seg]["b0"][part]))


def _x(cfg, seed, B, S, scale=1.0):
    return np.random.RandomState(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32) * scale


def _positions(B, S, offset=0):
    return np.broadcast_to(np.arange(offset, offset + S, dtype=np.int32),
                           (B, S)).copy()


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [7, 48], ids=["short", "q-chunked"])
def test_mla_projections_and_full_attention_match(deepseek, S):
    """_queries / _latent_kv / mla_attention; S=48 > 2 * attn_chunk takes
    the query-chunked branch."""
    jc, tc, jp, tp = deepseek
    jb, tb = _block(jp, tp, 1, "mixer")
    x, pos = _x(jc, S, 2, S), _positions(2, S, offset=3)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    for got, want in zip(tmla._queries(tb, tx, tpos, tc),
                         jmla._queries(jb, jx, jpos, jc)):
        _close(got, want)
    for got, want in zip(tmla._latent_kv(tb, tx, tpos, tc),
                         jmla._latent_kv(jb, jx, jpos, jc)):
        _close(got, want)
    out, state = tmla.mla_attention(tb, tx, tc, tpos)
    _close(out, jmla.mla_attention(jb, jx, jc, q_positions=jpos))
    c_kv, k_rope = jmla._latent_kv(jb, jx, jpos, jc)
    _close(state["c_kv"], c_kv)
    _close(state["k_rope"], k_rope)


@pytest.mark.parametrize("absorb", [False, True], ids=["expanded",
                                                       "absorbed"])
def test_mla_prefill_and_decode_paged_match(absorb):
    """Two prefill chunks of one request into its pages, then three decode
    steps with a second, idle slot on the trash page; outputs and pools
    compared after every call.  The JAX decode runs the Pallas kernel in
    interpret mode (its default off-TPU)."""
    jc, tc, jp, tp = _load("deepseek-v2-236b", mla_absorb=absorb)
    jb, tb = _block(jp, tp, 0, "mixer")
    P = 7
    rng = np.random.RandomState(4)
    pool_np = {"c_kv": np.zeros((P, PAGE, jc.kv_lora_rank), np.float32),
               "k_rope": np.zeros((P, PAGE, jc.rope_head_dim), np.float32)}
    jpool = jax.tree.map(jnp.asarray, pool_np)
    tpool = bridge.to_torch(pool_np, device="cpu")
    row = np.array([3, 1, 5, 0], np.int32)

    def same_pools():
        for k in pool_np:
            _close(tpool[k], jpool[k])

    for a, b in [(0, 6), (6, 9)]:
        x = _x(jc, 20 + a, 1, b - a)
        jo, jpool = jmla.mla_prefill_paged(jb, jnp.asarray(x), jpool,
                                           jnp.asarray(row), jnp.int32(a),
                                           jc, page_size=PAGE)
        to = tmla.mla_prefill_paged(tb, torch.from_numpy(x), tpool,
                                    torch.from_numpy(row), a, tc,
                                    page_size=PAGE)
        _close(to, jo)
        same_pools()
    bt = np.stack([row, np.zeros_like(row)])
    for step in range(3):
        x = _x(jc, 40 + step, 2, 1) * rng.uniform(0.5, 2.0)
        pos = np.array([9 + step, 0], np.int32)
        jo, jpool = jmla.mla_decode_paged(jb, jnp.asarray(x), jpool,
                                          jnp.asarray(bt), jnp.asarray(pos),
                                          jc, page_size=PAGE)
        to = tmla.mla_decode_paged(tb, torch.from_numpy(x), tpool,
                                   torch.from_numpy(bt),
                                   torch.from_numpy(pos), tc,
                                   page_size=PAGE)
        _close(to[0], jo[0])
        assert np.isfinite(to.numpy()).all()
        same_pools()


def test_mla_quantized_pool_raises_with_roadmap_item():
    """Quantized latent pools are ported (they raised until the ROADMAP
    item was done): at int8 the pool definitions equal repro's in names,
    shapes, storage dtypes and init — codes zeros, per-line float32
    scales ones."""
    tc = dataclasses.replace(tcfg.smoke(tcfg.get_config("deepseek-v2-236b")),
                             kv_dtype="int8")
    jc = dataclasses.replace(jcfg.smoke(jcfg.get_config("deepseek-v2-236b")),
                             kv_dtype="int8")
    tdefs = tmla.mla_paged_pool_defs(tc, 4, PAGE)
    jdefs = jmla.mla_paged_pool_defs(jc, 4, PAGE)
    assert sorted(tdefs) == sorted(jdefs) == [
        "c_kv", "c_kv_scale", "k_rope", "k_rope_scale"]
    for name, d in tdefs.items():
        assert (d.shape, d.dtype, d.init) == (
            tuple(jdefs[name].shape), jnp.dtype(jdefs[name].dtype).name,
            jdefs[name].init), name


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def _moe_both(jc, tc, jp, tp, x):
    jb, tb = _block(jp, tp, 1, "ffn")
    jo, jaux = jmoe.moe_ffn(jb, jnp.asarray(x), jc)
    to, taux = tmoe.moe_ffn(tb, torch.from_numpy(x), tc)
    return (jb, tb), (jo, jaux), (to, taux)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_moe_ffn_matches(arch):
    jc, tc, jp, tp = _load(arch)
    _, (jo, jaux), (to, taux) = _moe_both(jc, tc, jp, tp, _x(jc, 7, 2, 9))
    _close(to, jo)
    _close(taux, jaux)


def _router(cfg, p, xf):
    """The reference's routing, recomputed in numpy float32 for the
    dispatch inputs both sides are fed."""
    logits = xf @ np.asarray(p["router"])
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    eids = np.argsort(-probs, axis=-1, kind="stable")[:, :cfg.moe_top_k]
    gates = np.take_along_axis(probs, eids, -1)
    return (gates / gates.sum(-1, keepdims=True)).astype(np.float32), eids


def test_moe_capacity_drops_match():
    """64 tokens at capacity_factor 0.25: capacity 8 per expert against 32
    pairs per expert on average, so pairs drop; the kept (token, expert)
    slots must be the reference's exactly, and so must the output."""
    jc, tc, jp, tp = _load("deepseek-v2-236b", capacity_factor=0.25)
    x = _x(jc, 11, 2, 32)
    (jb, tb), (jo, jaux), (to, taux) = _moe_both(jc, tc, jp, tp, x)
    _close(to, jo)
    _close(taux, jaux)
    N, K = 64, jc.moe_top_k
    C = jmoe._capacity(N, jc)
    assert C == tmoe._capacity(N, tc) == 8
    gates, eids = _router(jc, jb, x.reshape(N, -1))
    _, jtok, jgate = jmoe._dispatch_combine(
        jnp.asarray(x.reshape(N, -1)), jnp.asarray(gates),
        jnp.asarray(eids), C, jc)
    xe, ttok, tgate = tmoe._dispatch_combine(
        torch.from_numpy(x.reshape(N, -1)), torch.from_numpy(gates),
        torch.from_numpy(eids), C, tc)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tgate.numpy(), np.asarray(jgate))
    kept = int((ttok.numpy() < N).sum())
    assert 0 < kept < N * K                      # pairs really dropped
    # the router the modules ran picked the same experts
    tprobs = torch.softmax(torch.from_numpy(x.reshape(N, -1))
                           @ tb["router"], -1)
    np.testing.assert_array_equal(
        torch.topk(tprobs, K, dim=-1).indices.numpy(), eids)


@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["kept", "dropping"])
def test_moe_local_dispatch_matches_reference(cf):
    """moe_dispatch="local" without a mesh (one group on both sides):
    the port (a rank's tokens are its one group) against the reference's
    ``_moe_local``, with and without capacity drops."""
    jc, tc, jp, tp = _load("deepseek-v2-236b", capacity_factor=cf,
                           moe_dispatch="local")
    x = _x(jc, 13, 2, 32)
    _, (jo, jaux), (to, taux) = _moe_both(jc, tc, jp, tp, x)
    _close(to, jo)
    _close(taux, jaux)


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

def _prompt(seed, length, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, length).astype(
        np.int32)


@pytest.mark.parametrize("prefill_chunk", [0, 3])
def test_engine_streams_identical(deepseek, prefill_chunk, monkeypatch):
    """Greedy streams equal repro.serve.Engine's with staggered admission
    (5 requests, 2 slots), whole-prompt or chunked prefill.  Whole
    prompts of an MoE model prefill unpadded, as in the reference."""
    jc, tc, jp, tp = deepseek
    padded = []

    def spy(*args, **kw):
        padded.append(args[-1])
        return tm.prefill_padded(*args, **kw)

    monkeypatch.setattr(tengine, "prefill_padded", spy)
    prompts = [_prompt(60 + i, s) for i, s in enumerate([5, 8, 6, 7, 5])]
    ecfg = dict(num_slots=2, page_size=PAGE, max_len=24,
                prefill_chunk=prefill_chunk)
    jeng = jserve.Engine(jc, jp, jserve.EngineConfig(**ecfg))
    teng = tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu", **ecfg))
    assert not teng._bucketable
    gen = dict(max_new_tokens=6)
    jreqs = [jeng.submit(p, jserve.GenerateConfig(**gen)) for p in prompts]
    treqs = [teng.submit(p, tserve.GenerateConfig(**gen)) for p in prompts]
    jeng.run()
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.generated == [int(v) for v in j.generated], t.request_id
    assert any(r.ledger.mean_batch > 1.0 for r in treqs)
    assert padded == []


def test_dense_archs_still_bucket():
    for arch, want in [("qwen3-0.6b", True), ("deepseek-v2-236b", False),
                       ("kimi-k2-1t-a32b", False)]:
        cfg = tcfg.smoke(tcfg.get_config(arch))
        params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        eng = tserve.Engine(cfg, params, tserve.EngineConfig(device="cpu"))
        assert eng._bucketable is want


@pytest.mark.parametrize("arch", jcfg.ALL_ARCHS)
def test_cache_support_predicates_equal_reference(arch):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    assert tkv.supports_paging(tc) == jkv.supports_paging(jc)
    assert tkv.supports_prefix_cache(tc) == jkv.supports_prefix_cache(jc)


def test_prefix_cache_on_moe_raises_like_reference():
    jc = jcfg.smoke(jcfg.get_config("deepseek-v2-236b"))
    tc = tcfg.smoke(tcfg.get_config("deepseek-v2-236b"))
    with pytest.raises(NotImplementedError) as want:
        jkv.PagedKVCache(jc, 2, PAGE, 16, prefix_cache=True)
    with pytest.raises(NotImplementedError) as got:
        tkv.PagedKVCache(tc, 2, PAGE, 16, torch.device("cpu"),
                         prefix_cache=True)
    assert str(got.value) == str(want.value)
    tkv.PagedKVCache(tc, 2, PAGE, 16, torch.device("cpu"))   # without: fine


def test_bridge_needs_a_device():
    with pytest.raises(TypeError):
        bridge.to_torch({"a": np.zeros(2)})
    assert bridge.to_torch({"a": np.zeros(2)}, device="cpu")["a"].is_cpu
