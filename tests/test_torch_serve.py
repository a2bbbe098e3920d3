"""Serving pieces of the port against the JAX package's: the block pool
under one operation stream, the sampler's greedy choice and top-k/top-p
kept sets (exact), temperature draws (distribution), and the roofline
ledger's pricing (exact)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.serve import block_pool as jbp
from repro.serve import sampling as js
from repro.serve import scheduler as jsch
import repro_torch.configs as tcfg
from repro_torch.serve import block_pool as tbp
from repro_torch.serve import crosscheck as txc
from repro_torch.serve import sampling as ts
from repro_torch.serve import scheduler as tsch


# --------------------------------------------------------------------------
# block pool
# --------------------------------------------------------------------------

def _drive_pool(mod, seed):
    """A random operation stream; returns everything the pool answered."""
    rng = np.random.RandomState(seed)
    pool = mod.BlockPool(12, 4)
    held, frozen, log = [], [], []
    for i in range(400):
        op = rng.randint(6)
        if op == 0:
            page = pool.acquire()
            log.append(("acquire", page))
            if page is not None:
                held.append(page)
        elif op == 1 and held:
            page = held.pop(rng.randint(len(held)))
            pool.release(page)
            log.append(("release", page))
        elif op == 2 and held:
            page = held[rng.randint(len(held))]
            pool.incref(page)
            held.append(page)
            log.append(("incref", page))
        elif op == 3 and held:
            page = held[rng.randint(len(held))]
            key = mod.chain_hash(None, rng.randint(0, 5, 4))
            pool.freeze(page, key)
            frozen.append(key)
            log.append(("freeze", page, pool.is_frozen(page)))
        elif op == 4 and frozen:
            key = frozen[rng.randint(len(frozen))]
            page = pool.lookup(key)
            if page is not None:
                held.append(page)
            log.append(("lookup", page, pool.peek(key)))
        elif op == 5 and held:
            page = held[rng.randint(len(held))]
            log.append(("cow", pool.cow_needed(page), pool.writable(page)))
        log.append((pool.free_page_count, pool.available_page_count,
                    pool.pages_in_use, pool.pages_cached))
    pool.check()
    return log, pool.stats.as_dict()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_pool_same_answers_as_reference(seed):
    assert _drive_pool(tbp, seed) == _drive_pool(jbp, seed)
    toks = np.random.RandomState(seed).randint(0, 100, 23)
    assert tbp.token_chain_hashes(toks, 4) == jbp.token_chain_hashes(toks, 4)


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------

def test_greedy_matches_reference():
    logits = np.random.RandomState(0).standard_normal((6, 300)).astype(
        np.float32)
    z = np.zeros((6,), np.float32)
    want = js.sample_host(jnp.asarray(logits), js.batch_key_data(None, 6),
                          z.astype(np.int32), z, z.astype(np.int32), z)
    got = ts.sample_tokens(torch.from_numpy(logits), np.zeros(6, np.int64),
                           z.astype(np.int32), z, z.astype(np.int32), z)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_top_k_top_p_kept_sets_match_reference(seed):
    rng = np.random.RandomState(seed)
    B, V = 8, 257
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    top_ks = rng.choice([0, 1, 5, 40, 300], B).astype(np.int32)
    top_ps = rng.choice([0.0, 0.3, 0.9, 1.0], B).astype(np.float32)
    temps = rng.choice([0.5, 1.0, 2.0], B).astype(np.float32)
    want = np.asarray(js._filter_logits_sort(
        jnp.asarray(logits), jnp.asarray(top_ks), jnp.asarray(top_ps),
        jnp.asarray(temps))) > ts.NEG_INF / 2
    got = ts._filter_logits_sort(
        torch.from_numpy(logits), torch.from_numpy(top_ks),
        torch.from_numpy(top_ps), torch.from_numpy(temps)).numpy() \
        > ts.NEG_INF / 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k,temp", [(0, 0.7), (3, 1.3)])
def test_temperature_draws_follow_the_softmax(top_k, temp):
    """Total-variation distance of 6000 draws from the tempered (and top-k
    renormalized) softmax stays below 0.03 (sampling noise ~0.01)."""
    V, n = 8, 6000
    logits = np.linspace(-1.0, 1.5, V).astype(np.float32)
    want = np.exp(logits / temp)
    if top_k:
        want[np.argsort(-logits)[top_k:]] = 0.0
    want /= want.sum()
    rows = torch.from_numpy(np.broadcast_to(logits, (n, V)).copy())
    toks = ts.sample_tokens(
        rows, np.full(n, 7, np.int64), np.arange(n, dtype=np.int32),
        np.full(n, temp, np.float32), np.full(n, top_k, np.int32),
        np.zeros(n, np.float32)).numpy()
    freq = np.bincount(toks, minlength=V) / n
    assert 0.5 * np.abs(freq - want).sum() < 0.03
    again = ts.sample_tokens(
        rows[:50], np.full(50, 7, np.int64), np.arange(50, dtype=np.int32),
        np.full(50, temp, np.float32), np.full(50, top_k, np.int32))
    np.testing.assert_array_equal(again.numpy(), toks[:50])  # same seed+step


# --------------------------------------------------------------------------
# ledger pricing
# --------------------------------------------------------------------------

def _cfgs(arch, shrink, kv_dtype):
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    if shrink:
        j, t = jcfg.smoke(j), tcfg.smoke(t)
    return (dataclasses.replace(j, kv_dtype=kv_dtype),
            dataclasses.replace(t, kv_dtype=kv_dtype))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-14b", "minicpm-2b",
                                  "minitron-4b", "deepseek-v2-236b",
                                  "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("shrink", [False, True], ids=["full", "smoke"])
def test_pricing_equals_reference(arch, shrink, monkeypatch):
    # the ledger's on-chip term is the CUDA kernels' count: the reference's
    # ledger is priced with the launch-grid walk of those kernels, so the
    # rest of it stays the baseline and the term is held against the walk
    monkeypatch.setattr(jsch, "attn_kernel_vmem_bytes",
                        txc.kernel_walk_vmem_bytes)
    for kv_dtype in ("bf16", "int8"):
        jc, tc = _cfgs(arch, shrink, kv_dtype)
        assert tsch.kv_line_bytes(tc) == jsch.kv_line_bytes(jc)
    jc, tc = _cfgs(arch, shrink, "bf16")
    assert tsch.params_bytes_active(tc) == jsch.params_bytes_active(jc)
    jl, tl = jsch.RooflineLedger(), tsch.RooflineLedger()
    for ctx, batch in [(1, 1), (17, 3), (200, 4), (511, 2)]:
        assert tsch.decode_token_flops(tc, ctx) == \
            jsch.decode_token_flops(jc, ctx)
        assert tsch.decode_token_bytes(tc, ctx, batch) == \
            jsch.decode_token_bytes(jc, ctx, batch)
        vj = jsch.decode_token_vmem_bytes(jc, ctx, batch, 16)
        assert tsch.decode_token_vmem_bytes(tc, ctx, batch, 16) == vj
        jl.add_decode_token(jc, ctx, batch, vmem_bytes=vj)
        tl.add_decode_token(tc, ctx, batch, vmem_bytes=vj)
    assert tl.decode_flops == jl.decode_flops
    assert tl.decode_bytes == jl.decode_bytes
    assert tl.arithmetic_intensity == jl.arithmetic_intensity
    terms = tl.terms(tc)
    assert terms.arithmetic_intensity == jl.terms(jc).arithmetic_intensity
    assert terms.bound_class() == "memory-bound"
    assert "vmem" not in terms.terms()      # H100 on-chip level unpriced
