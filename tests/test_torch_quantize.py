"""Quantized KV pools (``kv_dtype`` int8 / fp8_e4m3) in the port against
the JAX package, on the same numpy inputs and weights:

* ``kernels/quantize.py``: codes (compared through a uint8 view) and
  scales bit-equal to ``repro.kernels.quantize`` on float32 and bf16
  inputs, all-zero lines, exact .5 ties and lines whose absmax lands on
  +-qmax included; the round trip within the reference's error bound;
* pool definitions, storage dtypes and the ledger's line pricing equal
  to the reference's;
* the four plain paged attentions with scale pools against repro's jnp
  references and its Pallas kernels (interpret mode, ``pipeline="off"``):
  ragged tables, idle all-trash lanes, soft cap, verify chains crossing a
  page;
* greedy streams of the port's ``Engine`` / ``SpecEngine`` equal to
  ``repro.serve``'s at int8 and fp8 (GQA and MLA, with and without
  chunked prefill), under swap preemption and a copy-on-write prefix;
  swapped and copied pages keep codes and scales byte-exact;
* ``pipeline="double"`` with a quantized pool (the ring kernels' scale
  branches on the card, the plain versions here): greedy streams of both
  engines equal ``repro.serve``'s quantized ``pipeline="off"`` engine
  (the reference's own quantized double walk does not run on this jax),
  every paged dispatch carries ``"double"``, and the ledgers equal the
  reference's pricing of ``pipeline="double"``;
* the knobs: ``EngineConfig.kv_dtype`` validation and override (with
  either pipeline, the draft keeping its own ``kv_dtype``), the
  launcher's ``--kv-dtype``, the bridge's int8 / fp8 round trip, and the
  swap snapshot's aligned packing.

Tolerance of the attentions: rtol 2e-5 / atol 2e-6, the reference's own
(``tests/test_kv_quantize.py``).  Engine codes come from torch
projections that may differ from XLA's in the last bit, so the engines
are held by their token streams and codes are held bit-equal only on
identical inputs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models as jm
import repro.serve as jserve
from repro.kernels import paged_attention as jpa
from repro.kernels import quantize as jq
from repro.models import attention as jattn
from repro.models import mla as jmla
from repro.models.common import BlockDef as JBlockDef
from repro.serve import scheduler as jsched
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.serve as tserve
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as tq
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import mla as tmla
from repro_torch.models.common import BlockDef as TBlockDef
from repro_torch.serve import crosscheck as txc
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import scheduler as tsched

QDTYPES = ["int8", "fp8_e4m3"]
TOL = dict(rtol=2e-5, atol=2e-6)


def _bits(x) -> np.ndarray:
    """Raw bytes of a torch or JAX code array (uint8 view)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


# -- the quantizer ---------------------------------------------------------

def _edge_lines(kv_dtype):
    """(64, 16, 2, 128) float32 lines with the edge cases planted: an
    all-zero line, lines whose scaled values hit exact .5 ties, and lines
    whose absmax lands exactly on +-qmax after scaling."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 16, 2, 128)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    m = jq.qmax(kv_dtype)
    # absmax m -> scale 1 exactly: k + .5 are ties, +-m is the clip edge
    x[1, 0, 0] = np.linspace(-m, m, 128).round() + 0.5
    x[1, 0, 0, 0], x[1, 0, 1] = m, -m
    x[2, 1, 1] = np.where(np.arange(128) % 2, 2.5, -1.5)
    x[2, 1, 1, 0] = m
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", QDTYPES)
def test_quantize_bit_equals_reference(kv_dtype, dtype):
    x = jnp.asarray(_edge_lines(kv_dtype)).astype(dtype)
    jcodes, jscale = jq.quantize(x, kv_dtype, -1)
    tcodes, tscale = tq.quantize(bridge.to_torch(np.asarray(x),
                                                 device="cpu"), kv_dtype, -1)
    assert str(tcodes.dtype).split(".")[-1] == \
        tq.store_dtype(kv_dtype, "bfloat16") == jnp.dtype(jcodes.dtype).name
    assert tscale.dtype == torch.float32 and tscale.shape == x.shape[:-1]
    np.testing.assert_array_equal(_bits(tcodes), _bits(jcodes))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    assert tq._SCALE_FLOOR == jq._SCALE_FLOOR      # the all-zero line
    assert tscale[0, 0, 0].item() == np.float32(tq._SCALE_FLOOR)
    np.testing.assert_array_equal(
        tq.dequantize(tcodes, tscale).numpy(),
        np.asarray(jq.dequantize(jcodes, jscale)))


@pytest.mark.parametrize("kv_dtype", QDTYPES)
def test_quantize_roundtrip_error_bound(kv_dtype):
    """The reference's round-trip bound (test_kv_quantize.py): half an
    int8 step; for e4m3 a half-ulp relative error plus a subnormal
    floor."""
    x = np.random.default_rng(1).standard_normal((3, 4, 2, 16)).astype(
        np.float32) * 5.0
    q, s = tq.quantize(torch.from_numpy(x), kv_dtype, -1)
    dq = tq.dequantize(q, s).numpy()
    absmax = np.abs(x).max(axis=-1, keepdims=True)
    if kv_dtype == "int8":
        bound = absmax / 127.0 * 0.5 + 1e-6
    else:
        bound = np.abs(x) * 2.0 ** -4 + absmax / 448.0
    assert np.all(np.abs(x - dq) < bound)


@pytest.mark.parametrize("kv_dtype", ["bf16"] + QDTYPES)
def test_store_dtype_and_line_pricing_equal_reference(kv_dtype):
    for vdt in ("bfloat16", "float32"):
        assert tq.store_itemsize(kv_dtype, vdt) == \
            jq.store_itemsize(kv_dtype, vdt)
        assert tq.store_dtype(kv_dtype, vdt) == \
            jnp.dtype(jq.store_dtype(kv_dtype, vdt)).name
    for arch in ("qwen3-0.6b", "deepseek-v2-236b"):
        tc = dataclasses.replace(tcfg.get_config(arch), kv_dtype=kv_dtype)
        jc = dataclasses.replace(jcfg.get_config(arch), kv_dtype=kv_dtype)
        assert tsched.kv_line_bytes(tc) == jsched.kv_line_bytes(jc)
        assert tsched._kv_store_isize(tc) == jsched._kv_store_isize(jc)
        assert tsched._kv_scale_isize(tc) == jsched._kv_scale_isize(jc)
    with pytest.raises(ValueError, match="kv_dtype"):
        tq.validate_kv_dtype("int3")


def test_int8_line_shrink_on_full_configs():
    """The roofline lever: the all-layer KV line shrinks 1.94x (qwen3) and
    1.97x (deepseek-v2) at int8."""
    for arch, want in (("qwen3-0.6b", 1.94), ("deepseek-v2-236b", 1.97)):
        cfg = tcfg.get_config(arch)
        ratio = tsched.kv_line_bytes(cfg) / tsched.kv_line_bytes(
            dataclasses.replace(cfg, kv_dtype="int8"))
        assert round(ratio, 2) == want


@pytest.mark.parametrize("kv_dtype", QDTYPES)
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_quantized_pool_defs_equal_reference(arch, kv_dtype):
    tc = dataclasses.replace(tcfg.smoke(tcfg.get_config(arch)),
                             kv_dtype=kv_dtype)
    jc = dataclasses.replace(jcfg.smoke(jcfg.get_config(arch)),
                             kv_dtype=kv_dtype)
    tdefs = (tmla.mla_paged_pool_defs if arch.startswith("deepseek")
             else tattn.paged_pool_defs)(tc, 7, 4)
    jdefs = (jmla.mla_paged_pool_defs if arch.startswith("deepseek")
             else jattn.paged_pool_defs)(jc, 7, 4)
    assert sorted(tdefs) == sorted(jdefs)
    assert any(n.endswith("_scale") for n in tdefs)
    for name, d in tdefs.items():
        j = jdefs[name]
        assert (d.shape, d.dtype, d.init) == (
            tuple(j.shape), jnp.dtype(j.dtype).name, j.init), name
    kv = tkv.PagedKVCache(tc, num_slots=2, page_size=4, max_len=16,
                          device=torch.device("cpu"))
    blk = next(iter(kv.pools[0].values()))
    for name, t in blk.items():
        if name.endswith("_scale"):
            assert t.dtype == torch.float32 and bool((t == 1).all())
        else:
            assert str(t.dtype).split(".")[-1] == \
                tq.store_dtype(kv_dtype, tc.dtype)


# -- the plain attentions with scale pools ---------------------------------

def _tables(rng, B, nb, page, P, T=1, idle=True):
    """Ragged tables (the last slot idle: all entries trash page 0, pos 0
    when ``idle``); a verify chain of T tokens stays inside the table."""
    bt = np.zeros((B, nb), np.int32)
    pos = np.zeros((B,), np.int32)
    free = list(range(1, P))
    for b in range(B - 1 if idle else B):
        live = rng.randint(1, nb + 1)
        for j in range(live):
            bt[b, j] = free.pop()
        pos[b] = min(rng.randint(0, live * page), nb * page - T)
    return bt, pos


def _quantized(rng, shape, kv_dtype):
    """A pool drawn from ``rng`` and quantized by the reference: (codes,
    scales) as numpy arrays for both sides."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    q, s = jq.quantize(x, kv_dtype, -1)
    return np.asarray(q), np.asarray(s)


def _run_both(jfn, tfn, pallas, args, scales, **kw):
    """Run repro's jnp reference and Pallas kernel and the port's plain
    version (through ops) on the same numpy arrays; return all three."""
    ja = [jnp.asarray(a) for a in args]
    jkw = {k: jnp.asarray(v) for k, v in scales.items()}
    tkw = {k: bridge.to_torch(v, device="cpu") for k, v in scales.items()}
    want = np.asarray(jfn(*ja, **kw, **jkw))
    want_pallas = np.asarray(pallas(*ja, **kw, **jkw, interpret=True,
                                    pipeline="off"))
    got = tfn(*bridge.to_torch(list(args), device="cpu"), **kw, **tkw)
    return got.numpy(), want, want_pallas


@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
@pytest.mark.parametrize("kv_dtype", QDTYPES)
def test_gqa_decode_plain_matches_quantized_reference(kv_dtype, soft_cap):
    rng = np.random.RandomState(21)
    B, KV, G, hd, page, nb = 4, 2, 2, 16, 4, 5
    P = 1 + B * nb
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32) * (
        4.0 if soft_cap else 1.0)
    kq, ks = _quantized(rng, (P, page, KV, hd), kv_dtype)
    vq, vs = _quantized(rng, (P, page, KV, hd), kv_dtype)
    bt, pos = _tables(rng, B, nb, page, P)
    got, want, want_pallas = _run_both(
        jpa.paged_attention_reference, ops.paged_attention,
        jpa.paged_attention, (q, kq, vq, bt, pos),
        dict(k_scale=ks, v_scale=vs), scale=hd ** -0.5, soft_cap=soft_cap)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


@pytest.mark.parametrize("kv_dtype", QDTYPES)
def test_gqa_verify_plain_matches_quantized_reference(kv_dtype):
    """T = 3 chains from ragged positions, crossing page boundaries."""
    rng = np.random.RandomState(22)
    B, T, KV, G, hd, page, nb = 3, 3, 2, 2, 16, 4, 4
    P = 1 + B * nb
    q = rng.standard_normal((B, T, KV, G, hd)).astype(np.float32)
    kq, ks = _quantized(rng, (P, page, KV, hd), kv_dtype)
    vq, vs = _quantized(rng, (P, page, KV, hd), kv_dtype)
    bt, pos = _tables(rng, B, nb, page, P, T=T)
    pos[0] = page - 2                        # the chain crosses a page
    got, want, want_pallas = _run_both(
        jpa.paged_attention_verify_reference, ops.paged_attention_verify,
        jpa.paged_attention_verify, (q, kq, vq, bt, pos),
        dict(k_scale=ks, v_scale=vs), scale=hd ** -0.5)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


@pytest.mark.parametrize("kv_dtype", QDTYPES)
def test_mla_decode_plain_matches_quantized_reference(kv_dtype):
    rng = np.random.RandomState(23)
    B, H, r, dr, page, nb = 4, 4, 32, 8, 4, 4
    P = 1 + B * nb
    ql = rng.standard_normal((B, H, r)).astype(np.float32)
    qr = rng.standard_normal((B, H, dr)).astype(np.float32)
    cq, cs = _quantized(rng, (P, page, r), kv_dtype)
    rq, rs = _quantized(rng, (P, page, dr), kv_dtype)
    bt, pos = _tables(rng, B, nb, page, P)
    got, want, want_pallas = _run_both(
        jpa.mla_paged_attention_reference, ops.mla_paged_attention,
        jpa.mla_paged_attention, (ql, qr, cq, rq, bt, pos),
        dict(c_scale=cs, r_scale=rs), scale=(r + dr) ** -0.5)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


@pytest.mark.parametrize("kv_dtype", QDTYPES)
def test_mla_verify_plain_matches_quantized_reference(kv_dtype):
    rng = np.random.RandomState(24)
    B, T, H, r, dr, page, nb = 3, 3, 4, 32, 8, 4, 4
    P = 1 + B * nb
    ql = rng.standard_normal((B, T, H, r)).astype(np.float32)
    qr = rng.standard_normal((B, T, H, dr)).astype(np.float32)
    cq, cs = _quantized(rng, (P, page, r), kv_dtype)
    rq, rs = _quantized(rng, (P, page, dr), kv_dtype)
    bt, pos = _tables(rng, B, nb, page, P, T=T)
    pos[0] = page - 1                        # the chain crosses a page
    got, want, want_pallas = _run_both(
        jpa.mla_paged_attention_verify_reference,
        ops.mla_paged_attention_verify, jpa.mla_paged_attention_verify,
        (ql, qr, cq, rq, bt, pos), dict(c_scale=cs, r_scale=rs),
        scale=(r + dr) ** -0.5)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


def test_bf16_query_with_quantized_pool_computes_in_float32():
    """torch's einsum refuses a bf16 x float32 product where jnp promotes:
    the plain version upcasts the query, so a bf16 query gives the
    float32 query's result rounded once to bf16."""
    rng = np.random.RandomState(25)
    B, KV, G, hd, page, nb = 3, 2, 2, 16, 4, 3
    P = 1 + B * nb
    q = torch.from_numpy(rng.standard_normal((B, KV, G, hd)).astype(
        np.float32)).bfloat16()
    kq, ks = tq.quantize(torch.randn(P, page, KV, hd), "int8")
    vq, vs = tq.quantize(torch.randn(P, page, KV, hd), "int8")
    bt, pos = (torch.from_numpy(a) for a in _tables(rng, B, nb, page, P))
    kw = dict(scale=0.25, k_scale=ks, v_scale=vs)
    got = ops.paged_attention(q, kq, vq, bt, pos, **kw)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ops.paged_attention(q.float(), kq, vq, bt, pos,
                                                **kw).bfloat16())


def test_scale_pool_pairing_and_ring_refusal():
    """One scale pool alone raises; a quantized pool under
    ``pipeline="double"`` (explicit, or the process default) dispatches
    like any other, and on CPU tensors to the plain version, equal to the
    ``"off"`` dispatch."""
    rng = np.random.RandomState(26)
    P, page, KV, hd = 5, 4, 2, 16
    q = torch.randn(2, KV, 2, hd)
    kq, ks = tq.quantize(torch.randn(P, page, KV, hd), "int8")
    bt, pos = (torch.from_numpy(a) for a in _tables(rng, 2, 2, page, P))
    with pytest.raises(ValueError, match="both scale pools or neither"):
        ops.paged_attention(q, kq, kq, bt, pos, scale=0.25, k_scale=ks)
    kw = dict(scale=0.25, k_scale=ks, v_scale=ks)
    off = ops.paged_attention(q, kq, kq, bt, pos, pipeline="off", **kw)
    for pipeline in ("double", None):
        with ops.use_pipeline("double"):
            got = ops.paged_attention(q, kq, kq, bt, pos, pipeline=pipeline,
                                      **kw)
        assert torch.equal(got, off)


# -- engines ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(kind):
    """(repro config, port config, repro params, port params): the qwen3
    smoke config, or the reference's MoE-free MLA smoke config of
    test_kv_quantize.py (expert capacity cutoffs would make streams
    depend on batch composition)."""
    arch = "qwen3-0.6b" if kind == "gqa" else "deepseek-v2-236b"
    jc = jcfg.smoke(jcfg.get_config(arch))
    tc = tcfg.smoke(tcfg.get_config(arch))
    if kind == "mla":
        kw = dict(name="mla-dense-smoke", mla_absorb=True, n_experts=0,
                  moe_top_k=0, moe_d_ff=0, n_shared_experts=0,
                  moe_first_dense=0, n_layers=2)
        jc = dataclasses.replace(jc, block_pattern=(JBlockDef("mla",
                                                              "dense"),), **kw)
        tc = dataclasses.replace(tc, block_pattern=(TBlockDef("mla",
                                                              "dense"),), **kw)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.prepare_params(
        bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu"), tc)
    return jc, tc, jp, tp


def _prompt(seed, length, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, length).astype(
        np.int32)


def _both(kind, prompts, gen_kw, scfg=None, **ecfg):
    """The same requests through repro's engine and the port's (speculative
    when ``scfg`` names a proposer); streams must be equal.  Returns both
    engines and the port's requests."""
    jc, tc, jp, tp = _model(kind)
    if scfg is None:
        jeng = jserve.Engine(jc, jp, jserve.EngineConfig(**ecfg))
        teng = tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu",
                                                         **ecfg))
    else:
        jeng = jserve.SpecEngine(jc, jp, jserve.EngineConfig(**ecfg),
                                 jserve.SpecConfig(**scfg))
        teng = tserve.SpecEngine(tc, tp, tserve.EngineConfig(device="cpu",
                                                             **ecfg),
                                 tserve.SpecConfig(**scfg))
    jreqs = [jeng.submit(p, jserve.GenerateConfig(**gen_kw)) for p in prompts]
    treqs = [teng.submit(p, tserve.GenerateConfig(**gen_kw)) for p in prompts]
    jeng.run()
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.generated == [int(x) for x in j.generated], t.request_id
        assert len(t.generated) == gen_kw["max_new_tokens"]
    return jeng, teng, treqs


@pytest.mark.parametrize("kind,kv_dtype,chunk", [
    ("gqa", "int8", 0), ("gqa", "int8", 3), ("gqa", "fp8_e4m3", 0),
    ("gqa", "fp8_e4m3", 3), ("mla", "int8", 0), ("mla", "int8", 3)])
def test_engine_streams_equal_reference(kind, kv_dtype, chunk):
    """Greedy streams at a quantized kv_dtype equal repro's; chunked
    prefill re-reads the earlier chunks through the dequantized pages."""
    prompts = [_prompt(40 + i, n) for i, n in enumerate([5, 9, 7])]
    _, teng, _ = _both(kind, prompts, dict(max_new_tokens=6), num_slots=2,
                       page_size=4, max_len=32, prefill_chunk=chunk,
                       kv_dtype=kv_dtype)
    assert teng.cfg.kv_dtype == kv_dtype
    blk = next(iter(teng._kv.pools[0].values()))
    assert any(n.endswith("_scale") for n in blk)


def test_spec_engine_ngram_int8_equals_reference():
    motif = _prompt(47, 4)
    prompts = [np.tile(motif, 4), _prompt(48, 6)]
    _, teng, treqs = _both("gqa", prompts, dict(max_new_tokens=8),
                           scfg=dict(k=3, proposer="ngram"), num_slots=2,
                           page_size=4, max_len=48, kv_dtype="int8")
    assert teng.verify_steps > 0
    assert any(r.ledger.tokens_per_pass > 1.0 for r in treqs)


def test_preemption_swap_int8_equals_reference():
    """An undersized pool at int8: preempted requests swap their codes and
    scales to the host and resume; streams equal repro's and the fully
    backed run's."""
    prompts = [_prompt(70 + i, 6) for i in range(3)]
    kw = dict(num_slots=2, page_size=4, max_len=16, kv_dtype="int8",
              preempt_mode="swap")
    jeng, teng, treqs = _both("gqa", prompts, dict(max_new_tokens=6),
                              num_pages=6, **kw)
    assert teng._sched.preempt_count == jeng._sched.preempt_count > 0
    assert any(r.ledger.swap_bytes > 0 for r in treqs)
    _, _, full = _both("gqa", prompts, dict(max_new_tokens=6), **kw)
    assert [r.generated for r in full] == [r.generated for r in treqs]


def test_prefix_cache_cow_int8_equals_reference():
    shared = _prompt(100, 8)
    prompts = [np.concatenate([shared, _prompt(101 + i, 2)])
               for i in range(3)]
    _, teng, _ = _both("gqa", prompts, dict(max_new_tokens=6), num_slots=2,
                       page_size=4, max_len=18, prefix_cache=True,
                       kv_dtype="int8")
    assert teng._kv.pool.stats.dedup_hits > 0


def _double(kind, prompts, gen_kw, scfg=None, monkeypatch=None, **ecfg):
    """The same requests through the port's engine with
    ``pipeline="double"`` (speculative when ``scfg`` names a proposer),
    repro's engine with ``pipeline="off"`` (the streams' target) and
    repro's jnp engine priced at ``pipeline="double"`` (the ledger's; its
    kernels ignore the pipeline, as the port's plain versions do; its
    on-chip term priced by the launch-grid walk of the CUDA kernel the
    port dispatches to, the port ledger's count).
    Returns the port's engine and the pipelines its paged-attention
    dispatches carried."""
    monkeypatch.setattr(jsched, "attn_kernel_vmem_bytes",
                        txc.kernel_walk_vmem_bytes)
    jc, tc, jp, tp = _model(kind)
    seen = []
    real = ops.resolve

    def spy(name, device, pipeline=None):
        if "paged_attention" in name:
            seen.append(pipeline)
        return real(name, device, pipeline)

    def make(mod, params, cfg, **kw):
        e = mod.EngineConfig(**ecfg, **kw)
        if scfg is None:
            return mod.Engine(cfg, params, e)
        return mod.SpecEngine(cfg, params, e, mod.SpecConfig(**scfg))

    def run(eng, mod):
        reqs = [eng.submit(p, mod.GenerateConfig(**gen_kw)) for p in prompts]
        eng.run()
        return [[int(x) for x in r.generated] for r in reqs]

    want = run(make(jserve, jp, jc, pipeline="off"), jserve)
    jdbl = make(jserve, jp, jc, pipeline="double", kernel_backend="jnp")
    assert run(jdbl, jserve) == want
    monkeypatch.setattr(ops, "resolve", spy)
    teng = make(tserve, tp, tc, pipeline="double", device="cpu")
    assert run(teng, tserve) == want
    assert all(len(t) == gen_kw["max_new_tokens"] for t in want)
    got, ref = teng.aggregate_ledger(), jdbl.aggregate_ledger()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == pytest.approx(
            getattr(ref, f.name), rel=1e-12), f.name
    assert got.decode_vmem_bytes > 0
    return teng, set(seen)


@pytest.mark.parametrize("kind,kv_dtype", [
    ("gqa", "int8"), ("gqa", "fp8_e4m3"), ("mla", "int8"),
    ("mla", "fp8_e4m3")])
def test_engine_double_streams_equal_reference_off(kind, kv_dtype,
                                                   monkeypatch):
    """Quantized pools under ``pipeline="double"``, chunked prefill
    included: streams equal repro's quantized ``"off"`` engine, every
    paged dispatch carries ``"double"``, ledgers equal repro's double
    pricing."""
    prompts = [_prompt(40 + i, n) for i, n in enumerate([5, 9, 7])]
    teng, seen = _double(kind, prompts, dict(max_new_tokens=6),
                         monkeypatch=monkeypatch, num_slots=2, page_size=4,
                         max_len=32, prefill_chunk=3, kv_dtype=kv_dtype)
    assert teng.cfg.kv_dtype == kv_dtype and seen == {"double"}
    blk = next(iter(teng._kv.pools[0].values()))
    assert any(n.endswith("_scale") for n in blk)


def test_spec_engine_ngram_double_int8_equals_reference_off(monkeypatch):
    motif = _prompt(47, 4)
    prompts = [np.tile(motif, 4), _prompt(48, 6)]
    teng, seen = _double("gqa", prompts, dict(max_new_tokens=8),
                         scfg=dict(k=3, proposer="ngram"),
                         monkeypatch=monkeypatch, num_slots=2, page_size=4,
                         max_len=48, kv_dtype="int8")
    assert teng.verify_steps > 0 and seen == {"double"}
    assert teng.aggregate_ledger().accepted > 0


def _prefilled_cache(kind, S, **kw):
    """A port cache at int8 with one slot prefilled from an S-token
    prompt; returns (cache, slot, prompt tokens)."""
    _, tc, _, tp = _model(kind)
    tc = dataclasses.replace(tc, kv_dtype="int8")
    toks = _prompt(1, S)
    _, states = tm.prefill(tp, tc, torch.as_tensor(toks[None].astype(
        np.int64)))
    kv = tkv.PagedKVCache(tc, device=torch.device("cpu"), **kw)
    slot = kv.alloc(S, budget=kw["max_len"], tokens=toks)
    kv.write_prefill_states(slot, states, S)
    return kv, slot, toks


def _slot_pages(kv, slot):
    """Raw bytes of every leaf (codes and scales) of a slot's pages."""
    row = torch.as_tensor(kv.block_tables[slot][: kv.slot_pages(slot)],
                          dtype=torch.long)
    return {f"{i}/{b}/{n}": _bits(t[:, row]) for i, seg in
            enumerate(kv.pools) for b, blk in seg.items()
            for n, t in blk.items()}


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_swap_roundtrip_keeps_codes_and_scales(kind):
    kv, s, _ = _prefilled_cache(kind, 6, num_slots=3, page_size=4,
                                max_len=12)
    before = _slot_pages(kv, s)
    assert any(k.endswith("_scale") for k in before)
    snap = kv.swap_out(s)
    assert kv.pool.stats.swap_dmas == 1
    blocker = kv.alloc(4, slot=s)                # force another slot/pages
    s2 = kv.swap_in(snap)
    assert s2 is not None and s2 != s
    after = _slot_pages(kv, s2)
    assert before.keys() == after.keys()
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    kv.free(blocker)
    kv.pool.check(kv.table_refs())


def test_cow_copies_codes_and_scales():
    """Copy-on-write copies the codes AND their scales: the writer's copy
    holds the shared page's bytes, the sibling's view never moves."""
    S = 8
    kv, a, toks = _prefilled_cache("gqa", S, num_slots=2, page_size=4,
                                   max_len=16, prefix_cache=True)
    b = kv.alloc(S, budget=16, tokens=toks)
    assert (kv.block_tables[a][:2] == kv.block_tables[b][:2]).all()
    before = _slot_pages(kv, a)
    dense_a = [t.clone() for t in tm.params.tree_leaves(kv.dense_view(a))]
    assert kv.ensure_writable(b, S - 1, S)       # CoW of the shared page
    assert kv.pool.stats.cow_copies == 1
    assert kv.block_tables[a][1] != kv.block_tables[b][1]
    after_a, after_b = _slot_pages(kv, a), _slot_pages(kv, b)
    for k in before:
        np.testing.assert_array_equal(before[k], after_a[k], err_msg=k)
        np.testing.assert_array_equal(before[k], after_b[k], err_msg=k)
    for x, y in zip(dense_a, tm.params.tree_leaves(kv.dense_view(b))):
        assert x.dtype == torch.float32 or x.dtype == torch.bfloat16
        assert torch.equal(x[:, :, :S], y[:, :, :S])
    kv.pool.check(kv.table_refs())


def test_dense_view_dequantizes_to_model_dtype():
    kv, s, _ = _prefilled_cache("mla", 6, num_slots=2, page_size=4,
                                max_len=12)
    seg = kv.dense_view(s)[0]
    blk = next(iter(seg.values()))
    assert sorted(blk) == ["c_kv", "k_rope"]
    want = tm.params.torch_dtype(kv.cfg.dtype)
    assert all(t.dtype == want and t.shape[2] == kv.max_len
               for t in blk.values())


def test_engine_config_kv_dtype_validation_and_override():
    jc, tc, jp, tp = _model("gqa")
    eng = tserve.Engine(tc, tp, tserve.EngineConfig(
        num_slots=2, page_size=4, max_len=16, kv_dtype="int8",
        device="cpu"))
    assert eng.cfg.kv_dtype == "int8" and tc.kv_dtype == "bf16"
    with pytest.raises(ValueError, match="kv_dtype"):
        tserve.Engine(tc, tp, tserve.EngineConfig(
            num_slots=2, page_size=4, max_len=16, kv_dtype="int3",
            device="cpu"))
    # a quantized pool builds under pipeline="double" too
    eng = tserve.Engine(tc, tp, tserve.EngineConfig(
        num_slots=2, page_size=4, max_len=16, kv_dtype="int8",
        pipeline="double", device="cpu"))
    assert eng.cfg.kv_dtype == "int8" and eng.ecfg.pipeline == "double"
    # the draft model's cache keeps its own config's kv_dtype, under
    # either pipeline
    qdraft = dataclasses.replace(tc, kv_dtype="fp8_e4m3")
    dspec = tserve.SpecEngine(tc, tp, tserve.EngineConfig(
        num_slots=2, page_size=4, max_len=16, pipeline="double",
        device="cpu"), tserve.SpecConfig(k=2, proposer="draft",
                                         draft_cfg=qdraft, draft_params=tp))
    dspec.submit(_prompt(3, 5), tserve.GenerateConfig(max_new_tokens=3))
    dspec.run()
    assert dspec.cfg.kv_dtype == "bf16"
    assert dspec.proposer.kv.cfg.kv_dtype == "fp8_e4m3"
    assert any(n.endswith("_scale") for n in next(iter(
        dspec.proposer.kv.pools[0].values())))
    spec = tserve.SpecEngine(tc, tp, tserve.EngineConfig(
        num_slots=2, page_size=4, max_len=16, kv_dtype="int8",
        device="cpu"), tserve.SpecConfig(k=2, proposer="draft",
                                         draft_cfg=tc, draft_params=tp))
    spec.submit(_prompt(3, 5), tserve.GenerateConfig(max_new_tokens=3))
    spec.run()
    assert spec.cfg.kv_dtype == "int8"
    assert spec.proposer.kv.cfg.kv_dtype == "bf16"
    draft_blk = next(iter(spec.proposer.kv.pools[0].values()))
    assert not any(n.endswith("_scale") for n in draft_blk)


def test_serve_cli_kv_dtype_int8_on_cpu(capsys):
    tlaunch.main(["--smoke", "--device", "cpu", "--batch", "2",
                  "--prompt-len", "6", "--new-tokens", "3", "--slots", "2",
                  "--prefill-chunk", "4", "--kv-dtype", "int8"])
    out = capsys.readouterr().out
    assert "[serve] 2 requests, 6 tokens" in out
    assert "kv_dtype int8" in out


# -- plumbing --------------------------------------------------------------

def test_bridge_roundtrip_int8_and_fp8_byte_exact():
    rng = np.random.default_rng(5)
    tree = {"codes": [np.arange(-128, 128, dtype=np.int8).reshape(16, 16)],
            "fp8": rng.standard_normal((3, 7)).astype(
                ml_dtypes.float8_e4m3fn),
            "scale": rng.standard_normal((3,)).astype(np.float32)}
    t = bridge.to_torch(tree, device="cpu")
    assert t["codes"][0].dtype == torch.int8
    assert t["fp8"].dtype == torch.float8_e4m3fn
    back = bridge.to_numpy(t)
    for a, b in ((tree["codes"][0], back["codes"][0]),
                 (tree["fp8"], back["fp8"]), (tree["scale"], back["scale"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_swap_pack_aligns_every_leaf():
    """An int8 leaf of 7 bytes beside a float32 leaf: packed into one host
    buffer at 16-byte-aligned offsets, both restore exactly (a float32
    view at byte offset 7 would raise)."""
    _, tc, _, _ = _model("gqa")
    kv = tkv.PagedKVCache(dataclasses.replace(tc, kv_dtype="int8"),
                          num_slots=1, page_size=4, max_len=8,
                          device=torch.device("cpu"))
    codes = torch.arange(7, dtype=torch.int8).reshape(1, 7)
    fp8 = torch.linspace(-3, 3, 5).to(torch.float8_e4m3fn)
    scales = torch.linspace(0.5, 2.0, 6).reshape(2, 3)
    tree = [{"a": {"codes": codes, "fp8": fp8, "scale": scales}}]
    packed = kv._pack_to_host(tree)[0]["a"]
    for name, want in tree[0]["a"].items():
        got = packed[name]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.data_ptr() % tkv.PACK_ALIGN == 0 or got.numel() == 0
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert kv.pool.stats.swap_dmas == 1
