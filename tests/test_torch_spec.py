"""Speculative decoding in the port against the JAX package, on the same
numpy inputs and weights (carried across by repro_torch.bridge):

* the plain multi-token verify attentions (GQA and MLA) against repro's
  jnp references and its Pallas verify kernels (interpret mode,
  ``pipeline="off"``); T = 1 against the port's own decode versions;
* ``decode_step_verify_paged`` logits and written pools, smoke qwen3-0.6b
  and deepseek-v2 at float32;
* the acceptance rule: greedy = the argmax chain; sampled rows keep the
  target distribution;
* ``SpecEngine`` greedy streams against the port's plain ``Engine`` and
  ``repro.serve.SpecEngine`` (n-gram and draft proposers, GQA and MLA),
  budget edge and stop token, adaptive k, copy-on-write rollback under a
  shared prefix, ledger phase splits equal to the reference's;
* the plumbing: ``margin_tokens``, ``alloc(slot=...)``, the engine's
  ``_kv_margin`` / ``_preempt`` hooks, and the launcher's ``--spec``.

Tolerances: attention rtol 2e-5 / atol 2e-6 (the repo's kernel
tolerance), model logits rtol 1e-4 / atol 1e-5 (float32, XLA vs ATen op
order).  Random streams are torch's Philox, not JAX's threefry, so
sampled outputs are compared as distributions, never token for token.
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
from repro.kernels import paged_attention as jpa
from repro.kernels import quantize as jq
from repro.parallel.sharding import tree_instantiate
from repro.serve import proposer as jprop
from repro.serve import scheduler as jsched
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.serve as tserve
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.serve import crosscheck as txc
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import sampling as tsamp
from repro_torch.serve import scheduler as tsched

ATTN_TOL = dict(rtol=2e-5, atol=2e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
PAGE = 4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


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


# --------------------------------------------------------------------------
# Verify attention: plain versions vs repro's references and Pallas kernels
# --------------------------------------------------------------------------

def _tables(rng, B, T, page, nb, lens=None, trash=False):
    """Ragged tables as repro's tests draw them (slot b owns 1..nb live
    pages, pos anywhere in them, so pos + t may run onto trash entries),
    or explicit committed lengths ``lens`` (drafts' pages unbacked)."""
    P = 1 + B * nb
    bt = np.zeros((B, nb), np.int32)
    pos = np.zeros((B,), np.int32)
    if not trash:
        free = list(range(1, P))
        for b in range(B):
            if lens is None:
                live = rng.randint(1, nb + 1)
                p = rng.randint(0, live * page)
            else:
                live = min(-(-lens[b] // page), nb)
                p = lens[b] - 1
            for j in range(live):
                bt[b, j] = free.pop()
            pos[b] = p
    return P, bt, pos


def _gqa_inputs(seed, B, T, KV, G, hd, page, nb, **kw):
    rng = np.random.RandomState(seed)
    P, bt, pos = _tables(rng, B, T, page, nb, **kw)
    q = rng.standard_normal((B, T, KV, G, hd)).astype(np.float32)
    kp = rng.standard_normal((P, page, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, KV, hd)).astype(np.float32)
    return q, kp, vp, bt, pos


def _gqa_three_ways(args, **kw):
    ja = [jnp.asarray(a) for a in args]
    want_jnp = np.asarray(jpa.paged_attention_verify_reference(*ja, **kw))
    want_pallas = np.asarray(jpa.paged_attention_verify(
        *ja, **kw, interpret=True, pipeline="off"))
    got = ops.paged_attention_verify(*[torch.from_numpy(a) for a in args],
                                     **kw)
    return got.numpy(), want_jnp, want_pallas


@pytest.mark.parametrize("B,T,KV,G,hd,page,nb,case", [
    (3, 4, 2, 2, 16, 4, 5, "ragged"),    # GQA, odd block count
    (2, 2, 4, 1, 32, 8, 3, "ragged"),    # MHA (G=1)
    (2, 5, 1, 8, 64, 16, 2, "ragged"),   # single KV head
    (4, 5, 2, 5, 16, 4, 4, "edges"),     # page-crossing chains, past table
    (3, 4, 2, 2, 16, 4, 3, "trash"),     # idle lanes: all trash page 0
])
def test_gqa_verify_reference_matches_jax(B, T, KV, G, hd, page, nb, case):
    kw = {"trash": case == "trash",
          "lens": [3, 7, 1, nb * page + 1][:B] if case == "edges" else None}
    args = _gqa_inputs(B * 17 + T, B, T, KV, G, hd, page, nb, **kw)
    got, want_jnp, want_pallas = _gqa_three_ways(args, scale=hd ** -0.5,
                                                 soft_cap=20.0)
    assert np.isfinite(got).all()
    _close(got, want_jnp, ATTN_TOL)
    _close(got, want_pallas, ATTN_TOL)


def _mla_inputs(seed, B, T, H, r, dr, page, nb, **kw):
    rng = np.random.RandomState(seed)
    P, bt, pos = _tables(rng, B, T, page, nb, **kw)
    ql = rng.standard_normal((B, T, H, r)).astype(np.float32)
    qr = rng.standard_normal((B, T, H, dr)).astype(np.float32)
    cp = rng.standard_normal((P, page, r)).astype(np.float32)
    rp = rng.standard_normal((P, page, dr)).astype(np.float32)
    return ql, qr, cp, rp, bt, pos


@pytest.mark.parametrize("B,T,H,r,dr,page,nb,case", [
    (3, 3, 4, 32, 8, 4, 4, "ragged"),
    (2, 5, 8, 64, 16, 8, 2, "ragged"),
    (4, 4, 4, 32, 8, 4, 4, "edges"),
    (3, 3, 4, 32, 8, 4, 3, "trash"),
])
def test_mla_verify_reference_matches_jax(B, T, H, r, dr, page, nb, case):
    kw = {"trash": case == "trash",
          "lens": [3, 7, 1, nb * page + 1][:B] if case == "edges" else None}
    args = _mla_inputs(B * 19 + T, B, T, H, r, dr, page, nb, **kw)
    ja = [jnp.asarray(a) for a in args]
    scale = (r + dr) ** -0.5
    want_jnp = jpa.mla_paged_attention_verify_reference(*ja, scale=scale)
    want_pallas = jpa.mla_paged_attention_verify(
        *ja, scale=scale, interpret=True, pipeline="off")
    got = ops.mla_paged_attention_verify(
        *[torch.from_numpy(a) for a in args], scale=scale).numpy()
    assert np.isfinite(got).all()
    _close(got, want_jnp, ATTN_TOL)
    _close(got, want_pallas, ATTN_TOL)


def test_verify_t1_equals_decode_references():
    """A one-token verification IS a decode step (GQA and MLA)."""
    q, kp, vp, bt, pos = [torch.from_numpy(a) for a in
                          _gqa_inputs(23, 2, 1, 2, 2, 16, 4, 3)]
    ver = tpa.paged_attention_verify_reference(q, kp, vp, bt, pos,
                                               scale=0.25)[:, 0]
    dec = tpa.paged_attention_reference(q[:, 0], kp, vp, bt, pos, scale=0.25)
    _close(ver, dec, dict(rtol=1e-6, atol=1e-7))
    ql, qr, cp, rp, bt, pos = [torch.from_numpy(a) for a in
                               _mla_inputs(24, 2, 1, 4, 32, 8, 4, 3)]
    ver = tpa.mla_paged_attention_verify_reference(ql, qr, cp, rp, bt, pos,
                                                   scale=0.2)[:, 0]
    dec = tpa.mla_paged_attention_reference(ql[:, 0], qr[:, 0], cp, rp, bt,
                                            pos, scale=0.2)
    _close(ver, dec, dict(rtol=1e-6, atol=1e-7))


def test_verify_dispatch_and_kernel_refuses_cpu_tensors():
    gqa = [torch.from_numpy(a) for a in _gqa_inputs(3, 2, 3, 2, 2, 16, 4, 3)]
    mla = [torch.from_numpy(a) for a in
           _mla_inputs(4, 2, 3, 4, 32, 8, 4, 3)]
    for op, args, kw in [("paged_attention_verify", gqa, {}),
                         ("mla_paged_attention_verify", mla, {})]:
        cuda = getattr(tpa, op)
        assert ops.resolve(op, torch.device("cpu")) is \
            getattr(tpa, op + "_reference")
        assert ops.resolve(op, torch.device("cuda")) is cuda
        n = cuda.launches
        with pytest.raises(ValueError, match="CUDA tensors only"):
            cuda(*args, scale=0.25)
        getattr(ops, op)(*args, scale=0.25)
        assert cuda.launches == n                 # the plain version ran
    # scale pools: both plain versions dequantize int8 pools as repro's
    # jnp references do; the kernels still refuse CPU tensors
    for op, args, pool, names in [
            ("paged_attention_verify", gqa, 1, ("k_scale", "v_scale")),
            ("mla_paged_attention_verify", mla, 2, ("c_scale", "r_scale"))]:
        qargs = [a.numpy() for a in args]
        scales = {}
        for i, name in zip((pool, pool + 1), names):
            q, s = jq.quantize(jnp.asarray(qargs[i]), "int8", -1)
            qargs[i], scales[name] = np.asarray(q), np.asarray(s)
        want = getattr(jpa, op + "_reference")(
            *[jnp.asarray(a) for a in qargs], scale=0.25,
            **{k: jnp.asarray(v) for k, v in scales.items()})
        targs = [torch.from_numpy(a) for a in qargs]
        tkw = {k: torch.from_numpy(v) for k, v in scales.items()}
        got = getattr(tpa, op + "_reference")(*targs, scale=0.25, **tkw)
        _close(got.numpy(), want, ATTN_TOL)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            getattr(tpa, op)(*targs, scale=0.25, **tkw)


# --------------------------------------------------------------------------
# Model: decode_step_verify_paged
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_decode_step_verify_paged_matches(arch, qwen, deepseek):
    """Slot 0 prefills 9 tokens, then two verify steps of T = 4 (the
    second chain crosses a page and its last line falls on an unbacked
    trash entry); slot 1 is an idle lane.  Logits of every position of
    the live slot and all written pools are compared after each step."""
    jc, tc, jp, tp = qwen if arch == "qwen3-0.6b" else deepseek
    n_pages, T = 6, 4
    jpools = tree_instantiate(jm.paged_cache_defs(jc, 2, n_pages, PAGE),
                              jax.random.key(0))
    tpools = bridge.to_torch(jax.tree.map(np.asarray, jpools), device="cpu")
    row = np.array([2, 5, 1, 4, 0], np.int32)
    toks = np.random.RandomState(5).randint(0, jc.vocab_size, (1, 20))
    jlog, jpools = jm.prefill_chunk_paged(
        jp, jc, jpools, jnp.asarray(row), jnp.int32(0),
        jnp.asarray(toks[:, :9]), jnp.int32(0), page_size=PAGE)
    tm.prefill_chunk_paged(tp, tc, tpools, torch.from_numpy(row),
                           torch.from_numpy(toks[:, :9]).long(), 0,
                           page_size=PAGE)
    bt = np.stack([row, np.zeros_like(row)])
    for p in (9, 13):
        feed = np.stack([toks[0, p:p + T], np.zeros(T, np.int64)])
        pos = np.array([p, 0], np.int32)
        jlog, jpools = jm.decode_step_verify_paged(
            jp, jc, jpools, jnp.asarray(bt), jnp.asarray(feed, jnp.int32),
            jnp.asarray(pos), jnp.asarray([True, False]), page_size=PAGE)
        tlog = tm.decode_step_verify_paged(
            tp, tc, tpools, torch.from_numpy(bt), torch.from_numpy(feed),
            torch.from_numpy(pos), page_size=PAGE)
        assert tlog.shape == (2, T, tc.vocab_size)
        assert np.isfinite(tlog.numpy()).all()
        _close(tlog[0], jlog[0])
        for got, want in zip(jax.tree.leaves(bridge.to_numpy(tpools)),
                             jax.tree.leaves(jax.tree.map(np.asarray,
                                                          jpools))):
            _close(got[:, 1:], want[:, 1:])     # page 0 is the trash page


def test_verify_rejects_recurrent_mixers(qwen):
    _, tc, _, tp = qwen
    from repro_torch.models import transformer as tfm
    b = dataclasses.replace(tc.block_pattern[0], mixer="mamba")
    with pytest.raises(NotImplementedError, match="rollback-free"):
        tfm.apply_block_verify({"norm1": tp["final_norm"]}, b,
                               torch.zeros(1, 2, tc.d_model), {},
                               torch.zeros(1, dtype=torch.int32), tc,
                               torch.zeros(1, 2, dtype=torch.int32), PAGE,
                               {})


# --------------------------------------------------------------------------
# Acceptance rule and the draft sampler
# --------------------------------------------------------------------------

def _row_state(B, temps=0.0):
    return dict(seeds=np.arange(B, dtype=np.int64),
                steps=np.zeros((B,), np.int32),
                temps=np.full((B,), temps, np.float32),
                top_ks=np.zeros((B,), np.int32),
                top_ps=np.zeros((B,), np.float32))


def test_spec_accept_greedy_matches_argmax_chain():
    V, k = 16, 3
    logits = np.random.RandomState(2).standard_normal(
        (2, k + 1, V)).astype(np.float32)
    tgt = np.argmax(logits, axis=-1)
    # row 0: drafts track the argmax chain -> all accepted + bonus;
    # row 1: first draft wrong -> one corrected token only
    draft = np.stack([tgt[0, :k],
                      np.asarray([tgt[1, 0] + 1, 0, 0]) % V]).astype(np.int32)
    st = _row_state(2)
    toks, n_out = tsamp.spec_accept(
        torch.from_numpy(logits), draft, None, np.array([k, k]),
        st["seeds"], st["steps"], st["temps"], st["top_ks"], st["top_ps"])
    assert n_out.tolist() == [k + 1, 1]
    np.testing.assert_array_equal(toks[0].numpy(), tgt[0])
    assert int(toks[1, 0]) == tgt[1, 0]
    # the same inputs through the reference
    kd = np.zeros((2, jax.random.key_data(jax.random.key(0)).shape[0]),
                  np.uint32)
    jt, jn = jserve.sampling.spec_accept(
        jnp.asarray(logits), jnp.asarray(draft), None,
        jnp.asarray([k, k], jnp.int32), jnp.asarray(kd),
        jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.float32),
        jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.float32))
    assert n_out.tolist() == np.asarray(jn).tolist()
    np.testing.assert_array_equal(toks[0].numpy(), np.asarray(jt)[0])


@pytest.mark.parametrize("proposal", ["draft-q", "one-hot"])
def test_spec_accept_preserves_target_distribution(proposal):
    """The first committed token's marginal over many seeded rows equals
    the target softmax, whatever the proposal: a mismatched draft
    distribution q (drafts drawn from it), or a deterministic one-hot
    draft (the n-gram case).  N = 20000 rows over V = 12: total variation
    below 0.03, the reference test's bound (sampling noise alone gives
    ~0.01)."""
    V, k, N, temp = 12, 3, 20000, 0.8
    rng = np.random.RandomState(0)
    logits = rng.standard_normal((1, k + 1, V)).astype(np.float32) * 1.5
    p0 = torch.softmax(torch.from_numpy(logits[0, 0]) / temp, -1).numpy()
    st = _row_state(N, temps=temp)
    if proposal == "draft-q":
        qlog = rng.standard_normal((k, V))
        q = np.exp(qlog) / np.exp(qlog).sum(-1, keepdims=True)
        # inverse-CDF draws of each row's drafts from q
        cdf = np.cumsum(q, axis=-1)
        draft = np.minimum((rng.random_sample((N, k, 1)) > cdf).sum(-1),
                           V - 1).astype(np.int32)
        q_probs = torch.from_numpy(np.broadcast_to(q, (N, k, V)).astype(
            np.float32).copy())
    else:
        draft = np.tile(np.array([3, 5, 7], np.int32), (N, 1))
        q_probs = None
    toks, n_out = tsamp.spec_accept(
        torch.from_numpy(np.repeat(logits, N, axis=0)), draft, q_probs,
        np.full((N,), k), st["seeds"], st["steps"], st["temps"],
        st["top_ks"], st["top_ps"])
    emp = np.bincount(toks[:, 0].numpy(), minlength=V) / N
    assert 0.5 * np.abs(emp - p0).sum() < 0.03
    assert (n_out.numpy() >= 1).all() and (n_out.numpy() <= k + 1).all()


def test_sample_with_probs():
    """Greedy rows: the argmax and its one-hot.  Sampled rows: the
    tempered softmax (top-k applied), and the token sample_tokens draws
    for the same (seed, step)."""
    V = 10
    logits = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (3, V)).astype(np.float32))
    st = _row_state(3)
    st["temps"][1:] = [0.7, 1.3]
    st["top_ks"][2] = 4
    st["steps"][:] = [0, 3, 5]
    toks, probs = tsamp.sample_with_probs(logits, **st)
    assert int(toks[0]) == int(torch.argmax(logits[0]))
    assert probs[0].tolist() == torch.nn.functional.one_hot(
        toks[0], V).float().tolist()
    want1 = torch.softmax(logits[1] / 0.7, -1)
    _close(probs[1], want1)
    top4 = torch.topk(logits[2], 4).indices
    assert (probs[2] > 0).nonzero()[:, 0].sort().values.tolist() == \
        top4.sort().values.tolist()
    _close(probs[2].sum(), 1.0)
    same = tsamp.sample_tokens(logits, st["seeds"], st["steps"], st["temps"],
                               st["top_ks"], st["top_ps"])
    assert toks.tolist() == same.tolist()


def test_fold_seed_gives_distinct_streams():
    seeds = {tsamp.fold_seed(s, tag) for s in range(200)
             for tag in (tsamp.ACCEPT_FOLD, tsamp.DRAFT_FOLD)}
    assert len(seeds) == 400
    assert all(0 <= s < 2 ** 32 for s in seeds)
    assert tsamp.fold_seed(7, tsamp.DRAFT_FOLD) == \
        tsamp.fold_seed(7, tsamp.DRAFT_FOLD)


def test_ngram_propose_equals_reference():
    rng = np.random.RandomState(3)
    cases = [np.asarray([1, 2, 3, 9, 1, 2, 3, 7, 5, 1, 2, 3], np.int32),
             np.asarray([4, 5, 6], np.int32), np.full((6,), 8, np.int32)]
    cases += [rng.randint(0, 4, n).astype(np.int32) for n in (5, 9, 17)]
    for toks in cases:
        for k in (1, 2, 3, 4):
            np.testing.assert_array_equal(
                tserve.ngram_propose(toks, k), jprop.ngram_propose(toks, k))


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------

def _prompt(cfg, seed, length):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, length).astype(np.int32)


def _scfgs(jc, tc, jp, tp, proposer, **kw):
    if proposer == "draft":
        return (jserve.SpecConfig(k=3, proposer="draft", draft_cfg=jc,
                                  draft_params=jp, **kw),
                tserve.SpecConfig(k=3, proposer="draft", draft_cfg=tc,
                                  draft_params=tp, **kw))
    return (jserve.SpecConfig(k=3, proposer="ngram", **kw),
            tserve.SpecConfig(k=3, proposer="ngram", **kw))


def _three_engines(model, prompts, gen, proposer, ecfg, **skw):
    """Greedy streams of repro's SpecEngine, the port's SpecEngine and the
    port's plain Engine on the same prompts."""
    jc, tc, jp, tp = model
    jscfg, tscfg = _scfgs(jc, tc, jp, tp, proposer, **skw)
    jeng = jserve.SpecEngine(jc, jp, jserve.EngineConfig(**ecfg), jscfg)
    teng = tserve.SpecEngine(tc, tp, tserve.EngineConfig(device="cpu",
                                                         **ecfg), tscfg)
    base = tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu", **ecfg))
    out = []
    for eng, mod in ((jeng, jserve), (teng, tserve), (base, tserve)):
        reqs = [eng.submit(p, mod.GenerateConfig(**gen)) for p in prompts]
        eng.run()
        out.append(reqs)
    return jeng, teng, out


@pytest.mark.parametrize("arch,proposer", [
    ("qwen3-0.6b", "ngram"), ("qwen3-0.6b", "draft"),
    ("deepseek-v2-236b", "ngram"), ("deepseek-v2-236b", "draft")])
def test_spec_greedy_streams_identical(arch, proposer, qwen, deepseek):
    """Greedy speculative streams equal the port's sequential engine and
    repro's SpecEngine token for token (draft = target weights: near-total
    acceptance drives the multi-token commit path)."""
    model = qwen if arch == "qwen3-0.6b" else deepseek
    prompts = [_prompt(model[0], 10 + i, n) for i, n in enumerate([5, 8, 6])]
    _, teng, (jreqs, treqs, breqs) = _three_engines(
        model, prompts, dict(max_new_tokens=8), proposer,
        dict(num_slots=2, page_size=PAGE, max_len=32))
    for j, t, b in zip(jreqs, treqs, breqs):
        assert t.generated == b.generated
        assert t.generated == [int(x) for x in j.generated]
    if proposer == "draft":
        assert all(r.ledger.tokens_per_pass > 1.5 for r in treqs)
        assert all(r.ledger.acceptance_rate > 0.5 for r in treqs)
        assert all(r.ledger.draft_flops > 0 for r in treqs)
    assert teng.verify_steps > 0


def test_spec_ledger_phase_splits_equal_reference(qwen, monkeypatch):
    """The same run through repro's and the port's SpecEngine (draft
    proposer, chunked prefill, two slots) charges every request's ledger
    and the verify phase the same W, Q, tokens, passes and acceptance."""
    # the ledger's on-chip term is the CUDA kernels' count: the reference's
    # ledger is priced with the launch-grid walk of those kernels, so the
    # rest of it stays the baseline and the term is held against the walk
    monkeypatch.setattr(jsched, "attn_kernel_vmem_bytes",
                        txc.kernel_walk_vmem_bytes)
    jc = qwen[0]
    prompts = [_prompt(jc, 60 + i, 6) for i in range(3)]
    jeng, teng, (jreqs, treqs, _) = _three_engines(
        qwen, prompts, dict(max_new_tokens=8), "draft",
        dict(num_slots=2, page_size=PAGE, max_len=16, prefill_chunk=4))
    fields = ("decode_flops", "decode_bytes", "decode_vmem_bytes",
              "decode_tokens", "decode_batch_sum", "weight_passes",
              "draft_flops", "draft_bytes", "proposed", "accepted")
    for j, t in zip(jreqs, treqs):
        for f in fields:
            assert getattr(t.ledger, f) == pytest.approx(
                getattr(j.ledger, f), rel=1e-12), f
        assert t.ledger.tokens_per_pass == j.ledger.tokens_per_pass
        assert t.ledger.arithmetic_intensity == pytest.approx(
            j.ledger.arithmetic_intensity, rel=1e-12)
    jv, tv = jeng.phases["verify"], teng.phases["verify"]
    for f in ("flops", "vmem", "hbm", "steps", "tokens"):
        assert getattr(tv, f) == pytest.approx(getattr(jv, f), rel=1e-12), f
    assert teng.phases["draft"].steps == jeng.phases["draft"].steps
    # the analytic speculative summary agrees too
    jsum = jserve.spec.speculative_summary(jc, jreqs, 3, 10, draft_cfg=jc)
    tsum = tserve.speculative_summary(qwen[1], treqs, 3, 10,
                                      draft_cfg=qwen[1])
    for key, val in jsum.items():
        assert tsum[key] == pytest.approx(val, rel=1e-12), key


def test_spec_budget_edge_and_stop_token(qwen):
    """Commits stop at max_new_tokens (the budget-edge verify writes fall
    on the trash margin), and a stop token committed mid-chain ends the
    request as sequential decode does; chunked prefill composes."""
    jc, tc, jp, tp = qwen
    prompt = _prompt(jc, 31, 6)
    ecfg = dict(num_slots=1, page_size=PAGE, max_len=16)
    base = tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu", **ecfg))
    b = base.submit(prompt, tserve.GenerateConfig(max_new_tokens=7))
    base.run()
    scfg = tserve.SpecConfig(k=3, proposer="draft", draft_cfg=tc,
                             draft_params=tp)
    eng = tserve.SpecEngine(tc, tp, tserve.EngineConfig(
        device="cpu", prefill_chunk=3, **ecfg), scfg)
    s = eng.submit(prompt, tserve.GenerateConfig(max_new_tokens=7))
    eng.run()
    assert s.generated == b.generated and len(s.generated) == 7
    stop = b.generated[2]
    gen = tserve.GenerateConfig(max_new_tokens=7, stop_token=stop)
    base2 = tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu", **ecfg))
    b2 = base2.submit(prompt, gen)
    base2.run()
    eng2 = tserve.SpecEngine(tc, tp, tserve.EngineConfig(device="cpu",
                                                         **ecfg), scfg)
    s2 = eng2.submit(prompt, gen)
    eng2.run()
    assert s2.generated == b2.generated
    assert s2.finish_reason == "stop"


def test_spec_refuses_recurrent_archs():
    cfg = tcfg.smoke(tcfg.get_config("xlstm-350m"))
    assert not tserve.supports_spec(cfg)
    with pytest.raises(NotImplementedError, match="rollback-free"):
        tserve.SpecEngine(cfg, None)
    for arch in jcfg.ALL_ARCHS:
        assert tserve.supports_spec(tcfg.get_config(arch)) == \
            jserve.supports_spec(jcfg.get_config(arch))


def test_spec_config_errors(qwen):
    _, tc, _, tp = qwen
    ecfg = tserve.EngineConfig(device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        tserve.SpecEngine(tc, tp, ecfg, tserve.SpecConfig(k=0))
    with pytest.raises(ValueError, match="draft_cfg"):
        tserve.SpecEngine(tc, tp, ecfg, tserve.SpecConfig(proposer="draft"))
    with pytest.raises(ValueError, match="vocab"):
        tserve.SpecEngine(tc, tp, ecfg, tserve.SpecConfig(
            proposer="draft", draft_params=tp,
            draft_cfg=dataclasses.replace(tc, vocab_size=7)))
    with pytest.raises(ValueError, match="unknown proposer"):
        tserve.SpecEngine(tc, tp, ecfg, tserve.SpecConfig(proposer="x"))


def test_adaptive_k_rule_and_yield_model(qwen):
    for a in (1.0, 0.0, 0.9, 0.5, 0.3, 1e-9):
        for k_max, floor, k_min in ((4, 0.25, 1), (8, 0.25, 2)):
            assert tserve.adaptive_k(a, k_max, floor, k_min) == \
                jserve.adaptive_k(a, k_max, floor, k_min)
    assert tserve.adaptive_k(0.5, 8, floor=0.25) == 2
    for a in np.linspace(0.0, 1.0, 11):
        assert tserve.spec_expected_tokens_per_pass(float(a), 4) == \
            pytest.approx(jserve.spec_expected_tokens_per_pass(float(a), 4))
    jc, tc = qwen[0], qwen[1]
    for dc in (None, "self"):
        got = tserve.spec_speedup_model(tc, 3, 0.7, 16, 2,
                                        draft_cfg=tc if dc else None)
        want = jserve.spec_speedup_model(jc, 3, 0.7, 16, 2,
                                         draft_cfg=jc if dc else None)
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-12)


@pytest.mark.parametrize("proposer", ["ngram", "draft"])
def test_adaptive_k_streams_identical(qwen, proposer):
    """Shrinking the drafted length inside the fixed verify shape keeps
    greedy streams identical; the EWMA state is dropped at finish."""
    prompts = [_prompt(qwen[0], 110 + i, n) for i, n in enumerate([5, 8, 6])]
    _, teng, (jreqs, treqs, breqs) = _three_engines(
        qwen, prompts, dict(max_new_tokens=8), proposer,
        dict(num_slots=2, page_size=PAGE, max_len=32), adaptive=True,
        ewma_beta=0.6)
    for j, t, b in zip(jreqs, treqs, breqs):
        assert t.generated == b.generated
        assert t.generated == [int(x) for x in j.generated]
        assert t.ledger.proposed == j.ledger.proposed
    assert not teng._accept_ewma


def test_spec_cow_rollback_with_shared_prefix(qwen):
    """Identical page-aligned prompts alias the same pages; the first
    divergent write copies, and rejected-draft writes never reach a
    sibling: greedy streams stay equal to the unshared plain engine."""
    jc, tc, jp, tp = qwen
    prompt = np.tile(_prompt(jc, 120, 2), 4).astype(np.int32)
    gen = tserve.GenerateConfig(max_new_tokens=8)
    base = tserve.Engine(tc, tp, tserve.EngineConfig(
        device="cpu", num_slots=2, page_size=PAGE, max_len=16))
    breqs = [base.submit(prompt.copy(), gen) for _ in range(3)]
    base.run()
    eng = tserve.SpecEngine(
        tc, tp, tserve.EngineConfig(device="cpu", num_slots=2,
                                    page_size=PAGE, max_len=16,
                                    prefix_cache=True),
        tserve.SpecConfig(k=3, proposer="ngram"))
    sreqs = [eng.submit(prompt.copy(), gen) for _ in range(3)]
    eng.run()
    for b, s in zip(breqs, sreqs):
        assert s.generated == b.generated
    pool = eng._kv.pool
    assert pool.stats.dedup_hits > 0
    assert pool.stats.cow_copies > 0
    assert any(r.ledger.accepted < r.ledger.proposed for r in sreqs)
    pool.check(eng._kv.table_refs())


def test_spec_sampled_outputs_statistically_agree(qwen):
    """Temperature 1: the speculative and the plain engine draw from the
    same distribution.  Next-token histograms over 150 seeded requests
    (vocab 16, 2 spec-affected tokens each) within total variation 0.2,
    the reference test's bound."""
    _, tc, _, _ = qwen
    tc = dataclasses.replace(tc, vocab_size=16)
    tp = tm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    prompt = _prompt(tc, 50, 6)
    gen = tserve.GenerateConfig(max_new_tokens=3, temperature=1.0)
    N = 150

    def collect(engine):
        reqs = [engine.submit(prompt, gen, seed=1000 + i) for i in range(N)]
        engine.run()
        toks = np.asarray([r.generated[1:] for r in reqs]).ravel()
        return np.bincount(toks, minlength=tc.vocab_size) / toks.size

    ecfg = dict(device="cpu", num_slots=4, page_size=PAGE, max_len=16)
    base = tserve.Engine(tc, tp, tserve.EngineConfig(**ecfg))
    spec = tserve.SpecEngine(tc, tp, tserve.EngineConfig(**ecfg),
                             tserve.SpecConfig(k=2, proposer="draft",
                                               draft_cfg=tc,
                                               draft_params=tp))
    tv = 0.5 * np.abs(collect(base) - collect(spec)).sum()
    assert tv < 0.2, tv


# --------------------------------------------------------------------------
# Plumbing
# --------------------------------------------------------------------------

def test_kv_margin_tokens_widen_tables_without_pages(qwen):
    jc, tc = qwen[0], qwen[1]
    for margin in (0, 4, 5):
        t = tkv.PagedKVCache(tc, 3, PAGE, 16, torch.device("cpu"),
                             margin_tokens=margin)
        j = jserve.kv_cache.PagedKVCache(jc, 3, PAGE, 16,
                                         margin_tokens=margin)
        assert t.blocks_per_slot == j.blocks_per_slot == 4 + -(-margin // 4)
        assert t.max_len == j.max_len == 16
        assert t.num_pages == j.num_pages == 1 + 3 * 4
        slot = t.alloc(10, budget=16)
        assert (t.block_tables[slot, 4:] == 0).all()  # margin: trash page


def test_alloc_pins_a_slot(qwen):
    tc = qwen[1]
    kv = tkv.PagedKVCache(tc, 4, PAGE, 16, torch.device("cpu"))
    assert kv.alloc(5, slot=2) == 2
    assert kv.alloc(5) == 0                     # the default order holds
    assert kv.alloc(3, slot=3) == 3
    free_pages = kv.available_page_count
    with pytest.raises(ValueError, match="slot 2 is not free"):
        kv.alloc(5, slot=2)
    assert kv.available_page_count == free_pages  # pages given back
    kv.free(2)
    assert kv.alloc(5, slot=2) == 2


def test_engine_hooks(qwen, monkeypatch):
    """Plain Engine: no table margin; pool-dry preemption goes through
    ``_preempt``.  SpecEngine: margin k+1, and a preempted request's draft
    slot is released with it."""
    _, tc, _, tp = qwen
    ecfg = dict(device="cpu", num_slots=2, page_size=PAGE, max_len=16,
                num_pages=6)
    base = tserve.Engine(tc, tp, tserve.EngineConfig(**ecfg))
    assert base._kv_margin() == 0
    spec = tserve.SpecEngine(tc, tp, tserve.EngineConfig(**ecfg),
                             tserve.SpecConfig(k=3, proposer="draft",
                                               draft_cfg=tc,
                                               draft_params=tp))
    assert spec._kv_margin() == 4
    for eng in (base, spec):
        calls = []
        orig = eng._preempt
        monkeypatch.setattr(eng, "_preempt",
                            lambda r, orig=orig: (calls.append(r), orig(r)))
        reqs = [eng.submit(_prompt(tc, 90 + i, 6),
                           tserve.GenerateConfig(max_new_tokens=9))
                for i in range(2)]
        eng.run()
        assert all(len(r.generated) == 9 for r in reqs)
        assert calls                        # the pool ran dry: preempted
    assert spec._kv.blocks_per_slot == base._kv.blocks_per_slot + 1
    assert not spec.proposer._slots         # every draft slot released


def test_launcher_spec_flags_on_cpu(capsys):
    from repro_torch.launch import serve
    for extra in (["--spec", "ngram"],
                  ["--spec", "draft", "--draft-arch", "qwen3-0.6b",
                   "--draft-layers", "1", "--spec-k-adaptive"]):
        serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "6", "--new-tokens", "4", "--slots", "2",
                    "--spec-k", "2"] + extra)
        out = capsys.readouterr().out
        assert "[serve/spec] proposer=" + extra[1] in out
        assert "(random weights)" in out


def test_verify_pricing_equals_reference(qwen, deepseek, monkeypatch):
    # the ledger's on-chip term is the CUDA kernels' count: the reference's
    # ledger is priced with the launch-grid walk of those kernels, so the
    # rest of it stays the baseline and the term is held against the walk
    monkeypatch.setattr(jsched, "attn_kernel_vmem_bytes",
                        txc.kernel_walk_vmem_bytes)
    for jc, tc in ((qwen[0], qwen[1]), (deepseek[0], deepseek[1])):
        for L, T, B in ((1, 1, 1), (17, 4, 3), (100, 5, 2)):
            assert tsched.verify_step_vmem_bytes(tc, L, T, B, PAGE) == \
                pytest.approx(jsched.verify_step_vmem_bytes(
                    jc, L, T, B, PAGE), rel=1e-12)
            jl, tl = jsched.RooflineLedger(), tsched.RooflineLedger()
            jl.add_verify_step(jc, L, T, 2, 1, T - 1, B, vmem_bytes=5.0)
            tl.add_verify_step(tc, L, T, 2, 1, T - 1, B, vmem_bytes=5.0)
            jl.add_draft_cost(jc, L, 2, T - 2, B)
            tl.add_draft_cost(tc, L, 2, T - 2, B)
            for f in ("decode_flops", "decode_bytes", "decode_tokens",
                      "weight_passes", "draft_flops", "draft_bytes",
                      "proposed", "accepted"):
                assert getattr(tl, f) == pytest.approx(getattr(jl, f),
                                                       rel=1e-12), f


def test_row_generator_streams_differ_across_requests():
    """Requests with different seeds draw different noise at the same
    step (a seed laid out as seed << 32 | step lost the request seed on
    the CPU, whose generator keeps a seed's low 32 bits only)."""
    draws = {tuple(torch.rand(4, generator=tsamp.row_generator(
        s, 3, torch.device("cpu"))).tolist()) for s in range(50)}
    assert len(draws) == 50
    again = torch.rand(4, generator=tsamp.row_generator(
        7, 3, torch.device("cpu")))
    assert tuple(again.tolist()) in draws
