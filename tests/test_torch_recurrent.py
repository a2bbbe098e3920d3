"""The port's recurrent and hybrid mixers (``models/ssm.py``,
``models/xlstm.py``) and the per-slot state rows of the paged engine
against the JAX package, on smoke configs in float32 (scan_chunk 8,
mamba_d_state 8): the mixers at L = 5 (one chunk) and L = 16, 24 (the
chunk loop), with and without incoming state, against the port's own
step-by-step versions and across a prefix / suffix split; the decode and
prefill-chunk steps; ``PagedKVCache``'s state rows; the scheduler's state
pricing at the full configs.  The engines and the cross-checks are in
``test_torch_recurrent_engine.py``.

Tolerances: the mixers atol = rtol = 1e-5 (float32 sums in other orders:
XLA's fused products against torch's, cumulative sums); logits 1e-4
(several layers of them)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models as jm
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.models import xlstm as jxlstm
from repro.serve import kv_cache as jkv
from repro.serve import scheduler as jsched
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.serve as tserve
from repro_torch import bridge
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.models import xlstm as txlstm
from repro_torch.models.params import tree_leaves
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import scheduler as tsched

MIXER_TOL = dict(atol=1e-5, rtol=1e-5)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["xlstm-350m", "jamba-v0.1-52b"]


def _cfgs(arch):
    return (jcfg.smoke(jcfg.get_config(arch)),
            tcfg.smoke(tcfg.get_config(arch)))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jc, tc = _cfgs(request.param)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.prepare_params(
        bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu"), tc)
    return jc, tc, jp, tp


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=MIXER_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tail", [False, True], ids=["zeros", "tail"])
@pytest.mark.parametrize("L", [1, 5, 16])
def test_causal_conv1d_matches_reference(L, tail):
    x, w = _rand(0, (2, L, 12)), _rand(1, (12, 4))
    t = _rand(2, (2, 3, 12)) if tail else None
    jy, jt = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                   None if t is None else jnp.asarray(t))
    ty, tt = tlayers.causal_conv1d(_t(x), _t(w),
                                   None if t is None else _t(t))
    _close(ty, jy)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("shape", [(2, 5, 4, 16), (3, 7, 32)])
def test_group_norm_heads_matches_reference(shape):
    x = _rand(3, shape, 2.0) + 0.5
    _close(tlayers.group_norm_heads(_t(x)),
           jlayers.group_norm_heads(jnp.asarray(x)))


# --------------------------------------------------------------------------
# Mixers
# --------------------------------------------------------------------------

_MIXERS = {
    "mamba": ("jamba-v0.1-52b", jssm.mamba_defs, jssm.mamba_mixer,
              tssm.mamba_mixer, jssm.state_defs),
    "mlstm": ("xlstm-350m", jxlstm.mlstm_defs, jxlstm.mlstm_mixer,
              txlstm.mlstm_mixer, jxlstm.mlstm_state_defs),
    "slstm": ("xlstm-350m", jxlstm.slstm_defs, jxlstm.slstm_mixer,
              txlstm.slstm_mixer, jxlstm.slstm_state_defs),
}


def _mixer_case(kind, L, with_state, seed=0):
    arch, defs, jfn, tfn, sdefs = _MIXERS[kind]
    jc, tc = _cfgs(arch)
    from repro.parallel.sharding import tree_instantiate
    p = tree_instantiate(defs(jc), jax.random.key(seed))
    x = _rand(seed + 1, (2, L, jc.d_model))
    state = None
    if with_state:
        sd = sdefs(jc, 2)
        state = {k: jnp.asarray(_rand(seed + 2 + i, d.shape, 0.5)
                                ).astype(d.dtype)
                 for i, (k, d) in enumerate(sorted(sd.items()))}
        if "m" in state:                   # a stabilizer of either sign
            state["m"] = state["m"] * 2.0
        if "n" in state and kind == "slstm":
            state["n"] = jnp.abs(state["n"]) + 0.5
    tp = bridge.to_torch(jax.tree.map(np.asarray, p), device="cpu")
    tst = None if state is None else bridge.to_torch(
        jax.tree.map(np.asarray, state), device="cpu")
    return jc, tc, p, tp, x, state, tst, jfn, tfn


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("L", [5, 16, 24])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_mixer_matches_reference(kind, L, with_state):
    """Each mixer's output and final state against the reference: L = 5
    runs one chunk, 16 and 24 the chunk loop (scan_chunk 8)."""
    jc, tc, p, tp, x, st, tst, jfn, tfn = _mixer_case(kind, L, with_state)
    jo, jst = jfn(p, jnp.asarray(x), jc, state=st, return_state=True)
    with torch.no_grad():
        to, tst_out = tfn(tp, _t(x), tc, state=tst, return_state=True)
    _close(to, jo)
    assert sorted(tst_out) == sorted(jst)
    for k in jst:
        _close(tst_out[k], jst[k])


def test_scan_matches_associative_scan():
    """The odd / even recursion against jax.lax.associative_scan at odd
    and even lengths (to float32 rounding)."""
    for n in (1, 2, 5, 8, 13):
        a = np.exp(-np.abs(_rand(n, (2, n, 3, 4))))
        b = _rand(n + 50, (2, n, 3, 4))

        def comb(e1, e2):
            return e2[0] * e1[0], e2[0] * e1[1] + e2[1]

        ja, jb = jax.lax.associative_scan(comb, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
        ta, tb = tssm._scan(_t(a), _t(b))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("L", [5, 16, 24])
def test_mamba_matches_naive(L, with_state):
    _, tc, _, tp, x, _, tst, _, _ = _mixer_case("mamba", L, with_state)
    with torch.no_grad():
        _close(tssm.mamba_mixer(tp, _t(x), tc, state=tst),
               tssm.mamba_mixer_naive(tp, _t(x), tc, state=tst))


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("T", [5, 8])
def test_mlstm_chunk_matches_naive(T, with_state):
    """One chunk of the chunkwise mLSTM against the sequential cell."""
    B, H, hd = 2, 3, 8
    q, k, v = (_t(_rand(i, (B, H, T, hd))) for i in range(3))
    k = k / hd ** 0.5
    li = _t(_rand(4, (B, H, T)))
    lf = torch.nn.functional.logsigmoid(_t(_rand(5, (B, H, T))) + 2.0)
    if with_state:
        C0, n0 = _t(_rand(6, (B, H, hd, hd), 0.3)), _t(_rand(7, (B, H, hd)))
        m0 = _t(_rand(8, (B, H)))
    else:
        C0, n0, m0 = (torch.zeros(s) for s in
                      ((B, H, hd, hd), (B, H, hd), (B, H)))
    h, _ = txlstm._mlstm_chunk(q, k, v, li, lf, C0, n0, m0)
    _close(h, txlstm.mlstm_cell_naive(q, k, v, li, lf, C0, n0, m0))


@pytest.mark.parametrize("split", [3, 8, 13])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_mixer_state_continuity(kind, split):
    """A prefix then the suffix from its state equals the whole sequence
    (L 16: the whole runs the chunk loop, the pieces one chunk each)."""
    _, tc, _, tp, x, _, _, _, tfn = _mixer_case(kind, 16, False)
    x = _t(x)
    with torch.no_grad():
        whole, st = tfn(tp, x, tc, return_state=True)
        a, st_a = tfn(tp, x[:, :split], tc, return_state=True)
        b, st_b = tfn(tp, x[:, split:], tc, state=st_a, return_state=True)
    _close(torch.cat([a, b], dim=1), whole)
    for k in st:
        _close(st_b[k], st[k])


def test_mamba_decode_continues_the_sequence():
    """``mamba_decode`` (L = 1) from the state of the first 15 positions
    equals the 16th position of the whole sequence."""
    _, tc, _, tp, x, _, _, _, _ = _mixer_case("mamba", 16, False)
    x = _t(x)
    with torch.no_grad():
        whole = tssm.mamba_mixer(tp, x, tc)
        _, st = tssm.mamba_mixer(tp, x[:, :15], tc, return_state=True)
        last, _ = tssm.mamba_decode(tp, x[:, 15:], st, tc)
    _close(last, whole[:, 15:])


# --------------------------------------------------------------------------
# Model steps
# --------------------------------------------------------------------------

def test_check_supported_accepts_item_8():
    for arch in ARCHS:
        ttfm.check_supported(tcfg.get_config(arch))
    assert not {"mamba", "mlstm", "slstm"} & set(ttfm._TODO)


def test_forward_full_matches_reference(model):
    jc, tc, jp, tp = model
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (2, 19))
    jl, _, jst = jtfm.forward_full(jp, jc, jnp.asarray(toks, jnp.int32),
                                   collect_state=True)
    with torch.no_grad():
        tl, _, tst = ttfm.forward_full(tp, tc, _t(toks).long(),
                                       collect_state=True)
    _close(tl, jl, LOGITS_TOL)
    jleaves = jax.tree.leaves(jst)
    tleaves = tree_leaves(tst)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        _close(t, j, LOGITS_TOL)


def _paged_pools(jc, tc, num_slots, num_pages, page, seed=9):
    """Random pools of both packages (state rows and pages alike)."""
    jdefs = jtfm.paged_cache_defs(jc, num_slots, num_pages, page)
    from repro.parallel.sharding import tree_instantiate
    jpools = tree_instantiate(jdefs, jax.random.key(seed))
    jpools = jax.tree.map(
        lambda a: jnp.asarray(_rand(seed + a.size % 97, a.shape, 0.3)
                              ).astype(a.dtype), jpools)
    tpools = bridge.to_torch(jax.tree.map(np.asarray, jpools), device="cpu")
    return jpools, tpools


def test_decode_one_paged_matches_reference(model):
    """One packed decode step with slot 2 idle: logits of the active
    slots and every pool leaf against the reference; the idle slot's
    state rows keep their bytes."""
    jc, tc, jp, tp = model
    B, page, nb = 4, 4, 3
    num_pages = 1 + B * nb
    jpools, tpools = _paged_pools(jc, tc, B, num_pages, page)
    bt = np.arange(1, 1 + B * nb, dtype=np.int32).reshape(B, nb)
    active = np.array([True, True, False, True])
    bt[~active] = 0
    pos = np.array([5, 2, 0, 9], np.int32)
    tok = np.array([[3], [17], [0], [200]], np.int32)
    before = [t.clone() for t in tree_leaves(tpools)]
    flags = tree_leaves(tkv.paged_flags(tc))
    jlog, jnew = jtfm.decode_one_paged(
        jp, jc, jpools, jnp.asarray(bt), jnp.asarray(tok), jnp.asarray(pos),
        jnp.asarray(active), page_size=page)
    with torch.no_grad():
        tlog = ttfm.decode_one_paged(
            tp, tc, tpools, _t(bt), _t(tok).long(), _t(pos),
            page_size=page, active=_t(active))
    _close(tlog[_t(active)], np.asarray(jlog)[active], LOGITS_TOL)
    for j, t, b, paged in zip(jax.tree.leaves(jnew), tree_leaves(tpools),
                              before, flags):
        if paged:
            _close(t[:, 1:], np.asarray(j)[:, 1:], LOGITS_TOL)
        else:
            _close(t[:, active], np.asarray(j)[:, active], LOGITS_TOL)
            assert torch.equal(t[:, 2], b[:, 2])


def test_decode_needs_the_active_mask(model):
    _, tc, _, tp = model
    tpools = _paged_pools(*_cfgs(tc.name[:-len("-smoke")]), 2, 3, 4)[1]
    with pytest.raises(ValueError, match="active"):
        ttfm.decode_one_paged(tp, tc, tpools, torch.zeros((2, 1), dtype=
                              torch.int32), torch.zeros((2, 1),
                              dtype=torch.long), torch.zeros(
                              (2,), dtype=torch.int32), page_size=4)


@pytest.mark.parametrize("slot_kind", ["int", "tensor"])
def test_prefill_chunks_match_reference(model, slot_kind):
    """Two chunks of one request through slot 1 (an int or a 0-d
    tensor): last logits and every leaf against the reference; the other
    slots' rows keep their bytes."""
    jc, tc, jp, tp = model
    S, page, nb = 3, 4, 4
    num_pages = 1 + S * nb
    jpools, tpools = _paged_pools(jc, tc, S, num_pages, page)
    before = [t.clone() for t in tree_leaves(tpools)]
    flags = tree_leaves(tkv.paged_flags(tc))
    row = np.array([5, 6, 7, 8], np.int32)
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, 11)
    slot = 1 if slot_kind == "int" else torch.tensor(1, dtype=torch.int32)
    for start, end in ((0, 6), (6, 11)):
        jlog, jpools = jtfm.prefill_chunk_paged(
            jp, jc, jpools, jnp.asarray(row), jnp.int32(1),
            jnp.asarray(toks[None, start:end], jnp.int32), jnp.int32(start),
            page_size=page)
        with torch.no_grad():
            tlog = ttfm.prefill_chunk_paged(
                tp, tc, tpools, _t(row), _t(toks[None, start:end]).long(),
                start, page_size=page, slot=slot)
        _close(tlog, jlog, LOGITS_TOL)
    for j, t, b, paged in zip(jax.tree.leaves(jpools),
                              tree_leaves(tpools), before, flags):
        _close(t, j, LOGITS_TOL)
        if not paged:
            assert torch.equal(t[:, 0], b[:, 0])
            assert torch.equal(t[:, 2], b[:, 2])


# --------------------------------------------------------------------------
# PagedKVCache state rows
# --------------------------------------------------------------------------

def _prefilled(model, S=6):
    jc, tc, jp, tp = model
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (1, S))
    _, jst = jm.prefill(jp, jc, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        _, tst = tm.prefill(tp, tc, _t(toks).long())
    return jst, tst


def test_alloc_zeroes_state_rows(model):
    jc, tc, _, _ = model
    kv = tserve.PagedKVCache(tc, 3, 4, 12, torch.device("cpu"))
    for t in tkv.split_leaves(kv.pools, kv._paged)[1]:
        t.fill_(7.0)
    s = kv.alloc(5, budget=12)
    for t in tkv.split_leaves(kv.pools, kv._paged)[1]:
        assert not bool(t[:, s].any())
        others = [i for i in range(3) if i != s]
        assert bool((t[:, others] == 7.0).all())
    assert kv.state_row_bytes > 0
    assert kv.state_row_bytes == tsched.state_bytes(tc)


def test_write_prefill_states_matches_reference(model):
    jc, tc, _, _ = model
    jst, tst = _prefilled(model)
    jkvc = jkv.PagedKVCache(jc, num_slots=3, page_size=4, max_len=8)
    tkvc = tserve.PagedKVCache(tc, 3, 4, 8, torch.device("cpu"))
    js, ts = jkvc.alloc(8), tkvc.alloc(8)
    assert js == ts
    jkvc.write_prefill_states(js, jst, 6)
    tkvc.write_prefill_states(ts, tst, 6)
    flags = tree_leaves(tkvc._paged)
    for j, t, paged in zip(jax.tree.leaves(jkvc.dense_view(js)),
                           tree_leaves(tkvc.dense_view(ts)), flags):
        # pages: the prompt's 6 lines (the rest was never written)
        n = 6 if paged else None
        _close(t[:, :, :n], np.asarray(j)[:, :, :n], LOGITS_TOL)
    assert tkvc.page_bytes == jkvc.page_bytes
    assert any(not f for f in flags)


def test_swap_roundtrip_into_another_slot(model):
    """swap_out then swap_in into a different slot: pages and state rows
    byte-exact, through the one packed host buffer."""
    _, tc, _, _ = model
    _, tst = _prefilled(model)
    kv = tserve.PagedKVCache(tc, 3, 4, 12, torch.device("cpu"))
    s = kv.alloc(6, budget=12)
    kv.write_prefill_states(s, tst, 6)
    kv.ensure_writable(s, 6, 7)
    before = [t.clone() for t in tree_leaves(kv.dense_view(s))]
    n_pages = kv.slot_pages(s)
    snap = kv.swap_out(s)
    rows = sum(t.numel() * t.element_size() for t in
               tkv.split_leaves(snap.data, kv._paged)[1])
    assert rows == kv.state_row_bytes
    assert kv.pool.stats.swap_dmas == 1
    blocker = kv.alloc(4, slot=s)
    s2 = kv.swap_in(snap)
    assert s2 is not None and s2 != s
    for b, a in zip(before, tree_leaves(kv.dense_view(s2))):
        assert torch.equal(b, a)
    assert kv.slot_pages(s2) == n_pages
    kv.free(blocker)
    kv.free(s2)
    kv.pool.check(kv.table_refs())


def test_prefix_cache_refused_for_recurrent(model):
    _, tc, _, _ = model
    assert not tkv.supports_prefix_cache(tc)
    with pytest.raises(NotImplementedError):
        tserve.PagedKVCache(tc, 2, 4, 8, torch.device("cpu"),
                            prefix_cache=True)


# --------------------------------------------------------------------------
# Pricing (analytic, at the full configs)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [None, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_pricing_matches_reference(arch, layers):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    if layers:
        jc = dataclasses.replace(jc, n_layers=layers)
        tc = dataclasses.replace(tc, n_layers=layers)
    assert tsched.state_bytes(tc) == jsched.state_bytes(jc) > 0
    for L, B in ((1, 1), (100, 4), (513, 3)):
        assert tsched.decode_token_bytes(tc, L, B) == \
            jsched.decode_token_bytes(jc, L, B)
    for n in (1, 7):
        assert tsched.slot_swap_bytes(tc, n, 16) == \
            jsched.slot_swap_bytes(jc, n, 16)
    # on-chip bytes: the pass-through (weights + 2 x state) is the
    # reference's; the attention term prices the CUDA kernel, not the
    # Pallas one, so it is taken out on both sides (xlstm has none)
    for L, B in ((1, 1), (100, 4), (513, 3)):
        for n_q, t, j in (
                (1, tsched.decode_token_vmem_bytes(tc, L, B, 16),
                 jsched.decode_token_vmem_bytes(jc, L, B, 16)),
                (5, tsched.verify_step_vmem_bytes(tc, L, 5, B, 16),
                 jsched.verify_step_vmem_bytes(jc, L, 5, B, 16))):
            t_attn = tsched.attn_kernel_vmem_bytes(tc, L, 16, n_q=n_q)
            j_attn = jsched.attn_kernel_vmem_bytes(jc, L, 16, n_q=n_q)
            assert t - t_attn == j - j_attn
            if arch == "xlstm-350m":
                assert t_attn == j_attn == 0 and t == j


def test_xlstm_state_share():
    """xlstm-350m's state is 88.56 MB a slot, 43% of a 4-slot step."""
    tc = tcfg.get_config("xlstm-350m")
    sb = tsched.state_bytes(tc)
    assert sb == 21 * 4_214_800 + 3 * 16_384
    q = sum(tsched.decode_token_bytes(tc, 100, 4) for _ in range(4))
    assert 0.42 < 4 * 2 * sb / q < 0.44
