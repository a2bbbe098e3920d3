"""The port's engine on the recurrent and hybrid archs (xlstm-350m,
jamba-v0.1-52b smoke configs, float32) against the JAX package's: greedy
streams under staggered admission and chunked prefill; speculation
refused; and the cross-checks with the state rows (the bytes hold's
terms, the host ratio).  Swap and recompute preemption, and int8 pages
beside the state rows, are in ``test_torch_recurrent_preempt.py``.  The
mixers and the cache are in ``test_torch_recurrent.py``, whose ``model``
fixture both modules use."""

import numpy as np
import pytest

import repro.serve as jserve
import repro_torch.serve as tserve
from repro_torch.serve import crosscheck as txc
from test_torch_recurrent import model  # noqa: F401  (the fixture)


def _prompt(seed, length, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, length).astype(
        np.int32)


def _both(model, prompts, gen_kw, **ecfg):
    jc, tc, jp, tp = model
    jeng = jserve.Engine(jc, jp, jserve.EngineConfig(**ecfg))
    teng = tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu", **ecfg))
    jreqs = [jeng.submit(p, jserve.GenerateConfig(**gen_kw)) for p in prompts]
    treqs = [teng.submit(p, tserve.GenerateConfig(**gen_kw)) for p in prompts]
    jeng.run()
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.generated == [int(x) for x in j.generated], t.request_id
        assert t.finish_reason == j.finish_reason
    return jreqs, treqs, jeng, teng


@pytest.mark.parametrize("prefill_chunk", [0, 3])
def test_staggered_admission_streams_identical(model, prefill_chunk):
    prompts = [_prompt(10 + i, s) for i, s in enumerate([5, 8, 6, 8, 5])]
    jreqs, treqs, _, teng = _both(model, prompts, dict(max_new_tokens=6),
                                  num_slots=2, page_size=4, max_len=32,
                                  prefill_chunk=prefill_chunk)
    assert any(r.ledger.mean_batch > 1.0 for r in treqs)
    assert teng.decode_steps > 0
    assert not teng.prefill_shapes or all(
        kind == "chunk" for kind, _ in teng.prefill_shapes)
    for j, t in zip(jreqs, treqs):
        assert t.ledger.decode_bytes == pytest.approx(j.ledger.decode_bytes,
                                                      rel=1e-12)


def test_spec_refuses_recurrent(model):
    _, tc, _, tp = model
    assert not tserve.supports_spec(tc)
    with pytest.raises(NotImplementedError, match="speculative"):
        tserve.SpecEngine(tc, tp, tserve.EngineConfig(device="cpu"),
                          tserve.SpecConfig(proposer="ngram"))


# --------------------------------------------------------------------------
# Cross-checks
# --------------------------------------------------------------------------

def _mid_decode(model, slots=4, active=4):
    _, tc, _, tp = model
    eng = tserve.Engine(tc, tp, tserve.EngineConfig(
        device="cpu", num_slots=slots, page_size=4, max_len=32))
    for i in range(active):
        eng.submit(_prompt(60 + i, 5 + 2 * i),
                   tserve.GenerateConfig(max_new_tokens=8))
    eng.step()
    eng.step()
    return eng


@pytest.mark.parametrize("active", [4, 2])
def test_bytes_hold_with_state_rows(model, active):
    """The walk's weights + KV + state bytes equal the ledger's Q plus
    terms counted from the trees (the state rows' freeze read, the
    mixers' re-reads and the idle slots' rows among them): 0 B residual."""
    eng = _mid_decode(model, active=active)
    out = txc.crosscheck_decode(eng)
    assert txc.bytes_held(out), out["bytes_residual"]
    assert out["state_bytes"] > 0
    row = eng._kv.state_row_bytes
    assert out["state_freeze_read_bytes"] == 4 * row
    assert out["state_idle_bytes"] == (4 - active) * 2 * row
    # the mLSTM / sLSTM cells read C, n, m and h more than once; mamba
    # reads h and its conv tail once each
    assert (out["state_reread_bytes"] > 0) == ("xlstm" in eng.cfg.name)


def test_host_crosscheck_counts_state_rows(model):
    eng = _mid_decode(model, active=2)
    out = txc.crosscheck_host(eng)
    assert out["host_ratio"] == 1.0
    assert out["analytic_swap_bytes"] >= eng._kv.state_row_bytes
