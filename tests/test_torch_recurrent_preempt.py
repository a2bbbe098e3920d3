"""The port's engine on the recurrent and hybrid archs (xlstm-350m,
jamba-v0.1-52b smoke configs, float32) against the JAX package's under
pool pressure: greedy streams under swap and recompute preemption, and
with int8 pages beside the state rows (chunked prefill, preemption).
Split from ``test_torch_recurrent_engine.py`` (its helpers) so that the
suite's workers share the two modules' engine runs."""

import pytest

from test_torch_recurrent import model  # noqa: F401  (the fixture)
from test_torch_recurrent_engine import _both, _prompt


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_preemption_streams_identical(model, mode):
    prompts = [_prompt(80 + i, 6) for i in range(2)]
    jreqs, treqs, jeng, teng = _both(
        model, prompts, dict(max_new_tokens=8), num_slots=2, page_size=4,
        max_len=16, num_pages=6, preempt_mode=mode)
    assert teng._sched.preempt_count == jeng._sched.preempt_count > 0
    if mode == "swap":
        assert any(r.ledger.swap_bytes > 0 for r in treqs)
        assert [r.ledger.swap_bytes for r in treqs] == \
            [r.ledger.swap_bytes for r in jreqs]
    teng._kv.pool.check(teng._kv.table_refs())


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_quantized_hybrid_streams_identical(model, mode):
    """int8 KV pages beside float32 state rows (jamba's attention layer
    quantized; xlstm has no pages), chunked prefill and preemption."""
    prompts = [_prompt(90 + i, 7) for i in range(3)]
    _, treqs, _, teng = _both(
        model, prompts, dict(max_new_tokens=6), num_slots=2, page_size=4,
        max_len=16, num_pages=6, preempt_mode=mode, prefill_chunk=3,
        kv_dtype="int8")
    assert teng._sched.preempt_count > 0
    teng._kv.pool.check(teng._kv.table_refs())
