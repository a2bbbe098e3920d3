"""The port's continuous-batching engine against the JAX package's
``repro.serve.Engine`` on the same weights and prompts: greedy token
streams must be identical in the scenarios of test_serve_scheduler.py —
staggered admission, chunked prefill, early stop, prefix cache, and swap
and recompute preemption (alone and under a prefix cache)."""

import jax
import numpy as np
import pytest

import repro.configs as jcfg
import repro.models as jm
import repro.serve as jserve
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.serve as tserve
from repro_torch import bridge


@pytest.fixture(scope="module")
def qwen():
    jc = jcfg.smoke(jcfg.get_config("qwen3-0.6b"))
    tc = tcfg.smoke(tcfg.get_config("qwen3-0.6b"))
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.prepare_params(
        bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu"), tc)
    return jc, tc, jp, tp


def _prompt(seed, length, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, length).astype(
        np.int32)


def _both(qwen, prompts, gen_kw, **ecfg):
    """Run the same requests through both engines; returns both request
    lists and the port's engine."""
    jc, tc, jp, tp = qwen
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
def test_staggered_admission_streams_identical(qwen, prefill_chunk):
    prompts = [_prompt(10 + i, s) for i, s in enumerate([5, 8, 6, 8, 5])]
    _, treqs, _, teng = _both(qwen, prompts, dict(max_new_tokens=6),
                              num_slots=2, page_size=4, max_len=32,
                              prefill_chunk=prefill_chunk)
    assert any(r.ledger.mean_batch > 1.0 for r in treqs)
    assert teng.decode_steps > 0


def test_early_stop_streams_identical(qwen):
    prompts = [_prompt(20 + i, 6) for i in range(4)]
    jreqs, _, _, _ = _both(qwen, prompts, dict(max_new_tokens=8),
                           num_slots=2, page_size=4, max_len=32)
    stop = jreqs[0].generated[1]
    jreqs, treqs, _, _ = _both(qwen, prompts,
                               dict(max_new_tokens=8, stop_token=stop),
                               num_slots=2, page_size=4, max_len=32)
    assert any(r.finish_reason == "stop" for r in treqs)


def test_prefix_cache_streams_identical(qwen):
    shared = _prompt(100, 8)
    prompts = [np.concatenate([shared, _prompt(101 + i, 2)])
               for i in range(4)]
    _, treqs, _, teng = _both(qwen, prompts, dict(max_new_tokens=6),
                              num_slots=2, page_size=4, max_len=18,
                              prefix_cache=True)
    assert teng._kv.pool.stats.dedup_hits > 0
    assert any(r.ledger.prefix_cached_tokens >= 8 for r in treqs[1:])
    teng._kv.pool.check(teng._kv.table_refs())


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["plain", "prefix"])
@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_preemption_streams_identical(qwen, mode, prefix_cache):
    if prefix_cache:
        shared = _prompt(130, 8)
        prompts = [np.concatenate([shared, _prompt(131 + i, 2)])
                   for i in range(3)]
        gen, max_len = dict(max_new_tokens=6), 16
    else:
        prompts = [_prompt(80 + i, 6) for i in range(2)]
        gen, max_len = dict(max_new_tokens=8), 16
    jreqs, treqs, jeng, teng = _both(
        qwen, prompts, gen, num_slots=2, page_size=4, max_len=max_len,
        num_pages=6, preempt_mode=mode, prefix_cache=prefix_cache)
    assert teng._sched.preempt_count == jeng._sched.preempt_count > 0
    if mode == "swap":
        assert any(r.ledger.swap_bytes > 0 for r in treqs)
        assert [r.ledger.swap_bytes for r in treqs] == \
            [r.ledger.swap_bytes for r in jreqs]
    teng._kv.pool.check(teng._kv.table_refs())


def test_generate_matches_reference(qwen):
    jc, tc, jp, tp = qwen
    prompts = np.stack([_prompt(40 + i, 7) for i in range(3)])
    gen = dict(max_new_tokens=5)
    want = jserve.Engine(jc, jp).generate(prompts,
                                          jserve.GenerateConfig(**gen))
    got = tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu")).generate(
        prompts, tserve.GenerateConfig(**gen))
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["finished"],
                                  np.asarray(want["finished"]))


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--device", "cpu", "--batch", "3",
                "--prompt-len", "6", "--new-tokens", "4", "--slots", "2",
                "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens" in out and "on cpu" in out
    assert out.count("memory-bound") == 3
