"""The port's tensor-parallel engines (serve/shard.py) on two gloo ranks
on the CPU against the JAX package's engines, on the same weights and
prompts, float32 smoke configs:

* ``ShardedEngine`` at tp 2 on qwen3-0.6b smoke (GQA, tied embeddings)
  and the reference tests' ``mla-dense-smoke`` (MLA with a dense FFN and
  an untied, vocab-sharded head): greedy tokens equal to the reference
  ``Engine``'s and to the port's tp 1, on every rank; per-request
  ``decode_ici_bytes`` equal to the reference ``ShardedEngine``'s at
  mesh (1, 2), run as ``tests/test_shard_serve.py`` runs it (a
  subprocess with 8 forced host devices);
* ``overlap="ring"`` with ``pipeline="double"`` and chunked prefill:
  byte-equal to the port's tp 1 with the same settings;
* ``ShardedSpecEngine`` with the n-gram proposer (k 3): tokens equal to
  the reference ``SpecEngine``'s, each round charged
  ``decode_step_ici_bytes(cfg, 2, 2, n_tokens=4) / 2``;
* the 1x1 mesh: ``ShardedEngine`` is ``Engine`` byte for byte (tokens,
  ledgers, pools), and a dp > 1 mesh without a replica's device row
  points at ``serve.cluster.Cluster``.

The two ranks run every case in one spawn.  JAX is imported inside the
tests only, so the spawned ranks, which import this module for its
worker, start without it."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.configs as tcfg
from repro_torch import bridge
from repro_torch.models import BlockDef, init_params, prepare_params
from repro_torch.parallel.mesh import spawn
from repro_torch.serve import (Engine, EngineConfig, GenerateConfig,
                               ShardedEngine, ShardedSpecEngine, SpecConfig,
                               SpecEngine)
from repro_torch.serve.scheduler import decode_step_ici_bytes

ROOT = pathlib.Path(__file__).resolve().parent.parent
ECFG = dict(num_slots=2, page_size=4, max_len=32)
NEW = 6
SPEC_NEW = 8


def mla_dense(mod, block=BlockDef):
    """The reference tests' MLA arch with a dense FFN, from ``mod``'s
    configs and block class."""
    return dataclasses.replace(
        mod.smoke(mod.get_config("deepseek-v2-236b")),
        name="mla-dense-smoke", block_pattern=(block("mla", "dense"),),
        n_layers=2, d_ff=128, n_experts=0, moe_top_k=0, moe_d_ff=0,
        n_shared_experts=0, moe_first_dense=0)


def _prompts(seed, vocab, n=3, length=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, length).astype(np.int32) for _ in range(n)]


SPEC_PROMPTS = [np.tile(np.asarray([5, 9, 2], np.int32), 4)[:10]
                for _ in range(2)]


def _port_run(engine, prompts, new):
    reqs = [engine.submit(p, GenerateConfig(max_new_tokens=new))
            for p in prompts]
    engine.run()
    return reqs


# (case, config key, engine class, extra EngineConfig, spec)
CASES = [("qwen", "qwen", ShardedEngine, {}, False),
         ("qwen ring double chunked", "qwen", ShardedEngine,
          dict(overlap="ring", pipeline="double", prefill_chunk=3), False),
         ("mla", "mla", ShardedEngine, {}, False),
         ("qwen ngram", "qwen", ShardedSpecEngine, {}, True)]


def _configs():
    return {"qwen": tcfg.smoke(tcfg.get_config("qwen3-0.6b")),
            "mla": mla_dense(tcfg)}


def _rank_cases(rank: int, world: int, weights: dict) -> dict:
    """Every case on this rank; returns the tokens of every rank (equal
    across ranks asserted here) and rank 0's ledgers."""
    cfgs = _configs()
    out = {}
    for case, key, cls, extra, spec in CASES:
        cfg = cfgs[key]
        params = bridge.to_torch(weights[key], device="cpu")
        ecfg = EngineConfig(device="cpu", **ECFG, **extra)
        if spec:
            eng = cls(cfg, params, ecfg, SpecConfig(k=3, proposer="ngram"),
                      mesh_shape=(1, world))
            reqs = _port_run(eng, SPEC_PROMPTS, SPEC_NEW)
        else:
            eng = cls(cfg, params, ecfg, mesh_shape=(1, world))
            reqs = _port_run(eng, _prompts(1, cfg.vocab_size), NEW)
        toks = [list(r.generated) for r in reqs]
        every = [None] * world
        dist.all_gather_object(every, toks)
        assert all(t == toks for t in every), (case, every)
        out[case] = dict(
            tokens=toks, ici=[r.ledger.decode_ici_bytes for r in reqs],
            passes=[r.ledger.weight_passes for r in reqs],
            terms=[(t.n_chips, t.ici_s > 0) for t in
                   (eng.roofline_terms(r) for r in reqs)])
    return out


_REF_SHARDED = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, numpy as np, jax
    from repro.configs import get_config, smoke
    from repro.models import init_params
    from repro.serve import EngineConfig, GenerateConfig, ShardedEngine
    cfg = smoke(get_config("qwen3-0.6b"))
    params = init_params(cfg, jax.random.key(0))
    eng = ShardedEngine(cfg, params, EngineConfig(**{ecfg}),
                        mesh_shape=(1, 2))
    rng = np.random.RandomState(1)
    reqs = [eng.submit(rng.randint(0, cfg.vocab_size, 7).astype(np.int32),
                       GenerateConfig(max_new_tokens={new}))
            for _ in range(3)]
    eng.run()
    print("RESULT", json.dumps([r.ledger.decode_ici_bytes for r in reqs]))
""")


def test_tp2_engines_equal_reference_and_tp1():
    import jax
    import repro.configs as jcfg
    import repro.models as jm
    import repro.serve as jserve
    from repro.models.common import BlockDef as JBlockDef

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref_sharded = subprocess.Popen(
        [sys.executable, "-c", _REF_SHARDED.format(ecfg=ECFG, new=NEW)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        jcfgs = {"qwen": jcfg.smoke(jcfg.get_config("qwen3-0.6b")),
                 "mla": mla_dense(jcfg, JBlockDef)}
        keys = {"qwen": 0, "mla": 7}
        jparams = {k: jm.init_params(c, jax.random.key(keys[k]))
                   for k, c in jcfgs.items()}
        weights = {k: jax.tree.map(np.asarray, p) for k, p in jparams.items()}
        tp2 = spawn(_rank_cases, 2, device="cpu", args=(weights,),
                    threads=1)

        tcfgs = _configs()
        refs = {}                 # the reference's streams by (config, spec)
        for case, key, cls, extra, spec in CASES:
            jc, tc = jcfgs[key], tcfgs[key]
            tparams = prepare_params(
                bridge.to_torch(weights[key], device="cpu"), tc)
            ecfg = EngineConfig(device="cpu", **ECFG, **extra)
            if spec:
                prompts, new = SPEC_PROMPTS, SPEC_NEW
                teng = SpecEngine(tc, tparams, ecfg,
                                  SpecConfig(k=3, proposer="ngram"))
            else:
                prompts, new = _prompts(1, tc.vocab_size), NEW
                teng = Engine(tc, tparams, ecfg)
            if (key, spec) not in refs:
                jeng = (jserve.SpecEngine(
                    jc, jparams[key], jserve.EngineConfig(**ECFG),
                    jserve.SpecConfig(k=3, proposer="ngram")) if spec else
                    jserve.Engine(jc, jparams[key],
                                  jserve.EngineConfig(**ECFG)))
                jreqs = [jeng.submit(p, jserve.GenerateConfig(
                    max_new_tokens=new)) for p in prompts]
                jeng.run()
                refs[key, spec] = [[int(t) for t in r.generated]
                                   for r in jreqs]
            want = refs[key, spec]
            got = tp2[case]
            assert got["tokens"] == want, (case, got["tokens"], want)
            tp1 = [list(r.generated) for r in _port_run(teng, prompts, new)]
            assert got["tokens"] == tp1, case
            assert all(t == (2, True) for t in got["terms"]), case
            if spec:
                per_round = decode_step_ici_bytes(tc, 2, 2, n_tokens=4) / 2
                assert got["ici"] == [per_round * n for n in got["passes"]]
        out, err = ref_sharded.communicate(timeout=300)
    finally:
        if ref_sharded.poll() is None:
            ref_sharded.kill()
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
    assert line, err[-3000:]
    assert tp2["qwen"]["ici"] == json.loads(line[0].split(" ", 1)[1]) \
        and min(tp2["qwen"]["ici"]) > 0


def test_1x1_mesh_is_the_engine_byte_for_byte():
    cfg = tcfg.smoke(tcfg.get_config("qwen3-0.6b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ecfg = EngineConfig(device="cpu", **ECFG)
    base = Engine(cfg, params, ecfg)
    sh = ShardedEngine(cfg, params, ecfg, mesh_shape=(1, 1))
    assert sh.mesh is None and sh.step_cfg is sh.cfg
    prompts = _prompts(2, cfg.vocab_size, n=3)
    rb, rs = _port_run(base, prompts, NEW), _port_run(sh, prompts, NEW)
    assert [r.generated for r in rb] == [r.generated for r in rs]
    for a, b in zip(rb, rs):
        assert dataclasses.asdict(a.ledger) == dataclasses.asdict(b.ledger)
        assert b.ledger.decode_ici_bytes == 0.0
        t = sh.roofline_terms(b)
        assert t.n_chips == 1 and t.ici_s == 0.0
    for x, y in zip(base._kv.pools, sh._kv.pools):
        for k in x:
            for leaf in x[k]:
                assert torch.equal(x[k][leaf], y[k][leaf])
    with pytest.raises(NotImplementedError, match="Cluster"):
        ShardedEngine(cfg, params, ecfg, mesh_shape=(2, 1))
    with pytest.raises(ValueError):
        ShardedEngine(cfg, params, ecfg, mesh_shape=(0, 1))
