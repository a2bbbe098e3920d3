"""The collective edges on ``torch.distributed`` (parallel/collectives.py)
over gloo ranks on the CPU, tp 2 and 3, one spawn per width holding every
check: ``ring_matmul_reduce`` against ``row_parallel_psum`` at the
reference's rtol 2e-5 / atol 2e-4 (N dividing the ranks, padded, and
smaller than the ranks), ``ring_allgather_matmul`` and
``psum_scatter_matmul`` against ``x @ w`` (same tolerance, S and N that
do not divide), ``all_gather_cols`` exact; the collective cross-check
(``crosscheck_collectives``: the ledger's bytes against the walk of the
``c10d`` operators a decode step dispatches, within the reference's 1.15,
all-reduces only for qwen3-0.6b smoke, the all-gather present for
MLA-dense) and ``harvest_serve``'s ``ici`` sample (0 at tp 1, the
ledger's bytes at tp 2); the serve CLI's ``--mesh 1,2`` on the CPU.

Worker functions live at module level and the module imports neither JAX
nor the JAX package, so the spawned ranks start light."""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
from repro_torch.launch import serve as serve_cli
from repro_torch.models import BlockDef, init_params
from repro_torch.obs import Registry
from repro_torch.obs.metrics import harvest_serve
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.mesh import (axis_group, make_host_mesh, spawn,
                                       use_mesh)
from repro_torch.serve import (Engine, EngineConfig, GenerateConfig,
                               ShardedEngine)
from repro_torch.serve.crosscheck import ICI_RATIO_TOL, crosscheck_collectives

RING_TOL = dict(rtol=2e-5, atol=2e-4)


def mla_dense_smoke():
    """The reference tests' MLA arch with a dense FFN (an untied,
    vocab-sharded head: the all-gather edge runs)."""
    return dataclasses.replace(
        tcfg.smoke(tcfg.get_config("deepseek-v2-236b")),
        name="mla-dense-smoke", block_pattern=(BlockDef("mla", "dense"),),
        n_layers=2, d_ff=128, n_experts=0, moe_top_k=0, moe_d_ff=0,
        n_shared_experts=0, moe_first_dense=0)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _gather_cols(block, N, world):
    """The column blocks of the ranks, cut to the real N, side by side
    (each padded to the common block width first)."""
    width = -(-N // world)
    return coll.all_gather_cols(torch.nn.functional.pad(
        block, (0, width - block.shape[1])), "model")[:, :N]


def _ici_sample(text: str) -> float:
    line = [ln for ln in text.splitlines()
            if ln.startswith('serve_level_bytes_total{level="ici"}')]
    assert len(line) == 1, text
    return float(line[0].split()[-1])


def _collective_checks(rank: int, world: int) -> dict:
    """Every rank draws the same operands from one seed; this rank's
    shards are cut from them."""
    mesh = make_host_mesh(1, world)
    out = {}
    gen = torch.Generator().manual_seed(7)
    with use_mesh(mesh):
        for N in (128, 130, 2):              # dividing, padded, N < ranks
            B, K = 3, 12 * world
            h = _randn(gen, B, 2, K)
            w = _randn(gen, K, N) / K ** 0.5
            kl = K // world
            hl, wl = h[..., rank * kl:(rank + 1) * kl], \
                w[rank * kl:(rank + 1) * kl]
            want = coll.row_parallel_psum(hl @ wl, "model")
            got = coll.row_parallel_matmul(hl, wl, "model", "ring")
            torch.testing.assert_close(got, want, **RING_TOL)
            torch.testing.assert_close(want, h @ w, **RING_TOL)
            out[f"ring N={N}"] = float((got - want).abs().max())
        for S, K, N in ((8, 16, 12), (7, 10, 13), (2, 5, 1)):
            x = _randn(gen, S, K)
            w = _randn(gen, K, N) / K ** 0.5
            full = x @ w
            for fn in (coll.ring_allgather_matmul, coll.psum_scatter_matmul):
                torch.testing.assert_close(
                    _gather_cols(fn(x, w, "model"), N, world), full,
                    **RING_TOL)
        x = torch.arange(6, dtype=torch.float32).view(2, 3) + 10 * rank
        g = coll.all_gather_cols(x, "model")
        assert torch.equal(g, torch.cat([torch.arange(6.).view(2, 3)
                                         + 10 * r for r in range(world)],
                                        -1))
        assert not coll.staged_p2p(axis_group("model"), x)
    h2, w2 = _randn(gen, 3, 2, 8), _randn(gen, 8, 4)
    assert torch.equal(coll.row_parallel_matmul(h2, w2, None, "ring"),
                       h2 @ w2)
    with pytest.raises(ValueError):
        coll.row_parallel_matmul(h2, w2, None, "eager")
    return out


def test_collectives_on_three_gloo_ranks():
    out = spawn(_collective_checks, 3, device="cpu", threads=1)
    assert len(out) == 3


def _serve(cfg, engine_cls, **kw):
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    ecfg = EngineConfig(num_slots=2, page_size=4, max_len=20, device="cpu")
    eng = engine_cls(cfg, params, ecfg, **kw)
    rng = np.random.RandomState(5)
    reqs = [eng.submit(rng.randint(0, cfg.vocab_size, 7),
                       GenerateConfig(max_new_tokens=5)) for _ in range(3)]
    eng.run()
    return eng, reqs


def _crosscheck_worker(rank: int, world: int) -> dict:
    out = {"collectives": _collective_checks(rank, world)}
    for key, cfg in (("qwen", tcfg.smoke(tcfg.get_config("qwen3-0.6b"))),
                     ("mla", mla_dense_smoke())):
        eng, reqs = _serve(cfg, ShardedEngine, mesh_shape=(1, world))
        cc = crosscheck_collectives(eng)
        reg = Registry()
        harvest_serve(reg, eng)
        out[key] = dict(
            cc=cc, ici=eng.aggregate_ledger().decode_ici_bytes,
            ici_sample=_ici_sample(reg.expose()),
            tokens=[list(r.generated) for r in reqs])
    return out


def test_collectives_crosscheck_and_ici_metric_on_two_ranks():
    out = spawn(_crosscheck_worker, 2, device="cpu", threads=1)
    assert len(out["collectives"]) == 3
    for name, kinds in (("qwen", {"all-reduce"}),
                        ("mla", {"all-reduce", "all-gather"})):
        cc = out[name]["cc"]
        assert set(cc["by_kind"]) == kinds, cc
        assert cc["ops_by_kind"]["all-reduce"] == \
            cc["collective_count_analytic"] == 4
        assert cc["ops_by_kind"].get("all-gather", 0) == \
            (1 if "all-gather" in kinds else 0)
        assert cc["walk_ici_bytes"] > 0
        assert 1 / ICI_RATIO_TOL <= cc["ici_ratio"] <= ICI_RATIO_TOL, cc
        assert out[name]["ici_sample"] == out[name]["ici"] > 0
    # one card: the sample is there and is 0
    eng, _ = _serve(tcfg.smoke(tcfg.get_config("qwen3-0.6b")), Engine)
    reg = Registry()
    harvest_serve(reg, eng)
    assert _ici_sample(reg.expose()) == 0.0


def test_serve_cli_mesh_prints_communication_roofline(capfd):
    """Rank 0 of the spawned ranks prints to the inherited stdout, so the
    file descriptor is captured."""
    serve_cli.main(["--smoke", "--device", "cpu", "--mesh", "1,2",
                    "--batch", "3", "--prompt-len", "12", "--new-tokens",
                    "4", "--slots", "2", "--overlap", "ring"])
    out = capfd.readouterr().out
    assert "[serve/mesh] communication roofline (tp=2, gloo" in out
    assert "tp2" in out and "overlap ring" in out
    with pytest.raises(SystemExit, match="item 18"):
        serve_cli.main(["--smoke", "--device", "cpu", "--mesh", "2,2"])
    with pytest.raises(SystemExit, match="MoE"):
        serve_cli.main(["--smoke", "--device", "cpu", "--mesh", "1,2",
                        "--arch", "deepseek-v2-236b"])
