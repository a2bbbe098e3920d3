"""Tensor-parallel serving on the card (serve/shard.py): ``chip_smoke.py``'s
``[tp]`` holds at a smaller depth.  Two ranks share the one card over
gloo with CUDA tensors, eager: qwen3-14b's widths cut to LAYERS layers,
4 slots, 4 requests; tokens equal on both ranks and to the unsharded
engine's greedy stream wherever its top-2 margin is at least the logits
tolerance, the first decode logits within it (0.03, derived in PERF.md
§6 under tensor-parallel serving), row 1 launched LAYERS times a decode step on each rank, the
ledger's ``decode_step_ici_bytes`` a step, ``crosscheck_collectives``
within 1.15 with 2 x LAYERS all-reduces and one all-gather; the same
with ``overlap="ring"`` (gloo's send / recv staged through pinned host
memory), its logits within the same tolerance; and NCCL with a world of
one: a CUDA graph captured over the two edges (the capture dispatches one
all-reduce and one all-gather) replays equal to eager.

Needs an NVIDIA card with nvcc (marked ``cuda``; skips elsewhere).  On
the card, from the repo root:

    python -m pytest -m cuda tests/test_torch_shard_cuda.py

Imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import init_params
from repro_torch.parallel import collectives as coll
from repro_torch.core.roofline.op_collectives import CollectiveWalk
from repro_torch.parallel.mesh import (Mesh, axis_group, make_host_mesh,
                                       spawn, use_mesh)
from repro_torch.serve import (Engine, EngineConfig, GenerateConfig,
                               ShardedEngine, param_pspecs)
from repro_torch.serve.crosscheck import ICI_RATIO_TOL, crosscheck_collectives
from repro_torch.serve.scheduler import decode_step_ici_bytes

pytestmark = pytest.mark.cuda

LAYERS, SLOTS, PAGE, MAX_LEN, NEW = 4, 4, 16, 128, 16
PROMPTS = (17, 33, 46, 60)
LOGITS_ATOL = 0.03


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels, two ranks on it)")
    return torch.device("cuda")


def _cfg():
    return dataclasses.replace(get_config("qwen3-14b"), n_layers=LAYERS)


def _prompts(vocab):
    rng = np.random.default_rng(40)
    return [rng.integers(0, vocab, n) for n in PROMPTS]


def _serve(eng, cfg):
    """Serve the prompts greedily; first decode logits (active rows),
    tokens, row 1's launches (zeroed just before the run) and margins of
    every committed token by (request, index)."""
    first, margins = {}, {}
    body = eng._decode_logits

    def keep():
        out = body()
        rows = [r.slot for r in eng._sched.decode_requests()]
        v = torch.topk(out.float(), 2, dim=-1).values
        for r in eng._sched.decode_requests():
            margins[(r.request_id, len(r.generated))] = float(
                v[r.slot, 0] - v[r.slot, 1])
        first.setdefault("logits", out[rows].float().cpu().numpy())
        return out
    eng._decode_logits = keep
    sample_first = eng._sample_first

    def first_token(last_logits, req):
        v = torch.topk(last_logits.float().reshape(-1), 2).values
        margins[(req.request_id, 0)] = float(v[0] - v[1])
        return sample_first(last_logits, req)
    eng._sample_first = first_token
    reqs = [eng.submit(p, GenerateConfig(max_new_tokens=NEW))
            for p in _prompts(cfg.vocab_size)]
    pa.paged_attention.launches = 0
    eng.run()
    return dict(tokens=[[int(t) for t in r.generated] for r in reqs],
                logits=first["logits"], margins=margins,
                launches=pa.paged_attention.launches,
                steps=eng.decode_steps,
                ici=sum(r.ledger.decode_ici_bytes for r in reqs))


def _rank(rank, world, overlap):
    cfg = _cfg()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(1, world)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, specs=param_pspecs(cfg, mesh), mesh=mesh)
    eng = ShardedEngine(
        cfg, params, EngineConfig(num_slots=SLOTS, page_size=PAGE,
                                  max_len=MAX_LEN, device=dev,
                                  overlap=overlap),
        mesh_shape=(1, world), mesh=mesh)
    out = _serve(eng, cfg)
    out.pop("margins")
    out["cc"] = crosscheck_collectives(eng)
    with use_mesh(mesh):
        out["p2p_staged"] = coll.staged_p2p(axis_group("model"),
                                            torch.empty(0, device=dev))
    every = [None] * world
    dist.all_gather_object(every, out)
    return every


@pytest.fixture(scope="module")
def unsharded():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = _cfg()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    eng = Engine(cfg, params, EngineConfig(
        num_slots=SLOTS, page_size=PAGE, max_len=MAX_LEN, device="cuda",
        cuda_graphs=False))
    out = _serve(eng, cfg)
    del eng, params
    torch.cuda.empty_cache()
    return out


@pytest.mark.parametrize("overlap", ["none", "ring"])
def test_tp2_two_ranks_on_one_card(card, unsharded, overlap):
    cfg = _cfg()
    ranks = spawn(_rank, 2, backend="gloo", device="cuda", args=(overlap,),
                  timeout=600)
    r0 = ranks[0]
    assert all(r["tokens"] == r0["tokens"] for r in ranks)
    assert r0["p2p_staged"]
    for i, (a, b) in enumerate(zip(r0["tokens"], unsharded["tokens"])):
        if a != b:
            j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
            assert unsharded["margins"][(i, j)] < LOGITS_ATOL, \
                (i, j, a, b)
    d = float(np.abs(r0["logits"] - unsharded["logits"]).max())
    assert d <= LOGITS_ATOL, d
    for r in ranks:
        assert r["launches"] == LAYERS * r["steps"] > 0
    step = decode_step_ici_bytes(cfg, SLOTS, 2)
    assert r0["ici"] == pytest.approx(step * r0["steps"], rel=1e-12)
    cc = r0["cc"]
    assert cc["ops_by_kind"] == ({"all-reduce": 2 * LAYERS, "all-gather": 1}
                                 if overlap == "none" else
                                 {"all-gather": 2 * LAYERS + 1,
                                  "collective-permute": 2 * LAYERS})
    assert 1 / ICI_RATIO_TOL <= cc["ici_ratio"] <= ICI_RATIO_TOL, cc


def _nccl_one(rank, world):
    mesh = Mesh(("data", "model"), (1, 1), 0, {"model": dist.group.WORLD},
                dist.get_backend())
    g = torch.Generator(device="cuda").manual_seed(1)
    h = torch.randn((4, 1, 256), generator=g, device="cuda").to(
        torch.bfloat16)
    w = torch.randn((256, 512), generator=g, device="cuda").to(
        torch.bfloat16)

    def body():
        return coll.all_gather_cols(coll.row_parallel_psum(h @ w, "model"),
                                    "model")

    with use_mesh(mesh), torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph), CollectiveWalk() as walk:
            out = body()
        h.copy_(torch.randn(h.shape, generator=g, device="cuda").to(
            torch.bfloat16))
        graph.replay()
        want = body()
        torch.cuda.synchronize()
        return (bool(torch.equal(out, want)), dist.get_backend(),
                sorted(op.kind for op in walk.ops))


def test_nccl_world_of_one_captures_the_edges(card):
    equal, backend, captured = spawn(_nccl_one, 1, backend="nccl",
                                     device="cuda", timeout=300)
    assert backend == "nccl" and equal
    assert captured == ["all-gather", "all-reduce"]
