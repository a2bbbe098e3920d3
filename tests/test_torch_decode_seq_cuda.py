"""Decode over a dense cache whose lines are cut over ``model``, on the
card: row 1's log-sum-exp against its plain version, and a two-rank
decode step (gloo ranks sharing the one card) against the undistributed
step on the same weights and cache.  Imports no JAX.

* ``paged_attention(..., return_lse=True)`` (bf16 on the GQA core,
  float32 on the CUDA-core kernel): o the same bits as without the
  log-sum-exp; lse within ``lse_bar`` of the plain version's
  (``torch.logsumexp`` of its masked scores) run in float32 on the same
  values; a row that sees no line
  (pos -1, its table entries far past the pool) gives o = 0 and lse =
  -inf and reads nothing;
* qwen3-0.6b's widths with 15 query heads, 5 KV heads and a vocabulary
  of 151935, so that 2 divides none of them (heads whole on each rank,
  the lines cut; only the FFN splits), 2 layers, bf16 and float32, at
  (data 1, model 2): B 2 rows over a 256-line cache (128 lines a rank)
  whose first 120 lines are random; 16 steps of the same tokens from
  position 120 cross into rank 1's block.  Every step's logits within
  ``step_bar`` of one process's (the walk of the two edges' roundings and
  one ulp of the largest logit), each rank's paged-attention launches =
  layers x steps, and one step's walked ``model`` bytes equal
  ``train.step.decode_wire_bytes``.
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention as pa
from repro_torch.parallel.mesh import spawn

pytestmark = pytest.mark.cuda

LAYERS, B, S, P0, STEPS = 2, 2, 256, 120, 16
# lse against the plain version run in float32 on the same values
# (chip_smoke.py's LSE_SUM derivation): bf16 products are exact in
# float32, so the scores differ only by the order of their hd float32
# additions (2^-23 an addition, the tensor cores' accumulation may
# truncate), at most hd 2^-23 of sum_i |q_i k_i| scale; the log-sum-exp
# is 1-Lipschitz in the scores' max norm (a soft cap's tanh too); both
# sum up to 512 exponentials in float32 in other orders: 2^-15 more,
# relative to |lse| and 1
LSE_SUM, LSE_EXP = 2.0 ** -23, 2.0 ** -15
# Logits against one process, derived as chip_smoke.py's dsp_bar with
# two terms more.  Two edges a layer, the merge (the ranks' outputs
# rounded before the float32 sum, and the sum once more) and the FFN's
# reduce of two partials, each two roundings: sqrt(2) ulp / sqrt(12) of
# the value in rms, where a bf16 ulp is 2^-8 to 2^-7 of the value (take
# 2^-7: 0.41 x 2^-7); a random walk over them, of the step's largest
# logit, and TP_LOGITS_ATOL's 2.3x over that.  Both runs then round their
# logits to the model's dtype, so two that straddle a rounding boundary
# part by one ulp of the largest logit (bf16: 2^-6 at 2-4, where the
# walk's term is ~0.046 at 2 layers).  In float32 each edge sums its
# d_ff / 2 products and the partials in another order: ~sqrt(d_ff) 2^-24
# in rms
EDGE = {torch.bfloat16: 0.41 * 2.0 ** -7, torch.float32: 2.0 ** -24}
MANTISSA = {torch.bfloat16: 7, torch.float32: 23}
OVER = 2.3


def step_bar(ref_step, cfg, dtype) -> float:
    """The logits bar of one step (its unsharded logits ``ref_step``)."""
    top = float(ref_step.abs().max())
    edge = EDGE[dtype] * (math.sqrt(cfg.d_ff) if dtype == torch.float32
                          else 1.0)
    ulp = 2.0 ** (math.floor(math.log2(top)) - MANTISSA[dtype])
    return OVER * math.sqrt(2 * LAYERS) * edge * top + ulp


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def lse_bar(q, k, v, bt, pos, scale, lse):
    """Each row's bar (B, KV, G) for lse against the float32 plain
    version's ``lse``."""
    B_, KV, G, hd = q.shape
    page = k.shape[1]
    lines = bt.shape[1] * page
    kk = k[bt.long()].reshape(B_, lines, KV, hd).float()
    terms = torch.einsum("bkgh,bskh->bkgs", q.float().abs(), kk.abs()) * scale
    seen = torch.arange(lines, device=q.device)[None, :] <= pos.long()[:, None]
    top = torch.where(seen[:, None, None, :], terms, 0).amax(-1)
    return hd * LSE_SUM * top + LSE_EXP * (1 + lse.abs())


def _case(dtype, kind: str, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    Bq, KV, G, hd, page, nb = 4, 8, 2, 128, 16, 32
    P = 1 + Bq * nb
    q = torch.randn((Bq, KV, G, hd), generator=g, device="cuda")
    k = torch.randn((P, page, KV, hd), generator=g, device="cuda")
    v = torch.randn((P, page, KV, hd), generator=g, device="cuda")
    bt = torch.randperm(P - 1, generator=g, device="cuda")[:Bq * nb].view(
        Bq, nb).int() + 1
    pos = torch.tensor([5, 200, 511, 16], dtype=torch.int32, device="cuda")
    soft_cap = 0.0
    if kind == "soft_cap":
        q, soft_cap = q * 4.0, 30.0
    if kind == "empty":
        # rows 1 and 3 see no line; their tables point far past the pool
        pos = torch.tensor([5, -1, 511, -1], dtype=torch.int32,
                           device="cuda")
        bt[1] = bt[3] = 1 << 30
    return (q.to(dtype), k.to(dtype), v.to(dtype), bt, pos), dict(
        scale=hd ** -0.5, soft_cap=soft_cap)


@pytest.mark.parametrize("kind", ["ragged", "soft_cap", "empty"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_lse_kernel_against_plain(dtype, kind):
    args, kw = _case(dtype, kind)
    o, lse = pa.paged_attention(*args, **kw, return_lse=True)
    o_off = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    seen = args[4] >= 0
    assert torch.equal(o[seen], o_off[seen])
    assert lse.dtype == torch.float32 and lse.shape == o.shape[:3]
    safe = tuple(a if i != 3 else torch.where(
        seen[:, None], a, torch.ones_like(a)) for i, a in enumerate(args))
    _, lse_p = pa.paged_attention_reference(
        *(a.float() for a in safe[:3]), *safe[3:], **kw, return_lse=True)
    err = (lse[seen] - lse_p[seen]).abs()
    bar = lse_bar(*safe, kw["scale"], lse_p)[seen]
    assert bool((err <= bar).all()), float((err / bar).max())
    if kind == "empty":
        assert torch.equal(o[~seen], torch.zeros_like(o[~seen]))
        assert bool(torch.isneginf(lse[~seen]).all())
        assert torch.equal(o_off[~seen], torch.zeros_like(o_off[~seen]))
    assert not bool(torch.isnan(o).any())


def odd_qwen(dtype):
    """qwen3-0.6b's widths whose heads, KV heads and vocabulary 2 does not
    divide."""
    return dataclasses.replace(
        get_config("qwen3-0.6b"), n_layers=LAYERS, n_heads=15, n_kv_heads=5,
        vocab_size=151935, dtype=str(dtype).split(".")[-1],
        name="qwen3-0.6b-odd")


def _global(cfg):
    """Weights and a cache for ``cfg`` on the card, from seeds: lines
    below P0 random, the rest zeros; the tokens of every step."""
    from repro_torch.launch.specs import exact_cache_defs
    from repro_torch.models import init_params
    from repro_torch.models.params import tree_map
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)

    def line(d):
        t = torch.zeros(d.shape, dtype=d.torch_dtype, device="cuda")
        t[:, :, :P0] = 0.5 * torch.randn(t[:, :, :P0].shape, generator=g,
                                         device="cuda").to(t.dtype)
        return t
    caches = tree_map(line, exact_cache_defs(cfg, B, S))
    toks = torch.randint(0, cfg.vocab_size, (STEPS, B), generator=g,
                         device="cuda", dtype=torch.int32)
    return params, caches, toks


def two_ranks(rank: int, world: int, dtype) -> dict:
    from repro_torch.core.roofline.op_collectives import (CollectiveWalk,
                                                          summarize)
    from repro_torch.launch.specs import prefill_cache_specs
    from repro_torch.models import (decode_step, drop_cast, param_shardings,
                                    prepare_params)
    from repro_torch.models.params import tree_map
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.mesh import make_host_mesh, use_mesh
    from repro_torch.train.step import decode_local_config, decode_wire_bytes
    cfg = odd_qwen(dtype)
    params, caches, toks = _global(cfg)
    mesh = make_host_mesh(data=1, model=2)
    local = decode_local_config(cfg, mesh)
    mine = prepare_params(tree_map(
        lambda t, sp: shd.shard_leaf(t, sp, mesh), drop_cast(params),
        param_shardings(cfg, mesh)), local)
    blocks = tree_map(lambda t, sp: shd.shard_leaf(t, sp, mesh), caches,
                      prefill_cache_specs(cfg, B, S, mesh))
    pos = torch.full((B,), P0, dtype=torch.int32, device="cuda")
    got, walked = [], None
    n0 = pa.paged_attention.launches
    with use_mesh(mesh, process_wide=True), torch.no_grad():
        for i in range(STEPS):
            if i == 1:
                with CollectiveWalk(mesh=mesh) as walk:
                    lg = decode_step(mine, local, blocks, toks[i][:, None],
                                     pos + i)
                walked = {k[0]: v for k, v in
                          summarize(walk.ops).by_axes.items()}
            else:
                lg = decode_step(mine, local, blocks, toks[i][:, None],
                                 pos + i)
            got.append(lg.float().cpu())
    launches = pa.paged_attention.launches - n0
    out = {"launches": launches, "walked": walked,
           "wire": decode_wire_bytes(cfg, mesh.sizes, B, S),
           "layout": local.layout}
    if rank == 0:
        with torch.no_grad():
            want = [decode_step(params, cfg, caches, toks[i][:, None],
                                pos + i).float().cpu()
                    for i in range(STEPS)]
        out["share"] = max(float((a - b).abs().max())
                           / step_bar(b, cfg, dtype)
                           for a, b in zip(got, want))
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_two_rank_decode_against_one_process(dtype):
    res = spawn(two_ranks, 2, backend="gloo", device="cuda", args=(dtype,),
                timeout=600)
    assert res["layout"].kv_seq and res["layout"].context_parallel
    assert res["share"] <= 1.0, res["share"]
    assert res["launches"] == LAYERS * STEPS
    assert res["walked"]["model"] == pytest.approx(res["wire"]["model"],
                                                   rel=1e-9)
