"""Tensor-parallel training on the card, small: the holds of
``chip_smoke.py``'s ``[train-tp]`` phase on four-layer models in bf16,
two gloo ranks sharing the one card (NCCL at model 2 needs two cards).
Imports no JAX; compares with the undistributed port on the same rows
and weights, under deterministic algorithms.

* qwen3-0.6b's widths at 4 layers (remat full), model 2 against one
  rank, step 1: loss within ``chip_smoke.py``'s ``tp_loss_bar`` at B x
  S tokens (Hoeffding's bound on the mean of the tokens' NLL moves, each
  within twice the largest logit's move the bf16 row-parallel sums
  allow), grad norm within rtol 2^-6, every gradient leaf gathered whole
  within 2^-4 of one rank's (Frobenius; ``TP_GRAD_RTOL``'s derivation),
  parameters within one bf16 ulp + 2 lr (AdamW's first update is at
  most lr whatever the gradient's error) and, beyond one ulp + lr
  2^-7, only where the two runs' gradients differ in sign or are below
  2^7 eps; replicated leaves bit-equal on both ranks; the checkpoint of
  step 1 restores at (1, 1) bit for bit; each rank's pre-flight walk
  gives ``tp_wire_bytes`` on ``model`` (rtol 1e-9);
* deepseek-v2 smoke (MLA, 4 experts, capacity factor 1.0) at model 2:
  in bf16, loss and aux within 2^-8 relative of one rank's, both ranks
  keep the same pairs, which differ from one rank's only in the experts
  of tokens routed otherwise, each of them with a top-k margin within
  twice its router probabilities' change; in float32 (TF32 off) the
  kept pairs equal one rank's.
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
from repro_torch.core.analysis import analyze_step
from repro_torch.launch import specs as tspecs
from repro_torch.models import drop_cast, loss_fn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ShapeCell
from repro_torch.models.params import tree_paths
from repro_torch.parallel.mesh import make_host_mesh, spawn, use_mesh
from repro_torch.train import (CheckpointManager, OptConfig,
                               SyntheticLMData, TrainConfig,
                               make_initial_state, make_train_step)
from repro_torch.train.loop import abstract_state, state_shards
from repro_torch.train.step import (tp_wire_bytes, train_local_config,
                                    value_and_grad)

pytestmark = pytest.mark.cuda

B, S = 2, 256
LR = 1e-3
OPT = OptConfig(lr=LR, warmup_steps=0, total_steps=10)
GNORM_RTOL, GRAD_RTOL, MOE_RTOL = 2.0 ** -6, 2.0 ** -4, 2.0 ** -8
# chip_smoke.py's tp_loss_bar(B x S): 2 x TP_LOGITS_ATOL a token, p 1e-6
LOSS_ATOL = 2 * 0.03 * math.sqrt(2 * math.log(2 / 1e-6) / (B * S))


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def dense_cfg():
    return dataclasses.replace(tcfg.get_config("qwen3-0.6b"), n_layers=4)


def moe_cfg():
    return dataclasses.replace(
        tcfg.smoke(tcfg.get_config("deepseek-v2-236b")), dtype="bfloat16",
        capacity_factor=1.0)


def _dev():
    return torch.device("cuda", torch.cuda.current_device())


def _gather(obj, world):
    import torch.distributed as dist
    every = [None] * world
    dist.all_gather_object(every, obj)
    return every


def _ulp(t):
    fi = torch.finfo(t.dtype)
    mag = t.detach().float().abs().clamp_min(fi.tiny)
    return torch.exp2(torch.floor(torch.log2(mag))) * fi.eps


def _bits(t: torch.Tensor) -> bytes:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t).numpy().tobytes()


def dense_ranks(rank: int, world: int, ckpt: str) -> dict:
    cfg, dev = dense_cfg(), _dev()
    mesh = make_host_mesh(model=world)
    tc = TrainConfig(opt=OPT)
    data = SyntheticLMData(cfg, B, S, device=dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    state = make_initial_state(cfg, 0, dev, mesh=mesh)()
    shards = state_shards(cfg, mesh)
    sh = dict(tree_paths(shards))
    with use_mesh(mesh, process_wide=True):
        _, _, g = value_and_grad(drop_cast(state["params"]),
                                 data.batch_at(0),
                                 train_local_config(cfg, mesh))
        g_tp = {k: v if sh["params/" + k] is None else
                sh["params/" + k].gather(v) for k, v in tree_paths(g)}
    state, m = make_train_step(cfg, tc, mesh)(state, data.batch_at(0))
    CheckpointManager(ckpt, mesh=mesh, shards=shards).save(state, 1)
    with use_mesh(mesh):
        whole = {k: (v if sh[k] is None else sh[k].gather(v)).cpu()
                 for k, v in tree_paths(state)}
    args, _, _ = tspecs.train_specs(cfg, ShapeCell("t", S, B, "train"), mesh)
    walk = analyze_step(make_train_step(cfg, tc, mesh), args=args, mesh=mesh)
    out = {"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
           "rep": _gather({k: _bits(whole[k]) for k in whole
                           if sh[k] is None}, world),
           "walked": walk.character.collectives.by_axes.get(("model",)),
           "want": tp_wire_bytes(cfg, mesh.sizes, B, S, tc)["model"]}
    if rank == 0:
        init = make_initial_state(cfg, 0, dev)()
        _, _, g_one = value_and_grad(drop_cast(init["params"]),
                                     data.batch_at(0), cfg)
        g_one = dict(tree_paths(g_one))
        one, m1 = make_train_step(cfg, tc)(init, data.batch_at(0))
        out["one"] = {"loss": float(m1["loss"]),
                      "gnorm": float(m1["grad_norm"])}
        scale = min(1.0, OPT.clip_norm / max(out["gnorm"],
                                             out["one"]["gnorm"]))
        worst, out["grad_rel"], out["unexplained"] = 0.0, {}, 0
        for k, b in tree_paths(one["params"]):
            ga, gb = g_tp[k].float(), g_one[k].float()
            out["grad_rel"][k] = float(torch.linalg.vector_norm(ga - gb)
                                       / torch.linalg.vector_norm(gb))
            a = whole["params/" + k].to(dev)
            d = (a.float() - b.float()).abs()
            ulp = _ulp(torch.maximum(a.float().abs(), b.float().abs()).to(
                b.dtype))
            worst = max(worst, float((d / (ulp + 2 * LR)).max()))
            same = (torch.sign(ga) == torch.sign(gb)) & (
                torch.minimum(ga.abs(), gb.abs()) * scale > 2 ** 7 * OPT.eps)
            out["unexplained"] += int(
                ((d > ulp + LR * 2.0 ** -7) & same).sum())
        out["worst"] = worst
        restored, _ = CheckpointManager(ckpt).restore(abstract_state(cfg), 1,
                                                      device=dev)
        out["restored"] = all(torch.equal(v.cpu(), whole[k])
                              for k, v in tree_paths(restored))
    torch.use_deterministic_algorithms(False)
    return out


def test_dense_model2_matches_one_rank(tmp_path):
    got = spawn(dense_ranks, 2, device="cuda", backend="gloo",
                args=(str(tmp_path / "ckpt"),), timeout=900)
    assert abs(got["loss"] - got["one"]["loss"]) <= LOSS_ATOL
    assert abs(got["gnorm"] - got["one"]["gnorm"]) <= GNORM_RTOL * got[
        "one"]["gnorm"]
    assert max(got["grad_rel"].values()) <= GRAD_RTOL, got["grad_rel"]
    assert got["worst"] <= 1.0
    assert got["unexplained"] == 0
    assert got["rep"][0] == got["rep"][1]
    assert got["restored"]
    assert got["walked"] == pytest.approx(got["want"], rel=1e-9)


def moe_ranks(rank: int, world: int) -> dict:
    mesh = make_host_mesh(model=world)
    dev = _dev()
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    inner = moe_mod.moe_ffn

    def run(cfg, on_mesh):
        batch = SyntheticLMData(cfg, 4, 64, device=dev).batch_at(0)
        state = make_initial_state(cfg, 0, dev,
                                   mesh=mesh if on_mesh else None)()
        c = train_local_config(cfg, mesh) if on_mesh else cfg
        ctx = use_mesh(mesh, process_wide=True) if on_mesh else \
            contextlib.nullcontext()
        probs = []

        def spy(p, x, c_):
            probs.append(torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                       @ p["router"], -1).cpu().numpy())
            return inner(p, x, c_)

        moe_mod.moe_ffn = spy
        try:
            with ctx, torch.no_grad(), moe_mod.record_dispatch() as log:
                loss, met = loss_fn(state["params"], batch, c)
        finally:
            moe_mod.moe_ffn = inner
        calls = [{k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                  for k, v in x.items()} for x in log]
        return {"loss": float(loss), "aux": float(met["aux"]),
                "calls": calls, "probs": probs}

    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(moe_cfg(), dtype=dtype)
        out[dtype] = {"tp": _gather(run(cfg, True), world)}
        if rank == 0:
            out[dtype]["one"] = run(cfg, False)
    torch.use_deterministic_algorithms(False)
    return out


def _pairs(c_tp, c_one):
    got = set(zip(c_tp["token"].tolist(), c_tp["expert"].tolist()))
    want = set(zip(c_one["token"].tolist(), c_one["expert"].tolist()))
    diff = (np.sort(c_tp["choice"], 1) != np.sort(c_one["choice"], 1)
            ).any(1)
    touched = set(c_tp["choice"][diff].flatten().tolist()) | set(
        c_one["choice"][diff].flatten().tolist())
    return got, want, diff, touched


def test_moe_model2_matches_one_rank():
    got = spawn(moe_ranks, 2, device="cuda", backend="gloo", timeout=900)
    a, b = got["bfloat16"]["tp"]
    one = got["bfloat16"]["one"]
    for k in ("loss", "aux"):
        assert abs(a[k] - one[k]) <= MOE_RTOL * abs(one[k]), k
    for ca, cb, co, pa, po in zip(a["calls"], b["calls"], one["calls"],
                                  a["probs"], one["probs"]):
        assert np.array_equal(ca["token"], cb["token"])
        got_p, want, diff, touched = _pairs(ca, co)
        assert {e for _, e in got_p ^ want} <= touched
        # a rerouted token's top-k margin is within twice its change
        k = ca["choice"].shape[1]
        top = -np.sort(-po, axis=1)
        margin = top[:, k - 1] - top[:, k]
        assert (margin[diff] <= 2 * np.abs(po - pa).max(1)[diff]).all()
    a32, one32 = got["float32"]["tp"][0], got["float32"]["one"]
    for ca, co in zip(a32["calls"], one32["calls"]):
        got_p, want, diff, _ = _pairs(ca, co)
        assert not diff.any() and got_p == want
