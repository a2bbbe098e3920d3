"""Data-parallel training on the card, small: the holds of
``chip_smoke.py``'s ``[train-dp]`` phase at smoke widths in bf16, two
gloo ranks sharing the one card (NCCL at data 2 needs two cards) and an
NCCL world of one.  Imports no JAX; compares with the undistributed
port.

* data 2 against one rank at grad_accum 2 on the same rows, step 1
  under deterministic algorithms: the loss bit for bit (a power-of-two
  token count divides exactly), parameters within one bf16 ulp plus
  lr x 2^-7 (the bf16 reduce rounds g0 + g1 once; AdamW's first update
  moves by at most lr times that relative change; derived in
  ``chip_smoke.py::dp_dense_check``), equal on both ranks;
* deepseek-v2 smoke (capacity factor 1.0, so experts overflow), global
  dispatch: the ranks' kept pairs are the one-group dispatch of their
  gathered routing, and equal the one-rank run's wherever the routing is
  the same;
* the data-2 checkpoint restores at data 1 bit for bit, and the next
  step's loss from it equals the data-2 run's bit for bit;
* the NCCL world of one: the data-parallel step issues its collectives
  on a group of one and equals the undistributed step bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
from repro_torch.models import loss_fn
from repro_torch.models import moe as moe_mod
from repro_torch.models.params import tree_paths
from repro_torch.parallel.mesh import (Mesh, batch_shard, make_host_mesh,
                                       spawn, use_mesh)
from repro_torch.train import (CheckpointManager, OptConfig,
                               SyntheticLMData, TrainConfig,
                               make_initial_state, make_train_step)
from repro_torch.train.loop import abstract_state, state_shards

pytestmark = pytest.mark.cuda

B, S = 4, 64
OPT = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def dense_cfg():
    return dataclasses.replace(tcfg.smoke(tcfg.get_config("qwen3-0.6b")),
                               dtype="bfloat16")


def moe_cfg():
    return dataclasses.replace(
        tcfg.smoke(tcfg.get_config("deepseek-v2-236b")), dtype="bfloat16",
        capacity_factor=1.0)


def _dev():
    return torch.device("cuda", torch.cuda.current_device())


def _np(tree) -> dict:
    return {k: v.detach().cpu().float().numpy() for k, v in tree_paths(tree)}


def _gather(obj, world):
    import torch.distributed as dist
    every = [None] * world
    dist.all_gather_object(every, obj)
    return every


def dense_ranks(rank: int, world: int, ckpt: str) -> dict:
    mesh = make_host_mesh(world)
    cfg, dev = dense_cfg(), _dev()
    step = make_train_step(cfg, TrainConfig(opt=OPT), mesh)
    data = SyntheticLMData(cfg, B, S, device=dev, shard=batch_shard(mesh),
                           shards=world)
    torch.use_deterministic_algorithms(True, warn_only=True)
    state = make_initial_state(cfg, 0, dev, mesh=mesh)()
    state, m = step(state, data.batch_at(0))
    first = {"loss": float(m["loss"]), "params": _np(state["params"])}
    CheckpointManager(ckpt, mesh=mesh, shards=state_shards(cfg, mesh)).save(
        state, 1)
    _, m = step(state, data.batch_at(1))
    every = _gather(first["params"], world)
    same = all(all(np.array_equal(p[k], every[0][k]) for k in p)
               for p in every)
    return {**first, "next_loss": float(m["loss"]), "same": same}


def test_dense_data2_equals_one_rank_accumulated(tmp_path):
    got = spawn(dense_ranks, 2, device="cuda", backend="gloo",
                args=(str(tmp_path),), timeout=600)
    cfg, dev = dense_cfg(), torch.device("cuda")
    assert got["same"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        one = make_train_step(cfg, TrainConfig(opt=OPT, grad_accum=2))
        new, m = one(make_initial_state(cfg, 0, dev)(),
                     SyntheticLMData(cfg, B, S, device=dev).batch_at(0))
        assert float(m["loss"]) == got["loss"]
        lr = float(m["lr"])
        for k, b in tree_paths(new["params"]):
            a = torch.from_numpy(got["params"][k])
            b = b.float().cpu()
            mag = torch.maximum(a.abs(), b.abs()).clamp_min(
                torch.finfo(torch.bfloat16).tiny)
            ulp = torch.exp2(torch.floor(torch.log2(mag))) * 2.0 ** -7
            assert bool(((a - b).abs() <= ulp + lr * 2.0 ** -7).all()), k
        # the data-2 checkpoint of step 1 restores at data 1 bit for bit
        # and resumes: step 2's loss is the data-2 run's
        mgr = CheckpointManager(str(tmp_path))
        state, _ = mgr.restore(abstract_state(cfg), 1, device="cuda")
        with np.load(os.path.join(mgr.step_dir(1), "arrays.npz")) as f:
            for k, v in tree_paths(state):
                v = v.cpu()
                if v.dtype == torch.bfloat16:
                    v = v.view(torch.int16)
                assert torch.equal(v, torch.from_numpy(f[k])), k
        _, m = one(state, SyntheticLMData(cfg, B, S, device=dev).batch_at(1))
        assert float(m["loss"]) == got["next_loss"]
    finally:
        torch.use_deterministic_algorithms(False)


def moe_ranks(rank: int, world: int) -> dict:
    mesh = make_host_mesh(world)
    cfg, dev = moe_cfg(), _dev()
    state = make_initial_state(cfg, 0, dev)()
    batch = SyntheticLMData(cfg, B, S, device=dev, shard=batch_shard(mesh),
                            shards=world).batch_at(0)
    with use_mesh(mesh, process_wide=True), torch.no_grad(), \
            moe_mod.record_dispatch() as log:
        loss, met = loss_fn(state["params"], batch, cfg)
    calls = [{k: (v.cpu().numpy() if torch.is_tensor(v) else v)
              for k, v in c.items()} for c in log]
    return {"calls": _gather(calls, world), "loss": float(loss),
            "aux": float(met["aux"])}


def test_moe_global_dispatch_keeps_the_one_rank_pairs():
    got = spawn(moe_ranks, 2, device="cuda", backend="gloo", timeout=600)
    cfg, dev = moe_cfg(), torch.device("cuda")
    params = make_initial_state(cfg, 0, dev)()["params"]
    with torch.no_grad(), moe_mod.record_dispatch() as log:
        loss, met = loss_fn(params, SyntheticLMData(
            cfg, B, S, device=dev).batch_at(0), cfg)
    assert abs(got["loss"] - float(loss)) <= 2.0 ** -8 * abs(float(loss))
    assert abs(got["aux"] - float(met["aux"])) <= 2.0 ** -8 * float(
        met["aux"])
    for i, one in enumerate(log):
        ranks = [r[i] for r in got["calls"]]
        pairs = set()
        for r in ranks:
            pairs |= set(zip(r["token"].tolist(), r["expert"].tolist()))
        assert sum(len(r["token"]) for r in ranks) == len(pairs)
        routing = np.concatenate([r["choice"] for r in ranks])
        # the ranks keep the one-group dispatch of their own routing
        N = routing.shape[0]
        _, slot_token, _ = moe_mod._dispatch_combine(
            torch.zeros((N, 1)), torch.ones(routing.shape),
            torch.from_numpy(routing), one["capacity"], cfg)
        full = (slot_token < N).nonzero()[:, 0]
        assert pairs == set(zip(slot_token[full].long().tolist(),
                                (full // one["capacity"]).tolist()))
        want = set(zip(one["token"].cpu().tolist(),
                       one["expert"].cpu().tolist()))
        diff = (routing != one["choice"].cpu().numpy()).any(1)
        touched = set(routing[diff].flatten().tolist()) | set(
            one["choice"].cpu().numpy()[diff].flatten().tolist())
        assert {e for _, e in pairs ^ want} <= touched
        assert len(want) < B * S * cfg.moe_top_k          # experts overflow


def nccl_one(rank: int, world: int) -> dict:
    import torch.distributed as dist
    from repro_torch.core.roofline.op_collectives import CollectiveWalk
    cfg, dev = dense_cfg(), _dev()
    mesh = Mesh(("data", "model"), (1, 1), 0, {"data": dist.group.WORLD},
                dist.get_backend())
    tc = TrainConfig(opt=OPT)
    batch = SyntheticLMData(cfg, B, S, device=dev).batch_at(0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    state = make_initial_state(cfg, 0, dev)()
    a, ma = make_train_step(cfg, tc)(state, batch)
    with CollectiveWalk(mesh=mesh) as walk:
        b, mb = make_train_step(cfg, tc, mesh)(state, batch)
    equal = all(torch.equal(x, y) for (_, x), (_, y) in
                zip(tree_paths(a), tree_paths(b)))
    return {"equal": equal and torch.equal(ma["loss"], mb["loss"]),
            "sizes": sorted({o.group_size for o in walk.ops}),
            "n": len(walk.ops), "backend": dist.get_backend()}


def test_nccl_world_of_one_equals_the_undistributed_step():
    got = spawn(nccl_one, 1, device="cuda", backend="nccl", timeout=600)
    assert got["backend"] == "nccl" and got["equal"]
    assert got["n"] > 0 and got["sizes"] == [1]
