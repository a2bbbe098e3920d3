"""Data-parallel training over ``torch.distributed`` against the JAX
package's GSPMD step, on the CPU: gloo ranks of the port (one spawn per
world size, 2 and 4 ranks) and the reference in one subprocess with 8
forced host devices, side by side, on qwen3-0.6b smoke and deepseek-v2
smoke (float32; capacity factor 1.0, so experts overflow across ranks).
Both start from one initial state, which the port writes as a step-0
checkpoint and the reference restores.

Checks and tolerances (float32 on both sides; the two sum the same
terms in other orders):

* losses, nll, aux and grad norms: rtol 1e-5;
* parameters and ZeRO-1 moments after 2 steps (AdamW at lr 1e-3, no
  warmup), element by element, from the gradients' agreement bar:
  each step's gradients agree within 1e-4 x |g| + 1e-5 x max(1, the
  leaf's largest |g|) (the reference's bar for gradients).  Under
  ``compress_pod_grads`` the port rounds each rank's gradient to bf16
  and sums in bf16 (over data, then pod), where the reference's CPU
  program rounds the float32 sum once: each rounding is within 2^-8 of
  what it rounds, at most A = the sum over the ranks of their |g_r|, so
  with the reference's own rounding the two agree within 4 x 2^-8 x A
  (A measured on the port's ranks each step, the larger of the two
  steps; ranks' gradients that cancel make A far larger than |g|).
  With the reference's nu, G = sqrt(nu / ((1 - b2) b2)) bounds each
  step's |g|.  An update lr m_hat / (sqrt(v_hat) + eps) moves by at
  most lr x 2 x (rel + atol / rms) (rms = sqrt(v_hat); m_hat / sqrt(
  v_hat) changes by at most twice the gradients' relative error, by
  Cauchy-Schwarz over the steps' weights), and never by more than 2
  lr: parameters within rtol 1e-5 plus the sum over the steps; mu
  within (1 - b1)(1 + b1) x (rel G + atol), nu within 2 (1 - b2)(1 +
  b2) x G x (rel G + atol);
* losses and nll: rtol 1e-5; the grad norm under compression rtol
  2^-6 (its elements' bar against A, where A is |g|);
* MoE gradients: rtol 1e-4 / atol 1e-5 of the leaf's largest where
  that exceeds 1 (the reference's own bar for gradients);
* the kept (token, expert) pairs of the global dispatch: equal as sets;
* checkpoints (data 4 -> 2 -> 1, and across the packages): bit for bit;
* the pre-flight walk's collective bytes by axis: equal to
  ``train.step.dp_wire_bytes`` (float arithmetic, rtol 1e-12);
* gloo's staged reduce-scatter (all-reduce, then the slice) and the
  reduce-scatter operator: bit for bit on integer-valued float32, and
  within one float32 rounding of the sum on random values.

The rank functions live at module level and the module imports neither
JAX nor the JAX package at its top, so the spawned ranks start light.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
from repro_torch.core.analysis import analyze_step
from repro_torch.launch import specs as tspecs
from repro_torch.models.common import ShapeCell
from repro_torch.models.params import tree_map, tree_paths
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.mesh import (Mesh, batch_shard, batch_shards,
                                       make_host_mesh, spawn, use_mesh)
from repro_torch.train import (CheckpointManager, LoopConfig, OptConfig,
                               SyntheticLMData, TrainConfig, TrainLoop,
                               make_initial_state, make_train_step)
from repro_torch.train.loop import _TransientError, abstract_state, \
    state_shards
from repro_torch.train.optimizer import moment_shards
from repro_torch.train.step import dp_wire_bytes, value_and_grad
from repro_torch.models import model_param_defs
from repro_torch.models import moe as moe_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, SEED, STEPS = 4, 16, 3, 2
LR = 1e-3
OPT = OptConfig(lr=LR, warmup_steps=0, total_steps=10)
RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BF16_BAR = 4 * 2.0 ** -8


def dense_cfg():
    return tcfg.smoke(tcfg.get_config("qwen3-0.6b"))


def moe_cfg(dispatch="global"):
    return dataclasses.replace(
        tcfg.smoke(tcfg.get_config("deepseek-v2-236b")),
        capacity_factor=1.0, moe_dispatch=dispatch)


def _np(tree) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in tree_paths(tree)}


def _initial(cfg, init_dir: str, mesh):
    """The step-0 state of ``cfg`` written by the test, restored on this
    rank of ``mesh`` (moments as its ZeRO-1 blocks)."""
    mgr = CheckpointManager(os.path.join(init_dir, cfg.name), mesh=mesh,
                            shards=state_shards(cfg, mesh))
    return mgr.restore(abstract_state(cfg, mesh), 0, device="cpu")[0]


def _steps(cfg, mesh, tcfg_, init_dir: str, steps: int = STEPS,
           absum: bool = False):
    """``steps`` steps from the step-0 state: (state, metrics, and with
    ``absum`` each leaf's sum over the ranks of |its bf16 gradient|, the
    larger of the steps')."""
    state = _initial(cfg, init_dir, mesh)
    data = SyntheticLMData(cfg, B, S, seed=SEED, device="cpu",
                           shard=batch_shard(mesh), shards=batch_shards(mesh),
                           micro=tcfg_.grad_accum)
    step = make_train_step(cfg, tcfg_, mesh)
    metrics, big = [], None
    for i in range(steps):
        batch = data.batch_at(i)
        if absum:
            with use_mesh(mesh, process_wide=True):
                g = value_and_grad(state["params"], batch, cfg)[2]
                a = tree_map(lambda x: coll.all_reduce_(
                    x.to(torch.bfloat16).float().abs(), ("data", "pod")), g)
            big = a if big is None else tree_map(torch.maximum, big, a)
        state, m = step(state, batch)
        metrics.append({k: float(m[k]) for k in ("loss", "nll", "grad_norm")})
    return state, metrics, big


def _gather_objects(obj, world: int) -> list:
    import torch.distributed as dist
    every = [None] * world
    dist.all_gather_object(every, obj)
    return every


def _train_result(cfg, mesh, tcfg_, init_dir: str, world: int) -> dict:
    """Two steps; rank 0's parameters and metrics, every rank's moment
    blocks and whether its parameters equal rank 0's bit for bit."""
    state, metrics, big = _steps(cfg, mesh, tcfg_, init_dir,
                                 absum=tcfg_.compress_pod_grads)
    flat = _np(state)
    params = {k: v for k, v in flat.items() if k.startswith("params/")}
    moments = {k: v for k, v in flat.items() if k.startswith("opt/")}
    every = _gather_objects((params, moments), world)
    same = all(all(np.array_equal(p[k], params[k]) for k in params)
               for p, _ in every)
    return {"metrics": metrics, "params": params,
            "moments": [m for _, m in every], "params_equal": same,
            "absum": None if big is None else _np(big)}


def _walk(cfg, mesh, tcfg_) -> dict:
    """The pre-flight walk of this rank's step: its wire bytes by axis,
    and the analytic count."""
    args, _, _ = tspecs.train_specs(cfg, ShapeCell("t", S, B, "train"), mesh)
    rep = analyze_step(make_train_step(cfg, tcfg_, mesh), args=args,
                       mesh=mesh, dtype="float32")
    return {"walked": {k[0]: v for k, v in
                       rep.character.collectives.by_axes.items()},
            "want": dp_wire_bytes(cfg, mesh.sizes, tcfg_)}


def _moe_grads(cfg, mesh, init_dir: str, world: int) -> dict:
    """loss_fn's values and its gradient (the ranks' mean) on the global
    batch of step 0, and the global dispatch's kept pairs."""
    params = _initial(cfg, init_dir, mesh)["params"]
    batch = SyntheticLMData(cfg, B, S, seed=SEED, device="cpu",
                            shard=batch_shard(mesh),
                            shards=batch_shards(mesh)).batch_at(0)
    with use_mesh(mesh, process_wide=True), moe_mod.record_dispatch() as log:
        loss, met, grads = value_and_grad(params, batch, cfg)
        grads = tree_map(lambda g: coll.all_reduce_(g, ("data",)) / world,
                         grads)
    pairs = [(c["token"].numpy(), c["expert"].numpy(), c["capacity"])
             for c in log]
    return {"loss": float(loss), "nll": float(met["nll"]),
            "aux": float(met["aux"]), "grads": _np(grads),
            "pairs": _gather_objects(pairs, world)}


def _forms(mesh) -> dict:
    """reduce_scatter_dim's two forms on this rank's tensors: integer
    valued (exact sums) and random."""
    g = torch.Generator().manual_seed(mesh.rank)
    out = {}
    with use_mesh(mesh):
        for kind in ("int", "rand"):
            t = torch.randn((3, 8, 5), generator=g)
            if kind == "int":
                t = torch.round(t * 100)
            a = coll.reduce_scatter_dim(t, 1, "data", form="all_reduce")
            b = coll.reduce_scatter_dim(t, 1, "data", form="reduce_scatter")
            full = coll.all_reduce_(t.clone(), ("data",))
            out[kind] = (a.numpy(), b.numpy(),
                         full.narrow(1, 2 * mesh.coord("data"), 2).numpy())
    return out


def four_ranks(rank: int, world: int, init_dir: str, ckpt4: str) -> dict:
    """(pod 2, data 2): two steps, plain and compressed, and their walks;
    (data 4): the reduce-scatter forms, and a TrainLoop of 3 steps
    (a checkpoint at step 2, a transient fault on rank 1 at step 1 that
    every rank retries) then of 5, preempted at step 4 by rank 3."""
    res = {}
    pd = make_host_mesh(2, pod=2)
    d4 = make_host_mesh(4)
    for tag, comp in (("pod", False), ("compress", True)):
        t = TrainConfig(opt=OPT, compress_pod_grads=comp)
        res[tag] = _train_result(dense_cfg(), pd, t, init_dir, world)
        res[f"{tag} walk"] = _walk(dense_cfg(), pd, t)
    res["forms"] = _forms(d4)

    cfg = dense_cfg()
    calls = {"n": 0}

    def injector(step):
        if step == 1:
            calls["n"] += 1
            if rank == 1 and calls["n"] == 1:
                raise _TransientError("injected")

    def loop(total, inject):
        return TrainLoop(
            cfg, LoopConfig(total_steps=total, ckpt_every=2, log_every=1,
                            max_retries=1, train=TrainConfig(opt=OPT)),
            SyntheticLMData(cfg, B, S, seed=SEED, device="cpu",
                            shard=batch_shard(d4), shards=4),
            CheckpointManager(ckpt4, keep=5, mesh=d4,
                              shards=state_shards(cfg, d4)),
            make_initial_state(cfg, 0, "cpu", mesh=d4),
            failure_injector=inject, mesh=d4)

    first = loop(3, injector)
    out = first.run()
    res["loop"] = {"history": first.history, "step": out["step"],
                   "tries": calls["n"]}

    def preempt(step):
        if rank == 3 and step == 4:
            second._sigterm = True

    second = loop(5, preempt)
    out = second.run()
    res["preempt"] = _gather_objects((out["step"], out["preempted"],
                                      second.history), world)
    return res


def two_ranks(rank: int, world: int, init_dir: str, ckpt4: str,
              ckpt2: str) -> dict:
    """(data 2): two steps plain and with grad_accum 2, the walk, the
    MoE dispatches; the data-4 checkpoint of step 2 restored here and
    stepped once; the two-step state saved (collectively) at step 2."""
    mesh = make_host_mesh(2)
    res = {"mesh": mesh.sizes}
    plain = TrainConfig(opt=OPT)
    res["data"] = _train_result(dense_cfg(), mesh, plain, init_dir, world)
    res["accum"] = _train_result(dense_cfg(), mesh,
                                 TrainConfig(opt=OPT, grad_accum=2),
                                 init_dir, world)
    res["walk"] = _walk(dense_cfg(), mesh, plain)
    res["moe global"] = _moe_grads(moe_cfg(), mesh, init_dir, world)
    res["moe local"] = _moe_grads(moe_cfg("local"), mesh, init_dir, world)

    cfg = dense_cfg()
    shards = state_shards(cfg, mesh)
    mgr = CheckpointManager(ckpt4, mesh=mesh, shards=shards)
    state, manifest = mgr.restore(abstract_state(cfg, mesh), 2,
                                  device="cpu")
    with np.load(os.path.join(mgr.step_dir(2), "arrays.npz")) as f:
        disk = {k: f[k] for k in f.files}
    sh = dict(tree_paths(shards))
    res["restored equal"] = all(
        np.array_equal(v.numpy(), disk[k] if sh[k] is None
                       else sh[k].take(torch.from_numpy(disk[k])).numpy())
        for k, v in tree_paths(state))
    data = SyntheticLMData(cfg, B, S, seed=SEED, device="cpu",
                           shard=batch_shard(mesh), shards=2)
    _, m = make_train_step(cfg, plain, mesh)(state, data.batch_at(2))
    res["resumed loss"] = float(m["loss"])

    state = _steps(cfg, mesh, plain, init_dir)[0]
    CheckpointManager(ckpt2, mesh=mesh, shards=shards).save(state, STEPS)
    return res


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, jax, numpy as np
    from repro.configs import get_config, smoke
    from repro.launch import specs as specs_mod
    from repro.models import loss_fn
    from repro.models import moe as moe_mod
    from repro.models.common import ShapeCell
    from repro.parallel.mesh import make_mesh, mesh_context
    from repro.parallel.sharding import sharding_context
    from repro.train import CheckpointManager, SyntheticLMData
    from repro.train.checkpoint import _flat
    from repro.train.loop import make_initial_state
    from repro.train.optimizer import OptConfig
    from repro.train.step import TrainConfig, make_train_step

    out_path, init_dir, ckpt_dir = sys.argv[1:4]
    B, S, SEED, STEPS = {B}, {S}, {SEED}, {STEPS}
    OPT = OptConfig(lr={LR}, warmup_steps=0, total_steps=10)
    dense = smoke(get_config("qwen3-0.6b"))
    moe = dataclasses.replace(smoke(get_config("deepseek-v2-236b")),
                              capacity_factor=1.0)
    out = {{}}

    def initial(cfg):
        abstract = jax.eval_shape(make_initial_state(cfg))
        return CheckpointManager(os.path.join(init_dir, cfg.name)).restore(
            abstract, 0)[0]

    def put(tag, tree):
        for k, v in _flat(tree).items():
            out[tag + "/" + k] = np.asarray(v)

    def train(tag, cfg, shape, names, tcfg):
        mesh = make_mesh(shape, names)
        cell = ShapeCell("t", S, B, "train")
        with sharding_context(mesh):
            _, in_sh, out_sh = specs_mod.train_specs(cfg, cell, mesh)
            with mesh_context(mesh):
                step = jax.jit(make_train_step(cfg, tcfg),
                               in_shardings=in_sh, out_shardings=out_sh)
                state = jax.device_put(initial(cfg), in_sh[0])
                data = SyntheticLMData(cfg, B, S, seed=SEED)
                for i in range(STEPS):
                    state, m = step(state, jax.device_put(data.batch_at(i),
                                                          in_sh[1]))
                    for k in ("loss", "nll", "grad_norm"):
                        out[f"{{tag}}/{{k}}{{i}}"] = np.asarray(m[k])
        put(tag, state)
        return state

    state = train("data", dense, (2, 1), ("data", "model"),
                  TrainConfig(opt=OPT))
    CheckpointManager(ckpt_dir).save(state, STEPS)
    train("accum", dense, (2, 1), ("data", "model"),
          TrainConfig(opt=OPT, grad_accum=2))
    train("pod", dense, (2, 2, 1), ("pod", "data", "model"),
          TrainConfig(opt=OPT))
    train("compress", dense, (2, 2, 1), ("pod", "data", "model"),
          TrainConfig(opt=OPT, compress_pod_grads=True))

    for tag, cfg in (("moe global", moe),
                     ("moe local", dataclasses.replace(
                         moe, moe_dispatch="local"))):
        mesh = make_mesh((2, 1), ("data", "model"))
        params = initial(cfg)["params"]
        batch = SyntheticLMData(cfg, B, S, seed=SEED).batch_at(0)
        with sharding_context(mesh), mesh_context(mesh):
            (loss, met), g = jax.jit(jax.value_and_grad(
                lambda p, b: loss_fn(p, b, cfg), has_aux=True))(params,
                                                               batch)
        out[tag + "/loss"] = np.asarray(loss)
        out[tag + "/nll"] = np.asarray(met["nll"])
        out[tag + "/aux"] = np.asarray(met["aux"])
        put(tag + "/grads", g)

    # the global dispatch's kept pairs: its semantics are the mesh's,
    # so one eager forward over the global batch shows them
    inner, slots = moe_mod._dispatch_combine, []
    def spy(xf, gates, eids, C, cfg):
        res = inner(xf, gates, eids, C, cfg)
        N = xf.shape[0]
        jax.debug.callback(lambda st: slots.append((np.asarray(st), C, N)),
                           res[1])
        return res
    moe_mod._dispatch_combine = spy
    batch = SyntheticLMData(moe, B, S, seed=SEED).batch_at(0)
    loss_fn(initial(moe)["params"], batch, moe)
    jax.effects_barrier()
    for i, (st, C, N) in enumerate(slots):
        full = np.nonzero(st < N)[0]
        out[f"pairs{{i}}/token"] = st[full].astype(np.int64)
        out[f"pairs{{i}}/expert"] = full // C
        out[f"pairs{{i}}/capacity"] = np.asarray(C)
    np.savez(out_path, **out)
    print("RESULT ok")
""").format(B=B, S=S, SEED=SEED, STEPS=STEPS, LR=LR)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess, started first, and the port's two
    spawns meanwhile: {"ref", "four", "two", paths}."""
    tmp = tmp_path_factory.mktemp("train_dp")
    init_dir, ckpt4, ckpt2, ref_ckpt = (str(tmp / n) for n in (
        "init", "ckpt4", "ckpt2", "ref_ckpt"))
    for cfg in (dense_cfg(), moe_cfg()):
        state = make_initial_state(cfg, 0, "cpu")()
        CheckpointManager(os.path.join(init_dir, cfg.name)).save(state, 0)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    ref_path = tmp / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(ref_path), init_dir,
         ref_ckpt], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    try:
        four = spawn(four_ranks, 4, device="cpu", threads=1,
                     args=(init_dir, ckpt4), timeout=300)
        two = spawn(two_ranks, 2, device="cpu", threads=1,
                    args=(init_dir, ckpt4, ckpt2), timeout=300)
        stdout, stderr = proc.communicate(timeout=420)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "RESULT ok" in stdout, (stdout[-2000:], stderr[-3000:])
    with np.load(ref_path) as f:
        ref = {k: f[k] for k in f.files}
    return {"ref": ref, "four": four, "two": two, "ckpt4": ckpt4,
            "ckpt2": ckpt2, "ref_ckpt": ref_ckpt}


def _bars(ref: dict, tag: str, key: str, absum=None):
    """(parameter, mu, nu) tolerances of leaf ``key`` after STEPS steps,
    element by element (the module docstring); ``absum``: the ranks'
    summed |bf16 gradient| under compression."""
    b1, b2 = OPT.betas
    nu = ref[f"{tag}/opt/nu/{key}"].astype(np.float64)
    big = np.sqrt(nu / ((1 - b2) * b2))
    atol = GRAD_ATOL * max(1.0, float(big.max()) if big.size else 1.0)
    rms = np.maximum(np.sqrt(nu / (1 - b2 ** STEPS)), 1e-30)
    dg = GRAD_RTOL * big + atol
    if absum is not None:
        dg = dg + BF16_BAR * absum
    step = np.minimum(2.0, 2 * dg / rms)
    return (LR * STEPS * step, (1 - b1) * (1 + b1) * dg,
            2 * (1 - b2) * (1 + b2) * big * dg)


def _within(got, want, tol, what):
    err = np.abs(got.astype(np.float64) - want)
    bad = err > tol
    assert not bad.any(), (what, int(bad.sum()), float(err[bad].max()),
                           float(np.broadcast_to(tol, err.shape)[bad].min()))


def _hold_train(got: dict, ref: dict, tag: str, mesh_sizes=None):
    absum = got["absum"] or {}
    for i, m in enumerate(got["metrics"]):
        for k in ("loss", "nll", "grad_norm"):
            rtol = BF16_BAR if k == "grad_norm" and absum else RTOL
            np.testing.assert_allclose(m[k], float(ref[f"{tag}/{k}{i}"]),
                                       rtol=rtol, err_msg=f"{k} step {i}")
    for k, v in got["params"].items():
        want = ref[f"{tag}/{k}"].astype(np.float64)
        key = k.split("/", 1)[1]
        tol = _bars(ref, tag, key, absum.get(key))[0]
        _within(v, want, RTOL * np.abs(want) + tol, k)
    assert got["params_equal"]
    # each rank's moments are its zero1_spec blocks of the reference's
    sizes = mesh_sizes or {"data": 2, "model": 1}
    data = sizes["data"]
    for r, moments in enumerate(got["moments"]):
        mesh = Mesh(tuple(sizes), tuple(sizes.values()), rank=r)
        sh = dict(tree_paths(moment_shards(model_param_defs(dense_cfg()),
                                           mesh)))
        for k, v in moments.items():
            want = ref[f"{tag}/{k}"]
            if k == "opt/step":
                assert int(v) == int(want) == STEPS
                continue
            key = k.split("/", 2)[2]
            _, mu_tol, nu_tol = _bars(ref, tag, key, absum.get(key))
            s = sh[key]
            if data > 1:
                assert s is not None and s.count == data, k
            take = (lambda a: a) if s is None else (
                lambda a: s.take(torch.from_numpy(np.ascontiguousarray(
                    a))).numpy())
            want, tol = take(want), take(mu_tol if "/mu/" in k else nu_tol)
            assert v.shape == want.shape, (k, v.shape, want.shape)
            _within(v, want.astype(np.float64),
                    RTOL * np.abs(want) + tol, f"rank {r} {k}")


def test_dense_data2_matches_reference(runs):
    _hold_train(runs["two"]["data"], runs["ref"], "data")


def test_dense_pod2_data2_matches_reference(runs):
    _hold_train(runs["four"]["pod"], runs["ref"], "pod",
                mesh_sizes={"pod": 2, "data": 2, "model": 1})


def test_compress_pod_grads_matches_reference(runs):
    got, ref = runs["four"]["compress"], runs["ref"]
    _hold_train(got, ref, "compress",
                mesh_sizes={"pod": 2, "data": 2, "model": 1})
    # bf16 rounding shows: the compressed run is not the plain one
    assert any(not np.array_equal(v, runs["four"]["pod"]["params"][k])
               for k, v in got["params"].items())


def test_grad_accum_times_data_matches_reference(runs):
    _hold_train(runs["two"]["accum"], runs["ref"], "accum")


def _hold_moe(got: dict, ref: dict, tag: str):
    for k in ("loss", "nll", "aux"):
        np.testing.assert_allclose(got[k], float(ref[f"{tag}/{k}"]),
                                   rtol=RTOL, err_msg=k)
    assert got["aux"] > 0
    for k, v in got["grads"].items():
        want = ref[f"{tag}/grads/{k}"]
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(v, want, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=k)


def test_moe_global_dispatch_matches_reference(runs):
    got, ref = runs["two"]["moe global"], runs["ref"]
    _hold_moe(got, ref, "moe global")
    ranks = got["pairs"]                 # per rank: per MoE call
    n_calls = len(ranks[0])
    assert n_calls == sum(k.endswith("/capacity") for k in ref) >= 1
    for i in range(n_calls):
        want = set(zip(ref[f"pairs{i}/token"].tolist(),
                       ref[f"pairs{i}/expert"].tolist()))
        got_pairs = [set(zip(t.tolist(), e.tolist()))
                     for t, e, _ in (r[i] for r in ranks)]
        assert all(r[i][2] == int(ref[f"pairs{i}/capacity"]) for r in ranks)
        union = set().union(*got_pairs)
        assert sum(len(p) for p in got_pairs) == len(union) == len(want)
        assert union == want
        # experts overflow: some pairs of the global batch were dropped
        assert len(want) < B * S * moe_cfg().moe_top_k


def test_moe_local_dispatch_matches_reference(runs):
    _hold_moe(runs["two"]["moe local"], runs["ref"], "moe local")


def test_elastic_restore_4_to_2_to_1(runs):
    two, four = runs["two"], runs["four"]
    assert two["restored equal"]
    # the data-4 run's step 3 from the same state, at data 2
    loss3 = {h["step"]: h["loss"] for h in four["loop"]["history"]}[3]
    np.testing.assert_allclose(two["resumed loss"], loss3, rtol=1e-6)
    cfg = dense_cfg()
    mgr = CheckpointManager(runs["ckpt4"])
    state, manifest = mgr.restore(abstract_state(cfg), 2, device="cpu")
    with np.load(os.path.join(mgr.step_dir(2), "arrays.npz")) as f:
        for k, v in tree_paths(state):
            assert np.array_equal(v.numpy(), f[k]), k
    # the data-2 save restores whole on one device, bit for bit
    ref = CheckpointManager(runs["ckpt2"])
    got, manifest = ref.restore(abstract_state(cfg), STEPS, device="cpu")
    flat = _np(got)
    for k, v in two["data"]["params"].items():
        assert np.array_equal(flat[k], v), k
    for r, moments in enumerate(two["data"]["moments"]):
        sh = dict(tree_paths(moment_shards(
            model_param_defs(cfg), Mesh(("data", "model"), (2, 1), r))))
        for k, v in moments.items():
            s = sh.get(k.split("/", 2)[2]) if k != "opt/step" else None
            whole = torch.from_numpy(flat[k])
            assert np.array_equal(v, whole.numpy() if s is None
                                  else s.take(whole).numpy()), (r, k)


def test_loop_retries_and_preempts_together(runs):
    loop = runs["four"]["loop"]
    # rank 1's fault at step 1: rank 0 retried it as well
    assert loop["step"] == 3 and loop["tries"] == 2
    assert [h["step"] for h in loop["history"]] == [1, 2, 3]
    ends = runs["four"]["preempt"]
    assert all(step == 4 and pre for step, pre, _ in ends)
    assert [h["step"] for h in ends[0][2]] == [4]       # rank 0's history
    assert all(hist == [] for _, _, hist in ends[1:])
    mgr = CheckpointManager(runs["ckpt4"])
    assert 4 in mgr.all_steps()


def test_checkpoints_cross_packages(runs):
    import jax
    from repro.train import CheckpointManager as JManager
    from repro.train.checkpoint import _flat
    import repro.configs as jcfg
    from repro.train.loop import make_initial_state as j_initial
    jc = jcfg.smoke(jcfg.get_config("qwen3-0.6b"))
    abstract = jax.eval_shape(j_initial(jc))
    # the port's data-2 save restores in the reference on one device
    state, manifest = JManager(runs["ckpt2"]).restore(abstract, STEPS)
    with np.load(os.path.join(CheckpointManager(runs["ckpt2"]).step_dir(
            STEPS), "arrays.npz")) as f:
        for k, v in _flat(state).items():
            assert np.array_equal(np.asarray(v), f[k]), k
    assert int(manifest["step"]) == STEPS
    # the reference's save restores in the port at data 2, each rank its
    # blocks
    cfg = dense_cfg()
    with np.load(os.path.join(JManager(runs["ref_ckpt"]).step_dir(STEPS),
                              "arrays.npz")) as f:
        disk = {k: f[k] for k in f.files}
    for r in range(2):
        mesh = Mesh(("data", "model"), (2, 1), r)
        shards = state_shards(cfg, mesh)
        got, _ = CheckpointManager(runs["ref_ckpt"], mesh=mesh,
                                   shards=shards).restore(
            abstract_state(cfg, mesh), STEPS, device="cpu")
        sh = dict(tree_paths(shards))
        for k, v in tree_paths(got):
            want = disk[k] if sh[k] is None else sh[k].take(
                torch.from_numpy(disk[k])).numpy()
            assert np.array_equal(v.numpy(), want), (r, k)
            if k.startswith("opt/mu/") and sh[k] is not None:
                assert v.shape[sh[k].dim] * 2 == disk[k].shape[sh[k].dim]


@pytest.mark.parametrize("where", ["walk", "pod walk", "compress walk"])
def test_preflight_collective_bytes_by_axis(runs, where):
    got = runs["two"]["walk"] if where == "walk" else runs["four"][where]
    walked, want = got["walked"], got["want"]
    axes = ["data"] + (["pod"] if where != "walk" else [])
    assert sorted(walked) == sorted(axes)
    for a in axes:
        np.testing.assert_allclose(walked[a], want[a], rtol=1e-12,
                                   err_msg=a)
    if where == "compress walk":
        plain = runs["four"]["pod walk"]["want"]
        assert want["pod_grads"] * 2 == pytest.approx(plain["pod_grads"],
                                                      rel=1e-12)
        assert walked["pod"] < plain["pod"]


def test_staged_reduce_scatter_equals_the_operator(runs):
    forms = runs["four"]["forms"]
    a, b, full = forms["int"]
    assert np.array_equal(a, b) and np.array_equal(a, full)
    a, b, full = forms["rand"]
    assert np.array_equal(a, full)
    np.testing.assert_allclose(a, b, rtol=2 ** -22, atol=1e-6)
