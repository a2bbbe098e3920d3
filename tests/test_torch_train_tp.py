"""Tensor-parallel training over ``torch.distributed`` against the JAX
package's GSPMD step, on the CPU: gloo ranks of the port on ``(data,
model)`` and ``(pod, data, model)`` meshes (one spawn per world size: 2,
4 and 8 ranks, torch on two intra-op threads) and the reference in one
subprocess with 8 forced host devices under ``launch/specs.py::
train_specs`` shardings, side by side, in float32 on smoke configs:

* qwen3-0.6b (tied, qk-norm) at (data 1, model 2), (2, 2) and (pod 2,
  data 1, model 2) under remat "full", and at (1, 2) with grad_accum 2;
  at (1, 4) under remat "full", where its 2 KV heads do not divide
  ``model``: the rules replicate ``wk`` / ``wv`` and each rank slices
  the head its query heads read; and with one KV head (MQA, ``:kv1``)
  at (1, 2), a replicated head every rank reads whole;
* minitron-4b (untied head) at (1, 2) under remat "dots";
* deepseek-v2 (MLA, 4 experts, a shared expert; capacity factor 1.0,
  so experts overflow) at (1, 2) and (2, 2) under remat "dots";
* whisper-small (encoder, self + cross attention) at (1, 2) under remat
  "full", and llama-3.2-vision-90b (gated cross attention) at (1, 2).

Every case starts from one initial state, which the test writes as a
step-0 checkpoint; the ranks restore it onto their mesh (each its blocks)
and the reference restores it whole.

Checks and tolerances (float32 on both sides; the two sum the same
terms in other orders, the row-parallel sums across ranks included):

* loss, nll, aux and grad norm of each of the 3 steps: rtol 1e-5;
* every parameter and moment leaf after 3 steps (AdamW at lr 1e-3, no
  warmup), element by element, from the gradients' agreement bar (the
  reference's bar for gradients: 1e-4 x |g| + 1e-5 x max(1, the leaf's
  largest |g|), G = sqrt(nu / ((1 - b2) b2)) bounding |g|): parameters
  within rtol 1e-5 plus lr x 3 x min(2, 2 x bar / rms(g)); mu within
  (1 - b1)(1 + b1) x bar, nu within 2 (1 - b2)(1 + b2) x G x bar (the
  derivation is ``tests/test_torch_train_dp.py``'s);
* the ranks' replicated copies: equal bit for bit; a rank's moment
  block the shape of its ``zero1_spec`` block;
* deepseek-v2's kept (token, expert) pairs at the first step: equal, as
  sets, to the reference's global dispatch (each model rank keeps all
  of them, the data ranks their tokens');
* the f / g edges and the logits' gather at model 2: gradients of the
  unsharded product within rtol 1e-6, atol 1e-6; the vocab-sharded
  embedding bit for bit, its logits within rtol 1e-6;
* ``TrainLoop(mesh=)`` at (1, 2), 2 steps, then a restart to step 3
  from its checkpoint: the case's losses bit for bit;
* the pre-flight walk on (2, 2, 2): ``model``-axis ops, ``pod`` bytes on
  ``dcn``, the walked ``model`` bytes by edge equal to
  ``train.step.tp_wire_bytes`` and the ``data`` / ``pod`` bytes to
  ``dp_wire_bytes`` (float arithmetic, rtol 1e-12).

The elastic restores (save on (data 4, model 2), restore onto (2, 4) and
(1, 1), across packages) are ``tests/test_torch_train_tp_ckpt.py``'s.
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
from repro_torch.models import loss_fn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (LocalLayout, ModelConfig, ShapeCell,
                                       layout_of)
from repro_torch.models.layers import embed_tokens, logits_from_hidden
from repro_torch.models.params import tree_paths
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.mesh import (Mesh, batch_shard, batch_shards,
                                       make_host_mesh, spawn, use_mesh)
from repro_torch.serve import shard as serve_shard
from repro_torch.train import (CheckpointManager, LoopConfig, OptConfig,
                               SyntheticLMData, TrainConfig, TrainLoop,
                               make_initial_state, make_train_step)
from repro_torch.train.loop import abstract_state, state_shards
from repro_torch.train.step import (dp_wire_bytes, train_local_config,
                                    tp_wire_bytes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, SEED, STEPS = 4, 16, 3, 3
LR = 1e-3
OPT = OptConfig(lr=LR, warmup_steps=0, total_steps=10)
RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
EDGE_RTOL = EDGE_ATOL = 1e-6
THREADS = 2

# tag -> (arch, (pod, data, model), grad_accum, remat)
CASES = {
    "qwen 1x2": ("qwen3-0.6b", (1, 1, 2), 1, "none"),
    "qwen accum": ("qwen3-0.6b", (1, 1, 2), 2, "none"),
    "qwen 2x2": ("qwen3-0.6b", (1, 2, 2), 1, "full"),
    "qwen pod": ("qwen3-0.6b", (2, 1, 2), 1, "full"),
    "qwen 1x4": ("qwen3-0.6b", (1, 1, 4), 1, "full"),
    "qwen mqa 1x2": ("qwen3-0.6b:kv1", (1, 1, 2), 1, "none"),
    "minitron 1x2": ("minitron-4b", (1, 1, 2), 1, "dots"),
    "deepseek 1x2": ("deepseek-v2-236b", (1, 1, 2), 1, "none"),
    "deepseek 2x2": ("deepseek-v2-236b", (1, 2, 2), 1, "dots"),
    "whisper 1x2": ("whisper-small", (1, 1, 2), 1, "full"),
    "vision 1x2": ("llama-3.2-vision-90b", (1, 1, 2), 1, "none"),
}
ARCHS = sorted({c[0] for c in CASES.values()})
WALK_MESH, WALK_B = (2, 2, 2), 8


def case_cfg(arch: str, remat: str = "none"):
    """The smoke config of ``arch``; ``"<arch>:kv<n>"`` with n KV heads
    (and its own name, so its initial state has a directory of its
    own)."""
    arch, _, kv = arch.partition(":kv")
    cfg = dataclasses.replace(tcfg.smoke(tcfg.get_config(arch)),
                              remat=remat)
    if kv:
        cfg = dataclasses.replace(cfg, n_kv_heads=int(kv),
                                  name=f"{cfg.name}-kv{kv}")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    return cfg


def _mesh(shape):
    pod, data, model = shape
    return make_host_mesh(data=data, model=model, pod=pod)


def _gather_objects(obj, world: int) -> list:
    import torch.distributed as dist
    every = [None] * world
    dist.all_gather_object(every, obj)
    return every


def _whole(state, cfg, mesh) -> dict:
    """Every leaf of ``state`` whole (each block all-gathered), numpy."""
    sh = dict(tree_paths(state_shards(cfg, mesh)))
    with use_mesh(mesh):
        return {k: (v if sh[k] is None else sh[k].gather(v)).numpy().copy()
                for k, v in tree_paths(state)}


def _train_case(tag: str, init_dir: str, world: int) -> dict:
    """The case's 3 steps on its mesh from the step-0 state: rank 0's
    metrics and whole state, whether every rank's whole state (its own
    replicated copies in it) equals rank 0's, every rank's moment block
    shapes, and deepseek's kept pairs at the first step's forward."""
    arch, shape, accum, remat = CASES[tag]
    cfg = case_cfg(arch, remat)
    mesh = _mesh(shape)
    mgr = CheckpointManager(os.path.join(init_dir, cfg.name), mesh=mesh,
                            shards=state_shards(cfg, mesh))
    state = mgr.restore(abstract_state(cfg, mesh), 0, device="cpu")[0]
    data = SyntheticLMData(cfg, B, S, seed=SEED, device="cpu",
                           shard=batch_shard(mesh),
                           shards=batch_shards(mesh), micro=accum)
    step = make_train_step(cfg, TrainConfig(opt=OPT, grad_accum=accum),
                           mesh)
    pairs = None
    if cfg.n_experts:
        local = train_local_config(cfg, mesh)
        with use_mesh(mesh, process_wide=True), torch.no_grad(), \
                moe_mod.record_dispatch() as log:
            loss_fn(state["params"], data.batch_at(0), local)
        pairs = _gather_objects(
            [(c["token"].numpy(), c["expert"].numpy(), c["capacity"])
             for c in log], world)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, data.batch_at(i))
        metrics.append({k: float(m[k])
                        for k in ("loss", "nll", "aux", "grad_norm")})
    whole = _whole(state, cfg, mesh)
    digests = _gather_objects({k: v.tobytes() for k, v in whole.items()},
                              world)
    shapes = _gather_objects({k: tuple(v.shape) for k, v in
                              tree_paths(state["opt"])}, world)
    return {"metrics": metrics, "whole": whole, "pairs": pairs,
            "equal": all(d == digests[0] for d in digests),
            "moment shapes": shapes, "mesh": mesh.sizes}


def _edges(mesh) -> dict:
    """The f / g edges and the logits' gather at model 2 against the
    unsharded products, and the vocab-sharded embedding and logits
    against the whole table: this rank's gradients and values, numpy."""
    n, r = mesh.sizes["model"], mesh.coord("model")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 8), generator=g)
    w1, w2 = torch.randn((8, 6), generator=g), torch.randn((6, 8),
                                                           generator=g)
    c1, c2 = torch.randn((4, 8), generator=g), torch.randn((4, 6),
                                                           generator=g)
    cols = slice(r * 6 // n, (r + 1) * 6 // n)    # w1's columns, w2's rows
    out = {}

    def grads(fn, *leaves):
        leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
        loss = fn(*leaves)
        return [v.numpy() for v in torch.autograd.grad(loss, leaves)]

    def mlp(x_, a, b, axis=None):
        h = torch.nn.functional.gelu(coll.tp_copy(x_, axis) @ a)
        return (coll.tp_reduce(h @ b, axis) * c1).sum()

    def gather(x_, a, axis=None):
        z = coll.tp_copy(x_, axis) @ a
        if axis is not None:
            z = coll.all_gather_cols(z, axis)
        return (z * c2).sum()

    with use_mesh(mesh):
        out["mlp"] = (grads(mlp, x, w1, w2),
                      grads(lambda x_, a, b: mlp(x_, a, b, "model"),
                            x, w1[:, cols], w2[cols]))
        out["gather"] = (grads(gather, x, w1),
                         grads(lambda x_, a: gather(x_, a, "model"),
                               x, w1[:, cols]))
        # the vocab-sharded table: lookup and tied logits, and its gradient
        cfg = case_cfg("qwen3-0.6b")
        local = train_local_config(cfg, mesh)
        V = cfg.vocab_size
        tok = torch.randn((V, cfg.d_model), generator=g)
        tokens = torch.randint(0, V, (2, 5), generator=g)
        hidden = torch.randn((2, 5, cfg.d_model), generator=g)
        cl = torch.randn((2, 5, V), generator=g)
        blk = slice(r * V // n, (r + 1) * V // n)

        def table(t, c):
            e = embed_tokens({"tok": t}, tokens, c)
            lg = logits_from_hidden({"tok": t}, hidden, c)
            return e, lg

        e_full, l_full = table(tok, cfg)
        e_loc, l_loc = table(tok[blk].contiguous(), local)
        out["table"] = (e_full.numpy(), e_loc.numpy(), l_full.numpy(),
                        l_loc.numpy())

        def table_loss(t, c):
            e, lg = table(t, c)
            return (e.square()).sum() + (lg * cl).sum()

        out["table grads"] = (grads(lambda t: table_loss(t, cfg), tok)[0][
            blk], grads(lambda t: table_loss(t, local), tok[blk])[0])
    return out


def _loop(ckpt: str) -> dict:
    """qwen3-0.6b through ``TrainLoop(mesh=)`` at (data 1, model 2): 2
    steps with a checkpoint after each, then a second loop to step 3,
    which resumes from the latest (rank 0's step, broadcast)."""
    cfg = case_cfg("qwen3-0.6b")
    mesh = make_host_mesh(model=2)

    def loop(total):
        return TrainLoop(
            cfg, LoopConfig(total_steps=total, ckpt_every=1, log_every=1,
                            train=TrainConfig(opt=OPT)),
            SyntheticLMData(cfg, B, S, seed=SEED, device="cpu",
                            shard=batch_shard(mesh),
                            shards=batch_shards(mesh)),
            CheckpointManager(ckpt, keep=5, mesh=mesh,
                              shards=state_shards(cfg, mesh)),
            make_initial_state(cfg, 0, "cpu", mesh=mesh), mesh=mesh)

    first = loop(2)
    first.run()
    second = loop(3)
    out = second.run()
    return {"first": first.history, "second": second.history,
            "step": out["step"]}


def two_ranks(rank: int, world: int, init_dir: str) -> dict:
    torch.set_num_threads(THREADS)
    res = {tag: _train_case(tag, init_dir, world) for tag, c in
           CASES.items() if c[1] == (1, 1, 2)}
    res["edges"] = _edges(make_host_mesh(model=2))
    res["loop"] = _loop(os.path.join(os.path.dirname(init_dir), "loop"))
    return res


def four_ranks(rank: int, world: int, init_dir: str) -> dict:
    torch.set_num_threads(THREADS)
    return {tag: _train_case(tag, init_dir, world) for tag, c in
            CASES.items() if np.prod(c[1]) == 4}


def eight_ranks(rank: int, world: int) -> dict:
    """The pre-flight walk of qwen3-0.6b's step on (pod 2, data 2,
    model 2) under remat full and grad_accum 2."""
    torch.set_num_threads(THREADS)
    cfg = case_cfg("qwen3-0.6b", "full")
    mesh = _mesh(WALK_MESH)
    t = TrainConfig(opt=OPT, grad_accum=2)
    args, _, _ = tspecs.train_specs(cfg, ShapeCell("t", S, WALK_B, "train"),
                                    mesh)
    rep = analyze_step(make_train_step(cfg, t, mesh), args=args, mesh=mesh,
                       dtype="float32")
    c = rep.character.collectives
    return {"axes": {k[0]: v for k, v in c.by_axes.items()},
            "edges": dict(c.by_edge), "dcn": c.dcn_wire_bytes,
            "kinds": dict(c.ops_by_kind), "render": rep.render(),
            "tp": tp_wire_bytes(cfg, mesh.sizes, WALK_B, S, t),
            "dp": dp_wire_bytes(cfg, mesh.sizes, t)}


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
    CASES = {CASES!r}
    OPT = OptConfig(lr={LR}, warmup_steps=0, total_steps=10)
    out = {{}}

    def case_cfg(arch, remat):
        arch, _, kv = arch.partition(":kv")
        cfg = dataclasses.replace(smoke(get_config(arch)), remat=remat)
        if kv:
            cfg = dataclasses.replace(cfg, n_kv_heads=int(kv),
                                      name=f"{{cfg.name}}-kv{{kv}}")
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=1.0)
        return cfg

    def initial(cfg):
        abstract = jax.eval_shape(make_initial_state(cfg))
        return CheckpointManager(os.path.join(init_dir, cfg.name)).restore(
            abstract, 0)[0]

    for tag, (arch, shape, accum, remat) in CASES.items():
        cfg = case_cfg(arch, remat)
        pod, data, model = shape
        if pod > 1:
            mesh = make_mesh(shape, ("pod", "data", "model"))
        else:
            mesh = make_mesh((data, model), ("data", "model"))
        cell = ShapeCell("t", S, B, "train")
        with sharding_context(mesh):
            _, in_sh, out_sh = specs_mod.train_specs(cfg, cell, mesh)
            with mesh_context(mesh):
                step = jax.jit(make_train_step(cfg, TrainConfig(
                    opt=OPT, grad_accum=accum)), in_shardings=in_sh,
                    out_shardings=out_sh)
                state = jax.device_put(initial(cfg), in_sh[0])
                batches = SyntheticLMData(cfg, B, S, seed=SEED)
                for i in range(STEPS):
                    state, m = step(state, jax.device_put(
                        batches.batch_at(i), in_sh[1]))
                    for k in ("loss", "nll", "aux", "grad_norm"):
                        out[f"{{tag}}/{{k}}{{i}}"] = np.asarray(m[k])
        for k, v in _flat(state).items():
            out[tag + "/" + k] = np.asarray(v)
        if tag == "qwen 2x2":
            CheckpointManager(ckpt_dir).save(state, STEPS)

    # the global dispatch's kept pairs at the first step (its semantics
    # are the mesh's, so one eager forward over the global batch shows
    # them)
    inner, slots = moe_mod._dispatch_combine, []
    def spy(xf, gates, eids, C, cfg):
        res = inner(xf, gates, eids, C, cfg)
        N = xf.shape[0]
        jax.debug.callback(lambda st: slots.append((np.asarray(st), C, N)),
                           res[1])
        return res
    moe_mod._dispatch_combine = spy
    moe = case_cfg("deepseek-v2-236b", "none")
    loss_fn(initial(moe)["params"],
            SyntheticLMData(moe, B, S, seed=SEED).batch_at(0), moe)
    jax.effects_barrier()
    for i, (st, C, N) in enumerate(slots):
        full = np.nonzero(st < N)[0]
        out[f"pairs{{i}}/token"] = st[full].astype(np.int64)
        out[f"pairs{{i}}/expert"] = full // C
        out[f"pairs{{i}}/capacity"] = np.asarray(C)
    np.savez(out_path, **out)
    print("RESULT ok")
""").format(B=B, S=S, SEED=SEED, STEPS=STEPS, LR=LR, CASES=CASES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess, started first, and the port's spawns
    meanwhile: {"ref", "two", "four", "eight", "ref_ckpt"}."""
    tmp = tmp_path_factory.mktemp("train_tp")
    init_dir, ref_ckpt = str(tmp / "init"), str(tmp / "ref_ckpt")
    for arch in ARCHS:
        cfg = case_cfg(arch)
        state = make_initial_state(cfg, 0, "cpu")()
        CheckpointManager(os.path.join(init_dir, cfg.name)).save(state, 0)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    ref_path = tmp / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(ref_path), init_dir,
         ref_ckpt], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    try:
        two = spawn(two_ranks, 2, device="cpu", args=(init_dir,),
                    timeout=400)
        four = spawn(four_ranks, 4, device="cpu", args=(init_dir,),
                     timeout=400)
        eight = spawn(eight_ranks, 8, device="cpu", timeout=400)
        stdout, stderr = proc.communicate(timeout=420)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "RESULT ok" in stdout, (stdout[-2000:], stderr[-3000:])
    with np.load(ref_path) as f:
        ref = {k: f[k] for k in f.files}
    return {"ref": ref, "two": two, "four": four, "eight": eight,
            "ref_ckpt": ref_ckpt}


def _got(runs, tag: str) -> dict:
    world = int(np.prod(CASES[tag][1]))
    return runs[{2: "two", 4: "four"}[world]][tag]


def _bars(ref: dict, tag: str, key: str):
    """(parameter, mu, nu) tolerances of leaf ``key`` after STEPS steps,
    element by element (the module docstring)."""
    b1, b2 = OPT.betas
    nu = ref[f"{tag}/opt/nu/{key}"].astype(np.float64)
    big = np.sqrt(nu / ((1 - b2) * b2))
    atol = GRAD_ATOL * max(1.0, float(big.max()) if big.size else 1.0)
    rms = np.maximum(np.sqrt(nu / (1 - b2 ** STEPS)), 1e-30)
    dg = GRAD_RTOL * big + atol
    step = np.minimum(2.0, 2 * dg / rms)
    return (LR * STEPS * step, (1 - b1) * (1 + b1) * dg,
            2 * (1 - b2) * (1 + b2) * big * dg)


def _within(got, want, tol, what):
    err = np.abs(got.astype(np.float64) - want)
    bad = err > tol
    assert not bad.any(), (what, int(bad.sum()), float(err[bad].max()),
                           float(np.broadcast_to(tol, err.shape)[bad].min()))


@pytest.mark.parametrize("tag", list(CASES))
def test_train_step_matches_reference(runs, tag):
    got, ref = _got(runs, tag), runs["ref"]
    for i, m in enumerate(got["metrics"]):
        for k in ("loss", "nll", "aux", "grad_norm"):
            np.testing.assert_allclose(m[k], float(ref[f"{tag}/{k}{i}"]),
                                       rtol=RTOL, atol=1e-12,
                                       err_msg=f"{k} step {i}")
    arch = CASES[tag][0]
    assert (got["metrics"][0]["aux"] > 0) == bool(case_cfg(arch).n_experts)
    for k, v in got["whole"].items():
        want = ref[f"{tag}/{k}"]
        assert v.shape == want.shape, (k, v.shape, want.shape)
        if k == "opt/step":
            assert int(v) == int(want) == STEPS
            continue
        want = want.astype(np.float64)
        part, key = k.split("/", 1)
        if part == "opt":
            which, key = key.split("/", 1)
            tol = _bars(ref, tag, key)[1 if which == "mu" else 2]
        else:
            tol = _bars(ref, tag, key)[0]
        _within(v, want, RTOL * np.abs(want) + tol, k)
    assert got["equal"]


@pytest.mark.parametrize("tag", [t for t in CASES if CASES[t][1] != (
    1, 1, 2)] + ["qwen 1x2"])
def test_moment_blocks_are_zero1_blocks_of_model_blocks(runs, tag):
    got = _got(runs, tag)
    arch = CASES[tag][0]
    cfg, sizes = case_cfg(arch), got["mesh"]
    whole = {k: tuple(v.shape) for k, v in
             tree_paths(abstract_state(cfg)["params"])}
    for r, shapes in enumerate(got["moment shapes"]):
        mesh = Mesh(tuple(sizes), tuple(sizes.values()), rank=r)
        sh = dict(tree_paths(state_shards(cfg, mesh)))
        for k, shape in shapes.items():
            if k == "step":
                continue
            key = "opt/" + k
            full = whole[k.split("/", 1)[1]]
            want = full if sh[key] is None else sh[key].shape(full)
            assert shape == tuple(want), (r, k, shape, want)
            if sizes.get("data", 1) > 1 and sizes["model"] > 1 and k in (
                    "mu/segments/0/b0/mixer/wq",):
                # both axes divide wq: a quarter of the whole moment
                assert np.prod(shape) * 4 == np.prod(full)


@pytest.mark.parametrize("tag", ["deepseek 1x2", "deepseek 2x2"])
def test_moe_kept_pairs_match_reference(runs, tag):
    got, ref = _got(runs, tag), runs["ref"]
    ranks = got["pairs"]
    n_calls = len(ranks[0])
    assert n_calls == sum(k.endswith("/capacity") for k in ref) >= 1
    model = CASES[tag][1][2]
    for i in range(n_calls):
        want = set(zip(ref[f"pairs{i}/token"].tolist(),
                       ref[f"pairs{i}/expert"].tolist()))
        per = [set(zip(t.tolist(), e.tolist()))
               for t, e, _ in (r[i] for r in ranks)]
        assert all(r[i][2] == int(ref[f"pairs{i}/capacity"]) for r in ranks)
        # the ranks of one model row keep the same pairs
        for r in range(0, len(per), model):
            assert all(p == per[r] for p in per[r:r + model])
        rows = per[::model]
        union = set().union(*rows)
        assert sum(len(p) for p in rows) == len(union) == len(want)
        assert union == want
        assert len(want) < B * S * case_cfg("deepseek-v2-236b").moe_top_k


@pytest.mark.parametrize("what", ["mlp", "gather"])
def test_tp_edges_give_unsharded_gradients(runs, what):
    full, mine = runs["two"]["edges"][what]
    dx_full, *dw_full = full
    dx, *dw = mine
    np.testing.assert_allclose(dx, dx_full, rtol=EDGE_RTOL, atol=EDGE_ATOL)
    r, n = 0, 2                      # rank 0's blocks
    cols = slice(r * 6 // n, (r + 1) * 6 // n)
    np.testing.assert_allclose(dw[0], dw_full[0][:, cols], rtol=EDGE_RTOL,
                               atol=EDGE_ATOL)
    if what == "mlp":
        np.testing.assert_allclose(dw[1], dw_full[1][cols], rtol=EDGE_RTOL,
                                   atol=EDGE_ATOL)


def test_vocab_sharded_embedding_and_logits(runs):
    e_full, e_loc, l_full, l_loc = runs["two"]["edges"]["table"]
    assert np.array_equal(e_full, e_loc)
    np.testing.assert_allclose(l_loc, l_full, rtol=EDGE_RTOL, atol=EDGE_ATOL)
    g_full, g_loc = runs["two"]["edges"]["table grads"]
    np.testing.assert_allclose(g_loc, g_full, rtol=EDGE_RTOL, atol=EDGE_ATOL)


def test_preflight_walk_on_pod_data_model(runs):
    got = runs["eight"]
    assert sorted(got["axes"]) == ["data", "model", "pod"]
    assert got["dcn"] > 0 and got["dcn"] == pytest.approx(got["axes"]["pod"],
                                                          rel=1e-12)
    assert "model (ici)" in got["render"] and "pod (dcn)" in got["render"]
    np.testing.assert_allclose(got["axes"]["model"], got["tp"]["model"],
                               rtol=1e-12)
    for edge in ("tp_copy", "tp_reduce", "tp_gather"):
        np.testing.assert_allclose(got["edges"][edge], got["tp"][edge],
                                   rtol=1e-12, err_msg=edge)
    for axis in ("data", "pod"):
        np.testing.assert_allclose(got["axes"][axis], got["dp"][axis],
                                   rtol=1e-12, err_msg=axis)


def test_train_loop_on_a_model_axis_resumes(runs):
    """TrainLoop(mesh=) at (1, 2) from the seed-0 state gives the
    ``qwen 1x2`` case's losses bit for bit (the same state, rows and
    step), the third after a restart from its checkpoint."""
    loop = runs["two"]["loop"]
    want = [m["loss"] for m in runs["two"]["qwen 1x2"]["metrics"]]
    assert loop["step"] == 3
    assert [h["step"] for h in loop["first"] + loop["second"]] == [1, 2, 3]
    assert [h["loss"] for h in loop["first"] + loop["second"]] == want


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_recurrent_mixers_refused_at_model_2(arch):
    cfg = tcfg.smoke(tcfg.get_config(arch))
    with pytest.raises(NotImplementedError, match="item 21"):
        make_train_step(cfg, mesh=Mesh(("data", "model"), (1, 2)))
    make_train_step(cfg, mesh=Mesh(("data", "model"), (1, 1)))


def test_ring_overlap_refused_under_grad():
    h = torch.randn((2, 4), requires_grad=True)
    w = torch.randn((4, 3))
    with pytest.raises(NotImplementedError, match="item 21"):
        coll.row_parallel_matmul(h, w, "model", "ring")


@pytest.mark.parametrize("arch,tp", [("qwen3-0.6b", 2), ("qwen3-0.6b", 4),
                                     ("qwen3-0.6b:kv1", 2)])
def test_serving_and_training_share_one_local_config(arch, tp):
    cfg = case_cfg(arch)
    mesh = Mesh(("data", "model"), (1, tp))
    train = train_local_config(cfg, mesh)
    if cfg.n_kv_heads % tp == 0:   # serving's gates pass: one local config
        assert train == serve_shard.tp_local_config(cfg, tp) == \
            shd.tp_local_config(cfg, tp)
        assert not layout_of(train).kv_sliced
    else:       # KV 2 at tp 4, or MQA: replicated, one KV head a rank
        assert serve_shard.tp_sharding_error(cfg, tp) is not None
        assert train.layout == LocalLayout(kv_sliced=True)
        assert (train.n_heads, train.n_kv_heads) == (cfg.n_heads // tp, 1)
        # every field but the layout as serving's, KV heads aside
        plain = ModelConfig(**{f.name: getattr(train, f.name)
                               for f in dataclasses.fields(ModelConfig)})
        assert dataclasses.asdict(plain) == dataclasses.asdict(
            dataclasses.replace(shd.tp_local_config(cfg, tp),
                                n_kv_heads=1))
