"""Elastic restore of a tensor-parallel train state, the counterpart of
``tests/test_dryrun_small.py::test_elastic_restore_across_mesh_shapes``:
qwen3-0.6b smoke (float32) trained one step on (data 4, model 2) and
saved there (every block gathered whole, rank 0 writes), then restored
on (data 2, model 4), where its 2 KV heads do not divide the axis (the
rules replicate them and each rank slices the one its query head
reads), and on one device; and across packages.  Eight gloo ranks in one
spawn, torch on two intra-op threads.

Checks:

* every parameter and moment leaf restored on (2, 4) is its ``Block``
  of the file's whole leaf, bit for bit, of the shape ``abstract_state``
  gives that rank; restored on (1, 1), the file's and rank 0's gathered
  state, bit for bit;
* the second step from the restored state on (2, 4) against the (4, 2)
  run's second step: loss and grad norm within rtol 1e-5 (the same
  float32 terms summed in another order);
* the model-sharded save restores in ``repro``'s ``CheckpointManager``
  bit for bit, and ``repro``'s save (of its GSPMD state on (data 2,
  model 2)) restores on the port's (2, 2) ranks, each its blocks, bit
  for bit.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

import repro_torch.configs as tcfg
from repro_torch.models.params import tree_paths
from repro_torch.parallel.mesh import (Mesh, batch_shard, batch_shards,
                                       make_host_mesh, spawn, use_mesh)
from repro_torch.train import (CheckpointManager, OptConfig,
                               SyntheticLMData, TrainConfig,
                               make_initial_state, make_train_step)
from repro_torch.train.loop import abstract_state, state_shards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, SEED = 4, 16, 3
OPT = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
SAVE, RESTORE = (4, 2), (2, 4)
THREADS = 2


def dense_cfg():
    return tcfg.smoke(tcfg.get_config("qwen3-0.6b"))


def _np(tree) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tree_paths(tree)}


def _metrics(m) -> dict:
    return {k: float(m[k]) for k in ("loss", "grad_norm")}


def eight_ranks(rank: int, world: int, ckpt: str) -> dict:
    """(4, 2): one step, the save of step 1, the second step; (2, 4): the
    restore of step 1, its leaves against the file's blocks, the second
    step from it."""
    torch.set_num_threads(THREADS)
    cfg = dense_cfg()
    res = {}
    steps = {}
    for shape in (SAVE, RESTORE):
        mesh = make_host_mesh(data=shape[0], model=shape[1])
        shards = state_shards(cfg, mesh)
        mgr = CheckpointManager(ckpt, mesh=mesh, shards=shards)
        data = SyntheticLMData(cfg, B, S, seed=SEED, device="cpu",
                               shard=batch_shard(mesh),
                               shards=batch_shards(mesh))
        step = make_train_step(cfg, TrainConfig(opt=OPT), mesh)
        if shape == SAVE:
            state = make_initial_state(cfg, 0, "cpu", mesh=mesh)()
            state, _ = step(state, data.batch_at(0))
            mgr.save(state, 1)
            sh = dict(tree_paths(shards))
            with use_mesh(mesh):
                res["saved"] = {k: (v if sh[k] is None else sh[k].gather(v)
                                    ).numpy().copy()
                                for k, v in tree_paths(state)}
        else:
            abstract = abstract_state(cfg, mesh)
            state, manifest = mgr.restore(abstract, 1, device="cpu")
            sh = dict(tree_paths(shards))
            want = dict(tree_paths(abstract))
            with np.load(os.path.join(mgr.step_dir(1), "arrays.npz")) as f:
                disk = {k: f[k] for k in f.files}
            res["restored equal"] = all(
                tuple(v.shape) == tuple(want[k].shape) and np.array_equal(
                    v.numpy(), disk[k] if sh[k] is None else
                    sh[k].take(torch.from_numpy(disk[k])).numpy())
                for k, v in tree_paths(state))
            res["kv replicated"] = sh["params/segments/0/b0/mixer/wk"] \
                is None or all(p[1] != "model" for p in
                               sh["params/segments/0/b0/mixer/wk"].pieces)
            res["moment pieces"] = sh["opt/mu/segments/0/b0/mixer/wq"].pieces
        _, m = step(state, data.batch_at(1))
        steps[shape] = _metrics(m)
    res["steps"] = steps
    return res


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from repro.configs import get_config, smoke
    from repro.models import model_param_defs
    from repro.parallel import sharding as shd
    from repro.parallel.mesh import make_mesh
    from repro.train import CheckpointManager
    from repro.train.checkpoint import _flat
    from repro.train.loop import make_initial_state
    from repro.train.optimizer import opt_state_shardings

    port_ckpt, ref_ckpt, out_path = sys.argv[1:4]
    cfg = smoke(get_config("qwen3-0.6b"))
    defs = model_param_defs(cfg)
    abstract = jax.eval_shape(make_initial_state(cfg))
    out = {}
    # the port's (4, 2) save, restored onto repro's (2, 4) mesh
    mesh = make_mesh((2, 4), ("data", "model"))
    sh = {"params": shd.tree_shardings(defs, mesh),
          "opt": opt_state_shardings(defs, mesh)}
    state, manifest = CheckpointManager(port_ckpt).restore(
        abstract, 1, shardings=sh)
    for k, v in _flat(state).items():
        out["port/" + k] = np.asarray(v)
    out["port/step"] = np.asarray(manifest["step"])
    # repro's own save of a (2, 2)-sharded state, for the port
    mesh = make_mesh((2, 2), ("data", "model"))
    sh = {"params": shd.tree_shardings(defs, mesh),
          "opt": opt_state_shardings(defs, mesh)}
    state = jax.tree.map(jax.device_put, make_initial_state(cfg, seed=5)(),
                         sh)
    state = jax.tree.map(lambda x: x + 1 if x.dtype != np.int32 else x + 3,
                         state)
    CheckpointManager(ref_ckpt).save(state, 7)
    for k, v in _flat(state).items():
        out["ref/" + k] = np.asarray(v)
    np.savez(out_path, **out)
    print("RESULT ok")
""")


def test_elastic_restore_and_cross_packages(tmp_path):
    ckpt, ref_ckpt = str(tmp_path / "ckpt"), str(tmp_path / "ref_ckpt")
    got = spawn(eight_ranks, 8, device="cpu", args=(ckpt,), timeout=400)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out_path = tmp_path / "ref.npz"
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, ckpt, ref_ckpt, str(out_path)],
        capture_output=True, text=True, env=env, timeout=400)
    assert "RESULT ok" in proc.stdout, (proc.stdout[-2000:],
                                        proc.stderr[-3000:])
    cfg = dense_cfg()
    # (2, 4): blocks of the file's leaves, KV heads replicated there
    assert got["restored equal"] and got["kv replicated"]
    assert [p[1] for p in got["moment pieces"]] == ["data", "model"]
    a, b = got["steps"][SAVE], got["steps"][RESTORE]
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    # (1, 1): whole, bit for bit against the file and the gathered state
    mgr = CheckpointManager(ckpt)
    state, manifest = mgr.restore(abstract_state(cfg), 1, device="cpu")
    assert int(manifest["step"]) == 1
    flat = _np(state)
    with np.load(os.path.join(mgr.step_dir(1), "arrays.npz")) as f:
        assert sorted(f.files) == sorted(flat)
        for k, v in flat.items():
            assert np.array_equal(v, f[k]), k
            assert np.array_equal(v, got["saved"][k]), k
    # across packages: repro restored the port's save bit for bit
    with np.load(out_path) as f:
        ref = {k: f[k] for k in f.files}
    assert int(ref["port/step"]) == 1
    for k, v in flat.items():
        assert np.array_equal(ref["port/" + k], v), k
    # and the port restores repro's save on (2, 2), each rank its blocks
    for r in range(4):
        mesh = Mesh(("data", "model"), (2, 2), rank=r)
        shards = state_shards(cfg, mesh)
        restored, manifest = CheckpointManager(
            ref_ckpt, mesh=mesh, shards=shards).restore(
            abstract_state(cfg, mesh), 7, device="cpu")
        sh = dict(tree_paths(shards))
        for k, v in tree_paths(restored):
            whole = ref["ref/" + k]
            want = whole if sh[k] is None else sh[k].take(
                torch.from_numpy(whole)).numpy()
            assert np.array_equal(v.numpy(), want), (r, k)
        assert sh["params/segments/0/b0/mixer/wq"].pieces == (
            (2, "model", r % 2, 2),)
