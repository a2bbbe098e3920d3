"""The data-local MoE dispatch in training: the port's ``moe_dispatch=
"local"`` fed each data shard's rows, against the JAX package's under a
(data 2, model 1) mesh, in a subprocess with 8 forced host devices (the
main test process keeps its single-device view), deepseek-v2-236b
smoke, float32.

Under the reference's mesh the local dispatch groups the batch by its
data shard (G 2, each group's capacity from its own tokens); under the
port's explicit SPMD a rank holds one shard, its one group.  So the
reference's logits are the port's per-shard logits side by side, and
the reference's nll (a mean over the batch) and its gradient are the
mean of the port's per-shard ones.  The aux loss is the reference's
formula over the tokens a call sees: the reference's is over the global
batch, which the port's full-batch loss gives (a rank's own aux against
the global one is ROADMAP queue 1 item 19).

Tolerances: float32 on both sides: values rtol 1e-4 / atol 1e-5 (the
gradients' atol in units of the leaf's largest where that exceeds 1, as
in test_torch_train_grads.py), losses rtol 1e-5.
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
from repro_torch.models import loss_fn, model_param_defs
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.models.transformer import forward_full

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, SHARDS = 4, 16, 2


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: under the suite's six workers torch's
    default (one thread a core in every worker) oversubscribes the cores,
    and these smoke-sized steps then spend their wall waiting for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, jax, numpy as np
    from repro.configs import get_config, smoke
    from repro.models import init_params, loss_fn
    from repro.models.transformer import forward_full
    from repro.parallel.mesh import make_host_mesh, mesh_context
    from repro.parallel.sharding import mesh_sizes, sharding_context
    from repro.train import SyntheticLMData

    cfg = dataclasses.replace(smoke(get_config("deepseek-v2-236b")),
                              moe_dispatch="local")
    mesh = make_host_mesh(data=2, model=1)
    params = init_params(cfg, jax.random.key(0))
    batch = SyntheticLMData(cfg, {B}, {S}, seed=3).batch_at(0)
    def nll(p, b):        # one program: nll, its gradient, the rest
        loss, met = loss_fn(p, b, cfg)
        return met["nll"], (loss, met["aux"],
                            forward_full(p, cfg, b["tokens"])[0])

    with sharding_context(mesh), mesh_context(mesh):
        assert mesh_sizes() == {{"data": 2, "model": 1}}
        (nll_v, (loss, aux, logits)), g_nll = jax.jit(jax.value_and_grad(
            nll, has_aux=True))(params, batch)
    out = {{"loss": loss, "nll": nll_v, "aux": aux,
           "logits": logits, "tokens": batch["tokens"],
           "labels": batch["labels"]}}
    for i, (p, gn) in enumerate(zip(jax.tree.leaves(params),
                                    jax.tree.leaves(g_nll))):
        out[f"param{{i}}"], out[f"grad{{i}}"] = p, gn
    np.savez(sys.argv[1], **{{k: np.asarray(v) for k, v in out.items()}})
    print("RESULT", len(jax.tree.leaves(params)))
""").format(B=B, S=S)


def _reference(path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                       capture_output=True, text=True, env=env, timeout=420)
    assert "RESULT" in r.stdout, (r.stdout[-2000:], r.stderr[-3000:])
    return np.load(path), int(r.stdout.split("RESULT")[1])


def _close(got, want, leaf_scale=False, err_msg=""):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if leaf_scale else 1.0
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=1e-4, atol=1e-5 * scale,
                               err_msg=err_msg)


def test_local_dispatch_matches_reference_data_mesh(tmp_path):
    ref, n_leaves = _reference(tmp_path / "ref.npz")
    cfg = dataclasses.replace(tcfg.smoke(tcfg.get_config("deepseek-v2-236b")),
                              moe_dispatch="local")
    params = tree_unflatten(model_param_defs(cfg), [torch.from_numpy(ref[f"param{i}"])
                                   for i in range(n_leaves)])
    tokens = torch.from_numpy(ref["tokens"])
    labels = torch.from_numpy(ref["labels"])
    rows = B // SHARDS
    logits, nlls, grads = [], [], []
    for s in range(SHARDS):
        shard = {"tokens": tokens[s * rows:(s + 1) * rows],
                 "labels": labels[s * rows:(s + 1) * rows]}
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        _, met = loss_fn(tree_unflatten(params, leaves), shard, cfg)
        grads.append(torch.autograd.grad(met["nll"], leaves))
        nlls.append(met["nll"].detach())
        with torch.no_grad():
            logits.append(forward_full(params, cfg, shard["tokens"])[0])
    _close(torch.cat(logits), ref["logits"], err_msg="logits")
    np.testing.assert_allclose(float(sum(nlls)) / SHARDS, float(ref["nll"]),
                               rtol=1e-5)
    for i in range(n_leaves):
        _close(sum(g[i] for g in grads) / SHARDS, ref[f"grad{i}"],
               leaf_scale=True, err_msg=f"leaf {i}")
    # the aux term is the reference's formula: over the global batch the
    # port's full-batch loss gives the reference's aux (its nll differs:
    # one group of 64 tokens has another capacity than two of 32), and
    # the shards' mean nll plus it the reference's loss
    with torch.no_grad():
        _, met = loss_fn(params, {"tokens": tokens, "labels": labels}, cfg)
    assert float(met["aux"]) > 0
    assert abs(float(met["nll"]) - float(ref["nll"])) > 1e-4   # groups show
    np.testing.assert_allclose(float(met["aux"]), float(ref["aux"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(sum(nlls)) / SHARDS + float(met["aux"]),
                               float(ref["loss"]), rtol=1e-5)
