"""The port's optimizer, schedules, data, microbatching, checkpoints and
train loop against the JAX package's ``train/``, on qwen3-0.6b smoke
(float32) weights from ``repro.models.init_params`` carried across by
``repro_torch.bridge``.

Tolerances:
* ``adamw_update`` on the same numpy gradients (clipping active, three
  steps of bias correction): parameters, mu and nu within rtol 1e-6,
  and an atol of 1e-6 of the terms' size where they cancel (lr for a
  parameter, the leaf's largest moment for mu and nu);
* ``lr_at``: rtol 1e-6 (both float32; XLA's cos against ATen's);
* ``batch_at``: bit for bit (bf16 embeddings as their 16-bit patterns);
* microbatched gradients: the reference's own bar, rtol 1e-4 atol 1e-5
  (against the full batch and against the reference's microbatching);
  losses rtol 1e-5;
* a checkpoint written by one package restores in the other, and the
  next step's loss equals the writer's within rtol 1e-5 (float32 op
  order);
* the 10-step TrainLoop history: step 1 within rtol 1e-5; later steps
  within the AdamW sign bound derived in
  :func:`test_train_loop_history_matches_reference`.
"""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models as jm
import repro.train as jt
from repro.train import optimizer as jopt
from repro.train import step as jstep
import repro_torch.configs as tcfg
import repro_torch.train as tt
from repro_torch import bridge
from repro_torch.models.params import tree_leaves, tree_paths
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.train.loop import abstract_state

ARCH = "qwen3-0.6b"


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: under the suite's six workers torch's
    default (one thread a core in every worker) oversubscribes the cores,
    and these smoke-sized steps then spend their wall waiting for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _keep_sigterm():
    """TrainLoop installs a SIGTERM handler; give the worker its own
    back."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


def _cfgs(**changes):
    return (dataclasses.replace(jcfg.smoke(jcfg.get_config(ARCH)), **changes),
            dataclasses.replace(tcfg.smoke(tcfg.get_config(ARCH)), **changes))


def _params(jc):
    tree = jax.tree.map(np.asarray, jm.init_params(jc, jax.random.key(0)))
    return jax.tree.map(jnp.asarray, tree), bridge.to_torch(tree,
                                                            device="cpu")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def test_adamw_update_matches_reference():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    oc = dict(lr=3e-3, warmup_steps=2, total_steps=10, clip_norm=0.5)
    jst, tst = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    jupdate = jax.jit(jopt.adamw_update, static_argnums=3)
    rng = np.random.default_rng(4)
    for step in range(3):
        grads = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32),
            jax.tree.map(np.asarray, jp))
        jp, jst, jm_ = jupdate(
            jp, jax.tree.map(jnp.asarray, grads), jst,
            jopt.OptConfig(**oc))
        tp, tst, tm_ = topt.adamw_update(
            tp, bridge.to_torch(grads, device="cpu"), tst,
            topt.OptConfig(**oc))
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                       rtol=1e-6)
        assert float(tm_["grad_norm"]) > oc["clip_norm"]     # clipping on
        for name, tree_t, tree_j in (("p", tp, jp),
                                     ("mu", tst["mu"], jst["mu"]),
                                     ("nu", tst["nu"], jst["nu"])):
            for (path, a), b in zip(tree_paths(tree_t),
                                    jax.tree.leaves(tree_j)):
                b = _np(b)
                # where a sum's terms cancel, the result keeps their
                # absolute rounding: p - lr delta has terms of ~lr (|delta|
                # ~1), a moment's are at most the leaf's largest value
                scale = oc["lr"] if name == "p" else np.abs(b).max()
                np.testing.assert_allclose(
                    _np(a), b, rtol=1e-6, atol=1e-6 * scale,
                    err_msg=f"step {step}: {name} {path}")
    # decoupled decay on matrices only: a norm scale (1-d) moved by the
    # update alone
    assert tp["final_norm"]["scale"].dim() == 1


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_lr_at_matches_reference(schedule):
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=0, total_steps=37,
                    wsd_decay_frac=0.3, min_lr_ratio=0.05)):
        jo = jopt.OptConfig(schedule=schedule, **kw)
        to = topt.OptConfig(schedule=schedule, **kw)
        for s in range(0, 121, 3):
            got = topt.lr_at(torch.tensor(s, dtype=torch.int32), to)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(jopt.lr_at(
                jnp.int32(s), jo)), rtol=1e-6, err_msg=f"{schedule} {s}")
    if schedule == "wsd":       # the reference test's shape
        oc = topt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            schedule="wsd", wsd_decay_frac=0.2,
                            min_lr_ratio=0.1)
        assert float(topt.lr_at(5, oc)) == pytest.approx(0.5)
        assert float(topt.lr_at(50, oc)) == pytest.approx(1.0)
        assert 0.1 < float(topt.lr_at(90, oc)) < 1.0
        assert float(topt.lr_at(100, oc)) == pytest.approx(0.1)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-small",
                                  "llama-3.2-vision-90b"])
def test_batch_at_bit_equal(arch):
    """Tokens, labels and (in the model dtype bf16) the encoder frames /
    image embeddings, equal to the reference's draw bit for bit."""
    jc = dataclasses.replace(jcfg.smoke(jcfg.get_config(arch)),
                             dtype="bfloat16")
    tc = dataclasses.replace(tcfg.smoke(tcfg.get_config(arch)),
                             dtype="bfloat16")
    for step in (0, 7):
        want = jt.SyntheticLMData(jc, 3, 11, seed=99).batch_at(step)
        got = tt.SyntheticLMData(tc, 3, 11, seed=99,
                                 device="cpu").batch_at(step)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            w = np.asarray(want[k])
            if v.dtype == torch.bfloat16:
                assert k in ("enc_embeds", "img_embeds")
                np.testing.assert_array_equal(
                    v.view(torch.int16).numpy(), w.view(np.int16))
            else:
                assert v.dtype == torch.int32
                np.testing.assert_array_equal(v.numpy(), w)
    a = tt.SyntheticLMData(tc, 3, 11, seed=99, device="cpu")
    assert not torch.equal(a.batch_at(12)["tokens"],
                           a.batch_at(13)["tokens"])


def test_grad_microbatched_matches_full_batch_and_reference():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    jb = jt.SyntheticLMData(jc, 8, 16, seed=3).batch_at(0)
    tb = tt.SyntheticLMData(tc, 8, 16, seed=3, device="cpu").batch_at(0)
    lm, gm, mm = tstep._grad_microbatched(tp, tb, tc, 4)
    lf, _, gf = tstep.value_and_grad(tp, tb, tc)
    jl, jg, _ = jstep._grad_microbatched(jp, jb, jc, 4)
    assert float(lm) == pytest.approx(float(lf), rel=1e-5)
    assert float(lm) == pytest.approx(float(jl), rel=1e-5)
    assert set(mm) == {"nll", "aux"}
    for a, b, c in zip(tree_leaves(gm), tree_leaves(gf),
                       jax.tree.leaves(jg)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_np(a), _np(c), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        tstep._grad_microbatched(tp, tb, tc, 3)
    # bf16 compression: the reference's rounding, bit for bit
    comp = tstep.compress_bf16(gm)
    want = jstep.compress_bf16(jax.tree.map(jnp.asarray,
                                            [_np(x) for x in
                                             tree_leaves(gm)]))
    for a, b in zip(tree_leaves(comp), want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16))


_OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)


def test_checkpoint_crosses_packages(tmp_path):
    """A float32 checkpoint written by either package restores in the
    other, and the next step's loss there equals the writer's."""
    jc, tc = _cfgs()
    jstep_fn = jax.jit(jstep.make_train_step(
        jc, jstep.TrainConfig(opt=jopt.OptConfig(**_OPT))))
    tstep_fn = tstep.make_train_step(
        tc, tstep.TrainConfig(opt=topt.OptConfig(**_OPT)))
    jb = [jt.SyntheticLMData(jc, 2, 16, seed=8).batch_at(i) for i in (0, 1)]
    tb = [tt.SyntheticLMData(tc, 2, 16, seed=8, device="cpu").batch_at(i)
          for i in (0, 1)]
    init = jt.make_initial_state(jc, 0)
    # reference writes, the port restores
    js, _ = jstep_fn(init(), jb[0])
    jt.CheckpointManager(str(tmp_path / "ref")).save(js, 1)
    _, jnext = jstep_fn(js, jb[1])
    ts, manifest = tt.CheckpointManager(str(tmp_path / "ref")).restore(
        abstract_state(tc), device="cpu")
    assert manifest["step"] == 1 and int(ts["opt"]["step"]) == 1
    _, tnext = tstep_fn(ts, tb[1])
    assert float(tnext["loss"]) == pytest.approx(float(jnext["loss"]),
                                                 rel=1e-5)
    # the port writes, the reference restores
    ts0 = bridge.to_torch(jax.tree.map(np.asarray, init()), device="cpu")
    ts1, _ = tstep_fn(ts0, tb[0])
    tt.CheckpointManager(str(tmp_path / "port")).save(ts1, 1)
    _, tnext = tstep_fn(ts1, tb[1])
    js1, manifest = jt.CheckpointManager(str(tmp_path / "port")).restore(
        jax.eval_shape(init))
    assert manifest["step"] == 1
    _, jnext = jstep_fn(js1, jb[1])
    assert float(jnext["loss"]) == pytest.approx(float(tnext["loss"]),
                                                 rel=1e-5)
    assert os.path.exists(tmp_path / "port" / "step_0000000001" /
                          "arrays.npz")


def test_train_loop_history_matches_reference(tmp_path):
    """10 TrainLoop steps of each package from the same initial state on
    the same batches.

    Step 1 computes the same loss on the same weights: rtol 1e-5.  Later
    steps: AdamW's first update moves every parameter by about lr times
    the sign of its gradient, so an element whose gradient the two
    packages cannot agree on in sign (|g| under the gradients' agreement
    bar delta = 1e-5, test_torch_train_grads.py) may move 2 lr apart a
    step.  To first order the loss at step k then differs by at most
    the sum over those elements of |dL/dp| (< delta) times their
    distance (<= 2 lr (k - 1)): n_small * delta * 2 lr (k - 1), n_small
    counted here from the reference's step-1 gradients, on top of step
    1's rtol 1e-5 of the loss."""
    jc, tc = _cfgs()
    steps, lr = 10, 1e-2
    opt = dict(lr=lr, warmup_steps=0, total_steps=steps)
    data = dict(batch=4, seq=32, seed=11)
    jloop = jt.TrainLoop(
        jc, jt.LoopConfig(total_steps=steps, ckpt_every=100, log_every=1,
                          train=jt.TrainConfig(opt=jt.OptConfig(**opt))),
        jt.SyntheticLMData(jc, **data),
        jt.CheckpointManager(str(tmp_path / "j")),
        jt.make_initial_state(jc, 0))
    jloop.run()
    init = jax.tree.map(np.asarray, jt.make_initial_state(jc, 0)())
    tloop = tt.TrainLoop(
        tc, tt.LoopConfig(total_steps=steps, ckpt_every=100, log_every=1,
                          train=tt.TrainConfig(opt=tt.OptConfig(**opt))),
        tt.SyntheticLMData(tc, device="cpu", **data),
        tt.CheckpointManager(str(tmp_path / "t")),
        lambda: bridge.to_torch(init, device="cpu"))
    tloop.run()
    want = [h["loss"] for h in jloop.history]
    got = [h["loss"] for h in tloop.history]
    assert [h["step"] for h in tloop.history] == list(range(1, steps + 1))
    assert got[-1] < got[0] - 0.5
    g1 = jax.grad(lambda p: jm.loss_fn(
        p, jt.SyntheticLMData(jc, **data).batch_at(0), jc)[0])(init["params"])
    delta = 1e-5
    n_small = sum(int((np.abs(np.asarray(g)) < delta).sum())
                  for g in jax.tree.leaves(g1))
    for k, (a, b) in enumerate(zip(got, want), start=1):
        tol = 1e-5 * abs(b) + n_small * delta * 2 * lr * (k - 1)
        assert abs(a - b) <= tol, (k, a, b, tol, n_small)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_zero1_specs_match_reference(arch):
    """The moments' ZeRO-1 specs (the parameter's spec plus ``data`` on
    its largest free divisible dim) on several mesh shapes, leaf for
    leaf against the reference's PartitionSpecs."""
    import types
    import repro.models as jmodels
    import repro_torch.models as tmodels
    jdefs = jmodels.model_param_defs(jcfg.get_config(arch))
    tdefs = tmodels.model_param_defs(tcfg.get_config(arch))
    is_def = lambda x: hasattr(x, "logical")                 # noqa: E731
    for shape in ((4, 2), (2, 4), (8, 1), (1, 1)):
        mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                     devices=np.empty(shape))
        want = [tuple(jopt.zero1_spec(d, mesh)) for d in
                jax.tree.leaves(jdefs, is_leaf=is_def)]
        got = topt.opt_state_shardings(tdefs, dict(zip(("data", "model"),
                                                       shape)))
        assert got["step"] == ()
        assert _spec_leaves(got["mu"]) == want, shape


def _spec_leaves(tree):
    """A spec tree's specs in leaf order (a spec is a tuple: a leaf)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [s for t in tree for s in _spec_leaves(t)]
    return [tuple(tree)]


@pytest.mark.parametrize("arch", jcfg.ALL_ARCHS)
def test_abstract_state_matches_reference(arch):
    """At full size, without storage: ``abstract_params`` against the
    reference's ShapeDtypeStruct tree, ``param_bytes`` equal, the dense
    decode caches' defs leaf for leaf, and ``abstract_state`` the
    parameters plus float32 moments and an int32 step."""
    import repro_torch.models as tmodels
    from repro_torch.models.attention import dense_lines
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    want = [(tuple(s.shape), str(s.dtype))
            for s in jax.tree.leaves(jm.abstract_params(jc))]
    got = tmodels.abstract_params(tc)
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in tree_leaves(got)] == want
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert tmodels.param_bytes(tc) == jm.param_bytes(jc)
    is_def = lambda x: hasattr(x, "logical")                 # noqa: E731
    jcache = jax.tree.leaves(jm.cache_param_defs(jc, 2, 64), is_leaf=is_def)
    tcache = tree_leaves(tmodels.cache_param_defs(tc, 2, 64))
    # the port's dense cache rounds its kv_seq axis up to 16 lines
    assert [(tuple(d.shape), d.dtype) for d in tcache] == [
        (tuple(dense_lines(n) if ax == "kv_seq" else n
               for n, ax in zip(d.shape, d.logical)), d.dtype)
        for d in jcache]
    state = abstract_state(tc)
    assert [(k, t.shape, t.dtype) for k, t in tree_paths(state["params"])] \
        == [(k, t.shape, t.dtype) for k, t in tree_paths(got)]
    for m in ("mu", "nu"):
        assert [(t.shape, t.dtype) for t in tree_leaves(state["opt"][m])] \
            == [(t.shape, torch.float32) for t in tree_leaves(got)]
    assert state["opt"]["step"].dtype == torch.int32
