"""Training's loss and gradients: the port's ``models.loss_fn`` and
``train.step.value_and_grad`` against the JAX package's ``loss_fn`` and
``jax.grad`` on the same weights (``repro.models.init_params`` carried
across by ``repro_torch.bridge``) and the same batches (each package's
``SyntheticLMData``, equal draws), on smoke configs; remat; the
pre-flight walk of a train step.

Tolerances (float32 on both sides, XLA's op order against ATen's):
* loss: rtol 1e-5, for all 10 archs (xlstm-350m and jamba-v0.1-52b in
  test_torch_train_recurrent_grads.py);
* gradients of every leaf: rtol 1e-4, atol 1e-5 (the reference's own
  grad-accum bar), the atol in units of the leaf's largest gradient
  where that exceeds 1: an element summed from terms of that size
  carries their float32 roundoff (jamba's embedding rows reach 10, and
  elements near 0 there differ by ~4e-5, 1e-5 of the row);
* remat full / dots against none: bit for bit (the CPU recomputes the
  same ops in the same order); "dots" keeps only 2-D product outputs,
  never a (.., S, S) score tensor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models as jm
from repro.train import SyntheticLMData as JData
import repro_torch.configs as tcfg
from repro_torch import bridge
from repro_torch.core.analysis import AnalysisReport, analyze_step
from repro_torch.core.roofline import op_cost
from repro_torch.launch import specs
from repro_torch.models import (decode_step, loss_fn, model_param_defs,
                                prefill)
from repro_torch.models.common import ShapeCell, model_flops
from repro_torch.models.params import tree_leaves, tree_map, tree_paths
from repro_torch.parallel.mesh import single_device_mesh
from repro_torch.train import SyntheticLMData as TData
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.step import value_and_grad

GRAD_ARCHS = ("qwen3-0.6b", "deepseek-v2-236b", "xlstm-350m",
              "jamba-v0.1-52b", "whisper-small", "llama-3.2-vision-90b")
# the recurrent mixers' archs (the reference's slowest to compile) are
# held in test_torch_train_recurrent_grads.py
RECURRENT = ("xlstm-350m", "jamba-v0.1-52b")
B, S, SEED = 2, 16, 3
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: under the suite's six workers torch's
    default (one thread a core in every worker) oversubscribes the cores,
    and these smoke-sized steps then spend their wall waiting for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _with_gates(tree, rng):
    """Every cross-attention ``gate`` leaf drawn in [0.5, 1.5): at its
    init of 0 the cross path would be dead."""
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
                    if k == "gate" else _with_gates(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_gates(t, rng) for t in tree]
    return tree


_CACHE: dict = {}


def _case(arch):
    """(jc, tc, jax params, torch params, jax batch, torch batch, jax
    (loss, grads) or loss) of an arch, computed once a module."""
    if arch not in _CACHE:
        jc = jcfg.smoke(jcfg.get_config(arch))
        tc = tcfg.smoke(tcfg.get_config(arch))
        tree = _with_gates(jax.tree.map(
            np.asarray, jm.init_params(jc, jax.random.key(0))),
            np.random.default_rng(7))
        jp = jax.tree.map(jnp.asarray, tree)
        tp = bridge.to_torch(tree, device="cpu")
        jb = JData(jc, B, S, seed=SEED).batch_at(0)
        tb = TData(tc, B, S, seed=SEED, device="cpu").batch_at(0)
        loss = lambda p, b: jm.loss_fn(p, b, jc)             # noqa: E731
        if arch in GRAD_ARCHS:
            ref = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp, jb)
        else:
            ref = (jax.jit(loss)(jp, jb), None)
        _CACHE[arch] = (jc, tc, jp, tp, jb, tb, ref)
    return _CACHE[arch]


@pytest.mark.parametrize("arch", [a for a in jcfg.ALL_ARCHS
                                  if a not in RECURRENT])
def test_loss_matches_reference(arch):
    _check_loss(arch)


def _check_loss(arch):
    jc, tc, jp, tp, jb, tb, ((jl, jmet), _) = _case(arch)
    with torch.no_grad():
        tl, tmet = loss_fn(tp, tb, tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    if jc.n_experts:
        assert float(tmet["aux"]) > 0


@pytest.mark.parametrize("arch", [a for a in GRAD_ARCHS
                                  if a not in RECURRENT])
def test_grads_match_reference(arch):
    _check_grads(arch)


def _check_grads(arch):
    jc, tc, jp, tp, jb, tb, (_, jg) = _case(arch)
    tl, _, tg = value_and_grad(tp, tb, tc)
    jleaves = jax.tree.leaves(jg)
    tpaths = tree_paths(tg)
    assert len(jleaves) == len(tpaths)
    for (path, t), j in zip(tpaths, jleaves):
        j = np.asarray(j, np.float32)
        assert t.shape == j.shape, path
        scale = max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(
            t.float().numpy(), j, rtol=GRAD_TOL["rtol"],
            atol=GRAD_TOL["atol"] * scale, err_msg=path)
    # every leaf gets a gradient (the cross gates included)
    assert [p for p, t in tpaths if not float(t.abs().max()) > 0] == []


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b",
                                  "whisper-small"])
def test_remat_gives_the_same_gradients(arch):
    _check_remat(arch)


def _check_remat(arch):
    """remat full (every layer checkpointed; the whisper encoder's too)
    and dots (matrix products saved) against none, bit for bit."""
    _, tc, _, tp, _, tb, _ = _case(arch)
    out = {}
    for mode in ("none", "full", "dots"):
        loss, _, g = value_and_grad(tp, tb,
                                    dataclasses.replace(tc, remat=mode))
        out[mode] = (loss, tree_leaves(g))
    for mode in ("full", "dots"):
        assert torch.equal(out[mode][0], out["none"][0]), mode
        for a, b in zip(out[mode][1], out["none"][1]):
            assert torch.equal(a, b), mode


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_remat_dots_keeps_no_batched_product(arch, monkeypatch):
    """What remat "dots" keeps for backward, read off the policy as the
    selective checkpoint applies it (the output of each op it must
    save): only the 2-D weight products (mm / addmm), none of the
    batched ones, so no (.., S, S) attention scores and no per-expert
    (E, C, F) products.  Taken on fake tensors at an S no width shares."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.checkpoint import CheckpointPolicy
    from repro_torch.models import transformer
    _, tc, _, tp, _, _, _ = _case(arch)
    seq = 36
    cfg = dataclasses.replace(tc, remat="dots")
    inner, kept = transformer._save_dots, []

    def spy(ctx, op, *args, **kwargs):
        policy = inner(ctx, op, *args, **kwargs)
        if policy == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept.append((op, tuple(ctx.op_output.shape)))
        return policy

    monkeypatch.setattr(transformer, "_save_dots", spy)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        params = tree_map(mode.from_tensor, tp)
        tokens = torch.zeros((B, seq), dtype=torch.int32)
        batch = {"tokens": tokens, "labels": tokens}
        value_and_grad(params, batch, cfg)
    assert kept, "remat dots saved nothing"
    assert {op for op, _ in kept} <= {torch.ops.aten.mm.default,
                                      torch.ops.aten.addmm.default}
    assert all(len(shape) == 2 and shape[-1] != seq for _, shape in kept), \
        [s for _, s in kept if len(s) != 2 or s[-1] == seq]
    assert any(shape[0] == B * seq for _, shape in kept)


_PRODUCTS = ("mm", "bmm", "addmm")


class _ProductFlops(op_cost.OpCostMode):
    """The walk, also summing the matrix products' FLOPs apart."""

    def __init__(self):
        super().__init__()
        self.products = 0.0

    def _count(self, func, name, args, kwargs, ins, outs):
        if name in _PRODUCTS:
            self.products += self._flops(name, args, ins, outs)[0]
        super()._count(func, name, args, kwargs, ins, outs)


def _product_flops(fn, *args):
    mode = _ProductFlops()
    with mode:
        fn(*args)
    return mode.products


def test_preflight_walk_sees_the_backward():
    """Every matrix product with both operands requiring grad costs twice
    its forward FLOPs in backward, so with remat none a train step's
    walked mm / bmm / addmm FLOPs are exactly 3x the forward's.  With
    remat full the recompute adds each layer's forward but its last
    product (the down projection, whose output no backward needs:
    checkpoint stops recomputing once every saved tensor is back)."""
    tc = tcfg.smoke(tcfg.get_config("qwen3-0.6b"))
    mesh = single_device_mesh()
    cell = ShapeCell("t", S, B, "train")
    args, in_specs, _ = specs.train_specs(tc, cell, mesh)
    from torch._guards import detect_fake_mode
    fake = detect_fake_mode(tree_leaves(args))
    with fake, torch.no_grad():
        fwd = _product_flops(lambda s, b: loss_fn(s["params"], b, tc),
                             *args)
    steps = {}
    for remat in ("none", "full"):
        c = dataclasses.replace(tc, remat=remat)
        with fake:
            steps[remat] = _product_flops(make_train_step(c, TrainConfig()),
                                          *args)
    assert fwd > 0 and steps["none"] == 3 * fwd
    tokens, D = B * S, tc.d_model
    logits = 2 * tokens * D * tc.vocab_size
    down = 2 * tokens * tc.d_ff * D * tc.n_layers
    assert steps["full"] == 3 * fwd + (fwd - logits) - down
    # the report walks the same step on its fake arguments
    rep = analyze_step(make_train_step(tc, TrainConfig()), args=args,
                       mesh=mesh, label="smoke train", dtype=tc.dtype,
                       model_flops=model_flops(tc, S, B, "train"))
    assert isinstance(rep, AnalysisReport)
    assert rep.character.flops_dev > steps["none"]
    assert rep.character.op_counts["mm"] > 0
    text = rep.render()
    for want in ("== roofline: smoke train ==", "per-scope", "temps=0.00",
                 "fused_attention", "logits", "bound:"):
        assert want in text, want
    d = rep.as_dict()
    assert d["flops_dev"] == rep.character.flops_dev
    assert d["model_flops_total"] == model_flops(tc, S, B, "train")
    assert d["scope"] == "chip" and d["n_chips"] == 1
    # the specs: one spec a leaf, the ZeRO-1 moments replicated on one rank
    state_specs, batch_specs = in_specs
    assert len(tree_leaves(state_specs["opt"]["mu"])) == 0   # () specs
    assert batch_specs["tokens"] == ()
    assert tree_map(lambda t: tuple(t.shape), args[0]["params"]) == \
        tree_map(lambda d: tuple(d.shape), model_param_defs(tc))
    # the serving specs walk too: a prefill of the cell's tokens, one
    # decode token a row against a seq_len-deep dense cache
    for fn, make in ((lambda p, t: prefill(p, tc, t), specs.prefill_specs),
                     (lambda p, c, t, pos: decode_step(p, tc, c, t, pos),
                      specs.decode_specs)):
        a, sp, _ = make(tc, cell, mesh)
        assert len(sp) == len(a)
        r = analyze_step(fn, args=a, mesh=mesh, dtype=tc.dtype)
        assert 0 < r.character.flops_dev < rep.character.flops_dev
