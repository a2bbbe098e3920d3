"""Training on the card: a bf16 train step of qwen3-0.6b (full width, 4
layers) against the port's float32 step on the CPU, the bitwise resume
under deterministic algorithms, the tied embedding's cast after an
update, and the two MoE dispatches.

Needs an NVIDIA card (marked ``cuda``; skips elsewhere).  On the card,
from the repo root:

    python -m pytest -m cuda tests/test_torch_train_cuda.py

The training path launches no hand-written kernel (the reference's
training runs no Pallas kernel).  Imports no JAX.
"""

import contextlib
import dataclasses
import signal

import pytest
import torch

from repro_torch.configs import get_config, smoke
from repro_torch.models import init_params, prefill, prepare_params
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import (CheckpointManager, LoopConfig, OptConfig,
                               SyntheticLMData, TrainConfig, TrainLoop,
                               init_opt_state, make_initial_state,
                               make_train_step)
from repro_torch.train.loop import _TransientError
from repro_torch.train.step import value_and_grad

pytestmark = pytest.mark.cuda

# bf16 loss against float32 (test_bf16_step_matches_float32_cpu): 2^-6
# of the loss, derived in the test's docstring
BF16_LOSS_RTOL = 2.0 ** -6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    prev = signal.getsignal(signal.SIGTERM)   # TrainLoop installs its own
    yield torch.device("cuda")
    signal.signal(signal.SIGTERM, prev)


@contextlib.contextmanager
def _deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def test_bf16_step_matches_float32_cpu(card):
    """qwen3-0.6b at full width cut to 4 layers, B 2 x S 256: one train
    step on the card in bf16 against the same weights in float32 on the
    CPU.

    Tolerance: the card's step rounds every product and activation to
    bf16 (within 2^-9 of itself, round to nearest even, unbiased); four
    layers of such roundings move the logits by a few 2^-8 of
    themselves, and the loss, a float32 mean over 512 tokens of
    log-sum-exp minus the label's logit, by far less.  Held at 2^-6 of
    the loss (four bf16 ulps); the step's learning rate and the global
    gradient norm within 2^-4 (the norm of bf16 gradients)."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=4)
    f32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    cpu = tree_map(lambda t: t.float().cpu(), params)
    cpu["embed"].pop("tok_cast")
    opt = OptConfig(lr=3e-4, warmup_steps=1, total_steps=8)
    batch = SyntheticLMData(cfg, 2, 256, device="cuda").batch_at(0)
    _, got = make_train_step(cfg, TrainConfig(opt=opt))(
        {"params": params, "opt": init_opt_state(params)}, batch)
    _, want = make_train_step(f32, TrainConfig(opt=opt))(
        {"params": cpu, "opt": init_opt_state(cpu)},
        {k: v.cpu() for k, v in batch.items()})
    assert got["loss"].device.type == "cuda"
    rel = abs(float(got["loss"]) - float(want["loss"])) / float(want["loss"])
    assert rel <= BF16_LOSS_RTOL, (float(got["loss"]), float(want["loss"]))
    g_rel = abs(float(got["grad_norm"]) - float(want["grad_norm"])) \
        / float(want["grad_norm"])
    assert g_rel <= 2.0 ** -4
    assert float(got["lr"]) == pytest.approx(float(want["lr"]), rel=1e-6)


def test_resume_is_bitwise_under_deterministic_algorithms(card, tmp_path):
    cfg = dataclasses.replace(smoke(get_config("qwen3-0.6b")),
                              dtype="bfloat16", remat="full")
    loop_cfg = LoopConfig(total_steps=6, ckpt_every=3, log_every=1,
                          max_retries=0,
                          train=TrainConfig(opt=OptConfig(
                              lr=1e-3, warmup_steps=0, total_steps=6)))
    data = SyntheticLMData(cfg, 2, 64, seed=5, device="cuda")
    armed = {"on": True}

    def injector(step):
        if step == 4 and armed["on"]:
            raise _TransientError("node lost")

    def loop(name, inject=None):
        return TrainLoop(cfg, loop_cfg, data,
                         CheckpointManager(str(tmp_path / name)),
                         make_initial_state(cfg, 0, "cuda"),
                         failure_injector=inject)

    with _deterministic():
        ref = loop("a")
        ref_out = ref.run()
        with pytest.raises(_TransientError):
            loop("b", injector).run()
        armed["on"] = False
        resumed = loop("b", injector)
        out = resumed.run()
    want = {h["step"]: h["loss"] for h in ref.history}
    got = {h["step"]: h["loss"] for h in resumed.history}
    assert sorted(got) == [5, 6]
    assert all(got[s] == want[s] for s in got), (got, want)
    for a, b in zip(tree_leaves(out["state"]), tree_leaves(ref_out["state"])):
        assert torch.equal(a, b)


def test_tok_cast_follows_tok_after_an_update(card):
    """The cached bf16 copy of the tied table never outlives an update:
    the step drops it, and a serve prefill on the trained weights reads
    the updated table."""
    cfg = dataclasses.replace(smoke(get_config("qwen3-0.6b")),
                              dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    old_cast = params["embed"]["tok_cast"]
    batch = SyntheticLMData(cfg, 2, 32, device="cuda").batch_at(0)
    new, _ = make_train_step(cfg, TrainConfig(opt=OptConfig(
        lr=1e-2, warmup_steps=0)))(
        {"params": params, "opt": init_opt_state(params)}, batch)
    assert "tok_cast" not in new["params"]["embed"]
    served = prepare_params(new["params"], cfg)
    tok = new["params"]["embed"]["tok"]
    assert torch.equal(served["embed"]["tok_cast"], tok.to(torch.bfloat16))
    assert not torch.equal(served["embed"]["tok_cast"], old_cast)
    with torch.no_grad():
        a, _ = prefill(served, cfg, batch["tokens"])
        b, _ = prefill(new["params"], cfg, batch["tokens"])
    assert torch.equal(a, b)


def test_moe_dispatches_agree_on_the_card(card):
    """deepseek-v2 smoke in bf16: "local" (a rank's tokens are its one
    group) routes to the global dispatch: loss and gradients equal under
    deterministic algorithms."""
    cfg = dataclasses.replace(smoke(get_config("deepseek-v2-236b")),
                              dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    batch = SyntheticLMData(cfg, 2, 64, device="cuda").batch_at(0)
    out = {}
    with _deterministic():
        for mode in ("global", "local"):
            out[mode] = value_and_grad(
                params, batch, dataclasses.replace(cfg, moe_dispatch=mode))
    (lg, mg, gg), (ll, ml, gl) = out["global"], out["local"]
    assert float(mg["aux"]) > 0
    assert torch.equal(lg, ll)
    for a, b in zip(tree_leaves(gg), tree_leaves(gl)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(b, a, rtol=2.0 ** -8, atol=0)
