"""The port's training on its own (no JAX): the JAX package's
fault-tolerance tests (``tests/test_train.py``, ``tests/test_system.py``)
on ``repro_torch.train``, the tied embedding's cast left out of
training, and the launchers on the CPU.  Smoke configs, float32."""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
from repro_torch.launch import train as train_cli
from repro_torch.launch import train_lm
from repro_torch.models import init_params, prefill, prepare_params
from repro_torch.models.params import tree_leaves, tree_paths
from repro_torch.train import (CheckpointManager, LoopConfig, OptConfig,
                               Prefetcher, StragglerWatchdog,
                               SyntheticLMData, TrainConfig, TrainLoop,
                               init_opt_state, make_initial_state,
                               make_train_step)
from repro_torch.train.loop import _TransientError, abstract_state


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


def _cfg(**changes):
    return dataclasses.replace(tcfg.smoke(tcfg.get_config("qwen3-0.6b")),
                               **changes)


def _state(cfg, device="cpu"):
    return make_initial_state(cfg, 0, device)()


def test_checkpoint_roundtrip(tmp_path):
    """float32 and bf16 leaves (bf16 stored as its 16-bit pattern), the
    0-d step counter, the reference's keys and manifest."""
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg(dtype=dtype)
        state = _state(cfg)
        state["opt"]["step"] = torch.tensor(7, dtype=torch.int32)
        mgr = CheckpointManager(str(tmp_path / dtype), keep=2)
        mgr.save(state, step=7, meta={"arch": cfg.name})
        restored, manifest = mgr.restore(abstract_state(cfg), device="cpu")
        assert manifest["step"] == 7 and manifest["meta"] == {
            "arch": cfg.name}
        assert manifest["keys"] == sorted(k for k, _ in tree_paths(state))
        assert "params/segments/0/b0/mixer/wq" in manifest["keys"]
        for (k, a), (_, b) in zip(tree_paths(state), tree_paths(restored)):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert torch.equal(a, b), k
        with np.load(os.path.join(mgr.step_dir(7), "arrays.npz")) as z:
            raw = z["params/segments/0/b0/mixer/wq"]
        assert raw.dtype == (np.int16 if dtype == "bfloat16"
                             else np.float32)
        with open(os.path.join(mgr.step_dir(7), "manifest.json")) as f:
            dtypes = json.load(f)["dtypes"]
        assert dtypes["params/segments/0/b0/mixer/wq"] == dtype
        assert dtypes["opt/step"] == "int32"


def test_checkpoint_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"x": torch.arange(4)}
    for s in [10, 20, 30, 40]:
        mgr.save(state, s)
    assert mgr.all_steps() == [30, 40]
    assert not [n for n in os.listdir(tmp_path) if n.startswith("tmp.")]


def test_checkpoint_milestones_kept(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, milestone_every=100)
    state = {"x": torch.arange(4)}
    for s in [100, 150, 200, 250]:
        mgr.save_async(state, s)
    mgr.wait()
    assert mgr.all_steps() == [100, 200, 250]


def test_checkpoint_restore_refuses_a_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.empty(4, device="meta")}, device="cpu")
    mgr.save({"x": torch.arange(4)}, 1)
    with pytest.raises(KeyError, match="missing"):
        mgr.restore({"y": torch.empty(4, device="meta")}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"x": torch.empty(5, device="meta")}, device="cpu")


def test_resume_after_failure_is_bitwise(tmp_path):
    """Kill at step 7, restart, and the loss trajectory must match an
    uninterrupted run exactly."""
    cfg = _cfg()
    loop_cfg = LoopConfig(
        total_steps=10, ckpt_every=5, log_every=1, max_retries=0,
        train=TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0,
                                        total_steps=10)))
    data = SyntheticLMData(cfg, batch=2, seq=16, seed=5, device="cpu")

    def run(ckdir, injector=None):
        return TrainLoop(cfg, loop_cfg, data,
                         CheckpointManager(ckdir, keep=3),
                         make_initial_state(cfg, seed=0, device="cpu"),
                         failure_injector=injector)

    ref = run(str(tmp_path / "a"))
    out_ref = ref.run()
    ref_losses = {h["step"]: h["loss"] for h in ref.history}

    boom = {"armed": True}

    def injector(step):
        if step == 7 and boom["armed"]:
            raise _TransientError("node lost")

    crashed = run(str(tmp_path / "b"), injector)
    with pytest.raises(_TransientError):
        crashed.run()
    assert crashed.ckpt.latest_step() == 7          # the emergency save
    boom["armed"] = False
    resumed = run(str(tmp_path / "b"), injector)
    out = resumed.run()
    assert out["step"] == 10
    res_losses = {h["step"]: h["loss"] for h in resumed.history}
    assert sorted(res_losses) == [8, 9, 10]
    for step, loss in res_losses.items():
        assert ref_losses[step] == loss, (step, loss, ref_losses[step])
    for a, b in zip(tree_leaves(out["state"]), tree_leaves(out_ref["state"])):
        assert torch.equal(a, b)


def test_transient_error_is_retried(tmp_path):
    cfg = _cfg()
    calls = []

    def injector(step):
        calls.append(step)
        if step == 2 and calls.count(2) == 1:
            raise _TransientError("flaky")

    loop = TrainLoop(cfg, LoopConfig(total_steps=4, ckpt_every=2,
                                     log_every=1, max_retries=1),
                     SyntheticLMData(cfg, 2, 8, device="cpu"),
                     CheckpointManager(str(tmp_path)),
                     make_initial_state(cfg, device="cpu"),
                     failure_injector=injector)
    assert loop.run()["step"] == 4
    assert calls == [0, 1, 2, 2, 3]


def test_straggler_watchdog_flags_outliers():
    w = StragglerWatchdog(k=3.0, warmup=3, floor_s=0.0)
    events = []
    for i in range(50):
        e = w.update(i, 0.1 + 0.001 * (i % 3))
        if e:
            events.append(e)
    assert not events
    e = w.update(50, 1.5)  # 15x step time — a straggling pod
    assert e is not None and e.dt == 1.5
    # detector stats not poisoned by the outlier
    assert w.mean < 0.2


def test_prefetcher_yields_in_order():
    d = SyntheticLMData(_cfg(), batch=2, seq=8, seed=1, device="cpu")
    pf = Prefetcher(d, start_step=3)
    got = [next(pf) for _ in range(4)]
    pf.close()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    for s, b in got:
        assert torch.equal(b["tokens"], d.batch_at(s)["tokens"])


def test_train_step_reduces_loss():
    cfg = _cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = {"params": params, "opt": init_opt_state(params)}
    step = make_train_step(cfg, TrainConfig(opt=OptConfig(
        lr=1e-2, warmup_steps=0, total_steps=100)))
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
    batch = {"tokens": tokens, "labels": tokens}
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_tied_cast_is_left_out_of_training():
    """``prepare_params``' cached cast of the tied table is neither
    trained nor carried: the step drops it, the updated parameters hold
    none, and a serve prefill on them reads the updated table."""
    cfg = _cfg(dtype="bfloat16")
    assert cfg.tie_embeddings
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert "tok_cast" in params["embed"]
    state = {"params": params, "opt": init_opt_state(params)}
    assert "tok_cast" not in tree_paths(state["opt"]["mu"])[0][0]
    batch = SyntheticLMData(cfg, 2, 16, device="cpu").batch_at(0)
    new, _ = make_train_step(cfg, TrainConfig(opt=OptConfig(
        lr=1e-2, warmup_steps=0)))(state, batch)
    assert set(new["params"]["embed"]) == {"tok"}
    assert not any("tok_cast" in k for k, _ in tree_paths(new))
    tok = new["params"]["embed"]["tok"]
    assert not torch.equal(tok, params["embed"]["tok"])
    served = prepare_params(new["params"], cfg)
    assert torch.equal(served["embed"]["tok_cast"], tok.to(torch.bfloat16))
    with torch.no_grad():
        a, _ = prefill(served, cfg, batch["tokens"])
        b, _ = prefill(new["params"], cfg, batch["tokens"])
    assert torch.equal(a, b)


def test_make_initial_state_leaves_the_cast_out():
    cfg = _cfg(dtype="bfloat16")
    state = _state(cfg)
    want = abstract_state(cfg)
    assert [k for k, _ in tree_paths(state)] == [k for k, _ in
                                                 tree_paths(want)]
    for (k, a), (_, b) in zip(tree_paths(state), tree_paths(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, k


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is honoured")
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyntheticLMData(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_initial_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CheckpointManager(str(tmp_path)).restore({}, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm.main([])
    with pytest.raises(NotImplementedError, match="item 19"):
        train_cli.main(["--smoke", "--device", "cpu", "--data", "2"])


def test_launch_train_smoke_on_cpu(tmp_path, capsys):
    out = train_cli.main([
        "--smoke", "--device", "cpu", "--steps", "6", "--batch", "2",
        "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
        "--grad-accum", "2"])
    text = capsys.readouterr().out
    assert "== roofline: qwen3-0.6b-smoke train preflight ==" in text
    assert "[train] finished at step 6 on cpu" in text
    assert out["out"]["step"] == 6
    assert out["report"].character.flops_dev > 0
    assert [h["step"] for h in out["loop"].history] == [1, 2, 3, 4, 5, 6]
    assert CheckpointManager(str(tmp_path / "qwen3-0.6b-smoke")
                             ).all_steps() == [3, 6]
    # a second run resumes from the final checkpoint and has nothing left
    again = train_cli.main([
        "--smoke", "--device", "cpu", "--steps", "6", "--batch", "2",
        "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert again["loop"].history == []


def test_train_lm_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    loop = train_lm.main(["--device", "cpu", "--steps", "12"])
    assert "finished at step 12 on cpu" in capsys.readouterr().out
    assert loop.history[-1]["loss"] < loop.history[0]["loss"]
    assert os.path.isdir(tmp_path / "results" / "ckpt" / "qwen3-0.6b-smoke")
    full = train_lm.hundred_m_config()
    assert (full.name, full.n_layers, full.d_model, full.vocab_size,
            full.dtype) == ("qwen3-100m", 12, 640, 32768, "float32")
