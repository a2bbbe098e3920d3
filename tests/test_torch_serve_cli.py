"""The serve launcher's sampling and block-pool flags and the capacity
report, on the CPU.

* each of ``--temperature``, ``--top-k``, ``--top-p``, ``--prefix-cache``,
  ``--num-pages``, ``--watermark`` and ``--preempt`` reaches the
  ``EngineConfig`` / ``GenerateConfig`` field that carries it, with the
  reference's defaults when absent, and every request gets its own seed;
* ``--temperature 0.8 --seed 3`` samples: the stream repeats run to run
  and differs from the greedy one;
* ``--prefix-cache --num-pages ... --preempt recompute`` serves and
  prints the ``[serve/capacity]`` line;
* ``serve.crosscheck.capacity_report`` equals ``repro``'s key for key on
  the same run (prefix sharing with copy-on-write, preemption), mid-run
  and at the end, the chip's memory set alike on both sides.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest

import repro.configs as jcfg
import repro.models as jm
import repro.serve as jserve
from repro.serve.crosscheck import capacity_report as ref_capacity_report
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.serve as tserve
from repro_torch import bridge
from repro_torch.core.roofline.hardware import H100_SXM
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import sampling
from repro_torch.serve.crosscheck import capacity_report

BASE = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "6",
        "--new-tokens", "3", "--slots", "2"]
# flag -> (its argument, where its value lands, the value, the default)
FLAGS = {
    "--temperature": ("0.8", "gen.temperature", 0.8, 0.0),
    "--top-k": ("50", "gen.top_k", 50, 0),
    "--top-p": ("0.9", "gen.top_p", 0.9, 0.0),
    "--prefix-cache": (None, "ecfg.prefix_cache", True, False),
    "--num-pages": ("9", "ecfg.num_pages", 9, None),
    "--watermark": ("0.1", "ecfg.watermark", 0.1, 0.0),
    "--preempt": ("recompute", "ecfg.preempt_mode", "recompute", "swap"),
}


class _Stop(Exception):
    pass


def _parsed(monkeypatch, argv):
    """The engine config, the generate configs and seeds the launcher
    builds for ``argv`` (stopped at the second submit, before serving)."""
    seen = {"gen": [], "seed": []}

    class Spy(tserve.Engine):
        def __init__(self, cfg, params, ecfg):
            seen["ecfg"] = ecfg
            super().__init__(cfg, params, ecfg)

        def submit(self, prompt, gen, seed=None):
            seen["gen"].append(gen)
            seen["seed"].append(seed)
            if len(seen["gen"]) == 2:
                raise _Stop
            return super().submit(prompt, gen, seed=seed)

    monkeypatch.setattr(serve_cli, "Engine", Spy)
    with pytest.raises(_Stop):
        serve_cli.main(BASE + argv)
    return seen


def _field(seen, where):
    obj, name = where.split(".")
    return getattr(seen["ecfg"] if obj == "ecfg" else seen["gen"][0], name)


@pytest.mark.parametrize("flag", list(FLAGS))
def test_flag_reaches_its_field(monkeypatch, flag):
    arg, where, value, default = FLAGS[flag]
    seen = _parsed(monkeypatch, [flag] + ([arg] if arg else []))
    assert _field(seen, where) == value
    for other, (_, w, _, d) in FLAGS.items():
        if other != flag:
            assert _field(seen, w) == d, other
    # one stream per request, derived from --seed (0) and the request
    assert seen["seed"] == [sampling.fold_seed(0, b) for b in range(2)]


def _first_sequence(capsys, argv):
    serve_cli.main(BASE + argv)
    out = capsys.readouterr().out
    return re.search(r"\[serve\] first sequence: (.*)", out).group(1)


def test_sampled_stream_is_reproducible_and_not_greedy(capsys):
    sampled = ["--temperature", "0.8", "--seed", "3", "--new-tokens", "8"]
    a = _first_sequence(capsys, sampled)
    b = _first_sequence(capsys, sampled)
    greedy = _first_sequence(capsys, ["--seed", "3", "--new-tokens", "8"])
    assert a == b
    assert a != greedy


def test_pool_options_run_and_print_capacity(capsys):
    serve_cli.main(["--smoke", "--device", "cpu", "--batch", "3",
                    "--prompt-len", "12", "--new-tokens", "10", "--slots",
                    "3", "--prefix-cache", "--num-pages", "5", "--preempt",
                    "recompute", "--temperature", "0.8"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 30 tokens" in out
    cap = re.search(r"\[serve/capacity\] pages peak=(\d+)/4 \(\d+ B/page\), "
                    r"deduped=\d+ cow=\d+ preemptions=(\d+)", out)
    assert cap and int(cap.group(1)) <= 4 and int(cap.group(2)) > 0


@pytest.fixture(scope="module")
def qwen():
    jc = jcfg.smoke(jcfg.get_config("qwen3-0.6b"))
    tc = tcfg.smoke(tcfg.get_config("qwen3-0.6b"))
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.prepare_params(
        bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu"), tc)
    return jc, tc, jp, tp


def test_capacity_report_equals_reference(qwen):
    jc, tc, jp, tp = qwen
    ecfg = dict(num_slots=2, page_size=4, max_len=16, num_pages=8,
                prefix_cache=True, preempt_mode="swap", prefill_chunk=4)
    jeng = jserve.Engine(jc, jp, jserve.EngineConfig(**ecfg))
    chip = dataclasses.replace(H100_SXM,
                               hbm_bytes=jeng.ecfg.chip.hbm_bytes)
    teng = tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu", chip=chip,
                                                     **ecfg))
    rs = np.random.RandomState(7)
    shared = rs.randint(0, 256, 8).astype(np.int32)
    prompts = [np.concatenate([shared, rs.randint(0, 256, 2)]).astype(
        np.int32) for _ in range(3)] + [shared, shared]
    for eng, mod in ((jeng, jserve), (teng, tserve)):
        for p in prompts:
            eng.submit(p, mod.GenerateConfig(max_new_tokens=5))
    reports = []
    for _ in range(6):
        jeng.step()
        teng.step()
        reports.append((capacity_report(teng), ref_capacity_report(jeng)))
    jeng.run()
    teng.run()
    reports.append((capacity_report(teng), ref_capacity_report(jeng)))
    for got, want in reports:
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k], (k, got[k], want[k])
    end = reports[-1][0]
    assert end["pages_deduped"] > 0 and end["cow_copies"] > 0
    assert end["preemptions"] > 0


def _draws(logits, n, temp, top_k, top_p, batch=2000):
    """``n`` draws of ``sampling.sample_tokens`` from one logits row, each
    its own seeded stream."""
    out = []
    for i in range(0, n, batch):
        b = min(batch, n - i)
        out.append(sampling.sample_tokens(
            logits[None].expand(b, -1), np.arange(i, i + b) + 1000,
            np.zeros(b, np.int32), np.full(b, temp, np.float32),
            np.full(b, top_k, np.int32), np.full(b, top_p, np.float32)))
    return np.concatenate([t.numpy() for t in out])


@pytest.fixture
def two_threads():
    """Two intra-op threads for the sampler's filter scan: under the
    suite's six workers torch's default (one thread a core in every
    worker) oversubscribes the cores, and this test's 22 000 filtered
    rows then spent most of their wall waiting for them."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_sampler_distribution_within_null_bound(two_threads):
    """20 000 seeded draws at temperature 0.8, top-k 50, top-p 0.9 from
    one row: every draw in the kept set and the frequencies within
    ``tv_null_bound`` (6 sigma) of the filtered, tempered softmax; 2 000
    draws at temperature 1.0 held against the same target exceed their
    bound (the check sees a wrong temperature: the two targets are 0.15
    apart in total variation)."""
    import torch
    logits = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 3
    p = sampling.target_distribution(logits, 0.8, 50, 0.9)
    assert 0 < sampling.tv_null_bound(p, 20000) < 0.02
    for temp, n, ok in ((0.8, 20000, True), (1.0, 2000, False)):
        toks = _draws(logits, n, temp, 50, 0.9)
        f = np.bincount(toks, minlength=p.size) / n
        tv = 0.5 * np.abs(f - p).sum()
        bound = sampling.tv_null_bound(p, n)
        assert (tv <= bound) == ok, (temp, tv, bound)
        if ok:
            assert p[toks].min() > 0             # nothing outside the set
