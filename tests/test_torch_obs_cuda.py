"""Serve telemetry and the per-level roofline probes on the card.

Needs an NVIDIA card with nvcc (marked ``cuda``; skips elsewhere).  On
the card, from the repo root:

    python -m pytest -m cuda tests/test_torch_obs_cuda.py

* greedy streams of engines replaying captured graphs are the same with
  telemetry on and off (``Engine``, and ``SpecEngine`` with the n-gram
  proposer), as are the kernel wrappers' launch counts, and the trace
  validates;
* every ``decode_step`` span lasts at least the device time of its step
  (CUDA events around the graph replay and the sampler): the span
  brackets the step's read-back, not its launch;
* the microbench's new probes return finite betas, the L2-resident
  stream faster than ``measure_peak_bandwidth``'s HBM stream, an overlap
  fraction in [0, 1], and ``measure_ici_bandwidth`` None on one card.

bf16 smoke widths, so the tensor-core cores run.  Imports no JAX.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke
from repro_torch.core.roofline import microbench as mb
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import init_params
from repro_torch.obs import validate_trace
from repro_torch.serve import (Engine, EngineConfig, GenerateConfig,
                               SpecConfig, SpecEngine)

pytestmark = pytest.mark.cuda

PROMPTS = (5, 11, 7, 16)
COUNTERS = ("paged_attention", "paged_attention_verify",
            "mla_paged_attention", "mla_paged_attention_verify")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs, CUDA kernels)")
    return torch.device("cuda")


_MODELS: dict = {}


def _model(arch):
    if arch not in _MODELS:
        cfg = dataclasses.replace(smoke(get_config(arch)), dtype="bfloat16")
        gen = torch.Generator(device="cuda").manual_seed(0)
        _MODELS[arch] = (cfg, init_params(cfg, gen, "cuda"))
    return _MODELS[arch]


def _serve(cfg, params, telemetry, spec, engine_cls=None):
    ecfg = EngineConfig(num_slots=3, page_size=16, max_len=64,
                        prefill_chunk=8, device="cuda", telemetry=telemetry,
                        telemetry_window=2)
    if spec:
        eng = SpecEngine(cfg, params, ecfg,
                         SpecConfig(k=3, proposer="ngram"))
    else:
        eng = (engine_cls or Engine)(cfg, params, ecfg)
    rng = np.random.RandomState(11)
    reqs = [eng.submit(np.tile(rng.randint(0, cfg.vocab_size, 3), n // 3 + 1)
                       [:n], GenerateConfig(max_new_tokens=12))
            for n in PROMPTS]
    for name in COUNTERS:
        getattr(pa, name).launches = 0
    eng.run()
    torch.cuda.synchronize()
    return (eng, [list(r.generated) for r in reqs],
            {n: getattr(pa, n).launches for n in COUNTERS})


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
@pytest.mark.parametrize("spec", [False, True], ids=["engine", "spec"])
def test_graphed_streams_equal_with_telemetry_on_and_off(card, arch, spec):
    cfg, params = _model(arch)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        off, base, launches_off = _serve(cfg, params, False, spec)
        on, traced, launches_on = _serve(cfg, params, True, spec)
    finally:
        torch.use_deterministic_algorithms(False)
    assert on.graphs and off.graphs
    assert traced == base
    assert launches_on == launches_off and sum(launches_on.values()) > 0
    doc = on.obs.export_trace()
    assert validate_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"]}
    assert ({"propose", "verify"} if spec else {"decode_step"}) <= names
    on.obs.harvest(on)
    assert on.obs.attainment.windows


class _EventedEngine(Engine):
    """The engine with CUDA events around each decode step's device work
    (graph replay and sampler); its tokens are unchanged."""

    def _decode_sample(self):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        tok = super()._decode_sample()
        e.record()
        self.events.append((s, e))
        return tok


def test_decode_step_span_covers_its_device_time(card):
    cfg, params = _model("qwen3-0.6b")
    _EventedEngine.events = []
    eng, _, _ = _serve(cfg, params, True, False, engine_cls=_EventedEngine)
    spans = [e for e in eng.obs.export_trace()["traceEvents"]
             if e["ph"] == "X" and e["name"] == "decode_step"]
    assert len(spans) == len(eng.events) == eng.decode_steps > 0
    for span, (s, e) in zip(spans, eng.events):
        device_us = s.elapsed_time(e) * 1e3
        assert span["dur"] >= device_us, (span["dur"], device_us)


def test_probes_give_finite_betas(card):
    l2 = mb.measure_cache_bandwidth(card)
    hbm = mb.measure_peak_bandwidth(card, nbytes=256 << 20)["best"]
    host = mb.measure_host_link_bandwidth(card)
    ov = mb.measure_compute_transfer_overlap(card)
    for v in (l2, hbm, host):
        assert math.isfinite(v) and v > 0
    assert l2 > hbm, (l2, hbm)
    assert host < hbm
    assert set(ov) == {"host"} and 0.0 <= ov["host"] <= 1.0
    if torch.cuda.device_count() == 1:
        assert mb.measure_ici_bandwidth(card) is None
    else:
        assert mb.measure_ici_bandwidth(card) > 0
