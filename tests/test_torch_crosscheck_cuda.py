"""The roofline cross-checks on the card (``serve/crosscheck.py``).

Needs an NVIDIA card with nvcc (marked ``cuda``; skips elsewhere).  On
the card, from the repo root:

    python -m pytest -m cuda tests/test_torch_crosscheck_cuda.py

* the scope tags (``core/roofline/op_cost.py::named_scope``) change
  neither the greedy streams nor the kernel launch counts of a graphed
  engine (GQA and MLA + MoE smoke models);
* the walks run beside a live engine on the card: fake CPU tensors of
  the live shapes, nothing on the card read or allocated (the allocated
  bytes do not move), and the ``vmem`` and host checks at ratio 1.0 on
  bf16, int8 and fp8 pools under both pipelines.

bf16 smoke widths.  Imports no JAX.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import init_params
from repro_torch.serve import Engine, EngineConfig, GenerateConfig
from repro_torch.serve import crosscheck as xc

pytestmark = pytest.mark.cuda

PAGE = 8                       # the MLA kernels take pages of 8, 16 or 32
COUNTERS = (pa.paged_attention, pa.paged_attention_ring,
            pa.mla_paged_attention, pa.mla_paged_attention_ring)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels)")
    return torch.device("cuda")


def _serve(arch, **ecfg):
    cfg = dataclasses.replace(smoke(get_config(arch)), dtype="bfloat16")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    eng = Engine(cfg, params, EngineConfig(num_slots=2, page_size=PAGE,
                                           max_len=64, device="cuda",
                                           **ecfg))
    for f in COUNTERS:
        f.launches = 0
    reqs = [eng.submit(np.random.RandomState(i).randint(
        0, cfg.vocab_size, 11), GenerateConfig(max_new_tokens=8))
        for i in range(3)]
    eng.run()
    torch.cuda.synchronize()
    return ([list(r.generated) for r in reqs],
            [f.launches for f in COUNTERS])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_scopes_change_no_stream_and_no_launch(card, arch, monkeypatch):
    from repro_torch.models import attention, layers, mla, moe
    with_tags = _serve(arch)
    for mod in (attention, layers, mla, moe):
        monkeypatch.setattr(mod, "named_scope",
                            lambda tag: contextlib.nullcontext())
    assert _serve(arch) == with_tags
    assert sum(with_tags[1]) > 0


@pytest.mark.parametrize("pipeline", ["off", "double"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_walks_beside_a_live_engine(card, arch, kv_dtype, pipeline):
    cfg = dataclasses.replace(smoke(get_config(arch)), dtype="bfloat16")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    eng = Engine(cfg, params, EngineConfig(
        num_slots=2, page_size=PAGE, max_len=64, device="cuda",
        kv_dtype=kv_dtype, pipeline=pipeline))
    for i in range(2):
        eng.submit(np.random.RandomState(i).randint(0, cfg.vocab_size, 13),
                   GenerateConfig(max_new_tokens=12))
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = xc.crosscheck_decode(eng)
    step = xc.step_cost_analysis(eng)
    assert torch.cuda.memory_allocated() == before
    assert out["substituted"] and step["flops"] >= out["hlo_flops"]
    assert xc.bytes_held(out), out
    for n_q in (1, 4):
        assert xc.crosscheck_vmem(eng, n_q=n_q)["vmem_ratio"] == 1.0
    assert xc.crosscheck_host(eng)["host_ratio"] == 1.0
    eng.run()                  # the engine serves on after the walks
