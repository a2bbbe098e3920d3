"""The static engine's decode attention on the card: row 1
(``paged_attention``, the hand-written GQA kernel) over a dense cache
viewed as 16-line pages under the identity block table, and the static
engine's captured decode step against its eager run.

Needs an NVIDIA card with nvcc (marked ``cuda``; skips elsewhere).  On
the card, from the repo root:

    python -m pytest -m cuda tests/test_torch_static_cuda.py

Tolerances: the kernel against its plain version on the same inputs,
float32 atol = rtol = 2e-5 (another summation order) and bf16 6e-2 (the
plain version rounds the scores and p to bf16, the kernel keeps them in
float32), as ``chip_smoke.py``'s TOL.  Graphed against eager: token
streams, final caches and launch counts equal (``torch.equal``).
Imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import init_params
from repro_torch.models.attention import (DENSE_PAGE, dense_attention,
                                          dense_lines, identity_tables)
from repro_torch.serve import GenerateConfig, StaticEngine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=6e-2, rtol=6e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs, CUDA kernels)")
    return torch.device("cuda")


def _case(B, n_lines, KV, G, hd, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    S = dense_lines(n_lines)
    q = torch.randn((B, KV, G, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, KV, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g, device="cuda").to(dtype)
    return q, k, v


# (B, source lines, KV, G, hd): whisper's self and cross shapes, vision's
# cross shape, line counts that are not a multiple of 16
SHAPES = [(4, 56, 12, 1, 64), (4, 1500, 12, 1, 64), (2, 1600, 8, 8, 128),
          (3, 13, 2, 2, 16), (2, 37, 4, 3, 32)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_identity_table_matches_plain_version(card, shape, dtype):
    B, n, KV, G, hd = shape
    q, k, v = _case(B, n, KV, G, hd, dtype)
    S = k.shape[1]
    pos = torch.tensor([n - 1 - 3 * b for b in range(B)], dtype=torch.int32,
                       device=card).clamp_min(0)
    before = pa.paged_attention.launches
    got = dense_attention(q, k, v, pos, scale=hd ** -0.5)
    assert pa.paged_attention.launches == before + 1
    pool = (B * S // DENSE_PAGE, DENSE_PAGE, KV, hd)
    want = pa.paged_attention_reference(
        q, k.view(pool), v.view(pool), identity_tables(B, S, card), pos,
        scale=hd ** -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_pages_past_pos_are_never_read(card):
    """NaN in every page after the one holding ``pos``: the kernel never
    reads them (the output is finite and equals the plain version on the
    cache with zeros there)."""
    B, n, KV, G, hd = 2, 200, 4, 2, 64
    q, k, v = _case(B, n, KV, G, hd, torch.bfloat16, seed=1)
    pos = torch.tensor([40, 95], dtype=torch.int32, device=card)
    clean_k, clean_v = k.clone(), v.clone()
    for b, p in enumerate(pos.tolist()):
        start = (p // DENSE_PAGE + 1) * DENSE_PAGE
        k[b, start:], v[b, start:] = float("nan"), float("nan")
        clean_k[b, start:], clean_v[b, start:] = 0.0, 0.0
    got = dense_attention(q, k, v, pos, scale=hd ** -0.5)
    want = dense_attention(q, clean_k, clean_v, pos, scale=hd ** -0.5)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def _model(arch):
    cfg = dataclasses.replace(smoke(get_config(arch)), dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    for seg in params["segments"]:
        for blk in seg.values():
            for name in ("mixer", "cross"):
                if name in blk and "gate" in blk[name]:
                    t = blk[name]["gate"]
                    t.copy_(torch.rand(t.shape, generator=g,
                                       device="cuda") + 0.5)
    return cfg, params


def _sources(cfg, B):
    g = torch.Generator(device="cuda").manual_seed(2)
    if cfg.is_encoder_decoder:
        return {"enc_embeds": torch.randn(
            (B, cfg.n_audio_frames, cfg.d_model), generator=g,
            device="cuda").to(torch.bfloat16)}
    if cfg.n_image_tokens:
        return {"img_embeds": torch.randn(
            (B, cfg.n_image_tokens, cfg.d_model), generator=g,
            device="cuda").to(torch.bfloat16)}
    return {}


@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-90b",
                                  "qwen3-0.6b", "deepseek-v2-236b",
                                  "xlstm-350m"])
def test_static_graphed_equals_eager(card, arch):
    cfg, params = _model(arch)
    B, S = 3, 11
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    src = _sources(cfg, B)
    gen = GenerateConfig(max_new_tokens=9)
    outs, launches = [], []
    for graphs in (True, False):
        eng = StaticEngine(cfg, params, cuda_graphs=graphs)
        n = pa.paged_attention.launches
        with torch.no_grad():
            outs.append(eng.generate(prompts, gen, **src)["tokens"])
        torch.cuda.synchronize()
        launches.append(pa.paged_attention.launches - n)
        assert eng.decode_steps == 8
        if graphs:
            assert "decode" in eng._graphs.graphs
    np.testing.assert_array_equal(outs[0], outs[1])
    assert launches[0] == launches[1]
    per_step = sum(reps * (2 if b.mixer == "attn+cross" else 1)
                   for unit, reps in cfg.segments() for b in unit
                   if b.mixer in ("attn", "cross_attn", "attn+cross"))
    assert launches[0] == 8 * per_step
