"""Ledger <-> walk cross-checks of the port's serve steps
(``serve/crosscheck.py``) on CPU engines, at the reference tests' widths
(``tests/test_serve_crosscheck.py``: d_model 256 for decode, 512 for
verify, weights-dominated so the ledger's weights + KV pricing is the
bulk of the step).

* decode and verify: the walk's FLOPs (the paged-attention scope priced
  as the kernel) within 10% of the ledger's; the walk's weights + KV
  bytes equal to the ledger's Q plus the terms ``_compare`` counts from
  the parameter and pool trees, up to float64 rounding, and a ledger
  formula off by a norm vector or four bytes a line failing that hold;
  the verify step's measured intensity above 2.5 times the decode
  step's;
* ``vmem``: the ledger's closed form against the launch-grid walk at
  ratio 1.0 for GQA and MLA, every ``kv_dtype``, both pipelines, bf16 and
  float32 (live engines, and full-width configs at contexts that take
  several chunks and row tiles);
* host: the swap pricing against the walk of the gather-and-pack, 1.0;
* the decode + sample body the engine replays, and the overlap check."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.serve as tserve
from repro_torch.core.roofline.model import LevelBetas
from repro_torch.models.common import BlockDef
from repro_torch.serve import crosscheck as txc
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import scheduler as tsched


def _mla_cfg(**kw):
    """The reference tests' dense-FFN MLA config (MoE taken out: the
    ledger charges the active experts, the global dispatch reads all)."""
    cfg = tcfg.smoke(tcfg.get_config("deepseek-v2-236b"))
    base = dict(name="mla-dense-xcheck", d_model=256, d_ff=512,
                n_experts=0, moe_top_k=0, moe_d_ff=0, n_shared_experts=0,
                moe_first_dense=0, n_layers=2,
                block_pattern=(BlockDef("mla", "dense"),), q_lora_rank=64,
                kv_lora_rank=64, rope_head_dim=16, nope_head_dim=32,
                v_head_dim=32)
    base.update(kw)
    return dataclasses.replace(cfg, **base)


def _gqa_cfg(**kw):
    base = dict(d_model=256, d_ff=512)
    base.update(kw)
    return dataclasses.replace(tcfg.smoke(tcfg.get_config("qwen3-0.6b")),
                               **base)


def _mid_decode(cfg, spec=None, steps=8, max_len=32, **ecfg):
    params = tm.init_params(cfg, device="cpu")
    e = tserve.EngineConfig(device="cpu", num_slots=4, page_size=4,
                            max_len=max_len, **ecfg)
    eng = (tserve.Engine(cfg, params, e) if spec is None else
           tserve.SpecEngine(cfg, params, e, tserve.SpecConfig(**spec)))
    for i in range(4):
        eng.submit(np.random.RandomState(i).randint(
            0, cfg.vocab_size, 16).astype(np.int32),
            tserve.GenerateConfig(max_new_tokens=16))
    for _ in range(steps):
        eng.step()
    assert len(eng._sched.decode_requests()) == 4
    return eng


@pytest.fixture(scope="module")
def engines():
    return {"gqa": _mid_decode(_gqa_cfg()), "mla": _mid_decode(_mla_cfg())}


def _holds(out):
    """The decode / verify holds shared by both families."""
    assert out["substituted"]
    assert out["flops_ratio"] == pytest.approx(1.0, abs=0.10), out
    assert txc.bytes_held(out), out
    assert out["line_bytes"] == out["ledger_line_bytes"]
    # the walk's pieces add up; the appended lines are all it writes to
    # the pools outside the scope
    assert out["hlo_bytes"] == pytest.approx(
        out["param_bytes"] + out["pool_bytes"] + out["kernel_bytes"]
        + out["activation_bytes"], rel=1e-12)
    assert out["activation_bytes"] > 0 and out["naive_flops"] > 0


@pytest.mark.parametrize("family", ["gqa", "mla"])
def test_decode_crosscheck(engines, family):
    eng = engines[family]
    out = txc.crosscheck_decode(eng)
    _holds(out)
    line = tsched.kv_line_bytes(eng.cfg)
    assert out["pool_bytes"] == eng.ecfg.num_slots * line
    assert out["kernel_bytes"] == sum((L + 1) * line
                                      for L in out["contexts"])
    assert "paged_attention" in out["scopes"] and "logits" in out["scopes"]


@pytest.mark.parametrize("wrong", ["norm_priced", "line_scale"])
@pytest.mark.parametrize("family", ["gqa", "mla"])
def test_bytes_hold_fails_on_a_wrong_ledger(engines, family, wrong,
                                            monkeypatch):
    """The bytes hold takes nothing from the ledger's formulas: a ledger
    that prices one norm vector more, or four bytes more a KV line, is
    off by those bytes and fails it."""
    eng = engines[family]
    cfg = eng.cfg
    if wrong == "norm_priced":
        f = tsched.params_bytes_active
        extra = cfg.d_model * tsched._dtype_bytes(cfg.dtype)
        monkeypatch.setattr(tsched, "params_bytes_active",
                            lambda c: f(c) + extra)
        off = extra
    else:
        f = tsched.kv_line_bytes
        monkeypatch.setattr(tsched, "kv_line_bytes", lambda c: f(c) + 4)
        off = 4 * sum(L + 1 for L in
                      (r.context_len for r in eng._sched.decode_requests()))
    out = txc.crosscheck_decode(eng)
    assert not txc.bytes_held(out)
    assert out["bytes_residual"] == pytest.approx(-off, rel=1e-9)
    assert out["flops_ratio"] == pytest.approx(1.0, abs=0.10)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_bytes_hold_on_every_pool(arch, kv_dtype):
    """bf16 smoke engines (deepseek-v2's with its routed experts, held
    with the active experts in the ``moe_experts`` scope's place; its
    float32 router read as a wide leaf) on every pool dtype: the line
    counted from the pool tree (scales included) is the ledger's, and the
    hold leaves no residual."""
    cfg = dataclasses.replace(tcfg.smoke(tcfg.get_config(arch)),
                              dtype="bfloat16")
    eng = _mid_decode(cfg, steps=2, kv_dtype=kv_dtype)
    out = txc.crosscheck_decode(eng)
    assert txc.bytes_held(out) and out["bytes_residual"] == 0.0, out
    assert out["line_bytes"] == out["ledger_line_bytes"]
    assert out["experts_walked_bytes"] == out["expert_bytes"]
    assert (out["expert_bytes"] > 0) == (cfg.n_experts > 0)


def test_kernel_priced_flops_do_not_depend_on_the_table():
    """The plain paged attention scores every line of the table; priced
    as the kernel, the scope's FLOPs are the live lines', so the walk's W
    of the same requests is the same at any ``max_len``."""
    a = txc.crosscheck_decode(_mid_decode(_gqa_cfg(d_model=128)))
    b = txc.crosscheck_decode(_mid_decode(_gqa_cfg(d_model=128),
                                          max_len=128))
    assert a["contexts"] == b["contexts"]
    raw = [o["scopes"]["paged_attention"]["flops"] for o in (a, b)]
    assert raw[1] > 2 * raw[0]
    assert b["kernel_flops"] == pytest.approx(a["kernel_flops"], rel=1e-12)
    assert b["hlo_flops"] == pytest.approx(a["hlo_flops"], rel=1e-12)


@pytest.mark.parametrize("family", ["gqa", "mla"])
def test_verify_crosscheck(family):
    """W scales by T = k + 1 while Q stays near flat, so the verify step's
    measured intensity lands well above the decode step's."""
    cfg = (_gqa_cfg(d_model=512, d_ff=1024) if family == "gqa" else
           _mla_cfg(name="mla-dense-xcheck-512", d_model=512, d_ff=1024,
                    q_lora_rank=96, kv_lora_rank=96))
    eng = _mid_decode(cfg, spec=dict(k=3, proposer="ngram"), steps=4)
    ver = txc.crosscheck_verify(eng)
    assert ver["n_tokens"] == 4
    _holds(ver)
    dec = txc.crosscheck_decode(eng)
    ai_dec = dec["hlo_flops"] / dec["hlo_bytes"]
    ai_ver = ver["hlo_flops"] / ver["hlo_bytes"]
    assert ai_ver > 2.5 * ai_dec, (ai_ver, ai_dec)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pipeline", ["off", "double"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("family", ["gqa", "mla"])
def test_vmem_crosscheck_ratio_one(engines, family, kv_dtype, pipeline,
                                   dtype):
    """Every kernel the engine can dispatch to: the live engine's requests
    and table under each (dtype, kv_dtype, pipeline), decode and a
    5-token verify, then the full-width config at contexts that take one
    and many chunks (and, at T 16, several 64-row tiles of GQA rows)."""
    eng = engines[family]
    cfg = dataclasses.replace(eng.cfg, dtype=dtype, kv_dtype=kv_dtype)
    view = types.SimpleNamespace(cfg=cfg, ecfg=dataclasses.replace(
        eng.ecfg, pipeline=pipeline), _sched=eng._sched, _kv=eng._kv)
    for n_q in (1, 5):
        out = txc.crosscheck_vmem(view, n_q=n_q)
        assert out["vmem_ratio"] == 1.0 and out["pipeline"] == pipeline
        assert out["analytic_vmem_bytes"] > 0
    arch = "qwen3-14b" if family == "gqa" else "deepseek-v2-236b"
    full = dataclasses.replace(tcfg.get_config(arch), dtype=dtype,
                               kv_dtype=kv_dtype)
    for L, n_q in ((1, 1), (17, 1), (200, 1), (97, 5), (229, 16)):
        got = tsched.attn_kernel_vmem_bytes(full, L, 16, n_q=n_q,
                                            pipeline=pipeline)
        assert got == txc.kernel_walk_vmem_bytes(
            full, L, 16, n_q=n_q, pipeline=pipeline, n_blocks=64)


def test_vmem_counts_what_the_sources_do():
    """Spot values of the on-chip count, by hand from the sources: GQA
    core decode at one chunk writes its output directly; at two chunks
    the partials are written, and the merge reads each row's m, then its
    (m, l) once per warp and its acc (``__ldcg``, past L1); the MLA core's
    two column parts each stage the latent tile."""
    from repro_torch.kernels import paged_attention as kpa
    kw = dict(page_size=16, kv_heads=1, groups=2, head_dim=128, isize=2,
              kv_isize=2)
    line = 2 * 128 * 2
    assert kpa.gqa_onchip_bytes(10, **kw) == 2 * 128 * 2 + 10 * line \
        + 2 * 128 * 2
    assert kpa.gqa_onchip_bytes(20, **kw) == 2 * (2 * 128 * 2) + 20 * line \
        + 2 * 2 * (4 * 128 + 8) + 2 * 2 * (4 + 8 + 4 * 128) + 2 * 128 * 2
    mla = dict(page_size=16, n_heads=64, lora_rank=512, rope_dim=64,
               isize=2, kv_isize=2)
    one = kpa.mla_onchip_bytes(1, **mla)
    assert one == (2 * 64 * 576 * 2 + 2 * 576 * 2
                   + 2 * 64 * (4 * 512 + 8) + 64 * 512 * 2)
    # float32's CUDA-core ring stages whole pages, the off kernel lines
    f32 = dict(kw, isize=4)
    assert kpa.gqa_onchip_bytes(17, pipeline="double", **f32) - \
        kpa.gqa_onchip_bytes(17, **f32) == 15 * line


# (kernel, arguments, the bytes counted by hand from its source); page
# 16, one KV head.  GQA bf16 (csrc/gqa_core.cu): each (chunk, row tile)
# block stages its rows' queries and the chunk's lines; one chunk writes
# bf16 output, several write float32 (m, l, acc) partials that the last
# block reads back (m; (m, l) per warp: 2 warps a row at hd 256; acc).
# GQA float32: paged_attention.cu one block per KV head, its G query
# rows, lines 0..L-1; _verify.cu / _ring.cu blocks of f32_row_tile rows,
# each staging the lines its last row sees (the ring whole pages).  MLA
# bf16 (csrc/mla_core.cu): per token, chunks of 32 lines x 2 column
# parts, each part re-staging the 64 heads' queries and the lines, the
# partials written and read once by the merge kernel, the bf16 output.
# MLA float32: 8 blocks of 8 heads a token, each staging the lines.
_GQA = dict(page_size=16, kv_heads=1)
_MLA = dict(page_size=16, n_heads=64, lora_rank=512, rope_dim=64)
_HAND = {
    "gqa bf16 merge hd 256": (
        "gqa", dict(context_len=20, groups=2, head_dim=256, isize=2,
                    kv_isize=2),
        2 * 2 * 256 * 2 + 20 * (2 * 256 * 2) + 2 * 2 * (4 * 256 + 8)
        + 2 * 2 * (4 + 2 * 8 + 4 * 256) + 2 * 256 * 2),
    "gqa bf16 verify two row tiles": (
        "gqa", dict(context_len=10, groups=16, head_dim=64, isize=2,
                    kv_isize=2, n_q=5),
        80 * 64 * 2 + 2 * 14 * (2 * 64 * 2) + 80 * 64 * 2),
    "gqa bf16 int8 pool": (
        "gqa", dict(context_len=10, groups=2, head_dim=128, isize=2,
                    kv_isize=1, quantized=True),
        2 * 128 * 2 + 10 * (2 * 128 + 8) + 2 * 128 * 2),
    "gqa bf16 double = off": (
        "gqa", dict(context_len=20, groups=2, head_dim=128, isize=2,
                    kv_isize=2, pipeline="double"),
        2 * 2 * 128 * 2 + 20 * 512 + 2 * 2 * (4 * 128 + 8)
        + 2 * 2 * (4 + 8 + 4 * 128) + 2 * 128 * 2),
    "gqa f32 decode": (
        "gqa", dict(context_len=10, groups=2, head_dim=64, isize=4,
                    kv_isize=4),
        2 * 64 * 4 + 10 * (2 * 64 * 4) + 2 * 64 * 4),
    "gqa f32 verify two row tiles": (
        "gqa", dict(context_len=10, groups=2, head_dim=64, isize=4,
                    kv_isize=4, n_q=5),
        2 * 10 * 64 * 4 + (13 + 14) * (2 * 64 * 4)),
    "gqa f32 ring whole pages": (
        "gqa", dict(context_len=17, groups=2, head_dim=64, isize=4,
                    kv_isize=4, pipeline="double"),
        2 * 2 * 64 * 4 + 32 * (2 * 64 * 4)),
    "gqa f32 ring verify": (
        "gqa", dict(context_len=10, groups=2, head_dim=64, isize=4,
                    kv_isize=4, n_q=5, pipeline="double"),
        2 * 10 * 64 * 4 + (16 + 16) * (2 * 64 * 4)),
    "mla bf16 verify across a chunk edge": (
        "mla", dict(context_len=32, isize=2, kv_isize=2, n_q=2),
        2 * 64 * 576 * 2 + 2 * 32 * 576 * 2 + 2 * 64 * (4 * 512 + 8)
        + 64 * 512 * 2
        + 2 * 2 * 64 * 576 * 2 + 2 * 33 * 576 * 2
        + 2 * 2 * 64 * (4 * 512 + 8) + 64 * 512 * 2),
    "mla bf16 fp8 pool": (
        "mla", dict(context_len=10, isize=2, kv_isize=1, quantized=True),
        2 * 64 * 576 * 2 + 2 * 10 * (576 + 8) + 2 * 64 * (4 * 512 + 8)
        + 64 * 512 * 2),
    "mla f32 decode": (
        "mla", dict(context_len=10, isize=4, kv_isize=4),
        64 * 576 * 4 + 8 * 10 * 576 * 4 + 64 * 512 * 4),
    "mla f32 ring = off": (
        "mla", dict(context_len=10, isize=4, kv_isize=4, pipeline="double"),
        64 * 576 * 4 + 8 * 10 * 576 * 4 + 64 * 512 * 4),
    "mla f32 verify": (
        "mla", dict(context_len=10, isize=4, kv_isize=4, n_q=2),
        2 * (64 * 576 * 4 + 64 * 512 * 4) + 8 * (10 + 11) * 576 * 4),
}


@pytest.mark.parametrize("case", sorted(_HAND))
def test_vmem_hand_counts_per_kernel(case):
    """Every kernel variant's on-chip count against its hand count, and
    the launch-grid walk against the same number (one layer)."""
    from repro_torch.kernels import paged_attention as kpa
    family, kw, want = _HAND[case]
    kw = dict(kw)
    if family == "gqa":
        got = kpa.gqa_onchip_bytes(**_GQA, **kw)
        walked = txc._gqa_launch_walk(
            kw["context_len"] - 1, kw.get("n_q", 1), 16, 64, 1,
            kw["groups"], kw["head_dim"], kw["isize"], kw["kv_isize"],
            kw.get("quantized", False), kw.get("pipeline", "off"))
    else:
        got = kpa.mla_onchip_bytes(**_MLA, **kw)
        walked = txc._mla_launch_walk(
            kw["context_len"] - 1, kw.get("n_q", 1), 16, 64, 64, 512, 64,
            kw["isize"], kw["kv_isize"], kw.get("quantized", False))
    assert got == want
    assert walked == want


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("family", ["gqa", "mla"])
def test_host_crosscheck_ratio_one(family, kv_dtype):
    cfg = dataclasses.replace(
        tcfg.smoke(tcfg.get_config("qwen3-0.6b" if family == "gqa"
                                   else "deepseek-v2-236b")),
        kv_dtype=kv_dtype)
    kv = tkv.PagedKVCache(cfg, num_slots=2, page_size=4, max_len=32,
                          device=torch.device("cpu"))
    kv.alloc(13)
    view = types.SimpleNamespace(cfg=cfg, _kv=kv, ecfg=types.SimpleNamespace(
        num_slots=2, page_size=4))
    out = txc.crosscheck_host(view)
    assert out["n_blocks"] == 4 and out["host_ratio"] == 1.0
    assert txc.crosscheck_host(view, n_blocks=8)["host_ratio"] == 1.0


def test_step_cost_analysis_walks_decode_and_sampler(engines):
    eng = engines["gqa"]
    step = txc.step_cost_analysis(eng)
    dec = txc.crosscheck_decode(eng)
    assert step["substituted"]
    # the sampler's argmax over (B, V) float32 logits adds bytes, no FLOPs
    assert step["flops"] == dec["hlo_flops"]
    assert step["bytes"] > dec["hlo_bytes"]
    assert step["naive_flops"] == dec["naive_flops"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_overlap_crosscheck(dtype):
    """Pipeline off against double: byte-equal streams and, in bf16 (the
    tensor-core cores, whose stages change overlap, not bytes), a ``vmem``
    term that did not grow; float32's ring stages whole pages, so the
    check refuses it.  On the CPU both engines run the same plain
    versions, so their walls say nothing of overlap and the wall bound is
    left to the card (``chip_smoke.py`` holds the reference's 0.25)."""
    cfg = dataclasses.replace(tcfg.smoke(tcfg.get_config("qwen3-0.6b")),
                              dtype=dtype)
    params = tm.init_params(cfg, device="cpu")
    kw = dict(device="cpu", num_slots=2, page_size=4, max_len=32)
    off = tserve.Engine(cfg, params, tserve.EngineConfig(pipeline="off",
                                                         **kw))
    on = tserve.Engine(cfg, params, tserve.EngineConfig(pipeline="double",
                                                        **kw))
    prompts = [np.random.RandomState(i).randint(0, 256, 9) for i in (1, 2)]
    betas = LevelBetas(pi=1e12, vmem=9e12, hbm=3e12, ici=0.0, dcn=0.0,
                       host=5e10, source="test")
    gen = tserve.GenerateConfig(max_new_tokens=5)
    assert txc.overlapped_levels(on.ecfg) == ["vmem"]
    assert txc.overlapped_levels(off.ecfg) == []
    if dtype == "float32":
        with pytest.raises(RuntimeError, match="grew the vmem"):
            txc.crosscheck_overlap(off, on, prompts, gen, windows=1,
                                   wall_tol=float("inf"), betas=betas)
        return
    out = txc.crosscheck_overlap(off, on, prompts, gen, windows=1,
                                 wall_tol=float("inf"), betas=betas)
    assert out["levels"] == ["vmem"]
    assert out["terms_on"]["vmem"] == pytest.approx(out["terms_off"]["vmem"])
    assert out["terms_off"]["vmem"] > 0 and len(out["generated"]) == 2
