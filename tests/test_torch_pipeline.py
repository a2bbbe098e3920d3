"""The ``pipeline`` knob of the port (the JAX package's page-streaming
schedule, ``pipeline="double"``) against the reference:

* ``kernels/ops.py``: default, scoped and explicit pipelines, the
  reference's refusals, and the dispatch table — a CPU tensor gets the
  plain version whatever the pipeline, a CUDA tensor the off kernels
  (PERF.md rows 1, 3, 4, 5) or the ring kernels (rows 2, 6); checked
  without launching;
* the engines carry ``EngineConfig.pipeline`` to every paged-attention
  dispatch (decode, verify, the draft model's catch-up and steps);
* greedy tokens of the port's engines with ``pipeline="double"`` equal
  ``repro.serve.Engine`` with ``kernel_backend="jnp"`` (the reference's
  own double-pipeline test, ``tests/test_paged_attention.py``, with its
  seeds 100 and 200; the reference's double kernels themselves do not run
  on this jax);
* the VMEM pricing with ``pipeline`` equals the reference's.

The ring kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``, bit-equal to the off kernels).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models as jm
import repro.serve as jserve
from repro.kernels import paged_attention as jpa
from repro.serve import scheduler as jsched
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.serve as tserve
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quantize as tq
from repro_torch.serve import crosscheck as txc
from repro_torch.serve import scheduler as tsched

PAGED = {
    "paged_attention": (tpa.paged_attention, tpa.paged_attention_ring,
                        tpa.paged_attention_reference),
    "paged_attention_verify": (tpa.paged_attention_verify,
                               tpa.paged_attention_ring,
                               tpa.paged_attention_verify_reference),
    "mla_paged_attention": (tpa.mla_paged_attention,
                            tpa.mla_paged_attention_ring,
                            tpa.mla_paged_attention_reference),
    "mla_paged_attention_verify": (tpa.mla_paged_attention_verify,
                                   tpa.mla_paged_attention_ring,
                                   tpa.mla_paged_attention_verify_reference),
}


# --------------------------------------------------------------------------
# kernels/ops.py
# --------------------------------------------------------------------------

def test_default_scoped_and_explicit_pipeline():
    assert ops.default_pipeline() == "off"
    cuda = torch.device("cuda")
    assert ops.resolve("paged_attention", cuda) is tpa.paged_attention
    with ops.use_pipeline("double"):
        assert ops.default_pipeline() == "double"
        assert ops.resolve("paged_attention", cuda) is tpa.paged_attention_ring
        assert ops.resolve("paged_attention", cuda,
                           "off") is tpa.paged_attention
    assert ops.default_pipeline() == "off"
    ops.set_default_pipeline("double")
    try:
        assert ops.resolve("mla_paged_attention",
                           cuda) is tpa.mla_paged_attention_ring
    finally:
        ops.set_default_pipeline("off")
    assert ops.resolve("paged_attention", cuda,
                       "double") is tpa.paged_attention_ring


def test_unknown_pipeline_and_double_on_a_non_paged_op_raise():
    with pytest.raises(ValueError, match="pipeline"):
        ops.set_default_pipeline("triple")
    with pytest.raises(ValueError, match="pipeline"):
        with ops.use_pipeline("triple"):
            pass
    assert ops.default_pipeline() == "off"
    with pytest.raises(ValueError, match="pipeline"):
        ops.resolve("paged_attention", torch.device("cpu"), "triple")
    for op in ("layernorm", "flash_attention", "inner_product"):
        with pytest.raises(ValueError, match="not a paged streaming"):
            ops.resolve(op, torch.device("cpu"), "double")
        assert ops.resolve(op, torch.device("cpu"), "off") is not None


@pytest.mark.parametrize("op", sorted(PAGED))
def test_dispatch_table_without_launching(op):
    off, ring, plain = PAGED[op]
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert ops.resolve(op, cuda, "off") is off
    assert ops.resolve(op, cuda, "double") is ring
    assert ops.resolve(op, cpu, "off") is plain
    assert ops.resolve(op, cpu, "double") is plain
    assert ops.registered_kernels()[op]["ring"] is ring


def test_cpu_tensors_take_the_plain_version_under_double():
    rng = np.random.RandomState(0)
    B, KV, G, hd, page, nb = 2, 2, 2, 16, 4, 3
    P = 1 + B * nb
    q = torch.from_numpy(rng.standard_normal((B, KV, G, hd)).astype("f4"))
    kp = torch.from_numpy(rng.standard_normal((P, page, KV, hd)).astype("f4"))
    vp = torch.from_numpy(rng.standard_normal((P, page, KV, hd)).astype("f4"))
    bt = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32)
    pos = torch.tensor([6, 10], dtype=torch.int32)
    off = ops.paged_attention(q, kp, vp, bt, pos, scale=0.25)
    dbl = ops.paged_attention(q, kp, vp, bt, pos, scale=0.25,
                              pipeline="double")
    assert torch.equal(off, dbl)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tpa.paged_attention_ring(q, kp, vp, bt, pos, scale=0.25)
    kq, ks = tq.quantize(kp, "int8")
    vq, vs = tq.quantize(vp, "int8")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tpa.paged_attention_ring(q, kq, vq, bt, pos, scale=0.25,
                                 k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tpa.mla_paged_attention_ring(q[:, 0], q[:, 1], kp[:, :, 0],
                                     vp[:, :, 0], bt, pos, scale=0.1)


def test_ring_stages_fit_shared_memory():
    # qwen3-0.6b: page 16 x hd 128 x 2 B, K and V: 8 KB a stage
    assert tpa.ring_stages(2 * 16 * 128 * 2, 33) == tpa.RING_MAX_STAGES
    # deepseek-v2 in bf16 and float32: 16 lines x (512 + 64) x 2 / 4 B
    assert tpa.ring_stages(16 * 576 * 2, 17) == 4
    assert tpa.ring_stages(16 * 576 * 4, 17) == 4
    # a 64 KB stage fits three times beside a small table, twice beside
    # a table of 20000 blocks (80 KB)
    assert tpa.ring_stages(64 * 1024, 4) == 3
    assert tpa.ring_stages(64 * 1024, 20000) == 2
    with pytest.raises(ValueError, match="does not fit"):
        tpa.ring_stages(2 * 1024 * 128 * 4, 4)


def test_ring_stage_bytes_count_codes_and_scales():
    """A ring stage holds the page's K / V (latent / rope) lines at the
    pools' element size plus, over a quantized pool, one float32 scale per
    line and pool, padded to 16 bytes (the kernels' ``stage_bytes``)."""
    # qwen3-0.6b: page 16 x hd 128, bf16 and int8 codes + 2 x 16 scales
    assert tpa.gqa_ring_stage_bytes(16, 128, 2) == 2 * 16 * 128 * 2
    assert tpa.gqa_ring_stage_bytes(16, 128, 1, True) == 4096 + 128
    # float32 pools, and a page whose scales need padding: 2 x 3 x 16
    # codes + 2 x 3 x 4 scale bytes = 120 -> 128
    assert tpa.gqa_ring_stage_bytes(16, 64, 4) == 8192
    assert tpa.gqa_ring_stage_bytes(3, 16, 1, True) == 128
    # deepseek-v2: 16 lines x (512 + 64), bf16 / codes + 16 x 2 scales
    assert tpa.mla_ring_stage_bytes(512, 64, 2) == 16 * 576 * 2
    assert tpa.mla_ring_stage_bytes(512, 64, 1, True) == 16 * 576 + 128
    # smoke widths at dr 8: an 8-byte rope line of codes
    assert tpa.mla_ring_stage_bytes(32, 8, 1, True) == 16 * (40 + 8)
    # a quantized stage is about half a bf16 one: four fit beside the
    # table where they did before
    assert tpa.ring_stages(tpa.gqa_ring_stage_bytes(16, 256, 1, True),
                           33) == tpa.RING_MAX_STAGES


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------

def _load(arch):
    jc = jcfg.smoke(jcfg.get_config(arch))
    tc = tcfg.smoke(tcfg.get_config(arch))
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.prepare_params(
        bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu"), tc)
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def qwen():
    return _load("qwen3-0.6b")


@pytest.fixture(scope="module")
def deepseek():
    return _load("deepseek-v2-236b")


ECFG = dict(num_slots=2, page_size=4, max_len=32)


def _prompts(cfg, arch_seed):
    """The reference test's prompts (tests/test_paged_attention.py,
    ``_engine_tokens``)."""
    return [np.asarray(jax.random.randint(
        jax.random.key(arch_seed + i), (5 + i,), 0, cfg.vocab_size))
        for i in range(3)]


def _tokens(eng, mod, prompts, new_tokens=6):
    reqs = [eng.submit(p, mod.GenerateConfig(max_new_tokens=new_tokens))
            for p in prompts]
    eng.run()
    return [[int(t) for t in r.generated] for r in reqs]


def _spy(monkeypatch):
    """Record (op, pipeline) of every paged-attention dispatch."""
    seen = []
    real = ops.resolve

    def resolve(name, device, pipeline=None):
        if name in PAGED:
            seen.append((name, pipeline))
        return real(name, device, pipeline)
    monkeypatch.setattr(ops, "resolve", resolve)
    return seen


@pytest.mark.parametrize("arch,seed", [("qwen3-0.6b", 100),
                                       ("deepseek-v2-236b", 200)])
def test_engine_double_tokens_equal_reference_jnp(arch, seed, qwen,
                                                   deepseek, monkeypatch):
    jc, tc, jp, tp = qwen if arch == "qwen3-0.6b" else deepseek
    prompts = _prompts(jc, seed)
    want = _tokens(jserve.Engine(jc, jp, jserve.EngineConfig(
        kernel_backend="jnp", **ECFG)), jserve, prompts)
    seen = _spy(monkeypatch)
    got = _tokens(tserve.Engine(tc, tp, tserve.EngineConfig(
        device="cpu", pipeline="double", prefill_chunk=3, **ECFG)), tserve,
        prompts)
    assert got == want
    op = "paged_attention" if arch == "qwen3-0.6b" else "mla_paged_attention"
    assert seen and set(seen) == {(op, "double")}


@pytest.mark.parametrize("proposer", ["draft", "ngram"])
def test_spec_engine_double_tokens_equal_reference_jnp(proposer, qwen,
                                                        monkeypatch):
    """SpecEngine (draft = target weights, so drafts are accepted and the
    multi-token commit runs) under pipeline="double": every verify, draft
    catch-up and draft step dispatch carries the pipeline, and the greedy
    tokens equal the reference's sequential jnp engine."""
    jc, tc, jp, tp = qwen
    prompts = _prompts(jc, 100)
    want = _tokens(jserve.Engine(jc, jp, jserve.EngineConfig(
        kernel_backend="jnp", **ECFG)), jserve, prompts, 8)
    seen = _spy(monkeypatch)
    scfg = tserve.SpecConfig(k=3, proposer=proposer,
                             **({"draft_cfg": tc, "draft_params": tp}
                                if proposer == "draft" else {}))
    eng = tserve.SpecEngine(tc, tp, tserve.EngineConfig(
        device="cpu", pipeline="double", **ECFG), scfg)
    got = _tokens(eng, tserve, prompts, 8)
    assert got == want
    assert eng.verify_steps > 0
    ops_seen = {name for name, _ in seen}
    assert {pl for _, pl in seen} == {"double"}
    assert "paged_attention_verify" in ops_seen
    if proposer == "draft":
        assert "paged_attention" in ops_seen       # the draft's steps


def test_engine_refuses_an_unknown_pipeline(qwen):
    _, tc, _, tp = qwen
    with pytest.raises(ValueError, match="pipeline"):
        tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu",
                                                  pipeline="triple"))
    with pytest.raises(ValueError, match="pipeline"):
        tserve.SpecEngine(tc, tp, tserve.EngineConfig(device="cpu",
                                                      pipeline="quad"))
    assert tserve.EngineConfig().pipeline == "off"


def test_serve_cli_pipeline_flag_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "6", "--new-tokens", "3", "--pipeline",
                "double", "--spec", "ngram"])
    out = capsys.readouterr().out
    assert "(pipeline double)" in out and "[serve/spec]" in out


# --------------------------------------------------------------------------
# VMEM pricing: the reference's TPU grids (the kernel helpers), the CUDA
# kernels' on-chip bytes (the ledger)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", ["off", "double"])
@pytest.mark.parametrize("n_q", [1, 5])
def test_kernel_vmem_pricing_equals_reference(pipeline, n_q):
    for ctx in (1, 17, 300):
        kw = dict(context_len=ctx, page_size=16, n_heads=16, kv_heads=8,
                  head_dim=128, isize=2, n_q=n_q, pipeline=pipeline)
        assert (tpa.paged_decode_vmem_bytes(**kw)
                == jpa.paged_decode_vmem_bytes(**kw))
        kw = dict(context_len=ctx, page_size=16, n_heads=128,
                  lora_rank=512, rope_dim=64, isize=2, n_q=n_q,
                  pipeline=pipeline)
        assert (tpa.mla_paged_decode_vmem_bytes(**kw)
                == jpa.mla_paged_decode_vmem_bytes(**kw))
    assert (tpa.paged_decode_vmem_bytes(
        context_len=300, page_size=16, n_heads=16, kv_heads=8, head_dim=128,
        isize=2, n_q=n_q, pipeline="double")
        < tpa.paged_decode_vmem_bytes(
            context_len=300, page_size=16, n_heads=16, kv_heads=8,
            head_dim=128, isize=2, n_q=n_q, pipeline="off"))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b",
                                  "qwen3-14b"])
@pytest.mark.parametrize("pipeline", ["off", "double"])
def test_scheduler_vmem_pricing_equals_reference(arch, pipeline,
                                                 monkeypatch):
    # the ledger's on-chip term is the CUDA kernels' count: the reference's
    # ledger is priced with the launch-grid walk of those kernels, so the
    # rest of it stays the baseline and the term is held against the walk
    monkeypatch.setattr(jsched, "attn_kernel_vmem_bytes",
                        txc.kernel_walk_vmem_bytes)
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    for ctx, n_fed in ((1, 1), (97, 4), (229, 5)):
        assert (tsched.attn_kernel_vmem_bytes(tc, ctx, 16, n_q=n_fed,
                                              pipeline=pipeline)
                == jsched.attn_kernel_vmem_bytes(jc, ctx, 16, n_q=n_fed,
                                                 pipeline=pipeline))
        assert (tsched.decode_token_vmem_bytes(tc, ctx, 4, 16,
                                               pipeline=pipeline)
                == jsched.decode_token_vmem_bytes(jc, ctx, 4, 16,
                                                  pipeline=pipeline))
        assert (tsched.verify_step_vmem_bytes(tc, ctx, n_fed, 4, 16,
                                              pipeline=pipeline)
                == jsched.verify_step_vmem_bytes(jc, ctx, n_fed, 4, 16,
                                                 pipeline=pipeline))


def test_engine_ledger_prices_its_pipeline(qwen, monkeypatch):
    """The engine charges the decode steps' VMEM bytes at its own
    pipeline, as the reference's does: the CUDA kernel the pipeline
    dispatches to, priced on the reference's side by the launch-grid
    walk."""
    monkeypatch.setattr(jsched, "attn_kernel_vmem_bytes",
                        txc.kernel_walk_vmem_bytes)
    jc, tc, jp, tp = qwen
    prompts = _prompts(jc, 100)
    led = {}
    for pl in ("off", "double"):
        jeng = jserve.Engine(jc, jp, jserve.EngineConfig(
            kernel_backend="jnp", pipeline=pl, **ECFG))
        teng = tserve.Engine(tc, tp, tserve.EngineConfig(
            device="cpu", pipeline=pl, **ECFG))
        _tokens(jeng, jserve, prompts)
        _tokens(teng, tserve, prompts)
        led[pl] = teng.aggregate_ledger().decode_vmem_bytes
        assert led[pl] == pytest.approx(
            jeng.aggregate_ledger().decode_vmem_bytes, rel=1e-12)
    # the smoke model is float32: its ring (csrc/paged_attention_ring.cu)
    # stages whole pages where the off kernel stops at the last visible
    # line, so double moves more on-chip bytes (bf16's core moves the same)
    assert led["double"] > led["off"]
