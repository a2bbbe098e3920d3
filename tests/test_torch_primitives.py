"""The paper's primitives in the port against the JAX package on the CPU:
the plain versions against ``repro.kernels.ref``, the port's ops (which
run the plain versions on CPU tensors) against the Pallas kernels in
interpret mode, the analytic W/Q against the reference's HLO cost walk,
the microbench cache's fingerprint guard, and the slice as a whole
(``launch/primitives.py --device cpu --shapes smoke``).

Inputs are numpy arrays from a seed, handed to both packages.  Shapes and
tolerances are those of ``tests/test_kernels.py``: float32 rtol 3e-5 /
atol 3e-4, bf16 3e-2, Winograd against direct rtol 2e-3 / atol 5e-3.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.analysis import kernel_character
from repro.kernels import ops as jops
from repro.kernels import ref as jref
import repro.kernels.conv_direct as jconv
import repro.kernels.conv_winograd as jwino
import repro.kernels.gelu as jgelu
import repro.kernels.inner_product as jip
import repro.kernels.layernorm as jln

from repro_torch import bridge
from repro_torch.core import analysis
from repro_torch.core.roofline import microbench
from repro_torch.kernels import conv_direct as tconv
from repro_torch.kernels import gelu as tgelu
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import primitives

TOL = {"float32": dict(rtol=3e-5, atol=3e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
WINO_TOL = dict(rtol=2e-3, atol=5e-3)


def both(shape, dtype="float32", seed=0, scale=1.0):
    """The same values as a JAX array and a CPU torch tensor."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, bridge.to_torch(np.asarray(j), device="cpu")


def close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(bridge.to_numpy(t), np.float32),
                               np.asarray(j, np.float32), **tol)


# --------------------------------------------------------------------------
# plain versions against repro.kernels.ref
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gelu_and_inner_product_match_reference(dtype):
    jx, tx = both((64, 96), dtype, 1, 2.0)
    jw, tw = both((96, 40), dtype, 2)
    close(tref.gelu(tx), jref.gelu(jx), **TOL[dtype])
    close(tref.inner_product(tx, tw), jref.inner_product(jx, jw),
          **TOL[dtype])
    jb, tb = both((40,), dtype, 3)
    close(tref.inner_product(tx, tw, tb), jref.inner_product(jx, jw, jb),
          **TOL[dtype])


@pytest.mark.parametrize("hw,k", [(8, 3), (7, 3), (6, 1), (9, 5)])
def test_plain_conv2d_matches_reference(hw, k):
    jx, tx = both((2, hw, hw + 1, 6), seed=hw)
    jw, tw = both((k, k, 6, 10), seed=k, scale=0.1)
    close(tref.conv2d(tx, tw), jref.conv2d(jx, jw), **TOL["float32"])


@pytest.mark.parametrize("hw", [8, 10, 7])
def test_plain_winograd_pieces_match_reference(hw):
    jx, tx = both((2, hw, hw + 2, 8), seed=hw)
    jw, tw = both((3, 3, 8, 16), seed=1, scale=0.1)
    jt, (nh, nw, c) = jref.winograd_tiles(jx)
    tt, dims = tref.winograd_tiles(tx)
    assert dims == (nh, nw, c)
    close(tt, jt, rtol=0, atol=0)
    close(tref.winograd_kernel_transform(tw),
          jref.winograd_kernel_transform(jw), rtol=1e-6, atol=1e-7)
    close(tref.conv2d_winograd(tx, tw), jref.conv2d_winograd(jx, jw),
          **TOL["float32"])
    close(tref.conv2d_winograd(tx, tw), jref.conv2d(jx, jw), **WINO_TOL)


# --------------------------------------------------------------------------
# the port's ops against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 512),
                                   (512, 256, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inner_product_matches_pallas(m, k, n, dtype):
    jx, tx = both((m, k), dtype, 0)
    jw, tw = both((k, n), dtype, 1)
    close(tops.inner_product(tx, tw),
          jip.inner_product(jx, jw, interpret=True), **TOL[dtype])


@pytest.mark.parametrize("fuse", ["none", "relu", "gelu"])
def test_inner_product_epilogues_match_pallas(fuse):
    jx, tx = both((256, 256), seed=0)
    jw, tw = both((256, 256), seed=1)
    out = tops.inner_product(tx, tw, fuse)
    close(out, jip.inner_product(jx, jw, fuse=fuse, interpret=True),
          rtol=1e-4, atol=1e-4)
    if fuse == "gelu":
        close(out, jref.gelu(jref.inner_product(jx, jw)), rtol=1e-4,
              atol=1e-4)


@pytest.mark.parametrize("shape", [(256, 128), (512, 384), (8, 1024, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_layouts_match_pallas(shape, dtype):
    jx, tx = both(shape, dtype, 0, 2.0)
    blocked, naive = tops.gelu(tx), tops.gelu_naive(tx)
    close(blocked, jgelu.gelu_blocked(jx, interpret=True), **TOL[dtype])
    close(naive, jgelu.gelu_naive(jx, interpret=True), **TOL[dtype])
    assert torch.equal(blocked, naive)


@pytest.mark.parametrize("to", [8, 128, 3])
def test_pad_channels_matches_reference(to):
    jx, tx = both((4, 5, 3), seed=to)
    tp = tgelu.pad_channels(tx, to)
    close(tp, jgelu.pad_channels(jx, to), rtol=0, atol=0)
    assert tp.shape[-1] == -(-3 // to) * to
    assert (tgelu.pad_channels(tx, to) is tx) == (to == 3)


@pytest.mark.parametrize("hw,cin,cout", [(8, 32, 128), (12, 64, 128)])
def test_conv_direct_matches_pallas(hw, cin, cout):
    jx, tx = both((1, hw, hw, cin), seed=0)
    jw, tw = both((3, 3, cin, cout), seed=1, scale=0.1)
    close(tops.conv2d(tx, tw), jops.conv2d(jx, jw), rtol=3e-4, atol=3e-3)


@pytest.mark.parametrize("kh,kw", [(2, 2), (1, 4), (5, 3)])
def test_conv_direct_pad_split_matches_pallas(kh, kw):
    """Even kernels pad kh // 2 before, as the Pallas wrapper does."""
    jx, tx = both((2, 7, 6, 4), seed=kh)
    jw, tw = both((kh, kw, 4, 128), seed=kw, scale=0.1)
    close(tconv.conv2d_direct_reference(tx, tw),
          jconv.conv2d_direct(jx, jw, interpret=True), rtol=3e-4, atol=3e-3)


def test_winograd_stage_matches_pallas():
    jv, tv = both((16, 256, 32), seed=0)
    ju, tu = both((16, 32, 128), seed=1)
    out = tops.winograd_elementwise_stage(tv, tu)
    assert out.dtype == torch.float32
    close(out, jwino.winograd_elementwise_stage(jv, ju, interpret=True),
          **TOL["float32"])


@pytest.mark.parametrize("hw", [8, 10])
def test_conv_winograd_matches_pallas_and_direct(hw):
    jx, tx = both((2, hw, hw, 32), seed=0)
    jw, tw = both((3, 3, 32, 128), seed=1, scale=0.1)
    out = tops.conv2d_winograd(tx, tw)
    close(out, jops.conv2d_winograd(jx, jw), **TOL["float32"])
    close(out, jref.conv2d(jx, jw), **WINO_TOL)


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import conv_winograd, inner_product
    x = torch.ones((2, 2))
    for fn, args in ((inner_product.inner_product, (x, x)),
                     (tgelu.gelu_2d, (x,)),
                     (tconv.conv2d_direct, (x[None, None], x[None, None])),
                     (conv_winograd.winograd_elementwise_stage,
                      (x[None], x[None]))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


@pytest.mark.parametrize("code,words", [
    (-1, "cuda-cores f32"),
    (0 | 0 << 2 | 16, "wgmma 128x256, A tma, B tma"),
    (2 | 0 << 2, "wgmma 128x128, A element-wise, B tma"),
    (1 | 2 << 2, "wgmma 128x128, A cp.async, B element-wise"),
    (2 | 2 << 2, "wgmma 128x128, A element-wise, B element-wise"),
    (-2, "cuda-cores f32, A cp.async, B cp.async"),
    (-2 - 1, "cuda-cores f32, A element-wise, B cp.async"),
    (-2 - (1 << 1), "cuda-cores f32, A cp.async, B element-wise"),
    (-2 - (1 | 1 << 1), "cuda-cores f32, A element-wise, B element-wise"),
])
def test_plan_codes_read_as_words(code, words):
    # the C launch functions' plan codes (wg::plan_code): A producer in
    # bits 0-1, B producer in bits 2-3, 256 columns in bit 4; float32
    # (gemm::plan_code) -2 - (A | B << 1), A and B 0 for 16-byte cp.async
    # copies, 1 element-wise
    from repro_torch.kernels import inner_product
    assert inner_product.describe_plan(code) == words


def test_winograd_plan_words_and_cpu_refusal():
    # the stage's plan is the float32 core's (gemm::plan_code), read with
    # the same words; asking for it needs the CUDA library
    from repro_torch.kernels import conv_winograd
    assert conv_winograd.describe_plan(-2) == (
        "cuda-cores f32, A cp.async, B cp.async")
    assert conv_winograd.describe_plan(-5) == (
        "cuda-cores f32, A element-wise, B element-wise")
    v, u = torch.ones((16, 3, 4)), torch.ones((16, 4, 5))
    with pytest.raises(ValueError, match="CUDA"):
        conv_winograd.plan(v, u)


# --------------------------------------------------------------------------
# analytic W / Q against the reference's cost walk (exact)
# --------------------------------------------------------------------------

def _same(mine, ref, keys=("W_flops", "Q_bytes", "transcendentals")):
    for k in keys:
        assert mine[k] == pytest.approx(ref[k], rel=1e-9, abs=0), k


@pytest.mark.parametrize("fuse", ["none", "relu", "gelu"])
def test_inner_product_character_matches_cost_walk(fuse):
    m, k, n = 256, 384, 512
    x, w = jnp.ones((m, k)), jnp.ones((k, n))
    act = {"none": lambda y: y, "relu": lambda y: jnp.maximum(y, 0.0),
           "gelu": jref.gelu}[fuse]
    got = kernel_character(lambda a, b: act(jref.inner_product(a, b)), x, w)
    mine = analysis.inner_product_character(m, k, n, "float32", fuse)
    # the reference's XLA program writes the product and reads it back for
    # the epilogue: the unfused traffic; the kernel fuses it
    _same(dict(mine, Q_bytes=mine["Q_unfused"]), got)
    assert mine["Q_bytes"] == (m * k + k * n + m * n) * 4 == (
        analysis.inner_product_character(m, k, n)["Q_bytes"])
    if fuse == "none":
        assert mine["Q_bytes"] == 1703936
        assert mine["W_flops"] == 2 * m * k * n


@pytest.mark.parametrize("shape", [(4096, 512), (64, 100)])
def test_gelu_character_matches_cost_walk(shape):
    got = kernel_character(jref.gelu, jnp.ones(shape))
    _same(analysis.gelu_character(shape, "float32"), got)


def test_gelu_padding_ratios_match_cost_walk():
    """Paper section 3.4: C = 3 padded to 8 / 128, the pad counted."""
    x = jnp.ones((256, 227, 3))
    chars = {}
    for to in (None, 8, 128):
        fn = jref.gelu if to is None else (
            lambda t, to=to: jref.gelu(jgelu.pad_channels(t, to)))
        got = kernel_character(fn, x)
        chars[to] = analysis.gelu_character((256, 227, 3), "float32", to)
        _same(chars[to], got)
    assert chars[8]["W_flops"] / chars[None]["W_flops"] == pytest.approx(
        8 / 3, rel=1e-9)
    assert chars[8]["Q_bytes"] / chars[None]["Q_bytes"] == pytest.approx(
        4.5, rel=1e-6)


def test_conv_characters_match_cost_walk():
    x, w = jnp.ones((4, 28, 28, 128)), jnp.ones((3, 3, 128, 128))
    direct = analysis.conv2d_character(4, 28, 28, 128, 128)
    _same(direct, kernel_character(jref.conv2d, x, w))
    assert direct["W_flops"] == 924844032 and direct["Q_bytes"] == 3801088
    t = analysis.winograd_tile_count(4, 28, 28)
    stage = analysis.winograd_stage_character(t, 128, 128)
    v, u = jnp.ones((16, t, 128)), jnp.ones((16, 128, 128))
    _same(stage, kernel_character(
        lambda a, b: jnp.einsum("ptc,pcf->ptf", a, b), v, u))
    assert direct["W_flops"] / stage["W_flops"] == pytest.approx(2.25)
    # the whole Winograd conv: the transforms counted as the reference's
    # einsums; the cost walk adds ~126 FLOPs of tile-index arithmetic
    whole = analysis.winograd_conv_character(4, 28, 28, 128, 128)
    assert whole["W_flops"] == pytest.approx(
        kernel_character(jref.conv2d_winograd, x, w)["W_flops"], rel=1e-6)


# --------------------------------------------------------------------------
# microbench cache fingerprint guard (the plain probes on the CPU)
# --------------------------------------------------------------------------

def test_foreign_cache_falls_back_analytic_without_remeasure(tmp_path):
    cache = tmp_path / "microbench.json"
    foreign = microbench.MicrobenchResult(
        fma_flops=1.0, matmul_flops={"float32": 1.0, "bfloat16": 1.0},
        bandwidth={"copy": 1.0, "fill": 1.0, "triad": 1.0, "best": 1.0},
        fingerprint={"schema": microbench.CACHE_SCHEMA,
                     "device_kind": "NVIDIA H999", "n_devices": 4096})
    cache.write_text(json.dumps(dataclasses.asdict(foreign)))
    before = cache.read_text()
    with pytest.warns(UserWarning, match="falling back to the analytic"):
        res = microbench.run_microbench(cache_path=cache, device="cpu")
    assert res.source == "analytic"
    assert res.peak_flops == 989e12            # H100_SXM, not the stale 1.0
    assert res.flops_for("float32") == 67e12
    assert cache.read_text() == before         # no re-measure, no rewrite


def test_matching_cache_roundtrips_and_schema_bump_falls_back(tmp_path):
    cache = tmp_path / "microbench.json"
    first = microbench.run_microbench(cache_path=cache, device="cpu")
    assert first.source == "measured" and cache.exists()
    assert first.peak_flops == max(first.fma_flops,
                                   *first.matmul_flops.values())
    assert set(first.matmul_flops) == {"float32", "bfloat16"}
    assert first.warm_cold["cold_s"] > 0 and first.bandwidth["best"] > 0
    again = microbench.run_microbench(cache_path=cache, device="cpu")
    assert again == first
    spec = again.to_chipspec()
    assert spec.flops_for("bfloat16") == first.matmul_flops["bfloat16"]
    assert spec.hbm_bw == first.peak_bw
    assert again.level_betas().hbm == first.peak_bw
    d = json.loads(cache.read_text())
    d["fingerprint"]["schema"] = microbench.CACHE_SCHEMA - 1
    cache.write_text(json.dumps(d))
    with pytest.warns(UserWarning, match="falling back to the analytic"):
        stale = microbench.run_microbench(cache_path=cache, device="cpu")
    assert stale.source == "analytic"


def test_microbench_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for hosts without")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        microbench.run_microbench(cache_path=None)


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

def _numpy_make(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


@pytest.fixture(scope="module")
def smoke_study():
    roof = microbench.MicrobenchResult.analytic()
    study = primitives.Study(torch.device("cpu"), roof, make=_numpy_make,
                             keep_outputs=True)
    study.run("smoke")
    return study


def test_smoke_study_rows_match_reference_outputs(smoke_study):
    jfn = {
        "inner_product.f32": jref.inner_product,
        "inner_product.fused_gelu":
            lambda a, b: jip.inner_product(a, b, bm=96, bn=72, bk=80,
                                           fuse="gelu", interpret=True),
        "gelu.flat.blocked": lambda t: jgelu.gelu_blocked(t, interpret=True),
        "gelu.flat.naive": lambda t: jgelu.gelu_naive(t, interpret=True),
        "gelu.c3_natural": jref.gelu,
        "gelu.c3_padded8": lambda t: jref.gelu(jgelu.pad_channels(t, 8)),
        "gelu.c3_padded128": lambda t: jref.gelu(jgelu.pad_channels(t, 128)),
        "conv.direct": jops.conv2d,
        "conv.winograd_stage":
            lambda v, u: jwino.winograd_elementwise_stage(v, u,
                                                          interpret=True),
        "conv.winograd": jops.conv2d_winograd,
        "layernorm.f32_d40":
            lambda x, s, b: jln.layernorm(x, s, b, interpret=True),
        "pool.avg_blocked_nhwc": lambda t: jops.avg_pool(t, window=2),
        "pool.avg_naive_nchw": lambda t: jops.avg_pool_naive(t, window=2),
        "pool.avg_naive_nchw.kernel":
            lambda t: jref.avg_pool(t.transpose(0, 2, 3, 1), 2,
                                    2).transpose(0, 3, 1, 2),
        "pool.max": lambda t: jops.max_pool(t, window=2, stride=2),
        "pool.w3.avg_blocked_nhwc": lambda t: jops.avg_pool(t, window=3),
        "pool.w3.avg_naive_nchw": lambda t: jops.avg_pool_naive(t, window=3),
        "pool.w3.avg_naive_nchw.kernel":
            lambda t: jref.avg_pool(t.transpose(0, 2, 3, 1), 3,
                                    3).transpose(0, 3, 1, 2),
        "pool.w3.max": lambda t: jops.max_pool(t, window=3, stride=3),
        "flash_attention.f32_s80":
            lambda q, k, v: jops.flash_attention(q, k, v, causal=True),
        "flash_attention.f32_sq48_sk96_full":
            lambda q, k, v: jops.flash_attention(q, k, v, causal=False),
    }
    assert set(smoke_study.outputs) == set(jfn)
    for name, fn in jfn.items():
        args = [jnp.asarray(bridge.to_numpy(a))
                for a in smoke_study.inputs[name]]
        close(smoke_study.outputs[name], fn(*args), **TOL["float32"])


def test_smoke_study_counts_match_cost_walk(smoke_study):
    rows = {r.name: r for r in smoke_study.rows}
    checked = 0
    for name, r in rows.items():
        args = [jnp.asarray(bridge.to_numpy(a))
                for a in smoke_study.inputs[name]]
        if name.startswith("inner_product"):
            fuse = "gelu" if "gelu" in name else "none"
            fn = (lambda a, b: jref.gelu(jref.inner_product(a, b))) if (
                fuse == "gelu") else jref.inner_product
            got = kernel_character(fn, *args)
            _same(dict(r.char, Q_bytes=r.char["Q_unfused"]), got)
        elif name.startswith("gelu"):
            to = {"c3_padded8": 8, "c3_padded128": 128}.get(
                name.split(".")[1])
            fn = jref.gelu if to is None else (
                lambda t, to=to: jref.gelu(jgelu.pad_channels(t, to)))
            _same(r.char, kernel_character(fn, *args))
        elif name == "conv.direct":
            _same(r.char, kernel_character(jref.conv2d, *args))
        elif name == "conv.winograd_stage":
            _same(r.char, kernel_character(
                lambda v, u: jnp.einsum("ptc,pcf->ptf", v, u), *args))
        elif name.startswith("layernorm"):
            got = kernel_character(jref.layernorm, *args)
            # the walk adds XLA:CPU's partial sums of a row over 32 values
            # (D 40: two windows, in both row sums): 4 per row
            rows_ = args[0].shape[0]
            _same(dict(r.char, W_flops=r.char["W_flops"] + 4 * rows_), got,
                  ("W_flops", "transcendentals"))
        elif name.startswith("pool"):
            win = 3 if ".w3." in name else 2
            x = args[0]
            if name.endswith(".kernel"):                    # NCHW input
                x = x.transpose(0, 2, 3, 1)
            fn = jref.max_pool if name.endswith(".max") else jref.avg_pool
            got = kernel_character(lambda t: fn(t, win, win), x)
            _same(dict(r.char, Q_bytes=r.char["Q_unfused"]), got)
        elif name.startswith("flash_attention"):
            # useful work only (ref.mha's walk materialises the scores)
            b, sq, h, hd = args[0].shape
            sk = args[1].shape[1]
            causal = not name.endswith("_full")
            pairs = sum(min(i + 1, sk) if causal else sk for i in range(sq))
            assert r.char["W_flops"] == 4 * hd * b * h * pairs
        else:
            continue
        checked += 1
    assert checked == 20


def test_smoke_study_places_rows_on_the_roof(smoke_study):
    roof = smoke_study.roof
    for r in smoke_study.rows:
        pi = roof.flops_for(r.dtype)
        bound = max(r.char["W_flops"] / pi,
                    r.char["Q_bytes"] / roof.peak_bw)
        assert r.bound_s == pytest.approx(bound)
        assert r.util_roof == pytest.approx(bound / r.seconds)
        assert r.bound_by == ("bytes" if r.char["Q_bytes"] / roof.peak_bw
                              >= r.char["W_flops"] / pi else "operations")
    emitted = {line.split(",")[0] for line in smoke_study.emitted}
    assert {"gelu.forced_blocked_waste", "conv.winograd_work_reduction",
            "gelu.flat.layouts_bitwise_equal",
            "inner_product.fused_gelu.fusion_traffic"} <= emitted
    waste = next(line for line in smoke_study.emitted
                 if line.startswith("gelu.forced_blocked_waste"))
    assert "W8/W=2.67;Q8/Q=4.50" in waste


def test_primitives_cli_on_the_cpu(capsys):
    study = primitives.main(["--device", "cpu", "--shapes", "smoke",
                             "--cache", "", "--only", "gelu"])
    out = capsys.readouterr().out
    assert "host numbers, not the card's" in out
    assert "gelu.flat.blocked," in out and "util_roof=" in out
    assert "--- GELU roofline" in out
    assert [r.name for r in study.rows][:2] == ["gelu.flat.blocked",
                                                "gelu.flat.naive"]


def test_conv_section_adds_a_float32_direct_row_to_other_dtypes():
    # a bf16 convolution cell also runs the direct convolution in float32
    # (the float32 GEMM core on the card), against cuDNN with TF32 off for
    # that call only; its output is the reference's float32 convolution
    roof = microbench.MicrobenchResult.analytic()
    study = primitives.Study(torch.device("cpu"), roof, make=_numpy_make,
                             keep_outputs=True)
    tf32 = torch.backends.cudnn.allow_tf32
    rows = {r.name: r for r in study.conv((1, 6, 8, 12, "bfloat16"))}
    assert torch.backends.cudnn.allow_tf32 == tf32
    assert list(rows) == ["conv.direct", "conv.winograd_stage",
                          "conv.winograd", "conv.direct.f32"]
    r = rows["conv.direct.f32"]
    assert r.dtype == "float32" and rows["conv.direct"].dtype == "bfloat16"
    assert r.char == analysis.conv2d_character(1, 6, 6, 8, 12, 3, 3,
                                               "float32")
    x, w = study.inputs["conv.direct.f32"]
    assert x.dtype == w.dtype == torch.float32
    close(study.outputs["conv.direct.f32"],
          jref.conv2d(jnp.asarray(x.numpy()), jnp.asarray(w.numpy())),
          **TOL["float32"])
