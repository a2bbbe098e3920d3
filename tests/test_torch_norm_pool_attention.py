"""LayerNorm, average / max pooling and flash attention in the port against
the JAX package on the CPU: the port's ops (which run the plain versions
on CPU tensors) against the Pallas kernels in interpret mode and the
``repro.kernels.ref`` oracles, the analytic W / Q against the reference's
HLO cost walk, and the CUDA wrappers' refusal of CPU tensors.

Inputs are numpy arrays from a seed, handed to both packages.  Shapes and
float32 tolerances are those of ``tests/test_kernels.py``: LayerNorm rtol
2e-5 / atol 2e-4, pooling 1e-6, flash attention 3e-4.  In bf16 the port's
flash attention is held against the Pallas kernel, which computes in
float32 and rounds once as the port does, so the two differ by at most one
bf16 rounding of the same float32 value (rtol 2^-7, one ulp); ``ref.mha``
rounds p to bf16 before the PV product, about 1e-2 away, and is held only
against the port's own ``ref.mha`` (the reference tests' 5e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.analysis import kernel_character
from repro.core.roofline import substitute as jsub
from repro.kernels import ops as jops
from repro.kernels import ref as jref
import repro.kernels.avgpool as javg
import repro.kernels.flash_attention as jfa
import repro.kernels.layernorm as jln

from repro_torch import bridge
from repro_torch.core import analysis
from repro_torch.kernels import avgpool as tpool
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import layernorm as tln
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

LN_TOL = dict(rtol=2e-5, atol=2e-4)
POOL_TOL = dict(rtol=1e-6, atol=1e-6)
FLASH_TOL = dict(rtol=3e-4, atol=3e-4)
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-6)
BF16_MHA = dict(rtol=5e-2, atol=5e-2)


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
# LayerNorm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("r,d", [(256, 128), (512, 768), (128, 1024)])
def test_layernorm_matches_pallas_and_reference(r, d):
    jx, tx = both((r, d), seed=0, scale=3.0)
    js, ts = both((d,), seed=1)
    jb, tb = both((d,), seed=2)
    out = tops.layernorm(tx, ts, tb)
    close(out, jln.layernorm(jx, js, jb, interpret=True), **LN_TOL)
    close(out, jref.layernorm(jx, js, jb), **LN_TOL)
    close(tref.layernorm(tx, ts, tb), jref.layernorm(jx, js, jb), **LN_TOL)


def test_layernorm_bf16_and_leading_dims_match_pallas():
    jx, tx = both((4, 64, 256), "bfloat16", seed=3, scale=3.0)
    js, ts = both((256,), seed=4)
    jb, tb = both((256,), seed=5)
    out = tops.layernorm(tx, ts, tb)
    assert out.shape == (4, 64, 256) and out.dtype == torch.bfloat16
    close(out, jln.layernorm(jx, js, jb, interpret=True), **BF16_ULP)


def test_layernorm_is_two_pass():
    """A row far from 0 with a small spread: E[x^2] - mu^2 in float32 would
    lose the variance; the two-pass mean of squared deviations keeps it."""
    a = (1e4 + np.arange(64, dtype=np.float32) * 1e-2)[None]
    s, b = np.ones(64, np.float32), np.zeros(64, np.float32)
    out = tops.layernorm(torch.from_numpy(a), torch.from_numpy(s),
                         torch.from_numpy(b))
    close(out, jref.layernorm(jnp.asarray(a), jnp.asarray(s),
                              jnp.asarray(b)), **LN_TOL)
    assert float(out.std()) == pytest.approx(1.0, rel=1e-2)


# --------------------------------------------------------------------------
# average and max pooling
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window", [2, 4])
@pytest.mark.parametrize("c", [128, 256])
def test_avg_pool_walks_match_pallas_and_reference(window, c):
    jx, tx = both((2, 16, 16, c), seed=c)
    blocked = tops.avg_pool(tx, window)
    naive = tops.avg_pool_naive(tx, window)
    close(blocked, jops.avg_pool(jx, window=window), **POOL_TOL)
    close(naive, jops.avg_pool_naive(jx, window=window), **POOL_TOL)
    close(blocked, jref.avg_pool(jx, window, window), **POOL_TOL)
    assert torch.equal(blocked, naive)


@pytest.mark.parametrize("shape,window", [((2, 7, 9, 3), 2),
                                          ((1, 11, 17, 130), 3),
                                          ((3, 15, 13, 64), 4),
                                          ((1, 6, 6, 8), 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_avg_pool_crops_like_the_reference(shape, window, dtype):
    jx, tx = both(shape, dtype, seed=window)
    blocked = tops.avg_pool(tx, window)
    assert blocked.shape == (shape[0], shape[1] // window,
                             shape[2] // window, shape[3])
    tol = POOL_TOL if dtype == "float32" else BF16_ULP
    close(blocked, jref.avg_pool(jx, window, window), **tol)
    close(blocked, javg.avg_pool_blocked(jx, window=window, bh=1,
                                         interpret=True), **tol)
    assert torch.equal(blocked, tops.avg_pool_naive(tx, window))


def test_naive_walk_transposes_around_the_nchw_version():
    _, tx = both((2, 9, 10, 16), seed=1)
    seen = []

    def nchw(xc, window):
        seen.append((tuple(xc.shape), xc.is_contiguous()))
        return tpool.avg_pool_nchw_reference(xc, window=window)
    out = tpool.naive_walk(tx, 2, nchw)
    assert seen == [((2, 16, 8, 10), True)]          # cropped, then NCHW
    assert out.shape == (2, 4, 5, 16) and out.is_contiguous()
    assert torch.equal(out, tops.avg_pool(tx, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (3, 3)])
def test_max_pool_matches_reference(dtype, window, stride):
    jx, tx = both((2, 11, 9, 32), dtype, seed=window)
    out = tops.max_pool(tx, window, stride)
    close(out, jops.max_pool(jx, window=window, stride=stride), rtol=0,
          atol=0)
    assert out.dtype == tx.dtype


# --------------------------------------------------------------------------
# flash attention (model layout through ops; head layout in the module)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S,H,KV,hd", [(256, 4, 2, 64), (256, 4, 4, 128),
                                       (512, 8, 1, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_and_mha(S, H, KV, hd, causal):
    jq, tq = both((2, S, H, hd), seed=0)
    jk, tk = both((2, S, KV, hd), seed=1)
    jv, tv = both((2, S, KV, hd), seed=2)
    out = tops.flash_attention(tq, tk, tv, causal)
    assert out.shape == (2, S, H, hd)
    close(out, jops.flash_attention(jq, jk, jv, causal=causal), **FLASH_TOL)
    close(out, jref.mha(jq, jk, jv, causal=causal), **FLASH_TOL)
    close(tref.mha(tq, tk, tv, causal=causal),
          jref.mha(jq, jk, jv, causal=causal), **FLASH_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sq_below_sk_matches_pallas(causal):
    """Sq 128 against Sk 256: the mask is top-left (query i sees keys
    0..i), as in the Pallas kernel and ref.mha."""
    jq, tq = both((2, 128, 4, 64), seed=3)
    jk, tk = both((2, 256, 2, 64), seed=4)
    jv, tv = both((2, 256, 2, 64), seed=5)
    out = tops.flash_attention(tq, tk, tv, causal)
    close(out, jops.flash_attention(jq, jk, jv, causal=causal), **FLASH_TOL)
    close(out, jref.mha(jq, jk, jv, causal=causal), **FLASH_TOL)


def test_flash_attention_head_layout_matches_pallas_function():
    jq, tq = both((1, 4, 256, 64), seed=6)
    jk, tk = both((1, 2, 256, 64), seed=7)
    close(tfa.flash_attention_reference(tq, tk, tk),
          jfa.flash_attention(jq, jk, jk, interpret=True), **FLASH_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_matches_pallas(causal):
    jq, tq = both((1, 256, 2, 64), "bfloat16", seed=0)
    jk, tk = both((1, 256, 2, 64), "bfloat16", seed=1)
    jv, tv = both((1, 256, 2, 64), "bfloat16", seed=2)
    out = tops.flash_attention(tq, tk, tv, causal)
    assert out.dtype == torch.bfloat16
    close(out, jops.flash_attention(jq, jk, jv, causal=causal), **BF16_ULP)
    close(tref.mha(tq, tk, tv, causal=causal),
          jref.mha(jq, jk, jv, causal=causal), **BF16_MHA)


def test_flash_plain_version_chunks_give_the_same_values(monkeypatch):
    _, tq = both((1, 4, 100, 64), seed=8)
    _, tk = both((1, 2, 100, 64), seed=9)
    whole = tfa.flash_attention_reference(tq, tk, tk)
    monkeypatch.setattr(tfa, "PLAIN_CHUNK_ELEMS", 4 * 100 * 7)   # 7 rows
    torch.testing.assert_close(tfa.flash_attention_reference(tq, tk, tk),
                               whole, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# analytic W / Q against the reference's cost walk
# --------------------------------------------------------------------------

def xla_cpu_row_sum_partials(d: int) -> int:
    """Partial sums XLA:CPU adds when it sums a row of more than 32 values
    in windows of 32 (again over the partials while more than 32): the
    walk counts them as extra reduce work, which no kernel does."""
    extra = 0
    while d > 32:
        d = -(-d // 32)
        extra += d
    return extra


@pytest.mark.parametrize("r,d", [(64, 16), (64, 32), (256, 128),
                                 (512, 768), (128, 1024), (8, 4097),
                                 (16, 16384)])
def test_layernorm_character_matches_cost_walk(r, d):
    got = kernel_character(jref.layernorm, jnp.ones((r, d)), jnp.ones((d,)),
                           jnp.ones((d,)))
    mine = analysis.layernorm_character(r, d)
    # two row sums (mean, variance), each split alike
    assert got["W_flops"] == (mine["W_flops"]
                              + 2 * r * xla_cpu_row_sum_partials(d))
    assert got["transcendentals"] == mine["transcendentals"] == r
    assert mine["Q_bytes"] == (2 * r * d + 2 * d) * 4
    assert got["Q_bytes"] > 2 * mine["Q_bytes"]      # the walk is unfused
    bf16 = analysis.layernorm_character(r, d, "bfloat16")
    assert bf16["Q_bytes"] == 2 * r * d * 2 + 2 * d * 4


@pytest.mark.parametrize("shape,window", [((2, 16, 16, 128), 2),
                                          ((2, 16, 16, 128), 4),
                                          ((2, 7, 9, 3), 2),
                                          ((2, 7, 9, 3), 3),
                                          ((8, 64, 64, 32), 2)])
def test_pool_characters_match_cost_walk(shape, window):
    x = jnp.ones(shape)
    avg = kernel_character(lambda t: jref.avg_pool(t, window, window), x)
    mx = kernel_character(lambda t: jref.max_pool(t, window, window), x)
    mine_avg = analysis.avg_pool_character(*shape, window)
    mine_max = analysis.max_pool_character(*shape, window)
    assert avg["W_flops"] == mine_avg["W_flops"]
    assert avg["Q_bytes"] == mine_avg["Q_unfused"]
    assert mx["W_flops"] == mine_max["W_flops"] == 0       # section 3.5
    assert mx["Q_bytes"] == mine_max["Q_unfused"]
    # the same least traffic: the FLOP count alone tells them apart
    assert mine_max["Q_bytes"] == mine_avg["Q_bytes"]
    n, h, w, c = shape
    outs = n * (h // window) * (w // window) * c
    assert mine_avg["Q_bytes"] == (n * h * w * c + outs) * 4


def _visible_brute(sq, sk, causal):
    return int(sum(min(i + 1, sk) if causal else sk for i in range(sq)))


@pytest.mark.parametrize("sq,sk", [(1, 1), (5, 3), (3, 5), (128, 256),
                                   (8192, 8192)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_character_counts_visible_pairs(sq, sk, causal):
    pairs = _visible_brute(sq, sk, causal)
    assert analysis.visible_keys(sq, sk, causal) == pairs
    c = analysis.attention_character(2, 8, 2, sq, sk, 128, "bfloat16",
                                     causal)
    assert c["W_flops"] == 4 * 128 * 2 * 8 * pairs
    assert c["transcendentals"] == 2 * 8 * pairs
    assert c["Q_bytes"] == (2 * 2 * 8 * sq + 2 * 2 * 2 * sk) * 128 * 2


def test_attention_character_of_the_card_rows():
    q14 = analysis.attention_character(1, 40, 8, 8192, 8192, 128)
    assert q14["W_flops"] == pytest.approx(6.87e11, rel=1e-3)
    assert q14["Q_bytes"] == 201326592
    q06 = analysis.attention_character(8, 16, 8, 2048, 2048, 128)
    assert q06["W_flops"] == pytest.approx(1.38e11, rel=1e-2)


@pytest.mark.parametrize("s", [128, 512, 8192])
def test_flash_attention_ai_is_the_reference_model(s):
    assert analysis.flash_attention_ai(s) == jsub.flash_attention_ai(s)
    assert analysis.flash_attention_ai(s, 64) == jsub.flash_attention_ai(
        s, 64)


# --------------------------------------------------------------------------
# the CUDA wrappers
# --------------------------------------------------------------------------

def test_new_cuda_wrappers_refuse_cpu_tensors():
    x = torch.ones((2, 4, 4, 8))
    for fn, args in ((tln.layernorm, (x, torch.ones(8), torch.ones(8))),
                     (tpool.avg_pool_blocked, (x,)),
                     (tpool.avg_pool_nchw, (x,)),
                     (tpool.avg_pool_naive, (x,)),
                     (tfa.flash_attention, (x, x, x))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


def test_ops_registry_pairs_each_kernel_with_its_plain_version():
    reg = tops.registered_kernels()
    assert reg["layernorm"] == {"cuda": tln.layernorm,
                                "cpu": tln.layernorm_reference}
    assert reg["avg_pool_blocked"] == {"cuda": tpool.avg_pool_blocked,
                                       "cpu": tpool.avg_pool_reference}
    assert reg["avg_pool_naive"] == {"cuda": tpool.avg_pool_nchw,
                                     "cpu": tpool.avg_pool_nchw_reference}
    assert reg["flash_attention"] == {"cuda": tfa.flash_attention,
                                      "cpu": tfa.flash_attention_reference}
    assert "max_pool" not in reg                   # no kernel, on purpose
