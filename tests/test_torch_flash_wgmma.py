"""The bf16 flash-attention path on Hopper's tensor cores, on the CPU: its
plan words, the bf16 tensor-core term of the attention tolerance, and the
kernel's arithmetic (base-2 online softmax over 128-key slabs, P V with P
split into bf16 hi + lo parts) emulated in PyTorch against the plain
version at that tolerance.

The kernel itself (``csrc/flash_attention.cu``) runs only on the card:
``tests/test_torch_kernels_cuda.py -k flash``.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.primitives import tolerance


@pytest.mark.parametrize("code,words", [
    (-1, "CUDA cores float32"), (64, "wgmma bf16 hd64"),
    (128, "wgmma bf16 hd128"),
])
def test_flash_plan_codes_read_as_words(code, words):
    # flash_attention_plan: hd for the bf16 wgmma kernel, -1 for float32
    assert fa.describe_plan(code) == words


@pytest.mark.parametrize("code", [0, 32, 256])
def test_flash_plan_code_without_a_path_raises(code):
    with pytest.raises(ValueError, match="no path"):
        fa.describe_plan(code)


def test_flash_plan_is_bound_beside_the_launch():
    argtypes, restype = fa.C_SIGNATURES["flash_attention_plan"]
    assert argtypes == [ctypes.c_int, ctypes.c_int] and restype is ctypes.c_int
    assert "flash_attention_launch" in fa.C_SIGNATURES


@pytest.mark.parametrize("hd,sk,terms", [
    # 10 (hd / 6 + 32) + 320 + sqrt(Sk), in units of 2^-24
    (64, 1, 10 * (64 / 6 + 32) + 320 + 1),
    (64, 8192, 10 * (64 / 6 + 32) + 320 + math.sqrt(8192)),
    (128, 1, 10 * (128 / 6 + 32) + 320 + 1),
    (128, 8192, 10 * (128 / 6 + 32) + 320 + math.sqrt(8192)),
])
def test_bf16_attention_tolerance_adds_the_tensor_core_term(hd, sk, terms):
    for vs, rtol in (("plain", 2.0 ** -7), ("plain_f32", 2.0 ** -8)):
        tol = tolerance("attention", "bfloat16", sk, vs=vs, hd=hd)
        assert tol["atol"] == pytest.approx(2.0 ** -15 + terms * 2.0 ** -24,
                                            rel=1e-12)
        assert tol["rtol"] == rtol
    # 7.5e-5 to 8.7e-5: 2.5-2.9x the float32 allowance, and far under the
    # ~1e-2 that one bf16 rounding of p could move a short row by
    assert 7.5e-5 <= tol["atol"] <= 8.7e-5


@pytest.mark.parametrize("k", [1, 100, 8192])
@pytest.mark.parametrize("hd", [64, 128])
def test_float32_attention_tolerance_is_unchanged(k, hd):
    for vs in ("plain", "plain_f32"):
        assert tolerance("attention", "float32", k, vs=vs, hd=hd) == dict(
            atol=2.0 ** -15, rtol=2.0 ** -15)


def _kernel_arithmetic(q, k, v, causal, parts, bk=128):
    """The bf16 kernel's sums in float32 on the CPU: scores times
    scale log2(e), masked to -1e30, the online softmax in base 2 over
    slabs of ``bk`` keys, P V with P as bf16 hi (+ lo for parts 2), one
    rounding to bf16.  Products are exact, as on the tensor cores; the
    tensor cores' truncated sums are not emulated."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // kv, 1)
    vf = v.float().repeat_interleave(h // kv, 1)
    sl2 = (torch.tensor(1.0 / math.sqrt(hd))
           * torch.tensor(1.4426950408889634))
    m = torch.full((b, h, sq, 1), fa.NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, hd))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, bk):
        x = (q.float() @ kf[:, :, k0:k0 + bk].transpose(-1, -2)) * sl2
        if causal:
            keys = torch.arange(k0, min(k0 + bk, sk))[None, :]
            x = x.masked_fill(rows < keys, fa.NEG_INF)
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha, m = torch.exp2(m - mx), mx
        p = torch.exp2(x - m)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, k0:k0 + bk]
        if parts == 2:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0:k0 + bk]
        acc = acc * alpha + pv
    return (acc / l.clamp_min(1e-30)).bfloat16()


def _worst(out, want, tol):
    return float(((out.float() - want.float()).abs()
                  / (tol["atol"] + tol["rtol"] * want.float().abs())).max())


@pytest.mark.parametrize("b,h,kv,sq,sk,hd", [
    (1, 4, 2, 257, 257, 128),     # slab and tile edges, G 2
    (1, 5, 1, 129, 300, 64),      # Sq < Sk, G 5
])
@pytest.mark.parametrize("causal", [True, False])
def test_split_p_meets_the_bf16_tolerance_and_one_rounding_does_not(
        b, h, kv, sq, sk, hd, causal):
    rng = np.random.default_rng(sq + sk)

    def t(shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).bfloat16()
    q, k, v = t((b, h, sq, hd)), t((b, kv, sk, hd)), t((b, kv, sk, hd))
    plain = fa.flash_attention_reference(q, k, v, causal=causal)
    plain32 = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                           causal=causal)
    tol = tolerance("attention", "bfloat16", sk, hd=hd)
    tol32 = tolerance("attention", "bfloat16", sk, vs="plain_f32", hd=hd)
    split = _kernel_arithmetic(q, k, v, causal, parts=2)
    assert _worst(split, plain, tol) <= 1.0
    assert _worst(split, plain32, tol32) <= 1.0
    single = _kernel_arithmetic(q, k, v, causal, parts=1)
    assert _worst(single, plain32, tol32) > 2.0


def test_measurement_build_gets_its_own_library():
    # a -D define changes the library's name; no defines is the wrappers'
    plain = build.library_path("flash_attention")
    assert build.library_path("flash_attention", ()) == plain
    single = build.library_path("flash_attention", ("FLASH_P_PARTS=1",))
    assert single != plain and single.parent == plain.parent
