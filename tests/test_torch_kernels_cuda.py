"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, over every shape the kernels are built for.

Needs an NVIDIA card with nvcc (marked ``cuda``; skips elsewhere).  On
the card, from the repo root:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

This file imports no JAX, so it also runs where only torch is installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import quantize as kvq

pytestmark = pytest.mark.cuda

# f32: summation order only.  bf16: the plain version rounds the scores
# q.k and the probabilities p to bf16 (error growing with |q.k|), the
# kernel keeps both in float32 as the Pallas kernel does; against the
# plain version run in float32 on the same bf16 values only the kernel's
# bf16 output rounding remains (TOL_F32_PLAIN).
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=6e-2, rtol=6e-2)}
TOL_F32_PLAIN = {torch.float32: dict(atol=2e-5, rtol=2e-5),
                 torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _case(rng, B, KV, G, hd, page, nb, dtype, dev, trash=False):
    P = 1 + B * nb
    q = rng.standard_normal((B, KV, G, hd), dtype=np.float32)
    kp = rng.standard_normal((P, page, KV, hd), dtype=np.float32)
    vp = rng.standard_normal((P, page, KV, hd), dtype=np.float32)
    bt = np.zeros((B, nb), np.int32)
    pos = np.zeros((B,), np.int32)
    if not trash:
        free = list(rng.permutation(np.arange(1, P)))
        for b in range(B):
            live = int(rng.integers(1, nb + 1))
            bt[b, :live] = [free.pop() for _ in range(live)]
            pos[b] = int(rng.integers(0, live * page))
    t = lambda a, d=dtype: torch.from_numpy(a).to(dev, d)  # noqa: E731
    return (t(q), t(kp), t(vp), t(bt, torch.int32), t(pos, torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KV,G,hd,page,nb", [
    (4, 8, 2, 128, 16, 32),    # qwen3-0.6b decode
    (3, 2, 2, 16, 4, 5),       # smoke widths
    (2, 4, 1, 32, 8, 3),       # MHA
    (4, 1, 8, 64, 16, 2),      # one KV head, 8 query heads
    (2, 2, 3, 256, 16, 4),     # odd group count, widest head
])
@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
def test_paged_attention_kernel_matches_plain(card, dtype, B, KV, G, hd,
                                              page, nb, soft_cap):
    rng = np.random.default_rng(B * 100 + hd)
    args = _case(rng, B, KV, G, hd, page, nb, dtype, card)
    if soft_cap:                           # logits large enough to cap
        args = (args[0] * 4, *args[1:])
    kw = dict(scale=hd ** -0.5, soft_cap=soft_cap)
    n = pa.paged_attention.launches
    out = pa.paged_attention(*args, **kw)
    ref = pa.paged_attention_reference(*args, **kw)
    ref32 = pa.paged_attention_reference(*(a.float() for a in args[:3]),
                                         *args[3:], **kw)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == n + 1
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(out.float(), ref32, **TOL_F32_PLAIN[dtype])


def test_paged_attention_kernel_idle_trash_lanes_finite(card):
    rng = np.random.default_rng(5)
    args = _case(rng, 4, 8, 2, 128, 16, 32, torch.bfloat16, card,
                 trash=True)
    out = pa.paged_attention(*args, scale=128 ** -0.5)
    ref = pa.paged_attention_reference(*args, scale=128 ** -0.5)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL[torch.bfloat16])


def test_paged_attention_kernel_rejects_bad_inputs(card):
    rng = np.random.default_rng(6)
    q, k, v, bt, pos = _case(rng, 2, 2, 2, 16, 4, 3, torch.float32, card)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q, k, v, bt.long(), pos, scale=0.25)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                           v[..., :12].contiguous(), bt, pos, scale=0.25)
    with pytest.raises(ValueError, match="dtype"):
        pa.paged_attention(q, k.half(), v, bt, pos, scale=0.25)


# --------------------------------------------------------------------------
# MLA latent-space decode (csrc/mla_paged_attention.cu)
# --------------------------------------------------------------------------

def _mla_case(rng, B, H, r, dr, page, nb, dtype, dev, trash=False,
              lens=None):
    """Random queries and pools; ``lens`` gives each slot's live lines,
    else they are drawn (ragged); ``trash`` leaves every slot idle."""
    P = 1 + B * nb
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, H, r), (B, H, dr), (P, page, r),
                          (P, page, dr))]
    bt = np.zeros((B, nb), np.int32)
    pos = np.zeros((B,), np.int32)
    if not trash:
        free = list(rng.permutation(np.arange(1, P)))
        for b in range(B):
            n = lens[b] if lens else int(rng.integers(1, nb * page + 1))
            live = -(-n // page)
            bt[b, :live] = [free.pop() for _ in range(live)]
            pos[b] = n - 1
    t = lambda a, d=dtype: torch.from_numpy(a).to(dev, d)  # noqa: E731
    return (*(t(a) for a in arrs), t(bt, torch.int32), t(pos, torch.int32))


def _mla_check(args, dtype):
    kw = dict(scale=192 ** -0.5)
    n = pa.mla_paged_attention.launches
    out = pa.mla_paged_attention(*args, **kw)
    ref = pa.mla_paged_attention_reference(*args, **kw)
    ref32 = pa.mla_paged_attention_reference(*(a.float() for a in args[:4]),
                                             *args[4:], **kw)
    torch.cuda.synchronize()
    # bf16: the tensor-core core's split and merge kernels
    assert pa.mla_paged_attention.launches == n + (
        2 if dtype == torch.bfloat16 else 1)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(out.float(), ref32, **TOL_F32_PLAIN[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,r,dr,page,nb", [
    (4, 128, 512, 64, 16, 16),   # deepseek-v2 decode, 4 slots
    (3, 4, 32, 8, 8, 5),         # smoke widths (one masked head block)
    (2, 12, 64, 16, 32, 2),      # heads not a multiple of the tile
    (2, 8, 256, 32, 8, 4),
    (2, 16, 128, 8, 16, 3),
])
def test_mla_kernel_matches_plain(card, dtype, B, H, r, dr, page, nb):
    rng = np.random.default_rng(B * 1000 + r + dr)
    _mla_check(_mla_case(rng, B, H, r, dr, page, nb, dtype, card), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mla_kernel_edge_positions(card, dtype):
    """pos 0 (one live line), a partly filled last page, a full table."""
    rng = np.random.default_rng(8)
    args = _mla_case(rng, 3, 16, 512, 64, 16, 4, dtype, card,
                     lens=[1, 16 * 2 + 5, 16 * 4])
    _mla_check(args, dtype)


def test_mla_kernel_idle_trash_lanes_finite(card):
    rng = np.random.default_rng(9)
    args = _mla_case(rng, 4, 128, 512, 64, 16, 16, torch.bfloat16, card,
                     trash=True)
    _mla_check(args, torch.bfloat16)


def test_mla_kernel_rejects_bad_inputs(card):
    rng = np.random.default_rng(10)
    ql, qr, c, r, bt, pos = _mla_case(rng, 2, 8, 64, 16, 8, 3,
                                      torch.float32, card)
    with pytest.raises(ValueError, match="int32"):
        pa.mla_paged_attention(ql, qr, c, r, bt.long(), pos, scale=0.1)
    with pytest.raises(ValueError, match="latent rank"):
        pa.mla_paged_attention(ql[..., :48].contiguous(), qr,
                               c[..., :48].contiguous(), r, bt, pos,
                               scale=0.1)
    with pytest.raises(ValueError, match="page size"):
        pa.mla_paged_attention(ql, qr, c.reshape(-1, 4, 64),
                               r.reshape(-1, 4, 16), bt, pos, scale=0.1)
    with pytest.raises(ValueError, match="dtype"):
        pa.mla_paged_attention(ql, qr, c.half(), r, bt, pos, scale=0.1)


# --------------------------------------------------------------------------
# Multi-token verification (csrc/paged_attention_verify.cu,
# csrc/mla_paged_attention_verify.cu)
# --------------------------------------------------------------------------

def _verify_tables(rng, B, T, page, nb, P, lens=None, trash=False,
                   backed_drafts=False):
    """Block tables and first-token positions.  Slot b's committed context
    is ``lens[b]`` lines (drawn when not given), so pos = len - 1 and the
    T query tokens sit at pos .. pos + T - 1.  Only the context's pages
    are backed unless ``backed_drafts``: the drafts' lines past them then
    fall on table entries 0, the trash page, as near a request's budget."""
    bt = np.zeros((B, nb), np.int32)
    pos = np.zeros((B,), np.int32)
    if not trash:
        free = list(rng.permutation(np.arange(1, P)))
        for b in range(B):
            n = lens[b] if lens else int(rng.integers(1, nb * page + 1))
            lines = n + T - 1 if backed_drafts else n
            live = min(-(-lines // page), nb)
            bt[b, :live] = [free.pop() for _ in range(live)]
            pos[b] = n - 1
    return bt, pos


def _gqa_verify_case(rng, B, T, KV, G, hd, page, nb, dtype, dev, **kw):
    P = 1 + B * nb
    q = rng.standard_normal((B, T, KV, G, hd), dtype=np.float32)
    kp = rng.standard_normal((P, page, KV, hd), dtype=np.float32)
    vp = rng.standard_normal((P, page, KV, hd), dtype=np.float32)
    bt, pos = _verify_tables(rng, B, T, page, nb, P, **kw)
    t = lambda a, d=dtype: torch.from_numpy(a).to(dev, d)  # noqa: E731
    return (t(q), t(kp), t(vp), t(bt, torch.int32), t(pos, torch.int32))


def _gqa_verify_check(args, dtype, soft_cap=0.0):
    hd = args[0].shape[-1]
    kw = dict(scale=hd ** -0.5, soft_cap=soft_cap)
    n = pa.paged_attention_verify.launches
    out = pa.paged_attention_verify(*args, **kw)
    ref = pa.paged_attention_verify_reference(*args, **kw)
    ref32 = pa.paged_attention_verify_reference(
        *(a.float() for a in args[:3]), *args[3:], **kw)
    torch.cuda.synchronize()
    assert pa.paged_attention_verify.launches == n + 1
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(out.float(), ref32, **TOL_F32_PLAIN[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,KV,G,hd,page,nb", [
    (4, 5, 8, 5, 128, 16, 33),   # qwen3-14b verify, k = 4 (25 rows)
    (4, 5, 8, 2, 128, 16, 33),   # qwen3-0.6b draft catch-up (10 rows)
    (3, 4, 2, 2, 16, 4, 5),      # smoke widths
    (2, 2, 4, 1, 32, 8, 3),      # MHA
    (2, 5, 1, 8, 64, 16, 2),     # one KV head, 40 rows
    (2, 3, 2, 3, 256, 16, 4),    # odd group count, widest head
])
@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
def test_gqa_verify_kernel_matches_plain(card, dtype, B, T, KV, G, hd, page,
                                         nb, soft_cap):
    rng = np.random.default_rng(B * 100 + T * 10 + hd)
    args = _gqa_verify_case(rng, B, T, KV, G, hd, page, nb, dtype, card)
    if soft_cap:                           # logits large enough to cap
        args = (args[0] * 4, *args[1:])
    _gqa_verify_check(args, dtype, soft_cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("backed", [True, False],
                         ids=["backed", "trash-margin"])
def test_gqa_verify_kernel_edges(card, dtype, backed):
    """Draft chains crossing a page boundary (pos 14 and 30 with T 5 at
    page 16), a chain starting at pos 0, and a chain running past the
    whole table (pos + t beyond n_blocks * page): with the drafts' pages
    backed, and with them on trash entries."""
    rng = np.random.default_rng(21)
    args = _gqa_verify_case(rng, 4, 5, 8, 5, 128, 16, 4, dtype, card,
                            lens=[15, 31, 1, 62], backed_drafts=backed)
    _gqa_verify_check(args, dtype)


def test_gqa_verify_kernel_idle_trash_lanes_finite(card):
    rng = np.random.default_rng(22)
    args = _gqa_verify_case(rng, 4, 5, 8, 5, 128, 16, 33, torch.bfloat16,
                            card, trash=True)
    _gqa_verify_check(args, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 2, 5, 8])
def test_gqa_verify_kernel_t1_equals_decode_kernel(card, dtype, G):
    rng = np.random.default_rng(23 + G)
    q, k, v, bt, pos = _gqa_verify_case(rng, 4, 1, 8, G, 128, 16, 33, dtype,
                                        card)
    kw = dict(scale=128 ** -0.5)
    ver = pa.paged_attention_verify(q, k, v, bt, pos, **kw)[:, 0]
    dec = pa.paged_attention(q[:, 0].contiguous(), k, v, bt, pos, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(ver.float(), dec.float(),
                               **TOL_F32_PLAIN[dtype])


def test_gqa_verify_kernel_rejects_bad_inputs(card):
    rng = np.random.default_rng(24)
    q, k, v, bt, pos = _gqa_verify_case(rng, 2, 3, 2, 2, 16, 4, 3,
                                        torch.float32, card)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention_verify(q, k, v, bt, pos.long(), scale=0.25)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention_verify(
            q[..., :12].contiguous(), k[..., :12].contiguous(),
            v[..., :12].contiguous(), bt, pos, scale=0.25)
    with pytest.raises(ValueError, match="dtype"):
        pa.paged_attention_verify(q, k, v.half(), bt, pos, scale=0.25)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention_verify(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), k, v, bt, pos,
                                  scale=0.25)
    # scale pools: the wrong shape, the wrong dtype, one alone, scales
    # beside an unquantized pool, a quantized pool without them
    kq, ks = kvq.quantize(k, "int8")
    vq, vs = kvq.quantize(v, "int8")
    for kw, match in [
            (dict(k_scale=ks[:, :, :1].contiguous(), v_scale=vs), "shape"),
            (dict(k_scale=ks.double(), v_scale=vs), "dtype"),
            (dict(k_scale=ks), "both scale pools"),
            (dict(k_scale=ks, v_scale=vs, pools=(k, v)), "unquantized"),
            (dict(pools=(kq, vq)), "needs its float32 scale pools")]:
        kp, vp = kw.pop("pools", (kq, vq))
        with pytest.raises(ValueError, match=match):
            pa.paged_attention_verify(q, kp, vp, bt, pos, scale=0.25, **kw)


def _mla_verify_case(rng, B, T, H, r, dr, page, nb, dtype, dev, **kw):
    P = 1 + B * nb
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, T, H, r), (B, T, H, dr), (P, page, r),
                          (P, page, dr))]
    bt, pos = _verify_tables(rng, B, T, page, nb, P, **kw)
    t = lambda a, d=dtype: torch.from_numpy(a).to(dev, d)  # noqa: E731
    return (*(t(a) for a in arrs), t(bt, torch.int32), t(pos, torch.int32))


def _mla_verify_check(args, dtype):
    kw = dict(scale=192 ** -0.5)
    n = pa.mla_paged_attention_verify.launches
    out = pa.mla_paged_attention_verify(*args, **kw)
    ref = pa.mla_paged_attention_verify_reference(*args, **kw)
    ref32 = pa.mla_paged_attention_verify_reference(
        *(a.float() for a in args[:4]), *args[4:], **kw)
    torch.cuda.synchronize()
    assert pa.mla_paged_attention_verify.launches == n + (
        2 if dtype == torch.bfloat16 else 1)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(out.float(), ref32, **TOL_F32_PLAIN[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,H,r,dr,page,nb", [
    (4, 4, 128, 512, 64, 16, 17),  # deepseek-v2 verify, k = 3
    (3, 3, 4, 32, 8, 8, 5),        # smoke widths (one masked head block)
    (2, 2, 12, 64, 16, 32, 2),     # heads not a multiple of the tile
    (2, 5, 8, 256, 32, 8, 4),
])
def test_mla_verify_kernel_matches_plain(card, dtype, B, T, H, r, dr, page,
                                         nb):
    rng = np.random.default_rng(B * 1000 + T * 100 + r + dr)
    _mla_verify_check(_mla_verify_case(rng, B, T, H, r, dr, page, nb, dtype,
                                       card), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("backed", [True, False],
                         ids=["backed", "trash-margin"])
def test_mla_verify_kernel_edges(card, dtype, backed):
    """Chains crossing a page boundary, starting at pos 0, and running
    past the whole table, with the drafts' pages backed or trash."""
    rng = np.random.default_rng(31)
    args = _mla_verify_case(rng, 4, 4, 16, 512, 64, 16, 4, dtype, card,
                            lens=[15, 30, 1, 63], backed_drafts=backed)
    _mla_verify_check(args, dtype)


def test_mla_verify_kernel_idle_trash_lanes_finite(card):
    rng = np.random.default_rng(32)
    args = _mla_verify_case(rng, 4, 4, 128, 512, 64, 16, 17, torch.bfloat16,
                            card, trash=True)
    _mla_verify_check(args, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mla_verify_kernel_t1_equals_decode_kernel(card, dtype):
    rng = np.random.default_rng(33)
    ql, qr, c, r, bt, pos = _mla_verify_case(rng, 4, 1, 128, 512, 64, 16, 16,
                                             dtype, card)
    kw = dict(scale=192 ** -0.5)
    ver = pa.mla_paged_attention_verify(ql, qr, c, r, bt, pos, **kw)[:, 0]
    dec = pa.mla_paged_attention(ql[:, 0].contiguous(),
                                 qr[:, 0].contiguous(), c, r, bt, pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ver, dec)           # the same walk, bit for bit


def test_mla_verify_kernel_rejects_bad_inputs(card):
    rng = np.random.default_rng(34)
    ql, qr, c, r, bt, pos = _mla_verify_case(rng, 2, 3, 8, 64, 16, 8, 3,
                                             torch.float32, card)
    with pytest.raises(ValueError, match="int32"):
        pa.mla_paged_attention_verify(ql, qr, c, r, bt.long(), pos,
                                      scale=0.1)
    with pytest.raises(ValueError, match="latent rank"):
        pa.mla_paged_attention_verify(ql[..., :48].contiguous(), qr,
                                      c[..., :48].contiguous(), r, bt, pos,
                                      scale=0.1)
    with pytest.raises(ValueError, match="page size"):
        pa.mla_paged_attention_verify(ql, qr, c.reshape(-1, 4, 64),
                                      r.reshape(-1, 4, 16), bt, pos,
                                      scale=0.1)
    with pytest.raises(ValueError, match="shape"):
        pa.mla_paged_attention_verify(ql, qr[:, :2].contiguous(), c, r, bt,
                                      pos, scale=0.1)
    # scale pools: the wrong shape, the wrong dtype, one alone, scales
    # beside an unquantized pool, a quantized pool without them
    cq, cs = kvq.quantize(c, "fp8_e4m3")
    rq, rs = kvq.quantize(r, "fp8_e4m3")
    for kw, match in [
            (dict(c_scale=cs[:, :4].contiguous(), r_scale=rs), "shape"),
            (dict(c_scale=cs.half(), r_scale=rs), "dtype"),
            (dict(r_scale=rs), "both scale pools"),
            (dict(c_scale=cs, r_scale=rs, pools=(c, r)), "unquantized"),
            (dict(pools=(cq, rq)), "needs its float32 scale pools")]:
        cp, rp = kw.pop("pools", (cq, rq))
        with pytest.raises(ValueError, match=match):
            pa.mla_paged_attention_verify(ql, qr, cp, rp, bt, pos, scale=0.1,
                                          **kw)


# --------------------------------------------------------------------------
# The paper's primitives: inner product, GELU, direct conv, Winograd stage
# (csrc/inner_product.cu, gelu.cu, conv_direct.cu, winograd_stage.cu) and
# the FMA-chain probe (csrc/fma_probe.cu).  Tolerances:
# launch/primitives.py::tolerance (derived in PERF.md, PR 14).
# --------------------------------------------------------------------------

from repro_torch.kernels import conv_direct as conv_mod       # noqa: E402
from repro_torch.kernels import conv_winograd as wino_mod     # noqa: E402
from repro_torch.kernels import gelu as gelu_mod              # noqa: E402
from repro_torch.kernels import inner_product as ip_mod       # noqa: E402
from repro_torch.kernels import ref as prim_ref               # noqa: E402
from repro_torch.launch.primitives import tolerance           # noqa: E402

_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _normal(rng, shape, dev, dtype, scale=1.0):
    a = rng.standard_normal(shape, dtype=np.float32) * scale
    return torch.from_numpy(a).to(dev, dtype)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("fuse", ["none", "relu", "gelu"])
@pytest.mark.parametrize("m,k,n", [
    (256, 384, 512),          # the reference test's shape
    (1, 1, 1),                # K = 1, one output
    (129, 1, 257),            # K = 1, ragged M and N
    (131, 77, 133),           # no dimension a multiple of any tile
    (300, 1000, 5),           # thin N, K not a multiple of the K step
    (256, 5120, 384),         # a slice of qwen3-14b's gate projection
])
def test_inner_product_kernel_matches_plain(card, dt, fuse, m, k, n):
    dtype = _DT[dt]
    rng = np.random.default_rng(m * 7 + k + n)
    x, w = _normal(rng, (m, k), card, dtype), _normal(rng, (k, n), card,
                                                      dtype)
    before = ip_mod.inner_product.launches
    out = ip_mod.inner_product(x, w, fuse=fuse)
    want = ip_mod.inner_product_reference(x, w, fuse=fuse)
    want32 = ip_mod.inner_product_reference(x.float(), w.float(), fuse=fuse)
    torch.cuda.synchronize()
    assert ip_mod.inner_product.launches == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    dname = str(dtype).split(".")[-1]
    torch.testing.assert_close(out.float(), want.float(),
                               **tolerance("sum", dname, k))
    torch.testing.assert_close(out.float(), want32,
                               **tolerance("sum", dname, k, vs="plain_f32"))


def test_inner_product_kernel_rejects_bad_inputs(card):
    x = torch.ones((4, 3), device=card)
    with pytest.raises(ValueError, match="multiply"):
        ip_mod.inner_product(x, torch.ones((4, 3), device=card))
    with pytest.raises(ValueError, match="fuse"):
        ip_mod.inner_product(x, torch.ones((3, 2), device=card), fuse="tanh")
    with pytest.raises(ValueError, match="dtype"):
        ip_mod.inner_product(x.half(), torch.ones((3, 2), device=card).half())
    with pytest.raises(ValueError, match="CUDA"):
        ip_mod.inner_product(x.cpu(), torch.ones((3, 2)))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(256, 128), (512, 384), (8, 1024, 256),
                                   (1, 1), (1000, 3), (7, 9, 13),
                                   (256, 227, 227, 3)])
def test_gelu_kernel_layouts_match_plain_and_each_other(card, dt, shape):
    dtype = _DT[dt]
    dname = str(dtype).split(".")[-1]
    x = _normal(np.random.default_rng(len(shape)), shape, card, dtype, 2.0)
    before = gelu_mod.gelu_2d.launches
    blocked = gelu_mod.gelu_blocked(x)
    naive = gelu_mod.gelu_naive(x)
    torch.cuda.synchronize()
    assert gelu_mod.gelu_2d.launches == before + 2
    assert torch.equal(blocked, naive)               # bit for bit
    torch.testing.assert_close(blocked.float(), prim_ref.gelu(x).float(),
                               **tolerance("elementwise", dname))
    torch.testing.assert_close(blocked.float(), prim_ref.gelu(x.float()),
                               **tolerance("elementwise", dname,
                                           vs="plain_f32"))


@pytest.mark.parametrize("to", [8, 128])
def test_gelu_kernel_on_padded_channels(card, to):
    x = _normal(np.random.default_rng(to), (4, 31, 29, 3), card,
                torch.bfloat16, 2.0)
    padded = gelu_mod.pad_channels(x, to)
    out = gelu_mod.gelu_blocked(padded)
    torch.testing.assert_close(out.float(), prim_ref.gelu(padded).float(),
                               **tolerance("elementwise", "bfloat16"))
    assert bool((out[..., 3:] == 0).all())           # gelu(0) = 0


@pytest.mark.parametrize("block", [(256, 128), (1024, 8), (3, 5), (64, 40)])
def test_gelu_2d_any_tile(card, block):
    x = _normal(np.random.default_rng(3), (333, 200), card, torch.float32)
    out = gelu_mod.gelu_2d(x, block=block)
    torch.testing.assert_close(out, prim_ref.gelu(x),
                               **tolerance("elementwise", "float32"))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,cin,cout,kh,kw", [
    (1, 8, 8, 32, 128, 3, 3),       # the reference tests' shapes
    (1, 12, 12, 64, 128, 3, 3),
    (4, 28, 28, 128, 128, 3, 3),    # the reference benchmark's
    (2, 7, 5, 3, 17, 3, 3),         # C = 3, odd H / W, ragged Cout
    (2, 6, 9, 5, 7, 2, 2),          # even kernel: the Pallas pad split
    (1, 5, 4, 8, 9, 1, 5),
])
def test_conv_direct_kernel_matches_plain(card, dt, n, h, w, cin, cout, kh,
                                          kw):
    dtype = _DT[dt]
    dname = str(dtype).split(".")[-1]
    rng = np.random.default_rng(n + h + cin)
    x = _normal(rng, (n, h, w, cin), card, dtype)
    wt = _normal(rng, (kh, kw, cin, cout), card, dtype, 0.1)
    before = conv_mod.conv2d_direct.launches
    out = conv_mod.conv2d_direct(x, wt)
    want = conv_mod.conv2d_direct_reference(x, wt)
    want32 = conv_mod.conv2d_direct_reference(x.float(), wt.float())
    torch.cuda.synchronize()
    assert conv_mod.conv2d_direct.launches == before + 1
    k = kh * kw * cin
    torch.testing.assert_close(out.float(), want.float(),
                               **tolerance("sum", dname, k, 0.1))
    torch.testing.assert_close(out.float(), want32,
                               **tolerance("sum", dname, k, 0.1,
                                           vs="plain_f32"))


# The bf16 paths on the tensor cores (csrc/gemm_wgmma.cuh) at the core's
# edges: one BM x BN tile is 128 x 128 or 128 x 256, a stage 64 deep in K,
# a TMA row 16 bytes (K % 8 == 0 for x, N % 8 == 0 for w, Cin % 8 == 0 for
# the convolution's cp.async copies); every other shape or alignment takes
# the element-wise producer.  Each case names the plan it must take.
@pytest.mark.parametrize("m,k,n,want", [
    (100, 64, 256, "wgmma 128x128, A tma, B tma"),   # M not a multiple of 64
    (192, 40, 96, "wgmma 128x128, A tma, B tma"),    # K shorter than a stage
    (64, 200, 136, "wgmma 128x128, A tma, B tma"),   # K % 64 != 0
    (257, 520, 8, "wgmma 128x128, A tma, B tma"),    # N = 8
    (130, 96, 20, "wgmma 128x128, A tma, B element-wise"),   # N % 8 != 0
    (70, 99, 64, "wgmma 128x128, A element-wise, B tma"),    # K % 8 != 0
    (8192, 1024, 8192, "wgmma 128x256, A tma, B tma"),
    # qwen3-14b's gate projection over a 256-token chunk: three waves of
    # 128-wide tiles beat two of 256-wide ones on 132 SMs
    (256, 5120, 17408, "wgmma 128x128, A tma, B tma"),
])
@pytest.mark.parametrize("fuse", ["none", "gelu"])
def test_inner_product_bf16_wgmma_edges(card, m, k, n, want, fuse):
    rng = np.random.default_rng(m + k + n)
    x = _normal(rng, (m, k), card, torch.bfloat16)
    w = _normal(rng, (k, n), card, torch.bfloat16)
    assert ip_mod.plan(x, w) == want
    out = ip_mod.inner_product(x, w, fuse=fuse)
    want_out = ip_mod.inner_product_reference(x, w, fuse=fuse)
    want32 = ip_mod.inner_product_reference(x.float(), w.float(), fuse=fuse)
    torch.testing.assert_close(out.float(), want_out.float(),
                               **tolerance("sum", "bfloat16", k))
    torch.testing.assert_close(out.float(), want32,
                               **tolerance("sum", "bfloat16", k,
                                           vs="plain_f32"))


@pytest.mark.parametrize("offset", [1, 3])
def test_inner_product_bf16_misaligned_rows_take_element_wise(card, offset):
    # contiguous views whose first element is not 16-byte aligned: the
    # launch picks the element-wise producers and gets the same sums
    rng = np.random.default_rng(offset)
    m, k, n = 96, 64, 72
    xb = _normal(rng, (m * k + offset,), card, torch.bfloat16)
    wb = _normal(rng, (k * n + offset,), card, torch.bfloat16)
    x = xb[offset:].view(m, k)
    w = wb[offset:].view(k, n)
    assert ip_mod.plan(x, w) == ("wgmma 128x128, A element-wise, "
                                 "B element-wise")
    out = ip_mod.inner_product(x, w)
    torch.testing.assert_close(
        out.float(), ip_mod.inner_product_reference(x.float(), w.float()),
        **tolerance("sum", "bfloat16", k, vs="plain_f32"))
    assert torch.equal(out, ip_mod.inner_product(x.clone(), w.clone()))


def test_inner_product_f32_stays_on_the_cuda_cores(card):
    x = torch.ones((4, 8), device=card)
    words = ip_mod.plan(x, torch.ones((8, 8), device=card))
    assert words.startswith("cuda-cores f32")
    assert words == "cuda-cores f32, A cp.async, B cp.async"
    xc = torch.ones((1, 8, 8, 8), device=card)
    words = conv_mod.plan(xc, torch.ones((3, 3, 8, 8), device=card))
    assert words.startswith("cuda-cores f32")
    assert words == "cuda-cores f32, A cp.async, B cp.async"


@pytest.mark.parametrize("n,h,w,cin,cout,kh,kw,want", [
    (2, 9, 11, 16, 24, 3, 3, "A cp.async, B tma"),       # Cin % 8 == 0
    (3, 10, 7, 64, 130, 3, 3, "A cp.async, B element-wise"),  # Cout ragged
    (2, 9, 11, 24, 20, 2, 2, "A cp.async, B element-wise"),
    (2, 8, 13, 40, 16, 1, 5, "A cp.async, B tma"),
    (2, 9, 11, 5, 16, 1, 5, "A element-wise, B tma"),    # Cin % 8 != 0
    (2, 6, 9, 12, 33, 2, 2, "A element-wise, B element-wise"),
    (1, 5, 4, 3, 8, 3, 3, "A element-wise, B tma"),
])
def test_conv_direct_bf16_wgmma_edges(card, n, h, w, cin, cout, kh, kw, want):
    rng = np.random.default_rng(n * h + cin + cout)
    x = _normal(rng, (n, h, w, cin), card, torch.bfloat16)
    wt = _normal(rng, (kh, kw, cin, cout), card, torch.bfloat16, 0.1)
    assert conv_mod.plan(x, wt) == f"wgmma 128x128, {want}"
    out = conv_mod.conv2d_direct(x, wt)
    k = kh * kw * cin
    torch.testing.assert_close(
        out.float(), conv_mod.conv2d_direct_reference(x, wt).float(),
        **tolerance("sum", "bfloat16", k, 0.1))
    torch.testing.assert_close(
        out.float(), conv_mod.conv2d_direct_reference(x.float(), wt.float()),
        **tolerance("sum", "bfloat16", k, 0.1, vs="plain_f32"))


def test_bf16_gemm_kernels_run_on_hgmma(card):
    # every bf16 kernel of the three libraries multiplies with HGMMA
    # (wgmma) in its SASS; the float32 kernels (and the Winograd stage's,
    # float32 only) keep FFMA and no HMMA / HGMMA: a full float32 product
    for name in ("inner_product", "conv_direct", "flash_attention",
                 "winograd_stage"):
        funcs = _sass_functions(name)
        bf16 = [f for f in funcs if "bf16_kernel" in f]
        f32 = [f for f in funcs if "f32_kernel" in f]
        assert f32 and (bf16 or name == "winograd_stage"), sorted(funcs)
        for f in bf16:
            assert "HGMMA" in funcs[f], f
        for f in f32:
            assert "HGMMA" not in funcs[f] and "HMMA" not in funcs[f], f
            assert "FFMA" in funcs[f], f


@pytest.mark.parametrize("p,t,cin,cout", [(16, 196, 128, 128),
                                          (16, 1, 1, 1), (16, 37, 3, 130),
                                          (3, 300, 65, 9)])
def test_winograd_stage_kernel_matches_plain(card, p, t, cin, cout):
    rng = np.random.default_rng(t + cin)
    v = _normal(rng, (p, t, cin), card, torch.float32)
    u = _normal(rng, (p, cin, cout), card, torch.float32)
    before = wino_mod.winograd_elementwise_stage.launches
    out = wino_mod.winograd_elementwise_stage(v, u)
    torch.cuda.synchronize()
    assert wino_mod.winograd_elementwise_stage.launches == before + 1
    assert out.dtype == torch.float32
    torch.testing.assert_close(
        out, wino_mod.winograd_elementwise_stage_reference(v, u),
        **tolerance("sum", "float32", cin))


# The float32 GEMM core (csrc/gemm_core.cuh) at its edges, for its three
# users: a tile is 128 x 128, a slab 32 deep in K in a ring of 2 stages; A
# and B take 16-byte cp.async copies when their rows are a multiple of 4
# floats from a 16-byte aligned base (K % 4 for x, N % 4 for w, Cin % 4
# for the convolution's im2col A and for v, Cout % 4 for u), else one copy
# per element.  Each case names the plan it must take and holds the
# unchanged float32 "sum" tolerance.
F32 = "cuda-cores f32, "


@pytest.mark.parametrize("m,k,n,ox,ow,want", [
    (131, 77, 133, 0, 0, "A element-wise, B element-wise"),  # all ragged
    (200, 12, 136, 0, 0, "A cp.async, B cp.async"),   # K under one slab
    (257, 100, 260, 0, 0, "A cp.async, B cp.async"),  # K % 32 != 0
    (129, 1, 257, 0, 0, "A element-wise, B element-wise"),   # K = 1
    (300, 64, 1, 0, 0, "A cp.async, B element-wise"),   # N = 1
    (70, 99, 64, 0, 0, "A element-wise, B cp.async"),   # K % 4 != 0
    (96, 64, 72, 1, 0, "A element-wise, B cp.async"),   # offset 1
    (96, 64, 72, 0, 3, "A cp.async, B element-wise"),   # offset 3
    (1, 4096, 4, 0, 0, "A cp.async, B cp.async"),     # one row, long K
])
@pytest.mark.parametrize("fuse", ["none", "gelu"])
def test_inner_product_f32_core_edges(card, m, k, n, ox, ow, want, fuse):
    rng = np.random.default_rng(m + k + n + ox + ow)
    xb = _normal(rng, (m * k + ox,), card, torch.float32)
    wb = _normal(rng, (k * n + ow,), card, torch.float32)
    x, w = xb[ox:].view(m, k), wb[ow:].view(k, n)
    assert ip_mod.plan(x, w) == F32 + want
    out = ip_mod.inner_product(x, w, fuse=fuse)
    torch.testing.assert_close(
        out, ip_mod.inner_product_reference(x, w, fuse=fuse),
        **tolerance("sum", "float32", k))
    assert torch.equal(out, ip_mod.inner_product(x.clone(), w.clone(),
                                                 fuse=fuse))


@pytest.mark.parametrize("n,h,w,cin,cout,kh,kw,want", [
    (2, 9, 11, 16, 24, 3, 3, "A cp.async, B cp.async"),
    (3, 10, 7, 64, 130, 3, 3, "A cp.async, B element-wise"),
    (2, 7, 5, 3, 17, 3, 3, "A element-wise, B element-wise"),  # C = 3
    (2, 6, 9, 5, 8, 2, 2, "A element-wise, B cp.async"),
    (1, 5, 4, 4, 1, 1, 3, "A cp.async, B element-wise"),   # K under a slab
    (2, 8, 13, 40, 16, 1, 5, "A cp.async, B cp.async"),
    (1, 1, 1, 8, 4, 3, 3, "A cp.async, B cp.async"),       # all padding
])
def test_conv_direct_f32_core_edges(card, n, h, w, cin, cout, kh, kw, want):
    rng = np.random.default_rng(n * h + cin + cout)
    x = _normal(rng, (n, h, w, cin), card, torch.float32)
    wt = _normal(rng, (kh, kw, cin, cout), card, torch.float32, 0.1)
    assert conv_mod.plan(x, wt) == F32 + want
    out = conv_mod.conv2d_direct(x, wt)
    torch.testing.assert_close(
        out, conv_mod.conv2d_direct_reference(x, wt),
        **tolerance("sum", "float32", kh * kw * cin, 0.1))


@pytest.mark.parametrize("p,t,cin,cout,want", [
    (16, 1, 128, 128, "A cp.async, B cp.async"),      # one row a position
    (3, 300, 65, 9, "A element-wise, B element-wise"),
    (16, 200, 36, 20, "A cp.async, B cp.async"),
    (5, 130, 8, 3, "A cp.async, B element-wise"),
    (16, 129, 3, 128, "A element-wise, B cp.async"),
])
def test_winograd_stage_f32_core_edges(card, p, t, cin, cout, want):
    rng = np.random.default_rng(p * t + cin)
    v = _normal(rng, (p, t, cin), card, torch.float32)
    u = _normal(rng, (p, cin, cout), card, torch.float32)
    assert wino_mod.plan(v, u) == F32 + want
    torch.testing.assert_close(
        wino_mod.winograd_elementwise_stage(v, u),
        wino_mod.winograd_elementwise_stage_reference(v, u),
        **tolerance("sum", "float32", cin))


def test_f32_core_result_does_not_depend_on_the_launch(card):
    # each output sums k in order with fmaf: 16 positions with equal
    # (v, u) give 16 bit-equal slabs, and rows of an inner product embedded
    # in a larger M (another tile, another row of it) equal the rows alone
    rng = np.random.default_rng(21)
    v1 = _normal(rng, (1, 333, 128), card, torch.float32)
    u1 = _normal(rng, (1, 128, 128), card, torch.float32)
    m = wino_mod.winograd_elementwise_stage(v1.expand(16, -1, -1)
                                            .contiguous(),
                                            u1.expand(16, -1, -1)
                                            .contiguous())
    for i in range(16):
        assert torch.equal(m[i], m[0]), i
    assert torch.equal(m[0], wino_mod.winograd_elementwise_stage(v1, u1)[0])
    x = _normal(rng, (300, 200), card, torch.float32)
    w = _normal(rng, (200, 136), card, torch.float32)
    big = _normal(rng, (1000, 200), card, torch.float32)
    big[517:817] = x
    for fuse in ("none", "gelu"):
        alone = ip_mod.inner_product(x, w, fuse=fuse)
        assert torch.equal(ip_mod.inner_product(big, w, fuse=fuse)[517:817],
                           alone)


@pytest.mark.parametrize("hw", [8, 10, 7, 13])
def test_conv_winograd_with_kernel_matches_direct(card, hw):
    rng = np.random.default_rng(hw)
    x = _normal(rng, (2, hw, hw + 1, 32), card, torch.float32)
    w = _normal(rng, (3, 3, 32, 128), card, torch.float32, 0.1)
    out = wino_mod.conv2d_winograd(x, w)
    torch.testing.assert_close(out, prim_ref.conv2d_winograd(x, w),
                               atol=16 * tolerance("sum", "float32", 32,
                                                   0.3)["atol"],
                               rtol=2.0 ** -20)
    torch.backends.cudnn.allow_tf32 = False
    torch.testing.assert_close(out, prim_ref.conv2d(x, w), rtol=2e-3,
                               atol=5e-3)


def test_fma_probe_measures_a_plausible_float32_rate(card):
    from repro_torch.core.roofline import microbench
    flops = microbench.measure_peak_flops(card, iters=4096, repeats=2)
    assert 1e12 < flops < 1.2 * 132 * 128 * 2 * 2.0e9     # under any clock


# --------------------------------------------------------------------------
# LayerNorm, average pooling (blocked and naive) and flash attention
# (csrc/layernorm.cu, avgpool.cu, flash_attention.cu).  Tolerances:
# launch/primitives.py::tolerance (stated in PERF.md, PR 15).
# --------------------------------------------------------------------------

from repro_torch.kernels import avgpool as pool_mod                # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod          # noqa: E402
from repro_torch.kernels import layernorm as ln_mod                # noqa: E402
from repro_torch.kernels import ops as prim_ops                    # noqa: E402


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("r,d", [(256, 128), (512, 768), (128, 1024),
                                 (1, 1), (3, 5), (8192, 768), (3, 4097),
                                 (8, 16384), (64, 1025), (5, 33)])
def test_layernorm_kernel_matches_plain(card, dt, r, d):
    dtype = _DT[dt]
    dname = str(dtype).split(".")[-1]
    rng = np.random.default_rng(r + d)
    x = _normal(rng, (r, d), card, dtype, 3.0)
    s = _normal(rng, (d,), card, torch.float32)
    b = _normal(rng, (d,), card, torch.float32)
    before = ln_mod.layernorm.launches
    out = ln_mod.layernorm(x, s, b)
    torch.cuda.synchronize()
    assert ln_mod.layernorm.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    torch.testing.assert_close(out.float(),
                               ln_mod.layernorm_reference(x, s, b).float(),
                               **tolerance("norm", dname))
    torch.testing.assert_close(out.float(),
                               ln_mod.layernorm_reference(x.float(), s, b),
                               **tolerance("norm", dname, vs="plain_f32"))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_layernorm_kernel_on_misaligned_rows(card, dt, offset):
    """Rows that start off a 16-byte boundary take the scalar head."""
    dtype = _DT[dt]
    dname = str(dtype).split(".")[-1]
    rng = np.random.default_rng(offset)
    x = _normal(rng, (7 * 301 + offset,), card, dtype)[offset:].view(7, 301)
    s = _normal(rng, (301,), card, torch.float32)
    b = _normal(rng, (301,), card, torch.float32)
    torch.testing.assert_close(ln_mod.layernorm(x, s, b).float(),
                               ln_mod.layernorm_reference(x, s, b).float(),
                               **tolerance("norm", dname))


def test_layernorm_kernel_keeps_leading_dims_and_bf16_params(card):
    rng = np.random.default_rng(0)
    x = _normal(rng, (2, 3, 64), card, torch.float32)
    s = _normal(rng, (64,), card, torch.bfloat16)
    b = _normal(rng, (64,), card, torch.bfloat16)
    out = prim_ops.layernorm(x, s, b)
    assert out.shape == (2, 3, 64)
    torch.testing.assert_close(out, ln_mod.layernorm_reference(x, s, b),
                               **tolerance("norm", "float32"))


def test_layernorm_kernel_rejects_bad_inputs(card):
    x = torch.ones((4, 8), device=card)
    with pytest.raises(ValueError, match="scale"):
        ln_mod.layernorm(x, torch.ones(7, device=card),
                         torch.ones(8, device=card))
    with pytest.raises(ValueError, match="dtype"):
        ln_mod.layernorm(x.half(), torch.ones(8, device=card),
                         torch.ones(8, device=card))
    with pytest.raises(ValueError, match="D <="):
        ln_mod.layernorm(torch.ones((1, ln_mod.MAX_D + 1), device=card),
                         torch.ones(ln_mod.MAX_D + 1, device=card),
                         torch.ones(ln_mod.MAX_D + 1, device=card))
    with pytest.raises(ValueError, match="CUDA"):
        ln_mod.layernorm(x.cpu(), torch.ones(8), torch.ones(8))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape,window", [
    ((2, 16, 16, 128), 2), ((2, 16, 16, 256), 4),   # the reference tests'
    ((8, 64, 64, 128), 2),                          # the reference bench's
    ((2, 7, 9, 3), 2), ((3, 15, 13, 64), 3), ((1, 11, 17, 130), 4),
    ((1, 3, 3, 5), 1), ((2, 5, 4, 8), 5),          # window 1; past W
])
def test_avg_pool_kernels_match_plain_and_each_other(card, dt, shape,
                                                     window):
    dtype = _DT[dt]
    dname = str(dtype).split(".")[-1]
    x = _normal(np.random.default_rng(shape[-1]), shape, card, dtype)
    before = (pool_mod.avg_pool_blocked.launches,
              pool_mod.avg_pool_nchw.launches)
    blocked = pool_mod.avg_pool_blocked(x, window=window)
    naive = pool_mod.avg_pool_naive(x, window=window)
    torch.cuda.synchronize()
    n, h, w, c = shape
    want_shape = (n, h // window, w // window, c)
    assert blocked.shape == naive.shape == want_shape
    launched = int(blocked.numel() > 0)
    assert (pool_mod.avg_pool_blocked.launches,
            pool_mod.avg_pool_nchw.launches) == (before[0] + launched,
                                                 before[1] + launched)
    assert torch.equal(blocked, naive)               # bit for bit
    want = pool_mod.avg_pool_reference(x, window=window)
    torch.testing.assert_close(blocked.float(), want.float(),
                               **tolerance("sum", dname, window * window))
    torch.testing.assert_close(
        blocked.float(),
        pool_mod.avg_pool_reference(x.float(), window=window),
        **tolerance("sum", dname, window * window, vs="plain_f32"))


def test_avg_pool_nchw_kernel_alone_matches_plain(card):
    xc = _normal(np.random.default_rng(1), (4, 32, 30, 28), card,
                 torch.float32)
    torch.testing.assert_close(
        pool_mod.avg_pool_nchw(xc, window=2),
        pool_mod.avg_pool_nchw_reference(xc, window=2),
        **tolerance("sum", "float32", 4))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,kv,sq,sk,hd", [
    (2, 4, 2, 256, 256, 64), (2, 4, 4, 256, 256, 128),   # the reference
    (2, 8, 1, 512, 512, 64), (2, 4, 2, 128, 256, 64),    # tests' shapes
    (1, 5, 1, 1, 1, 128), (2, 4, 4, 100, 100, 64),
    (1, 10, 2, 1000, 1000, 128), (1, 8, 1, 100, 1000, 64),
    (1, 8, 8, 1000, 100, 128), (3, 6, 2, 65, 63, 64),
    # the bf16 kernel's 128-row query tiles and 128-key slabs at their
    # edges, G 1 / 2 / 5 / 8, Sq < Sk and Sq > Sk, hd 64 and 128
    (1, 2, 2, 127, 127, 64), (2, 4, 2, 128, 128, 128),
    (1, 5, 1, 129, 129, 64), (1, 8, 1, 257, 257, 128),
    (1, 10, 2, 127, 257, 128), (1, 4, 2, 128, 257, 64),
    (2, 5, 1, 129, 128, 128), (1, 8, 1, 257, 129, 128),
    (2, 2, 2, 257, 127, 64), (1, 16, 2, 128, 129, 64),
    (1, 10, 2, 4096, 4096, 128),                         # long, G 5
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(card, dt, b, h, kv, sq, sk, hd,
                                              causal):
    dtype = _DT[dt]
    dname = str(dtype).split(".")[-1]
    rng = np.random.default_rng(sq + sk + hd)
    q = _normal(rng, (b, h, sq, hd), card, dtype)
    k = _normal(rng, (b, kv, sk, hd), card, dtype)
    v = _normal(rng, (b, kv, sk, hd), card, dtype)
    before = fa_mod.flash_attention.launches
    out = fa_mod.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_mod.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(
        out.float(),
        fa_mod.flash_attention_reference(q, k, v, causal=causal).float(),
        **tolerance("attention", dname, sk, hd=hd))
    torch.testing.assert_close(
        out.float(),
        fa_mod.flash_attention_reference(q.float(), k.float(), v.float(),
                                         causal=causal),
        **tolerance("attention", dname, sk, vs="plain_f32", hd=hd))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sq,sk", [(257, 257), (129, 300)])
def test_flash_attention_kernel_is_deterministic(card, dt, sq, sk):
    # no atomics, a fixed order of sums: the same inputs give the same
    # bits, also in the model layout's transposed views
    rng = np.random.default_rng(sq * sk)
    q = _normal(rng, (2, sq, 10, 128), card, _DT[dt]).transpose(1, 2)
    k = _normal(rng, (2, sk, 2, 128), card, _DT[dt]).transpose(1, 2)
    v = _normal(rng, (2, sk, 2, 128), card, _DT[dt]).transpose(1, 2)
    for causal in (True, False):
        first = fa_mod.flash_attention(q, k, v, causal=causal)
        again = fa_mod.flash_attention(q, k, v, causal=causal)
        assert torch.equal(first, again)


@pytest.mark.parametrize("dt,hd,want", [
    ("bf16", 128, "wgmma bf16 hd128"), ("bf16", 64, "wgmma bf16 hd64"),
    ("f32", 128, "CUDA cores float32"), ("f32", 64, "CUDA cores float32"),
])
def test_flash_attention_plan_names_its_path(card, dt, hd, want):
    q = torch.ones((1, 2, 3, hd), device=card, dtype=_DT[dt])
    assert fa_mod.plan(q) == want


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_model_layout_reads_strides(card, dt):
    """ops.flash_attention hands the kernel transposed views: no copies,
    and the output comes back in model layout."""
    dtype = _DT[dt]
    rng = np.random.default_rng(7)
    q = _normal(rng, (2, 130, 8, 64), card, dtype)
    k = _normal(rng, (2, 130, 2, 64), card, dtype)
    v = _normal(rng, (2, 130, 2, 64), card, dtype)
    out = prim_ops.flash_attention(q, k, v)
    assert out.shape == q.shape and out.is_contiguous()
    want = fa_mod.flash_attention_reference(
        q.transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(out.float(), want.float(),
                               **tolerance("attention",
                                           str(dtype).split(".")[-1], 130,
                                           hd=64))


def test_flash_attention_kernel_rejects_bad_inputs(card):
    q = torch.ones((1, 4, 8, 64), device=card)
    k = torch.ones((1, 2, 8, 64), device=card)
    with pytest.raises(ValueError, match="head dim"):
        fa_mod.flash_attention(q[..., :32], k[..., :32], k[..., :32])
    k3 = torch.ones((1, 3, 8, 64), device=card)      # 4 heads, 3 KV heads
    with pytest.raises(ValueError, match="incompatible"):
        fa_mod.flash_attention(q, k3, k3)
    with pytest.raises(ValueError, match="dtype"):
        fa_mod.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention(q.cpu(), k.cpu(), k.cpu())


# --------------------------------------------------------------------------
# Ring kernels, pipeline="double" (csrc/paged_attention_ring.cu,
# csrc/mla_paged_attention_ring.cu): bit for bit the "off" kernel's output
# on the same inputs (torch.equal), and within the off kernels' tolerances
# of the plain versions, over the off kernels' parametrisations.
# --------------------------------------------------------------------------

def _kernels_a_call(wrapper, dtype):
    # a bf16 call of an MLA wrapper runs the tensor-core core: its split
    # and merge kernels; every other call one kernel
    mla = wrapper.__name__.startswith("mla_")
    return 2 if mla and dtype == torch.bfloat16 else 1


def _ring_check(ring, off, plain, args, n_float, kw, dtype):
    n = ring.launches
    out = ring(*args, **kw)
    want = off(*args, **kw)
    ref = plain(*args, **kw)
    ref32 = plain(*(a.float() for a in args[:n_float]), *args[n_float:], **kw)
    torch.cuda.synchronize()
    assert ring.launches == n + _kernels_a_call(ring, dtype)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, want)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(out.float(), ref32, **TOL_F32_PLAIN[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KV,G,hd,page,nb", [
    (4, 8, 2, 128, 16, 32),    # qwen3-0.6b decode
    (3, 2, 2, 16, 4, 5),       # smoke widths
    (2, 4, 1, 32, 8, 3),       # MHA
    (4, 1, 8, 64, 16, 2),      # one KV head, 8 query heads
    (2, 2, 3, 256, 16, 4),     # odd group count, widest head
])
@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
def test_gqa_ring_decode_equals_off_kernel(card, dtype, B, KV, G, hd, page,
                                           nb, soft_cap):
    rng = np.random.default_rng(B * 100 + hd)
    args = _case(rng, B, KV, G, hd, page, nb, dtype, card)
    if soft_cap:
        args = (args[0] * 4, *args[1:])
    _ring_check(pa.paged_attention_ring, pa.paged_attention,
                pa.paged_attention_reference, args, 3,
                dict(scale=hd ** -0.5, soft_cap=soft_cap), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,KV,G,hd,page,nb", [
    (4, 5, 8, 5, 128, 16, 33),   # qwen3-14b verify, k = 4 (25 rows)
    (4, 5, 8, 2, 128, 16, 33),   # qwen3-0.6b draft catch-up (10 rows)
    (3, 4, 2, 2, 16, 4, 5),      # smoke widths
    (2, 2, 4, 1, 32, 8, 3),      # MHA
    (2, 5, 1, 8, 64, 16, 2),     # one KV head, 40 rows
    (2, 3, 2, 3, 256, 16, 4),    # odd group count, widest head
])
@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
def test_gqa_ring_verify_equals_off_kernel(card, dtype, B, T, KV, G, hd,
                                           page, nb, soft_cap):
    rng = np.random.default_rng(B * 100 + T * 10 + hd)
    args = _gqa_verify_case(rng, B, T, KV, G, hd, page, nb, dtype, card)
    if soft_cap:
        args = (args[0] * 4, *args[1:])
    _ring_check(pa.paged_attention_ring, pa.paged_attention_verify,
                pa.paged_attention_verify_reference, args, 3,
                dict(scale=hd ** -0.5, soft_cap=soft_cap), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("backed", [True, False],
                         ids=["backed", "trash-margin"])
def test_gqa_ring_verify_edges(card, dtype, backed):
    """Chains crossing a page, from pos 0, and past the whole table."""
    rng = np.random.default_rng(21)
    args = _gqa_verify_case(rng, 4, 5, 8, 5, 128, 16, 4, dtype, card,
                            lens=[15, 31, 1, 62], backed_drafts=backed)
    _ring_check(pa.paged_attention_ring, pa.paged_attention_verify,
                pa.paged_attention_verify_reference, args, 3,
                dict(scale=128 ** -0.5), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gqa_ring_decode_past_the_off_kernels_group_limit(card, dtype):
    """16 query heads per KV head: the float32 off decode kernel refuses
    them, the ring takes them as one-token verification, bit-equal to the
    off verify kernel at T = 1.  bf16 queries run on the tensor-core core
    in every walk, so the off decode takes them too, bit-equal to the ring
    and to verify at T = 1."""
    rng = np.random.default_rng(25)
    args = _gqa_verify_case(rng, 3, 1, 2, 16, 64, 16, 6, dtype, card)
    kw = dict(scale=64 ** -0.5)
    dec = (args[0][:, 0].contiguous(), *args[1:])
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="query heads per KV head"):
            pa.paged_attention(*dec, **kw)
        off = None
    else:
        off = pa.paged_attention(*dec, **kw)
    out = pa.paged_attention_ring(*dec, **kw)
    want = pa.paged_attention_verify(*args, **kw)[:, 0]
    ref = pa.paged_attention_reference(*dec, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    if off is not None:
        assert torch.equal(off, out)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


def test_gqa_ring_idle_trash_lanes_finite(card):
    rng = np.random.default_rng(22)
    args = _gqa_verify_case(rng, 4, 5, 8, 5, 128, 16, 33, torch.bfloat16,
                            card, trash=True)
    _ring_check(pa.paged_attention_ring, pa.paged_attention_verify,
                pa.paged_attention_verify_reference, args, 3,
                dict(scale=128 ** -0.5), torch.bfloat16)
    dec = _case(rng, 4, 8, 2, 128, 16, 32, torch.bfloat16, card, trash=True)
    _ring_check(pa.paged_attention_ring, pa.paged_attention,
                pa.paged_attention_reference, dec, 3,
                dict(scale=128 ** -0.5), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,r,dr,page,nb", [
    (4, 128, 512, 64, 16, 16),   # deepseek-v2 decode, 4 slots
    (3, 4, 32, 8, 8, 5),         # smoke widths (one masked head block)
    (2, 12, 64, 16, 32, 2),      # heads not a multiple of the tile
    (2, 8, 256, 32, 8, 4),
    (2, 16, 128, 8, 16, 3),
])
def test_mla_ring_decode_equals_off_kernel(card, dtype, B, H, r, dr, page,
                                           nb):
    rng = np.random.default_rng(B * 1000 + r + dr)
    _ring_check(pa.mla_paged_attention_ring, pa.mla_paged_attention,
                pa.mla_paged_attention_reference,
                _mla_case(rng, B, H, r, dr, page, nb, dtype, card), 4,
                dict(scale=192 ** -0.5), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mla_ring_decode_edge_positions_and_trash(card, dtype):
    """pos 0, a partly filled last page, a full table; idle lanes."""
    rng = np.random.default_rng(8)
    for args in (_mla_case(rng, 3, 16, 512, 64, 16, 4, dtype, card,
                           lens=[1, 16 * 2 + 5, 16 * 4]),
                 _mla_case(rng, 4, 128, 512, 64, 16, 16, dtype, card,
                           trash=True)):
        _ring_check(pa.mla_paged_attention_ring, pa.mla_paged_attention,
                    pa.mla_paged_attention_reference, args, 4,
                    dict(scale=192 ** -0.5), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,H,r,dr,page,nb", [
    (4, 4, 128, 512, 64, 16, 17),  # deepseek-v2 verify, k = 3
    (3, 3, 4, 32, 8, 8, 5),        # smoke widths (one masked head block)
    (2, 2, 12, 64, 16, 32, 2),     # heads not a multiple of the tile
    (2, 5, 8, 256, 32, 8, 4),
])
def test_mla_ring_verify_equals_off_kernel(card, dtype, B, T, H, r, dr,
                                           page, nb):
    rng = np.random.default_rng(B * 1000 + T * 100 + r + dr)
    _ring_check(pa.mla_paged_attention_ring, pa.mla_paged_attention_verify,
                pa.mla_paged_attention_verify_reference,
                _mla_verify_case(rng, B, T, H, r, dr, page, nb, dtype, card),
                4, dict(scale=192 ** -0.5), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["backed", "trash-margin", "idle"])
def test_mla_ring_verify_edges(card, dtype, case):
    """Chains crossing a page, from pos 0 and past the table, with the
    drafts' pages backed or on trash entries; idle all-trash lanes."""
    rng = np.random.default_rng(31)
    if case == "idle":
        args = _mla_verify_case(rng, 4, 4, 128, 512, 64, 16, 17, dtype,
                                card, trash=True)
    else:
        args = _mla_verify_case(rng, 4, 4, 16, 512, 64, 16, 4, dtype, card,
                                lens=[15, 30, 1, 63],
                                backed_drafts=case == "backed")
    _ring_check(pa.mla_paged_attention_ring, pa.mla_paged_attention_verify,
                pa.mla_paged_attention_verify_reference, args, 4,
                dict(scale=192 ** -0.5), dtype)


def test_ring_kernels_dispatch_and_refusals(card):
    """ops with pipeline="double" launches the rings; the wrappers take
    quantized pools with their scales (bit-equal to the off kernels),
    refuse scale pools beside an unquantized pool, and refuse a page slab
    that does not fit twice in shared memory."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(40)
    args = _case(rng, 2, 2, 2, 16, 4, 3, torch.float32, card)
    n, n_off = pa.paged_attention_ring.launches, pa.paged_attention.launches
    out = ops.paged_attention(*args, scale=0.25, pipeline="double")
    with ops.use_pipeline("double"):
        again = ops.paged_attention(*args, scale=0.25)
    torch.cuda.synchronize()
    assert pa.paged_attention_ring.launches == n + 2
    assert pa.paged_attention.launches == n_off
    assert torch.equal(out, again)
    mla = _mla_case(rng, 2, 8, 64, 16, 8, 3, torch.float32, card)
    n = pa.mla_paged_attention_ring.launches
    ops.mla_paged_attention(*mla, scale=0.1, pipeline="double")
    assert pa.mla_paged_attention_ring.launches == n + 1
    for _, qargs, (ks, vs) in _quantize_pools(args, 1):
        kw = dict(scale=0.25, k_scale=ks, v_scale=vs)
        got = pa.paged_attention_ring(*qargs, **kw)
        assert torch.equal(got, pa.paged_attention(*qargs, **kw))
    for _, qargs, (cs, rs) in _quantize_pools(mla, 2):
        kw = dict(scale=0.1, c_scale=cs, r_scale=rs)
        got = pa.mla_paged_attention_ring(*qargs, **kw)
        assert torch.equal(got, pa.mla_paged_attention(*qargs, **kw))
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="unquantized"):
        pa.paged_attention_ring(*args, scale=0.25, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="unquantized"):
        pa.mla_paged_attention_ring(*mla, scale=0.1, c_scale=cs, r_scale=rs)
    q, k, v, bt, pos = args
    big = torch.zeros((2, 1024, 2, 128), device=card)   # 1 MB slab pair
    with pytest.raises(ValueError, match="does not fit"):
        pa.paged_attention_ring(q.new_zeros((2, 2, 2, 128)), big, big, bt,
                                pos, scale=0.1)


# --------------------------------------------------------------------------
# Quantized KV pools: the scale branches of the four single-walk kernels
# (int8 / fp8 e4m3 codes with float32 per-line scales), each against its
# plain version on the same codes and scales.  Both dequantize to the same
# float32 values and compute in float32, so only the summation order and,
# for a bf16 query, the final output rounding differ: float32 2e-5, bf16
# TOL_F32_PLAIN's 1e-2.
# --------------------------------------------------------------------------

KV_DTYPES = ["int8", "fp8_e4m3"]
QTOL = TOL_F32_PLAIN


def _quantize_pools(args, first):
    """``args`` with the pools at ``first`` and ``first + 1`` quantized
    (from their float32 values), for each storage type; yields (kv_dtype,
    args, scale pools)."""
    for kv_dtype in KV_DTYPES:
        out, scales = list(args), []
        for i in (first, first + 1):
            out[i], s = kvq.quantize(args[i].float(), kv_dtype)
            scales.append(s)
        yield kv_dtype, out, scales


def _quantized_check(kernel, plain, args, kw, dtype):
    n = kernel.launches
    out = kernel(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == n + _kernels_a_call(kernel, dtype)
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref.float(), **QTOL[dtype])
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KV,G,hd,page,nb,trash", [
    (4, 8, 2, 128, 16, 32, False),   # qwen3-0.6b decode
    (3, 2, 2, 16, 4, 5, False),      # smoke widths
    (2, 2, 3, 256, 16, 4, False),    # odd group count, widest head
    (4, 8, 2, 128, 16, 32, True),    # idle lanes: every entry trash page 0
])
@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
def test_quantized_paged_attention_matches_plain(card, dtype, B, KV, G, hd,
                                                 page, nb, trash, soft_cap):
    rng = np.random.default_rng(B * 100 + hd + trash)
    args = _case(rng, B, KV, G, hd, page, nb, dtype, card, trash=trash)
    if soft_cap:
        args = (args[0] * 4, *args[1:])
    for _, qargs, (ks, vs) in _quantize_pools(args, 1):
        _quantized_check(pa.paged_attention, pa.paged_attention_reference,
                         qargs, dict(scale=hd ** -0.5, soft_cap=soft_cap,
                                     k_scale=ks, v_scale=vs), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,KV,G,hd,page,nb,case", [
    (4, 5, 8, 5, 128, 16, 33, "ragged"),   # qwen3-14b verify, k = 4
    (3, 3, 2, 2, 16, 4, 5, "ragged"),      # smoke widths
    (4, 4, 2, 3, 64, 16, 4, "edges"),      # page-crossing chains, past table
    (4, 4, 2, 3, 64, 16, 4, "margin"),     # the same, drafts on trash entries
    (4, 5, 8, 5, 128, 16, 33, "trash"),    # idle lanes
])
@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
def test_quantized_paged_attention_verify_matches_plain(
        card, dtype, B, T, KV, G, hd, page, nb, case, soft_cap):
    rng = np.random.default_rng(B * 1000 + T * 100 + hd)
    kw = dict(trash=case == "trash")
    if case in ("edges", "margin"):
        kw.update(lens=[15, 30, 1, 63], backed_drafts=case == "edges")
    args = _gqa_verify_case(rng, B, T, KV, G, hd, page, nb, dtype, card,
                            **kw)
    if soft_cap:
        args = (args[0] * 4, *args[1:])
    for _, qargs, (ks, vs) in _quantize_pools(args, 1):
        _quantized_check(pa.paged_attention_verify,
                         pa.paged_attention_verify_reference, qargs,
                         dict(scale=hd ** -0.5, soft_cap=soft_cap,
                              k_scale=ks, v_scale=vs), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,r,dr,page,nb,case", [
    (4, 128, 512, 64, 16, 16, "ragged"),   # deepseek-v2 decode
    (3, 4, 32, 8, 8, 4, "ragged"),         # smoke widths
    (2, 12, 64, 16, 32, 2, "ragged"),      # heads not a multiple of the tile
    (4, 16, 512, 64, 16, 16, "edges"),     # pos 0, part page, one page, full
    (4, 128, 512, 64, 16, 16, "trash"),    # idle lanes
])
def test_quantized_mla_paged_attention_matches_plain(card, dtype, B, H, r,
                                                     dr, page, nb, case):
    rng = np.random.default_rng(B * 1000 + H + r + dr)
    lens = [1, 37, 16, nb * page] if case == "edges" else None
    args = _mla_case(rng, B, H, r, dr, page, nb, dtype, card,
                     trash=case == "trash", lens=lens)
    args = (args[0] * 0.5, args[1] * 0.5, *args[2:])   # the model's q scale
    for _, qargs, (cs, rs) in _quantize_pools(args, 2):
        _quantized_check(pa.mla_paged_attention,
                         pa.mla_paged_attention_reference, qargs,
                         dict(scale=192 ** -0.5, c_scale=cs, r_scale=rs),
                         dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,H,r,dr,page,nb,case", [
    (4, 4, 128, 512, 64, 16, 17, "ragged"),  # deepseek-v2 verify, k = 3
    (3, 3, 4, 32, 8, 8, 5, "ragged"),        # smoke widths
    (4, 4, 16, 512, 64, 16, 4, "edges"),     # chains crossing pages
    (4, 4, 16, 512, 64, 16, 4, "margin"),    # drafts on trash entries
    (4, 4, 128, 512, 64, 16, 17, "trash"),   # idle lanes
])
def test_quantized_mla_paged_attention_verify_matches_plain(
        card, dtype, B, T, H, r, dr, page, nb, case):
    rng = np.random.default_rng(B * 1000 + T * 100 + r + dr)
    kw = dict(trash=case == "trash")
    if case in ("edges", "margin"):
        kw.update(lens=[15, 30, 1, 63], backed_drafts=case == "edges")
    args = _mla_verify_case(rng, B, T, H, r, dr, page, nb, dtype, card, **kw)
    args = (args[0] * 0.5, args[1] * 0.5, *args[2:])
    for _, qargs, (cs, rs) in _quantize_pools(args, 2):
        _quantized_check(pa.mla_paged_attention_verify,
                         pa.mla_paged_attention_verify_reference, qargs,
                         dict(scale=192 ** -0.5, c_scale=cs, r_scale=rs),
                         dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quantized_verify_t1_equals_decode_kernels(card, dtype):
    """One verify token is one decode step, bit for bit, on quantized pools
    too (the same arithmetic in the same order)."""
    rng = np.random.default_rng(60)
    q, k, v, bt, pos = _gqa_verify_case(rng, 4, 1, 8, 2, 128, 16, 33, dtype,
                                        card)
    for _, (_, kq, vq, *_), (ks, vs) in _quantize_pools((q, k, v), 1):
        kw = dict(scale=128 ** -0.5, k_scale=ks, v_scale=vs)
        ver = pa.paged_attention_verify(q, kq, vq, bt, pos, **kw)[:, 0]
        dec = pa.paged_attention(q[:, 0].contiguous(), kq, vq, bt, pos, **kw)
        torch.cuda.synchronize()
        assert torch.equal(ver, dec)
    ql, qr, c, r, bt, pos = _mla_verify_case(rng, 4, 1, 128, 512, 64, 16,
                                             16, dtype, card)
    for _, (_, _, cq, rq), (cs, rs) in _quantize_pools((ql, qr, c, r), 2):
        kw = dict(scale=192 ** -0.5, c_scale=cs, r_scale=rs)
        ver = pa.mla_paged_attention_verify(ql, qr, cq, rq, bt, pos,
                                            **kw)[:, 0]
        dec = pa.mla_paged_attention(ql[:, 0].contiguous(),
                                     qr[:, 0].contiguous(), cq, rq, bt, pos,
                                     **kw)
        torch.cuda.synchronize()
        assert torch.equal(ver, dec)


def test_quantized_decode_kernels_reject_bad_scale_pools(card):
    from repro_torch.kernels import ops
    rng = np.random.default_rng(61)
    q, k, v, bt, pos = _case(rng, 2, 2, 2, 16, 4, 3, torch.bfloat16, card)
    kq, ks = kvq.quantize(k, "int8")
    vq, vs = kvq.quantize(v, "int8")
    for kw, match in [
            (dict(k_scale=ks, v_scale=vs[:, :2].contiguous()), "shape"),
            (dict(k_scale=ks, v_scale=vs.bfloat16()), "dtype"),
            (dict(v_scale=vs), "both scale pools"),
            (dict(k_scale=ks.transpose(0, 1).contiguous().transpose(0, 1),
                  v_scale=vs), "contiguous")]:
        with pytest.raises(ValueError, match=match):
            pa.paged_attention(q, kq, vq, bt, pos, scale=0.25, **kw)
    with pytest.raises(ValueError, match="dtype"):       # mixed storage
        pa.paged_attention(q, kq, vq.view(torch.float8_e4m3fn), bt, pos,
                           scale=0.25, k_scale=ks, v_scale=vs)
    ql, qr, c, r, bt, pos = _mla_case(rng, 2, 8, 64, 16, 8, 3,
                                      torch.float32, card)
    cq, cs = kvq.quantize(c, "int8")
    rq, rs = kvq.quantize(r, "int8")
    with pytest.raises(ValueError, match="shape"):
        pa.mla_paged_attention(ql, qr, cq, rq, bt, pos, scale=0.1,
                               c_scale=cs[:1].contiguous(), r_scale=rs)
    with pytest.raises(ValueError, match="needs its float32 scale pools"):
        pa.mla_paged_attention(ql, qr, cq, rq, bt, pos, scale=0.1)
    # under pipeline="double" the ring checks the same scale pools, and
    # takes good ones
    with pytest.raises(ValueError, match="shape"):
        ops.mla_paged_attention(ql, qr, cq, rq, bt, pos, scale=0.1,
                                c_scale=cs[:1].contiguous(), r_scale=rs,
                                pipeline="double")
    n = pa.mla_paged_attention_ring.launches
    got = ops.mla_paged_attention(ql, qr, cq, rq, bt, pos, scale=0.1,
                                  c_scale=cs, r_scale=rs, pipeline="double")
    want = pa.mla_paged_attention(ql, qr, cq, rq, bt, pos, scale=0.1,
                                  c_scale=cs, r_scale=rs)
    torch.cuda.synchronize()
    assert pa.mla_paged_attention_ring.launches == n + 1
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# The rings' scale branches (pipeline="double" over int8 / fp8 e4m3 pools):
# bit for bit the quantized off kernel's output on the same codes and
# scales (torch.equal), and within QTOL of the plain version, over the
# quantized off kernels' cases above and the reference's quantized double
# cases (tests/test_kv_quantize.py: smoke widths, ragged tables; its MLA
# page 4 is page 8 here, the smallest the MLA kernels take).
# --------------------------------------------------------------------------

def _ring_quantized_check(ring, off, plain, args, first, names, kw, dtype):
    for _, qargs, scales in _quantize_pools(args, first):
        skw = dict(kw, **dict(zip(names, scales)))
        want = off(*qargs, **skw)
        out = _quantized_check(ring, plain, qargs, skw, dtype)
        assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KV,G,hd,page,nb,trash", [
    (4, 8, 2, 128, 16, 32, False),   # qwen3-0.6b decode
    (3, 2, 2, 16, 4, 5, False),      # smoke widths (the reference's case)
    (2, 2, 3, 256, 16, 4, False),    # odd group count, widest head
    (4, 8, 2, 128, 16, 32, True),    # idle lanes: every entry trash page 0
])
@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
def test_gqa_ring_quantized_decode_equals_off_kernel(
        card, dtype, B, KV, G, hd, page, nb, trash, soft_cap):
    rng = np.random.default_rng(B * 100 + hd + trash)
    args = _case(rng, B, KV, G, hd, page, nb, dtype, card, trash=trash)
    if soft_cap:
        args = (args[0] * 4, *args[1:])
    _ring_quantized_check(pa.paged_attention_ring, pa.paged_attention,
                          pa.paged_attention_reference, args, 1,
                          ("k_scale", "v_scale"),
                          dict(scale=hd ** -0.5, soft_cap=soft_cap), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,KV,G,hd,page,nb,case", [
    (4, 5, 8, 5, 128, 16, 33, "ragged"),   # qwen3-14b verify, k = 4
    (4, 5, 8, 2, 128, 16, 33, "ragged"),   # qwen3-0.6b draft catch-up
    (2, 3, 2, 2, 16, 4, 4, "ragged"),      # smoke widths (the reference's)
    (4, 4, 2, 3, 64, 16, 4, "edges"),      # page-crossing chains, past table
    (4, 4, 2, 3, 64, 16, 4, "margin"),     # the same, drafts on trash entries
    (4, 5, 8, 5, 128, 16, 33, "trash"),    # idle lanes
])
@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
def test_gqa_ring_quantized_verify_equals_off_kernel(
        card, dtype, B, T, KV, G, hd, page, nb, case, soft_cap):
    rng = np.random.default_rng(B * 1000 + T * 100 + hd)
    kw = dict(trash=case == "trash")
    if case in ("edges", "margin"):
        kw.update(lens=[15, 30, 1, 63], backed_drafts=case == "edges")
    args = _gqa_verify_case(rng, B, T, KV, G, hd, page, nb, dtype, card,
                            **kw)
    if soft_cap:
        args = (args[0] * 4, *args[1:])
    _ring_quantized_check(pa.paged_attention_ring, pa.paged_attention_verify,
                          pa.paged_attention_verify_reference, args, 1,
                          ("k_scale", "v_scale"),
                          dict(scale=hd ** -0.5, soft_cap=soft_cap), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,r,dr,page,nb,case", [
    (4, 128, 512, 64, 16, 16, "ragged"),   # deepseek-v2 decode
    (3, 4, 32, 8, 8, 4, "ragged"),         # smoke widths, 8-byte rope lines
    (2, 12, 64, 16, 32, 2, "ragged"),      # heads not a multiple of the tile
    (4, 16, 512, 64, 16, 16, "edges"),     # pos 0, part page, one page, full
    (4, 128, 512, 64, 16, 16, "trash"),    # idle lanes
])
def test_mla_ring_quantized_decode_equals_off_kernel(card, dtype, B, H, r,
                                                     dr, page, nb, case):
    rng = np.random.default_rng(B * 1000 + H + r + dr)
    lens = [1, 37, 16, nb * page] if case == "edges" else None
    args = _mla_case(rng, B, H, r, dr, page, nb, dtype, card,
                     trash=case == "trash", lens=lens)
    args = (args[0] * 0.5, args[1] * 0.5, *args[2:])   # the model's q scale
    _ring_quantized_check(pa.mla_paged_attention_ring, pa.mla_paged_attention,
                          pa.mla_paged_attention_reference, args, 2,
                          ("c_scale", "r_scale"), dict(scale=192 ** -0.5),
                          dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,H,r,dr,page,nb,case", [
    (4, 4, 128, 512, 64, 16, 17, "ragged"),  # deepseek-v2 verify, k = 3
    (2, 3, 4, 32, 8, 8, 4, "ragged"),        # smoke widths (the reference's)
    (4, 4, 16, 512, 64, 16, 4, "edges"),     # chains crossing pages
    (4, 4, 16, 512, 64, 16, 4, "margin"),    # drafts on trash entries
    (4, 4, 128, 512, 64, 16, 17, "trash"),   # idle lanes
])
def test_mla_ring_quantized_verify_equals_off_kernel(
        card, dtype, B, T, H, r, dr, page, nb, case):
    rng = np.random.default_rng(B * 1000 + T * 100 + r + dr)
    kw = dict(trash=case == "trash")
    if case in ("edges", "margin"):
        kw.update(lens=[15, 30, 1, 63], backed_drafts=case == "edges")
    args = _mla_verify_case(rng, B, T, H, r, dr, page, nb, dtype, card, **kw)
    args = (args[0] * 0.5, args[1] * 0.5, *args[2:])
    _ring_quantized_check(pa.mla_paged_attention_ring,
                          pa.mla_paged_attention_verify,
                          pa.mla_paged_attention_verify_reference, args, 2,
                          ("c_scale", "r_scale"), dict(scale=192 ** -0.5),
                          dtype)


# --------------------------------------------------------------------------
# The tensor-core MLA core (csrc/mla_core.cu), the bf16 path of the
# decode, verify and ring wrappers: split-K over chunks of pages,
# merged in chunk order.  Each case holds the off kernel against the plain
# version (TOL / TOL_F32_PLAIN, or QTOL over quantized pools) and against
# the model of its own arithmetic order (pa.mla_split_model, held against
# the JAX reference on the CPU by tests/test_torch_mla_split.py) at
# MODEL_TOL: float32 sums in another order, then one bf16 rounding of the
# output (at most one bf16 ulp, 2^-8 relative, where the two land on
# either side of a rounding boundary).  The ring equals the off kernel,
# and a second call the first, bit for bit.
# --------------------------------------------------------------------------

MODEL_TOL = dict(atol=1e-3, rtol=2 ** -7)
MLA_STORES = ["bf16", *KV_DTYPES]


def _stored(args, store):
    """(args, scale kwargs) with the pools at 2 and 3 in ``store``."""
    if store == "bf16":
        return args, {}
    out, scales = list(args), []
    for i in (2, 3):
        out[i], s = kvq.quantize(args[i].float(), store)
        scales.append(s)
    return tuple(out), dict(c_scale=scales[0], r_scale=scales[1])


def _core_check(args, store):
    args, skw = _stored(args, store)
    kw = dict(scale=192 ** -0.5, **skw)
    decode = args[0].dim() == 3
    off = pa.mla_paged_attention if decode else pa.mla_paged_attention_verify
    plain = (pa.mla_paged_attention_reference if decode
             else pa.mla_paged_attention_verify_reference)
    n = off.launches
    out, again = off(*args, **kw), off(*args, **kw)
    ring = pa.mla_paged_attention_ring(*args, **kw)
    model = pa.mla_split_model(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    assert off.launches == n + 4          # two calls, two kernels each
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    assert torch.equal(out, again) and torch.equal(out, ring)
    torch.testing.assert_close(out.float(), model.float(), **MODEL_TOL)
    if skw:
        torch.testing.assert_close(out.float(), ref.float(),
                                   **QTOL[torch.bfloat16])
    else:
        ref32 = plain(*(a.float() for a in args[:4]), *args[4:], **kw)
        torch.testing.assert_close(out.float(), ref.float(),
                                   **TOL[torch.bfloat16])
        torch.testing.assert_close(out.float(), ref32,
                                   **TOL_F32_PLAIN[torch.bfloat16])
    return out


@pytest.mark.parametrize("store", MLA_STORES)
@pytest.mark.parametrize("B,H,r,dr,page,nb,lens", [
    # deepseek-v2 width: lines on chunk edges (a chunk is 2 pages, 32
    # lines), one line, a full table; every slot idle
    (4, 128, 512, 64, 16, 16, (32, 64, 33, 31)),
    (4, 128, 512, 64, 16, 16, (1, 2, 16, 17)),
    (4, 128, 512, 64, 16, 16, (256, 256, 255, 224)),
    (4, 128, 512, 64, 16, 16, None),
    # smoke widths (H 4, r 32, dr 8, page 8: a chunk is 16 lines)
    (3, 4, 32, 8, 8, 4, (1, 16, 32)),
    (3, 4, 32, 8, 8, 4, None),
], ids=["chunk-edges", "one-line", "full-table", "trash", "smoke",
        "smoke-trash"])
def test_mla_core_decode_edges(card, store, B, H, r, dr, page, nb, lens):
    rng = np.random.default_rng(B + H + r + page)
    args = _mla_case(rng, B, H, r, dr, page, nb, torch.bfloat16, card,
                     trash=lens is None, lens=list(lens or ()))
    _core_check((args[0] * 0.5, args[1] * 0.5, *args[2:]), store)


@pytest.mark.parametrize("store", MLA_STORES)
@pytest.mark.parametrize("B,T,H,r,dr,page,nb,lens", [
    (4, 4, 128, 512, 64, 16, 17, (97, 163, 190, 229)),
    (4, 4, 128, 512, 64, 16, 17, (29, 32, 1, 270)),   # chains across edges
    (3, 3, 4, 32, 8, 8, 5, (1, 14, 30)),
], ids=["serve", "chunk-edges", "smoke"])
def test_mla_core_verify_edges(card, store, B, T, H, r, dr, page, nb, lens):
    rng = np.random.default_rng(B + T + r)
    args = _mla_verify_case(rng, B, T, H, r, dr, page, nb, torch.bfloat16,
                            card, lens=list(lens))
    _core_check((args[0] * 0.5, args[1] * 0.5, *args[2:]), store)


@pytest.mark.parametrize("store", MLA_STORES)
@pytest.mark.parametrize("B,H,r,dr,page,nb", [
    (4, 128, 512, 64, 16, 16), (3, 4, 32, 8, 8, 4)], ids=["full", "smoke"])
def test_mla_core_t1_verify_and_ring_equal_decode(card, store, B, H, r, dr,
                                                  page, nb):
    rng = np.random.default_rng(70 + r)
    args = _mla_verify_case(rng, B, 1, H, r, dr, page, nb, torch.bfloat16,
                            card)
    args, skw = _stored(args, store)
    kw = dict(scale=192 ** -0.5, **skw)
    ql, qr = args[0][:, 0].contiguous(), args[1][:, 0].contiguous()
    dec = pa.mla_paged_attention(ql, qr, *args[2:], **kw)
    ver = pa.mla_paged_attention_verify(*args, **kw)[:, 0]
    ring_dec = pa.mla_paged_attention_ring(ql, qr, *args[2:], **kw)
    ring_ver = pa.mla_paged_attention_ring(*args, **kw)[:, 0]
    torch.cuda.synchronize()
    for got in (ver, ring_dec, ring_ver):
        assert torch.equal(got, dec)


def test_mla_split_plan_matches_the_launch(card):
    # the workspace the wrappers allocate is the header's count, and the
    # plan's blocks are the ones with lines to walk
    rng = np.random.default_rng(71)
    args = _mla_case(rng, 4, 128, 512, 64, 16, 16, torch.bfloat16, card,
                     lens=[97, 163, 190, 229])
    plan = pa.mla_split_plan(args[5], 1, 16, 16, 128, 512)
    assert (plan["chunk_lines"], plan["grid"], plan["blocks"]) == (32, 128,
                                                                   96)
    out = pa.mla_paged_attention(*args, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())


def _sass_functions(name):
    """{mangled name: SASS} of each kernel in csrc/<name>.cu's library
    (built if it is not), from cuobjdump beside nvcc."""
    import re
    import subprocess
    from pathlib import Path
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    build.build([name])
    sass = subprocess.run([str(cuobjdump), "--dump-sass",
                           str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return {f.split("\n", 1)[0].strip(): f
            for f in re.split(r"\n\s*Function : ", sass)[1:]}


def test_mla_bf16_kernels_run_on_hgmma(card):
    # the tensor-core core's split kernel carries HGMMA, built once for
    # the three walks; the float32 CUDA-core kernels FFMA and no HGMMA
    funcs = _sass_functions("mla_core")
    split = [f for f in funcs if "mla_split_bf16_kernel" in f]
    assert len(split) == 3 * 5 * 4, sorted(funcs)
    for f in split:
        assert "HGMMA" in funcs[f], f
    for name, f32 in (("mla_paged_attention", "mla_decode_kernel"),
                      ("mla_paged_attention_verify", "mla_verify_kernel"),
                      ("mla_paged_attention_ring", "mla_ring_kernel")):
        funcs = _sass_functions(name)
        cuda_cores = [f for f in funcs if f32 in f]
        assert cuda_cores and not any("mla_split" in f for f in funcs), \
            sorted(funcs)
        for f in cuda_cores:
            assert "HGMMA" not in funcs[f] and "FFMA" in funcs[f], f


# --------------------------------------------------------------------------
# The tensor-core GQA core (csrc/gqa_core.cu), the bf16 path of the
# decode, verify and ring wrappers: the rows of a KV head as the wgmma M,
# split-K over chunks of pages merged in chunk order by each row group's
# last block, one launch a call.  Each case holds the off kernel against
# the plain version (TOL / TOL_F32_PLAIN, or QTOL over quantized pools)
# and against the model of its own arithmetic order (pa.gqa_split_model,
# held against the JAX references on the CPU by
# tests/test_torch_gqa_split.py) at MODEL_TOL.  The ring equals the off
# kernel, and a second call the first, bit for bit; the row groups'
# counters are back at 0 after every call.
# --------------------------------------------------------------------------

GQA_STORES = ["bf16", *KV_DTYPES]


def _gqa_stored(args, store):
    """(args, scale kwargs) with the pools at 1 and 2 in ``store``."""
    if store == "bf16":
        return args, {}
    out, scales = list(args), []
    for i in (1, 2):
        out[i], s = kvq.quantize(args[i].float(), store)
        scales.append(s)
    return tuple(out), dict(k_scale=scales[0], v_scale=scales[1])


def _gqa_counters_are_zero():
    for buf in pa._gqa_counters.values():
        assert not bool(buf.any()), "a row group's counter was left set"


def _gqa_core_check(args, store, soft_cap=0.0):
    args, skw = _gqa_stored(args, store)
    kw = dict(scale=args[0].shape[-1] ** -0.5, soft_cap=soft_cap, **skw)
    decode = args[0].dim() == 4
    off = pa.paged_attention if decode else pa.paged_attention_verify
    plain = (pa.paged_attention_reference if decode
             else pa.paged_attention_verify_reference)
    n = off.launches
    out = off(*args, **kw)
    torch.cuda.synchronize()
    _gqa_counters_are_zero()
    again = off(*args, **kw)
    ring = pa.paged_attention_ring(*args, **kw)
    model = pa.gqa_split_model(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    _gqa_counters_are_zero()
    assert off.launches == n + 2          # two calls, one kernel each
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    assert torch.equal(out, again) and torch.equal(out, ring)
    torch.testing.assert_close(out.float(), model.float(), **MODEL_TOL)
    if skw:
        torch.testing.assert_close(out.float(), ref.float(),
                                   **QTOL[torch.bfloat16])
    else:
        ref32 = plain(*(a.float() for a in args[:3]), *args[3:], **kw)
        torch.testing.assert_close(out.float(), ref.float(),
                                   **TOL[torch.bfloat16])
        torch.testing.assert_close(out.float(), ref32,
                                   **TOL_F32_PLAIN[torch.bfloat16])
    return out


@pytest.mark.parametrize("store", GQA_STORES)
@pytest.mark.parametrize("B,KV,G,hd,page,nb,lens", [
    # qwen3-0.6b decode: lines on chunk edges (a chunk is a page, 16
    # lines), one line, a full table; every slot idle
    (4, 8, 2, 128, 16, 32, (32, 64, 33, 31)),
    (4, 8, 2, 128, 16, 32, (1, 2, 16, 17)),
    (4, 8, 2, 128, 16, 32, (512, 512, 511, 480)),
    (4, 8, 2, 128, 16, 32, None),
    # every other head dim; G 16, past the float32 kernel's limit
    (3, 2, 2, 16, 4, 5, (1, 9, 20)),
    (2, 4, 3, 32, 8, 3, (5, 24)),
    (2, 1, 8, 64, 16, 4, (33, 64)),
    (2, 2, 3, 256, 16, 4, (17, 64)),
    (2, 1, 16, 64, 16, 6, (40, 96)),
], ids=["chunk-edges", "one-line", "full-table", "trash", "hd16", "hd32",
        "hd64", "hd256", "g16"])
@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
def test_gqa_core_decode_edges(card, store, B, KV, G, hd, page, nb, lens,
                               soft_cap):
    rng = np.random.default_rng(B + KV + G + hd + page)
    q, *rest = _gqa_verify_case(rng, B, 1, KV, G, hd, page, nb,
                                torch.bfloat16, card, trash=lens is None,
                                lens=list(lens or ()))
    q = q[:, 0].contiguous() * (4.0 if soft_cap else 1.0)
    _gqa_core_check((q, *rest), store, soft_cap)


@pytest.mark.parametrize("store", GQA_STORES)
@pytest.mark.parametrize("B,T,KV,G,hd,page,nb,lens,backed", [
    # qwen3-14b verify, k 4 (25 rows), at chip_smoke.py's lines
    (4, 5, 8, 5, 128, 16, 33, (97, 163, 190, 229), True),
    # chains crossing a page and a chunk, from pos 0, past the table; the
    # same with the drafts on trash entries
    (4, 5, 8, 5, 128, 16, 4, (15, 31, 1, 62), True),
    (4, 5, 8, 5, 128, 16, 4, (15, 31, 1, 62), False),
    # 72 rows of a KV head: two row tiles
    (2, 9, 2, 8, 64, 16, 4, (30, 50), True),
    (3, 4, 2, 2, 16, 4, 5, (1, 14, 30), True),
    (2, 2, 4, 1, 32, 8, 3, (8, 20), True),
    (2, 3, 2, 3, 256, 16, 4, (20, 60), True),
], ids=["serve", "edges", "margin", "rows72", "hd16", "hd32", "hd256"])
def test_gqa_core_verify_edges(card, store, B, T, KV, G, hd, page, nb, lens,
                               backed):
    rng = np.random.default_rng(B + T + KV + G + hd)
    args = _gqa_verify_case(rng, B, T, KV, G, hd, page, nb, torch.bfloat16,
                            card, lens=list(lens), backed_drafts=backed)
    _gqa_core_check(args, store)


def test_gqa_core_verify_idle_lanes_and_soft_cap(card):
    rng = np.random.default_rng(80)
    for store in GQA_STORES:
        args = _gqa_verify_case(rng, 4, 5, 8, 5, 128, 16, 33,
                                torch.bfloat16, card, trash=True)
        _gqa_core_check(args, store)
        q, *rest = _gqa_verify_case(rng, 4, 5, 8, 5, 128, 16, 33,
                                    torch.bfloat16, card,
                                    lens=[97, 163, 190, 229],
                                    backed_drafts=True)
        _gqa_core_check((q * 4.0, *rest), store, soft_cap=30.0)


@pytest.mark.parametrize("store", GQA_STORES)
@pytest.mark.parametrize("T,G,page,nb,lens", [
    (1, 2, 32, 4, (40, 100)), (1, 2, 64, 3, (150, 65)),
    (5, 5, 32, 4, (40, 90)), (5, 5, 64, 3, (130, 60))],
    ids=["decode-page32", "decode-page64", "verify-page32", "verify-page64"])
def test_gqa_core_ring_with_tiles_in_flight(card, store, T, G, page, nb,
                                            lens):
    # at page 16 a chunk is one tile, which the ring stages synchronously
    # as the off walk does; at pages 32 and 64 it keeps 2 and 4 tiles in
    # flight and still equals the off walk bit for bit
    assert pa.gqa_core_stages(128, store != "bf16", page) == page // 16
    rng = np.random.default_rng(page + T)
    args = _gqa_verify_case(rng, 2, T, 8, G, 128, page, nb, torch.bfloat16,
                            card, lens=list(lens), backed_drafts=True)
    if T == 1:
        args = (args[0][:, 0].contiguous(), *args[1:])
    _gqa_core_check(args, store)


@pytest.mark.parametrize("store", GQA_STORES)
@pytest.mark.parametrize("B,KV,G,hd,page,nb", [
    (4, 8, 2, 128, 16, 33), (4, 8, 5, 128, 16, 33), (3, 2, 5, 16, 4, 5)],
    ids=["qwen3-0.6b", "qwen3-14b", "smoke"])
def test_gqa_core_t1_verify_and_ring_equal_decode(card, store, B, KV, G, hd,
                                                  page, nb):
    rng = np.random.default_rng(90 + G + hd)
    args = _gqa_verify_case(rng, B, 1, KV, G, hd, page, nb, torch.bfloat16,
                            card)
    args, skw = _gqa_stored(args, store)
    for cap in (0.0, 30.0):
        kw = dict(scale=hd ** -0.5, soft_cap=cap, **skw)
        q = args[0][:, 0].contiguous()
        dec = pa.paged_attention(q, *args[1:], **kw)
        ver = pa.paged_attention_verify(*args, **kw)[:, 0]
        ring_dec = pa.paged_attention_ring(q, *args[1:], **kw)
        ring_ver = pa.paged_attention_ring(*args, **kw)[:, 0]
        torch.cuda.synchronize()
        for got in (ver, ring_dec, ring_ver):
            assert torch.equal(got, dec)
    _gqa_counters_are_zero()


def test_gqa_bf16_kernels_run_on_hgmma(card):
    # the tensor-core core's kernel carries HGMMA, built once for the
    # three walks; the float32 CUDA-core kernels FFMA and no HGMMA
    funcs = _sass_functions("gqa_core")
    split = [f for f in funcs if "gqa_split_bf16_kernel" in f]
    assert len(split) == 3 * len(pa.KERNEL_HEAD_DIMS), sorted(funcs)
    for f in split:
        assert "HGMMA" in funcs[f], f
    for name, f32 in (("paged_attention", "paged_decode_kernel"),
                      ("paged_attention_verify", "paged_verify_kernel"),
                      ("paged_attention_ring", "paged_ring_kernel")):
        funcs = _sass_functions(name)
        cuda_cores = [f for f in funcs if f32 in f]
        assert cuda_cores and not any("gqa_split" in f for f in funcs), \
            sorted(funcs)
        for f in cuda_cores:
            assert "HGMMA" not in funcs[f] and "FFMA" in funcs[f], f


# --------------------------------------------------------------------------
# GELU's vector walks (csrc/gelu.cu): 16-byte accesses over the flat array
# and over aligned row-wise tiles, bit-equal to the strided walk
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("shape", [(333, 200), (7, 9, 13), (1, 5), (1000, 3),
                                   (4099,)])
def test_gelu_vector_walk_at_any_alignment(card, dt, offset, shape):
    """A contiguous view ``offset`` elements into a buffer (the vector walk
    peels a scalar head) and lengths that are not a multiple of 8 or 4 (a
    scalar tail): blocked equals naive bit for bit."""
    dtype = _DT[dt]
    dname = str(dtype).split(".")[-1]
    n = int(np.prod(shape))
    buf = _normal(np.random.default_rng(n + offset), (n + offset,), card,
                  dtype, 2.0)
    x = buf[offset:].view(shape)
    blocked, naive = gelu_mod.gelu_blocked(x), gelu_mod.gelu_naive(x)
    torch.cuda.synchronize()
    assert (blocked.data_ptr() - x.data_ptr()) % 16 == 0
    assert torch.equal(blocked, naive)
    torch.testing.assert_close(blocked.float(), prim_ref.gelu(x).float(),
                               **tolerance("elementwise", dname))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("block", [(64, 40), (5, 32), (256, 128)])
def test_gelu_row_tiles_take_vectors_bit_equal(card, dt, block):
    x = _normal(np.random.default_rng(5), (333, 200), card, _DT[dt], 2.0)
    out = gelu_mod.gelu_2d(x, block=block)
    torch.cuda.synchronize()
    assert torch.equal(out, gelu_mod.gelu_naive(x))


def test_gelu_vector_kernels_issue_16_byte_accesses(card):
    import re
    funcs = _sass_functions("gelu")
    for kernel in ("gelu_flat_kernel", "gelu_rows_kernel"):
        found = [f for f in funcs if kernel in f]
        assert found, sorted(funcs)
        for f in found:
            assert re.search(r"LDG\.E[.\w]*\.128", funcs[f]), f
            assert re.search(r"STG\.E[.\w]*\.128", funcs[f]), f
