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
    assert pa.mla_paged_attention.launches == n + 1
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
    with pytest.raises(NotImplementedError, match="item 5"):
        pa.paged_attention_verify(q, k, v, bt, pos, scale=0.25,
                                  k_scale=torch.ones(1, device=card))


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
    assert pa.mla_paged_attention_verify.launches == n + 1
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
    torch.testing.assert_close(ver.float(), dec.float(),
                               **TOL_F32_PLAIN[dtype])


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
    with pytest.raises(NotImplementedError, match="item 5"):
        pa.mla_paged_attention_verify(ql, qr, c, r, bt, pos, scale=0.1,
                                      c_scale=torch.ones(1, device=card),
                                      r_scale=torch.ones(1, device=card))


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
