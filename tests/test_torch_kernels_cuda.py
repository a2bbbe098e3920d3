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
