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
