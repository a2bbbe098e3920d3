"""Plain PyTorch versions of the paper's primitives (the JAX package's
``kernels/ref.py``, op for op): tanh-GELU, inner product, direct
convolution, Winograd F(2x2, 3x3), LayerNorm, average and max pooling,
and GQA attention (``mha``).

Sums are float32 and the result is cast to the input dtype at the end,
as the jnp code does.  On the card, float32 matmuls and convolutions are
float32 only with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False); the entry points that time
these set both.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

GELU_C = math.sqrt(2.0 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approx GELU (the oneDNN flavor), in float32."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(GELU_C * (xf + 0.044715 * xf ** 3)))
    return y.to(x.dtype)


def inner_product(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, K) @ (K, N) + b — oneDNN's fully-connected primitive."""
    y = x.float() @ w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def same_padding(k: int) -> Tuple[int, int]:
    """XLA's SAME split of a stride-1 window of size k: (before, after)."""
    return (k - 1) // 2, k - 1 - (k - 1) // 2


def conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC direct convolution, stride 1, SAME.  w: (KH, KW, Cin, Cout)."""
    kh, kw = w.shape[0], w.shape[1]
    (ht, hb), (wl, wr) = same_padding(kh), same_padding(kw)
    xp = F.pad(x.float().permute(0, 3, 1, 2), (wl, wr, ht, hb))
    y = F.conv2d(xp, w.float().permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


# --------------------------------------------------------------------------
# Winograd F(2x2, 3x3)
# --------------------------------------------------------------------------

_B_T = ((1, 0, -1, 0),
        (0, 1, 1, 0),
        (0, -1, 1, 0),
        (0, 1, 0, -1))
_G = ((1, 0, 0),
      (0.5, 0.5, 0.5),
      (0.5, -0.5, 0.5),
      (0, 0, 1))
_A_T = ((1, 1, 1, 0),
        (0, 1, -1, -1))


def winograd_matrices(device) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(B^T, G, A^T) as float32 tensors on ``device``."""
    return tuple(torch.tensor(m, dtype=torch.float32, device=device)
                 for m in (_B_T, _G, _A_T))


def winograd_kernel_transform(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> (4, 4, Cin, Cout):  U = G g G^T."""
    _, g_mat, _ = winograd_matrices(w.device)
    u = torch.einsum("ij,jkcf->ikcf", g_mat, w.float())
    return torch.einsum("ikcf,lk->ilcf", u, g_mat)


def winograd_tiles(x: torch.Tensor
                   ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """Overlapping 4x4 tiles (stride 2) of the SAME-padded NHWC input:
    (N, nH, nW, 4, 4, C)."""
    n, h, wd, c = x.shape
    nh, nw = -(-h // 2), -(-wd // 2)
    xp = F.pad(x, (0, 0, 1, 2 * nw - wd + 1, 1, 2 * nh - h + 1))
    idx_h = (2 * torch.arange(nh, device=x.device))[:, None] + torch.arange(
        4, device=x.device)[None, :]
    idx_w = (2 * torch.arange(nw, device=x.device))[:, None] + torch.arange(
        4, device=x.device)[None, :]
    t = xp[:, idx_h][:, :, :, idx_w]                # (N, nH, 4, nW, 4, C)
    return t.permute(0, 1, 3, 2, 4, 5), (nh, nw, c)


def winograd_input_transform(x: torch.Tensor) -> Tuple[torch.Tensor, int,
                                                       int]:
    """V = B^T d B over every tile, as (16, T, Cin) float32 with
    T = N nH nW, and (nH, nW)."""
    b_t, _, _ = winograd_matrices(x.device)
    tiles, (nh, nw, cin) = winograd_tiles(x)
    v = torch.einsum("ij,nhwjkc->nhwikc", b_t, tiles.float())
    v = torch.einsum("nhwikc,lk->nhwilc", v, b_t)
    return v.reshape(-1, 16, cin).transpose(0, 1).contiguous(), nh, nw


def winograd_output_transform(m: torch.Tensor, n: int, nh: int, nw: int,
                              h: int, wd: int) -> torch.Tensor:
    """Y = A^T M A: (16, T, Cout) -> (N, H, W, Cout) float32."""
    _, _, a_t = winograd_matrices(m.device)
    cout = m.shape[-1]
    m = m.transpose(0, 1).reshape(n, nh, nw, 4, 4, cout)
    y = torch.einsum("pi,nhwijf->nhwpjf", a_t, m)
    y = torch.einsum("nhwpjf,qj->nhwpqf", y, a_t)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * nh, 2 * nw, cout)
    return y[:, :h, :wd, :]


def winograd_stage(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The elementwise stage: (16, T, Cin) @ (16, Cin, Cout) in float32."""
    return torch.einsum("ptc,pcf->ptf", v.float(), u.float())


def conv2d_winograd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """F(2x2, 3x3) Winograd conv, stride 1, SAME padding: 16 instead of 36
    multiplies per 2x2 output patch and input channel (2.25x less work)."""
    n, h, wd, cin = x.shape
    v, nh, nw = winograd_input_transform(x)
    u = winograd_kernel_transform(w).reshape(16, cin, -1)
    m = winograd_stage(v, u)
    return winograd_output_transform(m, n, nh, nw, h, wd).to(x.dtype)


# --------------------------------------------------------------------------
# LayerNorm, pooling and attention
# --------------------------------------------------------------------------

def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Row LayerNorm over the last axis in float32, two passes: the mean,
    then the mean of the squared deviations (not E[x^2] - mu^2)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    return y.to(x.dtype)


def _windows(x: torch.Tensor, window: int, stride: int):
    """The (i, j) offsets of a VALID window walk over NHWC ``x``, each with
    the strided view of x that offset reads for every output pixel."""
    n, h, w, c = x.shape
    ho, wo = (h - window) // stride + 1, (w - window) // stride + 1
    for i in range(window):
        for j in range(window):
            yield x[:, i: i + stride * (ho - 1) + 1: stride,
                    j: j + stride * (wo - 1) + 1: stride, :]


def avg_pool(x: torch.Tensor, window: int = 2, stride: int = 2
             ) -> torch.Tensor:
    """NHWC average pooling (no padding): the float32 window sum, taken
    row by row from 0, divided by window^2."""
    acc = None
    for part in _windows(x, window, stride):
        acc = part.float() if acc is None else acc + part.float()
    return (acc / (window * window)).to(x.dtype)


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2
             ) -> torch.Tensor:
    """NHWC max pooling from -inf (float32) or the dtype's lowest value:
    zero FLOPs under the paper's section 3.5 accounting."""
    init = (-math.inf if x.dtype == torch.float32
            else torch.finfo(x.dtype).min)
    acc = None
    for part in _windows(x, window, stride):
        acc = torch.maximum(torch.full_like(part, init) if acc is None
                            else acc, part)
    return acc


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, hd), k / v (B, Sk, KV, hd); GQA by head grouping.
    Scores in float32 from products in the input dtype, the top-left
    causal mask (query i sees keys 0..i), softmax, and p cast to v's dtype
    before the PV product."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() / math.sqrt(hd)
    if causal:
        sk = k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return o.reshape(b, sq, h, hd)
