"""Plain PyTorch versions of the paper's primitives (the JAX package's
``kernels/ref.py``, op for op): tanh-GELU, inner product, direct
convolution and Winograd F(2x2, 3x3).

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
