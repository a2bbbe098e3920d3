"""Analytic work W (FLOPs) and traffic Q (bytes) of the paper's primitives.

The JAX package reads W and Q off the compiled HLO module
(``core/analysis.py::kernel_character``, its cost walk); the port has no
HLO, so it counts them from the shapes in the same conventions:

* a product of (M, K) and (K, N) is 2 M K N FLOPs;
* an elementwise arithmetic op, an elementwise ``maximum`` included, is
  one FLOP per element; a transcendental (tanh) is one FLOP and one
  transcendental per element; padding and other data movement is 0 FLOPs
  (the paper's section 3.5 caveat);
* tanh-GELU ``0.5 x (1 + tanh(c (x + 0.044715 x^3)))`` is 9 FLOPs per
  element, one of them the tanh;
* Q is the least traffic of one call: each input read once and each
  output written once, in its own dtype.  A fused epilogue adds no
  traffic (``Q_unfused`` adds the activation's extra write and read, the
  paper's fusion-traffic point); a pad reads its input and its scalar
  padding value and writes the padded array.

``Q_bytes`` is what a kernel's bound divides by the card's bandwidth.
Each function returns the keys of ``kernel_character``: ``W_flops``,
``Q_bytes``, ``transcendentals``, ``AI`` (W / Q).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

GELU_FLOPS = 9                      # per element, the tanh included
EPILOGUE_FLOPS = {"none": 0, "relu": 1, "gelu": GELU_FLOPS}


def itemsize(dtype: str) -> int:
    """Bytes per element of the torch dtype named ``dtype``."""
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def character(w: float, q: float, transcendentals: float = 0.0,
              **extra: float) -> Dict[str, float]:
    out = {"W_flops": float(w), "Q_bytes": float(q),
           "transcendentals": float(transcendentals),
           "AI": w / q if q else 0.0}
    out.update({k: float(v) for k, v in extra.items()})
    return out


def inner_product_character(m: int, k: int, n: int, dtype: str = "float32",
                            fuse: str = "none") -> Dict[str, float]:
    """(M, K) @ (K, N) with an optional fused epilogue."""
    isz = itemsize(dtype)
    q = (m * k + k * n + m * n) * isz
    return character(2 * m * k * n + EPILOGUE_FLOPS[fuse] * m * n, q,
                     m * n if fuse == "gelu" else 0,
                     Q_unfused=q + (2 * m * n * isz if fuse != "none" else 0))


def gelu_character(shape: Sequence[int], dtype: str = "float32",
                   pad_to: Optional[int] = None) -> Dict[str, float]:
    """tanh-GELU over ``shape``; with ``pad_to``, GELU of
    ``pad_channels(x, pad_to)``, the pad's traffic included."""
    isz = itemsize(dtype)
    elems = math.prod(shape)
    c = shape[-1]
    padded = c if pad_to is None else -(-c // pad_to) * pad_to
    pelems = elems // c * padded
    pad_q = (elems + 1 + pelems) * isz if padded != c else 0
    return character(GELU_FLOPS * pelems, pad_q + 2 * pelems * isz, pelems)


def conv2d_character(n: int, h: int, w: int, cin: int, cout: int,
                     kh: int = 3, kw: int = 3, dtype: str = "float32"
                     ) -> Dict[str, float]:
    """Direct convolution, stride 1, SAME: x, w read and out written
    once."""
    isz = itemsize(dtype)
    return character(2 * n * h * w * cin * cout * kh * kw,
                     (n * h * w * cin + kh * kw * cin * cout
                      + n * h * w * cout) * isz)


def winograd_tile_count(n: int, h: int, w: int) -> int:
    """T: the number of 4x4 input tiles of F(2x2, 3x3) (N ceil(H/2)
    ceil(W/2))."""
    return n * -(-h // 2) * -(-w // 2)


def winograd_stage_character(t: int, cin: int, cout: int,
                             positions: int = 16) -> Dict[str, float]:
    """The elementwise stage: ``positions`` float32 (T, Cin) @ (Cin,
    Cout) products; v, u and m read or written once in float32."""
    return character(2 * positions * t * cin * cout,
                     positions * (t * cin + cin * cout + t * cout) * 4)


def winograd_conv_character(n: int, h: int, w: int, cin: int, cout: int,
                            dtype: str = "float32") -> Dict[str, float]:
    """The whole F(2x2, 3x3) convolution: the stage's products plus the
    transforms, each a product with a constant matrix (input: two 4x4
    passes over T 4x4 Cin values; kernel: G g G^T; output: two passes of
    A^T over T 4x4 Cout values); the tile gather's index arithmetic is
    not counted.  Q is the convolution's own: x and w read, out written
    once (intermediates need not reach device memory)."""
    t = winograd_tile_count(n, h, w)
    work = (2 * 16 * t * cin * cout          # elementwise stage
            + 2 * 2 * 4 * 16 * t * cin       # V = B^T d B
            + 2 * 3 * (12 + 16) * cin * cout  # U = G g G^T
            + 2 * 4 * (8 + 4) * t * cout)    # Y = A^T M A
    return character(work, conv2d_character(n, h, w, cin, cout, 3, 3,
                                            dtype)["Q_bytes"])
