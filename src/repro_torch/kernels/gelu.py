"""tanh-GELU over a 2-D array, blocked vs naive walk: the CUDA kernel's
wrapper, its plain PyTorch version, and the paper's C = 3 padding study.

The paper's GELU study (section 3.4): an elementwise op's intensity does
not depend on the layout unless the layout forces padding (C = 3 padded to
a blocked 8 doubles the FLOPs and multiplies the traffic) or wastes memory
transactions.  :func:`gelu_2d` launches ``csrc/gelu.cu`` (the port of the
Pallas ``gelu_2d``) with a tile shape that picks the walk:

* :func:`gelu_blocked`: tiles of whole rows, so the whole array is one
  contiguous run, walked in one pass of 16-byte accesses (coalesced);
* :func:`gelu_naive`: strips of 1024 rows x 8 columns, walked down the
  rows, so each warp's load touches 32 sectors for 32 elements (strided)
  — the Hopper form of the Pallas (128k, 8) tiles that fill 8 of 128
  lanes.

Both do the same arithmetic per element, so they agree bit for bit.
:func:`pad_channels` reproduces the paper's C = 3 -> 8 experiment.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from . import build
from . import ref as _ref
from .inner_product import DTYPE_CODES

BLOCKED_TILE_ELEMS = 4096          # elements of one blocked tile
NAIVE_TILE = (1024, 8)             # rows x columns of one naive strip


def blocked_tile(rows: int, cols: int) -> Tuple[int, int]:
    """Whole rows, about BLOCKED_TILE_ELEMS elements: one contiguous run."""
    return min(rows, max(1, BLOCKED_TILE_ELEMS // cols)), cols


def naive_tile(rows: int, cols: int) -> Tuple[int, int]:
    """A strip of up to 1024 rows x 8 columns, walked down its rows."""
    return min(rows, NAIVE_TILE[0]), min(cols, NAIVE_TILE[1])


def gelu_2d_reference(x: torch.Tensor, *, block: Tuple[int, int] = (256, 128)
                      ) -> torch.Tensor:
    """Plain version (the tile shape does not change the values)."""
    return _ref.gelu(x)


def gelu_2d(x: torch.Tensor, *, block: Tuple[int, int] = (256, 128)
            ) -> torch.Tensor:
    """Launch the CUDA GELU kernel over x (R, C) with tiles ``block`` =
    (rows, cols) on the current stream (no sync).  A tile of whole rows is
    walked as one contiguous run, a tile at least a warp wide row by row,
    a narrower strip down its rows; the first two with 16-byte accesses
    where the addresses allow (the output lies as far past a 16-byte
    boundary as x, so a misaligned x costs only a scalar head).  Takes a
    contiguous 2-D float32 or bf16 CUDA tensor; the tiles need not divide
    the shape.  ``launches`` counts the kernel launches this wrapper
    made."""
    if not x.is_cuda:
        raise ValueError(
            "gelu_2d launches a CUDA kernel and takes CUDA tensors only "
            f"(x is on {x.device}); kernels.ops dispatches CPU tensors to "
            "gelu_2d_reference")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not in {list(DTYPE_CODES)}")
    if x.dim() != 2 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"x must be a non-empty contiguous 2-D tensor, got "
                         f"{tuple(x.shape)}")
    br, bc = (int(b) for b in block)
    if br < 1 or bc < 1:
        raise ValueError(f"bad tile {block}")
    out = _same_phase(x)
    lib = build.library("gelu", C_SIGNATURES)
    err = lib.gelu_2d_launch(
        x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], br, bc,
        DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gelu_2d kernel launch failed: CUDA error {err}")
    gelu_2d.launches += 1
    return out


gelu_2d.launches = 0


def _same_phase(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor like x whose address lies as far past a
    16-byte boundary as x's, so the kernel's 16-byte vector walk covers
    both with one scalar head (a view into a slightly larger buffer when
    x itself is not 16-byte aligned)."""
    off = x.data_ptr() % 16 // x.element_size()
    if off == 0:
        return torch.empty_like(x)
    buf = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    return buf[off:].view(x.shape)

# the C interface of csrc/gelu.cu, bound by kernels/build.py
C_SIGNATURES = {
    "gelu_2d_launch": (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_void_p], ctypes.c_int),
}


def gelu_layout(x: torch.Tensor, tile: Callable[[int, int], Tuple[int, int]],
                impl: Callable = gelu_2d) -> torch.Tensor:
    """GELU of any-rank x through ``impl`` (a :func:`gelu_2d`-like
    function) over its (rows, C) view (a 1-D x is one row), with tiles
    ``tile(rows, C)``."""
    x = x.contiguous()
    flat = x.reshape(-1, x.shape[-1]) if x.dim() > 1 else x.reshape(1, -1)
    return impl(flat, block=tile(*flat.shape)).reshape(x.shape)


def gelu_blocked(x: torch.Tensor) -> torch.Tensor:
    """Coalesced walk (the NCHW16C analogue): the CUDA kernel."""
    return gelu_layout(x, blocked_tile)


def gelu_naive(x: torch.Tensor) -> torch.Tensor:
    """Strided walk over 8-column strips: the CUDA kernel."""
    return gelu_layout(x, naive_tile)


def pad_channels(x: torch.Tensor, to: int = 128) -> torch.Tensor:
    """The paper's forced-blocked-layout experiment: zero-pad the last
    dimension up to a multiple of ``to``."""
    pad = (-x.shape[-1]) % to
    return x if pad == 0 else F.pad(x, (0, pad))
