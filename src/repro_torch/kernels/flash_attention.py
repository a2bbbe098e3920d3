"""Full-sequence GQA flash attention: the CUDA kernel's wrapper and its
plain PyTorch version, in the Pallas function's head layout.

``o = softmax(q k^T / sqrt(hd), masked) v`` for q (B, H, Sq, hd) and
k / v (B, KV, Sk, hd), query head h reading KV head h // (H / KV).  The
arithmetic is the Pallas ``_flash_kernel``'s (JAX package,
``kernels/flash_attention.py``): float32 throughout, the scale folded
into q before the product, the top-left causal mask (query i sees keys
0..i, both counted from 0, also when Sq != Sk), and the output rounded
once to q's dtype.  It is not ``ref.mha``'s, which rounds p to v's dtype
before the PV product.

:func:`flash_attention` launches ``csrc/flash_attention.cu``, which walks
K / V in slabs with the online softmax and takes any Sq, Sk >= 1 and hd
64 or 128 (the Pallas wrapper needs blocks of 128 that divide the
sequence): bf16 on the tensor cores (``wgmma``, K / V slabs by TMA, P
split into two bf16 parts for the P V product), float32 on the CUDA
cores.  :func:`plan` says which path a launch takes.  It reads every
tensor through its strides, so a transposed view of the model layout
(B, S, H, hd) needs no copy.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .inner_product import DTYPE_CODES

HEAD_DIMS = (64, 128)
NEG_INF = -1e30
# score elements per chunk of the plain version (bounds its memory)
PLAIN_CHUNK_ELEMS = 1 << 28


def describe_plan(code: int) -> str:
    """A plan code of the C ``flash_attention_plan`` in words: hd (64 or
    128) for the bf16 wgmma kernel, -1 for the float32 CUDA-core kernel;
    0 (no path) raises."""
    if code == -1:
        return "CUDA cores float32"
    if code in HEAD_DIMS:
        return f"wgmma bf16 hd{code}"
    raise ValueError(f"flash_attention has no path for plan code {code}")


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True
                              ) -> torch.Tensor:
    """Plain version in float32, over chunks of query rows (the whole
    softmax row at once, so sums run in another order than the kernel's
    online softmax)."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    kf = k.float()[:, :, None]                       # (B, KV, 1, Sk, hd)
    vf = v.float()[:, :, None]
    qf = q.float().reshape(b, kv, g, sq, hd) * scale
    out = torch.empty((b, kv, g, sq, hd), dtype=q.dtype, device=q.device)
    rows = max(1, PLAIN_CHUNK_ELEMS // max(1, b * h * sk))
    for r0 in range(0, sq, rows):
        s = qf[:, :, :, r0: r0 + rows] @ kf.transpose(-1, -2)
        if causal:
            q_pos = torch.arange(r0, min(r0 + rows, sq), device=q.device)
            k_pos = torch.arange(sk, device=q.device)
            s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        out[:, :, :, r0: r0 + rows] = ((p @ vf) / l.clamp_min(1e-30)).to(
            q.dtype)
    return out.reshape(b, h, sq, hd)


def _strides(t: torch.Tensor, vec: int):
    """(batch, head, sequence) strides of a 4-D tensor whose head dimension
    is contiguous and whose rows start on 16-byte boundaries, else None."""
    sb, sh, ss, sd = t.stride()
    if sd != 1 or t.data_ptr() % 16 or any(s % vec for s in (sb, sh, ss)):
        return None
    return sb, sh, ss


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Launch the CUDA flash-attention kernel on the current stream (no
    sync).  q (B, H, Sq, hd), k / v (B, KV, Sk, hd), CUDA tensors of one
    dtype (float32 or bf16), H a multiple of KV, hd 64 or 128; any
    strides with a contiguous head dimension (others are copied).
    Returns (B, H, Sq, hd) laid out as q is.  ``launches`` counts the
    kernel launches this wrapper made."""
    if not q.is_cuda:
        raise ValueError(
            "flash_attention launches a CUDA kernel and takes CUDA tensors "
            f"only (q is on {q.device}); kernels.ops dispatches CPU tensors "
            "to flash_attention_reference")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} not in {list(DTYPE_CODES)}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, H, Sq, hd), k = v (B, KV, Sk, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != hd or kv < 1 or h % kv
            or min(b, h, sq, sk) < 1):
        raise ValueError(f"incompatible q {tuple(q.shape)} and k / v "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    out = run_library(build.library("flash_attention", C_SIGNATURES), q,
                      k, v, causal=causal)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def run_library(lib, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool) -> torch.Tensor:
    """The launch of :func:`flash_attention` (after its checks) through a
    loaded build ``lib`` of ``csrc/flash_attention.cu``: tensors whose
    strides the kernel cannot read are copied first.  Not counted in
    ``flash_attention.launches``; a measurement build (``build.library``
    with defines) runs through here too."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    vec = 16 // q.element_size()
    args, strides = [], []
    for t in (q, k, v):
        st = _strides(t, vec)
        if st is None:
            t = t.contiguous()
            st = _strides(t, vec)
        args.append(t)
        strides += st
    out = torch.empty_like(args[0])
    strides += _strides(out, vec)
    err = lib.flash_attention_launch(
        *(t.data_ptr() for t in args), out.data_ptr(), b, h, kv, sq, sk, hd,
        (ctypes.c_longlong * 12)(*strides), 1.0 / math.sqrt(hd),
        int(bool(causal)), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out


def plan(q: torch.Tensor) -> str:
    """The path :func:`flash_attention` takes for a CUDA query of this
    dtype and head dim (the C launch function's own choice; nothing is
    launched), as :func:`describe_plan` words."""
    lib = build.library("flash_attention", C_SIGNATURES)
    return describe_plan(lib.flash_attention_plan(DTYPE_CODES[q.dtype],
                                                  q.shape[-1]))


# the C interface of csrc/flash_attention.cu, bound by kernels/build.py
C_SIGNATURES = {
    "flash_attention_launch": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
           ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
    "flash_attention_plan": ([ctypes.c_int] * 2, ctypes.c_int),
}
