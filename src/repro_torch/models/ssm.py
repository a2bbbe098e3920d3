"""Mamba-1 selective-SSM mixer (arXiv:2312.00752), chunked: the JAX
package's ``models/ssm.py`` in PyTorch.

The sequence is cut into ``cfg.scan_chunk`` chunks walked in order,
carrying the (B, d_inner, N) state; inside a chunk the recurrence
h_t = dA_t h_{t-1} + dBx_t runs as a parallel scan.  The scan is the
odd / even recursion ``jax.lax.associative_scan`` runs (:func:`_scan`),
so its products and sums fall in the reference's order, in about 6 log2
(chunk) ops a chunk where a step loop would take one launch a position.
Decode is the same mixer at L = 1.  The scans are plain PyTorch, as the
reference's are jnp outside any Pallas kernel.

``mamba_mixer_naive`` is the step-by-step version the tests use.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.roofline.op_cost import named_scope
from .common import ModelConfig
from .layers import causal_conv1d
from .params import ParamDef

# how often one decode step (L = 1) reads each incoming state leaf: the
# conv tail once (the concatenation), h once (the response to h_in)
DECODE_STATE_READS = {"h": 1, "conv": 1}


def mamba_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, di, N, R, W = (cfg.d_model, cfg.d_inner, cfg.mamba_d_state,
                      cfg.dt_rank, cfg.mamba_conv_width)
    dt = cfg.dtype
    return {
        "in_proj": ParamDef((D, 2 * di), dt, logical=("d_model", "d_ff")),
        "conv_w": ParamDef((di, W), "float32", init="normal", scale=10.0,
                           logical=("d_ff", "none")),
        "x_proj": ParamDef((di, R + 2 * N), dt, logical=("d_ff", "none")),
        "dt_proj": ParamDef((R, di), "float32", logical=("none", "d_ff")),
        "dt_bias": ParamDef((di,), "float32", init="zeros",
                            logical=("d_ff",)),
        "A_log": ParamDef((di, N), "float32", init="ones",
                          logical=("d_ff", "state")),
        "D_skip": ParamDef((di,), "float32", init="ones", logical=("d_ff",)),
        "out_proj": ParamDef((di, D), dt, fan_in_axes=(0,),
                             logical=("d_ff", "d_model")),
    }


def state_defs(cfg: ModelConfig, batch: int) -> Dict[str, ParamDef]:
    """Per-slot state rows: float32 h (batch, d_inner, N) and the conv
    tail (batch, W-1, d_inner) in the model dtype, both zeros."""
    di, N, W = cfg.d_inner, cfg.mamba_d_state, cfg.mamba_conv_width
    return {
        "h": ParamDef((batch, di, N), "float32", init="zeros",
                      logical=("batch", "d_ff", "state")),
        "conv": ParamDef((batch, W - 1, di), cfg.dtype, init="zeros",
                         logical=("batch", "none", "d_ff")),
    }


def _ssm_inputs(p, x: torch.Tensor, cfg: ModelConfig,
                conv_tail: Optional[torch.Tensor]):
    """Shared front: projections, conv, discretization inputs."""
    N, R = cfg.mamba_d_state, cfg.dt_rank
    xz = x @ p["in_proj"]
    xr, z = xz.chunk(2, dim=-1)                        # (B, L, di) each
    xr, new_tail = causal_conv1d(xr, p["conv_w"].to(xr.dtype), conv_tail)
    xr = F.silu(xr)
    proj = xr @ p["x_proj"]
    dt_raw, Bm, Cm = proj.split([R, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() @ p["dt_proj"] + p["dt_bias"])  # (B,L,di)
    A = -torch.exp(p["A_log"])                         # (di, N) float32
    dA = torch.exp(dt[..., None] * A)                  # (B, L, di, N)
    dBx = (dt * xr.float())[..., None] * Bm.float()[:, :, None, :]
    return xr, z, dA, dBx, Cm.float(), new_tail


def _combine(a1, b1, a2, b2):
    """The scan's operator: (a1, b1) then (a2, b2)."""
    return a2 * a1, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along axis 1."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return pairs if even.shape[1] == n else torch.cat([pairs, even[:, n:]],
                                                      dim=1)


def _scan(a: torch.Tensor, b: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of :func:`_combine` along axis 1, by the recursion
    of ``jax.lax.associative_scan``: combine adjacent pairs, scan the
    half-length result (the odd outputs), then combine each odd output
    with the next even input (the even outputs)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2],
                      b[:, 1::2])
    oa, ob = _scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _chunk_scan(dA_c: torch.Tensor, dBx_c: torch.Tensor,
                h_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk: the parallel scan plus the incoming state's response.
    dA_c, dBx_c (B, ch, di, N); h_in (B, di, N).  Returns h_all (B, ch,
    di, N) and h_out (a view of its last position)."""
    with named_scope("mamba_scan"):
        a_cum, b_cum = _scan(dA_c, dBx_c)
        h_all = b_cum + a_cum * h_in[:, None]
    return h_all, h_all[:, -1]


def _readout(p, y: torch.Tensor, xr: torch.Tensor, z: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    y = y + p["D_skip"] * xr.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ p["out_proj"]


def mamba_mixer(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None,
                return_state: bool = False):
    """Full-sequence mamba.  x (B, L, D); ``state`` {"h", "conv"} rows of
    the batch (zeros when None).  With ``return_state`` returns (out, new
    state), the new state's leaves views of fresh activations."""
    B, L, _ = x.shape
    di, N = cfg.d_inner, cfg.mamba_d_state
    conv_tail = state["conv"] if state else None
    h0 = state["h"] if state else x.new_zeros((B, di, N),
                                              dtype=torch.float32)
    xr, z, dA, dBx, Cm, new_tail = _ssm_inputs(p, x, cfg, conv_tail)

    ch = cfg.scan_chunk
    if L % ch == 0 and L > ch:
        h, ys = h0, []
        for c0 in range(0, L, ch):
            h_all, h = _chunk_scan(dA[:, c0:c0 + ch], dBx[:, c0:c0 + ch], h)
            ys.append(torch.einsum("bldn,bln->bld", h_all,
                                   Cm[:, c0:c0 + ch]))
        y, h_last = torch.cat(ys, dim=1), h
    else:
        h_all, h_last = _chunk_scan(dA, dBx, h0)
        y = torch.einsum("bldn,bln->bld", h_all, Cm)
    out = _readout(p, y, xr, z, x)
    if return_state:
        return out, {"h": h_last, "conv": new_tail}
    return out


def mamba_decode(p, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ModelConfig):
    """Single-token step.  x (B, 1, D).  Returns (out, new state)."""
    return mamba_mixer(p, x, cfg, state=state, return_state=True)


# --------------------------------------------------------------------------
# Step-by-step version (tests)
# --------------------------------------------------------------------------

def mamba_mixer_naive(p, x: torch.Tensor, cfg: ModelConfig,
                      state: Optional[Dict[str, torch.Tensor]] = None):
    B, L, _ = x.shape
    di, N = cfg.d_inner, cfg.mamba_d_state
    conv_tail = state["conv"] if state else None
    h = state["h"] if state else x.new_zeros((B, di, N), dtype=torch.float32)
    xr, z, dA, dBx, Cm, _ = _ssm_inputs(p, x, cfg, conv_tail)
    ys = []
    for t in range(L):
        h = dA[:, t] * h + dBx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return _readout(p, torch.stack(ys, dim=1), xr, z, x)
