"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, sequential): the JAX package's
``models/xlstm.py`` in PyTorch.

mLSTM uses exponential input gating with a running stabilizer ``m``; the
chunkwise form is the linear-attention chunking: intra-chunk scores with
log-decay weights plus the inter-chunk recurrent state (C, n, m), carried
from chunk to chunk.  sLSTM is a loop over positions.  States are float32
and the gates use ``torch.cummax`` and ``F.logsigmoid``, as the reference
has them.  ``mlstm_cell_naive`` is the step-by-step version the tests
use.  The cells are plain PyTorch, as the reference's are jnp outside
any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.roofline.op_cost import named_scope
from .common import ModelConfig
from .layers import causal_conv1d, group_norm_heads
from .params import ParamDef

# how often one decode step (T = 1) reads each incoming state leaf: C
# twice (the queries' read-out and the decayed carry), n twice (the
# denominator and the decayed carry), m three times (the stabilizer, the
# inter-chunk scale and the carry's decay), the conv tail once
MLSTM_DECODE_STATE_READS = {"C": 2, "n": 2, "m": 3, "conv": 1}
# sLSTM: h feeds the four gates' recurrent products, m the stabilizer and
# the forget gate, c and n their updates once each
SLSTM_DECODE_STATE_READS = {"c": 1, "n": 1, "h": 4, "m": 2}


# ==========================================================================
# mLSTM
# ==========================================================================

def mlstm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, H = cfg.d_model, cfg.n_heads
    di = 2 * D
    W = cfg.mamba_conv_width
    dt = cfg.dtype
    return {
        "w_up": ParamDef((D, di), dt, logical=("d_model", "d_ff")),
        "w_z": ParamDef((D, di), dt, logical=("d_model", "d_ff")),
        "conv_w": ParamDef((di, W), "float32", init="normal",
                           logical=("d_ff", "none")),
        "wq": ParamDef((di, di), dt, logical=("d_ff", "none")),
        "wk": ParamDef((di, di), dt, logical=("d_ff", "none")),
        "wv": ParamDef((di, di), dt, logical=("d_ff", "none")),
        "wi": ParamDef((di, H), "float32", init="normal",
                       logical=("d_ff", "heads")),
        "bi": ParamDef((H,), "float32", init="zeros", logical=("heads",)),
        "wf": ParamDef((di, H), "float32", init="normal",
                       logical=("d_ff", "heads")),
        "bf": ParamDef((H,), "float32", init="ones", scale=3.0,
                       logical=("heads",)),
        "skip": ParamDef((di,), "float32", init="ones", logical=("d_ff",)),
        "w_down": ParamDef((di, D), dt, fan_in_axes=(0,),
                           logical=("d_ff", "d_model")),
    }


def mlstm_state_defs(cfg: ModelConfig, batch: int) -> Dict[str, ParamDef]:
    """Per-slot rows: float32 C (batch, H, hd, hd) stored (v, k), n
    (batch, H, hd), m (batch, H), and the conv tail (batch, W-1, 2 D) in
    the model dtype, all zeros."""
    H = cfg.n_heads
    di = 2 * cfg.d_model
    hd = di // H
    W = cfg.mamba_conv_width
    return {
        "C": ParamDef((batch, H, hd, hd), "float32", init="zeros",
                      logical=("batch", "heads", "head_dim", "none")),
        "n": ParamDef((batch, H, hd), "float32", init="zeros",
                      logical=("batch", "heads", "head_dim")),
        "m": ParamDef((batch, H), "float32", init="zeros",
                      logical=("batch", "heads")),
        "conv": ParamDef((batch, W - 1, di), cfg.dtype, init="zeros",
                         logical=("batch", "none", "d_ff")),
    }


def _mlstm_chunk(q, k, v, li, lf, C_in, n_in, m_in):
    """One chunk of the stabilized chunkwise mLSTM.

    q, k, v (B, H, T, hd), k pre-scaled by 1/sqrt(hd); li, lf (B, H, T)
    log input / log forget gates; state C (B, H, hd, hd), n (B, H, hd),
    m (B, H).  Returns h (B, H, T, hd) and the new (C, n, m)."""
    with named_scope("mlstm_chunk"):
        return _mlstm_chunk_impl(q, k, v, li, lf, C_in, n_in, m_in)


def _mlstm_chunk_impl(q, k, v, li, lf, C_in, n_in, m_in):
    T = q.shape[2]
    Fc = torch.cumsum(lf, dim=-1)                           # (B, H, T)
    u = torch.cummax(li - Fc, dim=2).values                 # (B, H, T)
    m_t = Fc + torch.maximum(u, m_in[..., None])            # (B, H, T)
    # intra-chunk decay  log w[t, s] = F_t - F_s + li_s - m_t  (s <= t)
    logw = (Fc[..., :, None] - Fc[..., None, :] + li[..., None, :]
            - m_t[..., :, None])
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    w = torch.where(causal, torch.exp(logw), 0.0)           # (B, H, T, T)
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) * w
    inter_scale = torch.exp(Fc + m_in[..., None] - m_t)     # (B, H, T)
    # C is stored (v_dim, k_dim): queries contract the k index
    num = (torch.einsum("bhts,bhsd->bhtd", scores, v)
           + inter_scale[..., None] * torch.einsum("bhte,bhde->bhtd", q,
                                                   C_in))
    den = (scores.sum(dim=-1)
           + inter_scale * torch.einsum("bhtd,bhd->bht", q, n_in))
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]

    m_out = m_t[..., -1]                                    # (B, H)
    decay_out = torch.exp(Fc[..., -1:] - Fc + li - m_out[..., None])
    # the carry's decay, one expression the reference writes twice
    carry = torch.exp(Fc[..., -1] + m_in - m_out)           # (B, H)
    C_out = (carry[..., None, None] * C_in
             + torch.einsum("bhtd,bhte->bhde", decay_out[..., None] * v, k))
    n_out = (carry[..., None] * n_in
             + torch.einsum("bht,bhtd->bhd", decay_out, k))
    return h, (C_out, n_out, m_out)


def mlstm_mixer(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None,
                return_state: bool = False):
    """mLSTM block mixer.  x (B, L, D); ``state`` {"C", "n", "m", "conv"}
    rows of the batch (zeros when None)."""
    B, L, D = x.shape
    H = cfg.n_heads
    di = 2 * D
    hd = di // H
    xr = x @ p["w_up"]
    z = x @ p["w_z"]
    conv_tail = state["conv"] if state else None
    xc, new_tail = causal_conv1d(xr, p["conv_w"].to(xr.dtype), conv_tail)
    xc = F.silu(xc)

    def heads(t, w):
        return (t @ w).reshape(B, L, H, hd).transpose(1, 2)

    q = heads(xc, p["wq"]).float()
    k = heads(xc, p["wk"]).float() / (hd ** 0.5)
    v = heads(xr, p["wv"]).float()
    xf = xr.float()
    li = (xf @ p["wi"] + p["bi"]).transpose(1, 2)           # (B, H, L)
    lf = F.logsigmoid(xf @ p["wf"] + p["bf"]).transpose(1, 2)

    if state:
        C0, n0, m0 = state["C"], state["n"], state["m"]
    else:
        C0 = x.new_zeros((B, H, hd, hd), dtype=torch.float32)
        n0 = x.new_zeros((B, H, hd), dtype=torch.float32)
        m0 = x.new_zeros((B, H), dtype=torch.float32)

    ch = cfg.scan_chunk
    if L % ch == 0 and L > ch:
        carry, hs = (C0, n0, m0), []
        for c0 in range(0, L, ch):
            s = slice(c0, c0 + ch)
            h_c, carry = _mlstm_chunk(q[:, :, s], k[:, :, s], v[:, :, s],
                                      li[..., s], lf[..., s], *carry)
            hs.append(h_c)
        h, (Cf, nf, mf) = torch.cat(hs, dim=2), carry
    else:
        h, (Cf, nf, mf) = _mlstm_chunk(q, k, v, li, lf, C0, n0, m0)

    h = group_norm_heads(h.transpose(1, 2)).reshape(B, L, di)
    h = (h + p["skip"] * xc.float()).to(x.dtype)
    h = h * F.silu(z)
    out = h @ p["w_down"]
    if return_state:
        return out, {"C": Cf, "n": nf, "m": mf, "conv": new_tail}
    return out


def mlstm_cell_naive(q, k, v, li, lf, C0, n0, m0) -> torch.Tensor:
    """Sequential version over (B, H, T, hd) inputs (k pre-scaled)."""
    C, n, m = C0, n0, m0
    hs = []
    for t in range(q.shape[2]):
        qt, kt, vt = q[:, :, t], k[:, :, t], v[:, :, t]
        lit, lft = li[..., t], lf[..., t]
        m_new = torch.maximum(lft + m, lit)
        i_p = torch.exp(lit - m_new)
        f_p = torch.exp(lft + m - m_new)
        C = f_p[..., None, None] * C + i_p[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])           # (v_dim, k_dim)
        n = f_p[..., None] * n + i_p[..., None] * kt
        num = torch.einsum("bhde,bhe->bhd", C, qt)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", qt, n).abs(),
                            torch.exp(-m_new))
        m = m_new
        hs.append(num / den[..., None])
    return torch.stack(hs, dim=2)


# ==========================================================================
# sLSTM
# ==========================================================================

def slstm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, H = cfg.d_model, cfg.n_heads
    hd = D // H
    dt = cfg.dtype
    defs = {}
    for g in ("z", "i", "f", "o"):
        defs[f"w_{g}"] = ParamDef((D, H, hd), dt,
                                  logical=("d_model", "heads", "head_dim"))
        defs[f"r_{g}"] = ParamDef((H, hd, hd), "float32", init="normal",
                                  logical=("heads", "head_dim", "none"))
        defs[f"b_{g}"] = ParamDef((H, hd), "float32",
                                  init="ones" if g == "f" else "zeros",
                                  logical=("heads", "head_dim"))
    defs["out_proj"] = ParamDef((D, D), dt, logical=("d_model", "none"))
    return defs


def slstm_state_defs(cfg: ModelConfig, batch: int) -> Dict[str, ParamDef]:
    """Per-slot rows: float32 c, n, h, m, each (batch, H, hd), zeros."""
    H = cfg.n_heads
    hd = cfg.d_model // H
    return {name: ParamDef((batch, H, hd), "float32", init="zeros",
                           logical=("batch", "heads", "head_dim"))
            for name in ("c", "n", "h", "m")}


def _slstm_scan(p, xg: Dict[str, torch.Tensor], state):
    """xg[g]: (B, L, H, hd) input projections.  A loop over L; returns
    hs (B, L, H, hd) float32 and the final (c, n, h, m)."""
    c, n, h, m = state
    xs = {g: t.float() for g, t in xg.items()}

    def rec(g, hh):
        return torch.einsum("bhd,hde->bhe", hh, p[f"r_{g}"]) + p[f"b_{g}"]

    hs = []
    for t in range(xs["z"].shape[1]):
        zt = torch.tanh(xs["z"][:, t] + rec("z", h))
        it = xs["i"][:, t] + rec("i", h)
        ft = xs["f"][:, t] + rec("f", h)
        ot = torch.sigmoid(xs["o"][:, t] + rec("o", h))
        lf = F.logsigmoid(ft)
        m_new = torch.maximum(lf + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(lf + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = ot * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)


def slstm_mixer(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None,
                return_state: bool = False):
    """sLSTM block mixer.  x (B, L, D); ``state`` {"c", "n", "h", "m"}
    rows of the batch (zeros when None)."""
    B, L, D = x.shape
    H = cfg.n_heads
    hd = D // H
    if state is None:
        zero = x.new_zeros((B, H, hd), dtype=torch.float32)
        st = (zero, zero, zero, zero)
    else:
        st = (state["c"], state["n"], state["h"], state["m"])
    xg = {g: torch.einsum("bld,dhe->blhe", x, p[f"w_{g}"]) for g in "zifo"}
    hs, (c, n, h, m) = _slstm_scan(p, xg, st)
    y = group_norm_heads(hs).reshape(B, L, D).to(x.dtype)
    out = y @ p["out_proj"]
    if return_state:
        return out, {"c": c, "n": n, "h": h, "m": m}
    return out
