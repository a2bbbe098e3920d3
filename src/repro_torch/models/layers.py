"""Shared layers: norms, activations, MLPs, embeddings, RoPE, and the
short causal depthwise conv of the recurrent mixers.

Each layer is a (param defs, apply) pair over plain tensors and parameter
dicts, mirroring the JAX package's ``models/layers.py`` op for op: norms
compute in float32 and cast back, RoPE is half-split (NeoX) with cos/sin
cast to the activation dtype before the multiply.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.roofline.op_cost import named_scope
from ..parallel.collectives import all_gather_cols, row_parallel_matmul
from .common import ModelConfig
from .params import ParamDef, torch_dtype


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def norm_defs(cfg: ModelConfig, dim: Optional[int] = None
              ) -> Dict[str, ParamDef]:
    d = dim or cfg.d_model
    defs = {"scale": ParamDef((d,), "float32", init="ones",
                              logical=("d_model",))}
    if cfg.norm == "layer":
        defs["bias"] = ParamDef((d,), "float32", init="zeros",
                                  logical=("d_model",))
    return defs


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layer":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float
                  ) -> torch.Tensor:
    """qk-norm: RMS over the head_dim of (..., head_dim)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def group_norm_heads(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head group norm of the xLSTM cells: x is (..., H, hd)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


# --------------------------------------------------------------------------
# Activations
# --------------------------------------------------------------------------

def activate(h: torch.Tensor, g: Optional[torch.Tensor], act: str
             ) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf
    if act == "silu_glu":
        return F.silu(g) * h
    if act == "gelu_glu":
        return F.gelu(g, approximate="tanh") * h
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    if act == "relu2":
        r = F.relu(h)
        return r * r
    if act == "silu":
        return F.silu(h)
    raise ValueError(act)


def is_glu(act: str) -> bool:
    return act.endswith("_glu")


# --------------------------------------------------------------------------
# Dense FFN
# --------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None
             ) -> Dict[str, ParamDef]:
    D = cfg.d_model
    F_ = d_ff or cfg.d_ff
    dt = cfg.dtype
    defs = {
        "w_up": ParamDef((D, F_), dt, logical=("d_model", "d_ff")),
        "w_down": ParamDef((F_, D), dt, fan_in_axes=(0,),
                           logical=("d_ff", "d_model")),
    }
    if is_glu(cfg.act):
        defs["w_gate"] = ParamDef((D, F_), dt, logical=("d_model", "d_ff"))
    return defs


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The dense FFN.  Under tensor parallelism (``cfg.tp_axis``) the rank
    holds its slice of d_ff, so the down-projection contracts a partial
    inner dim and the row-parallel edge sums it over the axis."""
    h = x @ p["w_up"]
    g = x @ p["w_gate"] if "w_gate" in p else None
    return row_parallel_matmul(activate(h, g, cfg.act), p["w_down"],
                               cfg.tp_axis, cfg.tp_overlap)


# --------------------------------------------------------------------------
# Embeddings / logits
# --------------------------------------------------------------------------

def embed_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    V, D = cfg.vocab_size, cfg.d_model
    defs = {"tok": ParamDef((V, D), "float32", init="embed", scale=0.02,
                            logical=("vocab", "d_model"))}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((D, V), cfg.dtype, logical=("d_model", "vocab"))
    if cfg.pos_emb == "learned":
        defs["pos"] = ParamDef((min(cfg.max_seq_len, 65536), D), "float32",
                               init="embed", scale=0.02,
                               logical=("seq", "d_model"))
    return defs


def tied_head(p, cfg: ModelConfig) -> torch.Tensor:
    """The tied logits weight ``tok`` cast to the model dtype, (V, D).
    :func:`repro_torch.models.model.prepare_params` caches it once per
    weight load (``tok_cast``): eager torch would otherwise rebuild the
    cast copy — 311 MB for qwen3-0.6b in bf16 — on every decode step."""
    if "tok_cast" in p:
        return p["tok_cast"]
    return p["tok"].to(torch_dtype(cfg.dtype))


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = p["tok"][tokens].to(torch_dtype(cfg.dtype))
    if cfg.pos_emb == "learned":
        if positions is None:
            raise ValueError("learned position embeddings need positions")
        x = x + p["pos"][positions].to(x.dtype)
    return x


def logits_from_hidden(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits over the vocabulary.  Under tensor parallelism an untied
    head is vocab-sharded, so the rank computed V/n columns and the edge
    all-gathers them (``cfg.vocab_size`` stays global in the local config,
    which is how the edge tells); a tied table is replicated for the
    token lookup and gives full rows already."""
    with named_scope("logits"):
        w = tied_head(p, cfg).T if cfg.tie_embeddings else p["head"]
        out = x @ w
        if cfg.tp_axis is not None and out.shape[-1] != cfg.vocab_size:
            out = all_gather_cols(out, cfg.tp_axis)
        return out


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., dim//2)."""
    half = dim // 2
    # log(theta) rounded to float32, as the reference computes it; a host
    # scalar, so no host-to-device copy (which would wait on the stream)
    log_theta = float(np.log(np.float32(theta)))
    freqs = torch.exp(-log_theta * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd//2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# --------------------------------------------------------------------------
# Short causal depthwise conv (mamba / xLSTM front conv)
# --------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  tail: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x (B, L, C), w (C, W) in x's dtype.

    Returns (y, new_tail): ``tail`` (B, W-1, C) carries the last W-1
    inputs across prefill / decode boundaries (zeros when None), and
    ``new_tail`` is a view of the padded input.  The taps add in the
    reference's order (tap 0 first)."""
    B, L, C = x.shape
    W = w.shape[-1]
    if tail is None:
        tail = x.new_zeros((B, W - 1, C))
    xp = torch.cat([tail, x], dim=1)                 # (B, L+W-1, C)
    y = xp[:, :L, :] * w[:, 0]
    for k in range(1, W):
        y = y + xp[:, k:k + L, :] * w[:, k]
    new_tail = xp[:, L:, :] if W > 1 else tail
    return y, new_tail
