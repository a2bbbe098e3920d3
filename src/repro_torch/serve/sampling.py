"""Batched token sampling shared by prefill's first token and the fused
decode step.

Per row ``b``:

* ``temps[b] <= 0``  -> greedy ``argmax`` (no random numbers drawn).
* ``temps[b] > 0``   -> a Gumbel-max draw from ``logits_b / temps[b]``
  after the optional top-k / top-p filters.  The noise comes from a
  ``torch.Generator`` seeded from (request seed, step), so a request's
  draw at step ``i`` does not depend on the batch it shares — the role
  the reference's ``fold_in(key, step)`` plays.  torch's Philox is not
  JAX's threefry: the two agree in distribution, not bit for bit.
* ``top_ks[b] > 0`` / ``0 < top_ps[b] < 1`` -> the sort-based filter
  (:func:`_filter_logits_sort`), whose kept set equals the reference's.

Which rows sample is known on the host, so an all-greedy batch (the
serving default) runs one argmax and nothing else.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def _filter_logits_sort(logits: torch.Tensor, top_ks: torch.Tensor,
                        top_ps: Optional[torch.Tensor] = None,
                        temps: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Mask logits outside each row's top-k and/or nucleus (0 = keep all).

    One descending sort serves both filters.  The k-th value is a per-row
    threshold; the nucleus is the shortest prefix of the descending order
    of the tempered, top-k-renormalized distribution whose mass reaches
    ``top_ps`` (the first token always survives).  Ties at either
    threshold are all kept."""
    V = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    idx = torch.clamp(top_ks.long() - 1, 0, V - 1)
    thresh = torch.gather(sorted_desc, -1, idx[:, None])
    keep = (top_ks[:, None] <= 0) | (logits >= thresh)
    if top_ps is not None:
        scaled = sorted_desc.float()
        if temps is not None:
            safe_t = torch.clamp(temps, min=1e-6).float()
            scaled = scaled / safe_t[:, None]
        rank = torch.arange(V, device=logits.device)[None, :]
        in_k = (top_ks[:, None] <= 0) | (rank < top_ks[:, None])
        probs_desc = torch.softmax(torch.where(in_k, scaled, NEG_INF), dim=-1)
        mass_before = torch.cumsum(probs_desc, dim=-1) - probs_desc
        n_keep = torch.sum(in_k & (mass_before < top_ps[:, None]), dim=-1)
        p_thresh = torch.gather(sorted_desc, -1,
                                torch.clamp(n_keep - 1, 0, V - 1)[:, None])
        off = (top_ps[:, None] <= 0.0) | (top_ps[:, None] >= 1.0)
        keep = keep & (off | (logits >= p_thresh))
    return torch.where(keep, logits, NEG_INF)


def row_generator(seed: int, step: int, device: torch.device
                  ) -> torch.Generator:
    """The random stream of one draw: request ``seed`` at token ``step``."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    return g


def sample_tokens(logits: torch.Tensor, seeds: np.ndarray,
                  steps: np.ndarray, temps: np.ndarray, top_ks: np.ndarray,
                  top_ps: Optional[np.ndarray] = None) -> torch.Tensor:
    """Batched greedy / temperature / top-k / top-p sampling.

    logits (B, V) on the device; seeds, steps, temps, top_ks, top_ps (B,)
    host arrays (the engine's per-slot state).  Returns (B,) int64 token
    ids on the logits' device."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    temps = np.asarray(temps, np.float32)
    rows = np.flatnonzero(temps > 0.0)
    if rows.size == 0:
        return greedy
    dev = logits.device
    B = logits.shape[0]
    if top_ps is None:
        top_ps = np.zeros((B,), np.float32)
    filtered = logits
    if np.any(np.asarray(top_ks) > 0) or np.any(
            (np.asarray(top_ps) > 0.0) & (np.asarray(top_ps) < 1.0)):
        filtered = _filter_logits_sort(
            logits, torch.as_tensor(np.asarray(top_ks), device=dev),
            torch.as_tensor(np.asarray(top_ps, np.float32), device=dev),
            torch.as_tensor(temps, device=dev))
    out = greedy.clone()
    for b in rows:
        g = row_generator(seeds[b], steps[b], dev)
        u = torch.rand(logits.shape[-1], generator=g, device=dev)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        out[b] = torch.argmax(filtered[b] / float(temps[b]) + gumbel)
    return out
