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

Speculative decoding adds :func:`sample_with_probs` (a draft model's draw
plus the proposal distribution it came from) and :func:`spec_accept` (the
rejection rule that keeps committed tokens distributed as the target).
Their random numbers come from streams of their own, seeded with
:func:`fold_seed` of the request seed (see there).
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def _mix64(hi: int, lo: int) -> int:
    """splitmix64's finalizer of two 32-bit values packed into 64 bits:
    every output bit depends on every input bit."""
    z = ((int(hi) & 0xFFFFFFFF) << 32) | (int(lo) & 0xFFFFFFFF)
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def row_generator(seed: int, step: int, device: torch.device
                  ) -> torch.Generator:
    """The random stream of one draw: request ``seed`` at token ``step``.
    The generator's seed is a 64-bit hash of the pair, not the pair side
    by side: torch's CPU generator keeps only the low 32 bits of a seed,
    which would give every request the same noise at a given step."""
    g = torch.Generator(device=device)
    g.manual_seed(_mix64(seed, step))
    return g


# tags deriving the accept/reject uniforms' and the draft model's random
# streams from a request's seed (the reference folds the same tags into its
# per-request key: sampling._ACCEPT_FOLD, proposer.DRAFT_FOLD)
ACCEPT_FOLD = 0x5bec0de
DRAFT_FOLD = 0xd4af7


def fold_seed(seed: int, tag: int) -> int:
    """A request seed of its own for stream ``tag`` of request ``seed``.

    :func:`row_generator` keys a draw by (seed, step); the accept uniforms
    and a draft model's draws reuse the same step indices as the token
    draws, so they take the seed ``fold_seed(seed, tag)`` instead: the
    64-bit hash of ``seed`` and ``tag`` cut to the 32 bits
    ``row_generator`` reads of a seed.  Distinct (seed, tag) pairs give
    unrelated seeds, so the three streams of a request are independent
    (up to a 2^-32 chance of a collision)."""
    return _mix64(seed, tag) & 0xFFFFFFFF


def _gumbel(seed: int, step: int, n: int, device: torch.device
            ) -> torch.Tensor:
    """The Gumbel noise of one draw: request ``seed`` at token ``step``."""
    u = torch.rand(n, generator=row_generator(seed, step, device),
                   device=device)
    return -torch.log(-torch.log(u.clamp_min(1e-20)))


def _filtered(logits: torch.Tensor, temps: np.ndarray, top_ks: np.ndarray,
              top_ps: np.ndarray) -> torch.Tensor:
    """``logits`` (B, V) float32 through the top-k / top-p filter when any
    row asks for one (the filter's masks are exact, so unfiltered rows
    are returned unchanged)."""
    if np.any(np.asarray(top_ks) > 0) or np.any(
            (np.asarray(top_ps) > 0.0) & (np.asarray(top_ps) < 1.0)):
        dev = logits.device
        return _filter_logits_sort(
            logits, torch.as_tensor(np.asarray(top_ks), device=dev),
            torch.as_tensor(np.asarray(top_ps, np.float32), device=dev),
            torch.as_tensor(np.asarray(temps, np.float32), device=dev))
    return logits


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
    if top_ps is None:
        top_ps = np.zeros((logits.shape[0],), np.float32)
    filtered = _filtered(logits, temps, top_ks, top_ps)
    out = greedy.clone()
    for b in rows:
        gumbel = _gumbel(seeds[b], steps[b], logits.shape[-1], logits.device)
        out[b] = torch.argmax(filtered[b] / float(temps[b]) + gumbel)
    return out


def sample_with_probs(logits: torch.Tensor, seeds: np.ndarray,
                      steps: np.ndarray, temps: np.ndarray,
                      top_ks: np.ndarray, top_ps: np.ndarray
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample one token per row AND return the distribution it was drawn
    from — what a draft model hands the verifier so :func:`spec_accept`
    sees the true proposal ``q``.  Greedy rows (temp <= 0) give a one-hot
    at the argmax; sampled rows the filtered, tempered softmax, and their
    token is :func:`sample_tokens`'s draw for (seeds[b], steps[b]) (the
    draft model passes its own :func:`fold_seed` seeds).  Returns (tokens
    (B,) int64, probs (B, V) float32), both on the logits' device."""
    logits = logits.float()
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    temps = np.asarray(temps, np.float32)
    probs = torch.nn.functional.one_hot(greedy, V).float()
    rows = np.flatnonzero(temps > 0.0)
    if rows.size == 0:
        return greedy, probs
    filtered = _filtered(logits, temps, top_ks, top_ps)
    toks = greedy.clone()
    for b in rows:
        row = filtered[b] / float(temps[b])
        probs[b] = torch.softmax(row, dim=-1)
        toks[b] = torch.argmax(row + _gumbel(seeds[b], steps[b], V,
                                             logits.device))
    return toks, probs


def _leading(acc: torch.Tensor) -> torch.Tensor:
    """Length of each row's leading run of True: (B, k) -> (B,)."""
    return torch.cumprod(acc.long(), dim=1).sum(dim=1)


def spec_accept(logits: torch.Tensor, draft: np.ndarray,
                q_probs: Optional[torch.Tensor], n_draft: np.ndarray,
                seeds: np.ndarray, steps: np.ndarray, temps: np.ndarray,
                top_ks: np.ndarray, top_ps: np.ndarray
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched draft acceptance that preserves the target distribution
    (Leviathan et al. 2022, algorithm 1).

    logits (B, T, V) from the verify step: position t is the distribution
    AFTER feed token t (feed = [last committed, d_1..d_k], T = k+1).
    draft (B, k) the proposed tokens (d_{i+1} is checked against position
    i); q_probs (B, k, V) their proposal distributions, or None for a
    deterministic proposer (n-gram lookup: q is the one-hot at the draft);
    n_draft (B,) how many drafts are real.  seeds, steps, temps, top_ks,
    top_ps (B,) are the engine's per-slot state; committed token j of row
    b is drawn at step ``steps[b] + j``.

    Returns (tokens (B, T), n_out (B,)) on the logits' device: the first
    n_out[b] entries of row b are the committed continuation (accepted
    drafts, then one corrected or bonus token; every row commits >= 1).

    Greedy rows (temp <= 0) take the argmax chain: accept d_{i+1} while it
    equals argmax(logits_i), then the first mismatching argmax, which is
    token for token what sequential greedy decode gives.  Sampled rows
    accept d_{i+1} with probability min(1, p(d)/q(d)), against the i-th of
    k uniforms drawn from ``row_generator(fold_seed(seed, ACCEPT_FOLD),
    steps)`` (one fresh stream per round: ``steps`` grows every round); at
    the first rejection they resample from norm(max(p - q, 0)), and if
    every real draft survives they draw the bonus token from p at the
    last position.  That final token, at step ``steps + n_acc``, takes the
    Gumbel noise :func:`sample_tokens` would use at that step (Gumbel-max
    over the log of the residual; for the bonus token it is sample_tokens'
    draw).  Streams are torch's generators (Philox on the card), not
    JAX's threefry: the two agree in distribution, never token for
    token."""
    logits = logits.float()
    B, T, V = logits.shape
    k = T - 1
    dev = logits.device
    draft_d = torch.as_tensor(np.asarray(draft, np.int64), device=dev)
    n_draft_d = torch.as_tensor(np.asarray(n_draft), device=dev)
    real = torch.arange(k, device=dev)[None, :] < n_draft_d[:, None]
    greedy_t = torch.argmax(logits, dim=-1)                       # (B, T)
    n_out = _leading((draft_d == greedy_t[:, :k]) & real) + 1
    temps = np.asarray(temps, np.float32)
    rows = np.flatnonzero(temps > 0.0)
    if rows.size == 0:
        return greedy_t, n_out
    # the sampled rows, all at once; only their random draws are per row
    R = len(rows)
    sel = torch.as_tensor(rows, device=dev)
    rep = lambda a: np.repeat(np.asarray(a)[rows], T)  # noqa: E731
    filtered = _filtered(logits[sel].reshape(R * T, V), rep(temps),
                         rep(top_ks), rep(top_ps)).reshape(R, T, V)
    t_r = torch.as_tensor(temps[rows], device=dev)
    p = torch.softmax(filtered / t_r[:, None, None], dim=-1)     # (R, T, V)
    d = draft_d[sel]                                              # (R, k)
    q = (torch.nn.functional.one_hot(d, V).float() if q_probs is None
         else q_probs[sel].float())                               # (R, k, V)
    p_at = torch.gather(p[:, :k], 2, d[..., None])[..., 0]
    q_at = torch.gather(q, 2, d[..., None])[..., 0]
    u = torch.stack([
        torch.rand(k, generator=row_generator(
            fold_seed(seeds[b], ACCEPT_FOLD), steps[b], dev), device=dev)
        for b in rows])                                           # (R, k)
    n_acc = _leading((u * torch.clamp(q_at, min=1e-30) < p_at) & real[sel])
    ar = torch.arange(R, device=dev)
    res = p[ar, n_acc]                                            # (R, V)
    rejected = n_acc < torch.clamp(n_draft_d[sel], max=k)
    res = torch.where(rejected[:, None],
                      torch.clamp(res - q[ar, torch.clamp(n_acc, max=k - 1)],
                                  min=0.0), res)
    res = res / torch.clamp(res.sum(-1, keepdim=True), min=1e-30)
    n_acc_h = n_acc.cpu().numpy()
    gumbel = torch.stack([_gumbel(seeds[b], steps[b] + int(n_acc_h[i]), V,
                                  dev) for i, b in enumerate(rows)])
    final = torch.argmax(torch.log(res) + gumbel, dim=-1)         # (R,)
    chain = torch.cat([d, final[:, None]], dim=1)                 # (R, T)
    jj = torch.arange(T, device=dev)[None, :]
    out, n_out = greedy_t.clone(), n_out.clone()
    out[sel] = torch.where(jj < n_acc[:, None], chain, final[:, None])
    n_out[sel] = n_acc + 1
    return out, n_out
    out, n_out = out.clone(), n_out.clone()
    rep = lambda a: np.repeat(np.asarray(a), T)  # noqa: E731
    filtered = _filtered(logits.reshape(B * T, V), rep(temps),
                         rep(top_ks), rep(top_ps)).reshape(B, T, V)
    for b in rows:
        p = torch.softmax(filtered[b] / float(temps[b]), dim=-1)  # (T, V)
        q = (torch.nn.functional.one_hot(draft_d[b], V).float()
             if q_probs is None else q_probs[b].float())          # (k, V)
        idx = draft_d[b][:, None]
        p_at = torch.gather(p[:k], 1, idx)[:, 0]
        q_at = torch.gather(q, 1, idx)[:, 0]
        acc_seed = fold_seed(seeds[b], ACCEPT_FOLD)
        u = torch.stack([
            torch.rand((), generator=row_generator(acc_seed, steps[b] + i,
                                                   dev), device=dev)
            for i in range(k)])
        accept = (u * torch.clamp(q_at, min=1e-30) < p_at) & real[b]
        n_acc = int(_leading(accept[None])[0])
        res = p[n_acc]
        if n_acc < min(int(n_draft[b]), k):          # a real rejection
            res = torch.clamp(res - q[min(n_acc, k - 1)], min=0.0)
        res = res / torch.clamp(res.sum(), min=1e-30)
        gumbel = _gumbel(seeds[b], steps[b] + n_acc, V, dev)
        out[b, :n_acc] = draft_d[b, :n_acc]
        out[b, n_acc] = torch.argmax(torch.log(res) + gumbel)
        n_out[b] = n_acc + 1
    return out, n_out
