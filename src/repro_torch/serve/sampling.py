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
* ``top_ks[b] > 0`` / ``0 < top_ps[b] < 1`` -> the reference's filter
  dispatch (:func:`_maybe_filter` -> :func:`_filter_logits`): the
  sort-free threshold scan (:func:`_filter_logits_scan`) when V >= 1024
  and 8 * max(top_k) <= V, the sort (:func:`_filter_logits_sort`)
  otherwise.  Both keep every logit tied at a threshold, but at ties on
  the k-th value the sort's nucleus mass counts exactly k ranks and the
  scan's every tied logit, so only the dispatch keeps the reference's set.
  The nucleus boundary compares a float32 sum with ``top_ps``: where the
  mass lies within float32 rounding of ``top_p`` the summation order
  (torch vs XLA) can move it by one token.

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


def _sortable_bits(x: torch.Tensor) -> torch.Tensor:
    """Map float32 to the uint32 radix-sort key, held in int64 (torch has
    no uint32 arithmetic): a >= b iff map(a) >= map(b).  Positives get the
    sign bit set, negatives have every bit flipped."""
    bits = x.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(bits >> 31 != 0, bits ^ 0xFFFFFFFF,
                       bits | 0x80000000)


def _threshold_scan(mapped: torch.Tensor, weights: torch.Tensor,
                    target: torch.Tensor) -> torch.Tensor:
    """Per-row largest 32-bit threshold ``t`` with ``sum(weights[mapped >=
    t]) >= target``: 32 bisection steps, high bit to low, each one compare
    and masked sum over the row.  The weighted count does not increase
    with ``t``, so fixing one bit at a time lands on the boundary value."""
    t = torch.zeros(mapped.shape[0], dtype=torch.int64, device=mapped.device)
    for i in range(32):
        cand = t | (1 << (31 - i))
        hit = torch.where(mapped >= cand[:, None], weights, 0.0).sum(-1)
        t = torch.where(hit >= target, cand, t)
    return t


def _filter_logits_scan(logits: torch.Tensor, top_ks: torch.Tensor,
                        top_ps: Optional[torch.Tensor] = None,
                        temps: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The sort-free twin of :func:`_filter_logits_sort`: the k-th-largest
    logit and the nucleus boundary are value thresholds (the kept set is
    an upper set of logit values), each found by :func:`_threshold_scan`.
    The top-k pass counts survivors (weights 1); the top-p pass weighs
    them by the tempered, top-k-renormalized probabilities and finds the
    smallest value whose strictly-above mass is still short of ``top_ps``
    (the first token always survives).  Every logit tied at either
    threshold is kept, and the nucleus mass counts all of them."""
    V = logits.shape[-1]
    mapped = _sortable_bits(logits)
    k_tgt = torch.clamp(top_ks.long(), 1, V).float()
    t_k = _threshold_scan(mapped, torch.ones_like(logits, dtype=torch.float32),
                          k_tgt)
    in_k = (top_ks[:, None] <= 0) | (mapped >= t_k[:, None])
    keep = in_k
    if top_ps is not None:
        scaled = logits.float()
        if temps is not None:
            safe_t = torch.clamp(temps, min=1e-6).float()
            scaled = scaled / safe_t[:, None]
        probs = torch.softmax(torch.where(in_k, scaled, NEG_INF), dim=-1)
        t_p = _threshold_scan(mapped, torch.where(in_k, probs, 0.0),
                              top_ps.float())
        off = (top_ps[:, None] <= 0.0) | (top_ps[:, None] >= 1.0)
        keep = keep & (off | (mapped >= t_p[:, None]))
    return torch.where(keep, logits, NEG_INF)


# below this vocabulary one sort is cheaper than 32 streaming passes
_SCAN_MIN_VOCAB = 1024


def _filter_logits(logits: torch.Tensor, top_ks: torch.Tensor,
                   top_ps: Optional[torch.Tensor] = None,
                   temps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's dispatch between the two filters: the scan when V
    >= ``_SCAN_MIN_VOCAB`` and every requested k is at most V / 8, the
    sort otherwise.  The per-row controls may lie on the host (the
    engine's arrays): the choice is made there, without a device sync, and
    they follow the logits to their device for the filter itself."""
    V = logits.shape[-1]
    scan = V >= _SCAN_MIN_VOCAB and int(top_ks.max()) * 8 <= V
    dev = logits.device
    top_ks = top_ks.to(dev)
    top_ps = None if top_ps is None else top_ps.to(dev)
    temps = None if temps is None else temps.to(dev)
    fn = _filter_logits_scan if scan else _filter_logits_sort
    return fn(logits, top_ks, top_ps, temps)


def _maybe_filter(logits: torch.Tensor, top_ks: torch.Tensor,
                  top_ps: Optional[torch.Tensor],
                  temps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`_filter_logits` when some row asks for a filter, else the
    logits unchanged (the filters' masks are exact)."""
    want = bool((top_ks > 0).any())
    if top_ps is not None:
        want = want or bool(((top_ps > 0.0) & (top_ps < 1.0)).any())
    return _filter_logits(logits, top_ks, top_ps, temps) if want else logits


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
    """``logits`` (B, V) float32 through :func:`_maybe_filter` with the
    engine's host-side per-row controls."""
    return _maybe_filter(logits, torch.as_tensor(np.asarray(top_ks)),
                         torch.as_tensor(np.asarray(top_ps, np.float32)),
                         torch.as_tensor(np.asarray(temps, np.float32)))


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


def target_distribution(logits: torch.Tensor, temp: float, top_k: int,
                        top_p: float) -> np.ndarray:
    """The distribution :func:`sample_tokens` draws a row from at
    temperature ``temp`` > 0: the softmax of ``logits`` (V,) after the
    top-k / top-p filters, divided by ``temp``; float64 on the host, 0
    outside the kept set."""
    f = _filtered(logits.float()[None], np.asarray([temp], np.float32),
                  np.asarray([top_k]), np.asarray([top_p], np.float32))[0]
    f = f.double().cpu().numpy()
    keep = f > NEG_INF / 2
    z = np.where(keep, f / temp, -np.inf)
    p = np.exp(z - z[keep].max())
    return p / p.sum()


def tv_null_bound(probs: np.ndarray, n: int, sigmas: float = 6.0) -> float:
    """A bound on the total variation ``sum |f - p| / 2`` between the
    frequencies ``f`` of ``n`` independent draws from ``probs`` and
    ``probs`` itself, which a correct sampler exceeds with negligible
    probability: the TV's mean plus ``sigmas`` standard deviations, each
    count taken as normal with variance ``v = n p (1 - p)``, so that
    ``E|f - p| = sqrt(2 v / pi) / n`` and ``Var|f - p| = v (1 - 2 / pi) /
    n^2``, the counts' (negative) correlation left out."""
    v = probs * (1.0 - probs) / n
    mean = 0.5 * np.sum(np.sqrt(2.0 * v / np.pi))
    sd = 0.5 * np.sqrt(np.sum(v * (1.0 - 2.0 / np.pi)))
    return float(mean + sigmas * sd)


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
