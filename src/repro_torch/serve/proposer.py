"""Draft-token proposers for speculative decoding (serve/spec.py): the
JAX package's ``serve/proposer.py`` in PyTorch.

* :class:`NgramProposer` — weight-free prompt lookup: the last n-gram of
  a request's committed tokens is matched against its own earlier context
  and the continuation replayed.  Host-side, no device work; the proposal
  is deterministic, so its ``q`` is a one-hot and the acceptance rule
  reduces to ``min(1, p(d))``.
* :class:`DraftModelProposer` — a small draft model run through the same
  machinery as the target: its own :class:`PagedKVCache` packed by the
  SAME slot indices as the target engine, the multi-token verify step to
  catch up on the tokens the target committed, and
  :func:`sampling.sample_with_probs` for its k draft steps, so the
  verifier receives the proposal distribution ``q`` of every draft.  On
  CUDA the catch-up and the draft step are captured CUDA graphs over its
  own pools (serve/graphs.py), and so is its length-bucketed prefill of
  an admitted request's context, one graph per bucket; sampling stays
  eager between replays, and so does the exact-length prefill of an MoE
  draft model (which the reference jits once per length).

Both return a :class:`Proposal`; slots with nothing proposed carry
``n_draft = 0`` and are verified as ordinary decode steps.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models import decode_step_paged, decode_step_verify_paged, prefill
from ..models.common import ModelConfig
from . import sampling
from .engine import _bucket_len, bucket_prefill_body
from .graphs import PrefillInputs, StaticInput, StepGraphs
from .kv_cache import PagedKVCache
from .scheduler import Request


@dataclasses.dataclass
class Proposal:
    """One round of drafts for the packed slot batch.

    draft (num_slots, k) int32 — entries past ``n_draft`` are padding;
    n_draft (num_slots,) int32; q_probs (num_slots, k, V) float32 proposal
    distributions on the device, or None for a deterministic proposer;
    n_catchup (num_slots,) tokens a draft model re-ingested this round
    (None for weight-free proposers) — the ledger's draft accounting."""
    draft: np.ndarray
    n_draft: np.ndarray
    q_probs: Optional[torch.Tensor] = None
    n_catchup: Optional[np.ndarray] = None


def ngram_propose(tokens: np.ndarray, k: int, max_n: int = 3,
                  min_n: int = 1) -> np.ndarray:
    """Prompt lookup: longest-suffix n-gram match against the request's own
    context (prompt + generated).  Among occurrences, the most recent one
    with a full k-token continuation wins (falling back to the most recent
    overall, whose continuation may be shorter).  Returns up to k tokens
    (possibly none)."""
    L = int(tokens.shape[0])
    for n in range(min(max_n, L - 1), min_n - 1, -1):
        pat = tokens[L - n:]
        best = -1
        for i in range(L - n - 1, -1, -1):
            if i + n < L and np.array_equal(tokens[i:i + n], pat):
                if i + n + k <= L:
                    return np.asarray(tokens[i + n: i + n + k], np.int32)
                best = max(best, i)
        if best >= 0:
            return np.asarray(tokens[best + n: best + n + k], np.int32)
    return np.zeros((0,), np.int32)


class NgramProposer:
    """Weight-free prompt-lookup proposer (host-side, O(L * n) per slot)."""

    kind = "ngram"

    def __init__(self, num_slots: int, k: int, max_n: int = 3,
                 min_n: int = 1):
        self.num_slots = num_slots
        self.k = k
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, running: List[Request],
                k_eff: Optional[np.ndarray] = None) -> Proposal:
        """``k_eff`` (num_slots,) caps the drafted length per slot (the
        adaptive-k path); drafts stay padded to the fixed width k."""
        draft = np.zeros((self.num_slots, self.k), np.int32)
        n_draft = np.zeros((self.num_slots,), np.int32)
        for req in running:
            kr = self.k if k_eff is None else int(k_eff[req.slot])
            cand = ngram_propose(req.tokens, kr, self.max_n, self.min_n)
            draft[req.slot, : cand.shape[0]] = cand
            n_draft[req.slot] = cand.shape[0]
        return Proposal(draft=draft, n_draft=n_draft)

    def release(self, req: Request) -> None:
        pass


class DraftModelProposer:
    """A small draft model run through the same engine machinery.

    Owns a second :class:`PagedKVCache` whose slots mirror the target
    engine's (``alloc(slot=...)`` pins the index so both packed batches
    line up lane for lane).  Per round and active slot it (1) catches up:
    feeds the tokens the target committed since the last round through
    ``decode_step_verify_paged`` (padded to k+1), and (2) drafts k tokens
    autoregressively with ``decode_step_paged`` and
    :func:`sampling.sample_with_probs`, keeping every draft's ``q``.  Both
    passes use the target engine's page-streaming ``pipeline`` and, with
    ``cuda_graphs`` (the target engine's resolved setting), replay graphs
    captured over the draft's pools.  Sampled requests draw their drafts
    from the stream ``sampling.fold_seed(seed, sampling.DRAFT_FOLD)``."""

    kind = "draft"

    def __init__(self, cfg: ModelConfig, params: Any, *, num_slots: int,
                 page_size: int, max_len: int, k: int,
                 device: torch.device, pipeline: Optional[str] = None,
                 prefill_bucket: int = 8, cuda_graphs: bool = False):
        self.cfg = cfg
        self.params = params
        self.num_slots = num_slots
        self.page_size = page_size
        self.k = k
        self.device = device
        self.pipeline = pipeline
        self.prefill_bucket = prefill_bucket
        self.kv = PagedKVCache(cfg, num_slots, page_size, max_len, device,
                               margin_tokens=k + 1)
        self._slots: Dict[int, int] = {}        # request_id -> draft slot
        self._fed: Dict[int, int] = {}          # request_id -> tokens fed
        self._seeds = np.zeros((num_slots,), np.int64)
        self._dsteps = np.zeros((num_slots,), np.int32)
        self._temps = np.zeros((num_slots,), np.float32)
        self._top_ks = np.zeros((num_slots,), np.int32)
        self._top_ps = np.zeros((num_slots,), np.float32)
        # length-bucketed prefill needs per-token collected states: an MoE
        # FFN's capacity cutoffs would see the pad tokens
        self._bucketable = all(b.ffn != "moe" for b in cfg.block_pattern)
        # the two steps' inputs, in buffers their graphs keep: the catch-up
        # feed and positions; the draft step's token (copied from the last
        # draw on the device) and positions (one row a step, staged once a
        # round)
        self._feed_in = StaticInput((num_slots, k + 1), torch.int64, device)
        self._pos_in = StaticInput((num_slots,), torch.int32, device)
        self._step_pos_in = StaticInput((max(k - 1, 1), num_slots),
                                        torch.int32, device)
        self._step_tok = torch.zeros((num_slots, 1), dtype=torch.int64,
                                     device=device)
        self._step_pos = torch.zeros((num_slots,), dtype=torch.int32,
                                     device=device)
        self._prefill_in = PrefillInputs(self.kv.blocks_per_slot, device)
        self._graphs = StepGraphs(device, cuda_graphs, cfg, num_slots,
                                  k + 1)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- per-request lifecycle --------------------------------------------

    def _admit(self, req: Request) -> None:
        # prefill everything committed EXCEPT the newest token, so the
        # catch-up feed always has at least one pending token: at first
        # admission the target's prefill-sampled token, after a preemption
        # the resumed context's last one.  Pages grow on demand from here.
        fill = np.asarray(req.tokens[:-1], np.int64)
        L = int(fill.shape[0])
        slot = self.kv.alloc(L, slot=req.slot, budget=req.budget)
        if slot is None:
            raise RuntimeError(
                f"draft cache out of pages for request {req.request_id} "
                f"({L} tokens, {self.kv.available_page_count} obtainable) "
                "— the draft pool must mirror the target engine's sizing")
        self._slots[req.request_id] = slot
        if self._bucketable:
            S = _bucket_len(L, self.prefill_bucket)
            toks = np.zeros((1, S), np.int64)
            toks[0, :L] = fill
            inp = self._prefill_in
            inp.row.set(self.kv.block_tables[slot])
            inp.length.set(L)
            inp.tokens(S).set(toks)
            self._graphs.run(f"prefill_bucket:{S}", functools.partial(
                bucket_prefill_body, self.params, self.cfg, self.kv, inp, S))
        else:
            _, states = prefill(self.params, self.cfg,
                                self._tensor(fill[None, :]))
            self.kv.write_prefill_states(slot, states, L)
        self._fed[req.request_id] = L
        sampled = req.seed is not None
        self._seeds[slot] = (sampling.fold_seed(req.seed, sampling.DRAFT_FOLD)
                             if sampled else 0)
        self._temps[slot] = req.temperature if sampled else 0.0
        self._top_ks[slot] = req.top_k
        self._top_ps[slot] = req.top_p
        self._dsteps[slot] = len(req.generated) - 1

    def release(self, req: Request) -> None:
        slot = self._slots.pop(req.request_id, None)
        if slot is not None:
            self.kv.free(slot)
            self._fed.pop(req.request_id, None)

    # -- one proposal round ------------------------------------------------

    def _catchup_body(self) -> torch.Tensor:
        return decode_step_verify_paged(
            self.params, self.cfg, self.kv.pools, self.kv.tables.tensor,
            self._feed_in.tensor, self._pos_in.tensor,
            page_size=self.page_size, pipeline=self.pipeline)

    def _draft_body(self) -> torch.Tensor:
        return decode_step_paged(
            self.params, self.cfg, self.kv.pools, self.kv.tables.tensor,
            self._step_tok, self._step_pos, page_size=self.page_size,
            pipeline=self.pipeline)

    def _sample(self, logits: torch.Tensor):
        return sampling.sample_with_probs(logits, self._seeds, self._dsteps,
                                          self._temps, self._top_ks,
                                          self._top_ps)

    @torch.no_grad()
    def propose(self, running: List[Request],
                k_eff: Optional[np.ndarray] = None) -> Proposal:
        B, k = self.num_slots, self.k
        Tc = k + 1
        for req in running:
            if req.request_id not in self._slots:
                self._admit(req)
        k_hi = k if k_eff is None else max(
            (int(k_eff[r.slot]) for r in running), default=k)
        k_hi = max(k_hi, 1)

        # 1. catch up on the tokens the target committed since last round
        feed = np.zeros((B, Tc), np.int64)
        pos = np.zeros((B,), np.int32)
        n_pend = np.zeros((B,), np.int64)
        act = np.zeros((B,), bool)
        for req in running:
            s = req.slot
            fed = self._fed[req.request_id]
            pend = req.tokens[fed:]
            if not 1 <= pend.shape[0] <= Tc:
                raise RuntimeError(
                    f"draft model of request {req.request_id} is "
                    f"{pend.shape[0]} tokens behind (1..{Tc} expected)")
            feed[s, : pend.shape[0]] = pend
            feed[s, pend.shape[0]:] = pend[-1]
            pos[s] = fed
            n_pend[s] = pend.shape[0]
            act[s] = True
            self._fed[req.request_id] = fed + pend.shape[0]
            # catch-up writes [fed, fed+pend) and the draft steps up to
            # k_hi - 1 lines past it (past the budget: the trash margin)
            if not self.kv.ensure_writable(
                    s, fed, fed + int(pend.shape[0]) + k_hi - 1):
                raise RuntimeError(
                    f"draft cache out of pages growing request "
                    f"{req.request_id} ({self.kv.available_page_count} "
                    "obtainable) — the draft pool must mirror the target "
                    "engine's sizing")
        self.kv.block_tables_for([r.slot for r in running])
        self._feed_in.set(feed)
        self._pos_in.set(pos)
        cur_pos = pos + n_pend.astype(np.int32)      # draft token 1's pos
        # draft step i (1..k_hi-1) writes at cur_pos + i - 1
        self._step_pos_in.set(np.where(
            act, cur_pos + np.arange(self._step_pos_in.tensor.shape[0])[
                :, None], 0))
        logits = self._graphs.run("catchup", self._catchup_body)  # (B,Tc,V)
        last_idx = self._tensor(np.maximum(n_pend - 1, 0))
        last = logits[torch.arange(B, device=self.device), last_idx]

        # 2. draft k_hi tokens autoregressively, keeping each q (adaptive k
        # runs fewer steps; draft and q stay padded to width k)
        tok, q = self._sample(last)
        self._dsteps[act] += 1
        toks, qs = [tok], [q]
        for i in range(1, k_hi):
            self._step_tok.copy_(tok[:, None])
            self._step_pos.copy_(self._step_pos_in.tensor[i - 1])
            step_logits = self._graphs.run("draft", self._draft_body)
            tok, q = self._sample(step_logits)
            self._dsteps[act] += 1
            toks.append(tok)
            qs.append(q)
        draft = np.zeros((B, k), np.int32)
        draft[:, :k_hi] = torch.stack(toks, dim=1).cpu().numpy()
        q_probs = torch.stack(qs, dim=1)                     # (B, k_hi, V)
        if k_hi < k:
            q_probs = torch.nn.functional.pad(q_probs,
                                              (0, 0, 0, k - k_hi))
        if k_eff is None:
            n_draft = np.where(act, k, 0).astype(np.int32)
        else:
            n_draft = np.where(act, np.minimum(k_eff, k_hi), 0).astype(
                np.int32)
        return Proposal(draft=draft, n_draft=n_draft, q_probs=q_probs,
                        n_catchup=np.where(act, n_pend, 0).astype(np.int32))
