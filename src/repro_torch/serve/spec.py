"""Speculative decoding: draft k tokens cheaply, verify them in one pass.

Paged decode is memory-bound: every generated token re-reads the active
weights plus the KV lines, so its arithmetic intensity ``I = W/Q`` sits
far left of the ridge.  A proposer drafts ``k`` tokens; one multi-token
verification pass (``models.decode_step_verify_paged``, whose attention is
the hand-written verify kernel on the card) scores all ``k+1`` positions
in a single weight read and page walk; a rejection-sampling rule
(``sampling.spec_accept``) keeps every committed token distributed as the
target model's, and greedy output equals sequential greedy decode token
for token.  W scales by ``k+1`` while Q barely moves; the tokens/s gain is
the yield ``E[tokens/pass] = (1 - a^(k+1)) / (1 - a)`` at per-draft
acceptance ``a`` (:func:`spec_expected_tokens_per_pass`), discounted by the
verify/draft pass-cost ratio (:func:`spec_speedup_model`).

:class:`SpecEngine` subclasses the continuous-batching :class:`Engine`:
admission, chunked prefill, the paged cache and the per-request ledger are
inherited; the decode phase becomes propose -> verify -> accept ->
variable-length commit.  Rolling back rejected drafts is position
bookkeeping: their K/V writes sit past the committed context, are masked,
and are overwritten when a real token is fed at that position.  The
ledger gains the verify / draft phase splits
(``RooflineLedger.add_verify_step`` / ``add_draft_cost``).

On CUDA the verify step (fixed shape (num_slots, k+1)) replays a captured
CUDA graph, as the engine's decode step does (serve/graphs.py); the
acceptance rule and its host copies stay eager.  With telemetry on, the
``propose`` span ends at the draft round's synchronize and the ``verify``
span at the verify step's read-back.

The JAX package's ``serve/spec.py`` in PyTorch.  :meth:`SpecEngine.
export_request` frees the proposer's mirrored slot before a request
migrates to another replica (serve/cluster.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import synchronize
from ..models import decode_step_verify_paged, prepare_params
from ..models.common import ModelConfig
from ..obs.clock import now
from ..obs.trace import ENGINE_TID
from . import sampling
from .engine import Engine, EngineConfig
from .graphs import StaticInput
from .kv_cache import supports_paging
from .proposer import DraftModelProposer, NgramProposer
from .scheduler import (Request, RequestState, decode_token_bytes,
                        decode_token_flops, kv_line_bytes,
                        params_bytes_active, verify_step_vmem_bytes)


def supports_spec(cfg: ModelConfig) -> bool:
    """Speculative decoding needs a rollback-free cache: rejected drafts
    must be erasable by position bookkeeping alone.  Attention/MLA caches
    qualify (stale lines are masked and overwritten); recurrent state
    advances destructively."""
    return supports_paging(cfg) and all(
        b.mixer in ("attn", "mla") for b in cfg.block_pattern)


@dataclasses.dataclass
class SpecConfig:
    k: int = 4                         # drafted tokens per verify round
    proposer: str = "ngram"            # "ngram" | "draft"
    draft_cfg: Optional[ModelConfig] = None
    draft_params: Any = None
    ngram_max: int = 3                 # longest suffix n-gram to match
    ngram_min: int = 1
    # adaptive drafted length: an EWMA of each request's per-draft
    # acceptance picks k_eff <= k every round (the verify step keeps its
    # (num_slots, k+1) shape; shorter drafts are padding)
    adaptive: bool = False
    ewma_beta: float = 0.4             # weight of the newest observation
    adapt_floor: float = 0.25          # keep drafting while a^j >= floor
    k_min: int = 1                     # never shrink below this


def adaptive_k(alpha: float, k_max: int, floor: float = 0.25,
               k_min: int = 1) -> int:
    """Drafted length at acceptance rate ``alpha``: the j-th draft commits
    with probability ~``alpha^j``, so draft while that clears ``floor``."""
    if alpha >= 1.0:
        return k_max
    if alpha <= 0.0:
        return k_min
    j = int(np.floor(np.log(floor) / np.log(alpha)))
    return int(np.clip(j, k_min, k_max))


def spec_expected_tokens_per_pass(alpha: float, k: int) -> float:
    """E[committed tokens per verify pass] when each draft survives i.i.d.
    with probability ``alpha``: 1 + a + ... + a^k = (1 - a^(k+1))/(1 - a);
    the 1 is the always-committed corrected or bonus token."""
    if alpha >= 1.0:
        return float(k + 1)
    return (1.0 - alpha ** (k + 1)) / (1.0 - alpha)


def spec_speedup_model(cfg: ModelConfig, k: int, alpha: float,
                       context_len: int, active_batch: int,
                       draft_cfg: Optional[ModelConfig] = None
                       ) -> Dict[str, float]:
    """Predicted speculative speedup against the memory-bound ceiling.

    Decode and verify steps are both memory-bound, so their time ratio is
    their Q ratio, Q_verify/Q_decode = (w/B + (L + 2T - 1) line) / (w/B +
    (L + 1) line); a draft model adds its own bytes per round.  Then
    speedup = E[tokens/pass] / ((Q_verify + Q_draft) / Q_decode)."""
    T = k + 1
    etok = spec_expected_tokens_per_pass(alpha, k)
    q_dec = decode_token_bytes(cfg, context_len, active_batch)
    q_ver = q_dec + (2 * T - 2) * kv_line_bytes(cfg)
    q_draft = 0.0
    if draft_cfg is not None:
        line_d = kv_line_bytes(draft_cfg)
        w_d = params_bytes_active(draft_cfg) / max(active_batch, 1)
        # one catch-up pass (~etok tokens) + (k-1) single-token steps
        q_draft = (w_d + (context_len + 2 * T - 1) * line_d
                   + (k - 1) * (w_d + (context_len + k) * line_d))
    cost_ratio = (q_ver + q_draft) / q_dec
    return {"tokens_per_pass": etok, "pass_cost_ratio": cost_ratio,
            "speedup": etok / cost_ratio}


def speculative_summary(cfg: ModelConfig, requests: List[Request], k: int,
                        context_len: int,
                        draft_cfg: Optional[ModelConfig] = None
                        ) -> Dict[str, float]:
    """Pool finished requests' ledgers into the speculative report: the
    measured acceptance rate and tokens per weight pass, and the
    memory-bound model's predictions at the pooled acceptance rate."""
    acc = (sum(r.ledger.accepted for r in requests)
           / max(sum(r.ledger.proposed for r in requests), 1))
    tpp = (sum(r.ledger.decode_tokens for r in requests)
           / max(sum(r.ledger.weight_passes for r in requests), 1))
    batch = max(int(round(float(np.mean(
        [r.ledger.mean_batch for r in requests])))), 1)
    model = spec_speedup_model(cfg, k, acc, context_len, batch,
                               draft_cfg=draft_cfg)
    return {"acceptance_rate": acc, "tokens_per_pass": tpp,
            "predicted_tokens_per_pass": model["tokens_per_pass"],
            "predicted_speedup": model["speedup"]}


class SpecEngine(Engine):
    """Continuous-batching engine with speculative draft/verify decode.

        eng = SpecEngine(cfg, params, EngineConfig(num_slots=8),
                         SpecConfig(k=4, proposer="ngram"))
        eng.submit(prompt_ids, GenerateConfig(max_new_tokens=64))
        done = eng.run()

    Each decode round runs ONE verify step over the packed slot batch, of
    fixed shape (num_slots, k+1) whatever the admission state or per-slot
    draft counts, then commits a variable number of tokens per request on
    the host.  A request with no drafts this round still commits one
    token: a silent proposer degrades to ordinary decode."""

    def __init__(self, cfg: ModelConfig, params,
                 ecfg: Optional[EngineConfig] = None,
                 scfg: Optional[SpecConfig] = None):
        if not supports_spec(cfg):
            raise NotImplementedError(
                f"{cfg.name}: speculative decoding needs attention/MLA "
                "mixers throughout (rollback-free paged cache)")
        super().__init__(cfg, params, ecfg)
        self.scfg = scfg or SpecConfig()
        if self.scfg.k < 1:
            raise ValueError("SpecConfig.k must be >= 1")
        if self.scfg.proposer == "draft":
            dcfg = self.scfg.draft_cfg
            if dcfg is None or self.scfg.draft_params is None:
                raise ValueError("proposer='draft' needs draft_cfg and "
                                 "draft_params")
            if not supports_spec(dcfg):
                raise NotImplementedError(
                    f"draft arch {dcfg.name}: needs attention/MLA mixers")
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocab")
            self._draft_params = prepare_params(self.scfg.draft_params, dcfg)
        elif self.scfg.proposer != "ngram":
            raise ValueError(f"unknown proposer {self.scfg.proposer!r}")
        self.proposer = None
        self.verify_steps = 0
        # request_id -> EWMA of per-draft acceptance (adaptive k); starts
        # optimistic so fresh requests draft at full k
        self._accept_ewma: Dict[int, float] = {}

    # -- wiring ------------------------------------------------------------

    def _kv_margin(self) -> int:
        # verify feeds up to k tokens past the committed context; near the
        # budget edge those writes must resolve to (trash) table entries
        return self.scfg.k + 1

    def _graph_tokens(self) -> int:
        return self.scfg.k + 1

    def reset(self, num_slots: Optional[int] = None,
              max_len: Optional[int] = None) -> None:
        super().reset(num_slots=num_slots, max_len=max_len)
        e, s = self.ecfg, self.scfg
        # the verify step's token chains, in a buffer its graph keeps
        self._feed_in = StaticInput((e.num_slots, s.k + 1), torch.int64,
                                    self.device)
        if s.proposer == "draft":
            self.proposer = DraftModelProposer(
                s.draft_cfg, self._draft_params, num_slots=e.num_slots,
                page_size=e.page_size, max_len=self._kv.max_len, k=s.k,
                device=self.device, pipeline=e.pipeline,
                prefill_bucket=max(e.prefill_bucket, 1),
                cuda_graphs=self.graphs)
        else:
            self.proposer = NgramProposer(e.num_slots, s.k,
                                          max_n=s.ngram_max,
                                          min_n=s.ngram_min)
        self.verify_steps = 0

    # -- decode = propose -> verify -> accept -> commit --------------------

    def _verify_body(self) -> torch.Tensor:
        """The verify step over the persistent inputs: logits (B, T, V)."""
        return decode_step_verify_paged(
            self.params, self.step_cfg, self._kv.pools,
            self._kv.tables.tensor,
            self._feed_in.tensor, self._pos_in.tensor,
            page_size=self.ecfg.page_size, pipeline=self.ecfg.pipeline)

    def _run_decode(self, running: List[Request]) -> None:
        kv, s = self._kv, self.scfg
        k, T = s.k, s.k + 1
        # the verify step writes T lines from context_len - 1 on: back the
        # whole span (growth + copy-on-write) so speculative writes never
        # land on a shared page; past-budget lines fall on the trash margin
        running = self._grow_spans(
            running, lambda r: (r.context_len - 1, r.context_len - 1 + T))
        if not running:
            return
        slots = [r.slot for r in running]
        active = np.zeros((self.ecfg.num_slots,), bool)
        active[slots] = True
        k_eff = None
        if s.adaptive:
            k_eff = np.full((self.ecfg.num_slots,), k, np.int32)
            for req in running:
                a = self._accept_ewma.get(req.request_id, 1.0)
                k_eff[req.slot] = adaptive_k(a, k, s.adapt_floor, s.k_min)
        td0 = now()
        prop = self.proposer.propose(running, k_eff=k_eff)
        synchronize(self.device)
        td1 = now()
        self._sched.phases["draft"].add(wall_s=td1 - td0, steps=1)
        if self.obs is not None:
            self.obs.tracer.span("propose", self._obs_pid, ENGINE_TID,
                                 td0, td1, batch=len(running))

        feed = np.zeros((self.ecfg.num_slots, T), np.int64)
        feed[:, 0] = np.where(active, self._next_token, 0)
        feed[:, 1:] = prop.draft
        kv.block_tables_for(slots)
        self._feed_in.set(feed)
        self._pos_in.set(np.where(active, self._pos, 0))
        t0 = now()
        logits = self._graphs.run("verify", self._verify_body)
        out_tok, n_out = sampling.spec_accept(
            logits, prop.draft, prop.q_probs, prop.n_draft, self._seeds,
            self._steps, self._temps, self._top_ks, self._top_ps)
        out_np = out_tok.cpu().numpy()        # the device->host copies
        n_np = n_out.cpu().numpy()
        t1 = now()
        self.decode_steps += 1
        self.verify_steps += 1
        if self.obs is not None:
            self.obs.tracer.span("verify", self._obs_pid, ENGINE_TID,
                                 t0, t1, batch=len(running), k=k)

        n_active = len(running)
        ici_share = self._step_collective_bytes(T) / n_active
        vph = self._sched.phases["verify"]
        ps = self.ecfg.page_size
        line = kv_line_bytes(self.cfg)
        for req in running:
            slot, L = req.slot, req.context_len
            nd = int(prop.n_draft[slot])
            n = max(1, min(int(n_np[slot]), nd + 1))
            committed = 0
            for j in range(n):
                self._commit_token(req, int(out_np[slot, j]), t=t1)
                committed += 1
                if req.state is RequestState.FINISHED:
                    break
            # the last committed token is the corrected/bonus draw only if
            # the chain ran to completion; a stop token or the budget cut
            # it short, and then everything committed was an accepted draft
            accepted = committed - 1 if committed == n else committed
            vmem = verify_step_vmem_bytes(self.cfg, L, T, n_active, ps,
                                          pipeline=self.ecfg.pipeline)
            req.ledger.add_verify_step(self.cfg, L, T, committed, accepted,
                                       nd, n_active, vmem_bytes=vmem,
                                       ici_bytes=ici_share)
            vph.add(flops=sum(decode_token_flops(self.cfg, L + t)
                              for t in range(T)),
                    vmem=vmem,
                    hbm=(params_bytes_active(self.cfg) / n_active
                         + (L + 2 * T - 1) * line),
                    ici=ici_share, steps=0, tokens=committed)
            if s.adaptive and nd > 0:
                prev = self._accept_ewma.get(req.request_id, 1.0)
                self._accept_ewma[req.request_id] = (
                    (1.0 - s.ewma_beta) * prev + s.ewma_beta * accepted / nd)
            if s.proposer == "draft":
                req.ledger.add_draft_cost(
                    s.draft_cfg, L, int(prop.n_catchup[slot]),
                    max(nd - 1, 0), n_active)
        vph.add(wall_s=t1 - t0, steps=1, tokens=0)

    def _preempt(self, req: Request) -> None:
        # the draft proposer's mirrored slot goes with the target's; it
        # re-admits (re-prefilling the committed context) on resume
        self.proposer.release(req)
        super()._preempt(req)

    def export_request(self, req: Request, link: str = "dcn") -> Request:
        # a running target's mirrored proposer slot is freed here (a
        # preempted one was released at preemption); the acceptance EWMA
        # leaves with the request, and the destination's proposer
        # re-admits from the committed context
        if req.state is RequestState.RUNNING:
            self.proposer.release(req)
        self._accept_ewma.pop(req.request_id, None)
        return super().export_request(req, link=link)

    def step(self) -> List[Request]:
        done = super().step()
        for req in done:
            self.proposer.release(req)
            self._accept_ewma.pop(req.request_id, None)
        return done
