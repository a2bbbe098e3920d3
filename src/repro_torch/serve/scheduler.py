"""Continuous-batching scheduler with a per-request decode roofline ledger.

Requests move WAITING -> PREFILL -> RUNNING -> FINISHED, with a
PREEMPTED detour when the block pool runs dry.  Each engine step:

1. *admit*: resume preempted requests first (swap-in or recompute
   re-prefill), then admit waiting requests into free slots while the pool
   can back the PROMPT plus a free-page watermark; slots then grow one
   page at a time as decode crosses page boundaries.
2. *prefill*: every PREFILL request advances one chunk of at most
   ``prefill_chunk`` tokens (0 = the whole prompt), starting past any
   prefix the pool's content-hash index already holds.
3. *decode*: one step over the packed slot batch produces the next token
   for every RUNNING request; when a slot cannot grow, the newest-admitted
   running request is preempted (pages swapped to host memory, or dropped
   for recompute) and re-queued ahead of all waiting work.

Decode roofline ledger: one generated token at context length ``L`` does
``W(L) = 2 * N_active + 4 * H * hd * L * n_attn_blocks`` FLOPs and moves
``Q(L) = params_bytes / B_active + (L + 1) * kv_line_bytes`` HBM bytes;
each request accumulates W and Q and folds them into RooflineTerms.  A
speculative verify step (serve/spec.py) scores k+1 tokens for one weight
read (:meth:`RooflineLedger.add_verify_step`).
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import functools
import math
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..core.roofline.hardware import H100_SXM, ChipSpec, tp_scope
from ..core.roofline.model import PhaseTraffic, RooflineTerms, make_terms
from ..kernels import quantize as kvq
from ..kernels.paged_attention import gqa_onchip_bytes, mla_onchip_bytes
from ..models.common import ModelConfig, model_flops, param_counts
from ..models.params import torch_dtype
from ..obs.clock import now
from ..obs.trace import LIFECYCLE_TID, SLOT_TID0
from .kv_cache import PagedKVCache


# --------------------------------------------------------------------------
# Analytic per-token decode cost model
# --------------------------------------------------------------------------

def _dtype_bytes(dtype: str) -> int:
    return torch_dtype(dtype).itemsize


def _kv_store_isize(cfg: ModelConfig) -> int:
    """Itemsize KV pages are stored at (the quantized storage type when
    cfg.kv_dtype != bf16, else the activation dtype)."""
    return kvq.store_itemsize(cfg.kv_dtype, cfg.dtype)


def _kv_scale_isize(cfg: ModelConfig) -> int:
    """Per-line float32 scale bytes a quantized pool adds (0 for bf16)."""
    return 4 if kvq.is_quantized(cfg.kv_dtype) else 0


@functools.lru_cache(maxsize=None)
def kv_line_bytes(cfg: ModelConfig) -> int:
    """Bytes of growing cache per token summed over all layers: the KV
    line read once per context token per decode step.  Quantized pools
    shrink the value bytes to the storage itemsize and add the float32
    scales the page walk streams beside them: one per kv head for GQA (k
    and v each), two per line for MLA (latent and rope)."""
    isize = _kv_store_isize(cfg)
    s = _kv_scale_isize(cfg)
    total = 0
    for unit, reps in cfg.segments():
        for b in unit:
            if b.mixer == "attn":
                total += 2 * cfg.n_kv_heads * (cfg.hd * isize + s) * reps
            elif b.mixer == "mla":
                total += ((cfg.kv_lora_rank + cfg.rope_head_dim) * isize
                          + 2 * s) * reps
    return total


@functools.lru_cache(maxsize=None)
def state_bytes(cfg: ModelConfig) -> int:
    """Bytes of one slot's O(1) recurrent state summed over all layers
    (mamba h and conv tail, mLSTM C / n / m and conv tail, sLSTM c / n /
    h / m): read and written once per decode step."""
    isize = _dtype_bytes(cfg.dtype)
    di = cfg.d_inner
    total = 0
    for unit, reps in cfg.segments():
        for b in unit:
            if b.mixer == "mamba":
                total += (di * cfg.mamba_d_state * 4
                          + (cfg.mamba_conv_width - 1) * di * isize) * reps
            elif b.mixer == "mlstm":
                d2 = 2 * cfg.d_model
                hd = d2 // cfg.n_heads
                total += (cfg.n_heads * (hd * hd + hd + 1) * 4
                          + (cfg.mamba_conv_width - 1) * d2 * isize) * reps
            elif b.mixer == "slstm":
                total += 4 * cfg.d_model * 4 * reps
    return total


@functools.lru_cache(maxsize=None)
def params_bytes_active(cfg: ModelConfig) -> float:
    """Weight bytes touched per decode step (active params only)."""
    return param_counts(cfg)["active"] * _dtype_bytes(cfg.dtype)


def decode_token_flops(cfg: ModelConfig, context_len: int) -> float:
    """W for one generated token at context length ``context_len``."""
    return model_flops(cfg, context_len, 1, "decode")


def decode_token_bytes(cfg: ModelConfig, context_len: int,
                       active_batch: int) -> float:
    """Q for one generated token: amortized weight read + this request's
    KV line reads and its one write + its recurrent state, read and
    written once."""
    weights = params_bytes_active(cfg) / max(active_batch, 1)
    kv = (context_len + 1) * kv_line_bytes(cfg)
    return weights + kv + 2 * state_bytes(cfg)


def attn_kernel_vmem_bytes(cfg: ModelConfig, context_len: int,
                           page_size: int, n_q: int = 1,
                           pipeline: str = "off") -> float:
    """On-chip traffic of one slot's paged-attention calls summed over all
    attention/MLA layers, for ``n_q`` query tokens (1 = decode, k+1 =
    verify): the bytes the CUDA kernel that ``cfg.dtype``, ``cfg.kv_dtype``
    and ``pipeline`` dispatch to moves between L2 and the SMs
    (kernels/paged_attention.py ``gqa_onchip_bytes`` /
    ``mla_onchip_bytes``: staged lines and scales, query rows per block,
    split-K partials and the merge, the output), whatever device the
    engine runs on, as the reference's ledger priced its Pallas kernel
    whatever the backend."""
    kw = dict(page_size=page_size, isize=_dtype_bytes(cfg.dtype),
              kv_isize=_kv_store_isize(cfg),
              quantized=kvq.is_quantized(cfg.kv_dtype), n_q=n_q,
              pipeline=pipeline)
    total = 0.0
    for unit, reps in cfg.segments():
        for b in unit:
            if b.mixer == "attn":
                total += reps * gqa_onchip_bytes(
                    context_len, kv_heads=cfg.n_kv_heads,
                    groups=cfg.n_heads // cfg.n_kv_heads, head_dim=cfg.hd,
                    **kw)
            elif b.mixer == "mla":
                total += reps * mla_onchip_bytes(
                    context_len, n_heads=cfg.n_heads,
                    lora_rank=cfg.kv_lora_rank, rope_dim=cfg.rope_head_dim,
                    **kw)
    return total


def decode_token_vmem_bytes(cfg: ModelConfig, context_len: int,
                            active_batch: int, page_size: int,
                            pipeline: str = "off") -> float:
    """On-chip bytes for one generated token: the amortized weight read
    and the recurrent state traffic pass through once, and the
    paged-attention kernel adds its own (:func:`attn_kernel_vmem_bytes`)."""
    return (params_bytes_active(cfg) / max(active_batch, 1)
            + 2 * state_bytes(cfg)
            + attn_kernel_vmem_bytes(cfg, context_len, page_size,
                                     pipeline=pipeline))


def verify_step_vmem_bytes(cfg: ModelConfig, context_len: int, n_fed: int,
                           active_batch: int, page_size: int,
                           pipeline: str = "off") -> float:
    """On-chip bytes for one slot's multi-token verification step: one
    weight pass-through scores ``n_fed`` tokens sharing one call of the
    verify kernel (:func:`attn_kernel_vmem_bytes` at ``n_q = n_fed``);
    the recurrent state term is the reference's, though speculation runs
    on attention / MLA archs only."""
    return (params_bytes_active(cfg) / max(active_batch, 1)
            + 2 * state_bytes(cfg)
            + attn_kernel_vmem_bytes(cfg, context_len, page_size,
                                     n_q=n_fed, pipeline=pipeline))


def slot_swap_bytes(cfg: ModelConfig, n_blocks: int, page_size: int) -> float:
    """Host-link bytes to park (or restore) one slot: its physical pages
    across every paged cache leaf plus its recurrent state rows — the
    analytic prediction serve/crosscheck.crosscheck_host holds against the
    walk of the gather-and-pack ``PagedKVCache.swap_out`` runs."""
    return float(n_blocks * page_size * kv_line_bytes(cfg)
                 + state_bytes(cfg))


@functools.lru_cache(maxsize=None)
def kv_shard_fraction(cfg: ModelConfig, tp: int) -> float:
    """Share of the per-token KV line each card holds at tensor-parallel
    width ``tp``: GQA k/v pools (and their per-(line, kv_head) scales)
    shard over kv_heads, MLA latent pools replicate (serve/shard.py
    ``pool_pspecs``), so every card walks the whole compressed cache.
    Feeds the per-card HBM term of :meth:`RooflineLedger.terms`."""
    if tp <= 1:
        return 1.0
    total = kv_line_bytes(cfg)
    if total == 0:
        return 1.0
    isize = _kv_store_isize(cfg)
    s = _kv_scale_isize(cfg)
    sharded = 0
    for unit, reps in cfg.segments():
        for b in unit:
            if b.mixer == "attn":
                sharded += 2 * cfg.n_kv_heads * (cfg.hd * isize + s) * reps
    return (sharded / tp + (total - sharded)) / total


@functools.lru_cache(maxsize=None)
def decode_collective_count(cfg: ModelConfig) -> int:
    """All-reduces per tensor-parallel decode step: one per row-parallel
    matmul epilogue, the attention / MLA o-projection and the dense-FFN
    down-projection (parallel/collectives.py ``row_parallel_psum``)."""
    n = 0
    for unit, reps in cfg.segments():
        for b in unit:
            if b.mixer in ("attn", "mla"):
                n += reps
            if b.ffn == "dense":
                n += reps
    return n


def decode_step_ici_bytes(cfg: ModelConfig, batch: int, tp: int,
                          n_tokens: int = 1) -> float:
    """Per-card wire bytes of ONE tensor-parallel step over ``batch`` slots
    feeding ``n_tokens`` tokens each (1 for decode, k + 1 for verify).
    Each of the :func:`decode_collective_count` all-reduces moves a
    (batch, n_tokens, d_model) activation at the ring cost ``2 x payload x
    (tp-1)/tp``; an untied vocab-sharded head adds one tiled all-gather of
    the logits at ``payload x (tp-1)/tp``.  serve/crosscheck.py
    ``crosscheck_collectives`` holds it against the collectives a step
    dispatches."""
    if tp <= 1:
        return 0.0
    isize = _dtype_bytes(cfg.dtype)
    ring = (tp - 1) / tp
    act_payload = batch * n_tokens * cfg.d_model * isize
    wire = decode_collective_count(cfg) * 2.0 * act_payload * ring
    if not cfg.tie_embeddings:
        wire += batch * n_tokens * cfg.vocab_size * isize * ring
    return wire


# --------------------------------------------------------------------------
# Requests + ledger
# --------------------------------------------------------------------------

class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"


@dataclasses.dataclass
class RooflineLedger:
    """Per-request W/Q accounting, folded into RooflineTerms at the end.

    Speculative decoding splits the decode stream: *verify* steps charge
    W and Q like decode (``decode_flops`` / ``decode_bytes`` — one weight
    read scores k+1 tokens) and count in ``weight_passes``; *draft* work
    on the proposer goes to ``draft_flops`` / ``draft_bytes`` (overhead,
    not target throughput).  ``acceptance_rate`` is accepted / proposed
    drafts.  ``preemptions`` counts evictions under pool pressure,
    ``swap_bytes`` the host<->device swap traffic,
    ``prefix_cached_tokens`` the prompt tokens admission found already in
    the prefix index, ``pages_peak`` the most physical pages the request
    held.  ``decode_ici_bytes`` is the per-card card-to-card wire traffic
    the tensor-parallel engine charged (0 on one card).  The migration
    fields count cross-replica moves (serve/cluster.py): each packs the
    slot's pages into one SwapSnapshot on the source replica and restores
    it into the destination's pool; the bytes ride ``migration_link``
    ("dcn" across replica groups, "ici" inside a node)."""
    prefill_flops: float = 0.0
    decode_flops: float = 0.0
    decode_bytes: float = 0.0
    decode_kv_bytes: float = 0.0     # KV-walk + state share of decode_bytes
    decode_vmem_bytes: float = 0.0   # on-chip traffic (stream + resident)
    decode_ici_bytes: float = 0.0    # per-card tensor-parallel wire bytes
    decode_tokens: int = 0
    decode_batch_sum: int = 0        # sum of co-resident batch sizes
    weight_passes: int = 0           # target forward passes (decode+verify)
    draft_flops: float = 0.0         # proposer-side work (draft model)
    draft_bytes: float = 0.0
    proposed: int = 0                # draft tokens offered for verification
    accepted: int = 0                # draft tokens that survived
    preemptions: int = 0
    swap_bytes: float = 0.0
    prefix_cached_tokens: int = 0
    pages_peak: int = 0
    migrations: int = 0              # replica-to-replica moves
    migration_bytes: float = 0.0     # packed-snapshot bytes moved
    migration_pages: int = 0         # physical pages those snapshots held
    migration_link: str = "dcn"      # wire level that carried them

    def add_decode_token(self, cfg: ModelConfig, context_len: int,
                         active_batch: int, vmem_bytes: float = 0.0,
                         ici_bytes: float = 0.0) -> None:
        """``ici_bytes``: this request's share of the step's collective
        wire bytes (``decode_step_ici_bytes / active_batch``)."""
        self.decode_flops += decode_token_flops(cfg, context_len)
        self.decode_bytes += decode_token_bytes(cfg, context_len,
                                                active_batch)
        self.decode_kv_bytes += ((context_len + 1) * kv_line_bytes(cfg)
                                 + 2 * state_bytes(cfg))
        self.decode_vmem_bytes += vmem_bytes
        self.decode_ici_bytes += ici_bytes
        self.decode_tokens += 1
        self.decode_batch_sum += active_batch
        self.weight_passes += 1

    def add_verify_step(self, cfg: ModelConfig, context_len: int,
                        n_fed: int, n_committed: int, n_accepted: int,
                        n_proposed: int, active_batch: int,
                        vmem_bytes: float = 0.0,
                        ici_bytes: float = 0.0) -> None:
        """One multi-token verification step: ``n_fed`` = k+1 tokens scored
        in one weight pass at context ``context_len``; ``n_committed``
        tokens entered the request (``n_accepted`` of them surviving
        drafts).  W: fed token t attends ``context_len + t`` keys.  Q: ONE
        amortized weight read and one page walk over the context plus the
        just-written lines (read ``context_len + n_fed - 1``, write
        ``n_fed``) plus the recurrent state read and written once, so W
        scales by n_fed while Q barely moves."""
        line = kv_line_bytes(cfg)
        self.decode_flops += sum(
            decode_token_flops(cfg, context_len + t) for t in range(n_fed))
        self.decode_bytes += (params_bytes_active(cfg) / max(active_batch, 1)
                              + (context_len + 2 * n_fed - 1) * line
                              + 2 * state_bytes(cfg))
        self.decode_kv_bytes += ((context_len + 2 * n_fed - 1) * line
                                 + 2 * state_bytes(cfg))
        self.decode_vmem_bytes += vmem_bytes
        self.decode_ici_bytes += ici_bytes
        self.decode_tokens += n_committed
        self.decode_batch_sum += n_committed * active_batch
        self.weight_passes += 1
        self.proposed += n_proposed
        self.accepted += n_accepted

    def add_draft_cost(self, draft_cfg: ModelConfig, context_len: int,
                       n_fed: int, n_decodes: int, active_batch: int
                       ) -> None:
        """Proposer-side work for one round on a draft model: a catch-up
        pass over ``n_fed`` tokens (the previous round's commits, one
        weight pass) plus ``n_decodes`` single-token draft steps."""
        line = kv_line_bytes(draft_cfg)
        w = params_bytes_active(draft_cfg) / max(active_batch, 1)
        self.draft_flops += sum(
            decode_token_flops(draft_cfg, context_len + t)
            for t in range(n_fed + n_decodes))
        self.draft_bytes += (
            w + (context_len + 2 * n_fed - 1) * line
            + n_decodes * (w + (context_len + n_fed + n_decodes) * line))

    @property
    def mean_batch(self) -> float:
        return self.decode_batch_sum / max(self.decode_tokens, 1)

    @property
    def tokens_per_pass(self) -> float:
        """Tokens committed per target weight pass (1.0 for sequential
        decode; the speculative yield otherwise)."""
        return self.decode_tokens / max(self.weight_passes, 1)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)

    @property
    def arithmetic_intensity(self) -> float:
        return self.decode_flops / max(self.decode_bytes, 1.0)

    def terms(self, cfg: ModelConfig, chip: ChipSpec = H100_SXM,
              n_chips: int = 1) -> RooflineTerms:
        """RooflineTerms for this request's decode stream: HBM from the
        decode bytes, ``vmem`` from the on-chip pricing, ``host`` from the
        swap bytes, ``ici`` from the charged collective bytes, the decode
        FLOPs as the model FLOPs.

        ``n_chips`` > 1 is the tensor-parallel scope (``tp_scope``): the
        weight read and the FLOPs split evenly over the cards, the KV
        share by :func:`kv_shard_fraction` (GQA pools shard, MLA latent
        pools replicate), the on-chip bytes as HBM's, the swap bytes as
        the pools', and ``decode_ici_bytes`` is already per card.

        Migration bytes land on their carrying wire level
        (``migration_link``) and in ``migration_bytes_dev`` (each card
        ships its pool shard), so the terms grow a ``migration`` roof
        (RooflineTerms.roofs) that can out-bind decode bandwidth on a
        migration-heavy workload."""
        n = max(n_chips, 1)
        frac = kv_shard_fraction(cfg, n)
        hbm_dev = ((self.decode_bytes - self.decode_kv_bytes) / n
                   + self.decode_kv_bytes * frac)
        vmem_dev = (self.decode_vmem_bytes * hbm_dev
                    / max(self.decode_bytes, 1.0))
        mig_dev = self.migration_bytes * frac
        on_ici = self.migration_link == "ici"
        return make_terms(
            scope=tp_scope(chip, n), dtype=cfg.dtype,
            flops_dev=self.decode_flops / n, hbm_bytes_dev=hbm_dev,
            ici_wire_bytes_dev=self.decode_ici_bytes + (mig_dev if on_ici
                                                        else 0.0),
            dcn_wire_bytes_dev=0.0 if on_ici else mig_dev,
            vmem_bytes_dev=vmem_dev,
            host_bytes_dev=self.swap_bytes * frac,
            migration_bytes_dev=mig_dev,
            migration_link=self.migration_link,
            model_flops_total=self.decode_flops)

    def add(self, other: "RooflineLedger") -> None:
        """Fold ``other`` into this ledger: every count sums; the link
        is carried from a ledger that migrated (it names a wire, it does
        not add)."""
        for f in dataclasses.fields(RooflineLedger):
            v = getattr(other, f.name)
            if isinstance(v, str):
                if other.migration_bytes > 0:
                    setattr(self, f.name, v)
                continue
            setattr(self, f.name, getattr(self, f.name) + v)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                       # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0                       # nucleus mass (0 / >=1 = off)
    stop_token: Optional[int] = None
    seed: Optional[int] = None               # sampling stream; None = greedy
    request_id: int = 0

    state: RequestState = RequestState.WAITING
    slot: int = -1
    prefill_pos: int = 0                     # fill tokens already prefilled
    generated: List[int] = dataclasses.field(default_factory=list)
    finish_reason: str = ""
    ledger: RooflineLedger = dataclasses.field(default_factory=RooflineLedger)
    admit_seq: int = -1                      # admission order (victim pick)
    prefill_skip: int = 0                    # fill tokens prefix-cache hit
    # recompute-on-resume re-prefills prefill_src (the context at
    # preemption); swap-on-resume restores swap_snapshot instead
    prefill_src: Optional[np.ndarray] = None
    swap_snapshot: Optional[Any] = None
    # wall-clock stamps (obs.clock.now): submit (at the engine, or at a
    # Router's front door), the router -> replica hand-off (0.0: no
    # router crossed), first slot placement, end of the last prefill
    # chunk, one per committed token (speculative commits share one
    # stamp), so TTFT telescopes into queue wait + prefill + first
    # decode (ttft_breakdown)
    submit_time: float = 0.0
    dispatch_time: float = 0.0
    prefill_start_time: float = 0.0
    prefill_end_time: float = 0.0
    token_times: List[float] = dataclasses.field(default_factory=list)
    # cross-replica migration (serve/cluster.py): True between
    # Scheduler.detach on the source and the restore on the destination,
    # which then charges phase "migrate" instead of "swap"
    migrating: bool = False

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def fill_tokens(self) -> np.ndarray:
        """Tokens the prefill phase must feed: the prompt, or after a
        recompute preemption the whole context at preemption."""
        return self.prompt if self.prefill_src is None else self.prefill_src

    @property
    def ttft(self) -> float:
        """Time to first token (s); NaN before the first commit."""
        if not self.token_times:
            return float("nan")
        return self.token_times[0] - self.submit_time

    def ttft_breakdown(self) -> Dict[str, float]:
        """TTFT split into its three telescoping segments:

            queue_wait_s   = prefill_start_time - submit_time
            prefill_s      = prefill_end_time - prefill_start_time
            first_decode_s = token_times[0] - prefill_end_time

        The stamps bracket each other (submit -> first placement -> the
        synchronize after the last prefill chunk -> first commit), so the
        segments sum to :attr:`ttft` with no residual.  NaNs before the
        first commit."""
        if not self.token_times:
            nan = float("nan")
            return {"queue_wait_s": nan, "prefill_s": nan,
                    "first_decode_s": nan}
        return {
            "queue_wait_s": self.prefill_start_time - self.submit_time,
            "prefill_s": self.prefill_end_time - self.prefill_start_time,
            "first_decode_s": self.token_times[0] - self.prefill_end_time,
        }

    def latency_stats(self) -> Dict[str, float]:
        """TTFT and inter-token latency percentiles for this request."""
        gaps = np.diff(np.asarray(self.token_times))
        return {
            "ttft_s": self.ttft,
            "itl_p50_s": float(np.percentile(gaps, 50)) if gaps.size else
            float("nan"),
            "itl_p95_s": float(np.percentile(gaps, 95)) if gaps.size else
            float("nan"),
            "n_tokens": float(len(self.token_times)),
        }

    @property
    def context_len(self) -> int:
        return self.prompt_len + len(self.generated)

    @property
    def budget(self) -> int:
        return self.prompt_len + self.max_new_tokens

    @property
    def tokens(self) -> np.ndarray:
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])


class Scheduler:
    """Admission + queue bookkeeping over a :class:`PagedKVCache`.

    ``watermark`` is the fraction of the pool admission must leave
    obtainable after backing a new prompt; ``preempt_mode`` is what
    :meth:`preempt` does with a victim's pages: ``"swap"`` parks them in
    host memory, ``"recompute"`` drops them and re-prefills on resume."""

    def __init__(self, cfg: ModelConfig, kv: PagedKVCache,
                 prefill_chunk: int = 0, watermark: float = 0.0,
                 preempt_mode: str = "swap"):
        if preempt_mode not in ("swap", "recompute"):
            raise ValueError(f"unknown preempt_mode {preempt_mode!r}")
        self.cfg = cfg
        self.kv = kv
        self.prefill_chunk = prefill_chunk
        self.watermark = watermark
        self.preempt_mode = preempt_mode
        self.waiting: Deque[Request] = collections.deque()
        self.preempted: List[Request] = []            # resume-priority queue
        self.active: Dict[int, Request] = {}          # slot -> request
        self.finished: List[Request] = []
        self.preempt_count = 0
        self._next_id = 0
        self._admit_seq = 0
        # per-phase traffic + synchronized wall time (keys: prefill /
        # decode / verify / draft / swap; the engines charge the compute
        # phases, preempt and _resume the swap phase)
        self.phases: Dict[str, PhaseTraffic] = collections.defaultdict(
            PhaseTraffic)
        # telemetry bundle and trace process id, threaded in by the owning
        # engine (obs.Telemetry, or None = telemetry off)
        self.obs = None
        self.obs_pid = 0

    def reset_phases(self) -> None:
        """Drop accumulated phase traffic (after warm-up, before a timed
        window: capture and kernel builds must not pollute the budget)."""
        self.phases.clear()

    @property
    def watermark_pages(self) -> int:
        return int(math.ceil(self.watermark * (self.kv.num_pages - 1)))

    def submit(self, req: Request, keep_id: bool = False) -> Request:
        """Queue a request.  ``keep_id`` keeps a caller-assigned id (a
        Router stamps cluster-unique ids before dispatch) and moves the
        local counter past it, so direct submits never collide."""
        if keep_id:
            self._next_id = max(self._next_id, req.request_id + 1)
        else:
            req.request_id = self._next_id
            self._next_id += 1
        req.state = RequestState.WAITING
        self.waiting.append(req)
        return req

    def has_work(self) -> bool:
        return bool(self.waiting or self.preempted or self.active)

    # -- phases ------------------------------------------------------------

    def _place(self, req: Request, slot: int, prefilling: bool) -> None:
        req.slot = slot
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        self.active[slot] = req
        if prefilling:
            req.state = RequestState.PREFILL
            req.prefill_pos = self.kv.prefix_cached_tokens(slot)
            req.prefill_skip = req.prefill_pos
            req.ledger.prefix_cached_tokens = max(
                req.ledger.prefix_cached_tokens, req.prefill_pos)
        else:
            req.state = RequestState.RUNNING
        if req.prefill_start_time == 0.0:
            req.prefill_start_time = now()
        req.ledger.pages_peak = max(req.ledger.pages_peak,
                                    self.kv.slot_pages(slot))
        if self.obs is not None:
            self.obs.tracer.instant(
                "place", self.obs_pid, LIFECYCLE_TID, now(),
                request=req.request_id, slot=slot, prefilling=prefilling)

    def _resume(self, req: Request) -> bool:
        """Bring one preempted request back; False if it does not fit."""
        if req.swap_snapshot is not None:
            snap = req.swap_snapshot
            if (not self.kv.free_slot_count
                    or self.kv.swap_in_pages_needed(snap)
                    > self.kv.available_page_count):
                return False
            t0 = now()
            slot = self.kv.swap_in(snap)
            if slot is None:
                return False
            self.kv.synchronize()
            t1 = now()
            if req.migrating:
                # the restore leg of a migration: the wire bytes were
                # charged at detach; the copy in is this replica's host
                # traffic, phase "migrate"
                self.phases["migrate"].add(host=float(snap.nbytes),
                                           wall_s=t1 - t0)
                req.migrating = False
                if self.obs is not None:
                    self.obs.tracer.span(
                        "migrate_in", self.obs_pid, SLOT_TID0 + slot, t0,
                        t1, request=req.request_id, bytes=int(snap.nbytes))
                    self.obs.tracer.flow_finish(
                        "migrate", self.obs_pid, SLOT_TID0 + slot,
                        req.request_id, t1)
            else:
                self.phases["swap"].add(host=float(snap.nbytes),
                                        wall_s=t1 - t0)
                req.ledger.swap_bytes += snap.nbytes
                if self.obs is not None:
                    self.obs.tracer.span(
                        "swap_in", self.obs_pid, SLOT_TID0 + slot, t0, t1,
                        request=req.request_id, bytes=int(snap.nbytes))
            req.swap_snapshot = None
            self._place(req, slot, prefilling=False)
            return True
        fill = req.fill_tokens
        if not self.kv.can_admit_tokens(fill, self.watermark_pages):
            return False
        slot = self.kv.alloc(len(fill), budget=req.budget, tokens=fill)
        if slot is None:
            return False
        self._place(req, slot, prefilling=True)
        return True

    def admit(self) -> List[Request]:
        """Resume preempted requests first (FIFO by arrival), then admit
        waiting requests while a slot, the prompt's pages and the
        watermark are obtainable."""
        admitted = []
        self.preempted.sort(key=lambda r: r.request_id)
        while self.preempted and self._resume(self.preempted[0]):
            admitted.append(self.preempted.pop(0))
        if self.preempted:
            return admitted                 # do not admit past the queue
        while self.waiting:
            req = self.waiting[0]
            fill = req.fill_tokens
            if not self.kv.can_admit_tokens(fill, self.watermark_pages):
                break
            slot = self.kv.alloc(len(fill), budget=req.budget, tokens=fill)
            if slot is None:
                break
            self.waiting.popleft()
            self._place(req, slot, prefilling=True)
            admitted.append(req)
        return admitted

    def preempt(self, req: Request) -> None:
        """Evict a running request under pool pressure: swap its pages to
        host memory, or (recompute mode, or mid-prefill) drop them after
        snapshotting its committed context for re-prefill."""
        if req.state not in (RequestState.PREFILL, RequestState.RUNNING):
            raise ValueError(f"cannot preempt a {req.state.value} request")
        del self.active[req.slot]
        if self.preempt_mode == "swap" and req.state is RequestState.RUNNING:
            t0 = now()
            snap = self.kv.swap_out(req.slot)     # ends in the host copy
            t1 = now()
            self.phases["swap"].add(host=float(snap.nbytes),
                                    wall_s=t1 - t0)
            req.swap_snapshot = snap
            req.ledger.swap_bytes += snap.nbytes
            if self.obs is not None:
                self.obs.tracer.span(
                    "swap_out", self.obs_pid, SLOT_TID0 + req.slot, t0, t1,
                    request=req.request_id, bytes=int(snap.nbytes))
        else:
            req.prefill_src = req.tokens
            self.kv.free(req.slot)
        req.slot = -1
        req.state = RequestState.PREEMPTED
        req.ledger.preemptions += 1
        self.preempt_count += 1
        self.preempted.append(req)
        if self.obs is not None:
            self.obs.tracer.instant(
                "preempt", self.obs_pid, LIFECYCLE_TID, now(),
                request=req.request_id, mode=self.preempt_mode)

    def detach(self, req: Request, link: str = "dcn") -> Request:
        """Take a request off this replica for migration to another
        (serve/cluster.py): pack its pages into one :class:`SwapSnapshot`
        if it holds a slot (the swap path's single copy to host), or
        adopt the snapshot a preemption already parked, and charge the
        packed bytes to the migration ledger as wire traffic on ``link``.
        The caller hands the request to the destination's :meth:`attach`.
        A recompute-mode preemptee carries tokens, not pages: it moves
        for free (the destination re-prefills it)."""
        if req.state not in (RequestState.RUNNING, RequestState.PREEMPTED):
            raise ValueError(f"cannot migrate a {req.state.value} request")
        if req.state is RequestState.RUNNING:
            del self.active[req.slot]
            t0 = now()
            snap = self.kv.swap_out(req.slot)     # ends in the host copy
            wall = now() - t0
            if self.obs is not None:
                self.obs.tracer.span(
                    "migrate_out", self.obs_pid, SLOT_TID0 + req.slot, t0,
                    t0 + wall, request=req.request_id,
                    bytes=int(snap.nbytes))
            req.swap_snapshot = snap
            req.slot = -1
            req.state = RequestState.PREEMPTED
        else:
            if req in self.preempted:
                self.preempted.remove(req)
            snap = req.swap_snapshot          # its copy was charged as swap
            wall = 0.0
            if snap is None:                  # recompute-mode preemptee
                return req
        req.migrating = True
        req.ledger.migrations += 1
        req.ledger.migration_bytes += float(snap.nbytes)
        req.ledger.migration_pages += int(snap.n_blocks)
        req.ledger.migration_link = link
        self.phases["migrate"].add(host=float(snap.nbytes), wall_s=wall,
                                   **{link: float(snap.nbytes)})
        if self.obs is not None:
            self.obs.tracer.flow_start(
                "migrate", self.obs_pid, LIFECYCLE_TID, req.request_id,
                now(), link=link, bytes=int(snap.nbytes))
        return req

    def attach(self, req: Request) -> Request:
        """Adopt a detached request: keep its cluster-unique id clear of
        the local counter and queue it with resume priority.  The next
        :meth:`admit` restores its snapshot into this pool (frozen prefix
        pages found in the local index are aliased, kv_cache.swap_in) or
        re-prefills its context (a recompute-mode preemptee)."""
        self._next_id = max(self._next_id, req.request_id + 1)
        req.state = RequestState.PREEMPTED
        self.preempted.append(req)
        return req

    def preempt_victim(self) -> Optional[Request]:
        """Newest-admitted running request (least sunk decode work)."""
        cands = [r for r in self.active.values()
                 if r.state is RequestState.RUNNING]
        if not cands:
            return None
        return max(cands, key=lambda r: r.admit_seq)

    def prefill_work(self) -> List[Tuple[Request, int, int]]:
        """(request, start, end) chunks to prefill this step."""
        out = []
        for req in self.active.values():
            if req.state is not RequestState.PREFILL:
                continue
            fill_len = len(req.fill_tokens)
            start = req.prefill_pos
            end = fill_len if self.prefill_chunk <= 0 else min(
                fill_len, start + self.prefill_chunk)
            out.append((req, start, end))
        return out

    def decode_requests(self) -> List[Request]:
        return [r for r in self.active.values()
                if r.state is RequestState.RUNNING]

    def finish(self, req: Request, reason: str) -> None:
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.ledger.pages_peak = max(req.ledger.pages_peak,
                                    self.kv.slot_pages(req.slot))
        self.kv.free(req.slot)
        del self.active[req.slot]
        req.slot = -1
        self.finished.append(req)
        if self.obs is not None:
            # the whole request lifetime as one async slice, emitted as a
            # balanced pair at completion (no orphan ids from requests
            # still in flight at export time)
            t_end = now()
            t_begin = req.submit_time if req.submit_time > 0.0 else t_end
            self.obs.tracer.async_begin(
                "request", self.obs_pid, LIFECYCLE_TID, req.request_id,
                t_begin)
            self.obs.tracer.async_end(
                "request", self.obs_pid, LIFECYCLE_TID, req.request_id,
                t_end, tokens=len(req.generated), reason=reason)
