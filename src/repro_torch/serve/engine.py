"""Serving engines: the continuous-batching engine over a paged KV cache,
and the static whole-batch engine.

A fixed bank of decode slots, one decode step whose shapes do not depend
on which slots are live, chunked prefill interleaved with running
decodes, and a per-request roofline ledger (scheduler.py).  A recurrent
mixer's state rows (xlstm, jamba's mamba layers) advance only for the
slots the decode step's active mask marks, and a prefill chunk reads and
writes its slot's rows; both the mask and the slot are persistent inputs
of the captured steps.  On CUDA the
decode step's paged attention is the hand-written kernel
(kernels/paged_attention.py), its page walk chosen by
``EngineConfig.pipeline`` ("off", or "double" for the ring kernels);
sampling runs on the device right after the
logits, so only the (B,) chosen token ids cross to the host.  On CUDA the
decode step (embed, every layer, final norm and logits) is one captured
CUDA graph replayed each step (serve/graphs.py, ``EngineConfig.
cuda_graphs``), the counterpart of the reference's jitted step; so is a
paged prefill chunk, one graph per chunk length, and a length-bucketed
whole-prompt prefill with the scatter of its states, one graph per
bucket (``Engine.prefill_shapes`` records the shapes, as the
reference's jit cache does).  Their inputs (tokens, block-table row,
offset, length) sit in persistent buffers, so the same fixed-shape body
runs graphed or eagerly (CPU, ``cuda_graphs=False``).  Sampling stays
eager, since it draws per row from host-seeded generators, and so does
the unpadded whole-prompt prefill, as the reference does not jit it
either.  Whole-prompt prefill is length-bucketed to the next power of
two where padding cannot change the result (no MoE FFN, whose capacity
the pad tokens would take).  :meth:`Engine.measure_dispatch_overhead` is the
paper's no-kernel run (§2.4): the per-step floor of framework and launch
cost, in the mode (graphed or eager) the engine runs in.

Telemetry (``EngineConfig.telemetry``, off by default; ``obs/``) records
the stamps the engine already takes: the ``decode_step`` span is the two
stamps around the graph replay and the token read-back, the
``prefill_chunk`` span the two around a chunk and its synchronize; the
first decode step, whose graph capture runs inside it, is traced like any
other.  The hooks add no device op, synchronize or read-back.
:meth:`Engine.hierarchy_report` prints the hierarchical and time-based
roofline of the engine's ledger and phases.

Speculative decoding subclasses this engine (serve/spec.py) through two
hooks, :meth:`Engine._kv_margin` and :meth:`Engine._preempt`.  Tensor
parallelism (serve/shard.py) subclasses it through three: the device
steps run ``Engine.step_cfg`` (the shard's local config there, with the
collective edges), the ledger splits W / Q over :meth:`Engine.
_ledger_chips` cards and charges :meth:`Engine._step_collective_bytes`
a step.

:class:`StaticEngine` is the reference's original whole-batch prefill ->
lockstep decode loop over dense caches (``models.init_cache``), kept as
the engine the continuous one is checked against token for token and as
the serving path of the archs with cross-attention caches
(whisper-small, llama-3.2-vision-90b): :meth:`Engine.generate` routes to
it for them, or when given ``enc_embeds`` / ``img_embeds``.  Its prefill
(the encoder and the forward, one row at a time where the reference runs
the batch in one call: on the card a GEMM's bits depend on its row
count, and a row's prefill must equal the continuous engine's) runs
eagerly, as the reference does not jit it either; its decode step is one
captured graph on CUDA (the reference's jitted ``decode_step``) over
persistent token and position buffers and the caches, whose self and
cross decode attention run the hand-written paged-attention kernel
through an identity block table (``models.attention.dense_attention``).
Both engines sample through ``sampling.sample_tokens`` with row ``b`` of
``generate(seed=s)`` drawing from seed ``s + b`` at step index i, so a
static batch samples what the continuous engine's ``generate(seed=s)``
samples on the same prompts.
Token-for-token caveats, the reference's: paged MLA decode is always
absorbed, so for MLA archs the two engines agree byte for byte only with
``cfg.mla_absorb``; an MoE FFN's capacity cutoffs depend on the batch.
On the card the continuous engine pads a whole prompt to its
power-of-two bucket, so byte equality there needs prompts of such a
length (or an arch that is not bucketed).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..core.roofline.hardware import H100_SXM, ChipSpec
from ..device import resolve_device, synchronize
from ..kernels import quantize
from ..kernels.ops import check_pipeline
from ..kernels.paged_attention import (KERNEL_HEAD_DIMS, MLA_LATENT_DIMS,
                                       MLA_ROPE_DIMS)
from ..models import (decode_step, decode_step_paged, init_cache,
                      init_params, prefill, prefill_chunk_paged,
                      prefill_padded, prepare_params)
from ..models.common import ModelConfig, model_flops
from ..models.params import tree_map
from ..models.transformer import check_supported
from ..obs import Telemetry
from ..obs.clock import now
from ..obs.trace import ENGINE_TID, LIFECYCLE_TID, SLOT_TID0
from . import sampling
from .graphs import PrefillInputs, StaticInput, StepGraphs, graphs_enabled
from .kv_cache import PagedKVCache, supports_paging
from .scheduler import (Request, RequestState, RooflineLedger, Scheduler,
                        decode_token_bytes, decode_token_flops,
                        decode_token_vmem_bytes, kv_line_bytes,
                        params_bytes_active)


@dataclasses.dataclass
class GenerateConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0                    # 0 = no top-k filter
    top_p: float = 0.0                # nucleus mass (0 or >= 1 = off)
    stop_token: Optional[int] = None


@dataclasses.dataclass
class EngineConfig:
    num_slots: int = 4                # packed decode batch width
    page_size: int = 16               # tokens per physical KV page
    max_len: int = 256                # per-request context ceiling
    prefill_chunk: int = 0            # 0 = whole prompt in one chunk
    num_pages: Optional[int] = None   # None = fully backed pool
    chip: ChipSpec = H100_SXM         # roofline ledger target hardware
    prefill_bucket: int = 8           # min whole-prompt bucket (0 = off)
    prefix_cache: bool = False        # content-hash prefix sharing + CoW
    watermark: float = 0.0            # admission slack, fraction of pool
    preempt_mode: str = "swap"        # "swap" | "recompute" on pool-dry
    pipeline: str = "off"             # kernel page streaming: "off"|"double"
    # tensor-parallel epilogue schedule (serve/shard.py): "none" blocks on
    # the all-reduce, "ring" runs parallel/collectives.ring_matmul_reduce
    overlap: str = "none"
    device: Union[str, torch.device] = "cuda"   # "cpu" only when asked
    # KV page storage: None keeps the model config's ``kv_dtype``;
    # "bf16"|"int8"|"fp8_e4m3" rewrite it at engine build
    kv_dtype: Optional[str] = None
    # fixed-shape steps as captured CUDA graphs: None = on for CUDA, off
    # for the CPU (True there raises)
    cuda_graphs: Optional[bool] = None
    # observability (obs/): span tracing, metrics and live roofline
    # attainment, observation-only (token streams and launch counts are
    # the same on and off)
    telemetry: bool = False
    telemetry_window: int = 4         # engine steps per attainment window


# the smallest sizes the port's paged-attention kernels take, for the
# fields the reference's no-kernel twin floors below them
KERNEL_FLOORS = {"head_dim": min(KERNEL_HEAD_DIMS),
                 "kv_lora_rank": min(MLA_LATENT_DIMS),
                 "rope_head_dim": min(MLA_ROPE_DIMS)}


def no_kernel_cfg(cfg: ModelConfig) -> ModelConfig:
    """A degenerate twin of ``cfg``: identical layer count, block pattern
    and paged-cache structure, every tensor dimension floored, so the
    decode step runs the same op graph with near-zero kernel work and its
    synchronized wall IS the per-step framework and launch floor (the
    paper's no-kernel run).  The reference's floors, except three the
    port's CUDA kernels refuse (``KERNEL_FLOORS``): ``head_dim`` is raised
    to the GQA kernels' smallest head dim (16), ``kv_lora_rank`` to the
    MLA kernels' smallest latent rank (32) and ``rope_head_dim`` to their
    smallest rope dim (8), never above ``cfg``'s own, so the twin's step
    launches the same hand-written kernels as the real one."""
    shrink = {"d_model": 8, "n_heads": 1, "n_kv_heads": 1,
              "head_dim": 8, "d_ff": 8, "vocab_size": 32,
              "moe_d_ff": 8, "q_lora_rank": 8, "kv_lora_rank": 8,
              "rope_head_dim": 4, "nope_head_dim": 8, "v_head_dim": 8}
    updates = {k: v for k, v in shrink.items()
               if getattr(cfg, k) > v}
    twin = dataclasses.replace(cfg, name=cfg.name + "-nokernel",
                               **updates)
    own = {"head_dim": cfg.hd, "kv_lora_rank": cfg.kv_lora_rank,
           "rope_head_dim": cfg.rope_head_dim}
    got = {"head_dim": twin.hd, "kv_lora_rank": twin.kv_lora_rank,
           "rope_head_dim": twin.rope_head_dim}
    raised = {k: min(own[k], floor) for k, floor in KERNEL_FLOORS.items()
              if 0 < got[k] < floor}
    return dataclasses.replace(twin, **raised)


def _bucket_len(n: int, floor: int) -> int:
    """Next power of two >= n (but >= floor)."""
    return max(floor, 1 << max(n - 1, 0).bit_length())


def bucket_prefill_body(params, cfg: ModelConfig, kv: PagedKVCache,
                        inputs: PrefillInputs, S: int) -> torch.Tensor:
    """A whole prompt padded to ``S`` tokens (``inputs.tokens(S)``,
    ``inputs.length`` real ones) prefilled and its states scattered into
    the pages of the table row ``inputs.row`` (pad positions on the trash
    page): the body of an engine's or a draft model's ``prefill_bucket:S``
    step.  Returns the last real token's logits (1, V)."""
    last, states = prefill_padded(params, cfg, inputs.tokens(S).tensor,
                                  inputs.length.tensor)
    kv.scatter_prefill_states(inputs.row.tensor, states, 0,
                              inputs.length.tensor)
    return last


def _place_prefill_states(caches: List[Any], states: List[Any],
                          row: int = 0) -> None:
    """Copy collected per-layer states (reps, n, ...) into rows ``row`` ..
    ``row + n - 1`` of the dense caches, in place: a recurrent state
    replaces the rows' state, attention lines (reps, n, S, ...) and cross
    lines (reps, n, S_src, ...) take the prefix of the rounded axis."""
    def merge(c, s):
        c[(slice(None), slice(row, row + s.shape[1]))
          + tuple(slice(0, n) for n in s.shape[2:])].copy_(s)
    tree_map(merge, caches, states)


class StaticEngine:
    """Prefill (row by row) -> lockstep decode of the whole batch over
    dense caches (the reference's original engine).  Runs where
    ``params`` live; on CUDA the decode step replays a captured graph
    unless ``cuda_graphs`` is False."""

    def __init__(self, cfg: ModelConfig, params,
                 cuda_graphs: Optional[bool] = None):
        check_supported(cfg)
        self.cfg = cfg
        self.params = prepare_params(params, cfg)
        self.device = params["embed"]["tok"].device
        self.graphs = graphs_enabled(cuda_graphs, self.device)
        # the last generate()'s caches and captured decode step, kept
        # together (a graph replayed over freed caches would write into
        # memory reused since) until the next generate() drops them
        self._caches: Optional[List[Any]] = None
        self._graphs: Optional[StepGraphs] = None
        # the last generate()'s host timings: prefill (s), every decode
        # step (s, graph capture included in the first on CUDA)
        self.prefill_s = 0.0
        self.decode_s: List[float] = []

    @torch.no_grad()
    def generate(self, prompts, gen: GenerateConfig, enc_embeds=None,
                 img_embeds=None, seed: Optional[int] = None
                 ) -> Dict[str, Any]:
        """prompts (B, S) int (equal lengths) -> {"tokens" (B, S+new),
        "finished" (B,)} numpy arrays.  ``enc_embeds`` (B, frames, D) /
        ``img_embeds`` (B, n_img, D) feed an encoder-decoder / vision
        model.  Row ``b`` samples with seed ``seed + b`` when a seed is
        given, else greedily."""
        cfg, dev = self.cfg, self.device
        prompts_np = np.asarray(prompts, np.int64)
        B, S = prompts_np.shape
        self._caches = self._graphs = None
        caches = self._caches = init_cache(cfg, B, S + gen.max_new_tokens,
                                           dev)
        tokens_t = torch.as_tensor(prompts_np, device=dev)
        enc = None if enc_embeds is None else torch.as_tensor(enc_embeds,
                                                              device=dev)
        img = None if img_embeds is None else torch.as_tensor(img_embeds,
                                                              device=dev)
        t0 = now()
        # row by row, where the reference prefills the batch in one call:
        # a bf16 GEMM's bits depend on its row count (cuBLAS picks its
        # kernel by M), so only a (1, S) prefill reproduces the continuous
        # engine's per-request prefill byte for byte
        last = []
        for b in range(B):
            logits, states = prefill(
                self.params, cfg, tokens_t[b:b + 1],
                enc_embeds=None if enc is None else enc[b:b + 1],
                img_embeds=None if img is None else img[b:b + 1])
            _place_prefill_states(caches, states, b)
            last.append(logits)
        last_logits = torch.cat(last)
        del states
        synchronize(dev)
        self.prefill_s = now() - t0
        self.decode_s = []
        # the decode step's inputs, in buffers its graph keeps
        tok_in = StaticInput((B, 1), torch.int64, dev)
        pos_in = StaticInput((B,), torch.int32, dev)
        self._graphs = StepGraphs(dev, self.graphs, cfg, B, 1)

        def body() -> torch.Tensor:
            return decode_step(self.params, cfg, caches, tok_in.tensor,
                               pos_in.tensor)

        seeds = (np.zeros((B,), np.int64) if seed is None
                 else seed + np.arange(B, dtype=np.int64))
        temps = np.full((B,), gen.temperature if seed is not None else 0.0,
                        np.float32)
        top_ks = np.full((B,), gen.top_k, np.int32)
        top_ps = np.full((B,), gen.top_p, np.float32)

        def sample(logits: torch.Tensor, i: int) -> np.ndarray:
            return sampling.sample_tokens(
                logits, seeds, np.full((B,), i, np.int32), temps, top_ks,
                top_ps).cpu().numpy()

        cur = sample(last_logits, 0)
        tokens = [prompts_np.astype(np.int32)]
        finished = np.zeros((B,), bool)
        for i in range(gen.max_new_tokens):
            tokens.append(cur[:, None].astype(np.int32))
            if gen.stop_token is not None:
                finished |= cur == gen.stop_token
                if finished.all():
                    break
            if i == gen.max_new_tokens - 1:
                break
            t0 = now()
            tok_in.set(cur[:, None])
            pos_in.set(np.full((B,), S + i, np.int32))
            cur = sample(self._graphs.run("decode", body), i + 1)
            self.decode_s.append(now() - t0)
        return {"tokens": np.concatenate(tokens, axis=1),
                "finished": finished}

    @property
    def decode_steps(self) -> int:
        return len(self.decode_s)

    @property
    def graph_capture_s(self) -> float:
        """Seconds the last generate()'s decode graph took to capture."""
        return self._graphs.capture_s if self._graphs is not None else 0.0


class Engine:
    """Continuous-batching serve engine with a paged KV cache.

        eng = Engine(cfg, params, EngineConfig(num_slots=8, max_len=512))
        eng.submit(prompt_ids, GenerateConfig(max_new_tokens=64))
        done = eng.run()          # -> List[Request] with roofline ledgers

    ``generate()`` keeps the whole-batch signature and uses
    :class:`StaticEngine` for archs whose caches cannot page (enc-dec,
    vision cross-attention) or when given cross-attention sources.
    """

    def __init__(self, cfg: ModelConfig, params,
                 ecfg: Optional[EngineConfig] = None):
        check_supported(cfg)
        self.ecfg = ecfg or EngineConfig()
        check_pipeline(self.ecfg.pipeline)
        if self.ecfg.overlap not in ("none", "ring"):
            raise ValueError(f"overlap {self.ecfg.overlap!r} not in "
                             "('none', 'ring')")
        if (self.ecfg.kv_dtype is not None
                and self.ecfg.kv_dtype != cfg.kv_dtype):
            quantize.validate_kv_dtype(self.ecfg.kv_dtype)
            cfg = dataclasses.replace(cfg, kv_dtype=self.ecfg.kv_dtype)
        self.device = resolve_device(self.ecfg.device)
        self.graphs = graphs_enabled(self.ecfg.cuda_graphs, self.device)
        tok = params["embed"]["tok"]
        if tok.device.type != self.device.type:
            raise ValueError(f"params live on {tok.device}, the engine on "
                             f"{self.device}; init_params(device=...) must "
                             "match EngineConfig.device")
        self.cfg = cfg
        # the config the device steps and the pools are built from: the
        # model's own, or a tensor-parallel shard's (serve/shard.py)
        self.step_cfg = cfg
        self.params = prepare_params(params, cfg)
        self.paged_ok = supports_paging(cfg)
        self._static: Optional[StaticEngine] = None
        # bucketed whole-prompt prefill: only archs whose collected states
        # are all per-token (attention/MLA) survive padding — a recurrent
        # final state or an MoE capacity cutoff would see the pad tokens
        self._bucketable = (
            all(b.mixer in ("attn", "mla") for b in cfg.block_pattern)
            and all(b.ffn != "moe" for b in cfg.block_pattern))
        self._kv: Optional[PagedKVCache] = None
        self._sched: Optional[Scheduler] = None
        self._graphs: Optional[StepGraphs] = None
        # prefill shapes run through a fixed-shape body (and captured, with
        # graphs on): ("chunk", T) and ("bucket", S_padded)
        self.prefill_shapes: set = set()
        self.step_count = 0
        self.decode_steps = 0
        self._dispatch_s: Optional[float] = None
        self.obs: Optional[Telemetry] = None
        self._obs_pid = 0
        if self.ecfg.telemetry:
            self.attach_telemetry(
                Telemetry(window_steps=self.ecfg.telemetry_window))

    # -- wiring ------------------------------------------------------------

    def attach_telemetry(self, obs: Telemetry, pid: Optional[int] = None,
                         name: Optional[str] = None) -> None:
        """Adopt a telemetry bundle (``EngineConfig.telemetry`` builds the
        engine's own; a Cluster shares one over its replicas, ``pid`` the
        replica index, so they land on one timeline) and name this
        engine's trace tracks."""
        self.obs = obs
        if pid is not None:
            self._obs_pid = pid
        obs.tracer.process(self._obs_pid, name or self._obs_process_name())
        obs.tracer.thread(self._obs_pid, ENGINE_TID, "engine steps")
        obs.tracer.thread(self._obs_pid, LIFECYCLE_TID, "request lifecycle")
        if self._sched is not None:
            self._sched.obs = obs
            self._sched.obs_pid = self._obs_pid
            self._announce_slots()

    def _obs_process_name(self) -> str:
        return f"{self.cfg.name} engine"

    def _announce_slots(self) -> None:
        for s in range(self.ecfg.num_slots):
            self.obs.tracer.thread(self._obs_pid, SLOT_TID0 + s,
                                   f"slot {s}")

    def _ledger_chips(self) -> int:
        """Chips the per-request ledger's W / Q are split across (the
        tensor-parallel width for serve/shard.py's engines)."""
        return 1

    def _step_collective_bytes(self, n_tokens: int) -> float:
        """Per-card collective wire bytes one packed step feeding
        ``n_tokens`` tokens a slot moves (0 on one card; the sharded
        engines price their edges, scheduler.decode_step_ici_bytes)."""
        return 0.0

    def static_engine(self) -> StaticEngine:
        if self._static is None:
            self._static = StaticEngine(self.cfg, self.params,
                                        cuda_graphs=self.ecfg.cuda_graphs)
        return self._static

    def reset(self, num_slots: Optional[int] = None,
              max_len: Optional[int] = None) -> None:
        """(Re)build the paged cache and scheduler.  Drops any in-flight
        requests; call only when idle."""
        if not self.paged_ok:
            raise NotImplementedError(
                f"{self.cfg.name}: continuous batching needs a paged cache; "
                "use generate() (static fallback) for this arch")
        if num_slots is not None or max_len is not None:
            self.ecfg = dataclasses.replace(
                self.ecfg, num_slots=num_slots or self.ecfg.num_slots,
                max_len=max_len or self.ecfg.max_len)
        e = self.ecfg
        self._kv = PagedKVCache(self.step_cfg, e.num_slots, e.page_size,
                                e.max_len, self.device,
                                num_pages=e.num_pages,
                                margin_tokens=self._kv_margin(),
                                prefix_cache=e.prefix_cache,
                                eager_freeze=e.prefill_chunk <= 0)
        self._sched = Scheduler(self.cfg, self._kv,
                                prefill_chunk=e.prefill_chunk,
                                watermark=e.watermark,
                                preempt_mode=e.preempt_mode)
        if self.obs is not None:
            self._sched.obs = self.obs
            self._sched.obs_pid = self._obs_pid
            self._announce_slots()
        n = e.num_slots
        self._next_token = np.zeros((n,), np.int32)
        self._pos = np.zeros((n,), np.int32)
        # per-slot sampling state, read by the decode step's sampler
        self._seeds = np.zeros((n,), np.int64)
        self._steps = np.zeros((n,), np.int32)
        self._temps = np.zeros((n,), np.float32)
        self._top_ks = np.zeros((n,), np.int32)
        self._top_ps = np.zeros((n,), np.float32)
        # the decode step's inputs, in buffers its graph keeps; the graphs
        # go with the pools they captured
        self._tok_in = StaticInput((n, 1), torch.int64, self.device)
        self._pos_in = StaticInput((n,), torch.int32, self.device)
        self._active_in = StaticInput((n,), torch.bool, self.device)
        self._prefill_in = PrefillInputs(self._kv.blocks_per_slot,
                                         self.device)
        self._graphs = StepGraphs(self.device, self.graphs, self.step_cfg,
                                  n, self._graph_tokens())
        self.prefill_shapes = set()
        self.step_count = 0
        self.decode_steps = 0
        self._dispatch_s = None

    def _graph_tokens(self) -> int:
        """Tokens per slot of the engine's largest captured step (the
        decode step's 1; the speculative subclass verifies k + 1)."""
        return 1

    def _kv_margin(self) -> int:
        """Block-table margin (tokens) past ``max_len``; the speculative
        subclass widens it so verify writes near the budget edge stay on
        legal (trash) table entries."""
        return 0

    def _ensure(self, budget: int) -> None:
        if self._kv is None:
            self.reset(max_len=max(budget, self.ecfg.max_len))
        elif budget > self._kv.max_len:
            if self._sched.has_work():
                raise ValueError(
                    f"request budget {budget} exceeds engine max_len "
                    f"{self._kv.max_len} with requests in flight; drain "
                    "first or raise EngineConfig.max_len")
            self.reset(max_len=max(budget, self.ecfg.max_len))

    # -- request API -------------------------------------------------------

    def submit(self, prompt, gen: GenerateConfig,
               seed: Optional[int] = None) -> Request:
        """Queue one request.  ``seed`` names its sampling stream; without
        one the request decodes greedily whatever its temperature."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self._ensure(prompt.shape[0] + gen.max_new_tokens)
        req = Request(prompt=prompt, max_new_tokens=gen.max_new_tokens,
                      temperature=gen.temperature, top_k=gen.top_k,
                      top_p=gen.top_p, stop_token=gen.stop_token, seed=seed,
                      submit_time=now())
        req = self._sched.submit(req)
        if self.obs is not None:
            self.obs.tracer.instant("submit", self._obs_pid, LIFECYCLE_TID,
                                    req.submit_time,
                                    request=req.request_id)
        return req

    def enqueue(self, req: Request) -> Request:
        """Queue a request built elsewhere without renumbering it: a
        Router stamps cluster-unique ids (its stream keys on them) and
        the submit time at its front door; this stamps the dispatch."""
        self._ensure(req.budget)
        if req.submit_time == 0.0:
            req.submit_time = now()
        req.dispatch_time = now()
        req = self._sched.submit(req, keep_id=True)
        if self.obs is not None:
            self.obs.tracer.instant("enqueue", self._obs_pid, LIFECYCLE_TID,
                                    req.dispatch_time,
                                    request=req.request_id)
        return req

    def export_request(self, req: Request, link: str = "dcn") -> Request:
        """Detach a request for migration to another replica
        (``Scheduler.detach``: its pages pack into one SwapSnapshot in
        host memory, the bytes charge the migration ledger on ``link``).
        Subclasses release engine-side companion state first (the
        speculative proposer's slot)."""
        return self._sched.detach(req, link=link)

    def import_request(self, req: Request) -> Request:
        """Adopt a migrated request: it queues with resume priority, and
        the next :meth:`step` restores its snapshot into this pool and
        re-points the packed decode rows at it, the swap-resume path, so
        its stream continues as one engine's would.  The restore writes
        the pools in place and the next step writes the block tables into
        the persistent buffer the captured graphs read."""
        self._ensure(req.budget)
        return self._sched.attach(req)

    @torch.no_grad()
    def step(self) -> List[Request]:
        """One scheduler iteration: admit (resuming preempted requests
        first), prefill one chunk per admitted request, one packed decode
        step.  Returns the requests finished here."""
        sched = self._sched
        n_done = len(sched.finished)
        admitted = sched.admit()
        for req in admitted:
            self._init_sampling_row(req)
            if req.state is RequestState.RUNNING:
                self._restore_decode_row(req)        # swap-resume
        work = sched.prefill_work()
        for req, start, end in work:
            self._run_prefill(req, start, end)
        running = sched.decode_requests()
        if running:
            self._run_decode(running)
        elif (not admitted and not work
                and (sched.waiting or sched.preempted)):
            head = (sched.preempted + list(sched.waiting))[0]
            raise RuntimeError(
                f"request {head.request_id} (budget {head.budget}) cannot "
                f"be admitted: engine max_len {self._kv.max_len}, "
                f"{self._kv.available_page_count} obtainable pages "
                f"(watermark {sched.watermark_pages}), "
                f"{len(sched.preempted)} preempted waiting to resume")
        self.step_count += 1
        if self.obs is not None:
            self.obs.on_step(self)
        return sched.finished[n_done:]

    def run(self) -> List[Request]:
        """Drain all queued work; returns requests finished by this call."""
        if self._sched is None:
            return []
        n0 = len(self._sched.finished)
        while self._sched.has_work():
            self.step()
        return self._sched.finished[n0:]

    def roofline_terms(self, req: Request):
        """The request's decode RooflineTerms on ``EngineConfig.chip``."""
        return req.ledger.terms(self.cfg, self.ecfg.chip,
                                n_chips=self._ledger_chips())

    @property
    def phases(self):
        """Per-phase traffic + synchronized wall time (prefill / decode /
        swap)."""
        return self._sched.phases if self._sched is not None else {}

    def reset_phases(self) -> None:
        """Drop accumulated phase traffic: call after a warm-up pass so
        capture and kernel builds never pollute the timed budget."""
        if self._sched is not None:
            self._sched.reset_phases()

    @property
    def graph_capture_s(self) -> float:
        """Seconds this engine's pools' graphs took to capture (0 eager)."""
        return self._graphs.capture_s if self._graphs is not None else 0.0

    def _no_kernel_cfg(self) -> ModelConfig:
        """This engine's no-kernel twin config (:func:`no_kernel_cfg`)."""
        return no_kernel_cfg(self.cfg)

    def measure_dispatch_overhead(self, repeats: int = 20) -> float:
        """Per-step framework and launch overhead, seconds: the paper's
        kernel / no-kernel protocol (§2.4).  Runs the SAME decode step,
        sampling included, with every kernel's work degenerated to the
        floor (:meth:`_no_kernel_cfg`) on an engine of this one's
        settings, so it is the replay floor when graphs are on and the
        eager dispatch floor when they are off.  Median of ``repeats``
        synchronized calls after one untimed call (kernel builds,
        capture); cached until the next :meth:`reset`."""
        if self._dispatch_s is not None:
            return self._dispatch_s
        nk_cfg = self._no_kernel_cfg()
        gen = torch.Generator(device=self.device).manual_seed(0)
        nk = Engine(nk_cfg, init_params(nk_cfg, gen, self.device),
                    dataclasses.replace(self.ecfg, num_pages=None,
                                        telemetry=False))
        nk.reset()
        n = nk.ecfg.num_slots
        nk._kv.block_tables_for(list(range(n)))
        nk._tok_in.set(np.zeros((n, 1), np.int64))
        nk._pos_in.set(np.zeros((n,), np.int32))
        nk._active_in.set(np.ones((n,), bool))
        with torch.no_grad():
            nk._decode_sample()                     # build, capture: untimed
            synchronize(self.device)
            samples = []
            for _ in range(max(repeats, 1)):
                t0 = now()
                nk._decode_sample()
                synchronize(self.device)
                samples.append(now() - t0)
        self._dispatch_s = float(np.median(samples))
        return self._dispatch_s

    def aggregate_ledger(self) -> RooflineLedger:
        """One ledger summing every request this scheduler has seen (the
        migration link carried, not summed: ``RooflineLedger.add``)."""
        agg = RooflineLedger()
        if self._sched is None:
            return agg
        s = self._sched
        for req in (list(s.finished) + list(s.active.values())
                    + list(s.preempted) + list(s.waiting)):
            agg.add(req.ledger)
        return agg

    def hierarchy_report(self, betas=None, label: str = "decode",
                         overlap: Optional[Dict[str, float]] = None) -> str:
        """The hierarchical and time-based roofline report: the aggregate
        decode terms' per-level ladder (vmem / hbm / ici / dcn / host) and
        the per-phase time budget against ``betas`` (the measured
        ``MicrobenchResult.level_betas()`` when given; this engine's chip
        otherwise), less the dispatch floor of
        :meth:`measure_dispatch_overhead` when it has been measured.
        ``overlap`` (e.g. ``MicrobenchResult.overlap``) adds the serial
        and overlapped budgets to the time table."""
        from ..core.roofline.model import LevelBetas
        from ..core.roofline.report import (HIERARCHY_HEADER,
                                            TIME_BUDGET_HEADER,
                                            TIME_BUDGET_OVERLAP_HEADER,
                                            hierarchy_rows, text_table,
                                            time_budget_rows)
        if betas is None:
            betas = LevelBetas.from_chip(self.ecfg.chip, dtype=self.cfg.dtype)
        t = self.aggregate_ledger().terms(self.cfg, self.ecfg.chip,
                                          n_chips=self._ledger_chips())
        dispatch = self._dispatch_s or 0.0
        out = [f"== hierarchical roofline: {self.cfg.name} "
               f"(betas: {betas.source}) ==",
               text_table(hierarchy_rows(label, t), HIERARCHY_HEADER)]
        rows = time_budget_rows(dict(self.phases), betas,
                                dispatch_s_per_step=dispatch,
                                overlap=overlap)
        if rows:
            out.append("-- time budget (dispatch "
                       f"{dispatch * 1e6:.0f}us/step) --")
            out.append(text_table(rows, TIME_BUDGET_OVERLAP_HEADER
                                  if overlap is not None
                                  else TIME_BUDGET_HEADER))
        return "\n".join(out)

    # -- internals ---------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _run_prefill(self, req: Request, start: int, end: int) -> None:
        kv, cfg = self._kv, self.cfg
        fill = req.fill_tokens
        fill_len = len(fill)
        # chunk writes can hit a prefix-shared page (copy-on-write needs a
        # fresh page): back the span first, preempting if the pool is dry
        if not self._grow_spans([req], lambda r: (start, end)):
            return                          # req itself was preempted
        whole = start == 0 and end == fill_len
        inp = self._prefill_in
        t0 = now()
        if whole and self._bucketable and self.ecfg.prefill_bucket > 0:
            # pad to the next power of two: causal masking keeps the
            # prefix rows equal to an unpadded run
            S = _bucket_len(fill_len, self.ecfg.prefill_bucket)
            toks = np.zeros((1, S), np.int64)
            toks[0, :fill_len] = fill
            inp.row.set(kv.block_tables[req.slot])
            inp.length.set(fill_len)
            inp.tokens(S).set(toks)
            self.prefill_shapes.add(("bucket", S))
            last_logits = self._graphs.run(
                f"prefill_bucket:{S}", functools.partial(
                    bucket_prefill_body, self.params, self.step_cfg, kv, inp,
                    S))
        elif whole:
            last_logits, states = prefill(
                self.params, self.step_cfg,
                self._tensor(fill[None, :].astype(np.int64)))
            kv.write_prefill_states(req.slot, states, fill_len)
        else:
            T = end - start
            inp.row.set(kv.block_tables[req.slot])
            inp.slot.set(req.slot)
            inp.offset.set(start)
            inp.tokens(T).set(fill[None, start:end])
            self.prefill_shapes.add(("chunk", T))
            last_logits = self._graphs.run(
                f"prefill_chunk:{T}",
                functools.partial(self._chunk_body, T))
            if kv.prefix_cache:
                # every full page this chunk finalized holds canonical
                # prompt content now, so it is shareable right away
                kv.freeze_committed(req.slot, fill, end)
        synchronize(self.device)
        t1 = now()
        if self.obs is not None:
            self.obs.tracer.span("prefill_chunk", self._obs_pid,
                                 SLOT_TID0 + req.slot, t0, t1,
                                 request=req.request_id, start=start,
                                 end=end)
        self._sched.phases["prefill"].add(
            flops=(model_flops(cfg, end, 1, "prefill")
                   - model_flops(cfg, start, 1, "prefill")),
            hbm=params_bytes_active(cfg) + end * kv_line_bytes(cfg),
            wall_s=t1 - t0, steps=1, tokens=end - start)
        req.prefill_pos = end
        if end == fill_len:
            if not req.token_times:
                req.prefill_end_time = t1
            req.ledger.prefill_flops += model_flops(cfg, fill_len, 1,
                                                    "prefill")
            if req.prefill_skip:
                req.ledger.prefill_flops -= model_flops(
                    cfg, req.prefill_skip, 1, "prefill")
            if req.max_new_tokens <= 0:
                self._sched.finish(req, "length")
                return
            tok = self._sample_first(last_logits, req)
            self._commit_token(req, tok, first=True)

    def _grow_spans(self, reqs: List[Request], span) -> List[Request]:
        """Back every request's write span ``span(req) -> (start, end)``
        before a device step: on-demand page growth plus copy-on-write.
        When the pool runs dry the newest-admitted RUNNING request is
        preempted and the growth retried; preempted requests drop out of
        the returned list."""
        for req in sorted(reqs, key=lambda r: r.admit_seq):
            s, e = span(req)
            while (req.state is not RequestState.PREEMPTED
                   and not self._kv.ensure_writable(req.slot, s, e)):
                victim = self._sched.preempt_victim()
                if victim is None:
                    raise RuntimeError(
                        f"block pool exhausted: request {req.request_id} "
                        f"cannot grow to token {e} with "
                        f"{self._kv.available_page_count} obtainable pages "
                        "and no running victim to preempt; raise "
                        "EngineConfig.num_pages or lower num_slots")
                self._preempt(victim)
        return [r for r in reqs if r.state is not RequestState.PREEMPTED]

    def _preempt(self, req: Request) -> None:
        """Scheduler preemption plus engine-side hooks (subclasses release
        per-request companion state, e.g. the draft proposer's slot)."""
        self._sched.preempt(req)

    def _restore_decode_row(self, req: Request) -> None:
        """Re-point the packed decode rows at a swap-resumed request."""
        self._next_token[req.slot] = req.generated[-1]
        self._pos[req.slot] = req.context_len - 1
        self._steps[req.slot] = len(req.generated)

    def _chunk_body(self, T: int) -> torch.Tensor:
        """A prefill chunk of ``T`` tokens over the persistent prefill
        inputs (tokens, block-table row, slot, offset): last logits
        (1, V)."""
        inp = self._prefill_in
        return prefill_chunk_paged(self.params, self.step_cfg, self._kv.pools,
                                   inp.row.tensor, inp.tokens(T).tensor,
                                   inp.offset.tensor,
                                   page_size=self.ecfg.page_size,
                                   slot=inp.slot.tensor)

    def _decode_body(self) -> torch.Tensor:
        """The decode step over the persistent inputs (block tables,
        tokens, positions, the active mask): logits (B, V)."""
        return decode_step_paged(self.params, self.step_cfg, self._kv.pools,
                                 self._kv.tables.tensor, self._tok_in.tensor,
                                 self._pos_in.tensor,
                                 page_size=self.ecfg.page_size,
                                 pipeline=self.ecfg.pipeline,
                                 active=self._active_in.tensor)

    def _decode_logits(self) -> torch.Tensor:
        """The decode step's logits: its graph replayed (captured at the
        first call) on CUDA, the body eagerly on the CPU or with graphs
        off.  The graph's output is overwritten by its next replay."""
        return self._graphs.run("decode", self._decode_body)

    def _decode_sample(self) -> torch.Tensor:
        """The decode step and the sampler over its logits, all on the
        device; returns (B,) token ids (still on the device)."""
        return sampling.sample_tokens(self._decode_logits(), self._seeds,
                                      self._steps, self._temps,
                                      self._top_ks, self._top_ps)

    def _run_decode(self, running: List[Request]) -> None:
        kv = self._kv
        # the step writes each request's newest KV line at context_len - 1
        running = self._grow_spans(
            running, lambda r: (r.context_len - 1, r.context_len))
        if not running:
            return
        slots = [r.slot for r in running]
        active = np.zeros((self.ecfg.num_slots,), bool)
        active[slots] = True
        kv.block_tables_for(slots)
        self._tok_in.set(np.where(active, self._next_token, 0)[:, None])
        self._pos_in.set(np.where(active, self._pos, 0))
        self._active_in.set(active)
        t0 = now()
        next_tok = self._decode_sample()
        tok_np = next_tok.cpu().numpy()       # the only device->host copy
        t1 = now()
        self.decode_steps += 1
        if self.obs is not None:
            self.obs.tracer.span("decode_step", self._obs_pid, ENGINE_TID,
                                 t0, t1, batch=len(running))
        n_active = len(running)
        # each request carries its share of the step's collective bytes
        ici_share = self._step_collective_bytes(1) / n_active
        ph = self._sched.phases["decode"]
        ps = self.ecfg.page_size
        for req in running:
            vmem = decode_token_vmem_bytes(self.cfg, req.context_len,
                                           n_active, ps,
                                           pipeline=self.ecfg.pipeline)
            req.ledger.add_decode_token(self.cfg, req.context_len, n_active,
                                        vmem_bytes=vmem, ici_bytes=ici_share)
            ph.add(flops=decode_token_flops(self.cfg, req.context_len),
                   vmem=vmem,
                   hbm=decode_token_bytes(self.cfg, req.context_len,
                                          n_active),
                   ici=ici_share, steps=0, tokens=1)
            self._commit_token(req, int(tok_np[req.slot]), t=t1)
        ph.add(wall_s=t1 - t0, steps=1, tokens=0)

    def _commit_token(self, req: Request, tok: int, first: bool = False,
                      t: Optional[float] = None) -> None:
        req.generated.append(tok)
        req.token_times.append(now() if t is None else t)
        if first:
            req.state = RequestState.RUNNING
            if self.obs is not None:
                self.obs.tracer.instant(
                    "first_token", self._obs_pid, LIFECYCLE_TID,
                    req.token_times[-1], request=req.request_id)
        if self._kv.prefix_cache:
            # pages whose every position is now final become shareable
            self._kv.freeze_committed(req.slot, req.tokens,
                                      req.context_len - 1)
        if req.stop_token is not None and tok == req.stop_token:
            self._sched.finish(req, "stop")
        elif len(req.generated) >= req.max_new_tokens:
            self._sched.finish(req, "length")
        else:
            self._next_token[req.slot] = tok
            self._pos[req.slot] = req.context_len - 1
            self._steps[req.slot] = len(req.generated)

    def _init_sampling_row(self, req: Request) -> None:
        """Per-slot sampling state; a request without a seed samples
        greedily whatever its temperature."""
        slot = req.slot
        self._seeds[slot] = 0 if req.seed is None else req.seed
        self._temps[slot] = req.temperature if req.seed is not None else 0.0
        self._top_ks[slot] = req.top_k
        self._top_ps[slot] = req.top_p
        self._steps[slot] = 0

    def _sample_first(self, last_logits: torch.Tensor, req: Request) -> int:
        """The prefill's first token, through the same sampler (B=1).  A
        captured prefill's logits are read here, before another replay
        can overwrite them."""
        s = req.slot
        tok = sampling.sample_tokens(
            last_logits.reshape(1, -1), self._seeds[s:s + 1],
            np.asarray([len(req.generated)], np.int32),
            self._temps[s:s + 1], self._top_ks[s:s + 1],
            self._top_ps[s:s + 1])
        return int(tok[0])

    # -- batch API ---------------------------------------------------------

    def generate(self, prompts, gen: GenerateConfig, enc_embeds=None,
                 img_embeds=None, seed: Optional[int] = None
                 ) -> Dict[str, Any]:
        """prompts (B, S) int -> {"tokens" (B, S+new), "finished" (B,)}
        numpy arrays, through the continuous path with one slot per row
        (row ``b`` samples with seed ``seed + b`` when a seed is given);
        archs without a paged decode path (enc-dec / vision), or a call
        with ``enc_embeds`` / ``img_embeds``, take the static engine."""
        if (enc_embeds is not None or img_embeds is not None
                or not self.paged_ok):
            return self.static_engine().generate(
                prompts, gen, enc_embeds=enc_embeds, img_embeds=img_embeds,
                seed=seed)
        if self._sched is not None and self._sched.has_work():
            raise ValueError(
                "generate() rebuilds the scheduler and would drop requests "
                "already in flight; drain with run() first")
        prompts_np = np.asarray(prompts, np.int32)
        B, S = prompts_np.shape
        prev_ecfg = self.ecfg
        self.reset(num_slots=B, max_len=S + gen.max_new_tokens)
        try:
            for b in range(B):
                self.submit(prompts_np[b], gen,
                            seed=None if seed is None else seed + b)
            done = sorted(self.run(), key=lambda r: r.request_id)
        finally:
            self.ecfg = prev_ecfg
            self._kv = None
            self._sched = None
            self._graphs = None         # they captured the dropped pools
        n_gen = max(len(r.generated) for r in done)
        out = np.zeros((B, S + n_gen), np.int32)
        finished = np.zeros((B,), bool)
        for r in done:
            row = np.asarray(r.tokens)
            # rows that stopped early repeat their last token
            out[r.request_id] = np.concatenate(
                [row, np.full((S + n_gen - row.shape[0],), row[-1],
                              np.int32)])
            finished[r.request_id] = r.finish_reason == "stop"
        return {"tokens": out, "finished": finished}
