"""Model configuration shared by all 10 architectures (the port's copy).

One frozen dataclass covers dense / MoE / MLA / SSM / hybrid / enc-dec / VLM;
architecture identity lives in ``configs/<id>.py``.  Blocks are described by
a repeating ``block_pattern`` unit; the parameters of each segment are
stacked along a leading ``(reps, ...)`` axis and the model walks them with
a Python loop.  Pure Python: the JAX package keeps the same definitions and
the tests hold the two equal field by field.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class BlockDef:
    mixer: str          # attn | cross_attn | mla | mamba | mlstm | slstm
    ffn: str = "dense"  # dense | moe | none


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # attention flavor
    qk_norm: bool = False
    rope_theta: float = 1e6
    pos_emb: str = "rope"            # rope | learned | none
    causal: bool = True
    attn_chunk: int = 1024           # q-chunked attention threshold/size
    attn_logit_soft_cap: float = 0.0

    # norms / activations
    norm: str = "rms"                # rms | layer
    norm_eps: float = 1e-6
    act: str = "silu_glu"            # silu_glu | gelu | relu2 | gelu_glu
    tie_embeddings: bool = False
    residual_scale: float = 1.0      # minicpm-style depth scaling

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_first_dense: int = 0         # prologue layers with dense FFN
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    moe_dispatch: str = "global"     # global | local (data-local, §Perf)

    # MLA (DeepSeek-V2 style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    mla_absorb: bool = False         # latent-space decode (§Perf hillclimb)

    # block pattern: the repeated superblock; None -> uniform attn(+ffn)
    block_pattern: Tuple[BlockDef, ...] = (BlockDef("attn", "dense"),)

    # mamba
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv_width: int = 4
    mamba_dt_rank: int = 0           # 0 -> ceil(d_model / 16)
    scan_chunk: int = 256            # chunk for mamba/mlstm chunked scans

    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500       # conv-frontend STUB output length

    # vlm
    n_image_tokens: int = 0

    # numerics / training
    dtype: str = "bfloat16"
    # paged-KV storage dtype (serve path): "bf16" stores pages in ``dtype``
    # (no quantization); "int8" / "fp8_e4m3" store quantized values with a
    # float32 scale per (page, line[, kv_head]) living alongside the pool
    # and dequantize inside the paged-attention page walk.  See
    # kernels/quantize.py for the exact scheme.
    kv_dtype: str = "bf16"
    remat: str = "full"              # full | dots | none
    max_seq_len: int = 524288
    # §Perf levers (off in the paper-faithful baseline)
    tp_attn_inner: bool = False      # row-parallel o-proj over flat (H*hd)

    # tensor-parallel serving (serve/shard.py): set ONLY on the per-shard
    # local config that runs inside shard_map.  Names the mesh axis that
    # row-parallel partial sums are psum'd over (and vocab-sharded logits
    # all-gathered over); None = ordinary unsharded execution.  The local
    # config also carries the per-shard head/ffn counts, so model code is
    # oblivious to sharding except at these explicit collective edges.
    tp_axis: Optional[str] = None
    # Row-parallel epilogue schedule on the decode hot path: "none" keeps
    # the blocking matmul + psum (the byte-checked reference); "ring"
    # routes the o-proj / down-proj edges through
    # parallel.collectives.ring_matmul_reduce so ICI hops interleave with
    # per-shard matmul chunks.  Only consulted when tp_axis is set.
    tp_overlap: str = "none"

    # serving
    subquadratic: bool = False       # may run long_500k

    # -- derived ------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def use_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def pattern_repeats(self) -> int:
        if self.n_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.block_pattern)}")
        return self.n_layers // len(self.block_pattern)

    def segments(self) -> Sequence[Tuple[Tuple[BlockDef, ...], int]]:
        """(pattern_unit, n_repeats) pieces; a dense-FFN prologue (e.g.
        DeepSeek's first layer) becomes its own unrolled segment."""
        if self.moe_first_dense == 0:
            return [(self.block_pattern, self.pattern_repeats)]
        assert len(self.block_pattern) == 1, "prologue only for uniform stacks"
        b = self.block_pattern[0]
        pro = (BlockDef(b.mixer, "dense"),)
        rest = self.n_layers - self.moe_first_dense
        return [(pro, self.moe_first_dense), (self.block_pattern, rest)]


@dataclasses.dataclass(frozen=True)
class LocalLayout:
    """How a tensor-parallel training, prefill or dense-decode rank's
    layers depart from the head-parallel layout, as the specs the rules
    resolve say (``parallel.sharding.tp_local_config(..., train=True)``):

    * ``kv_sliced``: the KV heads do not divide the tp axis; the rules
      replicate ``wk`` / ``wv`` and the rank reads the ``n_kv_heads`` of
      them that its query heads use, through ``tp_copy``
      (models/attention.py).  The local shapes alone cannot tell a
      replicated KV head (MQA) from a shard of one head a rank;
    * ``context_parallel``: the query heads do not divide the axis; they
      stay whole and attention runs over the rank's rows of the
      sequence, the reference's ``seq_fb`` layout: q and o for the rows,
      K / V whole (models/attention.py);
    * ``whole_ffn``: a dense d_ff that the axis does not divide; the
      rules replicate it and every rank runs the FFN whole, without
      edges (models/layers.py);
    * ``kv_seq`` (decode, ``parallel.sharding.tp_local_config(...,
      decode=True)``): the KV heads do not divide the axis, so the rules
      put the dense cache's lines (``kv_seq``) on it: the rank holds
      every KV head (``n_kv_heads`` is the global count) for its block of
      the lines, attends all query heads over them (gathered where they
      are split) and the ranks' partial softmaxes are merged
      (``parallel.collectives.kv_merge``, flash-decoding).  With
      ``context_parallel`` beside it the query heads are whole too.

    KV slicing and context parallelism exclude each other: whole query
    heads read whole KV heads; KV slicing and the cut lines too: a
    decode rank reads every KV head."""
    kv_sliced: bool = False
    context_parallel: bool = False
    whole_ffn: bool = False
    kv_seq: bool = False

    def __post_init__(self):
        if self.kv_sliced and self.context_parallel:
            raise ValueError("a KV-sliced config has its query heads split")
        if self.kv_sliced and self.kv_seq:
            raise ValueError("a decode rank on cut lines reads every KV "
                             "head")


HEAD_PARALLEL = LocalLayout()


@dataclasses.dataclass(frozen=True)
class LocalConfig(ModelConfig):
    """A rank's local config whose layout is not head parallel: its one
    field beyond :class:`ModelConfig`'s is ``layout``, so that every
    other field stays equal to the one the reference holds."""
    layout: LocalLayout = HEAD_PARALLEL


def layout_of(cfg: ModelConfig) -> LocalLayout:
    """The rank's layout: a :class:`LocalConfig`'s, else head parallel."""
    return cfg.layout if isinstance(cfg, LocalConfig) else HEAD_PARALLEL


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> Sequence[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return out


# --------------------------------------------------------------------------
# Parameter / FLOP accounting (MODEL_FLOPS = 6*N*D convention + attention)
# --------------------------------------------------------------------------

def _block_params(cfg: ModelConfig, b: BlockDef) -> dict:
    """Analytic param counts per block, split active/total (MoE)."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p: dict = {"total": 0.0, "active": 0.0}

    def add(n, active=True):
        p["total"] += n
        if active:
            p["active"] += n

    if b.mixer == "attn" or b.mixer == "cross_attn":
        add(D * H * hd + 2 * D * KV * hd + H * hd * D)
    elif b.mixer == "attn+cross":
        add(2 * (D * H * hd + 2 * D * KV * hd + H * hd * D))
    elif b.mixer == "mla":
        r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
        dqk = cfg.nope_head_dim + cfg.rope_head_dim
        if r_q:
            add(D * r_q + r_q * H * dqk)
        else:
            add(D * H * dqk)
        add(D * (r_kv + cfg.rope_head_dim))
        add(r_kv * H * (cfg.nope_head_dim + cfg.v_head_dim))
        add(H * cfg.v_head_dim * D)
    elif b.mixer == "mamba":
        di, N, dt = cfg.d_inner, cfg.mamba_d_state, cfg.dt_rank
        add(D * 2 * di + di * cfg.mamba_conv_width + di * (dt + 2 * N)
            + dt * di + di * N + di + di * D)
    elif b.mixer == "mlstm":
        di = 2 * D
        add(D * 2 * di)                       # up proj (x, z)
        add(di * cfg.mamba_conv_width)        # conv4
        add(3 * di * di)                      # q, k, v
        add(2 * di * H)                       # i, f gates (per head)
        add(di * D)                           # down proj
    elif b.mixer == "slstm":
        hdim = D
        add(4 * D * hdim + 4 * hdim * cfg.hd * 1)  # w_{zifo} + block-diag r
    else:
        raise ValueError(b.mixer)

    glu = cfg.act.endswith("_glu")
    mult = 3 if glu else 2
    if b.ffn == "dense":
        add(mult * D * cfg.d_ff)
    elif b.ffn == "moe":
        add(mult * D * cfg.moe_d_ff * cfg.n_experts, active=False)
        p["active"] += mult * D * cfg.moe_d_ff * cfg.moe_top_k
        add(mult * D * cfg.moe_d_ff * cfg.n_shared_experts)
        add(D * cfg.n_experts)  # router
    return p


def param_counts(cfg: ModelConfig) -> dict:
    """Analytic total/active param counts (fresh dict; cached internally)."""
    return dict(_param_counts(cfg))


@functools.lru_cache(maxsize=None)
def _param_counts(cfg: ModelConfig) -> dict:
    total = active = 0.0
    for unit, reps in cfg.segments():
        for b in unit:
            p = _block_params(cfg, b)
            total += p["total"] * reps
            active += p["active"] * reps
    emb = cfg.vocab_size * cfg.d_model
    total += emb * (1 if cfg.tie_embeddings else 2)
    active += emb * (1 if cfg.tie_embeddings else 2)
    if cfg.pos_emb == "learned":
        pos = min(cfg.max_seq_len, 65536) * cfg.d_model
        total += pos
        active += pos
    if cfg.is_encoder_decoder:
        total += cfg.n_audio_frames * cfg.d_model
        active += cfg.n_audio_frames * cfg.d_model
    if cfg.is_encoder_decoder:
        # encoder: n_encoder_layers x (attn + dense ffn); the decoder stack
        # (incl. its cross-attn mixers) is already counted via block_pattern.
        enc = _block_params(cfg, BlockDef("attn", "dense"))
        total += enc["total"] * cfg.n_encoder_layers
        active += enc["active"] * cfg.n_encoder_layers
    return {"total": total, "active": active}


def model_flops(cfg: ModelConfig, seq_len: int, batch: int, kind: str) -> float:
    """MODEL_FLOPS per the assignment: 6*N*D dense / 6*N_active*D MoE for
    training; 2*N*D per generated token for decode; + attention term."""
    counts = param_counts(cfg)
    n_active = counts["active"]
    tokens = seq_len * batch
    if kind == "train":
        base = 6.0 * n_active * tokens
    elif kind == "prefill":
        base = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        base = 2.0 * n_active * batch
    # attention score/value flops (per-token context-dependent part)
    attn_blocks = 0
    for unit, reps in cfg.segments():
        attn_blocks += sum(
            1 for b in unit if b.mixer in ("attn", "mla", "attn+cross")) * reps
    H, hd = cfg.n_heads, cfg.hd
    if cfg.use_mla:
        hd = cfg.nope_head_dim + cfg.rope_head_dim
    if kind == "train":
        # causal: ~ 0.5 * S^2 pairs; fwd+bwd = 3x the fwd 4*H*hd flops/pair
        base += 3.0 * 2.0 * 2.0 * H * hd * 0.5 * seq_len * seq_len * batch * attn_blocks
    elif kind == "prefill":
        base += 2.0 * 2.0 * H * hd * 0.5 * seq_len * seq_len * batch * attn_blocks
    else:
        base += 2.0 * 2.0 * H * hd * seq_len * batch * attn_blocks
    return base


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
