"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one NVIDIA H100, from a repo checkout

Phases, in order; any failure exits non-zero.  Work that launches none
of the kernels runs beside other work where the card's memory holds
both: the training phase (o.) while nvcc builds, the dry run's three
walks (r., CPU only) from the start, [train-tp]'s (2, 2) ranks beside
[train-dp]'s launch/train.py run, and each NCCL world of one beside its
phase's gloo ranks; the examples' legs, which launch kernels but hold
no time, run beside [decode-sp]'s gloo ranks (s.), whose times say
nothing of speed (not beside [dryrun]'s five, which leave the card too
little memory).

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together, and one more for the flash kernel's
   measurement build with P rounded once to bf16) and print the build
   time, each source's registers and spills (and those of the two
   tensor-core cores' kernels and of GELU's vector walks), then check
   their SASS: HGMMA in every instantiation of the MLA core's split
   kernel (``csrc/mla_core.cu``, the bf16 path of the three MLA
   wrappers) and of the GQA core's
   (``csrc/gqa_core.cu``, the bf16 path of the three GQA wrappers),
   16-byte loads and stores (LDG / STG .128) in GELU's flat walk;
3. kernel phases: each kernel (GQA ``paged_attention`` and
   ``paged_attention_verify``, MLA ``mla_paged_attention`` and
   ``mla_paged_attention_verify``) against its plain PyTorch version on
   the card at its main path's shapes and at its edge cases (ragged
   tables, idle all-trash lanes, soft cap; for the verify kernels also
   draft chains crossing a page, drafts on trash margin entries, chains
   past the table, and T = 1 against the decode kernel, bit for bit in
   bf16), with the tolerance stated; the ``pipeline="double"`` ring kernels
   (``paged_attention_ring``, ``mla_paged_attention_ring``) on every one
   of those cases, equal to the off kernel bit for bit (torch.equal) and
   within the same tolerance of the plain version; the four kernels'
   scale branches (int8 and fp8_e4m3 pools with float32 per-line scales)
   on every one of those cases, bf16 and float32 queries, against the
   plain version on the same codes and scales (float32 2e-5, bf16 1e-2),
   and at T = 1 verify equal to decode bit for bit; ``paged_attention``'s
   log-sum-exp (``return_lse``, bf16 and float32, on the same cases and
   on rows that see no line: o = 0, lse = -inf, tables pointing past
   the pool) against the plain version run in float32 on the same
   values within LSE_SUM's bar, o the
   same bits with it as without, and its time beside the call without;
   the ring kernels'
   scale branches on every one of those quantized cases, equal to the
   quantized off kernel bit for bit (torch.equal) and within the same
   tolerance of the plain version; times (CUDA events) of the kernel, the
   ring kernel, the plain version and one PyTorch library call computing
   the same function, beside the bound, and of the scale branches (off
   and ring) on the same inputs quantized, beside the bound at the
   quantized line bytes; for the GQA and MLA decode and verify kernels at
   their main inputs, the bf16 path's chunk and block count and its
   output against the model of its own arithmetic order
   (``gqa_split_model``, ``mla_split_model``) on bf16, int8 and fp8
   pools;
4. the paper's primitive study (launch/primitives.py): the microbench
   (FMA-chain probe, matmul peaks per dtype, copy / fill / triad
   bandwidth, warm vs cold, and the hierarchical roofline's per-level
   betas: the L2-resident triad of ``csrc/l2_probe.cu``, the pinned host
   link and the host copy's overlap with a matmul loop) printed beside
   the data sheet; the
   inner-product, GELU, direct-conv and Winograd-stage kernels held
   against their plain versions at the reference benchmarks' shapes and
   at edge shapes (ragged M / N / K, K = 1, relu and gelu epilogues, odd
   H / W, C = 3 padded to 8 and 128, GELU blocked equal to naive bit for
   bit, also on views 1 and 3 elements into a buffer at lengths that are
   not a multiple of the 16-byte vector; for the bf16 GEMMs on the tensor cores the core's edges: M % 64,
   K under one stage and K % 64, N = 8, N % 8, K % 8, Cin % 8 and Cout
   ragged, 8192^3 and the gate projection, each printing the path and
   stage producers it took and where cuBLAS falls in its allowance);
   then the study at card shapes with the four kernels' launch counts
   zeroed before and read after, every row held against its plain
   version and within 105% of the measured roof, the GEMM rows' paths
   printed beside their times;
   b. the LayerNorm, average-pooling (blocked and naive) and flash-
   attention kernels held against their plain versions at the reference
   benchmarks' shapes and at edge shapes (LayerNorm: D 1 to 16384, R 1 to
   8192, a row misaligned by one element; pooling: odd H / W, C 3 to
   130, windows 2 to 4, blocked equal to naive bit for bit; flash: S 1 to
   4096, the bf16 kernel's 128-row tiles and slabs at their edges (S 127
   to 257), Sq != Sk both ways, causal and not, G 1 / 2 / 5 / 8, hd 64 /
   128, each case printing the path it took), then the study's
   layernorm, pooling and attention sections at card shapes, counted and
   placed on the roof the same way; then the flash kernel beside its
   build with P rounded once to bf16 at the two card shapes (times in
   turns, each one's error over the bf16 tolerance);
5. engine phases, one per path, random weights from generators seeded 0;
   every request must finish, each path's kernel launch counts (zeroed
   just before the run, read just after) must match its step counts
   times the kernels of a call (two for the MLA wrappers' tensor-core
   core, a split and a merge kernel; one for the GQA core), and
   one step's logits must match the same work done with the plain
   attention:
   a. the continuous-batching engine on full-width qwen3-0.6b (GQA);
   b. speculative decoding, self-draft: qwen3-0.6b drafting for itself
      (k 4); its acceptance rate must stay above 0.5;
   c. the engine on full-width deepseek-v2-236b cut to 4 layers (MLA +
      MoE);
   d. speculative decoding on that deepseek with the n-gram proposer
      (k 3), through the MLA verify kernel;
   e. speculative decoding on full-width, full-depth qwen3-14b verified
      against a full-width qwen3-0.6b draft model (k 4), Q14_NEW_TOKENS
      new tokens a request, through the GQA verify kernel (the draft's
      catch-up too) and the decode kernel (the draft's steps); tok/s
      beside the plain engine's on the same prompts;
   every speculative stream must equal the plain engine's greedy stream,
   or differ first where the plain engine's top-2 logit margin is under
   the logits tolerance; after each of a-e, the same prompts and weights
   served again with ``EngineConfig.pipeline`` off, double, double, off
   (deterministic algorithms on for the MoE model): every run's greedy
   streams byte-equal, each double run launching the ring kernels
   layers x steps times and no off paged kernel, each off run the
   reverse, tok/s of every run printed (one call, so comparable); then
   the same prompts and weights served with quantized KV pools
   (``EngineConfig.kv_dtype`` int8 and fp8_e4m3; qwen3-14b int8 only),
   pipeline off: every request finishes, the off kernels launch layers x
   steps times, the pools' device bytes equal the scheduler's pricing,
   one step's logits match the plain attention on copies of the quantized
   pools; tok/s, peak memory and the share of greedy tokens equal to the
   bf16 streams printed beside the bf16 run's; then each quantized engine
   served again with pipeline double (deterministic algorithms for the
   MoE model, both runs): greedy streams byte-equal to the off run's, the
   ring kernels launched layers x steps times and no off kernel, tok/s
   of both runs printed;
   f. CUDA graphs: every engine above replays captured graphs of its
   decode, verify, catch-up and draft steps and of its prefill chunks
   and prompt buckets, one per shape (on by default on the card),
   and each wrapper's launch count adds at each replay what its capture
   counted, so every launch hold above holds under replay; the pipeline
   runs are off and double with graphs, then double and off eager
   (``cuda_graphs=False``): all four byte-equal, each with its launch
   counts; on qwen3-0.6b each quantized pool is served eagerly too, byte-
   equal to its graphed run; ``[graph]`` lines print tok/s, mean decode /
   verify step and draft round both ways and the capture time;
   torch.profiler passes over three replays of each path's captured
   steps (after three it drops; the fullest of three passes: the
   profiler loses events) count the GQA core's kernel (or the MLA core's
   split and merge kernels) once per layer a replay; ``[dispatch]`` lines print
   ``Engine.measure_dispatch_overhead`` (the no-kernel decode step, the
   paper's dispatch floor) eager and graphed beside the mean decode step
   both ways, for qwen3-0.6b and qwen3-14b;
   g. serve telemetry on the measured roofs (``roof.to_chipspec()``):
   qwen3-0.6b graphed, telemetry off and on in turns, twice each (greedy
   streams and launch counts equal, tok/s on within 1.25x of off, a valid
   trace with the reference's events, every attainment window within
   105% of its roof, printed through ``attainment_rows``, the TTFT
   breakdown summing to TTFT, ``Engine.hierarchy_report``); the measured
   runs of deepseek-v2 (c) and speculative qwen3-14b (e) with telemetry
   on print one ``[telemetry]`` attainment line each (with the propose /
   verify spans);
   h. engine options (``[options]``), qwen3-0.6b at full size and
   deepseek-v2 at 4 layers, each case served graphed and eagerly with
   byte-equal streams, pools byte-equal outside page 0, equal launch
   counts and equal ``capacity_report``s: prefix sharing (a 96-token
   prefix with three tails, and a 128-token prompt twice, the second an
   aligned full hit: a T = 1 chunk after copy-on-write; deduplicated
   pages and copies > 0; streams equal the prefix-off run's or first
   differ under its top-2 margin; deepseek-v2 must refuse
   ``prefix_cache=True``), preemption by swap and by recompute in a pool
   of PREEMPT_PAGES (preemptions > 0, swapped bytes > 0; streams against
   the fully backed run: swap exactly, recompute under the top-2 margin
   rule, deepseek-v2's recompute reported only), seeded sampled requests
   (temperature 0.8, top-k 50, top-p 0.9); then SAMPLER_DRAWS seeded draws
   of the sampler from one row of qwen3's vocabulary: none outside the
   kept set, total variation against the filtered, tempered softmax
   within ``sampling.tv_null_bound``;
   i. prefill graphs (prefill ``[graph]`` lines), qwen3-0.6b and
   deepseek-v2: PROMPT_LENS twice on a graphed and an eager engine, the
   second pass timed: streams, pools outside page 0 and launches equal,
   the captured prefill shapes and their capture time, the mean prefill
   step and TTFT both ways, peak memory and each way's prefill time
   budget (``time_budget_rows`` on the measured betas less the engine's
   dispatch floor);
   j. the roofline cross-checks (``[crosscheck]`` lines,
   ``serve/crosscheck.py``): each core's on-chip bytes at its kernel
   phase's main inputs over the measured L2 beta as a share of its
   measured time (at most 1.05); on qwen3-0.6b 4 slots mid-decode the
   ledger's W and Q against the op-level walk of the decode step (W
   within 10%, the paged attention priced as the kernel; weights + KV
   equal to the ledger's Q plus terms counted from the trees), the
   ``vmem`` ledger against the launch-grid walk (ratio 1.0), the graphed
   decode step's wall against max(W / pi, Q / beta) of the walked decode
   + sample body (floor share at most 1), and ``crosscheck_overlap``
   pipeline off against double (streams byte-equal, the ``vmem`` term not
   grown, wall within +25%); ``crosscheck_host`` on the options phase's
   swap engines (ratio 1.0); deepseek-v2's walk with the all-experts gap
   attributed to the ``moe_experts`` scope; speculative qwen3-14b's
   verify step's measured intensity above 2.5 times the decode step's;
   k. the recurrent and hybrid mixers (``[recurrent]`` lines):
   xlstm-350m at its published widths cut to XLSTM_LAYERS (one period:
   7 mLSTM, 1 sLSTM) and
   jamba-v0.1-52b at its published widths cut to JAMBA_LAYERS (one
   period: 1 GQA layer, 7 mamba, 4 MoE FFNs of 16 experts), each served
   as in a (every request finishes, ``paged_attention`` once per
   attention layer and step, 0 for xlstm), then with pipeline off /
   double, graphed and eager (streams byte-equal, the rings once per
   step), a slot left out of three decode steps keeping its state rows
   bit for bit, xlstm's greedy tokens within XL_GAP_ATOL of a
   forward_full over their tokens; mean step graphed and eager, kernels
   a step, the ledger's Q split into weights, state and KV, the decode
   floor share and peak memory; the options of h on both (prefix_cache
   refused, swap and recompute preemption in PREEMPT_PAGES: swap equal
   to the fully backed run, recompute under the top-2 margin rule or
   reported for the MoE model; the host cross-check with the state rows
   in the swap, ratio 1.0; sampled); ``crosscheck_decode`` with the state
   rows as their own category (bytes hold, W reported) and the walked
   floor share; row 1 and its ring held at jamba's G 4 and timed before
   jamba's engine; jamba's 26.6 GB freed at the end;
   l. the static whole-batch path (``[static]`` lines, ``StaticEngine``
   over dense caches): row 1 held (TOL, TOL_F32_PLAIN) and timed at the
   static shapes, a dense cache viewed as 16-line pages under the
   identity table: whisper-small's self attention, its cross attention
   over 1500 frames (1504 lines, pos 1499) and llama-3.2-vision's over
   1600 image tokens; whisper-small whole (12 + 12 layers, 1500 frames)
   over 4 rows of 24-token prompts, 32 new tokens, and
   llama-3.2-vision-90b at its published widths cut to VISION_LAYERS (2
   cross and 8 self layers) over 2 rows, 16 new tokens, each with every
   cross gate set in [0.5, 1.5) and seeded sources: greedy streams byte-
   equal graphed and eager, ``paged_attention`` launched once per self
   and cross layer and step, every greedy token within LOGITS_ATOL of
   the top logit of a forward_full over its tokens, another source
   moving the first logits by more than LOGITS_ATOL; mean decode step
   both ways, prefill (and whisper's encoder alone), peak memory; the
   vision weights freed; qwen3-0.6b's static streams equal to the
   continuous engine's ``generate``, greedy and seeded sampled, byte for
   byte;
   m. tensor-parallel serving (``[tp]`` lines, serve/shard.py): rows 1,
   3 and 4 held against their plain versions at the local head counts
   tp 2 gives them (TP_KV KV heads at G 5, decode and verify at T
   TP_VERIFY_T; TP_MLA_H MLA heads) and timed; the unsharded engine
   first, eager, on qwen3-14b whole and on an MLA model
   with a dense FFN at deepseek-v2-236b's attention widths (TP_MLA_LAYERS
   layers), keeping its streams, each token's top-2 margin and the first
   decode step's logits, its weights freed; then two ranks on this one
   card over gloo with CUDA tensors (``parallel.mesh.spawn``), eager, each
   drawing only its shards of the same generator-seeded weights: 4
   requests of TP_PROMPTS tokens, TP_NEW new tokens, 4 slots; tokens equal
   on both ranks, streams equal to the unsharded ones or parted under the
   top-2 margin rule (TP_LOGITS_ATOL), the first decode logits within
   TP_LOGITS_ATOL, row 1 (qwen3-14b, 4 local KV heads) and row 4
   (MLA-dense, 64 local heads over a replicated latent pool) launched
   layers x steps times a rank, the ledger's TP_STEP_BYTES a qwen3-14b
   step, ``crosscheck_collectives`` within 1.15 with 2 x layers
   all-reduces and one all-gather; qwen3-14b again through
   ``ShardedSpecEngine`` (n-gram, k 3): row 3 launched layers x verify
   steps, the verify charge ``decode_step_ici_bytes(cfg, 4, 2, 4)`` a
   round; per-rank peak memory, the eager step tp 2 against tp 1 and the
   collectives' share of a step (CUDA events around the edges); then a
   CUDA graph captured over ``row_parallel_psum`` and ``all_gather_cols``
   on NCCL with a world of one (the capture dispatching one all-reduce
   and one all-gather), replayed equal to eager (NCCL at tp > 1 needs two
   cards); rows 1 (at the static shapes too), 3 and 4 timed beside one
   library call (gather + SDPA) where they are held;
   n. the multi-replica serving tier (``[router]`` lines,
   serve/{cluster,router}.py): two replicas colocated on this card (one
   copy of the weights), stepped in turn by the router, qwen3-0.6b whole
   and graphed, page 16, 4 slots a replica, PROMPT_LENS with NEW_TOKENS
   new: mixed (no migration), disaggregated 1 prefill + 1 decode, a
   rescue run (replica 0 mixed in ROUTER_RESCUE_PAGES pages preempting by
   swap, its preemptees moved to the decode-only replica 1), int8 pages
   disaggregated, seeded sampling (temperature 0.8, top-k 50, top-p 0.9)
   disaggregated, n-gram speculation (k 3) disaggregated; then the [tp]
   phase's MLA-dense model (deepseek-v2-236b's attention widths, 4
   layers, dense FFNs) disaggregated: in every disaggregated run each
   migrated request's pages (scale slabs and latents included) gathered
   through the destination's block table right after the restore equal
   the source's just before the export, bit for bit; every run's tokens
   equal one engine's on the same weights (a parting fails, with that
   engine's top-2 margin at the token); migration bytes within 15% of
   the analytic page model; rows 1 / 3 / 4 launched on each replica
   layers x that replica's steps; the migration wall a request, the
   router's tok/s beside one engine's, the TTFT split and peak memory
   printed;
   o. training (``[train]`` lines, train/ and launch/train.py; run
   while nvcc builds, its step against the measured roofs printed after
   the primitive study): qwen3-0.6b whole through ``launch/train.py``'s
   ``main`` (bf16 weights, float32 AdamW moments, remat full, B 4 x S
   2048, 8 cosine steps at lr 3e-4): its pre-flight report (the op
   walk of the step on fake tensors: W against the model FLOPs, the
   bound on the data sheet and on the measured roofs beside the
   measured step), the loss at every step
   (it must fall), the median step of steps 3-8, tokens/s, the model
   FLOPs' share of the measured bf16 matmul roof and peak memory; the
   whole state's checkpoint (bytes, save_async's snapshot and write,
   the restore, equal bit for bit); grad_accum 2 against the full batch
   on the same step (loss and global gradient norm within the tolerances
   derived in ``accumulation_check``); the bitwise resume under
   deterministic algorithms (qwen3-0.6b's widths at 2 layers, a fault at
   step 4, a restart: losses and final state equal an uninterrupted
   run's); deepseek-v2-236b at full width, 2 layers (dense + MoE), one
   forward and backward with the data-local dispatch: loss, nll, aux,
   finite gradients, the routed experts that got tokens (each with
   nonzero gradients, the others zero), peak memory
   (``deepseek_dispatch_check``); the training
   path launches none of the 14 kernels (every wrapper's count unchanged);
   p. data-parallel training (``[train-dp]`` lines): launch/train.py
   --data 2 on two gloo ranks, the restore at data 1, qwen3-0.6b (its
   widths at GLOO_LAYERS layers) and deepseek-v2 held against one rank,
   the NCCL world of one;
   q. tensor-parallel training (``[train-tp]`` lines, train/step.py on a
   ``model`` axis): gloo ranks on this card; qwen3-0.6b (its widths at
   GLOO_LAYERS layers) at (data 1, model 2), bf16, remat full, B 4 x S
   1024, 3 steps, step 1 against one rank on the same rows and weights
   (loss within tp_loss_bar, grad norm within TP_GNORM_RTOL, every
   gradient leaf gathered whole within TP_GRAD_RTOL, parameters within
   one bf16 ulp + TP_PARAM_LR lr and, beyond one ulp + lr x 2^-7, only
   where the gradients' signs differ,
   derived beside the constants), replicated leaves bit-equal on both
   ranks, moments, peak, step and gloo edge ms per rank, the checkpoint
   of step 2 restored at (1, 1) bit for bit and stepped (step 3's loss
   within tp_loss_bar); qwen3-0.6b at (data 2, model 2), four ranks, B 4
   x S 512, 2 steps (moment blocks a quarter of one rank's, loss against
   one rank); deepseek-v2 at 2 layers, model 2 (80 experts and 64 MLA
   heads a rank; in bf16, every token routed otherwise than on one rank
   has a top-6 margin within twice its router probabilities' measured
   change, and the kept pairs differ only in those tokens' experts; in
   float32 the kept pairs equal one rank's; loss and aux within
   TP_MOE_RTOL); every rank's pre-flight walk, its ``model`` bytes equal
   to ``train.step.tp_wire_bytes`` and its ``data`` bytes to
   ``dp_wire_bytes``; no ported kernel launched;
   r. the production-mesh dry run (``[dryrun]`` lines,
   launch/dryrun.py): one rank of qwen3-14b/train_4k on the 16 x 16 mesh
   (40 heads over 16: context-parallel attention at full width) and of
   deepseek-v2-236b/prefill_32k on 2 x 16 x 16 walked on fake tensors
   over a fake process group, their terms, walk seconds, collective
   bytes by axis and MODEL_FLOPS over W; both archives re-priced
   (launch/reanalyze.py) on the data sheet (equal to the walk's own
   numbers) and on the measured roofs (the walks run in a process of
   their own on one CPU thread from the script's start); then context
   parallelism for real: minicpm-2b at 2 layers on (data 1, model 5), 36
   heads over 5, five gloo ranks on this card, bf16, step 1 against one
   rank (loss within tp_loss_bar, grad norm within TP_GNORM_RTOL),
   replicated leaves bit-equal on every rank, the step's walked ``model`` bytes
   equal to ``train.step.tp_wire_bytes``, no ported kernel launched; a
   third walk, qwen3-14b/decode_32k on 16 x 16 (its dense cache's lines
   cut over ``model``), its walked ``model`` bytes equal to
   ``train.step.decode_wire_bytes``;
   s. decode on a sequence-sharded dense cache (``[decode-sp]`` lines):
   qwen3-0.6b (its widths at GLOO_LAYERS layers) on three gloo ranks of
   this card at (data 1, model 3), which divides neither its KV nor its
   query heads: 4 prompts of 1000 tokens prefilled into a 3072-line
   cache (1024 lines a rank), 48 greedy steps crossing from rank 0's
   block into rank 1's (rank 2 empty); every step's logits against one
   process's unsharded decode_step on the rows fed the same token
   (dsp_bar, derived beside it), the streams equal or parting only
   under the margin rule, row 1's launches = layers x steps on every
   rank, the walked ``model`` bytes equal to ``decode_wire_bytes``;
   beside it, in a process of their own, the examples' legs
   (``[examples]`` lines: launch/quickstart.py, launch/roofline_analysis.py
   on the roofs the primitive study measured, launch/serve_lm.py) on the
   card, every request finished, with the launches of rows 1 and 4
   (serve_lm) and 8-10 (roofline_analysis);
6. one JSON line listing the 14 ported kernels (rows 1-6 with ``int8`` /
   ``fp8_e4m3`` fields: time, max error, bound, plain and library times
   of the scale branch; rows 2 and 6, the rings, at the decode inputs of
   rows 1 and 4; row 1 with ``static_launches``, the graphed static runs'
   launches, ``lse_ms``, its time with the log-sum-exp, and
   ``decode_sp_launches``, one rank's in [decode-sp]; rows 1, 3 and 4
   with ``tp_launches``, each rank's launches in the [tp] runs), then
   the card line, then the device line last.
   Each phase prints its wall time.

Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# main-path shapes: qwen3-0.6b decode (KV 8, G 2, hd 128), 4 slots, page 16,
# max_len 512 -> 32 blocks per slot
SLOTS, KV, G, HD, PAGE, MAX_LEN = 4, 8, 2, 128, 16, 512
N_BLOCKS = MAX_LEN // PAGE
N_PAGES = 1 + SLOTS * N_BLOCKS
N_LAYERS = 28
PROMPT_LENS = (17, 45, 80, 120, 160, 200)
NEW_TOKENS = 32
PREFILL_CHUNK = 64

# Kernel vs plain version on the same inputs.  f32: the kernel sums in
# another order.  bf16: the plain version (like the JAX reference) rounds
# the scores q.k to bf16 before scaling (error ~2^-9 |s|, so it grows with
# the logits: up to ~3% of p in the soft-cap case, whose q is 4x larger)
# and rounds p to bf16 before P.V; the kernel keeps both in float32, as the
# Pallas kernel does.  So bf16 is also held, tighter, against the plain
# version run in float32 on the same bf16 values (TOL_F32_PLAIN): there
# the only difference is the kernel's bf16 output rounding (2^-9 |out|).
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=6e-2, rtol=6e-2)}
TOL_F32_PLAIN = {"float32": dict(atol=2e-5, rtol=2e-5),
                 "bfloat16": dict(atol=1e-2, rtol=1e-2)}
# decode logits (std ~0.6): the kernel's and the plain attention's bf16
# roundings feed 28 layers of bf16 activations
LOGITS_ATOL = 0.1

# MLA path: deepseek-v2-236b at full width, cut to 4 layers (1 dense-FFN
# prologue + 3 MoE); decode attention (H 128, r 512, dr 64) over 4 slots,
# page 16, max_len 256 -> 16 blocks per slot; the kernel phase's live
# lines per slot (679 in all, every last page partly filled)
DS_LAYERS, DS_MAX_LEN, DS_NEW_TOKENS = 4, 256, 16
MLA_H, MLA_R, MLA_DR = 128, 512, 64
MLA_BLOCKS = DS_MAX_LEN // PAGE
MLA_LENS = (97, 163, 190, 229)
# queries at std 0.5, the scale of the model's absorbed q_lat at init
MLA_Q_STD = 0.5
# deepseek decode logits: the kernel keeps the scores and p in float32
# where the plain version rounds them to bf16 (~2^-9 relative); 4 layers
# of bf16 activations and top-6 routing over 160 experts amplify such
# rounding to a few hundredths of a logit (max |logit| ~2 at init), while
# attention that misses one cache line moves the logits by several tenths
DS_LOGITS_ATOL = 0.2

# verify kernels (speculative decoding).  GQA: qwen3-14b's verify step
# (KV 8, G 5, hd 128) at k = 4 (T 5), 4 slots, max_len 512 plus the k+1
# margin -> 33 blocks per slot.  MLA: deepseek-v2's at k = 3 (T 4), max_len
# 256 plus margin -> 17 blocks.  Both at MLA_LENS committed lines per slot.
V_T, V_G, V_BLOCKS = 5, 5, MAX_LEN // PAGE + 1
MLA_T, MLA_V_BLOCKS = 4, DS_MAX_LEN // PAGE + 1
# speculative engine phases: qwen3-14b verified against a qwen3-0.6b
# draft; deepseek with the n-gram proposer.  Logits tolerances: one verify
# step against k+1 sequential decode steps with the plain attention, on
# pool copies.  Besides the kernel's float32 scores (see TOL), the verify
# step multiplies (slots x T)-row activations where decode multiplies
# slots-row ones, so bf16 GEMMs round differently: about a hundredth of a
# logit on qwen3-14b's 40 layers, while a kernel that misreads lines
# moves logits by tenths.  The same tolerances bound the plain engine's
# top-2 margin wherever a speculative stream first differs from it (bf16
# logits tie exactly at the top of a 152k vocabulary now and then).
SPEC_K, MLA_SPEC_K = 4, 3
Q14_LAYERS = 40
# qwen3-14b's speculative path decodes 16 new tokens a request (as
# deepseek-v2's paths do), not NEW_TOKENS: its eager and graphed runs of
# the 40 layers are the script's longest on a host that dispatches slowly
Q14_NEW_TOKENS = 16
SPEC_LOGITS_ATOL = 0.1
# self-draft: the same weights draft and verify, so greedy drafts are
# accepted but where bf16 rounding flips an argmax; a verify mask that let
# a query see a future line or miss its own would drive acceptance to ~0
SELF_DRAFT_MIN_ACCEPT = 0.5

HBM_BW = 3.35e12                              # H100 SXM data sheet, B/s
PEAK = {"float32": 67e12, "bfloat16": 989e12}  # FLOP/s, data sheet


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, inputs, reps: int = 25, per_sample: int = 10) -> float:
    """Median device time of one call, ms.  A sleep kernel queued first
    lets the host enqueue ``per_sample`` calls back to back, so the events
    bracket device work, not host dispatch; ``inputs`` rotates over copies
    larger than L2 together, so each call finds its operands cold."""
    import numpy as np
    import torch
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    samples = []
    k = 0
    for _ in range(reps):
        torch.cuda._sleep(20_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per_sample):
            fn(*inputs[k % len(inputs)])
            k += 1
        e.record()
        e.synchronize()
        samples.append(s.elapsed_time(e) / per_sample)
    return float(np.median(samples))


def attention_case(torch, np, rng, dtype, kind: str, groups: int = G,
                   kv: int = KV):
    """Inputs of one kernel case at the main path's shapes (``groups``
    query heads a KV head, ``kv`` KV heads: qwen3-0.6b's by default)."""
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((SLOTS, kv, groups, HD),
                                             dtype="float32"))
    kp = torch.from_numpy(rng.standard_normal((N_PAGES, PAGE, kv, HD),
                                              dtype="float32"))
    vp = torch.from_numpy(rng.standard_normal((N_PAGES, PAGE, kv, HD),
                                              dtype="float32"))
    bt = torch.zeros((SLOTS, N_BLOCKS), dtype=torch.int32)
    pos = torch.zeros((SLOTS,), dtype=torch.int32)
    soft_cap = 0.0
    pages = list(rng.permutation(np.arange(1, N_PAGES)))
    if kind != "trash":
        for b in range(SLOTS):
            if kind == "full":
                n_ctx = MAX_LEN
            else:                                   # ragged, engine-like
                n_ctx = int(rng.integers(1, 260))
            live = -(-n_ctx // PAGE)
            bt[b, :live] = torch.tensor([int(pages.pop())
                                         for _ in range(live)])
            pos[b] = n_ctx - 1
    if kind == "soft_cap":
        q, soft_cap = q * 4.0, 30.0
    return dict(q=q.to(dev, dtype), k=kp.to(dev, dtype), v=vp.to(dev, dtype),
                bt=bt.to(dev), pos=pos.to(dev), scale=HD ** -0.5,
                soft_cap=soft_cap)


def paged_bound(pos, T: int, S: int, line_bytes: int, row_flops: int,
                io_bytes: int, isize: int):
    """The least time of one paged-attention call at page PAGE, as (bytes
    ms, operations ms).  Bytes: each slot's visible lines (its last query
    token's pos + T of them, at most S) read once at ``line_bytes``, the
    live table entries and positions read once, the queries and output
    (``io_bytes``) moved once, over HBM bandwidth.  Operations:
    ``row_flops`` per (query token, line it sees) at the dtype's peak."""
    rows = [[min(int(p) + t + 1, S) for t in range(T)]
            for p in pos.tolist()]
    lines = sum(r[-1] for r in rows)
    touched = sum((r[-1] - 1) // PAGE + 1 for r in rows)
    nbytes = lines * line_bytes + io_bytes + touched * 4 + len(rows) * 4
    dt = "bfloat16" if isize == 2 else "float32"
    return (nbytes / HBM_BW * 1e3,
            sum(map(sum, rows)) * row_flops / PEAK[dt] * 1e3)


def bound_of(bytes_ms: float, ops_ms: float):
    """(bound ms, what bounds it)."""
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


# Row 1's log-sum-exp (return_lse, the flash-decoding merge's weight)
# against the plain version's, torch.logsumexp of its masked scores, the
# plain version run in float32 on the same (bf16) values, as ``hold``'s
# TOL_F32_PLAIN: bf16 products are exact in float32, so the two scores
# differ only by the order of their hd float32 additions (the tensor
# cores' accumulation may truncate rather than round: 2^-23 an addition),
# at most hd 2^-23 of the terms' magnitudes sum_i |q_i k_i| scale; lse is
# 1-Lipschitz in the scores' max norm (a soft cap's tanh too), so it
# moves by at most that for the row's largest such sum; both sum up to
# 512 exponentials in float32 in other orders: 2^-15 more, relative to
# |lse| and 1.  (Against the bf16 plain version, which rounds each score
# to bf16 in a library GEMM of unstated reduction order, the difference
# is printed, not held.)
LSE_SUM, LSE_EXP = 2.0 ** -23, 2.0 ** -15


def lse_hold(torch, pa, label: str, args, kw, dtype) -> float:
    """paged_attention with return_lse against itself without (o bit for
    bit) and against the float32 plain version's lse within the bar
    above; rows with pos < 0 (their tables may point anywhere) must give
    o = 0 and lse = -inf.  Returns the worst share of the bar."""
    q, k, v, bt, pos = args
    o, lse = pa.paged_attention(*args, **kw, return_lse=True)
    o_off = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    seen = pos >= 0
    safe_bt = torch.where(seen[:, None], bt, torch.zeros_like(bt))
    _, lse_p = pa.paged_attention_reference(q, k, v, safe_bt, pos, **kw,
                                            return_lse=True)
    _, lse32 = pa.paged_attention_reference(
        q.float(), k.float(), v.float(), safe_bt, pos, **kw,
        return_lse=True)
    B_, KV_, G_, hd = q.shape
    lines = bt.shape[1] * k.shape[1]
    kk = k[safe_bt.long()].reshape(B_, lines, KV_, hd).float()
    terms = torch.einsum("bkgh,bskh->bkgs", q.float().abs(), kk.abs()) \
        * kw["scale"]
    vis = torch.arange(lines, device="cuda")[None, :] <= pos.long()[:, None]
    top = torch.where(vis[:, None, None, :], terms, 0).amax(-1)
    bar = hd * LSE_SUM * top + LSE_EXP * (1 + lse32.abs())
    err = (lse - lse32).abs()
    share = float((err[seen] / bar[seen]).max()) if bool(seen.any()) else 0.0
    same = bool(torch.equal(o, o_off))
    empty_ok = bool((o[~seen] == 0).all()) and bool(
        torch.isneginf(lse[~seen]).all())
    worst = (lambda e: float(e[seen].max()) if bool(seen.any()) else 0.0)
    print(f"[kernel] {label} lse: max |lse - plain in f32| "
          f"{worst(err):.3e}, {share:.3f} of its bar (|lse - plain| "
          f"{worst((lse - lse_p).abs()):.3e}); o with lse on = off bit "
          f"for bit: {same}; {int((~seen).sum())} rows with no line: o = "
          f"0, lse = -inf: {empty_ok}")
    if not same or share > 1 or not empty_ok or not bool(
            torch.isfinite(o).all()):
        fail(f"{label}: the log-sum-exp misses its holds")
    return share


def lse_holds(torch, np, pa, rng) -> None:
    """Row 1's return_lse at the phase's main shapes and edge cases, bf16
    and float32, and a table whose rows all lie past pos (pos -1, table
    entries far past the pool: nothing may be read)."""
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for kind in ("ragged", "full", "trash", "soft_cap", "empty"):
            c = attention_case(torch, np, rng, dtype,
                               "ragged" if kind == "empty" else kind)
            if kind == "empty":
                c["pos"][1::2] = -1
                c["bt"][1::2] = 1 << 30
            lse_hold(torch, pa, f"paged_attention {name:8s} {kind:8s}",
                     (c["q"], c["k"], c["v"], c["bt"], c["pos"]),
                     dict(scale=c["scale"], soft_cap=c["soft_cap"]), dtype)


def kernel_phase(torch, np, pa):
    """paged_attention (CUDA) vs paged_attention_reference on the card, and
    the GQA ring kernel at decode (T = 1) against both, and its
    log-sum-exp (:func:`lse_holds`).  Returns the kernels-line entry and
    the ring's error and time at the same inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import quantize as kvq
    rng = np.random.default_rng(0)
    errs, ring_errs, qerrs = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for kind in ("ragged", "full", "trash", "soft_cap"):
            c = attention_case(torch, np, rng, dtype, kind)
            args = (c["q"], c["k"], c["v"], c["bt"], c["pos"])
            kw = dict(scale=c["scale"], soft_cap=c["soft_cap"])
            errs[(name, kind)] = hold(
                torch, f"paged_attention {name:8s} {kind:8s}",
                pa.paged_attention, pa.paged_attention_reference, args, 3,
                kw, name)
            ring_errs[(name, kind)] = ring_hold(
                torch, f"paged_attention_ring (decode) {name:8s} {kind:8s}",
                pa.paged_attention_ring, pa.paged_attention,
                pa.paged_attention_reference, args, 3, kw, name)
            quant_cases(torch, kvq, f"paged_attention {name:8s} {kind:8s}",
                        pa.paged_attention, pa.paged_attention_reference,
                        args, 1, ("k_scale", "v_scale"), kw, name, qerrs,
                        kind, ring=pa.paged_attention_ring)
    lse_holds(torch, np, pa, rng)
    # times at the main path's shapes and types: bf16, engine-like ragged
    # contexts; 16 copies (~135 MB) rotate so every call reads cold HBM
    c = attention_case(torch, np, rng, torch.bfloat16, "ragged")
    copies = [(c["q"].clone(), c["k"].clone(), c["v"].clone(), c["bt"],
               c["pos"]) for _ in range(16)]
    kw = dict(scale=c["scale"], soft_cap=0.0)
    n = pa.paged_attention.launches
    n_ring = pa.paged_attention_ring.launches
    kernel_ms = device_ms(lambda *a: pa.paged_attention(*a, **kw), copies)
    lse_ms = device_ms(lambda *a: pa.paged_attention(*a, **kw,
                                                     return_lse=True), copies)
    ring_ms = device_ms(lambda *a: pa.paged_attention_ring(*a, **kw), copies)
    plain_ms = device_ms(lambda *a: pa.paged_attention_reference(*a, **kw),
                         copies)
    ONCHIP["paged_attention (GQA core, decode)"] = (onchip_call(
        pa, c["pos"], 1, N_BLOCKS, kv_heads=KV, groups=G, head_dim=HD),
        kernel_ms, ring_ms)
    S = N_BLOCKS * PAGE
    k_pos = torch.arange(S, device="cuda")
    mask = (k_pos[None, :] <= c["pos"].long()[:, None])[:, None, None, :]

    def library(q, k, v, bt, pos, ks=None, vs=None):
        # gather (and dequantize) the pages, then torch's fused attention
        # with the mask
        kk = gather_pages(k, ks, bt, q.dtype).reshape(
            SLOTS, S, KV, HD).transpose(1, 2)
        vv = gather_pages(v, vs, bt, q.dtype).reshape(
            SLOTS, S, KV, HD).transpose(1, 2)
        qq = q.reshape(SLOTS, KV * G, 1, HD)
        return F.scaled_dot_product_attention(
            qq, kk.repeat_interleave(G, dim=1), vv.repeat_interleave(G, 1),
            attn_mask=mask, scale=c["scale"]).reshape(SLOTS, KV, G, HD)

    lib_out = library(*copies[0])
    lib_err = float((lib_out.float() - pa.paged_attention_reference(
        *copies[0], **kw).float()).abs().max())
    if lib_err > TOL["bfloat16"]["atol"]:
        fail(f"library yardstick disagrees with the plain version: {lib_err}")
    library_ms = device_ms(library, copies)
    isize = c["q"].element_size()
    gqa_split_report(torch, kvq, pa, "paged_attention", pa.paged_attention,
                     copies, kw, 1, N_BLOCKS)

    def bound(kv_isize, scale_bytes=0):
        return paged_bound(c["pos"], 1, S, KV * (HD * kv_isize + scale_bytes)
                           * 2, KV * G * 4 * HD, 2 * c["q"].numel() * isize,
                           isize)
    bytes_ms, ops_ms = bound(isize)
    bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
    quant, ring_quant = quant_times(
        torch, kvq, "paged_attention", pa.paged_attention,
        pa.paged_attention_reference, library, copies, 1,
        ("k_scale", "v_scale"), kw, lambda kvd: bound_of(*bound(1, 4)),
        qerrs, kernel_ms, pa.paged_attention_ring, ring_ms)
    pa.paged_attention.launches = n        # comparison launches do not count
    pa.paged_attention_ring.launches = n_ring
    print(f"[kernel] paged_attention bf16 B={SLOTS} KV={KV} G={G} hd={HD} "
          f"page={PAGE} lines={int((c['pos'].long() + 1).sum())}: "
          f"kernel {kernel_ms:.4f} ms, ring kernel {ring_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library (gather + SDPA) {library_ms:.4f} ms, "
          f"bound {bound_ms:.5f} ms ({bound_by}; operations {ops_ms:.5f} ms "
          f"at bf16 peak)")
    print(f"[kernel] paged_attention bf16 with its log-sum-exp "
          f"(return_lse, the sequence-sharded decode's call): {lse_ms:.4f} "
          f"ms beside {kernel_ms:.4f} ms without, same inputs")
    return (dict(name="paged_attention", route="cuda",
                 source="src/repro_torch/csrc/gqa_core.cu",
                 replaces="src/repro/kernels/paged_attention.py:345",
                 max_abs_err=errs[("bfloat16", "ragged")], ms=kernel_ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=library_ms, lse_ms=lse_ms, **quant),
            dict(max_abs_err=ring_errs[("bfloat16", "ragged")], ms=ring_ms,
                 **ring_quant))


def mla_case(torch, np, rng, dtype, kind: str, heads: int = MLA_H):
    """Inputs of one MLA kernel case at ``heads`` query heads.  ``ragged``:
    the main path's shapes and MLA_LENS; ``edges``: pos 0, a partly filled
    last page, one exact page and a full table; ``trash``: every slot idle
    (all entries trash page 0, pos 0); ``small``: smoke widths (H 4, r 32,
    dr 8, page 8)."""
    B, H, r, dr, page, nb = SLOTS, heads, MLA_R, MLA_DR, PAGE, MLA_BLOCKS
    lens = {"ragged": MLA_LENS, "edges": (1, 37, 16, DS_MAX_LEN),
            "trash": None, "small": (1, 9, 20)}[kind]
    if kind == "small":
        B, H, r, dr, page, nb = 3, 4, 32, 8, 8, 4
    P = 1 + B * nb
    g = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape, dtype="float32"))
    q_lat, q_rope = g(B, H, r) * MLA_Q_STD, g(B, H, dr) * MLA_Q_STD
    c, kr = g(P, page, r), g(P, page, dr)
    bt = torch.zeros((B, nb), dtype=torch.int32)
    pos = torch.zeros((B,), dtype=torch.int32)
    if lens is not None:
        pages = list(rng.permutation(np.arange(1, P)))
        for b, n in enumerate(lens):
            live = -(-n // page)
            bt[b, :live] = torch.tensor([int(pages.pop())
                                         for _ in range(live)])
            pos[b] = n - 1
    dev = "cuda"
    return dict(args=(q_lat.to(dev, dtype), q_rope.to(dev, dtype),
                      c.to(dev, dtype), kr.to(dev, dtype), bt.to(dev),
                      pos.to(dev)),
                scale=(128 + 64) ** -0.5)


def mla_bound(q_lat, q_rope, pos, T: int, S: int, kv_isize: int = 0):
    """:func:`paged_bound` of an MLA call: (r + dr)-element lines (at
    ``kv_isize`` bytes a code plus two float32 scales when quantized, else
    the queries' itemsize), H * (2 (r + dr) + 2 r) FLOPs per (query token,
    line), q_lat, q_rope and the output moved once."""
    H, r, dr = q_lat.shape[-2], q_lat.shape[-1], q_rope.shape[-1]
    isize = q_lat.element_size()
    line = (r + dr) * kv_isize + 8 if kv_isize else (r + dr) * isize
    return paged_bound(pos, T, S, line,
                       H * (2 * (r + dr) + 2 * r),
                       (2 * q_lat.numel() + q_rope.numel()) * isize, isize)


# the MLA kernels' bf16 path against the model of its own arithmetic
# order (kernels.paged_attention.mla_split_model): float32 sums in another
# order, then one bf16 rounding of the output (one bf16 ulp, 2^-8
# relative, where the two fall either side of a rounding boundary)
MODEL_TOL = dict(atol=1e-3, rtol=2 ** -7)


def split_report(torch, kvq, pa, label: str, kernel, args, T: int,
                 page: int, n_blocks: int) -> None:
    """The bf16 tensor-core path at the main path's inputs: its chunk and
    block count (kernels.paged_attention.mla_split_plan), and the kernel
    against the split model on bf16, int8 and fp8 pools; fails past
    MODEL_TOL."""
    q_lat, pos = args[0], args[5]
    plan = pa.mla_split_plan(pos, T, page, n_blocks, q_lat.shape[-2],
                             q_lat.shape[-1])
    errs = []
    for kvd in ("bf16", *KV_DTYPES):
        if kvd == "bf16":
            a, skw = args, {}
        else:
            a, scales = quantize_pools(kvq, args, 2, kvd)
            skw = dict(zip(("c_scale", "r_scale"), scales))
        kw = dict(scale=(128 + 64) ** -0.5, **skw)
        out = kernel(*a, **kw)
        model = pa.mla_split_model(*a, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - model.float()).abs().max())
        if not torch.allclose(out.float(), model.float(), **MODEL_TOL):
            fail(f"{label} {kvd} disagrees with the split model: {err}")
        errs.append(f"{kvd} {err:.3e}")
    rows = q_lat.shape[0] * T
    print(f"[split] {label}: chunks of {plan['chunk_lines']} lines "
          f"({pa.MLA_CHUNK_PAGES} pages), {plan['blocks']} of "
          f"{plan['grid']} split blocks walk lines, then a merge kernel of "
          f"{rows * q_lat.shape[-2]} blocks; vs the split model "
          f"(atol {MODEL_TOL['atol']}, rtol 2^-7) max abs diff "
          + ", ".join(errs))


def gqa_split_report(torch, kvq, pa, label: str, kernel, copies, kw, T: int,
                     n_blocks: int) -> None:
    """The GQA core (bf16 path of rows 1-3) at a row's timing inputs: its
    chunks, grid, working blocks and merging row groups
    (kernels.paged_attention.gqa_split_plan); the kernel against the split
    model (gqa_split_model) on bf16, int8 and fp8 pools, failing past
    MODEL_TOL."""
    q, k, v, bt, pos = copies[0]
    KV, G = q.shape[-3], q.shape[-2]
    plan = pa.gqa_split_plan(pos, T, k.shape[1], n_blocks, G, KV)
    errs = []
    for kvd in ("bf16", *KV_DTYPES):
        if kvd == "bf16":
            a, skw = copies[0], {}
        else:
            a, scales = quantize_pools(kvq, copies[0], 1, kvd)
            skw = dict(zip(("k_scale", "v_scale"), scales))
        out = kernel(*a, **kw, **skw)
        model = pa.gqa_split_model(*a, **kw, **skw)
        torch.cuda.synchronize()
        err = float((out.float() - model.float()).abs().max())
        if not torch.allclose(out.float(), model.float(), **MODEL_TOL):
            fail(f"{label} {kvd} disagrees with the split model: {err}")
        errs.append(f"{kvd} {err:.3e}")
    print(f"[split] {label}: chunks of {plan['chunk_lines']} lines "
          f"({pa.GQA_CHUNK_PAGES} x {k.shape[1]}-line pages), "
          f"{plan['blocks']} of {plan['grid']} blocks walk lines, "
          f"{plan['merges']} row groups merge in their last block, one "
          f"launch; vs the split model "
          f"(atol {MODEL_TOL['atol']}, rtol 2^-7) max abs diff "
          + ", ".join(errs))


def mla_kernel_phase(torch, np, pa):
    """mla_paged_attention (CUDA) vs mla_paged_attention_reference, and the
    MLA ring kernel at decode (T = 1) against both.  Returns the
    kernels-line entry and the ring's error and time at the same inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import quantize as kvq
    rng = np.random.default_rng(2)
    errs, ring_errs, qerrs = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for kind in ("ragged", "edges", "trash", "small"):
            c = mla_case(torch, np, rng, dtype, kind)
            errs[(name, kind)] = hold(
                torch, f"mla_paged_attention {name:8s} {kind:6s}",
                pa.mla_paged_attention, pa.mla_paged_attention_reference,
                c["args"], 4, dict(scale=c["scale"]), name)
            ring_errs[(name, kind)] = ring_hold(
                torch, f"mla_paged_attention_ring (decode) {name:8s} "
                f"{kind:6s}", pa.mla_paged_attention_ring,
                pa.mla_paged_attention, pa.mla_paged_attention_reference,
                c["args"], 4, dict(scale=c["scale"]), name)
            quant_cases(torch, kvq, f"mla_paged_attention {name:8s} "
                        f"{kind:6s}", pa.mla_paged_attention,
                        pa.mla_paged_attention_reference, c["args"], 2,
                        ("c_scale", "r_scale"), dict(scale=c["scale"]),
                        name, qerrs, kind, ring=pa.mla_paged_attention_ring)
    # times at the main path's shapes and type: bf16, MLA_LENS; 64 copies
    # of the queries and pools (~110 MB) rotate so every call reads cold
    # HBM
    c = mla_case(torch, np, rng, torch.bfloat16, "ragged")
    split_report(torch, kvq, pa, "mla_paged_attention", pa.mla_paged_attention,
                 c["args"], 1, PAGE, MLA_BLOCKS)
    q_lat, q_rope, cp, rp, bt, pos = c["args"]
    copies = [(q_lat.clone(), q_rope.clone(), cp.clone(), rp.clone(), bt,
               pos) for _ in range(64)]
    kw = dict(scale=c["scale"])
    n = pa.mla_paged_attention.launches
    n_ring = pa.mla_paged_attention_ring.launches
    kernel_ms = device_ms(lambda *a: pa.mla_paged_attention(*a, **kw),
                          copies)
    ring_ms = device_ms(lambda *a: pa.mla_paged_attention_ring(*a, **kw),
                        copies)
    plain_ms = device_ms(
        lambda *a: pa.mla_paged_attention_reference(*a, **kw), copies)
    ONCHIP["mla_paged_attention (MLA core, decode)"] = (onchip_call(
        pa, pos, 1, MLA_BLOCKS, n_heads=MLA_H, lora_rank=MLA_R,
        rope_dim=MLA_DR), kernel_ms, ring_ms)
    B, S = SLOTS, MLA_BLOCKS * PAGE
    k_pos = torch.arange(S, device="cuda")
    mask = (k_pos[None, :] <= pos.long()[:, None])[:, None, None, :]

    def library(ql, qr, cpool, rpool, bt, pos, cs=None, rs=None):
        # gather (and dequantize) the latent lines, then torch's fused
        # attention with k = [c | k_rope] and v = c, shared by every head
        cc = gather_pages(cpool, cs, bt, ql.dtype).reshape(B, 1, S, MLA_R)
        kk = torch.cat([cc, gather_pages(rpool, rs, bt, ql.dtype).reshape(
            B, 1, S, MLA_DR)], -1)
        qq = torch.cat([ql, qr], -1)[:, :, None, :]
        return F.scaled_dot_product_attention(
            qq, kk.expand(B, MLA_H, S, MLA_R + MLA_DR),
            cc.expand(B, MLA_H, S, MLA_R), attn_mask=mask,
            scale=c["scale"])[:, :, 0]

    lib_err = float((library(*copies[0]).float()
                     - pa.mla_paged_attention_reference(
                         *copies[0], **kw).float()).abs().max())
    if lib_err > TOL["bfloat16"]["atol"]:
        fail(f"MLA library yardstick disagrees with the plain version: "
             f"{lib_err}")
    library_ms = device_ms(library, copies)
    bytes_ms, ops_ms = mla_bound(q_lat, q_rope, pos, 1, S)
    bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
    quant, ring_quant = quant_times(
        torch, kvq, "mla_paged_attention", pa.mla_paged_attention,
        pa.mla_paged_attention_reference, library, copies, 2,
        ("c_scale", "r_scale"), kw,
        lambda kvd: bound_of(*mla_bound(q_lat, q_rope, pos, 1, S, 1)),
        qerrs, kernel_ms, pa.mla_paged_attention_ring, ring_ms)
    pa.mla_paged_attention.launches = n    # comparison launches do not count
    pa.mla_paged_attention_ring.launches = n_ring
    print(f"[kernel] mla_paged_attention bf16 B={SLOTS} H={MLA_H} "
          f"r={MLA_R} dr={MLA_DR} page={PAGE} lines={sum(MLA_LENS)}: "
          f"kernel {kernel_ms:.4f} ms, ring kernel {ring_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library "
          f"(gather + SDPA) {library_ms:.4f} ms (max abs diff vs plain "
          f"{lib_err:.3e}), bound {bound_ms:.5f} ms ({bound_by}; bytes "
          f"{bytes_ms:.5f} ms, operations {ops_ms:.5f} ms at bf16 peak)")
    return (dict(name="mla_paged_attention", route="cuda",
                 source="src/repro_torch/csrc/mla_core.cu",
                 replaces="src/repro/kernels/paged_attention.py:445",
                 max_abs_err=errs[("bfloat16", "ragged")], ms=kernel_ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=library_ms, **quant),
            dict(max_abs_err=ring_errs[("bfloat16", "ragged")], ms=ring_ms,
                 **ring_quant))


def hold(torch, label: str, kernel, plain, args, n_float: int, kw,
         name: str, tag: str = "kernel") -> float:
    """One kernel case against its plain version on the same inputs: at
    TOL[name], and at TOL_F32_PLAIN[name] against the plain version run in
    float32 on the same values (its first ``n_float`` arguments cast).
    Fails on a mismatch or a non-finite output; returns the max abs error
    against the plain version."""
    out = kernel(*args, **kw)
    ref = plain(*args, **kw)
    ref32 = plain(*(a.float() for a in args[:n_float]), *args[n_float:],
                  **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail(f"{label}: non-finite output")
    err = float((out.float() - ref.float()).abs().max())
    err32 = float((out.float() - ref32).abs().max())
    tol, tol32 = TOL[name], TOL_F32_PLAIN[name]
    ok = (bool(torch.allclose(out.float(), ref.float(), **tol))
          and bool(torch.allclose(out.float(), ref32, **tol32)))
    print(f"[{tag}] {label} max_abs_err={err:.3e} (atol=rtol="
          f"{tol['atol']}); vs plain in f32 {err32:.3e} (atol=rtol="
          f"{tol32['atol']}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{label} disagrees with its plain version: max abs err {err}")
    return err


def ring_hold(torch, label: str, ring, off, plain, args, n_float: int, kw,
              name: str) -> float:
    """One ring-kernel case: its output must equal the ``"off"`` kernel's
    on the same inputs bit for bit (torch.equal), then hold against the
    plain version as :func:`hold` does.  Returns that max abs error."""
    got, want = ring(*args, **kw), off(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        d = float((got.float() - want.float()).abs().max())
        fail(f"{label}: the ring kernel's output differs from the off "
             f"kernel's (max abs diff {d:.3e}); they must be bit-identical")
    print(f"[kernel] {label} equals the off kernel bit for bit")
    return hold(torch, label, ring, plain, args, n_float, kw, name)


# Quantized KV pools: each of the four single-walk kernels' scale
# branch against its plain version on the same codes and scales.  Both
# dequantize to the same float32 values and compute in float32, so only
# the summation order and a bf16 query's output rounding differ: float32
# 2e-5, bf16 1e-2 (TOL_F32_PLAIN, not the bf16 plain version's 6e-2).
KV_DTYPES = ("int8", "fp8_e4m3")
QTOL = TOL_F32_PLAIN


def quantize_pools(kvq, args, first: int, kv_dtype: str):
    """``args`` with its pools at ``first`` and ``first + 1`` quantized
    from their float32 values; returns (args, the two scale pools)."""
    out, scales = list(args), []
    for i in (first, first + 1):
        out[i], s = kvq.quantize(args[i].float(), kv_dtype)
        scales.append(s)
    return tuple(out), scales


def quant_hold(torch, label: str, kernel, plain, args, kw, name: str) -> float:
    """One quantized case (``kw`` carries the scale pools) against the
    plain version at QTOL[name]; returns the max abs error."""
    out = kernel(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail(f"{label}: non-finite output")
    err = float((out.float() - ref.float()).abs().max())
    tol = QTOL[name]
    ok = bool(torch.allclose(out.float(), ref.float(), **tol))
    print(f"[kernel] {label} max_abs_err={err:.3e} (atol=rtol="
          f"{tol['atol']}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{label} disagrees with its plain version: max abs err {err}")
    return err


def quant_cases(torch, kvq, label: str, kernel, plain, args, first: int,
                names, kw, name: str, errs: dict, kind: str, ring) -> None:
    """The quantized holds of one case, int8 and fp8, into ``errs``: the
    off kernel against the plain version, then the ring kernel (the
    scale branch of ``pipeline="double"``) equal to the off kernel bit for
    bit (torch.equal) on the same codes and scales and against the plain
    version at the same tolerance (its error under key ``"ring"``)."""
    for kvd in KV_DTYPES:
        qargs, scales = quantize_pools(kvq, args, first, kvd)
        skw = dict(kw, **dict(zip(names, scales)))
        errs[(name, kind, kvd)] = quant_hold(
            torch, f"{label} {kvd}", kernel, plain, qargs, skw, name)
        got, want = ring(*qargs, **skw), kernel(*qargs, **skw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            d = float((got.float() - want.float()).abs().max())
            fail(f"{label} {kvd}: the ring kernel's output differs from the "
                 f"off kernel's (max abs diff {d:.3e}); they must be "
                 "bit-identical")
        print(f"[kernel] {label} {kvd} ring equals the off kernel bit for "
              "bit")
        errs[(name, kind, kvd, "ring")] = quant_hold(
            torch, f"{label} {kvd} ring", ring, plain, qargs, skw, name)


def t1_equal(torch, kvq, label: str, name: str, verify, decode, args,
             n_q: int, first: int, names, kw) -> None:
    """On quantized pools, a one-token verify (``args``: T = 1 queries
    first, ``n_q`` of them) must equal the decode kernel bit for bit."""
    for kvd in KV_DTYPES:
        qargs, scales = quantize_pools(kvq, args, first, kvd)
        skw = dict(kw, **dict(zip(names, scales)))
        ver = verify(*qargs, **skw)[:, 0]
        dec = decode(*(a[:, 0].contiguous() for a in qargs[:n_q]),
                     *qargs[n_q:], **skw)
        torch.cuda.synchronize()
        if not torch.equal(ver, dec):
            d = float((ver.float() - dec.float()).abs().max())
            fail(f"{label} {name} {kvd}: T=1 differs from the decode kernel "
                 f"(max abs diff {d:.3e}); they must be bit-identical")
        print(f"[kernel] {label} {name:8s} {kvd} T=1 equals the decode "
              "kernel bit for bit")


def gather_pages(pool, scales, bt, dtype):
    """``pool[bt]``, dequantized to ``dtype`` when ``scales`` is given:
    the library yardsticks' gather (+ dequantize)."""
    g = pool[bt.long()]
    if scales is None:
        return g
    s = scales[bt.long()]
    return (g.float() * s.reshape(s.shape + (1,) * (g.dim() - s.dim()))
            ).to(dtype)


def quant_times(torch, kvq, label: str, kernel, plain, library, copies,
                first: int, names, kw, bound, errs: dict, bf16_ms: float,
                ring, ring_bf16_ms: float):
    """Times of one kernel's scale branch at the main path's bf16 inputs,
    each timing copy's pools quantized: kernel, ring kernel, plain version
    and library call (gather + dequantize + SDPA), with
    ``bound(kv_dtype)`` -> (ms, what bounds it) at the quantized line
    bytes.  Prints each beside the bf16-pool kernels' times of the same
    call; returns {kv_dtype: fields} for the kernel's and for the ring's
    kernels-line entries."""
    n = len(copies[0])
    out, ring_out = {}, {}
    for kvd in KV_DTYPES:
        qcopies = []
        for c in copies:
            qargs, scales = quantize_pools(kvq, c, first, kvd)
            qcopies.append(qargs + tuple(scales))

        def call(fn):
            return lambda *a: fn(*a[:n], **kw, **dict(zip(names, a[n:])))
        ms = device_ms(call(kernel), qcopies)
        ring_ms = device_ms(call(ring), qcopies)
        plain_ms = device_ms(call(plain), qcopies)
        lib_err = float((library(*qcopies[0]).float() - call(plain)(
            *qcopies[0]).float()).abs().max())
        if lib_err > TOL["bfloat16"]["atol"]:
            fail(f"{label} {kvd} library yardstick disagrees with the plain "
                 f"version: {lib_err}")
        library_ms = device_ms(library, qcopies)
        bound_ms, bound_by = bound(kvd)
        common = dict(plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=library_ms)
        out[kvd] = dict(ms=ms, max_abs_err=errs[("bfloat16", "ragged", kvd)],
                        **common)
        ring_out[kvd] = dict(
            ms=ring_ms,
            max_abs_err=errs[("bfloat16", "ragged", kvd, "ring")], **common)
        print(f"[kernel] {label} {kvd} pools, bf16 queries: kernel {ms:.4f} "
              f"ms ({ms / bf16_ms:.2f}x the bf16-pool kernel's "
              f"{bf16_ms:.4f} ms), ring kernel {ring_ms:.4f} ms "
              f"({ring_ms / ring_bf16_ms:.2f}x the bf16-pool ring's "
              f"{ring_bf16_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
              f"(gather + dequantize + SDPA) {library_ms:.4f} ms (max abs "
              f"diff vs plain {lib_err:.3e}), bound {bound_ms:.5f} ms "
              f"({bound_by})")
        del qcopies
    return out, ring_out


def verify_tables(torch, np, rng, lens, T: int, page: int, nb: int):
    """Block tables and first-token positions of a verify case: slot b
    holds ``lens[b]`` committed lines (pos = len - 1) and its T query
    tokens sit at pos .. pos + T - 1.  A len past nb * page runs the chain
    past the table.  ``lens`` None leaves every slot idle (all entries
    trash page 0, pos 0).  Returns the page count P and ``make(backed)``,
    which builds (bt, pos); ``backed`` False leaves the drafts' lines past
    the context on trash entries."""
    B = SLOTS if lens is None else len(lens)
    P = 1 + B * nb

    def make(backed: bool):
        bt = torch.zeros((B, nb), dtype=torch.int32)
        pos = torch.zeros((B,), dtype=torch.int32)
        if lens is not None:
            pages = list(rng.permutation(np.arange(1, P)))
            for b, n in enumerate(lens):
                lines = n + T - 1 if backed else n
                live = min(-(-lines // page), nb)
                bt[b, :live] = torch.tensor([int(pages.pop())
                                             for _ in range(live)])
                pos[b] = n - 1
        return bt, pos
    return P, make


def gqa_verify_case(torch, np, rng, dtype, kind: str, kv: int = KV,
                    T: int = V_T):
    """Inputs of one GQA verify case at qwen3-14b's verify shapes (4
    slots, KV 8, G 5, hd 128, T 5, page 16, 33 blocks; ``kv`` and ``T``
    override).  Kinds: ``ragged`` (MLA_LENS contexts, drafts backed),
    ``edges`` (chains crossing a page at pos 14 and 30, one at pos 0, one
    past the table; drafts backed), ``margin`` (the same with the drafts
    on trash entries), ``trash`` (idle lanes), ``soft_cap`` (4x queries,
    cap 30), ``t1`` (T = 1)."""
    T = 1 if kind == "t1" else T
    lens = {"ragged": MLA_LENS, "edges": (15, 31, 1, V_BLOCKS * PAGE + 2),
            "margin": (15, 31, 1, V_BLOCKS * PAGE + 2), "trash": None,
            "soft_cap": MLA_LENS, "t1": MLA_LENS}[kind]
    P, make = verify_tables(torch, np, rng, lens, T, PAGE, V_BLOCKS)
    bt, pos = make(backed=kind != "margin")
    g = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape, dtype="float32"))
    q = g(SLOTS, T, kv, V_G, HD) * (4.0 if kind == "soft_cap" else 1.0)
    dev = "cuda"
    return dict(args=(q.to(dev, dtype), g(P, PAGE, kv, HD).to(dev, dtype),
                      g(P, PAGE, kv, HD).to(dev, dtype), bt.to(dev),
                      pos.to(dev)),
                kw=dict(scale=HD ** -0.5,
                        soft_cap=30.0 if kind == "soft_cap" else 0.0))


def gqa_verify_kernel_phase(torch, np, pa):
    """paged_attention_verify (CUDA) vs paged_attention_verify_reference
    on the card, at T = 1 against the decode kernel, and the GQA ring
    kernel at verify shapes against both, on bf16 and quantized pools.
    Returns the kernels-line entry and the ring's times at the same
    inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import quantize as kvq
    rng = np.random.default_rng(3)
    errs, qerrs = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for kind in ("ragged", "edges", "margin", "trash", "soft_cap",
                     "t1"):
            c = gqa_verify_case(torch, np, rng, dtype, kind)
            errs[(name, kind)] = hold(
                torch, f"paged_attention_verify {name:8s} {kind:8s}",
                pa.paged_attention_verify, pa.paged_attention_verify_reference,
                c["args"], 3, c["kw"], name)
            quant_cases(torch, kvq, f"paged_attention_verify {name:8s} "
                        f"{kind:8s}", pa.paged_attention_verify,
                        pa.paged_attention_verify_reference, c["args"], 1,
                        ("k_scale", "v_scale"), c["kw"], name, qerrs, kind,
                        ring=pa.paged_attention_ring)
            ring_hold(torch, f"paged_attention_ring (verify) {name:8s} "
                      f"{kind:8s}", pa.paged_attention_ring,
                      pa.paged_attention_verify,
                      pa.paged_attention_verify_reference, c["args"], 3,
                      c["kw"], name)
            if kind == "t1":                 # one token = one decode step
                q, *rest = c["args"]
                ver = pa.paged_attention_verify(q, *rest, **c["kw"])[:, 0]
                dec = pa.paged_attention(q[:, 0].contiguous(), *rest,
                                         **c["kw"])
                torch.cuda.synchronize()
                d = float((ver.float() - dec.float()).abs().max())
                print(f"[kernel] paged_attention_verify {name:8s} T=1 vs "
                      f"the decode kernel: max abs diff {d:.3e}")
                # bf16: one core for both walks, bit for bit
                same = (torch.equal(ver, dec) if dtype == torch.bfloat16
                        else torch.allclose(ver.float(), dec.float(),
                                            **TOL_F32_PLAIN[name]))
                if not same:
                    fail(f"paged_attention_verify at T=1 differs from the "
                         f"decode kernel by {d}")
                t1_equal(torch, kvq, "paged_attention_verify", name,
                         pa.paged_attention_verify, pa.paged_attention,
                         c["args"], 1, 1, ("k_scale", "v_scale"), c["kw"])
    # times at the main path's shapes and type: bf16, MLA_LENS contexts;
    # 16 copies of the pools (~140 MB) rotate so every call reads cold HBM
    c = gqa_verify_case(torch, np, rng, torch.bfloat16, "ragged")
    q, kp, vp, bt, pos = c["args"]
    copies = [(q.clone(), kp.clone(), vp.clone(), bt, pos)
              for _ in range(16)]
    kw = c["kw"]
    n = pa.paged_attention_verify.launches
    n_dec = pa.paged_attention.launches
    n_ring = pa.paged_attention_ring.launches
    kernel_ms = device_ms(lambda *a: pa.paged_attention_verify(*a, **kw),
                          copies)
    ring_ms = device_ms(lambda *a: pa.paged_attention_ring(*a, **kw), copies)
    plain_ms = device_ms(
        lambda *a: pa.paged_attention_verify_reference(*a, **kw), copies)
    ONCHIP["paged_attention_verify (GQA core, T 5)"] = (onchip_call(
        pa, pos, V_T, V_BLOCKS, kv_heads=KV, groups=V_G, head_dim=HD),
        kernel_ms, ring_ms)
    B, S, H = SLOTS, V_BLOCKS * PAGE, KV * V_G
    q_pos = pos.long()[:, None] + torch.arange(V_T, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, None, :]
            <= q_pos[:, :, None])[:, None]                   # (B,1,T,S)

    def library(q, k, v, bt, pos, ks=None, vs=None):
        # gather (and dequantize) the pages, then torch's fused attention
        # with the explicit k_pos <= pos + t mask
        kk = gather_pages(k, ks, bt, q.dtype).reshape(
            B, S, KV, HD).transpose(1, 2)
        vv = gather_pages(v, vs, bt, q.dtype).reshape(
            B, S, KV, HD).transpose(1, 2)
        qq = q.permute(0, 2, 3, 1, 4).reshape(B, H, V_T, HD)
        o = F.scaled_dot_product_attention(
            qq, kk.repeat_interleave(V_G, 1), vv.repeat_interleave(V_G, 1),
            attn_mask=mask, scale=kw["scale"])
        return o.reshape(B, KV, V_G, V_T, HD).permute(0, 3, 1, 2, 4)

    lib_err = float((library(*copies[0]).float()
                     - pa.paged_attention_verify_reference(
                         *copies[0], **kw).float()).abs().max())
    if lib_err > TOL["bfloat16"]["atol"]:
        fail(f"GQA verify library yardstick disagrees with the plain "
             f"version: {lib_err}")
    library_ms = device_ms(library, copies)
    isize = q.element_size()
    gqa_split_report(torch, kvq, pa, "paged_attention_verify",
                     pa.paged_attention_verify, copies, kw, V_T, V_BLOCKS)

    def bound(kv_isize, scale_bytes=0):
        return paged_bound(pos, V_T, S, KV * (HD * kv_isize + scale_bytes)
                           * 2, KV * V_G * 4 * HD, 2 * q.numel() * isize,
                           isize)
    bytes_ms, ops_ms = bound(isize)
    bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
    quant, ring_quant = quant_times(
        torch, kvq, "paged_attention_verify", pa.paged_attention_verify,
        pa.paged_attention_verify_reference, library, copies, 1,
        ("k_scale", "v_scale"), kw, lambda kvd: bound_of(*bound(1, 4)),
        qerrs, kernel_ms, pa.paged_attention_ring, ring_ms)
    pa.paged_attention_verify.launches = n  # comparison launches not counted
    pa.paged_attention.launches = n_dec
    pa.paged_attention_ring.launches = n_ring
    print(f"[kernel] paged_attention_verify bf16 B={SLOTS} T={V_T} KV={KV} "
          f"G={V_G} hd={HD} page={PAGE} "
          f"lines={int((pos.long() + V_T).sum())}: "
          f"kernel {kernel_ms:.4f} ms, ring kernel {ring_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library "
          f"(gather + SDPA) {library_ms:.4f} ms (max abs diff vs plain "
          f"{lib_err:.3e}), bound {bound_ms:.5f} ms ({bound_by}; bytes "
          f"{bytes_ms:.5f} ms, operations {ops_ms:.5f} ms at bf16 peak)")
    return (dict(name="paged_attention_verify", route="cuda",
                 source="src/repro_torch/csrc/gqa_core.cu",
                 replaces="src/repro/kernels/paged_attention.py:557",
                 max_abs_err=errs[("bfloat16", "ragged")], ms=kernel_ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=library_ms, **quant),
            dict(ms=ring_ms, **ring_quant))


def mla_verify_case(torch, np, rng, dtype, kind: str):
    """Inputs of one MLA verify case at deepseek-v2's verify shapes (4
    slots, H 128, r 512, dr 64, T 4, page 16, 17 blocks), kinds as in
    :func:`gqa_verify_case` (no soft cap in MLA) plus ``small`` (smoke
    widths: H 4, r 32, dr 8, page 8)."""
    B, T, H, r, dr, page, nb = (SLOTS, MLA_T, MLA_H, MLA_R, MLA_DR, PAGE,
                                MLA_V_BLOCKS)
    lens = {"ragged": MLA_LENS, "edges": (15, 31, 1, nb * page + 2),
            "margin": (15, 31, 1, nb * page + 2), "trash": None,
            "t1": MLA_LENS, "small": (1, 7, 20)}[kind]
    if kind == "t1":
        T = 1
    if kind == "small":
        B, H, r, dr, page, nb = 3, 4, 32, 8, 8, 4
    P, make = verify_tables(torch, np, rng, lens, T, page, nb)
    bt, pos = make(backed=kind != "margin")
    g = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape, dtype="float32"))
    q_lat, q_rope = g(B, T, H, r) * MLA_Q_STD, g(B, T, H, dr) * MLA_Q_STD
    dev = "cuda"
    return dict(args=(q_lat.to(dev, dtype), q_rope.to(dev, dtype),
                      g(P, page, r).to(dev, dtype),
                      g(P, page, dr).to(dev, dtype), bt.to(dev),
                      pos.to(dev)),
                kw=dict(scale=(128 + 64) ** -0.5))


def mla_verify_kernel_phase(torch, np, pa):
    """mla_paged_attention_verify (CUDA) vs its plain version, at T = 1
    against the MLA decode kernel, and the MLA ring kernel at verify
    shapes against both, on bf16 and quantized pools.  Returns the
    kernels-line entry and the ring's times at the same inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import quantize as kvq
    rng = np.random.default_rng(4)
    errs, qerrs = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for kind in ("ragged", "edges", "margin", "trash", "small", "t1"):
            c = mla_verify_case(torch, np, rng, dtype, kind)
            errs[(name, kind)] = hold(
                torch, f"mla_paged_attention_verify {name:8s} {kind:6s}",
                pa.mla_paged_attention_verify,
                pa.mla_paged_attention_verify_reference, c["args"], 4,
                c["kw"], name)
            quant_cases(torch, kvq, f"mla_paged_attention_verify {name:8s} "
                        f"{kind:6s}", pa.mla_paged_attention_verify,
                        pa.mla_paged_attention_verify_reference, c["args"],
                        2, ("c_scale", "r_scale"), c["kw"], name, qerrs,
                        kind, ring=pa.mla_paged_attention_ring)
            ring_hold(torch, f"mla_paged_attention_ring (verify) {name:8s} "
                      f"{kind:6s}", pa.mla_paged_attention_ring,
                      pa.mla_paged_attention_verify,
                      pa.mla_paged_attention_verify_reference, c["args"], 4,
                      c["kw"], name)
            if kind == "t1":
                ql, qr, *rest = c["args"]
                ver = pa.mla_paged_attention_verify(ql, qr, *rest,
                                                    **c["kw"])[:, 0]
                dec = pa.mla_paged_attention(ql[:, 0].contiguous(),
                                             qr[:, 0].contiguous(), *rest,
                                             **c["kw"])
                torch.cuda.synchronize()
                d = float((ver.float() - dec.float()).abs().max())
                print(f"[kernel] mla_paged_attention_verify {name:8s} T=1 "
                      f"vs the decode kernel: max abs diff {d:.3e}")
                if not torch.equal(ver, dec):
                    fail(f"mla_paged_attention_verify at T=1 differs from "
                         f"the decode kernel by {d}; they must be "
                         "bit-identical")
                t1_equal(torch, kvq, "mla_paged_attention_verify", name,
                         pa.mla_paged_attention_verify,
                         pa.mla_paged_attention, c["args"], 2, 2,
                         ("c_scale", "r_scale"), c["kw"])
    # times at the main path's shapes and type: bf16, MLA_LENS; 64 copies
    # of the queries and pools (~225 MB) rotate so every call reads cold HBM
    c = mla_verify_case(torch, np, rng, torch.bfloat16, "ragged")
    split_report(torch, kvq, pa, "mla_paged_attention_verify",
                 pa.mla_paged_attention_verify, c["args"], MLA_T, PAGE,
                 MLA_V_BLOCKS)
    q_lat, q_rope, cp, rp, bt, pos = c["args"]
    copies = [(q_lat.clone(), q_rope.clone(), cp.clone(), rp.clone(), bt,
               pos) for _ in range(64)]
    kw = c["kw"]
    n = pa.mla_paged_attention_verify.launches
    n_dec = pa.mla_paged_attention.launches
    n_ring = pa.mla_paged_attention_ring.launches
    kernel_ms = device_ms(
        lambda *a: pa.mla_paged_attention_verify(*a, **kw), copies)
    ring_ms = device_ms(lambda *a: pa.mla_paged_attention_ring(*a, **kw),
                        copies)
    plain_ms = device_ms(
        lambda *a: pa.mla_paged_attention_verify_reference(*a, **kw), copies)
    ONCHIP["mla_paged_attention_verify (MLA core, T 4)"] = (onchip_call(
        pa, pos, MLA_T, MLA_V_BLOCKS, n_heads=MLA_H, lora_rank=MLA_R,
        rope_dim=MLA_DR), kernel_ms, ring_ms)
    B, S = SLOTS, MLA_V_BLOCKS * PAGE
    q_pos = pos.long()[:, None] + torch.arange(MLA_T, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, None, :]
            <= q_pos[:, :, None])[:, None]                   # (B,1,T,S)

    def library(ql, qr, cpool, rpool, bt, pos, cs=None, rs=None):
        # gather (and dequantize) the latent lines, then torch's fused
        # attention with k = [c | k_rope], v = c shared by every head, and
        # the explicit k_pos <= pos + t mask
        cc = gather_pages(cpool, cs, bt, ql.dtype).reshape(B, 1, S, MLA_R)
        kk = torch.cat([cc, gather_pages(rpool, rs, bt, ql.dtype).reshape(
            B, 1, S, MLA_DR)], -1)
        qq = torch.cat([ql, qr], -1).transpose(1, 2)         # (B,H,T,576)
        o = F.scaled_dot_product_attention(
            qq, kk.expand(B, MLA_H, S, MLA_R + MLA_DR),
            cc.expand(B, MLA_H, S, MLA_R), attn_mask=mask,
            scale=kw["scale"])
        return o.transpose(1, 2)

    lib_err = float((library(*copies[0]).float()
                     - pa.mla_paged_attention_verify_reference(
                         *copies[0], **kw).float()).abs().max())
    if lib_err > TOL["bfloat16"]["atol"]:
        fail(f"MLA verify library yardstick disagrees with the plain "
             f"version: {lib_err}")
    library_ms = device_ms(library, copies)
    bytes_ms, ops_ms = mla_bound(q_lat, q_rope, pos, MLA_T, S)
    bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
    quant, ring_quant = quant_times(
        torch, kvq, "mla_paged_attention_verify",
        pa.mla_paged_attention_verify,
        pa.mla_paged_attention_verify_reference, library, copies, 2,
        ("c_scale", "r_scale"), kw,
        lambda kvd: bound_of(*mla_bound(q_lat, q_rope, pos, MLA_T, S, 1)),
        qerrs, kernel_ms, pa.mla_paged_attention_ring, ring_ms)
    pa.mla_paged_attention_verify.launches = n
    pa.mla_paged_attention.launches = n_dec
    pa.mla_paged_attention_ring.launches = n_ring
    print(f"[kernel] mla_paged_attention_verify bf16 B={SLOTS} T={MLA_T} "
          f"H={MLA_H} r={MLA_R} dr={MLA_DR} page={PAGE} "
          f"lines={int((pos.long() + MLA_T).sum())}: kernel {kernel_ms:.4f} ms, "
          f"ring kernel {ring_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"(gather + SDPA) "
          f"{library_ms:.4f} ms (max abs diff vs plain {lib_err:.3e}), "
          f"bound {bound_ms:.5f} ms ({bound_by}; bytes {bytes_ms:.5f} ms, "
          f"operations {ops_ms:.5f} ms at bf16 peak)")
    return (dict(name="mla_paged_attention_verify", route="cuda",
                 source="src/repro_torch/csrc/mla_core.cu",
                 replaces="src/repro/kernels/paged_attention.py:660",
                 max_abs_err=errs[("bfloat16", "ragged")], ms=kernel_ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=library_ms, **quant),
            dict(ms=ring_ms, **ring_quant))


# the paper's primitives (PR 14): the data-sheet values the measured
# roofline is printed beside, and the kernels' hold cases
DATA_SHEET = {"fma": 67e12, "matmul float32": 67e12,
              "matmul bfloat16": 989e12, "bandwidth": HBM_BW}
# the share of the measured roof above which a study row is a counting or
# timing error
MAX_UTIL_ROOF = 1.05
# Winograd against the direct convolution: the reference tests' tolerance
# (the transforms' float32 rounding, |v| up to 4 |x|)
WINO_VS_DIRECT = dict(rtol=2e-3, atol=5e-3)
# study row that stands for each kernel in the kernels line
PRIM_ROWS = {"inner_product": "inner_product.bf16_square",
             "gelu_2d": "gelu.flat.blocked",
             "conv2d_direct": "conv.direct",
             "winograd_elementwise_stage": "conv.winograd_stage"}
PRIM_SOURCES = {
    "inner_product": ("inner_product.cu", "inner_product.py:52"),
    "gelu_2d": ("gelu.cu", "gelu.py:35"),
    "conv2d_direct": ("conv_direct.cu", "conv_direct.py:49"),
    "winograd_elementwise_stage": ("winograd_stage.cu",
                                   "conv_winograd.py:43")}


def prim_hold(torch, tally, key, label, out, checks):
    """One primitive case: ``out`` against each (reference, tolerance) of
    ``checks``; fails on a mismatch or a non-finite output.  ``tally``
    keeps, per ``key``, the case count and the worst error over its
    allowance.  Returns this case's worst error over its allowance."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out.float()).all()):
        fail(f"{label}: non-finite output")
    case = 0.0
    for want, tol in checks:
        diff = (out.float() - want.float()).abs()
        allow = tol["atol"] + tol["rtol"] * want.float().abs()
        ratio = float((diff / allow).max())
        if ratio > 1.0:
            fail(f"{label} disagrees with its reference: max abs err "
                 f"{float(diff.max()):.3e} ({ratio:.2f}x its tolerance "
                 f"atol {tol['atol']:.3e} rtol {tol['rtol']:.3e})")
        n, worst = tally.get(key, (0, 0.0))
        tally[key] = (n + 1, max(worst, ratio))
        case = max(case, ratio)
    return case


def primitive_holds(torch, np):
    """Each primitive kernel against its plain version on the card at the
    reference benchmarks' shapes and at edge shapes (the card shapes are
    held inside the study): tolerances from launch/primitives.py.  Each
    GEMM case prints the path its launch took (the wgmma tile and the
    producers of its stages, or the float32 CUDA cores) and, in bf16,
    where cuBLAS's product on the same inputs falls in the kernel's
    allowance (reported, not held)."""
    from repro_torch.kernels import conv_direct as cd
    from repro_torch.kernels import conv_winograd as cw
    from repro_torch.kernels import gelu as gm
    from repro_torch.kernels import inner_product as ip
    from repro_torch.kernels import ref
    from repro_torch.launch.primitives import CONV_W_SCALE, tolerance
    rng = np.random.default_rng(14)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def g(shape, name, scale=1.0):
        a = rng.standard_normal(shape, dtype="float32") * scale
        return torch.from_numpy(a).to("cuda", dts[name])
    tally = {}
    for name in dts:
        # reference shape, ragged edges, K = 1, one output, a thin N; the
        # wgmma core's edges (M % 64, K under one stage and K % 64, N = 8,
        # N % 8, K % 8); bf16 also at 8192^3 and the gate projection
        cases = [(1024, 1024, 1024), (131, 77, 133), (129, 1, 257),
                 (1, 1, 1), (300, 1000, 5), (100, 64, 256), (192, 40, 96),
                 (64, 200, 136), (257, 520, 8), (130, 96, 20),
                 (70, 99, 64)]
        if name == "bfloat16":
            cases += [(8192, 8192, 8192), (256, 5120, 17408)]
        else:
            # the float32 core's edges (128 x 128 tiles, slabs of 32 in K,
            # 16-byte copies for rows of a multiple of 4 floats): K under
            # a slab, K % 32, N = 1, one row over a long K; then x and w
            # at storage offsets 1 and 3 (element-wise producers)
            cases += [(200, 12, 136), (257, 100, 260), (300, 64, 1),
                      (1, 4096, 4), (96, 64, 72, 1, 0), (96, 64, 72, 0, 3),
                      (96, 64, 72, 3, 1)]
        for m, k, n, *offsets in cases:
            ox, ow = offsets or (0, 0)
            x = g((m * k + ox,), name)[ox:].view(m, k)
            w = g((k * n + ow,), name)[ow:].view(k, n)
            tol = tolerance("sum", name, k)
            tol32 = tolerance("sum", name, k, vs="plain_f32")
            worst = blas = 0.0
            for fuse in ("none", "relu", "gelu") if m * n < 2 ** 24 else (
                    "none",):
                want32 = ip.inner_product_reference(x.float(), w.float(),
                                                    fuse=fuse)
                worst = max(worst, prim_hold(
                    torch, tally, f"inner_product {name}",
                    f"inner_product {name} {m}x{k}x{n} {fuse}",
                    ip.inner_product(x, w, fuse=fuse),
                    [(ip.inner_product_reference(x, w, fuse=fuse), tol),
                     (want32, tol32)]))
                if name == "bfloat16" and fuse == "none":
                    # reported, not held: the yardstick's own numerics
                    diff = (torch.matmul(x, w).float() - want32).abs()
                    blas = float((diff / (tol32["atol"] + tol32["rtol"]
                                          * want32.abs())).max())
                    del diff
                del want32
            at = f" at offsets {ox}, {ow}" if ox or ow else ""
            print(f"[hold] inner_product {name} {m}x{k}x{n}{at}: "
                  f"{ip.plan(x, w)}; worst {worst:.3f} of its tolerance"
                  + (f" (torch.matmul {blas:.3f})" if name == "bfloat16"
                     else ""))
            del x, w
        # reference shapes, the paper's C = 3 at the card's size, edges;
        # blocked and naive bit for bit
        for shape in ((4096, 512), (256, 227, 3), (256, 227, 227, 3),
                      (1, 1), (1000, 3), (7, 9, 13)):
            if name == "float32" and len(shape) == 4:
                continue                   # the card's C = 3 runs in bf16
            x = g(shape, name, 2.0)
            for to in ((None, 8, 128) if shape[-1] == 3 else (None,)):
                xp = x if to is None else gm.pad_channels(x, to)
                label = f"gelu {name} {shape} pad {to}"
                blocked, naive = gm.gelu_blocked(xp), gm.gelu_naive(xp)
                prim_hold(torch, tally, f"gelu_2d {name}", label, blocked,
                          [(ref.gelu(xp), tolerance("elementwise", name)),
                           (ref.gelu(xp.float()),
                            tolerance("elementwise", name,
                                      vs="plain_f32"))])
                if not torch.equal(blocked, naive):
                    fail(f"{label}: blocked and naive walks differ")
                del xp, blocked, naive
            del x
        # the vector walk's scalar head and tail: views 1 and 3 elements
        # into a buffer, lengths not a multiple of the 16-byte vector
        for shape in ((333, 200), (7, 9, 13), (1, 5), (4099,)):
            for off in (1, 3):
                n = int(np.prod(shape))
                x = g((n + off,), name, 2.0)[off:].view(shape)
                label = f"gelu {name} {shape} at offset {off}"
                blocked, naive = gm.gelu_blocked(x), gm.gelu_naive(x)
                prim_hold(torch, tally, f"gelu_2d {name}", label, blocked,
                          [(ref.gelu(x), tolerance("elementwise", name))])
                if not torch.equal(blocked, naive):
                    fail(f"{label}: blocked and naive walks differ")
        # reference shape; C = 3 with odd H / W; even and 1 x 5 kernels;
        # Cin % 8 == 0 (cp.async rows) and not, Cout ragged
        # float32 also: Cin % 4 == 0 with Cout 8, K under a slab, one
        # pixel (all but one tap in the padding)
        for n, h, w_, cin, cout, kh, kw in ((4, 28, 28, 128, 128, 3, 3),
                                            (2, 7, 5, 3, 17, 3, 3),
                                            (2, 6, 9, 5, 7, 2, 2),
                                            (1, 5, 4, 8, 9, 1, 5),
                                            (2, 9, 11, 16, 24, 3, 3),
                                            (3, 10, 7, 64, 130, 3, 3),
                                            (2, 8, 13, 40, 16, 1, 5),
                                            (2, 6, 9, 12, 33, 2, 2),
                                            (2, 6, 9, 5, 8, 2, 2),
                                            (1, 5, 4, 4, 1, 1, 3),
                                            (1, 1, 1, 8, 4, 3, 3)):
            x = g((n, h, w_, cin), name)
            wt = g((kh, kw, cin, cout), name, CONV_W_SCALE)
            k = kh * kw * cin
            worst = prim_hold(
                torch, tally, f"conv2d_direct {name}",
                f"conv2d_direct {name} {x.shape} {wt.shape}",
                cd.conv2d_direct(x, wt),
                [(cd.conv2d_direct_reference(x, wt),
                  tolerance("sum", name, k, CONV_W_SCALE)),
                 (cd.conv2d_direct_reference(x.float(), wt.float()),
                  tolerance("sum", name, k, CONV_W_SCALE, vs="plain_f32"))])
            print(f"[hold] conv2d_direct {name} {tuple(x.shape)} "
                  f"{tuple(wt.shape)}: {cd.plan(x, wt)}; worst "
                  f"{worst:.3f} of its tolerance")
    # Winograd (float32): the stage alone at the reference shape and at
    # edges; the whole convolution with odd H / W and C = 3 against the
    # plain Winograd and the direct convolution
    # (the float32 core's edges: one row a position, p = 3, Cin / Cout
    # not multiples of 4, so each producer pair)
    for p, t, cin, cout in ((16, 784, 128, 128), (16, 1, 1, 1),
                            (16, 37, 3, 130), (16, 1, 128, 128),
                            (3, 300, 65, 9), (16, 200, 36, 20),
                            (5, 130, 8, 3), (16, 129, 3, 128)):
        v, u = g((p, t, cin), "float32"), g((p, cin, cout), "float32")
        worst = prim_hold(torch, tally, "winograd_elementwise_stage float32",
                          f"winograd stage {p}x{t}x{cin}x{cout}",
                          cw.winograd_elementwise_stage(v, u),
                          [(cw.winograd_elementwise_stage_reference(v, u),
                            tolerance("sum", "float32", cin))])
        print(f"[hold] winograd stage {p}x{t}x{cin}x{cout}: "
              f"{cw.plan(v, u)}; worst {worst:.3f} of its tolerance")
    for n, h, w_, cin, cout in ((4, 28, 28, 128, 128), (2, 13, 15, 32, 128),
                                (1, 7, 7, 3, 5)):
        x = g((n, h, w_, cin), "float32")
        wt = g((3, 3, cin, cout), "float32", CONV_W_SCALE)
        st = tolerance("sum", "float32", cin, 3 * CONV_W_SCALE)
        prim_hold(torch, tally, "winograd_elementwise_stage float32",
                  f"conv2d_winograd {x.shape} {wt.shape}",
                  cw.conv2d_winograd(x, wt),
                  [(ref.conv2d_winograd(x, wt),
                    dict(atol=16 * st["atol"], rtol=st["rtol"])),
                   (ref.conv2d(x, wt), WINO_VS_DIRECT)])
    for key, (n, worst) in sorted(tally.items()):
        print(f"[prim] {key}: {n} checks at the reference and edge shapes "
              f"passed; worst error {worst:.3f} of its tolerance")


def conv_direct_f32_known_failure(torch) -> None:
    """The float32 direct convolution at ResNet-50 conv3_x over a batch
    of 256 on unit-normal float32 inputs, against its plain version with
    the unchanged float32 "sum" tolerance, and kernel, plain version and
    cuDNN (TF32 off) each against the float64 sum.  A known failure,
    reported and not held: the kernel sums each output's K = 1152
    products in one in-order chain, whose worst of 25.7 M outputs misses
    the tolerance by a few percent (ROADMAP "Checks to watch").  Fails
    only on a non-finite output."""
    from repro_torch.kernels import conv_direct as cd
    from repro_torch.launch.primitives import (CONV_W_SCALE, cudnn_conv,
                                               cudnn_conv_f32, tolerance)
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((256, 28, 28, 128), generator=g, device="cuda")
    wt = torch.randn((3, 3, 128, 128), generator=g,
                     device="cuda") * CONV_W_SCALE
    tol = tolerance("sum", "float32", 9 * 128, CONV_W_SCALE)

    def ratio(got, want):
        allow = tol["atol"] + tol["rtol"] * want.abs()
        return float(((got.to(want.dtype) - want).abs() / allow).max())
    out = cd.conv2d_direct(x, wt)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail("conv2d_direct float32 at conv3_x batch 256: non-finite output")
    plain = cd.conv2d_direct_reference(x, wt)
    vs_plain = ratio(out, plain)
    exact = cudnn_conv(x.double(), wt.double())
    line = (f"{vs_plain:.3f} of its tolerance against the plain version "
            f"({'over it' if vs_plain > 1.0 else 'within it'}); against "
            f"the float64 sum: kernel {ratio(out, exact):.3f}, plain "
            f"version {ratio(plain, exact):.3f}, cuDNN (TF32 off) "
            f"{ratio(cudnn_conv_f32(x, wt), exact):.3f}")
    print(f"[known failure] conv2d_direct float32 {tuple(x.shape)} "
          f"{tuple(wt.shape)}, unit-normal float32 inputs: "
          f"{cd.plan(x, wt)}; {line}")
    del x, wt, out, plain, exact


def card_gemm_plans(torch, ip, cd, cw, shapes) -> dict:
    """The path each GEMM-shaped study row at card shapes takes (the C
    launch functions' own choice from shape and alignment), by row name;
    taken on fresh tensors of the row's shapes, as the study's are."""
    plans = {}
    for name, m, k, n, dtype, _ in shapes["inner_product"]:
        dt = getattr(torch, dtype)
        x = torch.empty((m, k), dtype=dt, device="cuda")
        w = torch.empty((k, n), dtype=dt, device="cuda")
        plans[name] = ip.plan(x, w)
        del x, w
    n, hw, cin, cout, dtype = shapes["conv"]
    for name, dt in (("conv.direct", getattr(torch, dtype)),
                     ("conv.direct.f32", torch.float32)):
        plans[name] = cd.plan(
            torch.empty((n, hw, hw, cin), dtype=dt, device="cuda"),
            torch.empty((3, 3, cin, cout), dtype=dt, device="cuda"))
    t = n * (-(-hw // 2)) ** 2                  # 2 x 2 output tiles
    plans["conv.winograd_stage"] = cw.plan(
        torch.empty((16, t, cin), device="cuda"),
        torch.empty((16, cin, cout), device="cuda"))
    return plans


def level_betas_lines(card, roof) -> None:
    """The hierarchical roofline's measured betas (microbench schema 2)
    beside the data sheet: the L2-resident stream (``vmem``), HBM, the
    pinned host link (``host``) and the host copy's overlap with a matmul
    loop; fails unless each is finite and positive and the overlap in
    [0, 1]."""
    import math
    from repro_torch.core.roofline.hardware import H100_SXM
    lb, ov = roof.level_bw, roof.overlap.get("host", float("nan"))
    for k in ("vmem", "hbm", "host"):
        if not (math.isfinite(lb.get(k, float("nan"))) and lb[k] > 0):
            fail(f"microbench level {k}: beta {lb.get(k)}")
    if not 0.0 <= ov <= 1.0 or "ici" in lb:
        fail(f"microbench overlap {roof.overlap}, levels {lb}")
    print(f"[roofline] {card}: per-level betas: vmem (L2-resident triad "
          f"over 12 MB, csrc/l2_probe.cu) {lb['vmem'] / 1e12:.3f} TB/s "
          f"(data sheet: none), {lb['vmem'] / lb['hbm']:.2f}x hbm "
          f"{lb['hbm'] / 1e12:.3f} TB/s; host (one 64 MB copy each way "
          f"through pinned memory) {lb['host'] / 1e9:.2f} GB/s vs "
          f"{H100_SXM.host_bw / 1e9:.0f} data sheet "
          f"({lb['host'] / H100_SXM.host_bw * 100:.1f}%); host copy hidden "
          f"under a bf16 matmul loop: overlap fraction {ov:.3f}; ici: none "
          "(one card)")


def primitives_phase(torch, np, card):
    """The paper's primitive study (PR 14): the measured roofline beside
    the data sheet, the four kernels held at reference and edge shapes,
    then launch/primitives.py's study at card shapes, counted.  Returns
    the kernels-line entries of the four kernels and the measured
    roof."""
    from repro_torch.core.roofline import microbench
    from repro_torch.kernels import conv_direct as cd
    from repro_torch.kernels import conv_winograd as cw
    from repro_torch.kernels import gelu as gm
    from repro_torch.kernels import inner_product as ip
    from repro_torch.launch import primitives
    t0 = time.perf_counter()
    roof = microbench.run_microbench(cache_path=None, device="cuda")
    # the card's cache (git-ignored): launch/roofline_analysis.py reads it
    microbench.DEFAULT_CACHE.parent.mkdir(parents=True, exist_ok=True)
    microbench.DEFAULT_CACHE.write_text(json.dumps(dataclasses.asdict(roof),
                                                   indent=2))
    for label, got, sheet in (
            ("fma", roof.fma_flops, DATA_SHEET["fma"]),
            ("matmul float32", roof.matmul_flops["float32"],
             DATA_SHEET["matmul float32"]),
            ("matmul bfloat16", roof.matmul_flops["bfloat16"],
             DATA_SHEET["matmul bfloat16"])):
        print(f"[roofline] {card}: peak {label} {got / 1e12:.2f} TFLOP/s "
              f"measured vs {sheet / 1e12:.0f} data sheet "
              f"({got / sheet * 100:.1f}%)")
    for k, v in roof.bandwidth.items():
        print(f"[roofline] {card}: bandwidth {k} {v / 1e12:.3f} TB/s "
              f"measured vs {HBM_BW / 1e12:.2f} data sheet "
              f"({v / HBM_BW * 100:.1f}%)")
    wc = roof.warm_cold
    print(f"[roofline] {card}: warm vs cold pass over 24 MB: warm "
          f"{wc['warm_s'] * 1e6:.2f} us, cold {wc['cold_s'] * 1e6:.2f} us "
          f"(cold/warm {wc['cold_s'] / wc['warm_s']:.2f})")
    level_betas_lines(card, roof)
    primitive_holds(torch, np)
    conv_direct_f32_known_failure(torch)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()

    counters = {"inner_product": ip.inner_product, "gelu_2d": gm.gelu_2d,
                "conv2d_direct": cd.conv2d_direct,
                "winograd_elementwise_stage": cw.winograd_elementwise_stage}
    for c in counters.values():
        c.launches = 0                           # counts start here
    study = primitives.Study(torch.device("cuda"), roof)
    for section in ("microbench", "inner_product", "gelu", "conv"):
        study.run("card", section)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}  # read here
    t2 = time.perf_counter()
    for k, n in launches.items():
        if n == 0:
            fail(f"the study at card shapes never launched {k}")
    rows = {r.name: r for r in study.rows}
    for r in study.rows:
        if r.util_roof > MAX_UTIL_ROOF:
            fail(f"{r.name}: {r.util_roof * 100:.1f}% of the measured roof "
                 "(a counting or timing error)")
    print(f"[prim] {card}: study at card shapes: {len(study.rows)} rows, "
          f"every util_roof <= {MAX_UTIL_ROOF * 100:.0f}% (max "
          f"{max(r.util_roof for r in study.rows) * 100:.1f}%); launches "
          f"{launches}; microbench + holds {t1 - t0:.1f} s, study "
          f"{t2 - t1:.1f} s")
    plans = card_gemm_plans(torch, ip, cd, cw, primitives.SHAPES["card"])
    entries = []
    for k, row_name in PRIM_ROWS.items():
        r = rows[row_name]
        bytes_ms = r.char["Q_bytes"] / HBM_BW * 1e3
        ops_ms = r.char["W_flops"] / PEAK[r.dtype] * 1e3
        bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
        src, rep = PRIM_SOURCES[k]
        # the kernel's other card rows (the inner product's gate
        # projection and float32, the convolution's float32) print beside
        # the one the kernels line stands on
        others = [n for n in plans if n != row_name and (
            n.startswith(row_name) or (k == "inner_product" and
                                       n.startswith("inner_product.")))]
        for name in [row_name] + others:
            rr = rows[name]
            b_ms, b_by = bound_of(rr.char["Q_bytes"] / HBM_BW * 1e3,
                                  rr.char["W_flops"] / PEAK[rr.dtype] * 1e3)
            path = f" [{plans[name]}]" if name in plans else ""
            print(f"[kernel] {k} ({name}){path}: kernel "
                  f"{rr.seconds * 1e3:.4f} ms, plain {rr.plain_s * 1e3:.4f} "
                  f"ms, library {rr.library_s * 1e3:.4f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by}; data sheet), "
                  f"{rr.util_roof * 100:.1f}% of the measured roof")
        entries.append(dict(
            name=k, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=f"src/repro/kernels/{rep}", launches=launches[k],
            max_abs_err=r.max_abs_err, ms=r.seconds * 1e3,
            plain_ms=r.plain_s * 1e3, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=r.library_s * 1e3))
    del study, rows
    torch.cuda.empty_cache()
    return entries, roof


# LayerNorm, pooling and flash attention (PR 15): the study row that
# stands for each kernel in the kernels line, its source and the Pallas
# call it replaces
NPA_KERNELS = {
    "layernorm": ("layernorm.f32_d768", "layernorm.cu", "layernorm.py:37"),
    "avg_pool_blocked": ("pool.avg_blocked_nhwc", "avgpool.cu",
                         "avgpool.py:37"),
    "avg_pool_naive": ("pool.avg_naive_nchw.kernel", "avgpool.cu",
                       "avgpool.py:65"),
    "flash_attention": ("flash_attention.q14_s8192", "flash_attention.cu",
                        "flash_attention.py:78"),
}
# flash hold cases: (B, H, KV, Sq, Sk, hd) — the reference tests' largest
# case, S = 1, G = 1, G = 5, Sq < Sk, Sq > Sk (G 1 to 8, hd 64 and 128);
# the bf16 kernel's 128-row query tiles and 128-key slabs at their edges
# (S 127, 128, 129, 257; G 1, 2, 5, 8; Sq < Sk and Sq > Sk) and one long
# case, S 4096 at G 5
FLASH_CASES = ((2, 8, 1, 512, 512, 64), (1, 5, 1, 1, 1, 128),
               (2, 4, 4, 100, 100, 64), (1, 10, 2, 1000, 1000, 128),
               (1, 8, 1, 100, 1000, 64), (1, 8, 8, 1000, 100, 128),
               (1, 2, 2, 127, 127, 64), (2, 4, 2, 128, 128, 128),
               (1, 5, 1, 129, 129, 64), (1, 8, 1, 257, 257, 128),
               (1, 10, 2, 127, 257, 128), (1, 4, 2, 128, 257, 64),
               (1, 8, 1, 257, 129, 128), (2, 2, 2, 257, 127, 64),
               (1, 10, 2, 4096, 4096, 128))
# the flash kernel built with P rounded once to bf16 (one P V product
# instead of hi + lo), timed beside the kept kernel at the card shapes
FLASH_SINGLE_P = ("FLASH_P_PARTS=1",)


def norm_pool_attention_holds(torch, np):
    """The LayerNorm, pooling and flash kernels against their plain
    versions on the card at the reference benchmarks' shapes and at edge
    shapes (the card shapes are held inside the study); tolerances from
    launch/primitives.py."""
    from repro_torch.kernels import avgpool as pm
    from repro_torch.kernels import flash_attention as fam
    from repro_torch.kernels import layernorm as lnm
    from repro_torch.launch.primitives import tolerance
    rng = np.random.default_rng(15)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def g(shape, name, scale=1.0):
        a = rng.standard_normal(shape, dtype="float32") * scale
        return torch.from_numpy(a).to("cuda", dts[name])
    tally = {}
    for name in dts:
        tol = tolerance("norm", name)
        tol32 = tolerance("norm", name, vs="plain_f32")
        # edges, the reference shape (8192, 4096), and rows that start 4
        # (2) bytes past a 16-byte boundary (offset -1)
        cases = [(r, d) for d in (1, 5, 768, 4097, 16384)
                 for r in (1, 3, 8192)] + [(8192, 4096), (-1, 4097)]
        for r, d in cases:
            if r < 0:
                r = 3
                x = g((r * d + 1,), name, 3.0)[1:].view(r, d)
            else:
                x = g((r, d), name, 3.0)
            s, b = g((d,), "float32"), g((d,), "float32")
            prim_hold(torch, tally, f"layernorm {name}",
                      f"layernorm {name} {r}x{d} at {x.data_ptr() % 16}",
                      lnm.layernorm(x, s, b),
                      [(lnm.layernorm_reference(x, s, b), tol),
                       (lnm.layernorm_reference(x.float(), s, b), tol32)])
            del x
        for shape in ((8, 64, 64, 128), (2, 7, 9, 3), (3, 15, 13, 64),
                      (1, 11, 17, 130)):
            for win in (2, 3, 4):
                x = g(shape, name)
                label = f"avg_pool {name} {shape} window {win}"
                blocked = pm.avg_pool_blocked(x, window=win)
                naive = pm.avg_pool_naive(x, window=win)
                for key, out in (("avg_pool_blocked", blocked),
                                 ("avg_pool_naive", naive)):
                    prim_hold(torch, tally, f"{key} {name}", label, out,
                              [(pm.avg_pool_reference(x, window=win),
                                tolerance("sum", name, win * win)),
                               (pm.avg_pool_reference(x.float(), window=win),
                                tolerance("sum", name, win * win,
                                          vs="plain_f32"))])
                if not torch.equal(blocked, naive):
                    fail(f"{label}: blocked and naive walks differ")
        for b, h, kv, sq, sk, hd in FLASH_CASES:
            label = (f"flash_attention {name} B{b} H{h} KV{kv} Sq{sq} Sk{sk} "
                     f"hd{hd}")
            worst = []
            for causal in (True, False):
                q, k, v = (g((b, sq, h, hd), name), g((b, sk, kv, hd), name),
                           g((b, sk, kv, hd), name))
                heads = [t.transpose(1, 2) for t in (q, k, v)]
                worst.append(prim_hold(
                    torch, tally, f"flash_attention {name}",
                    f"{label} causal={causal}",
                    fam.flash_attention(*heads, causal=causal),
                    [(fam.flash_attention_reference(*heads, causal=causal),
                      tolerance("attention", name, sk, hd=hd)),
                     (fam.flash_attention_reference(
                         *(t.float() for t in heads), causal=causal),
                      tolerance("attention", name, sk, vs="plain_f32",
                                hd=hd))]))
            print(f"[hold] {label}: {fam.plan(heads[0])}; worst "
                  f"{worst[0]:.3f} causal, {worst[1]:.3f} full, of its "
                  f"tolerance")
    for key, (n, worst) in sorted(tally.items()):
        print(f"[prim] {key}: {n} checks at the reference and edge shapes "
              f"passed; worst error {worst:.3f} of its tolerance")


def flash_single_p(torch, card, shapes) -> None:
    """The kept flash kernel (P V as bf16 hi + lo) beside its measurement
    build with P rounded once to bf16, at the study's card shapes, after
    the launch counts were read: device times in turns (kept, single,
    single, kept) on the same cold inputs, and each one's worst error
    over the bf16 attention tolerance against the plain version in
    float32 (reported, not held: the single-part build is not expected
    to meet it)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fam
    from repro_torch.launch.primitives import tolerance
    lib = build.library("flash_attention", fam.C_SIGNATURES, FLASH_SINGLE_P)
    gen = torch.Generator(device="cuda").manual_seed(20)
    for name, b, h, kv, sq, sk, hd, dtype, causal in shapes:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn((b, s, n, hd), generator=gen, device="cuda")
                   .to(dt).transpose(1, 2)
                   for s, n in ((sq, h), (sk, kv), (sk, kv)))
        want = fam.flash_attention_reference(q.float(), k.float(), v.float(),
                                             causal=causal).float()
        tol = tolerance("attention", dtype, sk, vs="plain_f32", hd=hd)
        allow = tol["atol"] + tol["rtol"] * want.abs()

        def split(q, k, v):
            return fam.flash_attention(q, k, v, causal=causal)

        def single(q, k, v):
            return fam.run_library(lib, q, k, v, causal=causal)
        errs = {}
        for label, fn in (("split", split), ("single", single)):
            diff = (fn(q, k, v).float() - want).abs()
            errs[label] = (float(diff.max()), float((diff / allow).max()))
            del diff
        del want, allow
        t = [device_ms(fn, [(q, k, v)], reps=10, per_sample=5)
             for fn in (split, single, single, split)]
        print(f"[flash] {card}: {name}: P as bf16 hi + lo {t[0]:.4f} / "
              f"{t[3]:.4f} ms (max abs err {errs['split'][0]:.3e}, "
              f"{errs['split'][1]:.3f} of its tolerance); P rounded once "
              f"{t[1]:.4f} / {t[2]:.4f} ms (max abs err "
              f"{errs['single'][0]:.3e}, {errs['single'][1]:.3f} of the "
              f"tolerance); single / split {(t[1] + t[2]) / (t[0] + t[3]):.3f}")
        del q, k, v
    torch.cuda.empty_cache()


def layernorm_in_turns(torch, card) -> None:
    """bf16 LayerNorm (row 9) at the study's bf16 cell (65536 x 4096, 512
    MB, so every call reads cold HBM): the kernel and ``F.layer_norm``
    (weights cast to bf16 once, outside the time) timed in turns (kernel,
    library, library, kernel) on the same inputs, after the launch counts
    were read; the kernel held against the plain version run in float32
    at the study's tolerance."""
    import torch.nn.functional as F
    from repro_torch.kernels import layernorm as ln
    from repro_torch.launch.primitives import tolerance
    gen = torch.Generator(device="cuda").manual_seed(23)
    r, d = 65536, 4096
    x = (torch.randn((r, d), generator=gen, device="cuda") * 3.0).bfloat16()
    g = torch.randn((d,), generator=gen, device="cuda")
    b = torch.randn((d,), generator=gen, device="cuda")
    gx, bx = g.bfloat16(), b.bfloat16()

    def kernel(x, g, b):
        return ln.layernorm(x, g, b)

    def library(x, g, b):
        return F.layer_norm(x, (d,), gx, bx, eps=ln.EPS)
    want = ln.layernorm_reference(x.float(), g, b)
    tol = tolerance("norm", "bfloat16", vs="plain_f32")
    errs = {}
    for label, fn in (("kernel", kernel), ("library", library)):
        diff = (fn(x, g, b).float() - want).abs()
        errs[label] = float(diff.max())
        del diff
    if not torch.allclose(kernel(x, g, b).float(), want, **tol):
        fail(f"layernorm bf16 {r} x {d} misses its tolerance: "
             f"{errs['kernel']}")
    del want
    t = [device_ms(fn, [(x, g, b)], reps=10, per_sample=5)
         for fn in (kernel, library, library, kernel)]
    print(f"[layernorm] {card}: bf16 {r} x {d} in turns: kernel {t[0]:.4f} "
          f"/ {t[3]:.4f} ms (max abs err vs plain in f32 "
          f"{errs['kernel']:.3e}), F.layer_norm {t[1]:.4f} / {t[2]:.4f} ms "
          f"({errs['library']:.3e}); kernel / library "
          f"{(t[0] + t[3]) / (t[1] + t[2]):.3f}")
    del x
    torch.cuda.empty_cache()


def norm_pool_attention_phase(torch, np, card, roof):
    """LayerNorm, pooling and flash attention (PR 15): the four kernels
    held at reference and edge shapes, then the study's layernorm,
    pooling and attention sections at card shapes with the kernels'
    launch counts zeroed before and read after.  Returns the kernels-line
    entries of the four kernels."""
    from repro_torch.core import analysis
    from repro_torch.kernels import avgpool as pm
    from repro_torch.kernels import flash_attention as fam
    from repro_torch.kernels import layernorm as lnm
    from repro_torch.launch import primitives
    t0 = time.perf_counter()
    norm_pool_attention_holds(torch, np)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    counters = {"layernorm": lnm.layernorm,
                "avg_pool_blocked": pm.avg_pool_blocked,
                "avg_pool_naive": pm.avg_pool_nchw,   # the naive walk's
                "flash_attention": fam.flash_attention}
    for c in counters.values():
        c.launches = 0                           # counts start here
    study = primitives.Study(torch.device("cuda"), roof)
    for section in ("layernorm", "pooling", "attention"):
        study.run("card", section)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}  # read here
    t2 = time.perf_counter()
    for k, n in launches.items():
        if n == 0:
            fail(f"the study at card shapes never launched {k}")
    for r in study.rows:
        if r.util_roof > MAX_UTIL_ROOF:
            fail(f"{r.name}: {r.util_roof * 100:.1f}% of the measured roof "
                 "(a counting or timing error)")
    rows = {r.name: r for r in study.rows}
    print(f"[prim] {card}: layernorm / pooling / attention at card shapes: "
          f"{len(study.rows)} rows, every util_roof <= "
          f"{MAX_UTIL_ROOF * 100:.0f}% (max "
          f"{max(r.util_roof for r in study.rows) * 100:.1f}%); launches "
          f"{launches}; holds {t1 - t0:.1f} s, study {t2 - t1:.1f} s")
    naive, blocked = rows["pool.avg_naive_nchw"], rows["pool.avg_blocked_nhwc"]
    print(f"[prim] {card}: naive pooling op {naive.seconds * 1e3:.4f} ms = "
          f"NCHW kernel {rows['pool.avg_naive_nchw.kernel'].seconds * 1e3:.4f}"
          f" ms + transposes; blocked {blocked.seconds * 1e3:.4f} ms")
    shapes = primitives.SHAPES["card"]["attention"]
    flash_plans = {c[0]: fam.plan(torch.empty(
        (1, 1, 1, c[6]), dtype=getattr(torch, c[7]), device="cuda"))
        for c in shapes}
    flash_single_p(torch, card, shapes)
    flash = rows["flash_attention.q14_s8192"]
    model_ai = analysis.flash_attention_ai(8192)
    print(f"[prim] {card}: flash q14 S 8192 intensity {flash.char['AI']:.1f} "
          f"FLOP/B; the reference's substitution model "
          f"(flash_attention_ai, bq 128) {model_ai:.2f}")
    entries = []
    for k, (row_name, src, rep) in NPA_KERNELS.items():
        r = rows[row_name]
        bytes_ms = r.char["Q_bytes"] / HBM_BW * 1e3
        ops_ms = r.char["W_flops"] / PEAK[r.dtype] * 1e3
        bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
        # flash's other card row prints beside the one the line stands on
        names = [row_name] + (["flash_attention.q06_b8_s2048"]
                              if k == "flash_attention" else [])
        for name in names:
            rr = rows[name]
            b_ms, b_by = bound_of(rr.char["Q_bytes"] / HBM_BW * 1e3,
                                  rr.char["W_flops"] / PEAK[rr.dtype] * 1e3)
            path = f" [{flash_plans[name]}]" if name in flash_plans else ""
            print(f"[kernel] {k} ({name}){path}: kernel "
                  f"{rr.seconds * 1e3:.4f} ms, plain {rr.plain_s * 1e3:.4f} "
                  f"ms, library {rr.library_s * 1e3:.4f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by}; data sheet), "
                  f"{rr.util_roof * 100:.1f}% of the measured roof")
        entries.append(dict(
            name=k, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=f"src/repro/kernels/{rep}", launches=launches[k],
            max_abs_err=r.max_abs_err, ms=r.seconds * 1e3,
            plain_ms=r.plain_s * 1e3, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=r.library_s * 1e3))
    del study, rows
    torch.cuda.empty_cache()
    return entries


def decode_logits_check(torch, np, engine, ops, op, counter):
    """One decode step of the engine's current batch, run on copies of its
    pools twice: through the kernel, and with the plain version of
    ``op`` swapped into the registry.  Returns the max abs logits
    difference and the max abs logit.  ``counter`` is the kernel wrapper,
    whose launches here are not counted."""
    from repro_torch.models import decode_step_paged
    kv = engine._kv
    running = engine._sched.decode_requests()
    slots = [r.slot for r in running]
    for r in running:                  # back the write line, as step() does
        if not kv.ensure_writable(r.slot, r.context_len - 1, r.context_len):
            fail("pool too small for the logits check")
    active = np.zeros((SLOTS,), bool)
    active[slots] = True
    tok = torch.as_tensor(np.where(active, engine._next_token, 0)[:, None],
                          dtype=torch.long, device="cuda")
    pos = torch.as_tensor(np.where(active, engine._pos, 0), dtype=torch.int32,
                          device="cuda")
    bt = kv.block_tables_for(slots)

    def run():
        return decode_step_paged(engine.params, engine.cfg, pool_copies(kv),
                                 bt, tok, pos, page_size=PAGE).float()

    n = counter.launches
    with torch.no_grad():
        got = run()
        saved = ops.registered_kernels()[op]
        ops.register_kernel(op, cuda=saved["cpu"], reference=saved["cpu"],
                            ring=saved.get("ring"))
        try:
            want = run()
        finally:
            ops.register_kernel(op, cuda=saved["cuda"],
                                reference=saved["cpu"], ring=saved.get("ring"))
    counter.launches = n
    rows = torch.as_tensor(slots, device="cuda")
    got, want = got[rows], want[rows]
    if not bool(torch.isfinite(got).all()):
        fail("engine decode logits are not finite")
    return float((got - want).abs().max()), float(want.abs().max())


def make_params(torch, cfg):
    """Random weights of ``cfg`` on the card from a generator seeded 0
    (peak-memory counting starts here)."""
    from repro_torch.models import init_params, param_count
    from repro_torch.obs.clock import now
    from repro_torch.serve.scheduler import params_bytes_active

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = now()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    # an MoE decode step multiplies every routed expert's weights (the
    # (E, C, D) dispatch buffer), not only the active ones the ledger prices
    expert_bytes = sum(
        t.numel() * t.element_size()
        for seg in params["segments"] for blk in seg.values()
        if "ffn" in blk and blk["ffn"]["w_up"].dim() == 4
        for k, t in blk["ffn"].items() if k in ("w_up", "w_gate", "w_down"))
    print(f"[engine] {cfg.name} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}): "
          f"{param_count(cfg) / 1e9:.2f} B params, random weights in "
          f"{now() - t0:.1f} s; routed-expert weights multiplied per decode "
          f"step {expert_bytes / 1e9:.2f} GB, ledger's active weights "
          f"{params_bytes_active(cfg) / 1e9:.2f} GB")
    return params


def engine_phase(torch, np, card, cfg, params, *, max_len: int,
                 new_tokens: int, op: str, counter, logits_atol: float,
                 kv_dtypes=KV_DTYPES, dispatch: bool = False,
                 telemetry_chip=None):
    """The continuous-batching engine on ``cfg`` serves PROMPT_LENS; every
    request must finish, the path's kernel ``op`` (wrapper ``counter``)
    must launch once per layer and decode step in that run, and one
    decode step of a second batch must match the same step with the
    plain attention; then :func:`pipeline_runs` serves the same prompts
    with ``pipeline`` off and double, and :func:`quantized_runs` with KV
    pools of each of ``kv_dtypes``.  The measured run replays captured
    graphs, whose core kernels a profiler pass counts; with ``dispatch``
    the dispatch floors are printed and each quantized engine also served
    eagerly; with ``telemetry_chip`` the measured run has telemetry on,
    priced on that chip, and prints its attainment line.  Returns the
    launch count of the measured run and the ring launch counts of the
    first double run."""
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import now
    from repro_torch.serve import Engine, EngineConfig, GenerateConfig

    ecfg = EngineConfig(num_slots=SLOTS, page_size=PAGE, max_len=max_len,
                        prefill_chunk=PREFILL_CHUNK, device="cuda")
    rng = np.random.default_rng(1)
    gen = GenerateConfig(max_new_tokens=new_tokens)

    # warm-up engine (cuBLAS handles, allocator): not counted, not timed
    warm = Engine(cfg, params, ecfg)
    warm.submit(rng.integers(0, cfg.vocab_size, 70), GenerateConfig(4))
    warm.run()
    del warm

    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    engine = Engine(cfg, params, ecfg if telemetry_chip is None else
                    dataclasses.replace(ecfg, telemetry=True,
                                        chip=telemetry_chip,
                                        telemetry_window=TELEMETRY_WINDOW))
    reqs = [engine.submit(p, gen) for p in prompts]
    counter.launches = 0                     # counts start here
    torch.cuda.synchronize()
    t0 = now()
    engine.run()
    torch.cuda.synchronize()
    wall = now() - t0
    launches = counter.launches              # counts read here
    steps = engine.decode_steps
    dec = engine.phases["decode"]
    dec_ms = dec.wall_s / max(dec.steps, 1) * 1e3
    agg = engine.aggregate_ledger()
    if telemetry_chip is not None:
        attainment_line(card, cfg.name, engine)

    graph_kernels(torch, cfg.name, engine._graphs, "decode",
                  dict.fromkeys(CORE_KERNELS[op], cfg.n_layers))

    # logits check on a second batch, outside the measured run: once three
    # requests decode together, one step is run both ways on pool copies
    more = [engine.submit(rng.integers(0, cfg.vocab_size, n),
                          GenerateConfig(max_new_tokens=8))
            for n in (30, 50, 90)]
    logits_err = None
    while engine._sched.has_work():
        if logits_err is None and len(engine._sched.decode_requests()) == 3:
            logits_err, scale = decode_logits_check(torch, np, engine, ops,
                                                    op, counter)
        engine.step()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for r in reqs:
        if r.finish_reason != "length" or len(r.generated) != new_tokens:
            fail(f"{cfg.name} request {r.request_id} ended "
                 f"{r.finish_reason!r} with {len(r.generated)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            fail(f"{cfg.name} request {r.request_id}: token ids outside "
                 "the vocab")
    per_call = launches_per_call(op, cfg)
    if launches != steps * cfg.n_layers * per_call:
        fail(f"{op} launched {launches} kernels for {steps} decode steps x "
             f"{cfg.n_layers} layers x {per_call} a call")
    if not engine.graphs or "decode" not in engine._graphs.graphs:
        fail(f"{cfg.name}: the engine did not capture its decode step")
    if logits_err is None or any(len(r.generated) != 8 for r in more):
        fail(f"the {cfg.name} logits-check batch did not run as planned")
    if logits_err > logits_atol:
        fail(f"{cfg.name} decode logits differ from the plain-attention "
             f"step by {logits_err} > {logits_atol}")
    n_tok = sum(len(r.generated) for r in reqs)
    ttft = [r.ttft for r in reqs]
    print(f"[engine] {cfg.name}: {len(reqs)} requests (prompts "
          f"{list(PROMPT_LENS)}, {new_tokens} new tokens, {SLOTS} slots, "
          f"prefill chunk {PREFILL_CHUNK}) all finished; {steps} decode "
          f"steps, {op} launches {launches} = steps x {cfg.n_layers} "
          f"layers x {per_call} a call")
    print(f"[engine] {cfg.name} decode logits vs plain attention: max abs "
          f"diff {logits_err:.4e} (atol {logits_atol}; max |logit| "
          f"{scale:.3f})")
    print(f"[engine] {cfg.name} {card}: {n_tok / wall:.2f} tok/s over "
          f"{wall:.3f} s (CUDA graphs; capture {capture_ms(engine):.1f} ms "
          f"inside the run: the decode step's and "
          f"{len(engine.prefill_shapes)} prefill shapes', each once); mean "
          f"decode step {dec_ms:.3f} ms; "
          f"TTFT mean {np.mean(ttft) * 1e3:.2f} ms, max "
          f"{np.max(ttft) * 1e3:.2f} ms; ledger arithmetic intensity "
          f"{agg.arithmetic_intensity:.3f} FLOP/B; peak memory "
          f"{peak_gb:.2f} GB")
    rings, steps = pipeline_runs(
        torch, card, cfg.name, cfg,
        lambda pl, g: Engine(cfg, params, dataclasses.replace(
            ecfg, pipeline=pl, cuda_graphs=g)),
        prompts, gen,
        lambda e: {op: e.decode_steps * cfg.n_layers * per_call})
    if dispatch:
        dispatch_line(torch, card, cfg, params, ecfg,
                      {g: [d["decode"] for d in steps[g]] for g in steps})
    quantized_runs(
        torch, np, card, cfg.name, cfg,
        lambda kvd, pl, g=True: Engine(cfg, params, dataclasses.replace(
            ecfg, kv_dtype=kvd, pipeline=pl, cuda_graphs=g)),
        prompts, gen, kv_dtypes,
        lambda e: {op: e.decode_steps * cfg.n_layers * per_call},
        ([list(r.generated) for r in reqs], n_tok / wall, peak_gb,
         pool_nbytes(engine)),
        lambda e: decode_logits_check(torch, np, e, ops, op, counter),
        logits_atol, eager=dispatch)
    return launches, rings


def dispatch_line(torch, card, cfg, params, ecfg, decode_ms) -> None:
    """The paper's dispatch floor (``Engine.measure_dispatch_overhead``:
    the decode step of the no-kernel twin, median of 20) with CUDA graphs
    off and on, printed beside the mean decode step of ``cfg``'s runs each
    way (``decode_ms``: {graphs: [ms of each run]})."""
    from repro_torch.serve import Engine
    floor = {g: Engine(cfg, params, dataclasses.replace(
        ecfg, cuda_graphs=g)).measure_dispatch_overhead() * 1e3
        for g in (False, True)}
    if not (0.0 < floor[True] and 0.0 < floor[False]):
        fail(f"{cfg.name}: dispatch floors {floor}")

    def runs(g):
        return ", ".join(f"{x:.3f}" for x in decode_ms[g])

    print(f"[dispatch] {cfg.name} {card}: no-kernel decode step (median "
          f"of 20) eager {floor[False]:.3f} ms, graphed {floor[True]:.3f} "
          f"ms ({floor[False] / floor[True]:.1f}x); mean decode step eager "
          f"{runs(False)} ms, graphed {runs(True)} ms")


def launches_per_call(op: str, cfg) -> int:
    """Kernel launches of one call of the paged wrapper ``op`` in a model
    of ``cfg``: for bf16 activations the MLA wrappers' tensor-core core
    is a split and a merge kernel (kernels.paged_attention.
    mla_launches_per_call), every GQA wrapper one kernel.  A ring's calls
    launch what the off kernel's do."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.params import torch_dtype
    return (pa.mla_launches_per_call(torch_dtype(cfg.dtype))
            if op.startswith("mla_") else 1)


# the off paged-attention kernels and the ring that runs each under
# pipeline="double" (decode and verify share a ring)
RING_OF = {"paged_attention": "paged_attention_ring",
           "paged_attention_verify": "paged_attention_ring",
           "mla_paged_attention": "mla_paged_attention_ring",
           "mla_paged_attention_verify": "mla_paged_attention_ring"}
# (pipeline, CUDA graphs) of the comparison runs: both pipelines graphed,
# then both eager, the pipelines in turns
PIPELINE_ORDER = (("off", True), ("double", True), ("double", False),
                  ("off", False))
# the kernels of each paged op's bf16 core, one launch each per call
CORE_KERNELS = {"paged_attention": ("gqa_split_bf16_kernel",),
                "paged_attention_verify": ("gqa_split_bf16_kernel",),
                "mla_paged_attention": ("mla_split_bf16_kernel",
                                        "mla_combine_kernel"),
                "mla_paged_attention_verify": ("mla_split_bf16_kernel",
                                               "mla_combine_kernel")}
PAGED_KERNELS = sorted(set(RING_OF) | set(RING_OF.values()))


@contextlib.contextmanager
def deterministic(torch, on: bool):
    """Deterministic algorithms on (``on``) for runs whose streams are
    compared byte for byte: an MoE model's combine (``index_add_``)
    otherwise adds in atomic order; the dense path is deterministic as it
    is.  cuBLAS on one stream is deterministic; its note says otherwise,
    and is silenced."""
    import warnings
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message="Deterministic behavior was enabled")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def run_kind(graphs: bool) -> str:
    return "graphed" if graphs else "eager"


def step_ms(engine) -> dict:
    """Mean synchronized step times of an engine's run, ms: decode step,
    or verify step and draft round."""
    out = {}
    for ph in ("decode", "verify", "draft"):
        p = engine.phases.get(ph)
        if p is not None and p.steps:
            out[ph] = p.wall_s / p.steps * 1e3
    return out


def capture_ms(engine) -> float:
    """Milliseconds an engine's graphs (its draft model's too: every step
    and prefill shape) took to capture, each once per engine (their first
    calls' eager runs excluded)."""
    prop = getattr(engine, "proposer", None)
    return (engine.graph_capture_s + (prop._graphs.capture_s if hasattr(
        prop, "_graphs") else 0.0)) * 1e3


def fmt_steps(d: dict) -> str:
    names = {"decode": "decode step", "verify": "verify step",
             "draft": "draft round"}
    return ", ".join(f"{names[k]} {v:.3f} ms" for k, v in d.items())


def graph_kernels(torch, label: str, graphs, name: str, want: dict,
                  replays: int = 3, passes: int = 3) -> None:
    """torch.profiler passes (CUDA activity) over ``replays`` replays of
    the captured step ``name`` of a ``serve.graphs.StepGraphs``: every
    kernel named in ``want`` (a part of its name -> launches a replay)
    must run that often inside the graph.  The profiler loses kernel
    events but never adds any (on an H100: a graph's first kernels in
    every profile started late in this script, and now and then a
    burst).  So each pass profiles a warm-up cycle of ``replays``
    replays, whose events it drops, then the counted cycle, ``passes``
    passes run, and the one that saw the most kernels is held.  Replays a
    step whose inputs are unchanged since its last run, which rewrites the
    same KV lines."""
    from torch.profiler import ProfilerActivity, profile, schedule
    graph = graphs.graphs[name].graph
    names: list = []
    totals = []
    for _ in range(passes):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):                 # the warm-up, then counted
                for _ in range(replays):
                    graph.replay()
                torch.cuda.synchronize()
                prof.step()
        seen = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        totals.append(len(seen))
        if len(seen) > len(names):
            names = seen
    got = {k: sum(k in n for n in names) for k in want}
    if not names or any(got[k] != n * replays for k, n in want.items()):
        fail(f"{label} {name} graph: the profiler saw {got} over {replays} "
             f"replays ({len(names)} kernels, the most of {passes} "
             f"passes), want {want} a replay")
    print(f"[graph] {label} {name} graph: {len(names) / replays:.0f} "
          f"kernels a replay (torch.profiler over {replays} replays after "
          f"as many untimed, the fullest of {passes} passes, which saw "
          f"{totals} kernels); "
          + ", ".join(f"{k} {got[k] // replays} a replay (= layers)"
                      for k in want))
    return len(names) / replays


def counted_run(torch, engine, prompts, gen, seeds=None):
    """Serve ``prompts`` on ``engine`` (request i seeded ``seeds[i]`` when
    given), every paged kernel's launch count zeroed just before the run
    and read just after.  Returns (requests, {kernel name: launches}, wall
    seconds)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.obs.clock import now
    counters = [getattr(pa, n) for n in PAGED_KERNELS]
    reqs = [engine.submit(p, gen, seed=None if seeds is None else seeds[i])
            for i, p in enumerate(prompts)]
    for c in counters:
        c.launches = 0                           # counts start here
    torch.cuda.synchronize()
    t0 = now()
    engine.run()
    torch.cuda.synchronize()
    wall = now() - t0
    return reqs, {c.__name__: c.launches for c in counters}, wall  # read


def want_launches(off_counts: dict, pipeline: str) -> dict:
    """Every paged kernel's launches for a run whose off kernels would
    launch ``off_counts`` (name -> count): on those kernels with pipeline
    off, on their rings (RING_OF) with pipeline double, 0 elsewhere."""
    want = dict.fromkeys(PAGED_KERNELS, 0)
    for op, n in off_counts.items():
        want[RING_OF[op] if pipeline == "double" else op] += n
    return want


def pipeline_runs(torch, card, label, cfg, make, prompts, gen, want_off):
    """Serve ``prompts`` with engines ``make(pipeline, graphs)`` of
    ``cfg`` in the runs of PIPELINE_ORDER: pipeline off and double with
    CUDA graphs, then double and off eager, so that runs differ by their
    attention kernels or by capture alone (deterministic algorithms on for
    an MoE model).  Every run's greedy streams must equal the first run's.
    Each run (:func:`counted_run`) must launch ``want_launches(want_off(
    engine), pipeline)``: an off run its off kernels and no ring, a double
    run the same counts on the rings and no off kernel, graphed or eager.
    Prints tok/s and mean step times of every run (one call, one card:
    comparable); returns the ring counts of the first double run and each
    mode's mean step times {graphs: [step_ms of its runs]}."""
    first, rates, rings = None, [], None
    steps = {True: [], False: []}
    capture = []
    moe = any(b.ffn == "moe" for b in cfg.block_pattern)
    with deterministic(torch, moe):
        for pl, graphs in PIPELINE_ORDER:
            engine = make(pl, graphs)
            reqs, got, wall = counted_run(torch, engine, prompts, gen)
            want = want_launches(want_off(engine), pl)
            run = f"pipeline={pl} {run_kind(graphs)}"
            if got != want:
                fail(f"{label} {run}: kernel launches {got}, want {want}")
            if engine.graphs != graphs:
                fail(f"{label} {run}: engine.graphs is {engine.graphs}")
            streams = [list(r.generated) for r in reqs]
            if first is None:
                first = streams
                if any(r.finish_reason != "length" for r in reqs):
                    fail(f"{label} {run}: a request did not finish")
            elif streams != first:
                fail(f"{label} {run}: greedy streams differ from the "
                     "first run's")
            if pl == "double" and rings is None:
                rings = {n: got[n] for n in set(RING_OF.values())}
            n_tok = sum(len(x) for x in streams)
            rates.append(f"{pl} {run_kind(graphs)} {n_tok / wall:.2f}")
            steps[graphs].append(step_ms(engine))
            if graphs:
                capture.append(capture_ms(engine))
    algo = "deterministic algorithms" if moe else "default algorithms"
    print(f"[pipeline] {label} {card}: tok/s {', '.join(rates)} (runs in "
          f"this order, {algo}); greedy streams of all "
          f"{len(PIPELINE_ORDER)} runs byte-equal; launches per double run "
          f"{rings}, 0 off paged launches; per off run the same on the off "
          "kernels, 0 ring launches")
    print(f"[graph] {label} {card}: greedy streams byte-equal with CUDA "
          f"graphs on and off, pipeline off and double, the same launch "
          f"counts; graphed: {'; '.join(map(fmt_steps, steps[True]))} "
          f"(capture {', '.join(f'{c:.1f}' for c in capture)} ms, each "
          f"step and prefill shape once per engine, inside the run); eager: "
          f"{'; '.join(map(fmt_steps, steps[False]))} (runs off, double, "
          f"double, off)")
    return rings, steps


def quantized_runs(torch, np, card, label, cfg, make, prompts, gen,
                   kv_dtypes, want_off, base, check, logits_atol,
                   more=((30, 50, 90), 8), eager=False) -> None:
    """Serve ``prompts`` again with engines ``make(kv_dtype, pipeline)``
    (quantized KV pools), one per ``kv_dtypes``, first with pipeline off:
    every request must finish; the run (:func:`counted_run`) must launch
    the off kernels ``want_off(engine)`` times and no ring; the KV pools'
    device bytes must equal the scheduler's pricing, kv_line_bytes x pages
    x page size; one step of a second batch on that engine (``more``:
    prompt lengths and new tokens, which must bring three requests to
    decode together; ``check(engine)``, on copies of the quantized pools)
    must match the plain attention within ``logits_atol``.  With
    ``eager``, the same engine with CUDA graphs off (``make(kv_dtype,
    "off", False)``) serves the prompts again: greedy streams byte-equal
    to the graphed run's, the same launch counts.  Then with pipeline
    double, on the same prompts and weights: greedy streams byte-equal to
    the off run's, the rings launched the off run's counts
    and no off kernel (both runs with deterministic algorithms for an MoE
    model, as :func:`pipeline_runs`).  Prints tok/s of both runs, peak
    memory and pool bytes beside the bf16 run's (``base``: its streams,
    tok/s, peak GB and KV pool bytes, same call) and the share of greedy
    tokens equal to the bf16 streams (not a gate: quantization moves
    logits)."""
    from repro_torch.serve import GenerateConfig
    from repro_torch.serve.scheduler import kv_line_bytes
    base_streams, base_rate, base_peak, base_pool_bytes = base
    moe = any(b.ffn == "moe" for b in cfg.block_pattern)
    mode = "deterministic algorithms" if moe else "default algorithms"
    rng = np.random.default_rng(7)
    for kvd in kv_dtypes:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with deterministic(torch, moe):
            engine = make(kvd, "off")
            reqs, got, wall = counted_run(torch, engine, prompts, gen)
            want = want_launches(want_off(engine), "off")
            if got != want:
                fail(f"{label} kv_dtype={kvd}: kernel launches {got}, want "
                     f"{want}")
            if any(r.finish_reason != "length"
                   or len(r.generated) != gen.max_new_tokens for r in reqs):
                fail(f"{label} kv_dtype={kvd}: a request did not finish")
            streams = [list(r.generated) for r in reqs]
            n_tok = sum(len(x) for x in streams)
            kv = engine._kv
            pool_bytes = pool_nbytes(engine)
            line_bytes = kv_line_bytes(engine.cfg)
            priced = line_bytes * kv.num_pages * kv.page_size
            if pool_bytes != priced:
                fail(f"{label} kv_dtype={kvd}: KV pools hold {pool_bytes} B, "
                     f"the scheduler prices {priced} B")
            same = sum(a == b for x, y in zip(streams, base_streams)
                       for a, b in zip(x, y))
            lens, more_new = more
            extra = [engine.submit(rng.integers(0, engine.cfg.vocab_size, n),
                                   GenerateConfig(max_new_tokens=more_new))
                     for n in lens]
            err = None
            while engine._sched.has_work():
                if err is None and len(engine._sched.decode_requests()) == 3:
                    err, scale = check(engine)
                engine.step()
        if err is None or any(len(r.generated) != more_new for r in extra):
            fail(f"the {label} kv_dtype={kvd} logits-check batch did not run "
                 "as planned")
        if err > logits_atol:
            fail(f"{label} kv_dtype={kvd}: logits differ from the plain "
                 f"attention by {err} > {logits_atol}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        acc = (f", acceptance rate "
               f"{engine.aggregate_ledger().acceptance_rate:.3f}"
               if hasattr(engine, "verify_steps") else "")
        graphed = step_ms(engine)
        del engine
        if eager:
            with deterministic(torch, moe):
                eengine = make(kvd, "off", False)
                ereqs, egot, ewall = counted_run(torch, eengine, prompts,
                                                 gen)
            if egot != got:
                fail(f"{label} kv_dtype={kvd} eager: kernel launches "
                     f"{egot}, graphed {got}")
            if [list(r.generated) for r in ereqs] != streams:
                fail(f"{label} kv_dtype={kvd}: eager greedy streams differ "
                     "from the graphed run's")
            print(f"[graph] {label} kv_dtype={kvd} {card}: greedy streams "
                  f"byte-equal with CUDA graphs on and off, the same launch "
                  f"counts; tok/s graphed {n_tok / wall:.2f} "
                  f"({fmt_steps(graphed)}), eager {n_tok / ewall:.2f} "
                  f"({fmt_steps(step_ms(eengine))})")
            del eengine, ereqs
        with deterministic(torch, moe):
            dengine = make(kvd, "double")
            dreqs, dgot, dwall = counted_run(torch, dengine, prompts, gen)
            dwant = want_launches(want_off(dengine), "double")
        if dgot != dwant:
            fail(f"{label} kv_dtype={kvd} pipeline=double: kernel launches "
                 f"{dgot}, want {dwant}")
        if [list(r.generated) for r in dreqs] != streams:
            fail(f"{label} kv_dtype={kvd}: pipeline=double greedy streams "
                 "differ from pipeline=off's")
        del dengine, dreqs
        print(f"[quant] {label} kv_dtype={kvd} {card}: {len(reqs)} requests "
              f"finished; launches {dict((k, v) for k, v in got.items() if v)}"
              f" = layers x steps x kernels a call, 0 ring launches; KV pools "
              f"{pool_bytes} B = kv_line_bytes {line_bytes} x {kv.num_pages} "
              f"pages x {kv.page_size} (bf16 pools {base_pool_bytes} B, "
              f"{base_pool_bytes / pool_bytes:.4f}x); logits vs plain "
              f"attention max abs "
              f"diff {err:.4e} (atol {logits_atol}; max |logit| {scale:.3f})")
        print(f"[quant] {label} kv_dtype={kvd} {card}: {n_tok / wall:.2f} "
              f"tok/s (bf16 pools {base_rate:.2f}); peak memory "
              f"{peak_gb:.2f} GB (bf16 pools {base_peak:.2f} GB); greedy "
              f"tokens equal to the bf16 streams {same}/{n_tok} "
              f"({same / n_tok:.3f}){acc}")
        print(f"[quant] {label} kv_dtype={kvd} pipeline=double {card}: "
              f"greedy streams byte-equal to pipeline=off's; launches "
              f"{dict((k, v) for k, v in dgot.items() if v)} = layers x "
              f"steps x kernels a call, 0 off paged launches; tok/s off {n_tok / wall:.2f}, "
              f"double {n_tok / dwall:.2f} ({mode}, this order)")


def pool_nbytes(engine) -> int:
    """Device bytes of an engine's KV pools (every leaf, scales too)."""
    from repro_torch.models.params import tree_leaves
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(engine._kv.pools))


def pool_copies(kv):
    """Copies of every page pool of a PagedKVCache (same tree)."""
    return [{b: {k: t.clone() for k, t in blk.items()}
             for b, blk in seg.items()} for seg in kv.pools]


def top2_margin(logits):
    """Host array of each row's top-1 minus top-2 logit."""
    import torch
    v = torch.topk(logits.float(), 2, dim=-1).values
    return (v[:, 0] - v[:, 1]).cpu().numpy()


def margin_engine(cfg, params, ecfg):
    """The plain engine, keeping each committed token's top-2 logit margin
    in ``margins`` by (request id, token index); its tokens are
    unchanged."""
    from repro_torch.serve import Engine, sampling

    class MarginEngine(Engine):
        def _decode_sample(self):
            logits = self._decode_logits()
            self.step_margin = top2_margin(logits)
            return sampling.sample_tokens(logits, self._seeds, self._steps,
                                          self._temps, self._top_ks,
                                          self._top_ps)

        def _sample_first(self, last_logits, req):
            self.first_margin = top2_margin(last_logits.reshape(1, -1))[0]
            return super()._sample_first(last_logits, req)

        def _commit_token(self, req, tok, first=False, t=None):
            m = self.first_margin if first else self.step_margin[req.slot]
            self.margins[(req.request_id, len(req.generated))] = float(m)
            super()._commit_token(req, tok, first=first, t=t)

    engine = MarginEngine(cfg, params, ecfg)
    engine.margins = {}
    return engine


def verify_logits_check(torch, np, engine, ops, op, counter, rng):
    """One verify step of a SpecEngine's current batch (each slot's next
    token and k random draft tokens), run on copies of its pools: through
    the verify kernel, against k+1 sequential decode steps with the plain
    version of the decode attention ``op`` swapped into the registry.
    Returns the max abs logits difference over all T positions of the
    live slots, and the max abs logit.  ``counter`` is the verify kernel's
    wrapper, whose launches here are not counted."""
    from repro_torch.models import decode_step_paged, decode_step_verify_paged
    kv, T = engine._kv, engine.scfg.k + 1
    running = engine._sched.decode_requests()
    slots = [r.slot for r in running]
    for r in running:                 # back the T write lines, as step() does
        if not kv.ensure_writable(r.slot, r.context_len - 1,
                                  r.context_len - 1 + T):
            fail("pool too small for the verify logits check")
    B = engine.ecfg.num_slots
    active = np.zeros((B,), bool)
    active[slots] = True
    feed = np.zeros((B, T), np.int64)
    feed[:, 0] = np.where(active, engine._next_token, 0)
    feed[:, 1:] = rng.integers(0, engine.cfg.vocab_size, (B, T - 1))
    feed = torch.as_tensor(feed, device="cuda")
    pos = torch.as_tensor(np.where(active, engine._pos, 0), dtype=torch.int32,
                          device="cuda")
    bt = kv.block_tables_for(slots)
    n = counter.launches
    with torch.no_grad():
        got = decode_step_verify_paged(engine.params, engine.cfg,
                                       pool_copies(kv), bt, feed, pos,
                                       page_size=PAGE).float()
        saved = ops.registered_kernels()[op]
        ops.register_kernel(op, cuda=saved["cpu"], reference=saved["cpu"],
                            ring=saved.get("ring"))
        try:
            pools = pool_copies(kv)
            want = torch.stack([
                decode_step_paged(engine.params, engine.cfg, pools, bt,
                                  feed[:, t:t + 1], pos + t,
                                  page_size=PAGE).float()
                for t in range(T)], dim=1)
        finally:
            ops.register_kernel(op, cuda=saved["cuda"],
                                reference=saved["cpu"], ring=saved.get("ring"))
    counter.launches = n
    rows = torch.as_tensor(slots, device="cuda")
    got, want = got[rows], want[rows]
    if not bool(torch.isfinite(got).all()):
        fail("verify logits are not finite")
    return float((got - want).abs().max()), float(want.abs().max())


def spec_phase(torch, np, card, cfg, params, *, scfg, label: str,
               max_len: int, new_tokens: int, verify_counter,
               decode_counter, decode_op: str, logits_atol: float,
               min_accept=None, kv_dtypes=KV_DTYPES,
               dispatch: bool = False, telemetry_chip=None) -> int:
    """Speculative decoding (SpecEngine with ``scfg``) against the plain
    engine on the same prompts (PROMPT_LENS) and weights.  Every request
    must finish; the verify kernel must launch once per target layer and
    verify step plus, with a draft model, once per draft layer and
    catch-up, and the decode kernel once per draft layer and draft step;
    each speculative stream must equal the plain greedy stream or first
    differ where the plain engine's top-2 logit margin is under
    ``logits_atol``; one verify step of a second batch must match k+1
    sequential plain-attention decode steps within ``logits_atol``;
    acceptance must reach ``min_accept`` when given; then
    :func:`pipeline_runs` serves the same prompts with ``pipeline`` off and
    double, and :func:`quantized_runs` with the target's KV pools of each
    of ``kv_dtypes`` (the draft model keeps its own).  The measured run
    replays captured graphs, whose core kernels a profiler pass counts;
    with ``dispatch`` the plain engine also serves the prompts eagerly
    (streams byte-equal) and the dispatch floors are printed; with
    ``telemetry_chip`` the measured run has telemetry on, priced on that
    chip, and prints its attainment line and propose / verify spans.
    Returns the verify kernel's launch count of the measured run and the
    ring launch counts of the first double run."""
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import now
    from repro_torch.serve import (Engine, EngineConfig, GenerateConfig,
                                   SpecEngine)

    torch.cuda.reset_peak_memory_stats()
    dcfg = scfg.draft_cfg
    ecfg = EngineConfig(num_slots=SLOTS, page_size=PAGE, max_len=max_len,
                        prefill_chunk=PREFILL_CHUNK, device="cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    gen = GenerateConfig(max_new_tokens=new_tokens)

    # warm-up engines (cuBLAS handles, allocator): not counted, not timed
    for warm in (Engine(cfg, params, ecfg),
                 SpecEngine(cfg, params, ecfg, scfg)):
        warm.submit(rng.integers(0, cfg.vocab_size, 70), GenerateConfig(6))
        warm.run()
    del warm

    base = margin_engine(cfg, params, ecfg)
    breqs = [base.submit(p, gen) for p in prompts]
    torch.cuda.synchronize()
    t0 = now()
    base.run()
    torch.cuda.synchronize()
    base_wall = now() - t0
    if dispatch:
        eager = Engine(cfg, params, dataclasses.replace(ecfg,
                                                        cuda_graphs=False))
        ereqs = [eager.submit(p, gen) for p in prompts]
        torch.cuda.synchronize()
        t0 = now()
        eager.run()
        torch.cuda.synchronize()
        eager_wall = now() - t0
        if [r.generated for r in ereqs] != [r.generated for r in breqs]:
            fail(f"{label}: the plain engine's eager greedy streams differ "
                 "from its graphed ones")
        n_plain = sum(len(r.generated) for r in breqs)
        print(f"[graph] {cfg.name} plain engine {card}: greedy streams "
              f"byte-equal with CUDA graphs on and off; tok/s graphed "
              f"{n_plain / base_wall:.2f} ({fmt_steps(step_ms(base))}; "
              f"capture {capture_ms(base):.1f} ms), eager "
              f"{n_plain / eager_wall:.2f} ({fmt_steps(step_ms(eager))})")
        dispatch_line(torch, card, cfg, params, ecfg,
                      {True: [step_ms(base)["decode"]],
                       False: [step_ms(eager)["decode"]]})
        del eager, ereqs

    engine = SpecEngine(cfg, params, ecfg if telemetry_chip is None else
                        dataclasses.replace(
                            ecfg, telemetry=True, chip=telemetry_chip,
                            telemetry_window=TELEMETRY_WINDOW), scfg)
    reqs = [engine.submit(p, gen) for p in prompts]
    verify_counter.launches = 0              # counts start here
    decode_counter.launches = 0
    torch.cuda.synchronize()
    t0 = now()
    engine.run()
    torch.cuda.synchronize()
    wall = now() - t0
    v_launches = verify_counter.launches     # counts read here
    d_launches = decode_counter.launches
    vop = verify_counter.__name__
    graph_kernels(torch, label, engine._graphs, "verify",
                  dict.fromkeys(CORE_KERNELS[vop], cfg.n_layers))
    if dcfg:
        for name, op in (("catchup", vop), ("draft", decode_op)):
            graph_kernels(torch, f"{label} draft model",
                          engine.proposer._graphs, name,
                          dict.fromkeys(CORE_KERNELS[op], dcfg.n_layers))
    steps = engine.verify_steps
    rounds = engine.phases["draft"].steps
    ver, dra = engine.phases["verify"], engine.phases["draft"]
    agg, base_agg = engine.aggregate_ledger(), base.aggregate_ledger()
    if telemetry_chip is not None:
        attainment_line(card, label, engine)

    # verify logits check on a second batch, outside the measured run: its
    # prompts prefill whole in one step, so all three decode together
    more = [engine.submit(rng.integers(0, cfg.vocab_size, n),
                          GenerateConfig(max_new_tokens=16))
            for n in (20, 40, 60)]
    logits_err = None
    while engine._sched.has_work():
        if logits_err is None and len(engine._sched.decode_requests()) == 3:
            logits_err, scale = verify_logits_check(
                torch, np, engine, ops, decode_op, verify_counter, rng)
        engine.step()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for r in breqs + reqs:
        if r.finish_reason != "length" or len(r.generated) != new_tokens:
            fail(f"{label} request {r.request_id} ended "
                 f"{r.finish_reason!r} with {len(r.generated)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            fail(f"{label} request {r.request_id}: token ids outside the "
                 "vocab")
    v_call = launches_per_call(verify_counter.__name__, cfg)
    d_call = launches_per_call(decode_op, dcfg or cfg)
    want_v = (steps * cfg.n_layers
              + (rounds * dcfg.n_layers if dcfg else 0)) * v_call
    want_d = rounds * (scfg.k - 1) * dcfg.n_layers * d_call if dcfg else 0
    if v_launches != want_v or d_launches != want_d:
        fail(f"{label}: verify kernel launched {v_launches} times (want "
             f"{want_v}), decode kernel {d_launches} (want {want_d}) for "
             f"{steps} verify steps and {rounds} draft rounds")
    if logits_err is None or any(len(r.generated) != 16 for r in more):
        fail(f"the {label} logits-check batch did not run as planned")
    print(f"[spec] {label}: verify logits vs {scfg.k + 1} sequential "
          f"plain-attention decode steps: max abs diff {logits_err:.4e} "
          f"(atol {logits_atol}; max |logit| {scale:.3f})")
    if logits_err > logits_atol:
        fail(f"{label} verify logits differ from sequential decode by "
             f"{logits_err} > {logits_atol}")
    n_same = 0
    for b, s in zip(breqs, reqs):
        diff = [j for j, (x, y) in enumerate(zip(b.generated, s.generated))
                if x != y]
        if not diff:
            n_same += 1
            continue
        j = diff[0]
        m = base.margins[(b.request_id, j)]
        print(f"[spec] {label} request {b.request_id}: streams first differ "
              f"at token {j} (plain {b.generated[j]}, spec "
              f"{s.generated[j]}); plain top-2 logit margin there {m:.4e}")
        if m > logits_atol:
            fail(f"{label} request {b.request_id}: speculative stream "
                 f"differs from the plain one at token {j}, where the "
                 f"plain top-2 margin {m} exceeds {logits_atol}")
    acc = agg.acceptance_rate
    n_tok = sum(len(r.generated) for r in reqs)
    print(f"[spec] {label}: {len(reqs)} requests (prompts "
          f"{list(PROMPT_LENS)}, {new_tokens} new tokens, {SLOTS} slots, "
          f"k {scfg.k}, proposer {scfg.proposer}) all finished; "
          f"{n_same}/{len(reqs)} streams equal the plain engine's; "
          f"{steps} verify steps, {rounds} draft rounds; verify kernel "
          f"launches {v_launches} = {want_v}, decode kernel {d_launches} = "
          f"{want_d}")
    print(f"[spec] {label} {card}: plain engine {n_tok / base_wall:.2f} "
          f"tok/s (mean decode step "
          f"{base.phases['decode'].wall_s / max(base.phases['decode'].steps, 1) * 1e3:.3f} ms); "
          f"speculative {n_tok / wall:.2f} tok/s (mean verify step "
          f"{ver.wall_s / max(ver.steps, 1) * 1e3:.3f} ms, mean draft "
          f"round {dra.wall_s / max(dra.steps, 1) * 1e3:.3f} ms; CUDA "
          f"graphs, capture {capture_ms(engine):.1f} ms); "
          f"acceptance rate {acc:.3f} (random weights), tokens per verify "
          f"pass {agg.tokens_per_pass:.3f}; ledger arithmetic intensity "
          f"{agg.arithmetic_intensity:.3f} FLOP/B (plain "
          f"{base_agg.arithmetic_intensity:.3f}); peak memory "
          f"{peak_gb:.2f} GB")
    if min_accept is not None and acc < min_accept:
        fail(f"{label}: acceptance rate {acc} < {min_accept}")

    def want_off(e):
        rounds = e.phases["draft"].steps
        want = {verify_counter.__name__: (e.verify_steps * cfg.n_layers
                + (rounds * dcfg.n_layers if dcfg else 0)) * v_call}
        if dcfg:
            want[decode_op] = rounds * (scfg.k - 1) * dcfg.n_layers * d_call
        return want
    rings, _ = pipeline_runs(
        torch, card, label, cfg,
        lambda pl, g: SpecEngine(cfg, params, dataclasses.replace(
            ecfg, pipeline=pl, cuda_graphs=g), scfg),
        prompts, gen, want_off)
    quantized_runs(
        torch, np, card, label, cfg,
        lambda kvd, pl, g=True: SpecEngine(cfg, params, dataclasses.replace(
            ecfg, kv_dtype=kvd, pipeline=pl, cuda_graphs=g), scfg),
        prompts, gen, kv_dtypes, want_off,
        ([list(r.generated) for r in reqs], n_tok / wall, peak_gb,
         pool_nbytes(engine)),
        lambda e: verify_logits_check(torch, np, e, ops, decode_op,
                                      verify_counter, rng),
        logits_atol, more=((20, 40, 60), 16))
    return v_launches, rings


# telemetry: engine steps per attainment window (a qwen3-0.6b step is
# ~7 ms graphed, so a window is ~0.1 s), the bar on tok/s with telemetry
# on against off (the reference's, tests/test_obs.py), the most a window
# may reach of a measured roof, and the events a serve trace must hold
TELEMETRY_WINDOW = 16
TELEMETRY_BAR = 1.25
MAX_ATTAINMENT = 1.05
TRACE_NAMES = {"prefill_chunk", "decode_step", "submit", "place",
               "first_token", "request"}


def check_windows(label: str, windows) -> None:
    """Every attainment window must name a roof it has and stay within
    MAX_ATTAINMENT of it (a measured roof is not clamped)."""
    if not windows:
        fail(f"{label}: no attainment window closed")
    for w in windows:
        if w.binding_roof not in w.roofs or not 0.0 < w.fraction:
            fail(f"{label}: window {w.index} binds {w.binding_roof!r} "
                 f"at {w.fraction}")
        if w.fraction > MAX_ATTAINMENT:
            fail(f"{label}: window {w.index} at {w.fraction * 100:.1f}% of "
                 f"its {w.binding_roof} roof (> {MAX_ATTAINMENT * 100:.0f}%)")


def attainment_line(card, label: str, engine) -> None:
    """One line for an engine's attainment windows on the measured roofs
    (harvested first), with its trace's step spans; the trace must
    validate and the windows pass :func:`check_windows`."""
    from collections import Counter
    from repro_torch.obs import validate_trace
    obs = engine.obs
    obs.harvest(engine)
    windows = obs.attainment.windows
    check_windows(label, windows)
    doc = obs.export_trace()
    errs = validate_trace(doc)
    if errs:
        fail(f"{label}: trace invalid: {errs[:3]}")
    spans = Counter(e["name"] for e in doc["traceEvents"] if e["ph"] == "X")
    fr = sorted(w.fraction for w in windows)
    binds = Counter(w.binding_roof for w in windows)
    print(f"[telemetry] {label} {card}: {len(windows)} attainment windows "
          f"on {engine.ecfg.chip.name}, binding {dict(binds)}, fraction of "
          f"the binding roof min {fr[0] * 100:.2f}% median "
          f"{fr[len(fr) // 2] * 100:.2f}% max {fr[-1] * 100:.2f}%; trace "
          f"valid, {len(doc['traceEvents'])} events, spans "
          + ", ".join(f"{k} {spans[k]}" for k in ("decode_step", "propose",
                                                  "verify", "prefill_chunk")
                      if spans[k]))


def telemetry_phase(torch, np, card, cfg, params, roof) -> None:
    """Serve telemetry at full width: qwen3-0.6b graphed, pipeline off,
    PROMPT_LENS, on the card's measured roofs (``roof.to_chipspec()``).
    One engine with telemetry off and one with it on, each warmed up
    first on prompts of the same lengths (its decode and prefill graphs
    captured there, before the tracker's baseline),
    then runs off, on, off, on: greedy streams and launch counts equal in
    all four, tok/s on within TELEMETRY_BAR of off, the trace valid with
    the reference's events, every window within MAX_ATTAINMENT of its
    roof, the TTFT breakdown summing to TTFT; prints the windows
    (``attainment_rows``), the TTFT split, the wall of a full window beyond
    its HBM-bound time beside the dispatch floor, and
    ``Engine.hierarchy_report`` on the measured betas."""
    from collections import Counter
    from repro_torch.core.roofline.report import (ATTAINMENT_HEADER,
                                                  attainment_rows,
                                                  text_table)
    from repro_torch.obs import validate_trace
    from repro_torch.serve import Engine, EngineConfig, GenerateConfig

    chip = roof.to_chipspec()
    base = EngineConfig(num_slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
                        prefill_chunk=PREFILL_CHUNK, device="cuda",
                        chip=chip, telemetry_window=TELEMETRY_WINDOW)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    gen = GenerateConfig(max_new_tokens=NEW_TOKENS)
    engines = {on: Engine(cfg, params, dataclasses.replace(base,
                                                           telemetry=on))
               for on in (False, True)}
    for eng in engines.values():
        # prompts of the measured lengths: every prefill shape and the
        # decode step captured before the tracker's baseline
        for n in PROMPT_LENS:
            eng.submit(rng.integers(0, cfg.vocab_size, n), GenerateConfig(8))
        eng.run()
        eng.reset_phases()
    on_eng = engines[True]
    obs = on_eng.obs
    w0 = len(obs.attainment.windows)       # the warm-up's, with captures
    runs, full = [], []
    for on in (False, True, False, True):
        if on:
            obs.attainment.rebase(on_eng)    # no window spans the idle gap
            n0 = len(obs.attainment.windows)
        reqs, got, wall = counted_run(torch, engines[on], prompts, gen)
        if on:
            # windows closed by ticks hold TELEMETRY_WINDOW steps each;
            # the harvest closes the run's last, shorter one
            full += obs.attainment.windows[n0:]
            obs.harvest(on_eng)
        runs.append((on, reqs, got, wall))
    first_streams = [list(r.generated) for r in runs[0][1]]
    for on, reqs, got, _ in runs:
        if [list(r.generated) for r in reqs] != first_streams:
            fail(f"telemetry {'on' if on else 'off'}: greedy streams differ")
        if got != runs[0][2]:
            fail(f"telemetry {'on' if on else 'off'}: launches {got}, want "
                 f"{runs[0][2]}")
        if any(r.finish_reason != "length" for r in reqs):
            fail("telemetry phase: a request did not finish")
    n_tok = sum(len(x) for x in first_streams)
    rate = {on: [n_tok / w for o, _, _, w in runs if o == on]
            for on in (False, True)}
    ratio = np.mean(rate[False]) / np.mean(rate[True])
    print(f"[telemetry] {cfg.name} {card}: greedy streams of 4 runs "
          f"(telemetry off, on, off, on; graphed, pipeline off) byte-equal; "
          f"launches per run {runs[0][2]['paged_attention']} "
          f"paged_attention, equal in all; tok/s off "
          + ", ".join(f"{x:.2f}" for x in rate[False]) + ", on "
          + ", ".join(f"{x:.2f}" for x in rate[True])
          + f" (mean off / on {ratio:.3f}, bar {TELEMETRY_BAR})")
    if ratio > TELEMETRY_BAR:
        fail(f"telemetry on is {ratio:.3f}x slower than off "
             f"(bar {TELEMETRY_BAR})")

    doc = obs.export_trace()
    errs = validate_trace(doc)
    names = Counter(e["name"] for e in doc["traceEvents"])
    if errs or not TRACE_NAMES <= set(names):
        fail(f"telemetry trace: errors {errs[:3]}, names {sorted(names)}")
    if names["decode_step"] != on_eng.decode_steps:
        fail(f"{names['decode_step']} decode_step spans for "
             f"{on_eng.decode_steps} decode steps")
    print(f"[telemetry] {cfg.name} trace: valid, {len(doc['traceEvents'])} "
          "events: " + ", ".join(f"{k} {names[k]}" for k in sorted(
              TRACE_NAMES | {"pool_pages", "roofline_attainment"})))

    windows = obs.attainment.windows[w0:]
    check_windows(cfg.name, windows)
    print(f"[telemetry] {cfg.name} {card}: attainment windows of "
          f"{TELEMETRY_WINDOW} steps (each run's last one shorter) on the "
          f"measured roofs ({chip.name}):")
    print(text_table(attainment_rows(windows), ATTAINMENT_HEADER))

    on_reqs = [r for on, reqs, _, _ in runs if on for r in reqs]
    split = {k: [] for k in ("queue_wait_s", "prefill_s", "first_decode_s")}
    for r in on_reqs:
        bd = r.ttft_breakdown()
        if abs(sum(bd.values()) - r.ttft) > 1e-9:
            fail(f"request {r.request_id}: TTFT breakdown {bd} does not sum "
                 f"to {r.ttft}")
        for k, v in bd.items():
            split[k].append(v)
    print(f"[telemetry] {cfg.name} TTFT breakdown over the on runs' "
          f"{len(on_reqs)} requests (mean ms; segments sum to TTFT): "
          + ", ".join(f"{k[:-2]} {np.mean(v) * 1e3:.2f}"
                      for k, v in split.items())
          + f", TTFT {np.mean([r.ttft for r in on_reqs]) * 1e3:.2f}")

    floor_ms = on_eng.measure_dispatch_overhead() * 1e3
    step_ms = [w.dt_s / TELEMETRY_WINDOW * 1e3 for w in full]
    hbm_ms = [s * w.attainment["hbm"] for s, w in zip(step_ms, full)]
    beyond = [s - h for s, h in zip(step_ms, hbm_ms)]
    if full:
        print(f"[telemetry] {cfg.name} {card}: {len(full)} full windows: "
              f"wall a step {np.median(step_ms):.3f} ms (median), its "
              f"HBM-bound time {np.median(hbm_ms):.3f} ms, beyond it "
              f"{np.median(beyond):.3f} ms (min {min(beyond):.3f}, max "
              f"{max(beyond):.3f}) against the graphed dispatch floor "
              f"{floor_ms:.3f} ms")
    print(on_eng.hierarchy_report(betas=roof.level_betas(),
                                  overlap=roof.overlap))


# the [options] phase: prefix sharing (a 96-token prefix, six full pages,
# with distinct tails, and one 128-token prompt served twice, the second
# time an aligned full hit whose last token is recomputed, a T = 1 chunk,
# into the shared page after copy-on-write), preemption in a pool too
# small for the first four requests' contexts (20 pages beside the trash
# page: they are admitted on 18 and grow to 22 at OPT_NEW_TOKENS), and
# sampled requests, each request seeded
OPT_PREFIX, OPT_TAILS, OPT_REPEAT = 96, (20, 37, 5), 128
OPT_NEW_TOKENS, PREEMPT_PAGES = 16, 21
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)
# the sampler on the card: draws of sample_tokens from one logits row (one
# seeded stream each, in batches of rows), held against the filtered,
# tempered softmax by total variation within sampling.tv_null_bound (the
# null TV's mean + 6 sigma; under 0.02 at these draws); the row: qwen3's
# vocabulary of N(0, 9) logits, seeded
SAMPLER_DRAWS, SAMPLER_BATCH = 20000, 1000
# capacity_report counters that must agree graphed and eager (all keys)
CAP_KEYS = ("pages_total", "pages_in_use", "pages_peak", "pages_cached",
            "pages_deduped", "cow_copies", "evictions", "preemptions",
            "page_bytes", "pool_bytes", "params_bytes", "pages_per_request",
            "effective_batch", "capacity_max_batch")


def serve_waves(torch, engine, waves, gen, seeds=None):
    """:func:`counted_run` over each list of prompts in ``waves`` in turn on
    one engine (request i seeded ``seeds[i]`` across the waves).  Returns
    (requests, {kernel: launches} summed, wall seconds summed)."""
    reqs, counts, wall = [], {}, 0.0
    for prompts in waves:
        part = None if seeds is None else seeds[len(reqs):]
        r, c, w = counted_run(torch, engine, prompts, gen, part)
        reqs += r
        wall += w
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return reqs, counts, wall


def pools_equal_outside_trash(torch, a, b) -> bool:
    """Two engines' page pools byte-equal on every page but page 0 (the
    trash page, which idle lanes and a bucket's pad positions write in
    any order), and their recurrent state rows byte-equal in every slot."""
    from repro_torch.models.params import tree_leaves
    return all(torch.equal(x[:, 1:], y[:, 1:]) if paged else
               torch.equal(x, y) for x, y, paged in zip(
                   tree_leaves(a._kv.pools), tree_leaves(b._kv.pools),
                   tree_leaves(a._kv._paged)))


def prefill_capture_ms(engine) -> float:
    """Milliseconds an engine's captured prefill graphs took to capture."""
    return sum(g.capture_s for n, g in engine._graphs.graphs.items()
               if n.startswith("prefill")) * 1e3


def graphed_and_eager(torch, label: str, case: str, make, waves, gen,
                      seeds=None):
    """One option case served by ``make(True)`` (CUDA graphs) and
    ``make(False)`` (the same bodies eagerly), one after the other: every
    request must finish, and the two must give byte-equal streams, pools
    byte-equal outside page 0, equal paged-kernel launch counts and equal
    ``capacity_report``s; each pool passes ``BlockPool.check`` against its
    tables.  Returns the graphed engine, its requests and its report."""
    from repro_torch.serve.crosscheck import capacity_report
    runs = {}
    for graphs in (True, False):
        engine = make(graphs)
        reqs, counts, wall = serve_waves(torch, engine, waves, gen, seeds)
        if any(r.finish_reason != "length" for r in reqs):
            fail(f"{label} {case} {run_kind(graphs)}: a request did not "
                 "finish")
        try:
            engine._kv.pool.check(engine._kv.table_refs())
        except AssertionError as e:
            fail(f"{label} {case} {run_kind(graphs)}: pool check: {e}")
        runs[graphs] = (engine, reqs, counts, capacity_report(engine), wall)
    (g, greqs, gcounts, gcap, gwall), (e, ereqs, ecounts, ecap, ewall) = (
        runs[True], runs[False])
    if [r.generated for r in greqs] != [r.generated for r in ereqs]:
        fail(f"{label} {case}: streams differ graphed and eager")
    if not pools_equal_outside_trash(torch, g, e):
        fail(f"{label} {case}: pools differ graphed and eager outside "
             "page 0")
    if gcounts != ecounts:
        fail(f"{label} {case}: launches graphed {gcounts}, eager {ecounts}")
    if {k: gcap[k] for k in CAP_KEYS} != {k: ecap[k] for k in CAP_KEYS}:
        fail(f"{label} {case}: capacity graphed {gcap}, eager {ecap}")
    if g.prefill_shapes and not any(n.startswith("prefill")
                                    for n in g._graphs.graphs):
        fail(f"{label} {case}: no prefill step was captured")
    n_tok = sum(len(r.generated) for r in greqs)
    launched = {k: v for k, v in gcounts.items() if v}
    print(f"[options] {label} {case}: graphed = eager: streams byte-equal, "
          f"pools byte-equal outside page 0, launches {launched}, capacity "
          f"pages peak {gcap['pages_peak']}/{gcap['pages_total']} deduped "
          f"{gcap['pages_deduped']} cow {gcap['cow_copies']} evictions "
          f"{gcap['evictions']} preemptions {gcap['preemptions']}; prefill "
          f"shapes {sorted(g.prefill_shapes)}; tok/s graphed "
          f"{n_tok / gwall:.2f}, eager {n_tok / ewall:.2f}")
    return g, greqs, gcap


def against_baseline(label: str, case: str, base, base_reqs, reqs,
                     logits_atol: float, exact: bool) -> int:
    """Streams of ``reqs`` against the same requests' greedy streams on a
    :func:`margin_engine` ``base``: equal, or (unless ``exact``) first
    differing where the base run's top-2 logit margin is under
    ``logits_atol`` (the chunk boundaries differ, so bf16 GEMMs round
    differently).  Returns how many are equal."""
    n_same = 0
    for b, r in zip(base_reqs, reqs):
        diff = [j for j, (x, y) in enumerate(zip(b.generated, r.generated))
                if x != y]
        if not diff:
            n_same += 1
            continue
        j = diff[0]
        m = base.margins[(b.request_id, j)]
        print(f"[options] {label} {case} request {b.request_id}: first "
              f"differs from the baseline at token {j}, where the baseline's "
              f"top-2 logit margin is {m:.4e}")
        if exact or m > logits_atol:
            fail(f"{label} {case} request {b.request_id}: stream differs "
                 f"from the baseline at token {j} (top-2 margin {m}, "
                 f"{'exact hold' if exact else f'atol {logits_atol}'})")
    return n_same


def options_phase(torch, np, card, cfg, params, *, max_len: int,
                  logits_atol: float) -> None:
    """The engine options no other phase takes, each served graphed and
    eagerly (:func:`graphed_and_eager`): prefix sharing with copy-on-write
    (``prefix_cache=True`` must raise on an MoE or recurrent model, as in
    the reference), preemption by swap and by recompute in a pool of
    PREEMPT_PAGES, sampled requests (SAMPLED, each seeded).  Prefix and
    preemption streams are held against a fully backed, prefix-off run:
    swap exactly, prefix sharing and recompute (other chunk boundaries)
    equal or first differing under the baseline's top-2 margin; an MoE
    model's recompute re-prefills committed tokens at another chunk
    capacity, so it is reported, not held."""
    from repro_torch.serve import Engine, EngineConfig, GenerateConfig
    from repro_torch.serve import sampling
    from repro_torch.serve.kv_cache import supports_prefix_cache
    moe = any(b.ffn == "moe" for b in cfg.block_pattern)
    ecfg = EngineConfig(num_slots=SLOTS, page_size=PAGE, max_len=max_len,
                        prefill_chunk=PREFILL_CHUNK, device="cuda")
    V = cfg.vocab_size
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, V, n) for n in PROMPT_LENS]
    gen = GenerateConfig(max_new_tokens=OPT_NEW_TOKENS)

    def engines(**kw):
        return lambda g: Engine(cfg, params, dataclasses.replace(
            ecfg, cuda_graphs=g, **kw))

    with deterministic(torch, moe):
        if not supports_prefix_cache(cfg):
            try:
                Engine(cfg, params, dataclasses.replace(
                    ecfg, prefix_cache=True)).reset()
            except NotImplementedError as e:
                print(f"[options] {cfg.name}: prefix_cache=True raises "
                      f"NotImplementedError, as in the reference ({e})")
            else:
                fail(f"{cfg.name}: prefix_cache=True did not raise")
        else:
            shared = rng.integers(0, V, OPT_PREFIX)
            repeat = rng.integers(0, V, OPT_REPEAT)
            tails = [np.concatenate([shared, rng.integers(0, V, n)])
                     for n in OPT_TAILS]
            waves = [[tails[0], repeat], [tails[1], tails[2], repeat]]
            eng, reqs, cap = graphed_and_eager(
                torch, cfg.name, "prefix sharing", engines(prefix_cache=True),
                waves, gen)
            if not (cap["pages_deduped"] > 0 and cap["cow_copies"] > 0):
                fail(f"{cfg.name} prefix sharing: deduped "
                     f"{cap['pages_deduped']}, cow {cap['cow_copies']}")
            if ("chunk", 1) not in eng.prefill_shapes:
                fail(f"{cfg.name}: the aligned full hit ran no T = 1 chunk")
            base = margin_engine(cfg, params, ecfg)
            breqs, _, _ = serve_waves(torch, base, waves, gen)
            n = against_baseline(cfg.name, "prefix sharing", base, breqs,
                                 reqs, logits_atol, exact=False)
            print(f"[options] {cfg.name} prefix sharing: {n}/{len(reqs)} "
                  "streams equal the prefix-off run's (the rest may differ "
                  f"first under its top-2 margin, atol {logits_atol})")

        base = margin_engine(cfg, params, ecfg)
        breqs, _, _ = serve_waves(torch, base, [prompts], gen)
        for mode in ("swap", "recompute"):
            eng, reqs, cap = graphed_and_eager(
                torch, cfg.name, f"preempt {mode}", engines(
                    num_pages=PREEMPT_PAGES, preempt_mode=mode),
                [prompts], gen)
            if cap["preemptions"] <= 0:
                fail(f"{cfg.name} preempt {mode}: nothing was preempted")
            swapped = sum(r.ledger.swap_bytes for r in reqs)
            if mode == "swap" and swapped <= 0:
                fail(f"{cfg.name} preempt swap: no bytes swapped")
            if mode == "swap":
                host_line(card, cfg, eng)
            if moe and mode == "recompute":
                n = sum(b.generated == r.generated
                        for b, r in zip(breqs, reqs))
                print(f"[options] {cfg.name} preempt recompute: {n}/"
                      f"{len(reqs)} streams equal the fully backed run's "
                      "(not held: a re-prefill runs committed tokens at "
                      "another MoE capacity)")
                continue
            n = against_baseline(cfg.name, f"preempt {mode}", base, breqs,
                                 reqs, logits_atol, exact=mode == "swap")
            print(f"[options] {cfg.name} preempt {mode}: {cap['preemptions']} "
                  f"preemptions, {swapped / 1e6:.2f} MB swapped; {n}/"
                  f"{len(reqs)} streams equal the fully backed run's"
                  + (" (exact hold)" if mode == "swap" else
                     f" (the rest may differ first under its top-2 margin, "
                     f"atol {logits_atol})"))

        sgen = GenerateConfig(max_new_tokens=OPT_NEW_TOKENS, **SAMPLED)
        seeds = [sampling.fold_seed(11, b) for b in range(len(prompts))]
        eng, reqs, _ = graphed_and_eager(torch, cfg.name, "sampled",
                                         engines(), [prompts], sgen, seeds)
        n = sum(b.generated == r.generated for b, r in zip(breqs, reqs))
        print(f"[options] {cfg.name} sampled (temperature "
              f"{SAMPLED['temperature']}, top-k {SAMPLED['top_k']}, top-p "
              f"{SAMPLED['top_p']}, seeded): streams byte-equal graphed and "
              f"eager; {n}/{len(reqs)} equal the greedy ones")


def host_line(card, cfg, eng) -> None:
    """crosscheck_host on a swap engine: the ledger's slot_swap_bytes
    against the walk of the gather-and-pack swap_out runs, at the pages of
    the longest prompt and of a full slot; both ratio 1.0."""
    from repro_torch.serve.crosscheck import crosscheck_host
    kv = eng._kv
    for n_blocks in (kv.pages_needed(max(PROMPT_LENS)),
                     kv.pages_needed(kv.max_len)):
        h = crosscheck_host(eng, n_blocks)
        if h["host_ratio"] != 1.0:
            fail(f"{cfg.name} crosscheck_host: ratio {h['host_ratio']} "
                 f"({h['analytic_swap_bytes']} vs {h['hlo_output_bytes']})")
        print(f"[crosscheck] {cfg.name} host (swap) {card}: slot_swap_bytes "
              f"{h['analytic_swap_bytes'] / 1e6:.4f} MB = walked "
              f"gather-and-pack output {h['hlo_output_bytes'] / 1e6:.4f} MB "
              f"at {h['n_blocks']} pages, ratio {h['host_ratio']:.1f}")


def sampler_distribution(torch, np, card, vocab: int) -> None:
    """SAMPLER_DRAWS draws of ``sampling.sample_tokens`` on the card from
    one logits row at SAMPLED's settings: no draw outside the kept set,
    and the frequencies within ``sampling.tv_null_bound`` of the filtered,
    tempered softmax in total variation."""
    from repro_torch.serve import sampling
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = torch.randn(vocab, generator=gen, device="cuda") * 3
    t, k, p = SAMPLED["temperature"], SAMPLED["top_k"], SAMPLED["top_p"]
    target = sampling.target_distribution(row, t, k, p)
    draws = []
    for i in range(0, SAMPLER_DRAWS, SAMPLER_BATCH):
        b = min(SAMPLER_BATCH, SAMPLER_DRAWS - i)
        draws.append(sampling.sample_tokens(
            row[None].expand(b, -1), np.arange(i, i + b),
            np.zeros(b, np.int32), np.full(b, t, np.float32),
            np.full(b, k, np.int32), np.full(b, p, np.float32)).cpu())
    toks = torch.cat(draws).numpy()
    freq = np.bincount(toks, minlength=vocab) / SAMPLER_DRAWS
    tv = 0.5 * np.abs(freq - target).sum()
    bound = sampling.tv_null_bound(target, SAMPLER_DRAWS)
    outside = int((target[toks] == 0).sum())
    print(f"[options] sampler on the card {card}: {SAMPLER_DRAWS} seeded "
          f"draws of sample_tokens (temperature {t}, top-k {k}, top-p {p}) "
          f"from one row of {vocab} logits: {int((target > 0).sum())} kept, "
          f"{outside} draws outside the kept set; total variation "
          f"{tv:.4f} against the filtered, tempered softmax (bound "
          f"{bound:.4f}: the null mean + 6 sigma)")
    if outside or not tv <= bound:
        fail(f"sampler on the card: {outside} draws outside the kept set, "
             f"total variation {tv} > {bound}")


# the [crosscheck] phase: the ledger's W and Q held against the op-level
# walk of the steps the engines run (serve/crosscheck.py, fake CPU
# tensors of the live shapes), its vmem bytes against the launch-grid
# walk of the CUDA kernels and against what the card's L2 could move in
# each core's measured time.  Bars: the reference's 10% on W
# (tests/test_serve_crosscheck.py), verify intensity above 2.5 times the
# decode step's (the same), the reference's crosscheck_overlap wall_tol;
# bytes equal to the ledger's plus the terms crosscheck counts from the
# parameter and pool trees, up to float64 rounding
XC_FLOPS_TOL = 0.10
XC_VERIFY_AI = 2.5
XC_WALL_TOL = 0.25
# on-chip bytes over the measured L2 beta, as a share of a core's
# measured time: a count the kernel could not have moved in its time is
# wrong (5% for the two timings' spread)
XC_L2_SHARE = 1.05
# prompts of at most one prefill chunk (one step prefills all four), and
# the decode steps each engine serves
XC_PROMPTS = (17, 45, 60, 33)
XC_NEW_TOKENS = 24
# kernel phase label -> (on-chip bytes of one call at the phase's main
# inputs, kernel ms, ring ms), filled by the kernel phases
ONCHIP: dict = {}


def onchip_call(pa, pos, T: int, n_blocks: int, **shape) -> float:
    """On-chip bytes of one bf16 call (kernels.paged_attention
    ``gqa_onchip_bytes`` / ``mla_onchip_bytes``) at positions ``pos``."""
    f = pa.gqa_onchip_bytes if "kv_heads" in shape else pa.mla_onchip_bytes
    return sum(f(int(p) + 1, page_size=PAGE, n_q=T, n_blocks=n_blocks,
                 isize=2, kv_isize=2, **shape) for p in pos.tolist())


def l2_share_lines(card, roof) -> None:
    """Each core's on-chip bytes at its kernel phase's main inputs over
    the measured L2 beta, as a share of the kernel's and the ring's
    measured times; fails above XC_L2_SHARE."""
    beta = roof.level_betas().vmem
    if len(ONCHIP) != 4:
        fail(f"{len(ONCHIP)} kernel phases counted their on-chip bytes")
    for label, (nbytes, ms, ring_ms) in ONCHIP.items():
        floor = nbytes / beta * 1e3
        shares = floor / ms, floor / ring_ms
        if max(shares) > XC_L2_SHARE:
            fail(f"{label}: {nbytes} on-chip bytes need {floor:.5f} ms at "
                 f"the L2 beta, {max(shares):.3f} of the measured time")
        print(f"[crosscheck] {label} {card}: on-chip {nbytes / 1e6:.3f} MB "
              f"at the L2 beta {beta / 1e12:.3f} TB/s = {floor * 1e3:.3f} "
              f"us; share of the kernel's {ms:.4f} ms {shares[0]:.3f}, of "
              f"the ring's {ring_ms:.4f} ms {shares[1]:.3f} (limit "
              f"{XC_L2_SHARE})")


def xc_engine(np, cfg, make, label: str):
    """An engine from ``make()`` served XC_PROMPTS once (graphs captured),
    then the same prompts stepped until all four decode: mid-decode."""
    from repro_torch.serve import GenerateConfig
    eng = make()
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in XC_PROMPTS]
    gen = GenerateConfig(max_new_tokens=XC_NEW_TOKENS)
    for p in prompts:
        eng.submit(p, gen)
    eng.run()
    for p in prompts:
        eng.submit(p, gen)
    for _ in range(4):
        if len(eng._sched.decode_requests()) == len(prompts):
            return eng
        eng.step()
    fail(f"{label}: {len(eng._sched.decode_requests())} of "
         f"{len(prompts)} requests decoding after 4 steps")


def xc_line(card, label: str, out: dict) -> None:
    """Print one cross-check: W and Q from the ledger and the walk, their
    ratios, the naive FLOPs and the walk's parameter / pool / activation
    split (``crosscheck._compare``'s keys)."""
    scope = out["scopes"].get("paged_attention", {})
    print(f"[crosscheck] {label} {card}: W ledger "
          f"{out['analytic_flops'] / 1e9:.4f} GFLOP, walk "
          f"{out['hlo_flops'] / 1e9:.4f} (raw {out['hlo_flops_raw'] / 1e9:.4f};"
          f" naive, matmuls only, {out['naive_flops'] / 1e9:.4f}; the plain "
          f"paged attention's, over every table line, "
          f"{scope.get('flops', 0.0) / 1e9:.4f}, priced as the kernel's "
          f"live lines {out['kernel_flops'] / 1e9:.4f}), "
          f"ratio {out['flops_ratio']:.4f}; Q ledger "
          f"{out['analytic_bytes'] / 1e9:.4f} GB, walk "
          f"{out['hlo_bytes'] / 1e9:.4f} GB (raw {out['hlo_bytes_raw'] / 1e9:.4f},"
          f" ratio {out['bytes_ratio']:.4f}) = parameters "
          f"{out['param_bytes'] / 1e9:.4f} + pools "
          f"{out['pool_bytes'] / 1e6:.3f} MB appended + "
          f"{out['kernel_bytes'] / 1e6:.3f} MB kernel walk + activations "
          f"{out['activation_bytes'] / 1e9:.4f} GB; weights + KV "
          f"{out['weights_kv_bytes'] / 1e9:.4f} GB, ratio "
          f"{out['weights_kv_ratio']:.4f}")


def xc_holds(label: str, out: dict, flops: bool = True) -> None:
    """W within XC_FLOPS_TOL (unless ``flops`` is False); the walk's
    weights + KV (an MoE step's with the active experts for all of them)
    equal to the ledger's Q plus the terms counted from the parameter and
    pool trees, up to ``bytes_tolerance`` of it (``crosscheck.bytes_held``:
    float64 rounding; a ledger formula off by any weight, norm, line or
    table leaves its bytes)."""
    from repro_torch.serve.crosscheck import bytes_held
    if flops and abs(out["flops_ratio"] - 1.0) > XC_FLOPS_TOL:
        fail(f"{label}: W ratio {out['flops_ratio']:.4f} outside "
             f"{XC_FLOPS_TOL}")
    analytic = out["analytic_bytes"]
    if not bytes_held(out):
        fail(f"{label}: weights + KV {out['weights_kv_dense_bytes']} = "
             f"ledger {analytic} + named {out['named_bytes']} + residual "
             f"{out['bytes_residual']}, over {out['bytes_tolerance']} of "
             f"the ledger's Q")
    print(f"[crosscheck] {label}: held: W within {XC_FLOPS_TOL:.0%}"
          + ("" if flops else " not held (reported)")
          + f"; weights + KV {out['weights_kv_dense_bytes'] / 1e9:.6f} GB = "
          f"ledger Q {analytic / 1e9:.6f} GB + lookup rows "
          f"{out['lookup_bytes'] / 1e6:.3f} MB + norm scales "
          f"{out['norm_bytes'] / 1e6:.3f} MB + wide leaves "
          f"{out['wide_bytes'] / 1e6:.3f} MB + appended lines "
          f"{out['pool_bytes'] / 1e6:.3f} MB - untied input table "
          f"{out['untied_table_bytes'] / 1e6:.3f} MB (the ledger's "
          f"exception: a pass the step never makes) + residual "
          f"{out['bytes_residual']:.1f} B (bar {out['bytes_tolerance']:g} "
          f"of Q); line {out['line_bytes']:.0f} B from the pool tree, "
          f"{out['ledger_line_bytes']} B in the ledger")


def vmem_hold(label: str, eng, n_q: int = 1) -> None:
    from repro_torch.serve.crosscheck import crosscheck_vmem
    vm = crosscheck_vmem(eng, n_q=n_q)
    if vm["vmem_ratio"] != 1.0:
        fail(f"{label}: vmem ratio {vm['vmem_ratio']} (closed form "
             f"{vm['analytic_vmem_bytes']}, launch walk "
             f"{vm['kernel_walk_bytes']})")
    print(f"[crosscheck] {label} vmem (pipeline {vm['pipeline']}, T "
          f"{n_q}): ledger {vm['analytic_vmem_bytes'] / 1e6:.4f} MB = launch "
          f"walk {vm['kernel_walk_bytes'] / 1e6:.4f} MB, ratio "
          f"{vm['vmem_ratio']:.1f}, contexts {vm['contexts']}")


def crosscheck_qwen(torch, np, card, cfg, params, roof) -> None:
    """qwen3-0.6b at full width, 4 slots mid-decode: crosscheck_decode (W
    within 10%, weights + KV held by ``crosscheck.bytes_held``), the vmem
    ledger against the launch walk, step_cost_analysis of the graphed
    decode + sample step against its measured wall (the wall at least
    max(W / pi, Q / beta) at the measured roofs), the four cores' L2
    shares, and crosscheck_overlap pipeline off against double."""
    from repro_torch.serve import Engine, EngineConfig, GenerateConfig
    from repro_torch.serve import crosscheck as xc
    ecfg = EngineConfig(num_slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
                        prefill_chunk=PREFILL_CHUNK, device="cuda")
    l2_share_lines(card, roof)
    label = f"{cfg.name} decode"
    eng = xc_engine(np, cfg, lambda: Engine(cfg, params, ecfg), label)
    out = xc.crosscheck_decode(eng)
    xc_line(card, label, out)
    xc_holds(label, out)
    vmem_hold(label, eng)
    step = xc.step_cost_analysis(eng)
    eng.reset_phases()
    eng.run()
    ph = eng.phases["decode"]
    wall = ph.wall_s / max(ph.steps, 1)
    betas = roof.level_betas()
    pi = roof.flops_for(cfg.dtype)
    floor = max(step["flops"] / pi, step["bytes"] / betas.hbm)
    if floor > wall:
        fail(f"{label}: the graphed step's wall {wall * 1e3:.4f} ms is "
             f"under its device floor {floor * 1e3:.4f} ms")
    print(f"[crosscheck] {label} step_cost_analysis {card}: decode + "
          f"sample W {step['flops'] / 1e9:.4f} GFLOP, Q "
          f"{step['bytes'] / 1e9:.4f} GB (raw {step['bytes_raw'] / 1e9:.4f});"
          f" floor max(W / pi, Q / beta) = {floor * 1e3:.4f} ms at pi "
          f"{pi / 1e12:.1f} TFLOP/s, beta {betas.hbm / 1e12:.3f} TB/s; "
          f"graphed step wall {wall * 1e3:.4f} ms over {ph.steps} steps, "
          f"floor share {floor / wall:.4f} (must be <= 1)")

    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in XC_PROMPTS]
    pair = [Engine(cfg, params, dataclasses.replace(ecfg, pipeline=pl))
            for pl in ("off", "double")]
    try:
        ov = xc.crosscheck_overlap(
            *pair, prompts, GenerateConfig(max_new_tokens=XC_NEW_TOKENS),
            windows=3, wall_tol=XC_WALL_TOL, betas=betas)
    except RuntimeError as e:
        fail(f"{cfg.name} crosscheck_overlap: {e}")
    print(f"[crosscheck] {cfg.name} overlap (pipeline off vs double) {card}:"
          f" streams byte-equal; levels {ov['levels']}; vmem term "
          f"{ov['terms_off']['vmem'] * 1e6:.3f} vs "
          f"{ov['terms_on']['vmem'] * 1e6:.3f} us a step (not grown); wall "
          f"{ov['wall_off_s'] * 1e3:.4f} vs {ov['wall_on_s'] * 1e3:.4f} ms a "
          f"step (within +{XC_WALL_TOL:.0%}; windows off "
          + ", ".join(f"{w * 1e3:.3f}" for w in ov["walls_off_s"])
          + ", on " + ", ".join(f"{w * 1e3:.3f}" for w in ov["walls_on_s"])
          + f"); inferred overlap {ov['inferred_overlap']}")


def crosscheck_deepseek(torch, np, card, cfg, params) -> None:
    """deepseek-v2 (4 layers): crosscheck_decode, the MoE gap attributed:
    the ``moe_experts`` scope reads every routed expert's weights where
    the ledger charges the top-k, and the walk with the active experts'
    bytes in that scope's place meets the dense step's bytes hold."""
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve import crosscheck as xc
    ecfg = EngineConfig(num_slots=SLOTS, page_size=PAGE, max_len=DS_MAX_LEN,
                        prefill_chunk=PREFILL_CHUNK, device="cuda")
    label = f"{cfg.name} ({cfg.n_layers} layers) decode"
    eng = xc_engine(np, cfg, lambda: Engine(cfg, params, ecfg), label)
    out = xc.crosscheck_decode(eng)
    xc_line(card, label, out)
    walked, experts = out["experts_walked_bytes"], out["expert_bytes"]
    if walked != experts:
        fail(f"{label}: the moe_experts scope read {walked} parameter "
             f"bytes, the routed experts hold {experts}")
    print(f"[crosscheck] {label} MoE gap: walk/ledger Q "
          f"{1 / out['weights_kv_ratio']:.4f}; moe_experts scope "
          f"{out['scopes']['moe_experts']['bytes'] / 1e9:.4f} GB of which "
          f"parameters {walked / 1e9:.4f} GB = {cfg.n_experts} experts x "
          f"{experts / cfg.n_experts / 1e6:.3f} MB over the MoE layers, "
          f"ledger's active {out['active_expert_bytes'] / 1e9:.4f} GB (top "
          f"{cfg.moe_top_k}); with the active experts in the scope's place "
          f"weights + KV {out['weights_kv_dense_bytes'] / 1e9:.4f} GB, ratio "
          f"{out['weights_kv_dense_ratio']:.4f}")
    xc_holds(label, out, flops=False)
    vmem_hold(label, eng)


def crosscheck_spec(torch, np, card, cfg, params, draft_cfg,
                    draft_params) -> None:
    """Speculative qwen3-14b (k SPEC_K, a qwen3-0.6b draft): the verify
    step's and the decode step's cross-checks; the verify step's measured
    intensity must exceed XC_VERIFY_AI times the decode step's."""
    from repro_torch.serve import EngineConfig, SpecConfig, SpecEngine
    from repro_torch.serve import crosscheck as xc
    ecfg = EngineConfig(num_slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
                        prefill_chunk=PREFILL_CHUNK, device="cuda")
    scfg = SpecConfig(k=SPEC_K, proposer="draft", draft_cfg=draft_cfg,
                      draft_params=draft_params)
    label = f"{cfg.name} + {draft_cfg.name} draft"
    eng = xc_engine(np, cfg, lambda: SpecEngine(cfg, params, ecfg, scfg),
                    label)
    ver = xc.crosscheck_verify(eng)
    dec = xc.crosscheck_decode(eng)
    xc_line(card, f"{label} verify (T {ver['n_tokens']})", ver)
    xc_line(card, f"{label} decode", dec)
    xc_holds(f"{label} verify", ver)
    xc_holds(f"{label} decode", dec)
    ai_ver = ver["hlo_flops"] / ver["hlo_bytes"]
    ai_dec = dec["hlo_flops"] / dec["hlo_bytes"]
    if not ai_ver > XC_VERIFY_AI * ai_dec:
        fail(f"{label}: verify intensity {ai_ver:.3f} not above "
             f"{XC_VERIFY_AI} x decode's {ai_dec:.3f}")
    print(f"[crosscheck] {label}: measured intensity verify {ai_ver:.3f} "
          f"FLOP/B, decode {ai_dec:.3f}: {ai_ver / ai_dec:.2f}x (must exceed "
          f"{XC_VERIFY_AI}x)")
    vmem_hold(label, eng, n_q=SPEC_K + 1)


def prefill_graph_lines(torch, np, card, cfg, params, betas, *, max_len: int,
                        new_tokens: int) -> None:
    """Prefill as captured graphs against the same bodies run eagerly: one
    engine each way serves PROMPT_LENS twice, and the second pass is timed
    (its captures fell in the first).  Streams byte-equal both passes and
    both ways, pools outside page 0 and launch counts equal; prints the
    captured prefill shapes and their capture ms, the mean prefill-chunk
    wall, TTFT mean and max, peak memory, and ``hierarchy_report``'s
    prefill row (on ``betas``, less the dispatch floor) both ways."""
    from repro_torch.core.roofline.report import (TIME_BUDGET_HEADER,
                                                  text_table,
                                                  time_budget_rows)
    from repro_torch.serve import Engine, EngineConfig, GenerateConfig
    moe = any(b.ffn == "moe" for b in cfg.block_pattern)
    ecfg = EngineConfig(num_slots=SLOTS, page_size=PAGE, max_len=max_len,
                        prefill_chunk=PREFILL_CHUNK, device="cuda")
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    gen = GenerateConfig(max_new_tokens=new_tokens)
    res = {}
    with deterministic(torch, moe):
        for graphs in (True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            engine = Engine(cfg, params, dataclasses.replace(
                ecfg, cuda_graphs=graphs))
            first, _, _ = counted_run(torch, engine, prompts, gen)
            engine.reset_phases()
            reqs, counts, _ = counted_run(torch, engine, prompts, gen)
            peak = torch.cuda.max_memory_allocated() / 1e9
            if [r.generated for r in reqs] != [r.generated for r in first]:
                fail(f"{cfg.name} {run_kind(graphs)}: the second pass's "
                     "streams differ from the first's")
            ph = engine.phases["prefill"]
            engine.measure_dispatch_overhead()
            row = time_budget_rows({"prefill": ph}, betas,
                                   dispatch_s_per_step=engine._dispatch_s)
            res[graphs] = dict(
                engine=engine, reqs=reqs, counts=counts, peak=peak,
                chunk_ms=ph.wall_s / max(ph.steps, 1) * 1e3,
                chunks=ph.steps, ttft=[r.ttft * 1e3 for r in reqs],
                table=text_table(row[:1], TIME_BUDGET_HEADER))
    g, e = res[True], res[False]
    if [r.generated for r in g["reqs"]] != [r.generated for r in e["reqs"]]:
        fail(f"{cfg.name}: prefill graphs change the streams")
    if not pools_equal_outside_trash(torch, g["engine"], e["engine"]):
        fail(f"{cfg.name}: prefill graphs change the pools outside page 0")
    if g["counts"] != e["counts"]:
        fail(f"{cfg.name}: launches graphed {g['counts']}, eager "
             f"{e['counts']}")
    shapes = sorted(g["engine"].prefill_shapes)
    names = [n for n in g["engine"]._graphs.graphs if n.startswith("prefill")]
    if not shapes or len(names) != len(shapes):
        fail(f"{cfg.name}: prefill shapes {shapes}, captured {names}")
    print(f"[graph] {cfg.name} prefill {card}: captured {len(names)} "
          f"prefill shapes {shapes} in {prefill_capture_ms(g['engine']):.1f} "
          f"ms of capture; streams, pools outside page 0 and launches equal "
          f"graphed and eager; second pass: mean prefill step graphed "
          f"{g['chunk_ms']:.3f} ms, eager {e['chunk_ms']:.3f} ms "
          f"({g['chunks']} steps each); TTFT mean graphed "
          f"{np.mean(g['ttft']):.2f} ms (max {np.max(g['ttft']):.2f}), eager "
          f"{np.mean(e['ttft']):.2f} ms (max {np.max(e['ttft']):.2f}); "
          f"peak memory graphed {g['peak']:.2f} GB, eager {e['peak']:.2f} GB")
    for graphs in (True, False):
        r = res[graphs]
        print(f"[graph] {cfg.name} prefill time budget, {run_kind(graphs)} "
              f"(dispatch floor {r['engine']._dispatch_s * 1e3:.3f} ms a "
              f"step, betas {betas.source}):")
        print(r["table"])


# --------------------------------------------------------------------------
# Recurrent and hybrid mixers: xlstm-350m and jamba-v0.1-52b at their
# published widths, each cut to one 8-layer period (xlstm: 7 mLSTM, 1
# sLSTM; jamba: 1 GQA layer, 7 mamba, 4 MoE FFNs of 16 experts top-2, 4
# dense).  One period keeps every mixer kind of each; xlstm's 24 layers
# whole took ~60 s of the script's 1200 s limit
# --------------------------------------------------------------------------

XLSTM_LAYERS = 8
JAMBA_LAYERS = 8
# jamba's attention layer: 32 query heads over 8 KV heads (G 4), hd 128
JAMBA_G = 4
# a greedy token's gap under the top logit of a forward_full over the
# same tokens: bf16 activations through 8 layers, whole-sequence cells
# and S-row GEMMs against step-by-step cells and 4-row GEMMs, as
# LOGITS_ATOL bounds qwen3-0.6b's decode logits
XL_GAP_ATOL = LOGITS_ATOL


def jamba_kernel_holds(torch, np, pa) -> None:
    """Row 1 (``paged_attention``, the GQA core) and its ring at jamba's
    attention shape, G 4, held as kernel_phase holds them at qwen3-0.6b's
    G 2 (TOL, TOL_F32_PLAIN; the ring bit-equal to the off kernel), and
    both timed with the plain version.  Launches here are not counted."""
    n, n_ring = pa.paged_attention.launches, pa.paged_attention_ring.launches
    rng = np.random.default_rng(28)
    for kind in ("ragged", "full", "trash", "soft_cap"):
        c = attention_case(torch, np, rng, torch.bfloat16, kind,
                           groups=JAMBA_G)
        args = (c["q"], c["k"], c["v"], c["bt"], c["pos"])
        kw = dict(scale=c["scale"], soft_cap=c["soft_cap"])
        hold(torch, f"paged_attention bfloat16 {kind:8s} G={JAMBA_G}",
             pa.paged_attention, pa.paged_attention_reference, args, 3, kw,
             "bfloat16")
        ring_hold(torch, f"paged_attention_ring (decode) bfloat16 "
                  f"{kind:8s} G={JAMBA_G}", pa.paged_attention_ring,
                  pa.paged_attention, pa.paged_attention_reference, args, 3,
                  kw, "bfloat16")
    c = attention_case(torch, np, rng, torch.bfloat16, "ragged",
                       groups=JAMBA_G)
    copies = [(c["q"].clone(), c["k"].clone(), c["v"].clone(), c["bt"],
               c["pos"]) for _ in range(16)]
    kw = dict(scale=c["scale"], soft_cap=0.0)
    kernel_ms = device_ms(lambda *a: pa.paged_attention(*a, **kw), copies)
    ring_ms = device_ms(lambda *a: pa.paged_attention_ring(*a, **kw), copies)
    plain_ms = device_ms(lambda *a: pa.paged_attention_reference(*a, **kw),
                         copies)
    pa.paged_attention.launches = n
    pa.paged_attention_ring.launches = n_ring
    print(f"[kernel] paged_attention bf16 at jamba's shape B={SLOTS} KV={KV} "
          f"G={JAMBA_G} hd={HD} page={PAGE} lines="
          f"{int((c['pos'].long() + 1).sum())}: kernel {kernel_ms:.4f} ms, "
          f"ring kernel {ring_ms:.4f} ms, plain {plain_ms:.4f} ms")


def greedy_gap(torch, np, cfg, params, reqs) -> float:
    """The largest gap, over every greedy token of ``reqs``, between the
    top logit of a forward_full over the request's tokens and the logit
    of the token the engine chose there (0 where they agree)."""
    from repro_torch.models.transformer import forward_full
    worst = 0.0
    with torch.no_grad():
        for r in reqs:
            seq = np.concatenate([r.prompt, r.generated[:-1]]).astype(
                np.int64)
            logits, _, _ = forward_full(params, cfg, torch.as_tensor(
                seq[None], device="cuda"))
            rows = logits[0, len(r.prompt) - 1:].float()
            chosen = torch.as_tensor(r.generated, device="cuda")
            gap = rows.max(-1).values - rows.gather(1, chosen[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
    return worst


def idle_slot_check(torch, np, cfg, params, ecfg) -> int:
    """Three requests prefilled and decoding; one left out of three decode
    steps keeps its state rows bit for bit while the others' move.
    Returns the bytes of state rows compared."""
    from repro_torch.serve import Engine, GenerateConfig
    from repro_torch.serve.kv_cache import split_leaves
    rng = np.random.default_rng(31)
    eng = Engine(cfg, params, ecfg)
    for n in (20, 33, 41):
        eng.submit(rng.integers(0, cfg.vocab_size, n), GenerateConfig(8))
    eng.step()
    running = eng._sched.decode_requests()
    if len(running) != 3:
        fail(f"{cfg.name} idle-slot check: {len(running)} decoding, want 3")
    rows = split_leaves(eng._kv.pools, eng._kv._paged)[1]
    idle, others = running[1], [running[0], running[2]]
    before = [t[:, idle.slot].clone() for t in rows]
    moved = [t[:, others[0].slot].clone() for t in rows]
    for _ in range(3):
        eng._run_decode(others)
    torch.cuda.synchronize()
    if not all(torch.equal(b, t[:, idle.slot]) for b, t in zip(before, rows)):
        fail(f"{cfg.name}: an idle slot's state rows changed in a decode "
             "step that left it out")
    if all(torch.equal(m, t[:, others[0].slot]) for m, t in zip(moved, rows)):
        fail(f"{cfg.name}: a decoding slot's state rows did not move")
    eng.run()
    return sum(b.numel() * b.element_size() for b in before)


def recurrent_phase(torch, np, card, cfg, params, roof) -> dict:
    """A recurrent or hybrid model through the engine, as engine_phase
    serves qwen3-0.6b: PROMPT_LENS, NEW_TOKENS new, SLOTS slots, chunk
    PREFILL_CHUNK.  The measured run replays captured graphs; every
    request must finish; ``paged_attention`` must launch once per
    attention layer and decode step (0 times for xlstm), the rings never.
    Then the same prompts with pipeline off / double, graphed and eager
    (:func:`pipeline_runs`: streams byte-equal), a slot left idle keeps
    its state rows bit for bit (:func:`idle_slot_check`), and for a model
    without MoE every greedy token sits within XL_GAP_ATOL of the top
    logit of a forward_full over its tokens.  Prints the mean step both
    ways, kernels a step, the ledger's Q split into weights / state / KV,
    the decode floor share at the measured roofs and peak memory, beside
    the card; returns the numbers."""
    from repro_torch.serve import Engine, EngineConfig, GenerateConfig
    from repro_torch.serve.scheduler import state_bytes
    moe = any(b.ffn == "moe" for b in cfg.block_pattern)
    n_attn = sum(reps for unit, reps in cfg.segments() for b in unit
                 if b.mixer == "attn")
    ecfg = EngineConfig(num_slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
                        prefill_chunk=PREFILL_CHUNK, device="cuda")
    rng = np.random.default_rng(1)
    gen = GenerateConfig(max_new_tokens=NEW_TOKENS)
    V = cfg.vocab_size

    def want_off(e):
        return {"paged_attention": e.decode_steps * n_attn}

    with deterministic(torch, moe):
        warm = Engine(cfg, params, ecfg)
        warm.submit(rng.integers(0, V, 70), GenerateConfig(4))
        warm.run()
        del warm
        prompts = [rng.integers(0, V, n) for n in PROMPT_LENS]
        engine = Engine(cfg, params, ecfg)
        reqs, got, wall = counted_run(torch, engine, prompts, gen)
    want = want_launches(want_off(engine), "off")
    if got != want:
        fail(f"{cfg.name}: kernel launches {got}, want {want}")
    for r in reqs:
        if r.finish_reason != "length" or len(r.generated) != NEW_TOKENS:
            fail(f"{cfg.name} request {r.request_id} ended "
                 f"{r.finish_reason!r} with {len(r.generated)} tokens")
        if not all(0 <= t < V for t in r.generated):
            fail(f"{cfg.name} request {r.request_id}: tokens outside the "
                 "vocab")
    if not engine.graphs or "decode" not in engine._graphs.graphs:
        fail(f"{cfg.name}: the engine did not capture its decode step")
    steps = engine.decode_steps
    dec = engine.phases["decode"]
    dec_ms = dec.wall_s / max(dec.steps, 1) * 1e3
    n_tok = sum(len(r.generated) for r in reqs)
    agg = engine.aggregate_ledger()
    kernels = graph_kernels(torch, cfg.name, engine._graphs, "decode",
                            dict.fromkeys(CORE_KERNELS["paged_attention"],
                                          n_attn) if n_attn else {})
    state_q = agg.decode_tokens * 2 * state_bytes(cfg) / steps
    kv_q = agg.decode_kv_bytes / steps - state_q  # the ledger's KV + state
    q_step = agg.decode_bytes / steps
    w_step = agg.decode_flops / steps
    pi, beta = roof.flops_for(cfg.dtype), roof.level_betas().hbm
    floor_ms = max(w_step / pi, q_step / beta) * 1e3
    gap = None if moe else greedy_gap(torch, np, cfg, params, reqs)
    if gap is not None and gap > XL_GAP_ATOL:
        fail(f"{cfg.name}: a greedy token sits {gap} under the top logit "
             f"of a forward_full over its tokens (atol {XL_GAP_ATOL})")
    rings, step_runs = pipeline_runs(
        torch, card, cfg.name, cfg,
        lambda pl, g: Engine(cfg, params, dataclasses.replace(
            ecfg, pipeline=pl, cuda_graphs=g)), prompts, gen, want_off)
    if rings.get("paged_attention_ring", 0) != steps * n_attn:
        fail(f"{cfg.name}: ring launches {rings}, want {steps * n_attn}")
    with deterministic(torch, moe):
        idle_bytes = idle_slot_check(torch, np, cfg, params, ecfg)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eager_ms = [d["decode"] for d in step_runs[False]]
    graphed_ms = [d["decode"] for d in step_runs[True]]
    print(f"[recurrent] {cfg.name} {card}: {len(reqs)} requests (prompts "
          f"{list(PROMPT_LENS)}, {NEW_TOKENS} new tokens, {SLOTS} slots, "
          f"prefill chunk {PREFILL_CHUNK}) all finished; {steps} decode "
          f"steps; paged_attention launches {got['paged_attention']} = "
          f"steps x {n_attn} attention layer(s), rings {rings} in the "
          f"double run; {n_tok / wall:.2f} tok/s graphed; mean decode step "
          f"graphed {dec_ms:.3f} ms (pipeline runs "
          f"{', '.join(f'{x:.3f}' for x in graphed_ms)}), eager "
          f"{', '.join(f'{x:.3f}' for x in eager_ms)} ms; "
          f"{kernels:.0f} kernels a graphed step; peak memory "
          f"{peak_gb:.2f} GB")
    print(f"[recurrent] {cfg.name} {card} ledger per decode step (mean of "
          f"{steps}): Q {q_step / 1e9:.4f} GB = weights "
          f"{(q_step - state_q - kv_q) / 1e9:.4f} + state "
          f"{state_q / 1e9:.4f} ({state_q / q_step:.1%}; "
          f"{state_bytes(cfg) / 1e6:.3f} MB a slot, read and written) + KV "
          f"{kv_q / 1e9:.4f}; W {w_step / 1e9:.4f} GFLOP; decode floor "
          f"max(W / pi, Q / beta) {floor_ms:.4f} ms at pi "
          f"{pi / 1e12:.1f} TFLOP/s, beta {beta / 1e12:.3f} TB/s: share of "
          f"the graphed step {floor_ms / dec_ms:.4f}")
    print(f"[recurrent] {cfg.name} {card}: a slot left out of 3 decode "
          f"steps kept its {idle_bytes / 1e6:.3f} MB of state rows bit for "
          "bit"
          + ("" if gap is None else f"; every greedy token within "
             f"{gap:.4f} of the top logit of a forward_full over its tokens "
             f"(atol {XL_GAP_ATOL})"))
    return dict(steps=steps, launches=got["paged_attention"],
                graphed_ms=dec_ms, eager_ms=eager_ms, kernels=kernels,
                q_step=q_step, state_q=state_q, floor_ms=floor_ms,
                peak_gb=peak_gb, gap=gap)


def crosscheck_recurrent(torch, np, card, cfg, params, roof) -> None:
    """``crosscheck_decode`` on a recurrent or hybrid model, 4 slots
    mid-decode: the walk's split with the state rows as their own
    category, the W ratio reported, and the bytes hold (weights + KV +
    state = the ledger's Q plus terms counted from the trees, the state
    rows' freeze read, re-reads and idle slots among them: residual within
    1e-9 of Q); ``step_cost_analysis`` of the graphed step against its
    wall (floor share at most 1)."""
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve import crosscheck as xc
    ecfg = EngineConfig(num_slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
                        prefill_chunk=PREFILL_CHUNK, device="cuda")
    label = f"{cfg.name} decode"
    moe = any(b.ffn == "moe" for b in cfg.block_pattern)
    with deterministic(torch, moe):
        eng = xc_engine(np, cfg, lambda: Engine(cfg, params, ecfg), label)
        out = xc.crosscheck_decode(eng)
        xc_line(card, label, out)
        xc_holds(label, out, flops=False)
        print(f"[crosscheck] {label} state rows {card}: walked "
              f"{out['state_bytes'] / 1e6:.3f} MB = the ledger's read and "
              f"write 2 x {len(out['contexts'])} x "
              f"{out['state_row_bytes'] / 1e6:.3f} MB + the freeze's read "
              f"{out['state_freeze_read_bytes'] / 1e6:.3f} MB + the cells' "
              f"re-reads {out['state_reread_bytes'] / 1e6:.3f} MB + idle "
              f"slots {out['state_idle_bytes'] / 1e6:.3f} MB; leaves the "
              f"ledger's parameter count omits "
              f"{out['omitted_bytes'] / 1e6:.3f} MB; "
              f"activations {out['activation_bytes'] / 1e9:.4f} GB; W "
              f"ratio {out['flops_ratio']:.4f} (reported)")
        step = xc.step_cost_analysis(eng)
        eng.reset_phases()
        eng.run()
    ph = eng.phases["decode"]
    wall = ph.wall_s / max(ph.steps, 1)
    pi, beta = roof.flops_for(cfg.dtype), roof.level_betas().hbm
    floor = max(step["flops"] / pi, step["bytes"] / beta)
    if floor > wall:
        fail(f"{label}: the graphed step's wall {wall * 1e3:.4f} ms is "
             f"under its walked floor {floor * 1e3:.4f} ms")
    print(f"[crosscheck] {label} step_cost_analysis {card}: decode + sample "
          f"W {step['flops'] / 1e9:.4f} GFLOP, Q {step['bytes'] / 1e9:.4f} "
          f"GB; floor {floor * 1e3:.4f} ms; graphed step wall "
          f"{wall * 1e3:.4f} ms over {ph.steps} steps, floor share "
          f"{floor / wall:.4f} (must be <= 1)")


# --------------------------------------------------------------------------
# The static whole-batch path (StaticEngine over dense caches): whisper-small
# whole, llama-3.2-vision-90b at its published widths cut to VISION_LAYERS,
# and qwen3-0.6b static against continuous
# --------------------------------------------------------------------------

VISION_LAYERS = 10
# (rows, prompt tokens, new tokens) of each static run
STATIC_RUNS = {"whisper-small": (4, 24, 32),
               "llama-3.2-vision-90b": (2, 24, 16)}
STATIC_QWEN = (4, 32, 16)


def gqa_library(torch, bt, pos, page: int, scale: float, T: int = 0):
    """One PyTorch library call's worth of GQA paged attention at these
    tables: gather the pages, then ``scaled_dot_product_attention`` with
    the mask k_pos <= pos (+ t).  ``T`` 0 takes decode queries (B, KV, G,
    hd), else verify queries (B, T, KV, G, hd).  Returns fn(q, k, v, bt,
    pos)."""
    import torch.nn.functional as F
    B, S, t = bt.shape[0], bt.shape[1] * page, max(T, 1)
    q_pos = pos.long()[:, None] + torch.arange(t, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, None, :]
            <= q_pos[:, :, None])[:, None]                   # (B,1,t,S)

    def library(q, k, v, bt, pos):
        kv, hd = k.shape[2], k.shape[3]
        kk = k[bt.long()].reshape(B, S, kv, hd).transpose(1, 2)
        vv = v[bt.long()].reshape(B, S, kv, hd).transpose(1, 2)
        g = q.shape[2] if T == 0 else q.shape[3]
        qq = (q.reshape(B, kv * g, 1, hd) if T == 0 else
              q.permute(0, 2, 3, 1, 4).reshape(B, kv * g, T, hd))
        o = F.scaled_dot_product_attention(
            qq, kk.repeat_interleave(g, 1), vv.repeat_interleave(g, 1),
            attn_mask=mask, scale=scale)
        return (o.reshape(B, kv, g, hd) if T == 0 else
                o.reshape(B, kv, g, T, hd).permute(0, 3, 1, 2, 4))
    return library


def mla_library(torch, bt, pos, page: int, scale: float):
    """The MLA decode counterpart of :func:`gqa_library`: gather the latent
    and rope lines, then SDPA with k = [c | k_rope] and v = c shared by
    every head.  Returns fn(q_lat, q_rope, c_pool, r_pool, bt, pos)."""
    import torch.nn.functional as F
    B, S = bt.shape[0], bt.shape[1] * page
    mask = (torch.arange(S, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]

    def library(ql, qr, cpool, rpool, bt, pos):
        H, r, dr = ql.shape[1], cpool.shape[-1], rpool.shape[-1]
        cc = cpool[bt.long()].reshape(B, 1, S, r)
        kk = torch.cat([cc, rpool[bt.long()].reshape(B, 1, S, dr)], -1)
        qq = torch.cat([ql, qr], -1)[:, :, None, :]
        return F.scaled_dot_product_attention(
            qq, kk.expand(B, H, S, r + dr), cc.expand(B, H, S, r),
            attn_mask=mask, scale=scale)[:, :, 0]
    return library


def library_ms(torch, label: str, library, plain, copies, kw) -> float:
    """The library call held against the plain version on the first
    inputs (bf16 tolerance), then timed over the copies."""
    err = float((library(*copies[0]).float()
                 - plain(*copies[0], **kw).float()).abs().max())
    if err > TOL["bfloat16"]["atol"]:
        fail(f"{label}: library yardstick disagrees with the plain version:"
             f" {err}")
    return device_ms(library, copies)


def static_kernel_holds(torch, np, pa, whisper, vision) -> None:
    """Row 1 (``paged_attention``) at the static engine's shapes: a dense
    cache (B, Smax_r, KV, hd) viewed as a pool of 16-line pages under the
    identity table (``models.attention.dense_attention``); whisper's self
    attention at its last decode step, whisper's cross attention over its
    1500 frames (1504 lines, pos 1499) and vision's over its 1600 image
    tokens (pos 1599).  Held as kernel_phase holds (TOL, TOL_F32_PLAIN)
    and timed with the plain version beside the bound.  Launches here are
    not counted."""
    from repro_torch.models.attention import dense_lines, identity_tables
    n = pa.paged_attention.launches
    rng = np.random.default_rng(29)
    rows, prompt, new = STATIC_RUNS[whisper.name]
    vrows = STATIC_RUNS[vision.name][0]
    cases = (("whisper-small self", whisper, rows, prompt + new,
              prompt + new - 2),
             ("whisper-small cross", whisper, rows, whisper.n_audio_frames,
              whisper.n_audio_frames - 1),
             ("llama-3.2-vision cross", vision, vrows, vision.n_image_tokens,
              vision.n_image_tokens - 1))
    for label, cfg, B, n_lines, last in cases:
        KV_, hd = cfg.n_kv_heads, cfg.hd
        G_ = cfg.n_heads // KV_
        S = dense_lines(n_lines)

        def normal(*shape):
            return torch.from_numpy(rng.standard_normal(
                shape, dtype="float32")).to("cuda", torch.bfloat16)
        q = normal(B, KV_, G_, hd)
        k = normal(B * S // PAGE, PAGE, KV_, hd)
        v = normal(B * S // PAGE, PAGE, KV_, hd)
        bt = identity_tables(B, S, "cuda")
        pos = torch.full((B,), last, dtype=torch.int32, device="cuda")
        kw = dict(scale=hd ** -0.5, soft_cap=0.0)
        hold(torch, f"paged_attention bfloat16 {label}: B={B} KV={KV_} "
             f"G={G_} hd={hd} lines {S} (pos {last})", pa.paged_attention,
             pa.paged_attention_reference, (q, k, v, bt, pos), 3, kw,
             "bfloat16", tag="static")
        n_copies = min(64, max(2, int(4e8 // (4 * k.numel()))))
        copies = [(q.clone(), k.clone(), v.clone(), bt, pos)
                  for _ in range(n_copies)]
        kernel_ms = device_ms(lambda *a: pa.paged_attention(*a, **kw),
                              copies)
        plain_ms = device_ms(
            lambda *a: pa.paged_attention_reference(*a, **kw), copies)
        lib_ms = library_ms(
            torch, f"[static] {label}",
            gqa_library(torch, bt, pos, PAGE, kw["scale"]),
            pa.paged_attention_reference, copies, kw)
        bound_ms, bound_by = bound_of(*paged_bound(
            pos, 1, S, KV_ * hd * 2 * 2, KV_ * G_ * 4 * hd,
            2 * q.numel() * 2, 2))
        print(f"[static] paged_attention {label}: kernel {kernel_ms:.4f} ms,"
              f" plain {plain_ms:.4f} ms, library (gather + SDPA) "
              f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    pa.paged_attention.launches = n


def set_gates(torch, params, seed: int) -> int:
    """Every cross-attention gate (init 0, so the cross path would move no
    logit) set to a value drawn uniformly from [0.5, 1.5) by a generator
    seeded ``seed``; returns how many."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 0
    for seg in params["segments"]:
        for blk in seg.values():
            for name in ("mixer", "cross"):
                if name in blk and "gate" in blk[name]:
                    t = blk[name]["gate"]
                    t.copy_(torch.rand(t.shape, generator=g, device="cuda")
                            + 0.5)
                    n += t.numel()
    return n


def cross_source(torch, cfg, rows: int, seed: int) -> dict:
    """The stub encoder frames or image patch embeddings of ``rows`` rows,
    drawn from a generator seeded ``seed``, as generate() takes them."""
    from repro_torch.models.params import torch_dtype
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = cfg.n_audio_frames if cfg.is_encoder_decoder else cfg.n_image_tokens
    x = torch.randn((rows, n, cfg.d_model), generator=g,
                    device="cuda").to(torch_dtype(cfg.dtype))
    return {"enc_embeds" if cfg.is_encoder_decoder else "img_embeds": x}


def static_phase(torch, np, card, pa, cfg) -> int:
    """``cfg`` (an encoder-decoder or vision model) through the static
    engine: STATIC_RUNS[cfg.name] rows, prompt and new tokens, greedy,
    cross gates set (:func:`set_gates`), seeded sources.  The graphed run
    (counts zeroed before it and read after) must launch
    ``paged_attention`` once per self and cross attention layer and
    decode step, and a profiler pass over replays of its captured decode
    step must see the GQA core's kernel as often; the eager run must give
    the same tokens byte for byte; every greedy token must lie within
    LOGITS_ATOL of the top logit of a forward_full over its tokens with
    the same source; another source must move the first logits by more
    than LOGITS_ATOL.  Prints the mean decode step graphed and eager,
    kernels a graphed step, the prefill (row by row: the encoder and the
    decoder) and peak memory; frees the weights.  Returns the graphed
    run's launches."""
    from repro_torch.models import prefill
    from repro_torch.models.transformer import _run_encoder, forward_full
    from repro_torch.obs.clock import now
    from repro_torch.serve import GenerateConfig, StaticEngine
    rows, prompt, new = STATIC_RUNS[cfg.name]
    params = make_params(torch, cfg)
    n_gates = set_gates(torch, params, 9)
    src = cross_source(torch, cfg, rows, 2)
    other = cross_source(torch, cfg, rows, 3)
    rng = np.random.default_rng(29)
    prompts = rng.integers(0, cfg.vocab_size, (rows, prompt))
    gen = GenerateConfig(max_new_tokens=new)
    per_step = sum(reps * (2 if b.mixer == "attn+cross" else 1)
                   for unit, reps in cfg.segments() for b in unit)
    with torch.no_grad():
        StaticEngine(cfg, params).generate(prompts, GenerateConfig(2), **src)
        torch.cuda.synchronize()
        pa.paged_attention.launches = 0             # counts start here
        graphed = StaticEngine(cfg, params)
        out = graphed.generate(prompts, gen, **src)
        torch.cuda.synchronize()
        launches = pa.paged_attention.launches      # counts read here
        eager = StaticEngine(cfg, params, cuda_graphs=False)
        out_e = eager.generate(prompts, gen, **src)
        eager_launches = pa.paged_attention.launches - launches
        toks = out["tokens"]
        if not np.array_equal(toks, out_e["tokens"]):
            fail(f"{cfg.name}: the static engine's graphed and eager greedy "
                 "streams differ")
        steps = graphed.decode_steps
        kernels = graph_kernels(torch, f"{cfg.name} static", graphed._graphs,
                                "decode", dict.fromkeys(
                                    CORE_KERNELS["paged_attention"],
                                    per_step))
        if steps != new - 1 or launches != steps * per_step or (
                eager_launches != launches):
            fail(f"{cfg.name}: paged_attention launched {launches} "
                 f"(eager {eager_launches}) in {steps} static decode steps,"
                 f" want steps x {per_step}")
        if not all(0 <= t < cfg.vocab_size for t in toks.reshape(-1)):
            fail(f"{cfg.name}: static tokens outside the vocab")
        logits, _, _ = forward_full(params, cfg, torch.as_tensor(
            toks[:, :-1], device="cuda"), **src)
        rows_l = logits[:, prompt - 1:].float()
        chosen = torch.as_tensor(toks[:, prompt:], device="cuda")
        gap = float((rows_l.max(-1).values
                     - rows_l.gather(2, chosen[..., None])[..., 0]).max())
        if not np.isfinite(gap) or gap > LOGITS_ATOL:
            fail(f"{cfg.name}: a static greedy token sits {gap} under the "
                 f"top logit of a forward_full over its tokens (atol "
                 f"{LOGITS_ATOL})")
        first, _ = prefill(params, cfg, torch.as_tensor(prompts,
                                                        device="cuda"), **src)
        moved, _ = prefill(params, cfg, torch.as_tensor(prompts,
                                                        device="cuda"),
                           **other)
        move = float((first.float() - moved.float()).abs().max())
        if not move > LOGITS_ATOL:
            fail(f"{cfg.name}: another cross source moves the first logits "
                 f"by {move} <= {LOGITS_ATOL}: the cross path is dead")
        enc_ms = None
        if cfg.is_encoder_decoder:
            torch.cuda.synchronize()
            t0 = now()
            _run_encoder(params, cfg, src["enc_embeds"])
            torch.cuda.synchronize()
            enc_ms = (now() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    g_ms = float(np.mean(graphed.decode_s[1:])) * 1e3
    e_ms = float(np.mean(eager.decode_s)) * 1e3
    print(f"[static] {cfg.name} {card}: {rows} rows x {prompt}-token "
          f"prompts, {new} new tokens, {n_gates} cross gates in [0.5, 1.5),"
          f" seeded sources: greedy streams byte-equal graphed and eager; "
          f"paged_attention launches {launches} = {steps} decode steps x "
          f"{per_step} (self + cross); every greedy token within {gap:.4f} "
          f"of the top logit of a forward_full over its tokens (atol "
          f"{LOGITS_ATOL}); another source moves the first logits by "
          f"{move:.4f}")
    print(f"[static] {cfg.name} {card}: mean decode step graphed "
          f"{g_ms:.3f} ms (capture {graphed.graph_capture_s * 1e3:.1f} ms in"
          f" the first), eager {e_ms:.3f} ms ({rows * 1e3 / g_ms:.1f} and "
          f"{rows * 1e3 / e_ms:.1f} tok/s), {kernels:.0f} kernels a graphed "
          f"step; prefill {graphed.prefill_s * 1e3:.2f} ms "
          f"graphed run, {eager.prefill_s * 1e3:.2f} ms eager run"
          + ("" if enc_ms is None else f" (encoder alone {enc_ms:.2f} ms)")
          + f"; peak memory {peak_gb:.2f} GB")
    del params, graphed, eager
    torch.cuda.empty_cache()
    print(f"[static] {cfg.name} weights freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated after")
    return launches


def static_vs_continuous(torch, np, card, cfg) -> None:
    """qwen3-0.6b (no MoE, no MLA): the static engine's greedy and seeded
    sampled streams equal the continuous engine's ``generate`` byte for
    byte on the same prompts (STATIC_QWEN rows, prompt and new tokens),
    row b of both drawing from seed s + b.  Reports first how far one
    whole-batch prefill lies from the same rows prefilled one by one."""
    from repro_torch.models import prefill
    from repro_torch.serve import (Engine, EngineConfig, GenerateConfig,
                                   StaticEngine)
    rows, prompt, new = STATIC_QWEN
    params = make_params(torch, cfg)
    prompts = np.random.default_rng(30).integers(0, cfg.vocab_size,
                                                 (rows, prompt))
    # why the static engine prefills row by row (reported, not held)
    toks = torch.as_tensor(prompts, device="cuda")
    with torch.no_grad():
        whole, states = prefill(params, cfg, toks)
        per_row = [prefill(params, cfg, toks[b:b + 1]) for b in range(rows)]
    d_logits = float((whole.float() - torch.cat(
        [r[0] for r in per_row]).float()).abs().max())
    d_k = float((states[0]["b0"]["k"].float() - torch.cat(
        [r[1][0]["b0"]["k"] for r in per_row], dim=1).float()).abs().max())
    print(f"[static] {cfg.name} {card}: one ({rows}, {prompt}) prefill "
          f"against {rows} (1, {prompt}) prefills: last logits differ by "
          f"{d_logits:.4f}, K lines by {d_k:.4f} (reported: the GEMMs' bits "
          "depend on their row count, so the static engine prefills row by "
          "row, as the continuous engine does)")
    del whole, states, per_row
    eng = Engine(cfg, params, EngineConfig(device="cuda"))
    static = StaticEngine(cfg, params)
    for label, gen, seed in (
            ("greedy", GenerateConfig(max_new_tokens=new), None),
            ("sampled", GenerateConfig(max_new_tokens=new, **SAMPLED), 5)):
        with torch.no_grad():
            s_out = static.generate(prompts, gen, seed=seed)["tokens"]
        c_out = eng.generate(prompts, gen, seed=seed)["tokens"]
        if not np.array_equal(s_out, c_out):
            bad = int(np.argmax((s_out != c_out).any(1)))
            fail(f"{cfg.name} {label}: the static engine's stream differs "
                 f"from the continuous engine's (row {bad}: "
                 f"{s_out[bad, prompt:].tolist()} vs "
                 f"{c_out[bad, prompt:].tolist()})")
        print(f"[static] {cfg.name} {card}: static = continuous byte for "
              f"byte, {label} ({rows} rows x {prompt}-token prompts, {new} "
              f"new tokens{'' if seed is None else f', seeds {seed} + b'})")
    del params, eng, static
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# m. tensor-parallel serving ([tp] lines)
# --------------------------------------------------------------------------

# qwen3-14b whole at tp 2: 4 slots, page 16, 4 requests of 17-60 tokens,
# 16 new tokens each (eager steps of ~0.35 s a rank over gloo); then its
# n-gram verify (k 3); then MLA with a dense FFN at deepseek-v2-236b's
# attention widths, TP_MLA_LAYERS layers
TP = 2
TP_PROMPTS = (17, 33, 46, 60)
TP_NEW, TP_MAX_LEN, TP_SPEC_K, TP_MLA_LAYERS = 16, 128, 3, 4
# the ledger's charge of one qwen3-14b decode step at 4 slots: 80
# all-reduces x 2 x (4 x 5120 x 2 B) x 1/2 plus the untied head's
# all-gather, 4 x 151936 x 2 B x 1/2
TP_STEP_BYTES = 3_884_544
# First decode logits, tp 2 against the unsharded engine (PERF.md §6,
# tensor-parallel serving): each row-parallel edge rounds the two ranks'
# partial products to bf16 before the sum and the sum once more, where
# one card rounds the whole product once.  A bf16 rounding errs by
# 2^-8 / sqrt(12) of the value in rms; the two partials (each ~1/sqrt(2)
# of the sum) and the sum give sqrt(2) x that, ~0.41 x 2^-8 an edge, a
# random walk over qwen3-14b's 80 edges: sqrt(80) x 0.41 x 2^-8 ~ 1.4% of
# the final hidden state, ~0.013 at the largest logit (0.90 at init).
# Held at 0.03, about 2.3x that.  The same bar bounds the unsharded
# engine's top-2 margin wherever a tp-2 stream first parts from it.
TP_LOGITS_ATOL = 0.03
# the collective cross-check's bar (the reference's)
TP_ICI_RATIO = 1.15


# rows 1, 3 and 4 at the local head counts tp 2 gives them: qwen3-14b's
# 8 KV heads halved at G 5 (decode, and verify at n-gram k 3), deepseek-v2's
# 128 MLA heads halved
TP_KV, TP_VERIFY_T, TP_MLA_H = 4, TP_SPEC_K + 1, MLA_H // 2


def tp_kernel_holds(torch, np, pa) -> None:
    """Rows 1, 3 and 4 at the tp-2 local head counts (TP_KV KV heads at
    G 5, decode and verify at T TP_VERIFY_T; TP_MLA_H MLA heads), held as
    the kernel phases hold them at the main shapes (TOL, TOL_F32_PLAIN)
    and timed with the plain version beside the bound.  Launches here are
    not counted."""
    counters = (pa.paged_attention, pa.paged_attention_verify,
                pa.mla_paged_attention)
    before = [c.launches for c in counters]
    rng = np.random.default_rng(30)
    bf16 = torch.bfloat16
    shape = f"KV={TP_KV} G={V_G}"
    for kind in ("ragged", "full", "trash", "soft_cap"):
        c = attention_case(torch, np, rng, bf16, kind, groups=V_G,
                           kv=TP_KV)
        hold(torch, f"paged_attention bfloat16 {kind:8s} {shape}",
             pa.paged_attention, pa.paged_attention_reference,
             (c["q"], c["k"], c["v"], c["bt"], c["pos"]), 3,
             dict(scale=c["scale"], soft_cap=c["soft_cap"]), "bfloat16",
             tag="tp")
    for kind in ("ragged", "edges", "margin", "trash", "soft_cap"):
        c = gqa_verify_case(torch, np, rng, bf16, kind, kv=TP_KV,
                            T=TP_VERIFY_T)
        hold(torch, f"paged_attention_verify bfloat16 {kind:8s} {shape} "
             f"T={TP_VERIFY_T}", pa.paged_attention_verify,
             pa.paged_attention_verify_reference, c["args"], 3, c["kw"],
             "bfloat16", tag="tp")
    for kind in ("ragged", "edges", "trash"):
        c = mla_case(torch, np, rng, bf16, kind, heads=TP_MLA_H)
        hold(torch, f"mla_paged_attention bfloat16 {kind:6s} H={TP_MLA_H}",
             pa.mla_paged_attention, pa.mla_paged_attention_reference,
             c["args"], 4, dict(scale=c["scale"]), "bfloat16", tag="tp")
    # times on ragged contexts, 16 copies rotating
    c = attention_case(torch, np, rng, bf16, "ragged", groups=V_G, kv=TP_KV)
    q, pos = c["q"], c["pos"]
    row1 = ([(q.clone(), c["k"].clone(), c["v"].clone(), c["bt"], pos)
             for _ in range(16)], dict(scale=c["scale"], soft_cap=0.0),
            paged_bound(pos, 1, N_BLOCKS * PAGE, TP_KV * HD * 2 * 2,
                        TP_KV * V_G * 4 * HD, 2 * q.numel() * 2, 2))
    c = gqa_verify_case(torch, np, rng, bf16, "ragged", kv=TP_KV,
                        T=TP_VERIFY_T)
    q, *rest = c["args"]
    row3 = ([(q.clone(), rest[0].clone(), rest[1].clone(), *rest[2:])
             for _ in range(16)], c["kw"],
            paged_bound(rest[3], TP_VERIFY_T, V_BLOCKS * PAGE,
                        TP_KV * HD * 2 * 2, TP_KV * V_G * 4 * HD,
                        2 * q.numel() * 2, 2))
    c = mla_case(torch, np, rng, bf16, "ragged", heads=TP_MLA_H)
    q_lat, q_rope, *rest = c["args"]
    row4 = ([(q_lat.clone(), q_rope.clone(), rest[0].clone(),
              rest[1].clone(), *rest[2:]) for _ in range(16)],
            dict(scale=c["scale"]),
            mla_bound(q_lat, q_rope, rest[3], 1, MLA_BLOCKS * PAGE))
    libraries = (
        gqa_library(torch, row1[0][0][3], row1[0][0][4], PAGE,
                    row1[1]["scale"]),
        gqa_library(torch, row3[0][0][3], row3[0][0][4], PAGE,
                    row3[1]["scale"], T=TP_VERIFY_T),
        mla_library(torch, row4[0][0][4], row4[0][0][5], PAGE,
                    row4[1]["scale"]))
    for (kernel, plain), (copies, kw, bound), library in zip(
            ((pa.paged_attention, pa.paged_attention_reference),
             (pa.paged_attention_verify, pa.paged_attention_verify_reference),
             (pa.mla_paged_attention, pa.mla_paged_attention_reference)),
            (row1, row3, row4), libraries):
        kernel_ms = device_ms(lambda *a: kernel(*a, **kw), copies)
        plain_ms = device_ms(lambda *a: plain(*a, **kw), copies)
        lib_ms = library_ms(torch, f"[tp] {kernel.__name__}", library,
                            plain, copies, kw)
        bound_ms, bound_by = bound_of(*bound)
        print(f"[tp] {kernel.__name__} bf16 at its tp-2 local shape "
              f"(ragged): kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, library (gather + SDPA) {lib_ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by})")
    for c, n in zip(counters, before):
        c.launches = n


def tp_mla_config(get_config):
    """deepseek-v2-236b's attention widths with a dense FFN (d_ff 12288,
    its dense prologue's) in every block, TP_MLA_LAYERS deep: the card's
    counterpart of the reference tests' ``mla-dense-smoke``."""
    from repro_torch.models import BlockDef
    return dataclasses.replace(
        get_config("deepseek-v2-236b"), name="deepseek-v2-mla-dense",
        block_pattern=(BlockDef("mla", "dense"),), n_layers=TP_MLA_LAYERS,
        n_experts=0, moe_top_k=0, moe_d_ff=0, n_shared_experts=0,
        moe_first_dense=0)


def tp_configs():
    from repro_torch.configs import get_config
    return {"qwen3-14b": get_config("qwen3-14b"),
            "mla-dense": tp_mla_config(get_config)}


def tp_prompts(vocab: int):
    import numpy as np
    rng = np.random.default_rng(40)
    return [rng.integers(0, vocab, n) for n in TP_PROMPTS]


def tp_job(torch, eng, prompts, gen, spec: bool) -> dict:
    """Serve ``prompts`` on one rank's sharded engine, row 1 / 3 / 4's
    launches zeroed just before and read just after; the first decode
    step's logits kept; then the collective walk and the timed edges of
    one more step (outside the counted run)."""
    from repro_torch.core.roofline.op_collectives import CollectiveWalk
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.obs.clock import now
    from repro_torch.parallel.mesh import use_mesh
    from repro_torch.serve.crosscheck import crosscheck_collectives
    first = {}
    body = eng._verify_body if spec else eng._decode_logits
    name = "_verify_body" if spec else "_decode_logits"

    def keep():
        out = body()
        if "logits" not in first:
            rows = [r.slot for r in eng._sched.decode_requests()]
            first["logits"] = out[rows].float().cpu().numpy()
        return out
    setattr(eng, name, keep)
    counters = (pa.paged_attention, pa.paged_attention_verify,
                pa.mla_paged_attention)
    reqs = [eng.submit(p, gen) for p in prompts]
    for c in counters:
        c.launches = 0                            # counts start here
    torch.cuda.synchronize()
    t0 = now()
    eng.run()
    torch.cuda.synchronize()
    wall = now() - t0
    launches = {c.__name__: c.launches for c in counters}  # read here
    delattr(eng, name)                            # the class's own again
    ph = eng.phases["verify" if spec else "decode"]
    out = dict(
        tokens=[[int(t) for t in r.generated] for r in reqs],
        launches=launches, wall=wall, logits=first.get("logits"),
        steps=ph.steps, step_ms=ph.wall_s / max(ph.steps, 1) * 1e3,
        ici=[r.ledger.decode_ici_bytes for r in reqs],
        passes=[r.ledger.weight_passes for r in reqs],
        step_bytes=eng._step_collective_bytes(
            eng._graph_tokens() if spec else 1),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not spec:
        out["cc"] = crosscheck_collectives(eng)
        timer = CollectiveWalk(timed=True)
        with use_mesh(eng.mesh), torch.no_grad():
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            with timer:
                eng._decode_body()
            e.record()
            out["edge_ms"] = timer.edge_ms()
            out["timed_step_ms"] = s.elapsed_time(e)
        out["n_edges"] = len(timer.pairs)
    return out


def tp_rank(rank: int, world: int) -> list:
    """One rank of the [tp] phase: gloo over CUDA tensors, eager.  Draws
    its shards of the generator-seeded weights, serves qwen3-14b, its
    n-gram verify and the MLA-dense model; returns every rank's results
    (rank 0's return is what the parent holds)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import init_params
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.mesh import (axis_group, make_host_mesh,
                                           use_mesh)
    from repro_torch.serve import (EngineConfig, GenerateConfig,
                                   ShardedEngine, ShardedSpecEngine,
                                   SpecConfig, param_pspecs)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(1, world)
    with use_mesh(mesh):
        staged = coll.staged_p2p(axis_group("model"),
                                 torch.empty(0, device=dev))
    res = {"p2p_staged": staged, "backend": mesh.backend}
    ecfg = EngineConfig(num_slots=SLOTS, page_size=PAGE, max_len=TP_MAX_LEN,
                        device=dev)
    gen = GenerateConfig(max_new_tokens=TP_NEW)
    for key, cfg in tp_configs().items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev, specs=param_pspecs(cfg, mesh), mesh=mesh)
        res[f"{key} params_gb"] = sum(
            t.numel() * t.element_size() for t in _leaves(params)) / 1e9
        prompts = tp_prompts(cfg.vocab_size)
        eng = ShardedEngine(cfg, params, ecfg, mesh_shape=(1, world),
                            mesh=mesh)
        res[key] = tp_job(torch, eng, prompts, gen, False)
        del eng
        gc.collect()
        if key == "qwen3-14b":
            eng = ShardedSpecEngine(
                cfg, params, ecfg, SpecConfig(k=TP_SPEC_K, proposer="ngram"),
                mesh_shape=(1, world), mesh=mesh)
            res[f"{key} ngram"] = tp_job(torch, eng, prompts, gen, True)
            del eng
        del params
        gc.collect()
    every = [None] * world
    dist.all_gather_object(every, res)
    return every


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def nccl_world_one(rank: int, world: int) -> dict:
    """The collective edges inside a captured CUDA graph on NCCL with a
    world of one: a row-parallel product with ``row_parallel_psum`` and a
    head with ``all_gather_cols`` (a group of one still issues both), the
    capture walked for the ``c10d`` operators it dispatched, replayed on
    new inputs, equal to eager bit for bit."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.roofline.op_collectives import CollectiveWalk
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.mesh import Mesh, use_mesh
    mesh = Mesh(("data", "model"), (1, 1), 0, {"model": dist.group.WORLD},
                dist.get_backend())
    g = torch.Generator(device="cuda").manual_seed(1)
    h = torch.randn((4, 1, 2560), generator=g, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn((2560, 5120), generator=g, device="cuda") / 50).to(
        torch.bfloat16)
    head = (torch.randn((5120, 4096), generator=g, device="cuda") / 70).to(
        torch.bfloat16)

    def body():
        y = coll.row_parallel_psum(h @ w, "model")
        return coll.all_gather_cols(y @ head, "model")

    with use_mesh(mesh), torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph), CollectiveWalk() as walk:
            out = body()
        h.copy_(torch.randn(h.shape, generator=g, device="cuda").to(
            torch.bfloat16))
        graph.replay()
        want = body()
        torch.cuda.synchronize()
        return {"equal": bool(torch.equal(out, want)),
                "captured": sorted(op.kind for op in walk.ops),
                "shape": tuple(out.shape), "backend": dist.get_backend(),
                "nccl": ".".join(map(str, torch.cuda.nccl.version()))}


def tp_reference(torch, np, card, cfg) -> dict:
    """The unsharded engine on the same generator-seeded weights, eager,
    in this process: greedy streams, each token's top-2 margin, the first
    decode step's logits and the mean decode step; its weights are freed
    before returning."""
    from repro_torch.serve import EngineConfig, GenerateConfig
    params = make_params(torch, cfg)
    eng = margin_engine(cfg, params, EngineConfig(
        num_slots=SLOTS, page_size=PAGE, max_len=TP_MAX_LEN, device="cuda",
        cuda_graphs=False))
    first = {}
    body = eng._decode_logits

    def keep():
        out = body()
        if "logits" not in first:
            rows = [r.slot for r in eng._sched.decode_requests()]
            first["logits"] = out[rows].float().cpu().numpy()
        return out
    eng._decode_logits = keep
    reqs, launches, wall = counted_run(
        torch, eng, tp_prompts(cfg.vocab_size),
        GenerateConfig(max_new_tokens=TP_NEW))
    ph = eng.phases["decode"]
    out = dict(tokens=[[int(t) for t in r.generated] for r in reqs],
               margins=dict(eng.margins), logits=first["logits"],
               step_ms=ph.wall_s / max(ph.steps, 1) * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del eng._decode_logits, eng, params, reqs, body
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_streams(label: str, got, ref) -> str:
    """Streams equal to the unsharded engine's, or parted first where its
    top-2 margin was under TP_LOGITS_ATOL; says where, and what share of
    the unsharded tokens had a margin under that bar."""
    margins = list(ref["margins"].values())
    under = (f"{sum(m < TP_LOGITS_ATOL for m in margins)} of "
             f"{len(margins)} unsharded tokens have a top-2 margin under "
             f"{TP_LOGITS_ATOL}")
    parted = []
    for i, (a, b) in enumerate(zip(got, ref["tokens"])):
        if a == b:
            continue
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        m = ref["margins"].get((i, j), float("inf"))
        if m >= TP_LOGITS_ATOL:
            fail(f"{label}: request {i} parts from the unsharded stream at "
                 f"token {j} where its top-2 margin is {m:.4f} >= "
                 f"{TP_LOGITS_ATOL}")
        parted.append(f"request {i} at token {j} (margin {m:.4f})")
    return ("streams equal to the unsharded engine's" if not parted else
            "streams parted under the top-2 margin rule: "
            + ", ".join(parted)) + f" ({under})"


def tp_phase(torch, np, card) -> dict:
    """Tensor-parallel serving (serve/shard.py) on the one card: two ranks
    over gloo with CUDA tensors, eager.  Returns rows 1, 3 and 4's launches
    on each rank."""
    from repro_torch.parallel.mesh import spawn
    from repro_torch.serve.scheduler import decode_step_ici_bytes
    cfgs = tp_configs()
    q14 = cfgs["qwen3-14b"]
    if decode_step_ici_bytes(q14, SLOTS, TP) != TP_STEP_BYTES:
        fail(f"qwen3-14b's step at 4 slots is charged "
             f"{decode_step_ici_bytes(q14, SLOTS, TP)} B, want "
             f"{TP_STEP_BYTES}")
    print(f"[tp] {card}: two ranks share this one card (one HBM, one "
          "set of SMs), so the tp-2 times below say nothing about tp-2 "
          "speed on two cards; they hold correctness and the ledger")
    refs = {k: tp_reference(torch, np, card, c) for k, c in cfgs.items()}
    torch.cuda.empty_cache()
    print(f"[tp] unsharded references freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    # the NCCL world of one (one small process) runs beside the ranks
    nccl = beside(spawn, nccl_world_one, 1, backend="nccl", device="cuda",
                  timeout=300)
    try:
        ranks = spawn(tp_rank, TP, backend="gloo", device="cuda",
                      timeout=900)
    except RuntimeError as e:
        fail(f"[tp] a rank failed: {e}")
    r0 = ranks[0]
    print(f"[tp] backend {r0['backend']}, CUDA tensors; send / recv "
          + ("through pinned host memory" if r0["p2p_staged"] else "direct")
          + ", the other collectives direct")
    out = {}
    for key, cfg in cfgs.items():
        ref = refs[key]
        L = cfg.n_layers
        op = "mla_paged_attention" if key == "mla-dense" else \
            "paged_attention"
        per_call = 2 if op.startswith("mla") else 1
        for job, spec in ((key, False), (f"{key} ngram", True)):
            if job not in r0:
                continue
            runs = [r[job] for r in ranks]
            label = f"{job} tp {TP}"
            if any(r["tokens"] != runs[0]["tokens"] for r in runs):
                fail(f"{label}: ranks committed different tokens")
            kop = "paged_attention_verify" if spec else op
            want = L * per_call * runs[0]["steps"]
            got = [r["launches"][kop] for r in runs]
            if any(g != want for g in got):
                fail(f"{label}: {kop} launched {got} times on the ranks, "
                     f"want {L} x {per_call} a step x {runs[0]['steps']} "
                     "steps")
            out.setdefault(kop, {})[job] = got
            step_bytes = decode_step_ici_bytes(
                cfg, SLOTS, TP, TP_SPEC_K + 1 if spec else 1)
            charged = sum(runs[0]["ici"])
            if not (runs[0]["step_bytes"] == step_bytes and abs(
                    charged - step_bytes * runs[0]["steps"])
                    <= 1e-9 * charged):
                fail(f"{label}: ledger charged {charged} B over "
                     f"{runs[0]['steps']} steps, want {step_bytes} a step")
            streams = tp_streams(label, runs[0]["tokens"], ref)
            line = (f"[tp] {label} {card}: {streams}; tokens equal on "
                    f"{TP} ranks; {kop} {got[0]} launches a rank = {L} x "
                    f"{per_call} x {runs[0]['steps']} steps; ledger "
                    f"{step_bytes:.0f} B a step ({charged:.0f} B in all)")
            if spec:
                per_req = [step_bytes * n / SLOTS for n in runs[0]["passes"]]
                line += (f"; per request charged "
                         f"{[round(x) for x in runs[0]['ici']]} B vs "
                         f"weight passes x step / slots {[round(x) for x in per_req]}"
                         " (equal while all slots verify)")
            print(line)
            if spec:
                continue
            d = float(np.abs(runs[0]["logits"] - ref["logits"]).max())
            if not d <= TP_LOGITS_ATOL:
                fail(f"{label}: first decode logits differ from the "
                     f"unsharded engine's by {d:.4f} > {TP_LOGITS_ATOL}")
            cc = runs[0]["cc"]
            kinds = {"all-reduce": 2 * L, "all-gather": 1}
            if cc["ops_by_kind"] != kinds or not (
                    1 / TP_ICI_RATIO <= cc["ici_ratio"] <= TP_ICI_RATIO):
                fail(f"{label}: collective cross-check {cc}, want ops "
                     f"{kinds} within {TP_ICI_RATIO}")
            print(f"[tp] {label} {card}: first decode logits within "
                  f"{d:.4f} of the unsharded engine's (atol "
                  f"{TP_LOGITS_ATOL}, max |logit| "
                  f"{float(np.abs(ref['logits']).max()):.2f}); "
                  f"crosscheck_collectives ledger {cc['analytic_ici_bytes']:.0f}"
                  f" B vs walked {cc['walk_ici_bytes']:.0f} B a step (ratio "
                  f"{cc['ici_ratio']:.4f}), ops {cc['ops_by_kind']}")
            print(f"[tp] {label} {card}: eager decode step "
                  f"{runs[0]['step_ms']:.2f} ms (ranks "
                  f"{[round(r['step_ms'], 2) for r in runs]}) vs unsharded "
                  f"eager {ref['step_ms']:.2f} ms; collectives "
                  f"{runs[0]['edge_ms']:.2f} ms of a {runs[0]['timed_step_ms']:.2f}"
                  f" ms step timed with events around {runs[0]['n_edges']} "
                  f"edges ({runs[0]['edge_ms'] / runs[0]['timed_step_ms']:.1%}"
                  "; the timed step dispatches through Python); peak memory "
                  f"a rank {[round(r['peak_gb'], 2) for r in runs]} GB "
                  f"(shards {ranks[0][f'{key} params_gb']:.2f} GB) vs "
                  f"unsharded {ref['peak_gb']:.2f} GB")
    try:
        one = nccl.result()
    except RuntimeError as e:
        fail(f"[tp] NCCL world of one failed: {e}")
    if one["captured"] != ["all-gather", "all-reduce"]:
        fail(f"[tp] NCCL world of one: the capture dispatched "
             f"{one['captured']}, want one all-reduce and one all-gather")
    if not one["equal"]:
        fail("[tp] NCCL world of one: the captured graph's replay differs "
             "from eager")
    print(f"[tp] NCCL {one['nccl']} world of one {card}: a CUDA graph "
          "captured over row_parallel_psum and all_gather_cols (the "
          f"capture dispatched {one['captured']}) replays equal to eager "
          f"bit for bit (output {one['shape']}); NCCL at tp > 1 needs two "
          "cards and is not verified here")
    return out


# --------------------------------------------------------------------------
# n. the multi-replica serving tier (serve/cluster.py, serve/router.py)
# --------------------------------------------------------------------------

# replica 0's pool in the rescue run (the trash page included): the six
# prompts' growth preempts there by swap, and the preemptees its pool
# cannot take back move to replica 1 (found by the page arithmetic alone:
# 12 preemptions, 2 rescues on any model at these lengths)
ROUTER_RESCUE_PAGES = 24
ROUTER_SEEDS = tuple(range(100, 100 + len(PROMPT_LENS)))


@contextlib.contextmanager
def migration_pages():
    """Every migrating request's pages (each paged leaf, its scale slabs
    and state rows, gathered through the block table, as bytes) on the
    source just before its export and on the destination right after its
    restore: (before, after) dicts by request id, and the wall seconds of
    each export and each restore (``walls``: "export", "restore")."""
    import torch
    from repro_torch.models.params import tree_leaves
    from repro_torch.serve.kv_cache import gather_slot_pages
    from repro_torch.serve.scheduler import RequestState, Scheduler

    def pages(kv, slot):
        phys = torch.as_tensor(kv.block_tables[slot][:kv.slot_pages(slot)],
                               dtype=torch.long, device=kv.device)
        return [t.contiguous().view(torch.uint8) for t in tree_leaves(
            gather_slot_pages(kv.pools, phys, kv._paged, slot))]

    from repro_torch.obs.clock import now
    before, after = {}, {}
    walls = {"export": [], "restore": []}
    detach, resume = Scheduler.detach, Scheduler._resume

    def spy_detach(self, req, link="dcn"):
        running = req.state is RequestState.RUNNING
        if running:
            before[req.request_id] = pages(self.kv, req.slot)
            torch.cuda.synchronize()
        t0 = now()
        out = detach(self, req, link)        # ends in its copy to host
        if running:
            walls["export"].append(now() - t0)
        return out

    def spy_resume(self, req):
        moving = req.migrating
        t0 = now()
        ok = resume(self, req)               # ends in a synchronize
        if ok and moving:
            walls["restore"].append(now() - t0)
            after[req.request_id] = pages(self.kv, req.slot)
        return ok

    Scheduler.detach, Scheduler._resume = spy_detach, spy_resume
    try:
        yield before, after, walls
    finally:
        Scheduler.detach, Scheduler._resume = detach, resume


def pages_equal(torch, label: str, before: dict, after: dict) -> str:
    """The pages after each migration equal those before it bit for bit."""
    if not before or sorted(before) != sorted(after):
        fail(f"[router] {label}: pages recorded for {sorted(before)} before "
             f"export and {sorted(after)} after restore")
    n = 0
    for rid in before:
        if len(before[rid]) != len(after[rid]) or not all(
                torch.equal(a, b) for a, b in zip(before[rid], after[rid])):
            fail(f"[router] {label}: request {rid}'s pages after migration "
                 "differ from those before it")
        n += sum(t.numel() for t in before[rid])
    return (f"pages after migration equal those before bit for bit "
            f"({len(before)} requests, {n / 1e6:.2f} MB)")


def router_run(torch, cluster, prompts, gen, seeds=None):
    """Serve ``prompts`` through a Router over ``cluster``, every paged
    kernel's launch count zeroed just before the run and read just after,
    and split by replica (each replica's step bracketed).  Returns
    (router, requests, {kernel: launches}, [per replica], wall s)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.obs.clock import now
    from repro_torch.serve import Router
    per = [dict.fromkeys(PAGED_KERNELS, 0) for _ in cluster.replicas]
    for i, eng in enumerate(cluster.replicas):
        def step(step=eng.step, i=i):
            n0 = {n: getattr(pa, n).launches for n in PAGED_KERNELS}
            out = step()
            for n in PAGED_KERNELS:
                per[i][n] += getattr(pa, n).launches - n0[n]
            return out
        eng.step = step
    router = Router(cluster)
    reqs = [router.submit(p, gen, seed=None if seeds is None else seeds[i])
            for i, p in enumerate(prompts)]
    for n in PAGED_KERNELS:
        getattr(pa, n).launches = 0              # counts start here
    torch.cuda.synchronize()
    t0 = now()
    router.run()
    torch.cuda.synchronize()
    wall = now() - t0
    total = {n: getattr(pa, n).launches for n in PAGED_KERNELS}  # read
    for eng in cluster.replicas:
        del eng.step                 # the counting wrapper: a cycle
    return router, reqs, total, per, wall


def router_warm(torch, router, prompts, gen, seeds=None):
    """The same requests through a router that has served them once:
    (requests, None, wall s)."""
    from repro_torch.obs.clock import now
    reqs = [router.submit(p, gen, seed=None if seeds is None else seeds[i])
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = now()
    router.run()
    torch.cuda.synchronize()
    return reqs, None, now() - t0


def router_streams(label: str, got, base, margins) -> str:
    """Streams equal to one engine's; a parting fails, with the engine's
    top-2 margin at the token (every shape a request meets is the one
    engine's: the decode and verify steps keep their (slots, T) shape
    whatever runs in them, and prefill runs a request alone)."""
    for i, (a, b) in enumerate(zip(got, base)):
        if a != b:
            j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            m = margins.get((i, j), float("nan"))
            fail(f"[router] {label}: request {i} parts from one engine's "
                 f"stream at token {j} (one engine's top-2 margin there "
                 f"{m:.4f}); no shape differs between the two")
    return "tokens equal one engine's on the same weights"


def router_phase(torch, np, card) -> None:
    """The multi-replica tier on the one card: replicas colocated, stepped
    in turn by the router (times say nothing of disaggregation's speed on
    separate cards).  qwen3-0.6b whole, graphed, page 16, 4 slots a
    replica, PROMPT_LENS with NEW_TOKENS new: dp 2 mixed; dp 2
    disaggregated (1 prefill + 1 decode); a rescue run (replica 0 mixed in
    ROUTER_RESCUE_PAGES pages, replica 1 decode-only); disaggregated with
    int8 pages, with seeded sampling, and with n-gram speculation (k 3);
    then the MLA-dense model of the [tp] phase disaggregated.  Each holds
    its pages across every migration bit for bit (the disaggregated
    runs), its tokens against one engine on the same weights, its
    migration bytes against the analytic page model (within 15%) and its
    kernel launches per replica (layers x that replica's steps)."""
    from repro_torch.configs import get_config
    from repro_torch.serve import (Cluster, EngineConfig, GenerateConfig,
                                   RoleConfig, SpecConfig, SpecEngine)
    from repro_torch.serve.scheduler import kv_line_bytes, state_bytes
    qwen = get_config("qwen3-0.6b")
    mla = tp_mla_config(get_config)
    base_ecfg = EngineConfig(num_slots=SLOTS, page_size=PAGE,
                             max_len=MAX_LEN, prefill_chunk=PREFILL_CHUNK,
                             device="cuda")
    gen = GenerateConfig(max_new_tokens=NEW_TOKENS)
    sampled = GenerateConfig(max_new_tokens=NEW_TOKENS, temperature=0.8,
                             top_k=50, top_p=0.9)
    disagg = RoleConfig.disaggregated(1, 1)
    runs = (
        # label, cfg, roles, ecfg changes, spec, gen, seeds
        ("qwen3-0.6b mixed dp 2", qwen, RoleConfig.mixed(2), {}, None, gen,
         None),
        ("qwen3-0.6b disaggregated 1+1", qwen, disagg, {}, None, gen, None),
        ("qwen3-0.6b rescue", qwen, RoleConfig(("mixed", "decode")),
         dict(num_pages=ROUTER_RESCUE_PAGES), None, gen, None),
        ("qwen3-0.6b int8 disaggregated", qwen, disagg,
         dict(kv_dtype="int8"), None, gen, None),
        ("qwen3-0.6b sampled disaggregated", qwen, disagg, {}, None, sampled,
         ROUTER_SEEDS),
        ("qwen3-0.6b n-gram k 3 disaggregated", qwen, disagg, {},
         SpecConfig(k=3, proposer="ngram"), gen, None),
        ("MLA-dense (4 layers) disaggregated", mla, disagg,
         dict(max_len=DS_MAX_LEN), None, gen, None),
    )
    print(f"[router] {card}: the replicas of each run share this one card "
          "in one process and the router steps them in turn, so the times "
          "below hold correctness and accounting, not the speed of "
          "disaggregation across cards")
    params, cfg_now = None, None
    for label, cfg, roles, change, scfg, g, seeds in runs:
        if cfg is not cfg_now:
            del params
            gc.collect()
            params, cfg_now = make_params(torch, cfg), cfg
        rng = np.random.default_rng(50)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
        one_ecfg = dataclasses.replace(
            base_ecfg, **{k: v for k, v in change.items()
                          if k != "num_pages"})
        ecfg = dataclasses.replace(base_ecfg, **change)
        one = (margin_engine(cfg, params, one_ecfg) if scfg is None
               else SpecEngine(cfg, params, one_ecfg, scfg))
        base, base_launches, base_wall = counted_run(torch, one, prompts, g,
                                                     seeds)
        margins = getattr(one, "margins", {})
        torch.cuda.reset_peak_memory_stats()
        with migration_pages() as (before, after, walls):
            cluster = Cluster(cfg, params, ecfg, scfg, mesh_shape=(2, 1),
                              roles=roles)
            router, reqs, total, per, wall = router_run(
                torch, cluster, prompts, g, seeds)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for r in reqs:
            if r.finish_reason != "length" or len(r.generated) != NEW_TOKENS:
                fail(f"[router] {label}: request {r.request_id} ended "
                     f"{r.finish_reason!r} with {len(r.generated)} tokens")
        if not cluster.colocated or any(
                e.device.type != "cuda" for e in cluster.replicas):
            fail(f"[router] {label}: replicas not colocated on the card")
        if any(e.params["embed"]["tok"].data_ptr()
               != params["embed"]["tok"].data_ptr()
               for e in cluster.replicas):
            fail(f"[router] {label}: a replica holds its own weights")
        got = [list(r.generated) for r in reqs]
        streams = router_streams(label, got, [list(r.generated)
                                              for r in base], margins)
        led = cluster.aggregate_ledger()
        line = []
        if roles.disaggregates and "prefill" in roles.roles:
            line.append(pages_equal(torch, label, before, after))
            if router.migrations != len(prompts):
                fail(f"[router] {label}: {router.migrations} migrations "
                     f"for {len(prompts)} requests")
        elif roles.disaggregates:                      # the rescue run
            if not (led.preemptions > 0 and router.migrations > 0):
                fail(f"[router] {label}: {led.preemptions} preemptions, "
                     f"{router.migrations} rescues; want both > 0")
            line.append(f"{led.preemptions} swap preemptions on replica 0, "
                        f"{router.migrations} preemptees rescued to "
                        "replica 1")
        elif router.migrations:
            fail(f"[router] {label}: a mixed fleet migrated")
        if router.migrations:
            analytic = (led.migration_pages * PAGE * kv_line_bytes(
                cluster.replicas[0].cfg)
                + led.migrations * state_bytes(cluster.replicas[0].cfg))
            ratio = analytic / led.migration_bytes
            if not 1 / 1.15 <= ratio <= 1.15:
                fail(f"[router] {label}: migration bytes "
                     f"{led.migration_bytes:.0f} vs analytic {analytic:.0f}"
                     f" (ratio {ratio:.4f}) outside 15%")
            in_ms = np.mean(walls["restore"]) * 1e3
            out = (f"export (gather, pack, device -> pinned host) "
                   f"{np.mean(walls['export']) * 1e3:.3f} ms + "
                   if walls["export"] else
                   "export: the swap-out at preemption, charged to swap; ")
            line.append(
                f"{router.migrations} migrations, {led.migration_bytes:.0f} "
                f"B ({led.migration_pages} pages) vs analytic "
                f"{analytic:.0f} B (ratio {ratio:.4f}); migration wall a "
                f"request: {out}restore (pinned host -> device, place) "
                f"{in_ms:.3f} ms")
        # launches: each replica, layers x its own steps
        op = ("paged_attention_verify" if scfg is not None else
              "mla_paged_attention" if cfg is mla else "paged_attention")
        per_call = launches_per_call(op, cfg)
        want = [cfg.n_layers * per_call * (e.verify_steps if scfg is not None
                                           else e.decode_steps)
                for e in cluster.replicas]
        got_l = [p[op] for p in per]
        if got_l != want or sum(got_l) != total[op] or any(
                total[n] for n in PAGED_KERNELS if n != op):
            fail(f"[router] {label}: {op} launched {got_l} on the replicas "
                 f"(run total {total}), want {want}")
        n_tok = sum(len(x) for x in got)
        cap = sum(capture_ms(e) for e in cluster.replicas)
        line = "; ".join([streams] + line)
        print(f"[router] {label} {card}: {line}")
        # the same requests again on the same replicas and engine, their
        # graphs captured: the warm walls and TTFTs
        warm = []
        for serve in (lambda: router_warm(torch, router, prompts, g, seeds),
                      lambda: counted_run(torch, one, prompts, g, seeds)):
            w_reqs, _, w_wall = serve()
            if [list(r.generated) for r in w_reqs] != got:
                fail(f"[router] {label}: the warm pass changed the tokens")
            warm.append((w_wall, np.array([list(
                r.ttft_breakdown().values()) for r in w_reqs])))
        (r_wall, ttft), (o_wall, o_ttft) = warm
        print(f"[router] {label} {card}: {op} {got_l} launches on the "
              f"replicas (roles {','.join(roles.roles)}) = {cfg.n_layers} "
              f"layers x {per_call} x their steps; cold (graph capture "
              f"inside: {cap:.1f} ms over the replicas, {capture_ms(one):.1f}"
              f" ms one engine) router {n_tok / wall:.2f} vs one engine "
              f"{n_tok / base_wall:.2f} tok/s; warm router "
              f"{n_tok / r_wall:.2f} vs one engine {n_tok / o_wall:.2f} "
              f"tok/s (replicas sharing one card); warm TTFT mean "
              f"{ttft.sum(1).mean() * 1e3:.2f} ms = queue "
              f"{ttft[:, 0].mean() * 1e3:.2f} + prefill "
              f"{ttft[:, 1].mean() * 1e3:.2f} + first decode "
              f"{ttft[:, 2].mean() * 1e3:.2f} (one engine "
              f"{o_ttft.sum(1).mean() * 1e3:.2f} = "
              f"{o_ttft[:, 0].mean() * 1e3:.2f} + "
              f"{o_ttft[:, 1].mean() * 1e3:.2f} + "
              f"{o_ttft[:, 2].mean() * 1e3:.2f}); peak memory "
              f"{peak_gb:.2f} GB")
        del cluster, router, reqs, one, base, before, after, walls
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# o. training ([train] lines): launch/train.py and train/ on the card
# --------------------------------------------------------------------------

# qwen3-0.6b whole through launch/train.py, as a user runs it: bf16
# weights, float32 AdamW moments, remat full (the config's), B 4 x S 2048,
# 8 steps of the cosine schedule at lr 3e-4 (warmup min(20, steps // 5))
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 4, 2048, 8, 3e-4
# the bitwise resume: qwen3-0.6b's widths cut to RESUME_LAYERS layers
# (the checkpoint IO of six saves stays small), 6 steps, a checkpoint
# every 3, a transient fault injected at step 4, then a restart
RESUME_LAYERS, RESUME_B, RESUME_S = 2, 2, 256
RESUME_STEPS, RESUME_EVERY, RESUME_FAULT = 6, 3, 4
# gradient accumulation against the full batch (derived in train_phase)
ACCUM_LOSS_RTOL, ACCUM_GNORM_RTOL = 2.0 ** -8, 2.0 ** -6
# deepseek-v2-236b at full width cut to 2 layers (the dense prologue and
# one MoE layer of 160 experts, top-6), B 2 x S 1024
DS_TRAIN_LAYERS, DS_TRAIN_B, DS_TRAIN_S = 2, 2, 1024


def kernel_launch_counts() -> dict:
    """Every kernel wrapper's launch count (the wrappers of the 14 rows,
    each a function of ``repro_torch.kernels`` with a ``launches``
    count)."""
    from repro_torch.kernels import (avgpool, conv_direct, conv_winograd,
                                     flash_attention, gelu, inner_product,
                                     layernorm)
    from repro_torch.kernels import paged_attention as pa
    mods = (pa, inner_product, gelu, conv_direct, conv_winograd, layernorm,
            avgpool, flash_attention)
    return {f"{m.__name__.rsplit('.', 1)[1]}.{n}": f.launches
            for m in mods for n, f in sorted(vars(m).items())
            if callable(f) and isinstance(getattr(f, "launches", None), int)}


def leaves_equal(torch, a, b) -> bool:
    from repro_torch.models.params import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def train_qwen(torch, np, card, tmp: str) -> dict:
    """Part 1: qwen3-0.6b whole through ``launch/train.py``'s ``main``
    (its pre-flight report, then TrainLoop), and the whole state's
    checkpoint: its bytes, the restore (bit for bit) and the save, timed.
    Returns the config, the run's final state and the step's numbers
    that :func:`train_roof_line` holds against the measured roofs."""
    import os
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models.common import model_flops
    from repro_torch.train import CheckpointManager
    from repro_torch.train.loop import abstract_state
    cfg = get_config("qwen3-0.6b")
    if (cfg.remat, cfg.dtype, cfg.tie_embeddings) != ("full", "bfloat16",
                                                      True):
        fail(f"unexpected qwen3-0.6b training config {cfg}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_cli.main([
        "--arch", cfg.name, "--steps", str(TRAIN_STEPS), "--batch",
        str(TRAIN_B), "--seq", str(TRAIN_S), "--lr", str(TRAIN_LR),
        "--ckpt-dir", tmp, "--ckpt-every", "100"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = res["loop"].history
    losses = [h["loss"] for h in hist]
    if [h["step"] for h in hist] != list(range(1, TRAIN_STEPS + 1)):
        fail(f"train history steps {[h['step'] for h in hist]}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"qwen3-0.6b training loss did not fall: {losses}")
    step_s = float(np.median([h["dt"] for h in hist[2:]]))
    mf = model_flops(cfg, TRAIN_S, TRAIN_B, "train")
    rep = res["report"]
    w, q = rep.character.flops_dev, rep.character.hbm_bytes_dev
    print(f"[train] qwen3-0.6b whole ({cfg.n_layers} layers, bf16 weights, "
          f"float32 moments, remat {cfg.remat}), B {TRAIN_B} x S {TRAIN_S}, "
          f"{TRAIN_STEPS} steps, cosine lr {TRAIN_LR}: loss by step "
          f"{', '.join(f'{x:.4f}' for x in losses)} (falls "
          f"{losses[0] - losses[-1]:.4f}); {card}")
    print(f"[train] qwen3-0.6b step (median of steps 3-{TRAIN_STEPS}) "
          f"{step_s * 1e3:.2f} ms (steps 1-2: {hist[0]['dt'] * 1e3:.1f}, "
          f"{hist[1]['dt'] * 1e3:.1f} ms), "
          f"{TRAIN_B * TRAIN_S / step_s:.0f} tokens/s; model FLOPs "
          f"{mf:.4e} a step = {mf / step_s / 1e12:.1f} TFLOP/s; peak "
          f"memory {peak / 1e9:.2f} GB; launch/train.py wall {wall:.1f} s "
          f"(pre-flight walk {rep.walk_seconds:.1f} s and the final "
          f"checkpoint included; the kernels' nvcc builds run beside it)")
    print(f"[train] pre-flight walk of the step (fake tensors): W "
          f"{w:.4e} FLOPs = {w / mf:.3f} x model FLOPs, Q {q / 1e9:.2f} GB; "
          f"bound {rep.terms.t_lower * 1e3:.2f} ms on the data sheet "
          f"({rep.terms.bound_class()}), against the measured step "
          f"{step_s * 1e3:.2f} ms "
          f"({100 * rep.terms.t_lower / step_s:.1f}% of it)")
    state = res["out"]["state"]
    mgr = CheckpointManager(os.path.join(tmp, cfg.name))
    path = os.path.join(mgr.step_dir(TRAIN_STEPS), "arrays.npz")
    nbytes = os.path.getsize(path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, manifest = mgr.restore(abstract_state(cfg), device="cuda")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    if manifest["step"] != TRAIN_STEPS or not leaves_equal(torch, restored,
                                                           state):
        fail("the final checkpoint does not restore bit for bit")
    del restored
    shutil.rmtree(mgr.dir)
    mgr = CheckpointManager(os.path.join(tmp, "timed"), keep=1)
    t0 = time.perf_counter()
    mgr.save_async(state, TRAIN_STEPS)
    t_snap = time.perf_counter() - t0
    mgr.wait()
    t_save = time.perf_counter() - t0
    shutil.rmtree(mgr.dir)
    print(f"[train] qwen3-0.6b checkpoint (params, moments, step): "
          f"{nbytes / 1e9:.3f} GB on disk; save_async {t_snap:.2f} s "
          f"host snapshot + {t_save - t_snap:.2f} s written in the "
          f"background; restore to the card {t_restore:.2f} s, equal to "
          f"the state bit for bit (warm page cache)")
    return {"cfg": cfg, "state": state,
            "step": {"step_s": step_s, "mf": mf, "w": w, "q": q}}


def train_roof_line(card, roof, step: dict) -> None:
    """The [train] step against the measured roofs (the primitive study's,
    measured after the phase ran): the model FLOPs' share of the bf16
    matmul roof, and the pre-flight walk's bound on these roofs."""
    bf16 = roof.matmul_flops["bfloat16"]
    step_s, mf, w, q = (step[k] for k in ("step_s", "mf", "w", "q"))
    bound_meas = max(w / bf16, q / roof.peak_bw)
    print(f"[train] qwen3-0.6b step {step_s * 1e3:.2f} ms on the measured "
          f"roofs ({card}): model FLOPs {100 * mf / step_s / bf16:.2f}% of "
          f"the bf16 matmul roof ({bf16 / 1e12:.1f} TFLOP/s); the pre-flight "
          f"walk's bound {bound_meas * 1e3:.2f} ms, "
          f"{100 * bound_meas / step_s:.1f}% of the step")


def accumulation_check(torch, cfg, state) -> None:
    """Part 3: ``grad_accum`` 2 against the full batch, one step each on
    the same state and batch (qwen3-0.6b whole, B 4 x S 2048).

    Tolerances.  The two steps compute the same function; they differ
    in rounding only.  (a) cuBLAS picks a GEMM kernel by row count, so
    a 4096-row product may sum in another order than an 8192-row one and
    round some bf16 outputs to the neighbouring value (one bf16 ulp,
    2^-8 of the element at most); such flips are sparse and of random
    sign, so after 28 layers the logits move far less than 2^-8 of
    themselves, and the loss, a float32 mean over 8192 tokens, less
    again: held at 2^-8 of the loss (ACCUM_LOSS_RTOL), one bf16 ulp.
    (b) A weight's full-batch gradient is one bf16 rounding of a float32
    sum over 8192 tokens; accumulated, it is two bf16 roundings of
    4096-token sums (each within 2^-9 of its half), added in float32 and
    halved, so every element lies within 2^-8 of |g| plus the (a) flips,
    and so does the global norm: held at 2^-6 (ACCUM_GNORM_RTOL), four
    times that."""
    from repro_torch.train import (OptConfig, SyntheticLMData, TrainConfig,
                                   make_train_step)
    data = SyntheticLMData(cfg, TRAIN_B, TRAIN_S, device="cuda")
    batch = data.batch_at(TRAIN_STEPS)
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=min(20, TRAIN_STEPS // 5),
                    total_steps=TRAIN_STEPS)
    out = {}
    for n in (1, 2):
        new, m = make_train_step(cfg, TrainConfig(opt=opt, grad_accum=n))(
            state, batch)
        out[n] = (float(m["loss"]), float(m["grad_norm"]))
        del new
    (l1, g1), (l2, g2) = out[1], out[2]
    dl, dg = abs(l2 - l1) / abs(l1), abs(g2 - g1) / abs(g1)
    print(f"[train] grad_accum 2 vs the full batch (qwen3-0.6b, step "
          f"{TRAIN_STEPS + 1}): loss {l2:.6f} vs {l1:.6f} (rel "
          f"{dl:.2e}, tol {ACCUM_LOSS_RTOL:.2e}), grad norm {g2:.6f} vs "
          f"{g1:.6f} (rel {dg:.2e}, tol {ACCUM_GNORM_RTOL:.2e})")
    if not (dl <= ACCUM_LOSS_RTOL and dg <= ACCUM_GNORM_RTOL):
        fail("gradient accumulation misses its tolerance")


def resume_check(torch, np, cfg, tmp: str) -> None:
    """Part 2: a run of RESUME_STEPS steps checkpointing every
    RESUME_EVERY, against one that fails at step RESUME_FAULT (the
    loop's emergency checkpoint, then the fault re-raised) and is
    restarted: the restarted run's losses and final state must equal the
    uninterrupted run's bit for bit.  Under deterministic algorithms: the
    embedding gather's, ``take_along_dim``'s backward add with atomics
    otherwise."""
    import os
    from repro_torch.train import (CheckpointManager, LoopConfig, OptConfig,
                                   SyntheticLMData, TrainConfig, TrainLoop,
                                   make_initial_state)
    from repro_torch.train.loop import _TransientError
    small = dataclasses.replace(cfg, n_layers=RESUME_LAYERS)
    loop_cfg = LoopConfig(
        total_steps=RESUME_STEPS, ckpt_every=RESUME_EVERY, log_every=1,
        max_retries=0, train=TrainConfig(opt=OptConfig(
            lr=1e-3, warmup_steps=0, total_steps=RESUME_STEPS)))
    data = SyntheticLMData(small, RESUME_B, RESUME_S, seed=5, device="cuda")
    armed = {"on": True}

    def injector(step):
        if step == RESUME_FAULT and armed["on"]:
            raise _TransientError("injected node loss")

    def loop(name, inject=None):
        return TrainLoop(small, loop_cfg, data,
                         CheckpointManager(os.path.join(tmp, name), keep=3),
                         make_initial_state(small, 0, "cuda"),
                         failure_injector=inject)

    with deterministic(torch, True):
        ref = loop("uninterrupted")
        ref_out = ref.run()
        crashed = loop("restarted", injector)
        try:
            crashed.run()
            fail("the injected fault did not stop the run")
        except _TransientError:
            pass
        armed["on"] = False
        resumed = loop("restarted", injector)
        t0 = time.perf_counter()
        out = resumed.run()
        wall = time.perf_counter() - t0
    want = {h["step"]: h["loss"] for h in ref.history}
    got = {h["step"]: h["loss"] for h in resumed.history}
    first = min(got) if got else None
    if (out["step"] != RESUME_STEPS or first != RESUME_FAULT + 1
            or any(got[s] != want[s] for s in got)
            or not leaves_equal(torch, out["state"], ref_out["state"])):
        fail(f"resume is not bitwise: {got} vs {want}")
    print(f"[train] resume (qwen3-0.6b widths, {RESUME_LAYERS} layers, B "
          f"{RESUME_B} x S {RESUME_S}, deterministic algorithms): fault at "
          f"step {RESUME_FAULT}, restarted from its emergency checkpoint: "
          f"losses of steps {sorted(got)} and the final state equal the "
          f"uninterrupted run's bit for bit "
          f"({', '.join(f'{got[s]:.6f}' for s in sorted(got))}); restart "
          f"to step {RESUME_STEPS} {wall:.2f} s")


def deepseek_dispatch_check(torch, np) -> None:
    """Part 4: deepseek-v2-236b at full width, 2 layers (the dense
    prologue, one MoE layer), one ``loss_fn`` forward and backward
    (``train.step.value_and_grad``, no optimizer state) with the
    data-local dispatch, under deterministic algorithms.  One rank is one
    group, so "local" runs the global dispatch over the rank's tokens:
    the line reads the routing through ``_dispatch_combine``'s kept
    slots and requires every routed expert with tokens to have nonzero
    gradients and every other to have zero ones."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.params import tree_paths
    from repro_torch.train import SyntheticLMData
    from repro_torch.train.step import value_and_grad
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              n_layers=DS_TRAIN_LAYERS, moe_dispatch="local")
    if [(tuple(b.ffn for b in u), r) for u, r in cfg.segments()] != [
            (("dense",), 1), (("moe",), 1)] or cfg.n_experts != 160:
        fail(f"unexpected deepseek-v2 training cut {cfg.segments()}")
    params = make_params(torch, cfg)
    batch = SyntheticLMData(cfg, DS_TRAIN_B, DS_TRAIN_S,
                            device="cuda").batch_at(0)
    kept = []
    inner = moe_mod._dispatch_combine

    def spy(xf, gates, eids, C, c, **kw):
        out = inner(xf, gates, eids, C, c, **kw)
        kept.append((out[1].reshape(c.n_experts, -1) < xf.shape[0]).sum(1))
        return out

    moe_mod._dispatch_combine = spy
    try:
        with deterministic(torch, True):
            torch.cuda.reset_peak_memory_stats()
            loss, metrics, grads = value_and_grad(params, batch, cfg)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
    finally:
        moe_mod._dispatch_combine = inner
    got = kept[0].cpu()
    finite = all(bool(torch.isfinite(g).all()) for _, g in tree_paths(grads))
    ffn = grads["segments"][1]["b0"]["ffn"]
    norms = torch.stack([torch.linalg.vector_norm(
        ffn[k][0], dim=(1, 2), dtype=torch.float32)
        for k in ("w_up", "w_gate", "w_down")])
    busy = got > 0
    moved = (norms > 0).all(0).cpu()
    still = (norms == 0).all(0).cpu()
    ok = bool(moved[busy].all()) and bool(still[~busy].all())
    print(f"[train] deepseek-v2-236b ({DS_TRAIN_LAYERS} layers: dense + "
          f"MoE), B {DS_TRAIN_B} x S {DS_TRAIN_S}, dispatch local (one "
          f"group a rank): loss {float(loss):.6f} = nll "
          f"{float(metrics['nll']):.6f} + aux {float(metrics['aux']):.6f}; "
          f"gradients finite: {finite}; {int(busy.sum())} of "
          f"{cfg.n_experts} routed experts got tokens (kept "
          f"{int(got.sum())} pairs), all of them with nonzero w_up / "
          f"w_gate / w_down gradients and the other {int((~busy).sum())} "
          f"with zero ones: {ok}; peak memory {peak / 1e9:.2f} GB")
    if not (finite and ok and np.isfinite(float(loss))):
        fail("deepseek-v2 local dispatch gradients")
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()


def train_phase(torch, np, card) -> dict:
    """The [train] phase: qwen3-0.6b whole through launch/train.py, its
    checkpoint, gradient accumulation, the bitwise resume, and
    deepseek-v2's local dispatch.  The training path runs no ported
    kernel (the reference's training runs no Pallas kernel): every
    wrapper's launch count must stay as it was, and so :func:`main` runs
    the phase while nvcc builds the kernels.  Returns the qwen3-0.6b
    step's numbers for :func:`train_roof_line`."""
    import signal
    import tempfile
    before = kernel_launch_counts()
    prev = signal.getsignal(signal.SIGTERM)   # TrainLoop installs its own
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
            run = train_qwen(torch, np, card, tmp)
            cfg, step = run["cfg"], run["step"]
            accumulation_check(torch, cfg, run["state"])
            del run
            gc.collect()
            torch.cuda.empty_cache()
            resume_check(torch, np, cfg, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        deepseek_dispatch_check(torch, np)
    finally:
        signal.signal(signal.SIGTERM, prev)
    after = kernel_launch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if moved or len(after) < 14:
        fail(f"the training path launched ported kernels: {moved} "
             f"({len(after)} wrappers counted)")
    print(f"[train] the training path launched none of the ported kernels "
          f"({len(after)} wrappers' launch counts unchanged)")
    return step


# --------------------------------------------------------------------------
# p. data-parallel training ([train-dp] lines): two ranks on the one card
# --------------------------------------------------------------------------

# The gloo phases ([train-dp], [train-tp]) run qwen3-0.6b at its full
# widths cut to GLOO_LAYERS layers: two to four processes time-slice the
# one card and reduce through host memory, so depth buys no check there
# (the [train] phase trains it whole) and costs the script's time limit
GLOO_LAYERS = 4


def gloo_qwen():
    """qwen3-0.6b at full width, GLOO_LAYERS deep: the gloo phases'
    dense model."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-0.6b"),
                               n_layers=GLOO_LAYERS)


# qwen3-0.6b (GLOO_LAYERS layers) at data 2 through launch/train.py: the
# [train] batch of 4 x 2048 as 2 rows a rank, 3 steps, a checkpoint at
# step 2
DP_STEPS, DP_CKPT = 3, 2
# a parameter after one step, data 2 against one rank at grad_accum 2 on
# the same rows: one bf16 ulp of it plus lr x DP_LR_SHARE.  The ranks'
# bf16 gradients g0, g1 are the microbatches' bit for bit (deterministic
# algorithms, the same GEMM shapes); data 2 sums them in bf16, the
# reduce's dtype (one rounding, 2^-8 relative), the one rank in float32;
# the clip's norm moves as much.  AdamW's first update lr g s / (|g s| +
# eps) moves by at most lr x (2^-8 + 2^-8) = lr x 2^-7 for a relative
# change of g and of s, and the float32 results may round to adjacent
# bf16 values: one ulp (dp_dense_check's docstring has the steps)
DP_LR_SHARE = 2.0 ** -7
# the NCCL world of one: qwen3-0.6b (GLOO_LAYERS layers) at B 2 x S 512
DP_NCCL_B, DP_NCCL_S = 2, 512


def digest(torch, t) -> tuple:
    """Two int64 sums over ``t``'s bits (plain and position-weighted):
    equal tensors give equal digests, and a changed element changes the
    weighted one."""
    v = t.detach().contiguous().view(-1)
    v = v.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[v.element_size()]).to(torch.int64)
    w = torch.arange(1, v.numel() + 1, device=v.device,
                     dtype=torch.int64) % 65521
    return int(v.sum()), int((v * w).sum())


def dp_ulp(torch, t):
    """One ulp of each element of ``t`` in its dtype (of its magnitude,
    at least the dtype's smallest normal's)."""
    fi = torch.finfo(t.dtype)
    mag = t.detach().float().abs().clamp_min(fi.tiny)
    return torch.exp2(torch.floor(torch.log2(mag))) * fi.eps


def dp_objects(obj, world: int) -> list:
    import torch.distributed as dist
    every = [None] * world
    dist.all_gather_object(every, obj)
    return every


def dp_dense_check(torch, rank: int, world: int, mesh, dev) -> dict:
    """qwen3-0.6b (GLOO_LAYERS layers), data 2 on this rank's 2 rows of
    the [train] batch, 2 steps under deterministic algorithms: the
    parameters' digests equal on both ranks after every step, the second
    step's collectives timed; rank 0 then runs one rank at grad_accum 2 on
    the whole batch from the same initial state.

    Tolerance of a parameter after step 1.  Under deterministic algorithms
    a rank's forward and backward over its 2 rows are the one rank's
    microbatch's, bit for bit (the same GEMM shapes), so the loss
    (s0 + s1) / 8192 equals (s0 / 4096 + s1 / 4096) / 2 bit for bit (a
    power-of-two divisor is exact) and the two ranks' bf16 gradients g0,
    g1 are the microbatches'.  Data 2 reduces them in bf16 (their dtype),
    bf16(g0 + g1) / 2; the one rank adds them in float32, (g0 + g1) / 2:
    each element within one bf16 rounding, 2^-8 relative, and the clip's
    norm as well.  AdamW's first update is lr g s / (|g s| + eps) (+ the
    decay), which a relative change e of g s moves by at most lr e: below
    lr x 2^-7 for both.  The float32 results may then round to adjacent
    bf16 values: one ulp of the parameter plus lr x DP_LR_SHARE."""
    from repro_torch.core.roofline.op_collectives import (CollectiveWalk,
                                                          summarize)
    from repro_torch.models.params import tree_paths
    from repro_torch.parallel.mesh import batch_shard
    from repro_torch.train import (OptConfig, SyntheticLMData, TrainConfig,
                                   make_initial_state, make_train_step)
    cfg = gloo_qwen()
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=DP_STEPS)
    step = make_train_step(cfg, TrainConfig(opt=opt), mesh)
    data = SyntheticLMData(cfg, TRAIN_B, TRAIN_S, device=dev,
                           shard=batch_shard(mesh), shards=world)
    res = {"equal": []}
    with deterministic(torch, True):
        state = make_initial_state(cfg, 0, dev, mesh=mesh)()
        for i in range(2):
            batch = data.batch_at(i)
            if i == 1:
                walk = CollectiveWalk(timed=True, mesh=mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with walk:
                    state, m = step(state, batch)
                torch.cuda.synchronize()
                res["step_ms"] = (time.perf_counter() - t0) * 1e3
                res["edge_ms"] = walk.edge_ms()
                cc = summarize(walk.ops)
                res["ops"] = dict(cc.ops_by_kind)
                res["by_axes"] = {k[0]: v for k, v in cc.by_axes.items()}
            else:
                state, m = step(state, batch)
                first = {"loss": m["loss"].clone(),
                         "params": {k: v.clone() for k, v in
                                    tree_paths(state["params"])}}
            dig = {k: digest(torch, v) for k, v in
                   tree_paths(state["params"])}
            res["equal"].append(all(d == dig for d in dp_objects(dig,
                                                                 world)))
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        one = make_train_step(cfg, TrainConfig(opt=opt, grad_accum=2))
        full = SyntheticLMData(cfg, TRAIN_B, TRAIN_S, device=dev)
        with deterministic(torch, True):
            state0 = make_initial_state(cfg, 0, dev)()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, m = one(state0, full.batch_at(0))
            torch.cuda.synchronize()
            res["one_step_ms"] = (time.perf_counter() - t0) * 1e3
        lr = float(m["lr"])
        res["loss"] = (float(first["loss"]), float(m["loss"]))
        worst, worst_key, n_diff = 0.0, "", 0
        for k, b in tree_paths(new["params"]):
            a = first["params"][k]
            d = (a.float() - b.float()).abs()
            tol = dp_ulp(torch, torch.maximum(a.float().abs(),
                                              b.float().abs()).to(b.dtype)
                         ) + lr * DP_LR_SHARE
            r = float((d / tol).max())
            n_diff += int((d > 0).sum())
            if r > worst:
                worst, worst_key = r, k
        res["params"] = (worst, worst_key, n_diff, lr)
        del new, state0, first
    gc.collect()
    torch.cuda.empty_cache()
    return res


def dp_moe_check(torch, np, rank: int, world: int, mesh, dev) -> dict:
    """deepseek-v2 at 2 layers (dense prologue, one MoE layer of 160
    experts), global dispatch, data 2 on the [train] MoE batch (one row of
    1024 tokens a rank) under deterministic algorithms: a forward's kept
    pairs and routing, then loss_fn's value and gradient; rank 0 then runs
    one rank over the whole batch on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.mesh import batch_shard, use_mesh
    from repro_torch.train import SyntheticLMData
    from repro_torch.train.step import value_and_grad
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              n_layers=DS_TRAIN_LAYERS)
    if cfg.moe_dispatch != "global" or cfg.n_experts != 160:
        fail(f"unexpected deepseek-v2 config {cfg}")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)

    def expert_norms(grads):
        ffn = grads["segments"][1]["b0"]["ffn"]
        return torch.stack([torch.linalg.vector_norm(
            ffn[k][0], dim=(1, 2), dtype=torch.float32)
            for k in ("w_up", "w_gate", "w_down")])

    def run(batch, on_mesh: bool):
        ctx = use_mesh(mesh, process_wide=True) if on_mesh else \
            contextlib.nullcontext()
        torch.cuda.reset_peak_memory_stats()
        with deterministic(torch, True), ctx:
            with torch.no_grad(), moe_mod.record_dispatch() as log:
                loss_fn(params, batch, cfg)
            loss, met, grads = value_and_grad(params, batch, cfg)
            norms = expert_norms(grads)
            del grads
            if on_mesh:        # an expert's mean gradient: any rank's
                coll.all_reduce_(norms, ("data",))
            torch.cuda.synchronize()
        # numpy, not tensors: a rank's tensors cannot outlive its process
        calls = [{k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                  for k, v in c.items()} for c in log]
        return {"loss": float(loss), "nll": float(met["nll"]),
                "aux": float(met["aux"]), "calls": calls,
                "moved": ((norms > 0).all(0)).cpu().numpy(),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    data = SyntheticLMData(cfg, DS_TRAIN_B, DS_TRAIN_S, device=dev,
                           shard=batch_shard(mesh), shards=world)
    mine = run(data.batch_at(0), True)
    every = dp_objects(mine, world)
    res = {"ranks": every}
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        full = SyntheticLMData(cfg, DS_TRAIN_B, DS_TRAIN_S, device=dev)
        res["one"] = run(full.batch_at(0), False)
        # the global dispatch over the ranks' own routing, in one group
        choice = torch.from_numpy(np.concatenate(
            [r["calls"][0]["choice"] for r in every]))
        N = choice.shape[0]
        gates = torch.full(choice.shape, 1.0 / cfg.moe_top_k)
        _, slot_token, _ = moe_mod._dispatch_combine(
            torch.zeros((N, 1)), gates, choice, every[0]["calls"][0][
                "capacity"], cfg)
        full_slots = (slot_token < N).nonzero()[:, 0]
        res["regrouped"] = set(zip(
            slot_token[full_slots].long().tolist(),
            (full_slots // every[0]["calls"][0]["capacity"]).tolist()))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_dp_rank(rank: int, world: int) -> dict:
    """One rank of the [train-dp] checks (gloo, CUDA tensors): the dense
    hold and the MoE dispatch, and this process's kernel launches."""
    import numpy as np
    import torch
    from repro_torch.parallel.mesh import make_host_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(world)
    dense = dp_dense_check(torch, rank, world, mesh, dev)
    moe = dp_moe_check(torch, np, rank, world, mesh, dev)
    return {"dense": dense, "moe": moe, "backend": mesh.backend,
            "launches": dp_objects(sum(kernel_launch_counts().values()),
                                   world)}


def dp_nccl_one(rank: int, world: int) -> dict:
    """The data-parallel step on an NCCL world of one (the ``data`` axis a
    group of one, so every reduce is issued) against the undistributed
    step: qwen3-0.6b (GLOO_LAYERS layers), one step from the same state
    and batch under
    deterministic algorithms."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.roofline.op_collectives import CollectiveWalk
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.train import (OptConfig, SyntheticLMData, TrainConfig,
                                   make_initial_state, make_train_step)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh(("data", "model"), (1, 1), 0, {"data": dist.group.WORLD},
                dist.get_backend())
    cfg = gloo_qwen()
    tc = TrainConfig(opt=OptConfig(lr=TRAIN_LR, warmup_steps=0,
                                   total_steps=DP_STEPS))
    batch = SyntheticLMData(cfg, DP_NCCL_B, DP_NCCL_S,
                            device=dev).batch_at(0)
    with deterministic(torch, True):
        state = make_initial_state(cfg, 0, dev)()
        plain, pm = make_train_step(cfg, tc)(state, batch)
        with CollectiveWalk(mesh=mesh) as walk:
            dp, dm = make_train_step(cfg, tc, mesh)(state, batch)
        torch.cuda.synchronize()
    same = leaves_equal(torch, plain, dp) and all(
        torch.equal(pm[k], dm[k]) for k in ("loss", "grad_norm"))
    return {"equal": same, "loss": float(dm["loss"]),
            "ops": len(walk.ops), "sizes": sorted({o.group_size
                                                   for o in walk.ops}),
            "axes": sorted({o.axis for o in walk.ops}),
            "backend": dist.get_backend(),
            "launches": sum(kernel_launch_counts().values())}


def dp_cli_run(torch, np, card, tmp: str) -> dict:
    """Part 1: launch/train.py --data 2 on the one card (two gloo ranks),
    then the data-2 checkpoint of step DP_CKPT restored here at data 1:
    its leaves equal the file's, and step DP_CKPT + 1 from it (one rank,
    grad_accum 2: the ranks' rows a microbatch each) gives the data-2
    run's loss at that step bit for bit."""
    import os
    from repro_torch.launch import train as train_cli
    from repro_torch.models.params import tree_paths
    from repro_torch.train import (CheckpointManager, OptConfig,
                                   SyntheticLMData, TrainConfig,
                                   make_train_step)
    from repro_torch.train.loop import abstract_state
    cfg = gloo_qwen()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        out = train_cli.main([
            "--arch", cfg.name, "--layers", str(GLOO_LAYERS), "--data", "2",
            "--steps", str(DP_STEPS),
            "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--lr",
            str(TRAIN_LR), "--ckpt-dir", tmp, "--ckpt-every",
            str(DP_CKPT)])
    except RuntimeError as e:
        fail(f"[train-dp] launch/train.py --data 2: {e}")
    wall = time.perf_counter() - t0
    hist = out["history"]
    if [h["step"] for h in hist] != list(range(1, DP_STEPS + 1)) or \
            out["backend"] != "gloo":
        fail(f"[train-dp] history {hist}, backend {out['backend']}")
    losses = [h["loss"] for h in hist]
    one_moments = 8 * sum(t.numel() for _, t in tree_paths(
        abstract_state(cfg)["params"]))
    mb = out["moment_bytes"]
    if not all(abs(m - one_moments / 2) <= 1e-6 * one_moments for m in mb):
        fail(f"[train-dp] moments a rank {mb} B, want half of "
             f"{one_moments} B")
    by_axis = out["collectives"]
    print(f"[train-dp] launch/train.py --data 2, qwen3-0.6b at "
          f"{cfg.n_layers} layers (full width, bf16, "
          f"remat full), global B {TRAIN_B} x S {TRAIN_S} as {TRAIN_B // 2}"
          f" rows a rank, {DP_STEPS} steps, two gloo ranks on one card "
          f"({card}): loss by step "
          f"{', '.join(f'{x:.6f}' for x in losses)}; step dt "
          f"{', '.join(f'{h['dt'] * 1e3:.1f}' for h in hist)} ms (two "
          f"processes time-slice one card and reduce through gloo's host "
          f"copies: this says nothing of data-parallel speed on two cards); "
          f"moments a rank {[round(m / 1e9, 3) for m in mb]} GB = half of "
          f"one rank's {one_moments / 1e9:.3f} GB; peak a rank "
          f"{[round((p or 0) / 1e9, 2) for p in out['peak_bytes']]} GB; "
          f"pre-flight"
          f" collectives a rank {', '.join(f'{k} {v / 1e9:.3f} GB' for k, v in by_axis.items())}"
          f"; wall {wall:.1f} s")
    mgr = CheckpointManager(os.path.join(tmp, cfg.name))
    if sorted(mgr.all_steps()) != [DP_CKPT, DP_STEPS]:
        fail(f"[train-dp] checkpoints {mgr.all_steps()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, manifest = mgr.restore(abstract_state(cfg), DP_CKPT,
                                  device="cuda")
    t_restore = time.perf_counter() - t0
    with np.load(os.path.join(mgr.step_dir(DP_CKPT), "arrays.npz")) as f:
        for k, v in tree_paths(state):
            want = torch.from_numpy(f[k])
            got = v.cpu()
            if got.dtype == torch.bfloat16:
                got = got.view(torch.int16)
            if not torch.equal(got, want):
                fail(f"[train-dp] restored {k} differs from the file")
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=min(20, DP_STEPS // 5),
                    total_steps=DP_STEPS)
    step = make_train_step(cfg, TrainConfig(opt=opt, grad_accum=2))
    batch = SyntheticLMData(cfg, TRAIN_B, TRAIN_S,
                            device="cuda").batch_at(DP_CKPT)
    _, m = step(state, batch)
    resumed = float(m["loss"])
    if resumed != losses[DP_CKPT]:
        fail(f"[train-dp] step {DP_CKPT + 1} resumed at data 1: loss "
             f"{resumed!r} vs the data-2 run's {losses[DP_CKPT]!r}")
    print(f"[train-dp] the data-2 checkpoint of step {DP_CKPT} restored at"
          f" data 1 ({manifest['step']}; {t_restore:.2f} s, warm page "
          f"cache): every leaf equals the file bit for bit, moments whole; "
          f"step {DP_CKPT + 1} from it (one rank, grad_accum 2) loss "
          f"{resumed:.9f} = the data-2 run's bit for bit")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_dp_phase(torch, np, card, four) -> None:
    """The [train-dp] phase: launch/train.py --data 2, the restore at data
    1, the dense and MoE holds on two gloo ranks, the NCCL world of one
    beside them.  ``four``, [train-tp]'s (data 2, model 2) ranks started
    beside the launch/train.py run, is waited for before the holds' ranks
    start (the card's memory holds the two, not three).  No ported kernel
    launches here or in a rank."""
    import concurrent.futures
    import signal
    import tempfile
    from repro_torch.parallel.mesh import spawn
    before = kernel_launch_counts()
    prev = signal.getsignal(signal.SIGTERM)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
            dp_cli_run(torch, np, card, tmp)
    finally:
        signal.signal(signal.SIGTERM, prev)
    torch.cuda.empty_cache()
    concurrent.futures.wait([four])
    # the NCCL world of one (one small process) runs beside the ranks
    nccl = beside(spawn, dp_nccl_one, 1, backend="nccl", device="cuda",
                  timeout=600)
    try:
        ranks = spawn(train_dp_rank, 2, backend="gloo", device="cuda",
                      timeout=900)
    except RuntimeError as e:
        fail(f"[train-dp] a rank failed: {e}")
    dense = ranks["dense"]
    if not all(dense["equal"]):
        fail(f"[train-dp] parameters differ across ranks: {dense['equal']}")
    l_dp, l_one = dense["loss"]
    worst, key, n_diff, lr = dense["params"]
    print(f"[train-dp] qwen3-0.6b data 2 vs one rank at grad_accum 2, step "
          f"1 from one state ({card}): loss {l_dp:.9f} vs {l_one:.9f} "
          f"({'equal bit for bit' if l_dp == l_one else 'DIFFERENT'}); "
          f"parameters within {worst:.3f} of their tolerance at worst "
          f"({key}; one bf16 ulp + lr {lr:.3e} x 2^-7, the reduce's dtype "
          f"bf16), {n_diff} elements not bit-equal; parameter digests equal"
          f" on both ranks after steps 1-2")
    if l_dp != l_one or worst > 1.0:
        fail("[train-dp] data 2 misses the one-rank accumulated step")
    print(f"[train-dp] qwen3-0.6b data 2 step 2 (deterministic "
          f"algorithms): {dense['step_ms']:.1f} ms, its collectives "
          f"{dense['edge_ms']:.1f} ms ({dense['ops']}; walked a rank "
          f"{', '.join(f'{k} {v / 1e9:.3f} GB' for k, v in dense['by_axes'].items())}"
          f"), against one rank's grad_accum 2 step "
          f"{dense['one_step_ms']:.1f} ms on the same 4 rows (two "
          f"processes on one card, gloo through host memory)")
    moe = ranks["moe"]
    one, per = moe["one"], moe["ranks"]
    calls = [r["calls"][0] for r in per]
    got = set()
    for c in calls:
        got |= set(zip(c["token"].tolist(), c["expert"].tolist()))
    n_kept = sum(len(c["token"]) for c in calls)
    want = set(zip(one["calls"][0]["token"].tolist(),
                   one["calls"][0]["expert"].tolist()))
    routing = np.concatenate([c["choice"] for c in calls])
    diff = (routing != one["calls"][0]["choice"]).any(1)
    n_flip = int(diff.sum())
    touched = set(routing[diff].flatten().tolist()) | set(
        one["calls"][0]["choice"][diff].flatten().tolist())
    off = {e for _, e in got ^ want}
    moved = per[0]["moved"]
    same_moved = bool((moved == one["moved"]).all())
    if n_kept != len(got) or got != moe["regrouped"]:
        fail("[train-dp] deepseek-v2: the ranks' kept pairs are not the "
             "global dispatch of their routing")
    if n_flip == 0 and (got != want or not same_moved):
        fail("[train-dp] deepseek-v2: data 2 keeps other pairs or moves "
             "other experts than one rank on the same routing")
    if not off <= touched or not set(
            np.nonzero(moved != one["moved"])[0].tolist()) <= touched:
        fail(f"[train-dp] deepseek-v2: pairs differ outside the experts "
             f"of the {n_flip} tokens routed differently")
    rel = {k: abs(per[0][k] - one[k]) / abs(one[k])
           for k in ("loss", "aux")}
    print(f"[train-dp] deepseek-v2-236b ({DS_TRAIN_LAYERS} layers), global "
          f"dispatch, B {DS_TRAIN_B} x S {DS_TRAIN_S} as one row a rank, "
          f"data 2 vs one rank ({card}): kept {n_kept} pairs (capacity "
          f"{calls[0]['capacity']}) = the global dispatch of the ranks' "
          f"routing; one rank kept {len(want)}, sets "
          f"{'equal' if got == want else f'differ in {len(got ^ want)}'}; "
          f"{n_flip} of {routing.shape[0]} tokens routed differently "
          f"(bf16 GEMMs over 1024 vs 2048 rows); loss {per[0]['loss']:.6f}"
          f" vs {one['loss']:.6f}, aux {per[0]['aux']:.6f} vs "
          f"{one['aux']:.6f} (rel {rel['loss']:.2e}, {rel['aux']:.2e}; tol "
          f"{ACCUM_LOSS_RTOL:.2e}); experts with nonzero gradients "
          f"{int(moved.sum())} vs {int(one['moved'].sum())}"
          f"{' (the same)' if same_moved else ''}; "
          f"peak a rank {[round(r['peak_gb'], 2) for r in per]} GB, one "
          f"rank {one['peak_gb']:.2f} GB")
    if max(rel.values()) > ACCUM_LOSS_RTOL:
        fail("[train-dp] deepseek-v2: loss or aux off the one-rank run's")
    try:
        nccl = nccl.result()
    except RuntimeError as e:
        fail(f"[train-dp] NCCL world of one failed: {e}")
    if not nccl["equal"] or nccl["sizes"] != [1] or nccl["axes"] != [
            "data"] or not nccl["ops"]:
        fail(f"[train-dp] NCCL world of one: {nccl}")
    print(f"[train-dp] NCCL world of one ({card}): the data-parallel step "
          f"(qwen3-0.6b, B {DP_NCCL_B} x S {DP_NCCL_S}) issued "
          f"{nccl['ops']} collectives on the data group of one and equals "
          f"the undistributed step bit for bit (loss {nccl['loss']:.6f}, "
          f"parameters, moments); NCCL data 2 needs two cards")
    after = kernel_launch_counts()
    moved_k = {k: after[k] - before[k] for k in after
               if after[k] != before[k]}
    in_ranks = ranks["launches"] + [nccl["launches"]]
    if moved_k or any(in_ranks) or len(after) < 14:
        fail(f"[train-dp] ported kernels launched: {moved_k}, ranks "
             f"{in_ranks}")
    print(f"[train-dp] no ported kernel launched ({len(after)} wrappers' "
          "counts unchanged here, 0 in every rank)")


# --------------------------------------------------------------------------
# q. tensor-parallel training ([train-tp] lines): gloo ranks on the one card
# --------------------------------------------------------------------------

# qwen3-0.6b (GLOO_LAYERS layers) at (data 1, model 2): B 4 x S 1024, 3
# steps, the checkpoint of step 2
TP_TRAIN_B, TP_TRAIN_S, TP_TRAIN_STEPS, TP_TRAIN_CKPT = 4, 1024, 3, 2
# qwen3-0.6b (GLOO_LAYERS layers) at (data 2, model 2): B 4 x S 512, 2
# steps
TP22_B, TP22_S, TP22_STEPS = 4, 512, 2
# The loss, model 2 against one rank on the same rows and weights.  The
# forward differs at the row-parallel edges only (the embedding's sum adds
# zeros, exact): each rounds the two ranks' bf16 partial products before
# their sum and the sum once more, where one card rounds the whole
# product once: TP_LOGITS_ATOL's derivation, ~0.41 x 2^-8 of the value an
# edge, a random walk over the edges.  qwen3-0.6b has 2 a layer (56
# whole, 8 at GLOO_LAYERS), fewer than the 80 that bar was derived for:
# the final hidden state's
# logits move by less than TP_LOGITS_ATOL.  A token's NLL, lse(z) - z_y,
# moves by at most a = 2 x TP_LOGITS_ATOL, and its move is a sum of
# round-to-nearest errors, zero in mean (lse's curvature adds a bias of
# the order of the logits' squared error, ~1e-4 x a).  The tokens' errors
# come from their own elements' roundings, independent of each other, so
# Hoeffding's inequality bounds their mean, the loss, by
# a sqrt(2 ln(2 / p) / N) but with probability p = TP_LOSS_P:
# tp_loss_bar(N), 5.05e-3 at N = 4096 tokens.  Step 3 from the tp run's
# checkpoint on one rank against the tp run's step 3 (a loss after two
# updates, the logits no longer near uniform) takes the same bar.
TP_LOSS_P = 1e-6
# The global gradient norm: the backward's tp_copy sums add as many bf16
# roundings again, summed over 2e8 squares or more: the relative bar the
# [train] phase takes for bf16 gradients summed in another order
# (ACCUM_GNORM_RTOL)
TP_GNORM_RTOL = ACCUM_GNORM_RTOL
# Each gradient leaf, model 2 gathered whole against one rank's (step 1's
# state and rows): |g_tp - g_one| / |g_one| (Frobenius).  A leaf's
# gradient sums products of forward activations and backward cotangents,
# each carrying the edges' roundings between it and the ends of the
# network: at most the 56 forward reduces and the 56 backward copies of
# the whole model (8 and 8 at GLOO_LAYERS) at ~0.41 x 2^-8 each, a random
# walk of at most sqrt(112) x 0.41 x 2^-8 = 2^-5.9 relative, element by
# element, and so for the leaf's norm.  The bar is
# four times that, 2^-4: the walk's steps are not independent (a layer's
# error feeds the next) and the nonlinearities' gains (softmax, SiLU,
# the norms) reach 2.  A missing tp_copy leaves a partial gradient, a
# doubled one a gradient twice its size: errors of 1/2 to 1.
TP_GRAD_RTOL = 2.0 ** -4
# A parameter after step 1: AdamW's first update is lr g s / (|g s| +
# eps) (+ the decay, the same on both), at most lr in size whatever g's
# error, so two runs part by at most one bf16 ulp (the rounding of the
# float32 result) + 2 lr.  Where both runs' g s have one sign and reach
# 2^7 eps, the updates part by at most lr eps / |g s| <= lr x 2^-7
# (DP_LR_SHARE), and the parameters by one ulp more: every element beyond
# that must be one whose gradient's sign differs between the runs (the
# measured gradients say which) or whose |g s| is below 2^7 eps.
TP_PARAM_LR = 2.0
TP_NEAR_EPS = 2.0 ** 7
# deepseek-v2 (2 layers) at model 2 against one rank: loss and aux
TP_MOE_RTOL = 2.0 ** -8


def tp_loss_bar(n_tokens: int) -> float:
    """The bar of a tp run's loss against one rank's over ``n_tokens``
    tokens (TP_LOSS_P's derivation)."""
    return 2 * TP_LOGITS_ATOL * math.sqrt(2 * math.log(2 / TP_LOSS_P)
                                          / n_tokens)


def tp_whole(torch, state, cfg, mesh) -> dict:
    """Every parameter leaf whole on every rank (the blocks all-gathered
    over ``model``)."""
    from repro_torch.models.params import tree_paths
    from repro_torch.parallel.mesh import use_mesh
    from repro_torch.train.loop import state_shards
    sh = dict(tree_paths(state_shards(cfg, mesh)))
    with use_mesh(mesh):
        return {k: v if sh[f"params/{k}"] is None else
                sh[f"params/{k}"].gather(v)
                for k, v in tree_paths(state["params"])}


def tp_replicated_equal(torch, state, cfg, mesh, world: int) -> bool:
    """Whether every rank's copy of each leaf the mesh replicates is the
    same bits (digests gathered over the world)."""
    from repro_torch.models.params import tree_paths
    from repro_torch.train.loop import state_shards
    sh = dict(tree_paths(state_shards(cfg, mesh)))
    dig = {k: digest(torch, v) for k, v in tree_paths(state)
           if sh[k] is None}
    return all(d == dig for d in dp_objects(dig, world))


def tp_walk(torch, cfg, mesh, tcfg, B: int, S: int) -> dict:
    """This rank's pre-flight walk (fake tensors) of the mesh step: the
    walked bytes by axis and by edge, and the analytic counts."""
    from repro_torch.core.analysis import analyze_step
    from repro_torch.launch import specs as tspecs
    from repro_torch.models.common import ShapeCell
    from repro_torch.train import make_train_step
    from repro_torch.train.step import dp_wire_bytes, tp_wire_bytes
    args, _, _ = tspecs.train_specs(cfg, ShapeCell("t", S, B, "train"),
                                    mesh)
    t0 = time.perf_counter()
    rep = analyze_step(make_train_step(cfg, tcfg, mesh), args=args,
                       mesh=mesh)
    c = rep.character.collectives
    return {"axes": {k[0]: v for k, v in c.by_axes.items()},
            "edges": dict(c.by_edge), "s": time.perf_counter() - t0,
            "tp": tp_wire_bytes(cfg, mesh.sizes, B, S, tcfg),
            "dp": dp_wire_bytes(cfg, mesh.sizes, tcfg)}


def tp_whole_grads(torch, state, batch, cfg, mesh) -> dict:
    """loss_fn's gradient at ``state``'s parameters on ``batch``, the
    mesh step's (the rank's local config, its blocks all-gathered whole
    over ``model``; a collective), by leaf key."""
    from repro_torch.models import drop_cast
    from repro_torch.models.params import tree_paths
    from repro_torch.parallel.mesh import use_mesh
    from repro_torch.train.loop import state_shards
    from repro_torch.train.step import train_local_config, value_and_grad
    sh = dict(tree_paths(state_shards(cfg, mesh)))
    with use_mesh(mesh, process_wide=True):
        _, _, grads = value_and_grad(drop_cast(state["params"]), batch,
                                     train_local_config(cfg, mesh))
        return {k: g if sh[f"params/{k}"] is None else
                sh[f"params/{k}"].gather(g)
                for k, g in tree_paths(grads)}


def tp_grad_hold(torch, got: dict, want: dict) -> tuple:
    """(worst leaf's |g_tp - g_one| / |g_one|, its leaf, the median
    leaf's, elements whose gradient's sign differs)."""
    rel, flips = {}, 0
    for k, b in want.items():
        a, b = got[k].float(), b.float()
        n = float(torch.linalg.vector_norm(b))
        e = float(torch.linalg.vector_norm(a - b))
        rel[k] = e / n if n > 0 else (0.0 if e == 0 else math.inf)
        flips += int((torch.sign(a) != torch.sign(b)).sum())
    key = max(rel, key=rel.get)
    return rel[key], key, sorted(rel.values())[len(rel) // 2], flips


def tp_param_hold(torch, got: dict, want: dict, g_got: dict, g_want: dict,
                  scale: float, lr: float, eps: float) -> tuple:
    """(worst share of the TP_PARAM_LR bar, its leaf, share of elements
    beyond one ulp + lr x DP_LR_SHARE, elements compared, elements beyond
    it whose gradients keep their sign and reach TP_NEAR_EPS x eps after
    the clip's ``scale``: none may)."""
    worst, key, beyond, n, unexplained = 0.0, "", 0, 0, 0
    for k, b in want.items():
        a = got[k]
        d = (a.float() - b.float()).abs()
        ulp = dp_ulp(torch, torch.maximum(a.float().abs(),
                                          b.float().abs()).to(b.dtype))
        r = float((d / (ulp + lr * TP_PARAM_LR)).max())
        far = d > ulp + lr * DP_LR_SHARE
        beyond += int(far.sum())
        ga, gb = g_got[k].float(), g_want[k].float()
        flip = (torch.sign(ga) != torch.sign(gb)) | (
            torch.minimum(ga.abs(), gb.abs()) * scale <= TP_NEAR_EPS * eps)
        unexplained += int((far & ~flip).sum())
        n += d.numel()
        if r > worst:
            worst, key = r, k
    return worst, key, beyond / n, n, unexplained


def tp_pairs(np, c_tp: dict, c_one: dict) -> tuple:
    """(the tp run's kept (token, expert) pairs, one rank's, a mask of the
    tokens whose top-k set differs, the experts those tokens chose in
    either run) of one recorded MoE call."""
    got = set(zip(c_tp["token"].tolist(), c_tp["expert"].tolist()))
    want = set(zip(c_one["token"].tolist(), c_one["expert"].tolist()))
    diff = (np.sort(c_tp["choice"], 1) != np.sort(c_one["choice"], 1)
            ).any(1)
    touched = set(c_tp["choice"][diff].flatten().tolist()) | set(
        c_one["choice"][diff].flatten().tolist())
    return got, want, diff, touched


def tp_qwen12(torch, rank: int, world: int, mesh, dev, tmp: str) -> dict:
    """qwen3-0.6b (GLOO_LAYERS layers) at (data 1, model 2), bf16, remat
    full, under
    deterministic algorithms: step 1's gradients (gathered whole), step 1
    (the whole parameters kept), step 2 timed with its collectives, the
    checkpoint of step 2 (collective, rank 0 writes), step 3; this rank's
    walk; then, on rank 0 alone, one rank's gradients and step 1 from the
    same state on the same rows, and the checkpoint restored at (1, 1)
    and stepped."""
    import os
    import numpy as np
    from repro_torch.core.roofline.op_collectives import (CollectiveWalk,
                                                          summarize)
    from repro_torch.models import drop_cast
    from repro_torch.models.params import tree_paths
    from repro_torch.parallel.mesh import batch_shard, batch_shards
    from repro_torch.train import (CheckpointManager, OptConfig,
                                   SyntheticLMData, TrainConfig,
                                   make_initial_state, make_train_step)
    from repro_torch.train.loop import abstract_state, state_shards
    from repro_torch.train.step import value_and_grad
    import torch.distributed as dist
    cfg = gloo_qwen()
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=TP_TRAIN_STEPS)
    tc = TrainConfig(opt=opt)
    data = SyntheticLMData(cfg, TP_TRAIN_B, TP_TRAIN_S, device=dev,
                           shard=batch_shard(mesh), shards=batch_shards(mesh))
    ckdir = os.path.join(tmp, "qwen12")
    mgr = CheckpointManager(ckdir, mesh=mesh, shards=state_shards(cfg, mesh))
    step = make_train_step(cfg, tc, mesh)
    res = {"losses": []}
    torch.cuda.reset_peak_memory_stats()
    with deterministic(torch, True):
        state = make_initial_state(cfg, 0, dev, mesh=mesh)()
        res["moment_bytes"] = sum(t.numel() * t.element_size() for _, t in
                                  tree_paths(state["opt"]))
        g_tp = tp_whole_grads(torch, state, data.batch_at(0), cfg, mesh)
        if rank != 0:
            g_tp = None
        for i in range(TP_TRAIN_STEPS):
            batch = data.batch_at(i)
            walk = CollectiveWalk(timed=True, mesh=mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with walk:
                state, m = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            res["losses"].append(float(m["loss"]))
            if i == 0:
                res["gnorm"] = float(m["grad_norm"])
                res["lr"] = float(m["lr"])
                whole = tp_whole(torch, state, cfg, mesh)  # collective
                first = whole if rank == 0 else None
                del whole
            if i == 1:
                res["step_ms"], res["edge_ms"] = ms, walk.edge_ms()
                cc = summarize(walk.ops)
                res["ops"] = dict(cc.ops_by_kind)
                res["walked"] = {k[0]: v for k, v in cc.by_axes.items()}
                res["walked_edges"] = dict(cc.by_edge)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mgr.save(state, TP_TRAIN_CKPT)
                res["save_s"] = time.perf_counter() - t0
        res["equal"] = tp_replicated_equal(torch, state, cfg, mesh, world)
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    res["walk"] = tp_walk(torch, cfg, mesh, tc, TP_TRAIN_B, TP_TRAIN_S)
    dist.barrier()
    if rank == 0:
        one = make_train_step(cfg, tc)
        full = SyntheticLMData(cfg, TP_TRAIN_B, TP_TRAIN_S, device=dev)
        with deterministic(torch, True):
            state = make_initial_state(cfg, 0, dev)()
            _, _, g_one = value_and_grad(drop_cast(state["params"]),
                                         full.batch_at(0), cfg)
            g_one = dict(tree_paths(g_one))
            new, m = one(state, full.batch_at(0))
            res["one"] = {"loss": float(m["loss"]),
                          "gnorm": float(m["grad_norm"])}
            res["grads"] = tp_grad_hold(torch, g_tp, g_one)
            scale = min(1.0, opt.clip_norm / max(res["gnorm"],
                                                 res["one"]["gnorm"]))
            res["params"] = tp_param_hold(
                torch, first, dict(tree_paths(new["params"])), g_tp, g_one,
                scale, res["lr"], opt.eps)
            del state, new, first, g_tp, g_one
            gc.collect()
            torch.cuda.empty_cache()
            plain = CheckpointManager(ckdir)
            t0 = time.perf_counter()
            state, manifest = plain.restore(abstract_state(cfg),
                                            TP_TRAIN_CKPT, device=dev)
            res["restore_s"] = time.perf_counter() - t0
            with np.load(os.path.join(plain.step_dir(TP_TRAIN_CKPT),
                                      "arrays.npz")) as f:
                res["restored_equal"] = all(np.array_equal(
                    (v.cpu().view(torch.int16) if v.dtype == torch.bfloat16
                     else v.cpu()).numpy(), f[k])
                    for k, v in tree_paths(state))
            _, m = one(state, full.batch_at(TP_TRAIN_CKPT))
            res["resumed"] = float(m["loss"])
            del state
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def tp_qwen22(torch, rank: int, world: int, mesh, dev) -> dict:
    """qwen3-0.6b (GLOO_LAYERS layers) at (data 2, model 2), B 4 x S 512, 2
    steps: each
    rank's moment blocks against one rank's whole moments, the losses,
    its walk; rank 0 then runs one rank's step 1 on the 4 rows."""
    from repro_torch.models.params import tree_paths
    from repro_torch.parallel.mesh import batch_shard, batch_shards
    from repro_torch.train import (OptConfig, SyntheticLMData, TrainConfig,
                                   make_initial_state, make_train_step)
    from repro_torch.train.loop import abstract_state, state_shards
    import torch.distributed as dist
    cfg = gloo_qwen()
    tc = TrainConfig(opt=OptConfig(lr=TRAIN_LR, warmup_steps=0,
                                   total_steps=TP22_STEPS))
    data = SyntheticLMData(cfg, TP22_B, TP22_S, device=dev,
                           shard=batch_shard(mesh), shards=batch_shards(mesh))
    step = make_train_step(cfg, tc, mesh)
    whole = {k: v.numel() for k, v in tree_paths(abstract_state(cfg)["opt"])}
    sh = dict(tree_paths(state_shards(cfg, mesh)))
    res = {"losses": []}
    torch.cuda.reset_peak_memory_stats()
    with deterministic(torch, True):
        state = make_initial_state(cfg, 0, dev, mesh=mesh)()
        mine = dict(tree_paths(state["opt"]))
        both = [k for k, b in sh.items() if k.startswith("opt/mu/")
                and b is not None and {p[1] for p in b.pieces} == {
                    "data", "model"}]
        res["quarter"] = (len(both), all(
            mine[k[4:]].numel() * 4 == whole[k[4:]] for k in both))
        res["moment_bytes"] = sum(t.numel() * t.element_size()
                                  for t in mine.values())
        res["one_moment_bytes"] = sum(
            n * 4 for k, n in whole.items() if k != "step")
        for i in range(TP22_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, data.batch_at(i))
            torch.cuda.synchronize()
            res["losses"].append(float(m["loss"]))
            res["step_ms"] = (time.perf_counter() - t0) * 1e3
        res["equal"] = tp_replicated_equal(torch, state, cfg, mesh, world)
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, m, mine
    gc.collect()
    torch.cuda.empty_cache()
    res["walk"] = tp_walk(torch, cfg, mesh, tc, TP22_B, TP22_S)
    dist.barrier()
    if rank == 0:
        full = SyntheticLMData(cfg, TP22_B, TP22_S, device=dev)
        with deterministic(torch, True):
            state = make_initial_state(cfg, 0, dev)()
            _, m = make_train_step(cfg, tc)(state, full.batch_at(0))
            res["one_loss"] = float(m["loss"])
            del state
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def tp_deepseek(torch, rank: int, world: int, mesh, dev) -> dict:
    """deepseek-v2 at 2 layers (the dense prologue, one MoE layer of 160
    experts), global dispatch, model 2, B 2 x S 1024 (every rank all the
    rows) under deterministic algorithms: this rank's local experts and
    heads, a forward's kept pairs and router probabilities, loss_fn's
    value and gradient; rank 0 then runs one rank on the same weights and
    rows.  Then the float32 witness: the same forward at model 2 and on
    one rank with the weights in float32 (TF32 off), its kept pairs."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, loss_fn, param_shardings
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.params import tree_leaves
    from repro_torch.parallel.mesh import use_mesh
    from repro_torch.train import SyntheticLMData
    from repro_torch.train.step import train_local_config, value_and_grad
    import torch.distributed as dist
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              n_layers=DS_TRAIN_LAYERS)
    batch = SyntheticLMData(cfg, DS_TRAIN_B, DS_TRAIN_S,
                            device=dev).batch_at(0)
    inner = moe_mod.moe_ffn

    def run(params, c, on_mesh: bool, grad: bool = True):
        ctx = use_mesh(mesh, process_wide=True) if on_mesh else \
            contextlib.nullcontext()
        probs = []

        def spy(p, x, c_):       # the router's probabilities, as moe_ffn's
            probs.append(torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                       @ p["router"], -1).cpu().numpy())
            return inner(p, x, c_)

        torch.cuda.reset_peak_memory_stats()
        out = {}
        with deterministic(torch, True), ctx:
            moe_mod.moe_ffn = spy
            try:
                with torch.no_grad(), moe_mod.record_dispatch() as log:
                    loss, met = loss_fn(params, batch, c)
            finally:
                moe_mod.moe_ffn = inner
            if grad:
                loss, met, grads = value_and_grad(params, batch, c)
                out["finite"] = all(bool(torch.isfinite(g).all())
                                    for g in tree_leaves(grads))
                del grads
            torch.cuda.synchronize()
        return {"loss": float(loss), "nll": float(met["nll"]),
                "aux": float(met["aux"]), "probs": probs, **out,
                "calls": [{k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                           for k, v in c_.items()} for c_ in log],
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, specs=param_shardings(cfg, mesh), mesh=mesh)
    ffn = params["segments"][1]["b0"]["ffn"]
    mla = params["segments"][1]["b0"]["mixer"]
    res = {"experts": ffn["w_up"].shape[1], "heads": mla["wq_b"].shape[2],
           "shared_ff": ffn["shared"]["w_up"].shape[-1]}
    res["tp"] = run(params, train_local_config(cfg, mesh), True)
    del params, ffn, mla
    gc.collect()
    torch.cuda.empty_cache()
    res["ranks"] = dp_objects([c["token"] for c in res["tp"]["calls"]],
                              world)
    dist.barrier()
    if rank == 0:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        res["one"] = run(params, cfg, False)
        del params
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    # the float32 witness: the row-parallel sums' order changes the
    # router's inputs by ~2^-24 relative, below every token's top-6 margin
    c32 = dataclasses.replace(cfg, dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        params = init_params(c32, torch.Generator(device=dev).manual_seed(0),
                             dev, specs=param_shardings(c32, mesh),
                             mesh=mesh)
        res["tp32"] = run(params, train_local_config(c32, mesh), True,
                          grad=False)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            params = init_params(c32, torch.Generator(
                device=dev).manual_seed(0), dev)
            res["one32"] = run(params, c32, False, grad=False)
            del params
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def train_tp2_rank(rank: int, world: int, tmp: str) -> dict:
    """One of the two ranks of [train-tp]'s (data 1, model 2) checks
    (gloo, CUDA tensors): qwen3-0.6b (GLOO_LAYERS layers), deepseek-v2
    (2 layers), and
    this process's kernel launches."""
    import torch
    from repro_torch.parallel.mesh import make_host_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(model=world)
    qwen = tp_qwen12(torch, rank, world, mesh, dev, tmp)
    moe = tp_deepseek(torch, rank, world, mesh, dev)
    return {"qwen": qwen, "moe": moe, "backend": mesh.backend,
            "every": dp_objects({k: qwen[k] for k in (
                "moment_bytes", "peak_gb", "step_ms", "edge_ms", "walk",
                "equal", "losses")}, world),
            "launches": dp_objects(sum(kernel_launch_counts().values()),
                                   world)}


def train_tp4_rank(rank: int, world: int) -> dict:
    """One of the four ranks of [train-tp]'s (data 2, model 2) checks."""
    import torch
    from repro_torch.parallel.mesh import make_host_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(data=2, model=2)
    res = tp_qwen22(torch, rank, world, mesh, dev)
    return {"qwen": res, "every": dp_objects({k: res[k] for k in (
        "moment_bytes", "peak_gb", "step_ms", "walk", "quarter", "equal",
        "losses")}, world),
        "launches": dp_objects(sum(kernel_launch_counts().values()), world)}


def tp_walk_line(label: str, walks: list) -> float:
    """Print each rank's walked bytes against the analytic counts; returns
    the worst distance of a ratio from 1."""
    worst = 0.0
    parts = []
    for r, w in enumerate(walks):
        ratios = {"model": w["axes"].get("model", 0.0) / w["tp"]["model"]}
        if "data" in w["axes"] or w["dp"]["data"]:
            ratios["data"] = w["axes"].get("data", 0.0) / w["dp"]["data"]
        worst = max([worst] + [abs(x - 1) for x in ratios.values()])
        parts.append(f"rank {r}: " + ", ".join(
            f"{k} {w['axes'].get(k, 0.0) / 1e9:.4f} GB (ratio {v:.4f})"
            for k, v in ratios.items()) + f" [{w['s']:.1f} s]")
    edges = walks[0]["edges"]
    print(f"[train-tp] {label} pre-flight walk (fake tensors, each rank its "
          f"own step): {'; '.join(parts)}; rank 0's model bytes by edge "
          + ", ".join(f"{k} {v / 1e9:.4f} GB (analytic "
                      f"{walks[0]['tp'][k] / 1e9:.4f})"
                      for k, v in sorted(edges.items())))
    return worst


def train_tp_phase(torch, np, card, four) -> None:
    """The [train-tp] phase: qwen3-0.6b (GLOO_LAYERS layers) at (data 1,
    model 2) against one rank, its checkpoint at (1, 1); qwen3-0.6b at
    (data 2, model 2) (``four``: the Future of its ranks, started beside
    [train-dp]); deepseek-v2 (2 layers) at model 2 against one rank;
    every rank's pre-flight walk against the analytic counts.  Gloo ranks
    on this one card (NCCL at model > 1 needs a card a rank: unverified).
    No ported kernel launches here or in a rank."""
    import tempfile
    from repro_torch.parallel.mesh import spawn
    before = kernel_launch_counts()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        try:
            two = spawn(train_tp2_rank, 2, backend="gloo", device="cuda",
                        args=(tmp,), timeout=900)
        except RuntimeError as e:
            fail(f"[train-tp] a (1, 2) rank failed: {e}")
    q = two["qwen"]
    every = two["every"]
    if not all(e["equal"] for e in every) or any(
            e["losses"] != every[0]["losses"] for e in every):
        fail("[train-tp] qwen3-0.6b (1, 2): replicated leaves or losses "
             "differ across ranks")
    l_tp, l_one = q["losses"][0], q["one"]["loss"]
    bar12 = tp_loss_bar(TP_TRAIN_B * TP_TRAIN_S)
    g_rel = abs(q["gnorm"] - q["one"]["gnorm"]) / q["one"]["gnorm"]
    worst, key, share, n, unexplained = q["params"]
    g_worst, g_key, g_median, g_flips = q["grads"]
    print(f"[train-tp] qwen3-0.6b at {GLOO_LAYERS} layers (full width, "
          f"bf16, remat full), B {TP_TRAIN_B} "
          f"x S {TP_TRAIN_S}, (data 1, model 2) vs one rank, step 1 from "
          f"one state on the same rows ({card}): loss {l_tp:.6f} vs "
          f"{l_one:.6f} (|d| {abs(l_tp - l_one):.2e}, bar {bar12:.2e}); "
          f"grad norm {q['gnorm']:.6f} vs {q['one']['gnorm']:.6f} (rel "
          f"{g_rel:.2e}, bar {TP_GNORM_RTOL:.2e}); each gradient leaf "
          f"gathered whole within {g_worst:.3e} of one rank's at worst "
          f"({g_key}; median leaf {g_median:.3e}; bar {TP_GRAD_RTOL:.3e}), "
          f"{g_flips / n * 100:.3f}% of elements with the other sign; "
          f"parameters within {worst:.3f} of one bf16 ulp + {TP_PARAM_LR:g} "
          f"lr at worst ({key}), {share * 100:.3f}% of {n} elements beyond "
          f"one ulp + lr x 2^-7, {unexplained} of them with gradients of one "
          f"sign above {TP_NEAR_EPS:g} eps (bar 0); replicated leaves and "
          f"losses equal on both ranks")
    if abs(l_tp - l_one) > bar12 or g_rel > TP_GNORM_RTOL \
            or g_worst > TP_GRAD_RTOL or worst > 1.0 or unexplained:
        fail("[train-tp] qwen3-0.6b (1, 2) misses the one-rank step")
    print(f"[train-tp] qwen3-0.6b (1, 2) per rank (two gloo ranks time-slice "
          f"one card and reduce through host memory: no tp speed): losses "
          f"{', '.join(f'{x:.6f}' for x in q['losses'])}; "
          + "; ".join(f"rank {r}: moments {e['moment_bytes'] / 1e9:.3f} GB, "
                      f"peak {e['peak_gb']:.2f} GB, step 2 "
                      f"{e['step_ms']:.1f} ms, gloo edges {e['edge_ms']:.1f}"
                      f" ms" for r, e in enumerate(every))
          + f"; step 2's collectives {q['ops']}, walked model "
          f"{q['walked'].get('model', 0.0) / 1e9:.4f} GB")
    if not q["restored_equal"] or abs(q["resumed"] - q["losses"][
            TP_TRAIN_CKPT]) > bar12:
        fail(f"[train-tp] the (1, 2) checkpoint at (1, 1): restored equal "
             f"{q['restored_equal']}, step {TP_TRAIN_CKPT + 1} loss "
             f"{q['resumed']} vs {q['losses'][TP_TRAIN_CKPT]}")
    print(f"[train-tp] the (1, 2) checkpoint of step {TP_TRAIN_CKPT} (saved "
          f"in {q['save_s']:.2f} s, blocks gathered, rank 0 writes) restored "
          f"at (1, 1) in {q['restore_s']:.2f} s (warm page cache): every "
          f"leaf equals the file bit for bit; step {TP_TRAIN_CKPT + 1} from "
          f"it on one rank loss {q['resumed']:.6f} vs the tp run's "
          f"{q['losses'][TP_TRAIN_CKPT]:.6f} (|d| "
          f"{abs(q['resumed'] - q['losses'][TP_TRAIN_CKPT]):.2e}, bar "
          f"{bar12:.2e})")
    bad = tp_walk_line("qwen3-0.6b (1, 2)", [e["walk"] for e in every])
    try:
        four = four.result()    # started beside [train-dp]'s launch/train.py
    except RuntimeError as e:
        fail(f"[train-tp] a (2, 2) rank failed: {e}")
    f4 = four["every"]
    q4 = four["qwen"]
    n_both = f4[0]["quarter"][0]
    if not all(e["quarter"][1] and e["equal"] for e in f4) or n_both == 0:
        fail(f"[train-tp] (2, 2): moment blocks not a quarter or replicated "
             f"leaves differ: {[(e['quarter'], e['equal']) for e in f4]}")
    d4, bar22 = abs(q4["losses"][0] - q4["one_loss"]), tp_loss_bar(
        TP22_B * TP22_S)
    print(f"[train-tp] qwen3-0.6b (data 2, model 2), four gloo ranks, B "
          f"{TP22_B} x S {TP22_S}: step 1 loss {q4['losses'][0]:.6f} vs one "
          f"rank {q4['one_loss']:.6f} (|d| {d4:.2e}, bar {bar22:.2e}), step "
          f"2 {q4['losses'][1]:.6f}; ZeRO-1 on "
          f"model shards: the {n_both} moments both axes divide are a "
          f"quarter of one rank's on every rank; moments a rank "
          f"{[round(e['moment_bytes'] / 1e9, 3) for e in f4]} GB of one "
          f"rank's {q4['one_moment_bytes'] / 1e9:.3f} GB; peak a rank "
          f"{[round(e['peak_gb'], 2) for e in f4]} GB; step "
          f"{[round(e['step_ms'], 1) for e in f4]} ms")
    if d4 > bar22:
        fail("[train-tp] (2, 2) misses the one-rank loss")
    bad = max(bad, tp_walk_line("qwen3-0.6b (2, 2)",
                                [e["walk"] for e in f4]))
    if bad > 5e-5:
        fail(f"[train-tp] a walk's bytes part from the analytic count by "
             f"{bad:.2e}")
    moe = two["moe"]
    tp_, one = moe["tp"], moe["one"]
    if (moe["experts"], moe["heads"]) != (80, 64) or not tp_["finite"]:
        fail(f"[train-tp] deepseek-v2 model 2: {moe['experts']} experts, "
             f"{moe['heads']} heads a rank, finite {tp_['finite']}")
    ranks = moe["ranks"]
    if any(len(r) != len(ranks[0]) or any(not np.array_equal(a, b) for a, b
                                          in zip(r, ranks[0]))
           for r in ranks):
        fail("[train-tp] deepseek-v2: the model ranks keep different pairs")
    c_tp, c_one = tp_["calls"][0], one["calls"][0]
    got, want, flipped, touched = tp_pairs(np, c_tp, c_one)
    n_flip = int(flipped.sum())
    off = {e for _, e in got ^ want}
    # a token whose top-6 differs has, on one rank, a margin (6th less
    # 7th probability) within twice its probabilities' largest change: an
    # expert a in the one rank's six but not the tp run's, and b the other
    # way, give margin <= p1[a] - p1[b] <= (p1[a] - p2[a]) + (p2[b] -
    # p1[b]) <= 2 max |p1 - p2|
    p1, p2 = one["probs"][0], tp_["probs"][0]
    top = -np.sort(-p1, axis=1)
    margin = top[:, 5] - top[:, 6]
    moved = np.abs(p1 - p2).max(1)
    near = margin <= 2 * moved
    if not off <= touched or (flipped & ~near).any():
        fail(f"[train-tp] deepseek-v2: kept pairs differ outside the experts"
             f" of the {n_flip} tokens routed differently, or "
             f"{int((flipped & ~near).sum())} of them route otherwise "
             f"beyond their margins")
    t32, o32 = moe["tp32"], moe["one32"]
    got32, want32, flip32, _ = tp_pairs(np, t32["calls"][0],
                                        o32["calls"][0])
    flip32 = int(flip32.sum())
    m32 = float(np.abs(t32["probs"][0] - o32["probs"][0]).max())
    rel = {k: abs(tp_[k] - one[k]) / abs(one[k]) for k in ("loss", "aux")}
    print(f"[train-tp] deepseek-v2-236b ({DS_TRAIN_LAYERS} layers: dense + "
          f"one MoE layer), global dispatch, B {DS_TRAIN_B} x S {DS_TRAIN_S},"
          f" model 2 vs one rank ({card}): {moe['experts']} experts and "
          f"{moe['heads']} MLA heads a rank (shared experts' d_ff "
          f"{moe['shared_ff']} a rank); bf16: kept {len(got)} pairs "
          f"(capacity {c_tp['capacity']}), the same on both ranks; one rank "
          f"kept {len(want)}, sets "
          f"{'equal' if got == want else f'differ in {len(got ^ want)}'}, "
          f"only in the experts of the {n_flip} of "
          f"{c_tp['choice'].shape[0]} tokens routed differently; router "
          f"probabilities moved by {float(moved.max()):.2e} at most, "
          f"{int(near.sum())} tokens have a top-6 margin within twice their "
          f"move, and every rerouted token is one of them; float32 (TF32 "
          f"off): kept {len(got32)} pairs vs one rank's {len(want32)}, "
          f"sets {'equal' if got32 == want32 else 'differ'}, {flip32} "
          f"tokens routed differently, probabilities moved by {m32:.2e}; "
          f"loss {tp_['loss']:.6f} vs {one['loss']:.6f}, aux "
          f"{tp_['aux']:.6f} vs {one['aux']:.6f} (rel {rel['loss']:.2e}, "
          f"{rel['aux']:.2e}; bar {TP_MOE_RTOL:.2e}); gradients finite; "
          f"peak a rank {tp_['peak_gb']:.2f} GB, one rank "
          f"{one['peak_gb']:.2f} GB")
    if got32 != want32 or flip32:
        fail("[train-tp] deepseek-v2: float32 kept pairs differ from one "
             "rank's")
    if max(rel.values()) > TP_MOE_RTOL:
        fail("[train-tp] deepseek-v2: loss or aux off the one-rank run's")
    after = kernel_launch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    in_ranks = two["launches"] + four["launches"]
    if moved or any(in_ranks) or len(after) < 14:
        fail(f"[train-tp] ported kernels launched: {moved}, ranks "
             f"{in_ranks}")
    print(f"[train-tp] no ported kernel launched ({len(after)} wrappers' "
          f"counts unchanged here, 0 in every rank); backend "
          f"{two['backend']}: NCCL at model > 1 needs a card a rank and "
          "stays unverified")


# --------------------------------------------------------------------------
# r. the production-mesh dry run ([dryrun] lines)
# --------------------------------------------------------------------------

# (arch, shape, multi_pod) of the cells walked at full width
DRYRUN_CELLS = (("qwen3-14b", "train_4k", False),
                ("deepseek-v2-236b", "prefill_32k", True),
                ("qwen3-14b", "decode_32k", False))
# context parallelism for real: minicpm-2b at CP_LAYERS layers on (data 1,
# model CP_MODEL), B x S tokens (S / CP_MODEL query rows a rank), one
# step.  5 is the narrowest axis its 36 heads do not divide; at 8 each
# rank holds the replicated 122753-row float32 tied table with its
# gradient, two moments and the updated copy, ~8 GB a rank, and eight
# ranks with their CUDA contexts overflow the 80 GB card
CP_LAYERS, CP_MODEL, CP_B, CP_S = 2, 5, 2, 320
# The loss against one rank: the run differs from one rank at the FFN's
# row-parallel reduce of 5 bf16 partials (each rounded, then 4 bf16
# additions: ~sqrt(1 + 4 / 2) x 2^-8 / sqrt(12) = 0.50 x 2^-8 of the
# value in rms) and, since a bf16 GEMM's bits depend on its row count, at
# the ~6 products a layer over the rank's rows (one rounding each, 0.29 x
# 2^-8): ~0.87 x 2^-8 a layer, 1.2 x 2^-8 of the final hidden state over 2
# layers, below the 80-edge walk (3.7 x 2^-8) TP_LOGITS_ATOL was derived
# for; the sequence gathers are exact.  So the logits move by less than
# TP_LOGITS_ATOL and the loss bar is tp_loss_bar(CP_B x CP_S), as
# [train-tp]'s; the grad norm takes TP_GNORM_RTOL (2^-6).


def dryrun_walks(card: str) -> None:
    """Part (a): the cells walked on fake tensors, one rank of a fake
    process group each, their JSON and archives written; a train or
    decode cell's walked ``model`` bytes held equal to the analytic count
    (``tp_wire_bytes``, ``decode_wire_bytes``).  CPU work only:
    :func:`start_walks` runs it in a process of its own from the script's
    start."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    for arch, shape, multi in DRYRUN_CELLS:
        with make_production_mesh(multi_pod=multi) as mesh:
            res = dryrun.run_cell(arch, shape, mesh, force=True,
                                  verbose=False)
        if res["status"] != "ok":
            fail(f"[dryrun] {arch}/{shape}: {res['status']} "
                 f"{res.get('error', res.get('reason'))}")
        axes = res["collective_by_axes"]
        wire = res.get("tp_wire_model_bytes")
        count = ("decode_wire_bytes" if shape.startswith("decode")
                 else "tp_wire_bytes")
        ratio = "" if wire is None else (
            f"; walked model bytes / {count} "
            f"{axes.get('model', 0.0) / wire:.4f}")
        print(f"[dryrun] {res['label']} (rank 0 of {res['n_chips']}, fake "
              f"tensors, walked on this host's CPU in "
              f"{res['walk_seconds']:.1f} s; priced on the H100 data sheet, "
              f"analytic): W {res['flops_dev'] / 1e12:.1f} TF, Q "
              f"{res['hbm_bytes_dev'] / 1e12:.3f} TB a device; compute "
              f"{res['compute_s']:.3f} s, memory {res['memory_s']:.3f} s, "
              f"ici {res['ici_s']:.3f} s, dcn {res['dcn_s']:.3f} s, "
              f"{res['dominant']}-bound; collectives by axis "
              + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in
                          sorted(axes.items()))
              + f"; cell_flops / W {res['useful_ratio']:.3f}, roofline "
              f"fraction {res['roofline_fraction'] * 100:.2f}%{ratio}")
        if wire is not None and abs(axes.get("model", 0.0) / wire - 1) \
                > 1e-9:
            fail(f"[dryrun] {arch}/{shape}: walked model bytes "
                 f"{axes.get('model')} vs {count} {wire}")
        sys.stdout.flush()


def dryrun_reprice(card: str, measured) -> None:
    """Part (b): each walked cell's archive re-priced from its JSON, no
    model built, on the sheet (equal to the walk's numbers) and on the
    measured roofs (``measured``, a ChipSpec)."""
    from repro_torch.core.analysis import analyze_records
    from repro_torch.core.roofline.hardware import H100_SXM
    from repro_torch.launch import dryrun
    from repro_torch.launch.reanalyze import load_record, reanalyze_cell
    for arch, shape, multi in DRYRUN_CELLS:
        path = dryrun.result_path(arch, shape, "multipod" if multi
                                  else "pod")
        with open(path) as f:
            res = json.load(f)
        record = load_record(path)
        again = analyze_records(record, res["mesh_shape"], chip=H100_SXM,
                                dtype=res["dtype"],
                                model_flops=res["model_flops_total"])
        d = again.as_dict()
        keys = ("flops_dev", "hbm_bytes_dev", "collective_ici_bytes_dev",
                "collective_dcn_bytes_dev", "compute_s", "memory_s",
                "ici_s", "dcn_s")
        if any(d[k] != res[k] for k in keys):
            fail(f"[dryrun] {arch}/{shape}: the archive re-priced on the "
                 f"sheet differs: {[(k, d[k], res[k]) for k in keys]}")
        m = analyze_records(record, res["mesh_shape"], chip=measured,
                            dtype=res["dtype"],
                            model_flops=res["model_flops_total"]).as_dict()
        print(f"[dryrun] {res['label']} re-priced from its archive "
              f"(launch/reanalyze.py, no model built): on the sheet equal to "
              f"the walk's numbers; on the measured roofs ({measured.name}, "
              f"{card}): compute {m['compute_s']:.3f} s, memory "
              f"{m['memory_s']:.3f} s, ici {m['ici_s']:.3f} s, dcn "
              f"{m['dcn_s']:.3f} s, {m['dominant']}-bound, roofline "
              f"fraction {m['roofline_fraction'] * 100:.2f}% (sheet "
              f"{res['roofline_fraction'] * 100:.2f}%)")
        if not reanalyze_cell(path, measured):
            fail(f"[dryrun] reanalyze_cell({path}) found nothing")


_WALKER = ("import sys; sys.path[:0] = sys.argv[1:3]; "
           "import torch; torch.set_num_threads(1); "
           "import chip_smoke as cs; cs.dryrun_walks(sys.argv[3])")


def start_walks(card: str):
    """Start part (a) of the [dryrun] phase in a process of its own, on
    one CPU thread, so that it runs beside the phases before it;
    :func:`dryrun_phase` collects it, and it is killed at exit if a phase
    fails first.  Its output goes to temporary files (a pipe would stall
    it once full)."""
    import atexit
    import tempfile
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", _WALKER, str(ROOT), str(SRC), card],
        stdout=out, stderr=err, text=True)
    proc.files = (out, err)
    atexit.register(stop_walks, proc)
    return proc


def stop_walks(proc) -> None:
    """Kill the walker if it still runs."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def cp_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("minicpm-2b"), n_layers=CP_LAYERS)


def host_replicated_equal(torch, state, cfg, mesh, world: int) -> bool:
    """:func:`tp_replicated_equal` with the digests taken on the host
    (SHA-1 of each replicated leaf's bytes): the card keeps no weight
    vector the size of the largest leaf, which five ranks' replicated
    minicpm-2b tables leave no room for."""
    import hashlib
    from repro_torch.models.params import tree_paths
    from repro_torch.train.loop import state_shards
    sh = dict(tree_paths(state_shards(cfg, mesh)))
    dig = {k: hashlib.sha1(v.detach().contiguous().reshape(-1).view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()
        for k, v in tree_paths(state) if sh[k] is None}
    return all(d == dig for d in dp_objects(dig, world))


def dryrun_cp_rank(rank: int, world: int) -> dict:
    """One of the CP_MODEL ranks of part (c): minicpm-2b's step 1 at
    (data 1, model CP_MODEL), its collectives walked; rank 0 then runs
    one rank's step 1 on the same rows and weights."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.roofline.op_collectives import (CollectiveWalk,
                                                          summarize)
    from repro_torch.parallel.mesh import (batch_shard, batch_shards,
                                           make_host_mesh)
    from repro_torch.train import (OptConfig, SyntheticLMData, TrainConfig,
                                   make_initial_state, make_train_step)
    from repro_torch.train.step import tp_wire_bytes, train_local_config
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(model=world)
    cfg = cp_config()
    tc = TrainConfig(opt=OptConfig(lr=TRAIN_LR, warmup_steps=0,
                                   total_steps=1))
    data = SyntheticLMData(cfg, CP_B, CP_S, device=dev,
                           shard=batch_shard(mesh), shards=batch_shards(mesh))
    local = train_local_config(cfg, mesh)
    from repro_torch.models.common import layout_of
    res = {"layout": layout_of(local), "heads": local.n_heads,
           "d_ff": local.d_ff,
           "tp": tp_wire_bytes(cfg, mesh.sizes, CP_B, CP_S, tc)}
    step = make_train_step(cfg, tc, mesh)
    with deterministic(torch, True):
        state = make_initial_state(cfg, 0, dev, mesh=mesh)()
        walk = CollectiveWalk(mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with walk:
            state, m = step(state, data.batch_at(0))
        torch.cuda.synchronize()
        res["step_ms"] = (time.perf_counter() - t0) * 1e3
        cc = summarize(walk.ops)
        res["walked"] = {k[0]: v for k, v in cc.by_axes.items()}
        res["edges"] = dict(cc.by_edge)
        res["loss"], res["gnorm"] = float(m["loss"]), float(m["grad_norm"])
        res["equal"] = host_replicated_equal(torch, state, cfg, mesh, world)
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        with deterministic(torch, True):
            one = make_train_step(cfg, tc)
            state = make_initial_state(cfg, 0, dev)()
            _, m = one(state, SyntheticLMData(cfg, CP_B, CP_S,
                                              device=dev).batch_at(0))
            res["one"] = {"loss": float(m["loss"]),
                          "gnorm": float(m["grad_norm"])}
            del state, m
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    res["launches"] = sum(kernel_launch_counts().values())
    return {"res": res, "every": dp_objects(
        {k: res[k] for k in ("loss", "gnorm", "equal", "walked", "step_ms",
                             "peak_gb", "reserved_gb", "launches")}, world)}


def dryrun_phase(torch, np, card, roof, walker) -> None:
    """The [dryrun] phase: (c) on CP_MODEL gloo ranks on this card, while
    ``walker`` (:func:`start_walks`) finishes (a) if it still runs; then
    (b) on the walks' archives and the lines, (a) and (b) first."""
    from repro_torch.parallel.mesh import spawn
    before = kernel_launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    # the ranks' peaks take most of the card: their allocators grow
    # segments in place, so that blocks freed in the step strand no
    # reserved memory (this process's allocator is set up already)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        out = spawn(dryrun_cp_rank, CP_MODEL, backend="gloo",
                    device="cuda", timeout=600)
    except RuntimeError as e:
        fail(f"[dryrun] a (1, {CP_MODEL}) rank failed: {e}")
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    t0 = time.perf_counter()
    try:
        walker.wait(timeout=900)
    except subprocess.TimeoutExpired:
        fail("[dryrun] the walks did not end within 900 s of part (c)")
    for f in walker.files:
        f.seek(0)
    walked, err = (f.read() for f in walker.files)
    print(walked, end="")
    print(f"[dryrun] the walks ran beside the phases from the script's "
          f"start and ended {time.perf_counter() - t0:.1f} s after part (c)")
    if walker.returncode:
        fail(f"[dryrun] the walks failed: {err[-3000:]}")
    dryrun_reprice(card, roof.to_chipspec())
    r, every = out["res"], out["every"]
    cfg = cp_config()
    bar = tp_loss_bar(CP_B * CP_S)
    d_loss = abs(r["loss"] - r["one"]["loss"])
    g_rel = abs(r["gnorm"] - r["one"]["gnorm"]) / r["one"]["gnorm"]
    ratio = r["walked"].get("model", 0.0) / r["tp"]["model"]
    same = all(e["loss"] == every[0]["loss"] and e["equal"] for e in every)
    print(f"[dryrun] context parallelism for real: {cfg.name} at "
          f"{CP_LAYERS} layers, bf16, remat {cfg.remat}, B {CP_B} x S "
          f"{CP_S}, (data 1, model {CP_MODEL}) on {CP_MODEL} gloo ranks of "
          f"this card ({card}): {cfg.n_heads} heads stay whole a rank "
          f"({r['layout']}, attention over {CP_S // CP_MODEL} query rows a "
          f"rank), d_ff {r['d_ff']} a rank, vocabulary {cfg.vocab_size} "
          f"whole; step 1 loss {r['loss']:.6f} vs one rank "
          f"{r['one']['loss']:.6f} (|d| {d_loss:.2e}, bar {bar:.2e}); grad "
          f"norm {r['gnorm']:.6f} vs {r['one']['gnorm']:.6f} (rel "
          f"{g_rel:.2e}, bar {TP_GNORM_RTOL:.2e}); replicated leaves "
          f"{'bit-equal' if same else 'DIFFERENT'} on all {CP_MODEL} ranks; "
          f"walked model bytes {r['walked'].get('model', 0.0) / 1e6:.3f} MB "
          f"= tp_wire_bytes {r['tp']['model'] / 1e6:.3f} MB (ratio "
          f"{ratio:.4f}; by edge "
          + ", ".join(f"{k} {v / 1e6:.3f}" for k, v in
                      sorted(r["edges"].items()))
          + f" MB); step 1 {[round(e['step_ms']) for e in every]} ms, peak "
          f"{[round(e['peak_gb'], 2) for e in every]} GB a rank (reserved "
          f"{[round(e['reserved_gb'], 2) for e in every]} GB) of "
          f"{free_gb:.2f} GB free on the card before the ranks "
          f"({CP_MODEL} processes time-slice one card: no speed claim)")
    from repro_torch.models.common import LocalLayout
    cp = LocalLayout(context_parallel=True)
    if r["layout"] != cp or d_loss > bar or \
            g_rel > TP_GNORM_RTOL or not same or abs(ratio - 1) > 1e-9:
        fail("[dryrun] the context-parallel step misses its holds")
    after = kernel_launch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    in_ranks = [e["launches"] for e in every]
    if moved or any(in_ranks) or len(after) < 14:
        fail(f"[dryrun] ported kernels launched: {moved}, ranks {in_ranks}")
    print(f"[dryrun] no ported kernel launched ({len(after)} wrappers' "
          "counts unchanged here, 0 in every rank)")


# --------------------------------------------------------------------------
# s. decode on a sequence-sharded dense cache ([decode-sp] lines) and the
#    examples' legs ([examples] lines)
# --------------------------------------------------------------------------

# qwen3-0.6b at full width, GLOO_LAYERS deep, at (data 1, model DSP_MODEL)
# on gloo ranks of this card: 3 divides neither its 8 KV heads nor its 16
# query heads, so every rank holds its DSP_LINES / DSP_MODEL lines of the
# dense cache for every KV head, and every query head (a kv_seq and
# context-parallel LocalLayout).  DSP_B prompts of DSP_PROMPT tokens
# prefilled into the DSP_LINES-line cache, then DSP_STEPS greedy decode
# steps: the positions cross from rank 0's block into rank 1's; rank 2's
# lines stay past every position
DSP_MODEL, DSP_B, DSP_PROMPT, DSP_LINES, DSP_STEPS = 3, 4, 1000, 3072, 48
# Logits against one process's unsharded decode_step on the same weights
# and cache, rows fed the same token, derived as TP_LOGITS_ATOL is.  The
# run differs from one process at two edges a layer (the query heads,
# the vocabulary and the attention weights stay whole at model 3): the
# merge, whose ranks' attention outputs are rounded to bf16 before the
# float32 sum where one call rounds once (two roundings, sqrt(2) x 2^-8 /
# sqrt(12) = 0.41 x 2^-8 of the value in rms), and the FFN's
# row-parallel reduce of three bf16 partials (each rounded, then two
# bf16 additions: sqrt(1 + 2 / 3 + 1) x 2^-8 / sqrt(12) = 0.47 x 2^-8):
# DSP_EDGE an edge, a random walk over 2 x GLOO_LAYERS edges, of the
# final hidden state, so of the step's largest logit (~3.0 at init for
# qwen3-0.6b, where TP_LOGITS_ATOL took qwen3-14b's 0.90), and
# TP_LOGITS_ATOL's 2.3x over that: dsp_bar(step), ~0.036 at 4 layers.
# A greedy stream may part from the unsharded one only where the
# unsharded top-2 margin is under twice the bar (each of the two logits
# moves by at most the bar)
DSP_EDGE, DSP_OVER = 0.47 * 2.0 ** -8, 2.3


def dsp_bar(np, ref_step) -> float:
    """The logits bar of one step (its unsharded logits ``ref_step``)."""
    return (DSP_OVER * math.sqrt(2 * GLOO_LAYERS) * DSP_EDGE
            * float(np.abs(ref_step).max()))


def dsp_rank(rank: int, world: int) -> dict:
    """One rank of [decode-sp]: the whole weights from a seed (the same on
    every rank), the prefill of the prompts into the whole cache, the
    rank's blocks of both cut by the rules, then DSP_STEPS greedy steps
    of models.decode_step on its decode_local_config (the second walked
    by CollectiveWalk).  Rank 0 also runs the unsharded decode_step on the
    whole cache.  Returns numpy."""
    import numpy as np
    import torch
    from repro_torch.core.roofline.op_collectives import (CollectiveWalk,
                                                          summarize)
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.specs import exact_cache_defs, prefill_cache_specs
    from repro_torch.models import (decode_step, drop_cast, init_params,
                                    param_shardings, prefill,
                                    prepare_params)
    from repro_torch.models.params import tree_map, tree_paths
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.mesh import make_host_mesh, use_mesh
    from repro_torch.train.step import decode_local_config, decode_wire_bytes
    cfg = gloo_qwen()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (DSP_B, DSP_PROMPT),
                            generator=g, device="cuda")
    caches = tree_map(lambda d: torch.zeros(d.shape, dtype=d.torch_dtype,
                                            device="cuda"),
                      exact_cache_defs(cfg, DSP_B, DSP_LINES))
    with torch.no_grad():
        last, states = prefill(params, cfg, prompts)
        lines = dict(tree_paths(states))
        for k, c in tree_paths(caches):
            c[:, :, :DSP_PROMPT] = lines[k]
    del states, lines
    first = last.argmax(-1).int()
    mesh = make_host_mesh(data=1, model=DSP_MODEL)
    local = decode_local_config(cfg, mesh)
    mine = prepare_params(tree_map(
        lambda t, sp: shd.shard_leaf(t, sp, mesh), drop_cast(params),
        param_shardings(cfg, mesh)), local)
    blocks = tree_map(lambda t, sp: shd.shard_leaf(t, sp, mesh), caches,
                      prefill_cache_specs(cfg, DSP_B, DSP_LINES, mesh))
    if rank:
        del params, caches
    torch.cuda.synchronize()

    def greedy(p, c, step_cfg, walk_at=None):
        tok, logits, ms, walked = first, [], [], None
        for i in range(DSP_STEPS):
            pos = torch.full((DSP_B,), DSP_PROMPT + i, dtype=torch.int32,
                             device="cuda")
            t0 = time.perf_counter()
            if i == walk_at:
                with CollectiveWalk(mesh=mesh) as w:
                    lg = decode_step(p, step_cfg, c, tok[:, None], pos)
                cc = summarize(w.ops)
                walked = ({k[0]: v for k, v in cc.by_axes.items()},
                          dict(cc.by_edge))
            else:
                lg = decode_step(p, step_cfg, c, tok[:, None], pos)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg.float().cpu().numpy())
            tok = lg.argmax(-1).int()
        return np.stack(logits), ms, walked

    n0 = pa.paged_attention.launches
    with use_mesh(mesh, process_wide=True), torch.no_grad():
        logits, ms, walked = greedy(mine, blocks, local, walk_at=1)
    out = {"logits": logits, "ms": ms, "walked": walked,
           "launches": pa.paged_attention.launches - n0,
           "wire": decode_wire_bytes(cfg, mesh.sizes, DSP_B, DSP_LINES),
           "layout": str(local.layout), "kv_seq": local.layout.kv_seq,
           "heads": local.n_heads, "kv": local.n_kv_heads,
           "block": tuple(tree_paths(blocks)[0][1].shape),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if rank == 0:
        with torch.no_grad():
            out["ref"], out["ref_ms"], _ = greedy(params, caches, cfg)
    return out


def dsp_check(np, got, ref) -> tuple:
    """(max |d logits| over the rows fed the same token, its largest
    share of its step's bar, rows compared, the partings): a row is
    compared at step i while the two greedy streams agree on every token
    fed so far; where they first part, the unsharded top-2 margin must be
    under twice the step's bar."""
    worst, share, n, parted = 0.0, 0.0, 0, []
    bars = [dsp_bar(np, ref[i]) for i in range(DSP_STEPS)]
    for b in range(DSP_B):
        for i in range(DSP_STEPS):
            d = float(np.abs(got[i, b] - ref[i, b]).max())
            worst, share = max(worst, d), max(share, d / bars[i])
            n += 1
            a, r = int(got[i, b].argmax()), int(ref[i, b].argmax())
            if a != r:
                top = np.sort(ref[i, b])[-2:]
                margin = float(top[1] - top[0])
                if margin >= 2 * bars[i]:
                    fail(f"[decode-sp] row {b} parts from the unsharded "
                         f"stream at step {i} where its top-2 margin is "
                         f"{margin:.4f} >= {2 * bars[i]:.4f}")
                parted.append(f"row {b} at step {i} (margin {margin:.4f})")
                break
    return worst, share, n, parted, min(bars), max(bars)


_EXAMPLES = ("import sys; sys.path[:0] = sys.argv[1:3]; "
             "import chip_smoke as cs; cs.examples_run(sys.argv[3])")


def examples_run(card: str) -> None:
    """The [examples] phase's body, in a process of its own: the three
    legs on the card, each with the launch counts of the kernels it
    reaches (rows 1 and 4: serve_lm; rows 8-10: roofline_analysis)."""
    from repro_torch.launch import quickstart, roofline_analysis, serve_lm
    t0 = time.perf_counter()
    before = kernel_launch_counts()
    q = quickstart.main([])
    dq = {k: v - before[k] for k, v in kernel_launch_counts().items()
          if v != before[k]}
    losses = q["losses"]
    if not all(math.isfinite(x) for x in losses) or tuple(
            q["tokens"].shape) != (quickstart.PROMPTS,
                                   quickstart.PROMPT_LEN + quickstart.NEW):
        fail(f"[examples] quickstart: losses {losses}, tokens "
             f"{q['tokens'].shape}")
    w = q["report"].character.flops_dev
    print(f"[examples] launch/quickstart.py on the card: the train step "
          f"characterized before it ran (W {w:.4g} FLOPs), {len(losses)} "
          f"steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, {quickstart.NEW} tokens decoded for "
          f"{quickstart.PROMPTS} prompts; kernel launches {dq}; "
          f"{time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    before = kernel_launch_counts()
    r = roofline_analysis.main([])
    dr = {k: v - before[k] for k, v in kernel_launch_counts().items()
          if v != before[k]}
    want = ("inner_product.inner_product", "gelu.gelu_2d",
            "layernorm.layernorm")
    if any(dr.get(k, 0) < 1 + roofline_analysis.REPEATS for k in want):
        fail(f"[examples] roofline_analysis: rows 8-10 not launched: {dr}")
    print(f"[examples] launch/roofline_analysis.py on the card ({card}): "
          + ", ".join(f"{n} AI {ai:.2f} F/B at {perf / 1e9:.1f} GFLOP/s"
                      for n, ai, perf in r["points"])
          + " (timed beside other phases' gloo ranks: the method, not "
          f"the card's speed); rows 8-10 launches "
          f"{dict((k, dr[k]) for k in want)}; "
          f"archived cell read back: "
          f"{'yes' if r['cell'] is not None else 'none in this checkout'}; "
          f"{time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    before = kernel_launch_counts()
    res = serve_lm.main([])
    ds = {k: v - before[k] for k, v in kernel_launch_counts().items()
          if v != before[k]}
    bad = [x["arch"] for x in res if not x["finished"]
           or x["requests"] != 6]
    rows = ("paged_attention.paged_attention",
            "paged_attention.mla_paged_attention")
    if bad or any(ds.get(k, 0) == 0 for k in rows):
        fail(f"[examples] serve_lm: unfinished {bad}, launches {ds}")
    import torch
    print(f"[examples] launch/serve_lm.py on the card: every request "
          f"finished ({sum(x['requests'] for x in res)}); rows 1 and 4 "
          f"launches {dict((k, ds[k]) for k in rows)}; "
          f"{time.perf_counter() - t1:.1f} s; the legs' peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def start_examples(card: str):
    """The [examples] legs in a process of their own, started with
    [decode-sp]'s ranks and collected after them (their gloo ranks' times
    say nothing of speed), output to temporary files, killed at exit if a
    phase fails first."""
    import atexit
    import tempfile
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", _EXAMPLES, str(ROOT), str(SRC), card],
        stdout=out, stderr=err, text=True)
    proc.files = (out, err)
    atexit.register(stop_walks, proc)
    return proc


def decode_sp_phase(torch, np, card) -> int:
    """[decode-sp] on DSP_MODEL gloo ranks of this card with the
    [examples] legs (:func:`start_examples`) beside them, then the legs
    collected; returns row 1's launches in one rank's run."""
    from repro_torch.parallel.mesh import spawn
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the examples' legs (kernels on smoke configs, no time held) run
    # beside these ranks only: beside [dryrun]'s five ranks, whose peaks
    # take most of the card, they ran it out of memory
    examples = start_examples(card)
    try:
        out = spawn(dsp_rank, DSP_MODEL, backend="gloo", device="cuda",
                    timeout=600)
    except RuntimeError as e:
        fail(f"[decode-sp] a rank failed: {e}")
    dt = time.perf_counter() - t0
    worst, share, n, parted, lo, hi = dsp_check(np, out["logits"],
                                                out["ref"])
    axes, edges = out["walked"]
    wire = out["wire"]
    ratio = axes.get("model", 0.0) / wire["model"]
    want = GLOO_LAYERS * DSP_STEPS
    print(f"[decode-sp] {gloo_qwen().name} full width at {GLOO_LAYERS} "
          f"layers, bf16, (data 1, model {DSP_MODEL}) on {DSP_MODEL} gloo "
          f"ranks of this card ({card}): layout {out['layout']}, "
          f"{out['heads']} query heads and {out['kv']} KV heads a rank, "
          f"its cache block {out['block']} (layers, rows, lines, KV, hd); "
          f"{DSP_B} prompts of {DSP_PROMPT} tokens prefilled into "
          f"{DSP_LINES} lines, {DSP_STEPS} greedy steps from position "
          f"{DSP_PROMPT} (rank 0's block into rank 1's, rank 2 empty)")
    print(f"[decode-sp] logits against one process's unsharded decode_step "
          f"on {n} (row, step)s fed the same token: max |d| {worst:.4f}, "
          f"{share:.3f} of its step's bar (dsp_bar {lo:.4f}-{hi:.4f}, the "
          f"largest logit {float(np.abs(out['ref']).max()):.3f}); "
          + ("streams equal" if not parted else
             "streams parted under the margin rule: " + ", ".join(parted))
          + f"; paged_attention launches {out['launches']} a rank (layers x "
          f"steps = {want}); walked model bytes "
          f"{axes.get('model', 0.0) / 1e6:.4f} MB = decode_wire_bytes "
          f"{wire['model'] / 1e6:.4f} MB (ratio {ratio:.4f}; by edge "
          + ", ".join(f"{k} {v / 1e6:.4f}" for k, v in sorted(edges.items()))
          + " MB)")
    med = float(np.median(out["ms"][1:]))
    print(f"[decode-sp] step {med:.1f} ms sharded (median), "
          f"{float(np.median(out['ref_ms'][1:])):.1f} ms unsharded on rank "
          f"0, peak {out['peak_gb']:.2f} GB a rank: {DSP_MODEL} gloo ranks "
          "time-slice one card, so the step time says nothing of speed; "
          f"phase {dt:.1f} s")
    if not out["kv_seq"] or share > 1 or out["launches"] != want or \
            abs(ratio - 1) > 1e-9:
        fail("[decode-sp] the sequence-sharded decode misses its holds")
    try:
        examples.wait(timeout=600)
    except subprocess.TimeoutExpired:
        fail("[examples] the legs did not end within 600 s of [decode-sp]")
    for f in examples.files:
        f.seek(0)
    text, err = (f.read() for f in examples.files)
    print("".join(line + "\n" for line in text.splitlines()
                  if line.startswith("[examples]")), end="")
    if examples.returncode:
        fail(f"[examples] the legs failed: {err[-3000:]}")
    return out["launches"]


def print_build_summary(name: str, log: str) -> None:
    """One line per source from nvcc's ``-Xptxas -v`` report: kernel
    instantiations, their register range, and each one that spills."""
    import re
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and (int(m.group(1)) or int(m.group(2))):
            spills.append(f"{fn}: {m.group(1)} B stores, {m.group(2)} B "
                          "loads")
    print(f"[build] {name}: {len(regs)} kernel instantiations, "
          f"{min(regs or [0])}-{max(regs or [0])} registers, "
          f"{len(spills)} spilling")
    for sp in spills:
        print(f"[build] {name} spills: {sp}")
    # the float32 GEMM core's kernels, one per pair of copy widths (A, B:
    # 4 floats a copy or 1)
    from repro_torch.kernels.build import resources
    for line in resources(log):
        print(f"[build] {name}: {line}")
    # the MLA tensor-core core's kernels and GELU's vector walks
    for family in NEW_KERNELS:
        found = []
        for part in log.split("Function properties for ")[1:]:
            used = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes spill stores", part)
            if family in part.split("\n", 1)[0] and used and spill:
                found.append((int(used.group(1)), int(spill.group(1)),
                              part.split("\n", 1)[0].strip()))
        if found:
            regs = [f[0] for f in found]
            tail, shape = MAIN_INSTANCE.get(family, ("", ""))
            main = [f[0] for f in found if tail and tail in f[2]]
            print(f"[build] {name}: {family} {len(found)} instantiations, "
                  f"{min(regs)}-{max(regs)} registers"
                  + (f" ({main[0]} at {shape})" if main else "")
                  + f", {sum(f[1] > 0 for f in found)} spilling")


# kernels whose registers and spills the build lines print, and the
# mangled tail of the two cores' main-path instantiations (bf16 pools; MLA
# r 512, dr 64; GQA hd 128)
NEW_KERNELS = ("mla_split_bf16_kernel", "mla_combine_kernel",
               "gqa_split_bf16_kernel", "gelu_flat_kernel",
               "gelu_rows_kernel")
MAIN_INSTANCE = {
    "mla_split_bf16_kernel": ("I13__nv_bfloat16Li512ELi64E",
                              "bf16 r 512 dr 64"),
    "gqa_split_bf16_kernel": ("I13__nv_bfloat16Li128E", "bf16 hd 128")}
# the instructions that show each new kernel's design in its SASS: wgmma
# in the two cores' split kernels, 16-byte loads and stores in GELU's
# vector walks
HGMMA = {"HGMMA": r"HGMMA"}
SASS_WANT = {"mla_core": ("mla_split_bf16_kernel", HGMMA),
             "gqa_core": ("gqa_split_bf16_kernel", HGMMA),
             "gelu": ("gelu_flat_kernel",
                      {"LDG.E.128": r"LDG\.E[.\w]*\.128",
                       "STG.E.128": r"STG\.E[.\w]*\.128"})}


def sass_check() -> None:
    """cuobjdump the built libraries: every instantiation of each new
    kernel must carry its design's instructions (SASS_WANT); prints a
    line per library, fails on a miss."""
    import re
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    for name, (kernel, want) in SASS_WANT.items():
        sass = subprocess.run([str(cuobjdump), "--dump-sass",
                               str(build.library_path(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        funcs = [f for f in re.split(r"\n\s*Function : ", sass)[1:]
                 if kernel in f.split("\n", 1)[0]]
        counts = {w: [len(re.findall(pattern, f)) for f in funcs]
                  for w, pattern in want.items()}
        if not funcs or any(min(c) == 0 for c in counts.values()):
            fail(f"{name}: {kernel} lacks {list(want)} in its SASS "
                 f"({counts})")
        print(f"[sass] {name}: {kernel} in {len(funcs)} instantiations, "
              + ", ".join(f"{w} {min(c)}-{max(c)} each"
                          for w, c in counts.items()))


def beside(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` started in a thread of its own: a Future.
    Used for ``spawn`` calls whose ranks run beside the caller's work
    (each call has its own store and queue, so concurrent calls never
    meet)."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(fn, *args, **kwargs)
    pool.shutdown(wait=False)
    return future


def phase_time(label: str, t0: float) -> float:
    """Print a phase's wall time; returns the clock for the next phase."""
    t1 = time.perf_counter()
    print(f"[time] {label}: {t1 - t0:.1f} s")
    return t1


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this runs on the card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a repo checkout")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import SpecConfig

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 means float32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    walker = start_walks(card)
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in (SRC / "repro_torch" / "csrc").glob(
        "*.cu"))

    def timed_build(names, defines=()):
        return build.build(names, defines), time.perf_counter()

    with ThreadPoolExecutor(2) as pool:   # all nvcc processes at once
        single_p = pool.submit(timed_build, ["flash_attention"],
                               FLASH_SINGLE_P)
        built = pool.submit(timed_build, sources)
        # the training path launches none of the kernels: it trains while
        # nvcc builds them
        train_step = train_phase(torch, np, card)
        t_train = time.perf_counter()
        logs, t_built = built.result()
        single, t_single = single_p.result()
        logs["flash_attention (P rounded once)"] = single["flash_attention"]
    print(f"[build] {', '.join(sources)} built in "
          f"{max(t_built, t_single) - t0:.1f} s (nvcc sm_90a, beside "
          f"[train])")
    for name, log in logs.items():
        print_build_summary(name, log)
    sass_check()

    qwen = get_config("qwen3-0.6b")
    if (qwen.n_layers, qwen.d_model, qwen.n_kv_heads, qwen.hd) != (
            N_LAYERS, 1024, KV, HD):
        fail(f"unexpected qwen3-0.6b config {qwen}")
    deepseek = dataclasses.replace(get_config("deepseek-v2-236b"),
                                   n_layers=DS_LAYERS)
    if (deepseek.d_model, deepseek.n_heads, deepseek.kv_lora_rank,
            deepseek.rope_head_dim, deepseek.n_experts) != (
            5120, MLA_H, MLA_R, MLA_DR, 160):
        fail(f"unexpected deepseek-v2-236b config {deepseek}")

    q14 = get_config("qwen3-14b")
    if (q14.n_layers, q14.d_model, q14.n_heads, q14.n_kv_heads, q14.hd,
            q14.vocab_size) != (Q14_LAYERS, 5120, KV * V_G, KV, HD,
                                qwen.vocab_size):
        fail(f"unexpected qwen3-14b config {q14}")

    print(f"[time] training beside the build: qwen3-0.6b whole "
          f"({TRAIN_STEPS} steps), checkpoint, accumulation, resume, "
          f"deepseek-v2 ({DS_TRAIN_LAYERS} layers) dispatch: "
          f"{t_train - t0:.1f} s")
    t_phase = phase_time("build and training", t0)
    entry, gqa_ring = kernel_phase(torch, np, pa)
    verify_entry, gqa_ring_verify = gqa_verify_kernel_phase(torch, np, pa)
    mla_entry, mla_ring = mla_kernel_phase(torch, np, pa)
    mla_verify_entry, mla_ring_verify = mla_verify_kernel_phase(
        torch, np, pa)
    # the ring kernels do the decode kernels' work at the decode phases'
    # inputs: the same plain version, library call and bound (this run's),
    # and their scale branches the same on the same inputs quantized
    ring_entry = dict(
        entry, name="paged_attention_ring",
        source="src/repro_torch/csrc/gqa_core.cu",
        replaces="src/repro/kernels/paged_attention.py:803", **gqa_ring)
    mla_ring_entry = dict(
        mla_entry, name="mla_paged_attention_ring",
        source="src/repro_torch/csrc/mla_core.cu",
        replaces="src/repro/kernels/paged_attention.py:932", **mla_ring)
    for pools in ("bf16", *KV_DTYPES):
        def ms(d):
            return d["ms"] if pools == "bf16" else d[pools]["ms"]
        print(f"[kernel] ring vs off at the same inputs ({pools} pools): "
              f"GQA decode {ms(gqa_ring):.4f} vs {ms(entry):.4f} ms, GQA "
              f"verify {ms(gqa_ring_verify):.4f} vs {ms(verify_entry):.4f} "
              f"ms, MLA decode {ms(mla_ring):.4f} vs {ms(mla_entry):.4f} ms, "
              f"MLA verify {ms(mla_ring_verify):.4f} vs "
              f"{ms(mla_verify_entry):.4f} ms")
    t_phase = phase_time("paged-attention kernel phases", t_phase)
    prim_entries, roof = primitives_phase(torch, np, card)
    train_roof_line(card, roof, train_step)
    t_phase = phase_time("primitive study", t_phase)
    npa_entries = norm_pool_attention_phase(torch, np, card, roof)
    layernorm_in_turns(torch, card)
    t_phase = phase_time("layernorm / pooling / attention", t_phase)

    params = make_params(torch, qwen)
    entry["launches"], rings = engine_phase(
        torch, np, card, qwen, params, max_len=MAX_LEN,
        new_tokens=NEW_TOKENS, op="paged_attention",
        counter=pa.paged_attention, logits_atol=LOGITS_ATOL, dispatch=True)
    ring_entry["launches"] = rings["paged_attention_ring"]
    spec_phase(torch, np, card, qwen, params,
               scfg=SpecConfig(k=SPEC_K, proposer="draft", draft_cfg=qwen,
                               draft_params=params),
               label="qwen3-0.6b self-draft", max_len=MAX_LEN,
               new_tokens=NEW_TOKENS,
               verify_counter=pa.paged_attention_verify,
               decode_counter=pa.paged_attention,
               decode_op="paged_attention", logits_atol=LOGITS_ATOL,
               min_accept=SELF_DRAFT_MIN_ACCEPT)
    t_phase = phase_time("qwen3-0.6b engine and self-draft paths", t_phase)
    telemetry_phase(torch, np, card, qwen, params, roof)
    t_phase = phase_time("telemetry", t_phase)
    options_phase(torch, np, card, qwen, params, max_len=MAX_LEN,
                  logits_atol=LOGITS_ATOL)
    sampler_distribution(torch, np, card, qwen.vocab_size)
    t_phase = phase_time("qwen3-0.6b options", t_phase)
    prefill_graph_lines(torch, np, card, qwen, params, roof.level_betas(),
                        max_len=MAX_LEN, new_tokens=NEW_TOKENS)
    t_phase = phase_time("qwen3-0.6b prefill graphs", t_phase)
    crosscheck_qwen(torch, np, card, qwen, params, roof)
    del params
    t_phase = phase_time("crosscheck: qwen3-0.6b", t_phase)
    chip = roof.to_chipspec()

    params = make_params(torch, deepseek)
    mla_entry["launches"], rings = engine_phase(
        torch, np, card, deepseek, params, max_len=DS_MAX_LEN,
        new_tokens=DS_NEW_TOKENS, op="mla_paged_attention",
        counter=pa.mla_paged_attention, logits_atol=DS_LOGITS_ATOL,
        telemetry_chip=chip)
    mla_ring_entry["launches"] = rings["mla_paged_attention_ring"]
    mla_verify_entry["launches"], _ = spec_phase(
        torch, np, card, deepseek, params,
        scfg=SpecConfig(k=MLA_SPEC_K, proposer="ngram"),
        label="deepseek-v2-236b (4 layers) n-gram", max_len=DS_MAX_LEN,
        new_tokens=DS_NEW_TOKENS,
        verify_counter=pa.mla_paged_attention_verify,
        decode_counter=pa.mla_paged_attention,
        decode_op="mla_paged_attention", logits_atol=DS_LOGITS_ATOL)
    t_phase = phase_time("deepseek-v2 engine and n-gram paths", t_phase)
    options_phase(torch, np, card, deepseek, params, max_len=DS_MAX_LEN,
                  logits_atol=DS_LOGITS_ATOL)
    t_phase = phase_time("deepseek-v2 options", t_phase)
    prefill_graph_lines(torch, np, card, deepseek, params, roof.level_betas(),
                        max_len=DS_MAX_LEN, new_tokens=DS_NEW_TOKENS)
    t_phase = phase_time("deepseek-v2 prefill graphs", t_phase)
    crosscheck_deepseek(torch, np, card, deepseek, params)
    del params
    t_phase = phase_time("crosscheck: deepseek-v2", t_phase)

    draft = make_params(torch, qwen)
    params = make_params(torch, q14)
    verify_entry["launches"], _ = spec_phase(
        torch, np, card, q14, params,
        scfg=SpecConfig(k=SPEC_K, proposer="draft", draft_cfg=qwen,
                        draft_params=draft),
        label="qwen3-14b + qwen3-0.6b draft", max_len=MAX_LEN,
        new_tokens=Q14_NEW_TOKENS, verify_counter=pa.paged_attention_verify,
        decode_counter=pa.paged_attention, decode_op="paged_attention",
        logits_atol=SPEC_LOGITS_ATOL, kv_dtypes=("int8",), dispatch=True,
        telemetry_chip=chip)
    t_phase = phase_time("qwen3-14b speculative path", t_phase)
    crosscheck_spec(torch, np, card, q14, params, qwen, draft)
    del params, draft
    t_phase = phase_time("crosscheck: qwen3-14b speculative", t_phase)

    xlstm = dataclasses.replace(get_config("xlstm-350m"),
                                n_layers=XLSTM_LAYERS)
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"),
                                n_layers=JAMBA_LAYERS)
    if (xlstm.d_model, xlstm.n_heads, len(xlstm.block_pattern)) != (
            1024, 4, XLSTM_LAYERS) or (
            jamba.d_model, jamba.n_heads, jamba.n_kv_heads, jamba.hd,
            jamba.d_inner, jamba.mamba_d_state, jamba.d_ff,
            jamba.vocab_size) != (4096, KV * JAMBA_G, KV, HD, 8192, 16,
                                  14336, 65536):
        fail(f"unexpected recurrent configs {xlstm} {jamba}")
    params = make_params(torch, xlstm)
    recurrent_phase(torch, np, card, xlstm, params, roof)
    options_phase(torch, np, card, xlstm, params, max_len=MAX_LEN,
                  logits_atol=LOGITS_ATOL)
    crosscheck_recurrent(torch, np, card, xlstm, params, roof)
    del params
    t_phase = phase_time(f"xlstm-350m ({XLSTM_LAYERS} layers) engine, "
                         "options and crosscheck",
                         t_phase)
    jamba_kernel_holds(torch, np, pa)
    params = make_params(torch, jamba)
    recurrent_phase(torch, np, card, jamba, params, roof)
    options_phase(torch, np, card, jamba, params, max_len=MAX_LEN,
                  logits_atol=LOGITS_ATOL)
    crosscheck_recurrent(torch, np, card, jamba, params, roof)
    del params
    torch.cuda.empty_cache()
    print(f"[recurrent] {jamba.name} weights freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated after")
    t_phase = phase_time(
        "jamba-v0.1-52b (8 layers) engine, options and crosscheck", t_phase)

    whisper = get_config("whisper-small")
    vision = dataclasses.replace(get_config("llama-3.2-vision-90b"),
                                 n_layers=VISION_LAYERS)
    if (whisper.n_layers, whisper.n_encoder_layers, whisper.d_model,
            whisper.n_kv_heads, whisper.hd, whisper.n_audio_frames,
            whisper.vocab_size) != (12, 12, 768, 12, 64, 1500, 51865) or (
            vision.d_model, vision.n_heads, vision.n_kv_heads, vision.hd,
            vision.n_image_tokens, vision.vocab_size) != (
            8192, 64, KV, HD, 1600, 128256):
        fail(f"unexpected static-path configs {whisper} {vision}")
    static_kernel_holds(torch, np, pa, whisper, vision)
    entry["static_launches"] = {
        c.name: static_phase(torch, np, card, pa, c)
        for c in (whisper, vision)}
    static_vs_continuous(torch, np, card, qwen)
    t_phase = phase_time("static path: whisper-small, llama-3.2-vision-90b "
                         "(10 layers), qwen3-0.6b static = continuous",
                         t_phase)
    tp_kernel_holds(torch, np, pa)
    tp = tp_phase(torch, np, card)
    entry["tp_launches"] = tp["paged_attention"]
    verify_entry["tp_launches"] = tp["paged_attention_verify"]
    mla_entry["tp_launches"] = tp["mla_paged_attention"]
    t_phase = phase_time(
        f"tensor parallel: qwen3-14b, its n-gram verify and MLA-dense "
        f"({TP_MLA_LAYERS} layers) at tp {TP}, NCCL world of one", t_phase)
    router_phase(torch, np, card)
    t_phase = phase_time("serving tier: qwen3-0.6b and MLA-dense replicas "
                         "behind the router", t_phase)
    from repro_torch.parallel.mesh import spawn
    # [train-tp]'s (data 2, model 2) ranks run beside launch/train.py
    # --data 2 (the two runs' peaks fit the card together)
    four = beside(spawn, train_tp4_rank, 4, backend="gloo", device="cuda",
                  timeout=900)
    train_dp_phase(torch, np, card, four)
    t_phase = phase_time(f"data-parallel training: launch/train.py --data 2 "
                         f"(qwen3-0.6b at {GLOO_LAYERS} layers; [train-tp]'s "
                         "(2, 2) ranks beside it), restore at data 1, dense "
                         "and MoE holds, NCCL world of one", t_phase)
    train_tp_phase(torch, np, card, four)
    t_phase = phase_time(f"tensor-parallel training: qwen3-0.6b ("
                         f"{GLOO_LAYERS} layers) at (1, 2) (and (2, 2), run "
                         "beside [train-dp]), deepseek-v2 (2 layers) at (1, "
                         "2), pre-flight walks", t_phase)
    dryrun_phase(torch, np, card, roof, walker)
    t_phase = phase_time(f"production-mesh dry run: {cp_config().name} ("
                         f"{CP_LAYERS} layers) context parallel at (1, "
                         f"{CP_MODEL}), the three full-width walks "
                         "collected", t_phase)
    entry["decode_sp_launches"] = decode_sp_phase(torch, np, card)
    phase_time(f"sequence-sharded decode: qwen3-0.6b ({GLOO_LAYERS} "
               f"layers) at (1, {DSP_MODEL}), the examples' legs collected",
               t_phase)
    kernels = [entry, ring_entry, verify_entry, mla_entry, mla_ring_entry,
               mla_verify_entry, *prim_entries, *npa_entries]
    if len(kernels) != 14:
        fail(f"{len(kernels)} kernels in the kernels line, want 14")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
