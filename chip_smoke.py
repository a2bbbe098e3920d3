"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one NVIDIA H100, from a repo checkout

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together) and print the build time;
3. kernel phases: each kernel (GQA ``paged_attention`` and
   ``paged_attention_verify``, MLA ``mla_paged_attention`` and
   ``mla_paged_attention_verify``) against its plain PyTorch version on
   the card at its main path's shapes and at its edge cases (ragged
   tables, idle all-trash lanes, soft cap; for the verify kernels also
   draft chains crossing a page, drafts on trash margin entries, chains
   past the table, and T = 1 against the decode kernel), with the
   tolerance stated; times (CUDA events) of the kernel, the plain version
   and one PyTorch library call computing the same function, beside the
   bound;
4. the paper's primitive study (launch/primitives.py): the microbench
   (FMA-chain probe, matmul peaks per dtype, copy / fill / triad
   bandwidth, warm vs cold) printed beside the data sheet; the
   inner-product, GELU, direct-conv and Winograd-stage kernels held
   against their plain versions at the reference benchmarks' shapes and
   at edge shapes (ragged M / N / K, K = 1, relu and gelu epilogues, odd
   H / W, C = 3 padded to 8 and 128, GELU blocked equal to naive bit for
   bit); then the study at card shapes with the four kernels' launch
   counts zeroed before and read after, every row held against its plain
   version and within 105% of the measured roof;
5. engine phases, one per path, random weights from generators seeded 0;
   every request must finish, each path's kernel launch counts (zeroed
   just before the run, read just after) must match its step counts, and
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
      against a full-width qwen3-0.6b draft model (k 4), through the GQA
      verify kernel (the draft's catch-up too) and the decode kernel (the
      draft's steps); tok/s beside the plain engine's on the same prompts;
   every speculative stream must equal the plain engine's greedy stream,
   or differ first where the plain engine's top-2 logit margin is under
   the logits tolerance;
6. one JSON line listing every ported kernel, then the device line last.

Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
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


def attention_case(torch, np, rng, dtype, kind: str):
    """Inputs of one kernel case at the main path's shapes."""
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((SLOTS, KV, G, HD),
                                             dtype="float32"))
    kp = torch.from_numpy(rng.standard_normal((N_PAGES, PAGE, KV, HD),
                                              dtype="float32"))
    vp = torch.from_numpy(rng.standard_normal((N_PAGES, PAGE, KV, HD),
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


def kernel_phase(torch, np, pa):
    """paged_attention (CUDA) vs paged_attention_reference on the card."""
    import torch.nn.functional as F
    rng = np.random.default_rng(0)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for kind in ("ragged", "full", "trash", "soft_cap"):
            c = attention_case(torch, np, rng, dtype, kind)
            errs[(name, kind)] = hold(
                torch, f"paged_attention {name:8s} {kind:8s}",
                pa.paged_attention, pa.paged_attention_reference,
                (c["q"], c["k"], c["v"], c["bt"], c["pos"]), 3,
                dict(scale=c["scale"], soft_cap=c["soft_cap"]), name)
    # times at the main path's shapes and types: bf16, engine-like ragged
    # contexts; 16 copies (~135 MB) rotate so every call reads cold HBM
    c = attention_case(torch, np, rng, torch.bfloat16, "ragged")
    copies = [(c["q"].clone(), c["k"].clone(), c["v"].clone(), c["bt"],
               c["pos"]) for _ in range(16)]
    kw = dict(scale=c["scale"], soft_cap=0.0)
    n = pa.paged_attention.launches
    kernel_ms = device_ms(lambda *a: pa.paged_attention(*a, **kw), copies)
    plain_ms = device_ms(lambda *a: pa.paged_attention_reference(*a, **kw),
                         copies)
    S = N_BLOCKS * PAGE
    k_pos = torch.arange(S, device="cuda")
    mask = (k_pos[None, :] <= c["pos"].long()[:, None])[:, None, None, :]

    def library(q, k, v, bt, pos):
        # gather the pages, then torch's fused attention with the mask
        kk = k[bt.long()].reshape(SLOTS, S, KV, HD).transpose(1, 2)
        vv = v[bt.long()].reshape(SLOTS, S, KV, HD).transpose(1, 2)
        qq = q.reshape(SLOTS, KV * G, 1, HD)
        return F.scaled_dot_product_attention(
            qq, kk.repeat_interleave(G, dim=1), vv.repeat_interleave(G, 1),
            attn_mask=mask, scale=c["scale"])

    lib_out = library(*copies[0]).reshape(SLOTS, KV, G, HD)
    lib_err = float((lib_out.float() - pa.paged_attention_reference(
        *copies[0], **kw).float()).abs().max())
    if lib_err > TOL["bfloat16"]["atol"]:
        fail(f"library yardstick disagrees with the plain version: {lib_err}")
    library_ms = device_ms(library, copies)
    pa.paged_attention.launches = n        # comparison launches do not count
    isize = c["q"].element_size()
    bytes_ms, ops_ms = paged_bound(c["pos"], 1, S, KV * HD * 2 * isize,
                                   KV * G * 4 * HD,
                                   2 * c["q"].numel() * isize, isize)
    bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
    print(f"[kernel] paged_attention bf16 B={SLOTS} KV={KV} G={G} hd={HD} "
          f"page={PAGE} lines={int((c['pos'].long() + 1).sum())}: "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"(gather + SDPA) {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}; operations {ops_ms:.5f} ms at bf16 peak)")
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:345",
                max_abs_err=errs[("bfloat16", "ragged")], ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def mla_case(torch, np, rng, dtype, kind: str):
    """Inputs of one MLA kernel case.  ``ragged``: the main path's shapes
    and MLA_LENS; ``edges``: pos 0, a partly filled last page, one exact
    page and a full table; ``trash``: every slot idle (all entries trash
    page 0, pos 0); ``small``: smoke widths (H 4, r 32, dr 8, page 8)."""
    B, H, r, dr, page, nb = SLOTS, MLA_H, MLA_R, MLA_DR, PAGE, MLA_BLOCKS
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


def mla_bound(q_lat, q_rope, pos, T: int, S: int):
    """:func:`paged_bound` of an MLA call: (r + dr)-element lines, H * (2
    (r + dr) + 2 r) FLOPs per (query token, line), q_lat, q_rope and the
    output moved once."""
    H, r, dr = q_lat.shape[-2], q_lat.shape[-1], q_rope.shape[-1]
    isize = q_lat.element_size()
    return paged_bound(pos, T, S, (r + dr) * isize,
                       H * (2 * (r + dr) + 2 * r),
                       (2 * q_lat.numel() + q_rope.numel()) * isize, isize)


def mla_kernel_phase(torch, np, pa):
    """mla_paged_attention (CUDA) vs mla_paged_attention_reference."""
    import torch.nn.functional as F
    rng = np.random.default_rng(2)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for kind in ("ragged", "edges", "trash", "small"):
            c = mla_case(torch, np, rng, dtype, kind)
            errs[(name, kind)] = hold(
                torch, f"mla_paged_attention {name:8s} {kind:6s}",
                pa.mla_paged_attention, pa.mla_paged_attention_reference,
                c["args"], 4, dict(scale=c["scale"]), name)
    # times at the main path's shapes and type: bf16, MLA_LENS; 64 copies
    # of the queries and pools (~110 MB) rotate so every call reads cold
    # HBM
    c = mla_case(torch, np, rng, torch.bfloat16, "ragged")
    q_lat, q_rope, cp, rp, bt, pos = c["args"]
    copies = [(q_lat.clone(), q_rope.clone(), cp.clone(), rp.clone(), bt,
               pos) for _ in range(64)]
    kw = dict(scale=c["scale"])
    n = pa.mla_paged_attention.launches
    kernel_ms = device_ms(lambda *a: pa.mla_paged_attention(*a, **kw),
                          copies)
    plain_ms = device_ms(
        lambda *a: pa.mla_paged_attention_reference(*a, **kw), copies)
    B, S = SLOTS, MLA_BLOCKS * PAGE
    k_pos = torch.arange(S, device="cuda")
    mask = (k_pos[None, :] <= pos.long()[:, None])[:, None, None, :]

    def library(ql, qr, cpool, rpool, bt, pos):
        # gather the latent lines, then torch's fused attention with
        # k = [c | k_rope] and v = c, shared by every head
        cc = cpool[bt.long()].reshape(B, 1, S, MLA_R)
        kk = torch.cat([cc, rpool[bt.long()].reshape(B, 1, S, MLA_DR)], -1)
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
    pa.mla_paged_attention.launches = n    # comparison launches do not count
    bytes_ms, ops_ms = mla_bound(q_lat, q_rope, pos, 1, S)
    bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
    print(f"[kernel] mla_paged_attention bf16 B={SLOTS} H={MLA_H} "
          f"r={MLA_R} dr={MLA_DR} page={PAGE} lines={sum(MLA_LENS)}: "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"(gather + SDPA) {library_ms:.4f} ms (max abs diff vs plain "
          f"{lib_err:.3e}), bound {bound_ms:.5f} ms ({bound_by}; bytes "
          f"{bytes_ms:.5f} ms, operations {ops_ms:.5f} ms at bf16 peak)")
    return dict(name="mla_paged_attention", route="cuda",
                source="src/repro_torch/csrc/mla_paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:445",
                max_abs_err=errs[("bfloat16", "ragged")], ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def hold(torch, label: str, kernel, plain, args, n_float: int, kw,
         name: str) -> float:
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
    print(f"[kernel] {label} max_abs_err={err:.3e} (atol=rtol="
          f"{tol['atol']}); vs plain in f32 {err32:.3e} (atol=rtol="
          f"{tol32['atol']}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{label} disagrees with its plain version: max abs err {err}")
    return err


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


def gqa_verify_case(torch, np, rng, dtype, kind: str):
    """Inputs of one GQA verify case at qwen3-14b's verify shapes (4
    slots, KV 8, G 5, hd 128, T 5, page 16, 33 blocks).  Kinds: ``ragged``
    (MLA_LENS contexts, drafts backed), ``edges`` (chains crossing a page
    at pos 14 and 30, one at pos 0, one past the table; drafts backed),
    ``margin`` (the same with the drafts on trash entries), ``trash`` (idle
    lanes), ``soft_cap`` (4x queries, cap 30), ``t1`` (T = 1)."""
    T = 1 if kind == "t1" else V_T
    lens = {"ragged": MLA_LENS, "edges": (15, 31, 1, V_BLOCKS * PAGE + 2),
            "margin": (15, 31, 1, V_BLOCKS * PAGE + 2), "trash": None,
            "soft_cap": MLA_LENS, "t1": MLA_LENS}[kind]
    P, make = verify_tables(torch, np, rng, lens, T, PAGE, V_BLOCKS)
    bt, pos = make(backed=kind != "margin")
    g = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape, dtype="float32"))
    q = g(SLOTS, T, KV, V_G, HD) * (4.0 if kind == "soft_cap" else 1.0)
    dev = "cuda"
    return dict(args=(q.to(dev, dtype), g(P, PAGE, KV, HD).to(dev, dtype),
                      g(P, PAGE, KV, HD).to(dev, dtype), bt.to(dev),
                      pos.to(dev)),
                kw=dict(scale=HD ** -0.5,
                        soft_cap=30.0 if kind == "soft_cap" else 0.0))


def gqa_verify_kernel_phase(torch, np, pa):
    """paged_attention_verify (CUDA) vs paged_attention_verify_reference
    on the card, and at T = 1 against the decode kernel."""
    import torch.nn.functional as F
    rng = np.random.default_rng(3)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for kind in ("ragged", "edges", "margin", "trash", "soft_cap",
                     "t1"):
            c = gqa_verify_case(torch, np, rng, dtype, kind)
            errs[(name, kind)] = hold(
                torch, f"paged_attention_verify {name:8s} {kind:8s}",
                pa.paged_attention_verify, pa.paged_attention_verify_reference,
                c["args"], 3, c["kw"], name)
            if kind == "t1":                 # one token = one decode step
                q, *rest = c["args"]
                ver = pa.paged_attention_verify(q, *rest, **c["kw"])[:, 0]
                dec = pa.paged_attention(q[:, 0].contiguous(), *rest,
                                         **c["kw"])
                torch.cuda.synchronize()
                d = float((ver.float() - dec.float()).abs().max())
                print(f"[kernel] paged_attention_verify {name:8s} T=1 vs "
                      f"the decode kernel: max abs diff {d:.3e}")
                if not torch.allclose(ver.float(), dec.float(),
                                      **TOL_F32_PLAIN[name]):
                    fail(f"paged_attention_verify at T=1 differs from the "
                         f"decode kernel by {d}")
    # times at the main path's shapes and type: bf16, MLA_LENS contexts;
    # 16 copies of the pools (~140 MB) rotate so every call reads cold HBM
    c = gqa_verify_case(torch, np, rng, torch.bfloat16, "ragged")
    q, kp, vp, bt, pos = c["args"]
    copies = [(q.clone(), kp.clone(), vp.clone(), bt, pos)
              for _ in range(16)]
    kw = c["kw"]
    n = pa.paged_attention_verify.launches
    kernel_ms = device_ms(lambda *a: pa.paged_attention_verify(*a, **kw),
                          copies)
    plain_ms = device_ms(
        lambda *a: pa.paged_attention_verify_reference(*a, **kw), copies)
    B, S, H = SLOTS, V_BLOCKS * PAGE, KV * V_G
    q_pos = pos.long()[:, None] + torch.arange(V_T, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, None, :]
            <= q_pos[:, :, None])[:, None]                   # (B,1,T,S)

    def library(q, k, v, bt, pos):
        # gather the pages, then torch's fused attention with the
        # explicit k_pos <= pos + t mask
        kk = k[bt.long()].reshape(B, S, KV, HD).transpose(1, 2)
        vv = v[bt.long()].reshape(B, S, KV, HD).transpose(1, 2)
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
    pa.paged_attention_verify.launches = n  # comparison launches not counted
    isize = q.element_size()
    bytes_ms, ops_ms = paged_bound(pos, V_T, S, KV * HD * 2 * isize,
                                   KV * V_G * 4 * HD, 2 * q.numel() * isize,
                                   isize)
    bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
    print(f"[kernel] paged_attention_verify bf16 B={SLOTS} T={V_T} KV={KV} "
          f"G={V_G} hd={HD} page={PAGE} "
          f"lines={int((pos.long() + V_T).sum())}: "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"(gather + SDPA) {library_ms:.4f} ms (max abs diff vs plain "
          f"{lib_err:.3e}), bound {bound_ms:.5f} ms ({bound_by}; bytes "
          f"{bytes_ms:.5f} ms, operations {ops_ms:.5f} ms at bf16 peak)")
    return dict(name="paged_attention_verify", route="cuda",
                source="src/repro_torch/csrc/paged_attention_verify.cu",
                replaces="src/repro/kernels/paged_attention.py:557",
                max_abs_err=errs[("bfloat16", "ragged")], ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


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
    """mla_paged_attention_verify (CUDA) vs its plain version, and at
    T = 1 against the MLA decode kernel."""
    import torch.nn.functional as F
    rng = np.random.default_rng(4)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for kind in ("ragged", "edges", "margin", "trash", "small", "t1"):
            c = mla_verify_case(torch, np, rng, dtype, kind)
            errs[(name, kind)] = hold(
                torch, f"mla_paged_attention_verify {name:8s} {kind:6s}",
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
                if not torch.allclose(ver.float(), dec.float(),
                                      **TOL_F32_PLAIN[name]):
                    fail(f"mla_paged_attention_verify at T=1 differs from "
                         f"the decode kernel by {d}")
    # times at the main path's shapes and type: bf16, MLA_LENS; 64 copies
    # of the queries and pools (~225 MB) rotate so every call reads cold HBM
    c = mla_verify_case(torch, np, rng, torch.bfloat16, "ragged")
    q_lat, q_rope, cp, rp, bt, pos = c["args"]
    copies = [(q_lat.clone(), q_rope.clone(), cp.clone(), rp.clone(), bt,
               pos) for _ in range(64)]
    kw = c["kw"]
    n = pa.mla_paged_attention_verify.launches
    kernel_ms = device_ms(
        lambda *a: pa.mla_paged_attention_verify(*a, **kw), copies)
    plain_ms = device_ms(
        lambda *a: pa.mla_paged_attention_verify_reference(*a, **kw), copies)
    B, S = SLOTS, MLA_V_BLOCKS * PAGE
    q_pos = pos.long()[:, None] + torch.arange(MLA_T, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, None, :]
            <= q_pos[:, :, None])[:, None]                   # (B,1,T,S)

    def library(ql, qr, cpool, rpool, bt, pos):
        # gather the latent lines, then torch's fused attention with
        # k = [c | k_rope], v = c shared by every head, and the explicit
        # k_pos <= pos + t mask
        cc = cpool[bt.long()].reshape(B, 1, S, MLA_R)
        kk = torch.cat([cc, rpool[bt.long()].reshape(B, 1, S, MLA_DR)], -1)
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
    pa.mla_paged_attention_verify.launches = n
    bytes_ms, ops_ms = mla_bound(q_lat, q_rope, pos, MLA_T, S)
    bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
    print(f"[kernel] mla_paged_attention_verify bf16 B={SLOTS} T={MLA_T} "
          f"H={MLA_H} r={MLA_R} dr={MLA_DR} page={PAGE} "
          f"lines={int((pos.long() + MLA_T).sum())}: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library (gather + SDPA) "
          f"{library_ms:.4f} ms (max abs diff vs plain {lib_err:.3e}), "
          f"bound {bound_ms:.5f} ms ({bound_by}; bytes {bytes_ms:.5f} ms, "
          f"operations {ops_ms:.5f} ms at bf16 peak)")
    return dict(name="mla_paged_attention_verify", route="cuda",
                source="src/repro_torch/csrc/mla_paged_attention_verify.cu",
                replaces="src/repro/kernels/paged_attention.py:660",
                max_abs_err=errs[("bfloat16", "ragged")], ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


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
    allowance."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out.float()).all()):
        fail(f"{label}: non-finite output")
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


def primitive_holds(torch, np):
    """Each primitive kernel against its plain version on the card at the
    reference benchmarks' shapes and at edge shapes (the card shapes are
    held inside the study): tolerances from launch/primitives.py."""
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
        # reference shape, ragged edges, K = 1, one output, a thin N
        for m, k, n in ((1024, 1024, 1024), (131, 77, 133), (129, 1, 257),
                        (1, 1, 1), (300, 1000, 5)):
            x, w = g((m, k), name), g((k, n), name)
            for fuse in ("none", "relu", "gelu"):
                prim_hold(torch, tally, f"inner_product {name}",
                          f"inner_product {name} {m}x{k}x{n} {fuse}",
                          ip.inner_product(x, w, fuse=fuse),
                          [(ip.inner_product_reference(x, w, fuse=fuse),
                            tolerance("sum", name, k)),
                           (ip.inner_product_reference(
                               x.float(), w.float(), fuse=fuse),
                            tolerance("sum", name, k, vs="plain_f32"))])
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
        # reference shape; C = 3 with odd H / W; even and 1 x 5 kernels
        for n, h, w_, cin, cout, kh, kw in ((4, 28, 28, 128, 128, 3, 3),
                                            (2, 7, 5, 3, 17, 3, 3),
                                            (2, 6, 9, 5, 7, 2, 2),
                                            (1, 5, 4, 8, 9, 1, 5)):
            x = g((n, h, w_, cin), name)
            wt = g((kh, kw, cin, cout), name, CONV_W_SCALE)
            k = kh * kw * cin
            prim_hold(torch, tally, f"conv2d_direct {name}",
                      f"conv2d_direct {name} {x.shape} {wt.shape}",
                      cd.conv2d_direct(x, wt),
                      [(cd.conv2d_direct_reference(x, wt),
                        tolerance("sum", name, k, CONV_W_SCALE)),
                       (cd.conv2d_direct_reference(x.float(), wt.float()),
                        tolerance("sum", name, k, CONV_W_SCALE,
                                  vs="plain_f32"))])
    # Winograd (float32): the stage alone at the reference shape and at
    # edges; the whole convolution with odd H / W and C = 3 against the
    # plain Winograd and the direct convolution
    for p, t, cin, cout in ((16, 784, 128, 128), (16, 1, 1, 1),
                            (16, 37, 3, 130)):
        v, u = g((p, t, cin), "float32"), g((p, cin, cout), "float32")
        prim_hold(torch, tally, "winograd_elementwise_stage float32",
                  f"winograd stage {p}x{t}x{cin}x{cout}",
                  cw.winograd_elementwise_stage(v, u),
                  [(cw.winograd_elementwise_stage_reference(v, u),
                    tolerance("sum", "float32", cin))])
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


def primitives_phase(torch, np, card):
    """The paper's primitive study (PR 14): the measured roofline beside
    the data sheet, the four kernels held at reference and edge shapes,
    then launch/primitives.py's study at card shapes, counted.  Returns
    the kernels-line entries of the four kernels."""
    from repro_torch.core.roofline import microbench
    from repro_torch.kernels import conv_direct as cd
    from repro_torch.kernels import conv_winograd as cw
    from repro_torch.kernels import gelu as gm
    from repro_torch.kernels import inner_product as ip
    from repro_torch.launch import primitives
    t0 = time.perf_counter()
    roof = microbench.run_microbench(cache_path=None, device="cuda")
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
    primitive_holds(torch, np)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()

    counters = {"inner_product": ip.inner_product, "gelu_2d": gm.gelu_2d,
                "conv2d_direct": cd.conv2d_direct,
                "winograd_elementwise_stage": cw.winograd_elementwise_stage}
    for c in counters.values():
        c.launches = 0                           # counts start here
    study = primitives.Study(torch.device("cuda"), roof)
    study.run("card")
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
    entries = []
    for k, row_name in PRIM_ROWS.items():
        r = rows[row_name]
        bytes_ms = r.char["Q_bytes"] / HBM_BW * 1e3
        ops_ms = r.char["W_flops"] / PEAK[r.dtype] * 1e3
        bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
        src, rep = PRIM_SOURCES[k]
        print(f"[kernel] {k} ({row_name}): kernel {r.seconds * 1e3:.4f} ms, "
              f"plain {r.plain_s * 1e3:.4f} ms, library "
              f"{r.library_s * 1e3:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}; data sheet), {r.util_roof * 100:.1f}% of the "
              f"measured roof")
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
        ops.register_kernel(op, cuda=saved["cpu"], reference=saved["cpu"])
        try:
            want = run()
        finally:
            ops.register_kernel(op, cuda=saved["cuda"],
                                reference=saved["cpu"])
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
                 new_tokens: int, op: str, counter, logits_atol: float
                 ) -> int:
    """The continuous-batching engine on ``cfg`` serves PROMPT_LENS; every
    request must finish, the path's kernel ``op`` (wrapper ``counter``)
    must launch once per layer and decode step in that run, and one
    decode step of a second batch must match the same step with the
    plain attention.  Returns the launch count of the measured run."""
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

    engine = Engine(cfg, params, ecfg)
    reqs = [engine.submit(rng.integers(0, cfg.vocab_size, n), gen)
            for n in PROMPT_LENS]
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
    if launches != steps * cfg.n_layers:
        fail(f"{op} launched {launches} times for {steps} decode steps x "
             f"{cfg.n_layers} layers")
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
          f"steps, {op} launches {launches} = steps x {cfg.n_layers}")
    print(f"[engine] {cfg.name} decode logits vs plain attention: max abs "
          f"diff {logits_err:.4e} (atol {logits_atol}; max |logit| "
          f"{scale:.3f})")
    print(f"[engine] {cfg.name} {card}: {n_tok / wall:.2f} tok/s over "
          f"{wall:.3f} s; mean decode step {dec_ms:.3f} ms; "
          f"TTFT mean {np.mean(ttft) * 1e3:.2f} ms, max "
          f"{np.max(ttft) * 1e3:.2f} ms; ledger arithmetic intensity "
          f"{agg.arithmetic_intensity:.3f} FLOP/B; peak memory "
          f"{peak_gb:.2f} GB")
    return launches


def pool_copies(kv):
    """Copies of every page pool of a PagedKVCache (same tree)."""
    return [{b: {k: t.clone() for k, t in blk.items()}
             for b, blk in seg.items()} for seg in kv.pools]


def top2_margin(logits):
    """Host array of each row's top-1 minus top-2 logit."""
    import torch
    v = torch.topk(logits.float(), 2, dim=-1).values
    return (v[:, 0] - v[:, 1]).cpu().numpy()


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
        ops.register_kernel(op, cuda=saved["cpu"], reference=saved["cpu"])
        try:
            pools = pool_copies(kv)
            want = torch.stack([
                decode_step_paged(engine.params, engine.cfg, pools, bt,
                                  feed[:, t:t + 1], pos + t,
                                  page_size=PAGE).float()
                for t in range(T)], dim=1)
        finally:
            ops.register_kernel(op, cuda=saved["cuda"],
                                reference=saved["cpu"])
    counter.launches = n
    rows = torch.as_tensor(slots, device="cuda")
    got, want = got[rows], want[rows]
    if not bool(torch.isfinite(got).all()):
        fail("verify logits are not finite")
    return float((got - want).abs().max()), float(want.abs().max())


def spec_phase(torch, np, card, cfg, params, *, scfg, label: str,
               max_len: int, new_tokens: int, verify_counter,
               decode_counter, decode_op: str, logits_atol: float,
               min_accept=None) -> int:
    """Speculative decoding (SpecEngine with ``scfg``) against the plain
    engine on the same prompts (PROMPT_LENS) and weights.  Every request
    must finish; the verify kernel must launch once per target layer and
    verify step plus, with a draft model, once per draft layer and
    catch-up, and the decode kernel once per draft layer and draft step;
    each speculative stream must equal the plain greedy stream or first
    differ where the plain engine's top-2 logit margin is under
    ``logits_atol``; one verify step of a second batch must match k+1
    sequential plain-attention decode steps within ``logits_atol``;
    acceptance must reach ``min_accept`` when given.  Returns the verify
    kernel's launch count of the measured run."""
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step_paged
    from repro_torch.obs.clock import now
    from repro_torch.serve import (Engine, EngineConfig, GenerateConfig,
                                   SpecEngine, sampling)

    class MarginEngine(Engine):
        """The plain engine, keeping each committed token's top-2 logit
        margin by (request id, token index); its tokens are unchanged."""

        def _decode_sample(self, bt, token, pos):
            logits = decode_step_paged(self.params, self.cfg, self._kv.pools,
                                       bt, token, pos,
                                       page_size=self.ecfg.page_size)
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

    base = MarginEngine(cfg, params, ecfg)
    base.margins = {}
    breqs = [base.submit(p, gen) for p in prompts]
    torch.cuda.synchronize()
    t0 = now()
    base.run()
    torch.cuda.synchronize()
    base_wall = now() - t0

    engine = SpecEngine(cfg, params, ecfg, scfg)
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
    steps = engine.verify_steps
    rounds = engine.phases["draft"].steps
    ver, dra = engine.phases["verify"], engine.phases["draft"]
    agg, base_agg = engine.aggregate_ledger(), base.aggregate_ledger()

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
    want_v = steps * cfg.n_layers + (rounds * dcfg.n_layers if dcfg else 0)
    want_d = rounds * (scfg.k - 1) * dcfg.n_layers if dcfg else 0
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
          f"round {dra.wall_s / max(dra.steps, 1) * 1e3:.3f} ms); "
          f"acceptance rate {acc:.3f} (random weights), tokens per verify "
          f"pass {agg.tokens_per_pass:.3f}; ledger arithmetic intensity "
          f"{agg.arithmetic_intensity:.3f} FLOP/B (plain "
          f"{base_agg.arithmetic_intensity:.3f}); peak memory "
          f"{peak_gb:.2f} GB")
    if min_accept is not None and acc < min_accept:
        fail(f"{label}: acceptance rate {acc} < {min_accept}")
    return v_launches


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
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in (SRC / "repro_torch" / "csrc").glob(
        "*.cu"))
    logs = build.build(sources)
    print(f"[build] {', '.join(sources)} built in "
          f"{time.perf_counter() - t0:.1f} s (nvcc sm_90a)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

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

    entry = kernel_phase(torch, np, pa)
    verify_entry = gqa_verify_kernel_phase(torch, np, pa)
    mla_entry = mla_kernel_phase(torch, np, pa)
    mla_verify_entry = mla_verify_kernel_phase(torch, np, pa)
    prim_entries = primitives_phase(torch, np, card)

    params = make_params(torch, qwen)
    entry["launches"] = engine_phase(
        torch, np, card, qwen, params, max_len=MAX_LEN,
        new_tokens=NEW_TOKENS, op="paged_attention",
        counter=pa.paged_attention, logits_atol=LOGITS_ATOL)
    spec_phase(torch, np, card, qwen, params,
               scfg=SpecConfig(k=SPEC_K, proposer="draft", draft_cfg=qwen,
                               draft_params=params),
               label="qwen3-0.6b self-draft", max_len=MAX_LEN,
               new_tokens=NEW_TOKENS,
               verify_counter=pa.paged_attention_verify,
               decode_counter=pa.paged_attention,
               decode_op="paged_attention", logits_atol=LOGITS_ATOL,
               min_accept=SELF_DRAFT_MIN_ACCEPT)
    del params

    params = make_params(torch, deepseek)
    mla_entry["launches"] = engine_phase(
        torch, np, card, deepseek, params, max_len=DS_MAX_LEN,
        new_tokens=DS_NEW_TOKENS, op="mla_paged_attention",
        counter=pa.mla_paged_attention, logits_atol=DS_LOGITS_ATOL)
    mla_verify_entry["launches"] = spec_phase(
        torch, np, card, deepseek, params,
        scfg=SpecConfig(k=MLA_SPEC_K, proposer="ngram"),
        label="deepseek-v2-236b (4 layers) n-gram", max_len=DS_MAX_LEN,
        new_tokens=DS_NEW_TOKENS,
        verify_counter=pa.mla_paged_attention_verify,
        decode_counter=pa.mla_paged_attention,
        decode_op="mla_paged_attention", logits_atol=DS_LOGITS_ATOL)
    del params

    draft = make_params(torch, qwen)
    params = make_params(torch, q14)
    verify_entry["launches"] = spec_phase(
        torch, np, card, q14, params,
        scfg=SpecConfig(k=SPEC_K, proposer="draft", draft_cfg=qwen,
                        draft_params=draft),
        label="qwen3-14b + qwen3-0.6b draft", max_len=MAX_LEN,
        new_tokens=NEW_TOKENS, verify_counter=pa.paged_attention_verify,
        decode_counter=pa.paged_attention, decode_op="paged_attention",
        logits_atol=SPEC_LOGITS_ATOL)
    del params, draft
    print(json.dumps({"kernels": [entry, verify_entry, mla_entry,
                                  mla_verify_entry, *prim_entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
