"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one NVIDIA H100, from a repo checkout

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together) and print the build time;
3. kernel phases: each kernel (GQA ``paged_attention``, MLA
   ``mla_paged_attention``) against its plain PyTorch version on the card
   at its main path's shapes and at its edge cases, with the tolerance
   stated; times (CUDA events) of the kernel, the plain version and one
   PyTorch library call computing the same function, beside the bound;
4. engine phases, one per path: the continuous-batching engine serves
   requests on full-width qwen3-0.6b (GQA) and on full-width
   deepseek-v2-236b cut to 4 layers (MLA + MoE), random weights from a
   generator seeded 0; every request must finish, the path's kernel
   launch count (zeroed just before the run, read just after) must equal
   decode steps x layers, and one decode step's logits must match the
   same step run with the plain attention;
5. one JSON line listing every ported kernel, then the device line last.

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


def attention_bound_ms(c) -> float:
    """Least time for the call: live K/V lines, q, out, the live table
    entries and positions each moved once, over HBM bandwidth; versus
    4 * G * hd FLOPs per live (line, kv head) at the dtype's peak."""
    isize = c["q"].element_size()
    lines = int((c["pos"].long() + 1).sum())
    pages = int(((c["pos"].long() // PAGE) + 1).sum())
    nbytes = (lines * KV * HD * 2 * isize + 2 * c["q"].numel() * isize
              + pages * 4 + SLOTS * 4)
    flops = lines * KV * 4 * G * HD
    dt = "bfloat16" if isize == 2 else "float32"
    return max(nbytes / HBM_BW, flops / PEAK[dt]) * 1e3


def kernel_phase(torch, np, pa):
    """paged_attention (CUDA) vs paged_attention_reference on the card."""
    import torch.nn.functional as F
    rng = np.random.default_rng(0)
    rows, errs = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for kind in ("ragged", "full", "trash", "soft_cap"):
            c = attention_case(torch, np, rng, dtype, kind)
            args = (c["q"], c["k"], c["v"], c["bt"], c["pos"])
            kw = dict(scale=c["scale"], soft_cap=c["soft_cap"])
            out = pa.paged_attention(*args, **kw)
            ref = pa.paged_attention_reference(*args, **kw)
            ref32 = pa.paged_attention_reference(
                *(a.float() for a in args[:3]), *args[3:], **kw)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out).all()):
                fail(f"paged_attention {name}/{kind}: non-finite output")
            err = float((out.float() - ref.float()).abs().max())
            err32 = float((out.float() - ref32).abs().max())
            tol, tol32 = TOL[name], TOL_F32_PLAIN[name]
            ok = (bool(torch.allclose(out.float(), ref.float(), **tol))
                  and bool(torch.allclose(out.float(), ref32, **tol32)))
            print(f"[kernel] paged_attention {name:8s} {kind:8s} "
                  f"max_abs_err={err:.3e} (atol=rtol={tol['atol']}); vs "
                  f"plain in f32 {err32:.3e} (atol=rtol={tol32['atol']}) "
                  f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"paged_attention {name}/{kind} disagrees with its "
                     f"plain version: max abs err {err}")
            errs[(name, kind)] = err
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
    bound_ms = attention_bound_ms(c)
    print(f"[kernel] paged_attention bf16 B={SLOTS} KV={KV} G={G} hd={HD} "
          f"page={PAGE} lines={int((c['pos'].long() + 1).sum())}: "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"(gather + SDPA) {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"(bytes)")
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:345",
                max_abs_err=errs[("bfloat16", "ragged")], ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
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
                scale=(128 + 64) ** -0.5, page=page)


def mla_bound(c):
    """(bytes ms, operations ms): live latent + rope lines, q_lat, q_rope,
    out, the live table entries and positions each moved once over HBM
    bandwidth; H * (2 (r + dr) + 2 r) FLOPs per live line at the dtype's
    peak."""
    q_lat, q_rope, cp, rp, bt, pos = c["args"]
    B, H, r = q_lat.shape
    dr = q_rope.shape[-1]
    isize = q_lat.element_size()
    lines = int((pos.long() + 1).sum())
    pages = int((pos.long() // c["page"] + 1).sum())
    nbytes = (lines * (r + dr) * isize + q_rope.numel() * isize
              + 2 * q_lat.numel() * isize + pages * 4 + B * 4)
    flops = lines * H * (2 * (r + dr) + 2 * r)
    dt = "bfloat16" if isize == 2 else "float32"
    return nbytes / HBM_BW * 1e3, flops / PEAK[dt] * 1e3


def mla_kernel_phase(torch, np, pa):
    """mla_paged_attention (CUDA) vs mla_paged_attention_reference."""
    import torch.nn.functional as F
    rng = np.random.default_rng(2)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for kind in ("ragged", "edges", "trash", "small"):
            c = mla_case(torch, np, rng, dtype, kind)
            args, kw = c["args"], dict(scale=c["scale"])
            out = pa.mla_paged_attention(*args, **kw)
            ref = pa.mla_paged_attention_reference(*args, **kw)
            ref32 = pa.mla_paged_attention_reference(
                *(a.float() for a in args[:4]), *args[4:], **kw)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out).all()):
                fail(f"mla_paged_attention {name}/{kind}: non-finite output")
            err = float((out.float() - ref.float()).abs().max())
            err32 = float((out.float() - ref32).abs().max())
            tol, tol32 = TOL[name], TOL_F32_PLAIN[name]
            ok = (bool(torch.allclose(out.float(), ref.float(), **tol))
                  and bool(torch.allclose(out.float(), ref32, **tol32)))
            print(f"[kernel] mla_paged_attention {name:8s} {kind:6s} "
                  f"max_abs_err={err:.3e} (atol=rtol={tol['atol']}); vs "
                  f"plain in f32 {err32:.3e} (atol=rtol={tol32['atol']}) "
                  f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"mla_paged_attention {name}/{kind} disagrees with its "
                     f"plain version: max abs err {err}")
            errs[(name, kind)] = err
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
    bytes_ms, ops_ms = mla_bound(c)
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
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
        pools = [{b: {k: t.clone() for k, t in blk.items()}
                  for b, blk in seg.items()} for seg in kv.pools]
        return decode_step_paged(engine.params, engine.cfg, pools, bt, tok,
                                 pos, page_size=PAGE).float()

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


def engine_phase(torch, np, card, cfg, *, max_len: int, new_tokens: int,
                 op: str, counter, logits_atol: float) -> int:
    """The continuous-batching engine on ``cfg`` (random weights from a
    generator seeded 0) serves PROMPT_LENS; every request must finish,
    the path's kernel ``op`` (wrapper ``counter``) must launch once per
    layer and decode step in that run, and one decode step of a second
    batch must match the same step with the plain attention.  Returns
    the launch count of the measured run."""
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, param_count
    from repro_torch.obs.clock import now
    from repro_torch.serve import Engine, EngineConfig, GenerateConfig
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

    entry = kernel_phase(torch, np, pa)
    mla_entry = mla_kernel_phase(torch, np, pa)
    entry["launches"] = engine_phase(
        torch, np, card, qwen, max_len=MAX_LEN, new_tokens=NEW_TOKENS,
        op="paged_attention", counter=pa.paged_attention,
        logits_atol=LOGITS_ATOL)
    mla_entry["launches"] = engine_phase(
        torch, np, card, deepseek, max_len=DS_MAX_LEN,
        new_tokens=DS_NEW_TOKENS, op="mla_paged_attention",
        counter=pa.mla_paged_attention, logits_atol=DS_LOGITS_ATOL)
    print(json.dumps({"kernels": [entry, mla_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
