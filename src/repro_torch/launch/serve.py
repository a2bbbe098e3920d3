"""Serving launcher: continuous-batching generation with the paged engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --batch 6 --prompt-len 64 --new-tokens 32 --slots 4
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-236b --layers 4 --batch 6 --slots 4 \\
        --prefill-chunk 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \\
        --batch 6 --slots 4 --prefill-chunk 64
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-v0.1-52b --layers 8 --batch 6 --slots 4 \\
        --prefill-chunk 64

Recurrent and hybrid archs (xlstm-350m, jamba-v0.1-52b) keep per-slot
state rows beside the pages; ``--spec`` and ``--prefix-cache`` refuse
them, as the reference does.

Encoder-decoder and vision archs (whisper-small, llama-3.2-vision-90b)
have cross-attention caches that do not page: they run the static
whole-batch engine (serve/engine.py ``StaticEngine``: one prefill of the
``--batch`` prompts, then lockstep decode, its step a captured CUDA graph
on the card) over stub frame / patch embeddings drawn from ``--seed``,
and print ``[serve/static] ... tok/s`` and the first sequence:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama-3.2-vision-90b --layers 10 --batch 2

The paged engine's options (``--slots``, ``--prefill-chunk``, ``--spec``,
``--prefix-cache``, ``--num-pages``, the pipelines and KV dtypes,
telemetry) do not apply to them.

Speculative decoding (serve/spec.py):

    ... --spec ngram --spec-k 4                  # weight-free prompt lookup
    ... --arch qwen3-14b --spec draft --draft-arch qwen3-0.6b
    ... --spec draft --spec-k-adaptive           # EWMA-adapted draft length

Sampling and block-pool memory management (serve/block_pool.py), with
the reference's flags: ``--temperature``, ``--top-k`` and ``--top-p``
sample every request from its own seeded stream (request ``b`` seeded
``sampling.fold_seed(--seed, b)``; temperature 0 is greedy); pages are
allocated on demand as contexts grow; ``--prefix-cache`` shares prompt
prefixes by content-hash page aliasing with copy-on-write on divergence;
an undersized pool (``--num-pages``, the trash page included; 0 = fully
backed) preempts the newest running request when it runs dry, by
``--preempt swap`` (pages to host memory and back) or ``--preempt
recompute`` (dropped, re-prefilled on resume); ``--watermark`` keeps that
fraction of the pool free at admission.  Each run prints the reference's
``[serve/capacity]`` line (serve/crosscheck.py::capacity_report):

    ... --prefix-cache --num-pages 24 --watermark 0.1 --preempt swap \
        --temperature 0.8 --top-k 50 --top-p 0.9

``--pipeline double`` runs the paged-attention ring kernels (the JAX
package's double-buffered page walk; bit-identical to ``off``) for the
decode, verify and draft steps; on the CPU the plain versions run either
way.  ``--kv-dtype int8|fp8_e4m3`` stores the target's KV pages quantized
(a float32 scale per line; the paged kernels, off and ring alike,
dequantize in their page walk) under either pipeline; the draft model
keeps its own.

Telemetry (``obs/``): ``--trace OUT.json`` writes the run's Chrome
trace-event timeline (chrome://tracing, ui.perfetto.dev),
``--metrics-snapshot OUT.prom`` a Prometheus text snapshot; either turns
telemetry on and prints the live roofline-attainment windows and the
hierarchical roofline report after the run.  ``--chip measured`` runs the
card's microbenchmarks (core/roofline/microbench.py, cached in
``results/microbench_torch.json``) and prices the ledger, the windows and
the report on the measured betas instead of the data sheet:

    ... --trace t.json --metrics-snapshot m.prom --chip measured

Runs on the card by default (``--device cuda``), where the decode,
verify, draft and prefill steps replay captured CUDA graphs;
``--device cpu`` runs the plain PyTorch path (use ``--smoke`` there).
``--layers`` cuts depth only (a dense-FFN prologue stays),
``--draft-layers`` the draft model's.
Weights are random, from generators seeded ``--seed`` (target) and
``--seed + 1`` (draft).  Prints tokens/s, the per-request decode roofline
ledger line with its TTFT and inter-token latency and, with ``--spec``,
the acceptance rate and tokens per verify pass (on random weights these
say nothing about real drafts).

Tensor parallelism (serve/shard.py): ``--mesh dp,tp`` with dp 1 starts
tp ranks (parallel/mesh.py ``spawn``), one NCCL rank per card on CUDA
(more ranks than cards is refused) or gloo ranks with ``--device cpu``;
each builds the same sharded engine, drawing only its shards of the
weights, and rank 0 prints the run and the ``[serve/mesh]``
communication roofline (per-card HBM beside the card-to-card link).
``--overlap ring`` runs the row-parallel epilogues as ring matmuls:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --mesh 1,2 --batch 3 --prompt-len 12 --new-tokens 6 --slots 2

The multi-replica tier (serve/cluster.py, serve/router.py): ``--router``
(implied by ``--mesh dp,1`` with dp > 1) serves through the front door
over dp replica engines, ``--roles disagg`` splits them into prefill and
decode replicas with KV pages migrating between them, ``--link dcn|ici``
names the wire the migration roofline term prices.  A host with fewer
cards than replicas colocates them (one card steps them in turn, one
copy of the weights).  Prints the router's tok/s, each request's TTFT
split and migrations, the migration roofline and the fleet's capacity:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --mesh 2,1 --router --roles disagg --batch 3 --prompt-len 12 \
        --new-tokens 6 --slots 2

The reference's other flags: ``--backend`` has no counterpart, since the
port has one kernel backend per op; ``--chip`` takes ``sheet`` or
``measured`` here (the card), not a TPU.  A tp > 1 replica behind the
router is refused (ROADMAP queue 1 item 18).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs import ALL_ARCHS, get_config, smoke
from ..core.roofline import microbench
from ..core.roofline.hardware import H100_SXM
from ..core.roofline.report import (ATTAINMENT_HEADER, COMM_HEADER,
                                    attainment_rows, comm_terms_row,
                                    text_table)
from ..device import resolve_device, synchronize
from ..models import init_params
from ..models.params import torch_dtype
from ..obs.clock import now
from ..parallel.mesh import make_host_mesh, rank_device, spawn
from ..serve import (Engine, EngineConfig, GenerateConfig, SpecConfig,
                     SpecEngine, make_engine, param_pspecs, parse_mesh,
                     sampling, speculative_summary, supports_spec,
                     tp_sharding_error)
from ..serve.crosscheck import capacity_report
from ..serve.kv_cache import supports_paging


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ALL_ARCHS), default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0 = all)")
    ap.add_argument("--spec", choices=["off", "ngram", "draft"],
                    default="off",
                    help="speculative decoding proposer (serve/spec.py)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens per verify round")
    ap.add_argument("--spec-k-adaptive", action="store_true",
                    help="EWMA-adapted drafted length within the fixed "
                         "verify shape")
    ap.add_argument("--draft-arch", default="qwen3-0.6b",
                    help="draft model arch for --spec draft (shrunk with "
                         "--smoke)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="cut the draft model to this many layers (0 = all)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k sampling filter (0 = off)")
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="nucleus sampling mass (0 or >= 1 = off)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-hash prefix sharing + copy-on-write "
                         "(serve/block_pool.py)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="block-pool size incl. trash page (0 = fully "
                         "backed; smaller exercises preemption)")
    ap.add_argument("--watermark", type=float, default=0.0,
                    help="admission slack as a fraction of pool pages")
    ap.add_argument("--preempt", choices=["swap", "recompute"],
                    default="swap",
                    help="pool-dry preemption: swap pages to host or "
                         "drop + recompute on resume")
    ap.add_argument("--slots", type=int, default=0,
                    help="decode slots (0 = one per request)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--pipeline", choices=["off", "double"], default="off",
                    help="paged-attention page streaming: single walk "
                         "(off) or the cp.async ring kernels (double)")
    ap.add_argument("--kv-dtype", choices=["bf16", "int8", "fp8_e4m3"],
                    default=None,
                    help="KV page storage (default: the arch config's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="turn telemetry on and write the Chrome "
                         "trace-event timeline here")
    ap.add_argument("--metrics-snapshot", default=None, metavar="OUT.prom",
                    help="turn telemetry on and write a Prometheus "
                         "text-exposition metrics snapshot here")
    ap.add_argument("--chip", choices=["sheet", "measured"], default="sheet",
                    help="price the roofline on the data sheet (H100 SXM) "
                         "or on the card's measured betas (microbench)")
    ap.add_argument("--mesh", default="1,1",
                    help="dp,tp: dp serving replicas behind the router, "
                         "or tp tensor-parallel ranks")
    ap.add_argument("--overlap", choices=["none", "ring"], default="none",
                    help="tensor-parallel epilogue: blocking all-reduce or "
                         "ring matmul")
    ap.add_argument("--router", action="store_true",
                    help="serve through the multi-replica front door "
                         "(serve/router.py); implied by --mesh dp,1 with "
                         "dp > 1")
    ap.add_argument("--roles", choices=["mixed", "disagg"], default="mixed",
                    help="replica roles for --router: 'mixed' serves each "
                         "request end to end, 'disagg' splits the fleet "
                         "into prefill and decode replicas with KV-page "
                         "migration between them (serve/cluster.py)")
    ap.add_argument("--link", choices=["dcn", "ici"], default="dcn",
                    help="wire level the migration snapshots are priced on "
                         "(the 'migration' roofline term)")
    return ap


def _model_config(args):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def main(argv=None):
    args = _parser().parse_args(argv)
    dp, tp = parse_mesh(args.mesh)
    if dp < 1 or tp < 1:
        raise SystemExit(f"--mesh {args.mesh}: dp and tp must be >= 1")
    if args.router or dp > 1:
        if tp != 1:
            raise SystemExit(f"--mesh {args.mesh}: a tp > 1 replica behind "
                             "the router needs tp ranks of its own "
                             "(ROADMAP queue 1 item 18); serve replicas "
                             "at tp 1")
        return _serve(args, dp=dp)
    if tp == 1:
        return _serve(args)
    err = tp_sharding_error(_model_config(args), tp)
    if err:
        raise SystemExit(err)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and torch.cuda.device_count() < tp:
        raise SystemExit(
            f"--mesh 1,{tp} runs one NCCL rank per card; this machine has "
            f"{torch.cuda.device_count()} card(s) (use --device cpu for "
            "gloo ranks on the CPU)")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    # measured once, here, before any rank starts: the ici probes take
    # cards 0 and 1 and must not run beside the ranks or each other
    roof = (microbench.run_microbench(device=rank_device(0, args.device))
            if args.chip == "measured" else None)
    spawn(_serve_rank, tp, backend=backend, device=dev.type,
          args=(args, roof))


def _serve_rank(rank: int, world: int, args, roof) -> None:
    """One tensor-parallel rank of :func:`main`; rank 0 prints."""
    _serve(args, tp=world, rank=rank, roof=roof)


def _serve(args, tp: int = 1, rank: int = 0, roof=None,
           dp: int = 0) -> None:
    """Serve on one card, or as rank ``rank`` of ``tp``; ``roof`` is the
    microbenchmark result measured before the ranks started (``--chip
    measured`` at tp > 1).  ``dp`` > 0 serves through the router over
    that many replicas (:func:`_run_router`)."""
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = _model_config(args)
    dev = (resolve_device(args.device) if tp == 1
           else rank_device(rank, args.device))
    mesh = make_host_mesh(1, tp) if tp > 1 else None
    chip = H100_SXM
    if args.chip == "measured":
        if roof is None:
            roof = microbench.run_microbench(device=dev)
        chip = roof.to_chipspec()
        say(f"[serve/chip] {chip.name}: beta hbm "
            f"{chip.hbm_bw / 1e12:.3f} TB/s, vmem (L2-resident stream) "
            f"{chip.vmem_bw / 1e12:.3f} TB/s, host (pinned copy) "
            f"{chip.host_bw / 1e9:.2f} GB/s, host overlap "
            f"{roof.overlap.get('host', float('nan')):.2f}")
    telemetry = bool(args.trace or args.metrics_snapshot)
    gen_ = torch.Generator(device=dev).manual_seed(args.seed)
    # a rank draws the whole generator sequence but keeps its shards only
    params = init_params(cfg, gen_, dev, **(
        {} if mesh is None else dict(specs=param_pspecs(cfg, mesh),
                                     mesh=mesh)))
    if not supports_paging(cfg):
        if dp:
            raise SystemExit(f"{cfg.name}: --router needs the paged decode "
                             "path (decoder-only archs)")
        if telemetry or args.spec != "off":
            raise SystemExit(f"{cfg.name}: the static engine takes no "
                             "--spec or telemetry (paged engine only)")
        return _run_static(args, cfg, params, dev)
    slots = args.slots or args.batch
    ecfg = EngineConfig(
        num_slots=slots, page_size=args.page_size,
        max_len=args.prompt_len + args.new_tokens,
        prefill_chunk=args.prefill_chunk, pipeline=args.pipeline,
        kv_dtype=args.kv_dtype, device=dev, chip=chip, telemetry=telemetry,
        prefix_cache=args.prefix_cache, num_pages=args.num_pages or None,
        watermark=args.watermark, preempt_mode=args.preempt,
        overlap=args.overlap)
    scfg = None
    if args.spec != "off":
        if not supports_spec(cfg):
            raise SystemExit(f"{cfg.name}: --spec needs attention/MLA "
                             "mixers throughout")
        if args.spec == "draft":
            dcfg = get_config(args.draft_arch)
            if args.smoke:
                dcfg = smoke(dcfg)
            if args.draft_layers:
                dcfg = dataclasses.replace(dcfg, n_layers=args.draft_layers)
            dgen = torch.Generator(device=dev).manual_seed(args.seed + 1)
            scfg = SpecConfig(k=args.spec_k, proposer="draft",
                              draft_cfg=dcfg,
                              draft_params=init_params(dcfg, dgen, dev),
                              adaptive=args.spec_k_adaptive)
        else:
            scfg = SpecConfig(k=args.spec_k, proposer="ngram",
                              adaptive=args.spec_k_adaptive)
    if dp:
        return _run_router(args, cfg, params, ecfg, scfg, dp, dev)
    if mesh is not None:
        engine = make_engine(cfg, params, ecfg, scfg, mesh_shape=(1, tp),
                             mesh=mesh)
    elif scfg is None:
        engine = Engine(cfg, params, ecfg)
    else:
        engine = SpecEngine(cfg, params, ecfg, scfg)
    rng = np.random.default_rng(args.seed)
    gen = GenerateConfig(max_new_tokens=args.new_tokens,
                         temperature=args.temperature, top_k=args.top_k,
                         top_p=args.top_p)
    reqs = [engine.submit(rng.integers(0, cfg.vocab_size, args.prompt_len),
                          gen, seed=sampling.fold_seed(args.seed, b))
            for b in range(args.batch)]
    t0 = now()
    engine.run()
    synchronize(dev)
    dt = now() - t0
    if engine.obs is not None:
        engine.obs.harvest(engine)    # the last window ends with the run
    n_tok = sum(len(r.generated) for r in reqs)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(f"[serve] {len(reqs)} requests, {n_tok} tokens in {dt:.3f}s = "
        f"{n_tok / dt:.1f} tok/s over {slots} slots on {where} "
        f"(pipeline {args.pipeline}), kv_dtype {engine.cfg.kv_dtype}"
        + (f", tp {tp} over {mesh.backend}, overlap {args.overlap}"
           if mesh is not None else ""))
    for r in reqs:
        t = engine.roofline_terms(r)
        lat = r.latency_stats()
        say(f"  req {r.request_id}: {len(r.generated)} tok, "
            f"ttft {lat['ttft_s'] * 1e3:.1f} ms, itl p50 "
            f"{lat['itl_p50_s'] * 1e3:.2f} ms p95 "
            f"{lat['itl_p95_s'] * 1e3:.2f} ms, "
            f"AI={t.arithmetic_intensity:.2f} FLOP/B, {t.bound_class()}, "
            f"mean batch {r.ledger.mean_batch:.2f}")
    if mesh is not None:
        # which roof binds decode at this width: per-card HBM or the link
        say(f"[serve/mesh] communication roofline (tp={tp}, "
            f"{mesh.backend}; ici beta {chip.ici_bw / 1e9:.0f} GB/s):")
        say(text_table([comm_terms_row(f"req {r.request_id}",
                                       engine.roofline_terms(r))
                        for r in reqs[:4]], COMM_HEADER))
    cap = capacity_report(engine)
    say(f"[serve/capacity] pages peak={cap['pages_peak']}"
        f"/{cap['pages_total']} ({cap['page_bytes']} B/page), "
        f"deduped={cap['pages_deduped']} cow={cap['cow_copies']} "
        f"preemptions={cap['preemptions']}, effective batch "
        f"{cap['effective_batch']} vs capacity-implied max "
        f"{cap['capacity_max_batch']} on {chip.name}")
    if scfg is not None:
        s = speculative_summary(cfg, reqs, args.spec_k,
                                args.prompt_len + args.new_tokens // 2,
                                draft_cfg=scfg.draft_cfg)
        say(f"[serve/spec] proposer={args.spec} k={args.spec_k} "
            f"acceptance={s['acceptance_rate']:.2f} (random weights) "
            f"tokens/pass={s['tokens_per_pass']:.2f} (predicted "
            f"{s['predicted_tokens_per_pass']:.2f}), predicted "
            f"memory-bound speedup x{s['predicted_speedup']:.2f}")
    if rank == 0:
        _export_telemetry(args, engine, roof)
    say("[serve] first sequence:", reqs[0].generated[:16])


def _run_router(args, cfg, params, ecfg, scfg, dp: int, dev) -> None:
    """The multi-replica tier: a Cluster of dp replica engines (at least
    two under ``--roles disagg``: half prefill, half decode) behind the
    Router, with each request's TTFT split, the migration ledger and
    roofline, and the fleet's capacity beside the throughput."""
    from ..core.roofline.report import MIGRATION_HEADER, migration_row
    from ..serve import Cluster, RoleConfig, Router
    dp = max(dp, 2 if args.roles == "disagg" else 1)
    if args.roles == "disagg":
        n_pre = max(dp // 2, 1)
        roles = RoleConfig.disaggregated(n_pre, dp - n_pre, link=args.link)
    else:
        roles = RoleConfig.mixed(dp, link=args.link)
    cluster = Cluster(cfg, params, ecfg, scfg, mesh_shape=(dp, 1),
                      roles=roles)
    router = Router(cluster)
    rng = np.random.default_rng(args.seed)
    gen = GenerateConfig(max_new_tokens=args.new_tokens,
                         temperature=args.temperature, top_k=args.top_k,
                         top_p=args.top_p)
    reqs = [router.submit(rng.integers(0, cfg.vocab_size, args.prompt_len),
                          gen, seed=sampling.fold_seed(args.seed, b))
            for b in range(args.batch)]
    t0 = now()
    done = router.run()
    synchronize(dev)
    dt = now() - t0
    n_new = sum(len(r.generated) for r in done)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    place = ("colocated on one device, stepped in turn" if cluster.colocated
             else "one device each")
    print(f"[serve/router] {len(done)} requests, {n_new} new tokens in "
          f"{dt:.3f}s ({n_new / dt:.1f} tok/s) over dp={dp} tp=1 replicas "
          f"({place}, {where}; roles {','.join(roles.roles)})")
    for r in sorted(done, key=lambda r: r.request_id)[:4]:
        bd = r.ttft_breakdown()
        print(f"[serve/router]   req {r.request_id}: {len(r.generated)} "
              f"tokens ({r.finish_reason}), ttft={r.ttft * 1e3:.1f}ms = "
              f"queue {bd['queue_wait_s'] * 1e3:.1f} + prefill "
              f"{bd['prefill_s'] * 1e3:.1f} + first-decode "
              f"{bd['first_decode_s'] * 1e3:.1f}, "
              f"migrations={r.ledger.migrations}")
    stats = router.stats()
    print(f"[serve/router] migrations={router.migrations} "
          f"({stats['migration_bytes'] / 1e3:.1f} kB packed KV over "
          f"{roles.link}), ttft p50={stats['ttft_p50_s'] * 1e3:.1f}ms "
          f"p95={stats['ttft_p95_s'] * 1e3:.1f}ms")
    chip = ecfg.chip
    if router.migrations:
        print(f"[serve/router] migration roofline on {chip.name}:")
        print(text_table([migration_row("fleet decode",
                                        cluster.roofline_terms())],
                         MIGRATION_HEADER))
    cap = capacity_report(cluster)
    per = ", ".join(
        f"r{r['replica']}({r['role']}) {r['pages_peak']}pk"
        f"/{r['pages_in_use']}use" if r["live"] else
        f"r{r['replica']}({r['role']}) idle" for r in cap["replicas"])
    print(f"[serve/capacity] fleet pages peak={cap['pages_peak']}"
          f"/{cap['pages_total']}, per-replica [{per}], cluster B_max="
          f"{cap['capacity_max_batch']} on {chip.name}")
    obs = cluster.obs
    if obs is not None:
        obs.harvest(cluster)
        if args.trace:
            obs.export_trace(args.trace)
            print(f"[serve/obs] trace written to {args.trace} "
                  f"({len(obs.tracer.events)} events): load it in "
                  "chrome://tracing or ui.perfetto.dev")
        if args.metrics_snapshot:
            obs.snapshot(args.metrics_snapshot)
            print(f"[serve/obs] metrics snapshot written to "
                  f"{args.metrics_snapshot}")
        if obs.attainment.windows:
            print(f"[serve/obs] roofline attainment windows on "
                  f"{chip.name}:")
            print(text_table(attainment_rows(obs.attainment.windows),
                             ATTAINMENT_HEADER))
    first = min(done, key=lambda r: r.request_id)
    print("[serve] first sequence:", first.generated[:16])


def _run_static(args, cfg, params, dev) -> None:
    """The static whole-batch engine over ``--batch`` prompts of
    ``--prompt-len`` tokens, with frame / patch embeddings drawn from a
    generator seeded ``--seed``; sampled rows take seeds ``--seed + b``."""
    rng = np.random.default_rng(args.seed)
    prompts = np.stack([rng.integers(0, cfg.vocab_size, args.prompt_len)
                        for _ in range(args.batch)])
    emb = torch.Generator(device=dev).manual_seed(args.seed)
    dt_ = torch_dtype(cfg.dtype)
    kwargs = {}
    if cfg.is_encoder_decoder:
        kwargs["enc_embeds"] = torch.randn(
            (args.batch, cfg.n_audio_frames, cfg.d_model), generator=emb,
            device=dev).to(dt_)
    if cfg.n_image_tokens:
        kwargs["img_embeds"] = torch.randn(
            (args.batch, cfg.n_image_tokens, cfg.d_model), generator=emb,
            device=dev).to(dt_)
    engine = Engine(cfg, params, EngineConfig(device=dev))
    gen = GenerateConfig(max_new_tokens=args.new_tokens,
                         temperature=args.temperature, top_k=args.top_k,
                         top_p=args.top_p)
    t0 = now()
    out = engine.generate(prompts, gen, seed=args.seed, **kwargs)
    synchronize(dev)
    dt = now() - t0
    toks = out["tokens"]
    n_new = toks.shape[1] - args.prompt_len
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    st = engine.static_engine()
    print(f"[serve/static] {args.batch} seqs x {n_new} new tokens in "
          f"{dt:.2f}s ({args.batch * n_new / dt:.1f} tok/s) on {where}: "
          f"prefill {st.prefill_s * 1e3:.1f} ms, {st.decode_steps} decode "
          f"steps" + (f", mean {np.mean(st.decode_s) * 1e3:.3f} ms"
                      if st.decode_s else ""))
    print("[serve] first sequence:", toks[0, args.prompt_len:].tolist())


def _export_telemetry(args, engine, roof) -> None:
    """After the run (harvested as it ended): write the requested trace
    and snapshot, and print the attainment windows and the hierarchical
    roofline report (on the measured betas with ``--chip measured``)."""
    obs = engine.obs
    if obs is None:
        return
    if args.trace:
        obs.export_trace(args.trace)
        print(f"[serve/obs] trace written to {args.trace} "
              f"({len(obs.tracer.events)} events): load it in "
              "chrome://tracing or ui.perfetto.dev")
    if args.metrics_snapshot:
        obs.snapshot(args.metrics_snapshot)
        print(f"[serve/obs] metrics snapshot written to "
              f"{args.metrics_snapshot}")
    if obs.attainment.windows:
        print(f"[serve/obs] roofline attainment windows on "
              f"{engine.ecfg.chip.name}:")
        print(text_table(attainment_rows(obs.attainment.windows),
                         ATTAINMENT_HEADER))
    engine.measure_dispatch_overhead()
    print(engine.hierarchy_report(
        betas=roof.level_betas() if roof is not None else None,
        overlap=roof.overlap if roof is not None else None))


if __name__ == "__main__":
    main()
