"""The card's roofline, measured: the paper's sections 2.1-2.2 on the card.

The paper measures peak compute with runtime-generated FMA chains and peak
bandwidth as the best of several streaming probes, with warm- and
cold-cache protocols.  Here:

* :func:`measure_peak_flops`: the hand-written FMA-chain probe
  ``csrc/fma_probe.cu`` (independent float32 FMA chains per thread), the
  CUDA cores' roof, which float32 work is placed against;
* :func:`measure_peak_matmul_flops`: ``torch.matmul`` per dtype (float32
  with TF32 off; bf16 on the tensor cores), the roof bf16 work is placed
  against;
* :func:`measure_peak_bandwidth`: copy, fill and triad over 1 GiB buffers
  (20x the H100's 50 MB L2), best of the three;
* :func:`measure_warm_vs_cold`: one streaming pass over buffers that sit
  in L2 against the same pass after a larger-than-L2 write evicted them;
* the per-level betas of the hierarchical roofline (arXiv 2009.05257):
  :func:`measure_cache_bandwidth` (``vmem``: a triad looped over 12 MB
  inside one launch of ``csrc/l2_probe.cu``, so every pass after the
  first hits L2), :func:`measure_host_link_bandwidth` (``host``: one copy
  each way through pinned host memory, as ``kv_cache.swap_out`` moves a
  slot), :func:`measure_ici_bandwidth` (``ici``: an NCCL all-reduce
  between two cards, None below two) and
  :func:`measure_compute_transfer_overlap` (the share of a pinned copy on
  a second stream hidden under a matmul loop on the first, and with two
  cards of the all-reduce under it).

Times come from CUDA events on the card.  On the CPU (only when asked for)
the same protocol runs with plain PyTorch probes and a host clock; those
numbers describe the host, never the card.  Results are cached in
``results/microbench_torch.json`` (git-ignored) under a fingerprint of
device name, device count and schema; a cache from another platform or
schema falls back to the data-sheet ``H100_SXM`` with a warning.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import os
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import torch

from ...device import resolve_device
from ...kernels import build
from .hardware import H100_SXM, MEMORY_LEVELS, ChipSpec
from .model import LevelBetas

# Bump whenever the cached JSON layout or the measurement protocol
# changes: a cache written under an older schema must not reprice the
# roofline.  Schema 2 added the per-level betas and overlap fractions.
CACHE_SCHEMA = 2
DEFAULT_CACHE = (Path(__file__).resolve().parents[4] / "results"
                 / "microbench_torch.json")
L2_BYTES = 50 * 10**6                # H100 SXM L2 (data sheet)
MATMUL_DTYPES = ("float32", "bfloat16")
# v = v * FMA_A + FMA_B stays bounded and non-degenerate over many steps
FMA_A, FMA_B = 1.000000119, 1e-7

# sizes on the CPU; the card's are the functions' defaults
_CPU_SIZES = dict(fma=dict(size=1 << 14, iters=64, repeats=3),
              matmul=dict(n=128, repeats=3),
              bw=dict(nbytes=1 << 22, repeats=3),
              warm_cold=dict(nbytes=1 << 20, evict_bytes=1 << 23,
                             repeats=3),
              cache=dict(nbytes=1 << 18, inner=16, repeats=3),
              host=dict(nbytes=1 << 22, repeats=3),
              overlap={})


def device_fingerprint(device: torch.device) -> Dict[str, object]:
    """Identity of the platform a measurement is valid for."""
    if device.type == "cuda":
        return {"schema": CACHE_SCHEMA,
                "device_kind": torch.cuda.get_device_name(device),
                "n_devices": torch.cuda.device_count()}
    return {"schema": CACHE_SCHEMA, "device_kind": "cpu", "n_devices": 1}


def _time_best(fn: Callable[[], object], device: torch.device, *,
               repeats: int = 5, warmup: int = 2,
               before: Optional[Callable[[], object]] = None) -> float:
    """Best-of-``repeats`` seconds of one ``fn()`` call (CUDA events on
    the card, the host clock on the CPU); ``before`` runs untimed ahead
    of each call.  On the card a short sleep kernel is queued before the
    start event, so the host enqueues the call while the card is busy
    and the events bracket device work, not the launch latency."""
    for _ in range(warmup):
        if before is not None:
            before()
        fn()
    best = float("inf")
    for _ in range(repeats):
        if before is not None:
            before()
        if device.type == "cuda":
            torch.cuda._sleep(200_000)              # ~0.1 ms
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            dt = s.elapsed_time(e) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
        best = min(best, dt)
    return best


# the C interface of csrc/fma_probe.cu, bound by kernels/build.py
C_SIGNATURES = {
    "fma_probe_launch": ([ctypes.c_void_p] + [ctypes.c_int] * 3
                         + [ctypes.c_float] * 2 + [ctypes.c_void_p],
                         ctypes.c_int),
    "fma_probe_chains": ([], ctypes.c_int),
}


def fma_probe(out: torch.Tensor, *, blocks: int, threads: int,
              iters: int) -> int:
    """Launch the FMA-chain probe into ``out`` (blocks * threads float32
    on the card); returns the FLOPs it does."""
    lib = build.library("fma_probe", C_SIGNATURES)
    err = lib.fma_probe_launch(out.data_ptr(), blocks, threads, iters,
                               FMA_A, FMA_B,
                               torch.cuda.current_stream(out.device)
                               .cuda_stream)
    if err != 0:
        raise RuntimeError(f"fma_probe launch failed: CUDA error {err}")
    return 2 * lib.fma_probe_chains() * iters * blocks * threads


def measure_peak_flops(device: torch.device, *, size: int = 0,
                       iters: int = 65536, repeats: int = 5) -> float:
    """float32 FLOP/s of independent FMA chains held in registers.  On the
    card: ``csrc/fma_probe.cu`` over 8 blocks of 256 threads per SM (or
    ``size`` threads); on the CPU the plain probe v = v * a + b over a
    ``size``-element tensor."""
    if device.type == "cuda":
        threads = 256
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        blocks = max(1, size // threads) if size else 8 * sms
        out = torch.empty(blocks * threads, dtype=torch.float32,
                          device=device)
        flops = fma_probe(out, blocks=blocks, threads=threads, iters=iters)
        dt = _time_best(lambda: fma_probe(out, blocks=blocks,
                                          threads=threads, iters=iters),
                        device, repeats=repeats)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("fma_probe produced non-finite values")
        return flops / dt
    size = size or 1 << 14
    v = torch.ones(size, dtype=torch.float32)

    def plain():
        for _ in range(iters):
            v.mul_(FMA_A).add_(FMA_B)
    return 2.0 * size * iters / _time_best(plain, device, repeats=repeats)


def measure_peak_matmul_flops(device: torch.device, dtype: str, *,
                              n: int = 8192, repeats: int = 5) -> float:
    """FLOP/s of an n x n x n ``torch.matmul`` in ``dtype`` (float32 with
    TF32 off, so float32 means float32)."""
    g = torch.Generator(device=device).manual_seed(0)
    dt_ = getattr(torch, dtype)
    a = torch.randn((n, n), generator=g, device=device).to(dt_)
    b = torch.randn((n, n), generator=g, device=device).to(dt_)
    c = torch.empty((n, n), dtype=dt_, device=device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dt = _time_best(lambda: torch.matmul(a, b, out=c), device,
                        repeats=repeats)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return 2.0 * n ** 3 / dt


def measure_peak_bandwidth(device: torch.device, *, nbytes: int = 1 << 30,
                           repeats: int = 5) -> Dict[str, float]:
    """B/s of copy (read + write), fill (write) and triad (c = b + 3 a:
    two reads + write) over float32 buffers of ``nbytes``; ``best`` is
    their maximum."""
    n = nbytes // 4
    a = torch.ones(n, dtype=torch.float32, device=device)
    b = torch.ones(n, dtype=torch.float32, device=device)
    c = torch.empty(n, dtype=torch.float32, device=device)
    res = {
        "copy": 2.0 * nbytes / _time_best(lambda: c.copy_(a), device,
                                          repeats=repeats),
        "fill": 1.0 * nbytes / _time_best(lambda: c.fill_(1.5), device,
                                          repeats=repeats),
        "triad": 3.0 * nbytes / _time_best(
            lambda: torch.add(b, a, alpha=3.0, out=c), device,
            repeats=repeats),
    }
    res["best"] = max(res.values())
    return res


def measure_warm_vs_cold(device: torch.device, *, nbytes: int = 12 << 20,
                         evict_bytes: int = 256 << 20, repeats: int = 10
                         ) -> Dict[str, float]:
    """Paper sections 2.5.1 / 2.5.2: one streaming pass y = x + 1 over an
    ``nbytes`` x (x and y fit in L2 together), timed warm (the same pass
    just before) and cold (a write of ``evict_bytes``, more than L2, in
    between: a buffer that was just written may still sit in L2, so the
    eviction writes, it does not read).  Returns seconds and the implied
    rates (bytes read + written per second)."""
    x = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    evict = torch.empty(evict_bytes // 4, dtype=torch.float32,
                        device=device)

    def one_pass():
        torch.add(x, 1.0, out=y)
    warm = _time_best(one_pass, device, repeats=repeats)
    cold = _time_best(one_pass, device, repeats=repeats,
                      before=lambda: evict.fill_(0.5))
    return {"warm_s": warm, "cold_s": cold, "warm_Bps": 2 * nbytes / warm,
            "cold_Bps": 2 * nbytes / cold}


# the C interface of csrc/l2_probe.cu
L2_SIGNATURES = {
    "l2_probe_launch": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                         ctypes.c_int, ctypes.c_float, ctypes.c_int,
                         ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
}
# a = a * L2_TRIAD_S + b: stays bounded over any number of passes
L2_TRIAD_S = 0.5


def l2_probe(a: torch.Tensor, b: torch.Tensor, *, iters: int,
             blocks: int, threads: int = 256) -> None:
    """Launch the cache-resident triad (``csrc/l2_probe.cu``): ``iters``
    passes of a = a * 0.5 + b over two float32 tensors on the card."""
    lib = build.library("l2_probe", L2_SIGNATURES)
    err = lib.l2_probe_launch(a.data_ptr(), b.data_ptr(), a.numel() // 4,
                              iters, L2_TRIAD_S, blocks, threads,
                              torch.cuda.current_stream(a.device)
                              .cuda_stream)
    if err != 0:
        raise RuntimeError(f"l2_probe launch failed: CUDA error {err}")


def measure_cache_bandwidth(device: torch.device, *, nbytes: int = 6 << 20,
                            inner: int = 64, repeats: int = 5) -> float:
    """B/s of a cache-resident stream, the ``vmem`` level's beta: a triad
    over two float32 arrays of ``nbytes`` each (12 MB together, well
    inside the 50 MB L2), repeated ``inner`` times, so every pass after
    the first hits L2.  On the card the passes run inside one launch of
    ``csrc/l2_probe.cu`` (4 blocks of 256 threads an SM); on the CPU as
    ``inner`` plain in-place triads over a buffer sized for its caches.
    Per pass: read a, read b, write a."""
    n = nbytes // 4
    a = torch.ones(n, dtype=torch.float32, device=device)
    b = torch.ones(n, dtype=torch.float32, device=device)
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count

        def run():
            l2_probe(a, b, iters=inner, blocks=4 * sms)
    else:
        def run():
            for _ in range(inner):
                torch.add(b, a, alpha=L2_TRIAD_S, out=a)
    dt = _time_best(run, device, repeats=repeats)
    if not bool(torch.isfinite(a).all()):
        raise RuntimeError("the cache-resident triad produced non-finite "
                           "values")
    return 3.0 * nbytes * inner / dt


def measure_host_link_bandwidth(device: torch.device, *,
                                nbytes: int = 64 << 20,
                                repeats: int = 5) -> float:
    """B/s of the ``host`` level, what a swap crosses, measured the way
    ``kv_cache.swap_out`` moves a slot: one copy of one contiguous device
    buffer into pinned host memory, and one back (as ``swap_in``'s);
    the beta is the harmonic mean of the two legs.  On the CPU both
    buffers are host memory (the same DRAM)."""
    dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
    dev.fill_(1)
    host = torch.empty(nbytes, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    d2h = nbytes / _time_best(lambda: host.copy_(dev), device,
                              repeats=repeats)
    h2d = nbytes / _time_best(lambda: dev.copy_(host), device,
                              repeats=repeats)
    return 2.0 / (1.0 / d2h + 1.0 / h2d)


def _ici_probe_rank(rank: int, world: int, nbytes: int, repeats: int,
                    n: int, iters: int) -> Dict[str, float]:
    """One NCCL rank of :func:`_ici_probe`: the all-reduce of ``nbytes``
    alone, ``iters`` bf16 ``n`` x ``n`` matmuls alone, then both at once
    (the all-reduce on its own stream); best-of-``repeats`` seconds."""
    import torch.distributed as dist
    dev = torch.device("cuda", rank)
    x = torch.ones(nbytes // 2, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=g, device=dev).to(torch.bfloat16)
    c = torch.empty_like(a)
    side = torch.cuda.Stream(dev)
    cur = torch.cuda.current_stream(dev)

    def reduce():
        dist.all_reduce(x)

    def compute():
        for _ in range(iters):
            torch.matmul(a, a, out=c)

    def both():
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            dist.all_reduce(x)
        compute()
        cur.wait_stream(side)

    out = {name: _time_best(fn, dev, repeats=repeats)
           for name, fn in (("reduce", reduce), ("compute", compute),
                            ("both", both))}
    dist.barrier()
    return out


@functools.lru_cache(maxsize=None)
def _ici_probe(nbytes: int, repeats: int, n: int = 4096,
               iters: int = 8) -> Dict[str, float]:
    """Rank 0's times of :func:`_ici_probe_rank` on two NCCL ranks, the
    first two cards (once per process and argument set)."""
    from ...parallel.mesh import spawn
    return spawn(_ici_probe_rank, 2, backend="nccl", device="cuda",
                 args=(nbytes, repeats, n, iters))


def measure_ici_bandwidth(device: torch.device, *, nbytes: int = 64 << 20,
                          repeats: int = 5) -> Optional[float]:
    """The ``ici`` level's beta: per-card wire bytes over the time of an
    NCCL all-reduce of ``nbytes`` between two cards (the ring moves 2 x
    payload x (n-1)/n = payload bytes per card at n = 2), the
    communication a tensor-parallel step does.  None with fewer than two
    cards (or on the CPU): the level stays at the data sheet."""
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    return nbytes / _ici_probe(nbytes, repeats)["reduce"]


def _overlap_fraction(t_c: float, t_x: float, t_both: float) -> float:
    """The reference's clamp: 1.0 when the shorter leg hides entirely
    under the longer, 0.0 when the two serialize."""
    denom = min(t_c, t_x)
    if denom <= 0:
        return 0.0
    return min(max((t_c + t_x - t_both) / denom, 0.0), 1.0)


def measure_compute_transfer_overlap(device: torch.device, *, n: int = 4096,
                                     iters: int = 8, nbytes: int = 64 << 20,
                                     repeats: int = 5) -> Dict[str, float]:
    """Achievable compute / transfer concurrency of the host level:
    ``iters`` bf16 ``n`` x ``n`` matmuls on the default stream (t_c), one
    device -> pinned-host copy of ``nbytes`` on a second stream (t_x, the
    swap-out direction), then both issued together (t_both); ``host`` =
    clamp((t_c + t_x - t_both) / min(t_c, t_x), 0, 1), the reference's
    formula.  With two or more cards ``ici`` is the same fraction for an
    NCCL all-reduce between two cards racing the matmuls.  Empty on the
    CPU, which has no second engine to race (not "no overlap")."""
    if device.type != "cuda":
        return {}
    out = {}
    if torch.cuda.device_count() >= 2:
        t = _ici_probe(nbytes, repeats, n, iters)
        out["ici"] = _overlap_fraction(t["compute"], t["reduce"],
                                       t["both"])
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((n, n), generator=g, device=device).to(torch.bfloat16)
    b = torch.randn((n, n), generator=g, device=device).to(torch.bfloat16)
    c = torch.empty((n, n), dtype=torch.bfloat16, device=device)
    src = torch.ones(nbytes, dtype=torch.uint8, device=device)
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)

    def compute():
        for _ in range(iters):
            torch.matmul(a, b, out=c)

    dst = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def transfer(with_compute: bool):
        def go():
            side.wait_stream(cur)            # start after the start event
            with torch.cuda.stream(side):
                dst.copy_(src, non_blocking=True)
            if with_compute:
                compute()
            cur.wait_stream(side)            # the end event waits for it
        return go

    t_c = _time_best(compute, device, repeats=repeats)
    t_x = _time_best(transfer(False), device, repeats=repeats)
    t_both = _time_best(transfer(True), device, repeats=repeats)
    torch.cuda.synchronize(device)
    out["host"] = _overlap_fraction(t_c, t_x, t_both)
    return out


@dataclasses.dataclass
class MicrobenchResult:
    fma_flops: float                       # float32 FMA-chain probe
    matmul_flops: Dict[str, float]         # torch.matmul, per dtype
    bandwidth: Dict[str, float]            # copy / fill / triad / best
    warm_cold: Dict[str, float] = dataclasses.field(default_factory=dict)
    # per-level betas (B/s) of the memory hierarchy; a level absent here
    # falls back to the data sheet in level_betas() / to_chipspec()
    level_bw: Dict[str, float] = dataclasses.field(default_factory=dict)
    # measured compute / transfer overlap fraction per level; empty means
    # the platform had no second engine to race, not "no overlap"
    overlap: Dict[str, float] = dataclasses.field(default_factory=dict)
    fingerprint: Dict[str, object] = dataclasses.field(default_factory=dict)
    source: str = "measured"               # "measured" | "analytic"

    @property
    def peak_flops(self) -> float:
        return max(self.fma_flops, *self.matmul_flops.values())

    @property
    def peak_bw(self) -> float:
        return self.bandwidth["best"]

    def flops_for(self, dtype: str) -> float:
        """The roof of work in ``dtype``: float32 against the best float32
        probe (on the card the FMA chains; float32 matmuls with TF32 off
        run on the same CUDA cores), other dtypes against their matmul
        probe."""
        if dtype == "float32":
            return max(self.fma_flops, self.matmul_flops.get("float32", 0.0))
        return self.matmul_flops.get(dtype, self.peak_flops)

    @classmethod
    def analytic(cls, chip: ChipSpec = H100_SXM) -> "MicrobenchResult":
        """Data-sheet fallback shaped like a measurement."""
        bw = chip.hbm_bw
        return cls(fma_flops=chip.flops_for("float32"),
                   matmul_flops={d: chip.flops_for(d)
                                 for d in MATMUL_DTYPES},
                   bandwidth={"copy": bw, "fill": bw, "triad": bw,
                              "best": bw},
                   level_bw={lvl: chip.level_bw(lvl)
                             for lvl in MEMORY_LEVELS},
                   source="analytic")

    def _level(self, level: str, default: float) -> float:
        v = self.level_bw.get(level)
        return float(v) if v else default

    def level_betas(self, fallback: ChipSpec = H100_SXM) -> LevelBetas:
        """The time-based ledger's denominators: measured where a probe
        ran, ``fallback`` for levels the platform could not exercise
        (``ici`` on one card)."""
        return LevelBetas(
            pi=self.peak_flops,
            vmem=self._level("vmem", fallback.level_bw("vmem")),
            hbm=self._level("hbm", self.peak_bw),
            ici=self._level("ici", fallback.ici_bw),
            dcn=self._level("dcn", fallback.dcn_bw),
            host=self._level("host", fallback.level_bw("host")),
            source=self.source)

    def to_chipspec(self, base: ChipSpec = H100_SXM) -> ChipSpec:
        """A ChipSpec whose per-dtype peaks and per-level betas come from
        the probes (capacity and unmeasured levels from ``base``)."""
        kind = self.fingerprint.get("device_kind", base.name)
        b = self.level_betas(base)
        return ChipSpec(
            name=f"{kind} ({self.source})", peak_flops=self.peak_flops,
            peak_flops_by_dtype={d: self.flops_for(d)
                                 for d in ("float32", *self.matmul_flops)},
            hbm_bw=b.hbm, hbm_bytes=base.hbm_bytes, vmem_bw=b.vmem,
            host_bw=b.host, ici_bw=b.ici, dcn_bw=b.dcn)


def _load_cache(path: Path, device: torch.device) -> MicrobenchResult:
    """The cached measurement if its fingerprint matches this platform;
    otherwise the analytic fallback, with a warning (no silent
    re-measure, no rewrite)."""
    d = json.loads(Path(path).read_text())
    cached_fp = d.get("fingerprint") or {}
    fp = device_fingerprint(device)
    if cached_fp != fp:
        warnings.warn(
            f"microbench cache {path} was measured on "
            f"{cached_fp or 'an unknown platform'} but this platform is "
            f"{fp}; falling back to the analytic hardware.py constants "
            "(delete the cache to re-measure)", stacklevel=3)
        return MicrobenchResult.analytic()
    return _from_cache(d)


def _from_cache(d: dict) -> MicrobenchResult:
    return MicrobenchResult(
        fma_flops=d["fma_flops"], matmul_flops=d["matmul_flops"],
        bandwidth=d["bandwidth"], warm_cold=d.get("warm_cold", {}),
        level_bw=d.get("level_bw", {}), overlap=d.get("overlap", {}),
        fingerprint=d.get("fingerprint") or {},
        source=d.get("source", "measured"))


def card_measurement(cache_path: Union[str, Path] = DEFAULT_CACHE
                     ) -> MicrobenchResult:
    """The card's measured roofs, for pricing work that is walked
    elsewhere (the dry run walks on the host's CPU): the cache at
    ``cache_path`` when its fingerprint names a CUDA card under this
    schema (and, with a card visible, that card), whatever the current
    platform; with no cache and a card visible, measured on the card and
    cached.  Never the CPU's numbers and never the data sheet in their
    place: anything else raises."""
    path = Path(cache_path)
    card = torch.cuda.is_available()
    if not path.exists():
        if not card:
            raise RuntimeError(
                f"no measurement of the card in {path}: run `python -m "
                "repro_torch.launch.primitives --only microbench` on the "
                "card, which writes it, or price on the data sheet")
        return run_microbench(path, device="cuda")
    d = json.loads(path.read_text())
    fp = d.get("fingerprint") or {}
    want = device_fingerprint(torch.device("cuda")) if card else None
    if (fp.get("schema") != CACHE_SCHEMA
            or fp.get("device_kind") in (None, "cpu")
            or d.get("source", "measured") != "measured"
            or (want is not None and fp != want)):
        raise RuntimeError(
            f"{path} holds no measurement of "
            f"{want['device_kind'] if want else 'a CUDA card'} under "
            f"schema {CACHE_SCHEMA} (it holds {fp or 'no fingerprint'}, "
            f"{d.get('source', 'measured')}): delete it and run `python -m "
            "repro_torch.launch.primitives --only microbench` on the card")
    return _from_cache(d)


def run_microbench(cache_path: Optional[Union[str, Path]] = DEFAULT_CACHE,
                   device: Union[str, torch.device] = "cuda"
                   ) -> MicrobenchResult:
    """Measure (or load from ``cache_path``) the roofline of ``device``;
    the CPU gets small sizes.  ``cache_path`` None always measures and
    writes nothing."""
    dev = resolve_device(device)
    if cache_path and os.path.exists(cache_path):
        return _load_cache(Path(cache_path), dev)
    kw = (_CPU_SIZES if dev.type == "cpu"
          else {k: {} for k in _CPU_SIZES})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    bandwidth = measure_peak_bandwidth(dev, **kw["bw"])
    level_bw = {"vmem": measure_cache_bandwidth(dev, **kw["cache"]),
                "hbm": bandwidth["best"],
                "host": measure_host_link_bandwidth(dev, **kw["host"])}
    ici = measure_ici_bandwidth(dev)
    if ici is not None:
        level_bw["ici"] = ici
    res = MicrobenchResult(
        fma_flops=measure_peak_flops(dev, **kw["fma"]),
        matmul_flops={d: measure_peak_matmul_flops(dev, d, **kw["matmul"])
                      for d in MATMUL_DTYPES},
        bandwidth=bandwidth,
        warm_cold=measure_warm_vs_cold(dev, **kw["warm_cold"]),
        level_bw=level_bw,
        overlap=measure_compute_transfer_overlap(dev, **kw["overlap"]),
        fingerprint=device_fingerprint(dev))
    if cache_path:
        Path(cache_path).parent.mkdir(parents=True, exist_ok=True)
        Path(cache_path).write_text(json.dumps(dataclasses.asdict(res),
                                               indent=2))
    return res
