"""The paper's contribution as a feature: automatic roofline construction
for (a) the live device via microbenchmarks, (b) any function, placed on
it, and (c) an assigned architecture cell from the archived dry run: the
JAX package's ``examples/roofline_analysis.py`` on the port.

    PYTHONPATH=src python -m repro_torch.launch.roofline_analysis --device cpu
    PYTHONPATH=src python -m repro_torch.launch.roofline_analysis   # the card

(a) ``core/roofline/microbench.py::run_microbench`` on the device (the
card's fingerprinted cache, ``results/microbench_torch.json``, when it
holds one: ``chip_smoke.py``'s primitives phase writes it; ``--cache ''``
measures again and writes nothing).  (b) matmul, GELU and LayerNorm at
512 x 512 in float32: W and Q of each from ``core/analysis.py::
kernel_character`` on the plain version (a kernel's launch is opaque to
the walk), the time of the kernel ``kernels/ops.py`` runs on the device
(on the card the hand-written rows 8, 10 and 9), placed under the
float32 roof with ``report.ascii_roofline``.  (c) the archived qwen3-14b
train_4k cell of the (16, 16) dry run (``launch/dryrun.py``), re-priced
from its walk's record by ``launch/reanalyze.py`` on the H100's data
sheet, when it exists.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..core.analysis import kernel_character
from ..core.roofline import microbench
from ..core.roofline.hardware import H100_SXM
from ..core.roofline.report import ascii_roofline
from ..device import resolve_device
from ..kernels import ops, ref
from . import reanalyze

N = 512
REPEATS = 5
CELL = "qwen3-14b__train_4k__pod.json"


def _seconds(fn, args, device) -> float:
    """Mean wall time of ``fn(*args)`` over REPEATS calls after one warm
    call (synchronized on the card)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / REPEATS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache", default=None,
                    help="microbench cache ('' measures, writes nothing; "
                         "default: the card's cache on the card, none on "
                         "the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cache = args.cache
    if cache is None:
        cache = str(microbench.DEFAULT_CACHE) if dev.type == "cuda" else ""

    # (a) measure the device's roofline (paper sections 2.1-2.2)
    mb = microbench.run_microbench(cache_path=cache or None, device=dev)
    pi = mb.flops_for("float32")
    kind = mb.fingerprint.get("device_kind", dev.type)
    print(f"device {kind}: pi={pi / 1e9:.1f} GFLOP/s (float32), "
          f"beta={mb.peak_bw / 1e9:.1f} GB/s")

    # (b) place kernels on it (paper section 3)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((N, N), generator=gen, device=dev)
    w = torch.randn((N, N), generator=gen, device=dev)
    scale = torch.ones((N,), device=dev)
    bias = torch.zeros((N,), device=dev)
    pts = []
    for name, plain, kernel, fargs in [
        ("matmul", ref.inner_product, ops.inner_product, (x, w)),
        ("gelu", ref.gelu, ops.gelu, (x,)),
        ("layernorm", ref.layernorm, ops.layernorm, (x, scale, bias)),
    ]:
        c = kernel_character(plain, *fargs)
        dt = _seconds(kernel, fargs, dev)
        pts.append((name, c["AI"], c["W_flops"] / dt))
    print(ascii_roofline(pts, peak_flops=pi, mem_bw=mb.peak_bw))

    # (c) read an archived dry-run cell back (H100 analysis)
    cell = None
    path = os.path.join(reanalyze.RESULTS_DIR, CELL)
    if os.path.exists(path):
        cell = reanalyze.reprice(path, H100_SXM)
        if cell is not None:
            print(f"\nqwen3-14b/train_4k on a 16 x 16 H100 mesh "
                  f"({H100_SXM.name}, analytic): bound={cell['bound']}, "
                  f"t_lower={cell['t_lower_s']:.3f}s, roofline fraction="
                  f"{cell['roofline_fraction'] * 100:.2f}%")
    return {"microbench": mb, "points": pts, "cell": cell}


if __name__ == "__main__":
    main()
