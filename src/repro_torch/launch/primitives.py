"""The paper's primitive studies on the card: the measured roofline
(sections 2.1-2.2), the inner product (fig. 6), GELU's layout and padding
study (fig. 8, section 3.4) and the convolutions (figs. 3-5), each run
through its hand-written CUDA kernel and placed on the measured roof.

    python -m repro_torch.launch.primitives [--only microbench|inner_product|gelu|conv]
        [--shapes smoke|reference|card] [--device cuda|cpu]

Prints the ``name,us_per_call,derived`` rows of the JAX package's
benchmarks and an ASCII roofline per section.  Each row times three
things on the same inputs: the kernel (through ``kernels.ops``), its
plain PyTorch version, and the library call that computes the same
function (``torch.matmul``, cuDNN's ``F.conv2d`` with TF32 off,
``F.gelu(approximate="tanh")``, ``torch.bmm``).  ``derived`` carries the
analytic W and Q (``core/analysis.py``), the intensity, the bound (the
larger of W over the measured roof of the row's dtype and Q over the
measured bandwidth), ``util_peak`` (achieved FLOP/s over the highest
measured peak) and ``util_roof`` (bound over time: the share of the
measured roof).  Every row also holds the kernel against its plain
version (``tolerance``) and raises on a mismatch.

Shape sets: ``smoke`` (tiny, for the CPU tests), ``reference`` (the JAX
benchmarks' shapes; they fit in the H100's 50 MB L2), ``card`` (the
default on a GPU: working sets larger than L2).  Times on the card come
from CUDA events with operands rotated over copies larger than L2
together, so each call finds them cold.  With ``--device cpu`` the ops
run their plain versions and the host clock times them: such numbers
describe the host, not the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..core import analysis
from ..core.roofline import microbench
from ..core.roofline.microbench import L2_BYTES, MicrobenchResult
from ..core.roofline.report import ascii_roofline, fmt_si
from ..device import resolve_device, synchronize
from ..kernels import conv_direct as conv_mod
from ..kernels import conv_winograd as wino_mod
from ..kernels import gelu as gelu_mod
from ..kernels import inner_product as ip_mod
from ..kernels import ops, ref

SECTIONS = ("microbench", "inner_product", "gelu", "conv")

# Each shape set: inner-product cells (name, M, K, N, dtype, fuse); the
# flat GELU cell (shape, dtype), run blocked and naive; the C = 3 cell
# (NHWC shape, dtype), run natural / padded to 8 / padded to 128; the
# convolution cell (N, H = W, Cin, Cout, dtype), 3x3, direct and Winograd.
SHAPES = {
    "smoke": dict(
        inner_product=[("inner_product.f32", 96, 80, 72, "float32", "none"),
                       ("inner_product.fused_gelu", 96, 80, 72, "float32",
                        "gelu")],
        gelu_flat=((64, 256), "float32"),
        gelu_c3=((2, 9, 9, 3), "float32"),
        conv=(2, 7, 16, 24, "float32")),
    "reference": dict(
        inner_product=[("inner_product.f32", 1024, 1024, 1024, "float32",
                        "none"),
                       ("inner_product.fused_gelu", 1024, 1024, 1024,
                        "float32", "gelu")],
        gelu_flat=((4096, 512), "float32"),
        gelu_c3=((256, 227, 3), "float32"),
        conv=(4, 28, 128, 128, "float32")),
    "card": dict(
        inner_product=[
            ("inner_product.bf16_square", 8192, 8192, 8192, "bfloat16",
             "none"),
            # qwen3-14b's gate projection over a 4-slot x 64-token prefill
            # chunk, and the same with the fused GELU epilogue
            ("inner_product.bf16_q14_prefill", 256, 5120, 17408,
             "bfloat16", "none"),
            ("inner_product.bf16_q14_prefill.fused_gelu", 256, 5120, 17408,
             "bfloat16", "gelu"),
            ("inner_product.f32", 4096, 4096, 4096, "float32", "none")],
        gelu_flat=((32768, 8192), "bfloat16"),
        # the paper's [256, 3, 227, 227] in NHWC
        gelu_c3=((256, 227, 227, 3), "bfloat16"),
        # ResNet-50 conv3_x at batch 256
        conv=(256, 28, 128, 128, "bfloat16")),
}
CONV_W_SCALE = 0.05            # the reference benchmark's weight scale
TIME_BUDGET_S = 0.2            # device time per measurement, about
# the library yardstick need only compute the same function: cuDNN may
# pick a Winograd or FFT algorithm, cuBLAS bf16 rounds once; 2% of the
# output's range still catches a wrong yardstick
LIBRARY_RTOL = 2e-2


def tolerance(kind: str, dtype: str, k: int = 1, scale: float = 1.0,
              vs: str = "plain") -> Dict[str, float]:
    """allclose tolerances of a kernel against its plain version (PERF.md,
    PR 14: stated before the first chip run at 8 k 2^-24 and 2^-20, then
    tightened to these after the holds on the card).

    ``kind`` "sum": a float32 sum of ``k`` products of typical size
    ``scale`` taken in another order.  Each partial sum rounds with an
    error of at most half an ulp (2^-24 relative) and the partial sums of
    zero-mean terms grow like sqrt(j) * scale, so the difference of two
    orders has a standard deviation of about 0.6 * k * 2^-24 * scale;
    atol = 4 * k * 2^-24 * scale is over 6 of them.  rtol 2^-22 covers
    the GELU epilogue (tanhf against torch.tanh, FMA contraction: a few
    ulps).
    ``kind`` "elementwise": GELU, the same float32 formula; atol = rtol =
    2^-22.
    bf16 outputs are rounded once (half an ulp, 2^-8 relative at most):
    against the plain version run in float32 (``vs`` "plain_f32") rtol
    2^-8; against the plain bf16 output, whose rounding may land one ulp
    away, rtol 2^-7."""
    atol = 4 * k * 2.0 ** -24 * scale if kind == "sum" else 2.0 ** -22
    rtol = 2.0 ** -22
    if dtype == "bfloat16":
        rtol = 2.0 ** -8 if vs == "plain_f32" else 2.0 ** -7
    return dict(atol=atol, rtol=rtol)


@dataclasses.dataclass
class Row:
    name: str
    dtype: str
    char: Dict[str, float]            # analytic W, Q, AI (core/analysis.py)
    seconds: float                    # through kernels.ops
    plain_s: float
    library_s: Optional[float]
    bound_s: float
    bound_by: str                     # "bytes" | "operations"
    util_peak: float
    util_roof: float
    library_util_roof: Optional[float]
    max_abs_err: float                # against the plain version

    @property
    def achieved(self) -> float:
        return self.char["W_flops"] / self.seconds

    def derived(self) -> str:
        lib = (f"library_us={self.library_s * 1e6:.1f};"
               f"library_util_roof={self.library_util_roof * 100:.1f}%;"
               if self.library_s is not None else "")
        return (f"AI={self.char['AI']:.2f};"
                f"util_peak={self.util_peak * 100:.1f}%;"
                f"util_roof={self.util_roof * 100:.1f}%;"
                f"W={self.char['W_flops']:.6g};Q={self.char['Q_bytes']:.6g};"
                f"bound_us={self.bound_s * 1e6:.2f};bound_by={self.bound_by};"
                f"plain_us={self.plain_s * 1e6:.1f};{lib}"
                f"max_abs_err={self.max_abs_err:.3e}")


class Study:
    """One run of the studies on one device against one measured roof."""

    def __init__(self, device: torch.device, roof: MicrobenchResult, *,
                 make: Optional[Callable] = None, keep_outputs: bool = False):
        self.device = device
        self.roof = roof
        self.make = make or self._randn
        self.keep_outputs = keep_outputs
        self.rows: List[Row] = []
        self.emitted: List[str] = []
        self.outputs: Dict[str, torch.Tensor] = {}
        self.inputs: Dict[str, tuple] = {}
        self._seed = 0

    # -- plumbing -------------------------------------------------------

    def _randn(self, shape, seed: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(shape, generator=g, device=self.device)

    def tensor(self, shape, dtype: str, scale: float = 1.0) -> torch.Tensor:
        """float32 normal values from the next seed, scaled, cast."""
        self._seed += 1
        t = self.make(tuple(shape), self._seed)
        return (t * scale if scale != 1.0 else t).to(getattr(torch, dtype))

    def emit(self, name: str, us: float, derived: str) -> None:
        row = f"{name},{us:.1f},{derived}"
        self.emitted.append(row)
        print(row, flush=True)

    def copies(self, args: Sequence[torch.Tensor]) -> List[tuple]:
        """``args`` and clones, enough that together they exceed 4x L2
        (the card only; operands already that large are not copied)."""
        nbytes = sum(a.numel() * a.element_size() for a in args)
        if self.device.type != "cuda" or nbytes >= 4 * L2_BYTES:
            return [tuple(args)]
        n = min(64, math.ceil(4 * L2_BYTES / max(nbytes, 1)))
        return [tuple(args)] + [tuple(a.clone() for a in args)
                                for _ in range(n - 1)]

    def seconds(self, fn: Callable, inputs: List[tuple]) -> float:
        """Median seconds of one ``fn(*inputs[i])`` call.  On the card a
        sleep kernel queued first lets the host enqueue the call (a batch
        of them when they are short) while the card is busy, so CUDA
        events bracket device work, not launch latency."""
        fn(*inputs[0])
        synchronize(self.device)
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            fn(*inputs[0])
            return time.perf_counter() - t0
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn(*inputs[-1])
        e1.record()
        e1.synchronize()
        one = e0.elapsed_time(e1) / 1e3
        per = max(1, min(10, int(2e-3 / max(one, 1e-7))))
        reps = max(3, min(15, int(TIME_BUDGET_S / max(one * per, 1e-7))))
        samples, k = [], 0
        for _ in range(reps):
            torch.cuda._sleep(5_000_000 if per > 1 else 200_000)
            e0.record()
            for _ in range(per):
                fn(*inputs[k % len(inputs)])
                k += 1
            e1.record()
            e1.synchronize()
            samples.append(e0.elapsed_time(e1) / 1e3 / per)
        return statistics.median(samples)

    def roof_of(self, dtype: str) -> float:
        return self.roof.flops_for(dtype)

    def bound(self, dtype: str, char: Dict[str, float]):
        """(seconds, "bytes" | "operations"): the larger of Q over the
        measured bandwidth and W over the measured roof of ``dtype``."""
        bytes_s = char["Q_bytes"] / self.roof.peak_bw
        ops_s = char["W_flops"] / self.roof_of(dtype)
        return max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                     else "operations")

    def row(self, name: str, dtype: str, char: Dict[str, float], args,
            kernel: Callable, plain: Callable,
            library: Optional[Callable], tol: Dict[str, float],
            plain_f32: Optional[Callable] = None,
            tol_f32: Optional[Dict[str, float]] = None,
            library_on: Optional[tuple] = None) -> Row:
        """Time kernel, plain version and library call on ``args`` (cold
        copies on the card), hold the kernel against the plain version
        (and ``plain_f32``, the plain version in float32 on the same
        values, where given), place the row on the roof and emit it.
        ``library_on`` = (dtype, char) places the library call on the roof
        of the work it does where that differs from the kernel's (cuDNN
        convolves bf16 on the tensor cores where Winograd works in
        float32)."""
        out = kernel(*args)
        want = plain(*args)
        synchronize(self.device)
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        err = float((out.float() - want.float()).abs().max())
        checks = [(want.float(), tol)]
        if plain_f32 is not None:
            checks.append((plain_f32(*args).float(), tol_f32))
        for ref_out, t in checks:
            if not torch.allclose(out.float(), ref_out, **t):
                bad = float((out.float() - ref_out).abs().max())
                raise AssertionError(
                    f"{name}: kernel differs from its plain version by "
                    f"{bad:.3e} (atol {t['atol']:.3e}, rtol {t['rtol']:.3e})")
        if library is not None:           # a yardstick that computes it
            lib_out = library(*args).float()
            scale = float(want.float().abs().max()) or 1.0
            lib_err = float((lib_out - want.float()).abs().max())
            if lib_err > LIBRARY_RTOL * scale:
                raise AssertionError(
                    f"{name}: the library call differs from the plain "
                    f"version by {lib_err:.3e} (max |plain| {scale:.3e})")
            del lib_out
        if self.keep_outputs:
            self.outputs[name] = out
            self.inputs[name] = tuple(args)
        del out, want, checks
        copies = self.copies(args)
        t_k = self.seconds(kernel, copies)
        t_p = self.seconds(plain, copies)
        t_l = self.seconds(library, copies) if library is not None else None
        del copies
        bound, bound_by = self.bound(dtype, char)
        lib_bound = self.bound(*library_on)[0] if library_on else bound
        r = Row(name=name, dtype=dtype, char=char, seconds=t_k, plain_s=t_p,
                library_s=t_l, bound_s=bound, bound_by=bound_by,
                util_peak=char["W_flops"] / t_k / self.roof.peak_flops,
                util_roof=bound / t_k,
                library_util_roof=lib_bound / t_l if t_l else None,
                max_abs_err=err)
        self.rows.append(r)
        if char["Q_bytes"] < L2_BYTES and self.device.type == "cuda":
            print(f"[primitives] {name}: its {fmt_si(char['Q_bytes'], 'B')} "
                  f"fit in the card's 50 MB L2; timed over rotating copies "
                  f"(cold)", flush=True)
        self.emit(name, t_k * 1e6, r.derived())
        return r

    def plot(self, title: str, rows: Sequence[Row]) -> None:
        for dtype in sorted({r.dtype for r in rows}):
            pts = [(r.name, r.char["AI"], r.achieved) for r in rows
                   if r.dtype == dtype]
            print(f"\n--- {title}, {dtype} (measured roof) ---")
            print(ascii_roofline(pts, peak_flops=self.roof_of(dtype),
                                 mem_bw=self.roof.peak_bw, width=68,
                                 height=16))
            print(flush=True)

    # -- the studies ----------------------------------------------------

    def microbench(self) -> None:
        r, dev = self.roof, self.device
        self.emit("microbench.fma_peak", 0.0,
                  f"GFLOPs={r.fma_flops / 1e9:.2f}")
        for d, v in r.matmul_flops.items():
            self.emit(f"microbench.matmul_peak.{d}", 0.0,
                      f"GFLOPs={v / 1e9:.2f}")
        for k, v in r.bandwidth.items():
            self.emit(f"microbench.bw_{k}", 0.0, f"GBps={v / 1e9:.2f}")
        if r.warm_cold:
            wc = r.warm_cold
            self.emit("microbench.warm_vs_cold", wc["warm_s"] * 1e6,
                      f"cold_us={wc['cold_s'] * 1e6:.1f};"
                      f"ratio={wc['cold_s'] / max(wc['warm_s'], 1e-12):.2f}")
        print(f"[microbench] {dev.type} roofline ({r.source}): "
              f"pi float32={r.flops_for('float32') / 1e12:.2f} TFLOP/s, "
              f"pi bfloat16={r.flops_for('bfloat16') / 1e12:.2f} TFLOP/s, "
              f"beta={r.peak_bw / 1e9:.1f} GB/s, ridge AI "
              f"{r.flops_for('float32') / r.peak_bw:.1f} / "
              f"{r.flops_for('bfloat16') / r.peak_bw:.1f} F/B", flush=True)

    def inner_product(self, cells) -> List[Row]:
        rows = []
        for name, m, k, n, dtype, fuse in cells:
            x = self.tensor((m, k), dtype)
            w = self.tensor((k, n), dtype)
            char = analysis.inner_product_character(m, k, n, dtype, fuse)

            def lib(a, b, fuse=fuse):
                y = torch.matmul(a, b)
                return F.gelu(y, approximate="tanh") if fuse == "gelu" else y
            f32 = (lambda a, b, fuse=fuse: ip_mod.inner_product_reference(
                a.float(), b.float(), fuse=fuse))
            rows.append(self.row(
                name, dtype, char, (x, w),
                lambda a, b, fuse=fuse: ops.inner_product(a, b, fuse),
                lambda a, b, fuse=fuse: ip_mod.inner_product_reference(
                    a, b, fuse=fuse),
                lib, tolerance("sum", dtype, k),
                f32, tolerance("sum", dtype, k, vs="plain_f32")))
            if fuse != "none":
                self.emit(f"{name}.fusion_traffic", 0.0,
                          f"Q_fused={char['Q_bytes']:.6g};"
                          f"Q_unfused={char['Q_unfused']:.6g}")
            del x, w
        self.plot("inner product roofline (paper fig. 6)", rows)
        return rows

    def gelu(self, flat_cell, c3_cell) -> List[Row]:
        rows = []
        shape, dtype = flat_cell
        x = self.tensor(shape, dtype, 2.0)
        char = analysis.gelu_character(shape, dtype)
        lib = lambda t: F.gelu(t, approximate="tanh")      # noqa: E731
        tol = tolerance("elementwise", dtype)
        tol32 = tolerance("elementwise", dtype, vs="plain_f32")
        f32 = lambda t: ref.gelu(t.float())                 # noqa: E731
        for layout, fn in (("blocked", ops.gelu), ("naive", ops.gelu_naive)):
            rows.append(self.row(f"gelu.flat.{layout}", dtype, char, (x,),
                                 fn, ref.gelu, lib, tol, f32, tol32))
        same = torch.equal(ops.gelu(x), ops.gelu_naive(x))
        self.emit("gelu.flat.layouts_bitwise_equal", 0.0, f"equal={same}")
        if not same:
            raise AssertionError("gelu blocked and naive walks differ")
        del x
        shape, dtype = c3_cell
        x = self.tensor(shape, dtype, 2.0)
        chars = {}
        for label, to in (("natural", None), ("padded8", 8),
                          ("padded128", 128)):
            name = f"gelu.c3_{label}"
            chars[label] = analysis.gelu_character(shape, dtype, pad_to=to)

            def pad(t, to=to):
                return t if to is None else gelu_mod.pad_channels(t, to)
            rows.append(self.row(
                name, dtype, chars[label], (x,),
                lambda t, pad=pad: ops.gelu(pad(t)),
                lambda t, pad=pad: ref.gelu(pad(t)),
                lambda t, pad=pad: lib(pad(t)), tol,
                lambda t, pad=pad: ref.gelu(pad(t).float()), tol32))
        nat, p8, p128 = (chars[k] for k in ("natural", "padded8",
                                            "padded128"))
        self.emit("gelu.forced_blocked_waste", 0.0,
                  f"W8/W={p8['W_flops'] / nat['W_flops']:.2f};"
                  f"Q8/Q={p8['Q_bytes'] / nat['Q_bytes']:.2f};"
                  f"W128/W={p128['W_flops'] / nat['W_flops']:.1f};"
                  f"Q128/Q={p128['Q_bytes'] / nat['Q_bytes']:.1f}")
        del x
        self.plot("GELU roofline (paper fig. 8)", rows)
        return rows

    def conv(self, cell) -> List[Row]:
        n, hw, cin, cout, dtype = cell
        x = self.tensor((n, hw, hw, cin), dtype)
        w = self.tensor((3, 3, cin, cout), dtype, CONV_W_SCALE)

        def cudnn(a, b):                   # NHWC views, SAME for 3x3
            return F.conv2d(a.permute(0, 3, 1, 2), b.permute(3, 2, 0, 1),
                            padding=1).permute(0, 2, 3, 1)
        k = 9 * cin
        direct_char = analysis.conv2d_character(n, hw, hw, cin, cout, 3, 3,
                                                dtype)
        rows = [self.row(
            "conv.direct", dtype, direct_char, (x, w), ops.conv2d,
            conv_mod.conv2d_direct_reference, cudnn,
            tolerance("sum", dtype, k, CONV_W_SCALE),
            lambda a, b: conv_mod.conv2d_direct_reference(a.float(),
                                                          b.float()),
            tolerance("sum", dtype, k, CONV_W_SCALE, vs="plain_f32"))]
        # Winograd: float32 inside; the stage holds the multiplies
        v, _, _ = ref.winograd_input_transform(x)
        u = ref.winograd_kernel_transform(w).reshape(16, cin, cout)
        t = v.shape[1]
        stage_char = analysis.winograd_stage_character(t, cin, cout)
        # |v| ~ 2 |x| (B^T d B sums four +-x), |u| ~ 1.5 |w|
        stage_tol = tolerance("sum", "float32", cin, 3 * CONV_W_SCALE)
        rows.append(self.row(
            "conv.winograd_stage", "float32", stage_char, (v, u.contiguous()),
            ops.winograd_elementwise_stage,
            wino_mod.winograd_elementwise_stage_reference,
            torch.bmm, stage_tol))
        del v, u
        # the output transform adds 16 stage outputs with weights +-1
        wtol = dict(atol=16 * stage_tol["atol"], rtol=stage_tol["rtol"])
        if dtype == "bfloat16":
            wtol = dict(wtol, rtol=tolerance("sum", dtype)["rtol"])
        # float32 work inside whatever x's dtype: placed on that roof
        rows.append(self.row(
            "conv.winograd", "float32",
            analysis.winograd_conv_character(n, hw, hw, cin, cout, dtype),
            (x, w),
            ops.conv2d_winograd, ref.conv2d_winograd, cudnn, wtol,
            library_on=(dtype, direct_char)))
        direct, wino = rows[0], rows[2]
        self.emit("conv.winograd_work_reduction", 0.0,
                  f"W_direct/W_stage="
                  f"{direct.char['W_flops'] / stage_char['W_flops']:.2f};"
                  f"t_direct/t_winograd={direct.seconds / wino.seconds:.2f}")
        del x, w
        self.plot("convolution roofline (paper fig. 3)", rows)
        return rows

    def run(self, shapes: str, only: Optional[str] = None) -> List[Row]:
        cells = SHAPES[shapes]
        todo = SECTIONS if only is None else (only,)
        if "microbench" in todo:
            self.microbench()
        if "inner_product" in todo:
            self.inner_product(cells["inner_product"])
        if "gelu" in todo:
            self.gelu(cells["gelu_flat"], cells["gelu_c3"])
        if "conv" in todo:
            self.conv(cells["conv"])
        return self.rows


def main(argv: Optional[Sequence[str]] = None) -> Study:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", choices=SECTIONS, default=None)
    p.add_argument("--shapes", choices=sorted(SHAPES), default=None,
                   help="default: card on a GPU, smoke on the CPU")
    p.add_argument("--device", default="cuda")
    p.add_argument("--cache", default=str(microbench.DEFAULT_CACHE),
                   help="microbench cache ('' measures afresh)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    shapes = args.shapes or ("card" if dev.type == "cuda" else "smoke")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        print(f"[primitives] {torch.cuda.get_device_name(dev)}, "
              f"{torch.cuda.device_count()} device(s); shapes {shapes}")
    else:
        print(f"[primitives] cpu (host numbers, not the card's); shapes "
              f"{shapes}")
    roof = microbench.run_microbench(cache_path=args.cache or None,
                                     device=dev)
    study = Study(dev, roof)
    study.run(shapes, args.only)
    return study


if __name__ == "__main__":
    main()
