"""The paper's analysis as a library call: a whole step's roofline report
(:func:`analyze_step`, :class:`AnalysisReport`), and the analytic work W
(FLOPs) and traffic Q (bytes) of the paper's primitives.

A step's report walks one call of the step with the op-level cost walk
(``core/roofline/extract.py::characterize``), on fake tensors when its
arguments are fake (``launch/specs.py``: the full-width step is
characterized without computing or allocating it), where the reference
lowers, compiles and parses the HLO.  The walk runs the call, so it sees
every aten op the call dispatches: the forward, the backward the
autograd engine runs (and the forward a checkpointed layer recomputes),
the optimizer's update.

The primitives:

The JAX package reads W and Q off the compiled HLO module
(``core/analysis.py::kernel_character``, its cost walk); the port has no
HLO, so it counts them from the shapes in the same conventions:

* a product of (M, K) and (K, N) is 2 M K N FLOPs;
* an elementwise arithmetic op, an elementwise ``maximum`` included, is
  one FLOP per element; a transcendental (tanh) is one FLOP and one
  transcendental per element; padding and other data movement is 0 FLOPs
  (the paper's section 3.5 caveat);
* tanh-GELU ``0.5 x (1 + tanh(c (x + 0.044715 x^3)))`` is 9 FLOPs per
  element, one of them the tanh;
* a sum of n values is n FLOPs (the walk counts a reduction's operand
  elements); a max reducer is 0 FLOPs, so max pooling's work is 0 (the
  paper's section 3.5 point: comparisons are invisible to the counter);
* Q is the least traffic of one call: each input read once and each
  output written once, in its own dtype.  A fused epilogue adds no
  traffic (``Q_unfused`` adds the activation's extra write and read, the
  paper's fusion-traffic point); a pad reads its input and its scalar
  padding value and writes the padded array.

Attention is the exception to "held against the walk": the reference's
``ref.mha`` materialises the scores, so its walk counts work and traffic
no flash kernel does.  :func:`attention_character` counts the useful
work (the two products over the visible (query, key) pairs) and the
least traffic (q, k, v read and o written once) instead.

``Q_bytes`` is what a kernel's bound divides by the card's bandwidth.
Each function returns the keys of ``kernel_character``: ``W_flops``,
``Q_bytes``, ``transcendentals``, ``AI`` (W / Q).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch.utils._pytree import tree_flatten

from ..parallel.mesh import mesh_axis_sizes
from .roofline import H100_SXM, ChipSpec, RooflineTerms, ScopeSpec
from .roofline.extract import (StepCharacter, character_as_dict,
                               characterize, terms_from_character)
from .roofline.hardware import scope_for_mesh
from .roofline.report import render_report

GELU_FLOPS = 9                      # per element, the tanh included
EPILOGUE_FLOPS = {"none": 0, "relu": 1, "gelu": GELU_FLOPS}


def itemsize(dtype: str) -> int:
    """Bytes per element of the torch dtype named ``dtype``."""
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def character(w: float, q: float, transcendentals: float = 0.0,
              **extra: float) -> Dict[str, float]:
    out = {"W_flops": float(w), "Q_bytes": float(q),
           "transcendentals": float(transcendentals),
           "AI": w / q if q else 0.0}
    out.update({k: float(v) for k, v in extra.items()})
    return out


def inner_product_character(m: int, k: int, n: int, dtype: str = "float32",
                            fuse: str = "none") -> Dict[str, float]:
    """(M, K) @ (K, N) with an optional fused epilogue."""
    isz = itemsize(dtype)
    q = (m * k + k * n + m * n) * isz
    return character(2 * m * k * n + EPILOGUE_FLOPS[fuse] * m * n, q,
                     m * n if fuse == "gelu" else 0,
                     Q_unfused=q + (2 * m * n * isz if fuse != "none" else 0))


def gelu_character(shape: Sequence[int], dtype: str = "float32",
                   pad_to: Optional[int] = None) -> Dict[str, float]:
    """tanh-GELU over ``shape``; with ``pad_to``, GELU of
    ``pad_channels(x, pad_to)``, the pad's traffic included."""
    isz = itemsize(dtype)
    elems = math.prod(shape)
    c = shape[-1]
    padded = c if pad_to is None else -(-c // pad_to) * pad_to
    pelems = elems // c * padded
    pad_q = (elems + 1 + pelems) * isz if padded != c else 0
    return character(GELU_FLOPS * pelems, pad_q + 2 * pelems * isz, pelems)


def conv2d_character(n: int, h: int, w: int, cin: int, cout: int,
                     kh: int = 3, kw: int = 3, dtype: str = "float32"
                     ) -> Dict[str, float]:
    """Direct convolution, stride 1, SAME: x, w read and out written
    once."""
    isz = itemsize(dtype)
    return character(2 * n * h * w * cin * cout * kh * kw,
                     (n * h * w * cin + kh * kw * cin * cout
                      + n * h * w * cout) * isz)


def winograd_tile_count(n: int, h: int, w: int) -> int:
    """T: the number of 4x4 input tiles of F(2x2, 3x3) (N ceil(H/2)
    ceil(W/2))."""
    return n * -(-h // 2) * -(-w // 2)


def winograd_stage_character(t: int, cin: int, cout: int,
                             positions: int = 16) -> Dict[str, float]:
    """The elementwise stage: ``positions`` float32 (T, Cin) @ (Cin,
    Cout) products; v, u and m read or written once in float32."""
    return character(2 * positions * t * cin * cout,
                     positions * (t * cin + cin * cout + t * cout) * 4)


def winograd_conv_character(n: int, h: int, w: int, cin: int, cout: int,
                            dtype: str = "float32") -> Dict[str, float]:
    """The whole F(2x2, 3x3) convolution: the stage's products plus the
    transforms, each a product with a constant matrix (input: two 4x4
    passes over T 4x4 Cin values; kernel: G g G^T; output: two passes of
    A^T over T 4x4 Cout values); the tile gather's index arithmetic is
    not counted.  Q is the convolution's own: x and w read, out written
    once (intermediates need not reach device memory)."""
    t = winograd_tile_count(n, h, w)
    work = (2 * 16 * t * cin * cout          # elementwise stage
            + 2 * 2 * 4 * 16 * t * cin       # V = B^T d B
            + 2 * 3 * (12 + 16) * cin * cout  # U = G g G^T
            + 2 * 4 * (8 + 4) * t * cout)    # Y = A^T M A
    return character(work, conv2d_character(n, h, w, cin, cout, 3, 3,
                                            dtype)["Q_bytes"])


def layernorm_character(rows: int, d: int, dtype: str = "float32",
                        param_dtype: str = "float32") -> Dict[str, float]:
    """Two-pass LayerNorm over (rows, d) as the reference program counts
    it: per element the mean's add, the deviation's subtract (twice: for
    the variance and again for the output, as XLA recomputes it), the
    square, the variance's add, the multiply by rsqrt(var + eps), the
    scale and the bias (8); per row the mean's 1 / d (twice, recomputed
    with the deviation), the variance's 1 / d, the + eps and the rsqrt, one
    transcendental (5).  Q: x read and y written once, scale and bias
    (``param_dtype``) read once.  (The reference's XLA:CPU program also
    sums a row of more than 32 values in windows of 32 and materialises
    its intermediates; neither belongs to the kernel's work or traffic.)
    """
    isz, psz = itemsize(dtype), itemsize(param_dtype)
    return character(8 * rows * d + 5 * rows,
                     2 * rows * d * isz + 2 * d * psz, rows)


def _pool_sizes(n: int, h: int, w: int, c: int, window: int):
    return n * h * w * c, n * (h // window) * (w // window) * c


def avg_pool_character(n: int, h: int, w: int, c: int, window: int = 2,
                       dtype: str = "float32") -> Dict[str, float]:
    """NHWC average pooling, stride = window: the window sums count the
    input's elements (the reducer's operand, cropped rows included, as the
    walk counts them), plus one divide per output.  Q: the input read and
    the output written once; ``Q_unfused`` is the reference program's
    float32 traffic (the scalar init value read, the window sums written
    and read back by the divide)."""
    isz = itemsize(dtype)
    elems, outs = _pool_sizes(n, h, w, c, window)
    return character(elems + outs, (elems + outs) * isz,
                     Q_unfused=(elems + outs) * isz + 4 + 2 * outs * 4)


def max_pool_character(n: int, h: int, w: int, c: int, window: int = 2,
                       dtype: str = "float32") -> Dict[str, float]:
    """NHWC max pooling, stride = window: 0 FLOPs (a max reducer), the
    same least traffic as average pooling; ``Q_unfused`` adds the scalar
    init value the reference program reads."""
    isz = itemsize(dtype)
    elems, outs = _pool_sizes(n, h, w, c, window)
    return character(0, (elems + outs) * isz,
                     Q_unfused=(elems + outs) * isz + isz)


def visible_keys(sq: int, sk: int, causal: bool = True) -> int:
    """Sum over the sq queries of the keys each sees: all sk, or under
    the top-left causal mask min(i + 1, sk) for query i."""
    if not causal:
        return sq * sk
    full = max(0, sq - sk)                   # queries that see every key
    part = sq - full                          # query i < sk sees i + 1
    return part * (part + 1) // 2 + full * sk


def attention_character(b: int, h: int, kv: int, sq: int, sk: int,
                        hd: int, dtype: str = "bfloat16",
                        causal: bool = True) -> Dict[str, float]:
    """GQA attention, its useful work: q k^T and p v over the visible
    (query, key) pairs, 4 hd FLOPs each, and one exp per pair
    (transcendentals); Q: q and o (B, H, Sq, hd), k and v (B, KV, Sk, hd),
    each moved once."""
    pairs = b * h * visible_keys(sq, sk, causal)
    isz = itemsize(dtype)
    return character(4 * hd * pairs,
                     (2 * b * h * sq + 2 * b * kv * sk) * hd * isz, pairs)


def flash_attention_ai(seq_len: int, bq: int = 128) -> float:
    """The JAX package's substitution model of its flash kernel's
    intensity (``core/roofline/substitute.py``): per head 2 hd S^2 causal
    FLOPs over q and o written once plus K / V re-read for each of the
    S / bq query blocks, 2 S hd (1 + S / bq) bf16 bytes: S / (2 (1 +
    S / bq)) FLOP a byte."""
    return seq_len / (2.0 * (1.0 + seq_len / bq))


# --------------------------------------------------------------------------
# A step's report
# --------------------------------------------------------------------------

@dataclasses.dataclass
class AnalysisReport:
    label: str
    character: StepCharacter
    terms: RooflineTerms
    walk_seconds: float
    mesh_shape: Dict[str, int]

    def render(self) -> str:
        extra = []
        top = self.character.collectives.top_ops[:5]
        if top:
            extra.append("top collectives (per-device wire bytes):")
            for op in top:
                extra.append(f"  {op.kind:<20} {op.wire_bytes / 1e6:>10.2f} MB"
                             f"  x{op.group_size}")
        if self.character.scopes:
            extra.append("per-scope (named_scope) breakdown:")
            for tag, sb in sorted(self.character.scopes.items(),
                                  key=lambda kv: -kv[1]["bytes"]):
                extra.append(
                    f"  {tag:<18} flops={sb['flops'] / 1e12:8.2f} TF"
                    f"  bytes={sb['bytes'] / 2**30:9.2f} GiB")
        mem = self.character.memory
        extra.append(
            f"memory/device: args={mem.argument_bytes / 2**30:.2f} GiB"
            f" temps={mem.temp_bytes / 2**30:.2f} GiB"
            f" out={mem.output_bytes / 2**30:.2f} GiB")
        return render_report(self.label, self.terms, extra)

    def as_dict(self) -> Dict[str, Any]:
        d = character_as_dict(self.character)
        t = self.terms
        d.update(
            label=self.label, mesh_shape=self.mesh_shape,
            walk_seconds=self.walk_seconds, scope=t.scope,
            n_chips=t.n_chips, dtype=t.dtype, compute_s=t.compute_s,
            memory_s=t.memory_s, ici_s=t.ici_s, dcn_s=t.dcn_s,
            dominant=t.dominant, bound=t.bound_class(),
            t_lower_s=t.t_lower, t_upper_s=t.t_upper,
            arithmetic_intensity=t.arithmetic_intensity,
            model_flops_total=t.model_flops_total,
            useful_ratio=t.useful_ratio,
            roofline_fraction=t.roofline_fraction,
            hardware_fraction=t.hardware_fraction)
        return d


def analyze_step(fn: Callable, *, args: Sequence[Any], mesh=None,
                 label: str = "step", scope: Optional[ScopeSpec] = None,
                 chip: ChipSpec = H100_SXM, dtype: str = "bfloat16",
                 model_flops: Optional[float] = None) -> AnalysisReport:
    """Walk one call ``fn(*args)`` and price it on ``scope`` (the scope
    of ``mesh``'s axis sizes on ``chip`` when None; one card without a
    mesh).  Fake arguments (``launch/specs.py``) are walked in their own
    ``FakeTensorMode``: nothing is computed or allocated.  The walk's
    temporaries are not tracked (``MemoryFootprint.temp_bytes`` 0)."""
    mesh_shape = (mesh_axis_sizes(mesh) if mesh is not None
                  else {"data": 1, "model": 1})
    if scope is None:
        scope = scope_for_mesh(mesh_shape, chip)
    from torch._guards import detect_fake_mode
    mode = detect_fake_mode(
        [t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)])
    t0 = time.perf_counter()
    with mode if mode is not None else contextlib.nullcontext():
        char = characterize(fn, *args)
    terms = terms_from_character(char, scope, dtype=dtype,
                                 model_flops_total=model_flops)
    return AnalysisReport(label=label, character=char, terms=terms,
                          walk_seconds=time.perf_counter() - t0,
                          mesh_shape=mesh_shape)
