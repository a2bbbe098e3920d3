"""Op-level cost walk of one call of a step function: the port's
counterpart of the JAX package's ``core/roofline/hlo_cost.py``.

The reference parses the partitioned HLO of a compiled step and counts
W (FLOPs), Q (bytes) and transcendentals under XLA's conventions.  The
port has no HLO: what one call of a step does on the card is the sequence
of aten ops it dispatches, and eager PyTorch runs every aten op as a
kernel of its own, even inside a captured CUDA graph.  So the port's
kernel boundary is every op, where XLA's was every fusion; that is a
deliberate difference, not a fault: an unfused step really does move its
intermediates through memory, and the walk charges them.

:class:`OpCostMode` is a ``TorchDispatchMode`` that runs each op and
counts it under ``hlo_cost.py``'s own conventions:

* FLOPs: a matmul-family op (``mm``, ``addmm``, ``bmm``, ``baddbmm``, what
  ``einsum`` lowers to, ``_scaled_dot_product_*``, ``convolution``) counts
  2 x prod(result) x the contracted size; an elementwise op prod(result);
  a reduction prod(operand), 0 when it only compares (max, min, argmax);
  data movement (copies, casts, gathers, scatters, ``where``, comparisons,
  clamps, sorts) counts 0.  Transcendentals (exp, tanh, log, rsqrt, sqrt,
  sin, cos, sigmoid, erf, non-integer pow) count one FLOP an element and
  are also counted apart, as ``TRANSCENDENTAL_OPS`` are there.
* Bytes: each op's operand bytes plus result bytes.  An operand counts the
  elements it spans (a broadcast dimension, stride 0, counts once).  View
  and metadata ops move nothing (``view``, ``reshape`` when it is a view,
  ``expand``, ``permute``, ``t``, ``transpose``, ``slice``, ``select``,
  ``as_strided``, ``alias``, ``detach``, ``unsqueeze``, ``squeeze``, ...):
  the counterpart of ``_SKIP_BYTES_OPS``.  Allocation without a write
  (``empty``) moves nothing.
* Slices and in-place updates, as ``hlo_cost.py`` prices its gathers and
  dynamic-update-slices: a gather (``index``, ``index_select``,
  ``gather``, ``take_along_dim``, ``embedding``) reads the rows it
  returns, not the whole table (rows read + result written + indices); an
  in-place write (``index_put_``, ``index_copy_``, ``index_add_``,
  ``scatter_``, ``scatter_add_``, ``copy_`` into a slice of a pool) costs
  the region it writes plus the values and indices it reads, and the
  region once more where it accumulates (read-modify-write).  Without
  this a decode step would be charged its whole KV pool.

Every byte is also split by what the tensor is: a parameter of the model,
a KV pool, a recurrent mixer's per-slot state row (a category only when
the walk is given such rows), or anything else (activations).  Views of a
parameter, a pool or a state row stay what their base is.  So a
cross-check can hold the ledger's weights, KV lines and state against the
first three and name the last as the traffic the ledger leaves out on
purpose.  An ``out=`` tensor is written, not read.

Scopes: :func:`named_scope` is the counterpart of ``jax.named_scope``.
It keeps a plain thread-local stack of tags and makes no CUDA call, so
it stays on the main path at no cost to launches or streams; the walk
adds each op's FLOPs and bytes to the innermost tag of
``TRACKED_SCOPES``.  Op counts per aten op name are the counterpart of
``hlo.py::count_ops``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# the reference's tags (core/roofline/hlo_cost.py), in its order
TRACKED_SCOPES = (
    "fused_attention",
    "paged_attention",
    "moe_dispatch",
    "moe_experts",
    "mamba_scan",
    "mlstm_chunk",
    "logits",
)

CATEGORIES = ("param", "pool", "activation")
# the category of recurrent state rows, split out when the walk has them
STATE = "state"

_local = threading.local()


def _stack() -> List[str]:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


@contextlib.contextmanager
def named_scope(tag: str):
    """Attribute the ops dispatched inside to ``tag`` (the innermost
    tracked tag wins).  A list push and pop: no CUDA call, no launch."""
    s = _stack()
    s.append(tag)
    try:
        yield
    finally:
        s.pop()


def current_scope() -> Optional[str]:
    """The innermost tag of ``TRACKED_SCOPES`` open now, or None."""
    for tag in reversed(_stack()):
        if tag in TRACKED_SCOPES:
            return tag
    return None


# -- op classes --------------------------------------------------------------

# views are the ops whose schema says so (``OpOverload.is_view``: view,
# expand, permute, t, transpose, slice, select, as_strided, alias,
# detach, unsqueeze, squeeze, ...), and this one, which reshapes a fresh
# result (matmul's) without the flag
_VIEW_OPS = {"_unsafe_view"}

# allocations that write nothing
_ALLOC_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "set_", "resize_"}

_MATMUL_OPS = {"mm", "addmm", "bmm", "baddbmm", "matmul", "dot", "mv",
               "addmv", "addbmm", "_scaled_mm"}
_SDPA_OPS = {"_scaled_dot_product_flash_attention",
             "_scaled_dot_product_efficient_attention",
             "_scaled_dot_product_cudnn_attention",
             "_scaled_dot_product_flash_attention_for_cpu",
             "scaled_dot_product_attention"}
_CONV_OPS = {"convolution", "_convolution", "conv2d", "conv1d", "conv3d",
             "cudnn_convolution"}

_GATHER_OPS = {"index", "index_select", "gather", "take_along_dim",
               "embedding", "take"}
# in-place writes priced by the region written: name -> accumulates
_WRITE_OPS = {"index_put_": None, "index_put": None, "_index_put_impl_": None,
              "index_copy_": False, "index_copy": False,
              "index_add_": True, "index_add": True,
              "scatter_": False, "scatter": False,
              "scatter_add_": True, "scatter_add": True,
              "scatter_reduce_": True, "scatter_reduce": True,
              "index_fill_": False, "masked_fill_": False,
              "masked_scatter_": False}

# one FLOP an element, counted as transcendentals too (hlo_cost.py's
# TRANSCENDENTAL_OPS); pow by an integer scalar is a multiply there
TRANSCENDENTAL_OPS = {
    "exp", "exp_", "exp2", "expm1", "tanh", "tanh_", "log", "log_", "log1p",
    "log2", "log10", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "sin", "cos",
    "sigmoid", "sigmoid_", "erf", "erfc", "erfinv", "atan2", "pow", "pow_",
    "logit", "cbrt",
}
# the models' activations that XLA spells as several ops: (FLOPs,
# transcendentals) an element, as its HLO counts them (silu = x *
# logistic(x); tanh-GELU's cube, sums and products around one tanh)
_COMPOSITE_ELEMENTWISE = {"silu": (2, 1), "gelu": (8, 1)}

# no arithmetic: copies, casts, layout, selection, comparisons, clamps
_MOVEMENT_OPS = {
    "clone", "contiguous", "copy", "copy_", "_to_copy", "to", "cat", "stack",
    "where", "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "logical_not", "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "clamp", "clamp_", "clamp_min", "clamp_max", "clamp_min_",
    "clamp_max_", "sort", "argsort", "topk", "fill_", "fill", "zero_", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
    "new_ones", "new_full", "scalar_tensor", "arange", "pad",
    "constant_pad_nd", "repeat", "repeat_interleave", "flip", "roll",
    "tril", "triu", "masked_fill", "_local_scalar_dense", "nonzero",
    "bernoulli_", "uniform_", "normal_", "random_", "exponential_",
    "lift_fresh_copy", "isnan", "isinf", "isfinite", "sign", "abs_",
    "_unsafe_index", "one_hot", "tile", "unique", "bucketize",
    "searchsorted", "view_copy", "permute_copy", "expand_copy",
    "transpose_copy", "slice_copy", "select_copy", "unsqueeze_copy",
    "squeeze_copy", "alias_copy", "t_copy", "detach_copy",
    "_reshape_copy", "split_with_sizes_copy", "unbind_copy",
    "slice_scatter", "select_scatter", "diagonal_scatter",
    "as_strided_scatter", "native_dropout", "_assert_async",
    "_assert_scalar", "_functional_assert_async",
}
# reductions that only compare: 0 FLOPs (the paper's section 3.5 rule)
_COMPARE_REDUCTIONS = {"max", "min", "amax", "amin", "argmax", "argmin",
                       "aminmax", "all", "any", "max_pool2d", "cummax",
                       "cummin"}
# reductions with arithmetic: FLOPs = prod(operand)
_SUM_REDUCTIONS = {"sum", "mean", "nansum", "prod", "cumsum", "cumprod",
                   "var", "std", "var_mean", "std_mean", "norm",
                   "linalg_vector_norm", "avg_pool2d", "count_nonzero",
                   "logsumexp"}


def _tensors(x: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _span_elems(t: torch.Tensor) -> int:
    """Elements an operand spans: a broadcast (stride 0) dim counts once."""
    n = 1
    for s, st in zip(t.shape, t.stride()):
        if s == 0:
            return 0
        if st != 0:
            n *= int(s)
    return n


def _nbytes(t: torch.Tensor, span: bool = True) -> float:
    n = _span_elems(t) if span else t.numel()
    return float(n * t.element_size())


def _prod(shape: Iterable[int]) -> int:
    return int(math.prod(int(s) for s in shape))


@dataclasses.dataclass
class OpCost:
    """What a walk counted: totals, the category split of the bytes (with
    a ``"state"`` entry when the walk was given state rows), per tracked
    scope ``{"flops", "bytes", "<category>_bytes", ...}``, and how often
    each aten op ran."""

    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    by_category: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in CATEGORIES})
    scopes: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def param_bytes(self) -> float:
        return self.by_category["param"]

    @property
    def pool_bytes(self) -> float:
        return self.by_category["pool"]

    @property
    def activation_bytes(self) -> float:
        return self.by_category["activation"]


class OpCostMode(TorchDispatchMode):
    """Count every aten op dispatched inside (see the module docstring).

    ``params``, ``pools`` and ``states`` are trees whose tensors are the
    model's parameters, KV pools and recurrent state rows: their bytes,
    and their views', are counted under those categories.  The ops run as
    usual (on fake tensors, under a ``FakeTensorMode`` entered before this
    one, nothing is computed)."""

    def __init__(self, params: Any = None, pools: Any = None,
                 states: Any = None):
        super().__init__()
        self.cost = OpCost()
        self._cat: Dict[int, str] = {}
        self._keep: List[torch.Tensor] = []   # ids stay unique while walked
        for t in _tensors(params):
            self._mark(t, "param")
        for t in _tensors(pools):
            self._mark(t, "pool")
        rows = _tensors(states)
        if rows:
            self.cost.by_category[STATE] = 0.0
        for t in rows:
            self._mark(t, STATE)

    def _mark(self, t: torch.Tensor, cat: str) -> None:
        if cat == "activation":
            return
        self._cat[id(t)] = cat
        self._keep.append(t)

    def category(self, t: torch.Tensor) -> str:
        return self._cat.get(id(t), "activation")

    # -- accounting -------------------------------------------------------

    def _charge(self, flops: float, trans: float,
                reads: List[Tuple[torch.Tensor, float]],
                writes: List[Tuple[torch.Tensor, float]]) -> None:
        c = self.cost
        by = {k: 0.0 for k in c.by_category}
        for t, b in reads + writes:
            by[self.category(t)] += b
        total = sum(by.values())
        c.flops += flops
        c.transcendentals += trans
        c.bytes += total
        for k in by:
            c.by_category[k] += by[k]
        tag = current_scope()
        if tag is not None:
            acc = c.scopes.setdefault(tag, {
                "flops": 0.0, "bytes": 0.0,
                **{f"{k}_bytes": 0.0 for k in by}})
            acc["flops"] += flops
            acc["bytes"] += total
            for k in by:
                acc[f"{k}_bytes"] += by[k]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        ins = _tensors((args, {k: v for k, v in kwargs.items()
                               if k != "out"}))
        outs = _tensors(out)
        if not (outs or name in _WRITE_OPS):
            return out                    # metadata (device, size, item)
        counts = self.cost.op_counts
        counts[name] = counts.get(name, 0) + 1
        if func.is_view or name in _VIEW_OPS:
            cats = {self.category(t) for t in ins[:1]}
            for t in outs:
                for cat in cats:
                    self._mark(t, cat)
            return out
        if name in _ALLOC_OPS:
            return out
        self._count(func, name, args, kwargs, ins, outs)
        return out

    def _count(self, func, name, args, kwargs, ins, outs) -> None:
        reads = [(t, _nbytes(t)) for t in ins]
        writes = [(t, _nbytes(t, span=False)) for t in outs]
        if name in _GATHER_OPS:
            self._gather(name, args, kwargs, outs)
            return
        if name in _WRITE_OPS:
            self._write(name, args, kwargs, outs)
            return
        if name in ("copy_",):
            dst, src = args[0], args[1]
            self._charge(0.0, 0.0, [(src, _nbytes(src))],
                         [(dst, _nbytes(dst, span=False))])
            return
        if name.endswith("_") and outs and ins and outs[0] is ins[0]:
            # in place: the result is the first operand, written once
            writes = [(outs[0], _nbytes(outs[0], span=False))]
        flops, trans = self._flops(name, args, ins, outs)
        self._charge(flops, trans, reads, writes)

    def _gather(self, name, args, kwargs, outs) -> None:
        table = args[0]
        if name == "embedding":
            table, idx = args[0], [args[1]]
        elif name == "index":
            idx = [i for i in args[1] if isinstance(i, torch.Tensor)]
        elif name in ("index_select", "gather", "take_along_dim"):
            idx = [args[2]] if name != "take_along_dim" else [args[1]]
        else:
            idx = _tensors(args[1:])
        rows = sum(_nbytes(t, span=False) for t in outs)
        reads = [(table, rows)] + [(i, _nbytes(i)) for i in idx]
        writes = [(t, _nbytes(t, span=False)) for t in outs]
        self._charge(0.0, 0.0, reads, writes)

    def _write(self, name, args, kwargs, outs) -> None:
        dst = args[0]
        isize = dst.element_size()
        if name in ("index_put_", "index_put", "_index_put_impl_"):
            indices, values = args[1], args[2]
            acc = bool(args[3] if len(args) > 3
                       else kwargs.get("accumulate", False))
            idx = [i for i in indices if isinstance(i, torch.Tensor)]
            bshape = torch.broadcast_shapes(*[i.shape for i in idx]) \
                if idx else ()
            rest = [s for d, s in enumerate(dst.shape)
                    if d >= len(indices) or indices[d] is None]
            region = _prod(bshape) * _prod(rest) * isize
            srcs = [values]
        elif name in ("index_add_", "index_add", "index_copy_", "index_copy"):
            dim, index, src = args[1], args[2], args[3]
            idx, srcs, acc = [index], [src], bool(_WRITE_OPS[name])
            region = src.numel() * isize
        elif name.startswith("scatter"):
            dim, index = args[1], args[2]
            src = args[3] if len(args) > 3 else kwargs.get("src")
            idx, acc = [index], bool(_WRITE_OPS[name])
            srcs = [src] if isinstance(src, torch.Tensor) else []
            region = index.numel() * isize
        else:                             # masked / index fills
            idx = _tensors(args[1:2])
            srcs = _tensors(args[2:])
            acc = False
            region = _nbytes(dst, span=False)
        reads = [(i, _nbytes(i)) for i in idx]
        reads += [(s, min(_nbytes(s), float(region))) for s in srcs]
        if acc:
            reads.append((dst, float(region)))
        out = outs[0] if outs else dst
        # a scatter is data movement in hlo_cost.py, its add combiner too
        self._charge(0.0, 0.0, reads, [(out, float(region))])

    def _flops(self, name, args, ins, outs) -> Tuple[float, float]:
        out_elems = float(sum(t.numel() for t in outs))
        if name in _MATMUL_OPS:
            a = args[1] if name in ("addmm", "baddbmm", "addmv",
                                    "addbmm") else args[0]
            k = a.shape[-1]
            f = 2.0 * out_elems * k
            if name in ("addmm", "baddbmm", "addmv", "addbmm"):
                f += out_elems            # the bias add XLA fuses after
            return f, 0.0
        if name in _SDPA_OPS:
            q, k = args[0], args[1]
            o = q.shape[:-1] + (args[2].shape[-1],)
            return 2.0 * _prod(o) * k.shape[-2] + 2.0 * _prod(
                q.shape[:-1]) * k.shape[-2] * q.shape[-1], 0.0
        if name in _CONV_OPS:
            w = args[1]
            return 2.0 * out_elems * _prod(w.shape[1:]), 0.0
        if name in _MOVEMENT_OPS:
            return 0.0, 0.0
        if name in _COMPARE_REDUCTIONS:
            return 0.0, 0.0
        if name in ("_softmax", "softmax", "_log_softmax", "log_softmax"):
            # max (compare), subtract, exp, sum, divide: XLA's decomposition
            n = float(ins[0].numel())
            return 4.0 * n, n
        if name in _SUM_REDUCTIONS:
            n = float(ins[0].numel())
            if name in ("mean", "var", "std"):
                n += out_elems
            return n, 0.0
        if name in _COMPOSITE_ELEMENTWISE:
            f, tr = _COMPOSITE_ELEMENTWISE[name]
            return f * out_elems, tr * out_elems
        if name in TRANSCENDENTAL_OPS:
            if name.startswith("pow") and len(args) > 1 and isinstance(
                    args[1], (int, float)) and float(args[1]).is_integer():
                return out_elems, 0.0
            return out_elems, out_elems
        return out_elems, 0.0


def walk(fn: Callable, *args, params: Any = None, pools: Any = None,
         states: Any = None, **kwargs) -> Tuple[OpCost, Any]:
    """Run ``fn(*args, **kwargs)`` under :class:`OpCostMode` and return
    (its cost, its output)."""
    mode = OpCostMode(params=params, pools=pools, states=states)
    with mode:
        out = fn(*args, **kwargs)
    return mode.cost, out
