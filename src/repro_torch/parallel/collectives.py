"""The tensor-parallel collective edges, the ring collective matmuls and
the data-parallel reduces on ``torch.distributed``: the JAX package's
``parallel/collectives.py`` for explicit SPMD, and the collectives GSPMD
places in the reference's data-parallel train step.

Every function runs on every rank of the axis (``axis`` names a mesh axis;
its process group comes from the active mesh, parallel/mesh.py
``use_mesh``) and returns this rank's result.  ``axis=None`` is the
unsharded model: the plain product, no collective.

* :func:`tp_copy` / :func:`tp_reduce`: Megatron's two conjugate edges
  of a tensor-parallel region, differentiable.  ``tp_copy`` ("f") is
  the identity forward and all-reduces the cotangent backward: it goes
  where a replicated activation (or a replicated weight read in part)
  enters a column-sharded product, whose backward leaves each rank a
  partial gradient.  ``tp_reduce`` ("g") all-reduces forward and is the
  identity backward: the row-parallel exit, whose consumer is
  replicated on every rank of the axis.  ``psum`` below is neither: its
  backward all-reduces too, right for the loss's token sums over the
  batch axes, and tp times the gradient at a tp exit;
* :func:`row_parallel_psum` / :func:`row_parallel_matmul`: the
  all-reduce epilogue of a row-parallel (contraction-sharded) matmul, the
  attention / MLA o-projection and the FFN down-projection, through
  ``tp_reduce`` while the partial product carries a gradient (the same
  forward bits as serving's bare all-reduce); ``overlap="ring"``
  computes it as :func:`ring_matmul_reduce`, serving only;
* :func:`all_gather_cols`: the vocab-sharded logits edge, whose backward
  keeps the rank's own column block;
* :func:`seq_slice` / :func:`seq_gather`: the edges of context-parallel
  attention (query heads that do not divide the axis: the rank's rows of
  the sequence), a slice whose backward pads the cotangent with zeros
  and an all-gather whose backward keeps the rank's rows;
* :func:`head_gather` / :func:`kv_merge`: the edges of decode over a
  dense cache whose lines are cut over the axis (KV heads that do not
  divide it): the rank's query heads gathered, so that it attends every
  head over its lines, and the ranks' partial outputs merged by their
  log-sum-exps (flash-decoding), one all-gather each, forward only;
* :func:`ring_allgather_matmul`, :func:`psum_scatter_matmul`: the
  sequence-parallel entry edge and the reduce-scatter epilogue;
* data parallelism over the batch axes ``("data", "pod")``
  (``mesh.dp_axes``): :func:`psum`, a differentiable all-reduce (the
  loss's token sums, the MoE router statistics), :func:`gather_shards`
  (per-shard values in batch-shard order), :func:`reduce_scatter_dim` /
  :func:`all_gather_dim` (ZeRO-1's gradient reduce-scatter and
  parameter all-gather) and :func:`all_reduce_`.

Sums run in the activation dtype, as ``psum`` does.  ``gloo`` takes CUDA
tensors for the all-reduce, the all-gather and the reduce-scatter, and
refuses them for send / recv (measured on an H100 with torch 2.11:
"writev ... Bad address"): on ``gloo``, a CUDA tensor's send / recv
goes through pinned host memory (:func:`staged_p2p`).  That is decided
by the backend and the tensor's device before the call, never by
catching a failed call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import axis_group

# torch 2.13 renames the tensor-at-once gather and scatter
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def staged_p2p(group, t: torch.Tensor) -> bool:
    """Whether a send / recv of ``t`` over ``group`` goes through pinned
    host memory: gloo refuses CUDA tensors there (the other collectives
    take them directly)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _size_rank(group):
    return dist.get_world_size(group), dist.get_rank(group)


def _grad_edge(x: torch.Tensor) -> bool:
    """Whether ``x`` is on a path autograd will differentiate: the edges
    run as functions with a backward only then (serving runs them under
    no_grad, on weights that need none)."""
    return torch.is_grad_enabled() and x.requires_grad


def _all_reduce_tagged(t: torch.Tensor, group, tag: str) -> torch.Tensor:
    """An all-reduce under the walk's tag of its edge
    (``op_collectives.EDGE_TAGS``)."""
    from ..core.roofline.op_cost import named_scope
    with named_scope(tag):
        dist.all_reduce(t, group=group)
    return t


class _TPCopy(torch.autograd.Function):
    """Identity forward; the cotangent's all-reduce over the group
    backward (Megatron's "f")."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        return _all_reduce_tagged(gy.contiguous().clone(), ctx.group,
                                  "tp_copy"), None


class _TPReduce(torch.autograd.Function):
    """All-reduce forward; identity backward (Megatron's "g"): every
    rank's consumer of the sum is the same replicated computation, so
    each rank's cotangent is already the whole one."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_tagged(x.contiguous().clone(), group, "tp_reduce")

    @staticmethod
    def backward(ctx, gy):
        return gy, None


def tp_copy(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """``x`` entering a region sharded over ``axis``: the identity, whose
    backward sums the ranks' partial cotangents (:class:`_TPCopy`).
    Without a gradient to carry (serving, ``axis`` None, an input that
    needs none) it is ``x`` itself and moves nothing."""
    if axis is None or not _grad_edge(x):
        return x
    return _TPCopy.apply(x, axis_group(axis))


def tp_reduce(partial: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """The sum over ``axis`` of the ranks' partial results (a
    row-parallel product, a vocab-sharded lookup): an all-reduce in
    ``partial``'s dtype, differentiable as :class:`_TPReduce` while
    ``partial`` carries a gradient, else :func:`row_parallel_psum`'s bare
    all-reduce (the same bits).  ``axis`` None is ``partial``."""
    if axis is None:
        return partial
    if _grad_edge(partial):
        return _TPReduce.apply(partial, axis_group(axis))
    return row_parallel_psum(partial, axis)


def row_parallel_psum(partial: torch.Tensor, axis: str) -> torch.Tensor:
    """All-reduce (sum) over ``axis`` of a row-parallel matmul's partial
    product: each rank contracted its slice of the inner dim (local heads
    of the o-projection, local d_ff of the down-projection).  Two of
    these per transformer block are the whole card-to-card cost of a
    tensor-parallel decode step (scheduler.decode_step_ici_bytes).  Not
    differentiable: training goes through :func:`tp_reduce`.  Tagged
    ``tp_reduce`` for the walk, as that edge's forward is."""
    return _all_reduce_tagged(partial.contiguous(), axis_group(axis),
                              "tp_reduce")


def _gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    n, _ = _size_rank(group)
    buf = x.new_empty((n * x.numel(),))
    _ALL_GATHER(buf, x.contiguous().view(-1), group=group)
    C = x.shape[-1]
    return buf.view(n, *x.shape).movedim(0, -2).reshape(*x.shape[:-1],
                                                         n * C)


class _GatherCols(torch.autograd.Function):
    """The tiled all-gather of column blocks; backward keeps the rank's
    own block of the cotangent (every rank's consumer of the gathered
    columns is the same replicated computation)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.cols = _size_rank(group)[1], x.shape[-1]
        from ..core.roofline.op_cost import named_scope
        with named_scope("tp_gather"):
            return _gather_cols(x, group)

    @staticmethod
    def backward(ctx, gy):
        c = ctx.cols
        return gy[..., ctx.rank * c:(ctx.rank + 1) * c], None


def all_gather_cols(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Gather a column-sharded activation to its full last dim, rank
    order (a tiled all-gather).  The collective gathers along dim 0 of a
    flat buffer; the column blocks are laid back side by side here.  A
    group of one still issues it (a copy), so a graph captured there
    holds the edge.  Differentiable while ``x`` carries a gradient
    (:class:`_GatherCols`)."""
    group = axis_group(axis)
    if _grad_edge(x):
        return _GatherCols.apply(x, group)
    from ..core.roofline.op_cost import named_scope
    with named_scope("tp_gather"):
        return _gather_cols(x, group)


def _rows(n: int, r: int, size: int) -> slice:
    k = size // n
    return slice(r * k, (r + 1) * k)


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of ``group`` laid side by side along ``dim``, in
    rank order (one all-gather of the blocks moved to the front)."""
    n, _ = _size_rank(group)
    src = x.movedim(dim, 0).contiguous()
    buf = src.new_empty((n * src.shape[0], *src.shape[1:]))
    _ALL_GATHER(buf, src, group=group)
    return buf.movedim(0, dim)


class _SeqGather(torch.autograd.Function):
    """The all-gather of sequence blocks along ``dim``; backward keeps the
    rank's own block of the cotangent (every rank's consumer of the
    gathered rows is the same replicated computation, so each rank's
    cotangent is already the whole one)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.rank, ctx.k = dim, _size_rank(group)[1], x.shape[dim]
        from ..core.roofline.op_cost import named_scope
        with named_scope("seq_gather"):
            return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, gy):
        return gy.narrow(ctx.dim, ctx.rank * ctx.k, ctx.k), None, None


class _SeqSlice(torch.autograd.Function):
    """The rank's block of a replicated activation along ``dim``;
    backward puts the cotangent back into zeros of the whole shape."""

    @staticmethod
    def forward(ctx, x, dim, n, r):
        ctx.dim, ctx.shape = dim, x.shape
        ctx.rows = _rows(n, r, x.shape[dim])
        return x.narrow(dim, ctx.rows.start, ctx.rows.stop - ctx.rows.start)

    @staticmethod
    def backward(ctx, gy):
        gx = gy.new_zeros(ctx.shape)
        gx.narrow(ctx.dim, ctx.rows.start,
                  ctx.rows.stop - ctx.rows.start).copy_(gy)
        return gx, None, None, None


def seq_slice(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """This rank's rows of ``x`` along ``dim`` (its block of ``size /
    n``, rank order over ``axis``): the entry of a context-parallel
    region.  Moves nothing; differentiable while ``x`` carries a
    gradient (:class:`_SeqSlice`), else a view."""
    from .mesh import active_mesh
    mesh = active_mesh()
    n, r = mesh.sizes[axis], mesh.coord(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"into {n} blocks over {axis!r}")
    if _grad_edge(x):
        return _SeqSlice.apply(x, dim, n, r)
    rows = _rows(n, r, x.shape[dim])
    return x.narrow(dim, rows.start, rows.stop - rows.start)


def seq_gather(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """The ranks' sequence blocks of ``x`` gathered along ``dim`` over
    ``axis`` (the exit of a context-parallel region), tagged
    ``seq_gather`` for the walk; differentiable while ``x`` carries a
    gradient (:class:`_SeqGather`)."""
    group = axis_group(axis)
    if _grad_edge(x):
        return _SeqGather.apply(x, dim, group)
    from ..core.roofline.op_cost import named_scope
    with named_scope("seq_gather"):
        return _gather_dim(x, dim, group)


def head_gather(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """The ranks' head blocks of ``x`` (a decode query, or a head-sharded
    weight an expanded MLA decode reads whole) laid side by side along
    ``dim`` in rank order: one all-gather, tagged ``head_gather`` for the
    walk.  Serving only (no backward)."""
    from ..core.roofline.op_cost import named_scope
    with named_scope("head_gather"):
        return _gather_dim(x, dim, axis_group(axis))


def _lse_slots(lse: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The float32 ``lse`` (...) as (..., k) elements of ``dtype`` whose
    bytes are its bits (k = 4 / itemsize), to travel beside an output of
    that dtype in one buffer."""
    return lse.contiguous()[..., None].view(dtype)


def kv_merge(o: torch.Tensor, lse: torch.Tensor, axis: str) -> torch.Tensor:
    """The flash-decoding merge over ``axis`` of every rank's partial
    attention output ``o`` (..., hd) over its block of a sequence's lines,
    with its rows' log-sum-exps ``lse`` (...) float32 (-inf for a row
    that saw no line): lse* = log sum_r e^lse_r and o = sum_r
    e^(lse_r - lse*) o_r, in float32 and rank order, rounded once to
    ``o``'s dtype.  A rank at -inf weighs exactly 0; a row that no rank
    saw gives 0.

    One all-gather of (o, lse) packed in o's dtype (lse's float32 bits as
    4 / itemsize elements beside hd), tagged ``kv_merge``: (n - 1) rows x
    (hd itemsize + 4) bytes on the wire a rank.  (The other form, an
    all-reduce of the max and then one of (l, acc), moves about twice
    that in two collectives.)  Every rank gets the whole merge, and no
    backward: decode is not trained."""
    from ..core.roofline.op_cost import named_scope
    hd = o.shape[-1]
    packed = torch.cat([o, _lse_slots(lse, o.dtype)], dim=-1)
    with named_scope("kv_merge"):
        every = _gather_dim(packed[None], 0, axis_group(axis))
    parts = every[..., :hd].float()
    lses = every[..., hd:].contiguous().view(torch.float32)[..., 0]
    top = lses.max(dim=0).values
    top = torch.where(torch.isfinite(top), top, 0.0)
    w = torch.exp(lses - top)                        # (n, ...); 0 at -inf
    den = w.sum(dim=0)
    out = (w[..., None] * parts).sum(dim=0) / den.clamp_min(1e-30)[..., None]
    return out.to(o.dtype)


def _ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """Send ``t`` to the next rank of ``group``, return the previous
    rank's (one ring step)."""
    n, r = _size_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    src = t.contiguous()
    staged = staged_p2p(group, src)
    if staged:
        src = src.to("cpu").pin_memory()
    dst = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, nxt, group),
           dist.P2POp(dist.irecv, dst, prv, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return dst.to(t.device, non_blocking=True) if staged else dst


def ring_matmul_reduce(h: torch.Tensor, w: torch.Tensor,
                       axis: str) -> torch.Tensor:
    """``row_parallel_psum(h @ w, axis)`` as a ring: h (..., K_local), w
    (K_local, N) this rank's rows of the weight.  N splits into n chunks
    (zero columns pad N up to a multiple of n, sliced off after); at step
    s each rank multiplies into one chunk while the accumulator of the
    previous chunk moves one hop on the ring, so after n steps rank i
    holds the full sum of chunk i, and a tiled all-gather rebuilds the
    row.  Wire bytes: (n-1) hops of one chunk plus the all-gather, 2 x
    payload x (n-1)/n, the all-reduce's.  The addition order differs from
    the all-reduce's, so results are close, not bitwise equal."""
    group = axis_group(axis)
    n, idx = _size_rank(group)
    if n == 1:
        return h @ w
    N = w.shape[-1]
    chunk = -(-N // n)
    if chunk * n != N:
        w = torch.nn.functional.pad(w, (0, chunk * n - N))
    acc = None
    for s in range(n):
        c = (idx - s - 1) % n                # the chunk this rank works on
        local = h @ w[:, c * chunk:(c + 1) * chunk]
        acc = local if acc is None else _ring_shift(acc, group) + local
    out = all_gather_cols(acc, axis)
    return out[..., :N] if chunk * n != N else out


def row_parallel_matmul(h: torch.Tensor, w: torch.Tensor,
                        axis: Optional[str],
                        overlap: str = "none") -> torch.Tensor:
    """The row-parallel epilogue: ``h @ w`` then :func:`tp_reduce`
    (``overlap="none"``) or :func:`ring_matmul_reduce` ("ring", which
    raises NotImplementedError on operands that carry a gradient);
    ``axis=None`` is the plain matmul whatever the schedule."""
    if overlap not in ("none", "ring"):
        raise ValueError(f"overlap {overlap!r} not in ('none', 'ring')")
    if axis is None:
        return h @ w
    if overlap == "ring":
        if _grad_edge(h) or _grad_edge(w):
            raise NotImplementedError(
                "tp_overlap='ring' has no backward: the ring matmul is a "
                "serving schedule (training under it: ROADMAP queue 1 "
                "item 21)")
        return ring_matmul_reduce(h, w, axis)
    return tp_reduce(h @ w, axis)


def _pad_to(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    extra = -x.shape[dim] % n
    if not extra:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, extra]
    return torch.nn.functional.pad(x, pad)


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor,
                          axis: str) -> torch.Tensor:
    """``all_gather(x) @ w`` without gathering x: the sequence-parallel
    entry edge.  ``x`` (S, K) and ``w`` (K, N) are the global operands;
    this rank uses its block of x's rows and of w's columns (S and N
    padded with zeros to a multiple of the axis size) and returns its
    column block of the product, (S, N/n) on the padded grid, cut to the
    real N (the last ranks' blocks may be narrower or empty).  Each ring
    step multiplies the row block in hand into its rows of the output
    while the block moves on."""
    group = axis_group(axis)
    n, idx = _size_rank(group)
    S, N = x.shape[0], w.shape[1]
    xp, wp = _pad_to(x, 0, n), _pad_to(w, 1, n)
    rows, cols = xp.shape[0] // n, wp.shape[1] // n
    w_blk = wp[:, idx * cols:(idx + 1) * cols]
    blk = xp[idx * rows:(idx + 1) * rows]
    out = torch.zeros((rows * n, cols), dtype=torch.float32,
                      device=x.device)
    for i in range(n):
        src = (idx - i) % n                  # the block's owner
        out[src * rows:(src + 1) * rows] = (blk @ w_blk).float()
        if i < n - 1:
            blk = _ring_shift(blk, group)
    lo = min(idx * cols, N)
    return out[:S, :max(min((idx + 1) * cols, N) - lo, 0)].to(x.dtype)


def psum_scatter_matmul(x: torch.Tensor, w: torch.Tensor,
                        axis: str) -> torch.Tensor:
    """Row-parallel matmul with a reduce-scatter epilogue: ``x`` (M, K)
    and ``w`` (K, N) are the global operands; this rank contracts its
    block of K and receives its column block of the summed (M, N), cut to
    the real N as :func:`ring_allgather_matmul` does.  Half the all-reduce
    epilogue's wire bytes when the consumer is itself sharded over the
    axis.  Partial sums in float32, as the reference's."""
    group = axis_group(axis)
    n, idx = _size_rank(group)
    N = w.shape[1]
    k = -(-x.shape[1] // n)
    xp, wp = _pad_to(x, 1, n), _pad_to(w, 0, n)
    part = (xp[:, idx * k:(idx + 1) * k]
            @ wp[idx * k:(idx + 1) * k]).float()
    part = _pad_to(part, 1, n)
    cols = part.shape[1] // n
    out = part.new_empty((cols, part.shape[0]))
    _REDUCE_SCATTER(out, part.t().contiguous(), group=group)
    lo = min(idx * cols, N)
    return out.t()[:, :max(min((idx + 1) * cols, N) - lo, 0)].to(x.dtype)


# --------------------------------------------------------------------------
# Data parallelism
# --------------------------------------------------------------------------

def _dp_groups(axes) -> list:
    return [axis_group(a) for a in axes]


class _PSum(torch.autograd.Function):
    """All-reduce (sum) whose backward is the all-reduce of the
    cotangent: ``psum``'s transpose.  Every rank's output is the same
    global sum, so a loss built from it is the global loss on every
    rank; the backward sums the ranks' (equal) cotangents, so each rank's
    gradient is R times its own tokens' share of the global gradient,
    and the mean over the R ranks, the data-parallel gradient reduce, is
    the global gradient (an identity backward would give 1/R of it)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        out = x.contiguous().clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, gy):
        gx = gy.contiguous().clone()
        for g in ctx.groups:
            dist.all_reduce(gx, group=g)
        return gx, None


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``x`` over every rank of ``axes`` (an all-reduce per
    axis, in order), differentiable as :class:`_PSum` says.  The groups
    are resolved here, so the backward needs no active mesh."""
    groups = _dp_groups(axes)
    return _PSum.apply(x, groups) if groups else x


def all_reduce_(t: torch.Tensor, axes) -> torch.Tensor:
    """In-place sum of ``t`` over ``axes`` (one all-reduce per axis, in
    the tensor's dtype), not differentiable; returns ``t``."""
    for g in _dp_groups(axes):
        dist.all_reduce(t, group=g)
    return t


def gather_shards(t: torch.Tensor, axes) -> torch.Tensor:
    """Every batch shard's ``t``, stacked (R, *t.shape) in batch-shard
    order (row-major over ``("pod", "data")``, ``mesh.batch_shard``):
    one all-gather per axis of ``axes``, ``"data"`` before ``"pod"``."""
    out = t.contiguous()
    for a in axes:
        group = axis_group(a)
        n, _ = _size_rank(group)
        buf = out.new_empty((n * out.numel(),))
        _ALL_GATHER(buf, out.reshape(-1), group=group)
        out = buf.view(n, *out.shape)
    return out.reshape(-1, *t.shape)


def reduce_scatter_dim(t: torch.Tensor, dim: int, axis: str,
                       form: Optional[str] = None) -> torch.Tensor:
    """The sum of ``t`` over ``axis``, this rank's block along ``dim``
    (the dim's size over the axis's; rank order).  ``form`` (None: the
    backend's) is "reduce_scatter", NCCL's ``reduce_scatter_tensor`` on
    the blocks moved to the front, or "all_reduce", the whole sum then
    the rank's slice: the form taken on gloo, whose reduce-scatter not
    every torch build has.  Either sums in ``t``'s dtype."""
    group = axis_group(axis)
    n, idx = _size_rank(group)
    k = t.shape[dim] // n
    if form is None:
        form = ("all_reduce" if dist.get_backend(group) == "gloo"
                else "reduce_scatter")
    if form == "all_reduce":
        full = t.contiguous().clone()
        dist.all_reduce(full, group=group)
        return full.narrow(dim, idx * k, k).contiguous()
    if form != "reduce_scatter":
        raise ValueError(f"form {form!r} not in (None, 'all_reduce', "
                         "'reduce_scatter')")
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((k, *src.shape[1:]))
    _REDUCE_SCATTER(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def all_gather_dim(t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """The ranks' blocks of ``axis`` laid side by side along ``dim``, in
    rank order (ZeRO-1's parameter all-gather)."""
    group = axis_group(axis)
    n, _ = _size_rank(group)
    src = t.movedim(dim, 0).contiguous()
    buf = src.new_empty((n * src.shape[0], *src.shape[1:]))
    _ALL_GATHER(buf, src, group=group)
    return buf.movedim(0, dim).contiguous()


__all__ = [
    "all_gather_cols", "all_gather_dim", "all_reduce_",
    "gather_shards", "head_gather", "kv_merge", "tp_copy", "tp_reduce",
    "psum", "reduce_scatter_dim", "psum_scatter_matmul", "ring_allgather_matmul",
    "ring_matmul_reduce", "row_parallel_matmul", "row_parallel_psum",
    "seq_gather", "seq_slice", "staged_p2p",
]
