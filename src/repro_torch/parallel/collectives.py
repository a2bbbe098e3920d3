"""The tensor-parallel collective edges and the ring collective matmuls
on ``torch.distributed``: the JAX package's ``parallel/collectives.py``
for explicit SPMD.

Every function runs on every rank of the axis (``axis`` names a mesh axis;
its process group comes from the active mesh, parallel/mesh.py
``use_mesh``) and returns this rank's result.  ``axis=None`` is the
unsharded model: the plain product, no collective.

* :func:`row_parallel_psum` / :func:`row_parallel_matmul`: the
  all-reduce epilogue of a row-parallel (contraction-sharded) matmul, the
  attention / MLA o-projection and the FFN down-projection;
  ``overlap="ring"`` computes it as :func:`ring_matmul_reduce`;
* :func:`all_gather_cols`: the vocab-sharded logits edge;
* :func:`ring_allgather_matmul`, :func:`psum_scatter_matmul`: the
  sequence-parallel entry edge and the reduce-scatter epilogue.

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


def row_parallel_psum(partial: torch.Tensor, axis: str) -> torch.Tensor:
    """All-reduce (sum) over ``axis`` of a row-parallel matmul's partial
    product: each rank contracted its slice of the inner dim (local heads
    of the o-projection, local d_ff of the down-projection).  Two of
    these per transformer block are the whole card-to-card cost of a
    tensor-parallel decode step (scheduler.decode_step_ici_bytes)."""
    out = partial.contiguous()
    dist.all_reduce(out, group=axis_group(axis))
    return out


def all_gather_cols(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Gather a column-sharded activation to its full last dim, rank
    order (a tiled all-gather).  The collective gathers along dim 0 of a
    flat buffer; the column blocks are laid back side by side here.  A
    group of one still issues it (a copy), so a graph captured there
    holds the edge."""
    group = axis_group(axis)
    n, _ = _size_rank(group)
    buf = x.new_empty((n * x.numel(),))
    _ALL_GATHER(buf, x.contiguous().view(-1), group=group)
    C = x.shape[-1]
    return buf.view(n, *x.shape).movedim(0, -2).reshape(*x.shape[:-1],
                                                         n * C)


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
    """The row-parallel epilogue: ``h @ w`` then :func:`row_parallel_psum`
    (``overlap="none"``) or :func:`ring_matmul_reduce` ("ring");
    ``axis=None`` is the plain matmul whatever the schedule."""
    if overlap not in ("none", "ring"):
        raise ValueError(f"overlap {overlap!r} not in ('none', 'ring')")
    if axis is None:
        return h @ w
    if overlap == "ring":
        return ring_matmul_reduce(h, w, axis)
    return row_parallel_psum(h @ w, axis)


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


__all__ = [
    "all_gather_cols", "psum_scatter_matmul", "ring_allgather_matmul",
    "ring_matmul_reduce", "row_parallel_matmul", "row_parallel_psum",
    "staged_p2p",
]
