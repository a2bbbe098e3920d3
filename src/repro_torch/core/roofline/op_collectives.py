"""The collective half of the op-level walk: the port's counterpart of the
JAX package's ``core/roofline/hlo.py`` collective parse (``CollectiveOp``,
ring wire bytes per op, ``CollectiveSummary``).

The reference compiles a sharded step and reads the collective ops out of
the partitioned HLO.  Here a step is one Python call on every rank, and
what crosses ranks is the ``c10d`` operators it dispatches: a
``TorchDispatchMode`` (:class:`CollectiveWalk`) sees each of them with
its tensors and its process group, whatever code issued it.  So the walk
counts what the step really sent, independently of the code that sent it
(it never looks at ``parallel/collectives.py``), and
serve/crosscheck.py ``crosscheck_collectives`` holds the ledger's
analytic bytes against it.

A walked step runs for real: fake tensors cannot pass through a process
group, so every rank of the group must walk the same step together.

Wire bytes per op and device, the reference's ring model
(``CollectiveOp.wire_bytes``): an all-reduce ``2 x payload x (n-1)/n``,
an all-gather / reduce-scatter / all-to-all ``payload x (n-1)/n``, a
point-to-point send its payload (the matching receive moves nothing more
on this device's wire), payload being the larger of the op's result and
operand bytes on this device.

Each op also carries its edge: the innermost of the tensor-parallel
edges' tags (:data:`EDGE_TAGS`: ``tp_copy``, whose
all-reduce runs in the backward, ``tp_reduce``, ``tp_gather``, the
context-parallel ``seq_gather`` and decode's ``head_gather`` and
``kv_merge`` over a sequence-sharded cache) open on
the dispatching thread, so a step's ``model`` bytes split by edge
(:func:`summarize`'s ``by_edge``), forward, backward and a checkpointed
layer's recompute alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .extract import CollectiveSummary
from .op_cost import _stack

# the tags parallel/collectives.py's tensor-parallel edges issue their
# collectives under (``op_cost.named_scope``)
EDGE_TAGS = ("tp_copy", "tp_reduce", "tp_gather", "seq_gather",
             "head_gather", "kv_merge")

# c10d operator -> (the reference's collective kind, and the positions of
# its result tensors, its operand tensors and its process group among the
# operator's arguments)
C10D_OPS: Dict[str, Tuple[str, int, int, int]] = {
    "allreduce_": ("all-reduce", 0, 0, 1),
    "allreduce_coalesced_": ("all-reduce", 0, 0, 1),
    "_allgather_base_": ("all-gather", 0, 1, 2),
    "allgather_": ("all-gather", 0, 1, 2),
    "allgather_into_tensor_coalesced_": ("all-gather", 0, 1, 2),
    "_reduce_scatter_base_": ("reduce-scatter", 0, 1, 2),
    "reduce_scatter_": ("reduce-scatter", 0, 1, 2),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, 1, 2),
    "alltoall_base_": ("all-to-all", 0, 1, 2),
    "alltoall_": ("all-to-all", 0, 1, 2),
    "send": ("collective-permute", 0, 0, 1),
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str                 # the reference's kind (C10D_OPS)
    result_bytes: int         # this device's result bytes
    operand_bytes: int        # this device's operand bytes
    group_size: int           # ranks in the op's process group
    op: str = ""              # the c10d operator's name
    link: str = "ici"         # "ici" | "dcn"
    axis: str = ""            # the mesh axis of its group ("" unknown)
    edge: str = ""            # the tp edge that issued it (EDGE_TAGS)

    @property
    def payload_bytes(self) -> float:
        return max(self.result_bytes, self.operand_bytes)

    @property
    def wire_bytes(self) -> float:
        """Bytes this device puts on the wire (ring algorithm)."""
        n = max(self.group_size, 1)
        if n == 1:
            return 0.0
        ring = (n - 1) / n
        if self.kind == "all-reduce":
            return 2.0 * self.payload_bytes * ring
        if self.kind == "collective-permute":
            return float(self.payload_bytes)
        return self.payload_bytes * ring


def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _edge() -> str:
    for tag in reversed(_stack()):
        if tag in EDGE_TAGS:
            return tag
    return ""


def _group(pg: Any):
    import torch.distributed as dist
    return dist.ProcessGroup.unbox(pg)


class CollectiveWalk(TorchDispatchMode):
    """Records every collective ``c10d`` operator dispatched inside it (a
    receive is the other end of a recorded send and is not counted).

    With ``mesh`` (a ``parallel.mesh.Mesh``) each op is attributed to the
    mesh axis whose process group it ran on, by the group's name: its
    ``axis``, and its link, ``dcn`` for ``pod`` (across hosts), ``ici``
    otherwise.

    With ``timed`` (ops on a card), each recorded op also gets a pair of
    CUDA events: the start before the op, the end before the first
    operator dispatched after it (by then ``wait()`` has made the stream
    wait for the collective); :meth:`edge_ms` sums them."""

    def __init__(self, timed: bool = False, mesh: Any = None):
        super().__init__()
        self.ops: List[CollectiveOp] = []
        self.timed = timed
        self.pairs: List[Tuple[Any, Any]] = []
        self._open = None
        self._axes = {g.group_name: a for a, g in
                      (mesh.groups.items() if mesh is not None else ())}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__.split(".")[0]
        edge = func.namespace == "c10d" and name in C10D_OPS
        ev = None
        if self.timed and (edge or self._open is not None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            if self._open is not None:
                self.pairs.append((self._open, ev))
                self._open = None
        if edge:
            kind, res, opd, pg = C10D_OPS[name]
            group = _group(args[pg])
            axis = self._axes.get(group.group_name, "") if self._axes \
                else ""
            self.ops.append(CollectiveOp(
                kind=kind, result_bytes=_nbytes(args[res]),
                operand_bytes=_nbytes(args[opd]),
                group_size=group.size(), op=name,
                link="dcn" if axis == "pod" else "ici", axis=axis,
                edge=_edge()))
        out = func(*args, **kwargs)
        if edge and self.timed:
            self._open = ev
        return out

    def edge_ms(self) -> float:
        """Milliseconds between each timed op's start and end events."""
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def summarize(ops: List[CollectiveOp]) -> CollectiveSummary:
    """The reference's ``CollectiveSummary.from_ops``, plus the op count
    of each kind; ``by_axes`` holds the wire bytes of the ops a walk with
    a mesh attributed to an axis, ``by_edge`` those of the tp edges."""
    by_kind: Dict[str, float] = {}
    n_by_kind: Dict[str, int] = {}
    by_axes: Dict[Tuple[str, ...], float] = {}
    by_edge: Dict[str, float] = {}
    ici = dcn = 0.0
    for op in ops:
        w = op.wire_bytes
        by_kind[op.kind] = by_kind.get(op.kind, 0.0) + w
        n_by_kind[op.kind] = n_by_kind.get(op.kind, 0) + 1
        if op.axis:
            by_axes[(op.axis,)] = by_axes.get((op.axis,), 0.0) + w
        if op.edge:
            by_edge[op.edge] = by_edge.get(op.edge, 0.0) + w
        if op.link == "dcn":
            dcn += w
        else:
            ici += w
    return CollectiveSummary(
        total_wire_bytes=ici + dcn, ici_wire_bytes=ici, dcn_wire_bytes=dcn,
        by_kind=by_kind, by_axes=by_axes, n_ops=len(ops),
        top_ops=sorted(ops, key=lambda o: -o.wire_bytes)[:12],
        ops_by_kind=n_by_kind, by_edge=by_edge)


def walk_collectives(fn: Callable, *args, **kwargs
                     ) -> Tuple[Any, CollectiveSummary]:
    """Run ``fn(*args, **kwargs)`` (on every rank of its groups) and
    summarize the collectives it dispatched: (result, summary)."""
    with CollectiveWalk() as walk:
        out = fn(*args, **kwargs)
    return out, summarize(walk.ops)


__all__ = ["C10D_OPS", "EDGE_TAGS", "CollectiveOp", "CollectiveWalk", "summarize",
           "walk_collectives"]
