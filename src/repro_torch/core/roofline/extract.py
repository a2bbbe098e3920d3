"""The paper's (W, Q) character of one step, from the op-level walk: the
port's counterpart of the JAX package's ``core/roofline/extract.py``.

Paper protocol -> the port's mapping:

* Work W            : the walk's FLOPs (``op_cost.py``: every aten op one
                      call dispatches, ``hlo_cost.py``'s conventions);
* Traffic Q         : the walk's bytes: every op's operands and results,
                      since every aten op is a kernel of its own;
* the naive counter : ``torch.utils.flop_counter.FlopCounterMode``, which
                      counts matmuls, convolutions and attention only, kept
                      in ``cost_raw`` as the reference keeps
                      ``cost_analysis()`` (the paper reports both the
                      LLC-derived and the IMC-derived traffic);
* Collective traffic: ``CollectiveSummary``, filled by the walk of the
                      ``c10d`` operators a sharded step dispatches
                      (``op_collectives.py``); zero on one card;
* Overhead subtraction: :meth:`StepCharacter.subtract`, the paper's
                      run-minus-no-run, which the engine's no-kernel twin
                      (``Engine._no_kernel_cfg``) can feed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten

from . import op_cost
from .hardware import ScopeSpec
from .model import RooflineTerms, make_terms


@dataclasses.dataclass
class CollectiveSummary:
    """Per-device collective wire bytes, the reference's
    ``hlo.py::CollectiveSummary`` as data (``op_collectives.summarize``
    fills it from a walked step; ``ops_by_kind`` counts the ops of each
    kind).  One card moves none: every field stays zero."""

    total_wire_bytes: float = 0.0
    ici_wire_bytes: float = 0.0
    dcn_wire_bytes: float = 0.0
    by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    by_axes: Dict[Tuple[str, ...], float] = dataclasses.field(
        default_factory=dict)
    n_ops: int = 0
    top_ops: List[Any] = dataclasses.field(default_factory=list)
    ops_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MemoryFootprint:
    """Bytes of the call's tensor arguments and outputs.  ``temp_bytes``
    stays 0: the largest set of intermediates alive at once is the caching
    allocator's business (a captured graph reuses its pool across the
    step), and the Python objects the walk sees die on another schedule,
    so the walk does not guess it."""

    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    generated_code_bytes: int = 0

    @property
    def peak_bytes(self) -> int:
        return self.argument_bytes + self.output_bytes + self.temp_bytes


@dataclasses.dataclass
class StepCharacter:
    """Everything measured about one step (per-device units)."""

    flops_dev: float
    hbm_bytes_dev: float
    transcendentals_dev: float
    collectives: CollectiveSummary
    memory: MemoryFootprint
    op_counts: Dict[str, int]
    cost_raw: Dict[str, float]
    scopes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # tracked tag -> {"flops", "bytes", "param_bytes", "pool_bytes",
    # "activation_bytes"}, and "state_bytes" when the walk had state rows
    bytes_by_category: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def subtract(self, overhead: "StepCharacter") -> "StepCharacter":
        """Paper's framework-overhead subtraction (run minus no-run)."""
        return dataclasses.replace(
            self,
            flops_dev=max(self.flops_dev - overhead.flops_dev, 0.0),
            hbm_bytes_dev=max(self.hbm_bytes_dev - overhead.hbm_bytes_dev, 0.0),
            transcendentals_dev=max(
                self.transcendentals_dev - overhead.transcendentals_dev, 0.0
            ),
        )


def _tensor_bytes(tree: Any) -> int:
    """Bytes of the distinct tensors of ``tree`` (a tensor given twice
    counts once)."""
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def characterize(fn: Callable, *args, params: Any = None, pools: Any = None,
                 states: Any = None, **kwargs) -> StepCharacter:
    """Walk one call ``fn(*args, **kwargs)`` and build its StepCharacter.

    ``params`` / ``pools`` / ``states`` name the model's parameters, KV
    pools and recurrent state rows among the arguments, for the walk's
    byte split (``bytes_by_category``).  Run
    it on fake tensors (``FakeTensorMode``, entered by the caller) to
    characterize a full-width step without computing or allocating it.
    W, Q and transcendentals come from :mod:`op_cost`; the naive counter,
    ``FlopCounterMode``'s total, is kept in ``cost_raw`` as
    ``naive_flops``."""
    from torch.utils.flop_counter import FlopCounterMode
    naive = FlopCounterMode(display=False)
    with naive:
        cost, out = op_cost.walk(fn, *args, params=params, pools=pools,
                                 states=states, **kwargs)
    memory = MemoryFootprint(argument_bytes=_tensor_bytes((args, kwargs)),
                             output_bytes=_tensor_bytes(out))
    return StepCharacter(
        flops_dev=cost.flops,
        hbm_bytes_dev=cost.bytes,
        transcendentals_dev=cost.transcendentals,
        collectives=CollectiveSummary(),
        memory=memory,
        op_counts=dict(cost.op_counts),
        cost_raw={"naive_flops": float(naive.get_total_flops())},
        scopes={k: dict(v) for k, v in cost.scopes.items()},
        bytes_by_category=dict(cost.by_category),
    )


def terms_from_character(
    char: StepCharacter,
    scope: ScopeSpec,
    *,
    dtype: str = "bfloat16",
    model_flops_total: Optional[float] = None,
) -> RooflineTerms:
    return make_terms(
        scope=scope,
        dtype=dtype,
        flops_dev=char.flops_dev,
        hbm_bytes_dev=char.hbm_bytes_dev,
        ici_wire_bytes_dev=char.collectives.ici_wire_bytes,
        dcn_wire_bytes_dev=char.collectives.dcn_wire_bytes,
        transcendentals_dev=char.transcendentals_dev,
        model_flops_total=model_flops_total,
    )


def character_as_dict(char: StepCharacter) -> Dict[str, Any]:
    """JSON-serializable dump, the reference's keys plus the walk's byte
    split (``bytes_by_category``)."""
    return {
        "flops_dev": char.flops_dev,
        "hbm_bytes_dev": char.hbm_bytes_dev,
        "transcendentals_dev": char.transcendentals_dev,
        "collective_wire_bytes_dev": char.collectives.total_wire_bytes,
        "collective_ici_bytes_dev": char.collectives.ici_wire_bytes,
        "collective_dcn_bytes_dev": char.collectives.dcn_wire_bytes,
        "collective_by_kind": dict(char.collectives.by_kind),
        "collective_by_axes": {
            "+".join(k) if k else "(unattributed)": v
            for k, v in char.collectives.by_axes.items()
        },
        "n_collective_ops": char.collectives.n_ops,
        "memory": dataclasses.asdict(char.memory),
        "op_counts": char.op_counts,
        "scopes": char.scopes,
        "cost_raw": char.cost_raw,
        "bytes_by_category": dict(char.bytes_by_category),
    }
