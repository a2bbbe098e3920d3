"""Roofline math for the serve ledger (paper eq. 1: ``P = min(pi,
I * beta)`` with arithmetic intensity ``I = W / Q``).

Each memory level with a priced beta contributes a time term
``bytes / beta``; the compute term is ``flops / pi``.  The dominant term
is the bottleneck.  A level whose beta is 0 (not priced) contributes no
term, whatever its bytes.  :class:`PhaseTraffic` accumulates one serving
phase's flops and bytes with its measured wall time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .hardware import ChipSpec, MEMORY_LEVELS, ScopeSpec


@dataclasses.dataclass
class RooflineTerms:
    scope: str
    n_chips: int
    dtype: str
    flops_dev: float
    hbm_bytes_dev: float
    vmem_bytes_dev: float = 0.0
    host_bytes_dev: float = 0.0
    chip: Optional[ChipSpec] = None

    @property
    def compute_s(self) -> float:
        return self.flops_dev / self.chip.flops_for(self.dtype)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_dev / self.chip.hbm_bw

    def level_bytes(self, level: str) -> float:
        return {"vmem": self.vmem_bytes_dev, "hbm": self.hbm_bytes_dev,
                "host": self.host_bytes_dev}[level]

    def terms(self) -> Dict[str, float]:
        """Seconds per priced resource: ``compute``, ``memory`` (HBM) and
        each other level with bytes and a known beta."""
        out = {"compute": self.compute_s, "memory": self.memory_s}
        for level in MEMORY_LEVELS:
            if level == "hbm":
                continue
            b, bw = self.level_bytes(level), self.chip.level_bw(level)
            if b > 0 and bw > 0:
                out[level] = b / bw
        return out

    @property
    def dominant(self) -> str:
        t = self.terms()
        return max(t, key=t.get)

    @property
    def arithmetic_intensity(self) -> float:
        """FLOP per HBM byte (the paper's I = W/Q)."""
        return self.flops_dev / max(self.hbm_bytes_dev, 1.0)

    @property
    def ridge_intensity(self) -> float:
        return self.chip.flops_for(self.dtype) / self.chip.hbm_bw

    def bound_class(self) -> str:
        d = self.dominant
        if d == "compute":
            return "compute-bound"
        if d == "memory":
            return "memory-bound"
        return f"{d}-bound"


def make_terms(*, scope: ScopeSpec, dtype: str, flops_dev: float,
               hbm_bytes_dev: float, vmem_bytes_dev: float = 0.0,
               host_bytes_dev: float = 0.0) -> RooflineTerms:
    return RooflineTerms(
        scope=scope.name, n_chips=scope.n_chips, dtype=dtype,
        flops_dev=flops_dev, hbm_bytes_dev=hbm_bytes_dev,
        vmem_bytes_dev=vmem_bytes_dev, host_bytes_dev=host_bytes_dev,
        chip=scope.chip)


@dataclasses.dataclass
class PhaseTraffic:
    """Per-level byte/FLOP accumulator for ONE serving phase (prefill /
    decode / swap) with the phase's measured (synchronized) wall time."""

    flops: float = 0.0
    vmem: float = 0.0
    hbm: float = 0.0
    host: float = 0.0
    wall_s: float = 0.0
    steps: int = 0
    tokens: int = 0

    def add(self, *, flops: float = 0.0, vmem: float = 0.0,
            hbm: float = 0.0, host: float = 0.0, wall_s: float = 0.0,
            steps: int = 1, tokens: int = 0) -> None:
        self.flops += flops
        self.vmem += vmem
        self.hbm += hbm
        self.host += host
        self.wall_s += wall_s
        self.steps += steps
        self.tokens += tokens
