"""Roofline math for the serve ledger (paper eq. 1: ``P = min(pi,
I * beta)`` with arithmetic intensity ``I = W / Q``).

Each memory level contributes a time term ``bytes / beta`` and the
compute term is ``flops / pi``; the dominant term is the bottleneck,
``t_lower = max(terms)`` the step under perfect overlap and ``t_upper =
sum(terms)`` with none.  The roofline fraction is the share of the bound
step that is irreducible model math at peak.

Hierarchical extension (arXiv 2009.05257): the terms carry bytes for every
level of ``vmem <-> hbm <-> ici <-> dcn <-> host``, so one step exposes a
roof per level (``roofs()``) and the lowest binds (``binding_roof``).  A
level that moves zero bytes is *unbound*: no roof, no time.  A level whose
beta is 0 (not priced, e.g. the data sheet's on-chip level) contributes
neither a roof nor a time term, whatever its bytes.

Time-based extension (arXiv 2009.04598): :class:`PhaseTraffic`
accumulates one serving phase's per-level bytes with its measured wall
time, and :func:`time_attribution` decomposes that wall into ``bytes /
beta`` terms plus ``flops / pi`` plus the per-step dispatch floor;
:func:`attribution_residual` is what the budget leaves unexplained.

Overlap extension: with per-level overlap fractions ``ov`` (the share of
a level's transfer time hidden behind compute) the bound is ``dispatch +
max(t_compute, max_l ov_l t_l) + sum_l (1 - ov_l) t_l``
(:func:`overlapped_budget`, :attr:`RooflineTerms.t_overlapped`).

KV-migration bytes (the multi-replica tier, serve/cluster.py) sit inside
their carrying link's wire total and in ``migration_bytes_dev``, which
``roofs()`` prices as a ``migration`` roof of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .hardware import ChipSpec, MEMORY_LEVELS, ScopeSpec


def _safe_time(nbytes: float, bw: float) -> float:
    """bytes / beta with the unbound and unpriced conventions: zero bytes
    or a zero beta cost zero seconds (never inf or NaN)."""
    if nbytes <= 0 or bw <= 0:
        return 0.0
    return nbytes / bw


@dataclasses.dataclass
class RooflineTerms:
    scope: str
    n_chips: int
    dtype: str

    # per-device quantities
    flops_dev: float
    hbm_bytes_dev: float
    ici_wire_bytes_dev: float = 0.0
    dcn_wire_bytes_dev: float = 0.0
    transcendentals_dev: float = 0.0

    # hierarchical levels bracketing HBM (0.0 = not tracked -> unbound):
    # vmem = on-chip traffic of the step's kernels, host = swap copies
    vmem_bytes_dev: float = 0.0
    host_bytes_dev: float = 0.0

    # cross-replica KV migration bytes, also inside the carrying link's
    # wire total; roofs() prices them as a roof of their own
    migration_bytes_dev: float = 0.0
    migration_link: str = "dcn"

    # model-level accounting
    model_flops_total: Optional[float] = None

    # hardware
    chip: Optional[ChipSpec] = None

    # per-level overlap fraction (keys from MEMORY_LEVELS; missing = 0.0):
    # the share of that level's transfer time hidden behind compute
    overlap: Dict[str, float] = dataclasses.field(default_factory=dict)

    # --- derived terms (seconds) -----------------------------------------
    @property
    def compute_s(self) -> float:
        return self.flops_dev / self.chip.flops_for(self.dtype)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_dev / self.chip.hbm_bw

    @property
    def ici_s(self) -> float:
        return _safe_time(self.ici_wire_bytes_dev, self.chip.ici_bw)

    @property
    def dcn_s(self) -> float:
        return _safe_time(self.dcn_wire_bytes_dev, self.chip.dcn_bw)

    @property
    def collective_s(self) -> float:
        return self.ici_s + self.dcn_s

    @property
    def vmem_s(self) -> float:
        return _safe_time(self.vmem_bytes_dev, self.chip.level_bw("vmem"))

    @property
    def host_s(self) -> float:
        return _safe_time(self.host_bytes_dev, self.chip.level_bw("host"))

    @property
    def migration_s(self) -> float:
        """Wire time of the migration share, at the carrying link's beta
        (an attribution view: the bytes already sit in that link's
        total)."""
        return _safe_time(self.migration_bytes_dev,
                          self.chip.level_bw(self.migration_link))

    def level_bytes(self, level: str) -> float:
        """Per-device bytes this step moved on one memory level."""
        return {"vmem": self.vmem_bytes_dev, "hbm": self.hbm_bytes_dev,
                "ici": self.ici_wire_bytes_dev,
                "dcn": self.dcn_wire_bytes_dev,
                "host": self.host_bytes_dev}[level]

    def terms(self) -> Dict[str, float]:
        """Seconds per priced resource: ``compute``, ``memory`` (HBM) and
        each other level with bytes and a known beta."""
        out = {"compute": self.compute_s, "memory": self.memory_s}
        for level in ("ici", "dcn", "vmem", "host"):
            b, bw = self.level_bytes(level), self.chip.level_bw(level)
            if b > 0 and bw > 0:
                out[level] = b / bw
        return out

    @property
    def dominant(self) -> str:
        t = self.terms()
        return max(t, key=t.get)

    @property
    def t_lower(self) -> float:
        """Step time with perfect overlap of compute and every level."""
        return max(self.terms().values())

    @property
    def t_upper(self) -> float:
        """Step time with zero overlap."""
        return sum(self.terms().values())

    def level_times(self) -> Dict[str, float]:
        """Seconds per memory level (keys = MEMORY_LEVELS, ``hbm`` for
        the ``memory`` term; 0.0 for unbound or unpriced levels)."""
        t = self.terms()
        return {level: t.get("memory" if level == "hbm" else level, 0.0)
                for level in MEMORY_LEVELS}

    @property
    def t_overlapped(self) -> float:
        """Step time under the per-level overlap fractions:
        ``max(t_compute, max_l ov_l t_l) + sum_l (1 - ov_l) t_l`` (t_upper
        at all 0, t_lower at all 1 when a level dominates compute)."""
        hidden, serial = 0.0, 0.0
        for level, t in self.level_times().items():
            ov = min(max(float(self.overlap.get(level, 0.0)), 0.0), 1.0)
            hidden = max(hidden, ov * t)
            serial += (1.0 - ov) * t
        return max(self.compute_s, hidden) + serial

    # --- classic roofline quantities --------------------------------------
    @property
    def arithmetic_intensity(self) -> float:
        """FLOP per HBM byte (the paper's I = W/Q)."""
        return self.flops_dev / max(self.hbm_bytes_dev, 1.0)

    @property
    def ridge_intensity(self) -> float:
        """Intensity at the roofline's ridge for this chip and dtype."""
        return self.chip.flops_for(self.dtype) / self.chip.hbm_bw

    @property
    def attainable_flops(self) -> float:
        """P = min(pi, I * beta) per chip (the classic two-term roof)."""
        return min(self.chip.flops_for(self.dtype),
                   self.arithmetic_intensity * self.chip.hbm_bw)

    # --- per-level roofs ---------------------------------------------------
    @property
    def ici_intensity(self) -> float:
        """FLOP per card-to-card wire byte (inf when none moves)."""
        return self.level_intensity("ici")

    @property
    def dcn_intensity(self) -> float:
        """FLOP per host-to-host wire byte (inf when none moves)."""
        return self.level_intensity("dcn")

    def level_intensity(self, level: str) -> float:
        """FLOP per byte moved on one memory level; inf when the step
        moves no bytes there (the roof is absent)."""
        b = self.level_bytes(level)
        if b <= 0:
            return float("inf")
        return self.flops_dev / b

    def level_roof(self, level: str) -> Optional[float]:
        """The FLOP/s ceiling one level imposes, or None when it is
        unbound (zero bytes) or unpriced (no beta)."""
        b, bw = self.level_bytes(level), self.chip.level_bw(level)
        if b <= 0 or bw <= 0:
            return None
        return self.flops_dev / b * bw

    def roofs(self) -> Dict[str, float]:
        """Per-chip attainable-performance ceilings: ``compute`` = pi,
        ``hbm`` = I * beta_hbm, and for every other level that moved bytes
        and has a beta, I_level * beta_level; migration bytes get a
        ``migration`` roof of their own at their link's beta.  The lowest
        binds.  Unbound and unpriced levels are omitted, so no ceiling is
        inf or NaN."""
        out = {"compute": self.chip.flops_for(self.dtype),
               "hbm": self.arithmetic_intensity * self.chip.hbm_bw}
        for level in ("vmem", "ici", "dcn", "host"):
            b, bw = self.level_bytes(level), self.chip.level_bw(level)
            if level == self.migration_link:
                b -= self.migration_bytes_dev
            if b > 0 and bw > 0:
                out[level] = self.flops_dev / b * bw
        if self.migration_bytes_dev > 0:
            bw = self.chip.level_bw(self.migration_link)
            if bw > 0:
                out["migration"] = (self.flops_dev
                                    / self.migration_bytes_dev * bw)
        return out

    @property
    def attainable_flops_comm(self) -> float:
        """P = min over every roof: the hierarchy-aware attainable
        performance per chip."""
        return min(self.roofs().values())

    @property
    def binding_roof(self) -> str:
        """Name of the ceiling that binds:
        compute | hbm | vmem | ici | dcn | host | migration."""
        r = self.roofs()
        return min(r, key=r.get)

    # --- usefulness / score ------------------------------------------------
    @property
    def model_flops_dev(self) -> Optional[float]:
        if self.model_flops_total is None:
            return None
        return self.model_flops_total / self.n_chips

    @property
    def useful_ratio(self) -> Optional[float]:
        """Model FLOPs / counted FLOPs (1.0 = no redundant compute)."""
        if self.model_flops_total is None or self.flops_dev == 0:
            return None
        return self.model_flops_dev / self.flops_dev

    @property
    def roofline_fraction(self) -> Optional[float]:
        """Useful compute time at peak / bound step time."""
        if self.model_flops_total is None:
            return None
        useful_s = self.model_flops_dev / self.chip.flops_for(self.dtype)
        return useful_s / max(self.t_lower, 1e-30)

    @property
    def hardware_fraction(self) -> float:
        """Compute term / bound time: the busy share of the math units
        (an upper bound on model FLOP utilisation)."""
        return self.compute_s / max(self.t_lower, 1e-30)

    def bound_class(self) -> str:
        d = self.dominant
        if d == "compute":
            return "compute-bound"
        if d == "memory":
            return "memory-bound"
        if d in ("vmem", "host"):
            return f"{d}-bound"
        return f"collective-bound({d})"


def make_terms(*, scope: ScopeSpec, dtype: str, flops_dev: float,
               hbm_bytes_dev: float, ici_wire_bytes_dev: float = 0.0,
               dcn_wire_bytes_dev: float = 0.0,
               transcendentals_dev: float = 0.0,
               model_flops_total: Optional[float] = None,
               vmem_bytes_dev: float = 0.0, host_bytes_dev: float = 0.0,
               migration_bytes_dev: float = 0.0,
               migration_link: str = "dcn",
               overlap: Optional[Dict[str, float]] = None) -> RooflineTerms:
    return RooflineTerms(
        scope=scope.name, n_chips=scope.n_chips, dtype=dtype,
        flops_dev=flops_dev, hbm_bytes_dev=hbm_bytes_dev,
        ici_wire_bytes_dev=ici_wire_bytes_dev,
        dcn_wire_bytes_dev=dcn_wire_bytes_dev,
        transcendentals_dev=transcendentals_dev,
        model_flops_total=model_flops_total,
        vmem_bytes_dev=vmem_bytes_dev, host_bytes_dev=host_bytes_dev,
        migration_bytes_dev=migration_bytes_dev,
        migration_link=migration_link, chip=scope.chip,
        overlap=dict(overlap or {}))


# --------------------------------------------------------------------------
# Time-based roofline (arXiv 2009.04598): per-phase, per-level wall budget
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PhaseTraffic:
    """Per-level byte/FLOP accumulator for ONE serving phase (prefill /
    decode / verify / draft / swap) with the phase's measured
    (synchronized) wall time."""

    flops: float = 0.0
    vmem: float = 0.0
    hbm: float = 0.0
    ici: float = 0.0
    dcn: float = 0.0
    host: float = 0.0
    wall_s: float = 0.0          # measured (synchronized) device window
    steps: int = 0               # device steps in this phase
    tokens: int = 0              # tokens the phase committed or processed

    def add(self, *, flops: float = 0.0, vmem: float = 0.0,
            hbm: float = 0.0, ici: float = 0.0, dcn: float = 0.0,
            host: float = 0.0, wall_s: float = 0.0, steps: int = 1,
            tokens: int = 0) -> None:
        self.flops += flops
        self.vmem += vmem
        self.hbm += hbm
        self.ici += ici
        self.dcn += dcn
        self.host += host
        self.wall_s += wall_s
        self.steps += steps
        self.tokens += tokens

    def bytes_for(self, level: str) -> float:
        if level not in MEMORY_LEVELS:
            raise ValueError(f"unknown memory level {level!r}")
        return getattr(self, level)


@dataclasses.dataclass(frozen=True)
class LevelBetas:
    """The compute peak and one beta per memory level: the denominators of
    a time-based roofline.  ``source`` records whether they came from the
    card's microbenchmarks ("measured") or the data sheet ("analytic")."""

    pi: float                    # FLOP/s
    vmem: float                  # B/s; 0 = not priced
    hbm: float
    ici: float
    dcn: float
    host: float
    source: str = "analytic"

    @classmethod
    def from_chip(cls, chip: ChipSpec, dtype: Optional[str] = None,
                  source: str = "analytic") -> "LevelBetas":
        return cls(pi=chip.flops_for(dtype) if dtype else chip.peak_flops,
                   vmem=chip.level_bw("vmem"), hbm=chip.hbm_bw,
                   ici=chip.ici_bw, dcn=chip.dcn_bw,
                   host=chip.level_bw("host"), source=source)

    def beta(self, level: str) -> float:
        if level not in MEMORY_LEVELS:
            raise ValueError(f"unknown memory level {level!r}")
        return float(getattr(self, level))


def time_attribution(phase: PhaseTraffic, betas: LevelBetas,
                     dispatch_s_per_step: float = 0.0) -> Dict[str, float]:
    """One phase as the additive no-overlap budget: ``compute`` =
    flops / pi, one ``bytes / beta`` term per memory level, and
    ``dispatch`` = steps x the measured per-step launch floor (the paper's
    section 2.4 no-kernel subtraction).  Unbound and unpriced levels
    contribute 0.0."""
    out = {"compute": _safe_time(phase.flops, betas.pi)}
    for level in MEMORY_LEVELS:
        out[level] = _safe_time(phase.bytes_for(level), betas.beta(level))
    out["dispatch"] = dispatch_s_per_step * phase.steps
    return out


def overlapped_budget(times: Dict[str, float],
                      overlap: Optional[Dict[str, float]] = None) -> float:
    """The overlapped bound over a :func:`time_attribution` dict:

        dispatch + max(compute, max_l ov_l * t_l) + sum_l (1 - ov_l) * t_l

    ``overlap`` maps levels to the share of their transfer time hidden
    behind compute (missing = 0.0: the serial sum), clamped into [0, 1].
    Dispatch never overlaps."""
    overlap = overlap or {}
    hidden, serial = 0.0, 0.0
    for level in MEMORY_LEVELS:
        t = times.get(level, 0.0)
        ov = min(max(float(overlap.get(level, 0.0)), 0.0), 1.0)
        hidden = max(hidden, ov * t)
        serial += (1.0 - ov) * t
    return (times.get("dispatch", 0.0)
            + max(times.get("compute", 0.0), hidden) + serial)


def attribution_residual(phase: PhaseTraffic, betas: LevelBetas,
                         dispatch_s_per_step: float = 0.0) -> float:
    """Signed share of the phase's measured wall the budget does not
    explain, (wall - sum(times)) / wall: positive = unattributed time,
    negative = the serial sum exceeds the wall (levels overlapped)."""
    if phase.wall_s <= 0:
        return float("nan")
    budget = sum(time_attribution(phase, betas, dispatch_s_per_step)
                 .values())
    return (phase.wall_s - budget) / phase.wall_s
