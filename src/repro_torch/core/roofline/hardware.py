"""Hardware descriptions for roofline construction.

A chip carries a compute ceiling per dtype and a bandwidth (beta) per
memory level of the hierarchical roofline (arXiv 2009.05257), fastest
first:

    vmem (on-chip)  <->  hbm  <->  ici  <->  dcn  <->  host

The level names are the reference's.  On Hopper ``vmem`` is the on-chip
level (L2 and shared memory: what a cache-resident stream reaches),
``ici`` the card-to-card link (NVLink), ``dcn`` the network between
hosts and ``host`` the PCIe link to host memory (the swap path).
Scopes (:class:`ScopeSpec`) group cards into the paper's rungs: one
card, a tensor-parallel group (:func:`tp_scope`), a host, several hosts.

A beta of 0 means the level is not priced: the ledger still counts its
bytes, but no roof or time is derived from them until a measurement
supplies the beta.  On one card ``ici`` and ``dcn`` move no bytes:
unbound, never infinite.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

# every byte a serving phase moves is attributed to exactly one of these;
# a level that moves zero bytes is unbound (no roof, no time)
MEMORY_LEVELS = ("vmem", "hbm", "ici", "dcn", "host")


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak capabilities of one accelerator chip."""

    name: str
    peak_flops: float            # FLOP/s at the benchmark dtype
    peak_flops_by_dtype: Mapping[str, float]
    hbm_bw: float                # bytes/s
    hbm_bytes: int               # capacity, bytes
    vmem_bw: float = 0.0         # bytes/s on-chip (0 = not priced)
    host_bw: float = 0.0         # bytes/s on the host link (swap path)
    ici_bw: float = 0.0          # bytes/s card to card (0 = one card)
    dcn_bw: float = 0.0          # bytes/s host to host (0 = one host)

    def flops_for(self, dtype: str) -> float:
        return float(self.peak_flops_by_dtype.get(dtype, self.peak_flops))

    def level_bw(self, level: str) -> float:
        """Beta of one memory level (B/s); 0.0 = not priced."""
        if level not in MEMORY_LEVELS:
            raise ValueError(f"unknown memory level {level!r}")
        return float(getattr(self, "hbm_bw" if level == "hbm"
                             else f"{level}_bw"))


# NVIDIA H100 SXM5, data-sheet values (dense, no sparsity, at the 700 W
# power limit): 989 TFLOP/s bf16/fp16 on the tensor cores, 67 TFLOP/s
# float32 outside them (PyTorch's default float32 matmul), 1979 fp8/int8;
# 80 GB of HBM3 at 3.35 TB/s; PCIe Gen5 x16 at 64 GB/s each way to the
# host; NVLink 4 at 450 GB/s each way per card (900 GB/s both ways) for
# ``ici``, the card-to-card level of tensor parallelism; one 400 Gb/s
# NIC, 50 GB/s, for ``dcn`` (all data-sheet values, none measured here).
# The data sheet gives no on-chip bandwidth, so ``vmem`` stays unpriced.
# This is the analytic fallback: microbench.run_microbench measures the
# card in use, and MicrobenchResult.to_chipspec() gives a ChipSpec whose
# peaks and per-level betas come from those probes.
H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops=989e12,
    peak_flops_by_dtype={
        "bfloat16": 989e12,
        "float16": 989e12,
        "float32": 67e12,
        "float8_e4m3fn": 1979e12,
        "int8": 1979e12,
    },
    hbm_bw=3.35e12,
    hbm_bytes=80 * 10**9,
    host_bw=64e9,
    ici_bw=450e9,
    dcn_bw=50e9,
)


@dataclasses.dataclass(frozen=True)
class ScopeSpec:
    """A resource scope, the paper's thread / socket / two-socket rung:
    ``n_chips`` chips acting as one roofline platform, joined by
    ``interconnect`` ("none" | "ici" | "dcn").  ``interconnect_bw`` is
    aggregate: chips x the per-chip bandwidth of the weakest link class
    the scope crosses."""

    name: str
    chip: ChipSpec
    n_chips: int
    interconnect: str = "none"

    @property
    def peak_flops(self) -> float:
        return self.chip.peak_flops * self.n_chips

    def peak_flops_for(self, dtype: str) -> float:
        return self.chip.flops_for(dtype) * self.n_chips

    @property
    def hbm_bw(self) -> float:
        return self.chip.hbm_bw * self.n_chips

    @property
    def hbm_bytes(self) -> int:
        return self.chip.hbm_bytes * self.n_chips

    @property
    def interconnect_bw(self) -> float:
        if self.interconnect == "none":
            return float("inf")
        if self.interconnect == "ici":
            return self.chip.ici_bw * self.n_chips
        if self.interconnect == "dcn":
            return self.chip.dcn_bw * self.n_chips
        raise ValueError(f"unknown interconnect {self.interconnect!r}")

    def per_chip_link_bw(self, kind: str) -> float:
        return self.chip.ici_bw if kind == "ici" else self.chip.dcn_bw


def chip_scope(chip: ChipSpec = H100_SXM) -> ScopeSpec:
    """Single chip, the paper's single-thread rung."""
    return ScopeSpec("chip", chip, 1, "none")


def tp_scope(chip: ChipSpec = H100_SXM, n_chips: int = 1) -> ScopeSpec:
    """Tensor-parallel serving: ``n_chips`` cards joined card to card
    acting as one decode platform (weights and KV sharded, activations
    all-reduced every block).  The paper's NUMA analogue: per-card HBM is
    the local roof, the card-to-card link the remote one
    (RooflineTerms.binding_roof)."""
    if n_chips <= 1:
        return chip_scope(chip)
    return ScopeSpec(f"tp{n_chips}", chip, n_chips, "ici")


def pod_scope(chip: ChipSpec = H100_SXM, n_chips: int = 8) -> ScopeSpec:
    """The cards of one host joined card to card, the paper's
    single-socket rung."""
    return ScopeSpec("pod", chip, n_chips, "ici")


def multipod_scope(chip: ChipSpec = H100_SXM, n_pods: int = 2,
                   chips_per_pod: int = 8) -> ScopeSpec:
    """Hosts joined by the network, the paper's two-socket rung."""
    return ScopeSpec("multipod", chip, n_pods * chips_per_pod, "dcn")


def scope_for_mesh(mesh_shape: Mapping[str, int],
                   chip: ChipSpec = H100_SXM) -> ScopeSpec:
    """The scope of a mesh's axis sizes: a ``pod`` axis crosses hosts."""
    n = 1
    for v in mesh_shape.values():
        n *= int(v)
    if mesh_shape.get("pod", 1) > 1:
        return ScopeSpec("multipod", chip, n, "dcn")
    if n == 1:
        return chip_scope(chip)
    return ScopeSpec("pod", chip, n, "ici")
