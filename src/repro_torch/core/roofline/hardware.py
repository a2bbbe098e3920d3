"""Hardware descriptions for roofline construction.

A chip carries a compute ceiling per dtype and a bandwidth (beta) per
memory level of the hierarchical roofline (arXiv 2009.05257), fastest
first:

    vmem (on-chip)  <->  hbm  <->  ici  <->  dcn  <->  host

The level names are the reference's.  On Hopper ``vmem`` is the on-chip
level (L2 and shared memory: what a cache-resident stream reaches),
``ici`` the card-to-card link (NVLink), ``dcn`` the network between
hosts and ``host`` the PCIe link to host memory (the swap path).

A beta of 0 means the level is not priced: the ledger still counts its
bytes, but no roof or time is derived from them until a measurement
supplies the beta.  On one card ``ici`` and ``dcn`` move no bytes and
carry beta 0: unbound, never infinite.
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
# host.  The data sheet gives no on-chip bandwidth, so ``vmem`` stays
# unpriced here, and one card has no ``ici`` or ``dcn`` traffic.  This is
# the analytic fallback: microbench.run_microbench measures the card in
# use, and MicrobenchResult.to_chipspec() gives a ChipSpec whose peaks and
# per-level betas come from those probes.
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
)


@dataclasses.dataclass(frozen=True)
class ScopeSpec:
    """``n_chips`` chips acting as one roofline platform."""

    name: str
    chip: ChipSpec
    n_chips: int


def chip_scope(chip: ChipSpec = H100_SXM) -> ScopeSpec:
    """Single chip (multi-chip scopes arrive with tensor parallelism,
    ROADMAP queue 1 item 11)."""
    return ScopeSpec("chip", chip, 1)
