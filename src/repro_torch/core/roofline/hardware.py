"""Hardware descriptions for roofline construction.

A chip carries a compute ceiling per dtype and a bandwidth (beta) per
memory level of the hierarchy

    vmem (on-chip)  <->  hbm  <->  host

``vmem`` keeps the reference's name for the on-chip level; on Hopper it
is shared memory and registers.  A beta of 0 means the level is not
priced: the ledger still counts its bytes, but no roof or time is derived
from them until a measurement supplies the beta.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

MEMORY_LEVELS = ("vmem", "hbm", "host")


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
# host.  This is the analytic fallback: microbench.run_microbench measures
# the card in use, and MicrobenchResult.to_chipspec() gives a ChipSpec
# whose per-dtype peaks and HBM beta come from those probes.
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
