"""Roofline terms for the serve ledger, with an H100 chip spec: the
hierarchical, time-based model (``model``), the card's measured roofline
(``microbench``) and its tables and ASCII plot (``report``)."""

from .hardware import H100_SXM, MEMORY_LEVELS, ChipSpec, ScopeSpec, chip_scope
from .model import (LevelBetas, PhaseTraffic, RooflineTerms,
                    attribution_residual, make_terms, overlapped_budget,
                    time_attribution)

__all__ = ["H100_SXM", "MEMORY_LEVELS", "ChipSpec", "ScopeSpec", "chip_scope",
           "LevelBetas", "PhaseTraffic", "RooflineTerms", "make_terms",
           "time_attribution", "overlapped_budget", "attribution_residual"]
