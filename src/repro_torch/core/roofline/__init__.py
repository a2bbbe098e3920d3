"""Roofline terms for the serve ledger (the part of the reference's
``core/roofline`` the scheduler uses), with an H100 chip spec; the
card's measured roofline (``microbench``) and its ASCII report
(``report``)."""

from .hardware import H100_SXM, MEMORY_LEVELS, ChipSpec, ScopeSpec, chip_scope
from .model import LevelBetas, PhaseTraffic, RooflineTerms, make_terms

__all__ = ["H100_SXM", "MEMORY_LEVELS", "ChipSpec", "ScopeSpec", "chip_scope",
           "LevelBetas", "PhaseTraffic", "RooflineTerms", "make_terms"]
