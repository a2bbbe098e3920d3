"""The HBM-capacity axis of the serving roofline: the JAX package's
``serve/crosscheck.py::capacity_report`` for one engine, in PyTorch.

Decode is memory-bound, and the card's memory also caps how many
requests decode at once: every live request holds ``pages_per_request``
pages of ``page_bytes`` each beside the weights.  :func:`capacity_report`
reads an engine's live block pool and says where the engine stands on
that axis: pages in use and at peak, what prefix sharing deduplicated and
copy-on-write copied, evictions and preemptions, and the batch the card's
memory would hold at this ``max_len`` against the batch decoding now.

Not ported yet: the fleet report over a multi-replica cluster
(``_cluster_capacity_report``, ROADMAP queue 1 item 12) and the ledger /
HLO cross-checks of the decode and verify steps (``crosscheck_decode``,
``crosscheck_verify`` and their helpers, ROADMAP queue 1 item 10).
"""

from __future__ import annotations

from typing import Dict

from ..models.common import param_counts
from ..models.params import torch_dtype


def capacity_report(engine) -> Dict:
    """Page economics of ``engine``'s live block pool, with the reference's
    keys and meanings.  ``capacity_max_batch`` is the concurrency ceiling
    the chip's memory (``EngineConfig.chip.hbm_bytes``) implies at this
    engine's ``max_len``:

        B_max = (HBM - params_bytes) / (pages_per_request * page_bytes)

    ``effective_batch`` (requests holding a slot now) against it says
    whether the deployment is slot-limited or capacity-limited; every
    deduplicated or on-demand-deferred page moves B_max's denominator."""
    if engine._kv is None:
        raise ValueError("engine has no live pool; submit work or reset()")
    kv, cfg, chip = engine._kv, engine.cfg, engine.ecfg.chip
    pool = kv.pool
    pb = kv.page_bytes
    pages_per_req = kv.pages_needed(kv.max_len)
    params_b = (param_counts(cfg)["total"]
                * torch_dtype(cfg.dtype).itemsize)
    hbm_for_kv = max(chip.hbm_bytes - params_b, 0.0)
    cap_batch = int(hbm_for_kv // max(pages_per_req * pb, 1))
    active = list(engine._sched.active.values()) if engine._sched else []
    return {
        "page_bytes": pb,
        "pages_total": kv.num_pages - 1,            # minus the trash page
        "pages_in_use": pool.pages_in_use,
        "pages_peak": pool.stats.peak_in_use,
        "pages_cached": pool.pages_cached,
        "pages_deduped": pool.stats.dedup_hits,
        "cow_copies": pool.stats.cow_copies,
        "evictions": pool.stats.evictions,
        "preemptions": engine._sched.preempt_count if engine._sched else 0,
        "pool_bytes": pb * (kv.num_pages - 1),
        "params_bytes": float(params_b),
        "pages_per_request": pages_per_req,
        "effective_batch": len(active),
        "capacity_max_batch": cap_batch,
    }
