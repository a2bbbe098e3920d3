"""Multi-replica serving cluster: dp independent engines on the data axis.

Serving many users is not one bigger engine but N copies of the same
engine, each with its own page pool, scheduler and roofline ledger,
behind a front door that moves *requests* between them, never
activations.  This module owns the replica fleet; serve/router.py owns
the front door (admission, ledger-predicted load balancing, KV-page
migration).

Replica placement
-----------------
Each replica gets its own device row (parallel/mesh.py
``dp_submeshes``): a tp = 1 replica pins its weights and pool to its
row's card and is the parent ``Engine`` byte for byte.  When the host
has fewer devices than ``dp * tp`` (the CPU, or one card) and tp = 1,
the fleet *colocates*: every replica runs on ``EngineConfig.device``,
each with its own pool and scheduler, and all of them read one copy of
the weights.  The scheduling, migration and ledger arithmetic are the
same; only the physical parallelism is simulated (one card steps the
replicas in turn).  A tp > 1 replica needs tp ranks of its own under
the port's explicit SPMD and is refused (serve/shard.py; ROADMAP queue
1 item 18).

Roles (disaggregated prefill / decode)
--------------------------------------
:class:`RoleConfig` gives each replica ``"mixed"`` (default),
``"prefill"`` or ``"decode"``.  A prefill replica admits, prefills and
commits the first token; the router then migrates the request, its pages
packed into one :class:`~repro_torch.serve.kv_cache.SwapSnapshot` in
pinned host memory (``kv_cache.swap_out``), to a decode replica, where
``swap_in`` restores the pages (aliasing prefix pages that pool's index
already holds).  The packed bytes are charged to the migration ledger
as wire traffic on ``link`` ("dcn" across replica groups, "ici" inside
a node), so the roofline can name "migration" as the binding term when
moving KV outweighs decoding it (``RooflineTerms.roofs``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..device import resolve_device
from ..models.common import ModelConfig
from ..models.model import prepare_params
from ..obs import Telemetry
from ..parallel.mesh import dp_submeshes, host_devices
from .engine import EngineConfig
from .scheduler import RooflineLedger
from .shard import make_engine
from .spec import SpecConfig

ROLES = ("mixed", "prefill", "decode")


@dataclasses.dataclass(frozen=True)
class RoleConfig:
    """Per-replica roles plus the migration wire level.

    ``roles[i]`` is replica i's job: ``"mixed"`` serves a request end to
    end, ``"prefill"`` hands every request off after its first token,
    ``"decode"`` only receives migrated (or rescued) requests.  ``link``
    names the wire the packed snapshots ride and prices the migration
    roofline term: "dcn" between nodes, "ici" inside one."""

    roles: Tuple[str, ...]
    link: str = "dcn"

    def __post_init__(self):
        bad = [r for r in self.roles if r not in ROLES]
        if bad:
            raise ValueError(f"unknown roles {bad}; pick from {ROLES}")
        if self.link not in ("dcn", "ici"):
            raise ValueError(f"migration link {self.link!r}: 'dcn'|'ici'")
        if not any(r in ("mixed", "prefill") for r in self.roles):
            raise ValueError("no prefill-capable replica: every request "
                             "needs a 'mixed' or 'prefill' home")
        if ("prefill" in self.roles
                and not any(r in ("mixed", "decode") for r in self.roles)):
            raise ValueError("prefill-only replicas need a 'decode' (or "
                             "'mixed') replica to migrate into")

    @classmethod
    def mixed(cls, n: int, link: str = "dcn") -> "RoleConfig":
        return cls(("mixed",) * n, link=link)

    @classmethod
    def disaggregated(cls, n_prefill: int, n_decode: int,
                      link: str = "dcn") -> "RoleConfig":
        return cls(("prefill",) * n_prefill + ("decode",) * n_decode,
                   link=link)

    @property
    def disaggregates(self) -> bool:
        return "prefill" in self.roles or "decode" in self.roles


class Cluster:
    """``dp`` replica engines over the data axis, one pool each::

        cl = Cluster(cfg, params, ecfg, mesh_shape=(2, 1),
                     roles=RoleConfig.disaggregated(1, 1))
        router = Router(cl)                      # serve/router.py
        router.submit(prompt_ids, gen); done = router.run()

    The cluster builds and owns the replicas (placement, the role table,
    the fleet's ledger) and leaves every scheduling decision to the
    Router.  ``colocate`` None decides from the host's devices of
    ``EngineConfig.device``'s type."""

    def __init__(self, cfg: ModelConfig, params,
                 ecfg: Optional[EngineConfig] = None,
                 scfg: Optional[SpecConfig] = None,
                 mesh_shape: Tuple[int, int] = (2, 1),
                 roles: Optional[RoleConfig] = None,
                 colocate: Optional[bool] = None):
        dp, tp = int(mesh_shape[0]), int(mesh_shape[1])
        if dp < 1 or tp < 1:
            raise ValueError(f"mesh {mesh_shape}: axes must be >= 1")
        roles = roles or RoleConfig.mixed(dp)
        if len(roles.roles) != dp:
            raise ValueError(f"RoleConfig names {len(roles.roles)} "
                             f"replicas for a dp={dp} mesh")
        self.cfg, self.ecfg = cfg, ecfg or EngineConfig()
        self.roles = roles
        self.dp, self.tp = dp, tp
        kind = resolve_device(self.ecfg.device).type
        n_dev = len(host_devices(kind))
        if colocate is None:
            colocate = n_dev < dp * tp
        if colocate and tp > 1:
            raise ValueError(f"cannot colocate tp={tp} replicas: each "
                             f"needs {tp} real devices ({n_dev} present)")
        self.colocated = bool(colocate)
        if self.colocated:
            # one copy of the weights, read by every replica
            params = prepare_params(params, cfg)
            rows: List = [None] * dp
            shapes = [(1, 1)] * dp
        else:
            rows = dp_submeshes(dp, tp, kind)
            shapes = [(dp, tp)] * dp
        self.replicas = [
            make_engine(cfg, params, self.ecfg, scfg, mesh_shape=shapes[i],
                        submesh=rows[i], replica_id=i)
            for i in range(dp)]
        # one telemetry bundle for the fleet in place of the replicas' own:
        # one timeline (pid = replica index) and one registry, so
        # migrations draw flow arrows between replica processes
        self.obs: Optional[Telemetry] = None
        if self.ecfg.telemetry:
            self.obs = Telemetry(window_steps=self.ecfg.telemetry_window)
            for i, eng in enumerate(self.replicas):
                eng.attach_telemetry(
                    self.obs, pid=i,
                    name=(f"replica {i} [{self.roles.roles[i]}] "
                          f"{cfg.name} tp={tp}"))

    # -- role queries ------------------------------------------------------

    def role(self, i: int) -> str:
        return self.roles.roles[i]

    def prefill_capable(self) -> List[int]:
        """Replicas that may receive fresh requests."""
        return [i for i, r in enumerate(self.roles.roles)
                if r in ("mixed", "prefill")]

    def decode_capable(self) -> List[int]:
        """Migration destinations: the decode-only replicas when there
        are any (the disaggregation point), else the mixed ones."""
        dec = [i for i, r in enumerate(self.roles.roles) if r == "decode"]
        if dec:
            return dec
        return [i for i, r in enumerate(self.roles.roles) if r == "mixed"]

    # -- fleet state -------------------------------------------------------

    def has_work(self) -> bool:
        return any(eng._sched is not None and eng._sched.has_work()
                   for eng in self.replicas)

    def aggregate_ledger(self) -> RooflineLedger:
        """One ledger over every request the fleet has seen; its terms()
        put the migration bytes on the RoleConfig link."""
        agg = RooflineLedger(migration_link=self.roles.link)
        for eng in self.replicas:
            agg.add(eng.aggregate_ledger())
        return agg

    def roofline_terms(self):
        """The fleet's aggregate decode RooflineTerms on ``ecfg.chip``, at
        one replica's scope (each replica is an independent step; the
        migration bytes ride the RoleConfig link)."""
        return self.aggregate_ledger().terms(self.cfg, self.ecfg.chip,
                                             n_chips=max(self.tp, 1))


__all__ = ["ROLES", "Cluster", "RoleConfig"]
