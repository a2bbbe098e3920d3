"""Ledger-routed front door over a replica :class:`~repro_torch.serve.cluster.Cluster`.

Every placement decision is priced with the same analytic terms the
per-request ledger reports (core/roofline): a request's predicted cost is
its prefill compute time plus its decode memory time on the target chip
(prefill on the compute roof, ``flops / pi``; decode on the HBM roof,
``bytes / beta``), and dispatch sends it to the prefill-capable replica
carrying the least predicted outstanding seconds.  The model is the
load estimate; no measured feedback loop.

A request's life under disaggregation::

    submit -> router queue -> dispatch (Engine.enqueue on a prefill replica)
           -> prefill and first token(s) on the prefill replica
           -> export_request: pages packed into ONE SwapSnapshot, one
              device -> pinned host copy
           -> import_request on a decode replica; its next step restores
              the pages (one host -> device copy per leaf), aliasing
              prefix pages its index already holds, and decode goes on
           -> finished, streamed

The snapshot's bytes are charged to the migration ledger as wire traffic
on the RoleConfig link ("dcn" / "ici"), so the fleet's RooflineTerms can
name "migration" as the binding roof.  A mixed cluster never migrates on
the happy path; it still *rescues*: a request preempted on a full
replica whose own pool cannot resume it moves mid-decode to a replica
that can.

The first tokens: the prefill replica commits token 1 (from the prefill
logits) and, as the export follows a whole engine step, token 2 (the
same step runs one packed decode).  Migration happens between commits,
and sampling is request-level (``sampling.row_generator(seed, step)``
with step = tokens generated), so a stream is the one a single engine
gives wherever the cut lands.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.roofline.hardware import chip_scope
from ..core.roofline.model import make_terms
from ..models.common import model_flops
from ..obs.clock import now
from ..obs.trace import ROUTER_PID
from .cluster import Cluster
from .engine import GenerateConfig
from .scheduler import Request, RequestState, decode_token_bytes


class Router:
    """Admission control, ledger-predicted load balancing and migration.

    ``admit_depth`` bounds each replica's *waiting* queue (requests the
    replica has not placed yet); the router holds the rest in its own
    queue, the boundary the TTFT queue-wait segment measures
    (``Request.ttft_breakdown``).  Default: the replica's slot count, one
    queued wave behind the running one."""

    def __init__(self, cluster: Cluster, admit_depth: Optional[int] = None):
        self.cluster = cluster
        self.admit_depth = (admit_depth if admit_depth is not None
                            else max(cluster.ecfg.num_slots, 1))
        if self.admit_depth < 1:
            raise ValueError("admit_depth must be >= 1")
        self._next_id = 0
        self.queue: collections.deque = collections.deque()
        self.requests: Dict[int, Request] = {}
        self.finished: List[Request] = []
        self.home: Dict[int, int] = {}           # request_id -> replica
        self.migrations = 0
        self.migration_bytes = 0.0
        self._cost: Dict[int, Dict[str, float]] = {}
        self._charged: Dict[int, Tuple[int, float]] = {}
        self._load = [0.0] * cluster.dp
        self._streamed: Dict[int, int] = {}      # request_id -> tokens sent
        # the cluster's shared telemetry (None = off); the front door
        # traces as a process of its own
        self.obs = cluster.obs
        if self.obs is not None:
            self.obs.tracer.process(ROUTER_PID, "router front door")
            self.obs.tracer.thread(ROUTER_PID, 0, "dispatch")

    # -- front door --------------------------------------------------------

    def submit(self, prompt, gen: GenerateConfig,
               seed: Optional[int] = None) -> Request:
        """Accept a request into the router queue (never straight into a
        replica): ids are cluster-unique, and the submit stamp starts the
        TTFT clock here.  ``seed`` names its sampling stream, as in
        ``Engine.submit``; without one it decodes greedily."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        req = Request(prompt=prompt, max_new_tokens=gen.max_new_tokens,
                      temperature=gen.temperature, top_k=gen.top_k,
                      top_p=gen.top_p, stop_token=gen.stop_token, seed=seed,
                      request_id=self._next_id, submit_time=now())
        self._next_id += 1
        self.queue.append(req)
        self.requests[req.request_id] = req
        if self.obs is not None:
            self.obs.tracer.instant("submit", ROUTER_PID, 0,
                                    req.submit_time,
                                    request=req.request_id)
        return req

    def predicted_cost(self, req: Request) -> Dict[str, float]:
        """A request priced with the ledger's own roofline terms before it
        runs: prefill seconds off the compute roof, decode seconds off the
        HBM roof (per-token bytes at full slot occupancy, the steady state
        the balancer packs toward, times the token budget).  Split so a
        migration can re-home the decode share without re-pricing."""
        cfg, ecfg = self.cluster.cfg, self.cluster.ecfg
        t = make_terms(
            scope=chip_scope(ecfg.chip), dtype=cfg.dtype,
            flops_dev=model_flops(cfg, req.prompt_len, 1, "prefill"),
            hbm_bytes_dev=(decode_token_bytes(cfg, req.prompt_len,
                                              ecfg.num_slots)
                           * max(req.max_new_tokens, 1)))
        return {"prefill_s": t.compute_s, "decode_s": t.memory_s,
                "total_s": t.compute_s + t.memory_s}

    # -- load bookkeeping --------------------------------------------------

    def _charge(self, rid: int, replica: int, amount: float) -> None:
        self._load[replica] += amount
        self._charged[rid] = (replica, amount)

    def _discharge(self, rid: int) -> None:
        rep, amt = self._charged.pop(rid, (None, 0.0))
        if rep is not None:
            self._load[rep] -= amt

    def _pick(self, candidates: List[int]) -> int:
        return min(candidates, key=lambda i: (self._load[i], i))

    def _dispatch(self) -> int:
        """Drain the router queue onto the least-loaded prefill-capable
        replicas, up to the admission depth."""
        sent = 0
        while self.queue:
            open_replicas = [
                i for i in self.cluster.prefill_capable()
                if (self.cluster.replicas[i]._sched is None
                    or len(self.cluster.replicas[i]._sched.waiting)
                    < self.admit_depth)]
            if not open_replicas:
                break
            req = self.queue.popleft()
            i = self._pick(open_replicas)
            cost = self.predicted_cost(req)
            self._cost[req.request_id] = cost
            self._charge(req.request_id, i, cost["total_s"])
            self.home[req.request_id] = i
            self.cluster.replicas[i].enqueue(req)
            if self.obs is not None:
                self.obs.tracer.instant(
                    "dispatch", ROUTER_PID, 0, now(),
                    request=req.request_id, replica=i,
                    predicted_s=cost["total_s"])
            sent += 1
        return sent

    # -- migration ---------------------------------------------------------

    def _move(self, req: Request, src: int, dst: int) -> None:
        """Migrate ``req`` from replica ``src`` to ``dst``.  Anything that
        fails here raises: a request is never re-prefilled in its place."""
        mb0 = req.ledger.migration_bytes
        self.cluster.replicas[src].export_request(
            req, link=self.cluster.roles.link)
        self.cluster.replicas[dst].import_request(req)
        self.migrations += 1
        self.migration_bytes += req.ledger.migration_bytes - mb0
        if self.obs is not None:
            self.obs.tracer.instant(
                "migrate", ROUTER_PID, 0, now(), request=req.request_id,
                src=src, dst=dst,
                bytes=int(req.ledger.migration_bytes - mb0))
        self.home[req.request_id] = dst
        self._discharge(req.request_id)
        cost = self._cost.get(req.request_id)
        self._charge(req.request_id, dst, cost["decode_s"] if cost else 0.0)

    def _migrate(self) -> None:
        """The disaggregation handoff: every request RUNNING on a
        prefill-only replica with its first token committed moves to the
        least-loaded decode replica."""
        for i, eng in enumerate(self.cluster.replicas):
            if self.cluster.role(i) != "prefill" or eng._sched is None:
                continue
            ready = [r for r in list(eng._sched.active.values())
                     if r.state is RequestState.RUNNING and r.generated]
            for req in ready:
                self._move(req, i, self._pick(self.cluster.decode_capable()))

    def _resumable(self, eng, req: Request) -> bool:
        """Would this replica's pool take the request back now?  A
        replica that has served nothing yet builds its pool to answer (a
        decode-only replica of a mixed fleet gets work only by rescue;
        the reference's would never be asked)."""
        if eng._kv is None:
            eng._ensure(req.budget)
        kv = eng._kv
        if req.budget > kv.max_len:
            return False
        if req.swap_snapshot is not None:
            return (kv.free_slot_count > 0
                    and kv.swap_in_pages_needed(req.swap_snapshot)
                    <= kv.available_page_count)
        return kv.can_admit_tokens(req.fill_tokens,
                                   reserve_pages=eng._sched.watermark_pages)

    def _rescue(self) -> None:
        """Mid-decode migration: a preempted request whose own replica
        cannot resume it (its pool still full) moves to a decode-capable
        replica that can, so preemption pressure spills across the fleet
        instead of queueing on one pool."""
        for i, eng in enumerate(self.cluster.replicas):
            sched = eng._sched
            if sched is None or not sched.preempted:
                continue
            for req in list(sched.preempted):
                if self._resumable(eng, req):
                    continue                     # its replica resumes it
                dests = [j for j in self.cluster.decode_capable()
                         if j != i and self._resumable(
                             self.cluster.replicas[j], req)]
                if dests:
                    self._move(req, i, self._pick(dests))

    # -- serving loop ------------------------------------------------------

    def step(self) -> List[Request]:
        """One cluster iteration: dispatch, rescue stuck preemptees, one
        engine step for each replica with work (in turn), then the
        disaggregation handoff.  Returns the requests finished here."""
        self._dispatch()
        self._rescue()
        done: List[Request] = []
        for eng in self.cluster.replicas:
            if eng._sched is not None and eng._sched.has_work():
                done.extend(eng.step())
        self._migrate()
        for req in done:
            self._discharge(req.request_id)
            self._cost.pop(req.request_id, None)
            self.home.pop(req.request_id, None)
            self.finished.append(req)
        return done

    def has_work(self) -> bool:
        return bool(self.queue) or self.cluster.has_work()

    def run(self) -> List[Request]:
        """Drain everything; returns the requests finished by this call."""
        n0 = len(self.finished)
        while self.has_work():
            self.step()
        return self.finished[n0:]

    def stream(self) -> Iterator[Tuple[int, int]]:
        """Per-token streaming: step the cluster and yield ``(request_id,
        token)`` as commits land, across replicas and migrations (ids are
        cluster-unique, so a stream runs on through a handoff)."""
        while self.has_work():
            self.step()
            for rid, req in self.requests.items():
                sent = self._streamed.get(rid, 0)
                for tok in req.generated[sent:]:
                    yield rid, int(tok)
                self._streamed[rid] = len(req.generated)

    # -- reporting ---------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        led = self.cluster.aggregate_ledger()
        ttfts = [r.ttft for r in self.finished if r.token_times]
        return {
            "finished": float(len(self.finished)),
            "queued": float(len(self.queue)),
            "migrations": float(self.migrations),
            "migration_bytes": float(self.migration_bytes),
            "ledger_migration_bytes": float(led.migration_bytes),
            "ttft_p50_s": (float(np.percentile(ttfts, 50)) if ttfts
                           else float("nan")),
            "ttft_p95_s": (float(np.percentile(ttfts, 95)) if ttfts
                           else float("nan")),
        }


__all__ = ["Router"]
