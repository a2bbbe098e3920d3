"""Tensor-parallel serving: the multi-card seam of the engine, the JAX
package's ``serve/shard.py`` for explicit SPMD.

The paper's central construction is a roofline per NUMA scope: the roof
that binds depends on whether traffic stays local (DRAM) or crosses the
socket link.  A tensor-parallel decode step reads its weight and KV
shards from per-card HBM (the local roof) and all-reduces a (B, 1,
d_model) activation per row-parallel matmul over the card-to-card link
(the remote roof).  This module runs the continuous-batching engine over
a ``(data, model)`` mesh and prices both.

The reference is one controller over a device mesh (``shard_map``).
Here every rank is a process (parallel/mesh.py ``spawn``) that builds
the same engine from the same inputs and holds only its shards:

* weights are partitioned leaf by leaf by the logical-axis rules
  (parallel/sharding.py ``DECODE_TP_RULES``): heads / kv_heads / d_ff /
  vocab split over ``model``; norms, latents and the tied embedding table
  replicate (the token lookup needs every row; an untied head stays
  vocab-sharded and the logits edge all-gathers);
* GQA page pools shard their kv_heads dim; MLA latent pools replicate
  while the q / o projections partition over heads;
* every device step (decode, verify, prefill chunk and bucket, whole
  prompt) is the parent engine's own body run on the local config
  (:func:`tp_local_config`, ``Engine.step_cfg``): the kernels see the
  local heads, and the only traffic between ranks is the collective
  edges of parallel/collectives.py, the reference's: the o-projection
  (GQA and MLA; decode, verify and prefill alike) and the dense-FFN
  down-projection all-reduce, the untied head's logits all-gather.  In
  the reference GSPMD partitions prefill from the sharded weights; here
  prefill crosses ranks at those same edges;
* the scheduler is deterministic and every rank samples the same logits
  with the same seeds, so every rank commits the same tokens.

On NCCL the steps are captured as CUDA graphs with their collectives
inside, as on one card.  A ``gloo`` collective cannot be captured, so
``cuda_graphs=True`` over gloo raises and the default (None) runs eagerly
there; both are decided from the backend up front.

The 1x1 mesh wraps nothing and needs no process group:
:class:`ShardedEngine` is then the parent ``Engine`` byte for byte.  At
tp > 1 the per-request ledger charges ``scheduler.decode_step_ici_bytes``
a step, its terms split over ``tp_scope``, and serve/crosscheck.py
``crosscheck_collectives`` holds the charged bytes against the
collectives a step dispatches.

Serving replicas (``dp`` > 1) are independent engines behind a router
(serve/cluster.py): each is built with ``submesh=`` its device row
(parallel/mesh.py ``dp_submeshes``) and ``replica_id=``.  A tp = 1
replica pins its weights and pools to its row's one device and is the
parent ``Engine`` byte for byte.  A tp > 1 replica would need tp ranks
of its own under this explicit SPMD and is refused (ROADMAP queue 1
item 18).  MoE FFNs need expert-parallel dispatch and recurrent mixers keep
per-slot state rows with no head dim to shard: both are refused at tp >
1 (:func:`tp_sharding_error`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from ..core.roofline import op_collectives
from ..models import model_param_defs, paged_cache_defs
from ..models.common import ModelConfig
from ..models.model import prepare_params
from ..models.params import tree_map
from ..parallel import sharding as shd
from ..parallel.mesh import MODEL_AXIS, Mesh, make_host_mesh, use_mesh
from .engine import Engine, EngineConfig
from .kv_cache import supports_paging
from .scheduler import decode_step_ici_bytes
from .spec import SpecConfig, SpecEngine


def parse_mesh(spec: str) -> Tuple[int, int]:
    """``"dp,tp"`` (e.g. ``"1,2"``) -> (dp, tp); a bare int means tp."""
    parts = [p.strip() for p in str(spec).split(",") if p.strip()]
    if len(parts) == 1:
        return 1, int(parts[0])
    if len(parts) != 2:
        raise ValueError(f"mesh spec {spec!r}: want 'dp,tp'")
    return int(parts[0]), int(parts[1])


def tp_sharding_error(cfg: ModelConfig, tp: int) -> Optional[str]:
    """Why ``cfg`` cannot run tensor-parallel at width ``tp`` (None when
    it can): the gates follow what the sharding partitions, query / o
    heads, GQA KV heads with their pools, the dense FFN's inner dim."""
    if tp <= 1:
        return None
    if not supports_paging(cfg):
        return f"{cfg.name}: sharded serving rides the paged engine"
    bad = [b.mixer for b in cfg.block_pattern if b.mixer not in ("attn",
                                                                "mla")]
    if bad:
        return (f"{cfg.name}: recurrent mixers {sorted(set(bad))} keep "
                "per-slot state rows with no head dim to shard")
    if any(b.ffn == "moe" for b in cfg.block_pattern):
        return (f"{cfg.name}: MoE FFNs need expert-parallel dispatch; "
                "tensor-parallel decode shards dense FFNs")
    if cfg.n_heads % tp:
        return f"{cfg.name}: n_heads {cfg.n_heads} not divisible by tp={tp}"
    if (any(b.mixer == "attn" for b in cfg.block_pattern)
            and cfg.n_kv_heads % tp):
        return (f"{cfg.name}: n_kv_heads {cfg.n_kv_heads} not divisible "
                f"by tp={tp} (KV pools shard over kv_heads)")
    if any(b.ffn == "dense" for b in cfg.block_pattern) and cfg.d_ff % tp:
        return f"{cfg.name}: d_ff {cfg.d_ff} not divisible by tp={tp}"
    return None


def supports_tp(cfg: ModelConfig, tp: int) -> bool:
    return tp_sharding_error(cfg, tp) is None


def tp_local_config(cfg: ModelConfig, tp: int,
                    overlap: str = "none") -> ModelConfig:
    """The config one rank's steps run: local head and FFN counts, an
    explicit head_dim (it must not re-derive from the local head count),
    ``tp_axis`` naming the axis the collective edges reduce over, and
    ``tp_overlap`` their schedule ("none" | "ring").  vocab_size stays
    global: the logits edge tells a sharded head by it."""
    err = tp_sharding_error(cfg, tp)
    if err:
        raise NotImplementedError(err)
    return dataclasses.replace(
        cfg,
        n_heads=cfg.n_heads // tp,
        n_kv_heads=(cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0
                    else cfg.n_kv_heads),
        head_dim=cfg.hd,
        d_ff=cfg.d_ff // tp if cfg.d_ff % tp == 0 else cfg.d_ff,
        tp_axis=MODEL_AXIS,
        tp_overlap=overlap,
    )


def param_pspecs(cfg: ModelConfig, mesh) -> Any:
    """The spec tree of the parameters under ``DECODE_TP_RULES``, the
    embedding table replicated (every rank looks up every token)."""
    specs = shd.tree_specs(model_param_defs(cfg), mesh, shd.DECODE_TP_RULES)
    specs["embed"]["tok"] = ()
    return specs


def pool_pspecs(cfg: ModelConfig, num_slots: int, num_pages: int,
                page_size: int, mesh) -> Any:
    """The spec tree of the paged cache: GQA k / v pools shard kv_heads,
    MLA latent pools replicate (the page dims never shard: a page is the
    block-table unit)."""
    defs = paged_cache_defs(cfg, num_slots, num_pages, page_size)
    return shd.tree_specs(defs, mesh, shd.DECODE_TP_RULES)


def shard_params(params, cfg: ModelConfig, mesh: Mesh):
    """This rank's shards of a parameter tree, leaf by leaf: a leaf of
    the global shape is cut to its block (a tensor of its own, so the
    whole one can go), a leaf already of the local shape is kept (from
    ``models.init_params(..., specs=, mesh=)``).  The tied table's cast
    copy is rebuilt from the replicated table."""
    specs = param_pspecs(cfg, mesh)

    def walk(defs, sp, tree):
        if isinstance(defs, dict):
            return {k: walk(defs[k], sp[k], tree[k]) for k in defs}
        if isinstance(defs, list):
            return [walk(d, s, t) for d, s, t in zip(defs, sp, tree)]
        local = shd.local_shape(defs.shape, sp, mesh)
        if tuple(tree.shape) == local:
            return tree
        if tuple(tree.shape) != defs.shape:
            raise ValueError(f"parameter of shape {tuple(tree.shape)}: "
                             f"neither {defs.shape} nor its shard {local}")
        return shd.shard_leaf(tree, sp, mesh)

    return prepare_params(walk(model_param_defs(cfg), specs, params), cfg)


class _ShardedStepMixin:
    """What :class:`ShardedEngine` and :class:`ShardedSpecEngine` share:
    the mesh, the local config and shards, the mesh made active around
    every step, and the ledger hooks."""

    def _init_sharded(self, cfg: ModelConfig, params, ecfg, mesh_shape,
                      mesh: Optional[Mesh], init,
                      submesh: Optional[Sequence[torch.device]] = None,
                      replica_id: int = 0):
        dp, tp = int(mesh_shape[0]), int(mesh_shape[1])
        if dp < 1 or tp < 1:
            raise ValueError(f"mesh {mesh_shape}: axes must be >= 1")
        if dp != 1 and submesh is None:
            raise NotImplementedError(
                "dp > 1 serving replicas are independent engines behind a "
                "router: one engine cannot be two replicas.  Build a "
                "serve.cluster.Cluster; it gives each replica its device "
                "row (parallel.mesh.dp_submeshes) through submesh=")
        self.dp, self.tp, self.mesh = dp, tp, None
        self.replica_id = int(replica_id)
        self.replica_device: Optional[torch.device] = None
        if submesh is not None:
            row = tuple(submesh)
            if len(row) != tp:
                raise ValueError(f"replica device row {row} does not "
                                 f"match (data=1, model={tp})")
            if tp > 1:
                raise NotImplementedError(
                    f"a tp={tp} replica inside a cluster needs {tp} ranks "
                    "of its own under explicit SPMD: ROADMAP queue 1 "
                    "item 18")
            # one-device replica: weights and pools on the row's device,
            # no wrapper, so the steps are the parent Engine's
            dev = torch.device(row[0])
            self.replica_device = dev
            init(cfg, tree_map(lambda t: t.to(dev), params),
                 dataclasses.replace(ecfg or EngineConfig(), device=dev))
            return
        if tp == 1:
            init(cfg, params, ecfg)
            return
        err = tp_sharding_error(cfg, tp)
        if err:
            raise NotImplementedError(err)
        mesh = mesh if mesh is not None else make_host_mesh(1, tp)
        if mesh.sizes.get(MODEL_AXIS) != tp or mesh.size != tp:
            raise ValueError(f"mesh {mesh.sizes} is not (data=1, model={tp})")
        ecfg = ecfg or EngineConfig()
        if mesh.backend == "gloo":
            # a gloo collective cannot be captured in a CUDA graph
            if ecfg.cuda_graphs:
                raise ValueError(
                    "cuda_graphs=True needs collectives a CUDA graph can "
                    "capture (NCCL); the mesh's backend is gloo")
            ecfg = dataclasses.replace(ecfg, cuda_graphs=False)
        self.mesh = mesh
        init(cfg, shard_params(params, cfg, mesh), ecfg)
        self.cfg_local = tp_local_config(self.cfg, tp,
                                         overlap=self.ecfg.overlap)
        self.step_cfg = self.cfg_local
        if self.obs is not None:
            self.obs.tracer.process(self._obs_pid, self._obs_process_name())

    def _obs_process_name(self) -> str:
        if getattr(self, "mesh", None) is not None:
            return (f"{self.cfg.name} engine tp={self.tp} "
                    f"(rank {self.mesh.rank})")
        return super()._obs_process_name()

    def step(self):
        dev = self.replica_device
        # a replica on its own card launches its kernels and captures its
        # graphs there, whatever the current card is
        on_card = (torch.cuda.device(dev) if dev is not None
                   and dev.type == "cuda" else contextlib.nullcontext())
        with use_mesh(self.mesh), on_card:
            return super().step()

    def _step_collective_bytes(self, n_tokens: int) -> float:
        if self.mesh is None:
            return 0.0
        return decode_step_ici_bytes(self.cfg, self.ecfg.num_slots,
                                     self.tp, n_tokens)

    def _ledger_chips(self) -> int:
        return self.tp

    def walk_decode_collectives(self):
        """Run the decode step body over the persistent inputs of the last
        step, eagerly, and summarize the collectives it dispatched
        (core/roofline/op_collectives.py).  Every rank must call it
        together.  The step rewrites the KV lines the last step wrote
        with the same values (no recurrent state is sharded), so the
        engine's state is unchanged."""
        if self._kv is None:
            raise ValueError("engine has no live pool; submit work or "
                             "reset()")
        if self.mesh is None:
            raise ValueError("1x1 mesh: no sharded step to walk")
        with use_mesh(self.mesh), torch.no_grad():
            _, summary = op_collectives.walk_collectives(self._decode_body)
        return summary


class ShardedEngine(_ShardedStepMixin, Engine):
    """The continuous-batching engine with its steps tensor-parallel.

    Every rank of a ``(1, tp)`` mesh runs, on the same inputs::

        eng = ShardedEngine(cfg, params, ecfg, mesh_shape=(1, tp))
        eng.submit(prompt_ids, GenerateConfig(max_new_tokens=64))
        done = eng.run()   # ledgers carry per-card ICI wire bytes

    ``params`` is the whole tree or this rank's shards
    (``models.init_params(..., specs=param_pspecs(cfg, mesh), mesh=)``);
    ``mesh`` defaults to ``make_host_mesh(1, tp)`` over the default
    process group.  On a 1x1 mesh nothing is sharded or wrapped."""

    def __init__(self, cfg: ModelConfig, params,
                 ecfg: Optional[EngineConfig] = None,
                 mesh_shape: Tuple[int, int] = (1, 1),
                 mesh: Optional[Mesh] = None,
                 submesh: Optional[Sequence[torch.device]] = None,
                 replica_id: int = 0):
        self._init_sharded(cfg, params, ecfg, mesh_shape, mesh,
                           lambda c, p, e: Engine.__init__(self, c, p, e),
                           submesh=submesh, replica_id=replica_id)


class ShardedSpecEngine(_ShardedStepMixin, SpecEngine):
    """Speculative decoding with the tensor-parallel steps: the
    verify step runs on the local config over local KV heads, so
    intensity scales by about k + 1 while the same edges carry T-times
    wider activations (``decode_step_ici_bytes(..., n_tokens)``).  A
    draft model runs whole on every rank."""

    def __init__(self, cfg: ModelConfig, params,
                 ecfg: Optional[EngineConfig] = None,
                 scfg: Optional[SpecConfig] = None,
                 mesh_shape: Tuple[int, int] = (1, 1),
                 mesh: Optional[Mesh] = None,
                 submesh: Optional[Sequence[torch.device]] = None,
                 replica_id: int = 0):
        if submesh is not None and scfg is not None and (
                scfg.draft_params is not None):
            # a replica's draft model lives on the replica's device too
            dev = torch.device(tuple(submesh)[0])
            scfg = dataclasses.replace(scfg, draft_params=tree_map(
                lambda t: t.to(dev), scfg.draft_params))
        self._init_sharded(
            cfg, params, ecfg, mesh_shape, mesh,
            lambda c, p, e: SpecEngine.__init__(self, c, p, e, scfg),
            submesh=submesh, replica_id=replica_id)


def make_engine(cfg: ModelConfig, params,
                ecfg: Optional[EngineConfig] = None,
                scfg: Optional[SpecConfig] = None,
                mesh_shape: Tuple[int, int] = (1, 1),
                mesh: Optional[Mesh] = None,
                submesh: Optional[Sequence[torch.device]] = None,
                replica_id: int = 0):
    """The engine a launcher builds: speculative with ``scfg``, sharded
    past a 1x1 mesh; a serving replica on its device row with
    ``submesh`` (serve/cluster.py)."""
    kw = dict(mesh_shape=mesh_shape, mesh=mesh, submesh=submesh,
              replica_id=replica_id)
    if scfg is not None:
        return ShardedSpecEngine(cfg, params, ecfg, scfg, **kw)
    return ShardedEngine(cfg, params, ecfg, **kw)


__all__ = [
    "ShardedEngine", "ShardedSpecEngine", "make_engine", "param_pspecs",
    "parse_mesh", "pool_pspecs", "shard_params", "supports_tp",
    "tp_local_config", "tp_sharding_error",
]
