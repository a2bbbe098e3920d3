from . import sampling
from .block_pool import BlockPool, PoolStats, chain_hash, token_chain_hashes
from .cluster import Cluster, RoleConfig
from .engine import Engine, EngineConfig, GenerateConfig, StaticEngine
from .kv_cache import PagedKVCache, SwapSnapshot
from .proposer import (DraftModelProposer, NgramProposer, Proposal,
                       ngram_propose)
from .router import Router
from .scheduler import Request, RequestState, RooflineLedger, Scheduler
from .shard import (ShardedEngine, ShardedSpecEngine, make_engine,
                    param_pspecs, parse_mesh, pool_pspecs, supports_tp,
                    tp_local_config, tp_sharding_error)
from .spec import (SpecConfig, SpecEngine, adaptive_k,
                   spec_expected_tokens_per_pass, spec_speedup_model,
                   speculative_summary, supports_spec)

__all__ = [
    "Engine", "EngineConfig", "GenerateConfig", "StaticEngine",
    "BlockPool", "PoolStats", "chain_hash", "token_chain_hashes",
    "PagedKVCache", "SwapSnapshot",
    "Request", "RequestState", "RooflineLedger", "Scheduler", "sampling",
    "DraftModelProposer", "NgramProposer", "Proposal", "ngram_propose",
    "SpecConfig", "SpecEngine", "adaptive_k",
    "spec_expected_tokens_per_pass", "spec_speedup_model",
    "speculative_summary", "supports_spec",
    "ShardedEngine", "ShardedSpecEngine", "make_engine", "param_pspecs",
    "parse_mesh", "pool_pspecs", "supports_tp", "tp_local_config",
    "tp_sharding_error",
    "Cluster", "RoleConfig", "Router",
]
