from . import sampling
from .block_pool import BlockPool, PoolStats, chain_hash, token_chain_hashes
from .engine import Engine, EngineConfig, GenerateConfig
from .kv_cache import PagedKVCache, SwapSnapshot
from .scheduler import Request, RequestState, RooflineLedger, Scheduler

__all__ = [
    "Engine", "EngineConfig", "GenerateConfig",
    "BlockPool", "PoolStats", "chain_hash", "token_chain_hashes",
    "PagedKVCache", "SwapSnapshot",
    "Request", "RequestState", "RooflineLedger", "Scheduler", "sampling",
]
