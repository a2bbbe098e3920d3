from .common import BlockDef, ModelConfig
from .model import (abstract_params, cache_param_defs, cross_entropy,
                    decode_step, drop_cast, decode_step_paged,
                    decode_step_verify_paged, init_cache, init_params,
                    loss_fn, model_param_defs, paged_cache_defs,
                    param_bytes, param_count, param_shardings,
                    prefill, prefill_chunk_paged, prefill_padded,
                    prepare_params)

__all__ = [
    "BlockDef", "ModelConfig", "abstract_params", "cache_param_defs",
    "cross_entropy", "decode_step", "drop_cast",
    "decode_step_paged", "decode_step_verify_paged", "init_cache",
    "init_params", "loss_fn", "model_param_defs", "paged_cache_defs",
    "param_bytes", "param_count", "param_shardings",
    "prefill", "prefill_chunk_paged", "prefill_padded", "prepare_params",
]
