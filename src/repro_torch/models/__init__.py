from .common import BlockDef, ModelConfig
from .model import (decode_step, decode_step_paged,
                    decode_step_verify_paged, init_cache, init_params,
                    model_param_defs, paged_cache_defs, param_count,
                    param_shardings,
                    prefill, prefill_chunk_paged, prefill_padded,
                    prepare_params)

__all__ = [
    "BlockDef", "ModelConfig", "decode_step",
    "decode_step_paged", "decode_step_verify_paged", "init_cache",
    "init_params", "model_param_defs", "paged_cache_defs", "param_count",
    "param_shardings",
    "prefill", "prefill_chunk_paged", "prefill_padded", "prepare_params",
]
