"""Architecture registry: ``get_config("<arch-id>")``.

ALL_ARCHS lists the 10 assigned architectures; importing this package
registers them all.
"""

from . import (  # noqa: F401  (registration side effects)
    deepseek_v2_236b,
    jamba_v01_52b,
    kimi_k2_1t,
    llama32_vision_90b,
    minicpm_2b,
    minitron_4b,
    qwen3_0_6b,
    qwen3_14b,
    whisper_small,
    xlstm_350m,
)
from .base import get_config, list_archs, register, smoke

ALL_ARCHS = (
    "xlstm-350m",
    "whisper-small",
    "qwen3-14b",
    "minicpm-2b",
    "minitron-4b",
    "qwen3-0.6b",
    "llama-3.2-vision-90b",
    "deepseek-v2-236b",
    "kimi-k2-1t-a32b",
    "jamba-v0.1-52b",
)

__all__ = ["get_config", "list_archs", "register", "smoke", "ALL_ARCHS"]
