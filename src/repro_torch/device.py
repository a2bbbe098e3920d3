"""Device selection shared by every entry point of the port."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on.  Entry points default to
    ``"cuda"``; a missing card raises instead of quietly running on the
    CPU — the CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for every queued kernel on ``device`` (no-op on the CPU, where
    PyTorch runs synchronously)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
