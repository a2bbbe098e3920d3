"""PyTorch / CUDA port of the serving stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference this package is held against
in the tests; nothing here imports it or JAX.  Layout mirrors ``repro``:
``configs``, ``models``, ``kernels`` (hand-written CUDA kernels under
``csrc/`` plus their plain PyTorch versions), ``serve``,
``core.roofline`` and ``launch``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
