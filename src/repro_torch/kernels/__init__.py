"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions,
and the device-keyed registry that picks between them (``ops``)."""
