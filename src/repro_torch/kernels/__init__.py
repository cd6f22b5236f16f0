"""Hand-written Hopper kernels of the port (``csrc/``), their plain
PyTorch versions (:mod:`ref`), the build (:mod:`build`) and one wrapper
per kernel (:mod:`ops`)."""
