"""Hand-written Hopper kernels of the port, their wrappers and their plain
PyTorch versions. CUDA sources live in ``csrc/`` and build on first use
(``_build``); importing this package builds nothing."""
