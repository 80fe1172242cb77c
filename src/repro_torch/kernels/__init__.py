"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, bound with ctypes),
their plain PyTorch versions (:mod:`.ref`) and the dispatch (:mod:`.ops`).
Importing builds nothing; a kernel builds at its first launch."""
