"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain torch
versions, the oracles, the resource model and the correctness gate."""
