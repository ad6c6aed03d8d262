"""PyTorch and CUDA port of ``repro`` for one NVIDIA H100 (Hopper, sm_90a).

The package mirrors ``repro``'s layout (``core``, ``kernels``, ``search``,
``launch``). It imports ``torch`` and ``numpy`` and nothing of ``jax`` or
``repro``. Its kernels are CUDA C++ under ``kernels/csrc``, built with
``nvcc`` on first use. Entry points run on ``cuda`` unless the caller asks
for ``cpu``.
"""
