"""Element-wise vector multiply, Z = X ⊙ Y: the paper's §4 accelerator.

Counterpart of ``repro/kernels/vecmul.py``. ``vecmul_cuda`` launches the
hand-written Hopper kernel in ``csrc/vecmul.cu``; ``vecmul_plain`` is the
same function in plain torch, walking the same ``block`` tiles (pad to a
multiple of ``block``, multiply block by block, slice back). The CPU tests
and the card's kernel-vs-plain check use the plain version; the main path
on a CUDA tensor never does.

The block length is the DSE-explorable tile: one CUDA block per ``block``
elements, ``block / (16 / itemsize)`` threads, one 16-byte access per
thread and operand. The kernel needs no shared memory.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/vecmul.cu"
REPLACES = "src/repro/kernels/vecmul.py:24"


def vec_width(itemsize: int) -> int:
    """Elements per 16-byte access."""
    return 16 // itemsize


def threads(block: int, itemsize: int) -> int:
    """Threads per CUDA block for a tile of ``block`` elements."""
    return block // vec_width(itemsize)


def smem_bytes() -> int:
    """Dynamic shared memory the kernel asks for: none."""
    return 0


def vecmul_plain(x: torch.Tensor, y: torch.Tensor, *, block: int = 1024) -> torch.Tensor:
    """Z = X ⊙ Y in plain torch over the kernel's tiles."""
    if x.shape != y.shape or x.dim() != 1:
        raise ValueError(f"vecmul takes two equal 1-D vectors, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    L = x.shape[0]
    pad = (-L) % block
    xp, yp = F.pad(x, (0, pad)), F.pad(y, (0, pad))
    return (xp.view(-1, block) * yp.view(-1, block)).reshape(-1)[:L]


def vecmul_cuda(x: torch.Tensor, y: torch.Tensor, *, block: int = 1024) -> torch.Tensor:
    """Z = X ⊙ Y through ``csrc/vecmul.cu`` on ``x``'s card."""
    if x.shape != y.shape or x.dim() != 1:
        raise ValueError(f"vecmul takes two equal 1-D vectors, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if not (x.is_cuda and y.device == x.device and y.dtype == x.dtype):
        raise ValueError("vecmul_cuda takes two CUDA tensors of one dtype "
                         "on one card")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("vecmul_cuda takes contiguous tensors")
    code = _build.dtype_code(x)
    if block % vec_width(x.element_size()) or threads(block, x.element_size()) > 1024:
        raise ValueError(f"block={block} is not a legal tile for {x.dtype}")
    z = torch.empty_like(x)
    if x.numel() == 0:
        return z
    vector = all(t.data_ptr() % 16 == 0 for t in (x, y, z))
    lib = _build.library()
    err = lib.vecmul_launch(x.data_ptr(), y.data_ptr(), z.data_ptr(), x.numel(),
                            block, code, int(vector), _build.stream_ptr(x.device))
    _build.check("vecmul_launch", err)
    _build.LAUNCHES["vecmul"] += 1
    return z
