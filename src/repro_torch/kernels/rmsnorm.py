"""Fused RMSNorm: x * rsqrt(mean(x²) + eps) * w, statistics in f32.

Counterpart of ``repro/kernels/rmsnorm.py``. ``rmsnorm_cuda`` launches the
hand-written Hopper kernel in ``csrc/rmsnorm.cu`` (one CUDA block per
``block_rows`` rows, one warp per row) on the path :func:`path` picks;
``rmsnorm_plain`` is the same function in plain torch over the same row
tiles (pad rows to a multiple of ``block_rows``, normalise tile by tile,
slice back).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"
REPLACES = "src/repro/kernels/rmsnorm.py:9"

#: threads per CUDA block: 16 warps, each owning whole rows
THREADS = 512

#: the longest row the register path holds: 16 vectors of 16 bytes a lane
MAX_REGISTER_ROW_BYTES = 16 * 16 * 32

#: the kernel's paths and their codes in ``csrc/rmsnorm.cu``
PATH_CODES = {"scalar": 0, "two-pass": 1, "registers": 2}


def path(d: int, itemsize: int, aligned: bool = True) -> str:
    """The kernel's path for rows of ``d`` elements, decided before the
    launch: ``"registers"`` for rows of whole 16-byte vectors of at most
    ``MAX_REGISTER_ROW_BYTES`` (the row stays in registers between the sum
    of squares and the write), ``"two-pass"`` for longer rows of whole
    vectors (the second read comes from L2), ``"scalar"`` when the rows
    are not whole vectors or a pointer is not 16-byte aligned."""
    row = d * itemsize
    if row % 16 or not aligned:
        return "scalar"
    return "registers" if row <= MAX_REGISTER_ROW_BYTES else "two-pass"


def vectors_per_lane(d: int, itemsize: int) -> int:
    """16-byte vectors each lane holds on the register path: the power of
    two at or above the row's vectors over 32 lanes (the kernel masks the
    rest)."""
    need = -(-(d * itemsize // 16) // 32)
    return 1 << max(need - 1, 0).bit_length()


def smem_bytes(d: int) -> int:
    """Dynamic shared memory the kernel asks for: w in f32. The launch and
    the resource model both call this."""
    return 4 * d


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"rmsnorm takes x [rows, d] and w [d], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
                  block_rows: int = 128) -> torch.Tensor:
    """RMSNorm of x [rows, d] in plain torch over the kernel's row tiles."""
    _check_shapes(x, w)
    rows, d = x.shape
    pad = (-rows) % block_rows
    tiles = F.pad(x, (0, 0, 0, pad)).view(-1, block_rows, d).float()
    inv = torch.rsqrt(torch.mean(tiles * tiles, dim=-1, keepdim=True) + eps)
    out = ((tiles * inv) * w.float()).to(x.dtype)
    return out.reshape(-1, d)[:rows]


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
                 block_rows: int = 128) -> torch.Tensor:
    """RMSNorm of x [rows, d] through ``csrc/rmsnorm.cu`` on ``x``'s card."""
    _check_shapes(x, w)
    if not (x.is_cuda and w.device == x.device and w.dtype == x.dtype):
        raise ValueError("rmsnorm_cuda takes CUDA tensors of one dtype on "
                         "one card")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_cuda takes contiguous tensors")
    if block_rows <= 0:
        raise ValueError(f"block_rows must be > 0, got {block_rows}")
    code = _build.dtype_code(x)
    rows, d = x.shape
    out = torch.empty_like(x)
    if rows == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, out))
    kind = path(d, x.element_size(), aligned)
    lib = _build.library()
    err = lib.rmsnorm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
                             block_rows, eps, code, PATH_CODES[kind],
                             vectors_per_lane(d, x.element_size()), THREADS,
                             smem_bytes(d), _build.stream_ptr(x.device))
    _build.check("rmsnorm_launch", err)
    _build.LAUNCHES["rmsnorm"] += 1
    _build.LAUNCHES[f"rmsnorm/{kind}"] += 1
    return out
