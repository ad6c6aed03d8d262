"""Public wrappers for the port's kernels.

Counterpart of ``repro/kernels/ops.py``. A wrapper given CUDA tensors
launches the hand-written Hopper kernel, or raises: there is no fallback.
Given CPU tensors it runs the kernel's plain torch version over the same
tiles (the role ``interpret=True`` plays for the Pallas kernels). Each
kernel launch adds one to that kernel's count in :func:`launch_counts`
and, for flash attention and rmsnorm, to its route's count in
:func:`route_launch_counts`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import vecmul as _vm

#: the ported kernels, in the order the port brought them up
KERNELS = ("vecmul", "rmsnorm", "flash_attention", "ssd_scan")


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far in this process, per kernel."""
    return {k: int(_build.LAUNCHES[k]) for k in KERNELS}


def route_launch_counts() -> Dict[str, int]:
    """Kernel launches so far per kernel and route (``"flash_attention/wgmma"``,
    ``"rmsnorm/registers"``, ...), for the kernels that have routes; where a
    route runs two kernels, the second counts under ``"<route>:<kernel>"``
    (``"flash_attention/mma:split"``, ``"ssd_scan/mma:stream"``) and not
    under the route's own key."""
    return {k: int(n) for k, n in sorted(_build.LAUNCHES.items()) if "/" in k}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    _build.LAUNCHES.clear()


def vecmul(x: torch.Tensor, y: torch.Tensor, *, block: int = 1024) -> torch.Tensor:
    if x.is_cuda:
        return _vm.vecmul_cuda(x, y, block=block)
    return _vm.vecmul_plain(x, y, block=block)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
            block_rows: int = 128) -> torch.Tensor:
    """RMSNorm over the last dim; leading dims are flattened into rows."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x.is_cuda:
        out = _rn.rmsnorm_cuda(x2.contiguous(), w, eps=eps, block_rows=block_rows)
    else:
        out = _rn.rmsnorm_plain(x2, w, eps=eps, block_rows=block_rows)
    return out.reshape(shape)


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 512,
                    block_k: int = 512, q_offset: int = 0) -> torch.Tensor:
    if q.is_cuda:
        return _fa.flash_attention_cuda(q, k, v, causal=causal, block_q=block_q,
                                        block_k=block_k, q_offset=q_offset)
    return _fa.flash_attention_plain(q, k, v, causal=causal, block_q=block_q,
                                     block_k=block_k, q_offset=q_offset)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256,
             initial_state: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan; returns (y [b,s,nh,dh], final_state [b,nh,dh,N] f32)."""
    if x.is_cuda:
        return _ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk,
                                  initial_state=initial_state)
    return _ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                               initial_state=initial_state)
