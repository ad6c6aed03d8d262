"""Mamba2 SSD chunked scan (state-space duality).

Counterpart of ``repro/kernels/ssd_scan.py``: x [b, s, nh, dh], dt
[b, s, nh] (post-softplus), A [nh] (negative, f32), B and C [b, s, N].
Per chunk of ``chunk`` rows, in f32, with cs = cumsum(dt * A) over the
chunk:

* y_intra[l,h,p] = sum_{s<=l} (C_l . B_s) exp(cs_l - cs_s) dt_s x_s[h,p];
* the chunk's own state S_loc[h,p,n] = sum_l B_l[n] dt_l exp(cs_L - cs_l)
  x_l[h,p] and its decay exp(cs_L);
* the recurrence S <- S * decay + S_loc from ``initial_state`` (or 0);
* y_inter[l,h,p] = (C_l . S_prev[h,p,:]) exp(cs_l).

y = (y_intra + y_inter) rounded once to x's dtype; the final state is f32.

``ssd_scan_cuda`` launches one of two hand-written Hopper kernels, chosen
by :func:`route` before the launch. bf16 at dh in ``WGMMA_DH``, N in
``WGMMA_N`` and a chunk in ``WGMMA_CHUNKS`` takes ``csrc/ssd_scan_wgmma.cu``
(two launches: the chunk cumsum, then one chunk walk per (batch, head) on
``wgmma`` with the state in registers). Every other call takes
``csrc/ssd_scan.cu`` (three launches: the chunk cumsum, the state walk with
the inter-chunk term, and the intra-chunk term, on f32 FMAs). A failed
build or launch raises; neither route stands in for the other.
``ssd_scan_plain`` computes the same function in plain torch over the same
chunks, with the cumsum taken in the kernel's order, so the CPU tests reach
the chunking, the recurrence and ``initial_state``. On the wgmma route it
rounds to bf16 where that kernel feeds the tensor cores one bf16 value:
x * w for the chunk's own state, and S_prev for the inter-chunk term (P
enters that kernel's products as two bf16 parts, close enough to f32).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.device import H100_SXM
from repro_torch.kernels import _build

SOURCES = {"fma": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "wgmma": "src/repro_torch/kernels/csrc/ssd_scan_wgmma.cu"}
REPLACES = "src/repro/kernels/ssd_scan.py:24"

#: threads per CUDA block of the FMA route (state and intra kernels)
THREADS = 256

#: the wgmma route's sizes (``SSD_WGMMA_CASE`` in its source lists the same
#: product): head dim, state size and chunk. wgmma's M is 64, so a chunk
#: below 64 has no tile; mamba2-780m has N 128, zamba2-2.7b N 64
WGMMA_DH = (64,)
WGMMA_N = (64, 128)
WGMMA_CHUNKS = (64, 128, 256)


def route(dtype: torch.dtype, chunk: int, dh: int, N: int) -> str:
    """Which kernel runs a call at the chunk it runs (``min(chunk, s)``),
    decided before the launch: ``"wgmma"`` for bf16 at a size the wgmma
    kernel is instantiated for, ``"fma"`` otherwise (f32, chunk 32, any
    other dh or N)."""
    return ("wgmma" if dtype == torch.bfloat16 and dh in WGMMA_DH
            and N in WGMMA_N and chunk in WGMMA_CHUNKS else "fma")


def _wgmma_smem(chunk: int, N: int, dh: int, stages: int) -> int:
    stage = chunk * (2 * N + dh) * 2 + (8 * chunk + 1023) // 1024 * 1024
    return 1024 + stages * stage + dh * N * 2 + 8 * stages * (chunk // 64 + 1)


def wgmma_stages(chunk: int, N: int, dh: int = 64) -> int:
    """Chunks in flight in the wgmma kernel's TMA ring: 2 where they fit one
    block's shared memory, else 1 (chunk 256 at N 128)."""
    return 2 if _wgmma_smem(chunk, N, dh, 2) <= H100_SXM.smem_per_block else 1


def smem_bytes_wgmma(chunk: int, N: int, dh: int = 64) -> int:
    """Dynamic shared memory the wgmma kernel asks for: 1024 bytes of
    alignment slack; per stage C, B and x of one chunk in bf16 and its cs
    and dt in f32 (padded to 1024 bytes); S_prev in bf16; the mbarriers.
    The launch and the resource model both call this."""
    return _wgmma_smem(chunk, N, dh, wgmma_stages(chunk, N, dh))


def _two_ctas_fit(chunk: int, N: int, dh: int) -> bool:
    dev = H100_SXM
    return 2 * (smem_bytes_wgmma(chunk, N, dh) + dev.smem_reserved_per_block) <= dev.smem_per_sm


def wgmma_warpgroups(chunk: int, N: int, dh: int = 64) -> int:
    """The wgmma kernel's consumer warpgroups: one per 64 columns of the
    state, which each holds in registers; at N = 64 a second one (holding
    no state, taking half the row tiles) where two CTAs of one warpgroup
    would not fit an SM's shared memory (chunk 256)."""
    if N >= 128:
        return N // 64
    return 1 if _two_ctas_fit(chunk, N, dh) else 2


def wgmma_threads(chunk: int, N: int, dh: int = 64) -> int:
    """The wgmma kernel's threads: its consumer warpgroups and the producer
    warp."""
    return 128 * wgmma_warpgroups(chunk, N, dh) + 32


def wgmma_ctas_per_sm(chunk: int, N: int, dh: int = 64) -> int:
    """CTAs of the wgmma kernel its launch bounds ask one SM to hold: 2
    where two fit the SM's shared memory and still leave each thread 168
    registers (one consumer warpgroup; the compiler then keeps each
    thread's registers to what two CTAs allow), else 1."""
    ok = H100_SXM.regs_per_sm // (2 * wgmma_threads(chunk, N, dh)) >= 168
    return 2 if _two_ctas_fit(chunk, N, dh) and ok else 1


def row_tile(chunk: int) -> int:
    """Rows of a chunk one intra block computes (the chunk's row tile)."""
    return min(chunk, 64)


def state_tile(chunk: int) -> int:
    """Rows of a chunk the state kernel stages at a time (32 keeps two
    blocks on an SM at mamba2-780m widths)."""
    return min(chunk, 32)


def state_slice(dh: int) -> int:
    """Columns of dh one state block owns: the largest of 64, 32, 16, 8, 4
    that divides dh (0 when none does: the kernel takes dh % 4 == 0)."""
    return next((ps for ps in (64, 32, 16, 8, 4) if dh % ps == 0), 0)


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def smem_bytes_intra(chunk: int, N: int, dh: int) -> int:
    """Dynamic shared memory of the intra kernel, in f32: C.B^T for the
    row tile, s-major [chunk][tl+4]; the accumulator [tl][dh]; one head's
    cumsum and dt [chunk] each; and a staging area that holds first C and B
    tiles transposed, [N][tl+4] each, and later one head's dt*x tile
    [tl][dh] and masked decay tile [tl][tl+4]. The launch and the resource
    model call this."""
    tl = row_tile(chunk)
    ldt = tl + 4
    stage = max(2 * N * ldt, tl * dh + tl * ldt)
    return 4 * (chunk * ldt + tl * dh + 2 * _pad4(chunk) + stage)


def smem_bytes_state(chunk: int, N: int, dh: int) -> int:
    """Dynamic shared memory of the state kernel, in f32: C rows transposed
    [N][tq+4], B rows [tq][N], the weighted x tile [tq][ps], the chunk's
    exp(cs) and row weights [chunk] each, the carried state transposed
    [N][ps] and the chunk's own state [ps][N+4]."""
    tq, ps = state_tile(chunk), state_slice(dh)
    return 4 * (N * (tq + 4) + tq * N + tq * ps + 2 * _pad4(chunk) + N * ps
                + ps * (N + 4))


def supported(chunk: int, N: int, dh: int) -> bool:
    """Whether the kernels take these sizes: whole float4 rows (dh and N
    multiples of 4) and a chunk that both kernels' row tiles divide: at most
    32 rows, or 64, or a multiple of 64."""
    return (dh % 4 == 0 and N % 4 == 0 and chunk % 4 == 0
            and chunk % row_tile(chunk) == 0 and chunk % state_tile(chunk) == 0)


def _chunk(x, dt, A, B, C, chunk: int) -> int:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 \
            or B.shape != C.shape:
        raise ValueError(f"ssd_scan takes x [b,s,nh,dh], dt [b,s,nh], A [nh], "
                         f"B, C [b,s,N]; got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    b, s, nh, _ = x.shape
    if tuple(dt.shape) != (b, s, nh) or A.shape[0] != nh or B.shape[:2] != (b, s):
        raise ValueError("ssd_scan: dt, A, B and C do not fit x")
    L = min(chunk, s)
    if L <= 0 or s % L:
        raise ValueError(f"chunk must divide the sequence: s={s} chunk={L}")
    return L


def chunk_cumsum(dt: torch.Tensor, A: torch.Tensor, chunk: int) -> torch.Tensor:
    """cs [b, s, nh] f32: the running sum of dt * A within each chunk, one
    row after another (the order the kernel adds in, so both round alike)."""
    b, s, nh = dt.shape
    dA = (dt.float() * A.float()).view(b, s // chunk, chunk, nh)
    cs = torch.empty_like(dA)
    acc = torch.zeros_like(dA[:, :, 0])
    for l in range(chunk):
        acc = acc + dA[:, :, l]
        cs[:, :, l] = acc
    return cs.view(b, s, nh)


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 256,
                   initial_state: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan in plain torch over the kernel's chunks; returns
    (y [b,s,nh,dh] in x's dtype, final_state [b,nh,dh,N] f32)."""
    L = _chunk(x, dt, A, B, C, chunk)
    b, s, nh, dh = x.shape
    N = B.shape[-1]
    nc = s // L
    # the wgmma kernel feeds x * w and S_prev to the tensor cores in bf16
    rnd = ((lambda t: t.to(torch.bfloat16).float())
           if route(x.dtype, L, dh, N) == "wgmma" else (lambda t: t))
    cs = chunk_cumsum(dt, A, L).view(b, nc, L, nh)
    xc = x.float().view(b, nc, L, nh, dh)
    dtc = dt.float().view(b, nc, L, nh)
    Bc = B.float().view(b, nc, L, N)
    Cc = C.float().view(b, nc, L, N)

    # intra-chunk term, one head at a time (C.B^T is shared by all heads)
    G = Cc @ Bc.transpose(-1, -2)  # [b, nc, L, S]
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    y_intra = torch.empty(b, nc, L, nh, dh, dtype=torch.float32, device=x.device)
    for h in range(nh):
        csh = cs[..., h]
        diff = (csh[..., :, None] - csh[..., None, :]).masked_fill(~causal, -torch.inf)
        att = G * torch.exp(diff)
        y_intra[..., h, :] = att @ (xc[..., h, :] * dtc[..., h, None])

    # the chunk's own state and decay, then the recurrence over chunks
    w = dtc * torch.exp(cs[:, :, -1:, :] - cs)  # [b, nc, L, nh]
    S_loc = torch.einsum("bcln,bclhp->bchpn", Bc, rnd(xc * w[..., None]))
    decay = torch.exp(cs[:, :, -1, :])  # [b, nc, nh]
    S = (torch.zeros(b, nh, dh, N, dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    S_prev = torch.empty(b, nc, nh, dh, N, dtype=torch.float32, device=x.device)
    for c in range(nc):
        S_prev[:, c] = S
        S = S * decay[:, c, :, None, None] + S_loc[:, c]

    # inter-chunk term
    y_inter = torch.einsum("bcln,bchpn->bclhp", Cc, rnd(S_prev)) * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(b, s, nh, dh).to(x.dtype)
    return y, S


def ssd_scan_cuda(x, dt, A, B, C, *, chunk: int = 256,
                  initial_state: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan on x's card, through the kernel :func:`route` names."""
    L = _chunk(x, dt, A, B, C, chunk)
    b, s, nh, dh = x.shape
    N = B.shape[-1]
    dev = x.device
    if not (x.is_cuda and all(t.device == dev for t in (dt, A, B, C))
            and dt.dtype == x.dtype and B.dtype == x.dtype and C.dtype == x.dtype
            and A.dtype == torch.float32):
        raise ValueError("ssd_scan_cuda takes x, dt, B, C of one dtype and A "
                         "in float32, all on one card")
    if not all(t.is_contiguous() for t in (x, dt, A, B, C)):
        raise ValueError("ssd_scan_cuda takes contiguous tensors")
    path = route(x.dtype, L, dh, N)
    if path == "fma" and not supported(L, N, dh):
        raise ValueError(f"ssd_scan_cuda takes dh and N multiples of 4 and a "
                         f"chunk of at most 32 (a multiple of 4), 64 or a "
                         f"multiple of 64; got dh={dh}, N={N}, chunk={L}")
    s0 = None
    if initial_state is not None:
        if tuple(initial_state.shape) != (b, nh, dh, N) or initial_state.device != dev:
            raise ValueError(f"initial_state must be [b,nh,dh,N] = "
                             f"{(b, nh, dh, N)} on x's card")
        s0 = initial_state.float().contiguous()
    s0_ptr = s0.data_ptr() if s0 is not None else None
    code = _build.dtype_code(x)
    cs = torch.empty(b, s, nh, dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    S = torch.empty(b, nh, dh, N, dtype=torch.float32, device=dev)
    lib = _build.library()
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            s0_ptr, cs.data_ptr())
    if path == "wgmma":
        err = lib.ssd_scan_wgmma_launch(
            *ptrs, y.data_ptr(), S.data_ptr(), b, s, nh, dh, N, L, wgmma_threads(L, N, dh),
            smem_bytes_wgmma(L, N, dh), _build.stream_ptr(dev))
        _build.check("ssd_scan_wgmma_launch", err)
    else:
        y_inter = torch.empty(b, s, nh, dh, dtype=torch.float32, device=dev)
        err = lib.ssd_scan_launch(
            *ptrs, y_inter.data_ptr(), y.data_ptr(), S.data_ptr(), b, s, nh, dh, N,
            L, row_tile(L), state_tile(L), state_slice(dh), code, THREADS,
            smem_bytes_intra(L, N, dh), smem_bytes_state(L, N, dh),
            _build.stream_ptr(dev))
        _build.check("ssd_scan_launch", err)
    _build.LAUNCHES["ssd_scan"] += 1
    _build.LAUNCHES[f"ssd_scan/{path}"] += 1
    return y, S


def wgmma_attributes(chunk: int, N: int, dh: int = 64) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) the compiler gave the
    wgmma kernel at this size; builds the library. Raises for a size that
    is not instantiated."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _build.library().ssd_scan_wgmma_attributes(
        dh, N, chunk, ctypes.byref(regs), ctypes.byref(local))
    _build.check("ssd_scan_wgmma_attributes", err)
    return regs.value, local.value
