"""Analytic kernel resource model for Hopper: the HLS resource-report analog.

Counterpart of ``repro/kernels/resource_model.py``, which budgets TPU VMEM.
For each candidate tile of a port kernel it reports:

* ``vmem_bytes``: the dynamic shared memory the port's kernel asks for at
  this tile (the kernel modules' ``smem_bytes``, the same function the
  launch calls), and ``vmem_util``, its share of the 232,448 B a block may
  have (the BRAM-utilization analog; the names stay because
  ``cost_db.derive_objectives`` reads ``vmem_util``);
* ``feasible``: that figure fits one block, the thread count is legal and
  the kernel has the tile (the wgmma route takes only the tiles it is
  instantiated for), so the DSE never proposes a tile that cannot launch;
* ``route``: which kernel (or kernel path) runs the tile, by the same rule
  the wrapper applies before its launch, and ``regs_per_thread``, the
  modelled registers, which only set the blocks resident per SM (0 where
  the model does not count them);
* ``mxu_aligned``: the tile is ``wgmma``-aligned (a multiple of 64 rows,
  d % 16 == 0); kernels with no matrix product report True;
* ``vpu_aligned``: rows are whole 16-byte vectors;
* ``est_latency_us``: blocks in waves over the SMs at the occupancy that
  shared memory and threads allow, each wave taking one block's
  max(compute, bytes) time, with the card's compute rate (f32 on the CUDA
  cores; bf16 on the tensor cores for the wgmma route) and memory rate
  split evenly among the resident blocks but never more than one SM's
  share to a block. Resident blocks per SM are what shared memory,
  threads and registers allow. Each ``csrc/*.cu`` states its terms.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.core.device import H100_SXM, DeviceModel
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import vecmul as _vm


@dataclass(frozen=True)
class KernelResources:
    name: str
    vmem_bytes: int  # dynamic shared memory per block
    vmem_util: float  # fraction of the per-block limit
    mxu_aligned: bool
    vpu_aligned: bool
    est_cycles_per_block: float
    est_latency_us: float  # whole-kernel latency estimate
    feasible: bool
    notes: str = ""
    threads: int = 0  # threads per block
    blocks_per_sm: int = 0  # resident blocks per SM at this tile
    regs_per_thread: int = 0  # modelled; 0 where not counted
    route: str = ""  # the kernel or path that runs this tile

    def to_dict(self):
        return dataclasses.asdict(self)


def blocks_per_sm(smem: int, threads: int, dev: DeviceModel, regs: int = 0) -> int:
    """Resident blocks per SM allowed by shared memory, threads and, when
    ``regs`` (per thread) is given, the register file."""
    by_smem = dev.smem_per_sm // (smem + dev.smem_reserved_per_block)
    by_threads = dev.max_threads_per_sm // max(threads, 1)
    by_regs = dev.regs_per_sm // (regs * threads) if regs else dev.max_blocks_per_sm
    return max(0, min(by_smem, by_threads, by_regs, dev.max_blocks_per_sm))


def _launch_time(*, smem, threads, n_blocks, flops, nbytes, dev: DeviceModel,
                 regs: int = 0, peak: float = 0.0) -> Tuple[float, float]:
    """(one block's seconds, the launch's seconds): blocks in waves over
    the SMs, the card's rates split evenly among the blocks resident at
    once, and a block never getting more than one SM's share. ``peak`` is
    the compute rate (default: f32 on the CUDA cores)."""
    occ = max(blocks_per_sm(smem, threads, dev, regs), 1)
    resident = dev.sm_count * occ
    waves = math.ceil(n_blocks / resident)
    share = max(min(n_blocks, resident), dev.sm_count)
    t_block = max(flops / n_blocks / ((peak or dev.peak_flops_fp32) / share),
                  nbytes / n_blocks / (dev.hbm_bw / share))
    return t_block, waves * t_block


def _fits(smem: int, threads: int, dev: DeviceModel) -> bool:
    return smem <= dev.smem_per_block and 1 <= threads <= dev.max_threads_per_block


def _mk(name, *, smem, threads, n_blocks, flops, nbytes, aligned_mma,
        aligned_vec, dev: DeviceModel, notes="", regs: int = 0, peak: float = 0.0,
        route: str = "") -> KernelResources:
    t_block, total = _launch_time(smem=smem, threads=threads, n_blocks=n_blocks,
                                  flops=flops, nbytes=nbytes, dev=dev, regs=regs,
                                  peak=peak)
    return KernelResources(
        name=name,
        vmem_bytes=smem,
        vmem_util=smem / dev.smem_per_block,
        mxu_aligned=aligned_mma,
        vpu_aligned=aligned_vec,
        est_cycles_per_block=t_block * dev.clock_hz,
        est_latency_us=total * 1e6,
        feasible=_fits(smem, threads, dev),
        notes=notes,
        threads=threads,
        blocks_per_sm=blocks_per_sm(smem, threads, dev, regs),
        regs_per_thread=regs,
        route=route,
    )


def _round8(n: float) -> int:
    return int(math.ceil(n / 8)) * 8


def flash_wgmma_registers(block_k: int, d: int) -> int:
    """Registers per thread the model gives the wgmma kernel, for its
    blocks per SM: S (bk/2 f32), O (d/2 f32), P in bf16 (bk/4) and 48 for
    addresses, m, l and the loop, rounded up to 8 (block_q sets the thread
    count, not this)."""
    return _round8(block_k / 2 + d / 2 + block_k / 4 + 48)


def rmsnorm_registers(d: int, itemsize: int) -> int:
    """Registers per thread the model gives the rmsnorm kernel: 4 per
    16-byte vector held on the register path, plus 32; 40 on the others."""
    if _rn.path(d, itemsize) != "registers":
        return 40
    return _round8(4 * _rn.vectors_per_lane(d, itemsize) + 32)


def vecmul_resources(L: int, block: int, itemsize: int = 4,
                     dev: DeviceModel = H100_SXM) -> KernelResources:
    n_blocks = max((L + block - 1) // block, 1)
    return _mk(
        "vecmul", smem=_vm.smem_bytes(), threads=_vm.threads(block, itemsize),
        n_blocks=n_blocks, flops=n_blocks * block,
        nbytes=3 * n_blocks * block * itemsize,
        aligned_mma=True,  # no matrix product
        aligned_vec=(block * itemsize) % 16 == 0,
        dev=dev, notes=f"L={L} block={block}")


def rmsnorm_resources(rows: int, d: int, block_rows: int, itemsize: int = 2,
                      dev: DeviceModel = H100_SXM) -> KernelResources:
    n_blocks = max((rows + block_rows - 1) // block_rows, 1)
    return _mk(
        "rmsnorm", smem=_rn.smem_bytes(d), threads=_rn.THREADS,
        n_blocks=n_blocks, flops=4 * rows * d,
        # each block reads its rows and w once, writes its rows once
        nbytes=(2 * rows * d + n_blocks * d) * itemsize,
        aligned_mma=True,  # no matrix product
        aligned_vec=(d * itemsize) % 16 == 0,
        dev=dev, notes=f"rows={rows} d={d} block_rows={block_rows}",
        regs=rmsnorm_registers(d, itemsize), route=_rn.path(d, itemsize))


_DTYPE_OF_ITEMSIZE = {2: torch.bfloat16, 4: torch.float32}


def flash_attention_resources(b: int, sq: int, sk: int, h: int, kh: int, d: int,
                              block_q: int, block_k: int, itemsize: int = 2,
                              dev: DeviceModel = H100_SXM, *,
                              causal: bool = True,
                              q_offset: int = 0) -> KernelResources:
    n_qt = max(sq // max(block_q, 1), 1)
    n_blocks = b * h * n_qt
    walked = sum(_fa.k_tiles_walked(qt, block_q, block_k, sk, causal=causal,
                                    q_offset=q_offset) for qt in range(n_qt))
    # every walked tile costs its full QK^T and PV: the kernel computes
    # masked entries too
    flops = b * h * walked * 4 * block_q * block_k * d
    nbytes = b * h * (2 * sq * d + walked * 2 * block_k * d) * itemsize
    route = _fa.route(_DTYPE_OF_ITEMSIZE[itemsize], d, min(block_q, sq),
                      min(block_k, sk))
    if route == "wgmma":
        # the route takes only instantiated tiles; registers set occupancy
        launch = dict(smem=_fa.smem_bytes_wgmma(block_q, block_k, d),
                      threads=_fa.wgmma_threads(block_q),
                      regs=flash_wgmma_registers(block_k, d),
                      peak=dev.peak_flops_bf16)
    else:
        launch = dict(smem=_fa.smem_bytes(block_q, block_k, d, itemsize),
                      threads=_fa.THREADS)
    return _mk(
        "flash_attention", n_blocks=n_blocks, flops=flops, nbytes=nbytes,
        aligned_mma=(block_q % 64 == 0 and block_k % 16 == 0 and d % 16 == 0),
        aligned_vec=(d * itemsize) % 16 == 0, dev=dev, route=route,
        notes=f"bq={block_q} bk={block_k} d={d} sk={sk} causal={causal}",
        **launch)


#: registers per thread the model gives the SSD wgmma kernel, for its
#: blocks per SM: a warpgroup's 64 columns of the state, the y tile and G
#: (32 f32 each), P's two bf16 parts (32) and 48 for addresses, cs and loops
SSD_WGMMA_REGISTERS = 32 + 32 + 32 + 32 + 48


def ssd_scan_resources(b: int, s: int, nh: int, dh: int, N: int, chunk: int,
                       itemsize: int = 2, dev: DeviceModel = H100_SXM,
                       ) -> KernelResources:
    """The launches of the route the wrapper takes at one chunk length
    (``ssd_scan.route``), their times added: on ``wgmma`` the chunk cumsum
    and one chunk walk per (batch, head) on the tensor cores
    (``csrc/ssd_scan_wgmma.cu``); on ``fma`` the cumsum, the state walk and
    the intra-chunk kernel of ``csrc/ssd_scan.cu``. ``vmem_bytes`` is the
    largest block's shared memory."""
    L = min(chunk, s)
    nc = s // L
    route = _ssd.route(_DTYPE_OF_ITEMSIZE[itemsize], L, dh, N)
    # cumsum: one thread per (batch, chunk, head), 256 a block
    cumsum = dict(smem=0, threads=256, n_blocks=max(math.ceil(b * nc * nh / 256), 1),
                  flops=2 * b * s * nh, nbytes=b * s * nh * (itemsize + 4))
    if route == "wgmma":
        n_rt = L // 64
        pairs = n_rt * (n_rt + 1) // 2  # 64 x 64 tiles at or below the diagonal
        smem = _ssd.smem_bytes_wgmma(L, N, dh)
        threads = _ssd.wgmma_threads(L, N, dh)
        # where two CTAs share an SM, the launch bounds cap the registers at
        # what two allow
        regs = min(SSD_WGMMA_REGISTERS,
                   dev.regs_per_sm // (_ssd.wgmma_ctas_per_sm(L, N, dh) * threads) // 8 * 8)
        walk = dict(
            smem=smem, threads=threads, n_blocks=b * nh, regs=regs,
            peak=dev.peak_flops_bf16,
            # per chunk: C.S_prev^T and the state update, then G and P.x
            # (twice: P's hi and lo parts) over whole diagonal tiles, G
            # recomputed for every head
            flops=b * nh * nc * (4 * L * dh * N + pairs * 2 * 64 * 64 * (N + 2 * dh)),
            # x read and y written once; B and C once (the heads of a batch
            # share them in L2); cs and dt read; the final state written
            nbytes=(2 * b * s * nh * dh * itemsize + 2 * b * s * N * itemsize
                    + b * s * nh * (4 + itemsize) + 4 * b * nh * dh * N))
        launches = [cumsum, walk]
        feasible = _fits(smem, threads, dev)
        occupancy = blocks_per_sm(smem, threads, dev, regs)
    else:
        tl, ps = _ssd.row_tile(L), max(_ssd.state_slice(dh), 1)
        n_rt = L // tl
        walked = n_rt * (n_rt + 1) // 2  # s tiles the row tiles of a chunk walk
        smem_i = _ssd.smem_bytes_intra(L, N, dh)
        smem_s = _ssd.smem_bytes_state(L, N, dh)
        threads = _ssd.THREADS
        launches = [
            cumsum,
            # state walk + inter-chunk term: x, B, C, dt, cs read, y_inter
            # written in f32, the final state written
            dict(smem=smem_s, threads=threads, n_blocks=b * nh * (dh // ps),
                 flops=4 * b * s * nh * dh * N + 2 * b * nc * nh * dh * N,
                 nbytes=(b * s * nh * dh * (itemsize + 4)
                         + b * s * (2 * N * itemsize + nh * (itemsize + 4))
                         + b * nh * dh * N * 4)),
            # intra-chunk term: C.B^T once per row tile, then per head the
            # masked decay tile and its product with dt*x, over the s tiles at
            # or below the diagonal; y_inter read, y written
            dict(smem=smem_i, threads=threads, n_blocks=b * nc * n_rt,
                 flops=b * nc * walked * tl * tl * (2 * N + nh * (2 * dh + 4)),
                 nbytes=b * nc * (walked * tl * (nh * dh * itemsize
                                                 + nh * (itemsize + 4) + N * itemsize)
                                  + L * N * itemsize + L * nh * dh * (4 + itemsize))),
        ]
        smem = max(smem_i, smem_s)
        feasible = (_ssd.supported(L, N, dh) and _fits(smem_i, threads, dev)
                    and _fits(smem_s, threads, dev))
        regs = 0
        occupancy = blocks_per_sm(smem_i, threads, dev)
    times = [_launch_time(dev=dev, **k) for k in launches]
    return KernelResources(
        name="ssd_scan",
        vmem_bytes=smem,
        vmem_util=smem / dev.smem_per_block,
        mxu_aligned=(L % 64 == 0 and dh % 16 == 0),
        vpu_aligned=(dh * itemsize) % 16 == 0,
        est_cycles_per_block=sum(t for t, _ in times) * dev.clock_hz,
        est_latency_us=sum(total for _, total in times) * 1e6,
        feasible=feasible,
        notes=f"chunk={L} nh={nh} dh={dh} N={N}",
        threads=threads,
        blocks_per_sm=occupancy,
        regs_per_thread=regs,
        route=route,
    )


RESOURCE_FNS = {
    "vecmul": vecmul_resources,
    "rmsnorm": rmsnorm_resources,
    "flash_attention": flash_attention_resources,
    "ssd_scan": ssd_scan_resources,
}
