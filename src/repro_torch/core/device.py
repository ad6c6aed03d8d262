"""GPU device models: the 'target device' input of SECDA-DSE, for Hopper.

Counterpart of ``repro/core/device.py``. The kernel resource model budgets
each candidate tile against these constants, and ``roofline_terms`` turns
FLOPs and bytes into the three roofline times.

``H100_SXM`` cites NVIDIA's H100 Tensor Core GPU data sheet (SXM5 part,
dense rates without sparsity, at the 700 W power limit) and the Hopper
architecture white paper for the per-SM limits.

``H100_CLUSTER`` is the same card in a DGX H100 style cluster, the plan
cells' target: 8 cards per node joined by NVLink 4 through NVSwitch, 450
GB/s per direction per card (the H100 data sheet's 900 GB/s is both
directions), and one 400 Gb/s ConnectX-7 NIC per card between nodes, 50
GB/s per direction (the DGX H100 system's eight single-port OSFP
compute-fabric links, one per card). ``roofline_terms`` charges each collective by its
group: one that stays inside a node goes at the NVLink rate, one that
crosses nodes at the NIC rate. (The reference charges every collective at
one ICI link rate, ``repro/core/device.py``.)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class DeviceModel:
    name: str
    peak_flops_bf16: float  # FLOP/s, dense tensor cores
    peak_flops_fp32: float  # FLOP/s, CUDA cores (non-tensor)
    hbm_bytes: int
    hbm_bw: float  # B/s
    link_bw: float  # B/s per direction to the other cards (NVLink)
    sm_count: int
    smem_per_block: int  # largest dynamic shared memory one block may ask for
    smem_per_sm: int  # shared memory one SM divides among its resident blocks
    smem_reserved_per_block: int  # the runtime's own share of each block
    l2_bytes: int
    clock_hz: float  # SM boost clock
    max_threads_per_block: int = 1024
    max_threads_per_sm: int = 2048
    max_blocks_per_sm: int = 32
    regs_per_sm: int = 65_536  # 32-bit registers an SM divides among its blocks
    cards_per_node: int = 1  # cards one NVLink domain joins
    nic_bw: float = 0.0  # B/s per direction per card between nodes

    def link_class(self, ranks) -> str:
        """``"nvlink"`` for a group of ranks that lies inside one node,
        ``"nic"`` for one that crosses nodes (ranks fill nodes in order)."""
        nodes = {r // self.cards_per_node for r in ranks}
        return "nvlink" if len(nodes) <= 1 else "nic"


H100_SXM = DeviceModel(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    peak_flops_fp32=67e12,
    hbm_bytes=80 * 10**9,
    hbm_bw=3.35e12,
    link_bw=450e9,
    sm_count=132,
    smem_per_block=232_448,  # 227 KB
    smem_per_sm=233_472,  # 228 KB
    smem_reserved_per_block=1024,
    l2_bytes=50 * 2**20,
    clock_hz=1.98e9,  # max boost clock of the SXM5 part
)


#: the plan cells' target: H100 SXM cards, 8 per node on NVLink 4, one
#: 400 Gb/s NIC per card between nodes (see the module docstring)
H100_CLUSTER = dataclasses.replace(H100_SXM, name="h100-sxm-dgx-cluster",
                                   cards_per_node=8, nic_bw=400e9 / 8)


def peak_flops(device: DeviceModel, dtype: str) -> float:
    """The card's peak rate for arithmetic on ``dtype`` ("bfloat16" on the
    tensor cores, "float32" on the CUDA cores)."""
    return device.peak_flops_bf16 if dtype == "bfloat16" else device.peak_flops_fp32


@dataclass(frozen=True)
class RooflineTerms:
    """The three roofline terms, in seconds (per step)."""

    compute_s: float
    memory_s: float
    collective_s: float

    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def bound(self) -> float:
        """Roofline step-time lower bound (perfect overlap of the 3 engines)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self):
        return dataclasses.asdict(self) | {"dominant": self.dominant(), "bound_s": self.bound()}


def roofline_terms(*, flops: float, hbm_bytes: float, wire_bytes: float,
                   device: DeviceModel = H100_SXM,
                   dtype: str = "bfloat16",
                   nic_wire_bytes: float = 0.0) -> RooflineTerms:
    """All inputs are per-device totals for one step; ``dtype`` picks the
    peak rate the FLOPs run at. ``wire_bytes`` go at the NVLink rate and
    ``nic_wire_bytes`` (collectives whose group crosses nodes) at the NIC
    rate."""
    collective_s = wire_bytes / device.link_bw
    if nic_wire_bytes:
        collective_s += nic_wire_bytes / device.nic_bw
    return RooflineTerms(
        compute_s=flops / peak_flops(device, dtype),
        memory_s=hbm_bytes / device.hbm_bw,
        collective_s=collective_s,
    )


def resolve_device(name: str):
    """The torch device an entry point runs on: ``cuda`` unless the caller
    asked for ``cpu``. Raises when ``cuda`` is asked for and there is no
    card; it never falls back to the CPU."""
    import torch

    if name == "cpu":
        return torch.device("cpu")
    if not name.startswith("cuda"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} asked for, but torch sees no "
                           f"CUDA card; pass device 'cpu' to run the plain "
                           f"versions on the CPU")
    return torch.device(name)
