"""Kernel design space registry: shapes, tile pools, defaults, resources.

Counterpart of ``repro/core/kernel_space.py``, copied (the port imports
nothing of ``repro``). The pools, the shipped defaults, the six CI shapes
and the ``kernel:<name>`` arch-column encoding are the reference's as they
are. The port adds full-width shapes at llama3-8b widths
(``configs/llama3_8b.py``: d_model 4096, 32 heads, 8 KV heads, d_head 128)
and at mamba2-780m widths for the SSD scan, and :func:`kernel_resources`
runs the Hopper resource model.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.device import H100_SXM, DeviceModel
from repro_torch.kernels.resource_model import RESOURCE_FNS, KernelResources

#: arch-column prefix that marks a row/ticket/report as a kernel cell
KERNEL_ARCH_PREFIX = "kernel:"

#: bytes per element for the dtypes the kernel space explores
_ITEMSIZE = {"float32": 4, "bfloat16": 2}

#: candidate pools per tunable dimension, before per-shape filtering
_POOLS: Dict[str, Dict[str, Tuple[Any, ...]]] = {
    "flash_attention": {"block_q": (64, 128, 256, 512),
                        "block_k": (64, 128, 256, 512),
                        "causal": (True, False)},
    "rmsnorm": {"block_rows": (32, 64, 128, 256)},
    "ssd_scan": {"chunk": (32, 64, 128, 256)},
    "vecmul": {"block": (256, 512, 1024, 2048, 4096)},
}

#: the frozen-default point each kernel ships with (``ops.py`` signatures),
#: snapped down to the largest legal value for small shapes
_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "flash_attention": {"block_q": 512, "block_k": 512, "causal": True},
    "rmsnorm": {"block_rows": 128},
    "ssd_scan": {"chunk": 256},
    "vecmul": {"block": 1024},
}

@dataclass(frozen=True)
class KernelShape:
    """One kernel workload instance: problem sizes + dtype.

    ``params`` keys per kernel: flash_attention ``b,sq,sk,h,kh,d``;
    rmsnorm ``rows,d``; ssd_scan ``b,s,nh,dh,N``; vecmul ``L``.
    """

    name: str
    kernel: str
    params: Mapping[str, int] = field(default_factory=dict)
    dtype: str = "float32"

    @property
    def itemsize(self) -> int:
        """Bytes per element of the working dtype."""
        return _ITEMSIZE[self.dtype]


#: the reference's CI-sized shapes, unchanged
CI_KERNEL_SHAPES: Tuple[KernelShape, ...] = (
    KernelShape("attn_s128_f32", "flash_attention",
                {"b": 2, "sq": 128, "sk": 128, "h": 4, "kh": 4, "d": 64},
                "float32"),
    KernelShape("attn_s256_gqa_bf16", "flash_attention",
                {"b": 1, "sq": 256, "sk": 256, "h": 4, "kh": 2, "d": 64},
                "bfloat16"),
    KernelShape("rms_512x512_f32", "rmsnorm",
                {"rows": 512, "d": 512}, "float32"),
    KernelShape("rms_1kx256_bf16", "rmsnorm",
                {"rows": 1024, "d": 256}, "bfloat16"),
    KernelShape("ssd_s256_f32", "ssd_scan",
                {"b": 1, "s": 256, "nh": 4, "dh": 32, "N": 32}, "float32"),
    KernelShape("vec_64k_f32", "vecmul", {"L": 65536}, "float32"),
)

#: full-width shapes: one llama3-8b prefill of 4096 tokens (attention),
#: its rmsnorm over 8192 rows of d_model, one mamba2-780m SSD scan of 8
#: sequences of 4096 tokens (``configs/mamba2_780m.py``: d_model 1536,
#: expand 2, head_dim 64 -> 48 heads, d_state 128), and a 16M-element vecmul
FULL_WIDTH_KERNEL_SHAPES: Tuple[KernelShape, ...] = (
    KernelShape("attn_llama3_8b_s4096_bf16", "flash_attention",
                {"b": 1, "sq": 4096, "sk": 4096, "h": 32, "kh": 8, "d": 128},
                "bfloat16"),
    KernelShape("rms_llama3_8b_8kx4096_bf16", "rmsnorm",
                {"rows": 8192, "d": 4096}, "bfloat16"),
    KernelShape("ssd_mamba2_780m_b8_s4096_bf16", "ssd_scan",
                {"b": 8, "s": 4096, "nh": 48, "dh": 64, "N": 128}, "bfloat16"),
    KernelShape("vec_16m_f32", "vecmul", {"L": 16_777_216}, "float32"),
)

KERNEL_SHAPES: Tuple[KernelShape, ...] = CI_KERNEL_SHAPES + FULL_WIDTH_KERNEL_SHAPES

KERNEL_SHAPE_BY_NAME: Dict[str, KernelShape] = {
    s.name: s for s in KERNEL_SHAPES}

KERNEL_NAMES: Tuple[str, ...] = tuple(sorted(_POOLS))


def kernel_arch(kernel: str) -> str:
    """Encode a kernel name into the CostDB/queue ``arch`` column."""
    return KERNEL_ARCH_PREFIX + kernel


def parse_kernel_arch(arch: str) -> Optional[str]:
    """Inverse of :func:`kernel_arch`; None for plan-space arch ids."""
    if arch.startswith(KERNEL_ARCH_PREFIX):
        return arch[len(KERNEL_ARCH_PREFIX):]
    return None


def legal_kernel_dims(shape: KernelShape) -> Dict[str, Tuple[Any, ...]]:
    """Per-shape legal pools: block dims that must divide a sequence axis
    (flash ``block_q``/``block_k``, ssd ``chunk``) are filtered to exact
    divisors no larger than the axis; rmsnorm/vecmul mask their ragged
    tail, so their pools pass through unfiltered."""
    pools = dict(_POOLS[shape.kernel])
    p = shape.params
    if shape.kernel == "flash_attention":
        pools["block_q"] = tuple(v for v in pools["block_q"]
                                 if v <= p["sq"] and p["sq"] % v == 0)
        pools["block_k"] = tuple(v for v in pools["block_k"]
                                 if v <= p["sk"] and p["sk"] % v == 0)
    elif shape.kernel == "ssd_scan":
        pools["chunk"] = tuple(v for v in pools["chunk"]
                               if v <= p["s"] and p["s"] % v == 0)
    return pools


def tile_grid(shape: KernelShape) -> List[Dict[str, Any]]:
    """Every legal tile point of a shape, as dims dicts: the product of the
    legal pools, keys in sorted order."""
    pools = legal_kernel_dims(shape)
    keys = sorted(pools)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(pools[k] for k in keys))]


def kernel_resources(shape: KernelShape, dims: Mapping[str, Any],
                     device: DeviceModel = H100_SXM) -> KernelResources:
    """Run the Hopper resource model for one candidate point: the
    feasibility check and latency estimate for kernel cells."""
    fn = RESOURCE_FNS[shape.kernel]
    p = shape.params
    if shape.kernel == "vecmul":
        return fn(p["L"], int(dims["block"]),
                  itemsize=shape.itemsize, dev=device)
    if shape.kernel == "rmsnorm":
        return fn(p["rows"], p["d"], int(dims["block_rows"]),
                  itemsize=shape.itemsize, dev=device)
    if shape.kernel == "ssd_scan":
        return fn(p["b"], p["s"], p["nh"], p["dh"], p["N"], int(dims["chunk"]),
                  itemsize=shape.itemsize, dev=device)
    return fn(p["b"], p["sq"], p["sk"], p["h"], p["kh"], p["d"],
              int(dims["block_q"]), int(dims["block_k"]),
              itemsize=shape.itemsize, dev=device,
              causal=bool(dims.get("causal", True)))


def default_kernel_dims(shape: KernelShape) -> Dict[str, Any]:
    """The shipped-default point for a shape, snapped into the legal
    pools (e.g. ``block_q=512`` becomes 128 on a 128-long sequence —
    exactly what the kernel's own min-clamp would run)."""
    legal = legal_kernel_dims(shape)
    out: Dict[str, Any] = {}
    for k, default in _DEFAULTS[shape.kernel].items():
        pool = legal[k]
        if default in pool:
            out[k] = default
        else:
            smaller = [v for v in pool if isinstance(v, int) and v <= default]
            out[k] = max(smaller) if smaller else pool[0]
    return out


def kernel_workload(shape: KernelShape) -> Dict[str, float]:
    """Map a kernel shape onto the fixed workload-feature keys the cost
    model featurizer reads (missing keys featurize to zero)."""
    p = shape.params
    seq = p.get("sq") or p.get("s") or p.get("rows") or p.get("L") or 0
    elems = 1
    for v in p.values():
        elems *= max(int(v), 1)
    return {
        "n_params": float(elems),
        "seq_len": float(seq),
        "global_batch": float(p.get("b", 1)),
        "d_model": float(p.get("d") or p.get("dh") or 0),
        "is_train": 0.0,
        "is_decode": 0.0,
    }
