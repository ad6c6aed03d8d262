"""The kernel design space: tile points and their device-aware template.

Counterpart of the kernel half of ``repro/core/design_space.py``
(``PlanPoint``, ``KernelPoint``, ``baseline_kernel_point``,
``KernelTemplate``). ``validate`` keeps the reference's pinned messages for
unknown dims and out-of-pool values; its device bound is the shared memory
a block may have on the H100, where the reference bounds TPU VMEM.
``neighbors`` yields in the reference's order, and ``random_points`` makes
the reference's draws in the reference's order.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

from repro_torch.core import kernel_space
from repro_torch.core.device import H100_SXM, DeviceModel
from repro_torch.core.kernel_space import (KernelShape, default_kernel_dims,
                                           legal_kernel_dims)


@dataclass(frozen=True)
class PlanPoint:
    """One candidate configuration = assignments over design dimensions."""

    dims: Mapping[str, Any]

    def key(self) -> str:
        blob = json.dumps(dict(sorted(self.dims.items())), sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def to_dict(self):
        return dict(self.dims)


@dataclass(frozen=True)
class KernelPoint(PlanPoint):
    """A kernel-space candidate: assignments over one kernel's tile dims.

    Shares ``PlanPoint``'s key/serialization contract so the CostDB,
    caches, and search strategies treat both spaces identically.
    """


def baseline_kernel_point(shape: KernelShape,
                          template: Optional["KernelTemplate"] = None
                          ) -> KernelPoint:
    """The expert initial design for a kernel cell: the shipped defaults,
    snapped into the shape's legal pools and, with a template, repaired to
    fit the device."""
    p = KernelPoint(dims=default_kernel_dims(shape))
    if template is not None:
        p = template.repair(p)
    return p


@dataclass
class KernelTemplate:
    """Device-aware legal tile ranges for one kernel workload shape: the
    same ``dims`` / ``validate`` / ``neighbors`` / ``repair`` /
    ``random_points`` surface as the reference's, with legality meaning
    grid divisibility plus a launch the H100 accepts (shared memory per
    block and threads per block, from the Hopper resource model)."""

    kshape: KernelShape
    device: DeviceModel = H100_SXM

    def dims(self) -> Dict[str, Tuple]:
        """Legal pools, divisibility-filtered against the workload shape."""
        return legal_kernel_dims(self.kshape)

    def _resources(self, dims: Mapping[str, Any]):
        return kernel_space.kernel_resources(self.kshape, dims, self.device)

    def validate(self, point: PlanPoint) -> Tuple[bool, str]:
        """(ok, reason): unknown dims and out-of-pool values give the
        reference's pinned messages; the device constraint is the shared
        memory and threads one block of the port's kernel needs."""
        legal = self.dims()
        for k, v in point.dims.items():
            if k not in legal:
                return False, f"unknown dimension {k}"
            if v not in legal[k]:
                return False, f"{k}={v!r} outside device-aware range {legal[k]}"
        res = self._resources(point.dims)
        if not res.feasible:
            if res.vmem_bytes > self.device.smem_per_block:
                return False, (f"shared memory {res.vmem_bytes} B per block "
                               f"exceeds {self.device.smem_per_block} B limit")
            return False, (f"{res.threads} threads per block outside "
                           f"1..{self.device.max_threads_per_block}")
        return True, ""

    def neighbors(self, point: PlanPoint) -> Iterator[PlanPoint]:
        """Single-dimension mutations, filtered to validity (closure
        property: every yielded point passes ``validate``)."""
        legal = self.dims()
        for k, vals in legal.items():
            for v in vals:
                if v != point.dims.get(k):
                    cand = KernelPoint(dims={**point.dims, k: v})
                    ok, _ = self.validate(cand)
                    if ok:
                        yield cand

    def repair(self, point: PlanPoint) -> KernelPoint:
        """Snap a candidate into the template: unknown dims are dropped,
        out-of-pool values fall back to the shipped default, and block
        dims shrink (largest first) until the block fits the device."""
        legal = self.dims()
        dims = dict(default_kernel_dims(self.kshape))
        for k, v in point.dims.items():
            if k in legal and v in legal[k]:
                dims[k] = v
        while not self._resources(dims).feasible:
            shrinkable = [(k, [v for v in legal[k]
                               if isinstance(v, int) and v < dims[k]])
                          for k in dims if isinstance(dims[k], int)]
            shrinkable = [(k, vs) for k, vs in shrinkable if vs]
            if not shrinkable:
                break  # nothing left to shrink; validate() will reject
            k, vs = max(shrinkable, key=lambda kv: dims[kv[0]])
            dims[k] = max(vs)
        return KernelPoint(dims=dims)

    def random_points(self, rng, n: int) -> List[KernelPoint]:
        """n uniform samples over the legal pools, each repaired to a
        valid point (closure property shared with ``neighbors``)."""
        legal = self.dims()
        keys = sorted(legal)
        out = []
        for _ in range(n):
            p = KernelPoint(dims={k: legal[k][rng.randrange(len(legal[k]))]
                                  for k in keys})
            out.append(self.repair(p))
        return out
