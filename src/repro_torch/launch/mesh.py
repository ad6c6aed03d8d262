"""Mesh factory: ``DeviceMesh`` es for the plan cells.

Counterpart of ``repro/launch/mesh.py``. A mesh of more than one device
lives on a *fake* process group (PyTorch's ``"fake"`` backend, whose
collectives do nothing): the dry run resolves plans and traces steps on
16x16 or 2x16x16 devices with none present, as the reference compiles
against forced host devices. Its device type is ``cpu`` and its tensors
are fake: a ``cuda`` type would need a CUDA build of torch for the scalars
DTensor's own code makes on the mesh's device. One cost of that: DTensor
moves a shard from one tensor dim to another on a CPU mesh by all-gather
and chunk, where a GPU mesh uses an all-to-all. The 1x1 mesh is the real card, or the CPU
when the caller asks; it holds every tensor whole, so the steps run on it
with plain tensors.

A process has one default group, so this module owns its lifetime: a
mesh of another size than the current group's tears the group down and
makes one of its own size (rank 0 of ``n``). Meshes made before that are
stale, and so are DTensor's cached sharding decisions, which hold the mesh
they were made on (a spec's mesh compares equal to a new mesh of the same
shape): they are dropped with the group.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

#: ``--mesh`` choice -> (shape, axis names, mesh name): the paper-scale
#: 16x16 (data, model) pod and 2x16x16 multipod, the 2x4 parity mesh and
#: the measured tier's one device
CAMPAIGN_MESHES = {
    "tiny": ((1, 1), ("data", "model"), "tiny1x1"),
    "small": ((2, 4), ("data", "model"), "small2x4"),
    "pod": ((16, 16), ("data", "model"), "pod16x16"),
    "multipod": ((2, 16, 16), ("pod", "data", "model"), "multipod2x16x16"),
}


def _ensure_world(n: int) -> None:
    """A fake default process group of ``n`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        _clear_dtensor_caches()
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _clear_dtensor_caches() -> None:
    """Drop DTensor's cached sharding propagation (the Python caches and,
    where torch has it, the native dispatch cache): its output specs keep
    the mesh (and so the process groups) they were computed on, and would
    be handed back for an equal mesh on a new group."""
    import torch
    from torch.distributed.tensor import DTensor

    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if native is not None:
        native()
    prop = DTensor._op_dispatcher.sharding_propagator
    for name in ("propagate_op_sharding", "_propagate_tensor_meta_cached"):
        clear = getattr(getattr(prop, name, None), "cache_clear", None)
        if clear is not None:
            clear()


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` (tests, reduced dry runs,
    the measured tier). ``device`` is the device type of a one-device mesh
    (``cuda``, the card, or ``cpu``); a larger mesh is always ``cpu``, of
    fake devices."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    _ensure_world(n)
    return init_device_mesh(device if n == 1 else "cpu", tuple(shape),
                            mesh_dim_names=tuple(axes))


def campaign_mesh_shape(name: str) -> Dict[str, int]:
    """``{axis name: size}`` of a ``--mesh`` choice, without making it."""
    shape, axes, _ = CAMPAIGN_MESHES[name]
    return dict(zip(axes, shape))


def make_campaign_mesh(name: str, device: str = "cuda"):
    """The mesh for a ``--mesh`` choice; returns ``(mesh, mesh_name)``.
    ``tiny`` (1x1, on ``device``) is the measured tier's; the others live
    on a fake process group, which making one of another size remakes:
    meshes made before that are stale."""
    shape, axes, mesh_name = CAMPAIGN_MESHES[name]
    return make_mesh(shape, axes, device), mesh_name


def single_device_mesh(device: str = "cuda"):
    """A 1-device ``("data",)`` mesh on ``device``."""
    return make_mesh((1,), ("data",), device)

