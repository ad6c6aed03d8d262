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
stale.
"""
from __future__ import annotations

import math
from typing import Sequence


def _ensure_world(n: int) -> None:
    """A fake default process group of ``n`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


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


def make_production_mesh(*, multi_pod: bool = False):
    """The paper-scale mesh: 16x16 (data, model), or 2x16x16 with a leading
    ``pod`` axis, on a fake group of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def single_device_mesh(device: str = "cuda"):
    """A 1-device ``("data",)`` mesh on ``device``."""
    return make_mesh((1,), ("data",), device)

