"""Elastic re-scaling: restore a checkpoint onto a different mesh.

Counterpart of ``repro/train/elastic.py``. Checkpoints hold full logical
tensors, so scaling events (node loss, pool resize) are handled by
rebuilding the mesh from the surviving device count and placing every
restored leaf by the plan's placements (``train.step.state_specs``).
The *global batch is preserved* (per-device batch grows/shrinks), so the
optimizer trajectory is the unsharded one (``tests/test_torch_elastic.py``
holds it within 1e-5 across 4 -> 2 -> 4 ranks).

The devices are the ranks of the live process group: with a real backend
(``gloo`` or ``nccl``) initialised, ``n`` is its world size and the mesh
is built over it with ``init_device_mesh``; otherwise ``n`` is 1, the card
(or the CPU when asked), on a 1x1 mesh. ``launch/mesh.make_mesh`` is not
used for ``n > 1``: it replaces any group that is not ``fake`` with a
fake one, the dry run's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple


def choose_mesh_shape(n_devices: int) -> Tuple[Tuple[int, int], Tuple[str, str]]:
    """Largest (data, model) factorization with model <= data."""
    best = (n_devices, 1)
    m = 1
    while m * m <= n_devices:
        if n_devices % m == 0:
            best = (n_devices // m, m)
        m *= 2
    return best, ("data", "model")


def live_world_size() -> Optional[int]:
    """The world size of the default process group when a real backend
    (``gloo``, ``nccl``) runs it, else ``None``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_backend() != "fake":
        return dist.get_world_size()
    return None


def rebuild(cfg, plan, ckpt_dir: str, *, devices: Optional[int] = None, opt_cfg=None,
            device: str = "cuda"):
    """(state, mesh, step fn, restored step) for the surviving devices.

    ``devices`` defaults to the live group's world size (1 without one);
    more than one device needs a live group of exactly that size, whose
    ranks all call this. ``device`` is where a one-device rebuild runs
    (``cuda``, the default, or ``cpu``; a group's ranks run on the CPU).
    The step fn takes the global batch as plain tensors and returns
    ``(state, metrics)`` with whole (not sharded) metrics."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.device import resolve_device
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import step as step_mod

    world = live_world_size()
    n = devices or world or 1
    shape, axes = choose_mesh_shape(n)
    if n > 1:
        if world != n:
            raise ValueError(f"{n} devices asked for, but the live process group "
                             f"has {world or 'no'} real ranks: start {n} ranks "
                             f"(gloo or nccl) and call rebuild on each")
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        dev = torch.device("cpu")
    else:
        dev = resolve_device(device)
        mesh = make_mesh(shape, axes, dev.type) if world is None else None

    like, logical = step_mod.abstract_train_state(cfg, plan)
    state, step, _ = ckpt_mod.restore_checkpoint(ckpt_dir, like, device=dev)
    sharded = n > 1
    if sharded:
        specs = step_mod.state_specs(mesh, plan, state, logical)

        def place(tree, pl):
            if isinstance(tree, dict):
                return {k: place(v, pl[k]) for k, v in tree.items()}
            return distribute_tensor(tree, mesh, pl)

        state = place(state, specs)
    inner = step_mod.make_train_step(cfg, plan, mesh if sharded else None, opt_cfg)

    def step_fn(state, batch) -> Tuple[Any, Dict[str, Any]]:
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if not sharded:
            return inner(state, batch)
        bp = plan.batch_specs(mesh, batch)
        batch = {k: distribute_tensor(v, mesh, bp[k]) for k, v in batch.items()}
        with implicit_replication():
            state, metrics = inner(state, batch)
            metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
        return state, metrics

    return state, mesh, step_fn, step
