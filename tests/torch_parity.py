"""Shared helpers for the repro_torch parity tests: the same numpy inputs,
made from a seed, go through the JAX reference and the torch port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def draw(rng, *dims, dtype="float32"):
    """One input in both packages: (jnp array, torch tensor) holding the
    same values (bf16 rounded once, in torch, then handed over exactly)."""
    t = torch.from_numpy((0.3 * rng.standard_normal(dims)).astype(np.float32))
    t = t.to(TORCH_DTYPES[dtype])
    return jnp.asarray(t.float().numpy(), dtype=dtype), t


def as_np(x):
    """A jnp array or torch tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def max_err(a, b) -> float:
    a, b = as_np(a), as_np(b)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def grid_cases(shapes):
    """One pytest param per legal tile point of each shape."""
    from repro_torch.core.kernel_space import tile_grid

    return [pytest.param(shape, dims, id=shape.name + "-" + ",".join(
        f"{k}={v}" for k, v in dims.items())) for shape in shapes
        for dims in tile_grid(shape)]
