"""Shared helpers for the repro_torch parity tests: the same numpy inputs,
made from a seed, go through the JAX reference and the torch port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import model as JM
from repro.models.layers import split_params
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced as treduced
from repro_torch.models import model as TM

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


# ---------------------------------------------------------------------------
# train parity: the reduced dense models on the reference's weights
# ---------------------------------------------------------------------------
#: the shortest sequence with two q chunks of 512 (the second one short)
#: and two loss chunks of 300
TRAIN_B, TRAIN_S = 2, 600


def train_setup(arch, seed=1):
    """The reduced ``arch`` in both packages on the reference's weights
    (f32), and a numpy batch of ``TRAIN_B`` x ``TRAIN_S`` tokens and targets:
    ``(cfg, tcfg, values, tparams, batch)``."""
    cfg, tcfg = reduced(get_config(arch)), treduced(tget(arch))
    values, _ = split_params(JM.init_params(cfg, jax.random.key(seed)))
    tparams = TM.params_from_reference(
        tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), values))
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)
             for k in ("tokens", "targets")}
    return cfg, tcfg, values, tparams, batch


def flat_tree(tree, pre=""):
    """A nested dict's leaves as float32 numpy, keyed by dotted path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, pre + k + "."))
        else:
            out[pre + k] = np.asarray(v, np.float32)
    return out


def reference_grads(cfg, values, batch, remat="none", loss_chunk=0):
    """The reference's loss and its gradients (``flat_tree``) on ``batch``."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, g = jax.value_and_grad(
        lambda p: JM.loss_fn(cfg, p, jb, remat=remat, loss_chunk=loss_chunk)[0])(values)
    return float(loss), flat_tree(g)
