"""The port's MoE block (``models/moe.py``) against the reference's
``repro/models/moe.py`` on the same weights and inputs: the top-k order
on tied gates (lower expert index first, ``jax.lax.top_k`` 's), the block's
output and aux loss with and without dropped tokens (a low capacity
factor: the dropped tokens' combine weights are 0), tied gates through the
whole block, a token count that pads the last group, bf16, and the
gradients of output and aux loss.

Tolerances: f32 within 1e-5 of the largest |value|, bf16 within 2e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import moe as JMOE
from repro.models.layers import keygen, split_params
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced as treduced
from repro_torch.models import moe as TMOE


def rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = (got.float().detach().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _setup(dtype="float32", seed=0, **spec_over):
    cfg = reduced(get_config("mixtral-8x7b"), dtype=dtype)
    spec = dataclasses.replace(cfg.moe, **spec_over)
    jdt = jnp.dtype(dtype)
    values, _ = split_params(JMOE.init_moe_mlp(keygen(jax.random.key(seed)), cfg.d_model,
                                               spec, jdt))
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt) for k, v in values.items()}
    return cfg, spec, values, tp


def _x(cfg, b, s, seed=1, dtype="float32"):
    x = (0.5 * np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.float32 if dtype == "float32" else torch.bfloat16)
    return jnp.asarray(tx.float().numpy(), dtype=dtype), tx


def test_top_k_puts_the_lower_index_first_on_ties():
    g = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]],
                 np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(g), 3)
    tv, ti = TMOE.top_k(torch.from_numpy(g), 3)
    assert ti.tolist() == np.asarray(ji).tolist() == [[1, 2, 0], [0, 1, 2], [1, 3, 0]]
    assert np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("cf,b,s", [(1.25, 2, 16), (0.5, 2, 16), (0.25, 1, 40), (1.25, 3, 1)])
def test_block_and_aux_loss_match_the_reference(cf, b, s):
    """cf 1.25: few drops; 0.5 and 0.25: most second choices dropped; 40
    tokens in groups of 16 pad the last group; 3 one-token rows are one
    group of 3."""
    cfg, spec, values, tp = _setup(capacity_factor=cf)
    jx, tx = _x(cfg, b, s)
    jy, jaux = JMOE.moe_block(values, jx, spec)
    ty, taux = TMOE.moe_block(tp, tx, spec)
    assert ty.shape == tx.shape and ty.dtype == torch.float32
    assert rel(jy, ty) < 1e-5
    assert abs(float(jaux) - float(taux)) < 1e-5 * abs(float(jaux))


def test_low_capacity_drops_tokens_with_zero_combine_weight():
    cfg, spec, values, tp = _setup(capacity_factor=0.25)
    _, tx = _x(cfg, 1, 16)
    g = 16
    C = TMOE.capacity(spec, g)
    assert C == 2  # int(2 * 16 * 0.25) // 4
    _, _, dispatch, combine = TMOE._route(tx.reshape(1, g, -1), tp["router"], spec, C)
    kept = dispatch.sum(dim=(2, 3))[0]  # choices kept per token
    assert int(kept.sum()) <= spec.n_experts * C < g * spec.top_k
    dropped = kept == 0
    assert bool(dropped.any())
    assert float(combine[0][dropped].abs().sum()) == 0.0
    # a dropped token's output is zero, as the reference's
    y, _ = TMOE.moe_block(tp, tx, spec)
    assert float(y[0][dropped].abs().max()) == 0.0
    # each expert's slots hold at most one token, in arrival order
    assert int(dispatch.sum(dim=1).max()) == 1


def test_tied_gates_route_as_the_reference():
    """A zero router makes every gate 1/E: top-k must take experts 0..k-1
    for every token, as ``jax.lax.top_k`` does, or the capacity counts and
    the outputs differ."""
    cfg, spec, values, tp = _setup()
    values = {**values, "router": jnp.zeros_like(values["router"])}
    tp = {**tp, "router": torch.zeros_like(tp["router"])}
    jx, tx = _x(cfg, 2, 16)
    with TMOE.record_routing() as routes:
        ty, taux = TMOE.moe_block(tp, tx, spec)
    assert (routes[0] == torch.arange(spec.top_k)).all()
    jy, jaux = JMOE.moe_block(values, jx, spec)
    assert rel(jy, ty) < 1e-5
    assert abs(float(jaux) - float(taux)) < 1e-6


def test_bf16_block_within_2e_2():
    cfg, spec, values, tp = _setup(dtype="bfloat16")
    jx, tx = _x(cfg, 2, 16, dtype="bfloat16")
    jy, jaux = JMOE.moe_block(values, jx, spec)
    ty, taux = TMOE.moe_block(tp, tx, spec)
    assert ty.dtype == torch.bfloat16
    assert rel(jy.astype(jnp.float32), ty) < 2e-2
    assert abs(float(jaux) - float(taux)) < 2e-2 * abs(float(jaux))


def test_gradients_of_output_and_aux_match_the_reference():
    cfg, spec, values, tp = _setup(capacity_factor=0.5)
    jx, tx = _x(cfg, 2, 16)
    w = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, aux = JMOE.moe_block(p, x, spec)
        return (y * w).sum() + 10.0 * aux

    jg, jgx = jax.grad(jloss, (0, 1))(values, jx)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = tx.clone().requires_grad_()
    y, aux = TMOE.moe_block(leaves, x, spec)
    loss = (y * torch.from_numpy(w)).sum() + 10.0 * aux
    grads = torch.autograd.grad(loss, [*leaves.values(), x])
    for k, g in zip(leaves, grads):
        assert rel(jg[k], g) < 1e-4, k
    assert rel(jgx, grads[-1]) < 1e-4


def test_port_config_matches_the_reference_spec():
    for arch in ("mixtral-8x7b", "qwen3-moe-235b-a22b"):
        for c, t in ((get_config(arch), tget(arch)),
                     (reduced(get_config(arch)), treduced(tget(arch)))):
            assert dataclasses.asdict(c.moe) == dataclasses.asdict(t.moe)
            for g in (1, 3, 16, c.moe.group_size):
                assert TMOE.capacity(t.moe, g) == max(
                    int(c.moe.top_k * g * c.moe.capacity_factor) // c.moe.n_experts, 1)
