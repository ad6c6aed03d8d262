"""The five model families beyond dense in the port against the reference
(``tests/test_torch_families.py`` holds the serve steps), at ``reduced``
sizes on the reference's weights (the hybrid's LoRA ``b`` halves drawn
non-zero): the train loss, through the no-cache forward, with every
gradient leaf against ``jax.grad`` 's and the metrics (the MoE aux loss
included); and bf16 prefill and decode with their caches' dtypes.

Tolerances: the loss within 1e-5 (relative), each gradient leaf within
1e-4 of its largest |value|; bf16 within 2e-2 of the largest |value|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import FAMILIES, flat, inputs, models, rel_err

from repro.models import model as JM
from repro_torch.models import model as TM


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_match_jax_grad(arch):
    """The no-cache forward through the train loss, with its gradients."""
    cfg, tcfg, values, tparams = models(arch)
    jb, tb = inputs(cfg, 2, 40, seed=3, targets=True)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(lambda p: JM.loss_fn(cfg, p, jb),
                                                 has_aux=True))(values)
    leaves = {k: v.detach().requires_grad_() for k, v in tparams.items()}
    tloss, tm = TM.loss_fn(tcfg, leaves, tb)
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(tm) == set(jm) and float(tm["tokens"]) == float(jm["tokens"])
    if "aux" in jm:
        aux = float(tm["aux"].detach())
        assert abs(aux - float(jm["aux"])) <= 1e-5 * max(abs(float(jm["aux"])), 1)
    grads = dict(zip(leaves, torch.autograd.grad(tloss, list(leaves.values()))))
    jgf = flat(jg)
    assert set(jgf) == set(grads)
    for k, g in grads.items():
        assert rel_err(jgf[k], g) < 1e-4, k


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_prefill_and_decode_within_2e_2(arch):
    cfg, tcfg, values, tparams = models(arch, dtype="bfloat16")
    jb, tb = inputs(cfg, 2, 24)
    jl, jc = jax.jit(lambda p, b, c: JM.prefill_fn(cfg, p, b, c))(
        values, jb, JM.init_cache(cfg, 2, 32))
    tl, tc = TM.prefill_fn(tcfg, tparams, tb, TM.init_cache(tcfg, 2, 32))
    assert tl.dtype == torch.bfloat16
    assert rel_err(jl.astype(jnp.float32), tl) < 2e-2
    nxt = np.random.default_rng(5).integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    jl, jc = jax.jit(lambda p, b, c: JM.decode_fn(cfg, p, b, c))(
        values, {"tokens": jnp.asarray(nxt)}, jc)
    tl, tc = TM.decode_fn(tcfg, tparams, {"tokens": torch.from_numpy(nxt)}, tc)
    assert rel_err(jl.astype(jnp.float32), tl) < 2e-2
    jf, tf = flat(jc), flat(tc)
    for k in jf:
        assert tf[k].dtype == {jnp.dtype(jnp.float32): torch.float32,
                               jnp.dtype(jnp.bfloat16): torch.bfloat16,
                               jnp.dtype(jnp.int32): torch.int32}[jnp.dtype(jf[k].dtype)], k
        if not k.endswith("len"):
            assert rel_err(jf[k].astype(jnp.float32), tf[k]) < 2e-2, k
