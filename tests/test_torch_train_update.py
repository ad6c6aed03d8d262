"""One whole train step of the port (``make_train_step``: microbatches,
compression with error feedback, AdamW) against the reference's, at
``reduced`` sizes in f32 on the reference's weights. The plan values are
combined so that each of ``microbatches`` 1 and 2, ``grad_compress``
none/int8/topk, ``opt_int8`` and master weights off and on runs once:
metrics within 1e-5, and the new params within 1e-6 where |g| >= 1e-3
max|g|. At step 1 Adam's m_hat / sqrt(v_hat) is +-1 for every element, so a
gradient that rounds to the other side of zero in one package flips its
update by 2 lr; the mask keeps those elements out."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sharding.plan import ShardingPlan as JPlan
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro.train.grad_compress import init_error_feedback
from repro_torch.sharding.plan import ShardingPlan as TPlan
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from torch_parity import flat_tree, reference_grads, train_setup


#: each plan value at least once: microbatches 1 and 2, grad_compress
#: none/int8/topk, opt_int8 off and on, master weights off and on
OPTIONS = {"baseline": ("qwen3-0.6b", {}),
           "mb2-int8-opt_int8": ("llama3-8b", {"microbatches": 2, "grad_compress": "int8",
                                               "opt_int8": True}),
           "topk-master": ("qwen3-0.6b", {"grad_compress": "topk", "master_weights": True})}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_train_step_matches_the_reference(option):
    arch, over = OPTIONS[option]
    cfg, tcfg, values, tparams, batch = train_setup(arch, seed=2)
    kw = dict(rules={}, zero1=False, remat="none", **over)
    jp, tp = JPlan(**kw), TPlan(**kw)
    oc = dict(warmup_steps=2, total_steps=10)
    jstate = {"params": values,
              "opt": jopt.init_opt_state(values, master_weights=jp.master_weights,
                                         int8_moments=jp.opt_int8)}
    if jp.grad_compress != "none":
        jstate["ef"] = init_error_feedback(values)
    jstate, jm = jax.jit(jstep.make_train_step(cfg, jp, None, jopt.AdamWConfig(**oc)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate = tstep._new_state(tparams, tp)
    tstate, tm = tstep.make_train_step(tcfg, tp, None, topt.AdamWConfig(**oc))(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    _, g = reference_grads(cfg, values, batch)
    want = flat_tree(jstate["params"])
    for k, p in tstate["params"].items():
        big = np.abs(g[k]) >= 1e-3 * np.abs(g[k]).max()
        assert big.mean() > 0.5, k
        err = float(np.abs(want[k] - p.numpy())[big].max())
        assert err <= 1e-6, (k, err)
    assert int(tstate["opt"]["step"]) == 1
