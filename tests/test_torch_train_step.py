"""The port's dense train step against the reference's, at ``reduced``
sizes in f32 on the reference's weights (``params_from_reference``): loss
and gradients of ``loss_fn`` against ``jax.value_and_grad`` of the
reference's, under every ``remat`` (none, dots, full) and ``loss_chunk``
(0 and a chunk) across qwen3-0.6b and llama3-8b: the loss within 1e-5
relative, each gradient leaf within 1e-4 of that leaf's largest |value|;
and the step's in-place contract. Whole steps against the reference's:
``tests/test_torch_train_update.py``.

The sequence (600 tokens) is the shortest with two q chunks of 512 (the
second one short) and two loss chunks (300)."""
import numpy as np
import pytest
import torch

from repro_torch.models import model as TM
from repro_torch.sharding.plan import ShardingPlan as TPlan
from repro_torch.train import step as tstep

from torch_parity import TRAIN_B as B, TRAIN_S as S, reference_grads, train_setup

CHUNK = 300


@pytest.mark.parametrize("arch,remat,loss_chunk", [
    ("qwen3-0.6b", "none", CHUNK), ("qwen3-0.6b", "dots", 0), ("llama3-8b", "full", CHUNK)])
def test_loss_and_grads_match_the_reference(arch, remat, loss_chunk):
    cfg, tcfg, values, tparams, batch = train_setup(arch)
    want_loss, want = reference_grads(cfg, values, batch, remat, loss_chunk)
    leaves = {k: v.detach().requires_grad_() for k, v in tparams.items()}
    loss, mets = TM.loss_fn(tcfg, leaves, {k: torch.from_numpy(v) for k, v in batch.items()},
                            remat=remat, loss_chunk=loss_chunk)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)
    assert float(mets["tokens"]) == B * S
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert g.shape == want[k].shape
        err = float(np.abs(want[k] - g.numpy()).max())
        assert err <= 1e-4 * float(np.abs(want[k]).max()), (k, err)


def test_step_updates_the_state_in_place_and_keeps_no_grad():
    _, tcfg, _, tparams, batch = train_setup("qwen3-0.6b")
    plan = TPlan(rules={}, zero1=False, remat="full")
    state = tstep._new_state(tparams, plan)
    before = {k: v.data_ptr() for k, v in state["params"].items()}
    out, mets = tstep.make_train_step(tcfg, plan)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert out is state and {k: v.data_ptr() for k, v in out["params"].items()} == before
    assert not any(v.requires_grad for v in out["params"].values())
    assert set(mets) == {"loss", "grad_norm", "lr", "tokens"}
