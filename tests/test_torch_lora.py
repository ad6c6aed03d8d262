"""LoRA on the surrogate, repro_torch against the reference: a fresh adapter
(B = 0) leaves the model as it was; from the same base weights and the same
A, ``finetune_lora`` on the same rows ends within the pretraining test's
tolerances of the reference (final loss within rel 1e-4, predictions within
atol 1e-4; f32 sums in another order over 200 steps) and leaves the base
untouched; the MCP tool pretrains first and fine-tunes after, as the
reference's does."""
import jax
import numpy as np
import pytest
import torch

from repro.core import lora as jlora
from repro.core.cost_db import CostDB as JCostDB
from repro.core.cost_db import DataPoint as JDataPoint
from repro.core.cost_model import CostModel as JCostModel
from repro.core.cost_model import init_mlp
from repro.core.mcp import build_registry as jbuild_registry
from repro_torch.core import lora
from repro_torch.core.cost_db import CostDB, DataPoint, featurize
from repro_torch.core.cost_model import CostModel
from repro_torch.core.mcp import build_registry

IN_DIM = featurize({}, {}).shape[0]


def _params(seed=0):
    return {k: np.asarray(v) for k, v in init_mlp(jax.random.key(seed), IN_DIM).items()}


def _ref_adapters(params, seed=1, rank=4):
    """The reference's adapters for ``params`` (its own ``init_lora``)."""
    ad, _ = jlora.init_lora({k: jax.numpy.asarray(v) for k, v in params.items()},
                            jax.random.key(seed), rank)
    return {k: None if v is None else {n: np.asarray(v[n]) for n in ("a", "b")}
            for k, v in ad.items()}


def _rows(n, seed=1):
    """Plan-cell rows: the bound falls with microbatches and remat choice."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mb = int(rng.choice([1, 2, 4, 8]))
        remat = str(rng.choice(["none", "dots", "full"]))
        ok = rng.random() < 0.75
        out.append(dict(arch="llama3-8b", shape="train_4k", mesh="pod16x16",
                        point={"microbatches": mb, "remat": remat, "__key__": f"k{i}"},
                        status="ok" if ok else "infeasible",
                        metrics={"workload": {"n_params": 8.0e9, "seq_len": 4096.0,
                                              "global_batch": 256.0, "is_train": 1.0},
                                 "bound_s": float(10.0 / mb * rng.uniform(0.9, 1.1)),
                                 "fits_hbm": ok},
                        iteration=i, ts=float(i)))
    return out


def _dbs(tmp_path, n=48):
    rows = _rows(n)
    db, jdb = CostDB(tmp_path / "a.jsonl"), JCostDB(tmp_path / "b.jsonl")
    db.append_many([DataPoint(**r) for r in rows])
    jdb.append_many([JDataPoint(**r) for r in rows])
    return db, jdb


def test_zero_b_adapter_is_the_identity():
    params = _params(0)
    cm = CostModel.from_numpy(params)
    X = np.random.default_rng(0).standard_normal((32, IN_DIM)).astype(np.float32)
    before = cm.predict(X)
    cm.lora = lora.init_lora(dict(cm.params), torch.Generator().manual_seed(1), rank=4)
    eff = lora.apply_lora(dict(cm.params), cm.lora)
    for k, v in cm.params.items():
        assert torch.equal(eff[k], v)
    after = cm.predict(X)
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])
    # one adapter per 2-D weight, as many parameters as the reference's
    assert {k for k, v in cm.lora.items() if v is not None} == {"w0", "w1", "w_out"}
    assert lora.lora_param_count(cm.lora) == jlora.lora_param_count(
        jlora.init_lora({k: jax.numpy.asarray(v) for k, v in params.items()},
                        jax.random.key(1), 4)[0])


def test_finetune_lora_matches_the_reference(tmp_path):
    db, jdb = _dbs(tmp_path)
    theirs = JCostModel(in_dim=IN_DIM, params=init_mlp(jax.random.key(2), IN_DIM))
    theirs.pretrain(jdb, steps=100)
    base = {k: np.asarray(v) for k, v in theirs.params.items()}
    ours = CostModel.from_numpy(base)
    ours.trained = True
    adapters = _ref_adapters(base, seed=1, rank=4)
    ours.lora = lora.lora_from_numpy(adapters)
    # the reference makes the same adapters itself (init_lora, key 1, rank 4)
    jloss = theirs.finetune_lora(jdb, rank=4, steps=200, seed=1)
    loss = ours.finetune_lora(db, rank=4, steps=200, seed=1)
    assert np.isfinite(loss) and loss == pytest.approx(jloss, rel=1e-4)
    X = np.stack([featurize(r["point"], r["metrics"]["workload"]) for r in _rows(16, seed=5)])
    np.testing.assert_allclose(ours.predict(X)[0], theirs.predict(X)[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours.predict(X)[1], theirs.predict(X)[1], rtol=0, atol=1e-4)
    # the base stayed frozen, and the adapters moved
    for k, v in ours.to_numpy().items():
        np.testing.assert_array_equal(v, base[k])
    assert float(ours.lora["w0"]["b"].abs().max()) > 0
    for k in ("w0", "w1", "w_out"):
        np.testing.assert_allclose(ours.lora[k]["b"].numpy(),
                                   np.asarray(theirs.lora[k]["b"]), rtol=0, atol=1e-4)


def test_finetune_lora_needs_four_rows(tmp_path):
    db, _ = _dbs(tmp_path, n=2)
    cm = CostModel.create(IN_DIM)
    assert np.isnan(cm.finetune_lora(db)) and cm.lora is None


def test_mcp_finetune_tool_pretrains_then_adapts(tmp_path):
    db, jdb = _dbs(tmp_path)
    params = _params(3)
    ours = CostModel.from_numpy(params)
    theirs = JCostModel(in_dim=IN_DIM, params=init_mlp(jax.random.key(3), IN_DIM))
    ours.lora = lora.lora_from_numpy(_ref_adapters(params, seed=1, rank=4))
    theirs.lora = jlora.init_lora(theirs.params, jax.random.key(1), 4)[0]
    reg = build_registry(evaluator=None, db=db, llm_stack=None, cost_model=ours)
    jreg = jbuild_registry(evaluator=None, db=jdb, llm_stack=None, cost_model=theirs)
    for status in ("pretrained", "lora-finetuned"):
        r, jr = reg.call("finetune_cost_model"), jreg.call("finetune_cost_model")
        assert r["status"] == jr["status"] == status
        assert r["loss"] == pytest.approx(jr["loss"], rel=1e-4)
    assert r["adapter_params"] == jr["adapter_params"] > 0
    assert build_registry(evaluator=None, db=db, llm_stack=None).call(
        "finetune_cost_model") == {"status": "no cost model attached"}
