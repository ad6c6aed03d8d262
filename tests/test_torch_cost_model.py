"""repro_torch surrogate against the reference's: from the same numpy
parameters both predict and rank alike, and gradient-descent pretraining on
the same rows lands within a stated tolerance."""
import jax
import numpy as np
import pytest

from repro.core.cost_db import CostDB as JCostDB
from repro.core.cost_db import DataPoint as JDataPoint
from repro.core.cost_model import CostModel as JCostModel
from repro.core.cost_model import init_mlp
from repro_torch.core.cost_db import CostDB, DataPoint, featurize
from repro_torch.core.cost_model import CostModel

IN_DIM = featurize({}, {}).shape[0]


def _params(seed=0):
    return {k: np.asarray(v) for k, v in init_mlp(jax.random.key(seed), IN_DIM).items()}


def _feats(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, IN_DIM)).astype(np.float32)


def test_from_numpy_predicts_and_ranks_like_the_reference():
    params = _params(0)
    ours = CostModel.from_numpy(params)
    theirs = JCostModel(in_dim=IN_DIM, params=init_mlp(jax.random.key(0), IN_DIM))
    X = _feats(64)
    (b, pf), (jb, jpf) = ours.predict(X), theirs.predict(X)
    np.testing.assert_allclose(b, jb, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pf, jpf, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours.rank_candidates(X), theirs.rank_candidates(X))
    for k, v in ours.to_numpy().items():
        np.testing.assert_array_equal(v, params[k])


def _rows(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        br = int(rng.choice([32, 64, 128, 256]))
        ok = rng.random() < 0.8
        out.append(dict(arch="kernel:rmsnorm", shape="rms_512x512_f32", mesh="dev1",
                        point={"block_rows": br, "__key__": f"k{i}"},
                        status="ok" if ok else "infeasible",
                        metrics={"workload": {"n_params": 262144.0, "seq_len": 512.0,
                                              "d_model": 512.0},
                                 "bound_s": float(10 ** rng.uniform(-6, -4)),
                                 "fits_hbm": True},
                        iteration=i, ts=float(i)))
    return out


def test_pretrain_agrees_with_the_reference(tmp_path):
    rows = _rows(40)
    db, jdb = CostDB(tmp_path / "a.jsonl"), JCostDB(tmp_path / "b.jsonl")
    db.append_many([DataPoint(**r) for r in rows])
    jdb.append_many([JDataPoint(**r) for r in rows])
    ours = CostModel.from_numpy(_params(1))
    theirs = JCostModel(in_dim=IN_DIM, params=init_mlp(jax.random.key(1), IN_DIM))
    loss = ours.pretrain(db, steps=100)
    jloss = theirs.pretrain(jdb, steps=100)
    assert ours.trained and theirs.trained
    # f32 sums in another order over 100 steps: agreement to 1e-4 relative
    assert loss == pytest.approx(jloss, rel=1e-4)
    X = _feats(16, seed=2)
    np.testing.assert_allclose(ours.predict(X)[0], theirs.predict(X)[0], rtol=0, atol=1e-4)


def test_pretrain_needs_four_rows(tmp_path):
    db = CostDB(tmp_path / "a.jsonl")
    db.append_many([DataPoint(**r) for r in _rows(2)])
    assert np.isnan(CostModel.create(IN_DIM).pretrain(db))
