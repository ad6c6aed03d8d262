"""repro_torch search against the reference's on the same rows and seeds:
anneal, evolve and ensemble propose exactly what the reference's propose
(one walk over shared synthetic rows, and the whole kernel-cell loop with
the reference's resource numbers); SurrogateGate and PromotionLadder give
the reference's verdicts, ``active`` and ``effective_factor`` from the same
surrogate parameters and rows; the search helpers agree; and the CLI's
gated ensemble cell writes ``pruned`` rows on the CPU."""
import functools
import inspect
import random

import jax
import numpy as np
import pytest

from repro.core import design_space as jds
from repro.core import kernel_space as jks
from repro.core.cost_db import CostDB as JCostDB
from repro.core.cost_db import DataPoint as JDataPoint
from repro.core.cost_model import CostModel as JCostModel
from repro.core.cost_model import init_mlp
from repro.core.evaluator import KernelEvaluator as JKernelEvaluator
from repro.core.promotion import select_measured_row as j_select_measured_row
from repro.launch.campaign import validate_gate_args as j_validate_gate_args
from repro.launch.kernel_cell import _explore_kernel_cell as j_explore
from repro import search as jsearch
from repro_torch import search
from repro_torch.core import kernel_space as ks
from repro_torch.core.cost_db import CostDB, DataPoint, featurize
from repro_torch.core.cost_model import CostModel
from repro_torch.core.design_space import KernelPoint, KernelTemplate
from repro_torch.core.evaluator import KernelEvaluator
from repro_torch.core.promotion import select_measured_row
from repro_torch.launch import dse
from repro_torch.launch.kernel_cell import _explore_kernel_cell

IN_DIM = featurize({}, {}).shape[0]
STRATS = ["anneal", "evolve", "ensemble"]


def _params(seed=0):
    return {k: np.asarray(v) for k, v in init_mlp(jax.random.key(seed), IN_DIM).items()}


def _bound(dims):
    """A synthetic, deterministic bound for a tile point."""
    return 1e-5 * (1 + int(KernelPoint(dims=dims).key()[:4], 16) % 13 / 4)


def _row(cls, kshape, dims, *, status="ok", source="expert", iteration=0,
         ts=1.0, fidelity="dryrun", metrics=None):
    point = dict(dims)
    point["__key__"] = KernelPoint(dims=dims).key()
    m = {"workload": ks.kernel_workload(kshape), "fits_hbm": True,
         "bound_s": _bound(dims), "est_latency_us": _bound(dims) * 1e6}
    m.update(metrics or {})
    return cls(arch=ks.kernel_arch(kshape.kernel), shape=kshape.name, mesh="dev1",
               point=point, status=status, metrics=m, source=source,
               iteration=iteration, ts=ts, fidelity=fidelity)


def _pair(dps_port, dps_ref, tmp_path, name):
    db, jdb = CostDB(tmp_path / f"{name}.jsonl"), JCostDB(tmp_path / f"j{name}.jsonl")
    db.append_many(dps_port)
    jdb.append_many(dps_ref)
    return db, jdb


def _cands(cs):
    return [(dict(c.point.dims), c.source) for c in cs]


# ---------------------------------------------------------------------------
# strategies: one walk over the same rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", STRATS)
@pytest.mark.parametrize("shape", ["attn_s128_f32", "ssd_s256_f32"])
@pytest.mark.parametrize("with_model", [False, True])
def test_strategies_propose_what_the_reference_proposes(name, shape, with_model,
                                                        tmp_path, monkeypatch):
    kshape = ks.KERNEL_SHAPE_BY_NAME[shape]
    jshape = jks.KERNEL_SHAPE_BY_NAME[shape]
    # hold the templates to the same legality, so only the strategies differ
    monkeypatch.setattr(ks, "kernel_resources",
                        lambda s, d, device=None: jks.kernel_resources(jshape, d))
    t, jt = KernelTemplate(kshape), jds.KernelTemplate(jshape)
    seed_dims = ks.default_kernel_dims(kshape)
    db, jdb = _pair([_row(DataPoint, kshape, seed_dims)],
                    [_row(JDataPoint, kshape, seed_dims)], tmp_path, "walk")
    cm = jcm = None
    if with_model:
        p = _params(1)
        cm, jcm = CostModel.from_numpy(p), JCostModel(in_dim=IN_DIM, params=dict(p))
        cm.trained = jcm.trained = True
    ours, theirs = (search.make_strategy(name, seed=3),
                    jsearch.make_strategy(name, seed=3))
    inc, jinc = db.all()[0], jdb.all()[0]
    for it in range(1, 6):
        kw = dict(arch=inc.arch, shape=shape, cfg=None, cell=None, iteration=it,
                  budget=3, workload=ks.kernel_workload(kshape), mesh="dev1")
        st = search.SearchState(template=t, db=db, incumbent=inc, pool=[inc],
                                cost_model=cm, **kw)
        jst = jsearch.SearchState(template=jt, db=jdb, incumbent=jinc, pool=[jinc],
                                  cost_model=jcm, **kw)
        got = search.select_candidates(st, ours.propose(st))
        want = jsearch.select_candidates(jst, theirs.propose(jst))
        assert _cands(got) == _cands(want), it
        # the same outcomes land in both DBs; every third one fails the gate
        rows, jrows = [], []
        for i, c in enumerate(got):
            status = "infeasible" if i == 2 else "ok"
            rows.append(_row(DataPoint, kshape, dict(c.point.dims), status=status,
                             source=c.source, iteration=it, ts=float(it)))
            jrows.append(_row(JDataPoint, kshape, dict(c.point.dims), status=status,
                              source=c.source, iteration=it, ts=float(it)))
        db.append_many(rows)
        jdb.append_many(jrows)
        ours.observe(rows)
        theirs.observe(jrows)
        ok = [d for d in [inc] + rows if d.status == "ok"]
        inc = min(ok, key=lambda d: d.metrics["bound_s"])
        jinc = next(d for d in [jinc] + jrows
                    if d.point["__key__"] == inc.point["__key__"])
    if name == "ensemble":
        assert ours.credit == pytest.approx(theirs.credit, rel=1e-12)
        # the ledger rebuilt from the DB alone matches the reference's too
        fresh, jfresh = search.make_strategy(name), jsearch.make_strategy(name)
        fresh.rebuild_credit(db, inc.arch, shape, mesh="dev1")
        jfresh.rebuild_credit(jdb, inc.arch, shape, mesh="dev1")
        assert fresh.credit == pytest.approx(jfresh.credit, rel=1e-12)
        assert fresh.allocation(7) == jfresh.allocation(7)
    if name == "anneal":
        assert ours.temperature == pytest.approx(theirs.temperature, rel=1e-12)


# ---------------------------------------------------------------------------
# strategies (and the gate) through the whole kernel-cell loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", STRATS)
@pytest.mark.parametrize("shape,gated", [("vec_64k_f32", False), ("attn_s128_f32", False),
                                         ("vec_64k_f32", True), ("attn_s256_gqa_bf16", True)])
def test_loop_with_each_strategy_matches_the_reference(name, shape, gated, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(ks, "kernel_resources", lambda s, d, device=None:
                        jks.kernel_resources(jks.KERNEL_SHAPE_BY_NAME[s.name], d))
    arch = ks.kernel_arch(ks.KERNEL_SHAPE_BY_NAME[shape].kernel)
    params = _params()
    kw = dict(iterations=6 if gated else 4, budget=3, seed=0, log=lambda *a: None)
    jcm = JCostModel(in_dim=IN_DIM, params=dict(params))
    cm = CostModel.from_numpy(params)
    gate_kw = dict(factor=1.2, require_calibration=False)
    jgate = jsearch.SurrogateGate(jcm, **gate_kw) if gated else None
    gate = search.SurrogateGate(cm, **gate_kw) if gated else None

    jdb = JCostDB(tmp_path / "ref.jsonl")
    jrep = j_explore(arch, shape, evaluator=JKernelEvaluator(mesh=None, mesh_name="dev1"),
                     db=jdb, cost_model=jcm, gate=jgate,
                     strategy=jsearch.make_strategy(name), **kw)
    db = CostDB(tmp_path / "port.jsonl")
    rep = _explore_kernel_cell(
        arch, shape, evaluator=KernelEvaluator(mesh_name="dev1", torch_device="cpu"),
        db=db, cost_model=cm, gate=gate, strategy=search.make_strategy(name), **kw)

    def rows(d):
        return [(r.point["__key__"], r.status, r.metrics.get("bound_s"), r.source,
                 r.iteration) for r in d.all()]

    assert rows(db) == rows(jdb)
    assert rep["iterations"] == jrep["iterations"]
    assert rep["best"]["point"] == jrep["best"]["point"]
    if gated:
        assert gate.pruned_total == jgate.pruned_total
        assert gate.active == jgate.active


# ---------------------------------------------------------------------------
# the surrogate gate and the promotion ladder on the same rows
# ---------------------------------------------------------------------------
def _calibration_rows(cls):
    """Rows over every CI shape's tile grid, a few failed ones, and
    measured rows for the ladder."""
    out = []
    for kshape in ks.CI_KERNEL_SHAPES:
        for i, dims in enumerate(ks.tile_grid(kshape)):
            status = "infeasible" if i % 7 == 3 else "ok"
            out.append(_row(cls, kshape, dims, status=status, iteration=i, ts=float(i)))
    attn = ks.KERNEL_SHAPE_BY_NAME["attn_s256_gqa_bf16"]
    for i, dims in enumerate(ks.tile_grid(attn)[:6]):
        out.append(_row(cls, attn, dims, fidelity="measured", source="ladder",
                        ts=100.0 + i,
                        metrics={"measured_s": 3e-4 * (1 + i % 3)}))
    return out


@pytest.fixture
def trained_pair(tmp_path):
    db, jdb = _pair(_calibration_rows(DataPoint), _calibration_rows(JDataPoint),
                    tmp_path, "cal")
    jcm = JCostModel.create(in_dim=IN_DIM)
    jcm.pretrain(jdb, split=None)
    cm = CostModel.from_numpy({k: np.asarray(v) for k, v in jcm.params.items()})
    cm.trained = True
    return db, jdb, cm, jcm


@pytest.mark.parametrize("cls", ["SurrogateGate", "PromotionLadder"])
@pytest.mark.parametrize("factor,min_factor,max_val_rmse,require", [
    (3.0, None, 0.35, True), (3.0, 1.5, 0.35, True), (3.0, 1.5, 5.0, True),
    (1.1, None, 5.0, True), (4.0, 2.0, 0.35, False)])
@pytest.mark.parametrize("cell", [None, "attn_s256_gqa_bf16"])
def test_gate_and_ladder_give_the_reference_verdicts(cls, factor, min_factor,
                                                     max_val_rmse, require, cell,
                                                     trained_pair):
    db, jdb, cm, jcm = trained_pair
    kw = dict(factor=factor, min_factor=min_factor, max_val_rmse=max_val_rmse,
              require_calibration=require)
    ours, theirs = getattr(search, cls)(cm, **kw), getattr(jsearch, cls)(jcm, **kw)
    where = {}
    if cell is not None:
        kshape = ks.KERNEL_SHAPE_BY_NAME[cell]
        where = dict(arch=ks.kernel_arch(kshape.kernel), shape=cell, mesh="dev1")
    assert ours.calibrate(db, **where) == theirs.calibrate(jdb, **where)
    assert ours.active == theirs.active
    assert ours.effective_factor == pytest.approx(theirs.effective_factor, rel=1e-5)
    assert (ours.last_val_n, ours.last_scope) == (theirs.last_val_n, theirs.last_scope)
    assert ours.last_rmse == pytest.approx(theirs.last_rmse, rel=1e-4, nan_ok=True)
    if cls == "PromotionLadder":
        assert ours.last_measured_n == theirs.last_measured_n
        assert ours.last_measured_rmse == pytest.approx(
            theirs.last_measured_rmse, rel=1e-4, abs=1e-6, nan_ok=True)
        assert ours.measured_offset == pytest.approx(
            theirs.measured_offset, rel=1e-5, nan_ok=True)
    attn = ks.KERNEL_SHAPE_BY_NAME["attn_s256_gqa_bf16"]
    points = [KernelPoint(dims=d) for d in ks.tile_grid(attn)]
    wl = ks.kernel_workload(attn)
    for inc in (None, 2e-6, 1e-5, 2.5e-5, 4e-5):
        got = ours.prune_verdicts(points, wl, inc)
        want = theirs.prune_verdicts(points, wl, inc)
        assert [v is None for v in got] == [v is None for v in want]
        for g, w in zip(got, want):
            if g is not None:
                assert g == pytest.approx(w, rel=1e-5)
    assert ours.pruned_total == theirs.pruned_total


def test_the_fixture_arms_and_prunes(trained_pair):
    """The parity cases above include an armed gate that prunes, not only
    inactive ones."""
    db, _, cm, _ = trained_pair
    gate = search.SurrogateGate(cm, factor=1.1, max_val_rmse=5.0)
    assert gate.calibrate(db)
    attn = ks.KERNEL_SHAPE_BY_NAME["attn_s256_gqa_bf16"]
    verdicts = gate.prune_verdicts([KernelPoint(dims=d) for d in ks.tile_grid(attn)],
                                   ks.kernel_workload(attn), 2.5e-5)
    assert 0 < sum(v is not None for v in verdicts) < len(verdicts)


def test_calibration_methods_match_the_reference(trained_pair):
    db, jdb, cm, jcm = trained_pair
    for where in ({}, dict(arch="kernel:flash_attention", shape="attn_s256_gqa_bf16",
                           mesh="dev1")):
        r, n = cm.validation_error(db, **where)
        jr, jn = jcm.validation_error(jdb, **where)
        assert n == jn and r == pytest.approx(jr, rel=1e-4)
        m = cm.measured_calibration(db, **where)
        jm = jcm.measured_calibration(jdb, **where)
        assert m[1] == jm[1] == 6
        assert m[0] == pytest.approx(jm[0], rel=1e-4, abs=1e-6)
        assert m[2] == pytest.approx(jm[2], rel=1e-5)


# ---------------------------------------------------------------------------
# helpers and the CLI
# ---------------------------------------------------------------------------
def test_search_helpers_match_the_reference(tmp_path):
    kshape = ks.KERNEL_SHAPE_BY_NAME["attn_s128_f32"]
    jshape = jks.KERNEL_SHAPE_BY_NAME["attn_s128_f32"]
    t, jt = KernelTemplate(kshape), jds.KernelTemplate(jshape)
    p = KernelPoint(dims={"block_q": 64, "block_k": 128, "causal": True})
    for seed in range(20):
        for n in (1, 2, 3):
            a = search.base.mutate(t, p, random.Random(seed), n)
            b = jsearch.base.mutate(jt, p, random.Random(seed), n)
            assert a.dims == b.dims
    rows = _calibration_rows(DataPoint)
    jrows = _calibration_rows(JDataPoint)
    for w in (None, {"bound_s": 1.0}, {"bound_s": 1.0, "vmem_util": 0.5,
                                       "flops_util": 0.5}):
        for d, jd in zip(rows, jrows):
            assert search.weighted_objective(d, w) == jsearch.weighted_objective(jd, w)
            assert search.bound_of(d) == jsearch.bound_of(jd)
    db, jdb = _pair(rows, jrows, tmp_path, "neg")
    inc = next(d for d in rows if d.status == "ok" and d.shape == "attn_s256_gqa_bf16")
    jinc = next(d for d in jrows if (d.shape, d.point) == (inc.shape, inc.point))
    neg = search.best_negative(db, inc.arch, inc.shape, inc)
    jneg = jsearch.best_negative(jdb, jinc.arch, jinc.shape, jinc)
    assert (neg and neg.to_json()) == (jneg and jneg.to_json())
    measured = [d for d in rows if d.fidelity == "measured"]
    jmeasured = [d for d in jrows if d.fidelity == "measured"]
    assert select_measured_row(measured[::-1]).to_json() == \
        j_select_measured_row(jmeasured).to_json()
    assert select_measured_row([]) is None


@pytest.mark.parametrize("factor,min_factor", [(None, None), (3.0, None), (3.0, 1.5),
                                               (1.0, None), (3.0, 4.0), (None, 2.0),
                                               (3.0, 1.0)])
def test_gate_args_are_validated_as_the_reference_does(factor, min_factor, tmp_path):
    want = j_validate_gate_args(factor, min_factor)
    assert dse.validate_gate_args(factor, min_factor) == want
    if want is None:
        return
    argv = ["--space", "kernels", "--arch", "vecmul", "--shape", "vec_64k_f32",
            "--device", "cpu", "--db", str(tmp_path / "db.jsonl")]
    if factor is not None:
        argv += ["--gate-factor", str(factor)]
    if min_factor is not None:
        argv += ["--gate-min-factor", str(min_factor)]
    with pytest.raises(SystemExit):
        dse.main(argv)


def test_unported_objective_and_strategy_are_refused(tmp_path):
    # --objective pareto is ported: the CLI runs it and reports the front
    rep = dse.main(["--space", "kernels",
                    "--arch", "vecmul", "--shape", "vec_64k_f32", "--device", "cpu",
                    "--iterations", "1", "--db", str(tmp_path / "db.jsonl"),
                    "--objective", "pareto"])
    assert rep["front"] and all(set(f) == {"point", "objectives", "crowding"}
                                for f in rep["front"])
    assert "objective" in inspect.signature(search.make_strategy).parameters
    with pytest.raises(SystemExit):
        dse.main(["--space", "kernels",
                  "--arch", "vecmul", "--shape", "vec_64k_f32", "--device", "cpu",
                  "--db", str(tmp_path / "db.jsonl"), "--objective", "hypervolume"])
    with pytest.raises(ValueError, match="unknown objective"):
        search.make_strategy("ensemble", objective="hypervolume")
    # the plan-coupled strategies are built for the plan space (the LLM
    # member needs a stack) and refused by the kernel space, as the
    # reference refuses them
    with pytest.raises(ValueError, match="needs llm_stack"):
        search.make_strategy("llm")
    for name in ("llm", "transfer", "ensemble+transfer"):
        with pytest.raises(SystemExit):
            dse.main(["--space", "kernels", "--arch", "vecmul", "--shape", "vec_64k_f32",
                      "--device", "cpu", "--db", str(tmp_path / "db.jsonl"),
                      "--strategy", name])
    assert [m.name for m in search.make_strategy("ensemble+transfer").members] == \
        [m.name for m in jsearch.make_strategy("ensemble+transfer").members]
    assert [m.name for m in search.make_strategy("ensemble").members] == \
        ["greedy", "anneal", "evolve"]
    assert [m.name for m in search.make_strategy("ensemble", objective="pareto").members] \
        == [m.name for m in jsearch.make_strategy("ensemble", objective="pareto").members]


def test_cli_gated_ensemble_writes_pruned_rows(tmp_path, monkeypatch, capsys):
    # force the gate on once the surrogate is trained (the calibration
    # guard needs more held-out rows than a CI cell has)
    for name in ("SurrogateGate", "PromotionLadder"):
        monkeypatch.setattr(search, name, functools.partial(
            getattr(search, name), require_calibration=False))
    db_path = tmp_path / "db.jsonl"
    assert dse.build_parser().get_default("strategy") == "ensemble"
    # the cell's eight wgmma tiles are modelled within 1.7x of each other
    # (its ten mma tiles at 1.4-4.0x the fastest), and at a factor of 3.0 the gate
    # prunes none of the designs six iterations propose
    rep = dse.main(["--space", "kernels",
                    "--arch", "flash_attention", "--shape", "attn_s256_gqa_bf16",
                    "--strategy", "ensemble", "--gate-factor", "1.5",
                    "--iterations", "6", "--budget", "3", "--measure-top-k", "2",
                    "--device", "cpu", "--db", str(db_path)])
    rows = CostDB(db_path).all()
    pruned = [d for d in rows if d.status == "pruned"]
    assert pruned and rep["gate"]["active"] and rep["gate"]["pruned"] >= len(pruned)
    assert all(d.reason.startswith("surrogate gate: predicted") for d in pruned)
    # one pruned row per design, and a pruned design never ran
    keys = [d.point["__key__"] for d in pruned]
    assert len(keys) == len(set(keys))
    assert sum(it["pruned"] for it in rep["iterations"]) == rep["gate"]["pruned"]
    sources = {d.source for d in rows if d.fidelity == "dryrun"}
    assert {"search:greedy", "search:anneal", "search:evolve"} & sources
    measured = [d for d in rows if d.fidelity == "measured"]
    assert len(measured) == 2 and all(d.metrics["backend"] == "cpu" for d in measured)
    assert "surrogate gate: active=True" in capsys.readouterr().out
