"""repro_torch's Pareto layer against the reference's: the pure dominance
functions on hypothesis-drawn vectors (orders exact, floats within 1e-12
relative), ``pareto_rows`` / ``CostDB.pareto`` / ``CostDB.front`` and
``build_leaderboard`` in both objective modes on the same rows (identical
order, byte-equal JSON; the Pareto results whatever order the rows were
appended in), and
``make_strategy(..., objective="pareto")``: the same members, proposing
what the reference's propose on the same rows and seeds."""
import json
import random

import pytest

from _hypothesis_compat import given, settings, strategies as st
from repro import search as jsearch
from repro.core import design_space as jds
from repro.core import kernel_space as jks
from repro.core import pareto as jpareto
from repro.core.cost_db import CostDB as JCostDB
from repro.core.cost_db import DataPoint as JDataPoint
from repro.core.cost_db import pareto_rows as j_pareto_rows
from repro.core.promotion import plan_front_promotions as j_plan_front_promotions
from repro.launch.campaign import build_leaderboard as j_build_leaderboard
from repro_torch import search
from repro_torch.core import kernel_space as ks
from repro_torch.core import pareto
from repro_torch.core.cost_db import CostDB, DataPoint, pareto_rows
from repro_torch.core.design_space import KernelPoint, KernelTemplate
from repro_torch.core.promotion import plan_front_promotions
from repro_torch.launch.campaign import build_leaderboard

CELLS = ["attn_s256_gqa_bf16", "ssd_s256_f32", "rms_512x512_f32"]


def _metrics(dims):
    """Deterministic kernel-row metrics for a tile point: a bound and the
    resource model's vmem/alignment fields, from the point's key hash."""
    h = int(KernelPoint(dims=dims).key()[:8], 16)
    bound = 1e-5 * (1 + h % 13 / 4)
    return {"bound_s": bound, "est_latency_us": bound * 1e6, "fits_hbm": True,
            "vmem_util": (h >> 4) % 9 / 10, "mxu_aligned": (h >> 8) % 2 == 0,
            "vpu_aligned": (h >> 9) % 3 != 0}


def _row(cls, kshape, dims, *, status="ok", source="expert", iteration=0, ts=1.0,
         fidelity="dryrun", extra=None):
    point = dict(dims)
    point["__key__"] = KernelPoint(dims=dims).key()
    m = {"workload": ks.kernel_workload(kshape), **_metrics(dims), **(extra or {})}
    return cls(arch=ks.kernel_arch(kshape.kernel), shape=kshape.name, mesh="dev1",
               point=point, status=status, metrics=m, source=source,
               iteration=iteration, ts=ts, fidelity=fidelity)


def _rows(cls):
    """Every tile of three cells, with duplicates of some designs (a later
    and an equal-ts copy), failed and measured rows, a row that fails the
    resource gate, and rows whose objectives are stored, not derived."""
    out = []
    for kshape in (ks.KERNEL_SHAPE_BY_NAME[n] for n in CELLS):
        for i, dims in enumerate(ks.tile_grid(kshape)):
            status = "infeasible" if i % 7 == 3 else "ok"
            out.append(_row(cls, kshape, dims, status=status, iteration=i,
                            ts=float(i % 4)))
            if i % 5 == 1:
                out.append(_row(cls, kshape, dims, iteration=i + 1, ts=float(i % 4),
                                source="search:anneal"))
            if i % 6 == 2:
                out.append(_row(cls, kshape, dims, fidelity="measured", ts=50.0 + i,
                                extra={"measured_s": 1e-4, "measured_us": 100.0,
                                       "backend": "cpu"}))
            if i % 9 == 4:
                out.append(_row(cls, kshape, dims, ts=60.0, extra={"fits_hbm": False}))
            if i % 8 == 5:
                out.append(_row(cls, kshape, dims, ts=70.0 + i, extra={
                    "objectives": {"bound_s": 2e-5, "vmem_util": 0.05}}))
    return out


def _tuples(ranked):
    return [(d.to_json(), rank, crowd, objs) for d, rank, crowd, objs in ranked]


# ---------------------------------------------------------------------------
# the pure functions on drawn vectors
# ---------------------------------------------------------------------------
@settings(max_examples=60, deadline=None)
@given(dim=st.integers(1, 3),
       raw=st.lists(st.tuples(st.integers(0, 5), st.integers(0, 5), st.integers(0, 5),
                              st.integers(0, 3)), min_size=0, max_size=14))
def test_pareto_functions_match_the_reference(dim, raw):
    # small integer grids scaled to floats: ties and duplicates are common
    vectors = [tuple(v / 3.0 for v in r[:dim]) for r in raw]
    tiebreaks = [(float(r[3]), f"row{i % 5}") for i, r in enumerate(raw)]
    assert pareto.front_ranks(vectors) == jpareto.front_ranks(vectors)
    assert pareto.crowding_distances(vectors) == pytest.approx(
        jpareto.crowding_distances(vectors), rel=1e-12)
    order, ranks, crowd = pareto.front_order(vectors, tiebreaks)
    jorder, jranks, jcrowd = jpareto.front_order(vectors, tiebreaks)
    assert (order, ranks) == (jorder, jranks)
    assert crowd == pytest.approx(jcrowd, rel=1e-12)
    for a in vectors[:6]:
        for b in vectors[:6]:
            assert pareto.dominates(a, b) == jpareto.dominates(a, b)
    ref = tuple(2.0 for _ in range(dim))
    assert pareto.hypervolume(vectors, ref) == pytest.approx(
        jpareto.hypervolume(vectors, ref), rel=1e-12)


def test_front_order_refuses_mismatched_tiebreaks():
    with pytest.raises(ValueError):
        pareto.front_order([(1.0,), (2.0,)], [(0.0, "a")])


# ---------------------------------------------------------------------------
# the DB's Pareto queries and the leaderboard on the same rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shuffle_seed", [None, 0, 1])
def test_pareto_rows_front_and_leaderboard_match_the_reference(shuffle_seed, tmp_path):
    rows, jrows = _rows(DataPoint), _rows(JDataPoint)
    if shuffle_seed is not None:
        # the port's DB gets the rows in another order: the result is a
        # function of the row set
        random.Random(shuffle_seed).shuffle(rows)
    db, jdb = CostDB(tmp_path / "p.jsonl"), JCostDB(tmp_path / "j.jsonl")
    db.append_many(rows)
    jdb.append_many(jrows)
    cell_rows = []
    for name in CELLS:
        arch = ks.kernel_arch(ks.KERNEL_SHAPE_BY_NAME[name].kernel)
        cell_rows.append({"arch": arch, "shape": name, "mesh": "dev1",
                          "status": "complete", "improvement": 0.5})
        cell, jcell = db.query(arch, name), jdb.query(arch, name)
        assert _tuples(pareto_rows(cell)) == _tuples(j_pareto_rows(jcell))
        assert _tuples(db.pareto(arch, name, mesh="dev1")) == \
            _tuples(jdb.pareto(arch, name, mesh="dev1"))
        for k in (None, 1, 3):
            got = [d.to_json() for d in db.front(arch, name, k=k, mesh="dev1")]
            assert got == [d.to_json() for d in jdb.front(arch, name, k=k, mesh="dev1")]
        measured = {d.point["__key__"] for d in cell if d.fidelity == "measured"}
        for top_k, budget in ((2, None), (3, 1), (0, None)):
            got = plan_front_promotions(db.front(arch, name, k=4), measured,
                                        top_k=top_k, budget_left=budget)
            want = j_plan_front_promotions(jdb.front(arch, name, k=4), measured,
                                           top_k=top_k, budget_left=budget)
            assert [d.to_json() for d in got] == [d.to_json() for d in want]
    # the rows make real fronts: several ranks, and a front of more than one
    ranked = db.pareto(cell_rows[0]["arch"], CELLS[0])
    assert max(r for _, r, _, _ in ranked) >= 1
    assert sum(r == 0 for _, r, _, _ in ranked) >= 2
    # the scalar mode's best breaks bound ties by file order, so it is held
    # to the reference on the same order only; the front on any order
    for objective in ("pareto",) if shuffle_seed is not None else ("bound_s", "pareto"):
        got = json.dumps(build_leaderboard(db, cell_rows, objective=objective),
                         indent=1, default=str)
        want = json.dumps(j_build_leaderboard(jdb, cell_rows, objective=objective),
                          indent=1, default=str)
        assert got == want
    lb = build_leaderboard(db, cell_rows, objective="pareto")
    assert all(r["front_size"] >= 1 and r["measured_backend"] == "cpu" for r in lb)
    with pytest.raises(ValueError, match="objective must be one of"):
        build_leaderboard(db, cell_rows, objective="hypervolume")


# ---------------------------------------------------------------------------
# the weight-armed strategies
# ---------------------------------------------------------------------------
def test_pareto_strategies_have_the_reference_members():
    assert search.WEIGHT_ARMS == jsearch.WEIGHT_ARMS
    for name in ("greedy", "anneal", "evolve", "ensemble"):
        ours = search.make_strategy(name, seed=5, objective="pareto")
        theirs = jsearch.make_strategy(name, seed=5, objective="pareto")
        if name == "ensemble":
            assert [(m.name, m.seed, getattr(m, "weights", None)) for m in ours.members] \
                == [(m.name, m.seed, getattr(m, "weights", None)) for m in theirs.members]
            assert [m.name for m in ours.members] == [
                "greedy", "anneal", "evolve", "anneal@latency", "anneal@memory",
                "evolve@latency", "evolve@memory"]
        else:
            assert ours.name == theirs.name
            assert getattr(ours, "weights", None) == getattr(theirs, "weights", None)
    with pytest.raises(ValueError, match="unknown objective"):
        search.make_strategy("anneal", objective="hypervolume")


@pytest.mark.parametrize("name", ["anneal", "evolve", "ensemble"])
@pytest.mark.parametrize("shape", ["attn_s256_gqa_bf16", "ssd_s256_f32"])
def test_pareto_strategies_propose_what_the_reference_proposes(name, shape, tmp_path,
                                                               monkeypatch):
    kshape, jshape = ks.KERNEL_SHAPE_BY_NAME[shape], jks.KERNEL_SHAPE_BY_NAME[shape]
    monkeypatch.setattr(ks, "kernel_resources",
                        lambda s, d, device=None: jks.kernel_resources(jshape, d))
    t, jt = KernelTemplate(kshape), jds.KernelTemplate(jshape)
    seed_dims = ks.default_kernel_dims(kshape)
    db, jdb = CostDB(tmp_path / "p.jsonl"), JCostDB(tmp_path / "j.jsonl")
    db.append(_row(DataPoint, kshape, seed_dims))
    jdb.append(_row(JDataPoint, kshape, seed_dims))
    ours = search.make_strategy(name, seed=3, objective="pareto")
    theirs = jsearch.make_strategy(name, seed=3, objective="pareto")
    inc, jinc = db.all()[0], jdb.all()[0]
    for it in range(1, 6):
        kw = dict(arch=inc.arch, shape=shape, cfg=None, cell=None, iteration=it,
                  budget=4, workload=ks.kernel_workload(kshape), mesh="dev1")
        st_ = search.SearchState(template=t, db=db, incumbent=inc, pool=[inc], **kw)
        jst = jsearch.SearchState(template=jt, db=jdb, incumbent=jinc, pool=[jinc], **kw)
        got = search.select_candidates(st_, ours.propose(st_))
        want = jsearch.select_candidates(jst, theirs.propose(jst))
        assert [(dict(c.point.dims), c.source) for c in got] == \
            [(dict(c.point.dims), c.source) for c in want], it
        rows = [_row(DataPoint, kshape, dict(c.point.dims), source=c.source,
                     iteration=it, ts=float(it),
                     status="infeasible" if i == 2 else "ok")
                for i, c in enumerate(got)]
        jrows = [_row(JDataPoint, kshape, dict(c.point.dims), source=c.source,
                      iteration=it, ts=float(it),
                      status="infeasible" if i == 2 else "ok")
                 for i, c in enumerate(got)]
        db.append_many(rows)
        jdb.append_many(jrows)
        ours.observe(rows)
        theirs.observe(jrows)
        # the incumbent follows the front head, as the pareto leaderboard does
        inc = db.front(inc.arch, shape, k=1)[0]
        jinc = jdb.front(jinc.arch, shape, k=1)[0]
        assert inc.to_json() == jinc.to_json()
    if name == "ensemble":
        assert ours.credit == pytest.approx(theirs.credit, rel=1e-12)
        assert {m for m in ours.credit} >= {"anneal@latency", "evolve@memory"}
