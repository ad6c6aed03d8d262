"""repro_torch kernel campaigns on the CPU: ``run_kernel_campaign`` against
the reference's on the same cells, strategies and surrogate parameters
(the same DB rows, leaderboards in both objective modes and
``BENCH_kernels.json`` cells); and the port's own campaign properties:
shard merges in either order equal a single-process run byte for byte,
queue mode with two owners in turn equals the static run, a rerun resumes
every cell with no evaluation, an injected crash then a rerun completes
the grid, an injected bad tile ends ``infeasible`` and counted, and the
CLI refuses what the reference's refuses. Small cells only (vecmul and
rmsnorm at CI sizes), no process pools."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import kernel_space as jks
from repro.core.cost_db import CostDB as JCostDB
from repro.core.cost_model import init_mlp
from repro.launch import kernel_cell as jkc
from repro_torch.core import kernel_space as ks
from repro_torch.core.cost_db import CostDB, featurize
from repro_torch.core.cost_model import CostModel
from repro_torch.kernels.conformance import INJECT_ENV
from repro_torch.launch import campaign, kernel_cell
from repro_torch.launch.merge_db import merge
from repro_torch.launch.scheduler import CellQueue

REPO = Path(__file__).resolve().parents[1]
KERNELS = ["vecmul", "rmsnorm"]
SHAPES = ["vec_64k_f32", "rms_512x512_f32", "rms_1kx256_bf16"]
QUIET = dict(iterations=1, budget=2, seed=0, verbose=False, device="cpu")


def _rows(db):
    return [(r.point["__key__"], r.status, r.metrics.get("bound_s"), r.source,
             r.iteration) for r in db.all()]


def _read(path):
    return Path(path).read_bytes()


@pytest.fixture
def reference_numbers(monkeypatch):
    """Hold the port to the reference's resource model and start its
    surrogate from the reference's initial parameters."""
    monkeypatch.setattr(ks, "kernel_resources", lambda s, d, device=None:
                        jks.kernel_resources(jks.KERNEL_SHAPE_BY_NAME[s.name], d))
    in_dim = featurize({}, {}).shape[0]
    params = {k: np.asarray(v) for k, v in init_mlp(jax.random.key(0), in_dim).items()}
    monkeypatch.setattr(CostModel, "create",
                        classmethod(lambda cls, in_dim, seed=0: cls.from_numpy(params)))


# ---------------------------------------------------------------------------
# the campaign against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("strategy", ["greedy", "ensemble"])
@pytest.mark.parametrize("objective", ["bound_s", "pareto"])
def test_campaign_matches_the_reference(strategy, objective, tmp_path, reference_numbers):
    kw = dict(iterations=1, budget=2, strategy=strategy, objective=objective, seed=0,
              verbose=False)
    jsum = jkc.run_kernel_campaign(KERNELS, SHAPES, out_dir=tmp_path / "ref", **kw)
    summ = kernel_cell.run_kernel_campaign(KERNELS, SHAPES, out_dir=tmp_path / "port",
                                           device="cpu", **kw)
    assert _rows(CostDB(tmp_path / "port" / "cost_db.jsonl")) == \
        _rows(JCostDB(tmp_path / "ref" / "cost_db.jsonl"))
    for key in ("cells", "ran", "resumed", "evaluations", "compiles", "correctness"):
        assert summ[key] == jsum[key], key
    # no measured tier here, so no field of the leaderboard is filled by a
    # clock or a backend
    assert _read(tmp_path / "port" / "leaderboard.json") == \
        _read(tmp_path / "ref" / "leaderboard.json")
    bench = json.loads(_read(tmp_path / "port" / "BENCH_kernels.json"))
    jbench = json.loads(_read(tmp_path / "ref" / "BENCH_kernels.json"))
    assert bench["cells"] == jbench["cells"] and len(bench["cells"]) == 3
    assert bench["correctness"] == jbench["correctness"]
    lb = json.loads(_read(tmp_path / "port" / "leaderboard.json"))
    assert all(r["feasible"] for r in lb)
    if objective == "pareto":
        assert all(r["objective"] == "pareto" and r["front_size"] >= 1 for r in lb)


def test_grid_resolution_matches_the_reference():
    assert kernel_cell.resolve_kernel_grid("all", "all") == \
        jkc.resolve_kernel_grid("all", "all")
    # full-width shapes are named, never pulled in by 'all'
    _, shapes = kernel_cell.resolve_kernel_grid("all", "all")
    assert not {s.name for s in ks.FULL_WIDTH_KERNEL_SHAPES} & set(shapes)
    assert kernel_cell.resolve_kernel_grid("vecmul", "vec_16m_f32,vec_64k_f32") == \
        (["vecmul"], ["vec_16m_f32", "vec_64k_f32"])
    for args in (("vecmul,nope", "all"), ("vecmul", "not_a_shape")):
        with pytest.raises(ValueError, match="unknown kernel/shape"):
            kernel_cell.resolve_kernel_grid(*args)
    kernels, shapes = kernel_cell.resolve_kernel_grid("all", "all")
    cells = kernel_cell.kernel_grid_cells(kernels, shapes)
    assert cells == jkc.kernel_grid_cells(kernels, shapes)
    for i in range(3):
        assert kernel_cell.kernel_grid_cells(kernels, shapes, (i, 3)) == \
            jkc.kernel_grid_cells(kernels, shapes, (i, 3))
    with pytest.raises(ValueError, match="shard index"):
        kernel_cell.kernel_grid_cells(kernels, shapes, (3, 3))


# ---------------------------------------------------------------------------
# shards, the queue, resume
# ---------------------------------------------------------------------------
def test_shard_merges_are_order_invariant_and_equal_one_process(tmp_path):
    kw = dict(strategy="ensemble", gate_factor=3.0, **QUIET)
    kernel_cell.run_kernel_campaign(KERNELS, SHAPES, out_dir=tmp_path / "one", **kw)
    for i in range(2):
        kernel_cell.run_kernel_campaign(KERNELS, SHAPES, out_dir=tmp_path / f"s{i}",
                                        shard=(i, 2), **kw)
    merge([tmp_path / "s0", tmp_path / "s1"], tmp_path / "ab", verbose=False)
    merge([tmp_path / "s1", tmp_path / "s0"], tmp_path / "ba", verbose=False)
    one = _read(tmp_path / "one" / "leaderboard.json")
    assert _read(tmp_path / "ab" / "leaderboard.json") == one
    assert _read(tmp_path / "ba" / "leaderboard.json") == one
    assert _read(tmp_path / "ab" / "cost_db.jsonl") == _read(tmp_path / "ba" / "cost_db.jsonl")
    assert len(json.loads(one)) == 3
    for objective in ("bound_s", "pareto"):
        merge([tmp_path / "s1", tmp_path / "s0"], tmp_path / f"m_{objective}",
              verbose=False, objective=objective)
    assert b'"front"' in _read(tmp_path / "m_pareto" / "leaderboard.json")
    assert _read(tmp_path / "m_bound_s" / "leaderboard.json") == one


def test_queue_owners_in_turn_match_the_static_run(tmp_path, monkeypatch):
    kw = dict(strategy="greedy", **QUIET)
    kernel_cell.run_kernel_campaign(KERNELS, SHAPES, out_dir=tmp_path / "static", **kw)

    class Died(Exception):
        pass

    def die_after_one(cells_done):
        if cells_done >= 1:
            raise Died

    queue = tmp_path / "queue"
    # owner w0 finishes one cell and dies before completing its ticket
    monkeypatch.setattr(kernel_cell, "_injected_crash_hook", die_after_one)
    with pytest.raises(Died):
        kernel_cell.run_kernel_campaign(KERNELS, SHAPES, out_dir=tmp_path / "w0",
                                        queue=queue, queue_owner="w0", **kw)
    monkeypatch.undo()
    q = CellQueue(queue)
    assert q.counts() == {"pending": 2, "leased": 1, "done": 0}
    # the supervisor reclaims w0's lease; w1 drains the queue, replaying
    # w0's finished cell from the queue's shared cache
    assert len(q.release_owner("w0")) == 1
    s1 = kernel_cell.run_kernel_campaign(KERNELS, SHAPES, out_dir=tmp_path / "w1",
                                         queue=queue, queue_owner="w1", **kw)
    assert s1["ran"] == 3 and s1["queue_owner"] == "w1" and q.drained()
    assert s1["cache"]["hits"] >= 1
    merge([tmp_path / "w0", tmp_path / "w1"], tmp_path / "merged", verbose=False,
          extra_cache_dirs=[q.cache_dir, q.measured_dir])
    assert _read(tmp_path / "merged" / "leaderboard.json") == \
        _read(tmp_path / "static" / "leaderboard.json")
    with pytest.raises(ValueError, match="mutually exclusive"):
        kernel_cell.run_kernel_campaign(KERNELS, SHAPES, out_dir=tmp_path / "x",
                                        queue=queue, shard=(0, 2), **kw)


def test_rerun_resumes_every_cell_with_no_evaluation(tmp_path):
    kw = dict(strategy="ensemble", measure_top_k=1, measure_runs=1, **QUIET)
    first = kernel_cell.run_kernel_campaign(KERNELS, SHAPES, out_dir=tmp_path, **kw)
    assert first["ran"] == 3 and first["measured"] == 3
    lb = _read(tmp_path / "leaderboard.json")
    again = kernel_cell.run_kernel_campaign(KERNELS, SHAPES, out_dir=tmp_path, **kw)
    assert (again["ran"], again["resumed"]) == (0, 3)
    assert (again["evaluations"], again["compiles"], again["measured"]) == (0, 0, 0)
    assert again["evaluations_total"] == first["evaluations_total"]
    # the same leaderboard, each cell now marked resumed
    rows, again_rows = json.loads(lb), json.loads(_read(tmp_path / "leaderboard.json"))
    assert [r.pop("status") for r in again_rows] == ["resumed"] * 3
    assert again_rows == [{k: v for k, v in r.items() if k != "status"} for r in rows]
    assert all(r["measured_backend"] == "cpu" for r in rows)
    progress = campaign.read_progress(tmp_path)
    assert progress["status"] == "done" and progress["resumed"] == 3


def test_injected_crash_then_rerun_completes_the_grid(tmp_path):
    token = tmp_path / "crash.token"
    token.write_text("")
    out = tmp_path / "camp"
    argv = [sys.executable, "-m", "repro_torch.launch.campaign", "--archs",
            ",".join(KERNELS), "--shapes", ",".join(SHAPES), "--iterations", "1",
            "--budget", "2", "--strategy", "greedy", "--device", "cpu",
            "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_CAMPAIGN_CRASH_TOKEN=str(token),
               REPRO_CAMPAIGN_CRASH_AFTER_CELLS="2")
    r = subprocess.run(argv, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 86, r.stderr[-2000:]
    assert not token.exists()  # the fault disarmed itself
    assert len(list((out / "reports").glob("*.json"))) == 2
    assert not (out / "leaderboard.json").exists()
    summary = campaign.main(argv[3:])
    assert (summary["ran"], summary["resumed"]) == (1, 2)
    assert len(json.loads(_read(out / "leaderboard.json"))) == 3
    assert len(json.loads(_read(out / "BENCH_kernels.json"))["cells"]) == 3


def test_injected_bad_default_tile_is_rejected_and_counted(tmp_path, monkeypatch):
    kshape = ks.KERNEL_SHAPE_BY_NAME["vec_64k_f32"]
    block = ks.default_kernel_dims(kshape)["block"]
    monkeypatch.setenv(INJECT_ENV, f"vecmul:block={block}")
    summ = kernel_cell.run_kernel_campaign(["vecmul"], ["vec_64k_f32"], out_dir=tmp_path,
                                           strategy="greedy", **QUIET)
    base = next(d for d in CostDB(tmp_path / "cost_db.jsonl").all() if d.source == "expert")
    assert base.status == "infeasible" and base.point["block"] == block
    assert base.reason.startswith("correctness gate")
    assert summ["correctness"]["rejected"] == 1
    bench = json.loads(_read(tmp_path / "BENCH_kernels.json"))
    assert bench["correctness"]["rejected"] == 1
    assert bench["cells"][0]["tuned_point"]["block"] != block


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [
    ["--queue", "Q", "--shard", "0/2"],
    ["--strategy", "llm"],
    ["--shapes", "vec_64k_f32,not_a_shape"],
    ["--gate-min-factor", "2.0"],
    ["--gate-factor", "1.0"],
    ["--measure-budget", "2"],
    ["--shard", "2/2"],
    ["--objective", "hypervolume"],
])
def test_cli_refuses_what_the_reference_refuses(extra, tmp_path):
    argv = ["--archs", "vecmul", "--device", "cpu", "--out", str(tmp_path / "o"), *extra]
    with pytest.raises(SystemExit) as e:
        campaign.main(argv)
    assert e.value.code == 2
    assert not (tmp_path / "o").exists()


def test_cli_defaults_and_the_card(tmp_path):
    ap = campaign.build_parser()
    assert (ap.get_default("archs"), ap.get_default("shapes"),
            ap.get_default("strategy"), ap.get_default("device")) == \
        ("all", "all", "ensemble", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            campaign.main(["--archs", "vecmul", "--out", str(tmp_path / "o")])
