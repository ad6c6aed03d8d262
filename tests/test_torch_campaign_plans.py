"""repro_torch plan campaigns on the CPU (``launch/campaign.py::run_campaign``).

Against the reference: the grid (``resolve_grid``, ``shard_cells`` for every
``i/n`` up to 4, the unknown ids named), ``cell_supported``'s verdicts and
reasons on every cell, the CLI's flags and defaults (the port's
``--device`` is the one extra), and one campaign on one deterministic stub
evaluator patched into both packages: the same rows, leaderboard,
``BENCH_ladder.json``, reports, heartbeat and summary (apart from clocks,
pids and paths).

The port's own campaign on its real Evaluator (the reduced qwen3-0.6b
under every arch name on 64-token cells, as ``tests/ci/torch_tiny_prelude.py``
sets up shard subprocesses): sweep and resume with no dry run, same-seed
byte identity, two shards and two queue owners merging to one process's
leaderboard byte for byte, the measured tier's rows and their replay
beside the same caches, pool workers given the reduced config, an injected
crash then a rerun completing the grid, and ``--device cuda`` without a
card refused."""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.core.evaluator as jevaluator_mod
from repro.configs import get_config as jget_config
from repro.core.cost_db import DataPoint as JDataPoint
from repro.launch import campaign as jcampaign
from repro.launch import orchestrator as jorch
from repro.models import model as JM
from repro_torch.configs import ARCH_NAMES, SHAPE_BY_NAME, SHAPES, get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.core import evaluator as evaluator_mod
from repro_torch.core import loop as loop_mod
from repro_torch.core.cost_db import CostDB, DataPoint, featurize, workload_features
from repro_torch.core.cost_model import CostModel
from repro_torch.core.design_space import DIMENSIONS
from repro_torch.launch import campaign
from repro_torch.launch.merge_db import merge
from repro_torch.launch.scheduler import CellQueue
from repro_torch.models import model as M

REPO = Path(__file__).resolve().parents[1]
GRID = dict(archs=["qwen3-0.6b", "stablelm-3b"], shapes=["train_4k", "decode_32k"])
QUIET = dict(iterations=1, budget=2, workers=1, verbose=False, device="cpu")


def _read(path):
    return Path(path).read_bytes()


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's in-process campaigns (shard
    subprocesses get one), so that under the suite's parallel workers they
    leave the cores to the tests that time themselves."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the grid, the verdicts, the CLI against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("archs,shapes", [
    ("all", "all"),
    ("qwen3-0.6b,stablelm-3b", "train_4k,decode_32k"),
    ("mamba2-780m,llama3-8b", "long_500k,decode_32k"),
    ("zamba2-2.7b", "all"),
])
def test_grid_and_shards_match_the_reference(archs, shapes):
    grid = campaign.resolve_grid(archs, shapes)
    assert grid == jcampaign.resolve_grid(archs, shapes)
    assert campaign.shard_cells(*grid) == jcampaign.shard_cells(*grid)
    for n in (1, 2, 3, 4):
        parts = [campaign.shard_cells(*grid, (i, n)) for i in range(n)]
        assert parts == [jcampaign.shard_cells(*grid, (i, n)) for i in range(n)]
        assert sorted(c for p in parts for c in p) == campaign.shard_cells(*grid)
    with pytest.raises(ValueError, match="shard index"):
        campaign.shard_cells(*grid, (2, 2))


def test_grid_all_is_the_reference_and_unknown_ids_are_named_alike():
    archs, shapes = campaign.resolve_grid("all", "all")
    assert (len(archs), len(shapes)) == (10, 4)
    supported = [(a, s) for a, s in campaign.shard_cells(archs, shapes)
                 if M.cell_supported(get_config(a), SHAPE_BY_NAME[s])[0]]
    assert len(supported) == 33
    for bad in (("nope,qwen3-0.6b", "train_4k"), ("qwen3-0.6b", "train_4k,zzz"),
                ("x", "y")):
        with pytest.raises(ValueError) as ours:
            campaign.resolve_grid(*bad)
        with pytest.raises(ValueError) as theirs:
            jcampaign.resolve_grid(*bad)
        assert str(ours.value) == str(theirs.value)


def test_unsupported_cells_and_reasons_match_the_reference():
    from repro.configs import SHAPES as JSHAPES

    for a in ARCH_NAMES:
        for s, js in zip(SHAPES, JSHAPES):
            assert M.cell_supported(get_config(a), s) == \
                JM.cell_supported(jget_config(a), js), (a, s.name)


def _flags(ap):
    return {a.dest: (tuple(a.option_strings), a.default, tuple(a.choices or ()), a.type,
                     a.nargs, type(a).__name__)
            for a in ap._actions if a.dest != "help"}


@pytest.mark.parametrize("module", ["campaign", "orchestrator"])
def test_parsers_take_the_reference_flags_and_defaults(module):
    from repro_torch.launch import orchestrator

    ours = _flags({"campaign": campaign, "orchestrator": orchestrator}[module].build_parser())
    theirs = _flags({"campaign": jcampaign, "orchestrator": jorch}[module].build_parser())
    device = ours.pop("device")
    assert ours == theirs
    assert device[1:3] == ("cuda", ("cuda", "cpu"))


def test_cli_refuses_what_the_reference_refuses_and_cuda_without_a_card(tmp_path):
    for extra in (["--queue", "Q", "--shard", "0/2"], ["--archs", "nope"],
                  ["--shapes", "train_4k,zzz"], ["--gate-min-factor", "2.0"],
                  ["--measure-budget", "2"], ["--shard", "2/2"],
                  ["--mesh", "huge"], ["--queue", "Q", "--queue-poll-s", "0"]):
        with pytest.raises(SystemExit) as e:
            campaign.main(["--device", "cpu", "--out", str(tmp_path / "o"), *extra])
        assert e.value.code == 2, extra
        assert not (tmp_path / "o").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            campaign.main(["--archs", "qwen3-0.6b", "--shapes", "train_4k",
                           "--out", str(tmp_path / "o")])


# ---------------------------------------------------------------------------
# one campaign on one stub evaluator, in both packages
# ---------------------------------------------------------------------------
def _factor(k, v) -> float:
    i = list(DIMENSIONS[k]).index(v) if k in DIMENSIONS and v in DIMENSIONS[k] else 0
    return 1.0 + 0.15 * (((3 * i + len(k)) % 5) - 2)


def _stub_evaluator(dp_cls, get_cfg, shapes):
    """An evaluator class for either package's ``run_campaign``: one formula
    from a plan point to its row, and a measured row from its bound."""

    class Stub:
        def __init__(self, mesh=None, mesh_name="", **kw):
            self.mesh = SimpleNamespace(shape={"data": 2, "model": 4})
            self.mesh_shape = {"data": 2, "model": 4}
            self.mesh_name = mesh_name or "small2x4"
            self.cache = None
            self.compile_count = self.pruned_count = 0
            self.measured_count = self.measured_replayed = 0

        def metrics(self, arch, shape, dims):
            terms = {"compute": 0.4, "memory": 0.3, "collective": 0.5}
            for j, (k, v) in enumerate(sorted(dims.items())):
                terms[("compute", "memory", "collective")[j % 3]] *= _factor(k, v)
            gib = 60.0 * np.prod([_factor(k, v) for k, v in sorted(dims.items())
                                  if k in ("remat", "microbatches", "loss_chunk")])
            bound = max(terms.values())
            return {"workload": workload_features(get_cfg(arch), shapes[shape]),
                    **{f"{t}_s": s for t, s in terms.items()}, "bound_s": bound,
                    "dominant": max(terms, key=terms.get), "fits_hbm": bool(gib <= 74.5),
                    "per_device_gib": float(gib), "mfu_at_bound": 0.1 / bound}

        def evaluate(self, arch, shape, point, *, source="explorer", iteration=-1):
            return self.evaluate_batch(arch, shape, [point], source=source,
                                       iteration=iteration)[0]

        def evaluate_batch(self, arch, shape, points, *, source="explorer", iteration=-1,
                           workers=None, gate=None, incumbent_bound=None):
            srcs = [source] * len(points) if isinstance(source, str) else list(source)
            out = []
            for p, s in zip(points, srcs):
                self.compile_count += 1
                m = self.metrics(arch, shape, dict(p.dims))
                out.append(dp_cls(
                    arch=arch, shape=shape, mesh=self.mesh_name,
                    point={**p.to_dict(), "__key__": p.key()},
                    status="ok" if m["fits_hbm"] else "infeasible",
                    reason="" if m["fits_hbm"] else "over the card's memory",
                    metrics=m, source=s, iteration=iteration, ts=float(self.compile_count)))
            return out

        def close(self):
            pass

        def measure(self, arch, shape, point, *, runs=None, modeled_bound_s=None):
            self.measured_count += 1
            bound = self.metrics(arch, shape, dict(point.dims))["bound_s"]
            return dp_cls(arch=arch, shape=shape, mesh=self.mesh_name,
                          point={**point.to_dict(), "__key__": point.key()},
                          status="ok", source="ladder", iteration=-1, fidelity="measured",
                          metrics={"measured_us": bound * 3e6, "backend": "stub",
                                   "bound_s_modeled": modeled_bound_s}, ts=0.0)

    return Stub


VOLATILE = {"ts", "wall_s", "pid", "leaderboard", "bench"}


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in sorted(obj.items()) if k not in VOLATILE}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def test_campaign_on_a_stub_evaluator_matches_the_reference(tmp_path, monkeypatch):
    from repro.configs import SHAPE_BY_NAME as JSHAPE_BY_NAME
    from repro.core.cost_model import init_mlp

    in_dim = featurize({}, {}).shape[0]
    params = {k: np.asarray(v) for k, v in init_mlp(jax.random.key(0), in_dim).items()}
    monkeypatch.setattr(CostModel, "create",
                        classmethod(lambda cls, in_dim, seed=0: cls.from_numpy(params)))
    monkeypatch.setattr(evaluator_mod, "Evaluator",
                        _stub_evaluator(DataPoint, get_config, SHAPE_BY_NAME))
    monkeypatch.setattr(jevaluator_mod, "Evaluator",
                        _stub_evaluator(JDataPoint, jget_config, JSHAPE_BY_NAME))
    grid = dict(archs=["qwen3-0.6b", "mamba2-780m"], shapes=["decode_32k", "long_500k"])
    kw = dict(iterations=2, budget=2, measure_top_k=1, measure_budget=2, verbose=False)
    theirs = jcampaign.run_campaign(**grid, mesh=SimpleNamespace(shape={}),
                                    mesh_name="small2x4", out_dir=tmp_path / "ref", **kw)
    ours = campaign.run_campaign(**grid, mesh="small", out_dir=tmp_path / "port",
                                 device="cpu", **kw)
    assert (ours["ran"], ours["unsupported"], ours["measured"]) == (3, 1, 2)
    assert _scrub(ours) == _scrub(theirs)
    for name in ("leaderboard.json", "BENCH_ladder.json", "progress.json"):
        a = json.loads(_read(tmp_path / "port" / name))
        b = json.loads(_read(tmp_path / "ref" / name))
        assert _scrub(a) == _scrub(b), name
    assert _read(tmp_path / "port" / "leaderboard.json") == \
        _read(tmp_path / "ref" / "leaderboard.json")
    reports = sorted(p.name for p in (tmp_path / "port" / "reports").glob("*.json"))
    assert reports == sorted(p.name for p in (tmp_path / "ref" / "reports").glob("*.json"))
    for name in reports:
        a = json.loads(_read(tmp_path / "port" / "reports" / name))
        b = json.loads(_read(tmp_path / "ref" / "reports" / name))
        assert _scrub(a) == _scrub(b), name
    unsupported = json.loads(_read(tmp_path / "port" / "reports" /
                                   "qwen3-0.6b__long_500k__small2x4.json"))
    assert unsupported["status"] == "unsupported" and "quadratic" in unsupported["reason"]
    rows = [json.loads(ln) for ln in _read(tmp_path / "port" / "cost_db.jsonl").splitlines()]
    jrows = [json.loads(ln) for ln in _read(tmp_path / "ref" / "cost_db.jsonl").splitlines()]
    assert [_scrub(r) for r in rows] == [_scrub(r) for r in jrows]


# ---------------------------------------------------------------------------
# the port's campaign on its real Evaluator, reduced
# ---------------------------------------------------------------------------
TINY_TRAIN = ShapeCell("train_4k", "train", 64, 8)
TINY_DECODE = ShapeCell("decode_32k", "decode", 64, 4)


@pytest.fixture
def tiny(monkeypatch):
    """What ``tests/ci/torch_tiny_prelude.py`` does in a shard subprocess:
    64-token cells under their names, the reduced qwen3-0.6b for every arch
    in the evaluator and the loop (``cell_supported`` reads the real
    configs)."""
    cfg = reduced(get_config("qwen3-0.6b"))
    monkeypatch.setitem(SHAPE_BY_NAME, "train_4k", TINY_TRAIN)
    monkeypatch.setitem(SHAPE_BY_NAME, "decode_32k", TINY_DECODE)
    for mod in (evaluator_mod, loop_mod):
        monkeypatch.setattr(mod, "get_config", lambda name: cfg)
    return cfg


def test_sweep_and_resume_trace_no_dry_run_again(tiny, tmp_path):
    s1 = campaign.run_campaign(**GRID, mesh="tiny", out_dir=tmp_path, **QUIET)
    assert (s1["ran"], s1["resumed"], s1["mesh"]) == (4, 0, "tiny1x1")
    assert s1["compiles"] > 0 and s1["compiles"] == s1["cache"]["misses"]
    lb = json.loads(_read(tmp_path / "leaderboard.json"))
    assert len(lb) == 4 and all(r["status"] == "complete" and r["feasible"] for r in lb)
    assert lb[0]["bound_s"] <= lb[-1]["bound_s"]
    s2 = campaign.run_campaign(**GRID, mesh="tiny", out_dir=tmp_path, **QUIET)
    assert (s2["ran"], s2["resumed"], s2["compiles"], s2["evaluations"]) == (0, 4, 0, 0)
    assert s2["compiles_total"] == s1["compiles"]
    lb2 = json.loads(_read(tmp_path / "leaderboard.json"))
    assert [r.pop("status") for r in lb2] == ["resumed"] * 4
    assert lb2 == [{k: v for k, v in r.items() if k != "status"} for r in lb]
    final = campaign.read_progress(tmp_path)
    assert final["status"] == "done" and final["cell_in_progress"] is None
    bench = json.loads(_read(tmp_path / "BENCH_ladder.json"))
    assert bench["schema"] == "ladder-v1" and len(bench["cells"]) == 4


def test_same_seed_campaigns_are_byte_identical(tiny, tmp_path):
    for run in ("a", "b"):
        campaign.run_campaign(archs=GRID["archs"], shapes=["train_4k"], mesh="tiny",
                              out_dir=tmp_path / run, **QUIET)
    assert _read(tmp_path / "a" / "leaderboard.json") == _read(tmp_path / "b" / "leaderboard.json")
    volatile = {"ts", "compile_s", "wall_s", "lower_s"}

    def scrub(obj):
        if isinstance(obj, dict):
            return {k: scrub(v) for k, v in sorted(obj.items()) if k not in volatile}
        if isinstance(obj, list):
            return [scrub(v) for v in obj]
        return obj

    names = sorted(p.name for p in (tmp_path / "a" / "reports").glob("*.json"))
    assert len(names) == 2
    for name in names:
        assert scrub(json.loads(_read(tmp_path / "a" / "reports" / name))) == \
            scrub(json.loads(_read(tmp_path / "b" / "reports" / name)))


def test_shards_and_queue_owners_merge_to_one_process_byte_for_byte(tiny, tmp_path,
                                                                    monkeypatch):
    one = campaign.run_campaign(**GRID, mesh="tiny", out_dir=tmp_path / "one", **QUIET)
    for i in range(2):
        s = campaign.run_campaign(**GRID, mesh="tiny", out_dir=tmp_path / f"s{i}",
                                  shard=(i, 2), **QUIET)
        assert (s["ran"], s["shard"]) == (2, f"{i}/2")
    m = merge([tmp_path / "s1", tmp_path / "s0"], tmp_path / "merged", verbose=False)
    assert (m["reports"], m["duplicates_dropped"]) == (4, 0)
    want = _read(tmp_path / "one" / "leaderboard.json")
    assert _read(tmp_path / "merged" / "leaderboard.json") == want

    class Died(Exception):
        pass

    def die_after_one(cells_done):
        if cells_done >= 1:
            raise Died

    queue = tmp_path / "queue"
    # owner w0 finishes one cell and dies before completing its ticket
    monkeypatch.setattr(campaign, "_injected_crash_hook", die_after_one)
    with pytest.raises(Died):
        campaign.run_campaign(**GRID, mesh="tiny", out_dir=tmp_path / "w0", queue=queue,
                              queue_owner="w0", **QUIET)
    monkeypatch.setattr(campaign, "_injected_crash_hook", lambda cells_done: None)
    q = CellQueue(queue)
    assert q.counts() == {"pending": 3, "leased": 1, "done": 0}
    assert len(q.release_owner("w0")) == 1
    # w1 drains the queue, replaying w0's finished cell from the queue's cache
    s1 = campaign.run_campaign(**GRID, mesh="tiny", out_dir=tmp_path / "w1", queue=queue,
                               queue_owner="w1", **QUIET)
    assert s1["ran"] == 4 and s1["queue_owner"] == "w1" and q.drained()
    assert s1["compiles"] == one["compiles"] - 3 and s1["cache"]["hits"] == 3
    merge([tmp_path / "w0", tmp_path / "w1"], tmp_path / "qmerged", verbose=False,
          extra_cache_dirs=[q.cache_dir, q.measured_dir])
    assert _read(tmp_path / "qmerged" / "leaderboard.json") == want


def test_measured_rows_replay_beside_the_same_caches(tiny, tmp_path):
    kw = dict(QUIET, measure_top_k=1, measure_runs=1, gate_factor=3.0)
    grid = dict(archs=["qwen3-0.6b"], shapes=["train_4k", "decode_32k"])
    first = campaign.run_campaign(**grid, mesh="small", out_dir=tmp_path, **kw)
    assert (first["ran"], first["measured"], first["measured_replayed"]) == (2, 2, 0)
    db = CostDB(tmp_path / "cost_db.jsonl")
    measured = [d for d in db.all() if d.fidelity == "measured"]
    assert len(measured) == 2 and all(
        d.status == "ok" and d.metrics["backend"] == "cpu" and d.mesh == "small2x4"
        for d in measured)
    lb = json.loads(_read(tmp_path / "leaderboard.json"))
    assert all(r["measured_backend"] == "cpu" and r["measured_us"] > 0 for r in lb)
    bench = json.loads(_read(tmp_path / "BENCH_ladder.json"))
    assert bench["tiers"]["measured"] == 2 and bench["calibration"]["gate_active"] is not None
    # the same command from an empty DB beside the same caches: every dry
    # run and every timing replays, the rows come back byte for byte
    rows = sorted(_read(tmp_path / "cost_db.jsonl").splitlines())
    (tmp_path / "cost_db.jsonl").unlink()
    for rep in (tmp_path / "reports").glob("*.json"):
        rep.unlink()
    again = campaign.run_campaign(**grid, mesh="small", out_dir=tmp_path, **kw)
    assert (again["compiles"], again["measured"], again["measured_replayed"]) == (0, 0, 2)
    replayed = [ln for ln in _read(tmp_path / "cost_db.jsonl").splitlines()
                if b'"fidelity": "measured"' in ln]
    assert len(replayed) == 2 and set(replayed) <= set(rows)
    assert json.loads(_read(tmp_path / "leaderboard.json")) == lb


def test_pool_workers_get_the_reduced_config(tiny, tmp_path):
    """Spawned dry-run workers never see the parent's patches: the reduced
    config travels in their payload, so a pooled campaign writes the serial
    one's leaderboard (the full qwen3-0.6b would give other bounds)."""
    grid = dict(archs=["qwen3-0.6b"], shapes=["decode_32k"])
    kw = dict(QUIET, iterations=1, budget=2)
    campaign.run_campaign(**grid, mesh="small", out_dir=tmp_path / "serial", **kw)
    kw["workers"] = 2
    pooled = campaign.run_campaign(**grid, mesh="small", out_dir=tmp_path / "pool", **kw)
    assert pooled["compiles"] == 3
    assert _read(tmp_path / "pool" / "leaderboard.json") == \
        _read(tmp_path / "serial" / "leaderboard.json")


def test_injected_crash_then_rerun_completes_the_grid(tmp_path):
    token = tmp_path / "crash.token"
    token.write_text("")
    out = tmp_path / "camp"
    argv = [sys.executable, "-m", "repro_torch.launch.campaign", "--archs",
            ",".join(GRID["archs"]), "--shapes", ",".join(GRID["shapes"]), "--mesh", "tiny",
            "--iterations", "1", "--budget", "2", "--workers", "1", "--device", "cpu",
            "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               REPRO_CAMPAIGN_PRELUDE=str(REPO / "tests" / "ci" / "torch_tiny_prelude.py"),
               REPRO_CAMPAIGN_CRASH_TOKEN=str(token), REPRO_CAMPAIGN_CRASH_AFTER_CELLS="2")
    r = subprocess.run(argv, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 86, r.stderr[-2000:]
    assert not token.exists()  # the fault disarmed itself
    assert len(list((out / "reports").glob("*.json"))) == 2
    assert not (out / "leaderboard.json").exists()
    r = subprocess.run(argv, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.loads(_read(out / "progress.json"))
    assert (summary["ran"], summary["resumed"], summary["status"]) == (2, 2, "done")
    assert len(json.loads(_read(out / "leaderboard.json"))) == 4
    assert len(json.loads(_read(out / "BENCH_ladder.json"))["cells"]) == 4
