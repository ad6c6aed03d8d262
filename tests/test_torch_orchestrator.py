"""repro_torch's orchestrator: the thirteen tests of ``tests/test_orchestrator.py``
and the steal rule of ``tests/test_queue_mode.py`` on the port's module,
and the one-card-a-measuring-shard rule.

CLI surface and specs (no subprocess): the parser's flags and defaults,
``--inject-kill`` and shard specs, the shard command replaying every
campaign flag (``--device`` included) and parsing against the port's
campaign CLI, shard dirs, bad specs refused, the heartbeat file, the
aggregated leaderboard, the steal rule as a pure function, and local
shards that would share a card refused when they measure.

End to end (real shard subprocesses of ``python -m
repro_torch.launch.campaign`` on the reduced qwen3-0.6b of
``tests/ci/torch_tiny_prelude.py``, a 4-cell grid on the tiny mesh, the
CPU): an unhealable shard fails fast, a killed shard heals and the merged
leaderboard is byte-identical to an uninterrupted run and to the manual
shard+merge flow, and a cell slower than ``--hang-timeout`` (every dry
run sleeps) is not killed. The queue-mode heal, the steal and the
loopback executor are in ``tests/test_torch_orchestrator_queue.py``.
Shard processes run with one thread each."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro_torch.launch import campaign as camp
from repro_torch.launch import executors
from repro_torch.launch import orchestrator as orch
from repro_torch.launch.campaign import parse_shard, read_progress, write_progress
from repro_torch.launch.scheduler import CellQueue

REPO = Path(__file__).resolve().parents[1]
PRELUDE = REPO / "tests" / "ci" / "torch_tiny_prelude.py"
GRID = dict(archs="qwen3-0.6b,stablelm-3b", shapes="train_4k,decode_32k",
            mesh="tiny", iterations=1, budget=2, workers=1, device="cpu")


def manual_flow(tmp, grid, shards=2):
    """The manual ``--shard i/n`` + ``merge_db`` flow: the leaderboard bytes
    every supervised run must reproduce."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1",
           "REPRO_CAMPAIGN_PRELUDE": str(PRELUDE)}
    env.pop("REPRO_TEST_EVAL_SLEEP_S", None)
    procs = []
    for i in range(shards):
        cmd = orch.build_shard_cmd(
            i, shards, tmp / f"manual{i}", archs=grid["archs"], shapes=grid["shapes"],
            mesh=grid["mesh"], iterations=grid["iterations"], budget=grid["budget"],
            workers=1, strategy="ensemble", gate_factor=None, llm="mock", device="cpu")
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, env=env))
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, out + err[-2000:]
    from repro_torch.launch.merge_db import merge

    merge([tmp / f"manual{i}" for i in range(shards)], tmp / "merged", verbose=False)
    return (tmp / "merged" / "leaderboard.json").read_bytes()


@pytest.fixture(scope="module")
def static_reference(tmp_path_factory):
    return manual_flow(tmp_path_factory.mktemp("static_ref"), GRID)


@pytest.fixture
def tiny_shards(monkeypatch):
    monkeypatch.setenv("REPRO_CAMPAIGN_PRELUDE", str(PRELUDE))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


# ---------------------------------------------------------------------------
# CLI surface + spec parsing (no subprocesses)
# ---------------------------------------------------------------------------
def test_build_parser_flags_and_defaults():
    ns = orch.build_parser().parse_args(
        ["--archs", "all", "--shapes", "all", "--shards", "2", "--out", "artifacts/run"])
    assert ns.shards == 2 and ns.strategy == "ensemble" and ns.device == "cuda"
    assert ns.max_restarts == 2 and ns.hang_timeout == 300.0
    assert ns.executor == "local" and ns.hosts is None
    ns2 = orch.build_parser().parse_args(
        ["--executor", "ssh", "--hosts", "h0,h1", "--remote-root", "/scratch/run"])
    assert ns2.executor == "ssh" and ns2.hosts == "h0,h1"
    assert orch.build_parser().parse_args(["--executor", "loopback"]).executor == "loopback"
    ns3 = orch.build_parser().parse_args(["--queue", "--steal-factor", "3", "--steal-min-s",
                                          "5", "--max-steals", "1", "--queue-lease-s", "60"])
    assert ns3.queue and ns3.steal_factor == 3.0 and ns3.steal_min_s == 5.0
    assert ns3.max_steals == 1 and ns3.queue_lease_s == 60.0
    assert not orch.build_parser().parse_args([]).queue  # static by default
    for bad in (["--strategy", "nope"], ["--mesh", "huge"], ["--executor", "k8s"],
                ["--device", "tpu"]):
        with pytest.raises(SystemExit):
            orch.build_parser().parse_args(bad)


def test_parse_inject_kill_and_shard_specs():
    assert orch.parse_inject_kill(None) is None
    assert orch.parse_inject_kill("0:1") == (0, 1)
    assert orch.parse_inject_kill("3:7") == (3, 7)
    for bad in ("1", "a:b", "0:0", "-1:2"):
        with pytest.raises(ValueError):
            orch.parse_inject_kill(bad)
    assert parse_shard(None) is None
    assert parse_shard("1/4") == (1, 4)
    for bad in ("x/y", "4/4", "1-4"):
        with pytest.raises(ValueError):
            parse_shard(bad)


@pytest.mark.parametrize("space,queue", [("plans", False), ("plans", True),
                                         ("kernels", False), ("kernels", True)])
def test_build_shard_cmd_replays_every_campaign_flag(space, queue, tmp_path):
    kw = dict(archs="all", shapes="all", mesh="pod", iterations=3, budget=4, workers=5,
              strategy="greedy", gate_factor=2.5, gate_min_factor=1.5, llm="ollama",
              measure_top_k=2, measure_runs=4, measure_budget=7, queue_lease_s=120.0,
              space=space, objective="pareto", device="cpu")
    cmd = orch.build_shard_cmd(1, 3, tmp_path / "s1",
                               queue_dir=tmp_path / "q" if queue else None, **kw)
    assert cmd[:3] == [sys.executable, "-m", "repro_torch.launch.campaign"]
    ns = camp.build_parser().parse_args(cmd[3:])  # parses against the campaign CLI
    for k, v in kw.items():
        if k != "queue_lease_s" or queue:
            assert getattr(ns, k) == v, k
    assert ns.out == str(tmp_path / "s1")
    if queue:
        assert ns.shard is None and ns.queue == str((tmp_path / "q").resolve())
        assert ns.queue_owner == "shard1"
    else:
        assert ns.shard == "1/3" and ns.queue is None
    # defaults stay off the command line, as the reference's do
    plain = orch.build_shard_cmd(0, 1, tmp_path / "s0", archs="a", shapes="b", mesh="tiny",
                                 iterations=1, budget=1, workers=1, strategy="ensemble",
                                 gate_factor=None, llm="mock")
    assert "--space" not in plain and "--objective" not in plain
    assert "--measure-top-k" not in plain and plain[plain.index("--device") + 1] == "cuda"


def test_shard_dirs_never_alias_out(tmp_path):
    dirs = orch.shard_dirs_for(tmp_path / "run", 3)
    assert len(dirs) == 3 and len(set(dirs)) == 3
    assert all(d != tmp_path / "run" for d in dirs)
    assert all(d.parent == tmp_path / "run" / "shards" for d in dirs)


def test_run_orchestrator_rejects_bad_specs(tmp_path):
    bad = [dict(archs="nope-arch", shapes="train_4k", shards=1),
           dict(archs="qwen3-0.6b", shapes="train_4k", shards=0),
           dict(archs="qwen3-0.6b", shapes="train_4k", shards=2, inject_kill=(5, 1)),
           dict(archs="qwen3-0.6b", shapes="train_4k", shards=1, executor="ssh"),
           dict(archs="qwen3-0.6b", shapes="train_4k", shards=1, executor="ssh",
                hosts=["h0"], inject_kill=(0, 1)),
           dict(archs="qwen3-0.6b", shapes="train_4k", shards=1, queue=True,
                executor="ssh", hosts=["h0"], remote_root="/scratch/elsewhere"),
           dict(archs="qwen3-0.6b", shapes="train_4k", shards=1, device="tpu")]
    for kw in bad:
        with pytest.raises(ValueError):
            orch.run_orchestrator(out_dir=tmp_path / "x", **kw)
    assert not (tmp_path / "x" / "summary.json").exists()  # failed fast


def test_measuring_shards_that_would_share_a_card_are_refused(tmp_path, monkeypatch,
                                                              capsys):
    """Two local shards measuring on cuda need two cards: with one (stubbed)
    card the API and the CLI refuse, naming why; with --measure-top-k 0, on
    the CPU, or with a card a shard, the rule lets them run."""
    monkeypatch.setattr(executors, "visible_cards", lambda: ["0"])
    monkeypatch.setattr(orch, "visible_cards", lambda: ["0"])
    with pytest.raises(ValueError, match="share 1 card"):
        orch.run_orchestrator(archs="qwen3-0.6b", shapes="train_4k", shards=2,
                              out_dir=tmp_path / "x", measure_top_k=1)
    with pytest.raises(SystemExit) as e:
        orch.main(["--shards", "2", "--measure-top-k", "1", "--out", str(tmp_path / "x")])
    assert e.value.code == 2 and "90% of a card" in capsys.readouterr().err
    assert not (tmp_path / "x").exists()
    for kw in (dict(measure_top_k=0, device="cuda", shards=4),
               dict(measure_top_k=1, device="cpu", shards=4),
               dict(measure_top_k=1, device="cuda", shards=1)):
        assert orch.validate_card_args(executor="local", cards=["0"], **kw) is None
    assert orch.validate_card_args(1, "cuda", "ssh", 4, []) is None  # remote hosts' cards
    assert "0 card(s)" in orch.validate_card_args(1, "cuda", "local", 1, [])


# ---------------------------------------------------------------------------
# heartbeat file contract and the aggregated view
# ---------------------------------------------------------------------------
def test_progress_roundtrip_and_torn_reads(tmp_path):
    assert read_progress(tmp_path) == {}  # missing file = no news
    write_progress(tmp_path, {"cells_done": 2, "ts": 1.0})
    assert read_progress(tmp_path)["cells_done"] == 2
    (tmp_path / "progress.json").write_text('{"cells_done": ')  # torn
    assert read_progress(tmp_path) == {}
    write_progress(tmp_path, {"cells_done": 3, "ts": 2.0})
    assert [p.name for p in tmp_path.glob("*.tmp")] == []


def test_aggregate_best_merges_shard_heartbeats(tmp_path):
    a = orch.ShardProc(index=0, out_dir=tmp_path, cmd=[], env={})
    b = orch.ShardProc(index=1, out_dir=tmp_path, cmd=[], env={})
    a.last_payload = {"best": [{"cell": "x/s", "bound_s": 2.0},
                              {"cell": "y/s", "bound_s": None}]}
    b.last_payload = {"best": [{"cell": "z/s", "bound_s": 1.0}]}
    assert [r["cell"] for r in orch.aggregate_best([a, b])] == ["z/s", "x/s"]


def test_help_and_the_plan_supervisor_import_no_torch():
    code = ("import sys; from repro_torch.launch import orchestrator as o; "
            "o.build_parser(); o.resolve_grid('all', 'all'); "
            "print('torch' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")}, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "False", r.stdout + r.stderr


# ---------------------------------------------------------------------------
# the steal rule, as a pure decision function
# ---------------------------------------------------------------------------
def _fleet(tmp_path, payloads):
    states = []
    for i, payload in enumerate(payloads):
        s = orch.ShardProc(index=i, out_dir=tmp_path / f"s{i}", cmd=[], env={})
        s.last_payload = payload
        states.append(s)
    return states


def _queue_with_history(tmp_path, *, done_durations=(2.0, 2.0, 3.0), lease_age=100.0,
                        now=1000.0, max_steals_used=0):
    """A queue where shard0 holds one old lease and the fleet has completed
    cells of known duration."""
    q = CellQueue(tmp_path / "q", lease_s=10_000.0)
    cells = [("done", f"s{i}") for i in range(len(done_durations))]
    cells.append(("slowarch", "sx"))
    q.seed(cells)
    for d in done_durations:
        t = q.acquire("shard1", now=500.0)
        q.complete(t, now=500.0 + d)
    t = q.acquire("shard0", now=now - lease_age)
    if max_steals_used:
        t.steals = max_steals_used
        q.renew(t, now=now - lease_age)
    return q


@pytest.mark.parametrize("case", ["steals_old_lease", "needs_idle_taker", "age_threshold",
                                  "no_completed_cells", "per_cell_budget",
                                  "never_from_idle_owner"])
def test_plan_steals(case, tmp_path):
    running_waiting = [{"status": "running"}, {"status": "waiting"}]
    kw = dict(steal_factor=4.0, steal_min_s=20.0, max_steals=2, now=1000.0)
    if case == "steals_old_lease":
        q = _queue_with_history(tmp_path)
        out = orch.plan_steals(q, _fleet(tmp_path, running_waiting), **kw)
        assert [t.cell for t in out] == ["slowarch/sx"]
        assert q.steal(out[0]) is not None and q.counts()["pending"] == 1
    elif case == "needs_idle_taker":
        q = _queue_with_history(tmp_path)
        fleet = _fleet(tmp_path, [{"status": "running"}, {"status": "running"}])
        assert orch.plan_steals(q, fleet, **kw) == []
    elif case == "age_threshold":
        q = _queue_with_history(tmp_path, lease_age=15.0)
        fleet = _fleet(tmp_path, running_waiting)
        # age 15 < max(steal_min_s=20, 4 x median 2) = 20: too young
        assert orch.plan_steals(q, fleet, **kw) == []
        # a lower floor puts the threshold at 4 x 2 = 8 < 15: steal
        assert len(orch.plan_steals(q, fleet, **{**kw, "steal_min_s": 5.0})) == 1
    elif case == "no_completed_cells":
        q = CellQueue(tmp_path / "q", lease_s=10_000.0)
        q.seed([("a", "s")])
        q.acquire("shard0", now=0.0)
        assert orch.plan_steals(q, _fleet(tmp_path, running_waiting), steal_factor=1.0,
                                steal_min_s=0.1, max_steals=2, now=10_000.0) == []
    elif case == "per_cell_budget":
        q = _queue_with_history(tmp_path, max_steals_used=2)
        assert orch.plan_steals(q, _fleet(tmp_path, running_waiting),
                                **{**kw, "steal_min_s": 5.0}) == []
    else:
        q = _queue_with_history(tmp_path)
        fleet = _fleet(tmp_path, [{"status": "waiting"}, {"status": "waiting"}])
        assert orch.plan_steals(q, fleet, **{**kw, "steal_min_s": 5.0}) == []


# ---------------------------------------------------------------------------
# the fault-handling contract, end to end
# ---------------------------------------------------------------------------
def test_orchestrator_fails_fast_on_unhealable_shard(tmp_path, monkeypatch):
    """A shard whose every attempt crashes (poisoned prelude) fails the run
    as soon as its restart budget is spent, terminating the other shard."""
    poison = tmp_path / "poison_prelude.py"
    poison.write_text("raise RuntimeError('poisoned prelude')\n")
    monkeypatch.setenv("REPRO_CAMPAIGN_PRELUDE", str(poison))
    t0 = time.time()
    with pytest.raises(RuntimeError, match="restart"):
        orch.run_orchestrator(archs="qwen3-0.6b", shapes="train_4k", shards=2,
                              out_dir=tmp_path / "run", mesh="tiny", iterations=1,
                              budget=2, workers=1, poll_interval=0.1, max_restarts=1,
                              device="cpu", verbose=False)
    assert time.time() - t0 < 60
    assert not (tmp_path / "run" / "leaderboard.json").exists()  # no merge
    assert (tmp_path / "run" / "shards" / "shard0" / "shard.log").exists()


def test_orchestrator_heals_killed_shard_and_merges_identically(tmp_path, tiny_shards,
                                                                static_reference):
    """Kill shard 0 after its first completed cell: the supervisor restarts
    it, the restarted shard resumes the finished cell, and the merged
    leaderboard is byte-identical to an uninterrupted run and to the manual
    shard+merge flow."""
    kw = dict(GRID, poll_interval=0.2, hang_timeout=300.0, verbose=False)
    s_kill = orch.run_orchestrator(shards=2, out_dir=tmp_path / "killed",
                                   inject_kill=(0, 1), **kw)
    assert s_kill["restarts"] == 1 and s_kill["restarts_per_shard"]["shard0"] == 1
    final = read_progress(tmp_path / "killed" / "shards" / "shard0")
    assert final["status"] == "done" and final["cells_done"] == 2
    assert final["resumed"] == 1 and final["ran"] == 1, final
    assert 0 < final["evaluations"] < final["evaluations_total"], final
    db_rows = [ln for ln in (tmp_path / "killed" / "shards" / "shard0"
                             / "cost_db.jsonl").read_text().splitlines() if ln.strip()]
    assert final["evaluations_total"] == len(db_rows)
    assert final["cell_in_progress"] is None and final["iteration"] is None
    assert not (tmp_path / "killed" / "shards" / "shard0" / orch.CRASH_TOKEN_FILE).exists()

    s_clean = orch.run_orchestrator(shards=2, out_dir=tmp_path / "clean", **kw)
    assert s_clean["restarts"] == 0
    killed = (tmp_path / "killed" / "leaderboard.json").read_bytes()
    clean = (tmp_path / "clean" / "leaderboard.json").read_bytes()
    assert killed == clean == static_reference
    rows = json.loads(killed)
    assert len(rows) == 4 and all(r["status"] == "complete" for r in rows)
    summary = json.loads((tmp_path / "killed" / "summary.json").read_text())
    assert (summary["restarts"], summary["shards"], summary["executor"],
            summary["device"]) == (1, 2, "local", "cpu")


def test_slow_cell_is_not_false_killed(tmp_path, tiny_shards, monkeypatch):
    """One cell whose wall time exceeds --hang-timeout (every dry run sleeps
    6 s; 4 dry runs) finishes with no restart, because the campaign beats
    at every proposal round and evaluation batch; the leaderboard matches
    an unsupervised campaign of the same cell without the sleeps."""
    monkeypatch.setenv("REPRO_TEST_EVAL_SLEEP_S", "6")
    hang_timeout = 20.0  # > one step (a 6 s dry run, or the torch import
    #                      before the first beat); < the cell (4 x 6 s)
    grid = dict(GRID, archs="qwen3-0.6b", shapes="train_4k", iterations=3, budget=1)
    s = orch.run_orchestrator(shards=1, out_dir=tmp_path / "run", poll_interval=0.2,
                              hang_timeout=hang_timeout, max_restarts=0, verbose=False,
                              **grid)
    assert s["restarts"] == 0, s
    report = json.loads(next((tmp_path / "run" / "shards" / "shard0"
                              / "reports").glob("*.json")).read_text())
    assert report["wall_s"] > hang_timeout, report  # the scenario is real
    assert (tmp_path / "run" / "leaderboard.json").read_bytes() == \
        manual_flow(tmp_path / "manual", grid, shards=1)
    final = read_progress(tmp_path / "run" / "shards" / "shard0")
    for key in ("cell_in_progress", "iteration", "evaluations", "evaluations_total",
                "compiles", "compiles_total"):
        assert key in final, final
