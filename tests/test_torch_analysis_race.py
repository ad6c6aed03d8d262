"""repro_torch.analysis.race: MemFS's POSIX semantics, the port's
CellQueue on MemFS, deterministic replay, and, scenario by scenario, the
port's explorer on the port's queue against the reference's explorer on
the reference's queue (verdict and number of schedules; under the broken
check-then-act queue, the minimized counterexample step for step). Each
package's full sweep runs once."""
import functools

import pytest

from repro.analysis import race as ref_race
from repro_torch.analysis import race
from repro_torch.analysis.race import (NOW, BrokenCellQueue, Built, MemFS, SCENARIOS,
                                       explore, main, minimize, one_state_per_ticket,
                                       run_once, ticket_locations)
from repro_torch.launch import scheduler
from repro_torch.launch.scheduler import CellQueue

#: schedules each scenario explores exhaustively, on either package's queue
SCHEDULES = {"two_acquirers": 84, "acquire_vs_reclaim": 651, "complete_vs_steal": 7,
             "renew_vs_steal": 4, "release_vs_complete": 9, "two_cells": 342}


# ---------------------------------------------------------------------------
# MemFS: the POSIX behaviors the protocol relies on
# ---------------------------------------------------------------------------

def test_memfs_is_the_ports_localfs_seam():
    assert issubclass(MemFS, scheduler.LocalFS)
    assert race.CellQueue is scheduler.CellQueue


def test_memfs_rename_is_win_or_enoent():
    fs = MemFS()
    fs.mkdirs("Q/pending")
    fs.write_text("Q/pending/x.json", "{}")
    fs.rename("Q/pending/x.json", "Q/leased/x.json.lease-a")
    with pytest.raises(FileNotFoundError):
        fs.rename("Q/pending/x.json", "Q/leased/x.json.lease-b")
    assert fs.read_text("Q/leased/x.json.lease-a") == "{}"


def test_memfs_rename_preserves_mtime_write_refreshes():
    fs = MemFS(clock=50.0)
    fs.write_text("Q/a", "1")
    m1 = fs.mtime("Q/a")
    fs.rename("Q/a", "Q/b")
    assert fs.mtime("Q/b") == m1
    fs.rewrite_nocreate("Q/b", "2")
    assert fs.mtime("Q/b") > m1
    fs.write_text("Q/b", "3")
    assert fs.mtime("Q/b") > m1


def test_memfs_link_is_exclusive_create():
    fs = MemFS()
    fs.write_text("Q/t.tmp1", "{}")
    fs.link("Q/t.tmp1", "Q/t")
    with pytest.raises(FileExistsError):
        fs.link("Q/t.tmp1", "Q/t")
    fs.unlink("Q/t.tmp1")
    assert fs.read_text("Q/t") == "{}"
    with pytest.raises(FileNotFoundError):
        fs.unlink("Q/t.tmp1")
    fs.unlink("Q/t.tmp1", missing_ok=True)


def test_memfs_rmdir_refuses_nonempty():
    fs = MemFS()
    fs.mkdir_exclusive("Q")
    with pytest.raises(FileExistsError):
        fs.mkdir_exclusive("Q")
    fs.write_text("Q/x", "1")
    with pytest.raises(OSError):
        fs.rmdir("Q")
    fs.unlink("Q/x")
    fs.rmdir("Q")
    fs.mkdir_exclusive("Q")  # lock is reacquirable once released


def test_memfs_rewrite_nocreate_cannot_resurrect():
    fs = MemFS()
    assert fs.rewrite_nocreate("Q/gone", "text") is False
    assert "Q/gone" not in fs.files


def test_memfs_glob_is_sorted_and_nonrecursive():
    fs = MemFS()
    for name in ("Q/leased/b.json.lease-x", "Q/leased/a.json.lease-y",
                 "Q/leased/deep/c.json", "Q/leased/a.json.tmp1"):
        fs.write_text(name, "{}")
    got = [p.name for p in fs.glob("Q/leased", "*.json*")]
    assert got == ["a.json.lease-y", "a.json.tmp1", "b.json.lease-x"]


def test_ports_cellqueue_runs_unchanged_on_memfs():
    """The port's queue, ungated, behaves over MemFS as over a disk."""
    fs = MemFS(clock=NOW)
    q = CellQueue("Q", lease_s=100.0, fs=fs)
    assert q.seed([("a", "s"), ("b", "s")]) == 2
    assert q.seed([("a", "s")]) == 0  # idempotent
    t = q.acquire("w1", now=NOW)
    assert t is not None and t.owner == "w1" and t.attempt == 1
    assert q.counts() == {"pending": 1, "leased": 1, "done": 0}
    assert q.complete(t, now=NOW) is True
    assert q.counts() == {"pending": 1, "leased": 0, "done": 1}
    assert one_state_per_ticket(fs) is None


# ---------------------------------------------------------------------------
# the explorer: determinism and violation plumbing
# ---------------------------------------------------------------------------

def test_replay_is_deterministic_and_matches_the_reference():
    build = SCENARIOS["two_acquirers"]
    r1 = run_once(build, ["bob", "alice", "bob"])
    r2 = run_once(build, ["bob", "alice", "bob"])
    assert r1.trace == r2.trace
    assert r1.violation is None
    assert r1.trace == ref_race.run_once(ref_race.SCENARIOS["two_acquirers"],
                                         ["bob", "alice", "bob"]).trace


def test_conservation_check_catches_a_lost_ticket():
    def build():
        fs = MemFS(clock=NOW)
        q = CellQueue("Q", lease_s=100.0, fs=fs)
        q.seed([("a", "s")])
        ops = [("eater", lambda: fs.unlink("Q/pending/a__s.json"))]
        return Built(fs=fs, ops=ops, final_check=lambda results: None,
                     initial_tickets=set(ticket_locations(fs)))

    res = run_once(build, [])
    assert res.violation is not None
    assert "conservation" in res.violation


def test_escaping_exception_is_a_violation():
    def build():
        fs = MemFS(clock=NOW)
        CellQueue("Q", lease_s=100.0, fs=fs)

        def boom():
            fs.read_text("Q/pending/never.json")  # FileNotFoundError

        return Built(fs=fs, ops=[("boom", boom)], final_check=lambda results: None,
                     initial_tickets=set())

    res = run_once(build, [])
    assert res.violation is not None
    assert "FileNotFoundError" in res.violation


# ---------------------------------------------------------------------------
# parity: the port's sweep against the reference's, scenario by scenario
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_scenario_sweep_matches_the_reference(name):
    assert sorted(SCENARIOS) == sorted(ref_race.SCENARIOS) == sorted(SCHEDULES)
    port = explore(SCENARIOS[name], scenario=name)
    ref = ref_race.explore(ref_race.SCENARIOS[name], scenario=name)
    assert port.ok, port.counterexample.violation
    assert ref.ok
    assert (port.schedules, port.max_decisions) == (ref.schedules, ref.max_decisions)
    assert port.schedules == SCHEDULES[name]


@pytest.mark.parametrize("name", ["two_acquirers", "two_cells"])
def test_broken_counterexample_matches_the_reference_step_for_step(name):
    port_build = functools.partial(SCENARIOS[name], queue_cls=BrokenCellQueue)
    ref_build = functools.partial(ref_race.SCENARIOS[name],
                                  queue_cls=ref_race.BrokenCellQueue)
    port, ref = explore(port_build, scenario=name), ref_race.explore(ref_build, scenario=name)
    assert not port.ok and not ref.ok
    assert port.schedules == ref.schedules
    mini = minimize(port_build, port.counterexample.choices)
    ref_mini = ref_race.minimize(ref_build, ref.counterexample.choices)
    assert "one-state-per-ticket" in mini.violation
    assert "pending/" in mini.violation and "leased/" in mini.violation
    assert mini.violation == ref_mini.violation
    assert mini.render_schedule() == ref_mini.render_schedule()
    assert "write Q/leased/" in mini.render_schedule()
    # the same schedule is harmless against the real protocol
    assert run_once(SCENARIOS[name], port.counterexample.choices).violation is None


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_named_scenarios_pass(capsys):
    assert main(["--scenario", "complete_vs_steal", "--scenario", "renew_vs_steal"]) == 0
    out = capsys.readouterr().out
    assert out.count("OK") == 2
    assert "complete_vs_steal: OK — 7 schedules explored exhaustively" in out


def test_cli_violation_exits_1(capsys, monkeypatch):
    monkeypatch.setattr(race, "CellQueue", BrokenCellQueue)
    assert main(["--scenario", "two_acquirers"]) == 1
    assert "VIOLATION" in capsys.readouterr().out


def test_cli_broken_self_test(capsys):
    assert main(["--broken"]) == 0
    out = capsys.readouterr().out
    assert "VIOLATION" in out
    assert "minimal counterexample schedule" in out
    assert "self-test passed" in out
    # a self-test that cannot find the bug fails
    assert main(["--broken", "--scenario", "renew_vs_steal"]) == 1
    assert "self-test FAILED" in capsys.readouterr().out


def test_cli_list_and_bad_scenario(capsys):
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in SCENARIOS:
        assert name in out
    with pytest.raises(SystemExit) as e:
        main(["--scenario", "no_such_scenario"])
    assert e.value.code == 2
