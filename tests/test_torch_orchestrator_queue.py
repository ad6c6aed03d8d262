"""repro_torch's orchestrator in queue mode and over the loopback executor,
end to end: the queue-mode tests of ``tests/test_queue_mode.py`` (a kill
mid-lease heals byte-identically; a straggler's cell is stolen) and the
loopback test of ``tests/test_orchestrator.py``, on shard subprocesses of
``python -m repro_torch.launch.campaign`` (``tests/ci/torch_tiny_prelude.py``,
a 4-cell grid on the tiny mesh, the CPU, one thread a shard). Every
merged leaderboard must be byte-identical to the static ``--shard i/n`` +
``merge_db`` flow's. Timings are explicit: the straggler's dry runs sleep
8 s each and the steal floor is 5 s, so the rule fires well after the
fast shard's cells and well before the straggler's cell ends."""
import json
from pathlib import Path

import pytest
from test_torch_orchestrator import GRID, PRELUDE, manual_flow

from repro_torch.launch import orchestrator as orch
from repro_torch.launch.scheduler import CellQueue


@pytest.fixture(scope="module")
def static_reference(tmp_path_factory):
    return manual_flow(tmp_path_factory.mktemp("static_ref"), GRID)


@pytest.fixture
def tiny_shards(monkeypatch):
    monkeypatch.setenv("REPRO_CAMPAIGN_PRELUDE", str(PRELUDE))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _merged_db_identities(out_dir: Path):
    rows = [json.loads(ln) for ln in (out_dir / "cost_db.jsonl").read_text().splitlines()
            if ln.strip()]
    return [(r["arch"], r["shape"], r["mesh"], r["point"].get("__key__"), r["status"])
            for r in rows]


def test_queue_mode_heals_mid_lease_kill_byte_identically(tmp_path, tiny_shards,
                                                          static_reference):
    """Shard 0 crashes mid-lease after one completed cell: the supervisor
    restarts it and releases its lease, the cell is re-leased exactly once,
    no row is recorded twice, and the leaderboard is the static flow's."""
    s = orch.run_orchestrator(shards=2, out_dir=tmp_path / "run", queue=True,
                              inject_kill=(0, 1), poll_interval=0.2, hang_timeout=300.0,
                              steal_min_s=600.0, queue_lease_s=600.0, verbose=False,
                              **GRID)
    assert s["restarts"] == 1 and s["restarts_per_shard"]["shard0"] == 1, s
    assert s["steals"] == 0 and s["lease_reclaims"] >= 1, s
    assert s["queue_cells"] == {"pending": 0, "leased": 0, "done": 4}, s
    q = CellQueue(tmp_path / "run" / orch.QUEUE_DIR)
    assert sorted(t.attempt for t in q.tickets("done")) == [1, 1, 1, 2]
    assert s["max_lease_attempts"] == 2
    idents = _merged_db_identities(tmp_path / "run")
    assert len(idents) == len(set(idents)), "double-recorded datapoint"
    assert (tmp_path / "run" / "leaderboard.json").read_bytes() == static_reference


def test_queue_mode_steals_from_straggler_byte_identically(tmp_path, tiny_shards,
                                                           monkeypatch, static_reference):
    """Shard 0 sleeps 8 s a dry run while shard 1 drains the rest and idles:
    the orchestrator steals the straggler's cell (no restart), the stolen
    ticket shows its second lease, and the leaderboard is the static
    flow's (the double results dedupe at merge)."""
    monkeypatch.setenv("REPRO_TEST_STRAGGLER_SHARD", "0")
    monkeypatch.setenv("REPRO_TEST_EVAL_SLEEP_S", "8")
    s = orch.run_orchestrator(shards=2, out_dir=tmp_path / "run", queue=True,
                              steal_min_s=5.0, steal_factor=2.0, poll_interval=0.2,
                              hang_timeout=300.0, queue_lease_s=600.0, verbose=False,
                              **GRID)
    assert s["steals"] >= 1 and s["restarts"] == 0, s
    assert s["queue_cells"] == {"pending": 0, "leased": 0, "done": 4}, s
    q = CellQueue(tmp_path / "run" / orch.QUEUE_DIR)
    stolen = [t for t in q.tickets("done") if t.steals >= 1]
    assert stolen and all(t.attempt >= 2 for t in stolen)
    idents = _merged_db_identities(tmp_path / "run")
    assert len(idents) == len(set(idents)), "double-recorded datapoint"
    assert (tmp_path / "run" / "leaderboard.json").read_bytes() == static_reference


def test_loopback_executor_merges_identically(tmp_path, tiny_shards, static_reference):
    """The ssh code path with a local transport: shards run in the "remote"
    root, are collected into OUT/shards, and merge to the static flow's
    leaderboard with no restart."""
    s = orch.run_orchestrator(shards=2, out_dir=tmp_path / "loop", poll_interval=0.2,
                              executor="loopback", remote_root=str(tmp_path / "remote"),
                              verbose=False, **GRID)
    assert s["restarts"] == 0 and s["executor"] == "loopback", s
    assert (tmp_path / "remote" / "shard0" / "progress.json").exists()
    for i in range(2):
        sd = tmp_path / "loop" / "shards" / f"shard{i}"
        assert (sd / "cost_db.jsonl").exists() and (sd / "reports").is_dir()
    assert (tmp_path / "loop" / "leaderboard.json").read_bytes() == static_reference
