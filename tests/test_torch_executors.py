"""repro_torch's shard executors, the ten tests of ``tests/test_executors.py``
on the port's module: protocol selection, ssh command templating (the
remote command runs ``python -m repro_torch.launch.campaign``), and the
loopback (ssh code path, local transport) lifecycle — spawn, heartbeat
fetch, pid-file group kill, exit-code propagation, collect-before-merge.
Besides: the local executor gives each shard one card, ``i mod n``, of
the cards it counts without torch."""
import json
import signal
import sys
import time
from pathlib import Path

import pytest

from repro_torch.launch.executors import (EXECUTOR_CHOICES, PID_FILE,
                                    LocalProcessExecutor, LoopbackExecutor,
                                    ShardProc, SSHExecutor, make_executor)

REPO = Path(__file__).resolve().parents[1]


def _shard(tmp_path, index=0, cmd=None, env=None) -> ShardProc:
    return ShardProc(index=index, out_dir=tmp_path / f"shard{index}",
                     cmd=cmd or [sys.executable, "-m",
                                 "repro_torch.launch.campaign", "--out", "X"],
                     env=env or {})


# ---------------------------------------------------------------------------
# selection + configuration (no processes)
# ---------------------------------------------------------------------------
def test_make_executor_selects_and_validates():
    assert isinstance(make_executor("local"), LocalProcessExecutor)
    ex = make_executor("ssh", hosts=["h0", "h1"], remote_python="python3.11")
    assert isinstance(ex, SSHExecutor) and ex.python == "python3.11"
    assert isinstance(make_executor("loopback"), LoopbackExecutor)
    with pytest.raises(ValueError):
        make_executor("ssh")  # hosts required
    with pytest.raises(ValueError):
        make_executor("k8s")
    assert set(EXECUTOR_CHOICES) == {"local", "ssh", "loopback"}


def test_ssh_round_robin_hosts_and_remote_dirs(tmp_path):
    ex = SSHExecutor(hosts=["h0", "h1"], remote_root="/scratch/run")
    shards = [_shard(tmp_path, i) for i in range(4)]
    assert [ex.host_for(s) for s in shards] == ["h0", "h1", "h0", "h1"]
    assert ex.remote_dir(shards[3]) == "/scratch/run/shard3"
    # no remote_root: the shared-FS convention — same absolute path
    ex2 = SSHExecutor(hosts=["h0"])
    assert ex2.remote_dir(shards[0]) == str(shards[0].out_dir.resolve())
    assert ex2.remote_repo == str(REPO)  # defaults to this checkout


def test_ssh_remote_command_templating(tmp_path):
    ex = SSHExecutor(hosts=["h0"], remote_root="/scratch/run",
                     remote_repo="/srv/repro", python="python3.12")
    s = _shard(tmp_path, 1, env={"REPRO_CAMPAIGN_PRELUDE": "/p.py",
                                 "REPRO_SHARD_INDEX": "1",
                                 "SECRET_LOCAL_VAR": "nope"})
    cmd = ex.remote_command(s)
    assert "mkdir -p /scratch/run/shard1" in cmd
    assert f"echo $$ > /scratch/run/shard1/{PID_FILE}" in cmd
    assert "setsid -w bash -c" in cmd
    # argv re-targeted: remote python, remote --out
    assert "python3.12 -m repro_torch.launch.campaign" in cmd
    assert "--out /scratch/run/shard1" in cmd
    # test/CI hooks forwarded, local noise not; PYTHONPATH -> remote src
    assert "REPRO_CAMPAIGN_PRELUDE=/p.py" in cmd
    assert "REPRO_SHARD_INDEX=1" in cmd
    assert "SECRET_LOCAL_VAR" not in cmd
    assert "PYTHONPATH=/srv/repro/src" in cmd
    # transport argv wraps the command for ssh
    argv = ex._transport_argv("h0", cmd)
    assert argv[0] == "ssh" and argv[-1] == cmd and "h0" in argv


def test_loopback_transport_is_local_sh(tmp_path):
    ex = LoopbackExecutor()
    assert ex._transport_argv("ignored", "echo hi")[:2] == ["/bin/sh", "-c"]
    assert ex.python == sys.executable  # this interpreter, not 'python3'


# ---------------------------------------------------------------------------
# loopback lifecycle: the ssh seam with real processes, no torch, no network
# ---------------------------------------------------------------------------
_FAKE_CAMPAIGN = ("import json, sys, time; "
                  "d = sys.argv[sys.argv.index('--out') + 1]; "
                  "json.dump({'cells_done': 1, 'status': 'running', "
                  "'ts': 1.0}, open(d + '/progress.json', 'w')); "
                  "time.sleep(120)")


def _wait_for(predicate, timeout=20.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if predicate():
            return True
        time.sleep(0.1)
    return False


def test_loopback_spawn_heartbeat_kill(tmp_path):
    """Spawn a fake campaign through the ssh code path: the pid file lands
    in the remote dir, the heartbeat is fetched from the remote
    progress.json, and signal() kills the remote process group."""
    ex = LoopbackExecutor(remote_root=str(tmp_path / "remote"))
    s = _shard(tmp_path, 0,
               cmd=[sys.executable, "-c", _FAKE_CAMPAIGN, "--out", "X"])
    rdir = Path(ex.remote_dir(s))
    ex.spawn(s)
    try:
        assert _wait_for(lambda: (rdir / "progress.json").exists()), \
            s.log_path.read_text()
        assert (rdir / PID_FILE).exists()
        assert ex.read_heartbeat(s) == {"cells_done": 1, "status": "running",
                                        "ts": 1.0}
        assert ex.poll(s) is None  # still running
        ex.signal(s, signal.SIGKILL)
        s.proc.wait(timeout=20)
        assert ex.poll(s) not in (None, 0)
    finally:
        ex.signal(s, signal.SIGKILL)
        s.close_log()
    # the local shard dir only holds the log until collect() mirrors it
    assert s.log_path.exists()
    assert not (s.out_dir / "progress.json").exists()
    ex.collect(s)
    assert (s.out_dir / "progress.json").exists()
    assert (s.out_dir / PID_FILE).exists()


def test_loopback_respawn_kills_stale_group(tmp_path):
    """A restart whose preceding kill round-trip was lost (transport
    outage) must not leave two campaigns sharing one shard dir: the spawn
    command kills any stale process group recorded in shard.pid first."""
    ex = LoopbackExecutor(remote_root=str(tmp_path / "remote"))
    s1 = _shard(tmp_path, 0,
                cmd=[sys.executable, "-c", _FAKE_CAMPAIGN, "--out", "X"])
    ex.spawn(s1)
    rdir = Path(ex.remote_dir(s1))
    assert _wait_for(lambda: (rdir / PID_FILE).exists()), "no pid file"
    stale_pid = int((rdir / PID_FILE).read_text())
    s2 = _shard(tmp_path, 0,
                cmd=[sys.executable, "-c", _FAKE_CAMPAIGN, "--out", "X"])
    ex.spawn(s2)  # no signal() first — simulates the lost kill
    try:
        assert _wait_for(lambda: s1.proc.poll() is not None), \
            "stale attempt survived the respawn"
        def new_pid_recorded():
            txt = (rdir / PID_FILE).read_text().strip()
            return txt.isdigit() and int(txt) != stale_pid
        assert _wait_for(new_pid_recorded), "pid file not re-stamped"
        assert ex.poll(s2) is None  # the new attempt is the one running
    finally:
        ex.signal(s2, signal.SIGKILL)
        ex.signal(s1, signal.SIGKILL)
        s1.close_log()
        s2.close_log()


def test_loopback_exit_code_propagates(tmp_path):
    ex = LoopbackExecutor(remote_root=str(tmp_path / "remote"))
    s = _shard(tmp_path, 0, cmd=[sys.executable, "-c",
                                 "import sys; sys.exit(86)", "--out", "X"])
    ex.spawn(s)
    try:
        assert _wait_for(lambda: ex.poll(s) is not None), "never exited"
        assert ex.poll(s) == 86  # os._exit(86)-style crashes stay visible
    finally:
        s.close_log()


def test_loopback_read_heartbeat_tolerates_missing_and_torn(tmp_path):
    ex = LoopbackExecutor(remote_root=str(tmp_path / "remote"))
    s = _shard(tmp_path, 0)
    assert ex.read_heartbeat(s) == {}  # no remote dir yet = no news
    rdir = Path(ex.remote_dir(s))
    rdir.mkdir(parents=True)
    (rdir / "progress.json").write_text('{"cells_done": ')  # torn
    assert ex.read_heartbeat(s) == {}
    (rdir / "progress.json").write_text('{"cells_done": 3}')
    assert ex.read_heartbeat(s) == {"cells_done": 3}


def test_loopback_collect_copies_and_skips_alias(tmp_path):
    ex = LoopbackExecutor(remote_root=str(tmp_path / "remote"))
    s = _shard(tmp_path, 0)
    rdir = Path(ex.remote_dir(s))
    (rdir / "reports").mkdir(parents=True)
    (rdir / "cost_db.jsonl").write_text('{"arch": "a"}\n')
    (rdir / "reports" / "c.json").write_text("{}")
    ex.collect(s)
    assert (s.out_dir / "cost_db.jsonl").read_text() == '{"arch": "a"}\n'
    assert (s.out_dir / "reports" / "c.json").exists()
    # a missing remote dir must fail loudly, not merge an empty shard
    s2 = _shard(tmp_path, 1)
    with pytest.raises(RuntimeError, match="collect failed"):
        ex.collect(s2)
    # no remote_root: remote dir IS the local dir — collect must not
    # attempt to copy a directory onto itself
    ex_alias = LoopbackExecutor()
    s3 = _shard(tmp_path, 2)
    s3.out_dir.mkdir(parents=True)
    ex_alias.collect(s3)  # no-op, no error


def test_local_executor_matches_shardproc_behavior(tmp_path):
    """The default backend is the original ShardProc lifecycle: local
    subprocess in its own session, heartbeat from the local shard dir."""
    ex = LocalProcessExecutor()
    s = _shard(tmp_path, 0, cmd=[sys.executable, "-c",
                                 "import time; time.sleep(120)"])
    ex.spawn(s)
    try:
        assert ex.poll(s) is None
        assert ex.read_heartbeat(s) == {}
        (s.out_dir / "progress.json").write_text('{"cells_done": 2}')
        assert ex.read_heartbeat(s) == {"cells_done": 2}
        ex.signal(s, signal.SIGKILL)
        s.proc.wait(timeout=20)
        assert ex.poll(s) not in (None, 0)
        ex.collect(s)  # no-op
    finally:
        ex.signal(s, signal.SIGKILL)
        s.close_log()


def test_local_executor_gives_each_shard_one_card(tmp_path, monkeypatch):
    """Shard i runs on card i mod n (``CUDA_VISIBLE_DEVICES``), counted
    from the supervisor's own ``CUDA_VISIBLE_DEVICES`` when it has one; a
    machine without cards leaves the shards' environment alone."""
    from repro_torch.launch import executors

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    assert executors.visible_cards() == ["3", "5"]
    ex = LocalProcessExecutor()
    seen = []
    for i in range(3):
        s = _shard(tmp_path, i, cmd=[sys.executable, "-c",
                                     "import os; print(os.environ['CUDA_VISIBLE_DEVICES'])"])
        ex.spawn(s)
        s.proc.wait(timeout=60)
        s.close_log()
        seen.append(s.log_path.read_text().strip())
    assert seen == ["3", "5", "3"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert executors.visible_cards() == []
    s = _shard(tmp_path, 4, cmd=[sys.executable, "-c", "pass"], env={"X": "1"})
    LocalProcessExecutor(cards=[]).spawn(s)
    s.proc.wait(timeout=60)
    s.close_log()
    assert s.env == {"X": "1"}
