"""repro_torch's DSE service: the CLI, the daemon's pure logic and
submission against the reference's on the same inputs, then a daemon end
to end on the port's 64-token prelude (``tests/ci/torch_tiny_prelude.py``,
forwarded to the workers): a tenant whose only cell is held by a foreign
lease cannot starve another, and the daemon never imports torch
(``/healthz``). The smoke script, cross-tenant dedupe and byte-identical
leaderboards are ``test_torch_service_e2e.py``'s (a file of their own, so
that ``--dist loadfile`` gives each daemon run its own worker)."""
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from contextlib import contextmanager
from pathlib import Path

import pytest

from repro.launch import service as jservice
from repro_torch.launch.scheduler import CellQueue
from repro_torch.launch.service import (ServiceDaemon, SubmitError, build_parser,
                                        snapshot_tenants)

REPO = Path(__file__).resolve().parents[1]
PRELUDE = REPO / "tests" / "ci" / "torch_tiny_prelude.py"

#: the smoke script's tenants: overlapping 2-cell grids sharing
#: (qwen3-0.6b, train_4k)
TENANT_GRIDS = {
    "alice": {"archs": "qwen3-0.6b", "shapes": "train_4k,decode_32k"},
    "bob": {"archs": "qwen3-0.6b,stablelm-3b", "shapes": "train_4k"},
}
PROFILE = {"mesh": "tiny", "iterations": 1, "budget": 2}


def _env():
    """The daemon's and the campaigns' environment: the 64-token prelude,
    and one intra-op thread for each torch process they start."""
    return {**os.environ, "PYTHONPATH": str(REPO / "src"),
            "REPRO_CAMPAIGN_PRELUDE": str(PRELUDE), "OMP_NUM_THREADS": "1"}


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


def _post(url, path, payload=None):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload or {}).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextmanager
def service_daemon(root: Path, *extra_args):
    """Boot ``python -m repro_torch.launch.service serve --device cpu`` on a
    free port; yields the base URL; shuts the daemon down (and asserts exit
    0) on the way out."""
    log = (root.parent / f"{root.name}.log").open("w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.service", "serve",
         "--root", str(root), "--port", "0", "--poll-interval", "0.2",
         "--queue-lease-s", "60", "--device", "cpu", *extra_args],
        env=_env(), stdout=log, stderr=subprocess.STDOUT)
    endpoint = root / "endpoint.json"
    try:
        deadline = time.time() + 30
        while not endpoint.exists():
            assert proc.poll() is None, "daemon died during startup"
            assert time.time() < deadline, "daemon never wrote endpoint.json"
            time.sleep(0.1)
        ep = json.loads(endpoint.read_text())
        url = f"http://{ep['host']}:{ep['port']}"
        yield url
        _post(url, "/shutdown")
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


# ---------------------------------------------------------------------------
# CLI surface + in-process daemon logic, against the reference's
# ---------------------------------------------------------------------------
SERVE_ARGV = ["serve", "--root", "svc", "--port", "0", "--max-workers", "3",
              "--executor", "loopback"]
CLIENT_ARGVS = [
    ["submit", "--tenant", "t0", "--archs", "qwen3-0.6b", "--shapes", "train_4k",
     "--objective", "pareto", "--priority", "3"],
    ["submit", "--tenant", "k", "--archs", "vecmul", "--shapes", "vec_64k_f32",
     "--space", "kernels", "--max-cells", "2"],
    ["status"], ["status", "--tenant", "t0"], ["shutdown"],
    ["leaderboard", "--tenant", "t0"],
]


def test_parser_subcommands_roundtrip():
    ap = build_parser()
    a = ap.parse_args(SERVE_ARGV)
    assert (a.command, a.max_workers, a.executor, a.device) == ("serve", 3, "loopback", "cuda")
    assert ap.parse_args(SERVE_ARGV + ["--device", "cpu"]).device == "cpu"
    want = vars(jservice.build_parser().parse_args(SERVE_ARGV))
    assert {k: v for k, v in vars(a).items() if k != "device"} == want
    for argv in CLIENT_ARGVS:
        assert vars(ap.parse_args(argv)) == vars(jservice.build_parser().parse_args(argv))
    assert ap.parse_args(["leaderboard", "--tenant", "t0"]).out == "-"
    for bad in (["serve"], ["submit", "--tenant", "t0"],
                ["serve", "--root", "r", "--device", "tpu"]):
        with pytest.raises(SystemExit):
            build_parser().parse_args(bad)


def test_snapshot_tenants_matches_the_reference():
    facts = [
        {"name": "b", "priority": 2, "backlog": 3, "workers": 1, "worker_beats": [100.0]},
        {"name": "a", "backlog": 1, "workers": 2, "worker_beats": [100.0, 499.0]},
        {"name": "c", "backlog": 1},  # no workers: never stalled
        {"name": "d", "backlog": 4, "workers": 1, "cells_done": 2, "budget_cells": 3,
         "credit": -0.5, "worker_beats": [150.0]},
    ]
    snaps = snapshot_tenants(facts, hang_timeout=300.0, now=500.0)
    want = jservice.snapshot_tenants(facts, hang_timeout=300.0, now=500.0)
    assert [vars(s) for s in snaps] == [vars(s) for s in want]
    assert [s.name for s in snaps] == ["a", "b", "c", "d"]
    by = {s.name: s for s in snaps}
    assert by["b"].stalled and by["d"].stalled  # every worker silent past 300 s
    assert not by["a"].stalled and not by["c"].stalled


SUBMISSIONS = [
    {"tenant": "../evil", "arch": "qwen3-0.6b", "shape": "train_4k"},
    {"tenant": "t0", "arch": "no-such-arch", "shape": "train_4k"},
    {"tenant": "t0", "arch": "qwen3-0.6b", "shape": "train_4k", "mesh": "warehouse"},
    {"tenant": "t0", "arch": "qwen3-0.6b"},
    {"tenant": "t0", "arch": "qwen3-0.6b", "shape": "train_4k", "priority": 0},
    {"tenant": "t0", "arch": "qwen3-0.6b", "shape": "train_4k", "max_cells": "2"},
    {"tenant": "t0", "arch": "qwen3-0.6b", "shape": "train_4k", "budget": 0},
    {"tenant": "t0", "arch": "qwen3-0.6b", "shape": "train_4k", "strategy": "llm",
     "space": "kernels"},
    {"tenant": "t0", "arch": "qwen3-0.6b", "shape": "train_4k,decode_32k", "mesh": "tiny"},
    # the same grid again: idempotent at the queue level
    {"tenant": "t0", "arch": "qwen3-0.6b", "shape": "train_4k", "mesh": "tiny"},
    # the campaign profile is pinned by the first submission
    {"tenant": "t0", "arch": "qwen3-0.6b", "shape": "train_4k", "mesh": "tiny",
     "objective": "pareto"},
    {"tenant": "k", "arch": "vecmul,rmsnorm", "shape": "vec_64k_f32,rms_512x512_f32",
     "space": "kernels", "priority": 2, "max_cells": 2},
    {"tenant": "k", "arch": "vecmul", "shape": "vec_64k_f32", "space": "kernels",
     "budget": 5},
]


def _outcomes(daemon, payloads):
    out = []
    for p in payloads:
        try:
            rec = daemon.submit(p)
            out.append((200, {k: v for k, v in rec.items() if k != "ts"}))
        except (SubmitError, jservice.SubmitError) as e:
            out.append((e.code, None))
    return out


def test_submit_validation_and_profile_pinning_match_the_reference(tmp_path):
    d = ServiceDaemon(tmp_path / "svc", verbose=False, device="cpu")
    jd = jservice.ServiceDaemon(tmp_path / "ref", verbose=False)
    got, want = _outcomes(d, SUBMISSIONS), _outcomes(jd, SUBMISSIONS)
    assert got == want
    assert [c for c, _ in got] == [400] * 8 + [200, 200, 409, 200, 409]
    assert got[8][1]["seeded"] == 2 and got[9][1]["seeded"] == 0
    assert got[11][1]["cells"] == [["kernel:rmsnorm", "rms_512x512_f32"],
                                   ["kernel:vecmul", "vec_64k_f32"]]
    for t in ("t0", "k"):
        s, js = d.tenant_status(t), jd.tenant_status(t)
        assert {k: s[k] for k in ("queue", "profile", "priority", "max_cells", "drained")} == \
            {k: js[k] for k in ("queue", "profile", "priority", "max_cells", "drained")}
    assert d.tenant_status("t0")["queue"]["pending"] == 2
    # both tenant cache dirs are symlinks into the shared service caches
    qroot = tmp_path / "svc" / "tenants" / "t0" / "queue"
    for cache in ("dryrun_cache", "measured_cache"):
        assert (qroot / cache).is_symlink()
        assert (qroot / cache).resolve() == (tmp_path / "svc" / cache)
    # the workers' argv: the port's campaign on the daemon's device, else
    # the reference's argv
    for t in ("t0", "k"):
        cmd = d._worker_cmd(d.tenants[t], tmp_path / "w0", f"svc-{t}-w0")
        assert cmd[1:3] == ["-m", "repro_torch.launch.campaign"]
        assert cmd[cmd.index("--device") + 1] == "cpu" and "--measure-top-k" not in cmd
        jcmd = jd._worker_cmd(jd.tenants[t], tmp_path / "w0", f"svc-{t}-w0")
        i = cmd.index("--device")
        want = [a.replace(str(tmp_path / "ref"), str(tmp_path / "svc")) for a in jcmd[3:]]
        if t == "k":
            # a kernel tenant's worker takes the kernel's name; the
            # reference passes the queue's encoded id, which its campaign
            # refuses
            assert want[1] == "kernel:rmsnorm"
            want[1] = "rmsnorm"
        assert cmd[3:i] + cmd[i + 2:] == want
    # a restarted daemon reopens every tenant from service.json
    d2 = ServiceDaemon(tmp_path / "svc", verbose=False, device="cpu")
    d2._restore()
    assert sorted(d2.tenants) == ["k", "t0"] and d2.submission_seq == d.submission_seq
    assert d2.tenants["k"].profile == d.tenants["k"].profile


# ---------------------------------------------------------------------------
# end to end: a daemon on the 64-token prelude
# ---------------------------------------------------------------------------
def test_stalled_tenant_cannot_starve_another_and_daemon_stays_torch_free(tmp_path):
    """Park a foreign never-expiring lease on one tenant's only cell (a
    stalled queue: backlog that no worker can take); the other tenant
    must still be scheduled and drain."""
    root = tmp_path / "svc"
    with service_daemon(root, "--max-workers", "2") as url:
        boot = _get(url, "/healthz")
        code, _ = _post(url, "/submit", {"tenant": "stuck", "arch": "stablelm-3b",
                                         "shape": "decode_32k", **PROFILE})
        assert code == 200
        q = CellQueue(root / "tenants" / "stuck" / "queue", lease_s=3600)
        deadline = time.time() + 30
        ticket = None
        while ticket is None and time.time() < deadline:
            ticket = q.acquire("outsider")
            if ticket is None:
                time.sleep(0.1)
        assert ticket is not None, "could not park the blocking lease"
        code, _ = _post(url, "/submit", {"tenant": "fast", "arch": "qwen3-0.6b",
                                         "shape": "train_4k,decode_32k", **PROFILE})
        assert code == 200
        deadline = time.time() + 240
        fast_done = False
        while time.time() < deadline:
            idx = _get(url, "/tenants")["tenants"]
            fast_done = idx["fast"]["queue"] == {**idx["fast"]["queue"], "pending": 0,
                                                 "leased": 0, "done": 2}
            if fast_done:
                break
            time.sleep(0.5)
        assert fast_done, f"fast tenant starved: {idx}"
        stuck = _get(url, "/tenants/stuck")
        assert stuck["queue"]["leased"] == 1 and stuck["queue"]["done"] == 0
        drained = _get(url, "/healthz")
    for h in (boot, drained):
        assert h["ok"] and h["torch_loaded"] is False
