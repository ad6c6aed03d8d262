"""repro_torch's DSE service end to end: ``scripts/torch_service_smoke.py``
runs once on the port's 64-token prelude (two tenants with overlapping
grids, one worker slot; its own checks: ``torch_loaded`` false, fleet dry
runs equal to the shared cache's entries, no restart, each leaderboard
covering its grid, a clean shutdown), beside a standalone port campaign
of each tenant's grid. The tests then read the service root: the
service's state, every design of the shared cell traced once, and each
tenant's streamed leaderboard byte-identical to its standalone
campaign's."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch.service import PROFILE_DEFAULTS
from test_torch_service import PROFILE, REPO, TENANT_GRIDS, _env


def _standalone_cmd(out: Path, grid) -> list:
    """The byte reference: the campaign a tenant's worker runs, alone."""
    p = {**PROFILE_DEFAULTS, **PROFILE}
    return [sys.executable, "-m", "repro_torch.launch.campaign",
            "--archs", grid["archs"], "--shapes", grid["shapes"],
            "--mesh", p["mesh"], "--iterations", str(p["iterations"]),
            "--budget", str(p["budget"]), "--workers", "1",
            "--strategy", p["strategy"], "--llm", p["llm"],
            "--out", str(out), "--device", "cpu"]


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """``scripts/torch_service_smoke.py --device cpu`` once, beside the
    standalone campaigns of its two tenants (their byte reference), all
    started together."""
    tmp = tmp_path_factory.mktemp("torch_service_e2e")
    refs = {t: subprocess.Popen(_standalone_cmd(tmp / f"ref_{t}", g), env=_env(),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for t, g in TENANT_GRIDS.items()}
    smoke = subprocess.run([sys.executable, str(REPO / "scripts" / "torch_service_smoke.py"),
                            "--out", str(tmp), "--device", "cpu"],
                           capture_output=True, text=True, env=_env(), timeout=300)
    for t, p in refs.items():
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-2000:]
    return {"smoke": smoke, "root": tmp / "svc", "ref": tmp}


def test_smoke_script_passes(smoke_run):
    r = smoke_run["smoke"]
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "service smoke OK" in r.stdout
    state = json.loads((smoke_run["root"] / "service.json").read_text())
    assert sorted(state["tenants"]) == ["alice", "bob"]
    for rec in state["tenants"].values():
        assert rec["queue"]["done"] == 2
        assert all(w["state"] == "done" and w["restarts"] == 0 for w in rec["workers"])


def test_cross_tenant_dedupe_traces_each_design_once(smoke_run):
    assert smoke_run["smoke"].returncode == 0
    per_cell = {}
    for f in (smoke_run["root"] / "dryrun_cache").glob("*.json"):
        rec = json.loads(f.read_text())
        key = (rec["arch"], rec["shape"])
        per_cell[key] = per_cell.get(key, 0) + 1
    # union of the two grids = 3 unique cells; the shared cell holds one
    # set of dry runs, not one per tenant
    assert set(per_cell) == {("qwen3-0.6b", "train_4k"), ("qwen3-0.6b", "decode_32k"),
                             ("stablelm-3b", "train_4k")}
    assert all(n == PROFILE["budget"] + 1 for n in per_cell.values()), per_cell
    # fleet dry runs == cache entries, read from each worker's last heartbeat
    traced = 0
    for t in TENANT_GRIDS:
        for w in (smoke_run["root"] / "tenants" / t / "workers").iterdir():
            traced += json.loads((w / "progress.json").read_text())["compiles_total"]
    assert traced == sum(per_cell.values())


def test_tenant_leaderboards_byte_identical_to_standalone(smoke_run):
    assert smoke_run["smoke"].returncode == 0
    for t in TENANT_GRIDS:
        got = (smoke_run["root"] / "tenants" / t / "merged" / "leaderboard.json").read_bytes()
        want = (smoke_run["ref"] / f"ref_{t}" / "leaderboard.json").read_bytes()
        assert got == want, f"tenant {t}'s leaderboard drifted from the standalone campaign's"
