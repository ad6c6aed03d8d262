"""CI smoke for the port's DSE-as-a-service control plane.

The counterpart of ``scripts/service_smoke.py`` for ``repro_torch``: it
boots the real daemon (``repro_torch.launch.service serve``) on a free port,
submits overlapping 2-cell grids from two tenants over HTTP, waits for
both queues to drain, then asserts the service contract end to end:

* the daemon never imported torch (``/healthz`` reports
  ``torch_loaded``);
* cross-tenant coalescing — fleet-wide ``compiles_total`` equals the
  shared dry-run cache's entry count (every design compiled exactly
  once, replays hit the cache), and the cell both tenants submitted
  holds a single compile set;
* both tenants drained with zero worker restarts;
* each tenant's streamed leaderboard is non-empty valid JSON covering
  its own grid;
* ``POST /shutdown`` stops the daemon with exit code 0.

Usage:  PYTHONPATH=src python scripts/torch_service_smoke.py [--out DIR]
            [--device cuda|cpu]
        (respects REPRO_CAMPAIGN_PRELUDE for the spawned workers; the
        workers run on the card unless ``--device cpu`` is given)

Exit codes: 0 = every assertion held, 1 otherwise (daemon log tail is
printed on failure).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

TENANTS = {
    # overlapping grids: (qwen3-0.6b, train_4k) is the shared cell
    "alice": {"arch": "qwen3-0.6b", "shape": "train_4k,decode_32k"},
    "bob": {"arch": "qwen3-0.6b,stablelm-3b", "shape": "train_4k"},
}
PROFILE = {"mesh": "tiny", "iterations": 1, "budget": 2}


def _get(url: str, path: str):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


def _post(url: str, path: str, payload=None):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload or {}).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _wait_drained(url: str, timeout_s: float = 600.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        idx = _get(url, "/tenants")["tenants"]
        if all(t["queue"]["pending"] == 0 and t["queue"]["leased"] == 0
               and t["workers_active"] == 0 for t in idx.values()) \
                and len(idx) == len(TENANTS):
            return idx
        time.sleep(1.0)
    raise AssertionError(f"queues never drained: {_get(url, '/tenants')}")


def run(root: Path, device: str = "cuda") -> None:
    """Boot, submit, drain, assert, shut down; raises on any violation."""
    log_path = root.parent / "service_smoke.log"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.service", "serve",
         "--root", str(root), "--port", "0", "--max-workers", "1",
         "--poll-interval", "0.2", "--device", device],
        stdout=log_path.open("w"), stderr=subprocess.STDOUT)
    try:
        endpoint = root / "endpoint.json"
        deadline = time.time() + 30
        while not endpoint.exists():
            assert proc.poll() is None, "daemon died during startup"
            assert time.time() < deadline, "no endpoint.json after 30s"
            time.sleep(0.1)
        ep = json.loads(endpoint.read_text())
        url = f"http://{ep['host']}:{ep['port']}"
        print(f"[smoke] daemon up at {url}")

        for tenant, grid in TENANTS.items():
            rec = _post(url, "/submit",
                        {"tenant": tenant, **grid, **PROFILE})
            print(f"[smoke] {tenant}: seeded {rec['seeded']} cells")
            assert rec["seeded"] == 2, rec

        idx = _wait_drained(url)
        print("[smoke] all queues drained")

        health = _get(url, "/healthz")
        assert health["ok"] and health["torch_loaded"] is False, health

        # coalescing: one compile fleet-wide per unique design
        cache = root / "dryrun_cache"
        per_cell: dict = {}
        for f in cache.glob("*.json"):
            rec = json.loads(f.read_text())
            key = (rec["arch"], rec["shape"])
            per_cell[key] = per_cell.get(key, 0) + 1
        assert set(per_cell) == {("qwen3-0.6b", "train_4k"),
                                 ("qwen3-0.6b", "decode_32k"),
                                 ("stablelm-3b", "train_4k")}, per_cell
        designs = PROFILE["budget"] + 1  # proposals + baseline
        assert all(n == designs for n in per_cell.values()), per_cell
        compiles = 0
        for tenant in TENANTS:
            status = _get(url, f"/tenants/{tenant}")
            assert status["drained"] and status["queue"]["done"] == 2, status
            assert all(w["state"] == "done" and w["restarts"] == 0
                       for w in status["workers"]), status
            compiles += sum(w["compiles_total"] for w in status["workers"])
        assert compiles == sum(per_cell.values()), (
            f"fleet compiled {compiles} designs but the shared cache holds "
            f"{sum(per_cell.values())} — a design compiled twice")
        print(f"[smoke] dedupe holds: {compiles} compiles == "
              f"{sum(per_cell.values())} cache entries (shared cell once)")

        for tenant, grid in TENANTS.items():
            with urllib.request.urlopen(
                    f"{url}/tenants/{tenant}/leaderboard", timeout=60) as r:
                lb = json.loads(r.read())
            cells = {(row["arch"], row["shape"]) for row in lb}
            want = {(a, s) for a in grid["arch"].split(",")
                    for s in grid["shape"].split(",")}
            assert cells == want, (tenant, cells, want)
        print("[smoke] per-tenant leaderboards cover their grids")

        _post(url, "/shutdown")
        rc = proc.wait(timeout=60)
        assert rc == 0, f"daemon exited {rc}"
        print("[smoke] clean shutdown — service smoke OK")
    except BaseException:
        if log_path.exists():
            print("---- daemon log tail ----", file=sys.stderr)
            print("\n".join(
                log_path.read_text().splitlines()[-40:]), file=sys.stderr)
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def main(argv=None) -> int:
    """CLI entry point: run the smoke in --out (default: a temp dir)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="service root dir (default: fresh temp dir)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the workers' device (default: the card)")
    args = ap.parse_args(argv)
    if args.out:
        root = Path(args.out) / "svc"
        root.parent.mkdir(parents=True, exist_ok=True)
        run(root, args.device)
        return 0
    with tempfile.TemporaryDirectory(prefix="torch_service_smoke_") as tmp:
        run(Path(tmp) / "svc", args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
