"""Merge per-shard campaign outputs into one canonical campaign directory.

Counterpart of ``repro/launch/merge_db.py``, copied. A sharded campaign
(``repro_torch.launch.campaign --shard i/n``) leaves n disjoint
output dirs, each with its own ``cost_db.jsonl``, ``reports/`` and
``dryrun_cache/``. This CLI folds them into one:

* **cost DB** — records deduplicated by ``(arch, shape, mesh,
  point.__key__, status, fidelity)``, keeping the *earliest* record (by
  timestamp, then serialized content); the merged JSONL is timestamp-sorted
  so the result reads like one chronological campaign. Fidelity in the
  identity keeps a design's dry-run row and its tier-2 *measured* row as
  two first-class records, while duplicate measurements of one design
  (a stolen cell promoted by two owners — byte-identical by the measured
  cache's replay contract) collapse to the one canonical row;
* **reports** — per-cell report JSONs copied over (shards own disjoint
  cells; on a collision the earliest-mtime report wins and a warning is
  printed);
* **caches** — content-addressed ``dryrun_cache/`` and ``measured_cache/``
  entries unioned (existing entries are never overwritten — they are
  identical by construction);
* **leaderboard** — rebuilt from the merged DB + the merged report set,
  using the same ranking/serialization as ``run_kernel_campaign``; this
  reproduces the single-process ``leaderboard.json`` byte-for-byte.

Usage:

    PYTHONPATH=src python -m repro_torch.launch.merge_db \\
        artifacts/shard0 artifacts/shard1 --out artifacts/campaign

Pure file manipulation, safe to run anywhere.
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_db import CostDB, DataPoint
from repro_torch.launch.campaign import (OBJECTIVE_CHOICES, build_leaderboard,
                                         validate_objective_args)
from repro_torch.launch.ioutil import write_json_atomic


def merge_cost_dbs(shard_dbs: Sequence[Path], out_db: Path,
                   ) -> Tuple[int, int]:
    """Merge shard JSONL DBs into ``out_db``; returns (kept, dropped_dups).
    Identity is ``(arch, shape, mesh, point.__key__, status, fidelity)``;
    the earliest record (timestamp, then serialized content — NOT input
    order, so the merge is **order-invariant**: any permutation of the
    shard list yields byte-identical output)
    wins. Status is part of the identity so a gate-``pruned`` prediction
    and the later evaluated row for the same design both survive — exactly
    the pair a single-process campaign's DB holds when the gate relaxes
    and a once-pruned design gets compiled. Fidelity is part of it so a
    design's dry-run bound and its tier-2 measured timing coexist, while
    duplicate measurements (one per owner of a stolen cell, byte-identical
    via the measured-cache replay) dedupe to one. Unreadable lines are
    skipped."""
    rows: List[DataPoint] = []
    for p in shard_dbs:
        if not p.exists():
            continue
        for line in p.read_text().splitlines():
            if not line.strip():
                continue
            try:
                rows.append(DataPoint.from_json(line))
            except (json.JSONDecodeError, TypeError):
                print(f"merge_db: skipping unreadable row in {p}")
    # ties broken by serialized content, never input order: two shards
    # carrying equal-timestamp rows for one identity (a stolen cell run
    # twice, clock granularity) must merge the same whichever came first
    rows.sort(key=lambda d: (d.ts or 0.0, d.to_json()))
    seen = set()
    kept: List[DataPoint] = []
    for d in rows:
        ident = (d.arch, d.shape, d.mesh, d.point.get("__key__"), d.status,
                 d.fidelity)
        if ident[3] is not None and ident in seen:
            continue
        seen.add(ident)
        kept.append(d)
    out_db.parent.mkdir(parents=True, exist_ok=True)
    with out_db.open("w") as f:
        f.write("".join(d.to_json() + "\n" for d in kept))
    return len(kept), len(rows) - len(kept)


def merge_reports(shard_dirs: Sequence[Path], out_dir: Path) -> List[Path]:
    """Copy per-cell report JSONs into ``out_dir/reports``. Statically-cut
    shards own disjoint cells, but queue-mode steals legitimately leave the
    same cell reported by two shards; on a collision the earliest-mtime
    file wins, with ties broken by content bytes (never input order, so
    the merge stays order-invariant)."""
    dest = out_dir / "reports"
    dest.mkdir(parents=True, exist_ok=True)
    srcs: Dict[str, Path] = {}
    for sd in shard_dirs:
        for f in sorted((sd / "reports").glob("*.json")):
            prev = srcs.get(f.name)
            if prev is None:
                srcs[f.name] = f
            elif _report_rank(f) < _report_rank(prev):
                print(f"merge_db: duplicate report {f.name}: keeping "
                      f"{f} (earlier), ignoring {prev}")
                srcs[f.name] = f
            else:
                print(f"merge_db: duplicate report {f.name}: keeping "
                      f"{prev} (earlier), ignoring {f}")
    out = []
    for name, src in sorted(srcs.items()):
        shutil.copyfile(src, dest / name)
        out.append(dest / name)
    return out


def _report_rank(path: Path) -> Tuple[float, bytes]:
    """Collision ordering for duplicate reports: earliest mtime first,
    content bytes as the order-independent tie-break."""
    return (path.stat().st_mtime, path.read_bytes())


def merge_caches(shard_dirs: Sequence[Path], out_dir: Path,
                 extra_cache_dirs: Optional[Sequence[Path]] = None) -> int:
    """Union the content-addressed caches — ``dryrun_cache/`` (compiles)
    and ``measured_cache/`` (tier-2 timings) — per subdirectory (same key =
    same record, so existing entries are never overwritten).
    ``extra_cache_dirs`` names cache directories *directly* (not shard
    dirs) — queue-mode campaigns share their caches inside the queue dir,
    and the merge folds them in so the merged campaign dir resumes for
    free; an extra dir named ``measured_cache`` routes to the measured
    union, anything else to the dry-run union. Returns entries copied."""
    extras = [Path(c) for c in (extra_cache_dirs or [])]
    n = 0
    for sub in ("dryrun_cache", "measured_cache"):
        dest = out_dir / sub
        dest.mkdir(parents=True, exist_ok=True)
        caches = [sd / sub for sd in shard_dirs]
        caches += [c for c in extras
                   if (c.name == "measured_cache") == (sub == "measured_cache")]
        for cd in caches:
            for f in sorted(cd.glob("*.json")):
                target = dest / f.name
                if not target.exists():
                    shutil.copyfile(f, target)
                    n += 1
    return n


def rebuild_leaderboard(out_dir: Path, objective: str = "bound_s") -> Path:
    """Reconstruct cell rows from the merged report set and rank them with
    the same ``build_leaderboard`` + serialization as ``run_kernel_campaign``.
    ``objective="pareto"`` rebuilds dominance-ranked fronts instead of the
    scalar heads — because ``pareto_rows`` is a pure function of the merged
    row *set* (dedupe + canonical front ordering), the rebuilt front is
    byte-identical under any shard permutation, same as scalar mode."""
    rows: List[Dict] = []
    for f in (out_dir / "reports").glob("*.json"):
        parts = f.stem.split("__")
        if len(parts) != 3:
            print(f"merge_db: skipping unrecognized report name {f.name}")
            continue
        arch, shape, mesh = parts
        d = json.loads(f.read_text())
        rows.append({"arch": arch, "shape": shape, "mesh": mesh,
                     "status": d.get("status", "complete"),
                     "improvement": d.get("improvement")})
    rows.sort(key=lambda c: (c["arch"], c["shape"], c["mesh"]))
    db = CostDB(out_dir / "cost_db.jsonl")
    # same serialization as run_kernel_campaign, and atomic for the same reason:
    # a reader (or a killed merge) must never see a torn leaderboard
    return write_json_atomic(out_dir / "leaderboard.json",
                             build_leaderboard(db, rows, objective=objective))


def merge(shard_dirs: Sequence[Path | str], out_dir: Path | str,
          verbose: bool = True,
          extra_cache_dirs: Optional[Sequence[Path | str]] = None,
          objective: str = "bound_s") -> Dict:
    """Fold the shard dirs into ``out_dir`` (DB dedup + reports + caches +
    rebuilt leaderboard, see module docstring); returns the merge summary.
    ``extra_cache_dirs`` folds additional content-addressed cache dirs in
    (the queue-shared cache of a ``--queue`` campaign). Raises
    ``FileNotFoundError`` for a missing shard dir and ``ValueError`` when
    ``out_dir`` aliases a shard dir. Deterministic AND order-invariant:
    the same shard contents produce byte-identical merged outputs under
    any permutation of ``shard_dirs`` (row dedup ties break on serialized
    content, report collisions on (mtime, content))."""
    err = validate_objective_args(objective)
    if err:
        raise ValueError(err)
    shard_dirs = [Path(s) for s in shard_dirs]
    out_dir = Path(out_dir)
    for sd in shard_dirs:
        if not sd.is_dir():
            raise FileNotFoundError(f"shard dir {sd} does not exist")
    if out_dir in shard_dirs:
        raise ValueError("--out must not be one of the shard dirs")
    kept, dups = merge_cost_dbs([sd / "cost_db.jsonl" for sd in shard_dirs],
                                out_dir / "cost_db.jsonl")
    reports = merge_reports(shard_dirs, out_dir)
    cached = merge_caches(shard_dirs, out_dir,
                          [Path(c) for c in (extra_cache_dirs or [])])
    lb_path = rebuild_leaderboard(out_dir, objective=objective)
    summary = {
        "shards": [str(s) for s in shard_dirs],
        "out": str(out_dir),
        "datapoints": kept, "duplicates_dropped": dups,
        "reports": len(reports), "cache_entries_copied": cached,
        "leaderboard": str(lb_path),
    }
    if verbose:
        print(f"merge_db: {summary}")
    return summary


def build_parser() -> argparse.ArgumentParser:
    """The merge CLI surface, importable cheaply."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.merge_db",
        description="merge sharded campaign outputs (cost DBs, reports, "
                    "dry-run caches) and rebuild one leaderboard")
    ap.add_argument("shards", nargs="+", help="per-shard campaign --out dirs")
    ap.add_argument("--out", required=True, help="merged campaign dir")
    ap.add_argument("--extra-cache", action="append", default=None,
                    metavar="DIR",
                    help="additional content-addressed cache dir(s) to fold "
                         "in (e.g. a queue-mode campaign's shared "
                         "QUEUE/dryrun_cache or QUEUE/measured_cache; a dir "
                         "named measured_cache routes to the measured "
                         "union); repeatable")
    ap.add_argument("--objective", choices=list(OBJECTIVE_CHOICES),
                    default="bound_s",
                    help="ranking mode for the rebuilt leaderboard: scalar "
                         "bound_s heads (default) or dominance-ranked "
                         "pareto fronts")
    return ap


def main():
    """CLI entry: merge the given shard dirs into ``--out``. Exits nonzero
    (FileNotFoundError/ValueError) on missing shard dirs or ``--out``
    aliasing a shard dir."""
    args = build_parser().parse_args()
    merge(args.shards, args.out, extra_cache_dirs=args.extra_cache,
          objective=args.objective)


if __name__ == "__main__":
    main()
