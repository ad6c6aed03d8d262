"""Content-addressed evaluation result cache.

Counterpart of ``repro/core/eval_cache.py``, copied. Kernel cells keep
their gate-and-resources records here (``dryrun_cache/``) and their
timings beside it (``measured_cache/``).

Evaluations dominate DSE wall-clock (a kernel launch and an oracle check
per design vs microseconds for everything else in the loop). Every design
is fully described by ``(arch, shape, mesh_name, point.key())``, so its
record can be memoized across iterations, loop restarts, and campaigns.

The cache is a directory of one JSON file per design, keyed by the SHA-256
of the identity tuple, living next to the cost DB (``DryRunCache.beside``)
so a campaign's DB and cache travel together. Writes are atomic
(tmp + rename) so concurrent campaign processes sharing a cache never read
torn records.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, Dict, Optional


class DryRunCache:
    def __init__(self, root: Path | str):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._mem: Dict[str, Dict[str, Any]] = {}
        self.hits = 0
        self.misses = 0

    @classmethod
    def beside(cls, db_path: Path | str) -> "DryRunCache":
        """The canonical cache location for a cost DB: a sibling directory."""
        return cls(Path(db_path).parent / "dryrun_cache")

    @staticmethod
    def key_for(arch: str, shape: str, mesh_name: str, point_key: str) -> str:
        blob = json.dumps([arch, shape, mesh_name, point_key])
        return hashlib.sha256(blob.encode()).hexdigest()[:32]

    def get(self, arch: str, shape: str, mesh_name: str,
            point_key: str) -> Optional[Dict[str, Any]]:
        key = self.key_for(arch, shape, mesh_name, point_key)
        rec = self._mem.get(key)
        if rec is None:
            f = self.root / f"{key}.json"
            if f.exists():
                try:
                    rec = json.loads(f.read_text())
                except (OSError, json.JSONDecodeError):
                    rec = None
                else:
                    self._mem[key] = rec
        if rec is None:
            self.misses += 1
            return None
        self.hits += 1
        return rec

    def put(self, arch: str, shape: str, mesh_name: str, point_key: str,
            rec: Dict[str, Any]) -> None:
        key = self.key_for(arch, shape, mesh_name, point_key)
        self._mem[key] = rec
        f = self.root / f"{key}.json"
        tmp = f.with_suffix(f".tmp.{os.getpid()}")
        tmp.write_text(json.dumps(rec, default=str))
        tmp.replace(f)

    def size(self) -> int:
        return len(list(self.root.glob("*.json")))

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses, "entries": self.size()}
