"""Atomic JSON writes (counterpart of ``repro/launch/ioutil.py``, copied).

Every JSON file a reader may poll while a writer is mid-flight (reports,
cache records) is written through :func:`write_json_atomic`: serialize to a
sibling temp file, then commit with one ``os.replace`` so no reader ever
sees a torn file.
"""
from __future__ import annotations

import json
from pathlib import Path


def write_json_atomic(path: Path | str, payload) -> Path:
    """Serialize ``payload`` to ``path`` via temp-file + ``os.replace``.
    Serialization is byte-stable for a given payload (``indent=1``,
    ``default=str``). Returns ``path``."""
    path = Path(path)
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(payload, indent=1, default=str))
    tmp.replace(path)
    return path
