"""Ratcheting baseline for the port's invariant linter.

Counterpart of ``repro/analysis/baseline.py``, copied. The port's baseline
file (``analysis_baseline_torch.json`` at the repo root; the reference
keeps ``analysis_baseline.json``) is a
list of accepted-debt entries keyed by finding fingerprint (rule + file
+ normalized source line — no line numbers, so entries survive code
motion). The ratchet semantics:

* a finding whose fingerprint is **not** in the baseline is *new* →
  the lint run fails;
* a baseline entry whose fingerprint no longer fires is *stale* → the
  linter rewrites the baseline without it (the ratchet only tightens;
  committing the shrunken file is the payoff for fixing debt);
* ``--write-baseline`` accepts all current findings (bootstrap — used
  once when introducing a rule over a codebase with existing debt).

The shipped baseline is **empty**: every rule runs clean on the port,
and the file exists purely so new debt has somewhere to *not* be.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis.rules import Finding


def load_baseline(path: Path) -> Dict[str, dict]:
    """fingerprint -> entry. A missing file is an empty baseline (the
    strictest possible ratchet), so fresh checkouts and fixture repos
    need no bootstrap step."""
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return {e["fingerprint"]: e for e in data.get("findings", [])}


def write_baseline(path: Path, findings: Iterable[Finding]) -> None:
    """Serialize findings as accepted debt, sorted for stable diffs.
    Entries keep the human-readable context (rule/file/snippet) so a
    reviewer can audit the debt without re-running the linter."""
    entries = sorted(
        ({"fingerprint": fd.fingerprint, "rule": fd.rule, "path": fd.rel,
          "snippet": fd.snippet, "occurrence": fd.occurrence}
         for fd in findings),
        key=lambda e: (e["rule"], e["path"], e["snippet"], e["occurrence"]))
    payload = {"comment": "accepted debt for repro_torch.analysis.lint; "
                          "the ratchet only ever shrinks this list",
               "findings": entries}
    path.write_text(json.dumps(payload, indent=1) + "\n")


def apply_baseline(findings: List[Finding], baseline: Dict[str, dict],
                   ) -> Tuple[List[Finding], List[Finding], List[dict]]:
    """Split findings against the baseline.

    Returns ``(new, known, stale)``: findings not covered by the
    baseline (failures), findings covered (tolerated debt), and baseline
    entries that no longer fire (to be ratcheted away).
    """
    current = {fd.fingerprint for fd in findings}
    new = [fd for fd in findings if fd.fingerprint not in baseline]
    known = [fd for fd in findings if fd.fingerprint in baseline]
    stale = [e for fp, e in baseline.items() if fp not in current]
    return new, known, stale
