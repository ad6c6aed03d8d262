"""Invariant linter runner + CLI for the port.

Counterpart of ``repro/analysis/lint.py``. Parses every Python file under
the lint root's ``src/repro_torch`` tree (or the paths given on the
command line), runs the RPR rule registry over the whole project at once
(rules may be cross-file — RPR004's torch-taint walks the import graph),
and reports findings against the ratcheting baseline.

Usage (from the repo root)::

    PYTHONPATH=src python -m repro_torch.analysis.lint \\
        --baseline analysis_baseline_torch.json

Exit codes: 0 clean (or debt fully covered by the baseline), 1 new
findings, 2 unparseable source. Stdlib-only; safe for bare CI jobs.
"""
from __future__ import annotations

import argparse
import ast
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.analysis.baseline import (apply_baseline, load_baseline,
                                           write_baseline)
from repro_torch.analysis.rules import RULES, Finding, number_occurrences

#: trees scanned by default, relative to --root
DEFAULT_SCAN = ("src/repro_torch",)


class SourceFile:
    """One parsed source file: absolute path, root-relative posix path
    (what rules scope on), raw text, AST, and split lines."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.tree = ast.parse(text, filename=str(path))
        self.lines = text.splitlines()


class Project:
    """The whole lint unit. Rules receive it alongside each file so
    cross-file analyses (RPR004 taint) can cache on it."""

    def __init__(self, files: Sequence[SourceFile]):
        self.files = list(files)


def discover(root: Path, scan: Sequence[str] = DEFAULT_SCAN,
             ) -> List[Path]:
    """Python files under the scan trees, sorted for run determinism."""
    out: List[Path] = []
    for sub in scan:
        base = root / sub
        if base.is_dir():
            out.extend(sorted(base.rglob("*.py")))
        elif base.is_file() and base.suffix == ".py":
            out.append(base)
    return out


def load_project(root: Path, paths: Sequence[Path]) -> Project:
    files = []
    for p in paths:
        rel = p.relative_to(root).as_posix()
        files.append(SourceFile(p, rel, p.read_text()))
    return Project(files)


def run_rules(project: Project, rules=None) -> List[Finding]:
    """All findings over the project, occurrence-numbered, in
    (path, line) order."""
    rules = RULES if rules is None else rules
    findings: List[Finding] = []
    for f in project.files:
        for rule in rules:
            if rule.applies(f):
                findings.extend(rule.check(f, project))
    findings.sort(key=lambda fd: (fd.rel, fd.line, fd.rule))
    return number_occurrences(findings)


def lint_paths(root: Path | str, scan: Sequence[str] = DEFAULT_SCAN,
               rules=None) -> List[Finding]:
    """Library entry point: lint the given root, return findings."""
    root = Path(root)
    return run_rules(load_project(root, discover(root, scan)), rules)


def build_parser() -> argparse.ArgumentParser:
    """The lint CLI surface (the README's fenced commands are parsed
    with it by the tests, to keep them honest)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="invariant linter for the PyTorch/CUDA port: enforces "
                    "the atomic-write, determinism, torch-free, and "
                    "exception-handling contracts (rules RPR001-RPR006)")
    ap.add_argument("--root", default=".",
                    help="repo root to lint (default: cwd)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="ratcheting baseline JSON; new findings fail, "
                         "fixed debt auto-tightens the file")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into --baseline "
                         "(bootstrap only)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout")
    ap.add_argument("--rules", default=None, metavar="IDS",
                    help="comma-separated rule ids to run "
                         "(default: all)")
    ap.add_argument("paths", nargs="*",
                    help="scan roots relative to --root "
                         f"(default: {' '.join(DEFAULT_SCAN)})")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    root = Path(args.root).resolve()
    scan = tuple(args.paths) if args.paths else DEFAULT_SCAN
    rules = RULES
    if args.rules:
        wanted = {r.strip().upper() for r in args.rules.split(",")}
        unknown = wanted - {r.id for r in RULES}
        if unknown:
            print(f"lint: unknown rule ids: {', '.join(sorted(unknown))}")
            return 2
        rules = [r for r in RULES if r.id in wanted]

    try:
        findings = lint_paths(root, scan, rules)
    except SyntaxError as e:
        print(f"lint: cannot parse {e.filename}:{e.lineno}: {e.msg}")
        return 2

    if args.write_baseline:
        if not args.baseline:
            print("lint: --write-baseline requires --baseline FILE")
            return 2
        write_baseline(root / args.baseline, findings)
        print(f"lint: wrote {len(findings)} finding(s) to "
              f"{args.baseline}")
        return 0

    if args.baseline:
        bl_path = root / args.baseline
        baseline = load_baseline(bl_path)
        new, known, stale = apply_baseline(findings, baseline)
        if stale:
            # the ratchet tightens: debt that stopped firing is removed
            # from the baseline so it can never silently come back
            write_baseline(bl_path, known)
            print(f"lint: ratchet tightened — {len(stale)} baseline "
                  f"entr{'y' if len(stale) == 1 else 'ies'} no longer "
                  f"fire(s); rewrote {args.baseline}")
        display = new
    else:
        new, known = findings, []
        display = findings

    if args.as_json:
        print(json.dumps([{
            "rule": fd.rule, "path": fd.rel, "line": fd.line,
            "message": fd.message, "snippet": fd.snippet,
            "fingerprint": fd.fingerprint,
            "baselined": fd in known} for fd in findings], indent=1))
    else:
        for fd in display:
            print(fd.render())

    n_files = len(discover(root, scan))
    if new:
        print(f"lint: {len(new)} new finding(s) across {n_files} files "
              f"({len(known)} baselined)")
        return 1
    print(f"lint: clean — {n_files} files, 0 new findings"
          + (f" ({len(known)} baselined)" if known else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
