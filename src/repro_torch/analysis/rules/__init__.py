"""Rule registry and shared plumbing for the port's invariant linter.

Counterpart of ``repro/analysis/rules/__init__.py``, copied; the registry
runs RPR004 re-aimed at torch (``rules.imports``).

A *rule* is a small object with an ``id`` (``RPR001``…), a one-line
``contract`` (what invariant it enforces and where), and a
``check(file, project)`` generator yielding :class:`Finding` objects.
Rules see the whole :class:`~repro_torch.analysis.lint.Project` so cross-file
checks (RPR004's transitive torch-taint) are first-class, not bolted on.

Findings carry a content-addressed ``fingerprint`` — a hash of
``rule id + relative path + normalized source line (+ occurrence index)``
— deliberately excluding the line *number*, so baseline entries survive
unrelated edits that shift code up or down. The linter's ratcheting
baseline (``repro_torch.analysis.baseline``) keys on these fingerprints.

The registry below is the single source of truth for which rules run;
README.md's port section mirrors it as a human-readable table.
"""
from __future__ import annotations

import ast
import hashlib
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Iterable, Iterator, List

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids an import cycle
    from repro_torch.analysis.lint import Project, SourceFile


@dataclass
class Finding:
    """One rule violation at one source location."""
    rule: str            # "RPR001"
    rel: str             # posix path relative to the lint root
    line: int            # 1-based line number (display only, not identity)
    message: str         # human-readable description of the violation
    snippet: str = ""    # the offending source line, stripped
    occurrence: int = 0  # disambiguates identical lines in one file

    @property
    def fingerprint(self) -> str:
        """Stable identity for the baseline ratchet. Hashes the rule, the
        file, and the *text* of the offending line — never its number —
        so entries survive line drift; ``occurrence`` separates repeats
        of an identical line within one file."""
        key = f"{self.rule}:{self.rel}:{self.snippet}:{self.occurrence}"
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def render(self) -> str:
        """One-line ``path:line: RULE message`` report format."""
        loc = f"{self.rel}:{self.line}"
        return f"{loc}: {self.rule} {self.message}"


class Rule:
    """Base class: subclasses set ``id``/``title``/``contract`` and
    implement ``check``. ``applies`` pre-filters files so rule bodies
    only ever see their own scope."""

    id: str = "RPR000"
    title: str = ""
    contract: str = ""

    def applies(self, f: "SourceFile") -> bool:
        raise NotImplementedError

    def check(self, f: "SourceFile", project: "Project") -> Iterator[Finding]:
        raise NotImplementedError

    # -- shared helpers -------------------------------------------------

    def finding(self, f: "SourceFile", node: ast.AST, message: str,
                ) -> Finding:
        """Build a Finding anchored at ``node``, filling in the snippet
        from the file's source lines."""
        line = getattr(node, "lineno", 1)
        snippet = ""
        if 1 <= line <= len(f.lines):
            snippet = f.lines[line - 1].strip()
        return Finding(rule=self.id, rel=f.rel, line=line,
                       message=message, snippet=snippet)


def number_occurrences(findings: Iterable[Finding]) -> List[Finding]:
    """Assign ``occurrence`` indices so two findings on byte-identical
    lines in the same file fingerprint differently (source order)."""
    seen: dict = {}
    out = []
    for fd in findings:
        key = (fd.rule, fd.rel, fd.snippet)
        fd.occurrence = seen.get(key, 0)
        seen[key] = fd.occurrence + 1
        out.append(fd)
    return out


# -- AST helpers shared across rule modules -----------------------------

def dotted_name(node: ast.AST) -> str:
    """Render ``a.b.c`` attribute/name chains; '' for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def subtree_mentions_tmp(node: ast.AST) -> bool:
    """True when a path expression is visibly a temp file: any name,
    attribute, or string constant in the subtree containing ``tmp``.
    This is the linter's exemption for the write-tmp-then-rename idiom
    (``write_json_atomic``, CellQueue's seam writes)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and "tmp" in n.id.lower():
            return True
        if isinstance(n, ast.Attribute) and "tmp" in n.attr.lower():
            return True
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and "tmp" in n.value.lower():
            return True
    return False


def enclosing_defs(tree: ast.AST) -> dict:
    """Map every node to the stack of enclosing function/class names,
    e.g. ``['LocalFS', 'write_text']``. Used for registry-scoped rules
    (RPR003 purity) and class-level exemptions (RPR005's fs primitive
    layer)."""
    scopes: dict = {}

    def visit(node: ast.AST, stack: tuple):
        scopes[node] = stack
        child_stack = stack
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            child_stack = stack + (node.name,)
        for child in ast.iter_child_nodes(node):
            visit(child, child_stack)

    visit(tree, ())
    return scopes


def _registry() -> List[Rule]:
    # imported lazily so `python -m repro_torch.analysis.rules...` cannot cycle
    from repro_torch.analysis.rules.atomic_writes import (NonAtomicJsonWrite,
                                                          CreatingWriteInQueue)
    from repro_torch.analysis.rules.determinism import (UnseededRandom,
                                                        WallClockInPureFn)
    from repro_torch.analysis.rules.imports import TorchImportInTorchFreeScope
    from repro_torch.analysis.rules.exceptions import SwallowedException
    return [NonAtomicJsonWrite(), UnseededRandom(), WallClockInPureFn(),
            TorchImportInTorchFreeScope(), CreatingWriteInQueue(),
            SwallowedException()]


RULES: List[Rule] = _registry()
