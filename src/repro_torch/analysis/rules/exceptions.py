"""RPR006 — no silently-swallowed broad exceptions in the launch layer.

Counterpart of ``repro/analysis/rules/exceptions.py``, copied, scoped to
the port's ``src/repro_torch/launch/``.

The orchestrator's heal/heartbeat/steal paths deliberately tolerate
specific races (``ProcessLookupError`` when a healed shard already
exited, ``FileNotFoundError`` when a rename lost) — those narrow,
commented catches are the protocol working as designed. What this rule
bans is the degenerate form: ``except Exception: pass`` (or bare
``except`` / ``BaseException`` with an empty body), which converts a
real fault — a corrupted ticket, a dead executor — into silence the
supervisor can never heal from. Catch narrowly, or at minimum log.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.rules import Finding, Rule

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:  # bare except:
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    for n in names:
        if isinstance(n, ast.Name) and n.id in _BROAD:
            return True
        if isinstance(n, ast.Attribute) and n.attr in _BROAD:
            return True
    return False


def _is_silent(handler: ast.ExceptHandler) -> bool:
    """Body is nothing but ``pass`` / ``...`` — no logging, no re-raise,
    no fallback value."""
    for stmt in handler.body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant) \
                and stmt.value.value is Ellipsis:
            continue
        return False
    return True


class SwallowedException(Rule):
    """RPR006 — broad except with an empty body in ``repro_torch.launch``."""

    id = "RPR006"
    title = "silently swallowed broad exception"
    contract = ("launch-layer code never pairs a broad catch (bare / "
                "Exception / BaseException) with an empty body; catch "
                "the specific race or surface the fault")

    def applies(self, f) -> bool:
        return f.rel.startswith("src/repro_torch/launch/")

    def check(self, f, project) -> Iterator[Finding]:
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ExceptHandler) \
                    and _is_broad(node) and _is_silent(node):
                what = ("bare except" if node.type is None
                        else "broad except")
                yield self.finding(
                    f, node,
                    f"{what} with empty body swallows faults the "
                    "supervisor needs to see; catch the specific "
                    "exception or handle/log it")


__all__ = ["SwallowedException"]
