"""RPR004 — torch must stay out of the port's supervisor processes.

Counterpart of ``repro/analysis/rules/imports.py``, re-aimed: where the
reference keeps jax out of its supervisors, this rule keeps ``torch`` and
``triton`` out of the port's. The orchestrator, scheduler, executors,
merge CLI and the service daemon run on login nodes and supervisor hosts
where importing torch costs seconds of startup per shard heartbeat (and
initialises CUDA state a supervisor never needs). The port keeps them
torch-free by importing torch lazily inside the functions that need it
(``run_campaign`` and ``measure_cell`` do this).

A naive "no ``import torch`` at top level" check misses the common way
this regresses: a torch-free module imports a *repro_torch* module that
imports torch at top level. This rule therefore computes a transitive
taint over the project's import graph — a module is *tainted* when any of
its top-level imports reaches torch — and flags any top-level import in
the torch-free scope that lands on a tainted module, reporting the full
chain (``repro_torch.core.evaluator -> torch``) so the fix site is
obvious. Keeping jax and ``repro`` out of the whole port is a different
contract, checked at import time by ``tests/test_torch_imports.py``.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.rules import Finding, Rule

#: modules that must import cleanly without torch present: the
#: counterparts of the reference's jax-free list
_TORCH_FREE_FILES = {
    "src/repro_torch/launch/scheduler.py",
    "src/repro_torch/launch/orchestrator.py",
    "src/repro_torch/launch/executors.py",
    "src/repro_torch/launch/campaign.py",
    "src/repro_torch/launch/merge_db.py",
    "src/repro_torch/launch/ioutil.py",
    # tier-2 measurement CLI: torch is imported lazily inside the
    # functions that run or time a step, so a supervisor can import the
    # module for its parser without paying a torch startup
    "src/repro_torch/launch/measure.py",
    # kernel campaigns: the whole queue/heartbeat/leaderboard drive loop
    # is supervision; torch enters only through the KernelEvaluator and
    # the conformance harness, both imported lazily inside
    # run_kernel_campaign
    "src/repro_torch/launch/kernel_cell.py",
    # Pareto dominance/crowding/hypervolume: stdlib-only so the merge CLI
    # and the leaderboard rebuild can rank fronts on login nodes
    "src/repro_torch/core/pareto.py",
    # DSE-as-a-service control plane: the daemon runs on supervisor nodes
    # and must serve HTTP + schedule workers without a torch runtime;
    # torch lives only in the campaign worker subprocesses it spawns
    "src/repro_torch/launch/service.py",
    "src/repro_torch/core/fairshare.py",
}
_TORCH_FREE_PREFIXES = ("src/repro_torch/analysis/",)

_TORCH_ROOTS = ("torch", "triton")


def _rel_to_module(rel: str) -> Optional[str]:
    """``src/repro_torch/launch/dse.py`` -> ``repro_torch.launch.dse`` (None for
    files outside the ``src/`` package tree)."""
    if not rel.startswith("src/") or not rel.endswith(".py"):
        return None
    mod = rel[len("src/"):-len(".py")]
    if mod.endswith("/__init__"):
        mod = mod[: -len("/__init__")]
    return mod.replace("/", ".")


def torch_free_modules(root: Path) -> List[str]:
    """The dotted names of every module in this rule's scope under the
    lint ``root``: the torch-free files and every module under the
    torch-free prefixes (what a run-time check imports with torch
    blocked)."""
    rels = set(_TORCH_FREE_FILES)
    for prefix in _TORCH_FREE_PREFIXES:
        rels.update(p.relative_to(root).as_posix()
                    for p in (root / prefix).rglob("*.py"))
    return sorted(_rel_to_module(r) for r in rels)


def _is_torch(mod: str) -> bool:
    root = mod.split(".", 1)[0]
    return root in _TORCH_ROOTS


def _top_level_imports(tree: ast.AST, self_mod: Optional[str],
                       ) -> List[Tuple[str, int]]:
    """(module, lineno) for every top-level import, with relative
    imports resolved against the importing module's package."""
    out: List[Tuple[str, int]] = []
    for node in ast.iter_child_nodes(tree):
        # guard one level of nesting: `if TYPE_CHECKING:` imports are
        # not executed at runtime and must not taint
        if isinstance(node, ast.If):
            continue
        if isinstance(node, ast.Import):
            out.extend((a.name, node.lineno) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                if self_mod is None:
                    continue
                parts = self_mod.split(".")
                # level=1 from a module means its own package
                base = parts[: len(parts) - node.level]
                mod = ".".join(base + ([mod] if mod else []))
            if mod:
                out.append((mod, node.lineno))
                # `from pkg import sub` may bind a submodule: emit the
                # dotted candidate too (taint lookup walks prefixes, so
                # a name that is really a function resolves to pkg)
                out.extend((f"{mod}.{a.name}", node.lineno)
                           for a in node.names if a.name != "*")
    return out


class TorchImportInTorchFreeScope(Rule):
    """RPR004 — no top-level torch or triton (direct or transitive
    through repro_torch modules) in supervisor code; see module
    docstring."""

    id = "RPR004"
    title = "top-level torch import in torch-free scope"
    contract = ("supervisor modules import torch lazily inside "
                "functions; top-level imports must not reach torch or "
                "triton, even transitively through other repro_torch "
                "modules")

    def applies(self, f) -> bool:
        return (f.rel in _TORCH_FREE_FILES
                or f.rel.startswith(_TORCH_FREE_PREFIXES))

    def _taint(self, project) -> Dict[str, List[str]]:
        """Map tainted module name -> witness chain ending in the torch
        root, e.g. ``['repro_torch.train.checkpoint', 'torch']``. Fixpoint over
        the project's top-level import graph."""
        cache = getattr(project, "_rpr004_taint", None)
        if cache is not None:
            return cache
        imports: Dict[str, List[str]] = {}
        for sf in project.files:
            mod = _rel_to_module(sf.rel)
            if mod is None:
                continue
            imports[mod] = [m for m, _ in
                            _top_level_imports(sf.tree, mod)]
        taint: Dict[str, List[str]] = {}
        changed = True
        while changed:
            changed = False
            for mod, deps in imports.items():
                if mod in taint:
                    continue
                for dep in deps:
                    if _is_torch(dep):
                        taint[mod] = [dep.split(".", 1)[0]]
                        changed = True
                        break
                    # an import of repro_torch.a.b executes it AND the
                    # repro_torch.a / repro_torch packages; any tainted
                    # prefix taints
                    chain = self._tainted_prefix(dep, taint, imports)
                    if chain is not None:
                        taint[mod] = chain
                        changed = True
                        break
        project._rpr004_taint = taint
        return taint

    @staticmethod
    def _tainted_prefix(dep: str, taint: Dict[str, List[str]],
                        imports: Dict[str, List[str]],
                        ) -> Optional[List[str]]:
        parts = dep.split(".")
        for i in range(len(parts), 0, -1):
            prefix = ".".join(parts[:i])
            if prefix in taint:
                return [prefix] + taint[prefix]
            if prefix in imports:
                # known-clean so far this fixpoint round; keep walking
                continue
        return None

    def check(self, f, project) -> Iterator[Finding]:
        taint = self._taint(project)
        self_mod = _rel_to_module(f.rel)
        known: Set[str] = {m for sf in project.files
                           for m in [_rel_to_module(sf.rel)] if m}
        flagged_lines: Set[int] = set()
        for node in ast.iter_child_nodes(f.tree):
            if isinstance(node, ast.If):
                continue
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            for mod, line in _top_level_imports_of(node, self_mod):
                if line in flagged_lines:
                    continue
                if _is_torch(mod):
                    flagged_lines.add(line)
                    yield Finding(
                        rule=self.id, rel=f.rel, line=line,
                        message=f"top-level import of {mod} in torch-free "
                                "scope; import it lazily inside the "
                                "function that needs it",
                        snippet=f.lines[line - 1].strip())
                    continue
                chain = self._tainted_prefix(mod, taint, {m: []
                                                          for m in known})
                if chain is not None:
                    flagged_lines.add(line)
                    full = " -> ".join(dict.fromkeys([mod] + chain))
                    yield Finding(
                        rule=self.id, rel=f.rel, line=line,
                        message=f"top-level import chain reaches torch: "
                                f"{full}; break the chain with a lazy "
                                "import",
                        snippet=f.lines[line - 1].strip())


def _top_level_imports_of(node: ast.AST, self_mod: Optional[str],
                          ) -> List[Tuple[str, int]]:
    """Single-statement version of :func:`_top_level_imports`."""
    shim = ast.Module(body=[node], type_ignores=[])
    return _top_level_imports(shim, self_mod)


__all__ = ["TorchImportInTorchFreeScope", "torch_free_modules"]
