"""Determinism rules: RPR002 (no unseeded module-level RNG in the search
and serving stacks) and RPR003 (no wall-clock reads inside functions the
codebase declares pure).

The engine's replayability contract is that a campaign is a function of
``(config, seed)``: two runs with the same seed must produce
byte-identical leaderboards (tier-1 asserts this). Both rules defend
that property at the source level.

Counterpart of ``repro/analysis/rules/determinism.py``: the same scopes and
purity registry under ``src/repro_torch/``. RPR002 also flags torch's
global generator (``torch.manual_seed``, and ``torch.rand`` & co. called
without ``generator=``), one way to break the contract that jax lacks.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Set

from repro_torch.analysis.rules import (Finding, Rule, dotted_name,
                                        enclosing_defs)

#: RPR002 scope — every module whose randomness must flow from the
#: campaign seed. search/ holds the strategies, serve/ the batcher, and
#: the core loop/explorer drive proposal sampling.
_RNG_SCOPE_PREFIXES = ("src/repro_torch/search/", "src/repro_torch/serve/")
_RNG_SCOPE_FILES = {"src/repro_torch/core/loop.py",
                    "src/repro_torch/core/explorer.py"}

#: random-module functions that are fine: constructing an *instance* RNG
#: (which the caller seeds) is the sanctioned pattern
_RANDOM_OK = {"Random", "SystemRandom"}

#: torch calls that (re)seed the process-global generator: whatever a
#: seeded module drew afterwards would depend on who called them last
_TORCH_GLOBAL_SEED = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all",
}

#: torch samplers that draw from the global generator unless handed a
#: ``generator=`` (a ``torch.Generator().manual_seed(seed)`` instance is
#: the sanctioned pattern, as ``random.Random(seed)`` is for the stdlib)
_TORCH_SAMPLERS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.normal", "torch.multinomial", "torch.bernoulli",
}

#: RPR003 registry — functions the codebase declares pure decision
#: logic: every input (including time) arrives as a parameter, so tests
#: and the race explorer can replay them deterministically. Keys are
#: lint-root-relative paths; values are function names (methods listed
#: by bare name).
PURE_FUNCTIONS: Dict[str, Set[str]] = {
    "src/repro_torch/launch/orchestrator.py": {
        "plan_steals", "aggregate_best", "shard_dirs_for",
    },
    "src/repro_torch/launch/campaign.py": {
        "build_leaderboard", "shard_cells", "resolve_grid",
    },
    "src/repro_torch/launch/merge_db.py": {
        "merge_cost_dbs", "_report_rank",
    },
    "src/repro_torch/launch/scheduler.py": {
        "sanitize_owner", "_expire_lease",
    },
    # the kernel campaign's grid cut: every shard and the queue seeding
    # must agree on cell numbering from the arguments alone
    "src/repro_torch/launch/kernel_cell.py": {
        "resolve_kernel_grid", "kernel_grid_cells",
    },
    # the promotion ladder's tier-2 policy: which heads get measured and
    # which duplicate measured row is canonical must replay identically
    # on every shard (exactly-once measurement rides on it)
    "src/repro_torch/core/promotion.py": {
        "plan_promotions", "plan_front_promotions", "select_measured_row",
    },
    # Pareto machinery: dominance ranking, crowding, and the total front
    # order must be pure functions of the row set — merged leaderboards
    # are byte-compared across shard permutations
    "src/repro_torch/core/pareto.py": {
        "dominates", "front_ranks", "crowding_distances", "front_order",
        "hypervolume",
    },
    # objective extraction + front assembly: one shared code path ranks
    # kernel rows and plan rows, replayed identically by every shard and
    # by the merge's leaderboard rebuild
    "src/repro_torch/core/cost_db.py": {
        "derive_objectives", "objectives_of", "objective_value",
        "pareto_rows",
    },
    # the service control plane's fairness/budget policy: every worker
    # grant must be a pure function of the tenant snapshot so scheduling
    # decisions replay in unit tests without a daemon
    "src/repro_torch/core/fairshare.py": {
        "budget_left", "over_budget", "plan_worker_grants",
    },
    # the daemon's per-tick tenant snapshot assembly feeds the fairshare
    # policy; time arrives via now= from the scheduler loop
    "src/repro_torch/launch/service.py": {
        "snapshot_tenants",
    },
}

_WALL_CLOCK_CALLS = {
    "time.time", "time.monotonic", "time.perf_counter", "time.time_ns",
    "time.monotonic_ns", "datetime.now", "datetime.utcnow",
    "datetime.today", "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}


class UnseededRandom(Rule):
    """RPR002 — module-level RNG (``random.random()``,
    ``np.random.uniform()``, no-arg ``np.random.default_rng()``,
    ``torch.randn(...)`` without ``generator=``, ``torch.manual_seed``)
    draws from (or reseeds) interpreter-global state that campaign seeds
    don't control. Search strategies must use ``random.Random(seed)``
    instances; numpy consumers ``np.random.default_rng(seed)``; torch
    consumers a seeded ``torch.Generator`` passed as ``generator=``."""

    id = "RPR002"
    title = "unseeded module-level RNG"
    contract = ("search/serve/core-loop code must draw randomness from "
                "seeded instances (random.Random(seed) / "
                "np.random.default_rng(seed) / a seeded torch.Generator), "
                "never module-level state")

    def applies(self, f) -> bool:
        return (f.rel.startswith(_RNG_SCOPE_PREFIXES)
                or f.rel in _RNG_SCOPE_FILES)

    def check(self, f, project) -> Iterator["Finding"]:
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ImportFrom):
                if node.module == "random":
                    bad = [a.name for a in node.names
                           if a.name not in _RANDOM_OK]
                    if bad:
                        yield self.finding(
                            f, node,
                            f"from random import {', '.join(bad)} pulls "
                            "module-level RNG functions; import Random "
                            "and seed an instance")
                elif node.module == "numpy.random":
                    bad = [a.name for a in node.names
                           if a.name != "default_rng"]
                    if bad:
                        yield self.finding(
                            f, node,
                            f"from numpy.random import {', '.join(bad)} "
                            "pulls global-state RNG; use "
                            "default_rng(seed)")
                continue
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name.startswith("random."):
                attr = name.split(".", 1)[1]
                if "." not in attr and attr not in _RANDOM_OK:
                    yield self.finding(
                        f, node,
                        f"{name}() uses the module-level RNG; use a "
                        "random.Random(seed) instance threaded from the "
                        "campaign seed")
            elif name.startswith(("np.random.", "numpy.random.")):
                attr = name.rsplit(".", 1)[1]
                if attr == "default_rng":
                    if not node.args and not node.keywords:
                        yield self.finding(
                            f, node,
                            "np.random.default_rng() without a seed is "
                            "entropy-seeded; pass the campaign seed")
                else:
                    yield self.finding(
                        f, node,
                        f"{name}() draws from numpy's global RNG; use "
                        "np.random.default_rng(seed)")
            elif name in _TORCH_GLOBAL_SEED:
                yield self.finding(
                    f, node,
                    f"{name}() reseeds torch's global generator; seed a "
                    "torch.Generator instance and pass it as generator=")
            elif name in _TORCH_SAMPLERS \
                    and not any(kw.arg == "generator" for kw in node.keywords):
                yield self.finding(
                    f, node,
                    f"{name}() without generator= draws from torch's "
                    "global generator; pass a torch.Generator seeded from "
                    "the campaign seed")


class WallClockInPureFn(Rule):
    """RPR003 — the functions in :data:`PURE_FUNCTIONS` are declared
    pure: the orchestrator replays ``plan_steals`` decisions in tests,
    the merge is property-tested for order-invariance, and leaderboard
    building must be a function of its inputs. A ``time.time()`` (or any
    wall-clock read) inside them silently re-introduces nondeterminism;
    the clock must arrive as a ``now=`` parameter instead."""

    id = "RPR003"
    title = "wall-clock read in declared-pure function"
    contract = ("functions in the purity registry take time as a "
                "parameter (now=...); they never read the clock "
                "themselves")

    def applies(self, f) -> bool:
        return f.rel in PURE_FUNCTIONS

    def check(self, f, project) -> Iterator["Finding"]:
        registry = PURE_FUNCTIONS[f.rel]
        scopes = enclosing_defs(f.tree)
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name not in _WALL_CLOCK_CALLS:
                continue
            stack = scopes.get(node, ())
            hit = next((s for s in stack if s in registry), None)
            if hit is not None:
                yield self.finding(
                    f, node,
                    f"{name}() inside declared-pure {hit}(); take the "
                    "timestamp as a now= parameter so callers/tests "
                    "control the clock")


__all__ = ["UnseededRandom", "WallClockInPureFn", "PURE_FUNCTIONS"]
