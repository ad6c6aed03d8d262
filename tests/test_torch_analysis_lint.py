"""repro_torch.analysis.lint against the reference's linter: the reference's
rule fixtures (true positives and the tricky false positives each rule
must tolerate) placed at the reference's paths for
``repro.analysis.lint`` and at the mapped ``src/repro_torch/`` paths for
the port's, with ``torch`` written where the reference's RPR004 fixtures
write ``jax``; the two must report the same findings. Then the port's own
checks: RPR002's torch generator cases, the ratcheting baseline, the CLI,
two RPR004 faults planted in a copy of the port, the shipped tree against
the shipped empty ``analysis_baseline_torch.json``, and the README's
fenced commands."""
import ast
import json
import re
import shlex
import shutil
import textwrap
from pathlib import Path

import pytest

from repro.analysis.lint import lint_paths as ref_lint_paths
from repro.analysis.rules import determinism as ref_determinism
from repro.analysis.rules import imports as ref_imports
from repro_torch.analysis import race
from repro_torch.analysis.baseline import load_baseline
from repro_torch.analysis.lint import DEFAULT_SCAN, build_parser, lint_paths, main
from repro_torch.analysis.rules import RULES, determinism, imports

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT_BASELINE = "analysis_baseline_torch.json"


def mini_repo(root, files):
    """Materialize a fixture tree: {relpath: source} -> root dir."""
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def port_path(rel: str) -> str:
    """A reference path's counterpart: ``src/repro/X`` -> ``src/repro_torch/X``;
    the reference's ``benchmarks/`` (prefix-scoped for RPR004, like its
    ``analysis/``) -> the port's prefix-scoped ``src/repro_torch/analysis/``."""
    if rel.startswith("benchmarks/"):
        return "src/repro_torch/analysis/" + rel[len("benchmarks/"):]
    assert rel.startswith("src/repro/"), rel
    return "src/repro_torch/" + rel[len("src/repro/"):]


def port_text(text: str) -> str:
    """Source, snippet or message with module names mapped and ``torch``
    for ``jax``."""
    return re.sub(r"\bjax\b", "torch", re.sub(r"\brepro\.", "repro_torch.", text))


def as_tuples(findings, path=str, text=str):
    return sorted((f.rule, path(f.rel), f.line, text(f.snippet), text(f.message))
                  for f in findings)


# ---------------------------------------------------------------------------
# the reference's fixture corpora (tests/test_analysis_lint.py), with the
# rules each fires there
# ---------------------------------------------------------------------------

FIXTURES = {
    "rpr001_flags_inplace_json_writes": ({
        "src/repro/launch/report.py": """
            import json
            from pathlib import Path

            def save(path, payload):
                Path(path).write_text(json.dumps(payload))

            def save2(payload):
                with open("artifacts/report.json", "w") as f:
                    json.dump(payload, f)
        """}, ["RPR001"] * 3),
    "rpr001_tolerates_tmp_rename_idiom_and_non_json": ({
        "src/repro/launch/ioutil.py": """
            import json
            import os
            from pathlib import Path

            def write_json_atomic(path, payload):
                path = Path(path)
                tmp = path.with_suffix(".json.tmp")
                tmp.write_text(json.dumps(payload, indent=1, default=str))
                tmp.replace(path)
                return path

            def write_marker(path):
                Path(path).write_text("armed")  # not JSON: fine in place
        """}, []),
    "rpr001_scope_excludes_core": ({
        "src/repro/core/report.py": """
            import json
            from pathlib import Path

            def save(path, payload):
                Path(path).write_text(json.dumps(payload))
        """}, []),
    "rpr002_flags_module_level_rng": ({
        "src/repro/search/strategy.py": """
            import random
            import numpy as np
            from random import choice

            def propose():
                x = random.random()
                y = np.random.uniform()
                g = np.random.default_rng()
                return x + y
        """}, ["RPR002"] * 4),
    "rpr002_tolerates_seeded_instances": ({
        "src/repro/search/strategy.py": """
            import random
            import numpy as np
            from random import Random

            def propose(seed):
                rng = random.Random(seed)
                g = np.random.default_rng(seed)
                return rng.random() + g.uniform()
        """,
        "src/repro/launch/jitter.py": """
            import random

            def backoff():
                return random.random()
        """}, []),
    "rpr003_flags_clock_in_registered_function_only": ({
        "src/repro/launch/orchestrator.py": """
            import time

            def plan_steals(counts, now):
                deadline = time.time() + 5  # BAD: registry says pure
                return deadline

            def heartbeat_loop():
                return time.time()  # fine: not in the purity registry
        """}, ["RPR003"]),
    "rpr004_flags_direct_and_transitive": ({
        "benchmarks/bench.py": """
            import jax

            def run():
                return jax.devices()
        """,
        "src/repro/train/ckpt.py": """
            import jax
        """,
        "src/repro/launch/orchestrator.py": """
            from repro.train import ckpt
        """}, ["RPR004"] * 2),
    "rpr004_tolerates_lazy_and_type_checking_imports": ({
        "src/repro/train/ckpt.py": """
            import jax
        """,
        "src/repro/launch/executors.py": """
            from typing import TYPE_CHECKING

            if TYPE_CHECKING:
                import jax  # annotation-only: never executed

            def launch():
                from repro.train import ckpt  # lazy: the sanctioned form
                return ckpt
        """}, []),
    "rpr005_flags_creating_writes_in_scheduler": ({
        "src/repro/launch/scheduler.py": """
            import os

            class CellQueue:
                def rewrite(self, path, text):
                    path.write_text(text)  # BAD: creates if missing

                def claim(self, path):
                    fd = os.open(path, os.O_WRONLY | os.O_CREAT)  # BAD
                    os.close(fd)
        """}, ["RPR005"] * 2),
    "rpr005_tolerates_tmp_paths_and_primitive_layer": ({
        "src/repro/launch/scheduler.py": """
            import os
            from pathlib import Path

            class LocalFS:
                def write_text(self, path, text):
                    Path(path).write_text(text)  # the primitive layer

                def rewrite_nocreate(self, path, text):
                    fd = os.open(path, os.O_WRONLY)  # no O_CREAT: legal
                    os.close(fd)

            class CellQueue:
                def _write(self, fs, path, ticket):
                    tmp = path.with_name(path.name + ".tmp")
                    fs.write_text(tmp, ticket)  # tmp + replace idiom
                    fs.replace(tmp, path)
        """}, []),
    "rpr006_flags_silent_broad_catch_only": ({
        "src/repro/launch/heal.py": """
            def kill(pid):
                try:
                    raise OSError(pid)
                except Exception:
                    pass  # BAD: the supervisor never learns

            def kill2(pid):
                try:
                    raise OSError(pid)
                except (ProcessLookupError, OSError):
                    pass  # narrow, deliberate race tolerance: fine

            def kill3(pid):
                try:
                    raise OSError(pid)
                except Exception as e:
                    print(f"heal: {e}")  # broad but surfaced: fine
        """}, ["RPR006"]),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_linter_matches_the_reference_on_its_fixtures(tmp_path, name):
    files, want_rules = FIXTURES[name]
    ref = ref_lint_paths(mini_repo(tmp_path / "ref", files))
    port = lint_paths(mini_repo(tmp_path / "port", {
        port_path(rel): port_text(src) for rel, src in files.items()}))
    assert [f.rule for f in ref] == want_rules  # the fixture still bites
    assert as_tuples(port) == as_tuples(ref, port_path, port_text)


def test_rpr004_chain_names_the_port_module(tmp_path):
    files, _ = FIXTURES["rpr004_flags_direct_and_transitive"]
    port = lint_paths(mini_repo(tmp_path, {
        port_path(rel): port_text(src) for rel, src in files.items()}))
    chained = [f for f in port if f.rel == "src/repro_torch/launch/orchestrator.py"]
    assert len(chained) == 1
    assert "repro_torch.train.ckpt -> torch" in chained[0].message


# ---------------------------------------------------------------------------
# the scopes carried over: RPR003's registry and RPR004's list, mapped
# ---------------------------------------------------------------------------

def test_purity_registry_is_the_references_with_paths_mapped():
    assert determinism.PURE_FUNCTIONS == {
        port_path(rel): names for rel, names in ref_determinism.PURE_FUNCTIONS.items()}
    for rel, names in determinism.PURE_FUNCTIONS.items():
        tree = ast.parse((REPO_ROOT / rel).read_text())
        defined = {n.name for n in ast.walk(tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        assert names <= defined, (rel, sorted(names - defined))


def test_torch_free_list_is_the_references_jax_free_list_mapped():
    assert imports._TORCH_FREE_FILES == {port_path(r) for r in ref_imports._JAX_FREE_FILES}
    assert imports._TORCH_FREE_PREFIXES == ("src/repro_torch/analysis/",)
    assert imports._TORCH_ROOTS == ("torch", "triton")
    for rel in imports._TORCH_FREE_FILES:
        assert (REPO_ROOT / rel).is_file(), rel


def test_registry_runs_six_rules_with_rpr004_aimed_at_torch():
    assert [r.id for r in RULES] == ["RPR001", "RPR002", "RPR003", "RPR004",
                                     "RPR005", "RPR006"]
    rpr004 = next(r for r in RULES if r.id == "RPR004")
    assert type(rpr004).__name__ == "TorchImportInTorchFreeScope"
    assert DEFAULT_SCAN == ("src/repro_torch",)


# ---------------------------------------------------------------------------
# RPR002: torch's global generator (no counterpart in the reference)
# ---------------------------------------------------------------------------

TORCH_RNG_BAD = """
    import torch

    def propose(p):
        torch.manual_seed(0)
        torch.cuda.manual_seed_all(0)
        a = torch.rand(2)
        b = torch.randn(3)
        c = torch.randint(0, 5, (2,))
        d = torch.randperm(4)
        e = torch.normal(0.0, 1.0, (2,))
        f = torch.multinomial(p, 1)
        g = torch.bernoulli(p)
        return a, b, c, d, e, f, g
"""

TORCH_RNG_GOOD = """
    import torch

    def propose(p, seed):
        gen = torch.Generator().manual_seed(seed)
        a = torch.rand(2, generator=gen)
        b = torch.randn(3, generator=gen)
        c = torch.randint(0, 5, (2,), generator=gen)
        d = torch.randperm(4, generator=gen)
        e = torch.normal(0.0, 1.0, (2,), generator=gen)
        f = torch.multinomial(p, 1, generator=gen)
        g = torch.bernoulli(p, generator=gen)
        return a, b, c, d, e, f, g, torch.zeros(2)
"""


def test_rpr002_flags_torch_global_generator(tmp_path):
    findings = lint_paths(mini_repo(tmp_path, {
        "src/repro_torch/search/strategy.py": TORCH_RNG_BAD,
        "src/repro_torch/serve/sampler.py": "import torch\n\n\ndef pick(p):\n"
                                            "    return torch.multinomial(p, 1)\n",
        "src/repro_torch/core/loop.py": "import torch\n\ntorch.manual_seed(1)\n"}))
    assert [f.rule for f in findings] == ["RPR002"] * 11
    by_line = {(f.rel, f.line): f.message for f in findings}
    assert "reseeds torch's global generator" in by_line[
        ("src/repro_torch/search/strategy.py", 5)]
    assert "torch.randn() without generator=" in by_line[
        ("src/repro_torch/search/strategy.py", 8)]


def test_rpr002_tolerates_seeded_torch_generators(tmp_path):
    root = mini_repo(tmp_path, {
        "src/repro_torch/search/strategy.py": TORCH_RNG_GOOD,
        # the global generator OUTSIDE the determinism scope is allowed
        "src/repro_torch/launch/jitter.py": TORCH_RNG_BAD})
    assert lint_paths(root) == []


def test_the_reference_linter_knows_no_torch_rng(tmp_path):
    """The torch cases are the port's own: at the reference's path the
    reference's RPR002 reports nothing for them."""
    root = mini_repo(tmp_path, {"src/repro/search/strategy.py": TORCH_RNG_BAD})
    assert ref_lint_paths(root) == []


# ---------------------------------------------------------------------------
# fingerprints + the ratcheting baseline + the CLI
# ---------------------------------------------------------------------------

BAD_SEARCH = """
    import random

    def propose():
        return random.random()
"""


def test_fingerprint_survives_line_drift(tmp_path):
    root = mini_repo(tmp_path, {"src/repro_torch/search/s.py": BAD_SEARCH})
    (first,) = lint_paths(root)
    src = (root / "src/repro_torch/search/s.py").read_text()
    (root / "src/repro_torch/search/s.py").write_text("# new header\n\n" + src)
    (drifted,) = lint_paths(root)
    assert drifted.line == first.line + 2
    assert drifted.fingerprint == first.fingerprint  # same debt, new line number


def test_baseline_grow_fails_shrink_tightens(tmp_path, capsys):
    root = mini_repo(tmp_path, {"src/repro_torch/search/s.py": BAD_SEARCH})
    argv = ["--root", str(root), "--baseline", "bl.json"]

    assert main(argv) == 1  # a violation with no accepted debt fails
    assert main(argv + ["--write-baseline"]) == 0  # bootstrap accepts it
    assert len(load_baseline(root / "bl.json")) == 1
    assert main(argv) == 0  # ...and the gated run is now green

    # GROW: a second violation is new debt -> fail
    (root / "src/repro_torch/search/s2.py").write_text(
        "import random\n\ndef f():\n    return random.choice([1])\n")
    assert main(argv) == 1
    (root / "src/repro_torch/search/s2.py").unlink()

    # SHRINK: fixing the original violation auto-tightens the baseline
    (root / "src/repro_torch/search/s.py").write_text(
        "import random\n\ndef propose(seed):\n"
        "    return random.Random(seed).random()\n")
    capsys.readouterr()
    assert main(argv) == 0
    assert "ratchet tightened" in capsys.readouterr().out
    assert load_baseline(root / "bl.json") == {}

    # the ratchet is one-way: the fixed debt cannot silently return
    (root / "src/repro_torch/search/s.py").write_text(textwrap.dedent(BAD_SEARCH))
    assert main(argv) == 1


def test_rules_filter_and_unknown_rule(tmp_path):
    root = mini_repo(tmp_path, {
        "src/repro_torch/search/s.py": BAD_SEARCH,
        "src/repro_torch/launch/r.py": """
            import json
            from pathlib import Path

            def save(p, d):
                Path(p).write_text(json.dumps(d))
        """})
    assert {f.rule for f in lint_paths(root)} == {"RPR001", "RPR002"}
    assert main(["--root", str(root), "--rules", "RPR002"]) == 1
    assert main(["--root", str(root), "--rules", "rpr006"]) == 0
    assert main(["--root", str(root), "--rules", "RPR999"]) == 2


def test_unparseable_source_is_exit_2(tmp_path, capsys):
    root = mini_repo(tmp_path, {"src/repro_torch/search/s.py": "def f(:\n"})
    assert main(["--root", str(root)]) == 2
    assert "cannot parse" in capsys.readouterr().out


def test_json_output_marks_baselined_findings(tmp_path, capsys):
    root = mini_repo(tmp_path, {"src/repro_torch/search/s.py": BAD_SEARCH})
    assert main(["--root", str(root), "--baseline", "bl.json", "--write-baseline"]) == 0
    capsys.readouterr()
    assert main(["--root", str(root), "--baseline", "bl.json", "--json"]) == 0
    out = capsys.readouterr().out
    rows = json.loads(out[:out.rindex("]") + 1])
    assert [(r["rule"], r["path"], r["baselined"]) for r in rows] == [
        ("RPR002", "src/repro_torch/search/s.py", True)]


# ---------------------------------------------------------------------------
# planted faults in a copy of the port: RPR004 direct and transitive
# ---------------------------------------------------------------------------

def _plant_after_imports(path: Path, line: str) -> int:
    """Insert ``line`` after the module's last top-level import; return its
    1-based line number."""
    text = path.read_text()
    tree = ast.parse(text)
    last = max(n.end_lineno for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom)))
    lines = text.splitlines(keepends=True)
    lines.insert(last, line + "\n")
    path.write_text("".join(lines))
    return last + 1


def test_planted_torch_imports_are_found_with_their_chains(tmp_path):
    """A direct ``import torch`` in the orchestrator is found there, and in
    the service, which imports the orchestrator at top level; with the
    orchestrator restored, the service importing the evaluator is found
    once, by its chain."""
    shutil.copytree(REPO_ROOT / "src" / "repro_torch", tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    pkg = tmp_path / "src" / "repro_torch"
    assert lint_paths(tmp_path) == []  # the copy starts clean
    orch = pkg / "launch" / "orchestrator.py"
    clean = orch.read_text()
    direct = _plant_after_imports(orch, "import torch")
    service_line = next(i for i, ln in enumerate(
        (pkg / "launch" / "service.py").read_text().splitlines(), 1)
        if ln.startswith("from repro_torch.launch.orchestrator import"))
    assert [(f.rule, f.rel, f.line, f.message) for f in lint_paths(tmp_path)] == [
        ("RPR004", "src/repro_torch/launch/orchestrator.py", direct,
         "top-level import of torch in torch-free scope; import it lazily "
         "inside the function that needs it"),
        ("RPR004", "src/repro_torch/launch/service.py", service_line,
         "top-level import chain reaches torch: repro_torch.launch.orchestrator -> torch; "
         "break the chain with a lazy import"),
    ]
    assert main(["--root", str(tmp_path), "--rules", "RPR004"]) == 1

    orch.write_text(clean)
    chained = _plant_after_imports(pkg / "launch" / "service.py",
                                   "from repro_torch.core.evaluator import Evaluator")
    assert [(f.rule, f.rel, f.line, f.message) for f in lint_paths(tmp_path)] == [
        ("RPR004", "src/repro_torch/launch/service.py", chained,
         "top-level import chain reaches torch: repro_torch.core.evaluator -> torch; "
         "break the chain with a lazy import"),
    ]


# ---------------------------------------------------------------------------
# acceptance: the shipped tree is clean against the shipped empty baseline
# ---------------------------------------------------------------------------

def test_shipped_tree_is_clean_against_the_empty_baseline(capsys):
    findings = lint_paths(REPO_ROOT)
    assert findings == [], "\n".join(f.render() for f in findings)
    before = (REPO_ROOT / PORT_BASELINE).read_text()
    assert json.loads(before)["findings"] == []
    assert main(["--root", str(REPO_ROOT), "--baseline", PORT_BASELINE]) == 0
    assert "lint: clean" in capsys.readouterr().out
    assert (REPO_ROOT / PORT_BASELINE).read_text() == before  # nothing rewritten


def test_readme_commands_parse_with_the_port_parsers():
    parsers = {"repro_torch.analysis.lint": build_parser,
               "repro_torch.analysis.race": race.build_parser}
    readme = (REPO_ROOT / "README.md").read_text()
    seen = []
    for block in re.findall(r"```[^\n]*\n(.*?)```", readme, re.DOTALL):
        for line in re.sub(r"\\\s*\n\s*", " ", block).splitlines():
            line = line.split("#", 1)[0]
            if "-m repro_torch.analysis." not in line:
                continue
            toks = shlex.split(line)
            mod = toks[toks.index("-m") + 1]
            assert mod in parsers, line
            parsers[mod]().parse_args(toks[toks.index("-m") + 2:])
            seen.append(mod)
    assert set(seen) == set(parsers)
