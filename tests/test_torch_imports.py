"""repro_torch stands alone: importing every one of its modules leaves jax
and repro out of sys.modules, and no source line imports them."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"

CHECK = """
import importlib, json, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(k for k in sys.modules
             if k in ("jax", "repro") or k.startswith(("jax.", "repro.")))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_importing_every_module_pulls_in_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", CHECK], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for name in ("repro_torch.launch.dse", "repro_torch.kernels._build",
                 "repro_torch.core.evaluator", "repro_torch.search.greedy",
                 "repro_torch.launch.campaign", "repro_torch.launch.scheduler",
                 "repro_torch.launch.merge_db", "repro_torch.core.pareto",
                 "repro_torch.configs", "repro_torch.configs.llama3_8b",
                 "repro_torch.sharding.plan", "repro_torch.launch.mesh",
                 "repro_torch.models.layers", "repro_torch.models.transformer",
                 "repro_torch.models.model", "repro_torch.serve.step",
                 "repro_torch.serve.sp_attention", "repro_torch.core.step_analysis",
                 "repro_torch.launch.dryrun", "repro_torch.launch.measure",
                 "repro_torch.train", "repro_torch.train.optimizer",
                 "repro_torch.train.grad_compress", "repro_torch.train.step",
                 "repro_torch.train.data", "repro_torch.train.checkpoint",
                 "repro_torch.train.trainer", "repro_torch.launch.train",
                 "repro_torch.core.lora", "repro_torch.core.explorer",
                 "repro_torch.core.llm_client", "repro_torch.core.rag",
                 "repro_torch.core.cot", "repro_torch.core.llm_stack",
                 "repro_torch.core.mcp", "repro_torch.core.loop",
                 "repro_torch.search.llm_guided", "repro_torch.search.transfer",
                 "repro_torch.examples", "repro_torch.examples.dse_vecmul",
                 "repro_torch.launch.executors", "repro_torch.launch.orchestrator"):
        assert name in out["modules"]


def test_no_source_line_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import|from) (jax|repro)(\.|\s|$)")
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1) if pat.match(line)]
    assert hits == []
