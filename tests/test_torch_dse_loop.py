"""The whole kernel-cell loop of repro_torch against the reference's
``_explore_kernel_cell``: with the port's resource model replaced by the
reference's numbers (so only the loop is compared) and the surrogate
started from the same numpy parameters, both evaluate the same points in
the same order with the same statuses and bounds. Plus the CLI on the CPU."""
import jax
import numpy as np
import pytest
import torch

from repro.core import kernel_space as jks
from repro.core.cost_db import CostDB as JCostDB
from repro.core.cost_model import CostModel as JCostModel
from repro.core.cost_model import init_mlp
from repro.core.evaluator import KernelEvaluator as JKernelEvaluator
from repro.launch.kernel_cell import _explore_kernel_cell as j_explore
from repro.search import make_strategy as j_make_strategy
from repro_torch.core import kernel_space as ks
from repro_torch.core.cost_db import CostDB, featurize
from repro_torch.core.cost_model import CostModel
from repro_torch.core.eval_cache import DryRunCache
from repro_torch.core.evaluator import KernelEvaluator
from repro_torch.kernels import _build
from repro_torch.launch import dse
from repro_torch.launch.kernel_cell import _explore_kernel_cell
from repro_torch.search import make_strategy

IN_DIM = featurize({}, {}).shape[0]


def _rows(db):
    return [(d.point["__key__"], d.status, d.metrics.get("bound_s"), d.source,
             d.iteration) for d in db.all()]


@pytest.mark.parametrize("shape", ["vec_64k_f32", "attn_s128_f32"])
def test_loop_matches_the_reference(shape, tmp_path, monkeypatch):
    def ref_resources(kshape, dims, device=None):
        return jks.kernel_resources(jks.KERNEL_SHAPE_BY_NAME[kshape.name], dims)

    monkeypatch.setattr(ks, "kernel_resources", ref_resources)
    arch = ks.kernel_arch(ks.KERNEL_SHAPE_BY_NAME[shape].kernel)
    params = {k: np.asarray(v) for k, v in init_mlp(jax.random.key(0), IN_DIM).items()}
    kw = dict(iterations=3, budget=3, seed=0, log=lambda *a: None)

    jdb = JCostDB(tmp_path / "ref.jsonl")
    jrep = j_explore(arch, shape, evaluator=JKernelEvaluator(mesh=None, mesh_name="dev1"),
                     db=jdb, cost_model=JCostModel(in_dim=IN_DIM, params=dict(params)),
                     gate=None, strategy=j_make_strategy("greedy"), **kw)
    db = CostDB(tmp_path / "port.jsonl")
    rep = _explore_kernel_cell(
        arch, shape, evaluator=KernelEvaluator(mesh_name="dev1", torch_device="cpu"),
        db=db, cost_model=CostModel.from_numpy(params),
        strategy=make_strategy("greedy"), **kw)
    assert len(_rows(db)) >= 5  # vecmul has 5 legal points in all
    assert _rows(db) == _rows(jdb)
    assert all(d.status == "ok" for d in db.all())
    assert rep["iterations"] == jrep["iterations"]
    assert rep["best"]["point"] == jrep["best"]["point"]
    assert rep["improvement"] == jrep["improvement"]


def test_cli_runs_a_cell_on_the_cpu(tmp_path, capsys):
    db_path = tmp_path / "db.jsonl"
    rep = dse.main(["--space", "kernels", "--arch", "rmsnorm", "--shape",
                    "rms_1kx256_bf16", "--strategy", "greedy", "--iterations", "2",
                    "--budget", "3", "--measure-top-k", "2", "--db", str(db_path),
                    "--device", "cpu", "--report", str(tmp_path / "rep.json")])
    assert rep["baseline"]["point"] == {"block_rows": 128}
    assert rep["best"]["bound_s"] <= rep["baseline"]["bound_s"]
    rows = CostDB(db_path).all()
    measured = [d for d in rows if d.fidelity == "measured"]
    assert len(measured) == 2
    assert all(d.status == "ok" and d.metrics["backend"] == "cpu" for d in measured)
    assert (tmp_path / "rep.json").exists()
    # a second run replays every evaluation and measurement from the caches
    dse.main(["--space", "kernels",
              "--arch", "rmsnorm", "--shape", "rms_1kx256_bf16", "--iterations", "2",
              "--budget", "3", "--measure-top-k", "2", "--db", str(db_path),
              "--device", "cpu"])
    assert "measured tier: 0 timed" in capsys.readouterr().out


def test_cpu_records_never_replay_for_the_card(tmp_path, monkeypatch):
    db_path = tmp_path / "db.jsonl"
    dse.main(["--space", "kernels",
              "--arch", "vecmul", "--shape", "vec_64k_f32", "--iterations", "1",
              "--budget", "2", "--measure-top-k", "1", "--db", str(db_path),
              "--device", "cpu"])
    rows = CostDB(db_path).all()
    evaluated = [d for d in rows if d.fidelity == "dryrun" and d.status == "ok"]
    measured = [d for d in rows if d.fidelity == "measured"]
    assert evaluated and measured
    caches = {"dryrun": DryRunCache.beside(db_path),
              "measured": DryRunCache(tmp_path / "measured_cache")}
    cpu = KernelEvaluator(mesh_name="dev1", torch_device="cpu")
    card = KernelEvaluator(mesh_name="dev1", torch_device="cuda")
    monkeypatch.setattr(_build, "fingerprint", lambda: "edited-sources")
    edited = card.cache_mesh()
    monkeypatch.undo()
    assert cpu.cache_mesh() == "dev1@cpu"
    assert card.cache_mesh() == f"dev1@cuda:{_build.fingerprint()}" != edited
    for d in evaluated + measured:
        cache = caches[d.fidelity]
        key = (d.arch, d.shape)
        assert cache.get(*key, cpu.cache_mesh(), d.point["__key__"]) is not None
        assert cache.get(*key, card.cache_mesh(), d.point["__key__"]) is None
        assert cache.get(*key, edited, d.point["__key__"]) is None
        assert d.mesh == "dev1"


def test_injected_bad_default_becomes_an_infeasible_row(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_INJECT_BAD", "vecmul:block=1024")
    db_path = tmp_path / "db.jsonl"
    rep = dse.main(["--space", "kernels",
                    "--arch", "vecmul", "--shape", "vec_64k_f32", "--iterations", "1",
                    "--budget", "2", "--db", str(db_path), "--device", "cpu"])
    base = CostDB(db_path).all()[0]
    assert base.point["block"] == 1024 and base.status == "infeasible"
    assert base.reason.startswith("correctness gate")
    assert rep["baseline"] is None and rep["best"] is not None


def test_cli_rejects_what_is_not_ported(tmp_path):
    with pytest.raises(SystemExit):
        dse.main(["--space", "kernels",
                  "--arch", "vecmul", "--shape", "rms_1kx256_bf16", "--device", "cpu",
                  "--db", str(tmp_path / "db.jsonl")])


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dse.main(["--space", "kernels", "--arch", "vecmul", "--shape", "vec_64k_f32",
                  "--db", str(tmp_path / "db.jsonl")])
