"""The plan loop of repro_torch.

Against the reference: ``DSELoop`` with one deterministic stub evaluator
(one formula from point to metrics, duck-typed for either package's rows),
the same surrogate weights and adapters, MockLLM, the default ensemble and
seed 0 gives the same rows (point keys, sources, statuses, iterations),
the same ensemble credit and the same heartbeats; so does
``TransferSeeded`` on a DB that holds donor cells; and ``Evaluator.
_rec_to_datapoint`` reads one dry-run record into the reference's row, with
``mfu_at_bound`` over the H100's bf16 peak instead of the TPU's.

On the port's real Evaluator (the reduced qwen3-0.6b on a tiny train_4k
cell, as ``tests/test_dryrun_and_loop.py`` runs the reference): the loop
end to end on the CPU, pool results equal to serial ones, a replay with 0
dry runs, a dry run that gives the same record before and after a
measurement on the 1x1 CPU mesh (one process group per process), the
measured tier's batch cut and its skip, a head_dim-sharded plan's dry run,
and the MCP registry's contract."""
import dataclasses
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro.core import lora as jlora
from repro.core.cost_db import CostDB as JCostDB
from repro.core.cost_db import DataPoint as JDataPoint
from repro.core.cost_model import CostModel as JCostModel
from repro.core.cost_model import init_mlp
from repro.core.device import TPU_V5E
from repro.core.evaluator import Evaluator as JEvaluator
from repro.core.llm_client import MockLLM as JMockLLM
from repro.core.llm_stack import LLMStack as JLLMStack
from repro.core.loop import DSELoop as JDSELoop
from repro.search import make_strategy as jmake_strategy
from repro_torch.configs import SHAPE_BY_NAME, get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.core import evaluator as evaluator_mod
from repro_torch.core import lora
from repro_torch.core import loop as loop_mod
from repro_torch.core.cost_db import CostDB, DataPoint, featurize, workload_features
from repro_torch.core.cost_model import CostModel
from repro_torch.core.design_space import DIMENSIONS, PlanPoint, PlanTemplate, baseline_point
from repro_torch.core.device import H100_CLUSTER
from repro_torch.core.eval_cache import DryRunCache
from repro_torch.core.evaluator import Evaluator
from repro_torch.core.llm_client import MockLLM
from repro_torch.core.llm_stack import LLMStack
from repro_torch.core.loop import DSELoop
from repro_torch.core.mcp import Registry
from repro_torch.launch import measure
from repro_torch.models import layers
from repro_torch.search import make_strategy

IN_DIM = featurize({}, {}).shape[0]
POD = {"data": 16, "model": 16}


# ---------------------------------------------------------------------------
# the loop against the reference's, on one stub evaluator
# ---------------------------------------------------------------------------
def _factor(k, v) -> float:
    """A deterministic multiplier for one plan dimension's value."""
    i = list(DIMENSIONS[k]).index(v) if k in DIMENSIONS and v in DIMENSIONS[k] else 0
    return 1.0 + 0.15 * (((3 * i + len(k)) % 5) - 2)


class StubEvaluator:
    """One formula from a plan point to its row; ``dp_cls`` is the
    package's DataPoint. Duck-types both packages' evaluators (the
    reference reads ``mesh.shape``, the port ``mesh_shape``)."""

    def __init__(self, dp_cls, cfg, cell):
        self.DataPoint = dp_cls
        self.mesh = SimpleNamespace(shape=dict(POD))
        self.mesh_shape = dict(POD)
        self.mesh_name = "pod16x16"
        self.cache = None
        self.compile_count = 0
        self.pruned_count = 0
        self.wl = workload_features(cfg, cell)

    def metrics(self, dims):
        terms = {"compute": 0.4, "memory": 0.3, "collective": 0.5}
        for j, (k, v) in enumerate(sorted(dims.items())):
            terms[("compute", "memory", "collective")[j % 3]] *= _factor(k, v)
        gib = 60.0 * np.prod([_factor(k, v) for k, v in sorted(dims.items())
                              if k in ("remat", "microbatches", "embed_rule", "loss_chunk")])
        bound = max(terms.values())
        return {"workload": self.wl, **{f"{t}_s": s for t, s in terms.items()},
                "bound_s": bound, "dominant": max(terms, key=terms.get),
                "fits_hbm": bool(gib <= 74.5), "per_device_gib": float(gib),
                "mfu_at_bound": 0.1 / bound}

    def evaluate(self, arch, shape, point, *, source="explorer", iteration=-1):
        return self.evaluate_batch(arch, shape, [point], source=source,
                                   iteration=iteration)[0]

    def evaluate_batch(self, arch, shape, points, *, source="explorer", iteration=-1,
                       workers=None, gate=None, incumbent_bound=None):
        srcs = [source] * len(points) if isinstance(source, str) else list(source)
        out = []
        for p, s in zip(points, srcs):
            self.compile_count += 1
            m = self.metrics(dict(p.dims))
            out.append(self.DataPoint(
                arch=arch, shape=shape, mesh=self.mesh_name,
                point={**p.to_dict(), "__key__": p.key()},
                status="ok" if m["fits_hbm"] else "infeasible",
                reason="" if m["fits_hbm"] else "over the card's memory",
                metrics=m, source=s, iteration=iteration))
        return out


def _surrogates():
    """The port's and the reference's surrogate on the same weights and
    the same (zero-B) adapters, so the fine-tunes start alike."""
    params = {k: np.asarray(v) for k, v in init_mlp(jax.random.key(0), IN_DIM).items()}
    ad, _ = jlora.init_lora(init_mlp(jax.random.key(0), IN_DIM), jax.random.key(1), 4)
    ours = CostModel.from_numpy(params)
    ours.lora = lora.lora_from_numpy(
        {k: None if v is None else {n: np.asarray(v[n]) for n in ("a", "b")}
         for k, v in ad.items()})
    theirs = JCostModel(in_dim=IN_DIM, params=init_mlp(jax.random.key(0), IN_DIM))
    theirs.lora = ad
    return ours, theirs


def _rows(db):
    """(point key, source, status, iteration) of every row; the LLM's
    rejected proposals carry their dims without a key."""
    return [(PlanPoint(dims={k: v for k, v in d.point.items() if k != "__key__"}).key(),
             d.source, d.status, d.iteration) for d in db.all()]


def _donors():
    """Finished rows of other cells (the transfer strategy's donors)."""
    out = []
    for arch, shape in (("llama3-8b", "prefill_32k"), ("qwen3-8b", "train_4k")):
        cfg, cell = get_config(arch), SHAPE_BY_NAME[shape]
        t = PlanTemplate(cfg, cell, POD)
        stub = StubEvaluator(dict, cfg, cell)
        for i, p in enumerate([baseline_point(cell, t)] + list(t.neighbors(
                baseline_point(cell, t)))[:6]):
            m = stub.metrics(dict(p.dims))
            out.append(dict(arch=arch, shape=shape, mesh="pod16x16",
                            point={**p.to_dict(), "__key__": p.key()}, status="ok",
                            metrics=m, source="search:greedy", iteration=i, ts=float(i)))
    return out


@pytest.mark.parametrize("strategy,donors", [("ensemble", False),
                                             ("transfer", True),
                                             ("ensemble+transfer", True)])
def test_loop_matches_the_reference(strategy, donors, tmp_path):
    arch, shape = "llama3-8b", "train_4k"
    cfg, cell = get_config(arch), SHAPE_BY_NAME[shape]
    db, jdb = CostDB(tmp_path / "port.jsonl"), JCostDB(tmp_path / "ref.jsonl")
    if donors:
        db.append_many([DataPoint(**r) for r in _donors()])
        jdb.append_many([JDataPoint(**r) for r in _donors()])
    stack, jstack = LLMStack(client=MockLLM(), db=db), JLLMStack(client=JMockLLM(), db=jdb)
    cm, jcm = _surrogates()
    beats, jbeats = [], []
    loop = DSELoop(evaluator=StubEvaluator(DataPoint, cfg, cell), db=db, llm_stack=stack,
                   cost_model=cm, strategy=make_strategy(strategy, llm_stack=stack, seed=0))
    jloop = JDSELoop(evaluator=StubEvaluator(JDataPoint, cfg, cell), db=jdb,
                     llm_stack=jstack, cost_model=jcm,
                     strategy=jmake_strategy(strategy, llm_stack=jstack, seed=0))
    rep = loop.run(arch, shape, iterations=5, eval_budget=4, verbose=False,
                   heartbeat=beats.append)
    jrep = jloop.run(arch, shape, iterations=5, eval_budget=4, verbose=False,
                     heartbeat=jbeats.append)
    assert _rows(db) == _rows(jdb)
    assert len(_rows(db)) >= 15
    sources = {d.source for d in db.all()}
    assert "expert" in sources and any(s.startswith("search:") for s in sources)
    assert rep.iterations == jrep.iterations  # sources, allocation (credit), bounds
    assert beats == jbeats and [b["phase"] for b in beats][:3] == \
        ["baseline", "proposed", "evaluated"]
    assert rep.best.point == jrep.best.point and rep.improvement() == jrep.improvement()
    # the surrogate was pretrained, then LoRA-fine-tuned, by the loop's tool
    assert cm.trained and float(cm.lora["w0"]["b"].abs().max()) > 0
    if strategy == "ensemble":
        assert [m.name for m in loop.strategy.members] == ["greedy", "llm", "anneal", "evolve"]


def test_explorer_matches_the_reference(tmp_path):
    from repro.core.design_space import PlanPoint as JPlanPoint
    from repro.core.explorer import Explorer as JExplorer
    from repro_torch.core.explorer import Explorer

    arch, shape = "llama3-8b", "prefill_32k"
    cfg, cell = get_config(arch), SHAPE_BY_NAME[shape]
    db, jdb = CostDB(tmp_path / "port.jsonl"), JCostDB(tmp_path / "ref.jsonl")
    cm, jcm = _surrogates()
    ex = Explorer(StubEvaluator(DataPoint, cfg, cell), db, cost_model=cm, n_random=2)
    jex = JExplorer(StubEvaluator(JDataPoint, cfg, cell), jdb, cost_model=jcm, n_random=2)
    seed = baseline_point(cell, PlanTemplate(cfg, cell, POD))
    extra = [PlanPoint(dims={**seed.dims, "attn_impl": "tri"})]
    for it in range(3):
        out = ex.explore(arch, shape, [seed], budget=4, iteration=it, extra_candidates=extra)
        jout = jex.explore(arch, shape, [JPlanPoint(dims=dict(seed.dims))], budget=4,
                           iteration=it,
                           extra_candidates=[JPlanPoint(dims=dict(p.dims)) for p in extra])
        assert [d.point["__key__"] for d in out] == [d.point["__key__"] for d in jout]
    assert _rows(db) == _rows(jdb) and len(_rows(db)) == 12
    assert {d.source for d in db.all()} == {"llm", "explorer"}


def test_rec_to_datapoint_matches_the_reference():
    cfg, cell = get_config("llama3-8b"), SHAPE_BY_NAME["train_4k"]
    wl = workload_features(cfg, cell)
    rec = {"status": "ok", "roofline": {"compute_s": 0.4, "memory_s": 0.38,
                                        "collective_s": 4.0, "bound_s": 4.0,
                                        "dominant": "collective"},
           "memory": {"fits_hbm": True, "per_device_bytes": 9.93e9},
           "hlo": {"flops": 4.0e14, "wire_bytes_total": 2.0e11, "hbm_bytes": 1.3e12},
           "model_flops_per_dev": 3.3e14, "useful_flops_ratio": 0.83, "compile_s": 1.25}
    base = dict(arch="llama3-8b", shape="train_4k", mesh="pod16x16",
                point={"remat": "full", "__key__": "k"}, source="expert", iteration=0)
    ev, jev = Evaluator(mesh="pod"), JEvaluator(mesh=None, mesh_name="pod16x16")
    assert ev.device is H100_CLUSTER and ev.mesh_name == "pod16x16"
    for fits in (True, False):
        r = {**rec, "memory": {**rec["memory"], "fits_hbm": fits}}
        got, want = ev._rec_to_datapoint(r, wl, dict(base)), \
            jev._rec_to_datapoint(r, wl, dict(base))
        assert got.status == want.status
        mfu = got.metrics.pop("mfu_at_bound")
        assert mfu == pytest.approx(want.metrics.pop("mfu_at_bound")
                                    * TPU_V5E.peak_flops_bf16 / H100_CLUSTER.peak_flops_bf16,
                                    rel=1e-12)
        got.metrics["objectives"].pop("flops_util")
        want.metrics["objectives"].pop("flops_util")
        assert got.metrics == want.metrics
        if not fits:
            assert got.reason == "per-device 9.2 GiB exceeds 75 GiB HBM"
    for r in ({"status": "skipped", "reason": "long"}, {"status": "error", "error": "E"},
              {"status": "worker-failed", "error": "W"}):
        got, want = ev._rec_to_datapoint(r, wl, dict(base)), \
            jev._rec_to_datapoint(r, wl, dict(base))
        assert (got.status, got.reason, got.metrics) == (want.status, want.reason, want.metrics)


# ---------------------------------------------------------------------------
# the port's real Evaluator on a tiny cell
# ---------------------------------------------------------------------------
TINY_CELL = ShapeCell("train_4k", "train", 64, 8)
TINY_DECODE = ShapeCell("decode_32k", "decode", 64, 8)


@pytest.fixture
def tiny(monkeypatch):
    """The reduced qwen3-0.6b under every arch name, a 64-token,
    8-sequence cell under the name train_4k (the reference's test does
    the same) and a decode cell of 8 sequences over a 64-token cache under
    decode_32k; spawned workers get them in their payload."""
    cfg = reduced(get_config("qwen3-0.6b"))
    monkeypatch.setitem(SHAPE_BY_NAME, "train_4k", TINY_CELL)
    monkeypatch.setitem(SHAPE_BY_NAME, "decode_32k", TINY_DECODE)
    for mod in (evaluator_mod, loop_mod, tconfigs):
        monkeypatch.setattr(mod, "get_config", lambda name: cfg)
    return cfg


def _same(a, b):
    """Rows equal apart from the time stamps and the trace seconds."""
    da, db_ = json.loads(a.to_json()), json.loads(b.to_json())
    for d in (da, db_):
        d.pop("ts")
        d["metrics"].pop("compile_s", None)
    return da == db_


def test_loop_end_to_end_on_the_cpu(tiny, tmp_path):
    db = CostDB(tmp_path / "db.jsonl")
    ev = Evaluator(mesh="tiny", torch_device="cpu", artifact_dir=str(tmp_path / "a"),
                   cache=DryRunCache.beside(tmp_path / "db.jsonl"),
                   measured_cache=DryRunCache(tmp_path / "measured_cache"))
    loop = DSELoop(evaluator=ev, db=db, llm_stack=LLMStack(client=MockLLM(), db=db),
                   cost_model=CostModel.create(in_dim=IN_DIM))
    report = loop.run("qwen3-0.6b", "train_4k", iterations=2, eval_budget=2, verbose=False)
    assert report.baseline is not None and report.baseline.status == "ok"
    assert report.best is not None and report.improvement() <= 1.001
    assert len(db.all()) >= 5 and ev.compile_count >= 5
    # the best design measured on the CPU's 1x1 mesh, at the cell's own batch
    head = PlanPoint(dims={k: v for k, v in report.best.point.items() if k != "__key__"})
    dp = ev.measure("qwen3-0.6b", "train_4k", head,
                    modeled_bound_s=report.best.metrics["bound_s"])
    assert dp.status == "ok" and dp.fidelity == "measured" and dp.mesh == "tiny1x1"
    m = dp.metrics
    assert m["backend"] == "cpu" and m["reduced"] == {} and m["peak_bytes"] is None
    assert m["measured_s"] > 0 and m["bound_s_1x1"] > 0
    assert m["bound_s_modeled"] == report.best.metrics["bound_s"]
    # replayed from the measured cache, byte for byte
    again = ev.measure("qwen3-0.6b", "train_4k", head,
                       modeled_bound_s=report.best.metrics["bound_s"])
    assert again.to_json() == dp.to_json() and ev.measured_replayed == 1


def test_pool_equals_serial_and_replays_with_no_dry_run(tiny, tmp_path):
    cfg, cell = tiny, TINY_DECODE
    t = PlanTemplate(cfg, cell, {"data": 2, "model": 4})
    base = baseline_point(cell, t)
    points = [base] + [p for p in t.neighbors(base)][:3]
    serial = Evaluator(mesh="small", torch_device="cpu", artifact_dir=str(tmp_path / "s"))
    pooled = Evaluator(mesh="small", torch_device="cpu", artifact_dir=str(tmp_path / "p"),
                       max_workers=2, cache=DryRunCache(tmp_path / "cache"))
    want = serial.evaluate_batch("qwen3-0.6b", "decode_32k", points)
    got = pooled.evaluate_batch("qwen3-0.6b", "decode_32k", points)
    assert all(d.status == "ok" for d in want)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert pooled.compile_count == len(points)
    replay = pooled.evaluate_batch("qwen3-0.6b", "decode_32k", points)
    assert pooled.compile_count == len(points) and pooled.cache.hits == len(points)
    assert [d.to_json() for d in replay] != [] and all(
        json.loads(a.to_json())["metrics"] == json.loads(b.to_json())["metrics"]
        for a, b in zip(replay, got))


def test_dry_run_is_the_same_before_and_after_a_measurement(tiny, tmp_path):
    ev = Evaluator(mesh="small", torch_device="cpu", artifact_dir=str(tmp_path))
    point = baseline_point(TINY_DECODE, PlanTemplate(tiny, TINY_DECODE, ev.mesh_shape))
    first = ev.evaluate("qwen3-0.6b", "decode_32k", point)
    measured = ev.measure("qwen3-0.6b", "decode_32k", point)  # the 1x1 group
    second = ev.evaluate("qwen3-0.6b", "decode_32k", point)  # the 2x4 group again
    assert first.status == "ok" and measured.status == "ok"
    assert _same(first, second)


def test_measure_cuts_the_batch_to_fit_and_skips_what_never_fits(tiny, tmp_path,
                                                                  monkeypatch):
    ev = Evaluator(mesh="pod", torch_device="cpu", artifact_dir=str(tmp_path),
                   measured_cache=DryRunCache(tmp_path / "mc"), measure_runs=1)
    plan_pt = baseline_point(TINY_CELL, PlanTemplate(tiny, TINY_CELL, ev.mesh_shape))
    fit = measure.one_device_batch("qwen3-0.6b", "train_4k", evaluator_mod.point_to_plan(
        tiny, TINY_CELL, plan_pt), cfg=tiny, cell=TINY_CELL, artifact_dir=tmp_path / "f",
        run_name="probe")
    # the bisection over batches 1, 2, 4, 8 traces 2, 4 and 8
    assert fit["status"] == "ok" and fit["batch"] == 8 and set(fit["traced"]) == {"2", "4", "8"}
    b2, b4 = fit["traced"]["2"], fit["traced"]["4"]
    assert b2 < b4 < fit["traced"]["8"] == fit["per_device_bytes"]
    # a card that holds batch 2 but not 4: the head runs at batch 2
    limit = 1.0001 * b2
    monkeypatch.setattr(measure, "FIT_SHARE", limit / evaluator_mod.H100_SXM.hbm_bytes)
    dp = ev.measure("qwen3-0.6b", "train_4k", plan_pt)
    assert dp.status == "ok" and dp.metrics["reduced"] == {"global_batch": [8, 2]}
    assert dp.metrics["per_device_bytes_1x1"] == b2
    # a card that runs out of memory at the fitted batch (the model reading
    # low): an error row, left uncached, so the next call runs it again
    monkeypatch.setattr(measure, "FIT_SHARE", 1.0)
    real = measure.measure_cell
    batches = []

    def oom(*a, cell, **kw):
        batches.append(cell.global_batch)
        return {"status": "error", "measured_at": 0.0, "n": 1,
                "error": "OutOfMemoryError: CUDA out of memory."}

    monkeypatch.setattr(measure, "measure_cell", oom)
    tri = PlanPoint(dims={**plan_pt.dims, "attn_impl": "tri"})
    dp = ev.measure("qwen3-0.6b", "train_4k", tri)
    assert dp.status == "error" and dp.reason.startswith("OutOfMemoryError")
    assert ev.measure("qwen3-0.6b", "train_4k", tri).status == "error"
    assert batches == [8, 8]
    monkeypatch.setattr(measure, "measure_cell", real)
    # one that cannot hold batch 1 (half of batch 2's bytes, below batch
    # 1's: the params are in both): a rejected row, never run, cached
    monkeypatch.setattr(measure, "FIT_SHARE", 0.5 * b2 / evaluator_mod.H100_SXM.hbm_bytes)
    other = PlanPoint(dims={**plan_pt.dims, "remat": "none"})
    before = measure.N_MEASUREMENTS
    dp = ev.measure("qwen3-0.6b", "train_4k", other)
    assert dp.status == "rejected" and "does not fit one card" in dp.reason
    assert measure.N_MEASUREMENTS == before
    assert ev.measure("qwen3-0.6b", "train_4k", other).to_json() == dp.to_json()


def test_head_dim_plans_dry_run_on_a_sharded_mesh(tmp_path):
    ev = Evaluator(mesh="small", torch_device="cpu", artifact_dir=str(tmp_path))
    cfg, cell = get_config("qwen3-0.6b"), SHAPE_BY_NAME["decode_32k"]
    base = baseline_point(cell, PlanTemplate(cfg, cell, ev.mesh_shape))
    hd = PlanPoint(dims={**base.dims, "attn_rule": "head_dim"})
    a, b = ev.evaluate_batch("qwen3-0.6b", "decode_32k", [base, hd])
    assert a.status == b.status == "ok", b.reason
    assert b.metrics["flops_per_dev"] == pytest.approx(a.metrics["flops_per_dev"], rel=0.05)


def test_topk_train_plans_dry_run_on_a_sharded_mesh(tiny, tmp_path):
    """A gradient sharded twice on one dim (ZeRO-1 over data, TP over
    model) is gathered for the top-k codec: DTensor would otherwise walk
    its every element to flatten it (the full-width dry run never ended)."""
    ev = Evaluator(mesh="small", torch_device="cpu", artifact_dir=str(tmp_path))
    base = baseline_point(TINY_CELL, PlanTemplate(tiny, TINY_CELL, ev.mesh_shape))
    pts = [PlanPoint(dims={**base.dims, "grad_compress": c}) for c in ("none", "topk")]
    none, topk = ev.evaluate_batch("qwen3-0.6b", "train_4k", pts)
    assert none.status == topk.status == "ok", topk.reason
    # the gather shows as wire bytes beside the uncompressed plan's
    assert topk.metrics["wire_bytes"] > none.metrics["wire_bytes"]


def test_zero3_plans_dry_run_when_kv_heads_do_not_fill_the_model_axis(tmp_path,
                                                                       monkeypatch):
    """``embed_rule=data`` with fewer KV heads than the model axis (qwen3-0.6b's
    8 on the pod's 16; here 2 on 4): the ZeRO-3 weight is gathered before its
    product, or DTensor shards the (heads, head_dim) pair where the heads
    cannot take it back."""
    cfg = reduced(get_config("qwen3-0.6b"), n_kv_heads=2)
    monkeypatch.setitem(SHAPE_BY_NAME, "train_4k", TINY_CELL)
    monkeypatch.setattr(evaluator_mod, "get_config", lambda name: cfg)
    ev = Evaluator(mesh="small", torch_device="cpu", artifact_dir=str(tmp_path))
    base = baseline_point(TINY_CELL, PlanTemplate(cfg, TINY_CELL, ev.mesh_shape))
    z3 = PlanPoint(dims={**base.dims, "embed_rule": "data"})
    a, b = ev.evaluate_batch("qwen3-0.6b", "train_4k", [base, z3])
    assert a.status == b.status == "ok", b.reason
    assert b.metrics["wire_bytes"] > a.metrics["wire_bytes"]  # the weights' gathers


@pytest.mark.parametrize("dims", [(2, 3, 4, 8, 16), (1, 1, 2, 4, 6)])
def test_head_dim_projections_compute_the_einsums(dims, monkeypatch):
    b, s, h, k, d = dims
    gen = torch.Generator().manual_seed(0)
    x, wq = torch.randn(b, s, d, generator=gen), torch.randn(d, h, k, generator=gen)
    o, wo = torch.randn(b, s, h, k, generator=gen), torch.randn(h, k, d, generator=gen)
    want_in, want_out = layers._project_in(x, wq), layers._project_out(o, wo)
    # the head_dim-sharded branches, on plain tensors
    monkeypatch.setattr(layers, "gathered", lambda w, dim: w)
    monkeypatch.setattr(layers, "_sharded_on", lambda w, dim: True)
    torch.testing.assert_close(layers._project_in(x, wq), want_in, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(layers._project_out(o, wo), want_out, rtol=1e-5, atol=1e-5)


def test_mcp_registry_contract():
    reg = Registry()

    @reg.register("echo", "echo tool", {"type": "object",
                                        "properties": {"x": {"type": "string"}},
                                        "required": ["x"]})
    def _echo(x):
        return {"x": x}

    assert reg.list_tools()[0]["name"] == "echo"
    assert reg.list_tools()[0]["inputSchema"]["required"] == ["x"]
    assert reg.call("echo", x="hi") == {"x": "hi"}
    with pytest.raises(TypeError):
        reg.call("echo")
    with pytest.raises(KeyError):
        reg.call("nope")
    assert reg.log and reg.log[-1]["tool"] == "echo"


def test_mcp_tools_drive_the_real_evaluator(tiny, tmp_path):
    from repro_torch.core.mcp import build_registry

    db = CostDB(tmp_path / "db.jsonl")
    ev = Evaluator(mesh="tiny", torch_device="cpu", artifact_dir=str(tmp_path))
    reg = build_registry(evaluator=ev, db=db, llm_stack=LLMStack(client=MockLLM(), db=db))
    assert [t["name"] for t in reg.list_tools()] == [
        "simulate", "query_cost_db", "best_design", "propose", "finetune_cost_model"]
    base = baseline_point(TINY_CELL, PlanTemplate(tiny, TINY_CELL, ev.mesh_shape))
    dp = reg.call("simulate", arch="qwen3-0.6b", shape="train_4k", point=dict(base.dims))
    assert dp.status == "ok" and db.best("qwen3-0.6b", "train_4k").to_json() == dp.to_json()
    assert reg.call("query_cost_db", arch="qwen3-0.6b") == db.all()
    out = reg.call("propose", arch="qwen3-0.6b", shape="train_4k", point=dict(base.dims),
                   metrics=dp.metrics)
    assert out["proposals"] and "FINAL ANSWER" in out["transcript"]
    assert dataclasses.is_dataclass(out["proposals"][0])
