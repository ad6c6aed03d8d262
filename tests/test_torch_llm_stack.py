"""The LLM stack of repro_torch against the reference's: the CoT scaffold's
proposals and trace, MockLLM's transcripts, ``LLMStack.propose`` (valid
points, rejected rows, transcripts) from the same DB rows, the rows a
garbage client and a template-violating client leave, and RAG retrieval
over the same rows all agree exactly (byte for byte where they are text).
The §4 design keeps the reference's keys and parameters; the code index
reads this package's own sources."""
import json
from pathlib import Path

import numpy as np
import pytest

from repro.configs import SHAPE_BY_NAME as JSHAPES
from repro.configs import get_config as jget
from repro.core import cot as jcot
from repro.core.cost_db import CostDB as JCostDB
from repro.core.cost_db import DataPoint as JDataPoint
from repro.core.design_space import PlanPoint as JPlanPoint
from repro.core.design_space import PlanTemplate as JPlanTemplate
from repro.core.design_space import baseline_point as jbaseline
from repro.core.llm_client import MockLLM as JMockLLM
from repro.core.llm_stack import LLMStack as JLLMStack
from repro.core.rag import DesignRetriever as JRetriever
from repro_torch.configs import SHAPE_BY_NAME, get_config
from repro_torch.core import cot
from repro_torch.core.cost_db import CostDB, DataPoint, workload_features
from repro_torch.core.design_space import PlanPoint, PlanTemplate, baseline_point
from repro_torch.core.llm_client import MockLLM, parse_json_answer
from repro_torch.core.llm_stack import LLMStack
from repro_torch.core.rag import CodeIndex, DesignRetriever, summarize_datapoint

REPO = Path(__file__).resolve().parents[1]
MESHES = {"pod": {"data": 16, "model": 16}, "small": {"data": 2, "model": 4}}
CELLS = [("llama3-8b", "train_4k"), ("llama3-8b", "decode_32k"),
         ("qwen3-0.6b", "prefill_32k"), ("mixtral-8x7b", "train_4k")]


def _cell(arch, shape, mesh="pod"):
    cfg, cell = get_config(arch), SHAPE_BY_NAME[shape]
    t = PlanTemplate(cfg, cell, MESHES[mesh])
    jt = JPlanTemplate(jget(arch), JSHAPES[shape], MESHES[mesh])
    return cfg, cell, t, jt


def _metrics(rng, fits=True, dominant=None):
    terms = {f"{t}_s": float(10 ** rng.uniform(-3, 0)) for t in
             ("compute", "memory", "collective")}
    dom = dominant or max(("compute", "memory", "collective"), key=lambda t: terms[f"{t}_s"])
    return {**terms, "bound_s": max(terms.values()), "dominant": dom, "fits_hbm": fits,
            "per_device_gib": float(rng.uniform(1, 90)),
            "mfu_at_bound": float(rng.uniform(0, 0.6))}


def _rows(n, seed=0):
    """Plan rows over a few cells, some infeasible and some rejected."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        arch, shape = CELLS[i % len(CELLS)]
        cfg, cell, t, _ = _cell(arch, shape)
        pt = t.random_points(__import__("random").Random(seed * 1000 + i), 1)[0]
        status = ["ok", "ok", "infeasible", "rejected"][i % 4]
        m = _metrics(rng, fits=status != "infeasible") if status != "rejected" else {}
        out.append(dict(arch=arch, shape=shape, mesh="pod16x16",
                        point={**pt.to_dict(), "__key__": pt.key()}, status=status,
                        metrics={**m, "workload": workload_features(cfg, cell)},
                        reason="" if status == "ok" else f"negative {i}",
                        source="search:greedy", iteration=i, ts=float(i)))
    return out


def _dbs(tmp_path, rows):
    db, jdb = CostDB(tmp_path / "port.jsonl"), JCostDB(tmp_path / "ref.jsonl")
    db.append_many([DataPoint(**r) for r in rows])
    jdb.append_many([JDataPoint(**r) for r in rows])
    return db, jdb


def _nots(row_json):
    d = json.loads(row_json)
    d.pop("ts")
    return d


GRID = [(arch, shape, dom, fits, tmpl)
        for arch, shape in CELLS
        for dom in ("compute", "memory", "collective")
        for fits in (True, False)
        for tmpl in (True, False)]


@pytest.mark.parametrize("arch,shape,dom,fits,tmpl", GRID)
def test_cot_and_mock_transcripts_are_byte_identical(arch, shape, dom, fits, tmpl):
    cfg, cell, t, jt = _cell(arch, shape)
    rng = np.random.default_rng(len(arch) + len(shape))
    point = dict(t.random_points(__import__("random").Random(3), 1)[0].dims)
    metrics = _metrics(rng, fits=fits, dominant=dom)
    wl = workload_features(cfg, cell)
    dims = {k: tuple(v) for k, v in t.dims().items()} if tmpl else None
    props, trace = cot.cot_propose(point, metrics, wl, k=4, template_dims=dims)
    jprops, jtrace = jcot.cot_propose(point, metrics, wl, k=4, template_dims=dims)
    assert props == jprops and trace.render() == jtrace.render()
    task = {"kind": "propose_plans", "point": point, "metrics": metrics, "workload": wl,
            "mesh_model": 16, "k": 4,
            **({"template": {k: list(v) for k, v in t.dims().items()}} if tmpl else {})}
    prompt = "<TASK>" + json.dumps(task, default=str) + "</TASK>"
    assert MockLLM().complete(prompt) == JMockLLM().complete(prompt)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_stack_proposes_what_the_reference_proposes(arch, shape, tmp_path):
    cfg, cell, t, jt = _cell(arch, shape)
    db, jdb = _dbs(tmp_path, _rows(24))
    stack, jstack = LLMStack(client=MockLLM(), db=db), JLLMStack(client=JMockLLM(), db=jdb)
    rng = np.random.default_rng(7)
    for fits in (True, False):
        metrics = _metrics(rng, fits=fits)
        base, jbase = baseline_point(cell, t), jbaseline(JSHAPES[shape], jt)
        assert base.dims == jbase.dims
        valid, rej, raw = stack.propose(arch, shape, cfg, cell, t, base, metrics, k=3)
        jvalid, jrej, jraw = jstack.propose(arch, shape, jget(arch), JSHAPES[shape], jt,
                                            jbase, metrics, k=3)
        assert raw == jraw
        assert [p.dims for p in valid] == [p.dims for p in jvalid]
        assert [p.key() for p in valid] == [p.key() for p in jvalid]
        assert [_nots(d.to_json()) for d in rej] == [_nots(d.to_json()) for d in jrej]
        # the prompts carry the same retrieved context
        assert stack.client.calls[-1] == jstack.client.calls[-1]


class _Garbage:
    name = "garbage"

    def complete(self, prompt, *, system=""):
        return "I cannot help with that."


class _Illegal:
    name = "illegal"

    def complete(self, prompt, *, system=""):
        return ('```json\n{"proposals": [{"remat": "sometimes"}, {"microbatches": 3}, '
                '{"attn_rule": "head_dim"}]}\n```')


@pytest.mark.parametrize("client", [_Garbage, _Illegal])
def test_garbage_and_template_violations_give_the_reference_rows(client):
    cfg, cell, t, jt = _cell("llama3-8b", "train_4k")
    metrics = _metrics(np.random.default_rng(0))
    base = baseline_point(cell, t)
    valid, rej, raw = LLMStack(client=client()).propose(
        "llama3-8b", "train_4k", cfg, cell, t, base, metrics)
    jvalid, jrej, jraw = JLLMStack(client=client()).propose(
        "llama3-8b", "train_4k", jget("llama3-8b"), JSHAPES["train_4k"], jt,
        JPlanPoint(dims=dict(base.dims)), metrics)
    assert raw == jraw and [p.dims for p in valid] == [p.dims for p in jvalid]
    assert rej and [_nots(d.to_json()) for d in rej] == [_nots(d.to_json()) for d in jrej]
    assert all(d.status == "rejected" and d.source == f"llm:{client.name}" for d in rej)


@pytest.mark.parametrize("arch", [None, "llama3-8b", "qwen3-0.6b"])
def test_design_retriever_retrieves_the_reference_rows(arch, tmp_path):
    db, jdb = _dbs(tmp_path, _rows(40, seed=3))
    cfg, cell, t, _ = _cell("llama3-8b", "decode_32k")
    point = dict(baseline_point(cell, t).dims)
    wl = workload_features(cfg, cell)
    got = DesignRetriever(db).retrieve(point, wl, k=6, arch=arch)
    want = JRetriever(jdb).retrieve(point, wl, k=6, arch=arch)
    assert [d.point["__key__"] for d in got] == [d.point["__key__"] for d in want]
    from repro.core.rag import summarize_datapoint as jsummarize

    assert [summarize_datapoint(d) for d in got] == [jsummarize(d) for d in want]


def test_vecmul_design_keeps_the_reference_keys():
    spec = ("The accelerator should be able to take two input vectors: X and Y "
            "... perform an element-wise multiplication ... loading should be "
            "performed using a load module ... written back to main memory "
            "using a store module")
    design, raw = LLMStack(client=MockLLM()).generate_accelerator(spec, length=2048)
    jdesign, _ = JLLMStack(client=JMockLLM()).generate_accelerator(spec, length=2048)
    assert set(design) == set(jdesign) and design["kernel"] == "vecmul"
    assert design["parameters"] == jdesign["parameters"] == {"L": 2048, "block": 1024}
    assert design["interfaces"] == jdesign["interfaces"]
    assert set(design["modules"]) == set(jdesign["modules"])
    assert design["modules"]["load"] and design["modules"]["store"]
    assert "vecmul.cu" in raw and "VMEM" not in raw and "BlockSpec" not in raw
    assert parse_json_answer(raw) == design


def test_code_index_reads_the_port_sources():
    root = REPO / "src" / "repro_torch"
    idx = CodeIndex(roots=[root]).build()
    files = {tag.split(":")[0] for tag, _ in idx.chunks}
    assert "llm_stack.py" in files and "vecmul.py" in files
    assert len(files) == len({p.name for p in root.rglob("*.py")})
    hits = idx.retrieve("vecmul block threads CUDA kernel", k=3)
    assert len(hits) == 3


def test_vecmul_demo_runs_on_the_cpu(tmp_path):
    from repro_torch.examples import dse_vecmul
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = dse_vecmul.run("cpu", db_path=tmp_path / "db.jsonl", verbose=False)
    assert out["design"]["parameters"] == {"L": 4096, "block": 1024}
    assert out["device"] == "cpu" and out["max_abs_err"] == 0.0
    assert not any(ops.launch_counts().values())  # the plain version, on the CPU
    assert [r["status"] for r in out["sweep"]] == ["ok"] * 4 + ["infeasible"] * 2
    assert out["rows"] == len(CostDB(tmp_path / "db.jsonl").all()) == 6
    assert out["best_block"] == 128 and out["resources"]["threads"] == 256
