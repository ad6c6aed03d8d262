"""``python -m repro_torch.launch.dse --space plans`` on the CPU: one plan
cell end to end (the expert baseline, the default ensemble's members with
their ``search:`` tags, the LLM member's valid proposals counted), a rerun
from an empty DB beside the same caches that replays every dry run and
measurement, the measured tier on the CPU when asked, the human gate, the
parser's defaults and refusals, and ``cuda`` without a card raising."""
import builtins

import pytest
import torch

import repro_torch.configs as tconfigs
from repro_torch.configs import SHAPE_BY_NAME, get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.core import evaluator as evaluator_mod
from repro_torch.core import loop as loop_mod
from repro_torch.core.cost_db import CostDB
from repro_torch.launch import dse

ACCEPTANCE = ["--space", "plans", "--arch", "qwen3-0.6b", "--shape", "decode_32k",
              "--mesh", "small", "--iterations", "2", "--budget", "4", "--workers", "2",
              "--device", "cpu"]


@pytest.fixture
def tiny(monkeypatch):
    """The reduced qwen3-0.6b on a decode_32k cell of 8 sequences over a
    64-token cache."""
    cfg = reduced(get_config("qwen3-0.6b"))
    monkeypatch.setitem(SHAPE_BY_NAME, "decode_32k", ShapeCell("decode_32k", "decode", 64, 8))
    for mod in (evaluator_mod, loop_mod, tconfigs):
        monkeypatch.setattr(mod, "get_config", lambda name: cfg)
    return cfg


def test_cli_runs_a_plan_cell_and_replays_it(tmp_path, capsys):
    db_path = tmp_path / "dse" / "cost_db.jsonl"
    rep = dse.main(ACCEPTANCE + ["--db", str(db_path), "--report", str(tmp_path / "r.json")])
    rows = CostDB(db_path).all()
    sources = {d.source for d in rows}
    assert "expert" in sources and {"search:greedy", "search:anneal"} <= sources
    assert rep["baseline"]["status"] == "ok" and rep["best"]["status"] == "ok"
    assert rep["llm"]["valid"] >= 1 and rep["compiles"] >= 5
    assert len(rep["iterations"]) == 2 and rep["mesh"] == "small2x4"
    assert all(it["allocation"] and set(it["allocation"]) == {"greedy", "llm", "anneal", "evolve"}
               for it in rep["iterations"])
    assert rep["rows_by_source"]["expert"] == 1 and "error" not in rep["rows_by_status"]
    out = capsys.readouterr().out
    assert f"llm member (mock): {rep['llm']['valid']} valid proposals" in out
    assert (tmp_path / "r.json").exists()
    # the same command from an empty DB beside the same caches: every
    # evaluation replays
    db_path.unlink()
    again = dse.main(ACCEPTANCE + ["--db", str(db_path)])
    assert again["compiles"] == 0 and "dry runs: 0 traced" in capsys.readouterr().out
    def same(it):
        return {k: v for k, v in it.items() if k not in ("compiled", "cache_hits")}

    assert [same(it) for it in again["iterations"]] == [same(it) for it in rep["iterations"]]
    assert sum(it["cache_hits"] for it in again["iterations"]) == \
        sum(it["compiled"] for it in rep["iterations"])
    assert again["best"]["point"] == rep["best"]["point"]


def test_cli_measures_the_heads_on_the_cpu(tiny, tmp_path, capsys):
    db_path = tmp_path / "cost_db.jsonl"
    argv = ["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh", "small",
            "--iterations", "2", "--budget", "3", "--gate-factor", "3.0",
            "--measure-top-k", "2", "--device", "cpu", "--db", str(db_path)]
    rep = dse.main(argv)
    assert len(rep["measured"]) == 2 and rep["gate"]["pruned"] >= 0
    for m in rep["measured"]:
        assert m["status"] == "ok" and m["backend"] == "cpu" and m["reduced"] == {}
        assert m["share_of_1x1_bound"] > 0 and m["bound_s"] > 0
    measured = [d for d in CostDB(db_path).all() if d.fidelity == "measured"]
    assert len(measured) == 2 and all(d.mesh == "small2x4" for d in measured)
    assert rep["finetunes"] and rep["finetunes"][0]["status"] == "pretrained"
    assert "measured tier: 2 timed" in capsys.readouterr().out
    db_path.unlink()
    dse.main(argv)
    assert "measured tier: 0 timed, 2 replayed" in capsys.readouterr().out


def test_human_gate_vetoes_accepted_designs(tiny, tmp_path, monkeypatch):
    monkeypatch.setattr(builtins, "input", lambda prompt: "n")
    db_path = tmp_path / "cost_db.jsonl"
    dse.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh", "small",
              "--iterations", "1", "--budget", "2", "--strategy", "llm", "--approve",
              "--device", "cpu", "--db", str(db_path)])
    rows = [d for d in CostDB(db_path).all() if d.iteration == 1]
    assert rows and all(d.status == "rejected" and d.reason == "human-in-the-loop veto"
                        for d in rows)
    assert all(d.source == "search:llm" for d in rows)


def test_parser_defaults_and_refusals(tmp_path):
    ap = dse.build_parser()
    assert (ap.get_default("space"), ap.get_default("mesh"), ap.get_default("llm"),
            ap.get_default("strategy"), ap.get_default("device")) == \
        ("plans", "pod", "mock", "ensemble", "cuda")
    db = ["--db", str(tmp_path / "db.jsonl"), "--device", "cpu"]
    for argv in (["--arch", "vecmul", "--shape", "decode_32k"],
                 ["--arch", "llama3-8b", "--shape", "vec_64k_f32"],
                 ["--space", "kernels", "--arch", "vecmul", "--shape", "vec_64k_f32",
                  "--strategy", "llm"],
                 ["--arch", "llama3-8b", "--shape", "decode_32k", "--mesh", "tiny"],
                 ["--arch", "llama3-8b", "--shape", "decode_32k", "--llm", "gpt"]):
        with pytest.raises(SystemExit) as e:
            dse.main(argv + db)
        assert e.value.code == 2
    assert not (tmp_path / "db.jsonl").exists()


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dse.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh", "small",
                  "--db", str(tmp_path / "db.jsonl")])
    assert not (tmp_path / "db.jsonl").exists()
