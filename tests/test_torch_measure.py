"""The measured tier for plan cells on the CPU: ``measure_cell`` runs a
reduced cell's step on the one-device mesh and returns the reference's
record keys (the reference measured on the same reduced cell), with
``measured_s`` the min of ``times_s``; a train cell's step is a whole one
that feeds its state back; a mesh of more than one device is refused as
an error record; the CLI parses; the card-vs-CPU train check runs (here
on the CPU on both sides)."""
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.launch.measure import measure_cell as jmeasure_cell
from repro.launch.mesh import make_mesh as jmake_mesh
from repro_torch.configs import SHAPE_BY_NAME, get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import measure
from repro_torch.launch.campaign import make_campaign_mesh


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_measure_cell_on_the_cpu(shape):
    mesh, name = make_campaign_mesh("tiny", "cpu")
    cfg = reduced(get_config("llama3-8b"))
    base = SHAPE_BY_NAME[shape]
    before = measure.N_MEASUREMENTS
    cell = ShapeCell(base.name, base.kind, 128, 2)
    rec = measure.measure_cell("llama3-8b", shape, mesh, name, cfg=cfg, cell=cell, runs=3)
    assert rec["status"] == "ok", rec.get("error")
    ref = jmeasure_cell("llama3-8b", shape, jmake_mesh((1, 1), ("data", "model")), name,
                        cfg=jreduced(jget("llama3-8b")), cell=cell, runs=1)
    assert ref["status"] == "ok" and set(ref) <= set(rec)
    assert rec["measured_s"] == min(rec["times_s"]) and len(rec["times_s"]) == 3
    assert rec["backend"] == "cpu" and rec["peak_bytes"] is None
    assert rec["mesh"] == name == "tiny1x1" and rec["fidelity"] == "measured"
    assert measure.N_MEASUREMENTS == before + 1


def test_measure_cell_refuses_a_sharded_mesh_and_skips_long_context():
    mesh, name = make_campaign_mesh("small")
    rec = measure.measure_cell("llama3-8b", "decode_32k", mesh, name)
    assert rec["status"] == "error" and "one device" in rec["error"]
    mesh, name = make_campaign_mesh("tiny", "cpu")
    assert measure.measure_cell("llama3-8b", "long_500k", mesh, name)["status"] == "skipped"
    with pytest.raises(ValueError, match="runs must be"):
        measure.measure_cell("llama3-8b", "decode_32k", mesh, name, runs=0)


def test_cli_parses_and_defaults_to_the_card():
    args = measure.build_parser().parse_args(["--arch", "llama3-8b", "--shape", "decode_32k"])
    assert (args.device, args.mesh, args.runs, args.batch) == \
        ("cuda", "tiny", measure.DEFAULT_RUNS, None)
    assert measure.build_parser().parse_args(
        ["--arch", "llama3-8b", "--shape", "prefill_32k", "--batch", "1"]).batch == 1
    with pytest.raises(SystemExit):
        measure.build_parser().parse_args(["--arch", "x", "--shape", "y", "--device", "tpu"])


def test_train_step_repeats_on_its_own_state():
    """The measured train call updates its zero state in place: repeated
    calls keep the shapes and the step counter advances."""
    import dataclasses

    from repro_torch.sharding.plan import baseline_plan

    mesh, _ = make_campaign_mesh("tiny", "cpu")
    cfg = reduced(get_config("qwen3-0.6b"))
    cell = ShapeCell("train_4k", "train", 128, 2)
    plan = dataclasses.replace(baseline_plan(cfg, cell), opt_int8=True)
    call, _ = measure.zero_step("qwen3-0.6b", "train_4k", mesh, plan, cfg=cfg, cell=cell)
    args = next(c.cell_contents for c in call.__closure__ if isinstance(c.cell_contents, dict))
    for _ in range(3):
        call()
    assert int(args["state"]["opt"]["step"]) == 3
    assert args["state"]["opt"]["m"]["embed"]["q"].dtype == torch.int8


def test_train_check_against_the_cpu_runs_on_the_cpu():
    """The check's two sides on the CPU: the reduced model in bf16 against f32."""
    cfg = reduced(get_config("qwen3-0.6b"), dtype="bfloat16")
    chk = measure.check_train_against_cpu(cfg, n_layers=2, tokens=64, device="cpu")
    assert chk["ok"] and chk["finite"] and chk["limit"] == measure.MODEL_REL
    assert chk["loss"] < measure.MODEL_REL and chk["grad_norm"] < measure.MODEL_REL
    assert set(chk["leaves"]) == {"grad", "m", "v", "param"}
    for part, errs in chk["leaves"].items():
        assert set(errs) == set(chk["leaves"]["grad"])
        assert max(errs.values()) == chk["worst"][part][1] < measure.TRAIN_LEAF_REL


def test_train_check_catches_a_wrong_attention_gradient(monkeypatch):
    """A fault in the bf16 side's attention backward (the score product's
    gradient to q dropped) fails the check: the leaves that reach the
    scores through q alone read 1, while the loss, which the fault leaves
    alone, passes."""
    from repro_torch.models import layers as TL

    backward = TL._ProductF32.backward

    def faulty(ctx, g):
        ga, gb, n = backward(ctx, g)
        return (torch.zeros_like(ga) if ga is not None and ga.dtype == torch.bfloat16
                else ga), gb, n

    monkeypatch.setattr(TL._ProductF32, "backward", staticmethod(faulty))
    cfg = reduced(get_config("qwen3-0.6b"), dtype="bfloat16")
    chk = measure.check_train_against_cpu(cfg, n_layers=2, tokens=64, device="cpu")
    assert not chk["ok"] and chk["loss"] < measure.MODEL_REL
    for leaf in ("blocks.attn.wq", "blocks.attn.q_norm"):
        assert chk["leaves"]["grad"][leaf] == pytest.approx(1.0)
    assert chk["worst"]["grad"][1] == pytest.approx(1.0)
