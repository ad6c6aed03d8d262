"""The measured tier for plan cells on the CPU: ``measure_cell`` runs a
reduced cell's step on the one-device mesh and returns the reference's
record keys (the reference measured on the same reduced cell), with
``measured_s`` the min of ``times_s``; a mesh of more than one device is
refused as an error record; the CLI parses."""
import pytest

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.launch.measure import measure_cell as jmeasure_cell
from repro.launch.mesh import make_mesh as jmake_mesh
from repro_torch.configs import SHAPE_BY_NAME, get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import measure
from repro_torch.launch.campaign import make_campaign_mesh


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
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
