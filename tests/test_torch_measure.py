"""The measured tier for plan cells on the CPU: ``measure_cell`` runs a
reduced cell's step on the one-device mesh and returns the reference's
record keys (the reference measured on the same reduced cell), with
``measured_s`` the min of ``times_s``; a train cell's step is a whole one
that feeds its state back; a mesh of more than one device is refused as
an error record; the CLI parses; the card-vs-CPU train check runs (here
on the CPU on both sides)."""
import contextlib
import dataclasses

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


@pytest.mark.parametrize("arch,dtype", [("mamba2-780m", "bfloat16"), ("mixtral-8x7b", "float32")])
def test_train_check_takes_the_other_families(arch, dtype):
    """The train check on a reduced mamba2 in bf16 (its ``conv_b`` starts at
    zero, so its new params are the step's update alone: they are held
    against the CPU's AdamW on the bf16 side's own gradient, whose signs a
    gradient within rounding of zero cannot flip) and a reduced mixtral in
    f32 (the MoE dispatch's backward)."""
    cfg = reduced(get_config(arch), dtype=dtype)
    chk = measure.check_train_against_cpu(cfg, n_layers=2, tokens=64, device="cpu")
    assert chk["ok"] and chk["finite"], chk["worst"]
    assert set(chk["leaves"]["param"]) == set(chk["leaves"]["grad"])
    if dtype == "float32":
        assert chk["worst"]["grad"][1] < 1e-5 and chk["loss"] < 1e-6
        assert chk["worst"]["param"][1] < 1e-4
    else:
        assert chk["leaves"]["param"]["blocks.conv_b"] < 1e-3


@pytest.mark.parametrize("fault", ["lr", "bias_correction"])
def test_train_check_catches_a_wrong_optimizer_step(fault, monkeypatch):
    """A fault in the bf16 side's AdamW only: twice the peak learning rate,
    or the bias correction taken at step 2 (each update about 0.73 of its
    size). The gradients and moments still agree; the new params' updates
    read 1 (lr) or 0.27 of their size and fail the check, except the norm
    weights', which bf16 cannot move from 1.0 by one step of lr (0 either
    way)."""
    from repro_torch.train import optimizer as opt_mod

    real = opt_mod.adamw_update

    def faulty(c, params, grads, opt_state):
        if any(p.dtype == torch.bfloat16 for p in params.values()):
            if fault == "lr":
                c = dataclasses.replace(c, lr=2 * c.lr)
            else:
                opt_state["step"] += 1
        return real(c, params, grads, opt_state)

    monkeypatch.setattr(opt_mod, "adamw_update", faulty)
    cfg = reduced(get_config("qwen3-0.6b"), dtype="bfloat16")
    chk = measure.check_train_against_cpu(cfg, n_layers=2, tokens=64, device="cpu")
    assert not chk["ok"] and chk["loss"] < measure.MODEL_REL
    for part in ("grad", "m", "v"):
        assert chk["worst"][part][1] < measure.TRAIN_LEAF_REL
    want = 1.0 if fault == "lr" else 0.273
    for leaf, err in chk["leaves"]["param"].items():
        norm = leaf.endswith(("norm", "ln1", "ln2", "ln_f"))
        assert err == (0.0 if norm else pytest.approx(want, rel=0.05)), leaf


def _device_runs(monkeypatch, fault):
    """Plant ``fault`` (a context manager) in ``check_against_cpu``'s first
    two runs of the model, the device's, which come before the CPU's."""
    real, calls = measure._serve_run, []

    def serve(*a, **k):
        calls.append(1)
        with fault() if len(calls) <= 2 else contextlib.nullcontext():
            return real(*a, **k)

    monkeypatch.setattr(measure, "_serve_run", serve)


def test_model_check_runs_on_the_cpu():
    """mamba2-780m at full width, 2 layers, a short prompt, with the
    "device" on the CPU too: its f32 run is the CPU's, its bf16 run within
    ``MODEL_REL``, so the CPU's own bf16 gap is not run."""
    chk = measure.check_against_cpu("mamba2-780m", n_layers=2, tokens=32, steps=2, device="cpu")
    assert chk["ok"] and chk["finite"] and chk["dtype"] == "bfloat16"
    assert chk["f32"]["worst"] == 0 and len(chk["f32"]["logits"]) == 3
    assert 0 < chk["bf16"]["worst"] < measure.MODEL_REL and "gap" not in chk
    assert chk["limit"] == {"f32": measure.F32_REL, "bf16": measure.MODEL_REL}
    assert {"ssm", "conv"} <= {k.split(".")[-1] for k in chk["f32"]["cache"]}


def test_model_check_catches_a_fault_of_the_device_runs(monkeypatch):
    """The SSD's skip term ``D`` dropped in the device's runs only: both the
    f32 and the bf16 run read far past their limits; the bf16 reading past
    ``MODEL_REL`` brings in the CPU's own bf16 gap, which is the sound one
    and sets the limit."""
    from repro_torch.models import mamba2

    core = mamba2._core

    @contextlib.contextmanager
    def no_skip():
        with monkeypatch.context() as m:
            m.setattr(mamba2, "_core", lambda *a, **k: core(*a[:4], torch.zeros_like(a[4]),
                                                            *a[5:], **k))
            yield

    _device_runs(monkeypatch, no_skip)
    chk = measure.check_against_cpu("mamba2-780m", n_layers=2, tokens=32, steps=2, device="cpu")
    assert not chk["ok"]
    assert chk["f32"]["worst"] > 100 * measure.F32_REL
    assert chk["bf16"]["worst"] > 3 * chk["limit"]["bf16"]
    assert 0 < chk["gap"]["worst"] < measure.MODEL_REL
    assert chk["limit"]["bf16"] == max(measure.MODEL_REL,
                                       measure.BF16_GAP_FACTOR * chk["gap"]["worst"])


@pytest.mark.parametrize("fits,want", [(0, None), (1, 1), (3, 4), (5, 16), (6, 32)])
def test_largest_fitting_bisects_the_candidates(fits, want):
    """The largest candidate whose bytes fit, from the first ``fits`` of
    six batches, each traced at most once."""
    cands = [1, 2, 4, 8, 16, 32]
    traced = []

    def nbytes(b):
        traced.append(b)
        return float(b)

    best, bad = measure._largest_fitting(cands, nbytes, limit=cands[fits - 1] if fits else 0.5)
    assert (best, bad) == (want, None)
    assert len(traced) == len(set(traced)) <= 3


def test_largest_fitting_returns_a_failed_dry_run():
    rec = {"status": "error", "error": "boom"}
    assert measure._largest_fitting([1, 2, 4], lambda b: rec if b == 2 else 1.0, 10.0) \
        == (None, rec)
