"""The port's dry-run tier against the reference's: MODEL_FLOPS, the
record's keys, per-device argument bytes (exact) and FLOPs (within 10%)
of qwen3-0.6b's serve and train cells on the 2x4 mesh (train: FLOPs
less the reference's extra attention forward within 1%, temp bytes at
most the reference's), the collective
kinds, the trip-count weighting against a fully unrolled trace (train
cells: ``tests/test_torch_train_trace.py``), and the production-mesh
records of llama3-8b and of mixtral-8x7b's decode cells (the other
families: ``tests/test_torch_dryrun_families.py``).

The reference runs in a subprocess with 8 forced host devices; the port's
mesh is a fake process group in this process."""
import json

import pytest
import torch

from conftest import run_subprocess
from torch_dryrun_parity import REFERENCE_F32_WIRE, TRAIN_TEMP_FACTOR, WIRE_FACTOR
from repro.configs import ARCH_NAMES, SHAPES
from repro.configs import get_config as jget
from repro.launch.dryrun import model_flops as jmodel_flops
from repro_torch.configs import SHAPE_BY_NAME, get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.core.step_analysis import StepCounter
from repro_torch.launch import dryrun
from repro_torch.launch.campaign import make_campaign_mesh
from repro_torch.models import layers as TL
from repro_torch.sharding.plan import baseline_plan

CELLS = ("decode_32k", "prefill_32k", "train_4k")

#: collective kinds by cell: equal for decode; for prefill the port runs
#: Megatron-SP's reduce-scatter where XLA:CPU leaves an all-reduce, and
#: keeps attention head-local where GSPMD reshards it to the sequence
#: (all-to-all) and moves the last token by collective-permute (PERF.md)
PREFILL_PORT_ONLY = {"reduce-scatter"}
PREFILL_REFERENCE_ONLY = {"all-to-all", "collective-permute"}
#: train: the port reduce-scatters (Megatron-SP's row-parallel sums, and
#: each gradient into its ZeRO-1 moments' shards) where XLA:CPU all-reduces,
#: and never reshards attention to the sequence (GSPMD's all-to-all)
TRAIN_PORT_ONLY = {"reduce-scatter"}
TRAIN_REFERENCE_ONLY = {"all-to-all"}

#: train FLOPs against the reference's less one attention forward a layer,
#: which its kv-block checkpoint nested in the q-chunk checkpoint
#: recomputes and the port's does not (``_extra_attention_forward``)
TRAIN_FLOPS_REL = 0.01


def _extra_attention_forward(arch: str, shape: str, data: int, model: int) -> float:
    """FLOPs per device of one forward of the reference's chunked attention
    (q·kᵀ and p·v over the whole [S, S], heads split over ``model``, the
    batch over ``data``) in every layer."""
    cfg, cell = get_config(arch), SHAPE_BY_NAME[shape]
    b, s = cell.global_batch // data, cell.seq_len
    return 2 * 2 * b * s * s * (cfg.n_heads // model) * cfg.head_dim() * cfg.n_layers


@pytest.fixture(scope="module")
def reference_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref")
    stdout = run_subprocess(f"""
        import json, pathlib
        from repro.launch.dryrun import run_cell
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((2, 4), ("data", "model"))
        recs = {{s: run_cell("qwen3-0.6b", s, mesh, "small2x4",
                             artifact_dir=pathlib.Path(r"{out}")) for s in {CELLS!r}}}
        print("REFS" + json.dumps(recs))
    """, n_devices=8, timeout=600)
    line = next(ln for ln in stdout.splitlines() if ln.startswith("REFS"))
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    mesh, name = make_campaign_mesh("small")
    out = tmp_path_factory.mktemp("port")
    return {s: dryrun.run_cell("qwen3-0.6b", s, mesh, name, artifact_dir=out) for s in CELLS}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_match(arch):
    for cell in SHAPES:
        assert dryrun.model_flops(get_config(arch), SHAPE_BY_NAME[cell.name]) == \
            jmodel_flops(jget(arch), cell)


@pytest.mark.parametrize("shape", CELLS)
def test_small_mesh_record_matches_the_reference(shape, reference_records, port_records):
    ref, rec = reference_records[shape], port_records[shape]
    assert ref["status"] == rec["status"] == "ok", rec.get("error")
    assert set(ref) <= set(rec)
    assert set(ref["memory"]) <= set(rec["memory"])
    assert set(ref["hlo"]) <= set(rec["hlo"])
    assert set(ref["roofline"]) <= set(rec["roofline"])
    assert rec["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    if shape == "train_4k":
        want = ref["hlo"]["flops"] - _extra_attention_forward("qwen3-0.6b", shape, 2, 4)
        assert rec["hlo"]["flops"] == pytest.approx(want, rel=TRAIN_FLOPS_REL)
    else:  # serve: the same products
        assert rec["hlo"]["flops"] == ref["hlo"]["flops"]
    assert rec["model_flops"] == ref["model_flops"]
    assert rec["n_devices"] == ref["n_devices"] == 8
    port_kinds, ref_kinds = set(rec["hlo"]["collect_bytes"]), set(ref["hlo"]["collect_bytes"])
    if shape == "decode_32k":
        assert port_kinds == ref_kinds
    elif shape == "prefill_32k":
        assert port_kinds - ref_kinds == PREFILL_PORT_ONLY
        assert ref_kinds - port_kinds == PREFILL_REFERENCE_ONLY
    else:
        assert port_kinds - ref_kinds == TRAIN_PORT_ONLY
        assert ref_kinds - port_kinds == TRAIN_REFERENCE_ONLY
        # the donated train state
        assert rec["memory"]["alias_bytes"] == ref["memory"]["alias_bytes"]
        temp = rec["memory"]["temp_bytes"] / ref["memory"]["temp_bytes"]
        assert temp <= TRAIN_TEMP_FACTOR, temp
    wire = rec["hlo"]["wire_bytes_total"] / ref["hlo"]["wire_bytes_total"]
    if shape == "train_4k":
        wire /= REFERENCE_F32_WIRE
    assert 1 / WIRE_FACTOR <= wire <= WIRE_FACTOR, wire
    m = rec["memory"]
    assert m["per_device_bytes"] == (m["argument_bytes"] + m["temp_bytes"]
                                     + m["output_bytes"] - m["alias_bytes"])
    # the port/reference ratios PERF.md quotes (pytest -s prints them)
    ratios = {f"wire {k}": rec["hlo"]["wire_bytes"][k] / ref["hlo"]["wire_bytes"][k]
              for k in sorted(port_kinds & ref_kinds)}
    for key in ("wire_bytes_total", "hbm_bytes", "flops"):
        ratios[key] = rec["hlo"][key] / ref["hlo"][key]
    for key in ("temp_bytes", "output_bytes", "alias_bytes", "per_device_bytes"):
        ratios[key] = rec["memory"][key] / ref["memory"][key]
    print(f"{shape} port/reference: " + ", ".join(f"{k} {v:.4g}" for k, v in ratios.items())
          + f"; port only {sorted(port_kinds - ref_kinds)}, reference only "
          f"{sorted(ref_kinds - port_kinds)}")


def _counts(counter):
    r = counter.result()
    return (r["flops"], r["hbm_bytes"], r["collect_bytes"], r["wire_bytes"])


@pytest.mark.parametrize("shape,decode_attn", [("prefill_32k", "gspmd"),
                                               ("decode_32k", "gspmd"),
                                               ("decode_32k", "sp_shardmap")])
def test_weighted_trace_equals_an_unrolled_one(shape, decode_attn):
    import dataclasses

    mesh, _ = make_campaign_mesh("small")
    cfg = reduced(get_config("qwen3-0.6b"), n_layers=3)
    base = SHAPE_BY_NAME[shape]
    cell = ShapeCell(base.name, base.kind, 2048, 4)  # four q chunks of 512
    plan = dataclasses.replace(baseline_plan(cfg, cell), decode_attn=decode_attn)
    weighted, _ = dryrun.trace_cell("qwen3-0.6b", shape, mesh, plan, cfg=cfg, cell=cell)
    unrolled, _ = dryrun.trace_cell("qwen3-0.6b", shape, mesh, plan, cfg=cfg, cell=cell,
                                    unroll=True)
    for w, u in zip(_counts(weighted), _counts(unrolled)):
        assert w == pytest.approx(u, rel=1e-12)
    assert weighted.result()["dot_flops_once"] < unrolled.result()["dot_flops_once"]


def test_affine_walk_of_the_triangular_attention_is_exact():
    def run(unroll):
        counter = StepCounter(unroll=unroll)
        with counter:
            q, k, v = (torch.empty(2, 2048, h, 64) for h in (8, 2, 2))
            TL.chunked_attention_tri(q, k, v, chunk=256, walk=counter.walk)
        return counter

    w, u = run(False), run(True)
    assert w.result()["flops"] == pytest.approx(u.result()["flops"], rel=1e-12)
    assert w.result()["hbm_bytes"] == pytest.approx(u.result()["hbm_bytes"], rel=1e-12)
    # 8 chunks: the pairs (i, ki <= i), 36 of 64 blocks
    assert u.result()["flops"] == 4 * 2 * 8 * 256 * 256 * 64 * 36


def test_production_mesh_records(tmp_path):
    mesh, name = make_campaign_mesh("pod")
    keys = None
    for shape in ("decode_32k", "prefill_32k"):
        rec = dryrun.run_cell("llama3-8b", shape, mesh, name, artifact_dir=tmp_path)
        assert rec["status"] == "ok", rec.get("error")
        assert rec["n_devices"] == 256 and rec["memory"]["fits_hbm"]
        assert rec["hlo"]["flops"] > rec["hlo"]["dot_flops_once"] > 0
        assert rec["roofline"]["bound_s"] > 0
        # a 16-card model group spans two 8-card nodes: the NIC carries it
        assert rec["hlo"]["wire_bytes_by_link"]["nic"] == rec["hlo"]["wire_bytes_total"] > 0
        keys = keys or set(rec)
        assert set(rec) == keys
        saved = json.loads((tmp_path / f"llama3-8b__{shape}__pod16x16.json").read_text())
        assert saved["status"] == "ok"
    rec = dryrun.run_cell("llama3-8b", "train_4k", mesh, name, artifact_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    assert set(rec) == keys and rec["n_devices"] == 256
    assert rec["hlo"]["flops"] > rec["hlo"]["dot_flops_once"] > 0
    assert rec["memory"]["alias_bytes"] > 0 and rec["roofline"]["bound_s"] > 0
    # the other families run too (tests/test_torch_dryrun_families.py):
    # mixtral's decode, and its 524k-token decode over the 4096-token window
    for arch, shape in [("mixtral-8x7b", "decode_32k"), ("mixtral-8x7b", "long_500k")]:
        rec = dryrun.run_cell(arch, shape, mesh, name, artifact_dir=tmp_path)
        assert rec["status"] == "ok", rec.get("error")
        assert set(rec) == keys and rec["hlo"]["flops"] > 0
    assert dryrun.run_cell("llama3-8b", "long_500k", mesh, name,
                           artifact_dir=tmp_path)["status"] == "skipped"
