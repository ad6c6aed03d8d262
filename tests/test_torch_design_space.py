"""repro_torch kernel design space against the reference: registry, pools,
defaults, KernelTemplate's pinned messages, neighbour order and random
draws, the Hopper resource model, and byte-compatible CostDB rows."""
import dataclasses
import json
import random

import pytest

from repro.core import design_space as jds
from repro.core import kernel_space as jks
from repro.core.cost_db import DataPoint as JDataPoint
from repro_torch.core import kernel_space as ks
from repro_torch.core.cost_db import CostDB, DataPoint
from repro_torch.core.design_space import (KernelPoint, KernelTemplate,
                                           baseline_kernel_point)
from repro_torch.core.device import H100_SXM
from repro_torch.kernels import flash_attention, rmsnorm


def test_registry_copies_the_reference():
    assert [dataclasses.astuple(s) for s in ks.CI_KERNEL_SHAPES] == \
        [dataclasses.astuple(s) for s in jks.KERNEL_SHAPES]
    assert ks.KERNEL_NAMES == jks.KERNEL_NAMES
    for s in ks.CI_KERNEL_SHAPES:
        js = jks.KERNEL_SHAPE_BY_NAME[s.name]
        assert ks.legal_kernel_dims(s) == jks.legal_kernel_dims(js)
        assert ks.default_kernel_dims(s) == jks.default_kernel_dims(js)
        assert ks.kernel_workload(s) == jks.kernel_workload(js)
    assert ks.kernel_arch("vecmul") == jks.kernel_arch("vecmul")
    assert ks.parse_kernel_arch("kernel:rmsnorm") == "rmsnorm"


def test_full_width_shapes_are_llama3_8b():
    attn = ks.KERNEL_SHAPE_BY_NAME["attn_llama3_8b_s4096_bf16"]
    assert attn.params == {"b": 1, "sq": 4096, "sk": 4096, "h": 32, "kh": 8, "d": 128}
    assert ks.KERNEL_SHAPE_BY_NAME["rms_llama3_8b_8kx4096_bf16"].params == \
        {"rows": 8192, "d": 4096}
    assert ks.KERNEL_SHAPE_BY_NAME["vec_16m_f32"].params == {"L": 16_777_216}


def test_validate_messages_are_pinned():
    kshape = ks.KERNEL_SHAPE_BY_NAME["rms_512x512_f32"]
    template = KernelTemplate(kshape)
    ok, why = template.validate(KernelPoint(dims={"block_rows": 32, "bogus": 1}))
    assert (ok, why) == (False, "unknown dimension bogus")
    legal = template.dims()
    ok, why = template.validate(KernelPoint(dims={"block_rows": 999}))
    assert (ok, why) == (
        False, f"block_rows=999 outside device-aware range {legal['block_rows']}")
    # the same messages as the reference's template
    jt = jds.KernelTemplate(jks.KERNEL_SHAPE_BY_NAME["rms_512x512_f32"])
    assert jt.validate(KernelPoint(dims={"block_rows": 999}))[1] == why
    # the shared-memory bound: same pools, starved device
    starved = dataclasses.replace(H100_SXM, smem_per_block=64)
    base = baseline_kernel_point(kshape)
    ok, why = KernelTemplate(kshape, starved).validate(base)
    res = ks.kernel_resources(kshape, base.dims, starved)
    assert not ok and why == (f"shared memory {res.vmem_bytes} B per block "
                              f"exceeds 64 B limit")


def _whole_pool_feasible(shape) -> bool:
    js = jks.KERNEL_SHAPE_BY_NAME[shape.name]
    for dims in ks.tile_grid(shape):
        if not (ks.kernel_resources(shape, dims).feasible
                and jks.kernel_resources(js, dims).feasible):
            return False
    return True


@pytest.mark.parametrize("shape", ks.CI_KERNEL_SHAPES, ids=lambda s: s.name)
def test_neighbors_and_random_points_match_the_reference(shape):
    ours = KernelTemplate(shape)
    theirs = jds.KernelTemplate(jks.KERNEL_SHAPE_BY_NAME[shape.name])
    points = [KernelPoint(dims=dims) for dims in ks.tile_grid(shape)]
    if not _whole_pool_feasible(shape):
        # closure still holds: whatever the template yields validates
        for p in points:
            assert all(ours.validate(n)[0] for n in ours.neighbors(p))
        assert all(ours.validate(p)[0]
                   for p in ours.random_points(random.Random(0), 20))
        return
    for p in points:
        assert [n.dims for n in ours.neighbors(p)] == \
            [n.dims for n in theirs.neighbors(p)]
    assert [p.dims for p in ours.random_points(random.Random(3), 25)] == \
        [p.dims for p in theirs.random_points(random.Random(3), 25)]
    assert baseline_kernel_point(shape, ours).dims == \
        jds.baseline_kernel_point(jks.KERNEL_SHAPE_BY_NAME[shape.name], theirs).dims


def test_some_ci_shapes_share_the_whole_pool():
    assert sum(_whole_pool_feasible(s) for s in ks.CI_KERNEL_SHAPES) >= 4


def test_default_attention_tile_is_repaired_to_fit_shared_memory():
    shape = ks.KERNEL_SHAPE_BY_NAME["attn_llama3_8b_s4096_bf16"]
    template = KernelTemplate(shape)
    p = baseline_kernel_point(shape, template)
    assert template.validate(p) == (True, "")
    res = ks.kernel_resources(shape, p.dims)
    assert res.route == "wgmma"  # bf16 at d=128
    assert res.vmem_bytes == flash_attention.smem_bytes_wgmma(
        p.dims["block_q"], p.dims["block_k"], 128) <= H100_SXM.smem_per_block
    # the shipped (512, 512) fits as it is (passes of 128 rows, sub-tiles of
    # 128 keys), so the repair keeps it, as the reference's does
    assert p.dims == {"block_q": 512, "block_k": 512, "causal": True}
    assert res.vmem_bytes == flash_attention.smem_bytes_wgmma(128, 128, 128)


def test_resource_model_uses_the_launch_smem_and_prefers_filling_the_card():
    shape = ks.KERNEL_SHAPE_BY_NAME["rms_llama3_8b_8kx4096_bf16"]
    est = {br: ks.kernel_resources(shape, {"block_rows": br}) for br in (32, 64, 128, 256)}
    assert all(r.vmem_bytes == rmsnorm.smem_bytes(4096) for r in est.values())
    assert all(r.feasible and r.vpu_aligned for r in est.values())
    # 256-row tiles leave 100 of 132 SMs idle
    assert est[32].est_latency_us < est[256].est_latency_us
    # never below the bytes over the memory rate
    assert est[32].est_latency_us * 1e-6 >= 2 * 8192 * 4096 * 2 / H100_SXM.hbm_bw


def test_cost_db_rows_are_byte_compatible(tmp_path):
    dp = DataPoint(arch="kernel:vecmul", shape="vec_64k_f32", mesh="dev1",
                   point={"block": 256, "__key__": "abc"}, status="ok",
                   metrics={"bound_s": 1e-6, "est_latency_us": 1.0,
                            "vmem_util": 0.0, "mxu_aligned": True,
                            "vpu_aligned": True}, source="expert",
                   iteration=0, ts=123.5)
    line = dp.to_json()
    assert JDataPoint.from_json(line).to_json() == line
    assert DataPoint.from_json(line).to_json() == line
    db = CostDB(tmp_path / "db.jsonl")
    db.append(dp)
    assert (tmp_path / "db.jsonl").read_text() == line + "\n"
    assert json.loads(line)["fidelity"] == "dryrun"
    assert db.best("kernel:vecmul", "vec_64k_f32").to_json() == line
