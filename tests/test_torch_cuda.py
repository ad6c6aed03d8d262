"""repro_torch kernels on the card: each CUDA kernel against its plain
version over the full legal grid of the CI shapes and a few odd shapes
(row by row, within ``conformance.PLAIN_REL``), the SSD scan also with an
initial state at every chunk, the oracle gate, launch counting, refused
launches, and one DSE cell with measured rows on cuda. The kernels have no
CPU mode, so these tests skip where torch sees no card; on a machine with
an H100 and nvcc run them from the repo root with
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
shared conftest imports jax, which that machine need not have; this file
imports none of it)."""
import pytest
import torch

from repro_torch.core.cost_db import CostDB
from repro_torch.core.kernel_space import (CI_KERNEL_SHAPES, KernelShape,
                                           kernel_resources, tile_grid)
from repro_torch.kernels import conformance, ops
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain
from repro_torch.launch import dse

SHAPES = list(CI_KERNEL_SHAPES) + [
    KernelShape("rms_odd_173x96_f32", "rmsnorm", {"rows": 173, "d": 96}, "float32"),
    KernelShape("vec_odd_5000_bf16", "vecmul", {"L": 5000}, "bfloat16"),
    KernelShape("ssd_odd_b2_s96_f32", "ssd_scan",
                {"b": 2, "s": 96, "nh": 3, "dh": 24, "N": 40}, "float32")]


def _grid():
    return [pytest.param(shape, dims, id=shape.name + "-" + ",".join(
        f"{k}={v}" for k, v in dims.items())) for shape in SHAPES
        for dims in tile_grid(shape)]


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    # the plain versions' matmuls in full f32, as the kernels compute
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dims", _grid())
def test_kernel_matches_plain_on_the_card(shape, dims, card):
    inputs = conformance.make_inputs(shape, device=card)
    if not kernel_resources(shape, dims).feasible:
        with pytest.raises(RuntimeError, match="CUDA error"):
            conformance.run_candidate(shape, dims, inputs)
        return
    before = ops.launch_counts()[shape.kernel]
    got = conformance.run_candidate(shape, dims, inputs)
    torch.cuda.synchronize()
    assert ops.launch_counts()[shape.kernel] == before + 1
    out = got[0] if isinstance(got, tuple) else got
    assert out.is_cuda and out.dtype == inputs[0].dtype
    agree = conformance.agree_with_plain(
        got, conformance.run_plain(shape, dims, inputs))
    assert agree["passed"], agree
    assert conformance.check_candidate(shape, dims, inputs=inputs)["passed"]


@pytest.mark.cuda
def test_dse_cell_measures_on_cuda(card, tmp_path):
    db = tmp_path / "db.jsonl"
    ops.reset_launch_counts()
    rep = dse.main(["--arch", "flash_attention", "--shape", "attn_s256_gqa_bf16",
                    "--iterations", "2", "--budget", "3", "--measure-top-k", "2",
                    "--db", str(db)])
    assert ops.launch_counts()["flash_attention"] > 0
    assert rep["best"] is not None
    measured = [d for d in CostDB(db).all() if d.fidelity == "measured"]
    assert measured and all(d.status == "ok" and d.metrics["backend"] == "cuda"
                            for d in measured)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_threads_an_initial_state(chunk, dtype, card):
    shape = KernelShape("ssd_s512", "ssd_scan",
                        {"b": 2, "s": 512, "nh": 4, "dh": 32, "N": 48}, dtype)
    x, dt, A, B, C = conformance.make_inputs(shape, device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    s0 = 0.3 * torch.randn(2, 4, 32, 48, generator=gen, device=card)
    for init in (None, s0):
        got = ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, initial_state=init)
        torch.cuda.synchronize()
        want = ssd_scan_plain(x, dt, A, B, C, chunk=chunk, initial_state=init)
        agree = conformance.agree_with_plain(got, want)
        assert agree["passed"], (init is None, agree)
