"""repro_torch vecmul: the plain version against the Pallas kernel (interpret
mode) over the full legal tile grid, and the CPU dispatch of ops.vecmul."""
import numpy as np
import pytest
import torch
from torch_parity import draw, grid_cases, max_err

from repro.kernels import ops as jops
from repro_torch.core.kernel_space import KERNEL_SHAPE_BY_NAME, KernelShape
from repro_torch.kernels import ops
from repro_torch.kernels.conformance import tolerance
from repro_torch.kernels.vecmul import vecmul_plain

SHAPES = [KERNEL_SHAPE_BY_NAME["vec_64k_f32"],
          KernelShape("vec_odd_5000_bf16", "vecmul", {"L": 5000}, "bfloat16")]


@pytest.mark.parametrize("shape,dims", grid_cases(SHAPES))
def test_vecmul_plain_matches_pallas(shape, dims):
    rng = np.random.default_rng(7)
    L = shape.params["L"]
    xj, xt = draw(rng, L, dtype=shape.dtype)
    yj, yt = draw(rng, L, dtype=shape.dtype)
    want = jops.vecmul(xj, yj, block=dims["block"], interpret=True)
    got = vecmul_plain(xt, yt, block=dims["block"])
    assert got.dtype == xt.dtype and got.shape == xt.shape
    # the same f32 product rounded once to the same type: exact
    assert max_err(got, want) <= tolerance("vecmul", shape.dtype)
    assert max_err(got, want) == 0.0


def test_ops_vecmul_on_cpu_runs_the_plain_version_and_counts_nothing():
    ops.reset_launch_counts()
    x = torch.arange(10, dtype=torch.float32)
    out = ops.vecmul(x, x, block=256)
    assert torch.equal(out, x * x)
    assert ops.launch_counts() == {"vecmul": 0, "rmsnorm": 0, "flash_attention": 0,
                                   "ssd_scan": 0}


def test_vecmul_cuda_refuses_cpu_tensors():
    from repro_torch.kernels.vecmul import vecmul_cuda

    x = torch.ones(8)
    with pytest.raises(ValueError, match="CUDA"):
        vecmul_cuda(x, x, block=256)
