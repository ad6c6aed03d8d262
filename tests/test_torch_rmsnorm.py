"""repro_torch rmsnorm: the plain version against the Pallas kernel
(interpret mode) over the full legal tile grid, odd row count included."""
import numpy as np
import pytest
import torch
from torch_parity import draw, grid_cases, max_err

from repro.kernels import ops as jops
from repro_torch.core.kernel_space import KERNEL_SHAPE_BY_NAME, KernelShape
from repro_torch.kernels import ops
from repro_torch.kernels.conformance import tolerance
from repro_torch.kernels.rmsnorm import (MAX_REGISTER_ROW_BYTES, path,
                                         rmsnorm_plain, smem_bytes,
                                         vectors_per_lane)

SHAPES = [KERNEL_SHAPE_BY_NAME["rms_512x512_f32"],
          KERNEL_SHAPE_BY_NAME["rms_1kx256_bf16"],
          KernelShape("rms_odd_173x96_f32", "rmsnorm", {"rows": 173, "d": 96},
                      "float32")]


@pytest.mark.parametrize("shape,dims", grid_cases(SHAPES))
def test_rmsnorm_plain_matches_pallas(shape, dims):
    rng = np.random.default_rng(11)
    rows, d = shape.params["rows"], shape.params["d"]
    xj, xt = draw(rng, rows, d, dtype=shape.dtype)
    wj, wt = draw(rng, d, dtype=shape.dtype)
    want = jops.rmsnorm(xj, wj, block_rows=dims["block_rows"], interpret=True)
    got = rmsnorm_plain(xt, wt, block_rows=dims["block_rows"])
    assert got.dtype == xt.dtype and got.shape == xt.shape
    assert max_err(got, want) <= tolerance("rmsnorm", shape.dtype)


def test_ops_rmsnorm_flattens_leading_dims_like_the_reference():
    rng = np.random.default_rng(3)
    xj, xt = draw(rng, 2, 3, 64)
    wj, wt = draw(rng, 64)
    want = jops.rmsnorm(xj, wj, block_rows=4, interpret=True)
    got = ops.rmsnorm(xt, wt, block_rows=4)
    assert got.shape == (2, 3, 64)
    assert max_err(got, want) <= tolerance("rmsnorm", "float32")


def test_rmsnorm_smem_is_w_in_f32():
    # one warp per row and no block reduction: only w stays in shared memory
    assert smem_bytes(4096) == 4 * 4096


@pytest.mark.parametrize("d,itemsize,want,nv", [
    (4096, 2, "registers", 16),  # llama3-8b rows: 8 KB, 16 vectors a lane
    (96, 4, "registers", 1),     # 24 vectors: lanes 24..31 masked
    (4000, 2, "registers", 16),  # 500 vectors: 16 a lane, the last masked
    (1536, 2, "registers", 8),
    (6144, 2, "two-pass", 32),   # 12 KB rows: second read from L2
    (100, 2, "scalar", 1),       # 200 B rows are not whole 16-byte vectors
])
def test_rmsnorm_path_rule(d, itemsize, want, nv):
    assert path(d, itemsize) == want
    assert path(d, itemsize, aligned=False) == "scalar"
    if want == "registers":
        assert vectors_per_lane(d, itemsize) == nv
        assert nv * 32 * 16 >= d * itemsize
        assert d * itemsize <= MAX_REGISTER_ROW_BYTES


def test_rmsnorm_cuda_refuses_cpu_tensors():
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(torch.ones(4, 8), torch.ones(8))
