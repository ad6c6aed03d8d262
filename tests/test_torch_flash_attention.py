"""repro_torch flash attention: the plain tile walk against the Pallas kernel
(interpret mode) over the full legal grid of the CI shapes, plus sq != sk
with q_offset (kernel against kernel, never against the bottom-right
aligned oracle)."""
import numpy as np
import pytest
import torch
from torch_parity import draw, grid_cases, max_err

from repro.kernels import ops as jops
from repro_torch.core.kernel_space import KERNEL_SHAPE_BY_NAME
from repro_torch.kernels import ops
from repro_torch.kernels.conformance import tolerance
from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                 k_tiles_walked, smem_bytes)

SHAPES = [KERNEL_SHAPE_BY_NAME["attn_s128_f32"],
          KERNEL_SHAPE_BY_NAME["attn_s256_gqa_bf16"]]


def _qkv(rng, b, sq, sk, h, kh, d, dtype):
    return (draw(rng, b, sq, h, d, dtype=dtype), draw(rng, b, sk, kh, d, dtype=dtype),
            draw(rng, b, sk, kh, d, dtype=dtype))


@pytest.mark.parametrize("shape,dims", grid_cases(SHAPES))
def test_flash_plain_matches_pallas(shape, dims):
    p = shape.params
    rng = np.random.default_rng(5)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, p["b"], p["sq"], p["sk"], p["h"],
                                        p["kh"], p["d"], shape.dtype)
    kw = dict(causal=dims["causal"], block_q=dims["block_q"], block_k=dims["block_k"])
    want = jops.flash_attention(qj, kj, vj, interpret=True, **kw)
    got = flash_attention_plain(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert max_err(got, want) <= tolerance("flash_attention", shape.dtype)


@pytest.mark.parametrize("sq,sk,q_offset,causal", [
    (64, 128, 64, True),    # decode-style tail of the sequence
    (64, 128, 0, True),     # top-left alignment: the causal skip stops early
    (128, 64, 0, True),
    (64, 128, -32, True),   # rows with no visible key average V (-1e30 mask)
    (64, 128, 0, False),
])
def test_flash_plain_matches_pallas_with_q_offset(sq, sk, q_offset, causal):
    rng = np.random.default_rng(9)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, sq, sk, 4, 2, 32, "float32")
    kw = dict(causal=causal, block_q=32, block_k=32, q_offset=q_offset)
    want = jops.flash_attention(qj, kj, vj, interpret=True, **kw)
    got = ops.flash_attention(qt, kt, vt, **kw)
    assert max_err(got, want) <= tolerance("flash_attention", "float32")


def test_fully_masked_rows_average_v_and_stay_finite():
    rng = np.random.default_rng(2)
    (_, qt), (_, kt), (_, vt) = _qkv(rng, 1, 32, 32, 2, 1, 16, "float32")
    out = flash_attention_plain(qt, kt, vt, causal=True, block_q=16, block_k=16,
                                q_offset=-64)
    assert torch.isfinite(out).all()
    want = vt.mean(dim=1, keepdim=True).expand(1, 32, 1, 16)
    torch.testing.assert_close(out[:, :, 0], want[:, :, 0], rtol=0, atol=1e-6)


def test_causal_skip_counts_only_visible_tiles():
    assert [k_tiles_walked(qt, 64, 64, 256, causal=True, q_offset=0)
            for qt in range(4)] == [1, 2, 3, 4]
    assert k_tiles_walked(0, 64, 64, 256, causal=False, q_offset=0) == 4
    assert k_tiles_walked(0, 64, 64, 256, causal=True, q_offset=-1) == 4
    assert k_tiles_walked(0, 64, 64, 256, causal=True, q_offset=192) == 4


def test_flash_smem_formula():
    # (64, 64) tiles at d=128 in bf16 fit two blocks on one SM
    assert smem_bytes(64, 64, 128, 2) == 115_456
    assert 2 * (115_456 + 1024) <= 233_472


def test_blocks_must_divide_the_sequence():
    q = torch.zeros(1, 96, 2, 16)
    with pytest.raises(ValueError, match="divide"):
        flash_attention_plain(q, q, q, block_q=64, block_k=64)
