"""repro_torch flash attention: the plain tile walk against the Pallas kernel
(interpret mode) over the full legal grid of the CI shapes, plus sq != sk
with q_offset (kernel against kernel, never against the bottom-right
aligned oracle); the mma route's split-TF32 arithmetic, emulated in plain
torch, against the plain version; routes, shared memory and the resource
model's feasible tiles."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import draw, grid_cases, max_err, tf32, tf32_product, tf32_truncate

from repro.kernels import ops as jops
from repro_torch.core.design_space import KernelPoint, KernelTemplate
from repro_torch.core.kernel_space import (KERNEL_SHAPE_BY_NAME, KernelShape,
                                           kernel_resources, tile_grid)
from repro_torch.kernels import ops
from repro_torch.kernels.conformance import PLAIN_REL, agree_with_plain, tolerance
from repro_torch.kernels.flash_attention import (MMA_D, NEG_INF, SOURCES,
                                                 WGMMA_BLOCKS, WGMMA_D,
                                                 flash_attention_plain,
                                                 k_tiles_walked, mma_head_dim,
                                                 mma_sub_keys, mma_threads, route,
                                                 smem_bytes_fma, smem_bytes_mma,
                                                 smem_bytes_wgmma)

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


def test_flash_wgmma_smem_formula():
    # the bf16 q tile, two K and two V stages, five mbarriers, 1024 B slack:
    # (64, 64) at d=128 fits two blocks on one SM, (128, 128) one
    assert smem_bytes_wgmma(64, 64, 128) == 1024 + 2 * 128 * (64 + 4 * 64) + 40 == 82_984
    assert 2 * (82_984 + 1024) <= 233_472
    assert smem_bytes_wgmma(128, 128, 128) == 164_904 <= 232_448


def test_route_is_decided_by_dtype_head_dim_and_tile():
    bf16 = torch.bfloat16
    for bq in WGMMA_BLOCKS:
        for bk in WGMMA_BLOCKS:
            assert route(bf16, 128, bq, bk) == route(bf16, 64, bq, bk) == "wgmma"
    assert route(bf16, 96, 64, 64) == "mma"  # no wgmma instantiation at d=96
    assert route(bf16, 64, 64, 256) == route(bf16, 64, 256, 64) == "mma"
    assert route(bf16, 128, 32, 64) == route(bf16, 128, 1, 64) == "mma"  # short q
    # f32 goes to mma.sync with each operand split into two TF32 parts
    # (three products a product): one TF32 product would break PLAIN_REL
    # (test_one_tf32_product_would_not_hold_f32_to_its_plain_version)
    assert route(torch.float32, 128, 64, 64) == "mma"
    # what the mma kernel cannot take goes to the FMA kernel: d above 128,
    # or two K/V stages past a block's shared memory where one still fits
    assert route(bf16, 160, 64, 64) == route(torch.float32, 256, 1, 1) == "fma"
    assert smem_bytes_mma(64, 256, 64, 4) > 232_448 >= smem_bytes_fma(64, 256, 64, 4)
    assert route(torch.float32, 64, 64, 256) == "fma"
    assert route(torch.float32, 64, 64, 128) == route(bf16, 64, 64, 256) == "mma"


def test_wgmma_dispatch_instantiates_exactly_the_routed_tiles():
    src = (Path(__file__).resolve().parents[1] / SOURCES["wgmma"]).read_text()
    cases = {tuple(map(int, m)) for m in
             re.findall(r"^\s*FLASH_WGMMA_CASE\((\d+), (\d+), (\d+)\)", src, re.M)}
    assert cases == {(d, bq, bk) for d in WGMMA_D for bq in WGMMA_BLOCKS
                     for bk in WGMMA_BLOCKS}


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_p_moves_the_plain_version_by_at_most_one_bf16_unit(causal):
    # the same bf16 inputs with P.V in f32 (the mma route's arithmetic:
    # P in two TF32 parts, V exact; f32 inputs hold the bf16 values
    # exactly) against P rounded to bf16
    # (the wgmma route's), both outputs in bf16: each element moves by at
    # most one bf16 unit in the last place of its row's largest value
    rng = np.random.default_rng(4)
    (_, qt), (_, kt), (_, vt) = _qkv(rng, 1, 256, 256, 4, 2, 64, "bfloat16")
    kw = dict(causal=causal, block_q=64, block_k=64)
    p16 = flash_attention_plain(qt, kt, vt, **kw).float()
    p32 = flash_attention_plain(qt.float(), kt.float(), vt.float(),
                                **kw).to(torch.bfloat16).float()
    row_max = torch.maximum(p16.abs(), p32.abs()).amax(dim=-1, keepdim=True)
    unit = torch.exp2(torch.floor(torch.log2(row_max)) - 7)
    assert ((p16 - p32).abs() <= unit).all()
    assert not torch.equal(p16, p32)  # the rounding of P does show


#: the mma route's feasible full-width tiles: its shared memory holds two K
#: and V stages of block_k rows in bf16, so every block_k up to 128 at
#: d=128 and up to 256 at d=64 fits, at any block_q (above 128 rows in
#: passes of 128). Every tile the FMA kernel took here is among them (none
#: at d=128; (64, 256) and (256, 64) at d=64).
MMA_FULL_WIDTH = {
    128: {(256, 64), (256, 128), (512, 64), (512, 128)},
    64: {(64, 256), (128, 256), (256, 64), (256, 128), (256, 256), (512, 64),
         (512, 128), (512, 256)},
}


@pytest.mark.parametrize("d,fma_feasible", [
    (128, set()),  # larger block_k go to the FMA kernel, whose f32 tiles
    (64, set()),   # do not fit at these widths either
])
def test_full_width_tiles_feasible_on_each_route(d, fma_feasible):
    shape = KernelShape("attn", "flash_attention",
                        {"b": 1, "sq": 4096, "sk": 4096, "h": 32, "kh": 8, "d": d},
                        "bfloat16")
    wgmma = {(bq, bk) for bq in WGMMA_BLOCKS for bk in WGMMA_BLOCKS}
    feasible = {"wgmma": set(), "mma": set(), "fma": set()}
    for dims in tile_grid(shape):
        res = kernel_resources(shape, dims)
        bq, bk = dims["block_q"], dims["block_k"]
        # the wgmma route takes exactly the tiles it is instantiated for,
        # and each fits; every other tile goes to the mma kernel where its
        # K/V stages fit one block's shared memory (its modelled registers
        # fit 256 threads at every d up to 128), else to the FMA kernel
        mma_smem = smem_bytes_mma(bq, bk, d, 2)
        assert res.route == ("wgmma" if (bq, bk) in wgmma
                             else "mma" if mma_smem <= 232_448 else "fma")
        if res.route == "wgmma":
            assert res.threads == 128 * bq // 64 + 32 and res.regs_per_thread > 0
            assert res.vmem_bytes == smem_bytes_wgmma(bq, bk, d)
        elif res.route == "mma":
            assert res.threads == mma_threads(bq) == 32 * min(bq // 16, 8)
            assert res.regs_per_thread * res.threads <= 65_536
            assert res.vmem_bytes == mma_smem
        else:
            assert res.vmem_bytes == smem_bytes_fma(bq, bk, d, 2)
        assert res.feasible == (res.vmem_bytes <= 232_448)
        if res.feasible:
            feasible[res.route].add((bq, bk))
    assert feasible == {"wgmma": wgmma, "mma": MMA_FULL_WIDTH[d], "fma": fma_feasible}
    ok, why = KernelTemplate(shape).validate(
        KernelPoint(dims={"block_q": 256, "block_k": 64, "causal": True}))
    assert ok and why == ""
    big = {"block_q": 64, "block_k": 512, "causal": True}
    ok, why = KernelTemplate(shape).validate(KernelPoint(dims=big))
    assert not ok
    assert why == (f"shared memory {smem_bytes_fma(64, 512, d, 2)} B per block "
                   "exceeds 232448 B limit")


def test_every_tile_the_fma_kernel_took_still_launches():
    # a call that fits the FMA kernel's shared memory runs on the mma
    # kernel where that fits too, else on the FMA kernel: no such call is
    # refused (d up to 256, block_q and block_k from 1 to 512)
    blocks = (1, 16, 32, 64, 96, 128, 256, 512)
    for dtype, itemsize in ((torch.float32, 4), (torch.bfloat16, 2)):
        for d in (8, 16, 24, 64, 80, 96, 128, 160, 256):
            for bq in blocks:
                for bk in blocks:
                    if smem_bytes_fma(bq, bk, d, itemsize) > 232_448:
                        continue
                    f32 = "float32" if itemsize == 4 else "bfloat16"
                    shape = KernelShape("attn", "flash_attention",
                                        {"b": 1, "sq": bq, "sk": bk, "h": 2, "kh": 1, "d": d}, f32)
                    res = kernel_resources(shape, {"block_q": bq, "block_k": bk, "causal": True})
                    assert res.feasible, (f32, d, bq, bk, res.route)
                    assert res.route == route(dtype, d, bq, bk)


def test_wgmma_route_runs_at_the_tensor_core_rate():
    shape = KERNEL_SHAPE_BY_NAME["attn_llama3_8b_s4096_bf16"]
    bf16 = kernel_resources(shape, {"block_q": 128, "block_k": 128, "causal": True})
    f32 = KernelShape("attn_f32", "flash_attention", shape.params, "float32")
    mma = kernel_resources(f32, {"block_q": 64, "block_k": 64, "causal": True})
    assert (bf16.route, mma.route) == ("wgmma", "mma")
    # modelled: q in f32 (64; split at each use for f32) + O (64) + S (16)
    # + 40
    assert mma.regs_per_thread == 184 and mma.threads == 128
    # the causal walk at (128, 128): 528 K tiles per head over 32 heads
    flops = 32 * 528 * 4 * 128 * 128 * 128
    assert bf16.est_latency_us * 1e-6 >= flops / 989e12
    # f32 on the mma route: three TF32 products a product, at best
    # 495 / 3 TFLOP/s; the causal walk at (64, 64): 2080 K tiles per head
    assert mma.est_latency_us * 1e-6 >= 3 * 32 * 2080 * 4 * 64 * 64 * 128 / 495e12
    assert bf16.est_latency_us < mma.est_latency_us / 2


def test_mma_shared_memory_threads_and_head_dims():
    # K and q rows padded to 8 words mod 32 (f32) or 4 mod 16 (bf16), V rows
    # to 4 mod 16: at d=64 f32 72 + 68 words a key over two stages, and 72
    # a q row, 16 rows a warp
    assert smem_bytes_mma(64, 64, 64, 4) == (2 * 64 * (72 + 68) + 64 * 72) * 4 == 90_112
    assert smem_bytes_mma(128, 128, 64, 4) == (2 * 128 * (72 + 68) + 128 * 72) * 4
    assert smem_bytes_mma(64, 64, 16, 4) == (2 * 64 * (40 + 20) + 64 * 40) * 4
    assert smem_bytes_mma(64, 128, 128, 4) == (2 * 128 * (136 + 132) + 64 * 136) * 4
    assert smem_bytes_mma(64, 64, 64, 2) == (2 * 64 * (36 + 36) + 64 * 36) * 4
    # a pass holds at most 128 q rows
    assert smem_bytes_mma(512, 64, 64, 2) == smem_bytes_mma(128, 64, 64, 2)
    # block_k rounds up to whole sub-tiles (64 keys to d=32, 32 above)
    assert mma_sub_keys(32) == 64 and mma_sub_keys(64) == mma_sub_keys(96) == 32
    assert smem_bytes_mma(64, 1, 32, 4) == smem_bytes_mma(64, 64, 32, 4)
    assert smem_bytes_mma(64, 1, 64, 4) == smem_bytes_mma(64, 32, 64, 4)
    assert smem_bytes_mma(64, 40, 128, 2) == smem_bytes_mma(64, 64, 128, 2)
    assert [mma_threads(bq) for bq in (1, 16, 32, 48, 128, 256, 512)] == \
        [32, 32, 64, 96, 256, 256, 256]
    assert [mma_head_dim(d) for d in (1, 16, 24, 64, 80, 96, 112, 128, 129)] == \
        [16, 16, 32, 64, 96, 96, 128, 128, 0]
    assert MMA_D == (16, 32, 64, 96, 128)
    src = (Path(__file__).resolve().parents[1] / SOURCES["mma"]).read_text()
    cases = {int(m) for m in re.findall(r"^\s*FLASH_MMA_CASE\((\d+)\)", src, re.M)}
    assert cases == set(MMA_D)
    # above d = 128 the FMA kernel takes the call
    f32 = KernelShape("attn_d160", "flash_attention",
                      {"b": 1, "sq": 64, "sk": 64, "h": 1, "kh": 1, "d": 160}, "float32")
    res = kernel_resources(f32, {"block_q": 64, "block_k": 64, "causal": True})
    assert res.route == "fma" and res.feasible


# -- the mma route's arithmetic, emulated in plain torch ---------------------
def _flash_emulated(q, k, v, *, causal, block_q, block_k, q_offset=0, terms=3):
    """The mma route's walk: ``flash_attention_plain``'s tiles, mask and
    online softmax, with Q.K^T and P.V taken as the kernel takes them."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    bq, bk = min(block_q, sq), min(block_k, sk)
    qf = (q.float() * (1.0 / math.sqrt(d))).view(b, sq, kh, g, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    out = torch.empty(b, kh, g, sq, d)
    for qt in range(sq // bq):
        q_t = qf[..., qt * bq:(qt + 1) * bq, :]
        q_pos = q_offset + qt * bq + torch.arange(bq)
        m = torch.full((b, kh, g, bq), NEG_INF)
        l = torch.zeros(b, kh, g, bq)
        acc = torch.zeros(b, kh, g, bq, d)
        for t in range(k_tiles_walked(qt, bq, bk, sk, causal=causal, q_offset=q_offset)):
            k_t = kf[..., t * bk:(t + 1) * bk, :]
            v_t = vf[..., t * bk:(t + 1) * bk, :]
            s = tf32_product(q_t, k_t.transpose(-1, -2).expand(b, kh, g, d, bk), terms)
            if causal:
                k_pos = t * bk + torch.arange(bk)
                s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + tf32_product(p, v_t.expand(b, kh, g, bk, d), terms)
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out[..., qt * bq:(qt + 1) * bq, :] = acc / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def test_tf32_emulation_rounds_to_nearest_away_from_zero():
    # ties (half a unit of 2**-10) go away from zero, either sign
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12])
    assert tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10),
                                 1.0]
    r = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    big = tf32(r)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - big).abs() <= r.abs() * 2.0 ** -11).all()
    small = tf32_truncate(r - big)
    assert ((r - big - small).abs() <= r.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("dims", [pytest.param(d, id=",".join(f"{k}={v}" for k, v in d.items()))
                                  for d in tile_grid(KERNEL_SHAPE_BY_NAME["attn_s128_f32"])])
def test_split_tf32_holds_attn_s128_f32_to_its_plain_version(dims):
    shape = KERNEL_SHAPE_BY_NAME["attn_s128_f32"]
    p = shape.params
    rng = np.random.default_rng(11)
    (_, q), (_, k), (_, v) = _qkv(rng, p["b"], p["sq"], p["sk"], p["h"], p["kh"],
                                  p["d"], "float32")
    kw = dict(causal=dims["causal"], block_q=dims["block_q"], block_k=dims["block_k"])
    assert route(q.dtype, p["d"], dims["block_q"], dims["block_k"]) == "mma"
    agree = agree_with_plain(_flash_emulated(q, k, v, **kw),
                             flash_attention_plain(q, k, v, **kw))
    assert agree["passed"] and agree["limit"] <= PLAIN_REL[torch.float32], agree


@pytest.mark.parametrize("d", [16, 64, 96, 128])
@pytest.mark.parametrize("q_offset,causal", [(0, True), (-32, True), (0, False)])
def test_split_tf32_holds_each_head_dim_to_its_plain_version(d, q_offset, causal):
    # q_offset -32: the first 32 rows see no key and average V (-1e30 mask)
    rng = np.random.default_rng(d)
    (_, q), (_, k), (_, v) = _qkv(rng, 1, 64, 128, 4, 2, d, "float32")
    kw = dict(causal=causal, block_q=32, block_k=64, q_offset=q_offset)
    want = flash_attention_plain(q, k, v, **kw)
    agree = agree_with_plain(_flash_emulated(q, k, v, **kw), want)
    assert agree["passed"], agree
    if q_offset < 0:
        torch.testing.assert_close(want[:, :32], v.mean(dim=1, keepdim=True)
                                   .repeat_interleave(2, dim=2).expand(1, 32, 4, d),
                                   rtol=0, atol=1e-6)


def test_one_tf32_product_would_not_hold_f32_to_its_plain_version():
    # why the route splits: the same walk with one TF32 product a product
    # (10 mantissa bits) misses PLAIN_REL by far, the split three-term
    # product meets it by far
    rng = np.random.default_rng(3)
    (_, q), (_, k), (_, v) = _qkv(rng, 2, 128, 128, 4, 4, 64, "float32")
    kw = dict(causal=True, block_q=128, block_k=128)
    want = flash_attention_plain(q, k, v, **kw)
    one = agree_with_plain(_flash_emulated(q, k, v, terms=1, **kw), want)
    three = agree_with_plain(_flash_emulated(q, k, v, terms=3, **kw), want)
    assert one["ratio"] > 4 and not one["passed"]
    assert three["ratio"] < 0.25


def test_blocks_must_divide_the_sequence():
    q = torch.zeros(1, 96, 2, 16)
    with pytest.raises(ValueError, match="divide"):
        flash_attention_plain(q, q, q, block_q=64, block_k=64)
