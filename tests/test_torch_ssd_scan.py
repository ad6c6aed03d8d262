"""repro_torch SSD scan: the plain chunk walk against the Pallas kernel
(interpret mode) over the full chunk grid of ``ssd_s256_f32`` and the
reference's shape sweep, the torch oracle against the jnp one,
``initial_state`` threading, the route rule (``wgmma`` for bf16 at the
sizes its kernel is instantiated for, ``mma`` for the rest whose chunk
tiles fit a block, ``fma`` for what is left) with the wgmma route's plain
version against the Pallas kernel and the plain version of the other
routes, the resource model at mamba2-780m widths and on all three routes,
the mma route's walk emulated with its split products against the plain
version (and one TF32 product a product missing it), and a walk that drops the
carried state failing both the row-wise kernel-against-plain check and the
oracle gate."""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import as_np, bf16x3_product, grid_cases, max_err, tf32_product

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.design_space import KernelTemplate, baseline_kernel_point
from repro_torch.core.device import H100_SXM
from repro_torch.core.kernel_space import (KERNEL_SHAPE_BY_NAME, KernelShape,
                                           kernel_resources, tile_grid)
from repro_torch.kernels import conformance, ops, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.resource_model import ssd_scan_resources

#: the gate's f32 tolerance for ssd_scan, the one the reference's tests use
TOL = 3e-3


def _np_inputs(rng, b, s, nh, dh, N):
    """The reference sweep's distributions, drawn with numpy."""
    x = (0.5 * rng.standard_normal((b, s, nh, dh))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal(nh))).astype(np.float32)
    B = (0.3 * rng.standard_normal((b, s, N))).astype(np.float32)
    C = (0.3 * rng.standard_normal((b, s, N))).astype(np.float32)
    return x, dt, A, B, C


def _both(arrays):
    import jax.numpy as jnp

    return ([jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("shape,dims", grid_cases([KERNEL_SHAPE_BY_NAME["ssd_s256_f32"]]))
def test_ssd_plain_matches_pallas_over_the_chunk_grid(shape, dims):
    inputs = conformance.make_inputs(shape)
    want_y, want_s = jops.ssd_scan(*_both([t.numpy() for t in inputs])[0],
                                   chunk=dims["chunk"], interpret=True)
    y, s = ssd.ssd_scan_plain(*inputs, chunk=dims["chunk"])
    assert y.dtype == inputs[0].dtype and y.shape == inputs[0].shape
    assert s.dtype == torch.float32 and tuple(s.shape) == (1, 4, 32, 32)
    assert max_err(y, want_y) <= TOL
    assert max_err(s, want_s) <= TOL


@pytest.mark.parametrize("s,chunk,nh,N", list(itertools.product(
    [32, 64, 128], [16, 32], [2, 4], [16, 32])))
def test_ssd_plain_matches_pallas_and_oracle_over_the_sweep(s, chunk, nh, N):
    rng = np.random.default_rng(s * 1000 + chunk * 10 + nh + N)
    jin, tin = _both(_np_inputs(rng, 2, s, nh, 16, N))
    y, st = ops.ssd_scan(*tin, chunk=chunk)
    want_y, want_s = jops.ssd_scan(*jin, chunk=chunk, interpret=True)
    assert max_err(y, want_y) <= TOL and max_err(st, want_s) <= TOL
    ref_y, ref_s = ref.ssd_ref(*tin)
    assert max_err(y, ref_y) <= TOL and max_err(st, ref_s) <= TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_ref_matches_the_reference_oracle(dtype, with_state):
    rng = np.random.default_rng(4)
    x, dt, A, B, C = _np_inputs(rng, 2, 48, 3, 8, 12)
    tx, tdt, tB, tC = (torch.from_numpy(a).to(conformance._DTYPES[dtype])
                       for a in (x, dt, B, C))
    tA = torch.from_numpy(A)
    s0 = (0.3 * rng.standard_normal((2, 3, 8, 12))).astype(np.float32) \
        if with_state else None
    got_y, got_s = ref.ssd_ref(tx, tdt, tA, tB, tC,
                               None if s0 is None else torch.from_numpy(s0))
    import jax.numpy as jnp

    jx, jdt, jB, jC = (jnp.asarray(as_np(t), dtype=dtype) for t in (tx, tdt, tB, tC))
    want_y, want_s = jref.ssd_ref(jx, jdt, jnp.asarray(A), jB, jC,
                                  None if s0 is None else jnp.asarray(s0))
    assert got_y.dtype == tx.dtype and got_s.dtype == torch.float32
    assert max_err(got_y, want_y) <= conformance.tolerance("ssd_scan", dtype)
    assert max_err(got_s, want_s) <= TOL


def test_ssd_initial_state_threading():
    """Chunked scan with a carried initial state == one long exact scan
    (port of the reference's test_ssd_initial_state_threading)."""
    rng = np.random.default_rng(1)
    x, dt, A, B, C = (torch.from_numpy(a) for a in _np_inputs(rng, 1, 64, 2, 16, 16))
    _, s_half = ops.ssd_scan(x[:, :32], dt[:, :32], A, B[:, :32], C[:, :32], chunk=16)
    y2, s_full = ops.ssd_scan(x[:, 32:], dt[:, 32:], A, B[:, 32:], C[:, 32:],
                              chunk=16, initial_state=s_half)
    want_y, want_s = ref.ssd_ref(x, dt, A, B, C)
    assert max_err(y2, want_y[:, 32:]) <= TOL
    assert max_err(s_full, want_s) <= TOL
    # and the plain walk threads it as the Pallas kernel does
    jin = [np.asarray(t[:, 32:]) for t in (x, dt)] + [np.asarray(A)] + \
        [np.asarray(t[:, 32:]) for t in (B, C)]
    import jax.numpy as jnp

    jy, js = jops.ssd_scan(*[jnp.asarray(a) for a in jin], chunk=16,
                           initial_state=jnp.asarray(s_half.numpy()), interpret=True)
    assert max_err(y2, jy) <= TOL and max_err(s_full, js) <= TOL


def test_ssd_resources_at_full_width():
    shape = KERNEL_SHAPE_BY_NAME["ssd_mamba2_780m_b8_s4096_bf16"]
    assert shape.params == {"b": 8, "s": 4096, "nh": 48, "dh": 64, "N": 128}
    assert [d["chunk"] for d in tile_grid(shape)] == [32, 64, 128, 256]
    for dims in tile_grid(shape):
        res = kernel_resources(shape, dims)
        L = dims["chunk"]
        assert res.feasible and res.route == ssd.route(torch.bfloat16, L, 64, 128)
        if res.route == "wgmma":  # chunks 64, 128 and 256
            assert res.threads == ssd.wgmma_threads(L, 128) == 288
            assert res.vmem_bytes == ssd.smem_bytes_wgmma(L, 128, 64)
        else:  # chunk 32: wgmma's M is 64; split products on mma.sync
            assert L == 32 and res.route == "mma"
            assert res.threads == ssd.mma_threads(64) == 128
            assert res.vmem_bytes == ssd.smem_bytes_mma(L, 128, 64, 2) == 50_176
        assert res.vmem_bytes <= H100_SXM.smem_per_block
        # never below the bytes the scan must move over the memory rate
        min_bytes = 2 * (2 * 8 * 4096 * 48 * 64 + 8 * 4096 * (48 + 2 * 128))
        assert res.est_latency_us * 1e-6 >= min_bytes / H100_SXM.hbm_bw
    # the shipped default (chunk 256) needs no repair on the card
    assert baseline_kernel_point(shape, KernelTemplate(shape)).dims == {"chunk": 256}


@pytest.mark.parametrize("chunk,ok", [(16, True), (32, True), (36, True), (48, True),
                                      (64, True), (96, True), (192, True)])
def test_ssd_supported_agrees_with_the_launcher(chunk, ok):
    # the launcher takes tiles that are whole float4s (multiples of 4) and
    # any chunk they fit: a chunk the row tile (at most 64 for the intra
    # kernel) or the state tile (at most 32) does not divide ends in a
    # masked tile, so 36, 48 and 96 launch too
    tl, (tq, ps) = ssd.row_tile(chunk, 128, 64), ssd.state_plan(chunk, 128, 64)
    assert (tl, tq, ps) == (min(chunk, 64), min(chunk, 32), 64)
    launcher = all(t > 0 and t % 4 == 0 for t in (tl, tq, ps))
    assert ssd.supported(chunk, 128, 64) == launcher == ok
    # N 160 is above the whole-chunk mma kernel's 128: these calls stream on
    # the mma route
    assert ssd.route(torch.bfloat16, chunk, 64, 160) == "mma"
    assert ssd.mma_streams(chunk, 160, 64, 2)
    assert ssd_scan_resources(1, 4 * chunk, 2, 64, 160, chunk).feasible == ok
    # at N 128 the tensor-core routes take every one of these chunks
    res = ssd_scan_resources(1, 4 * chunk, 2, 64, 128, chunk)
    assert res.feasible and res.route in ("mma", "wgmma")


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("dh", [32, 64, 96, 128, 160, 256])
def test_every_census_call_launches(dh, itemsize):
    # dh x N 16-256 x chunk 32-512: each of these 360 calls launches on
    # wgmma or mma (whole chunks or streamed), none on fma, the wrapper's
    # launch the model's
    dtype = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    for N in (16, 64, 128, 160, 192, 256):
        for chunk in (32, 64, 128, 256, 512):
            res = ssd_scan_resources(1, 2 * chunk, 2, dh, N, chunk, itemsize=itemsize)
            assert res.feasible and res.route == ssd.route(dtype, chunk, dh, N) != "fma", \
                (N, chunk)
            if res.route == "mma":
                assert (res.threads, res.vmem_bytes) == ssd.mma_launch(chunk, N, dh, itemsize)
                assert 0 < res.vmem_bytes <= H100_SXM.smem_per_block
    # dh 128, N 256, chunk 256 would ask 243,712 B at a row tile of 64: 32
    assert ssd._intra_bytes(256, 256, 128, 64) == 243_712
    assert ssd.row_tile(256, 256, 128) == 32
    assert ssd._intra_bytes(512, 128, 96, 64) == 237_568 and ssd.row_tile(512, 128, 96) == 32


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("dh", [30, 64, 130])
def test_every_odd_census_call_launches(dh, itemsize):
    # odd sizes: dh and N not multiples of 4 (padded inside the kernels),
    # chunks the row and sub-tiles do not divide (masked last tiles): none
    # on fma; a streamed call's slices of dh cover dh
    dtype = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    for N in (30, 64, 130, 160):
        for chunk in (48, 96, 160, 192, 320):
            res = ssd_scan_resources(1, 2 * chunk, 2, dh, N, chunk, itemsize=itemsize)
            assert res.feasible and res.route == ssd.route(dtype, chunk, dh, N) != "fma", \
                (N, chunk)
            if res.route == "mma" and ssd.mma_streams(chunk, N, dh, itemsize):
                w = ssd.stream_warps(chunk, N, dh, itemsize)
                assert 2 <= w <= 8 and w % 2 == 0 and 8 * w <= -(-dh // 16) * 16
                assert res.threads == 32 * w


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dh,N,chunk", [(16, 160, 64), (16, 256, 64), (16, 48, 512),
                                        (30, 130, 96)])
def test_fma_sizes_plain_matches_pallas(dh, N, chunk, with_state):
    # the sizes the FMA kernels took and the mma route now streams (N above
    # 128, a chunk above 256; dh and N padded inside the kernel, a chunk the
    # sub-tile does not divide), through its plain version, against the
    # Pallas kernel
    import jax.numpy as jnp

    rng = np.random.default_rng(dh + N + chunk + with_state)
    arrays = _np_inputs(rng, 1, 2 * chunk, 3, dh, N)
    s0 = (0.3 * rng.standard_normal((1, 3, dh, N))).astype(np.float32) if with_state else None
    assert ssd.route(torch.float32, chunk, dh, N) == "mma" and ssd.mma_streams(chunk, N, dh, 4)
    jin, tin = _both(arrays)
    want_y, want_s = jops.ssd_scan(*jin, chunk=chunk, interpret=True,
                                   initial_state=None if s0 is None else jnp.asarray(s0))
    y, st = ssd.ssd_scan_plain(*tin, chunk=chunk,
                               initial_state=None if s0 is None else torch.from_numpy(s0))
    assert y.shape == tin[0].shape and tuple(st.shape) == (1, 3, dh, N)
    assert max_err(y, want_y) <= TOL and max_err(st, want_s) <= TOL


def _drop_carried_state(x, dt, A, B, C, *, chunk, initial_state=None):
    """A broken walk: every chunk starts from a zero state (S_prev and
    initial_state lost), as a kernel that forgot the recurrence would."""
    b, s, nh, dh = x.shape
    nc, N = s // chunk, B.shape[-1]
    y, st = ssd.ssd_scan_plain(
        x.reshape(b * nc, chunk, nh, dh), dt.reshape(b * nc, chunk, nh), A,
        B.reshape(b * nc, chunk, N), C.reshape(b * nc, chunk, N), chunk=chunk)
    return y.reshape(x.shape), st.reshape(b, nc, nh, dh, N)[:, -1]


def test_dropping_the_carried_state_fails_the_row_check_and_the_gate(monkeypatch):
    shape = KERNEL_SHAPE_BY_NAME["ssd_s256_f32"]
    inputs = conformance.make_inputs(shape)
    dims = {"chunk": 32}
    want = conformance.run_plain(shape, dims, inputs)
    ok = conformance.agree_with_plain(ssd.ssd_scan_plain(*inputs, chunk=32), want)
    assert ok["passed"] and ok["ratio"] == 0
    bad = _drop_carried_state(*inputs, chunk=32)
    # the carried state decays along the chunk, so the first rows of each
    # later chunk move most and the last rows ten times less
    err = (bad[0] - want[0]).abs().amax(dim=(2, 3)).view(8, 32)
    assert torch.equal(err[0], torch.zeros(32))  # chunk 0 starts from 0 anyway
    assert err[1:, :4].max() > 10 * err[1:, 24:].max() > 0
    row = conformance.agree_with_plain(bad, want)
    assert not row["passed"] and row["ratio"] > 100
    monkeypatch.setattr(ops, "ssd_scan", _drop_carried_state)
    gate = conformance.check_candidate(shape, dims, inputs=inputs)
    assert not gate["passed"] and gate["max_abs_err"] > gate["tol"]


def test_agree_with_plain_checks_the_final_state_too():
    shape = KERNEL_SHAPE_BY_NAME["ssd_s256_f32"]
    inputs = conformance.make_inputs(shape)
    y, s = conformance.run_plain(shape, {"chunk": 64}, inputs)
    s_bad = s.clone()
    s_bad[0, 1, 3] *= 1.001
    res = conformance.agree_with_plain((y, s_bad), (y, s))
    assert not res["passed"] and res["ratio"] > 1


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    shape = KERNEL_SHAPE_BY_NAME["ssd_s256_f32"]
    x, dt, A, B, C = conformance.make_inputs(shape)
    with pytest.raises(ValueError, match="card"):
        ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=64)
    with pytest.raises(ValueError, match="divide"):
        ssd.ssd_scan_plain(x, dt, A, B, C, chunk=96)


@pytest.mark.parametrize("dtype,chunk,dh,N,want", [
    (torch.bfloat16, 64, 64, 128, "wgmma"),
    (torch.bfloat16, 128, 64, 128, "wgmma"),
    (torch.bfloat16, 256, 64, 128, "wgmma"),
    (torch.bfloat16, 256, 64, 64, "wgmma"),  # zamba2-2.7b's state
    (torch.float32, 256, 64, 128, "mma"),  # f32 chunk tiles beyond a block: streamed
    (torch.bfloat16, 32, 64, 128, "mma"),  # wgmma's M is 64
    (torch.bfloat16, 192, 64, 128, "mma"),  # a chunk wgmma has no tile for
    (torch.bfloat16, 256, 32, 128, "mma"),  # another head dim
    (torch.bfloat16, 256, 64, 48, "mma"),  # another state size
    (torch.float32, 32, 64, 128, "mma"),  # f32 at mamba2-780m widths
    (torch.float32, 128, 64, 128, "mma"),  # one stage still fits
    (torch.float32, 256, 32, 32, "mma"),  # ssd_s256_f32
    (torch.float32, 32, 24, 40, "mma"),  # ssd_odd_b2_s96_f32
    (torch.bfloat16, 48, 20, 33, "mma"),  # rows, dh and N padded inside
    (torch.float32, 64, 32, 160, "mma"),  # N above 128: streamed
    (torch.bfloat16, 64, 192, 64, "mma"),  # dh above 128: slices of dh
    (torch.bfloat16, 512, 32, 32, "mma"),  # a chunk above 256: streamed
    (torch.float32, 256, 64, 64, "mma"),  # zamba2-2.7b's widths in f32: streamed
    (torch.float32, 64, 64, 512, "fma"),  # N beyond two warps' streamed block
    (torch.bfloat16, 64, 64, 1024, "fma"),
])
def test_route_is_decided_by_dtype_chunk_head_dim_and_state(dtype, chunk, dh, N, want):
    assert ssd.route(dtype, chunk, dh, N) == want


def test_wgmma_dispatch_instantiates_exactly_the_routed_sizes():
    src = (Path(__file__).resolve().parents[1] / ssd.SOURCES["wgmma"]).read_text()
    cases = {tuple(map(int, m)) for m in
             re.findall(r"^\s*SSD_WGMMA_CASE\((\d+), (\d+), (\d+)\)", src, re.M)}
    assert cases == set(itertools.product(ssd.WGMMA_DH, ssd.WGMMA_N, ssd.WGMMA_CHUNKS))


def test_wgmma_smem_formula():
    # per stage C, B and x of the chunk in bf16 plus cs and dt in f32 (padded
    # to 1024 B); S_prev in bf16; one mbarrier per row tile and stage plus
    # one per stage; two stages except at chunk 256 with N 128
    assert ssd.smem_bytes_wgmma(256, 128) == \
        1024 + (256 * 320 * 2 + 2048) + 64 * 128 * 2 + 8 * 5 == 183_336
    assert ssd.wgmma_stages(256, 128) == 1
    assert ssd.smem_bytes_wgmma(128, 128) == \
        1024 + 2 * (128 * 320 * 2 + 1024) + 64 * 128 * 2 + 8 * 2 * 3 == 183_344
    assert ssd.smem_bytes_wgmma(256, 64) == 210_000 <= H100_SXM.smem_per_block
    # N 128: a consumer warpgroup per 64 state columns, one CTA an SM; N 64:
    # one warpgroup and two CTAs an SM where they fit, else two warpgroups
    grid = [(L, N) for N in (128, 64) for L in (64, 128, 256)]
    assert [ssd.wgmma_warpgroups(L, N) for L, N in grid] == [2, 2, 2, 1, 1, 2]
    assert [ssd.wgmma_threads(L, N) for L, N in grid] == [288, 288, 288, 160, 160, 288]
    assert [ssd.wgmma_ctas_per_sm(L, N) for L, N in grid] == [1, 1, 1, 2, 2, 1]


def _bf16_case(N, with_state):
    rng = np.random.default_rng(7 * N + with_state)
    x = 0.3 * rng.standard_normal((1, 256, 3, 64))
    dt = 0.1 + 0.2 * rng.random((1, 256, 3))
    A = -(0.5 + rng.random(3))
    B, C = (0.3 * rng.standard_normal((1, 256, N)) for _ in range(2))
    s0 = 0.3 * rng.standard_normal((1, 3, 64, N)) if with_state else None
    return [a.astype(np.float32) for a in (x, dt, A, B, C)], s0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("N", [64, 128])
def test_wgmma_route_plain_matches_pallas_and_the_fma_route(N, chunk, with_state):
    import jax.numpy as jnp

    (x, dt, A, B, C), s0 = _bf16_case(N, with_state)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, dt)] + \
        [torch.from_numpy(A)] + [torch.from_numpy(a).to(torch.bfloat16) for a in (B, C)]
    init = None if s0 is None else torch.from_numpy(s0).float()
    assert ssd.route(torch.bfloat16, chunk, 64, N) == "wgmma"
    y, st = ssd.ssd_scan_plain(*bf, chunk=chunk, initial_state=init)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    tol = conformance.tolerance("ssd_scan", "bfloat16")
    # the Pallas kernel on the same bf16 values
    jin = [jnp.asarray(as_np(t), dtype=jnp.float32 if t.dtype == torch.float32
                       else jnp.bfloat16) for t in bf]
    want_y, want_s = jops.ssd_scan(*jin, chunk=chunk, interpret=True,
                                   initial_state=None if s0 is None else jnp.asarray(s0))
    assert max_err(y, want_y) <= tol and max_err(st, want_s) <= tol
    # the plain version of the f32 routes: the same bf16 values in f32
    # (exactly representable) with no intermediate rounding, y rounded once;
    # f32 chunk tiles of 256 rows do not fit the whole-chunk kernel's block:
    # they stream
    f32 = [t.float() for t in bf]
    assert ssd.route(torch.float32, chunk, 64, N) == "mma"
    assert ssd.mma_streams(chunk, N, 64, 4) == (chunk == 256)
    fy, fs = ssd.ssd_scan_plain(*f32, chunk=chunk, initial_state=init)
    assert max_err(y, fy.to(torch.bfloat16)) <= tol and max_err(st, fs) <= tol
    # and the rounding of x * w and S_prev does show
    assert not torch.equal(st, fs)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("N", [40, 64, 128, 160])
@pytest.mark.parametrize("dh", [24, 64])
def test_resource_model_routes_and_refuses_as_the_wrapper(itemsize, N, dh):
    dtype = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    seen = set()
    for chunk in (16, 32, 48, 64, 96, 128, 192, 256):
        res = ssd_scan_resources(2, 512, 3, dh, N, chunk, itemsize=itemsize)
        path = ssd.route(dtype, chunk, dh, N)
        assert res.route == path
        seen.add(path)
        if path == "wgmma":  # every routed size is instantiated and fits
            assert res.feasible and res.vmem_bytes == ssd.smem_bytes_wgmma(chunk, N, dh)
            assert res.blocks_per_sm == ssd.wgmma_ctas_per_sm(chunk, N, dh)
        elif path == "mma":  # routed only where its block fits: it launches
            assert res.feasible
            assert (res.threads, res.vmem_bytes) == ssd.mma_launch(chunk, N, dh, itemsize)
            assert 0 < res.vmem_bytes <= H100_SXM.smem_per_block
            if not ssd.mma_streams(chunk, N, dh, itemsize):
                assert res.threads == ssd.mma_threads(dh)
                assert res.vmem_bytes == ssd.smem_bytes_mma(chunk, N, dh, itemsize)
        else:  # the FMA kernels refuse what supported() refuses
            assert res.feasible == (ssd.supported(chunk, N, dh)
                                    and res.vmem_bytes <= H100_SXM.smem_per_block)
    # N above 128 streams on the mma route; below it the whole-chunk kernel
    # takes every chunk up to 256 at bf16, and f32 streams at 256 only
    assert "fma" not in seen and "mma" in seen
    streamed = {c for c in (16, 32, 48, 64, 96, 128, 192, 256)
                if ssd.route(dtype, c, dh, N) == "mma" and ssd.mma_streams(c, N, dh, itemsize)}
    if N > 128:
        assert streamed == {c for c in (16, 32, 48, 64, 96, 128, 192, 256)
                            if ssd.route(dtype, c, dh, N) == "mma"}
    else:
        assert streamed <= {192, 256}


def test_mma_smem_formula_and_threads():
    # per stage C, B (rows of N padded to 64 or 128) and x (dh padded to 16 a
    # warp) in the input type, rows padded to 8 words mod 32 (f32) or 4 mod
    # 32 (bf16); cs, dt, exp(cs) and w of two chunks in f32; P's buffers of
    # 32 f32 rows padded to 8 words mod 32; two stages and one P buffer at
    # chunk 32
    assert ssd.mma_plan(32, 128, 64, 2) == (2, 1)
    assert ssd.smem_bytes_mma(32, 128, 64, 2) == \
        4 * (2 * 32 * (68 + 68 + 36) + 8 * 32 + 32 * 40) == 50_176
    # ssd_s256_f32 at chunk 256 (N 32 held as 64): one stage, one P buffer
    assert ssd.mma_plan(256, 32, 32, 4) == (1, 1)
    assert ssd.smem_bytes_mma(256, 32, 32, 4) == \
        4 * (256 * (72 + 72 + 40) + 8 * 256 + 32 * 264) == 230_400
    # ssd_odd_b2_s96_f32 (dh 24 -> 32, N 40 -> 64) at chunk 32
    assert ssd.smem_bytes_mma(32, 40, 24, 4) == \
        4 * (2 * 32 * (72 + 72 + 40) + 8 * 32 + 32 * 40) == 53_248
    # rows padded to 16: chunk 40 holds 48 rows, two row tiles, two buffers
    assert ssd.mma_plan(40, 48, 32, 2) == (2, 2)
    assert ssd.smem_bytes_mma(40, 48, 32, 2) == \
        4 * (2 * 48 * (36 + 36 + 36) + 8 * 48 + 2 * 32 * 72)
    # f32 at mamba2-780m widths: one stage at chunk 128, none at 256
    assert ssd.mma_plan(128, 128, 64, 4) == (1, 2)
    assert ssd.mma_plan(256, 128, 64, 4) == (0, 0)
    assert ssd.smem_bytes_mma(256, 128, 64, 4) == 0
    for args in [(32, 128, 64, 2), (256, 32, 32, 4), (128, 128, 64, 4), (256, 48, 32, 4)]:
        assert 0 < ssd.smem_bytes_mma(*args) <= H100_SXM.smem_per_block
    # one warp per 16 columns of dh padded to 32, 64 or 128; the state held
    # as 64 or 128 columns
    assert [ssd.mma_warps(d) for d in (1, 16, 24, 32, 33, 48, 64, 65, 128, 129)] == \
        [2, 2, 2, 2, 4, 4, 4, 8, 8, 0]
    assert [ssd.mma_threads(d) for d in (16, 24, 64, 96)] == [64, 64, 128, 256]
    assert [ssd.mma_state_cols(n) for n in (1, 32, 40, 64, 65, 128, 129)] == \
        [64, 64, 64, 64, 128, 128, 0]


def test_mma_dispatch_instantiates_every_routed_size():
    root = Path(__file__).resolve().parents[1]
    src = (root / ssd.SOURCES["mma"]).read_text() + \
        (root / "src/repro_torch/kernels/csrc/ssd_mma.cuh").read_text()
    cases = {tuple(map(int, m)) for m in
             re.findall(r"^\s*SSD_MMA_CASE\((\d+), (\d+)\)", src, re.M)}
    routed = {(ssd.mma_warps(d), ssd.mma_state_cols(n) // 8)
              for d in range(1, ssd.MMA_MAX_DH + 1) for n in range(1, ssd.MMA_MAX_N + 1)}
    assert cases == routed == set(itertools.product((2, 4, 8), (8, 16)))
    # and the C side's limits are the Python side's
    for name, value in (("MAX_L", ssd.MMA_MAX_CHUNK), ("MAX_N", ssd.MMA_MAX_N),
                        ("RT", ssd.MMA_ROW_TILE)):
        assert re.search(rf"constexpr int {name} = {value};", src), name


def _ssd_emulated(x, dt, A, B, C, *, chunk, initial_state=None, terms=3):
    """The mma route's walk, chunk by chunk, with every product taken as the
    kernel takes it (f32 inputs: ``tf32_product`` with ``terms``; bf16
    inputs: ``bf16x3_product``, the f32 operand in three bf16 parts):
    acc = (C . S_prev^T) exp(cs_l); P = G exp(cs_l - cs_s) dt_s, masked to
    s <= l, with G = C . B^T; acc += P . x; y = acc rounded once; then
    S <- S exp(cs_L) + (x w)^T . B."""
    b, s, nh, dh = x.shape
    N = B.shape[-1]
    L = min(chunk, s)
    nc = s // L
    product = (bf16x3_product if x.dtype == torch.bfloat16
               else lambda u, v: tf32_product(u, v, terms))
    cs = ssd.chunk_cumsum(dt, A, L).view(b, nc, L, nh)
    xf = x.float().view(b, nc, L, nh, dh)
    dtf = dt.float().view(b, nc, L, nh)
    Bf, Cf = B.float().view(b, nc, L, N), C.float().view(b, nc, L, N)
    S = (torch.zeros(b, nh, dh, N) if initial_state is None
         else initial_state.float().clone())
    y = torch.empty(b, nc, L, nh, dh)
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    for c in range(nc):
        csc = cs[:, c]
        G = product(Cf[:, c], Bf[:, c].transpose(-1, -2))
        for h in range(nh):
            csh = csc[..., h]
            decay = torch.exp(csh[:, :, None] - csh[:, None, :])
            P = torch.where(causal, G * decay * dtf[:, c, None, :, h], torch.zeros(()))
            acc = product(Cf[:, c], S[:, h].transpose(-1, -2)) \
                * torch.exp(csh)[..., None]
            y[:, c, :, h] = acc + product(P, xf[:, c, :, h])
        w = dtf[:, c] * torch.exp(csc[:, -1:, :] - csc)
        xw = (xf[:, c] * w[..., None]).permute(0, 2, 3, 1)  # [b, nh, dh, L]
        S = S * torch.exp(csc[:, -1])[..., None, None] \
            + product(xw, Bf[:, c][:, None])
    return y.reshape(b, s, nh, dh).to(x.dtype), S


def _mma_cases():
    shapes = [KERNEL_SHAPE_BY_NAME["ssd_s256_f32"],
              KernelShape("ssd_odd_b2_s96_f32", "ssd_scan",
                          {"b": 2, "s": 96, "nh": 3, "dh": 24, "N": 40}, "float32")]
    return [pytest.param(shape, d["chunk"], id=f"{shape.name}-chunk={d['chunk']}")
            for shape in shapes for d in tile_grid(shape)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape,chunk", _mma_cases())
def test_split_tf32_walk_holds_the_f32_cells_to_their_plain_version(shape, chunk, with_state):
    inputs = conformance.make_inputs(shape)
    p = shape.params
    assert ssd.route(torch.float32, chunk, p["dh"], p["N"]) == "mma"
    init = (0.3 * torch.from_numpy(np.random.default_rng(chunk).standard_normal(
        (p["b"], p["nh"], p["dh"], p["N"]))).float()) if with_state else None
    want = ssd.ssd_scan_plain(*inputs, chunk=chunk, initial_state=init)
    got = _ssd_emulated(*inputs, chunk=chunk, initial_state=init)
    for part in (0, 1):  # y and the final state, each at PLAIN_REL
        agree = conformance.agree_with_plain(got[part], want[part])
        assert agree["passed"] and agree["ratio"] < 0.25, (part, agree)


def test_split_walk_holds_bf16_at_chunk_32_to_its_plain_version():
    # bf16 C, B and x are exact: G takes one bf16 product, the rest three
    # (the f32 operand in three bf16 parts)
    rng = np.random.default_rng(5)
    x, dt, A, B, C = _np_inputs(rng, 1, 128, 3, 64, 128)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, dt)] + \
        [torch.from_numpy(A)] + [torch.from_numpy(a).to(torch.bfloat16) for a in (B, C)]
    assert ssd.route(torch.bfloat16, 32, 64, 128) == "mma"
    agree = conformance.agree_with_plain(_ssd_emulated(*bf, chunk=32),
                                         ssd.ssd_scan_plain(*bf, chunk=32))
    assert agree["passed"], agree


def test_one_tf32_product_would_not_hold_the_f32_scan_to_its_plain_version():
    # why the route splits: the same walk with one TF32 product a product
    # (10 mantissa bits) misses PLAIN_REL by far, in y and in the state
    shape = KERNEL_SHAPE_BY_NAME["ssd_s256_f32"]
    inputs = conformance.make_inputs(shape)
    want = ssd.ssd_scan_plain(*inputs, chunk=64)
    one = _ssd_emulated(*inputs, chunk=64, terms=1)
    three = _ssd_emulated(*inputs, chunk=64, terms=3)
    for part in (0, 1):
        miss = conformance.agree_with_plain(one[part], want[part])
        assert not miss["passed"] and miss["ratio"] > 4, (part, miss)
        assert conformance.agree_with_plain(three[part], want[part])["ratio"] < 0.25


@pytest.mark.parametrize("dh,N", [(64, 128), (64, 64)])
def test_f32_at_the_default_chunk_runs_on_mma_at_both_ssm_widths(dh, N):
    # mamba2-780m (dh 64, N 128) and zamba2-2.7b (dh 64, N 64) in f32 at the
    # reference's default chunk 256: the whole-chunk kernel's block would
    # need about 394 KB, so the mma route streams; the modelled block fits
    assert ssd.route(torch.float32, 256, dh, N) == "mma"
    assert ssd.mma_plan(256, N, dh, 4) == (0, 0) and ssd.mma_streams(256, N, dh, 4)
    assert ssd._mma_bytes(256, 128, 64, 4, 1, 1) > 390_000
    res = ssd_scan_resources(8, 4096, 48, dh, N, 256, itemsize=4)
    assert res.feasible and res.route == "mma" and res.threads == 256
    assert res.vmem_bytes == ssd.smem_bytes_stream(256, N, dh, 4) <= H100_SXM.smem_per_block


def test_stream_plan_is_its_sources():
    src = (Path(__file__).resolve().parents[1] / ssd.STREAM_SOURCE).read_text()
    assert re.search(rf"constexpr int KS = {ssd.STREAM_KEYS};", src)
    assert re.search(rf"constexpr int MAX_WARPS = {ssd.STREAM_MAX_WARPS};", src)
    # the slice's state [8 W][N padded to 32] f32 (rows 8 mod 32 words); cs,
    # dt, w of 256 rows; two row tiles of C rows and two sub-tiles of B and x
    # rows (f32 rows 8 mod 32 words); a 32 x 40-word P buffer. At
    # mamba2-780m's f32 widths 8 warps (one CTA an SM) and 4 (two of
    # 105,472 B) keep 8 warps resident; the tie goes to the wider slice
    assert ssd.stream_warps(256, 128, 64, 4) == 8
    assert ssd.smem_bytes_stream(256, 128, 64, 4) == \
        4 * (64 * 136 + 3 * 256 + 2 * 32 * 136 + 2 * 32 * (136 + 72) + 32 * 40) == 131_072
    assert ssd._stream_bytes(256, 128, 4, 4) == \
        4 * (32 * 136 + 3 * 256 + 2 * 32 * 136 + 2 * 32 * (136 + 40) + 32 * 40) == 105_472
    # dh 256 in slices of 64 (8 warps), two CTAs an SM in bf16, one in f32
    # at N 256
    assert ssd.stream_warps(256, 128, 256, 2) == 8
    assert ssd.stream_warps(256, 256, 256, 4) == 8
    assert ssd.mma_launch(256, 256, 64, 2) == (256, ssd.smem_bytes_stream(256, 256, 64, 2))
    # dh 16 takes two warps (one pair of 16 columns)
    assert ssd.stream_warps(64, 64, 16, 4) == 2
    # two warps' block holds N up to 352 in f32, 640 in bf16; past it the
    # FMA kernels take the call
    assert ssd.stream_warps(64, 352, 16, 4) == 2 and ssd.stream_warps(64, 368, 16, 4) == 0
    assert ssd.stream_warps(64, 640, 16, 2) == 2 and ssd.stream_warps(64, 672, 16, 2) == 0
    assert ssd.route(torch.float32, 64, 16, 384) == "fma" and ssd.supported(64, 384, 16)


@pytest.mark.parametrize("dtype,dh,N,chunk", [
    ("float32", 64, 128, 256), ("float32", 64, 64, 256), ("bfloat16", 32, 256, 64),
    ("float32", 130, 30, 160), ("bfloat16", 24, 40, 512)])
def test_split_walk_holds_the_streamed_sizes_to_their_plain_version(dtype, dh, N, chunk):
    # the streamed calls take the products the whole-chunk walk takes, in
    # sub-tiles: the emulated walk holds them to the plain version
    dt_ = getattr(torch, dtype)
    assert ssd.route(dt_, chunk, dh, N) == "mma" and ssd.mma_streams(chunk, N, dh, dt_.itemsize)
    rng = np.random.default_rng(dh + N + chunk)
    arrays = _np_inputs(rng, 1, 2 * chunk, 2, dh, N)
    inputs = [torch.from_numpy(a).to(dt_) if a.ndim > 1 else torch.from_numpy(a)
              for a in arrays]
    want = ssd.ssd_scan_plain(*inputs, chunk=chunk)
    got = _ssd_emulated(*inputs, chunk=chunk)
    for part in (0, 1):
        agree = conformance.agree_with_plain(got[part], want[part])
        assert agree["passed"], (part, agree)
