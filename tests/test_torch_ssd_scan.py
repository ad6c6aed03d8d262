"""repro_torch SSD scan: the plain chunk walk against the Pallas kernel
(interpret mode) over the full chunk grid of ``ssd_s256_f32`` and the
reference's shape sweep, the torch oracle against the jnp one,
``initial_state`` threading, the route rule (``wgmma`` for bf16 at the
sizes its kernel is instantiated for, ``fma`` otherwise) with the wgmma
route's plain version against the Pallas kernel and the FMA route, the
resource model at mamba2-780m widths and on both routes, and a walk that
drops the carried state failing both the row-wise kernel-against-plain
check and the oracle gate."""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import as_np, grid_cases, max_err

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.design_space import KernelTemplate, baseline_kernel_point
from repro_torch.core.device import H100_SXM
from repro_torch.core.kernel_space import (KERNEL_SHAPE_BY_NAME, kernel_resources,
                                           tile_grid)
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
        else:  # chunk 32: wgmma's M is 64
            assert L == 32 and res.threads == ssd.THREADS
            assert res.vmem_bytes == max(ssd.smem_bytes_intra(L, 128, 64),
                                         ssd.smem_bytes_state(L, 128, 64))
        assert res.vmem_bytes <= H100_SXM.smem_per_block
        # never below the bytes the scan must move over the memory rate
        min_bytes = 2 * (2 * 8 * 4096 * 48 * 64 + 8 * 4096 * (48 + 2 * 128))
        assert res.est_latency_us * 1e-6 >= min_bytes / H100_SXM.hbm_bw
    # the shipped default (chunk 256) needs no repair on the card
    assert baseline_kernel_point(shape, KernelTemplate(shape)).dims == {"chunk": 256}


@pytest.mark.parametrize("chunk,ok", [(16, True), (32, True), (36, False), (48, False),
                                      (64, True), (96, False), (192, True)])
def test_ssd_supported_agrees_with_the_launcher(chunk, ok):
    # the launcher takes a chunk only when both row tiles (min(L, 64) for the
    # intra kernel, min(L, 32) for the state kernel) divide it
    launcher = chunk % min(chunk, 64) == 0 and chunk % min(chunk, 32) == 0
    assert ssd.supported(chunk, 128, 64) == launcher == ok
    assert ssd_scan_resources(1, 4 * chunk, 2, 64, 128, chunk).feasible == ok


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
    (torch.float32, 256, 64, 128, "fma"),  # f32 stays on the FMA kernel
    (torch.bfloat16, 32, 64, 128, "fma"),  # wgmma's M is 64
    (torch.bfloat16, 192, 64, 128, "fma"),  # a chunk it has no tile for
    (torch.bfloat16, 256, 32, 128, "fma"),  # another head dim
    (torch.bfloat16, 256, 64, 48, "fma"),  # another state size
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
    # the FMA route's plain version: the same bf16 values in f32 (exactly
    # representable) with no intermediate rounding, y rounded once
    f32 = [t.float() for t in bf]
    assert ssd.route(torch.float32, chunk, 64, N) == "fma"
    fy, fs = ssd.ssd_scan_plain(*f32, chunk=chunk, initial_state=init)
    assert max_err(y, fy.to(torch.bfloat16)) <= tol and max_err(st, fs) <= tol
    # and the rounding of x * w and S_prev does show
    assert not torch.equal(st, fs)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("N", [40, 64, 128])
@pytest.mark.parametrize("dh", [24, 64])
def test_resource_model_routes_and_refuses_as_the_wrapper(itemsize, N, dh):
    dtype = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    for chunk in (16, 32, 48, 64, 96, 128, 192, 256):
        res = ssd_scan_resources(2, 512, 3, dh, N, chunk, itemsize=itemsize)
        path = ssd.route(dtype, chunk, dh, N)
        assert res.route == path
        if path == "wgmma":  # every routed size is instantiated and fits
            assert res.feasible and res.vmem_bytes == ssd.smem_bytes_wgmma(chunk, N, dh)
            assert res.blocks_per_sm == ssd.wgmma_ctas_per_sm(chunk, N, dh)
        else:
            assert res.feasible == (ssd.supported(chunk, N, dh)
                                    and res.vmem_bytes <= H100_SXM.smem_per_block)
