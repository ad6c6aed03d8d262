"""The port's Mamba2 block (``models/mamba2.py``) against the reference's
``repro/models/mamba2.py`` on the same numpy inputs: the chunked SSD
(against the reference's and against the port's exact sequential oracle
``kernels/ref.ssd_ref``, at lengths a multiple of the chunk and not, with
and without an initial state), the causal conv with and without its decode
carry, the recurrent one-token step, a whole block's prefill then decode
on the reference's weights, and the dtypes a bf16 model keeps in f32
(``A_log``, ``D``, ``dt_bias`` and the SSM state).

Tolerances: f32 within 1e-5 of the largest |value| against the reference
(the same arithmetic), 1e-4 against the sequential oracle (a different
summation order over up to 70 steps)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import mamba2 as JM2
from repro.models import model as JM
from repro.models.layers import split_params
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced as treduced
from repro_torch.kernels import ref as tref
from repro_torch.models import mamba2 as TM2
from repro_torch.models import model as TM


def rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _ssd_inputs(seed, b, s, nh, dh, N, state=False):
    rng = np.random.default_rng(seed)
    arrs = [(0.5 * rng.standard_normal((b, s, nh, dh))).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32),
            (-np.exp(0.3 * rng.standard_normal(nh))).astype(np.float32),
            (0.3 * rng.standard_normal((b, s, N))).astype(np.float32),
            (0.3 * rng.standard_normal((b, s, N))).astype(np.float32)]
    if state:
        arrs.append((0.2 * rng.standard_normal((b, nh, dh, N))).astype(np.float32))
    return arrs


@pytest.mark.parametrize("s,chunk,state", [(64, 16, False), (70, 16, False), (70, 16, True),
                                           (37, 8, True), (16, 32, False)])
def test_ssd_chunked_matches_the_reference_and_the_oracle(s, chunk, state):
    arrs = _ssd_inputs(s + chunk, 2, s, 3, 8, 5, state)
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.from_numpy(a) for a in arrs]
    jy, js = JM2.ssd_chunked(*j[:5], chunk, j[5] if state else None)
    ty, ts = TM2.ssd_chunked(*t[:5], chunk, t[5] if state else None)
    assert tuple(ty.shape) == jy.shape and ty.dtype == torch.float32
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (2, 3, 8, 5)
    assert rel(jy, ty) < 1e-5 and rel(js, ts) < 1e-5
    oy, os_ = tref.ssd_ref(*t[:5], initial_state=t[5] if state else None)
    assert rel(oy, ty) < 1e-4 and rel(os_, ts) < 1e-4


def test_ssd_chunked_backward_is_finite_and_matches_the_reference():
    """The mask inside the exponent: a masked entry never overflows, so the
    gradient carries no NaN (``exp`` then ``where`` would give one)."""
    arrs = _ssd_inputs(3, 1, 40, 2, 4, 3)
    arrs[1] = arrs[1] * 30.0  # large decays: exp of a masked (l < s) entry overflows
    j = [jnp.asarray(a) for a in arrs]
    jg = jax.grad(lambda x, dt: JM2.ssd_chunked(x, dt, *j[2:], 16)[0].sum(), (0, 1))(j[0], j[1])
    t = [torch.from_numpy(a).requires_grad_(i < 2) for i, a in enumerate(arrs)]
    y, _ = TM2.ssd_chunked(*t, 16)
    gx, gdt = torch.autograd.grad(y.sum(), t[:2])
    assert torch.isfinite(gx).all() and torch.isfinite(gdt).all()
    assert rel(jg[0], gx) < 1e-4 and rel(jg[1], gdt) < 1e-4


@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv_matches_with_and_without_its_carry(carry):
    rng = np.random.default_rng(7)
    x = (0.5 * rng.standard_normal((2, 5, 12))).astype(np.float32)
    w = (0.1 * rng.standard_normal((4, 12))).astype(np.float32)
    b = (0.1 * rng.standard_normal(12)).astype(np.float32)
    st = (0.5 * rng.standard_normal((2, 3, 12))).astype(np.float32) if carry else None
    jo, js = JM2._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              None if st is None else jnp.asarray(st))
    to, ts = TM2._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                              None if st is None else torch.from_numpy(st))
    assert rel(jo, to) < 1e-6 and rel(js, ts) == 0.0
    # one token at a time through the carry gives the whole sequence's conv
    state = torch.zeros(2, 3, 12)
    steps = []
    for i in range(5):
        o, state = TM2._causal_conv(torch.from_numpy(x[:, i:i + 1]), torch.from_numpy(w),
                                    torch.from_numpy(b), state)
        steps.append(o)
    whole, _ = TM2._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert rel(whole, torch.cat(steps, 1)) < 1e-6


def _block(dtype="float32"):
    cfg = reduced(get_config("mamba2-780m"), dtype=dtype)
    tcfg = treduced(tget("mamba2-780m"), dtype=dtype)
    values, _ = split_params(JM.init_params(cfg, jax.random.key(2)))
    jp = jax.tree.map(lambda a: a[0], values["blocks"])  # layer 0
    rng = np.random.default_rng(4)
    # non-trivial A_log, D and dt_bias (the init's are the same in every head)
    nh = cfg.ssm.n_heads(cfg.d_model)
    for k in ("A_log", "D", "dt_bias"):
        jp[k] = jnp.asarray((0.5 * rng.standard_normal(nh)).astype(np.float32)) + jp[k]
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if v.dtype == jnp.float32 else torch.bfloat16) for k, v in jp.items()}
    return cfg, tcfg, jp, tp


def test_block_prefill_then_recurrent_decode_match_the_reference():
    cfg, tcfg, jp, tp = _block()
    rng = np.random.default_rng(5)
    x = (0.5 * rng.standard_normal((2, 21, cfg.d_model))).astype(np.float32)
    jc = JM2.init_mamba_cache(cfg, 2, jnp.float32)
    tc = TM2.init_mamba_cache(tcfg, 2, torch.float32)
    jo, jc = JM2.mamba_block(jp, jnp.asarray(x[:, :20]), cfg, cache=jc)
    to, tc = TM2.mamba_block(tp, torch.from_numpy(x[:, :20]), tcfg, cache=tc)
    assert rel(jo, to) < 1e-5
    assert rel(jc["conv"], tc["conv"]) < 1e-6 and rel(jc["ssm"], tc["ssm"]) < 1e-5
    # the recurrent step (s == 1 with a state) against the reference's
    jo, jc = JM2.mamba_block(jp, jnp.asarray(x[:, 20:]), cfg, cache=jc)
    to, tc = TM2.mamba_block(tp, torch.from_numpy(x[:, 20:]), tcfg, cache=tc)
    assert rel(jo, to) < 1e-5 and rel(jc["ssm"], tc["ssm"]) < 1e-5
    # and equals the chunked prefill of all 21 tokens
    full, fc = TM2.mamba_block(tp, torch.from_numpy(x), tcfg,
                               cache=TM2.init_mamba_cache(tcfg, 2, torch.float32))
    assert rel(full[:, -1:], to) < 1e-5 and rel(fc["ssm"], tc["ssm"]) < 1e-5
    # no cache: the chunked forward alone
    jo = JM2.mamba_block(jp, jnp.asarray(x), cfg)[0]
    assert rel(jo, TM2.mamba_block(tp, torch.from_numpy(x), tcfg)[0]) < 1e-5


def test_bf16_model_keeps_the_ssm_leaves_and_state_in_f32():
    cfg = reduced(get_config("mamba2-780m"), dtype="bfloat16")
    tcfg = treduced(tget("mamba2-780m"), dtype="bfloat16")
    values, _ = split_params(JM.init_params(cfg, jax.random.key(0)))
    tp = TM.params_from_reference(tcfg, jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), values))
    want = {f"blocks.{k}": v.dtype for k, v in values["blocks"].items()}
    want.update({k: v.dtype for k, v in values.items() if k != "blocks"})
    names = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}
    assert {k: v.dtype for k, v in tp.items()} == {k: names[jnp.dtype(v)] for k, v in want.items()}
    for k in ("A_log", "D", "dt_bias"):
        assert tp[f"blocks.{k}"].dtype == torch.float32
    assert tp["blocks.in_proj"].dtype == torch.bfloat16
    init, _ = TM.init_params(tcfg)
    assert {k: v.dtype for k, v in init.items()} == {k: v.dtype for k, v in tp.items()}
    cache = TM.init_cache(tcfg, 2, 16)
    assert cache["ssm"].dtype == torch.float32 and cache["conv"].dtype == torch.bfloat16
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 9)).astype(np.int32))
    logits, cache = TM.prefill_fn(tcfg, tp, {"tokens": tok}, cache)
    assert cache["ssm"].dtype == torch.float32 and logits.dtype == torch.bfloat16
    jl, jc = JM.prefill_fn(cfg, values, {"tokens": jnp.asarray(tok.numpy())},
                           JM.init_cache(cfg, 2, 16))
    assert jc["ssm"].dtype == jnp.float32
    assert rel(jl.astype(jnp.float32), logits) < 2e-2
    assert rel(jc["ssm"], cache["ssm"]) < 2e-2
