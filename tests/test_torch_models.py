"""The port's dense models against the reference's, at ``reduced`` sizes
with the reference's weights carried across by ``params_from_reference``:
prefill's last-token logits and filled cache, decode's logits and cache,
the no-cache forward under both ``attn_impl`` values, a bf16 case, and the
decode-consistency property (the attention functions alone:
``test_torch_attention.py``).

Tolerances: f32 within 1e-4 of the largest |value| of the reference's
tensor; bf16 within 2e-2 of it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models.layers import split_params
from repro.sharding.plan import PlanCtx as JPlanCtx
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced as treduced
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.sharding.plan import PlanCtx

DENSE = ["llama3-8b", "qwen3-8b", "qwen3-0.6b", "stablelm-3b"]


def rel_err(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _models(arch, dtype="float32", **over):
    cfg = reduced(get_config(arch), dtype=dtype, **over)
    tcfg = treduced(tget(arch), dtype=dtype, **over)
    values, _ = split_params(JM.init_params(cfg, jax.random.key(1)))
    tparams = TM.params_from_reference(tcfg, jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), values))
    return cfg, tcfg, values, tparams


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_match_the_reference(arch):
    cfg, tcfg, values, tparams = _models(arch)
    B, S, max_len = 2, 40, 48
    tok = _tokens(cfg, B, S)
    jprefill = jax.jit(lambda p, b, c: JM.prefill_fn(cfg, p, b, c))
    jdecode = jax.jit(lambda p, b, c: JM.decode_fn(cfg, p, b, c))
    jl, jc = jprefill(values, {"tokens": jnp.asarray(tok)}, JM.init_cache(cfg, B, max_len))
    tl, tc = TM.prefill_fn(tcfg, tparams, {"tokens": torch.from_numpy(tok)},
                           TM.init_cache(tcfg, B, max_len))
    assert tuple(tl.shape) == jl.shape == (B, 1, cfg.vocab)
    assert rel_err(jl, tl) < 1e-4
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == jc[k].shape == (cfg.n_layers, B, max_len,
                                                    cfg.n_kv_heads, cfg.head_dim())
        assert rel_err(jc[k], tc[k]) < 1e-4
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [S, S]
    for step in range(3):
        nxt = _tokens(cfg, B, 1, seed=10 + step)
        jl, jc = jdecode(values, {"tokens": jnp.asarray(nxt)}, jc)
        tl, tc = TM.decode_fn(tcfg, tparams, {"tokens": torch.from_numpy(nxt)}, tc)
        assert rel_err(jl, tl) < 1e-4
        assert rel_err(jc["k"], tc["k"]) < 1e-4 and rel_err(jc["v"], tc["v"]) < 1e-4
        assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()


@pytest.mark.parametrize("attn_impl", ["chunked", "tri"])
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-0.6b"])
def test_forward_matches_under_both_attn_impls(arch, attn_impl):
    cfg, tcfg, values, tparams = _models(arch)
    tok = _tokens(cfg, 2, 1100)  # three 512-row chunks, the last one short
    jx, _, _ = JT.dense_forward(cfg, values, {"tokens": jnp.asarray(tok)},
                                constrain=JPlanCtx(lambda a, k: a, attn_impl=attn_impl))
    tx, _ = TT.dense_forward(tcfg, tparams, {"tokens": torch.from_numpy(tok)},
                             constrain=PlanCtx(lambda a, k: a, attn_impl=attn_impl))
    assert rel_err(jx, tx) < 1e-4


def test_bf16_prefill_and_decode_within_2e_2():
    cfg, tcfg, values, tparams = _models("llama3-8b", dtype="bfloat16")
    tok = _tokens(cfg, 2, 24)
    jl, jc = JM.prefill_fn(cfg, values, {"tokens": jnp.asarray(tok)}, JM.init_cache(cfg, 2, 32))
    tl, tc = TM.prefill_fn(tcfg, tparams, {"tokens": torch.from_numpy(tok)},
                           TM.init_cache(tcfg, 2, 32))
    assert tl.dtype == torch.bfloat16 and tc["k"].dtype == torch.bfloat16
    assert rel_err(jl.astype(jnp.float32), tl) < 2e-2
    assert rel_err(jc["k"].astype(jnp.float32), tc["k"]) < 2e-2
    nxt = _tokens(cfg, 2, 1, seed=5)
    jl, jc = JM.decode_fn(cfg, values, {"tokens": jnp.asarray(nxt)}, jc)
    tl, tc = TM.decode_fn(tcfg, tparams, {"tokens": torch.from_numpy(nxt)}, tc)
    assert rel_err(jl.astype(jnp.float32), tl) < 2e-2
    assert rel_err(jc["v"].astype(jnp.float32), tc["v"]) < 2e-2


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "stablelm-3b"])
def test_decode_is_consistent_with_a_longer_prefill(arch):
    """prefill(S) then one decode step gives prefill(S+1)'s last logits,
    the reference's own property (tests/test_decode_consistency.py)."""
    _, tcfg, _, tparams = _models(arch)
    tok = torch.from_numpy(_tokens(tcfg, 2, 17))
    _, cache = TM.prefill_fn(tcfg, tparams, {"tokens": tok[:, :16]}, TM.init_cache(tcfg, 2, 24))
    step, _ = TM.decode_fn(tcfg, tparams, {"tokens": tok[:, 16:]}, cache)
    full, _ = TM.prefill_fn(tcfg, tparams, {"tokens": tok}, TM.init_cache(tcfg, 2, 24))
    assert rel_err(full.numpy(), step) < 1e-4


def test_other_families_and_train_cells_name_their_slice():
    """Every family is ported (``tests/test_torch_families.py`` holds them
    to the reference): their params and input specs build, with the
    reference's shapes, for an MoE arch as for the dense ones."""
    from repro_torch.configs import SHAPE_BY_NAME

    params, axes = TM.init_params(tget("mixtral-8x7b"), device="meta")
    assert params["blocks.mlp.wi"].shape == (32, 8, 4096, 14336)
    assert axes["blocks.mlp.wi"] == ("layers", "experts", "embed", "expert_ffn")
    # train cells are ported: the reference's int32 [B, S] tokens and targets
    for arch in ("llama3-8b", "mixtral-8x7b"):
        want = JM.input_specs(get_config(arch), SHAPE_BY_NAME["train_4k"])["batch"]
        got = TM.input_specs(tget(arch), SHAPE_BY_NAME["train_4k"])["batch"]
        assert set(got) == set(want) == {"tokens", "targets"}
        for k, v in got.items():
            assert tuple(v.shape) == want[k].shape and v.dtype == torch.int32
    for arch in ("llama3-8b", "mixtral-8x7b", "mamba2-780m"):
        assert TM.cell_supported(tget(arch), SHAPE_BY_NAME["long_500k"]) == \
            JM.cell_supported(get_config(arch), SHAPE_BY_NAME["long_500k"])
