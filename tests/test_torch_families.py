"""The five model families beyond dense (MoE, VLM, SSM, hybrid and
encoder-decoder: mixtral-8x7b, qwen3-moe-235b-a22b, llava-next-34b,
mamba2-780m, zamba2-2.7b and seamless-m4t-medium) in the port against the
reference, at ``reduced`` sizes, on the reference's weights carried across
by ``params_from_reference``: prefill's last-token logits and its filled
cache, two decode steps' logits and caches, decode after prefill(S)
against prefill(S+1), and the input specs of every shape cell (the loss
with its gradients, and bf16: ``tests/test_torch_families_train.py``).

The hybrid's LoRA ``b`` halves start at zero in the reference's init, which
would leave its LoRA path untested: they are drawn non-zero here, in both
packages. Tolerances: f32 logits and caches within 1e-4 of the largest
|value| of the reference's tensor."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import model as JM
from repro.models.layers import split_params
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced as treduced
from repro_torch.models import model as TM

FAMILIES = ["mixtral-8x7b", "qwen3-moe-235b-a22b", "llava-next-34b", "mamba2-780m",
            "zamba2-2.7b", "seamless-m4t-medium"]


def rel_err(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = (got.float().detach().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, pre + k + "."))
        else:
            out[pre + k] = v
    return out


def models(arch, dtype="float32", **over):
    """(cfg, tcfg, reference values, port params) at ``reduced`` size."""
    cfg = reduced(get_config(arch), dtype=dtype, **over)
    tcfg = treduced(tget(arch), dtype=dtype, **over)
    values, _ = split_params(JM.init_params(cfg, jax.random.key(1)))
    if "lora" in values:  # non-zero LoRA b halves (the init's are zero)
        rng = np.random.default_rng(9)
        for part in values["lora"].values():
            for k, v in part.items():
                if k.endswith("_lora_b"):
                    part[k] = jnp.asarray(0.02 * rng.standard_normal(v.shape), v.dtype)
    tparams = TM.params_from_reference(tcfg, jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), values))
    return cfg, tcfg, values, tparams


def inputs(cfg, b, s, seed=0, targets=False):
    """(reference batch, port batch) of ``s`` positions: the text after the
    frontend's rows for vlm, beside the frames for audio."""
    rng = np.random.default_rng(seed)
    text = s - cfg.frontend_len if cfg.family == "vlm" else s
    names = ("tokens", "targets") if targets else ("tokens",)
    arrs = {k: rng.integers(0, cfg.vocab, (b, text)).astype(np.int32) for k in names}
    if cfg.frontend:
        arrs["frontend"] = (0.3 * rng.standard_normal((b, cfg.frontend_len, 1024))).astype(
            np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_then_decode_match_the_reference(arch):
    cfg, tcfg, values, tparams = models(arch)
    B, S, max_len = 2, 40, 48
    jb, tb = inputs(cfg, B, S)
    jl, jc = jax.jit(lambda p, b, c: JM.prefill_fn(cfg, p, b, c))(
        values, jb, JM.init_cache(cfg, B, max_len))
    tl, tc = TM.prefill_fn(tcfg, tparams, tb, TM.init_cache(tcfg, B, max_len))
    assert tuple(tl.shape) == jl.shape == (B, 1, cfg.vocab)
    assert rel_err(jl, tl) < 1e-4
    jf, tf = flat(jc), flat(tc)
    assert set(jf) == set(tf)
    for k in jf:
        assert tuple(tf[k].shape) == jf[k].shape, k
        assert rel_err(jf[k], tf[k]) < 1e-4 or k.endswith("len"), k
    if "len" in jf:
        assert tf["len"].tolist() == np.asarray(jf["len"]).tolist() == [S, S]
    jdecode = jax.jit(lambda p, b, c: JM.decode_fn(cfg, p, b, c))
    rng = np.random.default_rng(11)
    for _ in range(2):
        nxt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = jdecode(values, {"tokens": jnp.asarray(nxt)}, jc)
        tl, tc = TM.decode_fn(tcfg, tparams, {"tokens": torch.from_numpy(nxt)}, tc)
        assert rel_err(jl, tl) < 1e-4
        jf, tf = flat(jc), flat(tc)
        for k in jf:
            if k.endswith("len"):
                assert tf[k].tolist() == np.asarray(jf[k]).tolist()
            else:
                assert rel_err(jf[k], tf[k]) < 1e-4, k


#: archs whose reference gives every prompt token position 0 at a prefill
#: with a cache (``hybrid_forward`` and ``decode_stack`` take ``cache["len"]
#: + 0`` as the positions of all ``s`` tokens), which the port keeps for
#: parity: their decode after prefill(S) departs from prefill(S+1) by the
#: reference's own gap (ROADMAP queue 3)
PREFILL_POSITIONS_ZERO = {"zamba2-2.7b", "seamless-m4t-medium"}


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_is_consistent_with_a_longer_prefill(arch):
    """prefill(S) then one decode step gives prefill(S+1)'s last logits.
    MoE drops tokens by group, and a decode step's group (the batch's one
    token each) is not the prompt's: the property holds where no token is
    dropped, so the MoE archs run at a capacity factor of E / K, where
    every expert takes a whole group. For ``PREFILL_POSITIONS_ZERO`` the
    gap must be the reference's."""
    over = {}
    if get_config(arch).moe is not None:
        import dataclasses

        spec = reduced(get_config(arch)).moe
        over["moe"] = dataclasses.replace(spec, capacity_factor=spec.n_experts / spec.top_k)
    cfg, tcfg, values, tparams = models(arch, **over)
    jb, tb = inputs(tcfg, 2, 17)

    def short(b):
        return {k: (v[:, :-1] if k == "tokens" else v) for k, v in b.items()}

    _, cache = TM.prefill_fn(tcfg, tparams, short(tb), TM.init_cache(tcfg, 2, 24))
    step, _ = TM.decode_fn(tcfg, tparams, {"tokens": tb["tokens"][:, -1:]}, cache)
    full, _ = TM.prefill_fn(tcfg, tparams, tb, TM.init_cache(tcfg, 2, 24))
    gap = rel_err(full.numpy(), step)
    if arch not in PREFILL_POSITIONS_ZERO:
        assert gap < 1e-4
        return
    _, jc = JM.prefill_fn(cfg, values, short(jb), JM.init_cache(cfg, 2, 24))
    jstep, _ = JM.decode_fn(cfg, values, {"tokens": jb["tokens"][:, -1:]}, jc)
    jfull, _ = JM.prefill_fn(cfg, values, jb, JM.init_cache(cfg, 2, 24))
    ref_gap = rel_err(jfull, jstep)
    assert ref_gap > 1e-4 and abs(gap - ref_gap) < 1e-5 * max(ref_gap, 1.0) + 1e-6


@pytest.mark.parametrize("arch", FAMILIES)
def test_input_specs_match_the_reference(arch):
    from repro_torch.configs import SHAPES

    cfg, tcfg = get_config(arch), tget(arch)
    for cell in SHAPES:
        want, got = JM.input_specs(cfg, cell), TM.input_specs(tcfg, cell)
        jf, tf = flat(want), flat(got)
        assert set(jf) == set(tf), cell.name
        for k, v in jf.items():
            assert tuple(tf[k].shape) == v.shape, (cell.name, k)
            assert str(tf[k].dtype).split(".")[-1] == str(v.dtype).replace("bfloat16",
                                                                           "bfloat16"), k
