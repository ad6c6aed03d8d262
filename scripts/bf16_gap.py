"""How far bf16 departs from f32 in a model, in both packages.

Builds ``--arch`` (llama3-8b by default) at full width with ``--layers``
layers on the CPU (``launch.measure.cut_config``'s cut), one set of random
weights (the reference's, carried to the port by ``params_from_reference``),
runs a prefill of ``--tokens`` tokens (after a frontend's rows, or beside
an encoder's frames, N(0, 1) from the seed) and ``--steps`` decode steps in
bf16 and in f32, and prints each package's max |logit(bf16) - logit(f32)|
/ max |logit(f32)| over the prefill and the steps, as the card check
(``launch.measure.check_against_cpu``) takes it. The card check measures
the port's own gap itself and holds the card's bf16 run to
``BF16_GAP_FACTOR`` times it; this script sets the port's gap beside the
reference's (``launch.measure.MODEL_REL``, the card tests' bound on
llama3-8b, is the reference's gap rounded up to the next whole percent).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/bf16_gap.py --tokens 2048 --steps 8
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/bf16_gap.py --arch zamba2-2.7b --layers 6

llama3-8b holds its weights in bf16 and in f32 at once (about 12 GB of
memory); about a minute and a half of CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models.layers import split_params
from repro_torch.launch.measure import cut_config
from repro_torch.models import model as TM


def gap(want, got) -> float:
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    return float(np.abs(want - got).max() / np.abs(want).max())


def _prompt(cfg, tok, fe, S):
    """The prefill batch and the cache length it needs."""
    batch = {"tokens": tok[:, :S]}
    if fe is not None:
        batch["frontend"] = fe
    return batch, (cfg.frontend_len if cfg.family == "vlm" else 0) + tok.shape[1]


def reference_logits(cfg, values, tok, fe, steps):
    S = tok.shape[1] - steps
    prefill = jax.jit(lambda p, b, cache: JM.prefill_fn(cfg, p, b, cache))
    decode = jax.jit(lambda p, b, cache: JM.decode_fn(cfg, p, b, cache))
    batch, n = _prompt(cfg, tok, fe, S)
    logits, cache = prefill(values, {k: jnp.asarray(v) for k, v in batch.items()},
                            JM.init_cache(cfg, 1, n))
    out = [np.asarray(logits.astype(jnp.float32))]
    for i in range(steps):
        logits, cache = decode(values, {"tokens": jnp.asarray(tok[:, S + i:S + i + 1])}, cache)
        out.append(np.asarray(logits.astype(jnp.float32)))
    return out


def port_logits(cfg, params, tok, fe, steps):
    S = tok.shape[1] - steps
    t = torch.from_numpy(tok)
    batch, n = _prompt(cfg, tok, fe, S)
    with torch.no_grad():
        logits, cache = TM.prefill_fn(cfg, params, {k: torch.from_numpy(v)
                                                    for k, v in batch.items()},
                                      TM.init_cache(cfg, 1, n))
        out = [logits.float().numpy()]
        for i in range(steps):
            logits, cache = TM.decode_fn(cfg, params, {"tokens": t[:, S + i:S + i + 1]}, cache)
            out.append(logits.float().numpy())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args()
    tcfg = cut_config(args.arch, args.layers)
    cut = {k: getattr(tcfg, k) for k in ("n_layers", "n_enc_layers")}
    cfg = dataclasses.replace(jget(args.arch), **cut)
    values, _ = split_params(JM.init_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (1, args.tokens + args.steps)).astype(np.int32)
    fe = (rng.standard_normal((1, cfg.frontend_len, 1024)).astype(np.float32)
          if cfg.frontend else None)
    ref, port = {}, {}
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dt)
        # each leaf in the dtype the reference's own init gives it in this
        # dtype (Mamba2's A_log, D and dt_bias stay f32 in a bf16 model)
        v = jax.tree.map(lambda a, want: a.astype(want.dtype), values, JM.abstract_params(c)[0])
        ref[dt] = reference_logits(c, v, tok, fe, args.steps)
        del v
        gc.collect()
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(tcfg, dtype=dt)
        params = TM.params_from_reference(c, values)
        port[dt] = port_logits(c, params, tok, fe, args.steps)
        del params
        gc.collect()

    def worst(a, b):
        return max(gap(x, y) for x, y in zip(a, b))

    print(f"{args.arch}, {args.layers} layers, full width, {args.tokens}-token prefill and "
          f"{args.steps} decode steps on the CPU: bf16 vs f32 logit gap (share of max "
          f"|logit|, worst step): reference {worst(ref['float32'], ref['bfloat16']):.4g} (prefill "
          f"{gap(ref['float32'][0], ref['bfloat16'][0]):.4g}), port "
          f"{worst(port['float32'], port['bfloat16']):.4g} (prefill "
          f"{gap(port['float32'][0], port['bfloat16'][0]):.4g}); port vs reference: f32 "
          f"{worst(ref['float32'], port['float32']):.3g}, bf16 "
          f"{worst(ref['bfloat16'], port['bfloat16']):.3g}")


if __name__ == "__main__":
    main()
