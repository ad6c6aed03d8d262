"""How far bf16 departs from f32 in the dense model, in both packages.

Builds llama3-8b at full width with 2 layers on the CPU, one set of random
weights (the reference's, carried to the port by ``params_from_reference``),
runs a prefill of ``--tokens`` tokens and ``--steps`` decode steps in bf16
and in f32, and prints each package's max |logit(bf16) - logit(f32)| / max
|logit(f32)| over the prefill and the steps, as the card check
(``launch.measure.check_against_cpu``) takes it. It sizes that check's
tolerance (``launch.measure.MODEL_REL``): a gap of this size is bf16
rounding, not a fault of the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/bf16_gap.py --tokens 2048 --steps 8

Holds the weights in bf16 and in f32 at once (about 12 GB of memory);
about a minute and a half of CPU.
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
from repro_torch.configs import get_config as tget
from repro_torch.models import model as TM


def gap(want, got) -> float:
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    return float(np.abs(want - got).max() / np.abs(want).max())


def reference_logits(cfg, values, tok, steps):
    S = tok.shape[1] - steps
    prefill = jax.jit(lambda p, b, cache: JM.prefill_fn(cfg, p, b, cache))
    decode = jax.jit(lambda p, b, cache: JM.decode_fn(cfg, p, b, cache))
    logits, cache = prefill(values, {"tokens": jnp.asarray(tok[:, :S])},
                            JM.init_cache(cfg, 1, S + steps))
    out = [np.asarray(logits.astype(jnp.float32))]
    for i in range(steps):
        logits, cache = decode(values, {"tokens": jnp.asarray(tok[:, S + i:S + i + 1])}, cache)
        out.append(np.asarray(logits.astype(jnp.float32)))
    return out


def port_logits(cfg, params, tok, steps):
    S = tok.shape[1] - steps
    t = torch.from_numpy(tok)
    with torch.no_grad():
        logits, cache = TM.prefill_fn(cfg, params, {"tokens": t[:, :S]},
                                      TM.init_cache(cfg, 1, S + steps))
        out = [logits.float().numpy()]
        for i in range(steps):
            logits, cache = TM.decode_fn(cfg, params, {"tokens": t[:, S + i:S + i + 1]}, cache)
            out.append(logits.float().numpy())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    cfg = dataclasses.replace(jget("llama3-8b"), n_layers=2)
    values, _ = split_params(JM.init_params(cfg, jax.random.key(0)))
    tok = np.random.default_rng(0).integers(
        0, cfg.vocab, (1, args.tokens + args.steps)).astype(np.int32)
    ref, port = {}, {}
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dt)
        v = jax.tree.map(lambda a: a.astype(dt), values)
        ref[dt] = reference_logits(c, v, tok, args.steps)
        del v
        gc.collect()
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(tget("llama3-8b"), n_layers=2, dtype=dt)
        params = TM.params_from_reference(c, values)
        port[dt] = port_logits(c, params, tok, args.steps)
        del params
        gc.collect()

    def worst(a, b):
        return max(gap(x, y) for x, y in zip(a, b))

    print(f"llama3-8b, 2 layers, full width, {args.tokens}-token prefill and {args.steps} "
          f"decode steps on the CPU: bf16 vs f32 logit gap (share of max |logit|, worst "
          f"step): reference {worst(ref['float32'], ref['bfloat16']):.4g} (prefill "
          f"{gap(ref['float32'][0], ref['bfloat16'][0]):.4g}), port "
          f"{worst(port['float32'], port['bfloat16']):.4g} (prefill "
          f"{gap(port['float32'][0], port['bfloat16'][0]):.4g}); port vs reference: f32 "
          f"{worst(ref['float32'], port['float32']):.3g}, bf16 "
          f"{worst(ref['bfloat16'], port['bfloat16']):.3g}")


if __name__ == "__main__":
    main()
