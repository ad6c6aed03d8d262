"""The port's gradient compression against the reference's: both codecs'
round trips on the same numpy gradients (``topk`` on both sides of its
2**22-element branch to a strided-sample threshold), error feedback over
several steps, and ``wire_bytes_factor``. Tolerance: 1e-6 of each
gradient's largest |value| (the codecs' own arithmetic in f32 on both
sides)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import grad_compress as jgc
from repro_torch.train import grad_compress as tgc


def _g(n, seed=0):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(want - got.numpy()).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", [(7,), (33, 65), (4, 16, 48)])
def test_int8_roundtrip_matches(shape):
    g = _g(int(np.prod(shape))).reshape(shape)
    assert _rel(jgc._int8_roundtrip(jnp.asarray(g)), tgc._int8_roundtrip(torch.from_numpy(g))) \
        <= 1e-6


@pytest.mark.parametrize("n", [1000, 77_777, (1 << 22) + 4096])
def test_topk_roundtrip_matches(n):
    """Above 2**22 elements both take the threshold from a strided sample."""
    g = _g(n, seed=n).reshape(-1, 8) if n % 8 == 0 else _g(n, seed=n)
    want = np.asarray(jgc._topk_roundtrip(jnp.asarray(g)))
    got = tgc._topk_roundtrip(torch.from_numpy(g))
    assert np.array_equal(want != 0, got.numpy() != 0)
    assert _rel(want, got) == 0.0
    kept = int((got != 0).sum())
    assert kept >= max(int(n * tgc.TOPK_FRAC), 1) * (0.9 if n > 1 << 22 else 1.0)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_error_feedback_matches_over_steps(kind):
    shapes = {"a": (40, 24), "b.c": (3, 8, 16)}
    jnest = lambda d: {"a": d["a"], "b": {"c": d["b.c"]}}  # noqa: E731
    jef = jgc.init_error_feedback(jnest({k: jnp.zeros(s, jnp.bfloat16) for k, s in shapes.items()}))
    tef = tgc.init_error_feedback({k: torch.zeros(s, dtype=torch.bfloat16) for k, s in shapes.items()})
    assert all(v.dtype == torch.float32 for v in tef.values())
    for step in range(4):
        g = {k: _g(int(np.prod(s)), seed=10 * step + i).reshape(s)
             for i, (k, s) in enumerate(shapes.items())}
        jdec, jef = jgc.compress_decompress(kind, jnest({k: jnp.asarray(v) for k, v in g.items()}),
                                            jef)
        tdec, tef2 = tgc.compress_decompress(kind, {k: torch.from_numpy(v) for k, v in g.items()},
                                             tef)
        assert tef2 is tef  # updated in place
        for k in shapes:
            jd = jdec["a"] if k == "a" else jdec["b"]["c"]
            je = jef["a"] if k == "a" else jef["b"]["c"]
            assert _rel(jd, tdec[k]) <= 1e-6, (step, k)
            assert float(np.abs(np.asarray(je) - tef[k].numpy()).max()) <= \
                1e-6 * float(np.abs(g[k]).max()), (step, k)


def test_wire_bytes_factor_matches():
    for kind in ("none", "int8", "topk"):
        assert tgc.wire_bytes_factor(kind) == jgc.wire_bytes_factor(kind)
    assert tgc.TOPK_FRAC == jgc.TOPK_FRAC
