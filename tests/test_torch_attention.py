"""The port's attention functions against the reference's on the same
numpy inputs (f32, within 1e-5 of the largest |value|): the chunked walk
(causal, full, windowed, offset queries), the triangular walk, decode
attention over a partly filled cache, and the KV-head selection a shard
of q heads makes on a sharded mesh. In bf16 each keeps the reference's
f32 scores: within 6e-3 (about one rounding of the bf16 output) of the
reference's bf16 result, on logits large enough that scores rounded to
bf16 would miss it (1.3-1.6e-2)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL


def rel_err(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _qkv(b, sq, sk, h, kh, d, seed=0):
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal(s)).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=40),
                                dict(causal=True, q_offset=24)],
                         ids=["causal", "full", "window", "q_offset"])
def test_chunked_attention_matches(kw):
    sq = 70 if "q_offset" not in kw else 46
    q, k, v = _qkv(2, sq, 70, 4, 2, 16)
    want = JL.chunked_attention(*map(jnp.asarray, (q, k, v)), q_chunk=32, k_chunk=16, **kw)
    got = TL.chunked_attention(*map(torch.from_numpy, (q, k, v)), q_chunk=32, **kw)
    assert rel_err(want, got) < 1e-5


@pytest.mark.parametrize("window", [None, 40])
def test_triangular_attention_matches(window):
    q, k, v = _qkv(2, 100, 100, 6, 2, 16, seed=1)
    want = JL.chunked_attention_tri(*map(jnp.asarray, (q, k, v)), window=window, chunk=32)
    got = TL.chunked_attention_tri(*map(torch.from_numpy, (q, k, v)), window=window, chunk=32)
    assert rel_err(want, got) < 1e-5


def test_decode_attention_matches():
    q, k, v = _qkv(3, 1, 50, 8, 2, 16, seed=2)
    kv_len = np.array([50, 7, 1], np.int32)
    want = JL.decode_attention(*map(jnp.asarray, (q, k, v, kv_len)))
    got = TL.decode_attention(*map(torch.from_numpy, (q, k, v, kv_len)))
    assert rel_err(want, got) < 1e-5


@pytest.mark.parametrize("fn", ["chunked", "tri", "decode"])
def test_bf16_attention_keeps_the_reference_f32_scores(fn):
    rng = np.random.default_rng(3)
    q, k, v = [(2.0 * rng.standard_normal(s)).astype(np.float32)
               for s in ((2, 256, 8, 64), (2, 256, 2, 64), (2, 256, 2, 64))]
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    if fn == "chunked":
        want = JL.chunked_attention(jq, jk, jv, q_chunk=64, k_chunk=64)
        got = TL.chunked_attention(tq, tk, tv, q_chunk=64)
    elif fn == "tri":
        want = JL.chunked_attention_tri(jq, jk, jv, chunk=64)
        got = TL.chunked_attention_tri(tq, tk, tv, chunk=64)
    else:
        kv_len = np.array([256, 100], np.int32)
        want = JL.decode_attention(jq[:, :1], jk, jv, jnp.asarray(kv_len))
        got = TL.decode_attention(tq[:, :1], tk, tv, torch.from_numpy(kv_len))
    assert got.dtype == torch.bfloat16
    assert rel_err(want.astype(jnp.float32), got) < 6e-3


@pytest.mark.parametrize("h_l,g", [(2, 4), (4, 2), (8, 4), (3, 2)])
def test_local_kv_selection_reproduces_full_attention(h_l, g):
    """A shard holding q heads [off, off + h_l) and every KV head attends
    with the KV heads ``_select_kv`` picks, and gets its slice of the full
    result, for every shard offset."""
    h = 24 if h_l == 3 else 16
    kh = h // g
    q, k, v = map(torch.from_numpy, _qkv(1, 40, 40, h, kh, 8, seed=3))
    full = TL.chunked_attention(q, k, v, q_chunk=16)
    for off in range(0, h, h_l):
        kl, vl = TL._select_kv(k, v, off, h_l, g, kv_sharded=False)
        part = TL.chunked_attention(q[:, :, off:off + h_l], kl, vl, q_chunk=16)
        assert torch.allclose(part, full[:, :, off:off + h_l], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("q0,k0,causal,window,k_valid", [
    (0, 0, True, None, None), (64, 0, True, None, None), (64, 32, True, None, 90),
    (-16, 0, True, None, None), (40, 0, False, None, None), (100, 0, True, 24, None),
    (100, 48, True, 40, 120), (100, 0, False, 30, None), (10, 0, True, 200, None)])
def test_in_place_mask_equals_the_added_block_mask(q0, k0, causal, window, k_valid):
    """``_mask_scores_`` touches only the columns it changes, and leaves the
    same scores as adding the full ``_block_mask`` (and masking keys past
    ``k_valid``), as the reference does."""
    c, n = 16, 96
    s = torch.randn(3, 2, c, n)
    qpos, kpos = q0 + torch.arange(c), k0 + torch.arange(n)
    mask = TL._block_mask(qpos, kpos, causal, window)
    if k_valid is not None:
        mask = torch.where(kpos[None, :] < k_valid, mask, TL.NEG_INF)
    want = s + mask
    got = s.clone()
    TL._mask_scores_(got, q0, k0, causal, window, k_valid)
    assert torch.equal(got, want)
