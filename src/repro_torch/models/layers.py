"""Shared neural-net layers in torch math (counterpart of ``repro/models/layers.py``).

Conventions
-----------
* Parameters are a flat dict ``{dotted path: tensor}`` (the reference's
  tree paths joined with ``.``, e.g. ``blocks.attn.wq``) beside a dict of
  the same keys holding each one's logical axes, which
  ``repro_torch.sharding.plan`` resolves to placements. Layer-stacked
  parameters carry a leading ``"layers"`` axis, as in the reference.
* Attention keeps the reference's arithmetic: scores stored, scaled,
  masked (``NEG_INF``) and softmaxed in f32 whatever the operands' type,
  probabilities rounded to the value type for the product with V. The
  reference walks q chunks and k chunks with an online softmax; here each
  q chunk meets all of its keys in one product and one softmax, which
  gives the same result within rounding with far fewer launches.
* On a sharded mesh the activations are DTensors; attention runs on local
  shards (``sharding.plan.local_call``, the ``shard_map`` analogue), since
  its grouped-query layout does not survive DTensor's view rules.
* Loops over layers and chunks go through ``constrain.walk`` so the dry run
  can trace representative steps and weight them by the trip count.
* Under autograd each q chunk is recomputed in backward (the reference's
  ``jax.checkpoint`` of each q step), and the f32-score product has a
  backward of its own (``_ProductF32``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.sharding.plan import full_walk, is_sharded, local_call, shard_offset

NEG_INF = -1e30

Axes = Tuple[Optional[str], ...]


# ---------------------------------------------------------------------------
# Param plumbing
# ---------------------------------------------------------------------------
class ParamInit:
    """Draws parameters from one seeded generator, recording each one's
    logical axes (the reference's ``Param(value, logical_axes)``)."""

    def __init__(self, dtype: torch.dtype, device, seed: int = 0):
        self.dtype, self.device = dtype, torch.device(device)
        self.gen = (None if self.device.type == "meta"
                    else torch.Generator(device=self.device).manual_seed(seed))
        self.values: Dict[str, torch.Tensor] = {}
        self.axes: Dict[str, Axes] = {}

    def _put(self, name: str, v: torch.Tensor, axes: Axes) -> None:
        assert v.ndim == len(axes), (name, v.shape, axes)
        self.values[name] = torch.nn.Parameter(v, requires_grad=False)
        self.axes[name] = tuple(axes)

    def normal(self, name: str, shape, axes: Axes, scale: float = 0.02) -> None:
        v = torch.randn(shape, generator=self.gen, device=self.device, dtype=torch.float32)
        self._put(name, (scale * v).to(self.dtype), axes)

    def ones(self, name: str, shape, axes: Axes, dtype: Optional[torch.dtype] = None) -> None:
        self._put(name, torch.ones(shape, device=self.device, dtype=dtype or self.dtype), axes)

    def zeros(self, name: str, shape, axes: Axes, dtype: Optional[torch.dtype] = None) -> None:
        self._put(name, torch.zeros(shape, device=self.device, dtype=dtype or self.dtype), axes)

    def value(self, name: str, v: torch.Tensor, axes: Axes) -> None:
        """A parameter of given values (in their own dtype)."""
        self._put(name, v.to(self.device), axes)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * w


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., s, h, d]; positions: [..., s] (absolute token positions)."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=x.device) / d))
    ang = positions[..., :, None].float() * inv_freq  # [..., s, d/2]
    ang = ang[..., :, None, :]  # broadcast over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked attention (GQA-aware, causal / sliding-window), on local tensors
# ---------------------------------------------------------------------------
def _block_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """[qc, kc] additive mask in f32."""
    m = torch.zeros((qpos.shape[0], kpos.shape[0]), dtype=torch.float32, device=qpos.device)
    if causal:
        m = torch.where(qpos[:, None] >= kpos[None, :], m, NEG_INF)
    if window is not None:
        m = torch.where(qpos[:, None] - kpos[None, :] < window, m, NEG_INF)
    return m


def _mask_scores_(s: torch.Tensor, q0: int, k0: int, causal: bool,
                  window: Optional[int], k_valid: Optional[int] = None) -> None:
    """Add the ``_block_mask`` of rows ``q0 ..`` and columns ``k0 ..`` to
    scores ``s`` [..., c, n] in place, touching only the columns it
    changes: columns every row masks are set to ``NEG_INF`` (what adding
    it gives), the band where rows differ gets the mask itself, and the
    columns every row allows are left alone. ``k_valid`` masks keys at or
    past that position (padding) in every row."""
    c, n = s.shape[-2:]
    q1 = q0 + c - 1  # the last row's position
    hi = n if not causal else min(max(q1 + 1 - k0, 0), n)  # k > q1: masked in every row
    if k_valid is not None:
        hi = min(hi, max(k_valid - k0, 0))
    lo = 0 if window is None else min(max(q0 - window + 1 - k0, 0), hi)  # k <= q0 - w
    bands = []
    if causal:
        bands.append((max(q0 + 1 - k0, lo), hi))  # k in (q0, q1]: the diagonal
    if window is not None:
        bands.append((lo, min(q1 - window + 1 - k0, hi)))  # k in (q0 - w, q1 - w]
    bands = [(a, z) for a, z in bands if a < z]
    s[..., hi:] = NEG_INF
    s[..., :lo] = NEG_INF
    if bands:
        a, z = min(a for a, _ in bands), max(z for _, z in bands)
        qpos = q0 + torch.arange(c, device=s.device)
        kpos = k0 + a + torch.arange(z - a, device=s.device)
        s[..., a:z] += _block_mask(qpos, kpos, causal, window).to(s.dtype)


def _product_f32_into(a: torch.Tensor, b: torch.Tensor, alpha: float,
                      out: Optional[torch.Tensor]) -> torch.Tensor:
    if out is None:
        out = torch.empty((*a.shape[:-1], b.shape[-1]), dtype=torch.float32, device=a.device)
    if a.dtype == torch.float32 or (a.device.type == "cpu" and not is_fake(a)):
        # the CPU has no mixed-type product: upcast the operands (exact)
        return torch.baddbmm(out, a.float(), b.float(), beta=0, alpha=alpha, out=out)
    return torch.baddbmm(out, a, b, beta=0, alpha=alpha, out_dtype=torch.float32, out=out)


class _ProductF32(torch.autograd.Function):
    """``_product_f32`` with a backward: the two products of the f32
    gradient with the other operand, in f32 (JAX's transpose of a product
    with ``preferred_element_type=f32`` promotes the bf16 operand to f32),
    each rounded once to its operand's type."""

    @staticmethod
    def forward(ctx, a, b, alpha):
        ctx.save_for_backward(a, b)
        ctx.alpha = alpha
        return _product_f32_into(a, b, alpha, None)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().transpose(1, 2)).mul_(ctx.alpha).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), g).mul_(ctx.alpha).to(b.dtype)
        return ga, gb, None


def _product_f32(a: torch.Tensor, b: torch.Tensor, *, alpha: float = 1.0,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha * (a @ b)`` batched, stored in f32 whatever the operands'
    type: a bf16 product accumulates in f32 and is never rounded to bf16
    (the reference's ``preferred_element_type=jnp.float32``), with the
    scale in the product's epilogue. Under autograd (no ``out=``, which
    autograd refuses) it is ``_ProductF32``."""
    if out is None and torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _ProductF32.apply(a, b, alpha)
    return _product_f32_into(a, b, alpha, out)


def _chunk_call(fn, *args):
    """``fn(*args)`` for one q chunk; under autograd its activations are
    recomputed in backward instead of kept (the reference's
    ``jax.checkpoint`` of each q step), so the chunks' f32 scores, the full
    S x S per layer, never live at once."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                       for a in args):
        from torch.utils.checkpoint import checkpoint

        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _attend_chunk(qc: torch.Tensor, kt: torch.Tensor, vg: torch.Tensor, scale: float,
                  mask_args) -> torch.Tensor:
    """One q chunk against its keys. qc: [b, kh, g, c, d]; kt: [b, kh, d, n];
    vg: [b, kh, n, d]; ``mask_args`` go to ``_mask_scores_``. Returns
    [b, kh, g, c, d].

    ``scale * (q k^T)`` is one product into f32 scores, the mask is applied
    to them in place, then the f32 softmax, whose probabilities are rounded
    to V's type for the product with V (as the reference rounds p)."""
    b, kh, g, c, d = qc.shape
    n = kt.shape[-1]
    s = _product_f32(qc.reshape(b * kh, g * c, d), kt.reshape(b * kh, d, n), alpha=scale)
    _mask_scores_(s.view(b * kh, g, c, n), *mask_args)
    p = torch.softmax(s, dim=-1).to(vg.dtype)
    return torch.bmm(p, vg.reshape(b * kh, n, d)).view(b, kh, g, c, d)


def _grouped(x: torch.Tensor, kh: int) -> torch.Tensor:
    """[b, c, h, d] -> [b, kh, g, c, d]."""
    b, c, h, d = x.shape
    return x.reshape(b, c, kh, h // kh, d).permute(0, 2, 3, 1, 4)


def _ungrouped(o: torch.Tensor) -> torch.Tensor:
    """[b, kh, g, c, d] -> [b, c, h, d]."""
    b, kh, g, c, d = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(b, c, kh * g, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, q_chunk: int = 512,
                      walk=full_walk) -> torch.Tensor:
    """q: [b, sq, h, d]; k, v: [b, sk, kh, d]. Every q chunk meets every key
    (masked keys included), as the reference's two-level scan does, so the
    work is the reference's: 4·b·h·sq·sk·d FLOP."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    c = min(q_chunk, sq)
    nq = -(-sq // c)
    if nq * c != sq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nq * c - sq))
    scale = 1.0 / math.sqrt(d)
    kt = k.permute(0, 2, 3, 1).contiguous()  # [b, kh, d, sk]
    vg = v.permute(0, 2, 1, 3).contiguous()  # [b, kh, sk, d]
    out = q.new_empty(q.shape)
    for i, _ in walk(nq, "uniform"):
        # no name holds a chunk's output past its step: what a traced step
        # leaves alive stands for every untraced one (``StepCounter.walk``)
        out[:, i * c:(i + 1) * c] = _ungrouped(_chunk_call(
            _attend_chunk, _grouped(q[:, i * c:(i + 1) * c], kh), kt, vg, scale,
            (q_offset + i * c, 0, causal, window)))
    return out[:, :sq]


def chunked_attention_tri(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          window: Optional[int] = None, chunk: int = 512,
                          walk=full_walk) -> torch.Tensor:
    """Causal self-attention over the lower-triangular chunk pairs only: q
    chunk ``i`` meets key chunks ``ki <= i`` (and, with a window, ``i - ki <=
    ceil(window / chunk)``), the reference's static pair list, so fully
    masked blocks are never computed."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    c = min(chunk, s)
    n = -(-s // c)
    if n * c != s:
        pad = (0, 0, 0, 0, 0, n * c - s)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    scale = 1.0 / math.sqrt(d)
    kt = k.permute(0, 2, 3, 1).contiguous()
    vg = v.permute(0, 2, 1, 3).contiguous()
    w_chunks = None if window is None else (window + c - 1) // c
    out = q.new_empty(q.shape)
    # the keys a chunk meets grow by one chunk per step, so the work is
    # affine in the step (a window caps it, and then every step is traced)
    for i, _ in walk(n, "affine" if window is None else "all"):
        lo = 0 if w_chunks is None else max(0, i - w_chunks) * c
        hi = (i + 1) * c
        out[:, i * c:hi] = _ungrouped(_chunk_call(
            _attend_chunk, _grouped(q[:, i * c:hi], kh), kt[..., lo:hi], vg[:, :, lo:hi],
            scale, (i * c, lo, True, window, s)))
    return out[:, :s]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, start: int = 0, reduce=None) -> torch.Tensor:
    """Single-token attention over a cache. q: [b, 1, h, d]; k, v:
    [b, S, kh, d] (possibly partially filled); kv_len: [b] valid entries.
    Scores and softmax in f32, as the reference's. One product per KV head
    reads the cache in place (its layout keeps a head's rows strided, which
    a batched product over heads would copy).

    On a shard of the cache's sequence, ``k`` and ``v`` hold global
    positions ``start ..`` and ``reduce(x, op)`` combines ``x`` over the
    shards (``op`` is ``"max"`` or ``"sum"``): the softmax's max and sum and
    the output are reduced, and the cache stays where it is, as GSPMD
    partitions the reference's softmax over a sharded cache."""
    b, _, h, d = q.shape
    S, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, d)
    s = torch.empty(kh, b, g, S, dtype=torch.float32, device=q.device)
    for j in range(kh):
        _product_f32(qg[:, j], k[:, :, j].transpose(1, 2), alpha=1.0 / math.sqrt(d), out=s[j])
    valid = (start + torch.arange(S, device=q.device))[None, :] < kv_len[:, None]  # [b, S]
    s.masked_fill_(~valid[None, :, None, :], NEG_INF)
    if reduce is None:
        p = torch.softmax(s, dim=-1)
    else:
        p = torch.exp(s - reduce(s.amax(-1, keepdim=True), "max"))
        p = p / reduce(p.sum(-1, keepdim=True), "sum")
    p = p.to(v.dtype)
    o = torch.empty(kh, b, g, d, dtype=q.dtype if reduce is None else torch.float32,
                    device=q.device)
    for j in range(kh):
        if reduce is None:
            torch.bmm(p[j], v[:, :, j], out=o[j])
        else:
            _product_f32(p[j], v[:, :, j], out=o[j])
    if reduce is not None:
        o = reduce(o, "sum")
    return o.permute(1, 0, 2, 3).reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention on local shards of a sharded mesh
# ---------------------------------------------------------------------------
def _attn_placements(q, k, seq_local: bool = False):
    """Placements for q [b, s, h, d] and k/v/cache [b, S, kh, d] under which
    attention is local: the batch shards and q's head shards stay; k's head
    shards stay where they match q's; with ``seq_local``, k's sequence
    shards stay too (q is gathered over them); everything else (sequence,
    head_dim) is gathered."""
    from torch.distributed.tensor import Replicate, Shard

    qp, kp = [], []
    for a, c in zip(q.placements, k.placements):
        if a.is_shard(0) and c.is_shard(0):
            qp.append(Shard(0))
            kp.append(Shard(0))
        elif seq_local and c.is_shard(1):
            qp.append(Replicate())
            kp.append(Shard(1))
        elif a.is_shard(2):
            qp.append(Shard(2))
            kp.append(Shard(2) if c.is_shard(2) else Replicate())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    return tuple(qp), tuple(kp)


def _select_kv(k, v, q_off: int, h_l: int, g: int, kv_sharded: bool):
    """The KV heads this shard's q heads ``[q_off, q_off + h_l)`` read, from
    local k, v; returns (k, v) grouped so that ``h_l`` is a multiple of
    their head count."""
    if kv_sharded:
        return k, v
    lo = q_off // g
    if h_l % g == 0:
        return k[:, :, lo:lo + h_l // g], v[:, :, lo:lo + h_l // g]
    if g % h_l == 0:
        return k[:, :, lo:lo + 1], v[:, :, lo:lo + 1]
    idx = torch.div(q_off + torch.arange(h_l, device=k.device), g, rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def attend(ctx, fn, q, k, v, *vecs, seq_local: bool = False):
    """``fn(q, k, v, *vecs)`` on local shards when q is a DTensor (``vecs``
    are ``[b]`` tensors that follow the batch), else on the tensors as
    they are. With ``seq_local`` (decode over a cache) the cache keeps its
    sequence shards and ``fn`` also takes ``start`` (the shard's first
    position) and ``reduce`` (an all-reduce over the mesh dims that shard
    the sequence), as ``decode_attention`` does."""
    mesh = getattr(ctx, "mesh", None)
    from torch.distributed.tensor import DTensor

    if not is_sharded(mesh) or not isinstance(q, DTensor):
        return fn(q, k, v, *vecs)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard

    qp, kp = _attn_placements(q, k, seq_local)
    q_off, h_l = shard_offset(mesh, qp, q.shape[2], 2)
    g = q.shape[2] // k.shape[2]
    kv_sharded = any(p.is_shard(2) for p in kp)
    vp = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in qp)
    seq_dims = [i for i, p in enumerate(kp) if p.is_shard(1)]
    kw = {}
    if seq_dims:
        def reduce(x, op):
            for i in seq_dims:
                x = funcol.all_reduce(x, op, (mesh, i))
            return x

        kw = {"start": shard_offset(mesh, kp, k.shape[1], 1)[0], "reduce": reduce}

    def local(ql, kl, vl, *vl_):
        kl, vl = _select_kv(kl, vl, q_off, h_l, g, kv_sharded)
        return fn(ql, kl, vl, *vl_, **kw)

    return local_call(local, mesh, [(q, qp), (k, kp), (v, kp)] + [(x, vp) for x in vecs],
                      [qp])


# ---------------------------------------------------------------------------
# Attention block params + apply
# ---------------------------------------------------------------------------
def init_attention(init: ParamInit, prefix: str, cfg, lora_rank: int = 0,
                   stack: Tuple[int, ...] = (), stack_axes: Axes = ()) -> None:
    """Params for one attention block (optionally with LoRA adapter slots,
    which ``attention_block`` applies with ``use_lora``)."""
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    L, La = stack, stack_axes
    init.normal(f"{prefix}.wq", (*L, d, h, dh), (*La, "embed", "heads", "head_dim"))
    init.normal(f"{prefix}.wk", (*L, d, kh, dh), (*La, "embed", "kv_heads", "head_dim"))
    init.normal(f"{prefix}.wv", (*L, d, kh, dh), (*La, "embed", "kv_heads", "head_dim"))
    init.normal(f"{prefix}.wo", (*L, h, dh, d), (*La, "heads", "head_dim", "embed"))
    if cfg.qk_norm:
        init.ones(f"{prefix}.q_norm", (*L, dh), (*La, "head_dim"))
        init.ones(f"{prefix}.k_norm", (*L, dh), (*La, "head_dim"))
    if lora_rank:
        r = lora_rank
        for nm, (fi, fo, ax) in {
            "wq": (d, h * dh, "heads"),
            "wk": (d, kh * dh, "kv_heads"),
            "wv": (d, kh * dh, "kv_heads"),
            "wo": (h * dh, d, "embed"),
        }.items():
            init.normal(f"{prefix}.{nm}_lora_a", (*L, fi, r),
                        (*La, ax if nm == "wo" else "embed", "lora_rank"))
            init.zeros(f"{prefix}.{nm}_lora_b", (*L, r, fo),
                       (*La, "lora_rank", ax if nm != "wo" else "embed"))


def _cache_write(ctx, fn, cache, new, *vecs):
    """Run the in-place cache write ``fn(cache, new, *vecs)`` on local
    shards (``new`` and ``vecs`` are gathered over every mesh dim that
    shards the cache's sequence), or directly without a mesh."""
    mesh = getattr(ctx, "mesh", None)
    from torch.distributed.tensor import DTensor

    if not is_sharded(mesh) or not isinstance(cache, DTensor):
        return fn(None, cache, new, *vecs)
    from torch.distributed.tensor import Replicate, Shard

    cp = cache.placements
    npl = tuple(Replicate() if p.is_shard(1) else p for p in cp)
    vp = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in cp)
    start, _ = shard_offset(mesh, cp, cache.shape[1], 1)
    return local_call(lambda c, n, *v: fn(start, c, n, *v), mesh,
                      [(cache, cp), (new, npl)] + [(x, vp) for x in vecs], [cp])


def _insert_token(start, cache, new, slot):
    """Write one token ``new`` [b, 1, kh, d] at ``slot`` [b] of ``cache``
    [b, S, kh, d] in place. With ``start`` (a shard's first position) only
    the shard that owns the slot writes it."""
    b = cache.shape[0]
    bidx = torch.arange(b, device=cache.device)
    if start is None:
        cache[bidx, slot] = new[:, 0]
        return cache
    S_l = cache.shape[1]
    local = slot - start
    own = (local >= 0) & (local < S_l)
    idx = local.clamp(0, S_l - 1)
    cache[bidx, idx] = torch.where(own[:, None, None], new[:, 0], cache[bidx, idx])
    return cache


def _write_prompt(start, cache, new, S: int):
    """Write prompt keys ``new`` [b, s, kh, d] in place into ``cache``, the
    shard of a [b, S, kh, d] cache that begins at global position ``start``
    (``None``: the whole cache): position ``t`` at slot ``t`` when the prompt
    fits, else the last ``S`` keys at slot ``t % S`` (a sliding-window
    ring)."""
    start = start or 0
    s, S_l = new.shape[1], cache.shape[1]
    if s <= S:
        n = max(0, min(s - start, S_l))
        cache[:, :n] = new[:, start:start + n]
        return cache
    j = start + torch.arange(S_l, device=new.device)
    cache.copy_(new[:, (s - S) + (j - (s - S)) % S])
    return cache


def _sharded_on(w, dim: int) -> bool:
    """Whether ``w`` is a DTensor sharded on ``dim`` (negative from the end)."""
    from torch.distributed.tensor import DTensor

    return isinstance(w, DTensor) and any(p.is_shard(w.ndim + dim) for p in w.placements)


def gathered(w, dim: int):
    """``w`` with its shards of ``dim`` (the model width, ``embed``)
    gathered: a ZeRO-3 weight (``embed_rule=data``) is all-gathered before
    its use, as FSDP does and as GSPMD does for the reference, and its
    gradient reduce-scattered back. Left to itself DTensor can shard an
    attention product's (heads, head_dim) pair where a head count below the
    mesh dim cannot take it back, and (torch 2.11) asks backward to turn a
    shard into a partial sum, which it cannot."""
    from torch.distributed.tensor import DTensor, Replicate

    if not _sharded_on(w, dim):
        return w
    d = w.ndim + dim
    return w.redistribute(w.device_mesh,
                          [Replicate() if p.is_shard(d) else p for p in w.placements])


def rows_matmul(ctx, x: torch.Tensor, w: torch.Tensor, *more: torch.Tensor) -> torch.Tensor:
    """``cat([x, *more], -1) @ w`` for x [b, s, k] whose rows may be sharded
    over batch and sequence, which stay where they are (as GSPMD keeps
    them): on a mesh it runs on the local rows with ``w`` whole, since
    DTensor cannot multiply the flattened pair of batch and sequence shards
    (``more`` must be placed as ``x``; a last dim sharded is gathered)."""
    mesh = getattr(ctx, "mesh", None)
    from torch.distributed.tensor import DTensor

    if not (is_sharded(mesh) and isinstance(x, DTensor)):
        return (torch.cat([x, *more], dim=-1) if more else x) @ w
    from torch.distributed.tensor import Replicate

    xp = tuple(Replicate() if p.is_shard(x.ndim - 1) else p for p in x.placements)
    rep = (Replicate(),) * mesh.ndim
    return local_call(lambda w_, *xs: (torch.cat(xs, dim=-1) if len(xs) > 1 else xs[0]) @ w_,
                      mesh, [(w, rep)] + [(t, xp) for t in (x, *more)], [xp])


def _project_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [b, s, d] by w [d, h, k] -> [b, s, h, k]. einsum flattens the
    weight's (h, k) pair; DTensor cannot carry a shard of the trailing k
    through that flatten, so a head_dim-sharded weight is contracted as
    [d, k, h], its shard leading the pair."""
    w = gathered(w, -3)
    if _sharded_on(w, -1):
        return torch.einsum("bsd,dkh->bskh", x, w.transpose(-1, -2)).transpose(-1, -2)
    return torch.einsum("bsd,dhk->bshk", x, w)


def _project_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """o [b, s, h, k] by w [h, k, d] -> [b, s, d], contracting (h, k) as
    (k, h) when the weight is head_dim-sharded (see ``_project_in``)."""
    w = gathered(w, -1)
    if _sharded_on(w, -2):
        k, h = o.shape[-1], o.shape[-2]
        return (o.transpose(-1, -2).reshape(*o.shape[:-2], k * h)
                @ w.transpose(-2, -3).reshape(k * h, w.shape[-1]))
    return torch.einsum("bshk,hkd->bsd", o, w)


def _lora_delta(x: torch.Tensor, p, nm: str, use_lora: bool, like=None):
    """``(x @ a) @ b`` of the LoRA adapter pair ``{nm}_lora_a``/``_b`` in
    ``p`` (the reference's ``_proj_lora``), or ``None`` without one. On a
    mesh, ``b`` 's output columns take the shards of dim 2 of ``like`` (the
    projection the delta is added to: the MLP's hidden width), so each
    shard computes its own part of the delta only, as GSPMD places it."""
    if not use_lora or f"{nm}_lora_a" not in p:
        return None
    b = p[f"{nm}_lora_b"]
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(like, DTensor) and isinstance(b, DTensor):
        b = b.redistribute(b.device_mesh, [Shard(1) if q.is_shard(2) else r
                                           for q, r in zip(like.placements, b.placements)])
    return (x @ p[f"{nm}_lora_a"]) @ b


def _project_in_lora(x, p, nm: str, use_lora: bool):
    """``_project_in`` plus the LoRA delta ``(x @ a) @ b``, with ``b`` taken
    as [r, heads, head_dim] and, on a mesh, sharded as the projection is
    (its heads or its head_dim), so that the delta is contracted as the
    projection is and never flattens a sharded pair."""
    y = _project_in(x, p[nm])
    if not use_lora or f"{nm}_lora_a" not in p:
        return y
    b = p[f"{nm}_lora_b"]
    b = b.reshape(b.shape[0], y.shape[2], y.shape[3])
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(y, DTensor) and isinstance(b, DTensor):
        b = b.redistribute(b.device_mesh, [Shard(1) if q.is_shard(2) else
                                           Shard(2) if q.is_shard(3) else r
                                           for q, r in zip(y.placements, b.placements)])
    return y + _project_in(x @ p[f"{nm}_lora_a"], b)


def attention_block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg, *,
                    positions: torch.Tensor, causal: bool = True,
                    window: Optional[int] = None, cache=None,
                    constrain=lambda a, kind: a, use_lora: bool = False):
    """Returns (out [b, s, d], new_cache). ``cache`` (a layer's
    ``{"k", "v", "len"}``) is updated in place. ``use_lora`` adds the
    ``*_lora_a @ *_lora_b`` deltas of the four projections in ``p``."""
    b, s, _ = x.shape
    x = constrain(x, "hidden_in")
    q = _project_in_lora(x, p, "wq", use_lora)
    k = _project_in_lora(x, p, "wk", use_lora)
    v = _project_in_lora(x, p, "wv", use_lora)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if positions.ndim == 1:
        positions = positions[None, :].expand(b, s)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = constrain(q, "heads")
    k = constrain(k, "kv")
    v = constrain(v, "kv")
    walk = getattr(constrain, "walk", full_walk)

    new_cache = None
    if cache is None:
        if causal and getattr(constrain, "attn_impl", "chunked") == "tri":
            o = attend(constrain, lambda q_, k_, v_: chunked_attention_tri(
                q_, k_, v_, window=window, walk=walk), q, k, v)
        else:
            o = attend(constrain, lambda q_, k_, v_: chunked_attention(
                q_, k_, v_, causal=causal, window=window, walk=walk), q, k, v)
    else:
        kc, vc, ln = cache["k"], cache["v"], cache["len"]
        S = kc.shape[1]
        if s == 1:
            # single-token decode: insert then attend (SWA uses a ring buffer)
            if window is not None and S <= window:
                slot = ln % S
            else:
                slot = torch.clamp(ln, max=S - 1)
            kv_len = torch.clamp(ln + 1, max=S)
            sp = getattr(constrain, "sp_decode", None)
            if sp is not None:
                o, kc, vc = sp(q, k, v, kc, vc, slot, kv_len)
            else:
                kc = _cache_write(constrain, _insert_token, kc, k, slot)
                vc = _cache_write(constrain, _insert_token, vc, v, slot)
                o = attend(constrain, decode_attention, q, kc, vc, kv_len, seq_local=True)
            new_cache = {"k": kc, "v": vc, "len": ln + 1}
        else:
            # prefill: write the cache (ring-rotated when the SWA window is
            # shorter than the prompt) and attend over the full prompt
            kc = _cache_write(constrain, lambda st, c, n: _write_prompt(st, c, n, S), kc, k)
            vc = _cache_write(constrain, lambda st, c, n: _write_prompt(st, c, n, S), vc, v)
            o = attend(constrain, lambda q_, k_, v_: chunked_attention(
                q_, k_, v_, causal=causal, window=window, walk=walk), q, k, v)
            new_cache = {"k": kc, "v": vc, "len": ln + s}
    o = constrain(o, "heads")
    out = _project_out(o, p["wo"])
    if use_lora and "wo_lora_a" in p:
        # (o flattened over heads and head_dim) @ a: a head_dim-sharded o is
        # gathered first (DTensor cannot flatten the pair with its trailing
        # dim sharded, nor carry the gradient of a reordered ``a``)
        flat = gathered(o, -1).reshape(b, s, -1)
        out = out + (flat @ p["wo_lora_a"]) @ p["wo_lora_b"]
    return out, new_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def init_mlp(init: ParamInit, prefix: str, d: int, ff: int, lora_rank: int = 0,
             stack: Tuple[int, ...] = (), stack_axes: Axes = ()) -> None:
    L, La = stack, stack_axes
    init.normal(f"{prefix}.wi", (*L, d, ff), (*La, "embed", "ffn"))
    init.normal(f"{prefix}.wg", (*L, d, ff), (*La, "embed", "ffn"))
    init.normal(f"{prefix}.wo", (*L, ff, d), (*La, "ffn", "embed"))
    if lora_rank:
        r = lora_rank
        init.normal(f"{prefix}.wi_lora_a", (*L, d, r), (*La, "embed", "lora_rank"))
        init.zeros(f"{prefix}.wi_lora_b", (*L, r, ff), (*La, "lora_rank", "ffn"))
        init.normal(f"{prefix}.wo_lora_a", (*L, ff, r), (*La, "ffn", "lora_rank"))
        init.zeros(f"{prefix}.wo_lora_b", (*L, r, d), (*La, "lora_rank", "embed"))


def mlp_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
              constrain=lambda a, k: a, use_lora: bool = False) -> torch.Tensor:
    x = constrain(x, "hidden_in")
    hpre = x @ gathered(p["wi"], -2)
    delta = _lora_delta(x, p, "wi", use_lora, like=hpre)
    if delta is not None:
        hpre = hpre + delta
    hid = torch.nn.functional.silu(x @ gathered(p["wg"], -2)) * hpre
    hid = constrain(hid, "ffn")
    out = hid @ gathered(p["wo"], -1)
    delta = _lora_delta(hid, p, "wo", use_lora)
    return out if delta is None else out + delta
