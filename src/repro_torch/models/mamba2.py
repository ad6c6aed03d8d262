"""Mamba2 (SSD: state-space duality) blocks in torch math.

Counterpart of ``repro/models/mamba2.py``. Training and prefill run the
chunked SSD algorithm (the intra-chunk quadratic term, each chunk's local
state, the inter-chunk recurrence walked chunk by chunk through
``constrain.walk``, and the inter-chunk term); a one-token decode runs the
O(1) recurrent update. The arithmetic is the reference's: the decays, the
state and the SSD's products in f32, the mask inside the exponent (``exp``
of ``where``, so no masked entry overflows and backward sees no NaN).

On a sharded mesh the block's core (the convolution, the SSD and the
gate) runs on local shards (``sharding.plan.local_call``): the projection
is gathered over every mesh dim but the batch's, each shard takes the
heads its ``A_log`` shard holds, and the gated output leaves sharded over
those heads, so the output norm and the row-parallel ``out_proj`` follow
as DTensor ops.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import ParamInit
from repro_torch.sharding.plan import full_walk, is_sharded, local_call, shard_offset


def init_mamba_layer(init: ParamInit, prefix: str, cfg, stack=(), stack_axes=()) -> None:
    d = cfg.d_model
    s = cfg.ssm
    di, N, nh = s.d_inner(d), s.d_state, s.n_heads(d)
    Ls, La = tuple(stack), tuple(stack_axes)
    init.ones(f"{prefix}.ln", (*Ls, d), (*La, "embed"))
    # in_proj -> [z(di), x(di), B(N), C(N), dt(nh)]
    init.normal(f"{prefix}.in_proj", (*Ls, d, 2 * di + 2 * N + nh), (*La, "embed", "ssm_inner"))
    init.normal(f"{prefix}.conv_w", (*Ls, s.conv_width, di + 2 * N), (*La, "conv", "ssm_inner"),
                scale=0.1)
    init.zeros(f"{prefix}.conv_b", (*Ls, di + 2 * N), (*La, "ssm_inner"))
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=init.device))
    init.value(f"{prefix}.A_log", a_log.expand(*Ls, nh).clone(), (*La, "ssm_heads"))
    init.ones(f"{prefix}.D", (*Ls, nh), (*La, "ssm_heads"), dtype=torch.float32)
    init.zeros(f"{prefix}.dt_bias", (*Ls, nh), (*La, "ssm_heads"), dtype=torch.float32)
    init.ones(f"{prefix}.out_norm", (*Ls, di), (*La, "ssm_inner"))
    init.normal(f"{prefix}.out_proj", (*Ls, di, d), (*La, "ssm_inner", "embed"))


def _causal_conv(xBC, w, b, state=None):
    """Depthwise causal conv, width W. state: [b, W-1, ch] carry for decode.
    Returns (silu(conv + b), new carry: the last W-1 inputs)."""
    W = w.shape[0]
    if state is None:
        pad = torch.nn.functional.pad(xBC, (0, 0, W - 1, 0))
    else:
        pad = torch.cat([state.to(xBC.dtype), xBC], dim=1)
    s = xBC.shape[1]
    out = sum(pad[:, i:i + s] * w[i] for i in range(W))
    new_state = pad[:, -(W - 1):] if s >= 1 else state
    return torch.nn.functional.silu(out + b), new_state


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None, walk=full_walk):
    """SSD over a full sequence.

    x: [b, s, nh, dh]; dt: [b, s, nh] (post-softplus); A: [nh] (negative);
    B, C: [b, s, N]. Returns (y [b, s, nh, dh] in x's dtype, final state
    [b, nh, dh, N] in f32). The inter-chunk recurrence is a loop over the
    chunks run by ``walk`` (the reference's ``lax.scan``)."""
    b, s, nh, dh = x.shape
    N = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    T = x.shape[1]
    nc, Lc = T // chunk, chunk
    xc = x.reshape(b, nc, Lc, nh, dh)
    dtc = dt.reshape(b, nc, Lc, nh).float()
    Bc = B.reshape(b, nc, Lc, N).float()
    Cc = C.reshape(b, nc, Lc, N).float()

    dA = dtc * A[None, None, None, :]  # [b,nc,L,nh], negative
    cs = torch.cumsum(dA, dim=2)  # within-chunk cumulative decay

    # --- intra-chunk (quadratic within the chunk), laid out [b,nc,nh,L,S]
    # so that its product with x reads it in place ---
    cst = cs.transpose(2, 3)  # [b,nc,nh,L]
    diff = cst[..., :, None] - cst[..., None, :]  # [b,nc,nh,L,S]
    causal = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)[:, :, None]  # [b,nc,1,L,S]
    if torch.is_grad_enabled() and diff.requires_grad:
        # mask inside the exponent: exp of masked (l<s) entries would overflow
        att = CB * torch.exp(torch.where(causal, diff, -torch.inf))
    else:  # the same arithmetic in place: one [b,nc,nh,L,S] buffer
        att = diff.masked_fill_(~causal, -torch.inf).exp_().mul_(CB)
    del diff
    xf = xc.float()
    xdt = xf * dtc[..., None]  # [b,nc,L,nh,dh]
    y_intra = (att @ xdt.transpose(2, 3)).transpose(2, 3)  # [b,nc,L,nh,dh]
    del att

    # --- per-chunk local final state ---
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)  # [b,nc,L,nh]
    S_loc = torch.einsum("bclhp,bcln->bchpn", (dtc * decay_end)[..., None] * xf, Bc)
    chunk_decay = torch.exp(cs[:, :, -1, :])  # [b,nc,nh]

    # --- inter-chunk recurrence: S_prevs[c] is the state entering chunk c ---
    S = (torch.zeros((b, nh, dh, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    S_prevs = torch.empty((b, nc, nh, dh, N), dtype=torch.float32, device=x.device)
    for c, _ in walk(nc, "uniform"):
        S_prevs[:, c] = S
        S = S * chunk_decay[:, c, :, None, None] + S_loc[:, c]

    # --- inter-chunk contribution ---
    decay_in = torch.exp(cs)  # decay from chunk start to position l
    y_inter = torch.einsum("bcln,bchpn->bclhp", Cc, S_prevs) * decay_in[..., None]

    y = (y_intra + y_inter).reshape(b, T, nh, dh)[:, :s]
    return y.to(x.dtype), S


def _core(proj, conv_w, conv_b, A_log, D, dt_bias, conv_state, ssm_state, *, cfg,
          h0: int, nh_l: int, walk):
    """The block between ``in_proj`` and ``out_norm`` for heads ``h0 ..
    h0 + nh_l`` (all of them without a mesh): the causal conv over those
    heads' x channels and B, C; the SSD (chunked, or recurrent for a
    one-token step with a state); the skip ``D``; and the gate ``silu(z)``.
    ``A_log``, ``D`` and ``dt_bias`` hold those heads only; the rest is
    whole. Returns (gated y [b, s, nh_l * dh] in ``proj``'s dtype, the new
    conv carry over every channel or ``None``, the new state or the final
    state [b, nh_l, dh, N] f32)."""
    s_cfg = cfg.ssm
    d = cfg.d_model
    di, N, nh, dh = s_cfg.d_inner(d), s_cfg.d_state, s_cfg.n_heads(d), s_cfg.head_dim
    W = s_cfg.conv_width
    lo, hi = h0 * dh, (h0 + nh_l) * dh
    z = proj[..., lo:hi]
    xBC_all = proj[..., di:2 * di + 2 * N]
    dt = proj[..., 2 * di + 2 * N + h0:2 * di + 2 * N + h0 + nh_l]
    if nh_l == nh:
        xBC, new_conv = _causal_conv(xBC_all, conv_w, conv_b, conv_state)
    else:
        def sel(t):  # this shard's x channels, then B and C
            return torch.cat([t[..., lo:hi], t[..., di:]], dim=-1)

        xBC, _ = _causal_conv(sel(xBC_all), sel(conv_w), sel(conv_b),
                              None if conv_state is None else sel(conv_state))
        new_conv = None
        if conv_state is not None:
            new_conv = torch.cat([conv_state.to(proj.dtype), xBC_all], dim=1)[:, -(W - 1):]
    di_l = hi - lo
    xi, Bm, Cm = torch.split(xBC, [di_l, N, N], dim=-1)

    A = -torch.exp(A_log)  # [nh_l]
    dt = torch.nn.functional.softplus(dt.float() + dt_bias)  # [b,s,nh_l]
    xh = xi.reshape(*xi.shape[:2], nh_l, dh)

    if ssm_state is None or proj.shape[1] > 1:
        y, S_final = ssd_chunked(xh, dt, A, Bm, Cm, s_cfg.chunk, ssm_state, walk)
    else:
        # recurrent decode: h = h * exp(dt A) + dt * x ⊗ B ; y = C · h
        h = ssm_state.float()  # [b,nh,dh,N]
        dt1 = dt[:, 0]  # [b,nh]
        dA = torch.exp(dt1 * A[None, :])
        xb = (dt1[..., None] * xh[:, 0].float())[..., None] * Bm[:, 0, None, None, :]
        h = h * dA[..., None, None] + xb
        y = torch.einsum("bhpn,bn->bhp", h, Cm[:, 0].float())[:, None]
        S_final = h

    y = y + D[None, None, :, None] * xh.float()
    y = y.reshape(*y.shape[:2], di_l).to(proj.dtype)
    return y * torch.nn.functional.silu(z), new_conv, S_final


def _core_call(constrain, proj, p, cfg, conv_state, ssm_state):
    """``_core`` over every head, or on local shards on a sharded mesh (see
    the module docstring). Returns DTensors there: y sharded over the heads'
    mesh dims (and the batch's), the conv carry over the batch's, the state
    over both."""
    mesh = getattr(constrain, "mesh", None)
    walk = getattr(constrain, "walk", full_walk)
    nh = cfg.ssm.n_heads(cfg.d_model)
    from torch.distributed.tensor import DTensor

    def run(h0, nh_l):
        return lambda *a: _core(*a, cfg=cfg, h0=h0, nh_l=nh_l, walk=walk)

    args = [proj, p["conv_w"], p["conv_b"], p["A_log"], p["D"], p["dt_bias"],
            conv_state, ssm_state]
    if not (is_sharded(mesh) and isinstance(proj, DTensor)):
        return run(0, nh)(*args)
    from torch.distributed.tensor import Replicate, Shard

    bp = tuple(Shard(0) if q.is_shard(0) else Replicate() for q in proj.placements)
    a_pl = (p["A_log"].placements if isinstance(p["A_log"], DTensor)
            else (Replicate(),) * mesh.ndim)
    heads = [q.is_shard(0) and not b.is_shard(0) for q, b in zip(a_pl, bp)]
    hp = tuple(Shard(0) if h else Replicate() for h in heads)
    h0, nh_l = shard_offset(mesh, hp, nh, 0)
    rep = (Replicate(),) * mesh.ndim
    yp = tuple(Shard(2) if h else q for h, q in zip(heads, bp))
    sp = tuple(Shard(1) if h else q for h, q in zip(heads, bp))
    placed = [(proj, bp), (p["conv_w"], rep), (p["conv_b"], rep), (p["A_log"], hp),
              (p["D"], hp), (p["dt_bias"], hp), (conv_state, bp), (ssm_state, sp)]
    if conv_state is None:
        return local_call(lambda *a: run(h0, nh_l)(*a)[0], mesh, placed, [yp]), None, None
    return local_call(run(h0, nh_l), mesh, placed, [yp, bp, sp])


def _assign(dst, src) -> None:
    """Write ``src`` into the cache view ``dst`` in place (placed as ``dst``
    first on a mesh)."""
    from torch.distributed.tensor import DTensor

    if isinstance(dst, DTensor) and isinstance(src, DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def mamba_block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                constrain=lambda a, k: a):
    """One Mamba2 block. cache: a layer's ``{"conv": [b, W-1, di+2N],
    "ssm": [b, nh, dh, N]}``, updated in place. Returns (out, cache)."""
    xin = constrain(L.rmsnorm(x, p["ln"], cfg.norm_eps), "hidden_in")
    proj = xin @ L.gathered(p["in_proj"], -2)
    y, new_conv, new_ssm = _core_call(
        constrain, proj, p, cfg, None if cache is None else cache["conv"],
        None if cache is None else cache["ssm"])
    y = L.rmsnorm(y, p["out_norm"], cfg.norm_eps)
    out = y @ L.gathered(p["out_proj"], -1)
    if cache is not None:
        _assign(cache["conv"], new_conv)
        _assign(cache["ssm"], new_ssm)
    return constrain(x + constrain(out, "hidden"), "hidden"), cache


def init_mamba_cache(cfg, batch_size: int, dtype: torch.dtype, device="cpu",
                     stack=()) -> Dict[str, torch.Tensor]:
    """The conv carry in the model's dtype and the SSM state in f32 (the
    reference's), with ``stack`` leading dims (layers)."""
    s = cfg.ssm
    d = cfg.d_model
    di, N, nh, dh = s.d_inner(d), s.d_state, s.n_heads(d), s.head_dim
    Ls = tuple(stack)
    return {
        "conv": torch.zeros((*Ls, batch_size, s.conv_width - 1, di + 2 * N), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((*Ls, batch_size, nh, dh, N), dtype=torch.float32, device=device),
    }
