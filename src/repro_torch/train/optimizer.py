"""AdamW with optional ZeRO-1 sharded optimizer state and f32 master weights.

Counterpart of ``repro/train/optimizer.py``. The optimizer state is a
dict of the params' keys (``{"m", "v", "step"}``, and ``"master"``), so it
checkpoints and reshards with the same machinery as the params. Moments
may be stored in int8 with per-row scales over the last dim (8-bit Adam).
ZeRO-1: ``opt_specs`` shards m and v (and master weights) over the data
mesh dims on the largest tensor dim that is divisible and not already
sharded, so gradients meet them by reduce-scatter instead of all-reduce.

``adamw_update`` updates the state's tensors in place (the reference
donates them) and returns them. On plain tensors it walks each leaf in
blocks of its leading dim, so its f32 temporaries hold one block at a
time, not a whole stacked leaf; every per-element value, and every
per-row int8 scale, is the same as a whole-leaf update's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

#: f32 temporaries of ``adamw_update`` hold at most this many elements per
#: block of a plain leaf's leading dim (one layer of a stacked leaf)
BLOCK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


# ---------------------------------------------------------------------------
# int8 moment quantization (8-bit Adam): per-row scales over the last dim,
# so the quantized moments keep exactly the param's sharding
# ---------------------------------------------------------------------------
def _q8(x: torch.Tensor):
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return (q.float() * scale).reshape(shape)


def lr_schedule(c: AdamWConfig, step) -> torch.Tensor:
    """Warmup then cosine decay to ``min_lr_frac``, in f32 (a 0-d tensor on
    ``step`` 's device)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    step = torch.as_tensor(step, device=dev).float()
    warm = torch.clamp(step / max(c.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return c.lr * warm * (c.min_lr_frac + (1 - c.min_lr_frac) * cos)


def init_opt_state(params: Dict[str, torch.Tensor], *, master_weights: bool = False,
                   int8_moments: bool = False) -> Dict[str, Any]:
    """Zero moments (f32, or int8 with their scales) and step 0, on each
    param's device (``meta`` params give a meta state)."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if int8_moments:
        def zq(p):
            q, s = _q8(zeros32(p))
            return {"q": q, "s": s}

        mk = zq
    else:
        mk = zeros32
    dev = next(iter(params.values())).device
    st = {"m": {k: mk(p) for k, p in params.items()},
          "v": {k: mk(p) for k, p in params.items()},
          "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if master_weights:
        st["master"] = {k: p.float() for k, p in params.items()}
    return st


def _is_q(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def uses_int8(opt_state) -> bool:
    return any(_is_q(m) for m in opt_state["m"].values())


def _blocks(t: torch.Tensor):
    """Slices of ``t`` 's leading dim, each of at most ``BLOCK_ELEMS``
    elements (whole rows of the last dim, so per-row scales stay whole); a
    DTensor or a vector is one block, ``None`` (see ``_at``)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor) or t.ndim < 2 or t.numel() <= BLOCK_ELEMS:
        return [None]
    per = max(1, BLOCK_ELEMS // max(t[0].numel(), 1))
    return [slice(i, i + per) for i in range(0, t.shape[0], per)]


def _at(t: torch.Tensor, sl) -> torch.Tensor:
    """Block ``sl`` of ``t`` (``None``: all of it)."""
    return t if sl is None else t[sl]


def _placed(x: torch.Tensor, like) -> torch.Tensor:
    """``x`` redistributed to ``like`` 's placements (DTensors), else ``x``."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and isinstance(like, DTensor) and x.placements != like.placements:
        return x.redistribute(like.device_mesh, like.placements)
    return x


def grad_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of g^2 over every element of every leaf + 1e-16), in f32."""
    total = None
    for g in grads.values():
        for sl in _blocks(g):
            gb = _at(g, sl).float()
            part = (gb * gb).sum()
            total = part if total is None else total + part
    return torch.sqrt(total + 1e-16)


@torch.no_grad()
def adamw_update(c: AdamWConfig, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], opt_state: Dict[str, Any]):
    """One AdamW step, all math in f32, with the global grad-norm clip.
    Updates ``params`` and ``opt_state`` in place and returns ``(params,
    opt_state, {"grad_norm", "lr"})``. Gradients may come in any placement:
    each one is redistributed to its moments' placements (ZeRO-1: a
    reduce-scatter of a partial sum) before the update, which runs where
    the moments live; the new params are then placed as the params."""
    int8 = uses_int8(opt_state)
    step = opt_state["step"] + 1
    lr = lr_schedule(c, step)
    target = {k: (m["q"] if int8 else m) for k, m in opt_state["m"].items()}
    grads = {k: _placed(g, target[k]) for k, g in grads.items()}
    gnorm = grad_norm(grads)
    scale = torch.clamp(c.grad_clip / gnorm, max=1.0)
    stepf = step.float()
    b1c = 1 - c.b1 ** stepf
    b2c = 1 - c.b2 ** stepf
    master = opt_state.get("master")

    for k, p in params.items():
        g, m, v = grads[k], opt_state["m"][k], opt_state["v"][k]
        base = master[k] if master is not None else p
        for sl in _blocks(p):
            g32 = _at(g, sl).float() * scale
            if int8:
                m32 = _dq8(_at(m["q"], sl), _at(m["s"], sl), g32.shape)
                v32 = _dq8(_at(v["q"], sl), _at(v["s"], sl), g32.shape)
            else:
                m32, v32 = _at(m, sl), _at(v, sl)
            m32 = c.b1 * m32 + (1 - c.b1) * g32
            v32 = c.b2 * v32 + (1 - c.b2) * g32 * g32
            mh, vh = m32 / b1c, v32 / b2c
            p32 = _placed(_at(base, sl), target[k]).float()
            p32 = p32 - lr * (mh / (torch.sqrt(vh) + c.eps) + c.weight_decay * p32)
            if int8:
                for mom, new in ((m, m32), (v, v32)):
                    q, s = _q8(new)
                    _at(mom["q"], sl).copy_(q)
                    _at(mom["s"], sl).copy_(s)
            else:
                _at(m, sl).copy_(m32)
                _at(v, sl).copy_(v32)
            if master is not None:
                _at(master[k], sl).copy_(_placed(p32, master[k]))
            _at(p, sl).copy_(_placed(p32, p).to(p.dtype))
    opt_state["step"].copy_(step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# ZeRO-1 sharding of the optimizer state, as DTensor placements
# ---------------------------------------------------------------------------
def opt_specs(mesh, param_placements: Dict[str, tuple], params: Dict[str, Any], *,
              zero1: bool, master: bool, int8: bool = False) -> Dict[str, Any]:
    """Placements for the optimizer state, given the params' placements.

    ZeRO-1 puts ``Shard(i)`` on every data mesh dim (``pod`` and ``data``,
    pod-major, as the reference's ``("pod", "data")``) for the largest
    tensor dim ``i`` that no mesh dim shards and that the data dims'
    product divides; a param the data dims already shard (FSDP) keeps its
    placements. int8 moments keep the param's placements; their scale
    tensor (size 1 in the last dim) drops the last dim's shards."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    data_dims = [names.index(a) for a in ("pod", "data") if a in names]
    dsize = math.prod(mesh.size(i) for i in data_dims)
    scalar = tuple(Replicate() for _ in names)

    if int8:
        def qspec(pl, p):
            last = p.ndim - 1
            return {"q": pl, "s": tuple(Replicate() if x.is_shard(last) else x for x in pl)}

        mv = {k: qspec(param_placements[k], p) for k, p in params.items()}
        st = {"m": mv, "v": mv, "step": scalar}
        if master:
            st["master"] = dict(param_placements)
        return st

    def zero_shard(pl, leaf):
        if not zero1 or not data_dims:
            return pl
        if any(pl[i].is_shard() for i in data_dims):
            return pl  # param sharding already consumes the data axis (FSDP)
        used = {x.dim for x in pl if x.is_shard()}
        for i in sorted(range(leaf.ndim), key=lambda i: -leaf.shape[i]):
            if i not in used and leaf.shape[i] % dsize == 0 and leaf.shape[i] >= dsize:
                out = list(pl)
                for d in data_dims:
                    out[d] = Shard(i)
                return tuple(out)
        return pl

    mv = {k: zero_shard(param_placements[k], p) for k, p in params.items()}
    st = {"m": mv, "v": mv, "step": scalar}
    if master:
        st["master"] = mv
    return st
