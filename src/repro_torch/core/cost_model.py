"""Learned surrogate cost model: a small MLP over plan/tile features,
LoRA-fine-tuned on the cost DB.

Counterpart of ``repro/core/cost_model.py``. It predicts (log10 bound,
feasibility) from design + workload features so a strategy can pre-rank
candidates before paying for an evaluation: a tanh MLP with ``HIDDEN =
(64, 64)``, a log10-bound head and a sigmoid feasibility head, trained by
plain full-batch gradient descent. The base is pre-trained once
(:meth:`CostModel.pretrain`); later adaptation trains low-rank adapters
on the frozen base (:meth:`CostModel.finetune_lora`, ``core/lora.py``),
as §3.2.2 says.

State carries across packages: :meth:`CostModel.from_numpy` takes the
reference's parameters as numpy arrays (``w0, b0, w1, b1, w_out, b_out``,
weights laid out [in, out]), after which both packages predict and rank
the same way. ``lora`` takes adapters the same way (``lora.lora_from_numpy``). The
model is tiny and runs on the CPU.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import lora as lora_mod
from repro_torch.core.cost_db import CostDB, featurize

HIDDEN = (64, 64)


def mlp_forward(params: Mapping[str, torch.Tensor],
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    h = x
    for i in range(len(HIDDEN)):
        h = torch.tanh(h @ params[f"w{i}"] + params[f"b{i}"])
    out = h @ params["w_out"] + params["b_out"]
    return out[..., 0], torch.sigmoid(out[..., 1])  # (log10 bound, p_feasible)


def _loss(pred, pf, y, feas):
    reg = torch.mean((pred - y) ** 2 * feas) * (feas.sum() / torch.clamp(feas.sum(), min=1))
    bce = -torch.mean(feas * torch.log(pf + 1e-6) + (1 - feas) * torch.log(1 - pf + 1e-6))
    return reg + bce


class CostModel(nn.Module):
    """The surrogate MLP; parameters keep the reference's names and layout."""

    def __init__(self, in_dim: int, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.in_dim = in_dim
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v.detach().to(torch.float32).clone())
             for k, v in params.items()})
        self.trained = False
        self.lora: Optional[lora_mod.Adapters] = None

    @classmethod
    def create(cls, in_dim: int, seed: int = 0) -> "CostModel":
        """Fresh weights from a ``torch.Generator`` seeded with ``seed``
        (the reference draws from ``jax.random``, so the numbers differ;
        :meth:`from_numpy` carries the reference's over)."""
        gen = torch.Generator().manual_seed(seed)
        dims = (in_dim,) + HIDDEN
        params: Dict[str, torch.Tensor] = {}
        for i, (di, do) in enumerate(zip(dims[:-1], dims[1:])):
            params[f"w{i}"] = torch.randn(di, do, generator=gen) / math.sqrt(di)
            params[f"b{i}"] = torch.zeros(do)
        params["w_out"] = torch.randn(HIDDEN[-1], 2, generator=gen) * 0.1
        params["b_out"] = torch.zeros(2)
        return cls(in_dim, params)

    @classmethod
    def from_numpy(cls, params: Mapping[str, np.ndarray]) -> "CostModel":
        """A model holding ``params`` (numpy arrays, the reference's names)."""
        t = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in params.items()}
        return cls(int(t["w0"].shape[0]), t)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in self.params.items()}

    def _effective(self) -> Dict[str, torch.Tensor]:
        if self.lora is None:
            return dict(self.params)
        return lora_mod.apply_lora(dict(self.params), self.lora)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return mlp_forward(self._effective(), x)

    def predict(self, feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        x = torch.as_tensor(np.asarray(feats, np.float32))
        if x.dim() == 1:
            x = x[None]
        with torch.no_grad():
            b, pf = self(x)
        return b.numpy(), pf.numpy()

    def pretrain(self, db: CostDB, steps: int = 300, lr: float = 1e-2,
                 split: Optional[str] = "train") -> float:
        """Full-parameter fit by full-batch gradient descent on the DB's
        ``train`` split (``split=None`` uses every row); returns the final
        loss, or nan with fewer than 4 rows."""
        X, y, feas = db.training_set(split=split)
        if X.shape[0] < 4:
            return float("nan")
        Xt, yt, ft = (torch.from_numpy(a) for a in (X, y, feas))
        params = list(self.params.values())
        for _ in range(steps):
            loss = _loss(*mlp_forward(self.params, Xt), yt, ft)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, g in zip(params, grads):
                    p -= lr * g
        self.trained = True
        with torch.no_grad():
            return float(_loss(*mlp_forward(self.params, Xt), yt, ft))

    def finetune_lora(self, db: CostDB, rank: int = 4, steps: int = 200,
                      lr: float = 5e-3, seed: int = 1,
                      split: Optional[str] = "train") -> float:
        """LoRA adaptation: base frozen, adapters trained by full-batch
        gradient descent on the grown DB (``train`` split by default;
        ``val`` stays held out for the gate). The adapters are made on the
        first call, from a ``torch.Generator`` seeded with ``seed``, and
        kept after it. Returns the final loss, or nan with fewer than 4
        rows."""
        X, y, feas = db.training_set(split=split)
        if X.shape[0] < 4:
            return float("nan")
        if self.lora is None:
            self.lora = lora_mod.init_lora(dict(self.params),
                                           torch.Generator().manual_seed(seed), rank)
        Xt, yt, ft = (torch.from_numpy(a) for a in (X, y, feas))
        base = {k: v.detach() for k, v in self.params.items()}
        leaves = [t for ad in self.lora.values() if ad is not None for t in ad.values()]

        def loss_of():
            return _loss(*mlp_forward(lora_mod.apply_lora(base, self.lora), Xt), yt, ft)

        for _ in range(steps):
            for t in leaves:
                t.requires_grad_(True)
            grads = torch.autograd.grad(loss_of(), leaves)
            with torch.no_grad():
                for t, g in zip(leaves, grads):
                    t -= lr * g
        for t in leaves:
            t.requires_grad_(False)
        with torch.no_grad():
            return float(loss_of())

    def validation_error(self, db: CostDB, *, arch: Optional[str] = None,
                         shape: Optional[str] = None,
                         mesh: Optional[str] = None) -> Tuple[float, int]:
        """(RMSE in log10-bound decades, n rows) on the held-out ``val``
        split, feasible rows only. ``arch``/``shape``/``mesh`` restrict to
        one cell's rows (the surrogate gate's per-cell guard). (nan, 0)
        when there is no such row: the gate reads that as uncalibrated."""
        X, y, feas = db.training_set(split="val", arch=arch, shape=shape,
                                     mesh=mesh)
        mask = feas > 0.5
        if not mask.any():
            return float("nan"), 0
        pred, _ = self.predict(X[mask])
        rmse = float(np.sqrt(np.mean((pred - y[mask]) ** 2)))
        return rmse, int(mask.sum())

    def measured_calibration(self, db: CostDB, *, arch: Optional[str] = None,
                             shape: Optional[str] = None,
                             mesh: Optional[str] = None,
                             ) -> Tuple[float, int, float]:
        """Prediction against the measured tier's times: ``(rmse, n,
        offset)``. ``offset`` is the mean of ``log10(measured_s) -
        predicted`` (launch overhead and the model's absolute error are a
        constant scale the ladder does not care about), and ``rmse`` the
        spread of the residual around it, in decades. (nan, 0, nan) with no
        usable measured row or an untrained model."""
        if not self.trained:
            return float("nan"), 0, float("nan")
        feats, actual = [], []
        for d in db.measured_rows(arch, shape, mesh=mesh):
            ms = d.metrics.get("measured_s")
            if d.status != "ok" or not ms or ms <= 0:
                continue
            feats.append(featurize(d.point, d.metrics["workload"]))
            actual.append(np.log10(ms))
        if not feats:
            return float("nan"), 0, float("nan")
        pred, _ = self.predict(np.stack(feats))
        resid = np.asarray(actual) - pred
        offset = float(np.mean(resid))
        rmse = float(np.sqrt(np.mean((resid - offset) ** 2)))
        return rmse, len(feats), offset

    def rank_candidates(self, feats: np.ndarray) -> np.ndarray:
        """Indices sorted by predicted bound, infeasible-penalised."""
        b, pf = self.predict(feats)
        score = b + 2.0 * (1.0 - pf)  # infeasible ~ +2 decades
        return np.argsort(score)
