"""Kernel correctness gate: run a candidate tile against its ``ref.py`` oracle.

Counterpart of ``repro/kernels/conformance.py``. Every kernel-cell
candidate the DSE evaluates or measures passes through
:func:`check_candidate` before it may enter a leaderboard: the kernel runs
with the candidate's tile sizes on deterministic inputs (the Hopper kernel
on a card, its plain version on the CPU), and its output is compared
element-wise with the torch oracle in ``kernels.ref``, on the same device.
The oracle is the yardstick only; it never supplies a candidate's output.
A fast-but-wrong tile becomes a ``status="infeasible"`` row.

Tolerances are the reference's: absolute max-|error| per (kernel, dtype).
Those are loose enough for the oracle's different order of operations and
precision; a kernel against its own plain version (same tiles, same f32
arithmetic, one rounding at the end) is held much tighter, row by row, by
:func:`agree_with_plain`. ``ssd_scan`` returns ``(y, final_state)`` and
both halves are checked.

Fault-injection hook: ``REPRO_KERNEL_INJECT_BAD`` holds
``<kernel>:<dim>=<value>`` (e.g. ``vecmul:block=1024``); a candidate of that
kernel whose point sets that dim to that value gets +0.1 added to its
output, so a run can show the gate rejects a broken variant end to end.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.kernel_space import KernelShape
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm_plain
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.kernels.vecmul import vecmul_plain

#: absolute max-|error| threshold per (kernel, dtype)
TOLERANCES: Dict[Tuple[str, str], float] = {
    ("vecmul", "float32"): 1e-6,
    ("vecmul", "bfloat16"): 1e-2,
    ("rmsnorm", "float32"): 1e-5,
    ("rmsnorm", "bfloat16"): 3e-2,
    ("flash_attention", "float32"): 2e-3,
    ("flash_attention", "bfloat16"): 3e-2,
    ("ssd_scan", "float32"): 3e-3,
    ("ssd_scan", "bfloat16"): 5e-2,
}

#: a kernel against its plain version: each output row's max |error| at
#: most this share of the row's largest |plain| value. Both compute in f32
#: and round once, so in bf16 they differ by at most one unit in the last
#: place of an element (2**-7 of it at worst); in f32 only the order of
#: the sums differs.
PLAIN_REL: Dict[torch.dtype, float] = {torch.float32: 2.0 ** -14,
                                       torch.bfloat16: 2.0 ** -7}

INJECT_ENV = "REPRO_KERNEL_INJECT_BAD"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: a kernel's output: one tensor, or ssd_scan's (y, final_state)
Output = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def tolerance(kernel: str, dtype: str) -> float:
    """The gate threshold for one (kernel, dtype) pair."""
    return TOLERANCES[(kernel, dtype)]


def make_inputs(shape: KernelShape, seed: int = 0,
                device: torch.device | str = "cpu") -> Tuple[torch.Tensor, ...]:
    """Deterministic inputs for one kernel shape: the reference's numpy
    draws (same generator, same order, same 0.3 scale), as tensors of the
    shape's dtype on ``device``."""
    rng = np.random.default_rng(seed)
    dt = _DTYPES[shape.dtype]
    p = shape.params

    def to(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(a).to(device=device).to(dtype)

    def arr(*dims):
        return to(0.3 * rng.standard_normal(dims), dt)

    if shape.kernel == "vecmul":
        return arr(p["L"]), arr(p["L"])
    if shape.kernel == "rmsnorm":
        return arr(p["rows"], p["d"]), arr(p["d"])
    if shape.kernel == "flash_attention":
        return (arr(p["b"], p["sq"], p["h"], p["d"]),
                arr(p["b"], p["sk"], p["kh"], p["d"]),
                arr(p["b"], p["sk"], p["kh"], p["d"]))
    if shape.kernel == "ssd_scan":
        x = arr(p["b"], p["s"], p["nh"], p["dh"])
        dt_ = to(0.1 + 0.2 * rng.random((p["b"], p["s"], p["nh"])), dt)
        A = to(-(0.5 + rng.random(p["nh"])), torch.float32)
        B = arr(p["b"], p["s"], p["N"])
        C = arr(p["b"], p["s"], p["N"])
        return x, dt_, A, B, C
    raise KeyError(f"unknown kernel {shape.kernel!r}")


def _parse_inject_spec(spec: str) -> Optional[Tuple[str, str, Any]]:
    """``kernel:dim=value`` -> (kernel, dim, typed value); None if malformed."""
    try:
        kernel, assign = spec.split(":", 1)
        dim, raw = assign.split("=", 1)
    except ValueError:
        return None
    raw = raw.strip()
    if raw.lower() in ("true", "false"):
        val: Any = raw.lower() == "true"
    else:
        try:
            val = int(raw)
        except ValueError:
            val = raw
    return kernel.strip(), dim.strip(), val


def _maybe_inject_bad(kernel: str, dims: Mapping[str, Any], out: torch.Tensor):
    """Apply the REPRO_KERNEL_INJECT_BAD perturbation if this candidate
    matches the spec (test hook, inert unless the variable is set)."""
    spec = os.environ.get(INJECT_ENV)
    if not spec:
        return out
    parsed = _parse_inject_spec(spec)
    if parsed is None:
        return out
    want_kernel, dim, val = parsed
    if kernel != want_kernel or dims.get(dim) != val:
        return out
    return out + torch.tensor(0.1, dtype=out.dtype, device=out.device)


def run_candidate(shape: KernelShape, dims: Mapping[str, Any],
                  inputs: Tuple[torch.Tensor, ...]) -> Output:
    """Run the kernel with the candidate's tile dims on ``inputs``' device
    (the Hopper kernel for CUDA tensors, the plain version for CPU ones).
    For ssd_scan, the ``(y, final_state)`` pair with any injection applied
    to ``y`` only, as in the reference."""
    if shape.kernel == "vecmul":
        out = ops.vecmul(*inputs, block=int(dims["block"]))
    elif shape.kernel == "rmsnorm":
        out = ops.rmsnorm(*inputs, block_rows=int(dims["block_rows"]))
    elif shape.kernel == "flash_attention":
        out = ops.flash_attention(*inputs, causal=bool(dims["causal"]),
                                  block_q=int(dims["block_q"]),
                                  block_k=int(dims["block_k"]))
    elif shape.kernel == "ssd_scan":
        y, state = ops.ssd_scan(*inputs, chunk=int(dims["chunk"]))
        return _maybe_inject_bad(shape.kernel, dims, y), state
    else:
        raise KeyError(f"unknown kernel {shape.kernel!r}")
    return _maybe_inject_bad(shape.kernel, dims, out)


def run_plain(shape: KernelShape, dims: Mapping[str, Any],
              inputs: Tuple[torch.Tensor, ...]) -> Output:
    """The kernel's plain torch version with the candidate's tile dims, on
    ``inputs``' device: what a kernel is held against on the card."""
    if shape.kernel == "vecmul":
        return vecmul_plain(*inputs, block=int(dims["block"]))
    if shape.kernel == "rmsnorm":
        return rmsnorm_plain(*inputs, block_rows=int(dims["block_rows"]))
    if shape.kernel == "flash_attention":
        return flash_attention_plain(*inputs, causal=bool(dims["causal"]),
                                     block_q=int(dims["block_q"]),
                                     block_k=int(dims["block_k"]))
    if shape.kernel == "ssd_scan":
        return ssd_scan_plain(*inputs, chunk=int(dims["chunk"]))
    raise KeyError(f"unknown kernel {shape.kernel!r}")


def agree_with_plain(got: Output, want: Output) -> Dict[str, Any]:
    """Hold a kernel's output against its plain version's, row by row over
    the last axis (vecmul element by element; ssd_scan's y over dh and its
    final state over N): a row's max |got - want| may be at most
    ``PLAIN_REL[dtype]`` times the row's largest |want|, the dtype being
    that output's own.

    Returns ``max_abs_err``; ``ratio``, the worst row's error over its
    limit (at most 1 to pass); ``limit``, that row's limit; ``mean_abs``,
    the mean |want| (the typical output value) of the part with the worst
    row; and ``passed``.
    """
    if isinstance(want, tuple):
        parts = [agree_with_plain(g, w) for g, w in zip(got, want)]
        worst = max(parts, key=lambda r: (math.isnan(r["ratio"]), r["ratio"]))
        return {**worst, "max_abs_err": max(r["max_abs_err"] for r in parts),
                "passed": all(r["passed"] for r in parts)}
    g, w = got.float(), want.float()
    if w.numel() == 0:
        return {"max_abs_err": 0.0, "ratio": 0.0, "limit": 0.0,
                "mean_abs": 0.0, "passed": True}
    cols = w.shape[-1] if w.dim() > 1 else 1
    err = (g - w).abs().reshape(-1, cols).amax(dim=-1)
    limit = PLAIN_REL[want.dtype] * w.abs().reshape(-1, cols).amax(dim=-1)
    # a row that is 0 in the plain version must be 0 in the kernel too;
    # a NaN anywhere makes its row's ratio NaN and fails
    ratio = torch.where(err == 0, torch.zeros_like(err), err / limit)
    worst = int(torch.nan_to_num(ratio, nan=math.inf).argmax())
    r = float(ratio[worst])
    return {"max_abs_err": float(err.max()), "ratio": r,
            "limit": float(limit[worst]), "mean_abs": float(w.abs().mean()),
            "passed": r <= 1.0}


def reference_key(shape: KernelShape, dims: Mapping[str, Any]) -> Tuple:
    """The tile dims the oracle's answer depends on: ``causal`` for
    attention, none for the others. Candidates with the same key share
    one oracle run on the same inputs."""
    if shape.kernel == "flash_attention":
        return (bool(dims["causal"]),)
    return ()


def run_reference(shape: KernelShape, dims: Mapping[str, Any],
                  inputs: Tuple[torch.Tensor, ...]) -> Output:
    """The oracle on the same inputs (GQA K/V heads repeated up to the
    query head count; causal flag threaded through for attention)."""
    if shape.kernel == "vecmul":
        return ref.vecmul_ref(*inputs)
    if shape.kernel == "rmsnorm":
        return ref.rmsnorm_ref(*inputs)
    if shape.kernel == "flash_attention":
        q, k, v = inputs
        g = q.shape[2] // k.shape[2]
        if g > 1:
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)
        return ref.attention_ref(q, k, v, causal=bool(dims["causal"]))
    if shape.kernel == "ssd_scan":
        return ref.ssd_ref(*inputs)
    raise KeyError(f"unknown kernel {shape.kernel!r}")


def max_abs_error(got: Output, want: Output) -> float:
    """Max element-wise |got - want| in float32, tuple-aware (ssd_scan's
    y and final state must both match)."""
    if isinstance(got, tuple) or isinstance(want, tuple):
        return max(max_abs_error(g, w) for g, w in zip(got, want))
    if got.numel() == 0:
        return 0.0
    return float((got.float() - want.float()).abs().max().item())


def check_candidate(shape: KernelShape, dims: Mapping[str, Any], *,
                    inputs: Optional[Tuple[torch.Tensor, ...]] = None,
                    want: Optional[Output] = None,
                    seed: int = 0,
                    device: torch.device | str = "cpu") -> Dict[str, Any]:
    """The correctness gate: run candidate and oracle, compare.

    Returns ``{"max_abs_err", "tol", "passed"}``; callers turn a failed
    check into a ``status="infeasible"`` DataPoint. Without ``inputs``
    they are made on ``device``; ``want``, the oracle's answer on these
    inputs for this candidate's :func:`reference_key`, is computed here
    unless the caller already has it.
    """
    if inputs is None:
        inputs = make_inputs(shape, seed=seed, device=device)
    got = run_candidate(shape, dims, inputs)
    if want is None:
        want = run_reference(shape, dims, inputs)
    err = max_abs_error(got, want)
    tol = tolerance(shape.kernel, shape.dtype)
    return {"max_abs_err": err, "tol": tol, "passed": bool(err <= tol)}
