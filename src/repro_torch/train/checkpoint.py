"""Numpy checkpointing with atomic manifest commit.

Counterpart of ``repro/train/checkpoint.py``, with the same layout:

    <dir>/step_00000100/
        manifest.json      # step, extra, and per leaf: path, file, shape, dtype
        arr_00000.npy ...  # one file per leaf (full logical tensors)
        COMMIT             # written last: a checkpoint without it is ignored

A leaf's ``path`` is its key path in the state joined with ``/`` (a
param's dotted key split at its dots), as the reference names it, so each
package reads the other's checkpoints. numpy has no bfloat16, so a bf16
leaf is stored as its raw 16-bit words (``uint16``) with ``"bfloat16"`` as
the manifest's dtype, and restored bit for bit. Writes go to a temporary
directory committed by one atomic rename, so a crash mid-write never
corrupts the latest checkpoint; ``latest_step`` returns only committed
ones.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.ioutil import write_json_atomic


def _flatten(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs of a nested dict, in key order; dotted keys split."""
    out = []
    for k, v in tree.items():
        path = prefix + "/".join(str(k).split("."))
        if isinstance(v, dict):
            out.extend(_flatten(v, path + "/"))
        else:
            out.append((path, v))
    return out


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(ckpt_dir: str | Path, step: int, state, *,
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        manifest = {"step": step, "time": time.time(), "extra": extra or {}, "leaves": []}
        for i, (p, leaf) in enumerate(_flatten(state)):
            arr, dtype = _to_numpy(leaf)
            fname = f"arr_{i:05d}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append({"path": p, "file": fname,
                                       "shape": list(arr.shape), "dtype": dtype})
        # atomic even inside the staging dir: a reader racing the final
        # os.replace never parses a torn manifest
        write_json_atomic(tmp / "manifest.json", manifest)
        (tmp / "COMMIT").write_text(str(step))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic on POSIX
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
             if d.name.startswith("step_") and (d / "COMMIT").exists()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str | Path, like_state, *, step: Optional[int] = None,
                       device=None) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore into the structure of ``like_state`` (each leaf in its
    dtype, on ``device`` or the like leaf's device); returns ``(state,
    step, extra)``."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_path = {rec["path"]: rec for rec in manifest["leaves"]}

    def walk(like, prefix):
        out = {}
        for k, v in like.items():
            path = prefix + "/".join(str(k).split("."))
            if isinstance(v, dict):
                out[k] = walk(v, path + "/")
                continue
            rec = by_path.get(path)
            if rec is None:
                raise KeyError(f"checkpoint missing leaf {path!r}")
            t = _from_numpy(np.load(d / rec["file"]), rec["dtype"])
            if tuple(t.shape) != tuple(v.shape):
                raise ValueError(f"{path}: shape {tuple(t.shape)} != expected {tuple(v.shape)}")
            # a copy in torch's own (aligned) memory: CPU products may round
            # differently on the buffer numpy loaded into
            out[k] = t.to(device=device or v.device, dtype=v.dtype, copy=True)
        return out

    return walk(like_state, ""), step, manifest.get("extra", {})
