"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` into an object file, all
``nvcc`` processes started together, and the objects are linked into one
shared library with a plain C interface. The library lands in
``kernels/build/`` (listed in ``.gitignore``) under a name that hashes the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. The first call that launches a kernel builds; importing
this module builds nothing, so the CPU tests import it without ``nvcc``.

Each C entry point takes device pointers and the stream as ``void*`` and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero result into
an exception.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

#: dtype codes shared with csrc/common.cuh
DTYPE_CODES: Dict[torch.dtype, int] = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

#: argtypes of every C entry point; ctypes would cut a pointer to 32 bits
#: without them
SIGNATURES = {
    "vecmul_launch": [_P, _P, _P, _LL, _I, _I, _I, _P],
    "rmsnorm_launch": [_P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _F, _I, _I, _I, _P],
    "flash_attention_wgmma_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _F, _I, _I, _P],
    "flash_attention_wgmma_attributes": [_I, _I, _I, _P, _P],
    "ssd_scan_launch": [_P] * 10 + [_I] * 13 + [_P],
    "ssd_scan_wgmma_launch": [_P] * 9 + [_I] * 8 + [_P],
    "ssd_scan_wgmma_attributes": [_I, _I, _I, _P, _P],
}

#: launches per kernel, and per kernel and route under "<kernel>/<route>":
#: each CUDA wrapper adds one where it launches its
#: kernel, and nowhere else (``ops.launch_counts`` reads it)
LAUNCHES: collections.Counter = collections.Counter()

_LIB: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when the library was already built)
BUILD_SECONDS = 0.0


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``. Raises if none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def fingerprint() -> str:
    """A hash of the kernel sources, headers and flags: it names the built
    library, and evaluation records taken on the card carry it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link them into one ``.so``;
    returns its path. A no-op when the library for these sources exists."""
    global BUILD_SECONDS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"librepro_kernels_{fingerprint()}.so"
    if lib.exists():
        BUILD_SECONDS = 0.0
        return lib
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = lib.with_suffix(f".{tag}.tmp")
    r = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                        *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{r.stdout}{r.stderr}")
    tmp.replace(lib)  # atomic: a concurrent loader never sees half a file
    BUILD_SECONDS = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry
    point's ``argtypes`` and ``restype`` declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the pointer the C side takes."""
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def dtype_code(t: torch.Tensor) -> int:
    """The C side's code for ``t``'s dtype; raises for a type the kernels
    do not take."""
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}") \
            from None
