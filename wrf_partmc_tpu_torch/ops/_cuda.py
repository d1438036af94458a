"""Build and bind the port's hand-written CUDA kernels.

The sources in ``wrf_partmc_tpu_torch/csrc/*.cu`` expose a plain C
interface and are compiled at first use, with one ``nvcc`` per source for
``sm_90a``, all running at once, and linked into one shared library under
``build/kernels/`` at the root of the checkout (git-ignored); the library
is bound with ``ctypes``.  The file name carries
a hash of the sources, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "wpt_thomas_fields_f32": [_P, _P, _P, _P, _P],
    "wpt_empty_kernel": [_P],
    "wpt_scatter_rows_f32": [_P, _P, _P, _LL, _I, _I, _I, _P],
    "wpt_gather_rows_f32": [_P, _P, _P, _LL, _I, _I, _I, _P],
    "wpt_threefry_draw": [_P, _LL, _LL, _LL, _I, _F, _F, _I, *[_LL] * 7, _P],
    "wpt_mie_fit_bulk": [*[_P] * 6, _LL, _I, _I, *[_F] * 10, _I, _P],
    "wpt_move_ranks": [*[_P] * 12, _LL, *[_I] * 11, _P],
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a host "
                       "with the CUDA toolkit")


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one shared library (once per source
    hash) and return its path.  Each source is compiled by its own ``nvcc``
    process, all started together, and the objects are linked at the end."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for s in sources:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libwpt_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{s.stem}.o" for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for s, o in zip(sources, objs)]
        logs = [p.communicate() for p in procs]
        failed = [(s.name, p.returncode, err) for s, p, (_, err) in zip(sources, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{err}" for name, rc, err in failed))
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                               "-o", str(lib_tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(lib_tmp, out)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0, cached=False,
                      ptxas="".join(err for _, err in logs))
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
