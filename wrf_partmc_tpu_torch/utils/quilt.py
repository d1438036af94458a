"""Async file writer: the port's binding of ``native/quilt.cc``.

The runner hands each serialized output file (history, particle state,
restart) to a pool of native threads and goes back to stepping, as WRF's
quilt servers take writes off the compute ranks.  The library is built with
``g++`` at first use into ``build/quilt/`` at the root of the checkout
(git-ignored), under a name that carries a hash of the source, so an edited
source is rebuilt.  A failed build raises: the port never falls back to
writing synchronously on its own.  A caller who wants synchronous writes
passes ``writer=None`` to the writers of :mod:`.io`.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import io
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "quilt.cc"
BUILD_DIR = _ROOT / "build" / "quilt"

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile ``native/quilt.cc`` into ``build/quilt/`` (once per source
    hash) and return the library's path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"libquilt-{digest}.so"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-pthread", "-o", tmp,
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE} failed:\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded library, its thread pool started (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            cdll.quilt_start.argtypes = [ctypes.c_int]
            cdll.quilt_start.restype = ctypes.c_int
            cdll.quilt_submit.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
            cdll.quilt_submit.restype = ctypes.c_int
            cdll.quilt_pending.argtypes = []
            cdll.quilt_pending.restype = ctypes.c_int64
            cdll.quilt_flush.argtypes = []
            cdll.quilt_flush.restype = ctypes.c_int
            cdll.quilt_stop.argtypes = []
            cdll.quilt_stop.restype = None
            cdll.quilt_start(2)
            atexit.register(cdll.quilt_stop)         # join the workers at exit
            _lib = cdll
        return _lib


class QuiltWriter:
    """Async file writer; a context manager that flushes on exit."""

    def __init__(self):
        self.lib = lib()

    def submit_bytes(self, path: str, data: bytes) -> None:
        rc = self.lib.quilt_submit(str(path).encode(), data, len(data))
        if rc != 0:
            raise RuntimeError(f"quilt_submit failed rc={rc}")

    def submit_npz(self, path: str, save_fn) -> None:
        """Serialize with ``save_fn(file_like)`` in memory, write async."""
        buf = io.BytesIO()
        save_fn(buf)
        self.submit_bytes(path, buf.getvalue())

    def pending(self) -> int:
        return int(self.lib.quilt_pending())

    def flush(self) -> None:
        """Wait for every queued write; raise if any failed."""
        errors = int(self.lib.quilt_flush())
        if errors:
            raise OSError(f"{errors} quilted write(s) failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()
        return False
