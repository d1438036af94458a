"""Threefry-2x32 draws on the card (K4, ``csrc/threefry.cu``).

The CUDA counterpart of the plain draw in ``utils/rng.py``
(:func:`~wrf_partmc_tpu_torch.utils.rng.draw_plain`): one launch hashes
every element's counter under the key and writes the draw's 32 bits
(``"bits"``, int64 values below 2^32), its float32 uniform on
``[lo, lo + span)`` (``"uniform"``) or its float32 normal (``"normal"``),
bit for bit what the plain version gives.  A block draw hashes the global
indices of a rank's block, from ``rng.Block.kernel_args``; no index
tensor is built.  ``rng`` calls :func:`threefry_draw` for every draw on a
CUDA device, and the plain version for every draw on the CPU.
"""

from __future__ import annotations

import math

import torch

from . import _cuda

MODES = {"bits": 0, "uniform": 1, "normal": 2}
MAX_ELEMENTS = 2**32 - 1     # the kernel's 32-bit element index


def threefry_draw(mode: str, key, shape, device, lo: float = 0.0, span: float = 1.0,
                  block: tuple | None = None) -> torch.Tensor:
    """Launch K4 on ``device``'s current stream: a draw of ``shape`` under
    ``key`` (a pair of uint32 ints) in ``mode``; ``lo``/``span`` are the
    float32 range of ``"uniform"`` and ``"normal"``; ``block`` is
    ``(ny, nx, iy0, ix0, ny_l, nx_l, trail)`` for a rank's block of a
    global draw, None for a flat draw."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"threefry_draw: needs a CUDA device, got {device}")
    if mode not in MODES:
        raise ValueError(f"threefry_draw: mode {mode!r} is none of {sorted(MODES)}")
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n > MAX_ELEMENTS:
        raise ValueError(f"threefry_draw: a draw of {n} elements; the kernel takes fewer "
                         "than 2^32")
    if not torch.cuda.is_available():
        raise RuntimeError("threefry_draw: no CUDA device is available")
    dtype = torch.int64 if mode == "bits" else torch.float32
    out = torch.empty(shape, dtype=dtype, device=device)
    blk = (0,) * 7 if block is None else tuple(int(v) for v in block)
    err = _cuda.lib().wpt_threefry_draw(
        out.data_ptr(), n, int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF, MODES[mode],
        float(lo), float(span), int(block is not None), *blk, _cuda.stream_ptr(device))
    _cuda.check(err, "threefry_draw")
    threefry_draw.launches += 1
    threefry_draw.shapes.add((mode, shape, float(lo), float(span),
                              None if block is None else blk))
    return out


# launches: kernel launches; shapes: (mode, shape, lo, span, block
# arguments) of each, so a check can repeat them.  Both are read and reset
# by their caller.
threefry_draw.launches = 0
threefry_draw.shapes = set()
