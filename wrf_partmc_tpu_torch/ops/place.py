"""Row placement primitives: every particle scatter/gather of the port.

Port of ``wrf_partmc_tpu/ops/place.py`` (public ``scatter_rows`` /
``gather_rows`` and the Pallas kernels ``_scatter_kernel`` /
``_gather_kernel``).  Payload layout [B, CH, L]: batch (cell), channel,
slot.

* ``scatter_rows(x, dst, L2)``: out[b, :, dst[b, i]] = x[b, :, i]
  (dst == -1, or any dst outside [0, L2), drops the row; dst unique per
  batch; unwritten slots zero).
* ``gather_rows(x, src)``:      out[b, :, o] = x[b, :, src[b, o]]
  (src == -1, or any src outside [0, L1), yields a zero row; duplicate
  sources allowed).

On indices in [-1, L) both match the JAX package's ``*_ref`` exactly.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel (``csrc/place.cu``), which copies bit for bit.  The
TPU's bf16x3 one-hot MXU path has no counterpart here: on Hopper these are
indexed copies, bound by device memory, that build the scatter's output
tile and hold the gather's input tile in shared memory, so device memory
sees one coalesced pass on each side (see the note in ``csrc/place.cu``).
The scatter's kernel writes every output slot, zeros included, so its
output is allocated uninitialised.
"""

from __future__ import annotations

import torch

from . import _cuda


def scatter_rows_plain(x, dst, L2: int):
    """Reference scatter with ``index_put_``: dropped rows (dst outside
    [0, L2)) land in a spare slot L2 that is cut off."""
    B, CH, L1 = x.shape
    out = x.new_zeros((B, L2 + 1, CH))
    d = torch.where((dst >= 0) & (dst < L2), dst, L2).long()
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, L1)
    out.index_put_((bidx, d), x.transpose(1, 2))
    return out[:, :L2].transpose(1, 2).contiguous()


def gather_rows_plain(x, src):
    """Reference gather with ``torch.gather``; src outside [0, L1) gives
    zeros."""
    B, CH, L1 = x.shape
    L2 = src.shape[1]
    s = src.clamp(0, L1 - 1).long()[:, None, :].expand(B, CH, L2)
    rows = torch.gather(x, 2, s)
    valid = (src >= 0) & (src < L1)
    return torch.where(valid[:, None, :], rows, torch.zeros((), dtype=x.dtype, device=x.device))


def _check(name, x, idx, idx_len):
    if not (x.is_cuda and idx.device == x.device):
        raise ValueError(f"{name}: payload and index must be on one CUDA device")
    if x.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"{name}: needs float32 payload and int32 index, got "
                         f"{x.dtype} / {idx.dtype}")
    if x.dim() != 3 or idx.dim() != 2 or idx.shape[0] != x.shape[0] \
            or idx.shape[1] != idx_len:
        raise ValueError(f"{name}: bad shapes {tuple(x.shape)} / "
                         f"{tuple(idx.shape)}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: payload and index must be contiguous")
    # the kernel's 1-D grid holds at most one block per cell
    if x.shape[0] > 2**31 - 1:
        raise ValueError(f"{name}: {x.shape[0]} cells exceed the launch grid "
                         "(2^31 - 1 blocks)")


def scatter_rows_cuda(x, dst, L2: int):
    """Launch the CUDA row scatter (K2) on the current stream."""
    _check("scatter_rows", x, dst, x.shape[2])
    B, CH, L1 = x.shape
    out = torch.empty((B, CH, L2), dtype=torch.float32, device=x.device)
    err = _cuda.lib().wpt_scatter_rows_f32(
        x.data_ptr(), dst.data_ptr(), out.data_ptr(), B, CH, L1, L2,
        _cuda.stream_ptr(x.device))
    _cuda.check(err, "scatter_rows")
    scatter_rows_cuda.launches += 1
    scatter_rows_cuda.shapes.add((tuple(x.shape), L2))
    return out


def gather_rows_cuda(x, src):
    """Launch the CUDA row gather (K3) on the current stream."""
    _check("gather_rows", x, src, src.shape[1])
    B, CH, L1 = x.shape
    L2 = src.shape[1]
    out = torch.empty((B, CH, L2), dtype=torch.float32, device=x.device)
    err = _cuda.lib().wpt_gather_rows_f32(
        x.data_ptr(), src.data_ptr(), out.data_ptr(), B, CH, L1, L2,
        _cuda.stream_ptr(x.device))
    _cuda.check(err, "gather_rows")
    gather_rows_cuda.launches += 1
    gather_rows_cuda.shapes.add((tuple(x.shape), L2))
    return out


# launches: kernel launches; shapes: (payload shape, output slots) of each,
# so a check can repeat them.  Both are read and reset by their caller.
scatter_rows_cuda.launches = 0
scatter_rows_cuda.shapes = set()
gather_rows_cuda.launches = 0
gather_rows_cuda.shapes = set()


def scatter_rows(x, dst, L2: int):
    """out[b, :, dst[b, i]] = x[b, :, i]; dst outside [0, L2) drops the row."""
    if x.is_cuda:
        return scatter_rows_cuda(x, dst, L2)
    return scatter_rows_plain(x, dst, L2)


def gather_rows(x, src):
    """out[b, :, o] = x[b, :, src[b, o]]; src outside [0, L1) yields a zero row."""
    if x.is_cuda:
        return gather_rows_cuda(x, src)
    return gather_rows_plain(x, src)
