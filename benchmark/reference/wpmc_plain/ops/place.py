"""Row placement primitives, plain PyTorch: the port's ``ops/place.py``
with the placement kernels (K2, K3) taken out, so every device runs
``scatter_rows_plain`` / ``gather_rows_plain``.  Payload layout [B, CH, L]:
batch (cell), channel, slot.

* ``scatter_rows(x, dst, L2)``: out[b, :, dst[b, i]] = x[b, :, i]
  (dst == -1, or any dst outside [0, L2), drops the row; dst unique per
  batch; unwritten slots zero).
* ``gather_rows(x, src)``:      out[b, :, o] = x[b, :, src[b, o]]
  (src == -1, or any src outside [0, L1), yields a zero row; duplicate
  sources allowed).
"""

from __future__ import annotations

import torch



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


scatter_rows = scatter_rows_plain
gather_rows = gather_rows_plain
