"""Out-of-place counterparts of jax's ``x.at[..., i].add/set`` along one axis.

Both return a new tensor (``torch.select_scatter``) and leave ``t`` as it
was, so no state a caller still holds is changed.  Neither builds an index
tensor, so neither copies from the host.
"""

from __future__ import annotations

import torch


def add_at(t: torch.Tensor, i: int, val, dim: int = -1) -> torch.Tensor:
    """``t.at[..., i, ...].add(val)`` with ``i`` on axis ``dim``."""
    d = dim % t.dim()
    return torch.select_scatter(t, (t.select(d, i) + val).to(t.dtype), d, i)


def set_at(t: torch.Tensor, i: int, val, dim: int = -1) -> torch.Tensor:
    """``t.at[..., i, ...].set(val)`` with ``i`` on axis ``dim``."""
    d = dim % t.dim()
    row = t.select(d, i)
    if isinstance(val, torch.Tensor):
        row = torch.broadcast_to(val.to(t.dtype), row.shape)
    else:
        row = torch.full_like(row, val)
    return torch.select_scatter(t, row, d, i)
