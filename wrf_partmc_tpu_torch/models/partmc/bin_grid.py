"""Logarithmic diameter bin grid for the diagnostics.

Port of ``wrf_partmc_tpu/models/partmc/bin_grid.py`` (PartMC's
``bin_grid_make(BIN_GRID_TYPE_LOG, 100, 1d-9, 1d-3)``).  The reference bins
with a one-hot [..., P, B] contraction (an MXU idiom); at the runner's
width that one-hot would be 8.2 GB of float32, so the port sums each
particle's weight into its bin with ``scatter_add_``.  The sums then run in
another order than the reference's einsum (the diagnostics' tests state
the tolerance), and on CUDA they use float atomics, so a bin may differ in
the last ulp from run to run: acceptable for a diagnostic, and used for
nothing that feeds the model state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class BinGrid:
    edges: torch.Tensor      # [B+1] diameters [m], log-spaced
    centers: torch.Tensor    # [B]
    n_bin: int = 0

    @property
    def log_width(self) -> torch.Tensor:
        """d(ln D) per bin (constant on a log grid)."""
        return torch.log(self.edges[1] / self.edges[0])


def make_bin_grid(n_bin: int, d_min: float, d_max: float, device="cpu") -> BinGrid:
    """Edges 10**linspace(log10 d_min, log10 d_max, n_bin + 1) in float32,
    centers their geometric means."""
    lin = torch.linspace(math.log10(d_min), math.log10(d_max), n_bin + 1,
                         dtype=torch.float32, device=device)
    edges = torch.pow(10.0, lin)
    return BinGrid(edges=edges, centers=torch.sqrt(edges[:-1] * edges[1:]), n_bin=n_bin)


def bin_index(bg: BinGrid, diam) -> torch.Tensor:
    """int64 bin of each diameter (closed form on the log grid).  Values
    outside the grid go to the end bins; a zero diameter (a dead slot) to
    bin 0, and NaN to bin 0 as the reference's float-to-int conversion
    gives it."""
    i = torch.floor(torch.log(diam / bg.edges[0]) / bg.log_width)
    i = torch.where(torch.isnan(i), 0.0, i)
    return torch.clamp(i, 0, bg.n_bin - 1).to(torch.int64)


def histogram(bg: BinGrid, diam, weight) -> torch.Tensor:
    """Weighted histogram over the particle axis: diam, weight [..., P] ->
    [..., B] (a density per unit ln D once divided by ``log_width``, which
    callers do)."""
    out = torch.zeros((*weight.shape[:-1], bg.n_bin), dtype=weight.dtype,
                      device=weight.device)
    return out.scatter_add_(-1, bin_index(bg, diam), weight)
