"""The lateral-boundary pieces of a decomposed rank that need no exchange,
on every block of a (2, 2) and a (1, 4) mesh of a 12x10 grid, in this
process (a ``Mesh`` with no process group: nothing here sends): the
wrfbdy zone weights and the specified + relaxation blend on a block grid
(``bdy.zone_weights``, ``bdy.edge_sections``) equal the whole domain's,
cut to the block, bit for bit, including a relaxation zone that is wider
than a block (7 points over blocks of 5 rows and of 3 columns), and the
open-boundary outflow drop takes the global indices of the block's cells.
The whole-domain blend is held against the JAX package in
tests/test_torch_open_bc.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wrf_partmc_tpu_torch.config import BoundaryConfig
from wrf_partmc_tpu_torch.entry import make_config
from wrf_partmc_tpu_torch.grid import block_grid, make_grid
from wrf_partmc_tpu_torch.models.coupled import bdy
from wrf_partmc_tpu_torch.models.coupled.transport import open_boundary_drop
from wrf_partmc_tpu_torch.models.dycore.ideal import init_uniform
from wrf_partmc_tpu_torch.parallel.mesh import Mesh, block_of
from wrf_partmc_tpu_torch.utils.tree import tree_map

NX, NY = 12, 10


def _cfg(spec, relax):
    b = BoundaryConfig(periodic_x=False, periodic_y=False, open_xs=True, open_xe=True,
                       open_ys=True, open_ye=True, spec_zone=spec, relax_zone=relax)
    return make_config(NX, NY, 4, 4, 8).replace(n_class=8, boundary=b)


def _states(cfg, grid, n=2):
    r = np.random.default_rng(11)
    base = init_uniform(cfg, grid, 5.0, 2.0)
    f = lambda a: torch.tensor(r.normal(0.0, 1.0, tuple(a.shape)).astype(np.float32))
    return [dataclasses.replace(base, **{k: f(getattr(base, k)) for k in
                                         ("u", "v", "theta_p", "moist", "chem", "mu", "ph")})
            for _ in range(n + 1)]


def _meshes():
    return [Mesh(shape=shape, rank=r, device=torch.device("cpu"))
            for shape in ((2, 2), (1, 4)) for r in range(shape[0] * shape[1])]


@pytest.mark.parametrize("zones", [(1, 3), (2, 5)])
def test_blend_on_blocks(zones):
    cfg = _cfg(*zones)
    grid = make_grid(cfg)
    *bdy_states, dyn = _states(cfg, grid)
    data = bdy.make_bdy([0.0, 600.0], bdy_states, width=sum(zones), chem=True)
    whole = bdy.apply_specified_relax(dyn, data, 210.0, grid, cfg)
    w_whole = bdy.zone_weights(grid, cfg)
    for mesh in _meshes():
        bg = block_grid(grid, mesh, min_extent=1)
        cut = lambda t: block_of(t, mesh, NY, NX)
        np.testing.assert_array_equal(bdy.zone_weights(bg, cfg).numpy(), cut(w_whole).numpy())
        out = bdy.apply_specified_relax(tree_map(cut, dyn), data, 210.0, bg, cfg)
        for f in dataclasses.fields(out):
            o = getattr(out, f.name)
            if o is not None:
                np.testing.assert_array_equal(o.numpy(), cut(getattr(whole, f.name)).numpy(),
                                              err_msg=f"{mesh.shape} rank {mesh.rank} {f.name}")


def test_edge_sections_reach_past_a_block():
    """A 7-point zone over (1, 4) blocks of 3 columns paints the west slab
    on the first three ranks, the east on the last three."""
    grid = make_grid(_cfg(2, 5))
    painted = {}
    for mesh in _meshes()[4:]:
        secs = bdy.edge_sections(block_grid(grid, mesh, min_extent=1), 7)
        painted[mesh.ix] = {e: (s, f) for e, s, f in secs}
    assert [("xs" in painted[i], "xe" in painted[i]) for i in range(4)] == \
        [(True, False), (True, True), (True, True), (False, True)]
    assert painted[2]["xs"] == ((slice(0, 10), slice(6, 7)), (slice(0, 10), slice(0, 1)))
    assert painted[1]["xe"] == ((slice(0, 10), slice(0, 1)), (slice(0, 10), slice(2, 3)))


def test_outflow_drop_uses_global_indices():
    """Only moves across the domain's edges drop, not across a block's."""
    cfg = _cfg(1, 3)
    grid = make_grid(cfg)
    shape = (2, NY, NX, 3)
    r = np.random.default_rng(2)
    dj = torch.tensor(r.integers(-1, 2, shape))
    di = torch.tensor(r.integers(-1, 2, shape))
    horiz = torch.tensor(r.random(shape) < 0.7)
    whole = open_boundary_drop(dj, di, horiz, cfg)
    for mesh in _meshes():
        cut = lambda t: t[:, mesh.slices(NY, NX)[0], mesh.slices(NY, NX)[1]]
        bg = block_grid(grid, mesh, min_extent=1)
        assert torch.equal(open_boundary_drop(cut(dj), cut(di), cut(horiz), cfg, bg),
                           cut(whole))
