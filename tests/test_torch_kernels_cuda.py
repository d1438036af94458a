"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Skipped where there is no CUDA device (the CPU tests hold the
plain versions against the JAX package instead).

    python -m pytest tests/test_torch_kernels_cuda.py -m gpu

K2/K3 are copies and must be bit-exact; K1 performs the plain recurrence's
float32 operations without FMA contraction and is held at 1e-6 relative.
"""

import pytest
import torch

from wrf_partmc_tpu_torch.ops import place, tridiag

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("cshape,bshape", [((9, 40, 40), (9, 40, 40)),
                                           ((10, 1, 40, 40), (10, 3, 40, 40)),
                                           ((8, 1, 1), (8, 5, 7))])
def test_thomas_kernel_matches_plain(cuda, cshape, bshape):
    g = torch.Generator(device=cuda).manual_seed(0)
    dl = torch.randn(cshape, generator=g, device=cuda)
    du = torch.randn(cshape, generator=g, device=cuda)
    d = 4.0 + torch.randn(cshape, generator=g, device=cuda).abs()
    b = torch.randn(bshape, generator=g, device=cuda)
    before = tridiag.thomas_solve.launches
    x = tridiag.solve(dl, d, du, b)
    assert tridiag.thomas_solve.launches == before + 1
    ref = tridiag.solve_scan(dl, d, du, b)
    torch.testing.assert_close(x, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("B,CH,L1,L2", [(64, 33, 1280, 1120), (64, 33, 400, 400),
                                        (7, 5, 48, 128), (70000, 3, 40, 40)])
def test_scatter_kernel_bit_exact(cuda, B, CH, L1, L2):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((B, CH, L1), generator=g, device=cuda)
    n = min(L1, L2)
    perm = torch.argsort(torch.rand((B, L2), generator=g, device=cuda), dim=1)[:, :n]
    dst = torch.full((B, L1), -1, dtype=torch.int32, device=cuda)
    dst[:, :n] = perm.to(torch.int32)
    dst[torch.rand((B, L1), generator=g, device=cuda) < 0.1] = -1
    assert torch.equal(place.scatter_rows(x, dst, L2), place.scatter_rows_plain(x, dst, L2))


@pytest.mark.parametrize("B,CH,L1,L2", [(64, 33, 400, 1280), (64, 33, 1280, 1280),
                                        (7, 5, 48, 16), (70000, 3, 40, 40)])
def test_gather_kernel_bit_exact(cuda, B, CH, L1, L2):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((B, CH, L1), generator=g, device=cuda)
    src = torch.randint(-1, L1, (B, L2), generator=g, device=cuda, dtype=torch.int32)
    assert torch.equal(place.gather_rows(x, src), place.gather_rows_plain(x, src))


def test_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((2, 3, 8), device=cuda)
    with pytest.raises(ValueError):
        place.scatter_rows_cuda(x, torch.zeros((2, 8), dtype=torch.int64, device=cuda), 8)
    with pytest.raises(ValueError):
        place.gather_rows_cuda(x.transpose(1, 2), torch.zeros((2, 3), dtype=torch.int32,
                                                              device=cuda))
    with pytest.raises(ValueError):
        tridiag.thomas_solve(*(torch.ones((4, 3), dtype=torch.float64, device=cuda),) * 4)
