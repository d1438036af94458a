"""``utils.at``: the out-of-place ``x.at[..., i].add/set`` of the port against
numpy's indexed update on the same seeded inputs, exactly, with the input
left unchanged."""

import numpy as np
import pytest
import torch

from wrf_partmc_tpu_torch.utils.at import add_at, set_at


@pytest.mark.parametrize("op", ["add", "set"])
@pytest.mark.parametrize("dim, i, val_shape", [(-1, 3, (2, 5, 6)), (-2, 1, (2, 5, 7)),
                                               (-2, 4, (7,)), (0, 1, ())])
def test_matches_numpy(op, dim, i, val_shape):
    rng = np.random.default_rng(0)
    t0 = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    d = dim % t0.ndim
    sel_shape = t0.shape[:d] + t0.shape[d + 1:]
    val = rng.standard_normal(val_shape).astype(np.float32)
    want = t0.copy()
    idx = (slice(None),) * d + (i,)
    if op == "add":
        want[idx] += np.broadcast_to(val, sel_shape)
    else:
        want[idx] = np.broadcast_to(val, sel_shape)
    t = torch.from_numpy(t0.copy())
    fn = add_at if op == "add" else set_at
    out = fn(t, i, torch.from_numpy(val), dim=dim)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(t.numpy(), t0)          # out of place


def test_python_number():
    t = torch.zeros((3, 4))
    np.testing.assert_array_equal(set_at(t, 2, 1.5).numpy()[:, 2], [1.5] * 3)
    np.testing.assert_array_equal(add_at(t, 0, -2.0, dim=0).numpy()[0], [-2.0] * 4)
    assert set_at(t, 1, 0.1).dtype == torch.float32
