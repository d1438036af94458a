"""Bulk aerosol optics of the fitted Mie surrogate on the card (K5,
``csrc/mie_fit.cu``).

The CUDA counterpart of :func:`~wrf_partmc_tpu_torch.models.partmc.optics.mie_fit_sums_plain`:
from each particle slot's diameter, refractive index ``n + ik`` and live
number, one launch writes every cell's three sums at every band, Σ c_sca·num,
Σ c_abs·num and Σ c_sca·g·num, with (q_ext, q_sca, g) from ``mie.fit_lookup``'s
Chebyshev fit.  ``optics.mie_fit_sums`` calls :func:`mie_fit_bulk` for
CUDA tensors and the plain version for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.partmc import mie
from . import _cuda

MAX_BANDS = 4                    # the kernel's register arrays


def _inv32(v: float) -> float:
    """The float32 reciprocal of ``v`` rounded to float32 first, as the card
    turns torch's division by a host scalar into a product."""
    return float(np.float32(1.0) / np.float32(v))


def mie_fit_bulk(diam, n, k, live_num, coeffs, wavelengths) -> torch.Tensor:
    """Launch K5 on the inputs' current stream.  ``diam``, ``n``, ``k``,
    ``live_num``: float32 [C, P] on one card, contiguous (dead slots carry
    number 0); ``coeffs``: ``mie._fit_coeffs`` on that card ([60, 45]);
    ``wavelengths``: 1 to 4 bands [m].  Returns float32 [3, W, C]: Σ c_sca·num,
    Σ c_abs·num and Σ c_sca·g·num per band and cell."""
    ins = {"diam": diam, "n": n, "k": k, "live_num": live_num, "coeffs": coeffs}
    for name, t in ins.items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"mie_fit_bulk: {name} must be a contiguous float32 tensor")
    if diam.dim() != 2 or diam.shape[1] < 1 or any(t.shape != diam.shape
                                                  for t in (n, k, live_num)):
        raise ValueError("mie_fit_bulk: diam, n, k and live_num must share one [C, P] "
                         f"shape, got {[tuple(t.shape) for t in (diam, n, k, live_num)]}")
    n_coef = len(mie._nk_exponents()) * 3
    if tuple(coeffs.shape) != (mie._FIT_J, n_coef):
        raise ValueError(f"mie_fit_bulk: coeffs must be [{mie._FIT_J}, {n_coef}], got "
                         f"{tuple(coeffs.shape)}")
    wavelengths = tuple(float(w) for w in wavelengths)
    if not 1 <= len(wavelengths) <= MAX_BANDS or min(wavelengths) <= 0.0:
        raise ValueError(f"mie_fit_bulk: 1 to {MAX_BANDS} positive wavelengths, got "
                         f"{wavelengths}")
    if any(t.device.type != "cuda" for t in ins.values()):
        raise ValueError("mie_fit_bulk: every input must be a CUDA tensor, got "
                         f"{sorted({str(t.device) for t in ins.values()})}")
    if len({t.device for t in ins.values()}) != 1:
        raise ValueError("mie_fit_bulk: the inputs lie on more than one device")
    C, P = diam.shape
    W = len(wavelengths)
    out = torch.empty((3, W, C), dtype=torch.float32, device=diam.device)
    inv_wl = [_inv32(w) for w in wavelengths] + [0.0] * (MAX_BANDS - W)
    sms = torch.cuda.get_device_properties(diam.device).multi_processor_count
    with torch.cuda.device(diam.device):
        err = _cuda.lib().wpt_mie_fit_bulk(
            diam.data_ptr(), n.data_ptr(), k.data_ptr(), live_num.data_ptr(),
            coeffs.data_ptr(), out.data_ptr(), C, P, W,
            mie._LX0, _inv32(mie._LX1 - mie._LX0), mie._N0, _inv32(mie._N1 - mie._N0),
            mie._LK0, _inv32(mie._LK1 - mie._LK0), *inv_wl, sms,
            _cuda.stream_ptr(diam.device))
    _cuda.check(err, "mie_fit_bulk")
    mie_fit_bulk.launches += 1
    mie_fit_bulk.shapes.add((C, P, wavelengths))
    return out


# launches: kernel launches; shapes: (cells, slots, wavelengths) of each,
# so a check can repeat them.  Both are read and reset by their caller.
mie_fit_bulk.launches = 0
mie_fit_bulk.shapes = set()
