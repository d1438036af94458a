"""Mie optics: the exact series, a lookup table, and its fitted surrogate.

Port of ``wrf_partmc_tpu/models/partmc/mie.py``.  The homogeneous-sphere
series (Bohren & Huffman 1983 recurrences) is evaluated once, in float64
numpy, over a (size parameter x, n, log k) grid; particles then take
(Q_ext, Q_sca, g) either by trilinear interpolation in that table
(``table_lookup``) or from a least-squares Chebyshev(log x) x poly(n, k)
fit of it (``fit_lookup``, the every-step path of the bulk optics).  The
table build and the fit are numpy, copied from the reference, so both
packages get the same numbers; the table is cached in a file of the port's
own under the temporary directory.
"""

from __future__ import annotations

import functools
import hashlib
import os
import tempfile
from dataclasses import dataclass

import numpy as np
import torch


def mie_series(x, m):
    """Exact Mie efficiencies for homogeneous spheres.

    x: real size parameters (array-like), m: complex refractive indices
    (broadcastable against x).  Returns (q_ext, q_sca, g) float64 arrays.

    Standard algorithm (Bohren & Huffman 1983 §4.8): downward recurrence for
    the logarithmic derivative D_n(mx), upward Riccati-Bessel recurrences for
    psi/chi, Lorenz-Mie coefficients a_n/b_n, and the usual efficiency /
    asymmetry sums.  Vectorized numpy over the full input grid (host-side,
    table build time only).
    """
    x = np.atleast_1d(np.asarray(x, np.float64))
    m = np.broadcast_to(np.asarray(m, np.complex128), x.shape).copy()
    x = np.maximum(x, 1e-8)
    mx = m * x
    nstop = int(np.max(np.round(x + 4.0 * x ** (1.0 / 3.0) + 2.0))) + 1
    nmx = int(max(nstop, np.max(np.abs(mx)))) + 16

    # logarithmic derivative D_n(mx) by downward recurrence
    d = np.zeros(x.shape, np.complex128)
    dd = [None] * (nstop + 1)
    for n in range(nmx, 0, -1):
        rn = n / mx
        d = rn - 1.0 / (d + rn)      # d is now D_{n-1}
        if n - 1 <= nstop and n >= 1:
            if n - 1 >= 1:
                dd[n - 1] = d.copy()

    psi0 = np.cos(x)
    psi1 = np.sin(x)
    chi0 = -np.sin(x)
    chi1 = np.cos(x)
    xi0 = psi0 - 1j * chi0
    xi1 = psi1 - 1j * chi1

    q_ext = np.zeros(x.shape)
    q_sca = np.zeros(x.shape)
    g_sum = np.zeros(x.shape)
    a_prev = np.zeros(x.shape, np.complex128)
    b_prev = np.zeros(x.shape, np.complex128)
    # per-element series length: running the recurrences past an element's
    # own nstop overflows chi_n ((2n-1)!!/x^n growth), so freeze converged
    # elements instead of iterating the whole grid to the global nstop
    nstop_el = np.round(x + 4.0 * x ** (1.0 / 3.0) + 2.0)
    for n in range(1, nstop + 1):
        act = n <= nstop_el
        fn = (2.0 * n - 1.0) / x
        psi = np.where(act, fn * psi1 - psi0, psi1)
        chi = np.where(act, fn * chi1 - chi0, chi1)
        xi = psi - 1j * chi
        dn = dd[n]
        za = dn / m + n / x
        zb = dn * m + n / x
        with np.errstate(all="ignore"):
            a_n = np.where(act, (za * psi - psi1) / (za * xi - xi1), 0.0)
            b_n = np.where(act, (zb * psi - psi1) / (zb * xi - xi1), 0.0)
        q_ext += (2.0 * n + 1.0) * np.real(a_n + b_n)
        q_sca += (2.0 * n + 1.0) * (np.abs(a_n) ** 2 + np.abs(b_n) ** 2)
        if n > 1:
            nn = n - 1.0
            g_sum += (nn * (nn + 2.0) / (nn + 1.0)
                      * np.real(a_prev * np.conj(a_n) + b_prev * np.conj(b_n))
                      + (2.0 * nn + 1.0) / (nn * (nn + 1.0))
                      * np.real(a_prev * np.conj(b_prev)))
        a_prev, b_prev = a_n, b_n
        psi0, psi1 = psi1, psi
        chi0, chi1 = chi1, chi
        xi1 = xi
    nn = float(nstop)
    g_sum += (2.0 * nn + 1.0) / (nn * (nn + 1.0)) * np.real(
        a_prev * np.conj(b_prev))
    q_ext *= 2.0 / x ** 2
    q_sca *= 2.0 / x ** 2
    g = np.where(q_sca > 1e-12, 4.0 / (x ** 2 * np.maximum(q_sca, 1e-12))
                 * g_sum, 0.0)
    q_sca = np.minimum(q_sca, q_ext)
    return q_ext, q_sca, np.clip(g, -1.0, 1.0)


# table grid: uniform in log10(x), uniform in n, uniform in log10(k)
_LX0, _LX1, _NX = -3.0, 2.7, 160         # x in [1e-3, 500]
_N0, _N1, _NN = 1.25, 1.95, 15
_LK0, _LK1, _NK = -4.0, 0.0, 13          # k in [1e-4, 1]; smaller k ~ 0


@dataclass(frozen=True)
class MieTable:
    """[NX, NN, NK] Q_ext / Q_sca / g on the (log x, n, log k) grid."""
    q_ext: torch.Tensor
    q_sca: torch.Tensor
    g: torch.Tensor


def _cache_path() -> str:
    """The port's table cache, keyed by the same hash of the grid as the
    reference's (a file of its own, so neither package reads the other's
    partly written file)."""
    tag = hashlib.sha1(repr((1, _NX, _NN, _NK, _LX0, _LX1, _N0, _N1,
                             _LK0, _LK1)).encode()).hexdigest()[:12]
    return os.path.join(tempfile.gettempdir(), f"wpmc_reference_mie_{tag}.npz")


@functools.lru_cache(maxsize=1)
def _build_table_np():
    cache = _cache_path()
    if os.path.exists(cache):
        try:
            z = np.load(cache)
            if z["q_ext"].shape == (_NX, _NN, _NK):
                return z["q_ext"], z["q_sca"], z["g"]
        except (OSError, ValueError, KeyError):
            pass
    lx = np.linspace(_LX0, _LX1, _NX)
    nn = np.linspace(_N0, _N1, _NN)
    lk = np.linspace(_LK0, _LK1, _NK)
    X, N, K = np.meshgrid(10.0 ** lx, nn, 10.0 ** lk, indexing="ij")
    q_ext, q_sca, g = mie_series(X.ravel(), N.ravel() + 1j * K.ravel())
    shp = (_NX, _NN, _NK)
    out = tuple(a.reshape(shp).astype(np.float32) for a in (q_ext, q_sca, g))
    tmp = f"{cache}.{os.getpid()}.npz"
    try:
        np.savez(tmp, q_ext=out[0], q_sca=out[1], g=out[2])
        os.replace(tmp, cache)
    except OSError:
        pass
    return out


@functools.lru_cache(maxsize=None)
def make_mie_table(device="cpu") -> MieTable:
    """The table as tensors on ``device`` (made once per device)."""
    qe, qs, g = _build_table_np()
    t = lambda a: torch.as_tensor(a, device=device)
    return MieTable(q_ext=t(qe), q_sca=t(qs), g=t(g))


def table_lookup(table: MieTable, x, n, k):
    """Trilinear-interpolated (q_ext, q_sca, g) for size parameter ``x`` and
    refractive index ``n + ik`` (any broadcast shape).  Out-of-range values
    clamp to the table edge."""
    tx = (torch.log10(torch.clamp(x, min=1e-30)) - _LX0) / (_LX1 - _LX0) * (_NX - 1)
    tn = (n - _N0) / (_N1 - _N0) * (_NN - 1)
    tk = ((torch.log10(torch.clamp(k, min=1e-30)) - _LK0) / (_LK1 - _LK0) * (_NK - 1))
    fx = torch.clamp(tx, 0.0, _NX - 1.001)
    fn_ = torch.clamp(tn, 0.0, _NN - 1.001)
    fk = torch.clamp(tk, 0.0, _NK - 1.001)
    ix = torch.floor(fx).to(torch.int64)
    in_ = torch.floor(fn_).to(torch.int64)
    ik = torch.floor(fk).to(torch.int64)
    wx = fx - ix
    wn = fn_ - in_
    wk = fk - ik
    flat = [t.reshape(-1) for t in (table.q_ext, table.q_sca, table.g)]
    shape = torch.broadcast_shapes(fx.shape, fn_.shape, fk.shape)
    outs = [torch.zeros(shape, dtype=torch.float32, device=fx.device) for _ in range(3)]
    for dx in (0, 1):
        for dn in (0, 1):
            for dk in (0, 1):
                idx = ((ix + dx) * _NN + (in_ + dn)) * _NK + (ik + dk)
                idx = torch.clamp(idx, 0, flat[0].numel() - 1)
                w = ((wx if dx else 1.0 - wx) * (wn if dn else 1.0 - wn)
                     * (wk if dk else 1.0 - wk))
                for i, t in enumerate(flat):
                    outs[i] = outs[i] + w * t[idx]
    return tuple(outs)


_FIT_J = 60          # Chebyshev order in scaled log10(x)
_FIT_DEG = 4         # total degree of the (n, k) polynomial basis (15 terms)


def _nk_exponents():
    return [(dn, dk) for dn in range(_FIT_DEG + 1)
            for dk in range(_FIT_DEG + 1) if dn + dk <= _FIT_DEG]


@functools.lru_cache(maxsize=1)
def _fit_coeffs_np():
    """Least-squares tensor fit of the table: log10(q_ext), log10(q_abs) and
    g as Chebyshev_J(scaled log10 x) x poly(n, k_scaled) series.  Returns
    [J*M, 3] float32 (columns: log10 q_ext, log10 q_abs, g)."""
    qe, qs, g = _build_table_np()
    qa = np.maximum(qe.astype(np.float64) - qs, 1e-15)
    lx = np.linspace(_LX0, _LX1, _NX)
    nn = np.linspace(_N0, _N1, _NN)
    lk = np.linspace(_LK0, _LK1, _NK)
    t = (lx - _LX0) / (_LX1 - _LX0) * 2.0 - 1.0
    cheb = np.polynomial.chebyshev.chebvander(t, _FIT_J - 1)     # [NX, J]
    n_s = (nn - _N0) / (_N1 - _N0) * 2.0 - 1.0
    k_s = (lk - _LK0) / (_LK1 - _LK0) * 2.0 - 1.0
    Ng, Kg = np.meshgrid(n_s, k_s, indexing="ij")
    basis = np.stack([Ng ** dn * Kg ** dk for dn, dk in _nk_exponents()],
                     -1).reshape(-1, len(_nk_exponents()))       # [NN*NK, M]
    A = np.einsum("xj,pm->xpjm", cheb, basis).reshape(_NX * _NN * _NK, -1)
    cols = []
    for T in (np.log10(np.maximum(qe, 1e-15)), np.log10(qa), g):
        c, *_ = np.linalg.lstsq(A, T.reshape(-1), rcond=None)
        cols.append(c.astype(np.float32))
    return np.stack(cols, axis=-1)                               # [J*M, 3]


@functools.lru_cache(maxsize=None)
def _fit_coeffs(device) -> torch.Tensor:
    """The fit coefficients as a [J, M*3] tensor on ``device``, made once."""
    return torch.as_tensor(_fit_coeffs_np(), device=device).reshape(_FIT_J, -1)


def _ipow(x, n: int):
    """x**n for a small int n by repeated squaring, as the reference's
    ``integer_pow`` multiplies."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def fit_lookup(x, n, k):
    """Fitted (q_ext, q_sca, g): elementwise work and one [N, J] @ [J, M*3]
    contraction per call.  The Chebyshev design matrix is filled row by row
    into one [J, N] buffer, so no list of J terms and its stacked copy are
    alive together (at 124,416 cells x 128 slots the buffer is 3.8 GB)."""
    C = _fit_coeffs(x.device)                                   # [J, M*3]
    t = torch.clamp((torch.log10(torch.clamp(x, min=1e-30)) - _LX0)
                    / (_LX1 - _LX0) * 2.0 - 1.0, -1.0, 1.0)
    n_s = torch.clamp((n - _N0) / (_N1 - _N0) * 2.0 - 1.0, -1.0, 1.0)
    k_s = torch.clamp((torch.log10(torch.clamp(k, min=1e-30)) - _LK0)
                      / (_LK1 - _LK0) * 2.0 - 1.0, -1.0, 1.0)
    shape = t.shape
    t = t.reshape(-1)
    T = torch.empty((_FIT_J, t.numel()), dtype=torch.float32, device=t.device)
    T[0] = 1.0
    T[1] = t
    for j in range(2, _FIT_J):
        T[j] = 2.0 * t * T[j - 1] - T[j - 2]
    M = len(_nk_exponents())
    proj = (T.t() @ C).reshape(*shape, M, 3)
    del T
    basis = torch.stack([_ipow(n_s, dn) * _ipow(k_s, dk)
                         for dn, dk in _nk_exponents()], dim=-1)   # [..., M]
    out = torch.einsum("...mq,...m->...q", proj, basis)
    q_ext = 10.0 ** out[..., 0]
    q_abs = 10.0 ** out[..., 1]
    g = torch.clamp(out[..., 2], 0.0, 1.0)
    return q_ext, torch.clamp(q_ext - q_abs, min=0.0), g
