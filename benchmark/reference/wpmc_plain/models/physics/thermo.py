"""Moist-thermodynamic helpers (port of the relative-humidity path of
``wrf_partmc_tpu/models/physics/thermo.py``)."""

from __future__ import annotations

import torch

from ... import constants as c


def saturation_vapor_pressure(temp):
    """Tetens formula [Pa] over liquid water."""
    tc = temp - 273.15
    return 610.78 * torch.exp(17.27 * tc / torch.clamp(tc + 237.3, min=1.0))


def saturation_mixing_ratio(temp, pressure):
    es = saturation_vapor_pressure(temp)
    return c.EPS_VAP * es / torch.clamp(pressure - es, min=1.0)


def relative_humidity(qv, temp, pressure, clip=(0.001, 0.95)):
    """RH from vapor mixing ratio, clamped like the reference coupling."""
    rh = qv / torch.clamp(saturation_mixing_ratio(temp, pressure), min=1e-10)
    return torch.clamp(rh, clip[0], clip[1])
