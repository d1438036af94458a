"""Simulation clock and alarms.

The port's own copy of ``wrf_partmc_tpu/utils/clock.py`` (which has no JAX
in it): a host-side stand-in for the reference's ESMF time manager, with
alarm-driven I/O.  Time is an integer step counter and a fixed dt.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Alarm:
    """Fires every ``interval_s`` of simulation time."""

    interval_s: float
    offset_s: float = 0.0
    enabled: bool = True

    def ringing(self, t: float, dt: float) -> bool:
        if not self.enabled or self.interval_s <= 0:
            return False
        # rings on the step nearest each multiple of the interval
        phase = (t - self.offset_s) % self.interval_s
        tol = 0.5 * min(dt, self.interval_s)
        return phase < tol or (self.interval_s - phase) <= tol


@dataclass
class Clock:
    dt: float
    t_stop: float
    step: int = 0
    alarms: dict = field(default_factory=dict)

    @property
    def t(self) -> float:
        return self.step * self.dt

    def done(self) -> bool:
        return self.t >= self.t_stop - 1e-9

    def advance(self) -> None:
        self.step += 1

    def add_alarm(self, name: str, interval_s: float, offset_s: float = 0.0) -> None:
        self.alarms[name] = Alarm(interval_s, offset_s)

    def ringing(self, name: str) -> bool:
        return self.alarms[name].ringing(self.t, self.dt)
