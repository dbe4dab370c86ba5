"""Simulation-wide context (counterpart of ``cedarsim_tpu/core/context.py``).

A ``SimSpec`` carries the numeric fields every device eval may read (time,
temperature, gmin, scale, source factor) plus the analysis mode string that
selects a branch of the source models.  Numeric fields are Python floats or
tensors; a batched transient gives ``time`` one entry per lane, a DC sweep
over temperature gives ``temp`` one (Kelvin), and the compiler broadcasts
such a field over the instances of each lane.
"""

from __future__ import annotations

import dataclasses

from cedarsim_tpu_torch import config


class Modes:
    """Analysis modes.

    - ``DCOP``:   DC operating point; sources report their DC value, time=0.
    - ``TRANOP``: initial operating point for transient; sources report their
      transient waveform value at t=0 (falling back to DC).
    - ``TRAN``:   transient; sources follow their waveforms at ctx.time.
    - ``AC``:     small-signal linearization point.
    """

    DCOP = "dcop"
    TRANOP = "tranop"
    TRAN = "tran"
    AC = "ac"

    ALL = (DCOP, TRANOP, TRAN, AC)


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """Simulation context handed to every device eval."""

    time: object = 0.0
    temp: object = None          # Kelvin
    gmin: object = 1e-12
    scale: object = 1.0
    sourcefac: object = 1.0
    mode: str = Modes.TRAN

    @staticmethod
    def make(mode=Modes.TRAN, time=0.0, temp_c=27.0, gmin=1e-12, scale=1.0,
             sourcefac=1.0):
        # host floats: model conditionals on them fold while the VA
        # interpreter walks the model, exactly as in the JAX package
        return SimSpec(time=float(time), temp=float(temp_c) + config.T_ZERO_C,
                       gmin=float(gmin), scale=float(scale),
                       sourcefac=float(sourcefac), mode=mode)

    def at_time(self, t):
        return dataclasses.replace(self, time=t)

    def with_mode(self, mode):
        return dataclasses.replace(self, mode=mode)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def temp_c(self):
        return self.temp - config.T_ZERO_C

    @property
    def vt(self):
        """Thermal voltage kT/q."""
        return self.temp * (config.K_BOLTZMANN / config.Q_CHARGE)
