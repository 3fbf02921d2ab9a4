"""GERD->Roseires case configuration.

The physical and numerical parameters of the flagship case (values match the
reference configuration, ref: cases/gerd_roseires/settings.py, so the
simulations are comparable), organized as structured config objects plus the
module-level aliases the case model consumes.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@dataclass(frozen=True)
class NumericsConfig:
    """Preissmann discretization for the GERD reach (ref settings.py:1-8)."""

    spatial_step: float = 1000.0
    time_step: float = 3600.0
    theta: float = 0.6
    sim_duration: float = 3600.0 * 384
    tolerance: float = 1e-6


@dataclass(frozen=True)
class ReservoirConfig:
    """Initial pool levels and gate-fault scenario (ref settings.py:10-17)."""

    initial_roseires_level: float = 487.0
    initial_gerd_level: float = 637.0
    jammed_spillways: int = 0
    jammed_sluice_gates: int = 0
    open_timing: float = 3600.0 * 6
    close_timing: float = 3600.0 * 55


@dataclass(frozen=True)
class DesignFloodConfig:
    """Synthetic design-flood wave: sine-ramp up, flat peak, sine-ramp down
    (ref settings.py:21-39)."""

    base_flow: float = 1562.5
    peak_flow: float = 26000.0
    lag_time: float = 0.0
    time_to_peak: float = 3600.0 * 24
    time_at_peak: float = 3600.0 * 24

    def inflow_at(self, time: float) -> float:
        t = time - self.lag_time
        rise = self.peak_flow - self.base_flow
        if t <= 0:
            return self.base_flow
        if t < self.time_to_peak:
            return self.base_flow + rise * math.sin(0.5 * math.pi * t / self.time_to_peak)
        if t < self.time_to_peak + self.time_at_peak:
            return self.peak_flow
        if t < 2 * self.time_to_peak + self.time_at_peak:
            return self.base_flow + rise * math.sin(
                0.5 * math.pi * (t - self.time_at_peak) / self.time_to_peak
            )
        return self.base_flow


NUMERICS = NumericsConfig()
RESERVOIRS = ReservoirConfig()
FLOOD = DesignFloodConfig()

# --- flat aliases used by model.py / tests -------------------------------

spatial_step = NUMERICS.spatial_step
time_step = NUMERICS.time_step
theta = NUMERICS.theta
sim_duration = NUMERICS.sim_duration
tolerance = NUMERICS.tolerance

initial_roseires_level = RESERVOIRS.initial_roseires_level
initial_gerd_level = RESERVOIRS.initial_gerd_level
JAMMED_SPILLWAYS = RESERVOIRS.jammed_spillways
JAMMED_SLUICEGATES = RESERVOIRS.jammed_sluice_gates
OPEN_TIMING = RESERVOIRS.open_timing
CLOSE_TIMING = RESERVOIRS.close_timing

sin_wave = FLOOD.inflow_at

inflow_hyd_path = os.path.join(DATA_DIR, "inflow_hydrograph.csv")
inflow_hyd_func = sin_wave
coords_path = os.path.join(DATA_DIR, "centerline_coords.csv")
cross_sections_path = os.path.join(DATA_DIR, "composite_trapezoids.csv")
