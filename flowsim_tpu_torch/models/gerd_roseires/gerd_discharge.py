"""GERD reservoir routing: dam-release hydrograph precompute.

Host-side replication of the reference's ``GerdHydrograph``
(ref: cases/gerd_roseires/gerd_discharge.py:6-123): before the channel
simulation starts, the dam release table is built by stepping an implicit
reservoir mass balance over the inflow hydrograph.  This runs once on the
host (NumPy + brentq, like the reference), producing the [nt]-sized upstream
target series the solver consumes; nothing here is on the hot path.

Outlet capacity model (ref :70-123): gated ogee spillway scaled by a linear
opening factor alpha(WL), stepped + emergency spillways (weir laws
Q = c (WL - crest)^1.5), optional bottom outlets (implicit head-loss solve),
plus constant turbine flow.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.optimize import brentq

from flowsim_tpu_torch.api import Hydrograph
from flowsim_tpu_torch.utils.io import import_table

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

TURBINE_FLOW = 1562.5         # ref :10
SPILLWAY_CREST = 624.9        # ref :97
MAX_OPERATING_LEVEL = 640.0   # ref :98


class GerdHydrograph(Hydrograph):
    """Dam-release hydrograph; ``build`` precomputes the release table."""

    def __init__(self):
        super().__init__(function=None, table=None)
        self.turbine_flow = TURBINE_FLOW

    def build(self, inflow_hydrograph: Hydrograph, time_step, duration, initial_stage,
              vol_curve_path=None):
        """Step the reservoir mass balance over [0, duration] (ref :12-56)."""
        if int(duration) % int(time_step):
            # the reference sizes its table with floor but its loop writes
            # ceil rows — a non-multiple duration IndexErrors mid-routing;
            # fail up front with the actual constraint instead
            raise ValueError(
                f"GERD routing needs duration ({duration}) to be a multiple "
                f"of time_step ({time_step})")
        n = int(duration // time_step) + 1
        self.table = np.empty((n, 2), dtype=np.float64)

        path = vol_curve_path or os.path.join(DATA_DIR, "gerd_vol_curve.csv")
        curve = import_table(path, header=False)
        vols, stages = curve[:, 0], curve[:, 1]

        stage_0 = initial_stage
        inflow_0 = inflow_hydrograph.get_at(0)
        outflow_0 = self.release(inflow=inflow_0, stage=stage_0, initial_stage=initial_stage)
        self.table[0] = [0.0, outflow_0]

        for t in range(int(time_step), int(duration) + int(time_step), int(time_step)):
            inflow_1 = inflow_hydrograph.get_at(t)
            avg_inflow = 0.5 * (inflow_1 + inflow_0)
            vol_0 = np.interp(stage_0, stages, vols)
            Q_req = inflow_1

            def mass_balance(stage_1):
                outflow_1 = self.release(Q_req, stage_1, initial_stage)
                avg_outflow = 0.5 * (outflow_1 + outflow_0)
                vol_1 = np.interp(stage_1, stages, vols)
                return (vol_1 - vol_0) - (avg_inflow - avg_outflow) * time_step * 1e-6

            stage_1 = brentq(mass_balance, a=624.9, b=645.0)  # ref :45
            outflow_1 = self.release(Q_req, stage_1, initial_stage)

            k = t // int(time_step)
            self.table[k] = [t, outflow_1]
            stage_0, inflow_0, outflow_0 = stage_1, inflow_1, outflow_1

    def release(self, inflow, stage, initial_stage):
        """Release policy: capacity above initial stage, else demand-following
        with a turbine floor (ref :58-68)."""
        capacity = self.effective_capacity(WL=stage)
        if stage > initial_stage:
            return capacity
        return max(min(inflow, capacity), self.turbine_flow)

    def effective_capacity(self, WL, use_bottom_outlets=False):
        Q1 = self.gated_spillway(WL) * self.alpha(WL)
        Q2 = self.stepped_spillway(WL)
        Q3 = self.emergency_spillway(WL)
        Q4 = self.bottom_outlets(WL) if use_bottom_outlets else 0.0
        return Q1 + Q2 + Q3 + Q4 + self.turbine_flow

    def alpha(self, WL):
        if WL <= SPILLWAY_CREST:
            return 0.0
        if WL >= MAX_OPERATING_LEVEL:
            return 1.0
        return (WL - SPILLWAY_CREST) / (MAX_OPERATING_LEVEL - SPILLWAY_CREST)

    def bottom_outlets(self, WL, darcy_f=0.01):
        def f(Q):
            return max(0.0, WL - 545.0) - (9.9125e-5 * Q * Q + 1.00295e-3 * darcy_f * Q * Q)

        return brentq(f, a=0.0, b=1060.0)

    def emergency_spillway(self, WL):
        return 654.6723 * max(0.0, WL - 642.0) ** 1.5

    def stepped_spillway(self, WL):
        return 447.3594 * max(0.0, WL - 640.0) ** 1.5

    def gated_spillway(self, WL):
        return 196.4017 * max(0.0, WL - 624.9) ** 1.5
