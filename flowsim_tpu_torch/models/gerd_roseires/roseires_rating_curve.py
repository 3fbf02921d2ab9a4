"""Roseires dam gated rating curve.

Replicates the behavior of the reference ``RoseiresRatingCurve``
(ref: cases/gerd_roseires/roseires_rating_curve.py); counterpart of
``flowsim_tpu/models/gerd_roseires/roseires_rating_curve.py``:

* the sklearn degree-2 regressions over the spillway (stage x opening) and
  deep-sluice (stage x tailwater) release tables become plain least-squares
  quadratic fits (identical normal equations; ref :210-257);
* the closed-gate state search (how many sluices / fully-open spillways plus
  a partial opening reproduce the initial flow) runs once on the host with
  brentq, exactly as the reference does at construction (ref :143-178);
* the default *smooth* release — a smoothstep blend between the closed-state
  and open-state curves over a 0.5 m buffer (ref :89-109) — is exported as a
  pure ``blended_poly`` rating curve: for fixed gate states the total
  release is exactly quadratic in stage, so the two states reduce to two
  quadratics blended at evaluation;
* the *non-smooth* stateful gate controller (open/close thresholds, 5 h
  cooldown, jam scenarios; ref :111-141) is implemented as an explicit
  ``GateState`` update for host-side stepping and testing (the shipped
  configurations run smooth=True, which bypasses it; SURVEY.md §3.3).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
from scipy.optimize import brentq

from flowsim_tpu_torch.api import RatingCurve
from flowsim_tpu_torch.ops import rating_curve as rcurve
from flowsim_tpu_torch.utils.io import import_grid_table

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

HYDROPOWER_Q = 63.0 * 1e6 / (24 * 3600)   # ref :10
NUM_SLUICE_GATES = 5
NUM_SPILLWAYS = 7
MAX_SPILLWAY_OPENING = 13
MIN_STAGE = 466.7
MAX_STAGE = 492.0
TAIL_WATER_LEVEL_RANGE = (440.0, 455.0)

# gate-controller timing (ref settings.py:16-17 import; unused by smooth path)
OPEN_TIMING = 3600 * 6
CLOSE_TIMING = 3600 * 55


def _fit_table(path: str):
    """Quadratic bivariate least squares over a release table (ref :210-257)."""
    rows, cols, values = import_grid_table(path)
    X, y = [], []
    for i, r in enumerate(rows):
        for j, c in enumerate(cols):
            v = values[i, j]
            if not np.isnan(v):
                X.append([r, c])
                y.append(v)
    return rcurve.fit_quadratic_bivariate(np.array(X), np.array(y))


@dataclass
class GateState:
    """Explicit state of the non-smooth gate controller (ref :111-141)."""

    open: bool
    cooldown: float
    prev_time: float | None
    current_stage: float


class RoseiresRatingCurve(RatingCurve):
    def __init__(
        self,
        initial_stage=None,
        initial_flow=None,
        initially_open=False,
        jammed_spillways=0,
        jammed_sluice_gates=0,
        max_cooldown=3600 * 5,
        smooth=True,
        buffer=0.5,
        deep_sluices_active=True,
        data_dir=None,
    ):
        super().__init__()
        d = data_dir or DATA_DIR
        self.spillway_coef = _fit_table(os.path.join(d, "roseires_spillway_releases.csv"))
        self.sluice_coef = _fit_table(os.path.join(d, "roseires_deep_sluice_releases.csv"))

        if initial_stage > MAX_STAGE or initial_stage < MIN_STAGE:
            raise ValueError(f"Roseires water stage must be between {MIN_STAGE} m and {MAX_STAGE} m.")

        self.initial_stage = initial_stage
        self.smooth = smooth
        self.buffer = buffer
        self.jammed_spillways = jammed_spillways
        self.jammed_sluice_gates = jammed_sluice_gates if deep_sluices_active else NUM_SLUICE_GATES
        self.tail_water_level = float(np.average(TAIL_WATER_LEVEL_RANGE))
        self.max_cooldown = max_cooldown

        self.open_state = (
            [MAX_SPILLWAY_OPENING] * (NUM_SPILLWAYS - self.jammed_spillways) + [0] * self.jammed_spillways,
            NUM_SLUICE_GATES - self.jammed_sluice_gates,
        )
        self.closed_state = self._calc_closed_state(initial_flow)

        self.gate_state = GateState(
            open=initially_open, cooldown=0.0, prev_time=None, current_stage=initial_stage
        )
        self._current = self.open_state if initially_open else self.closed_state

        # solver curves (kept on the host until a solver lowers the
        # boundary to its device): the two gate states are exact quadratics in stage,
        # so fit them through 3 samples.  ``params`` is the smooth blended
        # curve (the shipped default); ``params_gated`` is the non-smooth
        # explicit-gate-state variant (scan-carried GateState in the solver).
        low_q = self._quad_of_state(self.closed_state)
        high_q = self._quad_of_state(self.open_state)
        self.params_smooth = rcurve.make_blended_poly(
            low_quad=low_q, high_quad=high_q,
            pivot_stage=initial_stage, buffer=buffer, fd_step=1e-3, device="cpu",
        )
        self.params_gated = rcurve.make_gated_blend(
            low_quad=low_q, high_quad=high_q,
            pivot_stage=initial_stage, max_cooldown=max_cooldown, fd_step=1e-3, device="cpu",
        )
        # ``params`` is what the solver consumes (api.Boundary.build reads
        # it); ``params_smooth`` stays available so the per-call
        # discharge(smooth=True) override works in a non-smooth instance
        # (the reference's discharge(smooth=...) toggles both ways)
        self.params = self.params_smooth if smooth else self.params_gated

    # -- state-parameterized releases (ref :84-87,180-200) ------------------

    def spillway_Q(self, stage, opening=None):
        opening = MAX_SPILLWAY_OPENING if opening is None else opening
        return float(rcurve.eval_quadratic_bivariate(self.spillway_coef, stage, opening))

    def sluice_Q(self, stage, tail_water_level=None):
        twl = self.tail_water_level if tail_water_level is None else tail_water_level
        return float(rcurve.eval_quadratic_bivariate(self.sluice_coef, stage, twl))

    def total_release(self, stage, state=None):
        openings, n_sluices = state if state is not None else self._current
        spill = sum(self.spillway_Q(stage, o) for o in openings if o > 0)
        return spill + self.sluice_Q(stage) * n_sluices + HYDROPOWER_Q

    def _quad_of_state(self, state):
        """Exact quadratic coefficients [c2, c1, c0] of total_release(stage)."""
        s = np.array([400.0, 480.0, 560.0])
        q = np.array([self.total_release(x, state) for x in s])
        V = np.vander(s, 3)
        return np.linalg.solve(V, q)

    def _calc_closed_state(self, initial_flow):
        """Search the gate configuration reproducing the initial flow at the
        initial stage (ref :143-178)."""
        openings = [MAX_SPILLWAY_OPENING] * (NUM_SPILLWAYS - self.jammed_spillways)
        n_sluices = 0
        for i in range(1, NUM_SLUICE_GATES + 1 - self.jammed_sluice_gates):
            n_sluices = i
            if self.total_release(self.initial_stage, (openings, n_sluices)) > initial_flow:
                n_sluices = i - 1
                break

        fully_o = 0
        for i in range(1, NUM_SPILLWAYS + 1 - self.jammed_spillways):
            openings = [MAX_SPILLWAY_OPENING] * i + [0] * (NUM_SPILLWAYS - i)
            if self.total_release(self.initial_stage, (openings, n_sluices)) > initial_flow:
                fully_o = i - 1
                break

        def f(partial):
            st = ([MAX_SPILLWAY_OPENING] * fully_o + [partial] + [0] * (NUM_SPILLWAYS - fully_o - 1),
                  n_sluices)
            return initial_flow - self.total_release(self.initial_stage, st)

        partial = round(brentq(f, 0, MAX_SPILLWAY_OPENING), 2)
        if fully_o + (1 if partial > 0 else 0) > NUM_SPILLWAYS - self.jammed_spillways:
            raise ValueError("infeasible closed gate state")
        return ([MAX_SPILLWAY_OPENING] * fully_o + [partial] + [0] * (NUM_SPILLWAYS - fully_o - 1),
                n_sluices)

    # -- gate controller (non-smooth path; ref :111-141) ---------------------

    def gate_control(self, time):
        gs = self.gate_state
        if gs.prev_time is not None:
            gs.cooldown = max(0.0, gs.cooldown - (time - gs.prev_time))
        gs.prev_time = time
        if gs.cooldown > 0:
            return
        if gs.current_stage >= self.initial_stage + 0.5 and not gs.open:
            gs.cooldown = self.max_cooldown
            gs.open = True
            self._current = self.open_state
        elif gs.current_stage <= self.initial_stage - 1 and gs.open:
            gs.cooldown = self.max_cooldown
            gs.open = False
            self._current = self.closed_state

    # -- RatingCurve surface --------------------------------------------------

    def discharge(self, stage, time=None, update_stage=True, update_gate_state=True, smooth=None):
        smooth = self.smooth if smooth is None else smooth
        if smooth:
            return float(rcurve.discharge(self.params_smooth, self._stage(stage)))
        if update_gate_state:
            self.gate_control(time)
        q = self.total_release(stage)
        if update_stage:
            self.gate_state.current_stage = stage
        return q

    def dQ_dz(self, stage, time=None, dY=0.001):
        f_plus = self.discharge(stage + dY, time=time, update_stage=False, update_gate_state=False)
        f_minus = self.discharge(stage - dY, time=time, update_stage=False, update_gate_state=False)
        return (f_plus - f_minus) / (2 * dY)
