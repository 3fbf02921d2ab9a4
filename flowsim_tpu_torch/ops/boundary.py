"""Boundary-condition residuals and Jacobian entries (torch).

Counterpart of ``flowsim_tpu/ops/boundary.py``.  Residual form is
``unknown - target`` (ref boundary.py:141) with

    kind              unknown   target
    flow_hydrograph   Q         hydrograph(t)
    normal_depth      Q         K(h) sqrt(S0)
    rating_curve      Q         RC(bed_level + h)
    fixed_depth       h         initial depth, or reservoir stage
                                + head loss - bed level
    stage_hydrograph  h         hydrograph(t) - bed_level

Hydrograph targets are precomputed per time level on the host (the solvers
only ever evaluate them at t = k*dt), so a hydrograph is just a [nt] tensor.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from flowsim_tpu_torch.config import DEFAULT_DEVICE, farray, resolve_device
from flowsim_tpu_torch.ops import hydraulics as hyd
from flowsim_tpu_torch.ops import rating_curve as rcurve
from flowsim_tpu_torch.ops import storage as storage_mod

Q_TYPE_KINDS = ("flow_hydrograph", "normal_depth", "rating_curve")  # ref :244-247
KINDS = ("flow_hydrograph", "fixed_depth", "normal_depth", "rating_curve", "stage_hydrograph")


@dataclass(frozen=True)
class BoundaryParams:
    kind: str
    bed_level: torch.Tensor           # stage datum of the boundary
    bed_slope: torch.Tensor           # section bed slope (normal_depth)
    initial_depth: torch.Tensor       # fixed_depth target
    target_series: torch.Tensor       # [nt] hydrograph values at k*dt
    rating: Optional[rcurve.RatingCurveParams] = None
    storage: Optional[storage_mod.StorageParams] = None

    @property
    def is_q_type(self) -> bool:
        return self.kind in Q_TYPE_KINDS

    def to(self, device) -> "BoundaryParams":
        return dataclasses.replace(
            self, bed_level=self.bed_level.to(device), bed_slope=self.bed_slope.to(device),
            initial_depth=self.initial_depth.to(device),
            target_series=self.target_series.to(device),
            rating=None if self.rating is None else self.rating.to(device),
            storage=None if self.storage is None else self.storage.to(device))


class NodeSection(NamedTuple):
    """Scalar section quantities at a boundary node (slice of SectionState)."""

    A: torch.Tensor
    R: torch.Tensor
    K: torch.Tensor
    n_eq: torch.Tensor
    dA_dh: torch.Tensor
    dR_dA: torch.Tensor
    dK_dA: torch.Tensor


def make_boundary(
    kind: str,
    bed_level=0.0,
    bed_slope=np.nan,
    initial_depth=np.nan,
    target_series=None,
    rating=None,
    storage=None,
    device=DEFAULT_DEVICE,
) -> BoundaryParams:
    device = resolve_device(device)
    if kind not in KINDS:
        raise ValueError("Invalid boundary condition.")  # ref boundary.py:32-33
    if storage is not None and kind != "fixed_depth":
        raise ValueError("lumped storage is only supported on a fixed_depth boundary")
    if kind == "rating_curve" and rating is None:
        raise ValueError("Rating curve is undefined.")  # ref boundary.py:96
    if kind in ("flow_hydrograph", "stage_hydrograph") and target_series is None:
        raise ValueError(
            "Insufficient arguments for boundary condition.")  # ref boundary.py:87
    f = lambda v: farray(v.detach().cpu() if isinstance(v, torch.Tensor) else np.asarray(v, np.float64), device)
    return BoundaryParams(
        kind=kind,
        bed_level=f(bed_level),
        bed_slope=f(bed_slope),
        initial_depth=f(initial_depth),
        target_series=f(np.zeros((1,)) if target_series is None else target_series),
        rating=None if rating is None else rating.to(device),
        storage=None if storage is None else storage.to(device),
    )


class BCState(NamedTuple):
    """Cross-time-level boundary state carried by the level loop.

    ``reservoir_stage``: previous level's DOWNSTREAM lumped-storage stage
    (NaN if no downstream storage; it also mirrors an upstream-only
    storage's stage).  ``reservoir_stage_us``: the UPSTREAM storage's stage
    (NaN unless the upstream boundary has storage) — a separate carry, so
    storage on both boundaries evolves independently.  The ``gate_*`` fields
    hold the explicit gate-controller state for a ``gated_blend`` downstream
    rating curve: open
    flag (0/1), remaining cooldown [s], last controller time (-1 before the
    first update), and the stage the controller last saw.
    """

    reservoir_stage: torch.Tensor
    gate_open: torch.Tensor
    gate_cooldown: torch.Tensor
    gate_prev_time: torch.Tensor
    gate_stage: torch.Tensor
    reservoir_stage_us: torch.Tensor


def initial_bc_state(dtype, device, gate_open=0.0, gate_stage=np.nan) -> BCState:
    z = lambda v: torch.as_tensor(v, dtype=dtype, device=device).clone()
    return BCState(
        reservoir_stage=z(np.nan),
        gate_open=z(gate_open),
        gate_cooldown=z(0.0),
        gate_prev_time=z(-1.0),
        gate_stage=z(gate_stage),
        reservoir_stage_us=z(np.nan),
    )


def update_gate_level_start(bc: BoundaryParams, state: BCState, time) -> BCState:
    """Per-level gate-controller update for a gated_blend rating curve;
    identity otherwise (see rcurve.gate_update)."""
    if bc.kind != "rating_curve" or bc.rating is None or bc.rating.kind != "gated_blend":
        return state
    gate_open, cooldown, prev_time = rcurve.gate_update(
        bc.rating, state.gate_open, state.gate_cooldown, state.gate_prev_time,
        state.gate_stage, time,
    )
    return state._replace(gate_open=gate_open, gate_cooldown=cooldown, gate_prev_time=prev_time)


class BCEval(NamedTuple):
    residual: torch.Tensor
    df_dh: torch.Tensor
    df_dQ: torch.Tensor
    reservoir_stage: torch.Tensor  # NaN unless fixed_depth + storage


def evaluate(
    bc: BoundaryParams,
    node: NodeSection,
    h,
    Q,
    k,
    dt,
    Q_prev=None,
    reservoir_stage_prev=None,
    bc_state: Optional[BCState] = None,
    upstream: bool = False,
    h_prev=None,
) -> BCEval:
    """Residual + its two Jacobian entries for one boundary.

    ``k`` is the time-level index; targets use ``target_series[k]``.
    ``Q_prev`` is the previous-level discharge at this node (for the storage
    volume) and ``reservoir_stage_prev`` the stage recorded at the previous
    time level.

    ``upstream`` flips the lumped-storage orientation: at the upstream end
    positive Q leaves the reservoir (mass balance gets -vol_in) and the
    channel surface sits BELOW the reservoir stage by the entrance loss.
    """
    res_stage = torch.full_like(h, float("nan"))

    if bc.kind == "flow_hydrograph":
        target = bc.target_series[k]
        return BCEval(Q - target, torch.zeros_like(h), torch.ones_like(h), res_stage)

    if bc.kind == "stage_hydrograph":
        target = bc.target_series[k] - bc.bed_level
        return BCEval(h - target, torch.ones_like(h), torch.zeros_like(h), res_stage)

    if bc.kind == "normal_depth":
        target = hyd.normal_flow(bc.bed_slope, node.K)
        df_dh = -hyd.dQn_dA(bc.bed_slope, node.dK_dA) * node.dA_dh  # ref :179-180
        return BCEval(Q - target, df_dh, torch.ones_like(h), res_stage)

    if bc.kind == "rating_curve":
        stage = bc.bed_level + h
        if bc.rating.kind == "gated_blend":
            if bc_state is None:
                raise ValueError("gated_blend rating curve needs a carried BCState")
            target = rcurve.gated_discharge(bc.rating, stage, bc_state.gate_open)
            df_dh = -rcurve.gated_dQ_dz(bc.rating, stage, bc_state.gate_open)
        else:
            target = rcurve.discharge(bc.rating, stage)
            df_dh = -rcurve.dQ_dz(bc.rating, stage)  # ref :182-184
        return BCEval(Q - target, df_dh, torch.ones_like(h), res_stage)

    if bc.kind == "fixed_depth":
        if bc.storage is None:
            return BCEval(h - bc.initial_depth, torch.ones_like(h), torch.zeros_like(h), res_stage)

        sp = bc.storage
        # upstream: positive Q drains the reservoir, and the entrance loss
        # drops the channel surface below the reservoir stage
        sign = -1.0 if upstream else 1.0
        vol_in = sign * 0.5 * (Q_prev + Q) * dt
        # at the first solved level the previous reservoir stage is taken as
        # the *current trial* boundary stage (a quirk of the reference model,
        # kept for the downstream case).  Upstream, the trial bootstrap makes
        # a draining reservoir's residual unsatisfiable in h, so it anchors
        # on the PREVIOUS level's surface instead.
        if int(k) == 1:
            Y_old = (h_prev if upstream and h_prev is not None else h) + bc.bed_level
        else:
            Y_old = reservoir_stage_prev
        Y_new = storage_mod.mass_balance(sp, dt, vol_in, Y_old)

        head_loss = storage_mod.energy_loss(sp, node.A, Q, node.n_eq, node.R)
        target = (Y_new + sign * head_loss) - bc.bed_level

        d_hl_dA = storage_mod.dhl_dA(sp, node.A, Q, node.n_eq, node.R, node.dR_dA)
        df_dh = 1.0 - sign * d_hl_dA * node.dA_dh
        dY_dvol = storage_mod.dY_new_dvol_in(sp, Y_new)
        d_hl_dQ = storage_mod.dhl_dQ(sp, node.A, Q, node.n_eq, node.R)
        df_dQ = -sign * (dY_dvol * 0.5 * dt + d_hl_dQ)
        return BCEval(h - target, df_dh, df_dQ, Y_new)

    raise ValueError(f"unknown boundary kind {bc.kind!r}")
