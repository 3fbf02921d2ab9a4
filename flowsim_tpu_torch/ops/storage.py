"""0-D lumped reservoir storage attached to a boundary (torch).

Counterpart of ``flowsim_tpu/ops/storage.py``.  The implicit per-step mass
balance is a fixed-count bracketed bisection (80 halvings of the solution
bracket), the same loop the fused CUDA kernel runs in its boundary thread, so
the plain engine and the kernel agree to rounding.

Stage-area curves: the cumulative volume V(Y) is precomputed once on a dense
fixed grid at set-up and ``net_vol_change = V(Y2) - V(Y1)`` is a table
interpolation.  With a constant ``surface_area`` it is ``(Y2 - Y1) * SA``.

Not ported yet: the implicit-function-theorem gradient rule of the JAX
package's ``mass_balance`` (``custom_jvp``).  The port computes no gradients
so far (ROADMAP.md Queue 1, gradients); differentiating this bisection with
autograd would give an identically-zero, silently wrong derivative — whoever
ports the gradient path must give :func:`mass_balance` its own backward.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from flowsim_tpu_torch.config import DEFAULT_DEVICE, GRAVITY as g, farray, resolve_device
from flowsim_tpu_torch.ops import hydraulics as hyd
from flowsim_tpu_torch.ops import rating_curve as rcurve

BISECT_ITERS = 80
_INTERP_EPS = float(np.spacing(np.finfo(np.float64).eps))


@dataclass(frozen=True)
class StorageParams:
    has_area_curve: bool
    has_rating: bool
    capture_losses: bool
    surface_area: torch.Tensor    # scalar (unused if has_area_curve)
    min_stage: torch.Tensor
    y_min: torch.Tensor           # solution bracket
    y_max: torch.Tensor
    vol_stage: torch.Tensor       # dense stage grid for V(Y) (has_area_curve)
    vol_table: torch.Tensor       # cumulative volume on vol_stage
    area_stage: torch.Tensor      # stage grid of the area curve
    area_table: torch.Tensor      # alpha-scaled areas on area_stage
    area_gradient: torch.Tensor   # d(area)/d(stage) table
    beta: torch.Tensor            # stage shift of the area lookup
    reservoir_length: torch.Tensor
    K_q: torch.Tensor
    rating: Optional[rcurve.RatingCurveParams] = None

    def to(self, device) -> "StorageParams":
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, rcurve.RatingCurveParams)):
                out[f.name] = v.to(device)
        return dataclasses.replace(self, **out)


def make_storage(
    surface_area=None,
    min_stage=-np.inf,
    solution_boundaries=(0.0, 200.0),
    area_curve=None,
    alpha=1.0,
    beta=0.0,
    rating: rcurve.RatingCurveParams | None = None,
    capture_losses=False,
    reservoir_length=0.0,
    K_q=0.0,
    vol_grid_points: int = 4096,
    device=DEFAULT_DEVICE,
) -> StorageParams:
    """Build storage params (host side).  ``area_curve`` is an (M, 2) array of
    (stage, area) rows."""
    device = resolve_device(device)
    f = lambda v: farray(np.asarray(v, dtype=np.float64), device)
    common = dict(
        has_rating=rating is not None,
        capture_losses=bool(capture_losses),
        min_stage=f(min_stage),
        reservoir_length=f(reservoir_length),
        K_q=f(K_q),
        rating=None if rating is None else rating.to(device),
    )
    if area_curve is not None:
        ac = np.asarray(area_curve, dtype=np.float64)
        stages, areas = ac[:, 0], alpha * ac[:, 1]
        y_min, y_max = float(stages.min()), float(stages.max())
        grid = np.linspace(y_min, y_max, vol_grid_points)
        area_on_grid = np.interp(grid + beta, stages, areas)
        vol = np.concatenate([[0.0], np.cumsum(0.5 * (area_on_grid[1:] + area_on_grid[:-1]) * np.diff(grid))])
        return StorageParams(
            has_area_curve=True,
            surface_area=f(0.0),
            y_min=f(y_min),
            y_max=f(y_max),
            vol_stage=f(grid),
            vol_table=f(vol),
            area_stage=f(stages),
            area_table=f(areas),
            area_gradient=f(np.gradient(areas, stages)),
            beta=f(beta),
            **common,
        )
    if surface_area is None:
        raise ValueError("surface_area or area_curve required")
    e = np.zeros((0,))
    return StorageParams(
        has_area_curve=False,
        surface_area=f(surface_area),
        y_min=f(solution_boundaries[0]),
        y_max=f(solution_boundaries[1]),
        vol_stage=f(e), vol_table=f(e), area_stage=f(e), area_table=f(e), area_gradient=f(e),
        beta=f(0.0),
        **common,
    )


def interp(x, xp, fp):
    """Linear interpolation of the table (xp ascending, fp) at ``x``, the
    end values held outside the table: what ``jnp.interp`` computes, in its
    association (``fp[i-1] + (delta / dx) * df``).  The fused kernel's
    ``interp_table`` mirrors this function operation for operation."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= _INTERP_EPS  # a repeated stage: no division by zero
    val = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    val = torch.where(x < xp[0], fp[0].expand_as(val), val)
    return torch.where(x > xp[-1], fp[-1].expand_as(val), val)


def area_at(sp: StorageParams, stage):
    """Water-surface area at stage."""
    if sp.has_area_curve:
        return interp(stage + sp.beta, sp.area_stage, sp.area_table)
    return sp.surface_area


def dA_dY(sp: StorageParams, stage):
    """d(area)/d(stage) from the tabulated gradient."""
    if sp.has_area_curve:
        return interp(stage, sp.area_stage, sp.area_gradient)
    return torch.zeros_like(stage)


def net_vol_change(sp: StorageParams, Y1, Y2):
    """Volume between stages Y1 -> Y2."""
    if sp.has_area_curve:
        v = lambda y: interp(y, sp.vol_stage, sp.vol_table)
        return v(Y2) - v(Y1)
    return (Y2 - Y1) * sp.surface_area


def _mass_balance_residual(sp: StorageParams, duration, vol_in, Y_old, Y):
    """g(Y) whose root is the new stage:  net_vol_change(Y_old, Y)
    - (vol_in - 0.5*(Qout(Y_old)+Qout(Y))*dt)."""
    q_old = rcurve.discharge(sp.rating, Y_old) if sp.has_rating else 0.0
    q_new = rcurve.discharge(sp.rating, Y) if sp.has_rating else 0.0
    target_vol = vol_in - 0.5 * (q_old + q_new) * duration
    return net_vol_change(sp, Y_old, Y) - target_vol


def mass_balance(sp: StorageParams, duration, vol_in, Y_old):
    """Implicit new stage from the trapezoidal mass balance.

    Solves  net_vol_change(Y_old, Y) = vol_in - 0.5*(Qout(Y_old)+Qout(Y))*dt
    by :data:`BISECT_ITERS` halvings of [y_min, y_max], then clamps to
    ``min_stage``.  No gradient rule yet (see the module docstring)."""
    f = lambda Y: _mass_balance_residual(sp, duration, vol_in, Y_old, Y)
    lo = sp.y_min * torch.ones_like(Y_old)
    hi = sp.y_max * torch.ones_like(Y_old)
    f_lo = f(lo)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        f_mid = f(mid)
        go_right = torch.sign(f_mid) == torch.sign(f_lo)
        lo = torch.where(go_right, mid, lo)
        f_lo = torch.where(go_right, f_mid, f_lo)
        hi = torch.where(go_right, hi, mid)
    Y = 0.5 * (lo + hi)
    return torch.maximum(Y, sp.min_stage)


def dY_new_dvol_in(sp: StorageParams, Y_new):
    """d(new stage)/d(inflow volume) = 1/A(Y); 0 below min stage."""
    return torch.where(Y_new <= sp.min_stage, torch.zeros_like(Y_new), 1.0 / area_at(sp, Y_new))


# ---------------------------------------------------------------------------
# Entrance energy losses: friction over the reservoir length plus an
# empirical velocity-head term K_q V^2 / 2g.
# ---------------------------------------------------------------------------


def energy_loss(sp: StorageParams, entry_area, flow, roughness, hydraulic_radius):
    if not sp.capture_losses:
        return torch.zeros_like(entry_area)
    K = hyd.conveyance(entry_area, roughness, hydraulic_radius)
    hf = hyd.friction_slope(flow, K) * sp.reservoir_length
    V = flow / entry_area
    h_emp = sp.K_q * V * V / (2.0 * g)
    return hf + h_emp


def dhl_dA(sp: StorageParams, entry_area, flow, roughness, hydraulic_radius, dR_dA):
    if not sp.capture_losses:
        return torch.zeros_like(entry_area)
    K = hyd.conveyance(entry_area, roughness, hydraulic_radius)
    dK = hyd.dK_dA(entry_area, roughness, hydraulic_radius, dR_dA)
    dhf = hyd.dSf_dA(flow, K, dK) * sp.reservoir_length
    V = flow / entry_area
    dV_dA = -flow / (entry_area * entry_area)
    d_h_emp = sp.K_q * 2.0 * V * dV_dA / (2.0 * g)
    return dhf + d_h_emp


def dhl_dQ(sp: StorageParams, entry_area, flow, roughness, hydraulic_radius):
    if not sp.capture_losses:
        return torch.zeros_like(entry_area)
    K = hyd.conveyance(entry_area, roughness, hydraulic_radius)
    dhf = hyd.dSf_dQ(flow, K) * sp.reservoir_length
    V = flow / entry_area
    dV_dQ = 1.0 / entry_area
    d_h_emp = sp.K_q * 2.0 * V * dV_dQ / (2.0 * g)
    return dhf + d_h_emp
