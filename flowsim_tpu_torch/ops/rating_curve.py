"""Stage-discharge rating curves as tensor dataclasses.

Counterpart of ``flowsim_tpu/ops/rating_curve.py``: one dataclass whose
``kind`` selects a pure evaluation path:

* ``polynomial``   Q = a x^2 + b x + c,  x = stage + shift
* ``poly_n``       arbitrary-degree polynomial, ascending coefficients
* ``power``        Q = a x^b
* ``blended_poly`` Q = low + alpha (high - low) with a smoothstep alpha over a
  buffer above a pivot stage — the smooth Roseires release path; low/high
  are quadratics in the **centered** stage ``stage - pivot`` (in the raw
  basis the three terms are ~1e6 and cancel to ~1e4)
* ``gated_blend``  the same two quadratics selected by an explicit gate state
  that is updated once per time level
* ``table``        linear interpolation of a (stage, Q) table

``dQ_dz`` is analytic for polynomial/power and a central finite difference
with step ``fd_step`` for the blended/gated/table curves, as in the
reference.  Host-side ``fit`` is NumPy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from flowsim_tpu_torch.config import DEFAULT_DEVICE, DEFAULT_DTYPE, farray, resolve_device


@dataclass(frozen=True)
class RatingCurveParams:
    kind: str
    coeffs: torch.Tensor        # poly: [a,b,c]; power: [a,b]; blended: low [c2,c1,c0]
    coeffs_high: torch.Tensor   # blended: high-state quadratic [c2,c1,c0]
    stage_shift: torch.Tensor   # scalar
    pivot_stage: torch.Tensor   # blended: alpha ramp start (initial stage)
    buffer: torch.Tensor        # blended: alpha ramp width
    fd_step: torch.Tensor       # finite-difference step for dQ/dz
    table_stage: torch.Tensor   # table kind
    table_q: torch.Tensor
    # gated_blend kind only: gate-controller cooldown
    max_cooldown: Optional[torch.Tensor] = None

    def to(self, device) -> "RatingCurveParams":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _make(kind, device, coeffs=(), coeffs_high=(), stage_shift=0.0, pivot_stage=0.0,
          buffer=0.0, fd_step=1e-3, table_stage=(), table_q=(), max_cooldown=None):
    device = resolve_device(device)
    f = lambda v: farray(np.asarray(v, dtype=np.float64), device)
    return RatingCurveParams(
        kind=kind, coeffs=f(coeffs), coeffs_high=f(coeffs_high),
        stage_shift=f(stage_shift), pivot_stage=f(pivot_stage), buffer=f(buffer),
        fd_step=f(fd_step), table_stage=f(table_stage), table_q=f(table_q),
        max_cooldown=None if max_cooldown is None else f(max_cooldown))


def make_polynomial(a, b, c, stage_shift=0.0, device=DEFAULT_DEVICE) -> RatingCurveParams:
    return _make("polynomial", device, coeffs=[a, b, c], stage_shift=stage_shift)


def make_polynomial_general(coefficients, stage_shift=0.0, device=DEFAULT_DEVICE) -> RatingCurveParams:
    """Arbitrary-degree polynomial rating: ``coefficients`` ascending
    (c0 + c1 x + ... + cN x^N) in the shifted stage x = stage + shift."""
    return _make("poly_n", device, coeffs=np.atleast_1d(coefficients), stage_shift=stage_shift)


def make_power(a, b, stage_shift=0.0, device=DEFAULT_DEVICE) -> RatingCurveParams:
    return _make("power", device, coeffs=[a, b], stage_shift=stage_shift)


def _center(quad, s0):
    c2, c1, c0 = [float(v) for v in quad]
    return [c2, 2.0 * c2 * s0 + c1, (c2 * s0 + c1) * s0 + c0]


def make_blended_poly(low_quad, high_quad, pivot_stage, buffer=0.5, fd_step=1e-3,
                      device=DEFAULT_DEVICE) -> RatingCurveParams:
    """Smooth gated-release curve: quadratics in stage for the closed (low)
    and open (high) gate states, blended by the reference's smoothstep
    (ref roseires_rating_curve.py:98-109).  The quadratics are re-based around
    the pivot stage before storage (centered basis)."""
    s0 = float(pivot_stage)
    return _make("blended_poly", device, coeffs=_center(low_quad, s0),
                 coeffs_high=_center(high_quad, s0), pivot_stage=pivot_stage,
                 buffer=buffer, fd_step=fd_step)


def make_table(stages, discharges, fd_step=1e-3, device=DEFAULT_DEVICE) -> RatingCurveParams:
    return _make("table", device, fd_step=fd_step, table_stage=stages, table_q=discharges)


def make_gated_blend(low_quad, high_quad, pivot_stage, max_cooldown=3600 * 5, fd_step=1e-3,
                     device=DEFAULT_DEVICE) -> RatingCurveParams:
    """Non-smooth gated release: discharge follows the low (closed) or high
    (open) quadratic depending on an explicit gate state carried across time
    levels, with the reference's hysteresis thresholds (open at pivot + 0.5,
    close at pivot - 1) and cooldown (ref roseires_rating_curve.py:111-141).
    The state updates once per time level from the previous level's converged
    downstream stage."""
    s0 = float(pivot_stage)
    return _make("gated_blend", device, coeffs=_center(low_quad, s0),
                 coeffs_high=_center(high_quad, s0), pivot_stage=pivot_stage,
                 buffer=0.5, fd_step=fd_step, max_cooldown=max_cooldown)


def gated_discharge(rc: RatingCurveParams, stage, gate_open):
    """Release under an explicit gate state (ref roseires:84-96)."""
    ds = stage - rc.pivot_stage
    low = _quad(rc.coeffs, ds)
    high = _quad(rc.coeffs_high, ds)
    return torch.where(gate_open > 0.5, high, low)


def gated_dQ_dz(rc: RatingCurveParams, stage, gate_open):
    d = rc.fd_step
    return (gated_discharge(rc, stage + d, gate_open) - gated_discharge(rc, stage - d, gate_open)) / (2.0 * d)


def gate_update(rc: RatingCurveParams, gate_open, cooldown, prev_time, current_stage, time):
    """One gate-controller step (ref roseires:111-141): decrement cooldown by
    elapsed time, then open/close on the hysteresis thresholds."""
    time = torch.as_tensor(time, dtype=gate_open.dtype, device=gate_open.device)
    zero = torch.zeros_like(gate_open)
    one = torch.ones_like(gate_open)
    elapsed = torch.where(prev_time >= 0.0, time - prev_time, zero)
    cooldown = torch.clamp(cooldown - elapsed, min=0.0)
    can_act = cooldown <= 0.0
    want_open = (current_stage >= rc.pivot_stage + 0.5) & (gate_open < 0.5)
    want_close = (current_stage <= rc.pivot_stage - 1.0) & (gate_open > 0.5)
    do_open = can_act & want_open
    do_close = can_act & want_close
    gate_open = torch.where(do_open, one, torch.where(do_close, zero, gate_open))
    cooldown = torch.where(do_open | do_close, rc.max_cooldown + zero, cooldown)
    return gate_open, cooldown, time


def _quad(c, x):
    return (c[0] * x + c[1]) * x + c[2]


def _polyval_ascending(coeffs, x):
    """Horner evaluation of c0 + c1 x + ... (coefficients ascending)."""
    out = torch.zeros_like(x) + coeffs[-1]
    for j in range(coeffs.shape[0] - 2, -1, -1):
        out = out * x + coeffs[j]
    return out


def _interp(x, xp, fp):
    """Linear interpolation with end clamping (numpy.interp semantics)."""
    idx = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True) - 1, 0, xp.shape[0] - 2)
    x0, x1 = xp[idx], xp[idx + 1]
    f0, f1 = fp[idx], fp[idx + 1]
    val = f0 + (x - x0) * (f1 - f0) / (x1 - x0)
    val = torch.where(x <= xp[0], fp[0] + torch.zeros_like(val), val)
    return torch.where(x >= xp[-1], fp[-1] + torch.zeros_like(val), val)


def discharge(rc: RatingCurveParams, stage):
    """Q(stage); pure, vectorized (ref rating_curve.py:32-63)."""
    if rc.kind == "polynomial":
        x = stage + rc.stage_shift
        a, b, c = rc.coeffs[0], rc.coeffs[1], rc.coeffs[2]
        return a * x * x + b * x + c
    if rc.kind == "poly_n":
        return _polyval_ascending(rc.coeffs, stage + rc.stage_shift)
    if rc.kind == "power":
        x = stage + rc.stage_shift
        a, b = rc.coeffs[0], rc.coeffs[1]
        return a * x ** b
    if rc.kind == "blended_poly":
        alpha = _alpha_smooth(rc, stage)
        ds = stage - rc.pivot_stage  # centered basis (see make_blended_poly)
        low = _quad(rc.coeffs, ds)
        high = _quad(rc.coeffs_high, ds)
        # delta form low + a*(high-low): one product, same as the JAX package
        return low + alpha * (high - low)
    if rc.kind == "table":
        return _interp(stage, rc.table_stage, rc.table_q)
    raise ValueError(f"unknown rating curve kind {rc.kind!r}")


def _alpha_smooth(rc: RatingCurveParams, stage):
    """smoothstep ramp from pivot to pivot+buffer (ref roseires:98-109).

    ``buffer == 0`` degenerates to the reference's step function; the
    division is guarded so stage == pivot gives 0/eps = 0, not NaN."""
    s = (stage - rc.pivot_stage) / torch.clamp(rc.buffer, min=1e-30)
    s = torch.clamp(s, 0.0, 1.0)
    return 3.0 * s * s - 2.0 * s * s * s


def dQ_dz(rc: RatingCurveParams, stage):
    """dQ/d(stage) (ref rating_curve.py:132-147; roseires:202-208)."""
    if rc.kind == "polynomial":
        x = stage + rc.stage_shift
        return rc.coeffs[0] * 2.0 * x + rc.coeffs[1]
    if rc.kind == "poly_n":
        x = stage + rc.stage_shift
        n = rc.coeffs.shape[0]
        dcoef = rc.coeffs[1:] * torch.arange(1, n, dtype=rc.coeffs.dtype, device=rc.coeffs.device)
        return _polyval_ascending(dcoef, x) if n > 1 else torch.zeros_like(x)
    if rc.kind == "power":
        x = stage + rc.stage_shift
        a, b = rc.coeffs[0], rc.coeffs[1]
        return a * b * x ** (b - 1.0)
    # blended_poly / table: central finite difference, replicating the
    # Roseires dQ_dz exactly (dY = 0.001 by default).
    d = rc.fd_step
    return (discharge(rc, stage + d) - discharge(rc, stage - d)) / (2.0 * d)


def inverse_stage(rc: RatingCurveParams, q_target, trial_stage=None, tolerance=1e-2, rate=1.0, max_iter=64):
    """Stage from discharge by Newton iteration (ref rating_curve.py:65-82):
    iterate while |Q - target| > tolerance, at most ``max_iter`` times."""
    dev = rc.coeffs.device
    if trial_stage is None:
        trial_stage = -rc.stage_shift * 1.05
    s = torch.as_tensor(trial_stage, dtype=DEFAULT_DTYPE, device=dev)
    q_target = torch.as_tensor(q_target, dtype=DEFAULT_DTYPE, device=dev)
    for _ in range(max_iter):
        qv = discharge(rc, s)
        active = torch.abs(qv - q_target) > tolerance
        step = -rate * (qv - q_target) / dQ_dz(rc, s)
        s = torch.where(active, s + step, s)
    return s


# ---------------------------------------------------------------------------
# Host-side fitting (NumPy)
# ---------------------------------------------------------------------------


def fit(discharges, stages, stage_shift=0.0, type: str = "polynomial", degree: int = 2,
        device=DEFAULT_DEVICE) -> RatingCurveParams:
    """Least-squares fit, replicating ref rating_curve.py:84-130."""
    discharges = np.asarray(discharges, dtype=np.float64)
    stages = np.asarray(stages, dtype=np.float64)
    if discharges.size < 3:
        raise ValueError("Need at least 3 points.")
    if discharges.shape != stages.shape:
        raise ValueError("Q and Y lists should have the same lengths.")
    shifted = stages + stage_shift
    if np.any(shifted <= 0):
        raise ValueError("All (stage - base) values must be positive for power-law fitting.")

    if type == "polynomial":
        poly = np.polynomial.polynomial.Polynomial.fit(x=shifted, y=discharges, deg=degree)
        coef = poly.convert().coef
        coef = np.pad(coef, (0, degree + 1 - len(coef)))  # trailing zeros trimmed by convert()
        if degree != 2:
            return make_polynomial_general(coef, stage_shift=stage_shift, device=device)
        c0, c1, c2 = coef
        return make_polynomial(a=c2, b=c1, c=c0, stage_shift=stage_shift, device=device)
    elif type == "power":
        b, log_a = np.polyfit(np.log(shifted), np.log(discharges), deg=1)
        return make_power(a=float(np.exp(log_a)), b=float(b), stage_shift=stage_shift, device=device)
    raise ValueError("Invalid rating curve type.")


def fit_quadratic_bivariate(X, y):
    """Least-squares degree-2 bivariate polynomial with intercept.  Returns
    coefficients [b0, b1, b2, b11, b12, b22] for 1, x1, x2, x1^2, x1*x2, x2^2
    (the Roseires spillway/sluice table regressions)."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    x1, x2 = X[:, 0], X[:, 1]
    design = np.column_stack([np.ones_like(x1), x1, x2, x1 * x1, x1 * x2, x2 * x2])
    coef, *_ = np.linalg.lstsq(design, y, rcond=None)
    return coef


def eval_quadratic_bivariate(coef, x1, x2):
    b0, b1, b2, b11, b12, b22 = coef
    return b0 + b1 * x1 + b2 * x2 + b11 * x1 * x1 + b12 * x1 * x2 + b22 * x2 * x2
