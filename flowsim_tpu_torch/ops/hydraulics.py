"""Vectorized hydraulic closure functions (torch).

Counterpart of ``flowsim_tpu/ops/hydraulics.py``: pure elementwise functions
of per-node tensors, formula-identical to the JAX package (including its
epsilon clamps) so Preissmann trajectories can be compared allclose.

Conventions
-----------
* ``A`` wetted area, ``P`` wetted perimeter, ``R = A/P`` hydraulic radius,
  ``T`` top width, ``K`` conveyance, ``n`` Manning roughness, ``h`` depth,
  ``Q`` discharge, ``rc`` radius of curvature (1/curvature).
* every function broadcasts over arbitrary leading shapes.
"""

from __future__ import annotations

import torch

from flowsim_tpu_torch.config import GRAVITY as g


# -- fractional powers ------------------------------------------------------
# All the Manning-law exponents are multiples of 1/6, so they are expressed
# through sqrt (exact to 0.5 ulp) and a Newton-polished cube root, the same
# forms the JAX package uses.  torch has no cbrt: the seed is ``pow(1/3)``
# and the one Newton step restores a full-precision root.


def _cbrt(x):
    zero_in = x == 0.0
    xs = torch.where(zero_in, torch.ones_like(x), x)
    r = xs.pow(1.0 / 3.0)
    r2 = r * r
    r3 = r2 * r
    return torch.where(zero_in, torch.zeros_like(x), r - (r3 - xs) / (3.0 * r2))


def pow_2_3(x):
    c = _cbrt(x)
    return c * c


def pow_m1_3(x):
    return 1.0 / _cbrt(x)


def pow_1_6(x):
    return torch.sqrt(_cbrt(x))


def pow_3_2(x):
    pos = x > 0.0
    xs = torch.where(pos, x, torch.ones_like(x))
    return torch.where(pos, xs * torch.sqrt(xs), torch.zeros_like(x))


def conveyance(A, n, R):
    """Manning conveyance K = A R^{2/3} / n  (ref: hydraulics.py:15-26)."""
    return A * pow_2_3(R) / n


def dK_dA(A, n, R, dR_dA):
    """dK/dA (ref: hydraulics.py:28-40)."""
    return (pow_2_3(R) + A * (2.0 / 3.0) * pow_m1_3(R) * dR_dA) / n


def friction_slope(Q, K):
    """Sf = Q|Q| / K^2  (ref: hydraulics.py:42-57)."""
    return Q * torch.abs(Q) / (K * K)


def dSf_dA(Q, K, dK_dA_val):
    """dSf/dA = -2 Sf dK/dA / K  (ref: hydraulics.py:59-75)."""
    return -2.0 * friction_slope(Q, K) * (dK_dA_val / K)


def dSf_dQ(Q, K):
    """dSf/dQ = 2|Q| / K^2  (ref: hydraulics.py:77-92)."""
    return 2.0 * torch.abs(Q) / (K * K)


def normal_flow(bed_slope, K):
    """Q = sign(S0) K sqrt(|S0|)  (ref: hydraulics.py:4-13)."""
    Q = K * torch.sqrt(torch.abs(bed_slope))
    return torch.where(bed_slope < 0, -Q, Q)


def dQn_dA(bed_slope, dK_dA_val):
    """d(normal flow)/dA  (ref: hydraulics.py:206-215)."""
    d = dK_dA_val * torch.sqrt(torch.abs(bed_slope))
    return torch.where(bed_slope < 0, -d, d)


def froude(T, A, Q):
    """Froude number with the reference's 1e-6 clamps (ref: hydraulics.py:155-168)."""
    V = Q / torch.clamp(A, min=1e-6)
    D = A / torch.clamp(T, min=1e-6)
    return V / torch.sqrt(g * torch.clamp(D, min=1e-6))


def dFr_dA(T, A, Q):
    """dFr/dA (no clamps, matching ref: hydraulics.py:170-187)."""
    V = Q / A
    D = A / T
    dV_dA = -Q / (A * A)
    dD_dA = 1.0 / T
    gD = g * D
    inv_sqrt = 1.0 / torch.sqrt(gD)
    return -0.5 * V * (inv_sqrt / gD) * g * dD_dA + dV_dA * inv_sqrt


def dFr_dQ(T, A):
    """dFr/dQ (ref: hydraulics.py:189-204)."""
    D = A / T
    return (1.0 / A) / torch.sqrt(g * D)


def darcy_weisbach_f(n, R):
    """f = 8 g n^2 / R^{1/3}  (ref: hydraulics.py:217-229)."""
    C = pow_1_6(R) / n
    return 8.0 * g / (C * C)


def curvature_slope(h, T, A, Q, n, R, rc):
    """Transverse-circulation energy slope Sc (ref: hydraulics.py:94-117).

    Sc = (2.86 sqrt(f) + 2.07 f) h^2 Fr^2 / ((0.565 + sqrt(f)) rc^2)
    """
    Fr = froude(T, A, Q)
    f = darcy_weisbach_f(n, R)
    sqrtf = torch.sqrt(f)
    num = (2.86 * sqrtf + 2.07 * f) * h * h * Fr * Fr
    den = (0.565 + sqrtf) * rc * rc
    return num / den


def dSc_dA(h, A, Q, n, R, rc, dR_dA, T):
    """dSc/dA (ref: hydraulics.py:119-137)."""
    Fr = froude(T, A, Q)
    f = darcy_weisbach_f(n, R)
    dh_dA = 1.0 / T
    dFr = dFr_dA(A=A, Q=Q, T=T)
    df_dA = -(8.0 / 3.0) * g * n * n * (pow_m1_3(R) / R) * dR_dA

    sqrtf = torch.sqrt(f)
    num = (2.86 * sqrtf + 2.07 * f) * h * h * Fr * Fr
    den = (0.565 + sqrtf) * rc * rc

    dnum_dA = (2.86 / (2.0 * sqrtf) * df_dA + 2.07 * df_dA) * h * h * Fr * Fr + (
        2.86 * sqrtf + 2.07 * f
    ) * (2.0 * h * dh_dA * Fr * Fr + h * h * 2.0 * Fr * dFr)
    dden_dA = (1.0 / (2.0 * sqrtf) * df_dA) * rc * rc
    return (dnum_dA * den - num * dden_dA) / (den * den)


def dSc_dQ(h, T, A, Q, n, R, rc):
    """dSc/dQ (ref: hydraulics.py:139-153)."""
    Fr = froude(T, A, Q)
    f = darcy_weisbach_f(n, R)
    dFr = dFr_dQ(T=T, A=A)
    sqrtf = torch.sqrt(f)
    num = (2.86 * sqrtf + 2.07 * f) * h * h * Fr * Fr
    den = (0.565 + sqrtf) * rc * rc
    dnum_dQ = (2.86 * sqrtf + 2.07 * f) * h * h * 2.0 * Fr * dFr
    return dnum_dQ / den
