"""Vectorized cross-section closures (torch).

Counterpart of ``flowsim_tpu/ops/sections.py``: branch-free per-node section
quantities evaluated for all nodes at once as pure functions of
``(geometry, depth)``.  Formula parity:

* trapezoid properties            ref cross_section.py:623-679
* subsection split (composite n)  ref cross_section.py:681-708
* Horton-Einstein equivalent n    ref cross_section.py:710-739
* compound conveyance             ref cross_section.py:741-754
* dK/dA, dR/dA, dA/dh             ref cross_section.py:756-793
* Sf / Sc and their derivatives   ref cross_section.py:114-175
* normal flow                     ref cross_section.py:177-182

Two deliberate quirks of the reference are kept: above bankfull the
full-section area omits the main-channel column while ``dA_dh`` is the full
top width, and the curvature term of ``dSe_dA_eff`` is pre-multiplied by
dA/dh (see :func:`energy_slope`).

Dispatch on the geometry type: :class:`TrapezoidGeometry` evaluates the
closed forms, :class:`TableGeometry` interpolates its lookup tables
(:func:`_table_section_state`); any other class raises ``TypeError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from flowsim_tpu_torch.geometry import TableGeometry, TrapezoidGeometry
from flowsim_tpu_torch.ops import hydraulics as hyd


class SectionState(NamedTuple):
    """All per-node section quantities needed by the solvers at depth h."""

    A: torch.Tensor
    P: torch.Tensor
    R: torch.Tensor
    T: torch.Tensor
    K: torch.Tensor        # total (Horton-Einstein) conveyance
    n_eq: torch.Tensor     # equivalent Manning n
    dA_dh: torch.Tensor
    dR_dA: torch.Tensor
    dK_dA: torch.Tensor


def _safe_div(num, den):
    """num / den where den > 0, else 0 (never evaluates x / 0)."""
    pos = den > 0.0
    return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(den))


def _trapz_regimes(g: TrapezoidGeometry, depth):
    """Shared regime quantities for a (possibly compound) trapezoid."""
    depth = torch.clamp(depth, min=0.0)
    wet = depth > 0.0

    overbank = g.compound & (depth > g.h_bank)
    h_bank = torch.where(g.compound, g.h_bank, torch.ones_like(g.h_bank))  # finite sentinel for math
    d_fp = torch.where(overbank, depth - h_bank, torch.zeros_like(depth))

    sq_m = torch.sqrt(1.0 + g.m_main * g.m_main)
    sq_fp = torch.sqrt(1.0 + g.m_fp * g.m_fp)

    # main-channel-only regime (also the full-section simple formulas)
    T_s = g.b_main + 2.0 * g.m_main * depth
    A_s = (g.b_main + g.m_main * depth) * depth
    P_s = g.b_main + 2.0 * depth * sq_m

    # bankfull main channel
    T_bank = g.b_main + 2.0 * g.m_main * h_bank
    A_mf = (g.b_main + T_bank) / 2.0 * h_bank
    P_mf = g.b_main + 2.0 * h_bank * sq_m

    # floodplains (trapezoidal, one sloped outer wall each)
    A_l = (g.b_fp_left + 0.5 * g.m_fp * d_fp) * d_fp
    P_l = g.b_fp_left + d_fp * sq_fp
    A_r = (g.b_fp_right + 0.5 * g.m_fp * d_fp) * d_fp
    P_r = g.b_fp_right + d_fp * sq_fp

    width_at_bank = g.b_fp_left + T_bank + g.b_fp_right
    return dict(
        depth=depth, wet=wet, overbank=overbank, d_fp=d_fp,
        sq_m=sq_m, sq_fp=sq_fp,
        T_s=T_s, A_s=A_s, P_s=P_s,
        T_bank=T_bank, A_mf=A_mf, P_mf=P_mf,
        A_l=A_l, P_l=P_l, A_r=A_r, P_r=P_r,
        width_at_bank=width_at_bank,
    )


def _properties(g: TrapezoidGeometry, r):
    ob, wet = r["overbank"], r["wet"]
    zero = torch.zeros_like(r["depth"])
    A = torch.where(ob, r["A_mf"] + r["A_l"] + r["A_r"], r["A_s"])
    P = torch.where(ob, r["P_mf"] + r["P_l"] + r["P_r"], r["P_s"])
    T = torch.where(ob, r["width_at_bank"] + 2.0 * g.m_fp * r["d_fp"], r["T_s"])
    A = torch.where(wet, A, zero)
    P = torch.where(wet, P, zero)
    T = torch.where(wet, T, zero)
    R = _safe_div(A, P)
    return A, P, R, T


def trapezoid_properties(g: TrapezoidGeometry, depth):
    """(A, P, R, T) per node (ref: cross_section.py:623-679)."""
    return _properties(g, _trapz_regimes(g, depth))


def _subsection_conveyances(g: TrapezoidGeometry, r, A, P, R):
    """Per-subsection conveyances for the Horton-Einstein combination.

    Below bankfull the whole section is "main" (ref: cross_section.py:687-689);
    above it the main channel extends rectangularly with width T_bank and its
    bed perimeter excludes the floodplain interfaces (ref: 694-708).
    """
    ob = r["overbank"]
    zero = torch.zeros_like(A)
    one = torch.ones_like(A)
    A_m = torch.where(ob, r["A_mf"] + r["T_bank"] * r["d_fp"], A)
    P_m = torch.where(ob, r["P_mf"], P)
    R_m = _safe_div(A_m, P_m)

    A_l = torch.where(ob, r["A_l"], zero)
    P_l = torch.where(ob, r["P_l"], zero)
    R_l = _safe_div(A_l, P_l)

    A_r = torch.where(ob, r["A_r"], zero)
    P_r = torch.where(ob, r["P_r"], zero)
    R_r = _safe_div(A_r, P_r)

    # inactive subsections (R = 0) evaluate the conveyance at a sentinel
    # R = 1 and select 0 — the same masks as the JAX package
    act_l, act_m, act_r = P_l > 0.0, P_m > 0.0, P_r > 0.0
    K_l = torch.where(act_l, hyd.conveyance(A_l, g.n_left, torch.where(act_l, R_l, one)), zero)
    K_m = torch.where(act_m, hyd.conveyance(A_m, g.n_main, torch.where(act_m, R_m, one)), zero)
    K_r = torch.where(act_r, hyd.conveyance(A_r, g.n_right, torch.where(act_r, R_r, one)), zero)
    return K_l, K_m, K_r


def section_state(g, depth) -> SectionState:
    """All closure quantities at once; see :class:`SectionState`."""
    if isinstance(g, TableGeometry):
        return _table_section_state(g, depth)
    if not isinstance(g, TrapezoidGeometry):
        raise TypeError(f"unknown geometry class {type(g).__name__!r}: "
                        "expected TrapezoidGeometry or TableGeometry")
    r = _trapz_regimes(g, depth)
    A, P, R, T = _properties(g, r)
    zero = torch.zeros_like(A)
    one = torch.ones_like(A)

    K_l, K_m, K_r = _subsection_conveyances(g, r, A, P, R)
    ksum = hyd.pow_3_2(K_l) + hyd.pow_3_2(K_m) + hyd.pow_3_2(K_r)
    K_compound = torch.where(ksum > 0.0, hyd.pow_2_3(ksum), zero)
    K_simple = hyd.conveyance(A, g.n_main, R)
    K = torch.where(g.compound, K_compound, K_simple)

    # equivalent n (ref: cross_section.py:710-739): simple -> n_main; compound
    # -> A R^{2/3} / K_total with n_main fallback on degenerate sections.
    n_eq_c = torch.where(
        (A > 0.0) & (R > 0.0) & (K_compound > 0.0),
        A * hyd.pow_2_3(R) / torch.where(K_compound > 0.0, K_compound, one),
        g.n_main + zero,
    )
    n_eq = torch.where(g.compound, n_eq_c, g.n_main + zero)

    dA_dh = T  # ref: cross_section.py:792-793

    # dR/dA with piecewise dP/dh (ref: cross_section.py:766-790)
    dP_dh = torch.where(r["overbank"], 2.0 * r["sq_fp"], 2.0 * r["sq_m"])
    ok = (P > 0.0) & (T > 0.0)
    dP_dA = dP_dh / torch.where(ok, T, one)
    dR_dA = torch.where(ok, (P - A * dP_dA) / torch.where(ok, P * P, one), zero)

    # dK/dA uses the *equivalent-n single-channel* formula even for compound
    # sections (ref: cross_section.py:756-764).
    dK_dA = torch.where(A > 0.0, hyd.dK_dA(A, n_eq, R, dR_dA), zero)

    return SectionState(A=A, P=P, R=R, T=T, K=K, n_eq=n_eq, dA_dh=dA_dh, dR_dA=dR_dA, dK_dA=dK_dA)


# ---------------------------------------------------------------------------
# Table (irregular-section) path
# ---------------------------------------------------------------------------


def _table_lookup(table, idx, frac):
    lo = torch.gather(table, -1, idx.unsqueeze(-1)).squeeze(-1)
    hi = torch.gather(table, -1, (idx + 1).unsqueeze(-1)).squeeze(-1)
    return lo + frac * (hi - lo)


def _table_section_state(g: TableGeometry, depth) -> SectionState:
    """Linear interpolation on the uniform depth grid of each node.

    The raw (possibly negative) depth drives the lookup; the bracket index is
    clipped to [0, M-2], so depths beyond the table extrapolate on its last
    interval (``frac`` > 1) and negative ones on the first; only A, P, T and
    K are wet-masked.  The index is floored and clipped in float64 before it
    becomes an integer, and a NaN depth takes bracket 0 (its values stay
    NaN): the CUDA kernels do the same.
    """
    M = g.area.shape[-1]
    dgrid = g.depth_max / (M - 1)
    x = depth / dgrid
    jf = torch.clamp(torch.floor(x), 0.0, float(M - 2))
    jf = torch.where(torch.isnan(jf), torch.zeros_like(jf), jf)
    idx = jf.long()
    frac = x - jf  # may exceed 1 beyond the table: linear extrapolation

    A = _table_lookup(g.area, idx, frac)
    P = _table_lookup(g.perimeter, idx, frac)
    T = _table_lookup(g.top_width, idx, frac)
    K = _table_lookup(g.conveyance, idx, frac)
    n_eq = _table_lookup(g.n_eq, idx, frac)
    dK = _table_lookup(g.dK_dA, idx, frac)
    dR = _table_lookup(g.dR_dA, idx, frac)
    wet = depth > 0.0
    zero = torch.zeros_like(A)
    A = torch.where(wet, A, zero)
    P = torch.where(wet, P, zero)
    T = torch.where(wet, T, zero)
    K = torch.where(wet, K, zero)
    R = _safe_div(A, P)
    return SectionState(A=A, P=P, R=R, T=T, K=K, n_eq=n_eq, dA_dh=T, dR_dA=dR, dK_dA=dK)


# ---------------------------------------------------------------------------
# Energy slope Se = Sf + Sc and derivatives (vectorized over nodes)
# ---------------------------------------------------------------------------


class EnergySlope(NamedTuple):
    Se: torch.Tensor
    dSe_dA_eff: torch.Tensor  # dSf/dA + (dSc/dA * dA/dh)   [see note]
    dSe_dQ: torch.Tensor


def energy_slope(g, depth, Q, state: Optional[SectionState] = None) -> EnergySlope:
    """Se and its derivatives, matching the reference's channel closure.

    Note on ``dSe_dA_eff``: the reference pre-multiplies the **curvature**
    term by dA/dh inside the section object (ref: cross_section.py:164) while
    the friction term is left as a pure d/dA (ref: cross_section.py:124-132);
    the Preissmann assembly then multiplies the sum by dA/dh again
    (ref: preissmann.py:543,605).  That exact composition is replicated.
    """
    s = state if state is not None else section_state(g, depth)
    Q = Q + torch.zeros_like(s.K)
    zero = torch.zeros_like(s.K)
    one = torch.ones_like(s.K)
    Kpos = s.K > 0.0
    Ksafe = torch.where(Kpos, s.K, one)

    Sf = torch.where(Kpos, hyd.friction_slope(Q, Ksafe), zero)
    dSf_dA = torch.where(Kpos, hyd.dSf_dA(Q, Ksafe, s.dK_dA), zero)
    dSf_dQ = torch.where(Kpos, hyd.dSf_dQ(Q, Ksafe), zero)

    curv = g.curvature + zero
    has_curv = curv != 0.0              # ref: cross_section.py:145 (Sc)
    has_curv_d = torch.abs(curv) > 1e-12  # ref: cross_section.py:156,168 (dSc)
    rc = 1.0 / torch.where(has_curv, curv, one)
    Rsafe = torch.where(s.R > 0.0, s.R, one)

    Sc = torch.where(
        has_curv,
        hyd.curvature_slope(depth, s.T, s.A, Q, s.n_eq, Rsafe, rc),
        zero,
    )
    dSc_dA = torch.where(
        has_curv_d,
        hyd.dSc_dA(depth, s.A, Q, s.n_eq, Rsafe, rc, s.dR_dA, s.T) * s.dA_dh,
        zero,
    )
    dSc_dQ = torch.where(
        has_curv_d,
        hyd.dSc_dQ(depth, s.T, s.A, Q, s.n_eq, Rsafe, rc),
        zero,
    )

    return EnergySlope(Se=Sf + Sc, dSe_dA_eff=dSf_dA + dSc_dA, dSe_dQ=dSf_dQ + dSc_dQ)


def normal_flow(g, depth, state: Optional[SectionState] = None):
    """Normal discharge at given depth; 0 where bed slope is unset or <= 0
    (ref: cross_section.py:177-182)."""
    s = state if state is not None else section_state(g, depth)
    S0 = g.bed_slope
    valid = torch.isfinite(S0) & (S0 > 0.0)
    return torch.where(
        valid,
        s.K * torch.sqrt(torch.abs(torch.where(valid, S0, torch.ones_like(S0)))),
        torch.zeros_like(s.K),
    )
