"""Irregular (surveyed polyline) sections -> per-node lookup tables (torch).

Counterpart of ``flowsim_tpu/geometry_tables.py``, operation for operation:
the same NumPy on the host, the result a :class:`TableGeometry` of float64
tensors on the requested device.

The reference's ``IrregularSection`` evaluates the wetted polyline per call —
contiguous wetted-segment discovery, water-surface intersection insertion,
trapezoid integration, Horton-Einstein composite roughness over the
left-fp/main/right-fp subsections, and multi-subchannel conveyance
combination (ref: cross_section.py:207-543).  That is data-dependent control
flow which cannot live under jit.

Here all of it runs **once on the host** per node over a dense depth grid,
producing the monotone tables of :class:`flowsim_tpu_torch.geometry.TableGeometry`;
the device interpolates.  Station-to-node interpolation replicates the
reference's union-x-grid blend (ref: cross_section.py:933-968).

Derivative tables (dK/dA, dR/dA) use the reference's own finite-difference
rule (central, dh=1e-6; ref :524-539) so the Jacobian matches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from flowsim_tpu_torch import geometry as geom
from flowsim_tpu_torch.config import DEFAULT_DEVICE, DEFAULT_DTYPE, resolve_device
from flowsim_tpu_torch.geometry import TableGeometry, TrapezoidStation


@dataclass
class IrregularStation:
    """One surveyed cross-section polyline (host side).

    Mirrors the reference ``IrregularSection`` constructor surface
    (ref: cross_section.py:216-237): (x, z) sorted by x; composite-roughness
    subsection limits default to the section extents.
    """

    x: np.ndarray
    z: np.ndarray
    n_main: float = 0.03
    n_left: Optional[float] = None
    n_right: Optional[float] = None
    left_fp_limit: Optional[float] = None
    right_fp_limit: Optional[float] = None
    bed_slope: Optional[float] = None
    curvature: float = 0.0
    # physical z-relief excluding synthetic capped walls (set by
    # blend_stations for mixed trapezoid x irregular blends, whose z
    # includes the finite z_cap substitute for infinite trapezoid walls —
    # z.max - z.min would inflate the default table span ~5-10x and
    # silently coarsen the lookup resolution at real depths)
    relief_hint: Optional[float] = None

    def __post_init__(self):
        x = np.ascontiguousarray(self.x, dtype=float)
        z = np.ascontiguousarray(self.z, dtype=float)
        if x.shape != z.shape or x.ndim != 1:
            raise ValueError("x and z must be equal-shape 1-D arrays")
        # stable sort: vertical walls are expressed as duplicate x values whose
        # relative order is meaningful (rasterized trapezoid sections)
        order = np.argsort(x, kind="stable")
        self.x, self.z = x[order], z[order]
        self.n_left = self.n_main if self.n_left is None else self.n_left
        self.n_right = self.n_main if self.n_right is None else self.n_right
        self.left_fp_limit = self.x[0] if self.left_fp_limit is None else self.left_fp_limit
        self.right_fp_limit = self.x[-1] if self.right_fp_limit is None else self.right_fp_limit

    @property
    def z_min(self) -> float:
        return float(self.z.min())

    def z_at(self, xq):
        return np.interp(xq, self.x, self.z, left=self.z[0], right=self.z[-1])


# ---------------------------------------------------------------------------
# Polyline hydraulics (host, NumPy) — reference-equivalent evaluations
# ---------------------------------------------------------------------------


def _wet_segments(x, z, hw):
    """Contiguous wetted runs incl. water-surface intersections
    (ref: cross_section.py:269-305)."""
    below = (hw - z) > 0.0
    if not below.any() or hw <= z.min():
        return []
    segs = []
    n = len(below)
    i = 0
    while i < n:
        if below[i]:
            start = i
            while i + 1 < n and below[i + 1]:
                i += 1
            end = i
            xs = x[start : end + 1].copy()
            zs = z[start : end + 1].copy()
            if start > 0 and z[start - 1] > hw:
                t = (hw - z[start - 1]) / (z[start] - z[start - 1])
                xs = np.insert(xs, 0, x[start - 1] + t * (x[start] - x[start - 1]))
                zs = np.insert(zs, 0, hw)
            if end < n - 1 and z[end + 1] > hw:
                t = (hw - z[end]) / (z[end + 1] - z[end])
                xs = np.append(xs, x[end] + t * (x[end + 1] - x[end]))
                zs = np.append(zs, hw)
            segs.append((xs, zs))
        i += 1
    return segs


def polyline_properties(x, z, hw):
    """(A, P, R, T) of a polyline at water level hw (ref :247-329)."""
    A = P = T = 0.0
    for xs, zs in _wet_segments(x, z, hw):
        d = np.maximum(hw - zs, 0.0)
        A += float(np.sum(0.5 * (d[:-1] + d[1:]) * np.diff(xs)))
        P += float(np.sum(np.sqrt(np.diff(xs) ** 2 + np.diff(zs) ** 2)))
        T += float(xs[-1] - xs[0])
    R = A / P if P > 0 else 0.0
    return A, P, R, T


def _subsection_AK(x, z, hw, x_min, x_max, n_value):
    """(A, R, K) of the [x_min, x_max] subsection (ref :450-473)."""
    mask = (x >= x_min) & (x <= x_max)
    if mask.sum() < 2:
        return 0.0, 0.0, 0.0
    A, P, R, _ = polyline_properties(x[mask], z[mask], hw)
    if A <= 0 or P <= 0:
        return 0.0, 0.0, 0.0
    K = A * R ** (2.0 / 3.0) / n_value
    return A, R, K


def equivalent_n(st: IrregularStation, hw):
    """Horton-Einstein composite n over left/main/right (ref :443-501)."""
    A, P, _, _ = polyline_properties(st.x, st.z, hw)
    if A <= 0 or P <= 0:
        return st.n_main
    _, _, K_l = _subsection_AK(st.x, st.z, hw, st.x[0], st.left_fp_limit, st.n_left)
    _, _, K_m = _subsection_AK(st.x, st.z, hw, st.left_fp_limit, st.right_fp_limit, st.n_main)
    _, _, K_r = _subsection_AK(st.x, st.z, hw, st.right_fp_limit, st.x[-1], st.n_right)
    K_tot = (K_l ** 1.5 + K_m ** 1.5 + K_r ** 1.5) ** (2.0 / 3.0)
    if K_tot <= 0:
        return st.n_main
    R = A / P
    return A * R ** (2.0 / 3.0) / K_tot


def conveyance(st: IrregularStation, hw):
    """Equivalent-n full-section conveyance (ref :503-511)."""
    A, P, R, _ = polyline_properties(st.x, st.z, hw)
    if A <= 0:
        return 0.0
    return A * R ** (2.0 / 3.0) / equivalent_n(st, hw)


def _subchannels(x, z, hw):
    """Contiguous wetted subchannels, replicating ref get_subchannels
    (:331-371): raw-node wetness ``z < hw``, runs of >= 2 points kept, and
    its exact water-surface intersection rules."""
    wet = z < hw
    subs = []
    i = 0
    n = len(wet)
    while i < n:
        if not wet[i]:
            i += 1
            continue
        start = i
        while i < n and wet[i]:
            i += 1
        end = i  # one past last wet index
        if (end - start) < 2:
            continue
        xs = x[start:end].copy()
        zs = z[start:end].copy()
        if start > 0 and z[start - 1] > hw:
            x0 = np.interp(hw, [z[start - 1], z[start]], [x[start - 1], x[start]])
            xs = np.insert(xs, 0, x0)
            zs = np.insert(zs, 0, hw)
        if end < n and z[end - 1] < hw and z[end] > hw:
            x1 = np.interp(hw, [z[end - 1], z[end]], [x[end - 1], x[end]])
            xs = np.append(xs, x1)
            zs = np.append(zs, hw)
        subs.append((xs, zs))
    return subs


def effective_conveyance(st: IrregularStation, hw):
    """Friction-law conveyance: multi-subchannel Horton combination when the
    section splits into several wetted subchannels (ref :373-394), otherwise
    the plain equivalent-n conveyance."""
    subs = _subchannels(st.x, st.z, hw)
    if len(subs) <= 1:
        return conveyance(st, hw)
    K_sum = 0.0
    for xs, zs in subs:
        sub = _sub_station(st, xs, zs)
        K_sum += conveyance(sub, hw) ** 1.5
    return K_sum ** (2.0 / 3.0)


def _sub_station(st: IrregularStation, xs, zs) -> IrregularStation:
    """A wetted subchannel as its own station, inheriting the parent's
    roughness parameters (ref :408-409 set_roughness_para)."""
    return IrregularStation(x=xs, z=zs, n_main=st.n_main, n_left=st.n_left,
                            n_right=st.n_right, left_fp_limit=st.left_fp_limit,
                            right_fp_limit=st.right_fp_limit)


def _dK_dA_single(a, r, drda, n):
    """Single-channel dK/dA (ref hydraulics dK_dA_; ref :513-523)."""
    return (r ** (2.0 / 3.0) + a * (2.0 / 3.0) * r ** (-1.0 / 3.0) * drda) / n


def _split_K_and_dK_dA(st: IrregularStation, subs, hw, fd_dh):
    """(K_eq, dK_eq/dA) of a section split into wetted subchannels.

    K_eq = (sum K_j^1.5)^(2/3) and its derivative combines the
    per-subchannel single-channel derivatives exactly as the reference's
    multi-subchannel dSf_dA (ref cross_section.py:395-420):
    dK_dA_eq = (2/3) K_sum^(-1/3) * sum 1.5 K_j^0.5 dK_dA_j.
    """
    K_sum = 0.0
    d_sum = 0.0
    for xs, zs in subs:
        sub = _sub_station(st, xs, zs)
        a_j, p_j, r_j, _ = polyline_properties(xs, zs, hw)
        if a_j <= 0 or p_j <= 0:
            continue
        K_j = conveyance(sub, hw)
        n_j = equivalent_n(sub, hw)
        a1, _, r1, _ = polyline_properties(xs, zs, hw - fd_dh)
        a2, _, r2, _ = polyline_properties(xs, zs, hw + fd_dh)
        drda_j = (r2 - r1) / (a2 - a1) if a2 != a1 else 0.0
        K_sum += K_j ** 1.5
        d_sum += 1.5 * K_j ** 0.5 * _dK_dA_single(a_j, r_j, drda_j, n_j)
    if K_sum <= 0.0:
        return 0.0, 0.0
    return K_sum ** (2.0 / 3.0), (2.0 / 3.0) * K_sum ** (-1.0 / 3.0) * d_sum


# ---------------------------------------------------------------------------
# Trapezoid stations as lateral profiles (mixed-pair interpolation support)
# ---------------------------------------------------------------------------


def trapezoid_z_profile(st, xq, z_cap=np.inf):
    """Bed elevation of a :class:`~flowsim_tpu_torch.geometry.TrapezoidStation` at
    lateral coordinates ``xq``, centered on the main channel.

    Vectorized replication of the reference's ``TrapezoidalSection.z_at``
    (ref cross_section.py:795-846).  The reference returns ``inf`` on vertical
    walls (rectangles; zero-slope outer floodplain walls) which poisons a
    blended polyline with inf/NaN; ``z_cap`` substitutes a finite wall height
    instead (deliberate hardening — pass ``np.inf`` for literal parity).
    """
    xq = np.asarray(xq, dtype=float)
    compound = st.h_bank is not None
    b2 = st.b_main / 2.0

    def wall(dist, m):
        with np.errstate(divide="ignore", invalid="ignore"):
            z = np.where(m > 0.0, st.z_bed + dist / max(m, 1e-300), z_cap)
        return np.minimum(z, z_cap)

    if not compound:
        if st.m_main == 0.0:  # rectangle: vertical walls (ref :799-803)
            return np.where((xq > -b2) & (xq < b2), st.z_bed, z_cap)
        inside = (xq >= -b2) & (xq <= b2)
        return np.where(inside, st.z_bed, wall(np.abs(xq) - b2, st.m_main))

    z_bank = st.z_bed + st.h_bank
    T_bank = st.b_main + 2.0 * st.m_main * st.h_bank
    lfl, rfl = -T_bank / 2.0, T_bank / 2.0

    z = np.full_like(xq, z_bank, dtype=float)
    in_main = (xq >= lfl) & (xq <= rfl)
    z = np.where(in_main & (np.abs(xq) <= b2), st.z_bed, z)
    bank = in_main & (np.abs(xq) > b2)
    z = np.where(bank, wall(np.abs(xq) - b2, st.m_main), z)

    def fp_wall(dist):
        if st.m_fp > 0.0:
            return np.minimum(z_bank + dist / st.m_fp, z_cap)
        return np.full_like(dist, z_cap)

    left_out = xq < lfl - st.b_fp_left
    right_out = xq > rfl + st.b_fp_right
    z = np.where(left_out, fp_wall((lfl - st.b_fp_left) - xq), z)
    z = np.where(right_out, fp_wall(xq - (rfl + st.b_fp_right)), z)
    return z


def trapezoid_as_irregular(st, depth_cap: float) -> IrregularStation:
    """Exact breakpoint polyline of a trapezoid station up to ``depth_cap``.

    The polyline reproduces the trapezoid's A(h)/T(h) exactly for
    h <= depth_cap (piecewise-linear geometry); vertical walls become
    duplicate-x points.  Composite-roughness limits follow the reference
    (compound: +-T_bank/2, ref cross_section.py:594-595; simple: +-inf,
    ref :608-609).
    """
    compound = st.h_bank is not None
    b2 = st.b_main / 2.0
    if compound:
        depth_cap = max(depth_cap, st.h_bank * 1.5)
    z_top = st.z_bed + depth_cap

    if not compound:
        dx_wall = st.m_main * depth_cap
        x = np.array([-(b2 + dx_wall), -b2, b2, b2 + dx_wall])
        z = np.array([z_top, st.z_bed, st.z_bed, z_top])
        lfl, rfl = -np.inf, np.inf
    else:
        z_bank = st.z_bed + st.h_bank
        T_bank = st.b_main + 2.0 * st.m_main * st.h_bank
        lfl, rfl = -T_bank / 2.0, T_bank / 2.0
        d_fp = depth_cap - st.h_bank
        dx_fp_wall = st.m_fp * d_fp
        x = np.array([
            lfl - st.b_fp_left - dx_fp_wall, lfl - st.b_fp_left,
            lfl, -b2, b2, rfl,
            rfl + st.b_fp_right, rfl + st.b_fp_right + dx_fp_wall,
        ])
        z = np.array([z_top, z_bank, z_bank, st.z_bed, st.z_bed, z_bank,
                      z_bank, z_top])
    return IrregularStation(
        x=x, z=z, n_main=st.n_main, n_left=st.n_left, n_right=st.n_right,
        left_fp_limit=lfl, right_fp_limit=rfl,
        bed_slope=st.bed_slope, curvature=st.curvature,
    )


def _profile_of(st, x_master, z_cap):
    if isinstance(st, IrregularStation):
        return st.z_at(x_master)
    return trapezoid_z_profile(st, x_master, z_cap=z_cap)


def _fp_limits_of(st):
    if isinstance(st, IrregularStation):
        return st.left_fp_limit, st.right_fp_limit
    compound = st.h_bank is not None
    if compound:
        T_bank = st.b_main + 2.0 * st.m_main * st.h_bank
        return -T_bank / 2.0, T_bank / 2.0  # ref cross_section.py:594-595
    return -np.inf, np.inf                  # ref cross_section.py:608-609


# ---------------------------------------------------------------------------
# Station interpolation (union-x blend; ref :933-968)
# ---------------------------------------------------------------------------


def blend_stations(s1, s2, w1: float, w2: float) -> IrregularStation:
    """Distance-weighted blend of two stations onto the union x grid
    (ref cross_section.py:933-968).  Either station may be a
    :class:`~flowsim_tpu_torch.geometry.TrapezoidStation`; its lateral profile is
    evaluated analytically (ref's mixed-pair path calls the trapezoid's
    ``z_at`` on the irregular partner's grid)."""
    if isinstance(s1, TrapezoidStation) and isinstance(s2, TrapezoidStation):
        raise TypeError("trapezoid x trapezoid pairs blend analytically; "
                        "use geometry._blend_station")

    xs = [s.x for s in (s1, s2) if isinstance(s, IrregularStation)]
    x_master = xs[0] if len(xs) == 1 else np.union1d(*xs)

    # finite wall height for the reference's inf walls: far above any
    # water level the tables can ever see
    z_fin = np.concatenate([s.z for s in (s1, s2) if isinstance(s, IrregularStation)])
    relief = float(z_fin.max() - z_fin.min()) if z_fin.size else 1.0
    z_cap = float(z_fin.max()) + 10.0 * (relief + 1.0)

    z_new = _profile_of(s1, x_master, z_cap) * w1 + _profile_of(s2, x_master, z_cap) * w2
    # mixed pairs: the blended z contains the synthetic z_cap walls, so the
    # physical relief for default table spans comes from the parents — the
    # irregular partner's true relief, floored by a compound trapezoid's
    # 1.5*h_bank (the same rule pure-trapezoid nodes use below in
    # build_table_geometry)
    relief_hint = None
    if any(isinstance(s, TrapezoidStation) for s in (s1, s2)):
        relief_hint = relief
        for s in (s1, s2):
            if isinstance(s, TrapezoidStation) and s.h_bank is not None:
                relief_hint = max(relief_hint, float(s.h_bank) * 1.5)
    if s1.bed_slope is None or s2.bed_slope is None:
        bed_slope = None
    else:
        bed_slope = s1.bed_slope * w1 + s2.bed_slope * w2
    l1, r1 = _fp_limits_of(s1)
    l2, r2 = _fp_limits_of(s2)
    return IrregularStation(
        x=x_master, z=z_new, relief_hint=relief_hint,
        n_main=s1.n_main * w1 + s2.n_main * w2,
        n_left=s1.n_left * w1 + s2.n_left * w2,
        n_right=s1.n_right * w1 + s2.n_right * w2,
        left_fp_limit=l1 * w1 + l2 * w2,
        right_fp_limit=r1 * w1 + r2 * w2,
        bed_slope=bed_slope,
        curvature=s1.curvature * w1 + s2.curvature * w2,
    )


def _blend_any(a, b, w1, w2):
    """Blend two stations of any type (ref interpolate_cross_section
    dispatch, cross_section.py:898-968): trapezoid x trapezoid stays
    analytic-trapezoid; any pair involving an irregular becomes irregular."""
    if isinstance(a, geom.TrapezoidStation) and isinstance(b, geom.TrapezoidStation):
        d = geom._blend_station(geom._station_to_arrays(a), geom._station_to_arrays(b), w1, w2)
        return geom.TrapezoidStation(
            z_bed=d["z_bed"], b_main=d["b_main"], m_main=d["m_main"],
            n_main=d["n_main"], h_bank=d["h_bank"] if d["compound"] else None,
            b_fp_left=d["b_fp_left"], b_fp_right=d["b_fp_right"], m_fp=d["m_fp"],
            n_left=d["n_left"], n_right=d["n_right"],
            bed_slope=None if np.isnan(d["bed_slope"]) else d["bed_slope"],
            curvature=d["curvature"],
        )
    return blend_stations(a, b, w1, w2)


def stations_at_nodes(stations, chainages, node_chainages):
    """The station of each node: an end station outside the chainages, the
    station itself on one, else the blend of the two around it."""
    for st in stations:
        if not isinstance(st, (IrregularStation, TrapezoidStation)):
            raise TypeError(f"unknown station class {type(st).__name__!r}: "
                            "expected IrregularStation or TrapezoidStation")
    chainages = np.asarray(chainages, dtype=float)
    out = []
    for s in np.asarray(node_chainages, dtype=float):
        if s <= chainages[0]:
            out.append(stations[0])
        elif s >= chainages[-1]:
            out.append(stations[-1])
        else:
            j = int(np.searchsorted(chainages, s)) - 1
            d1, d2 = s - chainages[j], chainages[j + 1] - s
            tot = d1 + d2
            if tot < 1e-9 or d1 < 1e-9:
                out.append(stations[j])
            elif d2 < 1e-9:
                out.append(stations[j + 1])
            else:
                out.append(_blend_any(stations[j], stations[j + 1], d2 / tot, d1 / tot))
    return out


# ---------------------------------------------------------------------------
# Rasterization -> TableGeometry
# ---------------------------------------------------------------------------


def _trapezoid_station_tables(st, depths):
    """Table rows for a trapezoid station from the analytic closures of
    :mod:`flowsim_tpu_torch.ops.sections`, evaluated on the CPU (exact parity
    with the reference's ``TrapezoidalSection``, compound quirks included)."""
    from flowsim_tpu_torch.ops import sections as sec

    arrs = geom._station_to_arrays(st)
    M = len(depths)
    fields = {}
    for k, v in arrs.items():
        if k == "compound":
            fields[k] = torch.full((M,), bool(v))
        else:
            fields[k] = torch.full((M,), float(v), dtype=DEFAULT_DTYPE)
    g = geom.TrapezoidGeometry(**fields)
    s = sec.section_state(g, torch.as_tensor(np.asarray(depths, dtype=np.float64)))
    return tuple(t.numpy() for t in (s.A, s.P, s.T, s.K, s.n_eq, s.dK_dA, s.dR_dA))


def build_table_geometry(
    stations,
    chainages,
    node_chainages,
    depth_max=None,
    samples: int = 1024,
    fd_dh: float = 1e-6,
    device=DEFAULT_DEVICE,
) -> TableGeometry:
    """Rasterize per-node irregular sections into lookup tables on ``device``.

    ``depth_max``: table span per node (scalar or [N]); defaults to the
    polyline relief (z.max - z.min) plus 25% freeboard.

    Mixed station lists are supported (ref cross_section.py:852-968): nodes
    whose bracketing stations are both trapezoids keep the analytic trapezoid
    closures (sampled into tables, including the reference's compound-section
    quirks); nodes involving an irregular station use the union-grid polyline
    blend.  ``depth_max`` for a pure-trapezoid node defaults to the largest
    irregular relief in the list.
    """
    device = resolve_device(device)
    node_sts = stations_at_nodes(stations, chainages, node_chainages)
    N = len(node_sts)
    M = samples

    dmax = np.full(N, np.nan)
    for i, st in enumerate(node_sts):
        if depth_max is not None:
            dmax[i] = depth_max if np.isscalar(depth_max) else depth_max[i]
        elif isinstance(st, IrregularStation):
            relief = (st.relief_hint if st.relief_hint is not None
                      else float(st.z.max() - st.z.min()))
            dmax[i] = relief * 1.25
    if np.isnan(dmax).any():
        fallback = np.nanmax(dmax) if np.isfinite(dmax).any() else None
        for i, st in enumerate(node_sts):
            if np.isnan(dmax[i]):
                if fallback is None:
                    raise ValueError(
                        "depth_max is required for a pure-trapezoid station list"
                    )
                d = fallback
                if isinstance(st, TrapezoidStation) and st.h_bank is not None:
                    d = max(d, st.h_bank * 1.5)
                dmax[i] = d

    A = np.zeros((N, M))
    P = np.zeros((N, M))
    T = np.zeros((N, M))
    K = np.zeros((N, M))
    n_eq = np.zeros((N, M))
    dK_dA = np.zeros((N, M))
    dR_dA = np.zeros((N, M))
    z_bed = np.array([
        st.z_bed if isinstance(st, TrapezoidStation) else st.z_min for st in node_sts
    ])
    bed_slope = np.array([np.nan if st.bed_slope is None else st.bed_slope for st in node_sts])
    curvature = np.array([st.curvature for st in node_sts])

    from flowsim_tpu_torch import native

    use_native = native.available()

    for i, st in enumerate(node_sts):
        depths = np.linspace(0.0, dmax[i], M)
        if isinstance(st, TrapezoidStation):
            (A[i], P[i], T[i], K[i], n_eq[i], dK_dA[i], dR_dA[i]) = \
                _trapezoid_station_tables(st, depths)
            continue
        if use_native:
            # C rasterizer for the A/P/T sweep (the per-sample inner loop)
            A[i], P[i], T[i] = native.polyline_tables(st.x, st.z, depths)
        for j, d in enumerate(depths):
            hw = st.z_min + d
            if use_native:
                a, p, t = A[i, j], P[i, j], T[i, j]
                r = a / p if p > 0 else 0.0
            else:
                a, p, r, t = polyline_properties(st.x, st.z, hw)
                A[i, j], P[i, j], T[i, j] = a, p, t
            if a > 0:
                n_eq[i, j] = equivalent_n(st, hw)
                # reference finite differences on the full section
                # (ref :524-539); dR/dA is always full-section
                a1, _, r1, _ = polyline_properties(st.x, st.z, hw - fd_dh)
                a2, _, r2, _ = polyline_properties(st.x, st.z, hw + fd_dh)
                drda = (r2 - r1) / (a2 - a1) if a2 != a1 else 0.0
                dR_dA[i, j] = drda
                subs = _subchannels(st.x, st.z, hw)
                if len(subs) <= 1:
                    # K = A R^(2/3) / n_eq from the already-computed values
                    # (effective_conveyance would redo the sweep + the
                    # equivalent_n sweeps a second time)
                    K[i, j] = a * r ** (2.0 / 3.0) / n_eq[i, j]
                    dK_dA[i, j] = _dK_dA_single(a, r, drda, n_eq[i, j])
                else:
                    # split section: Horton combination of the wetted
                    # subchannels for BOTH K and its derivative — the
                    # composite dK/dA must differentiate the composite K
                    # (ref cross_section.py:373-394 and :395-420)
                    K[i, j], dK_dA[i, j] = _split_K_and_dK_dA(
                        st, subs, hw, fd_dh)
            else:
                n_eq[i, j] = st.n_main

    # the main-channel Manning n baked into the conveyance columns; recorded
    # on the geometry so roughness-ensemble rescales can anchor on it
    # (None when the stations disagree — callers must then pass it
    # explicitly).  Station blending carries ulp-level float
    # noise, so compare with a relative tolerance rather than exact equality.
    n_mains = np.array([float(st.n_main) for st in node_sts])
    n_ref = (float(n_mains[0])
             if np.allclose(n_mains, n_mains[0], rtol=1e-9, atol=0.0)
             else None)

    t = lambda a: torch.tensor(a, dtype=DEFAULT_DTYPE, device=device)
    return TableGeometry(
        n_ref=n_ref,
        z_bed=t(z_bed),
        depth_max=t(dmax),
        area=t(A),
        perimeter=t(P),
        top_width=t(T),
        conveyance=t(K),
        n_eq=t(n_eq),
        dK_dA=t(dK_dA),
        dR_dA=t(dR_dA),
        bed_slope=t(bed_slope),
        curvature=t(curvature),
    )
