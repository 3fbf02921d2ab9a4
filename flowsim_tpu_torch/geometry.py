"""Channel geometry as struct-of-tensors dataclasses.

Counterpart of ``flowsim_tpu/geometry.py``.  A channel reach is a frozen
dataclass of per-node parameter tensors; all hydraulic closures (see
:mod:`flowsim_tpu_torch.ops.sections`) are vectorized pure functions of
``(geometry, depth)``.

Two representations, as in the JAX package:

* :class:`TrapezoidGeometry` — rectangular / simple-trapezoid /
  compound-trapezoid sections in closed form;
* :class:`TableGeometry` — irregular surveyed (x, z) polyline sections,
  rasterized on the host into per-node lookup tables over a uniform depth
  grid (:mod:`flowsim_tpu_torch.geometry_tables`) and interpolated on the
  device.

Host-side construction (station interpolation, planform curvature) is NumPy
and runs once at setup; the result is placed on the requested device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from flowsim_tpu_torch.config import DEFAULT_DEVICE, DEFAULT_DTYPE, resolve_device


# ---------------------------------------------------------------------------
# Station description (host side, scalar)
# ---------------------------------------------------------------------------


@dataclass
class TrapezoidStation:
    """Scalar parameters of one surveyed/fitted trapezoid section.

    ``h_bank`` is the bankfull depth ``z_bank - z_bed``; ``None`` means a
    simple (non-compound) section.
    """

    z_bed: float
    b_main: float
    m_main: float = 0.0
    n_main: float = 0.03
    h_bank: Optional[float] = None
    b_fp_left: float = 0.0
    b_fp_right: float = 0.0
    m_fp: float = 0.0
    n_left: float = 0.03
    n_right: float = 0.03
    bed_slope: Optional[float] = None
    curvature: float = 0.0


def trapezoid_station(**kwargs) -> TrapezoidStation:
    return TrapezoidStation(**kwargs)


# ---------------------------------------------------------------------------
# Device geometry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrapezoidGeometry:
    """Per-node trapezoid parameters, shape [N] each.

    ``compound`` is a bool mask; where False the floodplain fields are unused
    (``h_bank`` holds a large sentinel so ``depth <= h_bank`` always holds).
    ``bed_slope`` is NaN where the reference would carry ``None``.
    """

    z_bed: torch.Tensor
    b_main: torch.Tensor
    m_main: torch.Tensor
    n_main: torch.Tensor
    compound: torch.Tensor
    h_bank: torch.Tensor
    b_fp_left: torch.Tensor
    b_fp_right: torch.Tensor
    m_fp: torch.Tensor
    n_left: torch.Tensor
    n_right: torch.Tensor
    bed_slope: torch.Tensor
    curvature: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.z_bed.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.z_bed.device

    def _map(self, fn) -> "TrapezoidGeometry":
        return TrapezoidGeometry(
            **{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def to(self, device) -> "TrapezoidGeometry":
        return self._map(lambda v: v.to(device))

    def node(self, i) -> "TrapezoidGeometry":
        """Scalar (0-d) geometry of node ``i``."""
        return self._map(lambda v: v[i])


@dataclass(frozen=True)
class TableGeometry:
    """Per-node lookup tables over a uniform depth grid.

    ``depth_max[n]`` is the table span of node ``n``; tables hold M samples at
    depths ``j * depth_max / (M-1)``.  Values beyond the span extrapolate
    linearly using the last interval.  An ensemble carries a leading member
    axis on every tensor (``[B, N]`` rows, ``[B, N, M]`` tables).
    """

    z_bed: torch.Tensor       # [N]
    depth_max: torch.Tensor   # [N]
    area: torch.Tensor        # [N, M]
    perimeter: torch.Tensor   # [N, M]
    top_width: torch.Tensor   # [N, M]
    conveyance: torch.Tensor  # [N, M]
    n_eq: torch.Tensor        # [N, M]
    dK_dA: torch.Tensor       # [N, M]
    dR_dA: torch.Tensor       # [N, M]
    bed_slope: torch.Tensor   # [N]
    curvature: torch.Tensor   # [N]
    # Build-time main-channel Manning n baked into the conveyance columns
    # (None when the source stations disagree).  Plain metadata, not a
    # tensor: parallel.ensemble.table_roughness_ensemble anchors its exact
    # roughness rescale on it.
    n_ref: Optional[float] = None

    @property
    def n_nodes(self) -> int:
        # area is [..., N, M]; z_bed's first axis is the member axis of an
        # ensemble, so N comes from the table shape
        return self.area.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.z_bed.device

    def _map(self, fn) -> "TableGeometry":
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self) if f.name != "n_ref"})

    def astype(self, dtype) -> "TableGeometry":
        return self._map(lambda v: v.to(dtype))

    def to(self, device) -> "TableGeometry":
        return self._map(lambda v: v.to(device))

    def node(self, i) -> "TableGeometry":
        """Geometry of node ``i``: 0-d rows and ``[M]`` tables."""
        return self._map(lambda v: v[i])


# ---------------------------------------------------------------------------
# Host-side construction
# ---------------------------------------------------------------------------

_SIMPLE_H_BANK_SENTINEL = 1e30


def _station_to_arrays(st: TrapezoidStation) -> dict:
    compound = st.h_bank is not None
    return dict(
        z_bed=st.z_bed,
        b_main=st.b_main,
        m_main=st.m_main,
        n_main=st.n_main,
        compound=compound,
        h_bank=st.h_bank if compound else _SIMPLE_H_BANK_SENTINEL,
        b_fp_left=st.b_fp_left,
        b_fp_right=st.b_fp_right,
        m_fp=st.m_fp,
        n_left=st.n_left,
        n_right=st.n_right,
        bed_slope=np.nan if st.bed_slope is None else st.bed_slope,
        curvature=st.curvature,
    )


def planform_curvature(
    station_chainages: np.ndarray,
    coords_chainages: np.ndarray,
    coords: np.ndarray,
) -> np.ndarray:
    """Planform curvature per station from a centerline polyline.

    Three-point turning-angle formula applied to interior stations; end
    stations keep curvature 0 (ref: channel.py:243-277).
    """
    ch = np.asarray(station_chainages, dtype=float)
    curv = np.zeros_like(ch)
    for i in range(1, len(ch) - 1):
        chs = np.array([ch[i - 1], ch[i], ch[i + 1]])
        xys = np.column_stack(
            [
                np.interp(chs, coords_chainages, coords[:, 0]),
                np.interp(chs, coords_chainages, coords[:, 1]),
            ]
        )
        xy_left, xy, xy_right = xys
        v1 = xy - xy_left
        v2 = xy_right - xy
        if np.linalg.norm(v1) == 0 or np.linalg.norm(v2) == 0:
            curv[i] = 0.0
            continue
        dot = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))
        theta = np.arccos(np.clip(dot, -1.0, 1.0))
        L = 0.5 * (np.linalg.norm(v1) + np.linalg.norm(v2))
        cross = v1[0] * v2[1] - v1[1] * v2[0]
        curv[i] = 2.0 * np.sin(theta / 2.0) / L * np.sign(cross)
    return curv


def _blend_station(a: dict, b: dict, w1: float, w2: float) -> dict:
    """Distance-weighted blend of two trapezoid stations
    (ref: cross_section.py:898-930): parameters blend linearly; bankfull depth
    blends through ``y_bank`` with simple sections contributing 0, and the
    result is simple again if the blended bank depth is <= 1e-6.
    """
    y_bank1 = a["h_bank"] if a["compound"] else 0.0
    y_bank2 = b["h_bank"] if b["compound"] else 0.0
    y_new = y_bank1 * w1 + y_bank2 * w2
    compound = y_new > 1e-6
    if np.isnan(a["bed_slope"]) or np.isnan(b["bed_slope"]):
        bed_slope = np.nan
    else:
        bed_slope = a["bed_slope"] * w1 + b["bed_slope"] * w2
    return dict(
        z_bed=a["z_bed"] * w1 + b["z_bed"] * w2,
        b_main=a["b_main"] * w1 + b["b_main"] * w2,
        m_main=a["m_main"] * w1 + b["m_main"] * w2,
        n_main=a["n_main"] * w1 + b["n_main"] * w2,
        compound=compound,
        h_bank=y_new if compound else _SIMPLE_H_BANK_SENTINEL,
        b_fp_left=a["b_fp_left"] * w1 + b["b_fp_left"] * w2,
        b_fp_right=a["b_fp_right"] * w1 + b["b_fp_right"] * w2,
        m_fp=a["m_fp"] * w1 + b["m_fp"] * w2,
        n_left=a["n_left"] * w1 + b["n_left"] * w2,
        n_right=a["n_right"] * w1 + b["n_right"] * w2,
        bed_slope=bed_slope,
        curvature=a["curvature"] * w1 + b["curvature"] * w2,
    )


def interpolate_stations(
    stations: list[TrapezoidStation],
    chainages: np.ndarray,
    node_chainages: np.ndarray,
    coords: Optional[np.ndarray] = None,
    coords_chainages: Optional[np.ndarray] = None,
    device=DEFAULT_DEVICE,
) -> TrapezoidGeometry:
    """Build per-node geometry tensors by interpolating surveyed stations.

    Replicates ref channel.py:213-241 (node lookup, distance weights, clamping
    to end stations) and channel.py:243-277 (curvature assignment).
    """
    device = resolve_device(device)
    chainages = np.asarray(chainages, dtype=float)
    node_chainages = np.asarray(node_chainages, dtype=float)
    if not np.all(np.diff(chainages) > 0):
        raise ValueError("chainages must be strictly increasing")
    if len(chainages) != len(stations):
        raise ValueError("chainages and stations must have same length")

    sts = [_station_to_arrays(s) for s in stations]
    if coords is not None and coords_chainages is not None:
        curv = planform_curvature(chainages, np.asarray(coords_chainages, float), np.asarray(coords, float))
        # end stations keep their constructor curvature (0 by default),
        # interior stations get the planform value (ref: channel.py:244).
        for i in range(1, len(sts) - 1):
            sts[i]["curvature"] = curv[i]

    rows = []
    for s in node_chainages:
        if s <= chainages[0]:
            rows.append(sts[0])
            continue
        if s >= chainages[-1]:
            rows.append(sts[-1])
            continue
        j = int(np.searchsorted(chainages, s)) - 1
        dist1 = s - chainages[j]
        dist2 = chainages[j + 1] - s
        total = dist1 + dist2
        if total < 1e-9 or dist1 < 1e-9:
            rows.append(sts[j])
        elif dist2 < 1e-9:
            rows.append(sts[j + 1])
        else:
            rows.append(_blend_station(sts[j], sts[j + 1], dist2 / total, dist1 / total))

    def col(name):
        return torch.tensor(np.array([r[name] for r in rows], dtype=np.float64),
                            dtype=DEFAULT_DTYPE, device=device)

    return TrapezoidGeometry(
        z_bed=col("z_bed"),
        b_main=col("b_main"),
        m_main=col("m_main"),
        n_main=col("n_main"),
        compound=torch.tensor(np.array([r["compound"] for r in rows], dtype=bool), device=device),
        h_bank=col("h_bank"),
        b_fp_left=col("b_fp_left"),
        b_fp_right=col("b_fp_right"),
        m_fp=col("m_fp"),
        n_left=col("n_left"),
        n_right=col("n_right"),
        bed_slope=col("bed_slope"),
        curvature=col("curvature"),
    )


def build_trapezoid_geometry(
    n_nodes: int,
    length: float,
    us_z_bed: float,
    ds_z_bed: float,
    width: float,
    roughness: float,
    device=DEFAULT_DEVICE,
) -> TrapezoidGeometry:
    """Provisional prismatic rectangular reach (ref: channel.py:282-294).

    Both end sections are rectangles of the given width/roughness with a
    common bed slope ``(z_us - z_ds)/length``; nodes interpolate linearly.
    """
    bed_slope = (us_z_bed - ds_z_bed) / length
    us = TrapezoidStation(z_bed=us_z_bed, b_main=width, m_main=0.0, n_main=roughness, bed_slope=bed_slope)
    ds = TrapezoidStation(z_bed=ds_z_bed, b_main=width, m_main=0.0, n_main=roughness, bed_slope=bed_slope)
    node_ch = np.linspace(0.0, length, n_nodes)
    return interpolate_stations([us, ds], np.array([0.0, length]), node_ch, device=device)
