"""High-level user API of the port.

Counterpart of ``flowsim_tpu/api.py`` for the single-reach Preissmann path:
``Hydrograph`` / ``RatingCurve`` / ``LumpedStorage`` / ``Boundary`` /
``Channel`` / ``PreissmannSolver``.  Host objects collect configuration; the
solver lowers them to (geometry, boundary params, settings) tensors on its
device and runs one of two engines:

* ``engine="plain"`` — the eager scan-of-Newton of ``ops/preissmann.py`` (the
  counterpart of the JAX package's ``"xla"`` engine);
* ``engine="fused"`` — the whole simulation as one CUDA kernel launch
  (``ops/cuda/fused_newton.py``).

Deliberate difference from the JAX api: there ``engine="fused"`` silently
falls back to the XLA engine when the configuration is outside the kernel's
scope; here ``FusedUnsupported`` reaches the caller.

``Channel.set_cross_sections`` takes ``TrapezoidStation``s (closed-form
sections) or ``IrregularStation``s (surveyed polylines), alone or mixed; a
list with an irregular station lowers to a ``TableGeometry``.

``device`` defaults to ``"cuda"`` and raises when there is no CUDA device;
pass ``device="cpu"`` explicitly to run on the host.

River networks: ``Junction`` marks a channel end that meets a junction and
``NetworkSolver`` runs the network engines of ``ops/network.py`` (``"loop"``,
``"stacked"``, ``"fused"``); here too ``FusedUnsupported`` reaches the caller.

Not ported yet: ``LaxSolver``, result export (``prepare_results`` /
``save_results``, and the per-branch ``NetworkSolver.branch`` / ``summary`` /
``save_results`` that need it; ROADMAP.md Queue 1 items 12 and 14).
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Optional

import numpy as np
import torch

from flowsim_tpu_torch import geometry as geom
from flowsim_tpu_torch.geometry_tables import build_table_geometry
from flowsim_tpu_torch.config import DEFAULT_DEVICE, DEFAULT_DTYPE, resolve_device
from flowsim_tpu_torch.ops import boundary as bnd
from flowsim_tpu_torch.ops import hydraulics as hyd
from flowsim_tpu_torch.ops import initial_conditions as ic
from flowsim_tpu_torch.ops import network as net
from flowsim_tpu_torch.ops import preissmann as prs
from flowsim_tpu_torch.ops import rating_curve as rcurve
from flowsim_tpu_torch.ops import sections as sec
from flowsim_tpu_torch.ops import storage as storage_mod


class Hydrograph:
    """Forcing time series Q(t) or stage(t) (ref: hydrograph.py:3-33).

    Either a table (linear interpolation) or an arbitrary Python function;
    solvers sample it on the host at the discrete times k*dt.
    """

    def __init__(self, function: Optional[Callable] = None, table=None):
        self.table = None if table is None else np.asarray(table, dtype=np.float64)
        self.function = function

    def get_at(self, time):
        if self.function is not None:
            return self.function(time)
        if self.table is None:
            raise ValueError("Hydrograph is not defined.")
        return float(np.interp(time, self.table[:, 0], self.table[:, 1]))

    def set_table(self, table):
        self.table = np.asarray(table, dtype=np.float64)

    def set_function(self, func):
        self.function = func

    def sample(self, times) -> np.ndarray:
        return np.asarray([self.get_at(t) for t in np.asarray(times)], dtype=np.float64)


class RatingCurve:
    """Host wrapper over :mod:`flowsim_tpu_torch.ops.rating_curve` params
    (ref: rating_curve.py:3-162).  The params are kept on the CPU; a solver
    moves them to its device when it lowers the boundary."""

    def __init__(self, params: Optional[rcurve.RatingCurveParams] = None):
        self.params = params

    @property
    def defined(self):
        return self.params is not None

    def set(self, type, a, b, c=None, stage_shift=None):
        shift = 0.0 if stage_shift is None else stage_shift
        if type == "polynomial":
            if c is None:
                raise ValueError("Insufficient arguments. c must be specified.")
            self.params = rcurve.make_polynomial(a, b, c, stage_shift=shift, device="cpu")
        elif type == "power":
            self.params = rcurve.make_power(a, b, stage_shift=shift, device="cpu")
        else:
            raise ValueError("Invalid type.")

    def fit(self, discharges, stages, stage_shift=0.0, type="polynomial", degree=2):
        self.params = rcurve.fit(discharges, stages, stage_shift=stage_shift, type=type,
                                 degree=degree, device="cpu")

    def _stage(self, stage):
        return torch.as_tensor(stage, dtype=DEFAULT_DTYPE, device=self.params.coeffs.device)

    def discharge(self, stage, time=None):
        return float(rcurve.discharge(self.params, self._stage(stage)))

    def stage(self, discharge, trial_stage=None, time=None, tolerance=1e-2, rate=1.0):
        return float(
            rcurve.inverse_stage(self.params, discharge, trial_stage=trial_stage, tolerance=tolerance, rate=rate)
        )

    def dQ_dz(self, stage, time=None):
        return float(rcurve.dQ_dz(self.params, self._stage(stage)))


class LumpedStorage:
    """0-D reservoir config (ref: lumped_storage.py:7-23)."""

    def __init__(self, solution_boundaries=(0.0, 200.0), surface_area=None, min_stage=None,
                 rating_curve: Optional[RatingCurve] = None):
        self.solution_boundaries = solution_boundaries
        self.surface_area = surface_area
        self.min_stage = -math.inf if min_stage is None else min_stage
        self.rating_curve = rating_curve
        self.area_curve = None
        self.alpha = 1.0
        self.beta = 0.0
        self.capture_losses = False
        self.reservoir_length = 0.0
        self.K_q = 0.0

    def set_area_curve(self, table, alpha=1.0, beta=0.0):
        self.area_curve = np.asarray(table, dtype=np.float64)
        self.alpha = alpha
        self.beta = beta

    def build(self, device=DEFAULT_DEVICE) -> storage_mod.StorageParams:
        return storage_mod.make_storage(
            surface_area=self.surface_area,
            min_stage=self.min_stage,
            solution_boundaries=self.solution_boundaries,
            area_curve=self.area_curve,
            alpha=self.alpha,
            beta=self.beta,
            rating=None if self.rating_curve is None else self.rating_curve.params,
            capture_losses=self.capture_losses,
            reservoir_length=self.reservoir_length,
            K_q=self.K_q,
            device=device,
        )


class Boundary:
    """Channel boundary (ref: boundary.py:7-54)."""

    def __init__(
        self,
        condition: str,
        chainage,
        bed_level: Optional[float] = None,
        initial_depth: Optional[float] = None,
        rating_curve=None,
        hydrograph: Optional[Hydrograph] = None,
    ):
        if condition not in bnd.KINDS:
            raise ValueError("Invalid boundary condition.")
        self.condition = condition
        self.chainage = chainage
        self.bed_level = bed_level
        self.initial_depth = initial_depth
        self.initial_stage = None if initial_depth is None or bed_level is None else bed_level + initial_depth
        self.rating_curve = rating_curve
        self.hydrograph = hydrograph
        self.lumped_storage: Optional[LumpedStorage] = None

    def set_lumped_storage(self, lumped_storage: LumpedStorage):
        self.lumped_storage = lumped_storage

    def condition_type(self) -> bool:
        return self.condition in bnd.Q_TYPE_KINDS

    def build(self, times, bed_level, bed_slope, device=DEFAULT_DEVICE) -> bnd.BoundaryParams:
        """Lower to device params; hydrographs sampled at the solver times."""
        series = None
        if self.condition in ("flow_hydrograph", "stage_hydrograph"):
            if self.hydrograph is None:
                raise ValueError(f"{self.condition} boundary needs a hydrograph")
            series = self.hydrograph.sample(times)
        rating = None
        if self.condition == "rating_curve":
            if self.rating_curve is None:
                raise ValueError("rating_curve boundary needs a rating curve")
            rating = self.rating_curve.params if isinstance(self.rating_curve, RatingCurve) else self.rating_curve
        storage = None if self.lumped_storage is None else self.lumped_storage.build(device=device)
        return bnd.make_boundary(
            kind=self.condition,
            bed_level=bed_level,
            bed_slope=bed_slope,
            initial_depth=np.nan if self.initial_depth is None else self.initial_depth,
            target_series=series,
            rating=rating,
            storage=storage,
            device=device,
        )


class Channel:
    """Reach assembly (ref: channel.py:7-51)."""

    def __init__(
        self,
        upstream_boundary: Boundary,
        downstream_boundary: Boundary,
        initial_flow: float,
        roughness: Optional[float] = None,
        width: Optional[float] = None,
        interpolation_method: str = "GVF_equation",
    ):
        if interpolation_method not in ("linear", "GVF_equation", "steady-state"):
            raise ValueError("Invalid interpolation method.")
        self.upstream_boundary = upstream_boundary
        self.downstream_boundary = downstream_boundary
        self.initial_flow_rate = initial_flow
        self.roughness = roughness
        self.width = width
        self.interpolation_method = interpolation_method
        self.length = downstream_boundary.chainage - upstream_boundary.chainage
        self.xs_chainages = None
        self.input_stations = None
        self.coords = None
        self.coords_chainages = None
        # populated by a solver
        self.geometry = None   # TrapezoidGeometry or TableGeometry
        self.ch_at_node = None
        self.initial_conditions = None

    def set_cross_sections(self, chainages, sections):
        chainages = np.asarray(chainages, dtype=float)
        if len(chainages) != len(sections):
            raise ValueError("chainages and sections must have same length")
        if not np.all(np.diff(chainages) > 0):
            raise ValueError("chainages must be strictly increasing")
        self.xs_chainages = chainages
        self.input_stations = list(sections)

    def set_coords(self, coords, chainages):
        self.coords = np.asarray(coords, dtype=np.float64)
        self.coords_chainages = np.asarray(chainages, dtype=np.float64)

    # -- lowering ----------------------------------------------------------

    def build_geometry(self, n_nodes: int, device=DEFAULT_DEVICE):
        self.ch_at_node = np.linspace(self.upstream_boundary.chainage, self.downstream_boundary.chainage, n_nodes)
        if self.xs_chainages is None:
            # provisional prismatic rectangle (ref channel.py:282-294)
            self.geometry = geom.build_trapezoid_geometry(
                n_nodes=n_nodes,
                length=self.length,
                us_z_bed=self.upstream_boundary.bed_level,
                ds_z_bed=self.downstream_boundary.bed_level,
                width=self.width,
                roughness=self.roughness,
                device=device,
            )
            return self.geometry

        if all(isinstance(s, geom.TrapezoidStation) for s in self.input_stations):
            self.geometry = geom.interpolate_stations(
                self.input_stations,
                self.xs_chainages,
                self.ch_at_node,
                coords=self.coords,
                coords_chainages=self.coords_chainages,
                device=device,
            )
        else:
            # irregular-only or mixed trapezoid/irregular lists both lower to
            # per-node lookup tables: trapezoid-bracketed nodes sample the
            # analytic closures, pairs involving an irregular station blend on
            # the union x grid (ref cross_section.py:852-968)
            stations = list(self.input_stations)
            if self.coords is not None and self.coords_chainages is not None:
                curv = geom.planform_curvature(self.xs_chainages, self.coords_chainages, self.coords)
                # copy before stamping curvature: the station objects are
                # caller-owned and may be reused for another Channel (with
                # different or no coords)
                for i in range(1, len(stations) - 1):
                    stations[i] = copy.copy(stations[i])
                    stations[i].curvature = float(curv[i])
            self.geometry = build_table_geometry(stations, self.xs_chainages, self.ch_at_node, device=device)
        return self.geometry

    def initialize_conditions(self, n_nodes: int, dx: float, device=DEFAULT_DEVICE):
        g = self.geometry
        if g is None or g.n_nodes != n_nodes or g.device != resolve_device(device):
            g = self.build_geometry(n_nodes, device=device)
        h, Q = ic.initial_conditions(
            g,
            self.interpolation_method,
            self.initial_flow_rate,
            dx,
            h_us=self.upstream_boundary.initial_depth,
            h_ds=self.downstream_boundary.initial_depth,
        )
        self.initial_conditions = np.stack([h.cpu().numpy(), Q.cpu().numpy()], axis=1)
        return h, Q

    # per-node accessors matching the reference Channel surface
    def _section_at(self, i, hw):
        g = self.geometry.node(i)
        return sec.section_state(g, torch.as_tensor(hw, dtype=DEFAULT_DTYPE, device=g.device) - g.z_bed)

    def area_at(self, i, hw):
        return float(self._section_at(i, hw).A)

    def top_width(self, i, hw):
        return float(self._section_at(i, hw).T)

    def bed_level_at(self, i):
        return float(self.geometry.z_bed[i])

    def dA_dh(self, i, hw):
        """dA/dh (= top width) at node i (ref channel.py:186-190)."""
        return float(self._section_at(i, hw).dA_dh)

    def _slope_at(self, h, Q, i):
        g = self.geometry.node(i)
        t = lambda v: torch.as_tensor(v, dtype=DEFAULT_DTYPE, device=g.device)
        return sec.energy_slope(g, t(h), t(Q))

    def Se(self, h, Q, i):
        """Energy slope Se = Sf + Sc at node i (ref channel.py:53-69)."""
        return float(self._slope_at(h, Q, i).Se)

    def dSe_dA(self, h, Q, i):
        """d(Se)/dA at node i, with the reference's curvature-term dA/dh
        pre-multiplication (ref channel.py:71-87; see energy_slope note)."""
        return float(self._slope_at(h, Q, i).dSe_dA_eff)

    def dSe_dQ(self, h, Q, i):
        """d(Se)/dQ at node i (ref channel.py:89-105)."""
        return float(self._slope_at(h, Q, i).dSe_dQ)


class _SolverBase:
    """Shared grid setup + state accessors (ref: solver.py:10-63,244-296)."""

    def __init__(self, channel: Channel, time_step, spatial_step, simulation_time, fit_spatial_step=True,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.channel = channel
        self.time_step = float(time_step)
        self.spatial_step = float(spatial_step)
        self.number_of_nodes = int(channel.length // self.spatial_step + 1)
        self.number_of_time_levels = int(simulation_time // self.time_step + 1)
        if fit_spatial_step:
            # ref solver.py:53-55
            self.number_of_nodes = round(channel.length / self.spatial_step) + 1
            self.spatial_step = channel.length / (self.number_of_nodes - 1)
        self.depth = None  # [nt, N] numpy after run()
        self.flow = None
        self.output: Optional[prs.SimOutput] = None
        self.total_sim_duration = 0.0

    # accessors (ref solver.py:244-258): k=None -> last computed level;
    # k=-1 -> the level BEFORE it (the reference's time_level-1), not
    # python's last-element indexing
    def _level_index(self, k):
        last = self.depth.shape[0] - 1
        return last if k is None else last - 1 if k == -1 else k

    def depth_at(self, k=None, i=None):
        if i is None:
            raise ValueError("Spatial node must be specified.")
        return float(self.depth[self._level_index(k), i])

    def flow_at(self, k=None, i=None):
        if i is None:
            raise ValueError("Spatial node must be specified.")
        return float(self.flow[self._level_index(k), i])

    def water_level_at(self, k=None, i=None):
        return self.channel.bed_level_at(i) + self.depth_at(k, i)

    def area_at(self, k=None, i=None):
        """Wetted area at (level k, node i) (ref solver.py:271-283)."""
        return self.channel.area_at(i, self.water_level_at(k, i))

    def Se_at(self, k=None, i=None):
        """Energy slope at (level k, node i) (ref solver.py:290-293)."""
        return self.channel.Se(self.depth_at(k, i), self.flow_at(k, i), i)

    def dA_dh(self, k=None, i=None):
        """dA/dh (top width) at (level k, node i) (ref solver.py:295-296)."""
        return self.channel.dA_dh(i, self.water_level_at(k, i))


class PreissmannSolver(_SolverBase):
    """Implicit Preissmann solver (ref: preissmann.py:9-46 surface)."""

    _type = "preissmann"
    ENGINES = ("plain", "fused")

    def __init__(self, channel, theta, time_step, spatial_step, simulation_time,
                 fit_spatial_step=True, linear_solver="pcr", newton="while",
                 regularization=False, gate_initially_open=False, device=DEFAULT_DEVICE):
        if regularization:
            raise NotImplementedError(
                "regularization (wetting/drying) is a half-finished dead code "
                "path in the reference; all shipped cases run "
                "regularization=False, which is the supported behavior here"
            )
        super().__init__(channel, time_step, spatial_step, simulation_time, fit_spatial_step, device=device)
        self.theta = float(theta)
        self.linear_solver = linear_solver
        self.newton = newton
        self.gate_initially_open = bool(gate_initially_open)
        channel.build_geometry(self.number_of_nodes, device=self.device)
        self.h0, self.Q0 = channel.initialize_conditions(self.number_of_nodes, self.spatial_step, device=self.device)
        times = np.arange(self.number_of_time_levels) * self.time_step
        geo = channel.geometry
        z, s0 = geo.z_bed.cpu(), geo.bed_slope.cpu()
        self.us_params = channel.upstream_boundary.build(times, z[0], s0[0], device=self.device)
        self.ds_params = channel.downstream_boundary.build(times, z[-1], s0[-1], device=self.device)

    def settings(self, tolerance, max_iter, diagnos=False) -> prs.PreissmannSettings:
        return prs.PreissmannSettings(
            theta=self.theta,
            time_step=self.time_step,
            spatial_step=self.spatial_step,
            n_time_levels=self.number_of_time_levels,
            tolerance=float(tolerance),
            max_iter=int(max_iter),
            linear_solver=self.linear_solver,
            newton=self.newton,
            gate_initially_open=self.gate_initially_open,
            diagnos=bool(diagnos),
        )

    RCOND_THRESHOLD = 1e-12  # ref preissmann.py:142

    def run(self, tolerance=1e-4, verbose=1, max_iter=100, diagnos=False, engine="plain",
            lateral_inflow=None):
        """Run the full simulation on the solver's device.

        ``engine``: ``"plain"`` (default) runs the eager scan-of-Newton;
        ``"fused"`` runs the whole simulation as one CUDA kernel.  A
        configuration outside the kernel's scope raises ``FusedUnsupported``
        (no fallback to the plain engine).  Returns the ``SimOutput`` of
        tensors on the device (``reservoir_stage`` / ``reservoir_stage_us``
        hold the lumped-storage stage series, NaN without storage);
        ``self.depth`` / ``self.flow`` hold NumPy copies for the accessors.

        ``lateral_inflow``: distributed source q [m^2/s per unit length] —
        scalar (uniform), per node [N], or per level and node [nt, N]; both
        engines take it.
        """
        if engine not in self.ENGINES:
            raise ValueError(f"unknown engine {engine!r}; expected one of {self.ENGINES}")
        sset = self.settings(tolerance, max_iter, diagnos=diagnos)
        args = (self.channel.geometry, self.us_params, self.ds_params, self.h0, self.Q0, sset)
        if lateral_inflow is not None:
            lateral_inflow = np.asarray(lateral_inflow, dtype=np.float64)
            if lateral_inflow.ndim == 0:
                lateral_inflow = np.full(self.number_of_nodes, float(lateral_inflow))
            lateral_inflow = prs.as_lateral_inflow(lateral_inflow, self.h0)
        if engine == "fused":
            from flowsim_tpu_torch.ops.cuda.fused_newton import fused_simulate

            out = fused_simulate(*args, lateral_inflow=lateral_inflow)
        else:
            out = prs.simulate(*args, lateral_inflow=lateral_inflow)
        self.output = out
        self.depth = out.depth.cpu().numpy()
        self.flow = out.flow.cpu().numpy()
        self.total_sim_duration = (self.number_of_time_levels - 1) * self.time_step
        error = out.error.cpu().numpy()
        if diagnos:
            # ref preissmann.py:133-144: NaN and ill-conditioning checks
            if np.isnan(error).any() or np.isnan(self.depth).any():
                bad = int(np.argmax(np.isnan(error) | np.isnan(self.depth).any(axis=1)))
                self.check_criticality(level=bad)
                raise ValueError("NaN in system assembly")  # ref preissmann.py:137
            rcond = out.rcond.cpu().numpy()
            if (rcond < self.RCOND_THRESHOLD).any():
                bad = int(np.argmax(rcond < self.RCOND_THRESHOLD))
                self.check_criticality(level=bad)
                raise ValueError(
                    "Jacobian is ill-conditioned (rcond too small)"
                )  # ref preissmann.py:143
        # storage-bracket saturation: the bisection clamps to [y_min, y_max]
        # where a bracketing root finder would raise when the root leaves the
        # solution_boundaries — surface that here (checked before the
        # convergence error: saturation is the root cause when both trip)
        us_only = self.ds_params.storage is None
        for bc, series in ((self.us_params, out.reservoir_stage if us_only else out.reservoir_stage_us),
                           (self.ds_params, out.reservoir_stage)):
            sp = bc.storage
            if sp is None:
                continue
            stages = series.cpu().numpy()
            stages = stages[np.isfinite(stages)]
            if stages.size == 0:
                continue
            ymin, ymax = float(sp.y_min), float(sp.y_max)
            tol = 1e-6 * max(ymax - ymin, 1.0)
            if (stages >= ymax - tol).any() or (
                    ymin > float(sp.min_stage) and (stages <= ymin + tol).any()):
                raise ValueError(
                    "Lumped-storage stage hit the solution_boundaries "
                    f"bracket [{ymin}, {ymax}] — the mass-balance root lies "
                    "outside it; widen solution_boundaries")
        converged = out.converged.cpu().numpy()
        if not bool(converged.all()):
            bad = int(np.argmin(converged))
            self.check_criticality(level=bad)  # ref preissmann.py:124-125
            raise ValueError(
                f"Convergence within {int(out.iterations[bad])} iterations couldn't be achieved."
            )  # ref preissmann.py:126
        if verbose >= 2:
            # per-level iteration/error lines (ref preissmann.py:116-159)
            for k, (it, e) in enumerate(zip(out.iterations.cpu().tolist(), error.tolist())):
                print(f"\n> Time level #{k}\n>> {it} iterations.\n>> Error = {e}")
        if verbose >= 1:
            print("Simulation completed successfully.")
        return out

    def check_criticality(self, level=-1):
        """Froude scan with the reference's warning lines
        (ref preissmann.py:179-198)."""
        geo = self.channel.geometry
        h = torch.as_tensor(self.depth[level], dtype=DEFAULT_DTYPE, device=geo.device)
        Q = torch.as_tensor(self.flow[level], dtype=DEFAULT_DTYPE, device=geo.device)
        st = sec.section_state(geo, h)
        fr = hyd.froude(st.T, st.A, Q).cpu().numpy()
        fail = False
        for i, f in enumerate(fr):
            x = self.channel.ch_at_node[i]
            if f == 1.0:
                fail = True
                print(f"WARNING: Flow goes critical at x = {x} m. Fr = {f}.")
            elif f > 1.0:
                fail = True
                print(f"WARNING: Flow goes supercritical at x = {x} m. Fr = {f}.")
        if not fail:
            print("Flow is subcritical.")
        return fail


class Junction:
    """Marker for a channel end that meets network junction ``id``, used in
    place of a :class:`Boundary` when assembling a :class:`NetworkSolver`.
    ``bed_level`` / ``initial_depth`` play a boundary's roles for the
    provisional geometry and the initial conditions."""

    condition = "junction"

    def __init__(self, id: int, chainage, bed_level=None, initial_depth=None):
        self.id = int(id)
        self.chainage = chainage
        self.bed_level = bed_level
        self.initial_depth = initial_depth
        self.lumped_storage = None


_RESULTS_MESSAGE = ("per-branch results need utils/results.py, which is not ported yet "
                    "(ROADMAP.md Queue 1 item 14); read NetworkSolver.output instead")


class NetworkSolver:
    """Implicit Preissmann solve over a river network of channels joined at
    junctions (see :mod:`flowsim_tpu_torch.ops.network`).

    ``channels``: :class:`Channel` objects whose boundaries may be
    :class:`Junction` markers; flow runs upstream -> downstream per channel.
    ``junction_area``: per-junction reservoir areas; ``junction_rating``: per
    junction a :class:`RatingCurve`, its params or ``None`` (a rated outflow
    leaving the network).  ``initial_conditions``: optional per-channel
    ``(h0, Q0)``; ``None`` entries use the channel's own generator.
    ``spatial_step``: one value or one per channel.
    """

    _type = "network"

    def __init__(self, channels, theta, time_step, spatial_step, simulation_time, junction_area=None,
                 junction_rating=None, fit_spatial_step=True, linear_solver="pcr", newton="while",
                 initial_conditions=None, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.channels = list(channels)
        self.theta = float(theta)
        self.time_step = float(time_step)
        self.simulation_time = float(simulation_time)
        self.linear_solver = linear_solver
        self.newton = newton
        self.junction_area = junction_area
        self.number_of_time_levels = int(simulation_time // self.time_step + 1)
        times = np.arange(self.number_of_time_levels) * self.time_step
        self.junction_rating = None if junction_rating is None else [
            None if rc is None else (rc.params if isinstance(rc, RatingCurve) else rc).to(self.device)
            for rc in junction_rating]

        if np.ndim(spatial_step) == 0:
            spatial_step = [spatial_step] * len(self.channels)
        if len(spatial_step) != len(self.channels):
            raise ValueError(f"spatial_step has {len(spatial_step)} entries for {len(self.channels)} channels")
        ics = initial_conditions or [None] * len(self.channels)
        if len(ics) != len(self.channels):
            raise ValueError(f"initial_conditions has {len(ics)} entries for {len(self.channels)} channels")

        self.branches = []
        self.branch_dx = []
        junction_ids = set()
        for ch, dx, ic_pair in zip(self.channels, spatial_step, ics):
            dx = float(dx)
            n_nodes = int(ch.length // dx + 1)
            if fit_spatial_step:  # ref solver.py:53-55
                n_nodes = round(ch.length / dx) + 1
                dx = ch.length / (n_nodes - 1)
            self.branch_dx.append(dx)
            geo = ch.build_geometry(n_nodes, device=self.device)
            if ic_pair is None:
                h0, Q0 = ch.initialize_conditions(n_nodes, dx, device=self.device)
            else:
                h0, Q0 = (torch.as_tensor(v, dtype=DEFAULT_DTYPE, device=self.device) for v in ic_pair)
            z, s0 = geo.z_bed.cpu(), geo.bed_slope.cpu()

            def lower(b, node):
                if isinstance(b, Junction):
                    junction_ids.add(b.id)
                    return b.id
                return b.build(times, z[node], s0[node], device=self.device)

            self.branches.append(net.BranchDef(geo=geo, dx=dx, us=lower(ch.upstream_boundary, 0),
                                               ds=lower(ch.downstream_boundary, -1), h0=h0, Q0=Q0))
        self.n_junctions = (max(junction_ids) + 1) if junction_ids else 0
        self.output = None

    def settings(self, tolerance, max_iter, **kw) -> prs.PreissmannSettings:
        return prs.PreissmannSettings(
            theta=self.theta, time_step=self.time_step, spatial_step=self.branch_dx[0],
            n_time_levels=self.number_of_time_levels, tolerance=float(tolerance), max_iter=int(max_iter),
            linear_solver=self.linear_solver, newton=self.newton, **kw)

    def run(self, tolerance=1e-4, verbose=1, max_iter=100, engine="loop"):
        """Run the network on the solver's device with ``engine`` ``"loop"``,
        ``"stacked"`` or ``"fused"`` (one kernel launch).  ``"fused"`` raises
        ``FusedUnsupported`` outside the kernel's scope: unlike the JAX api,
        nothing falls back to ``"stacked"``.  Returns the NetworkOutput
        (tensors on the device), also kept as ``self.output``."""
        out = net.simulate_network(self.branches, self.n_junctions, self.settings(tolerance, max_iter),
                                   junction_area=self.junction_area, junction_rating=self.junction_rating,
                                   engine=engine)
        self.output = out
        converged = out.converged.cpu().numpy()
        if not bool(converged.all()):
            bad = int(np.argmin(converged))
            self.check_criticality(level=bad)  # ref preissmann.py:124-125
            raise ValueError(f"Convergence within {int(out.iterations[bad])} iterations couldn't be achieved.")
        if verbose >= 1:
            print("Simulation completed successfully.")
        return out

    def check_criticality(self, level=-1):
        """Per-branch Froude scan with the reference's warning lines
        (ref preissmann.py:179-198), prefixed by the branch index."""
        fail = False
        for bi, (ch, br) in enumerate(zip(self.channels, self.branches)):
            h, Q = self.output.depth[bi][level], self.output.flow[bi][level]
            st = sec.section_state(br.geo, h)
            fr = hyd.froude(st.T, st.A, Q).cpu().numpy()
            for i, f in enumerate(fr):
                x = ch.ch_at_node[i]
                if f == 1.0:
                    fail = True
                    print(f"WARNING: [branch {bi}] Flow goes critical at x = {x} m. Fr = {f}.")
                elif f > 1.0:
                    fail = True
                    print(f"WARNING: [branch {bi}] Flow goes supercritical at x = {x} m. Fr = {f}.")
        if not fail:
            print("Flow is subcritical.")
        return fail

    def branch(self, i):
        raise NotImplementedError(_RESULTS_MESSAGE)

    def summary(self) -> dict:
        raise NotImplementedError(_RESULTS_MESSAGE)

    def save_results(self, folder_path: str):
        raise NotImplementedError(_RESULTS_MESSAGE)
