"""GERD flood routing with a tributary confluence — the network flagship.

Counterpart of ``flowsim_tpu/models/gerd_tributary.py``: the GERD->Roseires
main stem (surveyed compound trapezoids, planform curvature) split at a
confluence node, and a 10 km simple-trapezoid tributary joining there with a
scaled copy of the routed GERD release:

    GERD release --[upper main stem]--+
                                      | junction 0 (confluence)
    tributary hydrograph --[trib]-----+
                                      +--[lower main stem]-- Roseires rating

:func:`build` gives the branches for ``ops.network.simulate_network``;
:func:`network_solver` assembles the same network from ``api.Channel`` objects
with ``api.Junction`` ends into an ``api.NetworkSolver``.

Run: ``python -m flowsim_tpu_torch.models.gerd_tributary [hours] [device] [engine]``
(defaults: 96 h, ``cuda``, ``fused``).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from flowsim_tpu_torch import trees
from flowsim_tpu_torch.api import Boundary, Channel, Hydrograph, Junction, NetworkSolver
from flowsim_tpu_torch.config import DEFAULT_DEVICE, farray
from flowsim_tpu_torch.geometry import interpolate_stations, trapezoid_station
from flowsim_tpu_torch.models.gerd_roseires import model as gerd_model
from flowsim_tpu_torch.models.gerd_roseires import settings as gsettings
from flowsim_tpu_torch.ops import initial_conditions as ic
from flowsim_tpu_torch.ops.network import BranchDef, simulate_network

# the tributary: a simple trapezoid falling to the confluence bed level
TRIB_SLOPE = 2e-4


def _trib_station(z):
    return trapezoid_station(z_bed=z, b_main=120.0, m_main=2.0, n_main=0.032, bed_slope=TRIB_SLOPE)


def build(split_node=60, trib_scale=0.2, trib_length=10_000.0, sim_duration=None,
          device=DEFAULT_DEVICE, **model_kw):
    """``(branches, n_junctions, settings, solver)`` for
    :func:`flowsim_tpu_torch.ops.network.simulate_network`.

    ``split_node``: main-stem node of the confluence; ``trib_scale``: the
    tributary hydrograph is the main inflow's rise times this factor;
    ``sim_duration=None``: the flagship's 384 hours."""
    if sim_duration is not None:
        model_kw["sim_duration"] = sim_duration
    solver, _ = gerd_model.build(smooth=True, device=device, **model_kw)
    sset = solver.settings(tolerance=gsettings.tolerance, max_iter=100)
    geo = solver.channel.geometry
    dx = solver.spatial_step

    upper_geo = trees.tree_map(lambda x: x[: split_node + 1], geo)
    lower_geo = trees.tree_map(lambda x: x[split_node:], geo)

    z_conf = float(geo.z_bed[split_node])
    n_trib = int(trib_length // dx) + 1
    trib_geo = interpolate_stations([_trib_station(z_conf + TRIB_SLOPE * trib_length), _trib_station(z_conf)],
                                    np.array([0.0, trib_length]), np.linspace(0.0, trib_length, n_trib),
                                    device=device)
    # it ramps up from a trickle, so at t=0 the network state is the single
    # reach's plus a small backwater-consistent tributary
    q_eps = 50.0
    base = solver.us_params.target_series.cpu().numpy()
    trib_us = dataclasses.replace(solver.us_params,
                                  target_series=farray((base - base[0]) * trib_scale + q_eps, device),
                                  bed_level=farray(z_conf + TRIB_SLOPE * trib_length, device))
    # junction stage at t=0 = the flagship water level at the confluence; the
    # GVF backwater from it gives the tributary its t=0 profile
    Y0 = float(solver.h0[split_node]) + z_conf
    h_trib, Q_trib = ic.initial_conditions(trib_geo, "GVF_equation", q_eps, dx, h_ds=Y0 - z_conf)

    branches = [
        BranchDef(geo=upper_geo, dx=dx, us=solver.us_params, ds=0,
                  h0=solver.h0[: split_node + 1], Q0=solver.Q0[: split_node + 1]),
        BranchDef(geo=trib_geo, dx=dx, us=trib_us, ds=0, h0=h_trib, Q0=Q_trib),
        BranchDef(geo=lower_geo, dx=dx, us=0, ds=solver.ds_params,
                  h0=solver.h0[split_node:], Q0=solver.Q0[split_node:]),
    ]
    return branches, 1, sset, solver


def network_solver(split_node=60, trib_length=10_000.0, device=DEFAULT_DEVICE, **build_kw):
    """The same network assembled as a user of ``api`` does: the main stem as
    two :class:`~flowsim_tpu_torch.api.Channel` objects on the flagship's
    surveyed stations and centreline, joined with the tributary channel at
    :class:`~flowsim_tpu_torch.api.Junction` 0, with the initial state of
    :func:`build`.  Returns ``(network_solver, branches)``; the solver's
    branches equal ``branches`` up to rounding of the node chainages (every
    branch keeps the flagship's ``dx``, as in :func:`build`)."""
    branches, _, sset, solver = build(split_node=split_node, trib_length=trib_length, device=device, **build_kw)
    flagship = solver.channel
    x = flagship.ch_at_node
    z_conf = float(flagship.geometry.z_bed[split_node])

    def main_stem(us, ds):
        ch = Channel(us, ds, initial_flow=flagship.initial_flow_rate)
        ch.set_coords(flagship.coords, flagship.coords_chainages)
        ch.set_cross_sections(flagship.xs_chainages, flagship.input_stations)
        return ch

    times = np.arange(sset.n_time_levels) * solver.time_step
    trib_us = branches[1].us
    inflow = Hydrograph(table=np.stack([times, trib_us.target_series.cpu().numpy()], axis=1))
    tributary = Channel(Boundary("flow_hydrograph", 0.0, bed_level=float(trib_us.bed_level), hydrograph=inflow),
                        Junction(0, trib_length, bed_level=z_conf), initial_flow=float(branches[1].Q0[0]))
    tributary.set_cross_sections([0.0, trib_length], [_trib_station(z_conf + TRIB_SLOPE * trib_length),
                                                      _trib_station(z_conf)])
    channels = [main_stem(flagship.upstream_boundary, Junction(0, x[split_node], bed_level=z_conf)),
                tributary,
                main_stem(Junction(0, x[split_node], bed_level=z_conf), flagship.downstream_boundary)]
    ns = NetworkSolver(channels, theta=solver.theta, time_step=solver.time_step, spatial_step=solver.spatial_step,
                       simulation_time=(sset.n_time_levels - 1) * solver.time_step,
                       initial_conditions=[(br.h0, br.Q0) for br in branches], fit_spatial_step=False,
                       device=device)
    return ns, branches


def main(sim_hours=96, device=DEFAULT_DEVICE, engine="fused"):
    branches, n_junctions, sset, _ = build(sim_duration=3600 * int(sim_hours), device=device)
    out = simulate_network(branches, n_junctions, sset, engine=engine)
    q_up = out.flow[0][:, -1].cpu().numpy()
    q_tr = out.flow[1][:, -1].cpu().numpy()
    q_dn = out.flow[2].cpu().numpy()
    print(f"converged: {bool(out.converged.all())}  total Newton iterations: {int(out.iterations.sum())}")
    print(f"main-stem peak at confluence: {q_up.max():,.0f} m3/s")
    print(f"tributary peak at confluence: {q_tr.max():,.0f} m3/s")
    print(f"combined peak entering Roseires reach: {q_dn[:, 0].max():,.0f} m3/s")
    print(f"peak at Roseires: {q_dn[:, -1].max():,.0f} m3/s")
    # level 0 is the tributary-free initial state; the balance holds from level 1
    imbalance = np.abs(q_up[1:] + q_tr[1:] - q_dn[1:, 0]).max()
    print(f"max junction imbalance (levels 1+): {imbalance:.2e} m3/s")
    return out


if __name__ == "__main__":
    main(*sys.argv[1:4])
