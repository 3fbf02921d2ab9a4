"""GERD->Roseires flood-routing model (the flagship application).

Mirrors ref cases/gerd_roseires/model.py:10-125: build the GERD release
hydrograph (reservoir routing), load the 21 fitted compound-trapezoid
stations (cross-section 53 skipped), attach the Roseires rating-curve
boundary, assemble the channel with planform curvature, run the Preissmann
solver, and optionally return interpolated upstream stages for calibration
or export the bank polylines.
"""

from __future__ import annotations

import numpy as np

from flowsim_tpu_torch.config import DEFAULT_DEVICE
from flowsim_tpu_torch.api import Boundary, Channel, Hydrograph, PreissmannSolver
from flowsim_tpu_torch.models.gerd_roseires import settings
from flowsim_tpu_torch.models.gerd_roseires.gerd_discharge import GerdHydrograph
from flowsim_tpu_torch.models.gerd_roseires.roseires_rating_curve import RoseiresRatingCurve
from flowsim_tpu_torch.utils.io import import_hydrograph, import_table, load_trapezoid_stations


def build(
    n_main=None,
    n_fp=None,
    initial_roseires_level=settings.initial_roseires_level,
    theta=settings.theta,
    spatial_step=settings.spatial_step,
    time_step=settings.time_step,
    sim_duration=settings.sim_duration,
    inflow_hyd_path=settings.inflow_hyd_path,
    inflow_hyd_func=settings.inflow_hyd_func,
    coords_path=settings.coords_path,
    cross_sections_path=settings.cross_sections_path,
    jammed_spillways=settings.JAMMED_SPILLWAYS,
    jammed_sluice_gates=settings.JAMMED_SLUICEGATES,
    gerd_level=settings.initial_gerd_level,
    with_gerd=True,
    smooth=True,
    device=DEFAULT_DEVICE,
    **solver_kw,
):
    """Construct the solver (ref model.py:33-87); returns (solver, channel).

    ``device`` is where the solver's tensors live and where it runs:
    ``"cuda"`` by default, ``"cpu"`` only when asked for."""
    if inflow_hyd_func is None:
        gerd_inflow_hyd = Hydrograph(table=import_hydrograph(inflow_hyd_path))
    else:
        gerd_inflow_hyd = Hydrograph(function=inflow_hyd_func)

    if sim_duration is None:
        if gerd_inflow_hyd.table is None:
            raise ValueError("Simulation duration must be specified.")
        duration = int(gerd_inflow_hyd.table[-1, 0])
    else:
        duration = int(sim_duration)

    gerd_discharge_hyd = GerdHydrograph()
    gerd_discharge_hyd.build(
        inflow_hydrograph=gerd_inflow_hyd, time_step=time_step,
        duration=duration, initial_stage=gerd_level,
    )
    initial_flow = gerd_discharge_hyd.get_at(0)

    xs_chainages, stations = load_trapezoid_stations(cross_sections_path, n_main=n_main, n_fp=n_fp)
    roseires_ch = xs_chainages[-1]
    roseires_bed = stations[-1].z_bed
    upstream_ch = xs_chainages[0]

    upstream_bc = Boundary(
        condition="flow_hydrograph",
        hydrograph=gerd_discharge_hyd if with_gerd else gerd_inflow_hyd,
        chainage=upstream_ch,
    )
    roseires = Boundary(
        initial_depth=initial_roseires_level - roseires_bed,
        bed_level=roseires_bed,
        condition="rating_curve",
        rating_curve=RoseiresRatingCurve(
            initial_stage=initial_roseires_level,
            initial_flow=initial_flow,
            jammed_sluice_gates=jammed_sluice_gates,
            jammed_spillways=jammed_spillways,
            smooth=smooth,
        ),
        chainage=roseires_ch,
    )

    channel = Channel(
        initial_flow=initial_flow,
        upstream_boundary=upstream_bc,
        downstream_boundary=roseires,
    )
    if coords_path is not None:
        coords = import_table(coords_path, sort_by="chainage")
        channel.set_coords(coords=coords[:, 1:], chainages=coords[:, 0])
    channel.set_cross_sections(chainages=xs_chainages, sections=stations)

    solver = PreissmannSolver(
        channel=channel, theta=theta, time_step=time_step,
        spatial_step=spatial_step, simulation_time=duration, device=device,
        **solver_kw,
    )
    return solver, channel


def run(
    Q=None,
    tolerance=settings.tolerance,
    verbose=1,
    banks_file=None,
    engine="fused",
    **build_kw,
):
    """Run the case (ref model.py:10-113) with the given engine.

    With ``Q`` given, returns upstream stages interpolated at those
    discharges (the calibration hook, ref model.py:105-113); otherwise
    returns the solver.  The bank-polyline shapefile export of the JAX
    package is not ported yet: ``banks_file`` other than ``None`` raises.

    Calibration-hook caveat, faithful to the reference: the interpolation
    runs np.interp over the upstream flow SERIES, which rises and falls —
    a non-monotonic xp.
    """
    if banks_file is not None:
        raise NotImplementedError(
            "the bank-polyline shapefile export is not ported yet; pass banks_file=None")
    solver, channel = build(**build_kw)
    if verbose > 0:
        print("Simulation started.")
    solver.run(verbose=max(0, verbose - 1), tolerance=tolerance, engine=engine)
    if verbose > 0:
        print("Done.")

    if Q is not None:
        z0 = float(channel.geometry.z_bed[0])
        return np.interp(np.asarray(Q), solver.flow[:, 0], solver.depth[:, 0] + z0)
    return solver


if __name__ == "__main__":
    # regulated (GERD releases) vs natural (inflow passed straight through)
    # scenarios back to back, as ref cases/gerd_roseires/main.py does
    print("Start.")
    run(verbose=0, inflow_hyd_func=None)
    print("Finished regulated scenario.")
    run(verbose=0, inflow_hyd_func=None, with_gerd=False)
    print("Finished natural scenario.")
