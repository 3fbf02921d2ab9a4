"""Example case: 20 km rectangular reach routing a trapezoidal flood wave
into a reservoir (ref: cases/example/main.py).

Counterpart of ``flowsim_tpu/models/example.py``.

Run: ``python -m flowsim_tpu_torch.models.example [device] [engine]``
(``device`` defaults to ``cuda``, ``engine`` to ``plain``).
"""

from __future__ import annotations

import sys

from flowsim_tpu_torch.api import Boundary, Channel, Hydrograph, LumpedStorage, PreissmannSolver
from flowsim_tpu_torch.config import DEFAULT_DEVICE


def trapezoid_hydrograph(t):
    """Trapezoidal flood wave 1,000 -> 10,000 m^3/s (ref main.py:8-28)."""
    initial_flow, peak_flow = 1000.0, 10000.0
    lag_time = 0.0
    time_to_peak = 3 * 3600.0
    peak_time = 6 * 3600.0
    recession_time = 4 * 3600.0
    if t <= lag_time:
        return initial_flow
    elif t - lag_time < time_to_peak:
        return initial_flow + (peak_flow - initial_flow) * (t - lag_time) / time_to_peak
    elif t - lag_time - time_to_peak < peak_time:
        return peak_flow
    elif t - lag_time - time_to_peak - peak_time < recession_time:
        return peak_flow - (peak_flow - initial_flow) * (t - lag_time - time_to_peak - peak_time) / recession_time
    return initial_flow


def build(scheme: str = "preissmann", device=DEFAULT_DEVICE):
    """(solver, channel) for the example configuration (ref main.py:31-57)."""
    if scheme != "preissmann":
        raise NotImplementedError(
            f"scheme={scheme!r}: the Lax-Friedrichs solver (LaxSolver) is not ported yet "
            "(ROADMAP.md Queue 1 item 12); only 'preissmann' is")
    us = Boundary(condition="flow_hydrograph", bed_level=5, chainage=0,
                  hydrograph=Hydrograph(function=trapezoid_hydrograph))
    ds = Boundary(condition="fixed_depth", initial_depth=5, bed_level=0, chainage=20000)
    ds.set_lumped_storage(LumpedStorage(surface_area=5000 * 250, min_stage=5,
                                        solution_boundaries=(0, 200)))
    channel = Channel(width=250, initial_flow=trapezoid_hydrograph(0), roughness=0.027,
                      upstream_boundary=us, downstream_boundary=ds)
    solver = PreissmannSolver(channel=channel, theta=0.8, time_step=3600,
                              spatial_step=1000, simulation_time=24 * 3600, device=device)
    return solver, channel


def main(device=DEFAULT_DEVICE, engine="plain"):
    """Run the example and print the reservoir's peak stage.  Result export
    (``save_results``) is not ported yet (ROADMAP.md Queue 1 item 14)."""
    solver, _ = build("preissmann", device=device)
    out = solver.run(verbose=1, max_iter=100, engine=engine)
    print(f"Finished Preissmann. Peak reservoir stage {float(out.reservoir_stage[1:].max()):.6f} m")
    return solver


if __name__ == "__main__":
    main(*sys.argv[1:3])
