"""Dendritic river basin: a binary-tree network of reaches.

Counterpart of ``flowsim_tpu/models/basin.py``: ``levels`` tree levels give
``2**levels - 1`` branches and ``2**(levels-1) - 1`` confluences (levels=5: 31
branches, 16 headwaters).  Each headwater receives its own flood wave; widths
double at every confluence, beds descend continuously through the junctions,
and the outlet drains through a normal-depth boundary.

Run: ``python -m flowsim_tpu_torch.models.basin [levels] [device] [engine]``
(defaults: 4, ``cuda``, ``stacked``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from flowsim_tpu_torch import trees
from flowsim_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from flowsim_tpu_torch.geometry import interpolate_stations, trapezoid_station
from flowsim_tpu_torch.ops import boundary as bnd
from flowsim_tpu_torch.ops import initial_conditions as ic
from flowsim_tpu_torch.ops import preissmann as prs
from flowsim_tpu_torch.ops.network import BranchDef, simulate_network

DX = 500.0
LINK_NODES = 13          # nodes per reach (6 km links)
SLOPE = 5e-4
LEAF_FLOW = 60.0         # m^3/s base flow per headwater
WIDTH0 = 40.0            # m headwater channel width
ROUGHNESS = 0.03


def _leaf_hydrograph(times, scale, peak_factor=4.0, ramp_h=6.0):
    """Flood wave: base -> peak over ``ramp_h`` hours, then recession."""
    t = np.asarray(times) / 3600.0
    rise = np.clip(t / ramp_h, 0.0, 1.0)
    fall = np.clip((t - 2 * ramp_h) / (2 * ramp_h), 0.0, 1.0)
    q = LEAF_FLOW * scale * (1.0 + (peak_factor - 1.0) * (rise - rise * fall))
    return np.maximum(q, LEAF_FLOW * scale * 0.5)


def build(levels=4, sim_hours=24, time_step=900.0, tolerance=1e-6, link_nodes=LINK_NODES,
          device=DEFAULT_DEVICE):
    """``(branches, n_junctions, settings)`` for the binary-tree basin.

    Branch indexing is heap-like: branch 0 is the outlet reach, branch i's
    children are 2i+1 and 2i+2.  Junction i (one per internal branch) joins
    branch i's children to branch i's upstream end."""
    device = resolve_device(device)
    n_branches = 2 ** levels - 1
    n_internal = 2 ** (levels - 1) - 1
    length = (link_nodes - 1) * DX
    drop = SLOPE * length
    nt = int(sim_hours * 3600 // time_step) + 1
    times = np.arange(nt) * time_step

    def depth_of(i):  # tree depth: outlet 0, headwaters levels-1
        return int(np.log2(i + 1))

    # per-leaf inflow scales (the JAX package's draws), then each branch's
    # accumulated base flow so the t=0 state is junction-consistent
    rng = np.random.default_rng(7)
    scales = {i: float(rng.uniform(0.8, 1.2)) for i in range(n_internal, n_branches)}
    base_flow = {}
    for i in reversed(range(n_branches)):
        if i >= n_internal:
            base_flow[i] = float(_leaf_hydrograph([0.0], scales[i])[0])
        else:
            base_flow[i] = base_flow[2 * i + 1] + base_flow[2 * i + 2]

    geos = []
    for i in range(n_branches):
        z_lo = depth_of(i) * drop
        width = WIDTH0 * 2 ** (levels - 1 - depth_of(i))
        st = lambda z: trapezoid_station(z_bed=z, b_main=width, m_main=1.5, n_main=ROUGHNESS, bed_slope=SLOPE)
        geos.append(interpolate_stations([st(z_lo + drop), st(z_lo)], np.array([0.0, length]),
                                         np.linspace(0.0, length, link_nodes), device=device))
    # the steady-state initial depths of every branch in one node-wise
    # bisection over the stacked geometries (the same per-node arithmetic as
    # one initial_conditions call per branch, in one pass)
    flows = torch.tensor([base_flow[i] for i in range(n_branches)], dtype=torch.float64, device=device)
    depths = ic.steady_normal_depth(trees.stack(geos), flows[:, None])

    branches = []
    for i, geo in enumerate(geos):
        z_lo = depth_of(i) * drop
        h0, Q0 = depths[i], torch.full((link_nodes,), base_flow[i], dtype=torch.float64, device=device)
        if i >= n_internal:  # headwater: external inflow
            us = bnd.make_boundary("flow_hydrograph", bed_level=z_lo + drop,
                                   target_series=_leaf_hydrograph(times, scales[i]), device=device)
        else:
            us = i  # junction i feeds branch i
        if i == 0:  # outlet
            ds = bnd.make_boundary("normal_depth", bed_level=0.0, bed_slope=SLOPE, device=device)
        else:
            ds = (i - 1) // 2  # the parent's junction
        branches.append(BranchDef(geo=geo, dx=DX, us=us, ds=ds, h0=h0, Q0=Q0))

    settings = prs.PreissmannSettings(theta=0.7, time_step=time_step, spatial_step=DX, n_time_levels=nt,
                                      tolerance=tolerance, max_iter=100)
    return branches, n_internal, settings


def main(levels=4, device=DEFAULT_DEVICE, engine="stacked"):
    levels = int(levels)
    branches, nj, sset = build(levels, device=device)
    out = simulate_network(branches, nj, sset, engine=engine)
    q_out = out.flow[0][:, -1].cpu().numpy()
    print(f"basin: {len(branches)} branches, {nj} confluences, {2 ** (levels - 1)} headwaters, "
          f"{sum(int(b.h0.shape[0]) for b in branches)} nodes")
    print(f"converged: {bool(out.converged.all())}  total Newton iterations: {int(out.iterations.sum())}")
    print(f"outlet base flow: {q_out[0]:,.0f} m3/s   outlet peak: {q_out.max():,.0f} m3/s")
    return out


if __name__ == "__main__":
    main(*sys.argv[1:4])
