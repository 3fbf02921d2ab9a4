"""Initial-condition generators: steady-state, linear, GVF backwater (torch).

Counterpart of ``flowsim_tpu/ops/initial_conditions.py``:

* steady-state — per-node normal depth by a vectorized 100-step bisection
  over all nodes at once, with the reference's out-of-bracket fallbacks.
* linear — linear depth profile between the boundary depths.
* GVF — downstream->upstream predictor-corrector on dh/dx = (S0-Se)/(1-Fr²)
  with the reference's exact clamps: denominator floor 0.01, depth floor
  0.01, supercritical and dry-section guards.  Sequential by nature and run
  once at set-up: a Python loop over the nodes on the host, whatever device
  the geometry lives on; the result is moved to that device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flowsim_tpu_torch.ops import hydraulics as hyd
from flowsim_tpu_torch.ops import sections as sec


def steady_normal_depth(geo, Q, hw_span: float = 100.0, iters: int = 100):
    """Normal depth per node for discharge Q (vectorized bisection).

    Matches brentq-root behavior on the bracket [z_min, z_min + hw_span] and
    the reference's fallbacks: Q <= 0 -> depth 0; Q above capacity -> span.
    """
    zeros = torch.zeros_like(geo.z_bed)
    Q = torch.as_tensor(Q, dtype=zeros.dtype, device=zeros.device)

    def f(depth):
        return Q - sec.normal_flow(geo, depth)

    lo = zeros
    hi = zeros + hw_span
    f_lo = f(lo)
    f_hi = f(hi)
    f_lo0 = f_lo
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        f_mid = f(mid)
        same = torch.sign(f_mid) == torch.sign(f_lo)
        lo, hi, f_lo = (torch.where(same, mid, lo), torch.where(same, hi, mid),
                        torch.where(same, f_mid, f_lo))
    depth = 0.5 * (lo + hi)
    # brentq-failure fallbacks (ref cross_section.py:196-202)
    depth = torch.where(f_lo0 < 0, zeros, depth)             # Q below zero-depth flow
    depth = torch.where(f_hi > 0, zeros + hw_span, depth)    # Q above capacity
    return depth


def linear_profile(n_nodes: int, h_us, h_ds, dtype=torch.float64, device="cpu"):
    """Linear depth interpolation (ref channel.py:380-390)."""
    w = torch.linspace(0.0, 1.0, n_nodes, dtype=dtype, device=device)
    return h_us + (h_ds - h_us) * w


class GVFResult(NamedTuple):
    depth: torch.Tensor
    supercritical: bool  # any node tripped the Fr > 1 guard


def gvf_profile(geo, Q, h_downstream, dx) -> GVFResult:
    """GVF backwater march (ref channel.py:307-378).

    Returns depths at all nodes (on the geometry's device) and a
    supercritical flag (the caller raises, as the reference does).
    """
    dev = geo.device
    cpu = geo.to("cpu")
    N = cpu.n_nodes
    dtype = cpu.z_bed.dtype
    Qt = torch.as_tensor(float(Q), dtype=dtype)
    nodes = [cpu.node(i) for i in range(N)]
    z = cpu.z_bed.tolist()

    def dh_dx_at(h_in, idx, S0):
        """S0 is passed in because the reference evaluates it at the
        enclosing loop's node pair for both predictor and corrector."""
        gi = nodes[idx]
        st = sec.section_state(gi, h_in)
        dry = bool((st.T < 1e-6) | (st.A < 1e-6))
        Fr = hyd.froude(st.T, st.A, Qt)
        supercrit = bool(Fr > 1.0) and not dry
        denom = torch.clamp(1.0 - Fr * Fr, min=0.01)
        Se = sec.energy_slope(gi, h_in, Qt, st).Se
        val = (S0 - Se) / denom
        return (torch.zeros_like(val) if dry else val), supercrit

    h_down = torch.as_tensor(float(h_downstream), dtype=dtype)
    depths = [None] * N
    depths[N - 1] = h_down
    flag = False
    for i in range(N - 2, -1, -1):
        S0 = (z[i] - z[i + 1]) / dx
        dh_down, sc1 = dh_dx_at(h_down, i + 1, S0)
        h_pred = h_down - dh_down * dx
        # clamps only at h <= 0 (a positive near-dry depth is kept)
        if float(h_pred) <= 0.0:
            h_pred = torch.full_like(h_pred, 0.01)
        dh_pred, sc2 = dh_dx_at(h_pred, i, S0)
        h_up = h_down - 0.5 * (dh_down + dh_pred) * dx
        if float(h_up) <= 0.0:
            h_up = torch.full_like(h_up, 0.01)
        flag = flag or sc1 or sc2
        depths[i] = h_up
        h_down = h_up
    return GVFResult(depth=torch.stack(depths).to(dev), supercritical=flag)


def initial_conditions(geo, method: str, Q, dx, h_us=None, h_ds=None):
    """Dispatch matching ``Channel.initialize_conditions`` (ref :107-138).

    Returns (h[N], Q[N]); raises on supercritical GVF like the reference.
    """
    N = geo.n_nodes
    if method == "steady-state":
        h = steady_normal_depth(geo, Q)
    elif method == "linear":
        if h_us is None or h_ds is None:
            raise ValueError("linear ICs need both boundary depths")
        h = linear_profile(N, h_us, h_ds, dtype=geo.z_bed.dtype, device=geo.device)
    elif method == "GVF_equation":
        if h_ds is None:
            raise ValueError("GVF ICs need the downstream depth")
        res = gvf_profile(geo, Q, h_ds, dx)
        if res.supercritical:
            raise RuntimeError(
                "GVF Error: Flow became supercritical. "
                "Downstream boundary control is not valid for this Q."
            )  # ref channel.py:329-333
        h = res.depth
    else:
        raise ValueError("Invalid interpolation method.")  # ref channel.py:41-44
    return h, torch.full((N,), float(Q), dtype=geo.z_bed.dtype, device=geo.device)
