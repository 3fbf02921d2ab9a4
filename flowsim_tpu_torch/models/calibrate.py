"""Manning-n calibration sweeps: the whole grid as one batched simulation.

Counterpart of the sweep half of ``flowsim_tpu/models/calibrate.py``
(``set_main_roughness`` .. ``rmse_sweep``).  The reference calibration re-runs
the full simulation serially for each candidate roughness; here roughness
enters the geometry tree, so the sweep is one ensemble
(:mod:`flowsim_tpu_torch.parallel.ensemble`) and, with ``engine="fused"``,
one kernel launch on the card.

Not ported yet: the gradient half (``bfgs_calibrate``, ``gradient_calibrate``)
waits for the adjoint (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses

import torch

from flowsim_tpu_torch import trees
from flowsim_tpu_torch.ops import preissmann as prs
from flowsim_tpu_torch.parallel.ensemble import ENGINES, batched_simulate, roughness_ensemble


def set_main_roughness(geo, n_main):
    """Return geometry with the main-channel Manning n replaced (scalar or
    per-node); the calibration parameter of ref n_calibrate.py:5-17."""
    n = torch.as_tensor(n_main, dtype=geo.n_main.dtype, device=geo.device)
    return dataclasses.replace(geo, n_main=n.expand(geo.n_main.shape).contiguous())


def simulate_with_roughness(geo, us_bc, ds_bc, h0, Q0, settings, n_main):
    return prs.simulate(set_main_roughness(geo, n_main), us_bc, ds_bc, h0, Q0, settings)


def interp(x, xp, fp):
    """Piecewise-linear interpolation of ``fp`` over ``xp`` at ``x``, clamped
    to ``fp[0]`` / ``fp[-1]`` outside the table; ``xp`` and ``fp`` may carry
    leading batch axes (``x`` is shared).  The segment is found by a
    right-sided search, so a repeated abscissa takes the later value."""
    x = x.expand(*xp.shape[:-1], x.shape[-1]).contiguous()
    last = xp.shape[-1] - 1
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x, right=True), 1, last)
    x0, x1 = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    f0, f1 = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    dx = x1 - x0
    flat = dx == 0
    f = torch.where(flat, f0, f0 + ((x - x0) / torch.where(flat, torch.ones_like(dx), dx)) * (f1 - f0))
    f = torch.where(x < xp[..., :1], fp[..., :1].expand_as(f), f)
    return torch.where(x > xp[..., -1:], fp[..., -1:].expand_as(f), f)


def upstream_stage_at(out: prs.SimOutput, z_bed_us, Q_targets):
    """Interpolate upstream stage at target discharges (ref model.py:105-113).
    Reads node 0 only, so it takes a ``store="boundaries"`` output as well,
    with or without a leading member axis."""
    Q_targets = torch.as_tensor(Q_targets, dtype=out.flow.dtype, device=out.flow.device)
    return interp(Q_targets, out.flow[..., 0], out.depth[..., 0] + z_bed_us)


def gvf_ic_fn(dx, Q_init, h_downstream):
    """GVF initial conditions as a function of the geometry.

    The reference rebuilds the whole model per candidate roughness, so the
    GVF backwater initial profile changes with n; a calibration sweep must
    therefore recompute the initial state per ensemble member.
    """
    from flowsim_tpu_torch.ops import initial_conditions as ic

    def f(geo):
        res = ic.gvf_profile(geo, Q_init, h_downstream, dx)
        return res.depth, torch.full((geo.n_nodes,), float(Q_init), dtype=res.depth.dtype,
                                     device=res.depth.device)

    return f


def _rmse(H, H_targets):
    H_targets = torch.as_tensor(H_targets, dtype=H.dtype, device=H.device)
    return torch.sqrt(torch.mean((H - H_targets) ** 2, dim=-1))


def rmse_objective(geo, us_bc, ds_bc, h0, Q0, settings, Q_targets, H_targets, ic_fn=None):
    """RMSE of simulated vs target stages as a function of n_main
    (ref n_calibrate.py:55-63).  ``ic_fn(geo) -> (h0, Q0)`` recomputes the
    initial state per candidate (pass :func:`gvf_ic_fn` for GVF cases)."""

    def f(n_main):
        g = set_main_roughness(geo, n_main)
        h, Q = (h0, Q0) if ic_fn is None else ic_fn(g)
        out = prs.simulate(g, us_bc, ds_bc, h, Q, settings)
        return _rmse(upstream_stage_at(out, g.z_bed[0], Q_targets), H_targets)

    return f


def rmse_sweep(geo, us_bc, ds_bc, h0, Q0, settings, Q_targets, H_targets, n_values,
               sharded: bool = False, engine: str = "plain", ic_fn=None):
    """The serial sweep of ref n_calibrate.py:55-75 as one batched run;
    returns the RMSE per candidate, ``[len(n_values)]``.

    ``engine="fused"`` routes the whole sweep through the batched CUDA kernel
    (one launch) and stores the boundary nodes only: the objective reads node
    0, which both layouts keep in column 0.  Pass ``ic_fn`` (e.g.
    :func:`gvf_ic_fn`) to recompute per-candidate initial conditions, as the
    reference's per-candidate model rebuild does.
    """
    if sharded:
        raise NotImplementedError(
            "a sweep spread over several cards is not ported yet (ROADMAP.md Queue 1 item 13)")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    n_values = torch.as_tensor(n_values, dtype=geo.n_main.dtype, device=geo.device)
    if engine == "plain":
        obj = rmse_objective(geo, us_bc, ds_bc, h0, Q0, settings, Q_targets, H_targets, ic_fn=ic_fn)
        return torch.stack([obj(n) for n in n_values])
    geob = roughness_ensemble(geo, n_values)
    if ic_fn is not None:
        states = [ic_fn(trees.member(geob, m)) for m in range(n_values.shape[0])]
        h0, Q0 = (torch.stack(s) for s in zip(*states))
    settings = dataclasses.replace(settings, store="boundaries")
    out = batched_simulate(geob, us_bc, ds_bc, h0, Q0, settings, engine="fused")
    return _rmse(upstream_stage_at(out, geo.z_bed[0], Q_targets), H_targets)
