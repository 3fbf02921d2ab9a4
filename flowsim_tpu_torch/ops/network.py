"""River networks: 1-D branches joined at junctions, one implicit system per level.

Counterpart of ``flowsim_tpu/ops/network.py``.  Junction physics is the
standard practice of 1-D river models: every branch end that meets a
junction has the junction's water-surface elevation, and discharge is
continuous across it (the momentum flux through the junction is neglected):

    at junction j with stage Y_j:
        h_end,b = Y_j - z_bed_end,b        (one row per connected end)
        sum_b  sgn_b * Q_end,b = 0          (one row per junction)

``sgn`` is +1 for a branch whose downstream end meets the junction and -1
for one whose upstream end does.  Splitting one reach at an interior node
loses no physics: a 2-branch serial split solves the same nonlinear system as
the single reach.

Each branch contributes the single reach's theta-box stencil
(``ops/preissmann.cell_stencil``) and a 2x2 block-tridiagonal Jacobian; the
junction stages couple only the end rows, and the global arrowhead system is
solved by a Schur complement:

    T_b dx_b + C_b dY = -R_b       per branch
    E dx + D_Y dY     = -G         junction rows
    u_b = T_b^{-1}(-R_b),  V_b = T_b^{-1} C_b    (one multi-RHS solve)
    (E V - D_Y) dY = G + E u,      dx_b = u_b - V_b dY

Newton converges on the pre-update residual of every branch plus the
junction imbalances.  External ends take every boundary kind of
``ops/boundary.py`` (gated controller and lumped storage included), each with
its own carried ``BCState``.  A junction may be a reservoir
(``junction_area > 0``) and may have a rated outflow leaving the network
(``junction_rating``; every kind but ``gated_blend``).

Three engines:

* ``"loop"`` — a Python level loop and a Python ``while`` Newton over the
  branches one by one (the JAX package's per-branch ``lax.scan``);
* ``"stacked"`` — every branch edge-padded to the longest length Nmax, one
  batched assembly and one batched multi-RHS block solve per iteration (pad
  nodes carry delta-copy equations, so node Nmax-1 mirrors each branch's real
  end); ``settings.linear_solver`` picks the solve, ``"cuda_pcr"`` is kernel
  2 over all branches and right-hand sides in one launch.  It stacks the
  branches' geometry trees, so, as in the JAX package, every branch has one
  geometry class (a network that mixes trapezoid and table branches raises
  ``ValueError``) and table branches share their static ``n_ref``;
* ``"fused"`` — the whole simulation in one CUDA kernel launch
  (``ops/cuda/fused_network.py``); on CPU tensors its plain version.

The fused network kernel's plain version is :func:`simulate_stacked` with
``by_class=True`` and the ``"pcr"`` solve: the stacked engine with each
geometry class stacked on its own and its closures evaluated on its own
branches, so that it also runs mixed networks, as the kernel does.

Branch geometry: :class:`TrapezoidGeometry` (closed forms) or
:class:`TableGeometry` (per-node lookup tables of surveyed sections), mixed
freely in the loop engine and in the fused kernel.

A network Monte-Carlo overrides branch fields per member: :func:`check_batch`
validates the overrides, :func:`simulate_members` runs the members one after
another through the stacked engine (``parallel/ensemble``'s plain engine and,
with ``by_class=True``, the batched network kernel's plain version).

Not ported yet: ``simulate_network_chunk`` (checkpoint/resume, ROADMAP.md
Queue 1 item 14) and ``newton="fixed"`` (gradients, item 9; it raises).
The TPU-only f32-LU-plus-refinement junction solve of the JAX package has no
counterpart: the card solves in float64.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from types import SimpleNamespace
from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from flowsim_tpu_torch import trees
from flowsim_tpu_torch.config import farray
from flowsim_tpu_torch.geometry import TableGeometry, TrapezoidGeometry
from flowsim_tpu_torch.ops import boundary as bnd
from flowsim_tpu_torch.ops import preissmann as prs
from flowsim_tpu_torch.ops import rating_curve as rcurve
from flowsim_tpu_torch.ops import sections as sec
from flowsim_tpu_torch.ops import tridiag

ENGINES = ("loop", "stacked", "fused")


@dataclass
class BranchDef:
    """One network branch: geometry, grid spacing and initial state.

    ``us`` / ``ds``: a :class:`~flowsim_tpu_torch.ops.boundary.BoundaryParams`
    (external end) or an ``int`` junction id in ``[0, n_junctions)``.  Flow is
    positive from ``us`` to ``ds``.  ``qlat``: optional lateral inflow
    [m^2/s], per node ``[N]`` or per level and node ``[nt, N]``.
    """

    geo: object
    dx: float
    us: Union[bnd.BoundaryParams, int]
    ds: Union[bnd.BoundaryParams, int]
    h0: torch.Tensor
    Q0: torch.Tensor
    qlat: Optional[torch.Tensor] = None


class NetworkOutput(NamedTuple):
    depth: tuple                   # per branch [nt, N_b]
    flow: tuple                    # per branch [nt, N_b]
    junction_stage: torch.Tensor   # [nt, J]
    iterations: torch.Tensor       # [nt]
    error: torch.Tensor            # [nt]
    converged: torch.Tensor        # [nt]
    # per external end [nt, n_branches, 2 (us, ds)]; NaN where unused
    reservoir_stage: torch.Tensor = None
    gate_open: torch.Tensor = None
    # rated outflow leaving the network at each junction [nt, J]
    junction_outflow: torch.Tensor = None


def _is_junction(end) -> bool:
    return isinstance(end, (int, np.integer))


def check_junction_inputs(junction_area, junction_rating, n_junctions):
    """The junction configuration must match the junction count exactly: a
    short ``junction_area`` would otherwise broadcast or read past its end."""
    if junction_area is not None and len(junction_area) != n_junctions:
        raise ValueError(f"junction_area has {len(junction_area)} entries for {n_junctions} junctions")
    if junction_rating is not None:
        if len(junction_rating) != n_junctions:
            raise ValueError(f"junction_rating has {len(junction_rating)} entries for {n_junctions} junctions")
        for rc in junction_rating:
            if rc is not None and rc.kind == "gated_blend":
                raise ValueError("gated_blend is not supported at junctions")


def _check_supported(branches: List[BranchDef], n_junctions: int, settings=None):
    """Trapezoid or table geometry (another class raises ``TypeError``),
    junction ids in range, every junction with >= 2 ends, and (with
    ``settings``) every branch's state, series and lateral inflow of the
    shapes the level loop indexes: a wrong length would read past an end."""
    for i, br in enumerate(branches):
        if not isinstance(br.geo, (TrapezoidGeometry, TableGeometry)):
            raise TypeError(f"branch {i}: unknown geometry class {type(br.geo).__name__!r}; a branch takes "
                            "TrapezoidGeometry or TableGeometry")
        n_b = int(br.h0.shape[0])
        for end_name, end in (("us", br.us), ("ds", br.ds)):
            if _is_junction(end):
                if not 0 <= int(end) < n_junctions:
                    raise ValueError(f"branch {i} {end_name}: junction id {end} out of range [0, {n_junctions})")
            elif settings is not None and end.kind in ("flow_hydrograph", "stage_hydrograph") \
                    and tuple(end.target_series.shape) != (settings.n_time_levels,):
                raise ValueError(
                    f"branch {i} {end_name} target_series must have n_time_levels="
                    f"{settings.n_time_levels} entries; got {tuple(end.target_series.shape)}")
        if tuple(br.h0.shape) != (br.geo.n_nodes,) or tuple(br.Q0.shape) != (br.geo.n_nodes,):
            raise ValueError(f"branch {i}: h0/Q0 must have shape ({br.geo.n_nodes},)")
        if br.qlat is not None and settings is not None:
            shape = tuple(torch.as_tensor(br.qlat).shape)
            nt = settings.n_time_levels
            if shape not in ((n_b,), (nt, n_b)):
                raise ValueError(f"branch {i} qlat shape {shape} must be [{n_b}] or [nt={nt}, {n_b}]")
    for j in range(n_junctions):
        ends = sum(int(_is_junction(e) and int(e) == j) for br in branches for e in (br.us, br.ds))
        if ends < 2:
            raise ValueError(f"junction {j} connects {ends} end(s); needs >= 2")


def _end_row_junction(h_end, z_end, Y_j):
    """Equal-stage row at a junction-connected branch end."""
    return h_end - (Y_j - z_end), torch.ones_like(h_end), torch.zeros_like(h_end)


def default_initial_stages(branches, n_junctions):
    """Default Y0: the water level of the first connected end of each
    junction, downstream ends preferred."""
    found = {}
    for br in branches:
        for end, idx in ((br.ds, -1), (br.us, 0)):
            if _is_junction(end) and int(end) not in found:
                found[int(end)] = br.geo.z_bed[idx] + br.h0[idx]
    h0 = branches[0].h0
    if not n_junctions:
        return h0.new_zeros((0,))
    return torch.stack([found[j] for j in range(n_junctions)])


def _solve_junction_system(M, rhs):
    """The dense J x J Schur system, float64 (LU with partial pivoting)."""
    if M.shape[0] == 1:
        return rhs / M[0, 0]
    return torch.linalg.solve(M, rhs)


def _sum_signed_ends(branches, Qs, n_junctions):
    """sum sgn * Q_end per junction (+1 for a downstream end, -1 upstream),
    accumulated in the order of the branches, downstream end first."""
    S = Qs[0].new_zeros((n_junctions,))
    for br, Q in zip(branches, Qs):
        if _is_junction(br.ds):
            S[int(br.ds)] += Q[-1]
        if _is_junction(br.us):
            S[int(br.us)] += -Q[0]
    return S


def _junction_outflow(junction_rating, Y):
    """Per-junction rated outflow Q_out(Y) and dQ_out/dY ([J] each): zero at
    a junction without a rating."""
    J = Y.shape[0]
    if junction_rating is None:
        z = Y.new_zeros((J,))
        return z, z
    q, dq = [], []
    for j, rc in enumerate(junction_rating):
        if rc is None:
            q.append(Y.new_zeros(()))
            dq.append(Y.new_zeros(()))
        else:
            q.append(rcurve.discharge(rc, Y[j]))
            dq.append(rcurve.dQ_dz(rc, Y[j]))
    return torch.stack(q), torch.stack(dq)


def _junction_residuals(S, Y, area, dt, q_out, prev_terms):
    """Junction rows, shared by the engines.

    Plain junction (area = 0): ``G = sum sgn Q - Q_out(Y)``.  Junction
    reservoir (area > 0), a 0-D storage with the trapezoidal mass balance of
    the lumped storage:
    ``area (Y - Y_prev)/dt - 0.5 (S + S_prev) + 0.5 (Q_out + Q_out_prev)``.
    ``prev_terms`` = (Y_prev, S_prev, Q_out_prev), the level-start values."""
    Y_prev, Sp, q_out_prev = prev_terms
    G_plain = S - q_out
    G_stor = area * (Y - Y_prev) / dt - 0.5 * (S + Sp) + 0.5 * (q_out + q_out_prev)
    return torch.where(area > 0.0, G_stor, G_plain)


def _schur_diagonal(area, dt, dq_dz):
    """D_Y = dG/dY: area/dt + 0.5 dQ_out/dY at a reservoir, -dQ_out/dY at a
    plain junction; and fac = dG/dQ_end scale (-1/2 at a reservoir, 1)."""
    stor = area > 0.0
    D_Y = torch.where(stor, area / dt + 0.5 * dq_dz, -dq_dz)
    fac = torch.where(stor, torch.full_like(area, -0.5), torch.ones_like(area))
    return D_Y, fac


def _initial_end_states(branches, settings, end_nodes):
    """Per branch (us, ds) BCState: the gate starts as the settings say at an
    external end, closed at a junction end (which never reads it)."""
    gate_open0 = 1.0 if settings.gate_initially_open else 0.0
    states = []
    for br, nodes in zip(branches, end_nodes):
        pair = []
        for end, node in zip((br.us, br.ds), nodes):
            h0 = br.h0
            if _is_junction(end):
                pair.append(bnd.initial_bc_state(h0.dtype, h0.device))
            else:
                pair.append(bnd.initial_bc_state(h0.dtype, h0.device, gate_open=gate_open0,
                                                 gate_stage=end.bed_level + h0[node]))
        states.append(tuple(pair))
    return states


def _gate_rows(end_states):
    return torch.stack([torch.stack([s[0].gate_open, s[1].gate_open]) for s in end_states])


def _finish(h0s, Q0s, hs_t, Qs_t, Y0, Y_t, iters, errs, stages_t, gates0, gates_t, junction_rating,
            tol) -> NetworkOutput:
    """Stack the per-level records into a NetworkOutput (level 0 is the
    initial state: 0 iterations, error 0, converged, no reservoir stage)."""
    depth = tuple(torch.cat([h0[None], ht], dim=0) for h0, ht in zip(h0s, hs_t))
    flow = tuple(torch.cat([Q0[None], qt], dim=0) for Q0, qt in zip(Q0s, Qs_t))
    stage = torch.cat([Y0[None], Y_t], dim=0)
    errs = torch.cat([errs.new_zeros((1,)), errs])
    iters = torch.cat([iters.new_zeros((1,)), iters])
    res0 = torch.full((1,) + tuple(stages_t.shape[1:]), float("nan"), dtype=stages_t.dtype,
                      device=stages_t.device)
    return NetworkOutput(depth=depth, flow=flow, junction_stage=stage, iterations=iters, error=errs,
                         converged=errs < tol, reservoir_stage=torch.cat([res0, stages_t]),
                         gate_open=torch.cat([gates0[None], gates_t]),
                         junction_outflow=junction_outflow_series(junction_rating, stage))


def junction_outflow_series(junction_rating, stage):
    """Rated outflow at every junction and level, ``[..., nt, J]``, from the
    junction stages ``[..., nt, J]`` (zeros without a rating)."""
    if junction_rating is None:
        return torch.zeros_like(stage)
    cols = [torch.zeros_like(stage[..., j]) if rc is None else rcurve.discharge(rc, stage[..., j])
            for j, rc in enumerate(junction_rating)]
    return torch.stack(cols, dim=-1)


def simulate_network(branches: List[BranchDef], n_junctions: int, settings: prs.PreissmannSettings,
                     Y0=None, junction_area=None, junction_rating=None,
                     engine: str = "loop") -> NetworkOutput:
    """Run the implicit network solve over ``settings.n_time_levels``, on the
    device of the branches' state.

    ``engine``: ``"loop"``, ``"stacked"`` or ``"fused"`` (module docstring);
    ``"fused"`` raises ``FusedUnsupported`` outside the kernel's scope and
    nothing falls back.  ``Y0``: initial junction stages ``[J]`` (default:
    :func:`default_initial_stages`).  ``junction_area``: ``[J]`` surface
    areas, ``> 0`` makes the junction a reservoir.  ``junction_rating``:
    length-J list of ``RatingCurveParams`` or ``None`` — a rated outflow
    leaving the network there.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    if engine == "stacked":
        return simulate_stacked(branches, n_junctions, settings, Y0, junction_area, junction_rating)
    settings = _checked_settings(branches, n_junctions, settings, junction_area, junction_rating)
    if engine == "fused":
        from flowsim_tpu_torch.ops.cuda.fused_network import fused_simulate_network

        return fused_simulate_network(branches, n_junctions, settings, Y0=Y0, junction_area=junction_area,
                                      junction_rating=junction_rating)
    Y0, area = _junction_start(branches, n_junctions, Y0, junction_area)
    return _simulate_loop(branches, n_junctions, settings, Y0, area, junction_rating)


def simulate_stacked(branches: List[BranchDef], n_junctions: int, settings: prs.PreissmannSettings, Y0=None,
                     junction_area=None, junction_rating=None, by_class: bool = False) -> NetworkOutput:
    """The stacked engine (``simulate_network(engine="stacked")``).

    ``by_class``: stack each geometry class on its own (:func:`stack_geometry`)
    and evaluate its closures on its own branches — the fused network
    kernel's plain version, which also runs a network that mixes trapezoid
    and table branches; else one geometry tree for the whole network, as the
    JAX package's stacked engine stacks it (a mixed network, or table
    branches whose ``n_ref`` differs, raise ``ValueError``)."""
    settings = _checked_settings(branches, n_junctions, settings, junction_area, junction_rating)
    groups = stack_geometry(branches, max(int(br.h0.shape[0]) for br in branches), by_class)
    Y0, area = _junction_start(branches, n_junctions, Y0, junction_area)
    return _simulate_stacked(branches, n_junctions, settings, Y0, area, junction_rating, groups)


def _checked_settings(branches, n_junctions, settings, junction_area, junction_rating):
    """Every input check of the engines; the settings with the float32 floor
    guarded."""
    prs.check_settings(settings)
    _check_supported(branches, n_junctions, settings)
    settings = prs.guard_f32_floor(settings)
    check_junction_inputs(junction_area, junction_rating, n_junctions)
    return settings


def _junction_start(branches, n_junctions, Y0, junction_area):
    """The initial junction stages ``[J]`` and the junction areas ``[J]``."""
    h0 = branches[0].h0
    area = h0.new_zeros((n_junctions,)) if junction_area is None else farray(junction_area, h0.device)
    Y0 = default_initial_stages(branches, n_junctions) if Y0 is None \
        else torch.as_tensor(Y0, dtype=h0.dtype, device=h0.device)
    return Y0, area


def _lateral_inflow(br, k, like):
    """(current, previous) lateral inflow of a branch at level k, or Nones."""
    if br.qlat is None:
        return None, None
    q = torch.as_tensor(br.qlat, dtype=like.dtype, device=like.device)
    return (q, q) if q.dim() == 1 else (q[k], q[k - 1])


def _assemble_branch(br: BranchDef, settings, prev: prs.PrevLevel, h, Q, k, Y, end_states):
    """Residual and block-tridiagonal Jacobian of one branch, with equal-stage
    rows at its junction ends (the regrouping of ``ops/preissmann.assemble``).

    Returns ``(L, D, U, b, err_sq, couplings, (us_stage, ds_stage))``;
    ``couplings`` lists ``(junction, node, block row)`` of each ``-1`` entry
    of dR/dY."""
    theta, dt, dx = settings.theta, settings.time_step, br.dx
    geo = br.geo
    st = sec.section_state(geo, h)
    es = sec.energy_slope(geo, h, Q, st)
    qc, qp = _lateral_inflow(br, k, h)
    cells = prs.cell_stencil(theta, dt, dx, dict(prs.node_stencil_fields(geo, st, es, h, Q), qlat=qc),
                             dict(A=prev.A, Se=prev.Se, Q2A=prev.Q2A, Q=prev.Q, h=prev.h, qlat=qp))
    th_dx = theta / dx
    nan = torch.full((), float("nan"), dtype=h.dtype, device=h.device)
    couplings = []

    def end_row(end, node, upstream, est):
        if _is_junction(end):
            res, dfh, dfq = _end_row_junction(h[node], geo.z_bed[node], Y[int(end)])
            couplings.append((int(end), node, 0 if upstream else 1))
            return res, dfh, dfq, nan
        ev = bnd.evaluate(end, prs._node_section(st, node), h[node], Q[node], k, dt, Q_prev=prev.Q[node],
                          reservoir_stage_prev=est.reservoir_stage, bc_state=est, upstream=upstream,
                          h_prev=prev.h[node])
        return ev.residual, ev.df_dh, ev.df_dQ, ev.reservoir_stage

    us_res, us_dh, us_dq, us_stage = end_row(br.us, 0, True, end_states[0])
    ds_res, ds_dh, ds_dq, ds_stage = end_row(br.ds, -1, False, end_states[1])
    err_sq = us_res**2 + ds_res**2 + torch.sum(cells.Rc**2) + torch.sum(cells.Rm**2)

    N = h.shape[0]
    L = h.new_zeros((N, 2, 2))
    D = h.new_zeros((N, 2, 2))
    U = h.new_zeros((N, 2, 2))
    b = h.new_zeros((N, 2))
    L[1:, 0, 0] = cells.dM_dh_i
    L[1:, 0, 1] = cells.dM_dQ_i
    D[0, 0, 0] = us_dh
    D[0, 0, 1] = us_dq
    D[1:, 0, 0] = cells.dM_dh_i1
    D[1:, 0, 1] = cells.dM_dQ_i1
    D[:-1, 1, 0] = cells.dC_dh_i
    D[:-1, 1, 1] = -th_dx
    D[-1, 1, 0] = ds_dh
    D[-1, 1, 1] = ds_dq
    U[:-1, 1, 0] = cells.dC_dh_i1
    U[:-1, 1, 1] = th_dx
    b[0, 0] = -us_res
    b[1:, 0] = -cells.Rm
    b[:-1, 1] = -cells.Rc
    b[-1, 1] = -ds_res
    return L, D, U, b, err_sq, couplings, (us_stage, ds_stage)


def _update_end_states(branches, end_states, stages, hs_end):
    """After a level: each external end keeps the level's storage stage and
    the stage its gate controller sees next (``hs_end[b] = (h_us, h_ds)``)."""
    out = []
    for b, (br, ests) in enumerate(zip(branches, end_states)):
        pair = []
        for j, end in enumerate((br.us, br.ds)):
            est = ests[j]
            if not _is_junction(end):
                est = est._replace(reservoir_stage=stages[b, j], gate_stage=end.bed_level + hs_end[b][j])
            pair.append(est)
        out.append(tuple(pair))
    return out


def _gate_level_start(branches, end_states, t):
    return [tuple(est if _is_junction(end) else bnd.update_gate_level_start(end, est, t)
                  for end, est in zip((br.us, br.ds), ests))
            for br, ests in zip(branches, end_states)]


def _simulate_loop(branches, J, settings, Y0, area, junction_rating) -> NetworkOutput:
    """The loop engine: each branch assembled and solved on its own."""
    nt, tol, max_iter, dt = settings.n_time_levels, settings.tolerance, settings.max_iter, settings.time_step
    h0s = tuple(br.h0 for br in branches)
    Q0s = tuple(br.Q0 for br in branches)
    end_states = _initial_end_states(branches, settings, [(0, -1)] * len(branches))
    gates0 = _gate_rows(end_states)
    hs, Qs, Y = list(h0s), list(Q0s), Y0
    rec = dict(h=[], Q=[], Y=[], err=[], it=[], stage=[], gate=[])

    def one_iteration(hs, Qs, Y, prevs, k, end_states, prev_terms):
        us_list, V_list, coup_list, stage_rows = [], [], [], []
        err_sq = Y.new_zeros(())
        for br, h, Q, prev, ests in zip(branches, hs, Qs, prevs, end_states):
            L, D, U, b, e2, coup, stages_b = _assemble_branch(br, settings, prev, h, Q, k, Y, ests)
            stage_rows.append(torch.stack(stages_b))
            err_sq = err_sq + e2
            # u = T^{-1}(-R) and one Schur column V = T^{-1} C per junction
            # coupling, solved together as one multi-RHS system
            cols = [b]
            for (_, node, row) in coup:
                c = torch.zeros_like(b)
                c[node, row] = -1.0
                cols.append(c)
            X = tridiag.solve_block_tridiag(L, D, U, torch.stack(cols, dim=-1), method=settings.linear_solver)
            us_list.append(X[..., 0])
            V_list.append([X[..., 1 + i] for i in range(len(coup))])
            coup_list.append(coup)
        q_out, dq_dz = _junction_outflow(junction_rating, Y)
        G = _junction_residuals(_sum_signed_ends(branches, Qs, J), Y, area, dt, q_out, prev_terms)
        err = torch.sqrt(err_sq + torch.sum(G**2))
        if J:
            D_Y, fac = _schur_diagonal(area, dt, dq_dz)
            M = Y.new_zeros((J, J))
            rhs = G.clone()
            for br, u, Vs, coup in zip(branches, us_list, V_list, coup_list):
                ends = []
                if _is_junction(br.ds):
                    ends.append((int(br.ds), -1, 1.0))
                if _is_junction(br.us):
                    ends.append((int(br.us), 0, -1.0))
                for (jj, idx, sgn) in ends:
                    rhs[jj] += fac[jj] * sgn * u[idx, 1]
                    for (jcol, _, _), V in zip(coup, Vs):
                        M[jj, jcol] += fac[jj] * sgn * V[idx, 1]
            dY = _solve_junction_system(M - torch.diag(D_Y), rhs)
        else:
            dY = Y.new_zeros((0,))
        new_hs, new_Qs = [], []
        for h, Q, u, Vs, coup in zip(hs, Qs, us_list, V_list, coup_list):
            dx_b = u
            for (jcol, _, _), V in zip(coup, Vs):
                dx_b = dx_b - V * dY[jcol]
            new_hs.append(h + dx_b[:, 0])
            new_Qs.append(Q + dx_b[:, 1])
        return new_hs, new_Qs, Y + dY, err, torch.stack(stage_rows)

    for k in range(1, nt):
        end_states = _gate_level_start(branches, end_states, float(k) * dt)
        prevs = [prs.prev_level_state(br.geo, h, Q) for br, h, Q in zip(branches, hs, Qs)]
        q_out_prev, _ = _junction_outflow(junction_rating, Y)
        prev_terms = (Y, _sum_signed_ends(branches, [p.Q for p in prevs], J), q_out_prev)
        stages = torch.stack([torch.stack([e[0].reservoir_stage, e[1].reservoir_stage]) for e in end_states])
        err = torch.full((), float("inf"), dtype=Y.dtype, device=Y.device)
        it = 0
        while float(err) >= tol and it < max_iter:
            hs, Qs, Y, err, stages = one_iteration(hs, Qs, Y, prevs, k, end_states, prev_terms)
            it += 1
        end_states = _update_end_states(branches, end_states, stages, [(h[0], h[-1]) for h in hs])
        for key, v in (("h", hs), ("Q", Qs), ("Y", Y), ("err", err), ("it", it), ("stage", stages),
                       ("gate", _gate_rows(end_states))):
            rec[key].append(v)
    dev = Y0.device
    return _finish(h0s, Q0s, [torch.stack([r[b] for r in rec["h"]]) for b in range(len(branches))],
                   [torch.stack([r[b] for r in rec["Q"]]) for b in range(len(branches))],
                   Y0, torch.stack(rec["Y"]), torch.tensor(rec["it"], dtype=torch.int32, device=dev),
                   torch.stack(rec["err"]), torch.stack(rec["stage"]), gates0, torch.stack(rec["gate"]),
                   junction_rating, tol)


def edge_pad(x, n_max):
    """``[N, ...] -> [n_max, ...]``, the last row repeated along axis 0."""
    N = x.shape[0]
    if N == n_max:
        return x
    return torch.cat([x, x[-1:].expand(n_max - N, *x.shape[1:])], dim=0)


def stack_geometry(branches, n_max: int, by_class: bool = False) -> list:
    """The branches' geometry edge-padded to ``n_max`` nodes and stacked,
    ``[(branch indices, geometry [B_c, n_max, ...])]``, one entry per
    geometry class in the order of first appearance.

    ``by_class=False`` (the stacked engine): one tree for the whole network,
    as the JAX package's ``jax.tree_util.tree_map`` stacks it — a network
    that mixes geometry classes raises ``ValueError`` naming the engines that
    run it, and so do table branches whose static ``n_ref`` differs.
    ``by_class=True`` (the fused kernel's plain version): each class is
    stacked on its own, a table's ``n_ref`` (build metadata the simulation
    never reads) dropped."""
    classes = list(dict.fromkeys(type(br.geo) for br in branches))
    if len(classes) > 1 and not by_class:
        raise ValueError(
            "the stacked engine stacks one geometry tree, as the JAX package's does: this network mixes "
            f"{' and '.join(c.__name__ for c in classes)} branches; run it with engine=\"loop\" or "
            "engine=\"fused\"")
    groups = []
    for cls in classes:
        idx = [b for b, br in enumerate(branches) if type(br.geo) is cls]
        geos = [branches[b].geo for b in idx]
        if by_class and cls is TableGeometry:
            geos = [replace(g, n_ref=None) for g in geos]
        groups.append((idx, trees.tree_map(lambda *xs: torch.stack([edge_pad(x, n_max) for x in xs]), *geos)))
    return groups


@dataclass(frozen=True)
class StackedTopology:
    """The static index maps of the stacked engine (and of the fused network
    kernel, which mirrors it).  Junction ends are listed branch by branch,
    downstream end first; ``couplings[b]`` lists ``(junction, node, row)`` of
    branch b's ``-1`` Schur columns, upstream first."""

    n_b: tuple
    n_max: int
    couplings: tuple
    m_rhs: int
    end_branch: tuple
    end_node: tuple
    end_sign: tuple
    end_junction: tuple


def stacked_topology(branches) -> StackedTopology:
    n_b = tuple(int(br.h0.shape[0]) for br in branches)
    n_max = max(n_b)
    coups, eb, eidx, esgn, ejj = [], [], [], [], []
    for b, br in enumerate(branches):
        c = []
        if _is_junction(br.us):
            c.append((int(br.us), 0, 0))
        if _is_junction(br.ds):
            c.append((int(br.ds), n_max - 1, 1))
        coups.append(tuple(c))
        if _is_junction(br.ds):
            eb.append(b); eidx.append(n_max - 1); esgn.append(1.0); ejj.append(int(br.ds))
        if _is_junction(br.us):
            eb.append(b); eidx.append(0); esgn.append(-1.0); ejj.append(int(br.us))
    m_rhs = 1 + max((len(c) for c in coups), default=0)
    return StackedTopology(n_b, n_max, tuple(coups), m_rhs, tuple(eb), tuple(eidx), tuple(esgn), tuple(ejj))


def stack_lateral_inflow(branches, n_max, nt, like):
    """Edge-padded lateral inflow ``[B, Nmax]`` (every branch constant in
    time) or ``[nt, B, Nmax]``; zeros for a branch without one; ``None``
    when no branch has any."""
    if all(br.qlat is None for br in branches):
        return None
    qs = [None if br.qlat is None else torch.as_tensor(br.qlat, dtype=like.dtype, device=like.device)
          for br in branches]
    any2d = any(q is not None and q.dim() == 2 for q in qs)
    per = []
    for br, q in zip(branches, qs):
        n_b = int(br.h0.shape[0])
        q = like.new_zeros((n_b,)) if q is None else q
        if q.dim() == 1:
            q = edge_pad(q, n_max)
            if any2d:
                q = q.expand(nt, n_max)
        else:
            q = edge_pad(q.T, n_max).T
        per.append(q)
    return torch.stack(per, dim=1 if any2d else 0)


def _simulate_stacked(branches, J, settings, Y0, area, junction_rating, groups) -> NetworkOutput:
    """The stacked engine: one batched assembly and one batched multi-RHS
    solve per Newton iteration over the edge-padded branches.  Closures and
    stencil run node-major (``[Nmax, B]``), so the single reach's
    ``cell_stencil`` applies as it is; pads are re-synced to their branch's
    end at every level start.  ``groups``: :func:`stack_geometry`; with
    more than one class each class's closures run on its own columns."""
    topo = stacked_topology(branches)
    B, Nmax = len(branches), topo.n_max
    theta, dt, nt = settings.theta, settings.time_step, settings.n_time_levels
    tol, max_iter = settings.tolerance, settings.max_iter
    h0 = branches[0].h0
    dev, dtype = h0.device, h0.dtype
    f64 = dict(dtype=dtype, device=dev)
    dxs = torch.tensor([float(br.dx) for br in branches], **f64)
    # node-major geometry [Nmax, B, ...]: movedim, not .T, keeps a table's
    # sample axis last
    groupsT = [(torch.tensor(idx, dtype=torch.long, device=dev), trees.tree_map(lambda v: v.movedim(0, 1), g))
               for idx, g in groups]
    if len(groups) == 1:
        z_bedS = groups[0][1].z_bed
    else:
        z_bedS = h0.new_empty((B, Nmax))
        for idx, g in groups:
            z_bedS[idx] = g.z_bed
    bedT = SimpleNamespace(z_bed=z_bedS.T)

    def closures(hT, QT):
        """Section state and energy slope of every slot, node-major."""
        if len(groupsT) == 1:
            g = groupsT[0][1]
            st = sec.section_state(g, hT)
            return st, sec.energy_slope(g, hT, QT, st)
        st_f, es_f = {f: hT.new_empty(hT.shape) for f in sec.SectionState._fields}, \
            {f: hT.new_empty(hT.shape) for f in sec.EnergySlope._fields}
        for cols, g in groupsT:
            h, Q = hT[:, cols], QT[:, cols]
            st = sec.section_state(g, h)
            es = sec.energy_slope(g, h, Q, st)
            for out, part in ((st_f, st), (es_f, es)):
                for f, v in zip(part._fields, part):
                    out[f][:, cols] = v
        return sec.SectionState(**st_f), sec.EnergySlope(**es_f)

    def prev_level_state(hT, QT):
        st, es = closures(hT, QT)
        return prs.PrevLevel(h=hT, Q=QT, A=st.A, Se=es.Se, Q2A=QT * QT / st.A)

    qlatS = stack_lateral_inflow(branches, Nmax, nt, h0)
    n_b = torch.tensor(topo.n_b, device=dev)
    node_real = torch.arange(Nmax, device=dev)[None, :] < n_b[:, None]           # [B, Nmax]
    cell_real = torch.arange(Nmax - 1, device=dev)[None, :] < (n_b - 1)[:, None]  # [B, Nc]
    end_idx = (n_b - 1)[:, None]

    def sync(xS):
        return torch.where(node_real, xS, torch.gather(xS, 1, end_idx))

    m_rhs = topo.m_rhs
    rhs_coup = torch.zeros((B, Nmax, 2, max(m_rhs - 1, 1)), **f64)
    colmap = torch.zeros((B, max(m_rhs - 1, 1)), dtype=torch.long, device=dev)
    colmask = torch.zeros((B, max(m_rhs - 1, 1)), **f64)
    for b, c in enumerate(topo.couplings):
        for ci, (jcol, idx, row) in enumerate(c):
            rhs_coup[b, idx, row, ci] = -1.0
            colmap[b, ci] = jcol
            colmask[b, ci] = 1.0
    eb, eidx, ejj = (torch.tensor(v, dtype=torch.long, device=dev)
                     for v in (topo.end_branch, topo.end_node, topo.end_junction))
    esgn = torch.tensor(topo.end_sign, **f64)
    # (end, coupling of the same branch) pairs -> M[row, col]
    pairs = [(e, ci, jcol) for e, b in enumerate(topo.end_branch) for ci, (jcol, _, _) in enumerate(topo.couplings[b])]
    pe = torch.tensor([p[0] for p in pairs], dtype=torch.long, device=dev)
    pci = torch.tensor([p[1] for p in pairs], dtype=torch.long, device=dev)
    pcol = torch.tensor([p[2] for p in pairs], dtype=torch.long, device=dev)

    def sum_signed_ends(QS):
        return QS.new_zeros((J,)).index_add(0, ejj, esgn * QS[eb, eidx])

    us_junction = [_is_junction(br.us) for br in branches]
    ds_junction = [_is_junction(br.ds) for br in branches]
    us_j = torch.tensor([int(br.us) if u else 0 for br, u in zip(branches, us_junction)], dtype=torch.long, device=dev)
    ds_j = torch.tensor([int(br.ds) if d else 0 for br, d in zip(branches, ds_junction)], dtype=torch.long, device=dev)
    th_dx = (theta / dxs)[:, None]

    def end_rows(stT, hS, QS, prevS, k, end_states, Y, upstream):
        """Residual, df/dh, df/dQ and storage stage of every branch's us (or
        ds) end, [B] each: junction rows vectorised, external ones evaluated
        one by one."""
        idx = 0 if upstream else Nmax - 1
        jid = us_j if upstream else ds_j
        h_e, Q_e = hS[:, idx], QS[:, idx]
        if J:
            res = h_e - (Y[jid] - z_bedS[:, idx])
        else:
            res = torch.zeros_like(h_e)
        dfh, dfq, stage = torch.ones_like(h_e), torch.zeros_like(h_e), torch.full_like(h_e, float("nan"))
        rows = [[], [], [], []]
        ext = []
        for b, br in enumerate(branches):
            end = br.us if upstream else br.ds
            if _is_junction(end):
                continue
            est = end_states[b][0 if upstream else 1]
            node = bnd.NodeSection(A=stT.A[idx, b], R=stT.R[idx, b], K=stT.K[idx, b], n_eq=stT.n_eq[idx, b],
                                   dA_dh=stT.dA_dh[idx, b], dR_dA=stT.dR_dA[idx, b], dK_dA=stT.dK_dA[idx, b])
            ev = bnd.evaluate(end, node, h_e[b], Q_e[b], k, dt, Q_prev=prevS.Q[b, idx],
                              reservoir_stage_prev=est.reservoir_stage, bc_state=est, upstream=upstream,
                              h_prev=prevS.h[b, idx])
            ext.append(b)
            for r, v in zip(rows, (ev.residual, ev.df_dh, ev.df_dQ, ev.reservoir_stage)):
                r.append(v + torch.zeros_like(h_e[b]))
        if ext:
            sel = torch.tensor(ext, dtype=torch.long, device=dev)
            res, dfh, dfq, stage = (t.index_put((sel,), torch.stack(r)) for t, r in zip((res, dfh, dfq, stage), rows))
        return res, dfh, dfq, stage

    def one_iteration(hS, QS, Y, prevS, prevT, k, end_states, qc, qp, prev_terms):
        hT, QT = hS.T, QS.T
        stT, esT = closures(hT, QT)
        cells = prs.cell_stencil(theta, dt, dxs, dict(prs.node_stencil_fields(bedT, stT, esT, hT, QT), qlat=qc),
                                 dict(A=prevT.A, Se=prevT.Se, Q2A=prevT.Q2A, Q=prevT.Q, h=prevT.h, qlat=qp))
        mask = cell_real
        Rc = torch.where(mask, cells.Rc.T, hS[:, 1:] - hS[:, :-1])
        Rm = torch.where(mask, cells.Rm.T, QS[:, 1:] - QS[:, :-1])
        one, zero = torch.ones_like(Rc), torch.zeros_like(Rc)
        dC_dh_i = torch.where(mask, cells.dC_dh_i.T, -one)
        dC_dQ_i = torch.where(mask, -th_dx + zero, zero)
        dC_dh_i1 = torch.where(mask, cells.dC_dh_i1.T, one)
        dC_dQ_i1 = torch.where(mask, th_dx + zero, zero)
        dM_dh_i = torch.where(mask, cells.dM_dh_i.T, zero)
        dM_dQ_i = torch.where(mask, cells.dM_dQ_i.T, -one)
        dM_dh_i1 = torch.where(mask, cells.dM_dh_i1.T, zero)
        dM_dQ_i1 = torch.where(mask, cells.dM_dQ_i1.T, one)
        us_res, us_dh, us_dq, us_stage = end_rows(stT, hS, QS, prevS, k, end_states, Y, True)
        ds_res, ds_dh, ds_dq, ds_stage = end_rows(stT, hS, QS, prevS, k, end_states, Y, False)

        L = hS.new_zeros((B, Nmax, 2, 2))
        D = hS.new_zeros((B, Nmax, 2, 2))
        U = hS.new_zeros((B, Nmax, 2, 2))
        b = hS.new_zeros((B, Nmax, 2))
        L[:, 1:, 0, 0] = dM_dh_i
        L[:, 1:, 0, 1] = dM_dQ_i
        D[:, 0, 0, 0] = us_dh
        D[:, 0, 0, 1] = us_dq
        D[:, 1:, 0, 0] = dM_dh_i1
        D[:, 1:, 0, 1] = dM_dQ_i1
        D[:, :-1, 1, 0] = dC_dh_i
        D[:, :-1, 1, 1] = dC_dQ_i
        D[:, -1, 1, 0] = ds_dh
        D[:, -1, 1, 1] = ds_dq
        U[:, :-1, 1, 0] = dC_dh_i1
        U[:, :-1, 1, 1] = dC_dQ_i1
        b[:, 0, 0] = -us_res
        b[:, 1:, 0] = -Rm
        b[:, :-1, 1] = -Rc
        b[:, -1, 1] = -ds_res

        q_out, dq_dz = _junction_outflow(junction_rating, Y)
        G = _junction_residuals(sum_signed_ends(QS), Y, area, dt, q_out, prev_terms)
        err = torch.sqrt(torch.sum(us_res**2) + torch.sum(ds_res**2) + torch.sum(torch.where(mask, Rc, zero)**2)
                         + torch.sum(torch.where(mask, Rm, zero)**2) + torch.sum(G**2))
        rhs = torch.cat([b[..., None], rhs_coup[..., : m_rhs - 1]], dim=-1)
        X = tridiag.solve_block_tridiag(L, D, U, rhs, method=settings.linear_solver)
        if J:
            D_Y, fac = _schur_diagonal(area, dt, dq_dz)
            rhsJ = G.index_add(0, ejj, fac[ejj] * esgn * X[eb, eidx, 1, 0])
            prow = ejj[pe]
            pvals = fac[prow] * esgn[pe] * X[eb[pe], eidx[pe], 1, 1 + pci]
            M = Y.new_zeros((J * J,)).index_add(0, prow * J + pcol, pvals).reshape(J, J)
            dY = _solve_junction_system(M - torch.diag(D_Y), rhsJ)
            dY_cols = dY[colmap] * colmask                       # [B, m_rhs-1], unused columns 0
            delta = X[..., 0] - (X[..., 1:] * dY_cols[:, None, None, :]).sum(-1)
        else:
            dY = Y.new_zeros((0,))
            delta = X[..., 0]
        return (hS + delta[..., 0], QS + delta[..., 1], Y + dY, err,
                torch.stack([us_stage, ds_stage], dim=-1))

    end_states = _initial_end_states(branches, settings, [(0, n - 1) for n in topo.n_b])
    gates0 = _gate_rows(end_states)
    hS = torch.stack([edge_pad(br.h0, Nmax) for br in branches])
    QS = torch.stack([edge_pad(br.Q0, Nmax) for br in branches])
    h0S, Q0S, Y = hS, QS, Y0
    rec = dict(h=[], Q=[], Y=[], err=[], it=[], stage=[], gate=[])
    for k in range(1, nt):
        hS, QS = sync(hS), sync(QS)
        end_states = _gate_level_start(branches, end_states, float(k) * dt)
        prevT = prev_level_state(hS.T, QS.T)
        prevS = prs.PrevLevel(*(t.T for t in prevT))
        if qlatS is None:
            qc = qp = None
        elif qlatS.dim() == 3:
            qc, qp = qlatS[k].T, qlatS[k - 1].T
        else:
            qc = qp = qlatS.T
        q_out_prev, _ = _junction_outflow(junction_rating, Y)
        prev_terms = (Y, sum_signed_ends(prevS.Q), q_out_prev)
        stages = torch.stack([torch.stack([e[0].reservoir_stage, e[1].reservoir_stage]) for e in end_states])
        err = torch.full((), float("inf"), **f64)
        it = 0
        while float(err) >= tol and it < max_iter:
            hS, QS, Y, err, stages = one_iteration(hS, QS, Y, prevS, prevT, k, end_states, qc, qp, prev_terms)
            it += 1
        end_states = _update_end_states(branches, end_states, stages, [(hS[b, 0], hS[b, Nmax - 1]) for b in range(B)])
        for key, v in (("h", hS), ("Q", QS), ("Y", Y), ("err", err), ("it", it), ("stage", stages),
                       ("gate", _gate_rows(end_states))):
            rec[key].append(v)
    hS_t, QS_t = torch.stack(rec["h"]), torch.stack(rec["Q"])
    return _finish([h0S[b, :n] for b, n in enumerate(topo.n_b)], [Q0S[b, :n] for b, n in enumerate(topo.n_b)],
                   [hS_t[:, b, :n] for b, n in enumerate(topo.n_b)], [QS_t[:, b, :n] for b, n in enumerate(topo.n_b)],
                   Y0, torch.stack(rec["Y"]), torch.tensor(rec["it"], dtype=torch.int32, device=dev),
                   torch.stack(rec["err"]), torch.stack(rec["stage"]), gates0, torch.stack(rec["gate"]),
                   junction_rating, tol)


# -- per-member branch overrides (the network Monte-Carlo) -------------------

BATCH_KEYS = ("geo", "us", "ds", "h0", "Q0", "qlat")


def check_batch(branches, batch, settings) -> int:
    """Validate per-branch override dicts; returns the member count M.

    Every value carries a leading member axis of the same length M:
    ``geo`` / ``us`` / ``ds`` a batched tree, ``h0`` / ``Q0`` ``[M, N]``,
    ``qlat`` ``[M, N]`` or ``[M, nt, N]``.  Junction ends and ``dx`` cannot
    be overridden."""
    if len(batch) != len(branches):
        raise ValueError(f"batch has {len(batch)} entries for {len(branches)} branches; pass one dict per "
                         "branch (an empty dict for a branch shared by all members)")
    M = None
    nt = settings.n_time_levels
    for i, (br, d) in enumerate(zip(branches, batch)):
        n = int(br.h0.shape[0])
        for k, v in d.items():
            if k == "dx":
                raise ValueError("dx is static; rebuild the branches instead")
            if k not in BATCH_KEYS:
                raise ValueError(f"unknown BranchDef override {k!r}; expected one of {BATCH_KEYS}")
            if k in ("us", "ds") and (_is_junction(v) or _is_junction(getattr(br, k))):
                raise ValueError("junction ends cannot be overridden per member")
            if k == "geo" and type(v) is not type(br.geo):
                raise ValueError(f"branch {i} geo: the members must keep the branch's geometry class "
                                 f"{type(br.geo).__name__}")
            if k in ("us", "ds") and (v.kind, getattr(v.rating, "kind", None)) != (
                    getattr(br, k).kind, getattr(getattr(br, k).rating, "kind", None)):
                raise ValueError(f"branch {i} {k}: the members must keep the branch's boundary and rating kinds")
            lead = v.bed_level.shape if k in ("us", "ds") else v.z_bed.shape[:-1] if k == "geo" else v.shape[:1]
            if len(lead) != 1:
                raise ValueError(f"branch {i} {k}: the override needs one leading member axis")
            M = int(lead[0]) if M is None else M
            if int(lead[0]) != M:
                raise ValueError(f"branch {i} {k}: {int(lead[0])} members, the batch has {M}")
            if k in ("h0", "Q0") and tuple(v.shape) != (M, n):
                raise ValueError(f"branch {i} {k} must be [M={M}, N={n}]; got {tuple(v.shape)}")
            if k == "geo" and v.z_bed.shape[-1] != n:
                raise ValueError(f"branch {i} geo has {v.z_bed.shape[-1]} nodes, the branch {n}")
            if k == "qlat" and tuple(v.shape) not in ((M, n), (M, nt, n)):
                raise ValueError(f"branch {i} qlat must be [M={M}, N={n}] or [M, nt={nt}, N]; got {tuple(v.shape)}")
            if k in ("us", "ds") and v.kind in ("flow_hydrograph", "stage_hydrograph") \
                    and tuple(v.target_series.shape) != (M, nt):
                raise ValueError(f"branch {i} {k} target_series must be [M={M}, nt={nt}]")
    if M is None:
        raise ValueError("the batch overrides nothing: give at least one branch a per-member value")
    return M


def member_branches(branches, batch, m):
    """The branches of member ``m`` of a batch."""
    out = []
    for br, d in zip(branches, batch):
        o = {k: (trees.member(v, m) if k in ("geo", "us", "ds") else v[m]) for k, v in d.items()}
        out.append(replace(br, **o) if o else br)
    return out


def join_outputs(outs, join=torch.stack) -> NetworkOutput:
    """NetworkOutputs joined field by field: ``torch.stack`` puts single runs
    on a leading member axis, ``torch.cat`` joins batches along it."""
    return NetworkOutput(
        depth=tuple(join(f) for f in zip(*(o.depth for o in outs))),
        flow=tuple(join(f) for f in zip(*(o.flow for o in outs))),
        **{k: join([getattr(o, k) for o in outs]) for k in NetworkOutput._fields
           if k not in ("depth", "flow")})


def simulate_members(branches, n_junctions, settings, batch, Y0=None, junction_area=None,
                     junction_rating=None, by_class: bool = False) -> NetworkOutput:
    """Every member of a batch (:func:`check_batch`) through the stacked
    engine with ``settings.linear_solver`` (:func:`simulate_stacked`, with
    ``by_class``), one after another, stacked on a leading member axis."""
    M = check_batch(branches, batch, settings)
    return join_outputs([simulate_stacked(member_branches(branches, batch, m), n_junctions, settings, Y0=Y0,
                                          junction_area=junction_area, junction_rating=junction_rating,
                                          by_class=by_class) for m in range(M)])
