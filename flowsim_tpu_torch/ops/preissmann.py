"""Preissmann four-point implicit box scheme — the dynamical core (torch).

Counterpart of ``flowsim_tpu/ops/preissmann.py``.  Each Newton iteration is

    1. one vectorized stencil evaluating all 2N residuals and all (8N-4)
       Jacobian entries from the per-node closure tensors, and
    2. one block-tridiagonal solve (see :mod:`flowsim_tpu_torch.ops.tridiag`)
       for the Newton update.

Time stepping is a Python loop over levels and the Newton iteration a Python
``while`` (the JAX package's ``lax.scan`` / ``lax.while_loop``).  This eager
engine is the **plain version** that the fused CUDA kernel
(``ops/cuda/fused_newton.py``) is held against; the fast path on the card is
that kernel.

Numerical semantics replicated exactly:

* theta-weighted operators time_diff / spatial_diff / cell_avg;
* unknown ordering [h0,Q0,h1,Q1,...] and equation ordering
  [US, C_0, M_0, ..., C_{N-2}, M_{N-2}, DS], regrouped into the equivalent
  2x2-block tridiagonal form;
* convergence on the L2 norm of the *pre-update* residual, with the final
  Newton increment still applied;
* the gate controller of a ``gated_blend`` downstream curve steps once per
  level, before Newton, on the previous level's downstream stage;
* the storage volume of a lumped reservoir is 0.5 (Q^{k-1} + Q^k) dt at its
  boundary node, and the stage recorded for a level is that of the level's
  last assembly.

Not ported yet (ROADMAP.md Queue 1): ``newton="fixed"`` / ``"implicit"``.
The TPU-only
settings ``out_memory`` and ``fused_unroll`` of the JAX package have no
counterpart: they steer VMEM placement and a loop-overhead trick of the
Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from flowsim_tpu_torch.config import GRAVITY as g
from flowsim_tpu_torch.ops import boundary as bnd
from flowsim_tpu_torch.ops import sections as sec
from flowsim_tpu_torch.ops import tridiag


@dataclass(frozen=True)
class PreissmannSettings:
    theta: float
    time_step: float
    spatial_step: float
    n_time_levels: int
    tolerance: float
    max_iter: int
    linear_solver: str = "pcr"
    # 'while': data-dependent Newton loop — the only variant ported so far
    newton: str = "while"
    gate_initially_open: bool = False
    # diagnos=True tracks a PCR-pivot rcond proxy per level (SimOutput.rcond)
    diagnos: bool = False
    # "full" stores every node of every level; "boundaries" keeps only nodes
    # 0 and N-1 (depth/flow become [nt, 2]): the Monte-Carlo output mode
    store: str = "full"


class PrevLevel(NamedTuple):
    """Quantities of the previous (converged) time level, computed once."""

    h: torch.Tensor
    Q: torch.Tensor
    A: torch.Tensor
    Se: torch.Tensor
    Q2A: torch.Tensor


class SimOutput(NamedTuple):
    depth: torch.Tensor        # [nt, N] ([nt, 2] with store="boundaries")
    flow: torch.Tensor         # [nt, N] ([nt, 2] with store="boundaries")
    iterations: torch.Tensor   # [nt] Newton iterations (0 at level 0)
    error: torch.Tensor        # [nt] final pre-update residual norm
    converged: torch.Tensor    # [nt] bool
    reservoir_stage: torch.Tensor  # [nt] NaN unless a storage BC (ds, or us-only)
    gate_open: torch.Tensor    # [nt] gate flag (gated_blend downstream curve)
    rcond: Optional[torch.Tensor] = None  # [nt] min pivot-rcond proxy (diagnos)
    reservoir_stage_us: Optional[torch.Tensor] = None  # [nt] upstream storage stage


STORES = ("full", "boundaries")


def check_settings(settings: PreissmannSettings) -> None:
    """Reject the options of the JAX package that are not ported yet."""
    if settings.newton != "while":
        raise NotImplementedError(
            f"newton={settings.newton!r} is not ported yet (ROADMAP.md Queue 2); "
            "only the while-Newton is")
    if settings.store not in STORES:
        raise ValueError(f"unknown store {settings.store!r}; expected one of {STORES}")
    if settings.linear_solver not in tridiag.METHODS:
        raise ValueError(f"unknown linear_solver {settings.linear_solver!r}")


def _node_section(st: sec.SectionState, i) -> bnd.NodeSection:
    return bnd.NodeSection(
        A=st.A[i], R=st.R[i], K=st.K[i], n_eq=st.n_eq[i],
        dA_dh=st.dA_dh[i], dR_dA=st.dR_dA[i], dK_dA=st.dK_dA[i],
    )


def prev_level_state(geo, h, Q) -> PrevLevel:
    st = sec.section_state(geo, h)
    es = sec.energy_slope(geo, h, Q, st)
    return PrevLevel(h=h, Q=Q, A=st.A, Se=es.Se, Q2A=Q * Q / st.A)


class CellOut(NamedTuple):
    """Per-cell stencil outputs needed by the two adjacent block rows."""

    Rc: torch.Tensor
    Rm: torch.Tensor
    dC_dh_i: torch.Tensor
    dC_dh_i1: torch.Tensor
    dM_dh_i: torch.Tensor
    dM_dh_i1: torch.Tensor
    dM_dQ_i: torch.Tensor
    dM_dQ_i1: torch.Tensor


def node_stencil_fields(geo, st, es, h, Q) -> dict:
    """The per-node tensors :func:`cell_stencil` consumes."""
    return dict(
        A=st.A, z=geo.z_bed, h=h, Se=es.Se, Q2A=Q * Q / st.A, Q=Q,
        dA_dh=st.dA_dh, dSe_dA=es.dSe_dA_eff, dSe_dQ=es.dSe_dQ, QA=Q / st.A,
    )


def cell_stencil(theta, dt, dx, cur: dict, prev: dict) -> CellOut:
    """Interior residual + Jacobian stencil over the n-1 cells of n node
    tensors.  ``prev`` needs keys A, Se, Q2A, Q, h only.

    Optional ``qlat`` key on both dicts ([N] lateral inflow per unit length,
    m^2/s): continuity becomes dA/dt + dQ/dx = q with q entering as the
    theta-weighted cell average; the lateral momentum flux is neglected.
    State-independent, so the Jacobian is unchanged."""
    A, Se, Q2A, Q, hcur, z = cur["A"], cur["Se"], cur["Q2A"], cur["Q"], cur["h"], cur["z"]
    dA_dh, dSe_dA, dSe_dQ, QA = cur["dA_dh"], cur["dSe_dA"], cur["dSe_dQ"], cur["QA"]
    Ap, Sep, Q2Ap, Qp, hp = prev["A"], prev["Se"], prev["Q2A"], prev["Q"], prev["h"]

    tdiff = lambda c, p: (c[1:] + c[:-1] - p[1:] - p[:-1]) / (2.0 * dt)
    sdiff = lambda c, p: (theta * (c[1:] - c[:-1]) + (1.0 - theta) * (p[1:] - p[:-1])) / dx
    cavg = lambda c, p: 0.5 * theta * (c[1:] + c[:-1]) + 0.5 * (1.0 - theta) * (p[1:] + p[:-1])

    Rc = tdiff(A, Ap) + sdiff(Q, Qp)
    if cur.get("qlat") is not None:
        Rc = Rc - cavg(cur["qlat"], prev["qlat"])
    avgA = cavg(A, Ap)
    # water-level slope as bed slope + theta-weighted depth slope: identical
    # algebra to sdiff(z+h) but cancellation-free
    dYdx = (z[1:] - z[:-1]) / dx + sdiff(hcur, hp)
    avgSe = cavg(Se, Sep)
    Rm = tdiff(Q, Qp) + sdiff(Q2A, Q2Ap) + g * avgA * (dYdx + avgSe)

    th_dx = theta / dx
    inv2dt = 1.0 / (2.0 * dt)
    geom = dYdx + avgSe
    QA2 = QA * QA
    return CellOut(
        Rc=Rc,
        Rm=Rm,
        dC_dh_i=dA_dh[:-1] * inv2dt,
        dC_dh_i1=dA_dh[1:] * inv2dt,
        # dC_dQ_i = -th_dx ; dC_dQ_i1 = th_dx (constants)
        dM_dh_i=(th_dx * QA2[:-1] * dA_dh[:-1]
                 + g * (avgA * (-th_dx + 0.5 * theta * dSe_dA[:-1] * dA_dh[:-1])
                        + 0.5 * theta * dA_dh[:-1] * geom)),
        dM_dh_i1=(-th_dx * QA2[1:] * dA_dh[1:]
                  + g * (avgA * (th_dx + 0.5 * theta * dSe_dA[1:] * dA_dh[1:])
                         + 0.5 * theta * dA_dh[1:] * geom)),
        dM_dQ_i=inv2dt - th_dx * 2.0 * QA[:-1] + g * avgA * 0.5 * theta * dSe_dQ[:-1],
        dM_dQ_i1=inv2dt + th_dx * 2.0 * QA[1:] + g * avgA * 0.5 * theta * dSe_dQ[1:],
    )


def assemble(geo, us_bc, ds_bc, settings: PreissmannSettings, prev: PrevLevel, h, Q, k, bc_state=None,
             qlat_cur=None, qlat_prev=None):
    """Residuals + block-tridiagonal Jacobian at the current Newton iterate.

    Returns (L, D, U, b, err_norm, reservoir_stage, reservoir_stage_us):
    the 2x2 block system J delta = b (b = -R grouped per node), the L2 norm
    of R, and the two boundaries' new storage stages (each boundary reads its
    own previous stage from ``bc_state``).  ``reservoir_stage`` is the
    downstream stage, or the upstream one when only that end has storage;
    ``reservoir_stage_us`` is NaN unless the upstream boundary has storage.
    """
    theta = settings.theta
    dt = settings.time_step
    dx = settings.spatial_step

    st = sec.section_state(geo, h)
    es = sec.energy_slope(geo, h, Q, st)

    # -- interior residuals + Jacobian, one stencil over cells -------------
    cells = cell_stencil(
        theta, dt, dx, dict(node_stencil_fields(geo, st, es, h, Q), qlat=qlat_cur),
        dict(A=prev.A, Se=prev.Se, Q2A=prev.Q2A, Q=prev.Q, h=prev.h, qlat=qlat_prev))
    Rc, Rm = cells.Rc, cells.Rm
    th_dx = theta / dx

    # -- boundary rows -----------------------------------------------------
    rs_prev = None if bc_state is None else bc_state.reservoir_stage
    rs_prev_us = None if bc_state is None else bc_state.reservoir_stage_us
    us = bnd.evaluate(us_bc, _node_section(st, 0), h[0], Q[0], k, dt,
                      Q_prev=prev.Q[0], reservoir_stage_prev=rs_prev_us,
                      bc_state=bc_state, upstream=True, h_prev=prev.h[0])
    ds = bnd.evaluate(ds_bc, _node_section(st, -1), h[-1], Q[-1], k, dt,
                      Q_prev=prev.Q[-1], reservoir_stage_prev=rs_prev, bc_state=bc_state)
    reservoir_stage = torch.where(torch.isnan(ds.reservoir_stage), us.reservoir_stage, ds.reservoir_stage)

    # -- norm of the full residual vector ----------------------------------
    err = torch.sqrt(us.residual**2 + ds.residual**2 + torch.sum(Rc**2) + torch.sum(Rm**2))

    # -- regroup into 2x2 block-tridiagonal form ---------------------------
    # L rows (1,.) and U rows (0,.) are structurally zero; D row 0 of node 0
    # is the upstream row, D row 1 of node N-1 the downstream row.
    N = h.shape[0]
    L = h.new_zeros((N, 2, 2))
    D = h.new_zeros((N, 2, 2))
    U = h.new_zeros((N, 2, 2))
    b = h.new_zeros((N, 2))

    L[1:, 0, 0] = cells.dM_dh_i
    L[1:, 0, 1] = cells.dM_dQ_i
    D[0, 0, 0] = us.df_dh
    D[0, 0, 1] = us.df_dQ
    D[1:, 0, 0] = cells.dM_dh_i1
    D[1:, 0, 1] = cells.dM_dQ_i1
    D[:-1, 1, 0] = cells.dC_dh_i
    D[:-1, 1, 1] = -th_dx
    D[-1, 1, 0] = ds.df_dh
    D[-1, 1, 1] = ds.df_dQ
    U[:-1, 1, 0] = cells.dC_dh_i1
    U[:-1, 1, 1] = th_dx

    b[0, 0] = -us.residual
    b[1:, 0] = -Rm
    b[:-1, 1] = -Rc
    b[-1, 1] = -ds.residual
    return L, D, U, b, err, reservoir_stage, us.reservoir_stage


def _solve_with_diag(L, D, U, b, settings):
    """Newton increment + (when ``settings.diagnos``) an rcond proxy."""
    method = settings.linear_solver
    if not settings.diagnos:
        return tridiag.solve_block_tridiag(L, D, U, b, method=method), None
    if method == "pcr":
        return tridiag.block_pcr_diag(L, D, U, b)
    delta = tridiag.solve_block_tridiag(L, D, U, b, method=method)
    _, rc = tridiag.block_pcr_diag(L, D, U, b)
    return delta, rc


def newton_solve(geo, us_bc, ds_bc, settings, prev: PrevLevel, h, Q, k, bc_state=None,
                 qlat_cur=None, qlat_prev=None):
    """One time level: Newton-iterate to tolerance.

    Returns ``(h, Q, err, iters, reservoir_stage, reservoir_stage_us,
    rcond)``; the loop condition is on the residual computed *before* the
    update, and the update of that iteration is still applied.  ``rcond`` is
    the minimum pivot-rcond proxy across the level's iterations (1.0 when
    ``settings.diagnos`` is off).
    """
    tol = settings.tolerance
    err = torch.full((), float("inf"), dtype=h.dtype, device=h.device)
    rcond = torch.ones((), dtype=h.dtype, device=h.device)
    res_stage = res_stage_us = torch.full((), float("nan"), dtype=h.dtype, device=h.device)
    it = 0
    # one host read of the residual norm per iteration: the loop is data
    # dependent, as lax.while_loop is in the JAX package
    while float(err) >= tol and it < settings.max_iter:
        L, D, U, b, err, res_stage, res_stage_us = assemble(
            geo, us_bc, ds_bc, settings, prev, h, Q, k, bc_state, qlat_cur=qlat_cur, qlat_prev=qlat_prev)
        delta, rc = _solve_with_diag(L, D, U, b, settings)
        h = h + delta[:, 0]
        Q = Q + delta[:, 1]
        if rc is not None:
            rcond = torch.minimum(rcond, rc)
        it += 1
    return h, Q, err, it, res_stage, res_stage_us, rcond


def _initial_state(ds_bc, h0, settings):
    gate_open0 = 1.0 if settings.gate_initially_open else 0.0
    return gate_open0, bnd.initial_bc_state(
        h0.dtype, h0.device, gate_open=gate_open0, gate_stage=ds_bc.bed_level + h0[-1])


def check_shapes(geo, us_bc, ds_bc, h0, Q0, settings, lateral_inflow=None) -> None:
    """Explicit shape checks: torch would raise on an out-of-range index, but
    a mismatched series or state should fail before the first level."""
    N, nt = geo.n_nodes, settings.n_time_levels
    if h0.shape != (N,) or Q0.shape != (N,):
        raise ValueError(f"h0/Q0 must have shape ({N},); got {tuple(h0.shape)}, {tuple(Q0.shape)}")
    for name, bc in (("upstream", us_bc), ("downstream", ds_bc)):
        if bc.kind in ("flow_hydrograph", "stage_hydrograph") and bc.target_series.shape != (nt,):
            raise ValueError(
                f"{name} target_series must have n_time_levels={nt} entries; "
                f"got {tuple(bc.target_series.shape)}")
    if lateral_inflow is not None:
        q = lateral_inflow
        if q.shape[-1:] != (N,):
            raise ValueError(f"lateral_inflow last dim {tuple(q.shape)[-1:]} != n_nodes {N}")
        if q.dim() != 1 and (q.dim() != 2 or q.shape[0] != nt):
            # a wrong time length would otherwise index past the last row
            raise ValueError(f"lateral_inflow must be [N] or [nt={nt}, N]; got {tuple(q.shape)}")


def as_lateral_inflow(lateral_inflow, like):
    """``None`` or a float64 tensor on the device of ``like``."""
    if lateral_inflow is None:
        return None
    return torch.as_tensor(lateral_inflow, dtype=like.dtype, device=like.device)


def simulate(geo, us_bc, ds_bc, h0, Q0, settings: PreissmannSettings, lateral_inflow=None) -> SimOutput:
    """Full run: Newton-solved levels 1..nt-1, on the device of ``h0``.

    ``lateral_inflow``: optional distributed source q [m^2/s], per node [N]
    (constant in time) or per level and node [nt, N] (see
    :func:`cell_stencil`)."""
    check_settings(settings)
    lateral_inflow = as_lateral_inflow(lateral_inflow, h0)
    check_shapes(geo, us_bc, ds_bc, h0, Q0, settings, lateral_inflow)
    nt = settings.n_time_levels
    N = h0.shape[0]
    dev, dtype = h0.device, h0.dtype
    ds_bed = ds_bc.bed_level
    if lateral_inflow is not None and lateral_inflow.dim() == 1:
        lateral_inflow = lateral_inflow.expand(nt, N)
    # store="boundaries" keeps nodes 0 and N-1 only
    keep = slice(None) if settings.store == "full" else torch.tensor([0, N - 1], device=dev)
    width = N if settings.store == "full" else 2

    gate_open0, bc_state = _initial_state(ds_bc, h0, settings)
    depth = torch.empty((nt, width), dtype=dtype, device=dev)
    flow = torch.empty((nt, width), dtype=dtype, device=dev)
    depth[0], flow[0] = h0[keep], Q0[keep]
    iters = torch.zeros((nt,), dtype=torch.int32)
    errs = torch.zeros((nt,), dtype=dtype, device=dev)
    gates = torch.full((nt,), gate_open0, dtype=dtype, device=dev)
    rconds = torch.ones((nt,), dtype=dtype, device=dev)
    stages = torch.full((nt,), float("nan"), dtype=dtype, device=dev)
    stages_us = torch.full((nt,), float("nan"), dtype=dtype, device=dev)

    h, Q = h0, Q0
    for k in range(1, nt):
        # per-level gate-controller update (no-op unless gated_blend ds curve)
        bc_state = bnd.update_gate_level_start(ds_bc, bc_state, float(k) * settings.time_step)
        prev = prev_level_state(geo, h, Q)
        qlat_cur = None if lateral_inflow is None else lateral_inflow[k]
        qlat_prev = None if lateral_inflow is None else lateral_inflow[k - 1]
        h, Q, err, it, res_stage, res_stage_us, rcond = newton_solve(
            geo, us_bc, ds_bc, settings, prev, h, Q, k, bc_state, qlat_cur=qlat_cur, qlat_prev=qlat_prev)
        bc_state = bc_state._replace(reservoir_stage=res_stage, gate_stage=ds_bed + h[-1],
                                     reservoir_stage_us=res_stage_us)
        stages[k], stages_us[k] = res_stage, res_stage_us
        depth[k], flow[k] = h[keep], Q[keep]
        iters[k] = it
        errs[k] = err
        gates[k] = bc_state.gate_open
        rconds[k] = rcond

    converged = errs < settings.tolerance
    converged[0] = True
    return SimOutput(
        depth=depth,
        flow=flow,
        iterations=iters.to(dev),
        error=errs,
        converged=converged,
        reservoir_stage=stages,
        gate_open=gates,
        rcond=rconds,
        reservoir_stage_us=stages_us,
    )


def single_step(geo, us_bc, ds_bc, h, Q, k, settings: PreissmannSettings, bc_state=None,
                qlat_cur=None, qlat_prev=None):
    """Advance one time level with the full per-level semantics of
    :func:`simulate`'s loop body (gate update, Newton solve, state carry).

    Returns ``(h, Q, err, iters, bc_state)``.
    """
    check_settings(settings)
    if bc_state is None:
        _, bc_state = _initial_state(ds_bc, h, settings)
    bc_state = bnd.update_gate_level_start(ds_bc, bc_state, float(k) * settings.time_step)
    prev = prev_level_state(geo, h, Q)
    h2, Q2, err, iters, res_stage, res_stage_us, _ = newton_solve(
        geo, us_bc, ds_bc, settings, prev, h, Q, k, bc_state, qlat_cur=qlat_cur, qlat_prev=qlat_prev)
    bc_state = bc_state._replace(reservoir_stage=res_stage, gate_stage=ds_bc.bed_level + h2[-1],
                                 reservoir_stage_us=res_stage_us)
    return h2, Q2, err, iters, bc_state
