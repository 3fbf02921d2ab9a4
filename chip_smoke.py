#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root, no arguments, one card::

    python3 chip_smoke.py

It builds the CUDA kernels of ``flowsim_tpu_torch/ops/cuda/csrc`` with
``nvcc``, holds each against its plain PyTorch version on the card, and drives
four main paths through the user entry points:

* one forecast: the GERD->Roseires flagship end to end (``model.build`` ->
  ``PreissmannSolver.run``), checked by the repository's own means (all levels
  converged, 4803 Newton iterations, fields equal to the plain engine's);
* the Monte-Carlo / calibration path: 10 240 members of that flagship
  (per-member roughness and inflow) through
  ``parallel.ensemble.batched_simulate(engine="fused")`` in one kernel launch,
  with the scaling curve over the member count, and a 64-candidate
  ``models.calibrate.rmse_sweep(engine="fused")``;
* the long reach: a synthetic prismatic reach of 10 000, 100 000 and 1 000 000
  nodes through ``ops.preissmann.simulate(linear_solver="cuda_tiled")`` — one
  launch of the tiled SPIKE kernel per Newton iteration — against the same
  run with the plain ``"pcr"`` solve;
* the reservoir: ``models.example.build()`` (a flood wave routed into a lumped
  storage) with ``engine="fused"`` against ``engine="plain"``.

Any mismatch raises: no phase's failure is caught.  Every phase prints one
JSON line; the last line of the output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<card>", "count": 1}}

Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Peak rates used for the bound of each kernel (NVIDIA H100 SXM data sheet):
# HBM3 at 3.35 TB/s; FP64 outside the tensor cores at half the 67 TFLOP/s
# FP32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_FLOPS = 33.5e12

# Floating-point operations per node, counted by hand from the kernels'
# expressions (a division, sqrt or cbrt counts as one):
#   one PCR sweep of one node   2 inverses (9 each) + a, c (16 each)
#                               + L', U' (12 each) + D' (32) + b' (12)
#   the PCR back-substitution   inverse (9) + 2x2 product (6)
#   one Newton assembly         section state + energy slope with curvature
#                               (~420) + cell stencil and Jacobian (~110)
FLOPS_PCR_SWEEP = 118
FLOPS_PCR_BACKSOLVE = 15
# the same with five right-hand-side pairs (the tiled SPIKE kernel): each
# further pair adds 16 to a sweep and 6 to the back-substitution
FLOPS_PCR_SWEEP_5 = FLOPS_PCR_SWEEP + 4 * 16
FLOPS_PCR_BACKSOLVE_5 = FLOPS_PCR_BACKSOLVE + 4 * 6
FLOPS_ASSEMBLY = 530

H_TOL = 1e-9      # m: kernel vs plain engine, same arithmetic up to rounding
Q_TOL = 1e-6      # m^3/s on flows of ~1e4
STAGE_TOL = 1e-9  # m: reservoir stage of a lumped storage
TILED_REL_TOL = 1e-11   # tiled SPIKE kernel vs its plain version, relative
LONG_REACH_NODES = (10_000, 100_000, 1_000_000)
FLAGSHIP_ITERATIONS = 4803
# the plain engine on the card is a Python loop of small launches (~12 ms per
# Newton iteration): the flagship is held against it over its first levels
PLAIN_COMPARED_LEVELS = 97

# the Monte-Carlo ensemble of the JAX package's north-star script
# (scripts/bench_montecarlo.py): members, draws and seed
ENSEMBLE_MEMBERS = 10240
ENSEMBLE_N_RANGE = (0.025, 0.045)
ENSEMBLE_INFLOW_RANGE = (0.8, 1.2)
ENSEMBLE_SEED = 42
SCALING_MEMBERS = (1, 66, 132, 264, 528, 2048)
SWEEP_CANDIDATES = 64


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sweeps(n: int) -> int:
    return max(1, (n - 1).bit_length())


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events around
    ``reps`` back-to-back calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def random_system(n: int, seed: int, device):
    """Seeded, block-diagonally-dominant 2x2-block tridiagonal system."""
    rng = np.random.default_rng(seed)
    L = rng.uniform(-1.0, 1.0, (n, 2, 2))
    U = rng.uniform(-1.0, 1.0, (n, 2, 2))
    D = rng.uniform(-1.0, 1.0, (n, 2, 2)) + 6.0 * np.eye(2)
    L[0] = 0.0
    U[-1] = 0.0
    b = rng.uniform(-1.0, 1.0, (n, 2))
    return tuple(torch.tensor(a, dtype=torch.float64, device=device) for a in (L, D, U, b))


def block_residual(L, D, U, b, x):
    """max |A x - b| of the dense 2N x 2N system, evaluated block-wise."""
    mv = lambda M, v: (M * v.unsqueeze(-2)).sum(-1)
    r = mv(D, x) - b
    r[1:] += mv(L[1:], x[:-1])
    r[:-1] += mv(U[:-1], x[1:])
    return float(r.abs().max())


BOUNDARY_CASES = ("flow_normal", "stage_fixed", "normal_stage", "stage_flow", "fixed_flow", "flow_polynomial",
                  "polynomial_stage", "blended_stage")


def build_boundary_case(api, name: str, levels: int = 12, **solver_kw):
    """A 20 km prismatic rectangular reach (simple sections, no curvature)
    under one of BOUNDARY_CASES: the boundary kinds the flagship does not
    use.  ``api`` is the module that provides Boundary / Channel / Hydrograph
    / RatingCurve / PreissmannSolver, so the same case can be built from any
    package with that surface."""
    width, rough, q0, z_us, z_ds, length = 250.0, 0.027, 1000.0, 5.0, 0.0, 20000.0
    slope = (z_us - z_ds) / length
    lo, hi = 0.0, 50.0          # normal depth of the rectangle by bisection
    for _ in range(200):
        h = 0.5 * (lo + hi)
        q = width * h * (width * h / (width + 2.0 * h)) ** (2.0 / 3.0) / rough * math.sqrt(slope)
        lo, hi = (h, hi) if q < q0 else (lo, h)
    hn = 0.5 * (lo + hi)
    wave = lambda t: math.sin(2.0 * math.pi * t / (12 * 3600.0))
    # a demand imposed at the downstream end must stay small, or the depth
    # there has no solution within a level
    flow = {"us": api.Hydrograph(function=lambda t: q0 + 150.0 * wave(t)),
            "ds": api.Hydrograph(function=lambda t: q0 + 10.0 * wave(t))}
    us_kind, ds_kind = name.split("_")
    ends = {}
    for end, kind, bed, chainage in (("us", us_kind, z_us, 0.0), ("ds", ds_kind, z_ds, length)):
        kw = dict(chainage=chainage, bed_level=bed)
        if kind == "flow":
            ends[end] = api.Boundary(condition="flow_hydrograph", hydrograph=flow[end], **kw)
        elif kind == "stage":
            stage = api.Hydrograph(function=lambda t, bed=bed: bed + hn + 0.3 * wave(t))
            ends[end] = api.Boundary(condition="stage_hydrograph", hydrograph=stage, **kw)
        elif kind == "fixed":
            ends[end] = api.Boundary(condition="fixed_depth", initial_depth=hn, **kw)
        elif kind == "normal":
            ends[end] = api.Boundary(condition="normal_depth", **kw)
        elif end == "ds":  # a quadratic rating through (normal depth, q0)
            curve = api.RatingCurve()
            curve.set("polynomial", a=40.0, b=120.0, c=q0 - 40.0 * hn * hn - 120.0 * hn, stage_shift=-bed)
            ends[end] = api.Boundary(condition="rating_curve", rating_curve=curve, **kw)
        elif kind == "polynomial":
            # an upstream rating is gate-style: inflow FALLS as the stage rises
            # (an inlet rating with a positive slope is dynamically unstable);
            # 0.5 (h - hn)^2 - 30 (h - hn) + q0
            curve = api.RatingCurve()
            curve.set("polynomial", a=0.5, b=-30.0 - hn, c=q0 + 30.0 * hn + 0.5 * hn * hn, stage_shift=-bed)
            ends[end] = api.Boundary(condition="rating_curve", rating_curve=curve, **kw)
        else:  # "blended": two falling lines through (bed + hn, q0), blended over 0.5 m
            stage0 = bed + hn
            make = api.rcurve.make_blended_poly
            on_host = dict(device="cpu") if "device" in inspect.signature(make).parameters else {}
            params = make(low_quad=[0.0, -25.0, q0 + 25.0 * stage0], high_quad=[0.0, -20.0, q0 + 20.0 * stage0],
                          pivot_stage=stage0 - 0.3, buffer=0.5, **on_host)
            ends[end] = api.Boundary(condition="rating_curve", rating_curve=api.RatingCurve(params), **kw)
    channel = api.Channel(width=width, initial_flow=q0, roughness=rough, upstream_boundary=ends["us"],
                          downstream_boundary=ends["ds"], interpolation_method="steady-state")
    return api.PreissmannSolver(channel=channel, theta=0.8, time_step=3600.0, spatial_step=1000.0,
                                simulation_time=3600.0 * levels, **solver_kw)


def tiled_system(n: int, seed: int, device, coupling: float = 0.3):
    """Seeded random diagonally dominant system for the tiled solve (the
    ``_random_system`` of ``tests/test_tiled_pcr.py``, in float64)."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, 2, 2)) * coupling
    L[0] = 0.0
    D = rng.normal(size=(n, 2, 2)) + 4.0 * np.eye(2)
    U = rng.normal(size=(n, 2, 2)) * coupling
    U[-1] = 0.0
    b = rng.normal(size=(n, 2))
    return tuple(torch.tensor(a, dtype=torch.float64, device=device) for a in (L, D, U, b))


def build_long_reach(n_nodes: int, device, levels: int = 8, linear_solver: str = "pcr"):
    """Synthetic long prismatic reach: trapezoid b = 80 m, m = 10, n = 0.03,
    slope 2e-4, dx = 200 m, theta = 0.7, dt = 600 s, an inflow ramp
    1500 -> 3000 m^3/s over the first hour, normal depth downstream; float64,
    tolerance 1e-6.  Returns (geo, us_bc, ds_bc, h0, Q0, settings)."""
    from flowsim_tpu_torch import geometry as geom, trees
    from flowsim_tpu_torch.ops import boundary as bnd
    from flowsim_tpu_torch.ops import initial_conditions as ic
    from flowsim_tpu_torch.ops import preissmann as prs

    length = (n_nodes - 1) * 200.0
    slope = 2e-4
    sts = [geom.TrapezoidStation(z_bed=length * slope, b_main=80.0, m_main=10.0, n_main=0.03, bed_slope=slope),
           geom.TrapezoidStation(z_bed=0.0, b_main=80.0, m_main=10.0, n_main=0.03, bed_slope=slope)]
    # the two stations differ in bed level only: lower them at the two ends
    # and lay the prismatic section out over all nodes with tensor ops
    # (interpolate_stations walks the nodes one by one on the host, which is
    # for surveyed reaches, not for a million nodes)
    ends = geom.interpolate_stations(sts, [0.0, length], [0.0, length], device=device)
    geo = trees.tree_map(lambda v: v[:1].expand(n_nodes).contiguous(), ends)
    x = torch.linspace(0.0, length, n_nodes, dtype=torch.float64, device=device)
    geo = dataclasses.replace(geo, z_bed=(length - x) * slope)
    # the vectorised normal-depth bisection, not the per-node backwater march
    h0, Q0 = ic.initial_conditions(geo, "steady-state", 1500.0, 200.0)

    nt = levels + 1
    times = np.arange(nt) * 600.0
    series = 1500.0 + 1500.0 * np.minimum(times / 3600.0, 1.0)
    us = bnd.make_boundary("flow_hydrograph", bed_level=length * slope, target_series=series, device=device)
    ds = bnd.make_boundary("normal_depth", bed_level=0.0, bed_slope=slope, device=device)
    sset = prs.PreissmannSettings(theta=0.7, time_step=600.0, spatial_step=200.0, n_time_levels=nt,
                                  tolerance=1e-6, max_iter=30, linear_solver=linear_solver)
    return geo, us, ds, h0, Q0, sset


STORAGE_CASES = ("ds_const", "ds_curve_rating_losses", "ds_const_losses", "us_const", "us_curve", "both_ends")


def build_storage_case(name: str, device, levels: int = 12):
    """A 29 km rectangular reach (N = 30, width 120 m, n = 0.023, slope 6.1e-4,
    dx = 1 km, dt = 1 h, theta = 0.6) with lumped storage behind a
    ``fixed_depth`` boundary, one of STORAGE_CASES: constant area, a
    stage-area curve with a polynomial rating on the storage and entrance
    losses, losses alone, an upstream reservoir (constant area, area curve)
    over a quiescent pool, and a reservoir at each end.  Returns
    (geo, us_bc, ds_bc, h0, Q0, settings)."""
    from flowsim_tpu_torch import geometry as geom
    from flowsim_tpu_torch.ops import boundary as bnd
    from flowsim_tpu_torch.ops import initial_conditions as ic
    from flowsim_tpu_torch.ops import preissmann as prs
    from flowsim_tpu_torch.ops import rating_curve as rcurve
    from flowsim_tpu_torch.ops import storage as stg

    n, slope, dx, dt = 30, 0.00061, 1000.0, 3600.0
    nt = levels + 1
    length = (n - 1) * dx
    geo = geom.build_trapezoid_geometry(n, length, slope * length, 0.0, 120.0, 0.023, device=device)
    z = geo.z_bed.cpu().numpy()
    bed_us, bed_ds = float(z[0]), float(z[-1])
    h0, Q0 = ic.initial_conditions(geo, "steady-state", 100.0, dx)
    h_ds0 = float(h0[-1])
    mk = lambda *a, **kw: bnd.make_boundary(*a, device=device, **kw)
    inflow = 100.0 + 200.0 * np.sin(np.linspace(0.0, np.pi, nt))
    us_hyd = mk("flow_hydrograph", bed_level=bed_us, target_series=inflow)
    # a quiescent pool for the upstream reservoirs: level surface, no flow
    stage_pool = bed_us + 2.0
    pool_h0 = torch.tensor(stage_pool - z, dtype=torch.float64, device=device)
    pool_Q0 = torch.zeros_like(Q0)
    ds_stage_pool = mk("stage_hydrograph", bed_level=bed_ds,
                       target_series=stage_pool + 0.05 * np.sin(np.linspace(0.0, np.pi, nt)))
    tol = 1e-6
    if name == "ds_const":
        us, state = us_hyd, (h0, Q0)
        ds = mk("fixed_depth", bed_level=bed_ds, storage=stg.make_storage(
            surface_area=1.25e6, min_stage=bed_ds + h_ds0, solution_boundaries=(0.0, 100.0), device=device))
    elif name == "ds_curve_rating_losses":
        us, state = us_hyd, (h0, Q0)
        curve = np.stack([bed_ds + np.linspace(-2.0, 20.0, 12), 4.0e5 * (1.0 + 0.08 * np.arange(12))], axis=1)
        ds = mk("fixed_depth", bed_level=bed_ds, storage=stg.make_storage(
            area_curve=curve, min_stage=bed_ds - 1.0,
            rating=rcurve.make_polynomial(0.0, 30.0, -30.0 * (bed_ds - 1.0), device=device),
            capture_losses=True, reservoir_length=1500.0, K_q=0.2, device=device))
    elif name == "ds_const_losses":
        us, state = us_hyd, (h0, Q0)
        ds = mk("fixed_depth", bed_level=bed_ds, storage=stg.make_storage(
            surface_area=5.0e5, min_stage=bed_ds - 1.0, solution_boundaries=(bed_ds - 2.0, bed_ds + 30.0),
            capture_losses=True, reservoir_length=1500.0, K_q=0.2, device=device))
    elif name == "us_const":
        ds, state = ds_stage_pool, (pool_h0, pool_Q0)
        us = mk("fixed_depth", bed_level=bed_us, storage=stg.make_storage(
            surface_area=8.0e6, min_stage=bed_us - 1.0, solution_boundaries=(bed_us - 2.0, bed_us + 30.0),
            device=device))
    elif name == "us_curve":
        ds, state = ds_stage_pool, (pool_h0, pool_Q0)
        curve = np.stack([bed_us + np.linspace(-2.0, 30.0, 10), 8.0e6 * (1.0 + 0.05 * np.arange(10))], axis=1)
        us = mk("fixed_depth", bed_level=bed_us, storage=stg.make_storage(
            area_curve=curve, min_stage=bed_us - 1.0, device=device))
    elif name == "both_ends":
        state, tol = (h0, Q0), 1e-8
        us = mk("fixed_depth", bed_level=bed_us, storage=stg.make_storage(
            surface_area=3.0e6, min_stage=bed_us - 5.0, solution_boundaries=(0.0, 100.0), device=device))
        ds = mk("fixed_depth", bed_level=bed_ds, storage=stg.make_storage(
            surface_area=1.25e6, min_stage=bed_ds + h_ds0, solution_boundaries=(0.0, 100.0), device=device))
    else:
        raise ValueError(f"unknown storage case {name!r}; expected one of {STORAGE_CASES}")
    sset = prs.PreissmannSettings(theta=0.6, time_step=dt, spatial_step=dx, n_time_levels=nt,
                                  tolerance=tol, max_iter=100)
    return (geo, us, ds, *state, sset)


def stage_diff(a, b, what: str) -> float:
    """max |a - b| over two reservoir-stage series that must be NaN at the
    same places (no storage, level 0)."""
    if a is None or b is None:
        if a is not b:
            raise AssertionError(f"{what}: one run carries an upstream reservoir stage, the other none")
        return 0.0
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        raise AssertionError(f"{what}: reservoir stages are NaN at different places")
    return float(torch.nan_to_num(a - b).abs().max())


def compare_runs(kernel_out, plain_out, what: str) -> dict:
    """Kernel B against the plain engine: identical per-level iteration
    counts and gate series, fields within H_TOL / Q_TOL, reservoir stages
    within STAGE_TOL."""
    it_k = kernel_out.iterations.cpu().tolist()
    it_p = plain_out.iterations.cpu().tolist()
    if it_k != it_p:
        raise AssertionError(f"{what}: per-level iteration counts differ: {it_k} vs {it_p}")
    dh = float((kernel_out.depth - plain_out.depth).abs().max())
    dq = float((kernel_out.flow - plain_out.flow).abs().max())
    if not (dh <= H_TOL and dq <= Q_TOL):
        raise AssertionError(f"{what}: max|dh|={dh} (tol {H_TOL}), max|dQ|={dq} (tol {Q_TOL})")
    if not torch.equal(kernel_out.gate_open, plain_out.gate_open):
        raise AssertionError(f"{what}: gate series differ")
    ds_stage = max(stage_diff(kernel_out.reservoir_stage, plain_out.reservoir_stage, what),
                   stage_diff(kernel_out.reservoir_stage_us, plain_out.reservoir_stage_us, what))
    if not ds_stage <= STAGE_TOL:
        raise AssertionError(f"{what}: max|d reservoir stage|={ds_stage} (tol {STAGE_TOL})")
    if not bool(kernel_out.converged.all()) or not bool(torch.isfinite(kernel_out.depth).all()):
        raise AssertionError(f"{what}: kernel run not converged / not finite")
    return dict(levels=len(it_k), iterations=int(sum(it_k)), max_abs_dh=dh, max_abs_dQ=dq,
                max_abs_dstage=ds_stage)


def compare_members(batched_out, member_outs, what: str, exact: bool) -> dict:
    """A batched run against one run per member: identical per-level iteration
    counts and gate series; fields bit-identical (``exact``: the same kernel
    launched once per member) or within H_TOL / Q_TOL (the plain version)."""
    dh = dq = dstage = 0.0
    for m, ref in enumerate(member_outs):
        it_b, it_r = batched_out.iterations[m].cpu().tolist(), ref.iterations.cpu().tolist()
        if it_b != it_r:
            raise AssertionError(f"{what}, member {m}: iteration counts differ: {it_b} vs {it_r}")
        if not torch.equal(batched_out.gate_open[m], ref.gate_open):
            raise AssertionError(f"{what}, member {m}: gate series differ")
        if exact:
            for field in ("depth", "flow", "error"):
                if not torch.equal(getattr(batched_out, field)[m], getattr(ref, field)):
                    raise AssertionError(f"{what}, member {m}: {field} is not bit-identical")
        else:
            dh = max(dh, float((batched_out.depth[m] - ref.depth).abs().max()))
            dq = max(dq, float((batched_out.flow[m] - ref.flow).abs().max()))
        dstage = max(dstage, stage_diff(batched_out.reservoir_stage[m], ref.reservoir_stage, what),
                     stage_diff(batched_out.reservoir_stage_us[m], ref.reservoir_stage_us, what))
    if not (dh <= H_TOL and dq <= Q_TOL and dstage <= (0.0 if exact else STAGE_TOL)):
        raise AssertionError(f"{what}: max|dh|={dh} (tol {H_TOL}), max|dQ|={dq} (tol {Q_TOL}), "
                             f"max|d reservoir stage|={dstage} (tol {STAGE_TOL})")
    return dict(members=len(member_outs), levels=int(batched_out.iterations.shape[1]),
                iterations=int(batched_out.iterations.sum()), max_abs_dh=dh, max_abs_dQ=dq,
                max_abs_dstage=dstage, bit_identical=exact)


def prs_out_member(out, m):
    """Member(s) ``m`` of a batched SimOutput."""
    return type(out)(*(None if f is None else f[m] for f in out))


def expand_members(tree, n_members: int):
    """A shared parameter tree as a batched one: a leading member axis (a
    view, no copy) on every tensor leaf."""
    from flowsim_tpu_torch import trees
    return trees.tree_map(lambda v: v.expand(n_members, *v.shape), tree)


def scaled_inflow(us_params, scales):
    """Per-member upstream boundary: the shared hydrograph times a scale."""
    scales = torch.as_tensor(scales, dtype=torch.float64, device=us_params.target_series.device)
    batched = expand_members(us_params, scales.shape[0])
    return dataclasses.replace(batched, target_series=us_params.target_series[None, :] * scales[:, None])


def check_tiled_kernel(dev) -> dict:
    """tiled_spike_solve against tiled_spike_plain on the card: random
    diagonally dominant systems from one partial tile to a million nodes, and
    the Newton system of the long reach."""
    from flowsim_tpu_torch.ops import preissmann as prs
    from flowsim_tpu_torch.ops import tridiag
    from flowsim_tpu_torch.ops.cuda import tiled_pcr

    checks = []
    for n in (200, 1000, 4096, 100_000, 1_000_003):
        L, D, U, b = tiled_system(n, seed=n, device=dev)
        x = tiled_pcr.tiled_spike_solve(L, D, U, b)
        torch.cuda.synchronize()
        x_plain = tiled_pcr.tiled_spike_plain(L, D, U, b)
        scale = float(x_plain.abs().max())
        rel = float((x - x_plain).abs().max()) / scale
        rel_pcr = float((x - tridiag.block_pcr(L, D, U, b)).abs().max()) / scale
        res = block_residual(L, D, U, b, x)
        if not (rel <= TILED_REL_TOL and rel_pcr <= 1e-9):
            raise AssertionError(f"tiled_spike_solve N={n}: rel err {rel} vs its plain version, "
                                 f"{rel_pcr} vs block_pcr")
        checks.append(dict(n=n, tile=tiled_pcr.DEFAULT_TILE, rel_err=rel, rel_err_vs_block_pcr=rel_pcr,
                           residual=res, solution_scale=scale))
    # other tiles: two blocks resident per SM, and the largest that fits
    for tile in (256, tiled_pcr.MAX_TILE):
        L, D, U, b = tiled_system(5000, seed=tile, device=dev)
        x = tiled_pcr.tiled_spike_solve(L, D, U, b, tile=tile)
        x_plain = tiled_pcr.tiled_spike_plain(L, D, U, b, tile=tile)
        rel = float((x - x_plain).abs().max() / x_plain.abs().max())
        if not rel <= TILED_REL_TOL:
            raise AssertionError(f"tiled_spike_solve tile={tile}: rel err {rel}")
        checks.append(dict(n=5000, tile=tile, rel_err=rel, residual=block_residual(L, D, U, b, x)))
    # realistic conditioning: the first Newton system of a 2048-node long reach
    geo, us, ds, h0, Q0, sset = build_long_reach(2048, dev, levels=2)
    prev = prs.prev_level_state(geo, h0, Q0)
    L, D, U, b, *_ = prs.assemble(geo, us, ds, sset, prev, h0, Q0, 1)
    x = tiled_pcr.tiled_spike_solve(L, D, U, b, tile=256)
    x_plain = tiled_pcr.tiled_spike_plain(L, D, U, b, tile=256)
    x_pcr = tridiag.block_pcr(L, D, U, b)
    scale = float(x_plain.abs().max()) + 1e-300
    rel = float((x - x_plain).abs().max()) / scale
    rel_pcr = float((x - x_pcr).abs().max()) / scale
    if not (rel <= TILED_REL_TOL and rel_pcr <= 1e-8):
        raise AssertionError(f"tiled_spike_solve on the Newton system: rel err {rel}, {rel_pcr} vs block_pcr")
    checks.append(dict(n=2048, tile=256, system="long-reach Newton step", rel_err=rel,
                       rel_err_vs_block_pcr=rel_pcr, residual=block_residual(L, D, U, b, x)))
    try:
        tiled_pcr.tiled_spike_solve(*tiled_system(2000, seed=1, device=dev), tile=tiled_pcr.MAX_TILE + 1)
    except ValueError as e:
        oversize = str(e)
    else:
        raise AssertionError("tiled_spike_solve accepted a tile beyond shared memory")
    return dict(checks=checks, oversize_tile_raises=oversize)


def check_storage_kernels(dev) -> dict:
    """Kernel 1 with each storage variant and kernel 3 with storage ensembles
    against their plain versions: identical per-level counts, fields and
    reservoir stages within the tolerances."""
    from flowsim_tpu_torch import trees
    from flowsim_tpu_torch.ops import rating_curve as rcurve
    from flowsim_tpu_torch.ops.cuda.fused_batched import fused_simulate_batched, fused_simulate_batched_plain
    from flowsim_tpu_torch.ops.cuda.fused_newton import FusedUnsupported, fused_simulate, fused_simulate_plain
    from flowsim_tpu_torch.parallel import ensemble

    out = {}
    for name in STORAGE_CASES:
        args = build_storage_case(name, dev)
        out_k = fused_simulate(*args)
        out_p = fused_simulate_plain(*args)
        stage = out_k.reservoir_stage[1:]
        if not bool(torch.isfinite(stage).all()):
            raise AssertionError(f"storage case {name}: the reservoir stage is not finite")
        out[name] = dict(compare_runs(out_k, out_p, "storage " + name),
                         stage_first_last=[float(stage[0]), float(stage[-1])])
    # an ensemble of four reservoirs: per-member surface area and inflow scale
    geo, us, ds, h0, Q0, sset = build_storage_case("ds_const", dev, levels=8)
    B = 4
    geob = ensemble.roughness_ensemble(geo, [0.021, 0.023, 0.026, 0.030])
    us_b = scaled_inflow(us, [0.9, 1.0, 1.1, 1.2])
    ds_members = [dataclasses.replace(ds, storage=dataclasses.replace(
        ds.storage, surface_area=torch.tensor(a, dtype=torch.float64, device=dev)))
        for a in (1.0e6, 1.25e6, 1.5e6, 2.0e6)]
    ds_b, _ = ensemble.batch_boundaries(ds_members)
    args = (geob, us_b, ds_b, h0, Q0, sset)
    kw = dict(us_batched=True, ds_batched=True)
    out_k = fused_simulate_batched(*args, **kw)
    out_p = fused_simulate_batched_plain(*args, **kw)
    out["ensemble_ds_const_4x8"] = compare_members(
        out_k, [prs_out_member(out_p, m) for m in range(B)], "storage ensemble", exact=False)
    singles = [fused_simulate(trees.member(geob, m), trees.member(us_b, m), ds_members[m], h0, Q0, sset)
               for m in range(B)]
    compare_members(out_k, singles, "storage ensemble vs single launches", exact=True)
    final = out_k.reservoir_stage[:, -1].tolist()
    if len(set(final)) != B:
        raise AssertionError(f"storage ensemble: the members' final stages do not differ: {final}")
    out["ensemble_ds_const_4x8"]["final_stage_per_member"] = final
    # per-member stage-area tables, storage rating and losses; shared reservoirs at both ends
    geo, us, ds, h0, Q0, sset = build_storage_case("ds_curve_rating_losses", dev, levels=6)
    ds_members = []
    for f_area, f_q in ((0.8, 25.0), (1.0, 30.0), (1.3, 35.0)):
        sp = ds.storage
        ds_members.append(dataclasses.replace(ds, storage=dataclasses.replace(
            sp, area_table=sp.area_table * f_area, vol_table=sp.vol_table * f_area,
            rating=dataclasses.replace(sp.rating, coeffs=sp.rating.coeffs * (f_q / 30.0)))))
    ds_b, _ = ensemble.batch_boundaries(ds_members)
    geob = expand_members(geo, 3)
    out_k = fused_simulate_batched(geob, us, ds_b, h0, Q0, sset, ds_batched=True)
    out_p = fused_simulate_batched_plain(geob, us, ds_b, h0, Q0, sset, ds_batched=True)
    out["ensemble_ds_curve_3x6"] = compare_members(
        out_k, [prs_out_member(out_p, m) for m in range(3)], "curve storage ensemble", exact=False)
    args = build_storage_case("both_ends", dev, levels=6)
    geob = ensemble.roughness_ensemble(args[0], [0.023, 0.025, 0.028])
    out_k = fused_simulate_batched(geob, *args[1:])
    out_p = fused_simulate_batched_plain(geob, *args[1:])
    out["ensemble_both_ends_3x6"] = compare_members(
        out_k, [prs_out_member(out_p, m) for m in range(3)], "both-ends storage ensemble", exact=False)
    # a gated rating on the storage itself is outside the kernel, as on the TPU
    geo, us, ds, h0, Q0, sset = build_storage_case("ds_curve_rating_losses", dev, levels=2)
    gated = rcurve.make_gated_blend([0.0, 20.0, 0.0], [0.0, 30.0, 0.0], pivot_stage=2.0, device=dev)
    bad = dataclasses.replace(ds, storage=dataclasses.replace(ds.storage, rating=gated))
    try:
        fused_simulate(geo, us, bad, h0, Q0, sset)
    except FusedUnsupported as e:
        out["refuses_gated_storage_rating"] = str(e)
    else:
        raise AssertionError("fused_simulate accepted a gated_blend rating on the storage")
    return out


def drive_long_reach(dev, launches: dict) -> tuple[list, dict]:
    """The long-reach main path: ``simulate(linear_solver="cuda_tiled")`` at
    each of LONG_REACH_NODES against the same run with ``"pcr"``, with the
    stage times of one solve.  Returns the per-size records and the figures of
    the largest size for the kernel table."""
    from flowsim_tpu_torch.ops import preissmann as prs
    from flowsim_tpu_torch.ops.cuda import tiled_pcr

    records, table = [], {}
    for n in LONG_REACH_NODES:
        geo, us, ds, h0, Q0, sset = build_long_reach(n, dev, levels=8, linear_solver="cuda_tiled")
        sset_pcr = dataclasses.replace(sset, linear_solver="pcr")
        tiled_pcr.launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_t = prs.simulate(geo, us, ds, h0, Q0, sset)
        torch.cuda.synchronize()
        tiled_ms = (time.perf_counter() - t0) * 1e3
        count = tiled_pcr.launch_count
        t0 = time.perf_counter()
        out_p = prs.simulate(geo, us, ds, h0, Q0, sset_pcr)
        torch.cuda.synchronize()
        pcr_ms = (time.perf_counter() - t0) * 1e3
        cmp = compare_runs(out_t, out_p, f"long reach N={n}, cuda_tiled vs pcr")
        if count != cmp["iterations"] or count == 0:
            raise AssertionError(f"long reach N={n}: {count} launches for {cmp['iterations']} iterations")
        if out_t.depth.shape != (sset.n_time_levels, n):
            raise AssertionError(f"long reach N={n}: depth has shape {tuple(out_t.depth.shape)}")

        # one solve, stage by stage, on the first Newton system of level 1
        prev = prs.prev_level_state(geo, h0, Q0)
        L, D, U, b, *_ = prs.assemble(geo, us, ds, sset, prev, h0, Q0, 1)
        T, n_tiles = tiled_pcr._tiling(n, tiled_pcr.DEFAULT_TILE)
        G, V, W = tiled_pcr.stage_a(L, D, U, b, T)
        y = tiled_pcr.stage_b(G, V, W, T)
        x = tiled_pcr.stage_c(G, V, W, y, T)
        x_plain = tiled_pcr.tiled_spike_plain(L, D, U, b)
        err = float((x - x_plain).abs().max())
        if not err <= TILED_REL_TOL * float(x_plain.abs().max()):
            raise AssertionError(f"long reach N={n}: the staged solve differs from the plain one by {err}")
        a_ms = time_cuda(lambda: tiled_pcr.stage_a(L, D, U, b, T), reps=20)
        b_ms = statistics.median(wall_ms(lambda: tiled_pcr.stage_b(G, V, W, T)) for _ in range(3))
        c_ms = time_cuda(lambda: tiled_pcr.stage_c(G, V, W, y, T), reps=10)
        solve_ms = statistics.median(wall_ms(lambda: tiled_pcr.tiled_spike_solve(L, D, U, b)) for _ in range(3))
        plain_ms = statistics.median(wall_ms(lambda: tiled_pcr.tiled_spike_plain(L, D, U, b)) for _ in range(2))
        pcr_solve_ms = time_cuda(lambda: prs.tridiag.block_pcr(L, D, U, b), reps=3, warmup=1)
        tiled_pcr.launch_count = count   # the timing launches above are not the main path's
        # the kernel's own traffic: L, D, U, b read once (14 doubles a node),
        # G, V, W written once (10); operations: ceil(log2 T) sweeps + back-solve
        nbytes = 8 * (14 + 10) * n
        flops = n_tiles * T * (sweeps(T) * FLOPS_PCR_SWEEP_5 + FLOPS_PCR_BACKSOLVE_5)
        tb, tf = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F64_FLOPS * 1e3
        rec = dict(n_nodes=n, tile=T, tiles=n_tiles, launches=count,
                   iterations_per_level=out_t.iterations.tolist(), wall_ms=tiled_ms, wall_ms_pcr=pcr_ms,
                   newton_node_updates_per_s=n * cmp["iterations"] / (tiled_ms * 1e-3),
                   newton_node_updates_per_s_pcr=n * cmp["iterations"] / (pcr_ms * 1e-3),
                   solve_ms=solve_ms, stage_a_ms=a_ms, stage_b_ms=b_ms, stage_c_ms=c_ms,
                   plain_solve_ms=plain_ms, block_pcr_solve_ms=pcr_solve_ms,
                   bound_ms=max(tb, tf), bound_bytes_ms=tb, bound_operations_ms=tf, **cmp)
        records.append(rec)
        table = dict(rec, max_abs_err=err, bound_by="bytes" if tb >= tf else "operations")
        del out_t, out_p, L, D, U, b, G, V, W, x, x_plain
        torch.cuda.empty_cache()
    launches["tiled_spike_solve"] = table["launches"]
    return records, table


def drive_reservoir(dev) -> dict:
    """The reservoir main path: the shipped example (a flood wave routed into
    a lumped storage) through ``models.example.build`` and ``solver.run``,
    ``engine="fused"`` against ``engine="plain"``, all 24 levels."""
    from flowsim_tpu_torch.models import example
    from flowsim_tpu_torch.ops.cuda import fused_newton

    solver, _ = example.build("preissmann", device=dev)
    fused_newton.launch_count = 0
    out_k = solver.run(engine="fused", max_iter=100, verbose=0)
    torch.cuda.synchronize()
    count = fused_newton.launch_count
    if count != 1:
        raise AssertionError(f"the reservoir example took {count} launches of fused_simulate, expected 1")
    sset = solver.settings(1e-4, 100)
    args = (solver.channel.geometry, solver.us_params, solver.ds_params, solver.h0, solver.Q0, sset)
    kernel_ms = statistics.median(wall_ms(lambda: fused_newton.fused_simulate(*args)) for _ in range(3))
    fused_newton.launch_count = count
    t0 = time.perf_counter()
    out_p = solver.run(engine="plain", max_iter=100, verbose=0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if (solver.number_of_nodes, solver.number_of_time_levels) != (21, 25):
        raise AssertionError("the example is not at its shipped size (21 nodes, 25 levels)")
    cmp = compare_runs(out_k, out_p, "reservoir example fused vs plain")
    stage = out_k.reservoir_stage
    if not bool(torch.isnan(stage[0])) or not bool(torch.isfinite(stage[1:]).all()):
        raise AssertionError("reservoir example: the stage series is not finite after level 0")
    return dict(n_nodes=21, n_time_levels=25, launches=count, kernel_ms=kernel_ms, plain_ms=plain_ms,
                iterations_per_level=out_k.iterations.tolist(), reservoir_stage=stage[1:].tolist(),
                peak_stage=float(stage[1:].max()), peak_inflow=float(out_k.flow[:, 0].max()),
                peak_flow_into_reservoir=float(out_k.flow[:, -1].max()), **cmp)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    from flowsim_tpu_torch.models.gerd_roseires import model
    from flowsim_tpu_torch.ops import tridiag
    from flowsim_tpu_torch import trees
    from flowsim_tpu_torch.models import calibrate
    from flowsim_tpu_torch.ops.cuda import build, fused_batched, fused_newton, pcr_kernel
    from flowsim_tpu_torch.ops.cuda.fused_batched import (fused_simulate_batched,
                                                          fused_simulate_batched_plain)
    from flowsim_tpu_torch.ops.cuda.fused_newton import (FusedUnsupported, fused_simulate,
                                                         fused_simulate_plain)
    from flowsim_tpu_torch.parallel import ensemble

    dev = torch.device("cuda")

    # -- phase 1: device ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # -- phase 2: build (one nvcc per source, started together) -------------
    t0 = time.perf_counter()
    info = build.build_all()
    emit("build", seconds=time.perf_counter() - t0, flags=" ".join(build.NVCC_FLAGS),
         sources={n: dict(seconds=i["seconds"], ptxas=i["ptxas"]) for n, i in info.items()})

    # -- phase 3: each kernel against its plain version ----------------------
    pcr_checks = []
    for n in (2, 121, 128, 1000, 1001, 8192):
        L, D, U, b = random_system(n, seed=n, device=dev)
        x = pcr_kernel.pcr_solve(L, D, U, b)
        torch.cuda.synchronize()
        x_plain = pcr_kernel.pcr_solve_plain(L, D, U, b)
        rel = float((x - x_plain).abs().max() / x_plain.abs().max())
        res = block_residual(L, D, U, b, x)
        if not (rel <= 1e-10 and res <= 1e-9):
            raise AssertionError(f"pcr_solve N={n}: rel err {rel}, residual {res}")
        pcr_checks.append(dict(n=n, rel_err=rel, residual=res,
                               max_abs_err=float((x - x_plain).abs().max())))
    # a batch of systems maps to blockIdx.x
    Lb, Db, Ub, bb = (torch.stack(t) for t in zip(*(random_system(121, seed=s, device=dev)
                                                    for s in (11, 12, 13))))
    xb = pcr_kernel.pcr_solve(Lb, Db, Ub, bb)
    if float((xb - pcr_kernel.pcr_solve_plain(Lb, Db, Ub, bb)).abs().max()) > 1e-10:
        raise AssertionError("pcr_solve batched disagrees with the plain version")
    try:
        pcr_kernel.pcr_solve(*random_system(8193, seed=1, device=dev))
    except ValueError as e:
        oversize = str(e)
    else:
        raise AssertionError("pcr_solve accepted N = 8193")

    def solver_args(solver, **settings_kw):
        sset = dataclasses.replace(solver.settings(tolerance=1e-6, max_iter=100), **settings_kw)
        return (solver.channel.geometry, solver.us_params, solver.ds_params, solver.h0, solver.Q0, sset)

    fused_checks = {}
    # the smooth flagship over 25 levels (its longer comparison is the
    # flagship phase below) and the gated one over 49, where the gate switches
    for name, levels, kw in (("flagship_25_levels", 25, {}),
                             ("gated_blend_49_levels", 49, dict(smooth=False))):
        solver, channel = model.build(device=dev, sim_duration=3600 * (levels - 1), **kw)
        args = solver_args(solver)
        out_k = fused_simulate(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = fused_simulate_plain(*args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        fused_checks[name] = dict(compare_runs(out_k, out_p, name), plain_seconds=plain_s,
                                  gate_switches=int((out_k.gate_open[1:] != out_k.gate_open[:-1]).sum()))
    # the boundary kinds and the simple (non-compound, straight) sections
    # that the flagship does not reach
    from flowsim_tpu_torch import api
    for name in BOUNDARY_CASES:
        s_bc = build_boundary_case(api, name, device=dev)
        args = (s_bc.channel.geometry, s_bc.us_params, s_bc.ds_params, s_bc.h0, s_bc.Q0,
                s_bc.settings(tolerance=1e-8, max_iter=100))
        fused_checks["boundary_" + name] = compare_runs(
            fused_simulate(*args), fused_simulate_plain(*args), name)
    # the options the flagship does not use, on the 13-level flagship:
    # lateral inflow per node and per level, and store="boundaries"
    solver, channel = model.build(device=dev, sim_duration=3600 * 12)
    n13, nt13 = solver.number_of_nodes, solver.number_of_time_levels
    rng = np.random.default_rng(7)
    q_node = torch.tensor(rng.uniform(0.0, 2e-3, n13), dtype=torch.float64, device=dev)
    q_level = torch.tensor(rng.uniform(0.0, 2e-3, (nt13, n13)), dtype=torch.float64, device=dev)
    base13 = fused_simulate(*solver_args(solver))
    for name, q in (("lateral_inflow_per_node", q_node), ("lateral_inflow_per_level", q_level)):
        out_k = fused_simulate(*solver_args(solver), lateral_inflow=q)
        fused_checks[name] = compare_runs(
            out_k, fused_simulate_plain(*solver_args(solver), lateral_inflow=q), name)
        moved = float((out_k.depth - base13.depth).abs().max())
        if moved < 1e-4:
            raise AssertionError(f"{name}: the inflow moved the depths by only {moved} m")
        fused_checks[name]["moved_depth_by"] = moved
    out_b = fused_simulate(*solver_args(solver, store="boundaries"), lateral_inflow=q_level)
    out_bp = fused_simulate_plain(*solver_args(solver, store="boundaries"), lateral_inflow=q_level)
    if out_b.depth.shape != (nt13, 2) or not torch.equal(out_b.depth, out_k.depth[:, [0, -1]]) \
            or not torch.equal(out_b.flow, out_k.flow[:, [0, -1]]):
        raise AssertionError("store='boundaries' is not columns 0 and N-1 of the full run")
    fused_checks["store_boundaries"] = compare_runs(out_b, out_bp, "store=boundaries")
    # what the kernel still refuses reaches the caller (nothing falls back)
    refused = {}
    gated_ds = model.build(device=dev, sim_duration=3600 * 12, smooth=False)[0].ds_params
    for name, args in (
            ("diagnos", solver_args(solver, diagnos=True)),
            ("newton_fixed", solver_args(solver, newton="fixed")),
            ("upstream_gated_rating", (channel.geometry, gated_ds, *solver_args(solver)[2:]))):
        try:
            fused_simulate(*args)
        except FusedUnsupported as e:
            refused[name] = str(e)
        else:
            raise AssertionError(f"fused_simulate accepted {name}")

    # -- fused_simulate_batched: (i) against its plain version ---------------
    batched_checks = {}
    scales4 = [0.85, 1.0, 1.1, 1.2]
    plain_batched_ms = kernel_batched_cmp_ms = None
    for name, kw, pivots in (("smooth_4x25", {}, (-0.1, 0.0, 0.05, 0.1)),
                             ("gated_blend_4x25", dict(smooth=False), (0.0, -0.6, 0.2, -1.0))):
        solver, channel = model.build(device=dev, sim_duration=3600 * 24, **kw)
        geob = ensemble.roughness_ensemble(channel.geometry, [0.026, 0.030, 0.036, 0.044])
        us_b = scaled_inflow(solver.us_params, scales4)
        ds_members = [dataclasses.replace(solver.ds_params, rating=dataclasses.replace(
            solver.ds_params.rating, pivot_stage=solver.ds_params.rating.pivot_stage + dp))
            for dp in pivots]
        ds_b, _ = ensemble.batch_boundaries(ds_members)
        args = (geob, us_b, ds_b, solver.h0, solver.Q0, solver.settings(tolerance=1e-6, max_iter=100))
        kw_b = dict(us_batched=True, ds_batched=True)
        out_k = fused_simulate_batched(*args, **kw_b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = fused_simulate_batched_plain(*args, **kw_b)
        torch.cuda.synchronize()
        plain_ms_here = (time.perf_counter() - t0) * 1e3
        members = [prs_out_member(out_p, m) for m in range(4)]
        batched_checks[name] = dict(
            compare_members(out_k, members, name, exact=False), plain_ms=plain_ms_here,
            gate_switches=[int((g[1:] != g[:-1]).sum()) for g in out_k.gate_open],
            iterations_per_member=out_k.iterations.sum(dim=1).tolist())
        if not bool(out_k.converged.all()):
            raise AssertionError(f"{name}: a member did not converge")
        if plain_batched_ms is None:
            plain_batched_ms = plain_ms_here
            kernel_batched_cmp_ms = statistics.median(
                wall_ms(lambda: fused_simulate_batched(*args, **kw_b)) for _ in range(3))
            batched_cmp = batched_checks[name]
    # per-member lateral inflow [B, nt, N], 2 members x 13 levels
    solver, channel = model.build(device=dev, sim_duration=3600 * 12)
    geob = ensemble.roughness_ensemble(channel.geometry, [0.028, 0.040])
    q_members = torch.tensor(rng.uniform(0.0, 2e-3, (2, nt13, n13)), dtype=torch.float64, device=dev)
    args = (geob, solver.us_params, solver.ds_params, solver.h0, solver.Q0,
            solver.settings(tolerance=1e-6, max_iter=100))
    out_k = fused_simulate_batched(*args, lateral_inflow=q_members)
    out_p = fused_simulate_batched_plain(*args, lateral_inflow=q_members)
    batched_checks["lateral_inflow_2x13"] = compare_members(
        out_k, [prs_out_member(out_p, m) for m in range(2)], "batched lateral inflow", exact=False)

    # (ii) against one launch of fused_simulate per member: 8 members, all 385
    # levels, store="full" -- the same code and arithmetic, so bit-identical
    solver, channel = model.build(device=dev)
    sset = solver.settings(tolerance=1e-6, max_iter=100)
    n8 = np.linspace(0.025, 0.045, 8)
    s8 = np.linspace(0.8, 1.2, 8)
    geob = ensemble.roughness_ensemble(channel.geometry, n8)
    us_b = scaled_inflow(solver.us_params, s8)
    out_k = fused_simulate_batched(geob, us_b, solver.ds_params, solver.h0, solver.Q0, sset,
                                   us_batched=True)
    singles = [fused_simulate(trees.member(geob, m), trees.member(us_b, m), solver.ds_params,
                              solver.h0, solver.Q0, sset) for m in range(8)]
    batched_checks["bit_identity_8x385"] = compare_members(out_k, singles, "batched vs single launches",
                                                          exact=True)
    if not bool(out_k.converged.all()):
        raise AssertionError("bit_identity_8x385: a member did not converge")
    # (iii) one member made to diverge (a roughness of 1e-6) among 7 sound ones
    bad = 3
    n_bad = n8.copy()
    n_bad[bad] = 1e-6
    out_d = fused_simulate_batched(ensemble.roughness_ensemble(channel.geometry, n_bad), us_b,
                                   solver.ds_params, solver.h0, solver.Q0, sset, us_batched=True)
    sound = [m for m in range(8) if m != bad]
    compare_members(prs_out_member(out_d, sound), [singles[m] for m in sound],
                    "sound members beside a diverged one", exact=True)
    if bool(out_d.converged[bad].all()) or not bool(out_d.converged[sound].all()):
        raise AssertionError("diverged member: the converged flags are wrong")
    batched_checks["diverged_member"] = dict(
        bad_member=bad, bad_member_levels_converged=int(out_d.converged[bad].sum()),
        sound_members_bit_identical=True)
    emit("kernels", pcr_solve=pcr_checks, pcr_solve_oversize_raises=oversize,
         fused_simulate=fused_checks, fused_simulate_refuses=refused,
         fused_simulate_batched=batched_checks, tiled_spike_solve=check_tiled_kernel(dev),
         storage=check_storage_kernels(dev))

    # -- phases 4 + 5: the main path, through the user entry points ----------
    # counts to 0, drive, read the counts; comparisons and timings come after
    solver, channel = model.build(device=dev)                       # N=121, nt=385, theta=0.6
    pcr_solver, pcr_channel = model.build(device=dev, sim_duration=3600 * 24,
                                          linear_solver="cuda_pcr")
    fused_newton.launch_count = 0
    pcr_kernel.launch_count = 0
    out = solver.run(engine="fused", tolerance=1e-6, verbose=0)
    out_pcr = pcr_solver.run(engine="plain", tolerance=1e-6, verbose=0)
    torch.cuda.synchronize()
    launches = dict(fused_simulate=fused_newton.launch_count, pcr_solve=pcr_kernel.launch_count)

    n, nt = solver.number_of_nodes, solver.number_of_time_levels
    total_it = int(out.iterations.sum())
    if (n, nt, solver.theta) != (121, 385, 0.6):
        raise AssertionError(f"flagship is not at full width: N={n}, nt={nt}, theta={solver.theta}")
    if out.depth.shape != (nt, n) or not bool(torch.isfinite(out.depth).all()) \
            or not bool(torch.isfinite(out.flow).all()):
        raise AssertionError("flagship output has the wrong shape or is not finite")
    if not bool(out.converged.all()):
        raise AssertionError("flagship: not every level converged")
    if total_it != FLAGSHIP_ITERATIONS:
        raise AssertionError(f"flagship: {total_it} Newton iterations, expected {FLAGSHIP_ITERATIONS}")
    if launches["fused_simulate"] != 1:
        raise AssertionError(f"fused_simulate launched {launches['fused_simulate']} times, expected 1")
    pcr_it = int(out_pcr.iterations.sum())
    if launches["pcr_solve"] != pcr_it or pcr_it == 0:
        raise AssertionError(f"pcr_solve launched {launches['pcr_solve']} times for {pcr_it} iterations")

    args = (channel.geometry, solver.us_params, solver.ds_params, solver.h0, solver.Q0,
            solver.settings(tolerance=1e-6, max_iter=100))
    fused_ms_runs = [wall_ms(lambda: fused_simulate(*args)) for _ in range(6)][1:]
    fused_ms = statistics.median(fused_ms_runs)

    # against the plain engine over the first levels; the bit-identity of the
    # batched kernel with single launches covers all 385 levels above
    cmp_levels = PLAIN_COMPARED_LEVELS
    s_cut, c_cut = model.build(device=dev, sim_duration=3600 * (cmp_levels - 1))
    cmp_args = (c_cut.geometry, s_cut.us_params, s_cut.ds_params, s_cut.h0, s_cut.Q0,
                s_cut.settings(tolerance=1e-6, max_iter=100))
    out_cmp = fused_simulate(*cmp_args)
    fused_cmp_ms = statistics.median(wall_ms(lambda: fused_simulate(*cmp_args)) for _ in range(3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_plain = fused_simulate_plain(*cmp_args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    cmp = compare_runs(out_cmp, out_plain, "flagship fused vs plain")
    emit("flagship", n_nodes=n, n_time_levels=nt, theta=solver.theta, total_iterations=total_it,
         max_iterations_in_a_level=int(out.iterations.max()), all_converged=True,
         launches=launches["fused_simulate"], launch_ms_runs=fused_ms_runs, launch_ms_median=fused_ms,
         us_per_newton_iteration=fused_ms * 1e3 / total_it,
         newton_node_updates_per_s=n * total_it / (fused_ms * 1e-3),
         plain_compared_levels=cmp_levels, plain_ms=plain_ms, **cmp)

    # phase 5: the plain engine with the CUDA PCR solve against the "pcr" run
    ref_solver, _ = model.build(device=dev, sim_duration=3600 * 24, linear_solver="pcr")
    out_ref = ref_solver.run(engine="plain", tolerance=1e-6, verbose=0)
    if out_pcr.iterations.tolist() != out_ref.iterations.tolist():
        raise AssertionError("cuda_pcr and pcr runs differ in iteration counts")
    dpcr = max(float((out_pcr.depth - out_ref.depth).abs().max()),
               float(((out_pcr.flow - out_ref.flow) / out_ref.flow).abs().max()))
    if dpcr > 1e-10:
        raise AssertionError(f"cuda_pcr vs pcr fields differ by {dpcr}")
    emit("pcr_path", levels=25, iterations=pcr_it, launches=launches["pcr_solve"], max_diff=dpcr)

    # kernel A timed at the main path's shape: one N=121 system of a Newton step
    from flowsim_tpu_torch.ops import preissmann as prs
    prev = prs.prev_level_state(channel.geometry, solver.h0, solver.Q0)
    L, D, U, b, *_ = prs.assemble(channel.geometry, solver.us_params, solver.ds_params, args[5],
                                 prev, solver.h0, solver.Q0, 1)
    x = pcr_kernel.pcr_solve(L, D, U, b)
    x_plain = pcr_kernel.pcr_solve_plain(L, D, U, b)
    dense = tridiag.blocks_to_dense(L, D, U)
    x_lib = torch.linalg.solve(dense, b.reshape(-1)).reshape(-1, 2)
    pcr_err = float((x - x_plain).abs().max())
    if pcr_err > 1e-10 * float(x_plain.abs().max()) or \
            float((x - x_lib).abs().max()) > 1e-8 * float(x_lib.abs().max()):
        raise AssertionError("pcr_solve disagrees at the main path's shape")
    pcr_ms = time_cuda(lambda: pcr_kernel.pcr_solve(L, D, U, b), reps=200)
    pcr_plain_ms = time_cuda(lambda: pcr_kernel.pcr_solve_plain(L, D, U, b), reps=10)
    pcr_lib_ms = time_cuda(lambda: torch.linalg.solve(dense, b.reshape(-1)), reps=20)

    # -- phase 6: the same path at longer reaches ---------------------------
    # the kernel is compiled once per block size (128, 256, 512, 1024 threads,
    # each with its own register budget): 121 nodes ran above; these two reach
    # the 256- and 512-thread builds, the long reach below the 1024-thread one
    mid_checks = {}
    for step in (500.0, 250.0):
        s_mid, c_mid = model.build(device=dev, sim_duration=3600 * 12, spatial_step=step)
        ma = (c_mid.geometry, s_mid.us_params, s_mid.ds_params, s_mid.h0, s_mid.Q0,
              s_mid.settings(tolerance=1e-6, max_iter=100))
        mid_checks[f"n_{s_mid.number_of_nodes}"] = compare_runs(
            fused_simulate(*ma), fused_simulate_plain(*ma), f"reach at dx={step}")

    long_kw = dict(device=dev, sim_duration=3600 * 48, spatial_step=125.0)
    s_long, c_long = model.build(**long_kw)
    la = (c_long.geometry, s_long.us_params, s_long.ds_params, s_long.h0, s_long.Q0,
          s_long.settings(tolerance=1e-6, max_iter=100))
    note = None
    try:
        out_lk = fused_simulate(*la)
    except FusedUnsupported as e:
        # no fallback: report, then take the largest reach the kernel holds
        note = str(e)
        emit("long_reach_unsupported", n_nodes=s_long.number_of_nodes, error=note)
        length = c_long.length
        s_long, c_long = model.build(**dict(long_kw, spatial_step=length / (fused_newton.MAX_N - 1)))
        la = (c_long.geometry, s_long.us_params, s_long.ds_params, s_long.h0, s_long.Q0,
              s_long.settings(tolerance=1e-6, max_iter=100))
        out_lk = fused_simulate(*la)
    long_ms = statistics.median(wall_ms(lambda: fused_simulate(*la)) for _ in range(3))
    t0 = time.perf_counter()
    out_lp = fused_simulate_plain(*la)
    torch.cuda.synchronize()
    long_plain_ms = (time.perf_counter() - t0) * 1e3
    lcmp = compare_runs(out_lk, out_lp, "long reach fused vs plain")
    emit("long_reach", n_nodes=s_long.number_of_nodes, sweeps=sweeps(s_long.number_of_nodes),
         spatial_step=s_long.spatial_step, kernel_ms=long_ms, plain_ms=long_plain_ms,
         us_per_newton_iteration=long_ms * 1e3 / lcmp["iterations"], unsupported_note=note,
         shorter_reaches=mid_checks, **lcmp)

    # -- phase 7: the Monte-Carlo main path, through the user entry points ----
    # model.build -> roughness_ensemble + per-member inflow -> batched_simulate
    # (engine="fused", store="boundaries"): all members in ONE launch
    B = ENSEMBLE_MEMBERS
    rng = np.random.default_rng(ENSEMBLE_SEED)
    n_draws = rng.uniform(*ENSEMBLE_N_RANGE, B)
    q_scale = rng.uniform(*ENSEMBLE_INFLOW_RANGE, B)
    sset_b = dataclasses.replace(solver.settings(tolerance=1e-6, max_iter=100), store="boundaries")

    def build_ensemble():
        return (ensemble.roughness_ensemble(channel.geometry, n_draws),
                scaled_inflow(solver.us_params, q_scale))

    def run_ensemble(geob, us_b, members=B, sset=sset_b):
        return ensemble.batched_simulate(
            trees.slice_members(geob, 0, members), trees.slice_members(us_b, 0, members),
            solver.ds_params, solver.h0, solver.Q0, sset, us_axes=0, engine="fused")

    build_ms = wall_ms(build_ensemble)
    geob, us_b = build_ensemble()
    fused_batched.launch_count = 0
    fused_newton.launch_count = 0
    out_e = run_ensemble(geob, us_b)
    torch.cuda.synchronize()
    launches["fused_simulate_batched"] = fused_batched.launch_count
    if launches["fused_simulate_batched"] != 1 or fused_newton.launch_count != 0:
        raise AssertionError(f"the ensemble took {fused_batched.launch_count} batched and "
                             f"{fused_newton.launch_count} single launches, expected 1 and 0")
    if out_e.depth.shape != (B, nt, 2) or out_e.iterations.shape != (B, nt) \
            or not bool(torch.isfinite(out_e.depth).all()) or not bool(torch.isfinite(out_e.flow).all()):
        raise AssertionError("ensemble output has the wrong shape or is not finite")
    if not bool(out_e.converged.all()):
        raise AssertionError(f"ensemble: {int((~out_e.converged.all(dim=1)).sum())} of {B} members "
                             "did not converge at every level")
    per_member = out_e.iterations.sum(dim=1)
    ens_iters = int(per_member.sum())
    ens_runs = [wall_ms(lambda: run_ensemble(geob, us_b)) for _ in range(3)]
    ens_ms = statistics.median(ens_runs)
    # the packing alone: what the wrapper does on the device before the launch
    lead = (B,)
    pack_ms = wall_ms(lambda: (
        fused_newton.pack_geometry(geob), fused_newton.pack_params(us_b, solver.ds_params, sset_b, lead),
        fused_newton.series(us_b, nt, dev, lead), fused_newton.series(solver.ds_params, nt, dev, lead),
        solver.h0.expand(B, n).contiguous(), solver.Q0.expand(B, n).contiguous()))
    peak = out_e.flow[:, :, 1].max(dim=1).values.cpu().numpy()
    scaling = []
    for members in SCALING_MEMBERS:
        its = run_ensemble(geob, us_b, members).iterations.sum(dim=1)   # first touch of this grid size
        ms_b = wall_ms(lambda: run_ensemble(geob, us_b, members))
        scaling.append(dict(members=members, ms=ms_b, sims_per_s=members / (ms_b * 1e-3),
                            newton_iterations=int(its.sum()), most_in_a_member=int(its.max())))
    sset_full = dataclasses.replace(sset_b, store="full")
    out_f = run_ensemble(geob, us_b, 1024, sset_full)
    if out_f.depth.shape != (1024, nt, n) or not bool(out_f.converged.all()) \
            or not torch.equal(out_f.depth[:, :, [0, -1]], out_e.depth[:1024]):
        raise AssertionError("the store='full' ensemble disagrees with the store='boundaries' one")
    full_ms = wall_ms(lambda: run_ensemble(geob, us_b, 1024, sset_full))
    del out_f
    run_ensemble(geob, us_b, 1024)
    ends_ms = wall_ms(lambda: run_ensemble(geob, us_b, 1024))   # the same members, store="boundaries"
    emit("ensemble", members=B, n_nodes=n, n_time_levels=nt, store="boundaries", launches=1,
         all_converged=True, wall_ms_runs=ens_runs, wall_ms_median=ens_ms,
         simulations_per_s=B / (ens_ms * 1e-3), total_newton_iterations=ens_iters,
         mean_iterations_per_member=ens_iters / B,
         min_max_iterations_per_member=[int(per_member.min()), int(per_member.max())],
         newton_node_updates_per_s=n * ens_iters / (ens_ms * 1e-3),
         ensemble_build_ms=build_ms, packing_ms=pack_ms,
         downstream_peak_flow_quantiles_5_50_95=np.percentile(peak, [5, 50, 95]).tolist(),
         scaling=scaling, store_full_1024=dict(members=1024, ms=full_ms, ms_store_boundaries=ends_ms,
                                               sims_per_s=1024 / (full_ms * 1e-3),
                                               output_bytes=fused_newton.output_bytes(1024, n, nt, "full")))

    # -- phase 8: a calibration sweep ------------------------------------------
    # 64 roughness candidates, each with its own GVF initial state, against
    # synthetic targets made from the n = 0.030 run
    ic_fn = calibrate.gvf_ic_fn(solver.spatial_step, channel.initial_flow_rate,
                                channel.downstream_boundary.initial_depth)
    n_grid = 0.020 + 0.0005 * np.arange(SWEEP_CANDIDATES)
    geo_true = calibrate.set_main_roughness(channel.geometry, 0.030)
    out_true = fused_simulate(geo_true, solver.us_params, solver.ds_params, *ic_fn(geo_true), sset)
    q_lo, q_hi = float(out_true.flow[:, 0].min()), float(out_true.flow[:, 0].max())
    Q_targets = torch.linspace(q_lo, q_hi, 12, dtype=torch.float64, device=dev)[1:-1]
    H_targets = calibrate.upstream_stage_at(out_true, channel.geometry.z_bed[0], Q_targets)
    fused_batched.launch_count = 0
    t0 = time.perf_counter()
    rmse = calibrate.rmse_sweep(channel.geometry, solver.us_params, solver.ds_params, solver.h0,
                                solver.Q0, sset, Q_targets, H_targets, n_grid, engine="fused",
                                ic_fn=ic_fn)
    torch.cuda.synchronize()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    best = int(torch.argmin(rmse))
    if best != int(np.argmin(np.abs(n_grid - 0.030))) or not bool(torch.isfinite(rmse).all()):
        raise AssertionError(f"rmse_sweep: the minimum is at n={n_grid[best]}, expected 0.030")
    if fused_batched.launch_count != 1:
        raise AssertionError(f"rmse_sweep took {fused_batched.launch_count} launches, expected 1")
    emit("calibrate", candidates=SWEEP_CANDIDATES, launches=1, sweep_ms_with_gvf_initial_states=sweep_ms,
         best_n=float(n_grid[best]), rmse_at_best=float(rmse[best]), rmse_min_max=[float(rmse.min()), float(rmse.max())],
         rmse_neighbours=[float(rmse[best - 1]), float(rmse[best + 1])])

    # -- phase 9: the long reach, one tiled SPIKE launch per Newton iteration --
    long_records, tiled = drive_long_reach(dev, launches)
    emit("long_reach_tiled", linear_solver="cuda_tiled", against="pcr", sizes=long_records)

    # -- phase 10: the reservoir example ---------------------------------------
    emit("reservoir", **drive_reservoir(dev))

    # -- the kernel table ----------------------------------------------------
    n_it = cmp["iterations"]          # iterations of the run that ms/plain_ms time
    n_par = fused_newton._N_PARAMS
    fused_bytes = 8 * (13 * n + 2 * n + 2 * cmp_levels + n_par) \
        + fused_newton.output_bytes(1, n, cmp_levels, "full")
    fused_flops = n_it * n * (FLOPS_ASSEMBLY + sweeps(n) * FLOPS_PCR_SWEEP + FLOPS_PCR_BACKSOLVE)
    pcr_bytes = 8 * (14 * n + 2 * n)
    pcr_flops = n * (sweeps(n) * FLOPS_PCR_SWEEP + FLOPS_PCR_BACKSOLVE)

    def bound(nbytes, flops):
        tb, tf = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F64_FLOPS * 1e3
        return max(tb, tf), ("bytes" if tb >= tf else "operations")

    fb, fby = bound(fused_bytes, fused_flops)
    pb, pby = bound(pcr_bytes, pcr_flops)
    # the batched kernel: the same work per Newton iteration, over the
    # iterations this ensemble's data needed; store="boundaries" outputs
    per_member_in = 8 * (13 * n + 2 * n + 2 * nt + n_par)
    bb, bby = bound(B * per_member_in + fused_newton.output_bytes(B, n, nt, "boundaries"),
                    ens_iters * n * (FLOPS_ASSEMBLY + sweeps(n) * FLOPS_PCR_SWEEP + FLOPS_PCR_BACKSOLVE))
    kernels = [
        dict(name="fused_simulate", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/fused_newton.cu",
             replaces="flowsim_tpu/ops/pallas/fused_newton.py:1413",
             launches=launches["fused_simulate"], max_abs_err=cmp["max_abs_dh"],
             ms=fused_cmp_ms, plain_ms=plain_ms, bound_ms=fb, bound_by=fby, library_ms=None,
             shape=dict(n_nodes=n, n_time_levels=cmp_levels, newton_iterations=n_it),
             tolerance=dict(depth_m=H_TOL, flow_m3s=Q_TOL, iteration_counts="identical")),
        dict(name="fused_simulate_batched", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/fused_newton.cu",
             replaces="flowsim_tpu/ops/pallas/fused_newton.py:2269",
             launches=launches["fused_simulate_batched"], max_abs_err=batched_cmp["max_abs_dh"],
             ms=ens_ms, plain_ms=plain_batched_ms, bound_ms=bb, bound_by=bby, library_ms=None,
             ms_at_plain_shape=kernel_batched_cmp_ms, ms_over_bound=ens_ms / bb,
             shape=dict(members=B, n_nodes=n, n_time_levels=nt, newton_iterations=ens_iters,
                        store="boundaries"),
             plain_shape=dict(members=batched_cmp["members"], n_nodes=n,
                              n_time_levels=batched_cmp["levels"],
                              newton_iterations=batched_cmp["iterations"], store="full"),
             tolerance=dict(depth_m=H_TOL, flow_m3s=Q_TOL, iteration_counts="identical",
                            against_single_launches="bit-identical")),
        dict(name="pcr_solve", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/pcr_kernel.cu",
             replaces="flowsim_tpu/ops/pallas/pcr_kernel.py:79",
             launches=launches["pcr_solve"], max_abs_err=pcr_err,
             ms=pcr_ms, plain_ms=pcr_plain_ms, bound_ms=pb, bound_by=pby, library_ms=pcr_lib_ms,
             shape=dict(n_nodes=n, systems=1),
             tolerance=dict(relative=1e-10)),
        # ms is the whole solve (the kernel's stage A plus the torch stages B
        # and C); the bound is that of the kernel's own traffic.  No single
        # PyTorch call solves a banded system of 2e6 unknowns: library_ms null
        dict(name="tiled_spike_solve", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/tiled_pcr.cu",
             replaces="flowsim_tpu/ops/pallas/tiled_pcr.py:139",
             launches=launches["tiled_spike_solve"], max_abs_err=tiled["max_abs_err"],
             ms=tiled["solve_ms"], plain_ms=tiled["plain_solve_ms"], bound_ms=tiled["bound_ms"],
             bound_by=tiled["bound_by"], library_ms=None,
             stage_a_ms=tiled["stage_a_ms"], stage_b_ms=tiled["stage_b_ms"], stage_c_ms=tiled["stage_c_ms"],
             shape=dict(n_nodes=tiled["n_nodes"], tile=tiled["tile"], tiles=tiled["tiles"]),
             tolerance=dict(relative=TILED_REL_TOL)),
    ]
    for kern in kernels:
        if kern["launches"] < 1:
            raise AssertionError(f"{kern['name']} was not launched on the main path")

    if "jax" in sys.modules or "flowsim_tpu" in sys.modules or "pandas" in sys.modules:
        raise AssertionError("chip_smoke.py must not import jax, flowsim_tpu or pandas")

    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
