#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root, no arguments, one card::

    python3 chip_smoke.py

It builds the CUDA kernels of ``flowsim_tpu_torch/ops/cuda/csrc`` with
``nvcc``, holds each against its plain PyTorch version on the card, and drives
two main paths through the user entry points:

* one forecast: the GERD->Roseires flagship end to end (``model.build`` ->
  ``PreissmannSolver.run``), checked by the repository's own means (all levels
  converged, 4803 Newton iterations, fields equal to the plain engine's);
* the Monte-Carlo / calibration path: 10 240 members of that flagship
  (per-member roughness and inflow) through
  ``parallel.ensemble.batched_simulate(engine="fused")`` in one kernel launch,
  with the scaling curve over the member count, and a 64-candidate
  ``models.calibrate.rmse_sweep(engine="fused")``.

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
FLOPS_ASSEMBLY = 530

H_TOL = 1e-9      # m: kernel vs plain engine, same arithmetic up to rounding
Q_TOL = 1e-6      # m^3/s on flows of ~1e4
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


def compare_runs(kernel_out, plain_out, what: str) -> dict:
    """Kernel B against the plain engine: identical per-level iteration
    counts and gate series, fields within H_TOL / Q_TOL."""
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
    if not bool(kernel_out.converged.all()) or not bool(torch.isfinite(kernel_out.depth).all()):
        raise AssertionError(f"{what}: kernel run not converged / not finite")
    return dict(levels=len(it_k), iterations=int(sum(it_k)), max_abs_dh=dh, max_abs_dQ=dq)


def compare_members(batched_out, member_outs, what: str, exact: bool) -> dict:
    """A batched run against one run per member: identical per-level iteration
    counts and gate series; fields bit-identical (``exact``: the same kernel
    launched once per member) or within H_TOL / Q_TOL (the plain version)."""
    dh = dq = 0.0
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
    if not (dh <= H_TOL and dq <= Q_TOL):
        raise AssertionError(f"{what}: max|dh|={dh} (tol {H_TOL}), max|dQ|={dq} (tol {Q_TOL})")
    return dict(members=len(member_outs), levels=int(batched_out.iterations.shape[1]),
                iterations=int(batched_out.iterations.sum()), max_abs_dh=dh, max_abs_dQ=dq,
                bit_identical=exact)


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
         fused_simulate_batched=batched_checks)

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
    L, D, U, b, _ = prs.assemble(channel.geometry, solver.us_params, solver.ds_params, args[5],
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
