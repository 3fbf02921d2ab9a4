#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root, no arguments, one card::

    python3 chip_smoke.py

It builds the CUDA kernels of ``flowsim_tpu_torch/ops/cuda/csrc`` with
``nvcc``, holds each against its plain PyTorch version on the card, and drives
the main paths through the user entry points:

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
  launch each of the tiled SPIKE solve's three kernels (local tile solves,
  reduced system, substitution) per Newton iteration — against the same run
  with the plain ``"pcr"`` solve, and each stage timed at two tiles;
* reaches of 965-8192 nodes (phase ``long_reach_fused``): the flagship
  refined to 50 m (N = 2409, 385 levels) through
  ``api.PreissmannSolver.run(engine="fused")``, the long reach at N = 2048,
  4096 and 8192 through ``fused_simulate`` and 1024 members of the N = 2048
  reach through ``batched_simulate(engine="fused")`` — the long build of
  kernel 1, its state in a scratch of device memory, and the cluster build
  of kernel 3, each member over a thread-block cluster with its state in
  their shared memory — against the plain engine, the cluster build in
  turns with the long build (a block and a scratch a member), the
  cluster build forced on single launches, the long and the cluster build
  forced at N <= 964 against the register build bit for bit (trapezoid,
  storage and table reaches), and the N = 2048 reach on lookup tables;
* the reservoir: ``models.example.build()`` (a flood wave routed into a lumped
  storage) with ``engine="fused"`` against ``engine="plain"``, and the same
  reservoir with a power outflow rating fitted through ``api.RatingCurve``;
* river networks: the flagship with a tributary confluence
  (``models.gerd_tributary``: 3 branches, 385 levels) through
  ``ops.network.simulate_network(engine="fused")`` and
  ``api.NetworkSolver.run(engine="fused")``, one launch of the network kernel
  each, and the 127-branch basin of ``models.basin`` through the stacked engine
  with ``linear_solver="cuda_pcr"`` (one PCR launch per Newton iteration);
* the network Monte-Carlo: 1024 tributary members (per-member inflow scale)
  through ``parallel.ensemble.batched_simulate_network(engine="fused")`` in
  one launch of the batched network kernel, and each build of the network
  kernel timed on the same members;
* irregular sections (phase ``table``): the JAX package's hardware-validation
  reach of two surveyed polylines (N = 121, M = 1024 depth samples, 193
  levels) through ``api.PreissmannSolver.run(engine="fused")`` — the table
  path of kernel 1, its lean build, held to the register build bit for bit
  on every table case and timed in turns with it and the bracket build, on
  one launch and on batches, their probe builds beside — and its 10
  240-member roughness ensemble
  (``table_roughness_ensemble`` -> ``batched_simulate(engine="fused")``, M =
  96) — the table path of kernel 3, its bracket build, timed in turns with
  the residency build it replaced and both probed —, with a mixed-station
  reach, lateral
  inflow, store="boundaries", the boundary pairs and storage rows on tables,
  and batched launches bit-identical to single ones; the single run and 4
  members of the ensemble are held against the plain engine on all 193 levels;
* surveyed branches in river networks (phase ``table_network``): that reach
  split at node 60 into two table branches, with and without a trapezoid
  tributary at the junction, through ``simulate_network(engine="fused")`` —
  the table path of kernel 5 — and 1024 mixed members at M = 96 through
  ``batched_simulate_network(engine="fused")`` — the table path of kernel 6
  —, held against the plain version on the card (both networks and two
  members on their first 49 levels), every build of the table path forced to the
  same bits, the probe builds, B = 4 against single launches and a NaN
  member among 15 sound ones;
* networks beyond one block's shared memory (phase ``network_scratch``): the
  tributary on the flagship at 50 m (3627 slots, 385 levels) through
  ``simulate_network(engine="fused")`` and ``NetworkSolver.run(engine=
  "fused")``, the 127-branch basin, the basin at levels=6 and a table
  network of 3075 slots — the cluster build of kernel 5, one network over a
  thread-block cluster with its slot arrays in the blocks' shared memory —,
  a trapezoid and a table network of 3 x 4097 slots beyond a cluster's
  shared memory — the scratch build of kernel 5, its slot arrays in device
  memory — and 1024 members of the tributary at 250 m through
  ``batched_simulate_network(engine="fused")`` — kernel 6's scratch build on
  a persistent grid —, held against the plain version on the card; the
  cluster build timed in turns with the scratch build forced and held to its
  bits, their probe builds, kernel 6 in the cluster build's forms, and both
  builds forced where the shared-memory builds run, bit for bit.

Before the main path, the ``kernels`` phase also holds kernel 1's latency
build (the one a single launch takes) against its register build bit for
bit, lumped storages with outflow ratings of every kind but gated_blend
(power, table, poly_n among them) in kernels 1, 3, 5 and 6 against their
plain versions, and the ``probe`` phase splits a Newton iteration of kernels 5 and 1 into
its phases (the probe builds, of every build of kernel 1: thread 0 reads the
SM clock after each barrier) and prints microseconds per iteration for each.

Any mismatch raises: no phase's failure is caught.  Every phase prints one
JSON line; the last line of the output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<card>", "count": 1}}

Without a CUDA device the script exits non-zero and prints no result.

``python3 chip_smoke.py --kernel1-times`` times kernel 1 alone (CUDA events,
packing outside: the flagship at 97 and 385 levels in every build, the
reservoir example), ``--kernel2-times`` kernel 2 alone (the host's path and
the device alone), ``--network-times`` kernels 5 and 6 alone (the tributary,
one launch and 1024 members), ``--table-times`` kernel 1's table builds in
turns with their probes (the validation reach at M = 1024 and 96, 16 members
and one wave at M = 96), ``--sass`` counts each kernel's float64
instructions between barriers; with any of them the script prints only
those, to compare two checkouts on one card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import inspect
import json
import math
import re
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

# Floating-point operations per node, counted by hand (a division, sqrt or
# cbrt counts as one).  A bound charges the least work of the function, not
# the kernel's algorithm: the kernels solve their block-tridiagonal systems
# by PCR (n log n), but block Thomas solves the same system in O(n), so
# every linear solve is charged as block Thomas on 2x2 blocks:
#   forward, one node           D' = D - L C_prev (12 + 4), its inverse
#                               (determinant 3, reciprocal 1, 4 products),
#                               C = D'^-1 U (12), d = D'^-1 (b - L d_prev)
#                               (6 + 2 + 6)
#   back-substitution, one node x = d - C x_next (6 + 2)
#   each further RHS pair       6 + 2 + 6 forward, 6 + 2 back
#   one Newton assembly         section state + energy slope with curvature
#                               (~420) + cell stencil and Jacobian (~110)
FLOPS_THOMAS = 12 + 4 + 8 + 12 + 14 + 8
FLOPS_THOMAS_PAIR = 14 + 8
FLOPS_ASSEMBLY = 530
# one Newton assembly on lookup tables (irregular sections): the section
# state is 7 linear interpolations (3 each) in place of the trapezoid's
# closed forms; the energy slope with curvature (~140 of the ~420 above) and
# the cell stencil (~110) as in FLOPS_ASSEMBLY
FLOPS_TABLE_ASSEMBLY = 7 * 3 + 140 + 110
# the tiled solve's stages B and C (csrc/tiled_pcr.cu), per reduced row and
# per node:
#   one cyclic-reduction row update   D' and the five right-hand-side columns
#                                     (160) + a 4x4 elimination with partial
#                                     pivoting over five columns: 4
#                                     reciprocals, 94 forward, 80 back
#   one back-substituted reduced row  4 rows x (two 2x2 products + 2)
#   stage C, one node                 2 rows x (two 2-term products + 2)
FLOPS_CR_ROW = 160 + 4 + 94 + 80
FLOPS_CR_BACK = 32
FLOPS_SUBSTITUTE = 16

H_TOL = 1e-9      # m: kernel vs plain engine, same arithmetic up to rounding
Q_TOL = 1e-6      # m^3/s on flows of ~1e4
STAGE_TOL = 1e-9  # m: reservoir stage of a lumped storage
TILED_REL_TOL = 1e-11   # tiled SPIKE kernel vs its plain version, relative
LONG_REACH_NODES = (10_000, 100_000, 1_000_000)
TILED_TILES = (256, 512)   # the tiles of the tiled solve timed against each other
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
SCALING_MEMBERS = (1, 66, 132, 264, 265, 528, 1056, 2048)
SWEEP_CANDIDATES = 64

# river networks: the tributary confluence on the flagship (3 branches, one
# junction, 385 levels) and the dendritic basin of models/basin.py
NETWORK_SPLIT_NODE = 60
NETWORK_COMPARED_LEVELS = 49      # the stacked plain engine on the card, first levels
NETWORK_Y_TOL = 1e-9              # m: junction stages
# the network Monte-Carlo of the JAX package's scripts/bench_network_mc.py:
# inflow scale 0.9 + 0.2 * default_rng(0).random(M) on every external
# flow-hydrograph end
NETWORK_MC_MEMBERS = 1024
NETWORK_MC_SEED = 0
NETWORK_SCALING_MEMBERS = (1, 132, 264, 1024)
BASIN_MC_MEMBERS = 256
# scripts/bench_basin_large.py at levels=7: 127 branches of 45 nodes, 6 hours
LARGE_BASIN = dict(levels=7, link_nodes=45, sim_hours=6)

# irregular sections: the JAX package's hardware-validation reach
# (scripts/validate_fused_hw.py:55-90, "irregular_table"): 40 km at slope
# 2e-4, two surveyed polylines of 21 points (n = 0.03), N = 121, M = 1024
# depth samples, 193 levels of 1800 s, theta 0.7, tol 1e-8; its ensemble
# ("batched_table", :330-362) rebuilt at M = 96, tol 1e-6, over
# n in linspace(0.025, 0.04)
TABLE_LENGTH, TABLE_SLOPE, TABLE_NODES = 40000.0, 2e-4, 121
TABLE_LEVELS, TABLE_DT, TABLE_THETA, TABLE_TOL = 193, 1800.0, 0.7, 1e-8
TABLE_BATCH_SAMPLES, TABLE_BATCH_TOL = 96, 1e-6
TABLE_OPTION_LEVELS = 25       # lateral inflow with store="boundaries"
TABLE_PLAIN_MEMBERS = 2        # members of the timed ensemble held against the plain engine
TABLE_SMALL_BATCH = 16         # the JAX case's members
TABLE_N_RANGE = (0.025, 0.04)
JUNCTION_RATING_KINDS = ("polynomial", "blended_poly", "poly_n", "power", "table")
# surveyed branches in networks: the validation reach split at
# NETWORK_SPLIT_NODE into two table branches (the split of
# tests/test_fused_network.py's table network), and in the mixed variant the
# trapezoid tributary of scripts/validate_fused_network_hw.py:349-366 (b = 40
# m, m = 2, n = 0.03, 4 km at slope 2e-4, 150 -> 300 m^3/s over 4 h) at the
# main stem's dx; its ensemble at M = 96, tol 1e-6, with the network
# Monte-Carlo's inflow draws
TRIB_LENGTH, TRIB_WIDTH, TRIB_SIDE, TRIB_N, TRIB_FLOWS = 4000.0, 40.0, 2.0, 0.03, (150.0, 300.0)
# levels of the surveyed networks and of two ensemble members held against
# the plain engine: the first 49 (the script runs more than a minute longer
# than before this phase, so the plain engine does not take all 193)
TABLE_NET_COMPARED_LEVELS = 49
TABLE_NET_SMALL_BATCH = 16
TABLE_NET_BIT_MEMBERS = 4
# the bracket build's other forms (bracket_forms): members, depth samples
BRACKET_FORM_MEMBERS, BRACKET_FORM_SAMPLES = 4, 96


# reaches of 965-8192 nodes in kernels 1 and 3 (their long build): the JAX
# package's scaling reach (build_long_reach, scripts/bench_scaling.py:43-79)
# at these N, 8 levels, against the plain engine on every level; the
# flagship refined to 50 m (N = 2409, 385 levels; the plain engine on its
# first 25); the scaling reach at N = 2048 on lookup tables of M = 32
# samples; and 1024 members of the N = 2048 reach with roughness
# linspace(0.02, 0.06) (scripts/bench_scaling.py:135-140)
LONG_FUSED_NODES = (2048, 4096, 8192)
LONG_FLAGSHIP_STEP = 50.0
LONG_FLAGSHIP_PLAIN_LEVELS = 25
LONG_TABLE_NODES, LONG_TABLE_SAMPLES = 2048, 32
LONG_ENSEMBLE_MEMBERS, LONG_ENSEMBLE_NODES, LONG_ENSEMBLE_N_RANGE = 1024, 2048, (0.02, 0.06)
LONG_BIT_MEMBERS = 4

# networks beyond one block's shared memory (the scratch build of kernels 5
# and 6): the tributary on the flagship at 50 m (split at node 1200: 1201 /
# 201 / 1209 nodes, 3627 slots, 385 levels; the plain version on its first
# 25) and at 250 m (split at node 240: 241 / 41 / 243 nodes, 729 slots) for
# the network Monte-Carlo's members (member 1023 against the plain version
# on SCRATCH_PLAIN_LEVELS levels; members 0-3 against single launches); the basin at levels=6 (63 x 13
# slots) and LARGE_BASIN (127 x 45), 25 levels; the N = 2048 scaling reach on
# tables (M = 32) split at node 1024 with a trapezoid tributary (3 x 1025)
SCRATCH_TRIB_50 = dict(split_node=1200, spatial_step=50.0)
SCRATCH_TRIB_250 = dict(split_node=240, spatial_step=250.0)
SCRATCH_PLAIN_LEVELS = 25
SCRATCH_BASIN = dict(levels=6, sim_hours=6)
SCRATCH_TABLE_SPLIT = 1024
SCRATCH_BIT_MEMBERS = 4
SCRATCH_NAN_MEMBERS = 16
# beyond a cluster's shared memory (the scratch build of kernel 5 since the
# cluster build): the N = 8192 scaling reach split at node 4096 with the
# tributary of scratch_table_network, 3 x 4097 slots, 8 levels
SCRATCH_HUGE = (8192, 4096)
# the cluster build sums the norm rank by rank: against another build every
# field bit for bit but the norm, which agrees to this relative tolerance
CLUSTER_ERR_RTOL = 1e-12


# the host's clock at the end of the last phase, and each phase's seconds
# (from the end of the one before): the "done" line prints them all
PHASE_SECONDS = {"_since": time.perf_counter()}


def emit(phase: str, **fields) -> None:
    now = time.perf_counter()
    PHASE_SECONDS[phase] = now - PHASE_SECONDS["_since"]
    PHASE_SECONDS["_since"] = now
    print(json.dumps({"phase": phase, "phase_seconds": PHASE_SECONDS[phase], **fields}), flush=True)


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


def readings(fn, n: int = 3) -> list:
    """``n`` readings of one launch each by CUDA events, after one launch: in
    a comparison in turns each build's median of them, since a stall of the
    host inside a reading adds to it."""
    return [time_cuda(fn, reps=1, warmup=int(not r)) for r in range(n)]


def builds_in_turns(launch, ids: dict, rounds: int = 3) -> dict:
    """Each build of ``ids`` (name: build id) launched by ``launch`` in turns
    (forward, backward, forward, backward), ``rounds`` readings a turn
    (:func:`readings`): name -> its readings in ms."""
    runs = {n: [] for n in ids}
    for r in range(4):
        for n in (list(ids) if r % 2 == 0 else list(ids)[::-1]):
            runs[n] += readings(lambda: launch(ids[n]), n=rounds)
    return runs


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def pack_one(geo, us, ds, h0, Q0, sset, qlat=None) -> tuple:
    """``fused_newton.launch``'s arguments for one simulation, packed as
    ``fused_simulate`` packs them (``qlat``: ``None``, ``[N]`` or ``[nt, N]``;
    a TableGeometry's tables with them)."""
    from flowsim_tpu_torch.ops.cuda import fused_newton as fn

    nt, dev = sset.n_time_levels, h0.device
    par, rc_kind, us_rc_kind = fn.pack_params(us, ds, sset)
    stor, stab, st_ints = fn.pack_storage(us, ds)
    one = lambda t: t.unsqueeze(0).contiguous()
    return (one(fn.pack_geometry(geo)), one(h0), one(Q0), one(fn.series(us, nt, dev)),
            one(fn.series(ds, nt, dev)), one(par), None if qlat is None else one(qlat), sset, us.kind, ds.kind,
            rc_kind, us_rc_kind, (one(stor), stab, st_ints), fn.pack_tables(geo))


SIM_FIELDS = ("depth", "flow", "error", "iterations", "converged", "gate_open")


def same_bits(a, b, what: str, fields=SIM_FIELDS) -> None:
    """Every field bit for bit (NaN at the same places: a member that
    diverged)."""
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.is_floating_point() and not torch.equal(x.isnan(), y.isnan()):
            raise AssertionError(f"{what}: {f} is NaN at different places")
        if x.is_floating_point():
            x, y = torch.where(x.isnan(), 0.0, x), torch.where(y.isnan(), 0.0, y)
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {f} is not bit-identical")


def check_latency_build(dev) -> dict:
    """Kernel 1's latency build against its register build, bit for bit
    (depth, flow, error, iterations, converged, gate), on the 385-level
    flagship, the 25- and 49-level smooth and gated_blend flagships, the
    13-level flagship with lateral inflow (per node, per level) and
    store="boundaries", and the 20 km rectangle's eight boundary pairs; and
    the build the C entry chooses (``fused_newton.chosen_build``) at N = 121
    for one, two and three waves of the card and 10 240 members.  Counts no
    launch."""
    from flowsim_tpu_torch import api
    from flowsim_tpu_torch.models.gerd_roseires import model
    from flowsim_tpu_torch.ops.cuda import fused_newton as fn

    cases = {}
    for name, levels, kw in (("flagship_385_levels", 385, {}), ("smooth_25_levels", 25, {}),
                             ("smooth_49_levels", 49, {}), ("gated_blend_25_levels", 25, dict(smooth=False)),
                             ("gated_blend_49_levels", 49, dict(smooth=False))):
        s, c = model.build(device=dev, sim_duration=3600 * (levels - 1), **kw)
        cases[name] = (c.geometry, s.us_params, s.ds_params, s.h0, s.Q0, s.settings(tolerance=1e-6, max_iter=100))
    s13, c13 = model.build(device=dev, sim_duration=3600 * 12)
    rng = np.random.default_rng(7)
    n13, nt13 = s13.number_of_nodes, s13.number_of_time_levels
    a13 = (c13.geometry, s13.us_params, s13.ds_params, s13.h0, s13.Q0, s13.settings(tolerance=1e-6, max_iter=100))
    q_node = torch.tensor(rng.uniform(0.0, 2e-3, n13), dtype=torch.float64, device=dev)
    q_level = torch.tensor(rng.uniform(0.0, 2e-3, (nt13, n13)), dtype=torch.float64, device=dev)
    cases["lateral_inflow_per_node_13_levels"] = (*a13, q_node)
    cases["lateral_inflow_per_level_13_levels"] = (*a13, q_level)
    cases["store_boundaries_inflow_13_levels"] = (*a13[:5], dataclasses.replace(a13[5], store="boundaries"),
                                                  q_level)
    for name in BOUNDARY_CASES:
        b = build_boundary_case(api, name, device=dev)
        cases["boundary_" + name] = (b.channel.geometry, b.us_params, b.ds_params, b.h0, b.Q0,
                                     b.settings(tolerance=1e-8, max_iter=100))
    out = {}
    for name, args in cases.items():
        packed = pack_one(*args)
        if fn.chosen_build(1, args[3].shape[0]) != fn.LATENCY_BUILD:
            raise AssertionError(f"{name}: one launch does not take the latency build")
        lat = fn.launch(*packed, build_id=-1)
        reg = fn.launch(*packed, build_id=fn.REGISTER_BUILD)
        same_bits(lat, reg, f"latency vs register build, {name}")
        if not bool(lat.converged.all()):
            raise AssertionError(f"{name}: not converged")
        out[name] = dict(levels=int(lat.iterations.shape[1]), iterations=int(lat.iterations.sum()),
                         bit_identical=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    choices = {n_sims: fn.chosen_build(n_sims, 121)
               for n_sims in (1, sms, sms + 1, 2 * sms, 2 * sms + 1, ENSEMBLE_MEMBERS)}
    for n, storage in ((121, True), (129, False), (964, False)):
        if fn.chosen_build(1, n, storage) != fn.REGISTER_BUILD:
            raise AssertionError(f"N={n}, storage={storage}: not the register build")
    return dict(cases=out, chosen_build_at_n121=choices)


KERNEL1_BUILD_NAMES = {0: "register_build", 1: "residency_build", 2: "latency_build", 3: "long_build",
                      4: "bracket_build", 5: "cluster_build", 6: "reach_build", 7: "lean_build"}


def kernel1_build_ids(fn) -> list:
    """Kernel 1's builds in this checkout that one simulation of the flagship
    can take: the register build and, where it has one, the latency build."""
    return [0] + ([fn.LATENCY_BUILD] if hasattr(fn, "LATENCY_BUILD") else [])


def kernel1_builds(fn) -> dict:
    """The builds of kernel 1 to time, by name: the one the wrapper takes (-1)
    and each of :func:`kernel1_build_ids` forced."""
    return dict(chosen=-1, **{KERNEL1_BUILD_NAMES[b]: b for b in kernel1_build_ids(fn)})


def kernel1_probe_builds(fn) -> dict:
    """Kernel 1's builds with a probe build, by the key of the probe phase:
    ``flagship_kernel1`` the register build, then the latency build."""
    return {("flagship_kernel1" if b == 0 else "flagship_kernel1_" + KERNEL1_BUILD_NAMES[b]): b
            for b in kernel1_build_ids(fn)}


def kernel1_times(dev, rounds: int = 5, builds: dict | None = None) -> dict:
    """Kernel 1 alone by CUDA events: each case packed once, as
    ``fused_simulate`` packs it, then 5 back-to-back ``fused_newton.launch``
    calls a reading, the cases and builds (:func:`kernel1_builds`: the one the
    wrapper takes and each forced one; the reservoir, which has storage, the
    wrapper's only) in turns: the flagship at 97 and 385 levels and the
    reservoir example.  ``python3 chip_smoke.py --kernel1-times`` prints only
    this, so that two checkouts can be compared on one card."""
    from flowsim_tpu_torch.models import example
    from flowsim_tpu_torch.models.gerd_roseires import model
    from flowsim_tpu_torch.ops.cuda import fused_newton as fn

    builds = kernel1_builds(fn) if builds is None else builds
    cases = {}
    for name, kw in (("flagship_97_levels", dict(sim_duration=3600 * (PLAIN_COMPARED_LEVELS - 1))),
                     ("flagship_385_levels", {})):
        s, c = model.build(device=dev, **kw)
        cases[name] = pack_one(c.geometry, s.us_params, s.ds_params, s.h0, s.Q0,
                               s.settings(tolerance=1e-6, max_iter=100))
    r, _ = example.build("preissmann", device=dev)
    cases["reservoir"] = pack_one(r.channel.geometry, r.us_params, r.ds_params, r.h0, r.Q0, r.settings(1e-4, 100))
    runs = {(k, b): [] for k in cases for b in builds if k != "reservoir" or b == "chosen"}
    for _ in range(rounds):
        for (k, b) in runs:
            runs[(k, b)].append(time_cuda(lambda: fn.launch(*cases[k], build_id=builds[b]), reps=5, warmup=1))
    out = {k: {} for k in cases}
    for (k, b), v in runs.items():
        out[k][b] = dict(ms=statistics.median(v), ms_runs=v)
    for k, rec in out.items():   # the wrapper's figure at the top of each case
        rec.update(ms=rec["chosen"]["ms"], ms_runs=rec["chosen"]["ms_runs"])
    return out


def graph_ms(fn, reps: int = 200) -> float:
    """Device time per call of ``fn`` alone: ``reps`` calls captured in one
    CUDA graph, the replay timed by CUDA events (least of 3 replays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


PCR_TIMED_NODES = (121, 512, 1000)


def kernel2_times(dev) -> dict:
    """Kernel 2 alone at N = 121, 512 and 1000 (one seeded system each; 121
    is the main path's shape): the host path (CUDA events around 200
    back-to-back ``pcr_solve`` calls, as the kernel table times it) and the
    device alone (:func:`graph_ms`), for the path the wrapper takes and, where
    this checkout has the ``path`` hook, each path forced.  ``python3
    chip_smoke.py --kernel2-times`` prints only this, to compare two
    checkouts."""
    from flowsim_tpu_torch.ops.cuda import pcr_kernel

    paths = {"chosen": None}
    if hasattr(pcr_kernel, "PATH_CARRIED"):
        paths.update(node_path=pcr_kernel.PATH_NODE, carried_path=pcr_kernel.PATH_CARRIED)
    carried_max = getattr(pcr_kernel, "CARRIED_MAX_N", 0)
    out = {}
    for n in PCR_TIMED_NODES:
        L, D, U, b = random_system(n, seed=n, device=dev)
        rec = {}
        for name, path in paths.items():
            if name == "carried_path" and n > carried_max:
                continue
            call = (lambda: pcr_kernel.pcr_solve(L, D, U, b)) if path is None \
                else (lambda: pcr_kernel.pcr_solve(L, D, U, b, path=path))
            rec[name] = dict(host_path_ms=time_cuda(call, reps=200), device_alone_ms=graph_ms(call))
        out[f"n_{n}"] = rec
    return out


SASS_OPS = ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX", "MUFU.RCP64H", "MUFU.RSQ64H", "CALL", "SHFL", "BAR", "LDL",
            "STL", "LDG")
SASS_FLOAT64 = ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX", "MUFU.RCP64H", "MUFU.RSQ64H")


def sass_counts(names=("fused_newton", "pcr_kernel", "fused_network", "fused_network_table"),
                out_dir="build/sass") -> dict:
    """Float64 instructions, local-memory loads and stores (``LDL``/``STL``:
    spills) and global loads of each kernel in the built libraries, from
    ``cuobjdump -sass``: per kernel the totals of :data:`SASS_OPS` and the same
    counts between consecutive barriers (``BAR.SYNC``) in program order, so
    that the closures, the assembly and one sweep can be read apart.  A
    network kernel's ``assembly`` is the segment from the closures' barrier
    to the norm's (the first that holds the norm's shuffles), with its
    ``float64`` sum.  The dumps go to ``out_dir``."""
    import os
    from flowsim_tpu_torch.ops.cuda import build

    os.makedirs(out_dir, exist_ok=True)
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    op_re = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)")
    out = {}
    for name in names:
        build.load(name)
        lib_path = build.build_info[name]["path"]
        text = subprocess.run([tool, "-sass", lib_path], check=True, capture_output=True, text=True).stdout
        with open(os.path.join(out_dir, name + ".sass"), "w") as f:
            f.write(text)
        kernel, segs = None, None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                kernel = m.group(1)
                segs = [dict.fromkeys(SASS_OPS, 0)]
                out[kernel] = dict(total=dict.fromkeys(SASS_OPS, 0), segments=segs)
                continue
            m = op_re.search(line)
            if kernel is None or not m:
                continue
            op = m.group(1)
            key = next((k for k in SASS_OPS if op.startswith(k)), None)
            if key is None:
                continue
            out[kernel]["total"][key] += 1
            segs[-1][key] += 1
            if key == "BAR" and op.startswith("BAR.SYNC"):
                segs.append(dict.fromkeys(SASS_OPS, 0))
    for kernel, rec in out.items():
        if "fused_network_kernel" in kernel:
            seg = next((sg for sg in rec["segments"] if sg["SHFL"]), None)
            if seg is not None:
                rec["assembly"] = dict(seg, float64=sum(seg[k] for k in SASS_FLOAT64))
    return out


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


STORAGE_CASES = ("ds_const", "ds_curve_rating_losses", "ds_const_losses", "us_const", "us_curve", "both_ends",
                 "ds_power_losses", "us_table", "both_poly_n")
# the power rating of scripts/validate_fused_network_hw.py:187-188: 20 m^3/s
# three metres above its crest
POWER_RATING_A, POWER_RATING_B = 20.0 / 3.0 ** 1.6, 1.6


def build_storage_case(name: str, device, levels: int = 12):
    """A 29 km rectangular reach (N = 30, width 120 m, n = 0.023, slope 6.1e-4,
    dx = 1 km, dt = 1 h, theta = 0.6) with lumped storage behind a
    ``fixed_depth`` boundary, one of STORAGE_CASES: constant area, a
    stage-area curve with a polynomial rating on the storage and entrance
    losses, losses alone, an upstream reservoir (constant area, area curve)
    over a quiescent pool, and a reservoir at each end; and the outflow
    ratings beyond the quadratics: the curve-and-losses reservoir with a
    ``power`` rating (POWER_RATING_A/B, its crest at the curve's lowest
    stage, so the whole bisection bracket lies above it), the upstream curve
    reservoir with a 10-breakpoint ``table`` rating, and the pair at both
    ends with cubic ratings from ``rating_curve.fit(..., degree=3)``
    (``poly_n``).  Returns (geo, us_bc, ds_bc, h0, Q0, settings)."""
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
    elif name == "ds_power_losses":
        us, state = us_hyd, (h0, Q0)
        curve = np.stack([bed_ds + np.linspace(-2.0, 20.0, 12), 4.0e5 * (1.0 + 0.08 * np.arange(12))], axis=1)
        ds = mk("fixed_depth", bed_level=bed_ds, storage=stg.make_storage(
            area_curve=curve, min_stage=bed_ds - 1.0,
            rating=rcurve.make_power(POWER_RATING_A, POWER_RATING_B, stage_shift=-(bed_ds - 2.0), device=device),
            capture_losses=True, reservoir_length=1500.0, K_q=0.2, device=device))
    elif name == "us_table":
        ds, state = ds_stage_pool, (pool_h0, pool_Q0)
        curve = np.stack([bed_us + np.linspace(-2.0, 30.0, 10), 8.0e6 * (1.0 + 0.05 * np.arange(10))], axis=1)
        table = rcurve.make_table(bed_us + np.array([-2.0, 0.0, 1.0, 1.5, 2.0, 2.5, 3.0, 5.0, 10.0, 30.0]),
                                  [0.0, 0.0, 5.0, 10.0, 20.0, 35.0, 50.0, 150.0, 600.0, 5000.0], device=device)
        us = mk("fixed_depth", bed_level=bed_us, storage=stg.make_storage(
            area_curve=curve, min_stage=bed_us - 1.0, rating=table, device=device))
    elif name == "both_poly_n":
        state, tol = (h0, Q0), 1e-8

        def cubic(crest, c1, c2, c3):   # monotone in the whole bracket: c2^2 < 3 c1 c3
            x = np.linspace(0.2, 4.0, 12)
            return rcurve.fit(c1 * x + c2 * x * x + c3 * x ** 3, crest + x, stage_shift=-crest, degree=3,
                              device=device)
        us = mk("fixed_depth", bed_level=bed_us, storage=stg.make_storage(
            surface_area=3.0e6, min_stage=bed_us - 5.0, solution_boundaries=(0.0, 100.0),
            rating=cubic(bed_us + float(h0[0]) - 1.0, 2.0, 0.5, 0.1), device=device))
        ds = mk("fixed_depth", bed_level=bed_ds, storage=stg.make_storage(
            surface_area=1.25e6, min_stage=bed_ds + h_ds0, solution_boundaries=(0.0, 100.0),
            rating=cubic(bed_ds + h_ds0 - 1.0, 10.0, 2.0, 0.5), device=device))
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


def batched_packed(geob, us_b, ds_bc, h0, Q0, sset) -> tuple:
    """``fused_newton.launch``'s arguments for what
    ``fused_simulate_batched(..., us_batched=True)`` launches (or with
    ``us_b`` shared, what it launches without), packed once."""
    from flowsim_tpu_torch.ops.cuda import fused_newton as fn

    n_members, n = geob.z_bed.shape
    nt, lead = sset.n_time_levels, (geob.z_bed.shape[0],)
    par, rc_kind, us_rc_kind = fn.pack_params(us_b, ds_bc, sset, batch_shape=lead)
    return (fn.pack_geometry(geob), h0.expand(n_members, n).contiguous(), Q0.expand(n_members, n).contiguous(),
            fn.series(us_b, nt, h0.device, lead), fn.series(ds_bc, nt, h0.device, lead), par, None, sset,
            us_b.kind, ds_bc.kind, rc_kind, us_rc_kind, fn.pack_storage(us_b, ds_bc, batch_shape=lead),
            fn.pack_tables(geob, n_members))


def batched_launch(geob, us_b, ds_bc, h0, Q0, sset, build_id):
    """:func:`batched_packed` launched with the kernel build forced instead
    of chosen by the member count: the register build on a batch that the
    wrapper gives the residency build, to time the two on the same members.
    Counts no launch."""
    from flowsim_tpu_torch.ops.cuda import fused_newton as fn

    return fn.launch(*batched_packed(geob, us_b, ds_bc, h0, Q0, sset), build_id=build_id)



def kernel_builds(ptxas: list) -> list:
    """Registers and spills of fused_newton.cu's builds, by template
    arguments (block size, storage rows, blocks an SM in the launch bound,
    table geometry); the probe build is left out."""
    out = []
    for rec in ptxas:
        m = re.search(r"fused_simulate_kernelILi(\d+)ELb([01])ELi(\d+)ELb0ELb([01])E", rec["kernel"])
        if m:
            out.append(dict(block=int(m.group(1)), storage=m.group(2) == "1", min_blocks=int(m.group(3)),
                            table=m.group(4) == "1",
                            **{k: rec.get(k) for k in ("registers", "stack_bytes", "spill_store_bytes",
                                                       "spill_load_bytes")}))
    return out


def bracket_kernel_builds(ptxas: list) -> list:
    """Registers and spills of fused_newton.cu's bracket and lean builds and
    their probe builds, by template argument (probe, lean)."""
    out = []
    for rec in ptxas:
        m = re.search(r"fused_bracket_kernelILb([01])E(?:Lb([01])E)?", rec["kernel"])
        if m:
            out.append(dict(probe=m.group(1) == "1", lean=m.group(2) == "1",
                            **{k: rec.get(k) for k in ("registers", "stack_bytes", "spill_store_bytes",
                                                       "spill_load_bytes", "static_smem_bytes")}))
    return out


def latency_kernel_builds(ptxas: list) -> list:
    """Registers and spills of fused_newton.cu's latency build and its probe
    build, by template argument (probe)."""
    out = []
    for rec in ptxas:
        m = re.search(r"fused_latency_kernelILb([01])E", rec["kernel"])
        if m:
            out.append(dict(probe=m.group(1) == "1",
                            **{k: rec.get(k) for k in ("registers", "stack_bytes", "spill_store_bytes",
                                                       "spill_load_bytes")}))
    return out


def reach_kernel_builds(ptxas: list) -> list:
    """Registers and spills of fused_newton.cu's reach build, by template
    arguments (storage rows, table geometry, probe, closure lanes a node)."""
    out = []
    for rec in ptxas:
        m = re.search(r"fused_reach_kernelILb([01])ELb([01])ELb([01])ELi(\d+)E", rec["kernel"])
        if m:
            out.append(dict(storage=m.group(1) == "1", table=m.group(2) == "1", probe=m.group(3) == "1",
                            lanes=int(m.group(4)),
                            **{k: rec.get(k) for k in ("registers", "stack_bytes", "spill_store_bytes",
                                                       "spill_load_bytes", "static_smem_bytes")}))
    return out


def network_kernel_builds(ptxas: list) -> list:
    """Registers and spills of fused_network.cu's builds, by template
    arguments (RHS pairs, launch-bound block, blocks an SM, one slot a
    thread, probe, table branches, slot arrays in a scratch, one network
    over a cluster, the bracket cache, the lean form, its side warps; a
    source without the last arguments has no scratch, cluster, bracket or
    lean build)."""
    out = []
    for rec in ptxas:
        m = re.search(r"fused_network_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])ELb([01])ELb([01])E"
                      r"(?:Lb([01])E)?(?:Lb([01])E)?(?:Lb([01])E)?(?:Lb([01])E)?(?:Lb([01])E)?", rec["kernel"])
        if m:
            out.append(dict(rhs=int(m.group(1)), block=int(m.group(2)), min_blocks=int(m.group(3)),
                            one_slot=m.group(4) == "1", probe=m.group(5) == "1", table=m.group(6) == "1",
                            scratch=m.group(7) == "1", cluster=m.group(8) == "1", bracket=m.group(9) == "1",
                            lean=m.group(10) == "1", side_warps=m.group(11) == "1",
                            static_smem_bytes=rec.get("static_smem_bytes"),
                            **{k: rec.get(k) for k in ("registers", "stack_bytes", "spill_store_bytes",
                                                       "spill_load_bytes")}))
    return out


def network_packed(branches, n_junctions, settings, batch=None):
    """The network kernel's packed inputs (``batch`` None: one member) and a
    function that launches them in a given build (the C entry's test hook;
    -1 chooses by the member count as the wrappers do; ``cluster`` the
    cluster build's forced cluster, 0 the C entry's) and returns the raw
    outputs.  Counts no launch."""
    from flowsim_tpu_torch.ops import network as net
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet

    M = 1 if batch is None else net.check_batch(branches, batch, settings)
    topo = fnet.check_supported(branches if batch is None else net.member_branches(branches, batch, 0),
                                n_junctions, settings)
    p = fnet._pack(branches, n_junctions, settings, batch or [dict() for _ in branches], M, None, None, None, topo)
    return topo, lambda build_id=-1, cluster=0: fnet._launch(p, M, len(branches), n_junctions, settings, topo,
                                                             build_id=build_id, cluster=cluster)


def network_launch(branches, n_junctions, settings, batch=None, build_id=-1):
    """What ``fused_simulate_network`` (``batch`` None) or
    ``fused_simulate_network_batched`` launches, with the kernel build forced
    instead of chosen by the member count.  Counts no launch."""
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet

    topo, launch = network_packed(branches, n_junctions, settings, batch)
    out = fnet._output(launch(build_id), topo, None)
    return out if batch is not None else fnet._single(out)


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
    """Kernel 1 with each storage variant (every outflow rating kind but
    gated_blend among them) and kernel 3 with storage ensembles (per-member
    power and poly_n coefficients among them) against their plain versions:
    identical per-level counts, fields and reservoir stages within the
    tolerances; a batch against single launches bit for bit."""
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
    # outflow ratings beyond the quadratics in kernel 3: four members of
    # per-member power coefficients (a scaled), against single launches bit
    # for bit and against the plain version
    geo, us, ds, h0, Q0, sset = build_storage_case("ds_power_losses", dev, levels=6)
    B = 4
    rt = ds.storage.rating
    ds_members = [dataclasses.replace(ds, storage=dataclasses.replace(ds.storage, rating=dataclasses.replace(
        rt, coeffs=rt.coeffs * torch.tensor([f, 1.0], dtype=torch.float64, device=dev))))
        for f in (0.8, 1.0, 1.2, 1.5)]
    ds_b, _ = ensemble.batch_boundaries(ds_members)
    geob = expand_members(geo, B)
    out_k = fused_simulate_batched(geob, us, ds_b, h0, Q0, sset, ds_batched=True)
    out_p = fused_simulate_batched_plain(geob, us, ds_b, h0, Q0, sset, ds_batched=True)
    out["ensemble_ds_power_4x6"] = compare_members(
        out_k, [prs_out_member(out_p, m) for m in range(B)], "power-rated storage ensemble", exact=False)
    singles = [fused_simulate(geo, us, ds_members[m], h0, Q0, sset) for m in range(B)]
    compare_members(out_k, singles, "power-rated storage ensemble vs single launches", exact=True)
    final = out_k.reservoir_stage[:, -1].tolist()
    if len(set(final)) != B:
        raise AssertionError(f"power-rated storage ensemble: the members' final stages do not differ: {final}")
    out["ensemble_ds_power_4x6"].update(final_stage_per_member=final, against_single_launches="bit-identical")
    # per-member cubic coefficients at both ends (the storage tables per member)
    args = build_storage_case("both_poly_n", dev, levels=6)
    rd = args[2].storage.rating
    ds_members = [dataclasses.replace(args[2], storage=dataclasses.replace(
        args[2].storage, rating=dataclasses.replace(rd, coeffs=rd.coeffs * f))) for f in (0.8, 1.0, 1.25)]
    ds_b, _ = ensemble.batch_boundaries(ds_members)
    geob = expand_members(args[0], 3)
    out_k = fused_simulate_batched(geob, args[1], ds_b, *args[3:], ds_batched=True)
    out_p = fused_simulate_batched_plain(geob, args[1], ds_b, *args[3:], ds_batched=True)
    out["ensemble_both_poly_n_3x6"] = compare_members(
        out_k, [prs_out_member(out_p, m) for m in range(3)], "poly_n storage ensemble", exact=False)
    # a power rating whose crest lies inside the bisection bracket: its
    # discharge at the bracket's foot is NaN, and the bisection takes the
    # plain engine's NaN branch (the stage goes to the foot, then min_stage)
    geo, us, ds, h0, Q0, sset = build_storage_case("ds_power_losses", dev, levels=4)
    f64 = dict(dtype=torch.float64, device=dev)
    nan_foot = dataclasses.replace(ds, storage=dataclasses.replace(
        ds.storage, min_stage=torch.tensor(1.0, **f64),
        rating=dataclasses.replace(ds.storage.rating, stage_shift=torch.tensor(1.5, **f64))))
    out_k = fused_simulate(geo, us, nan_foot, h0, Q0, sset)
    out["power_crest_inside_bracket"] = dict(
        compare_runs(out_k, fused_simulate_plain(geo, us, nan_foot, h0, Q0, sset), "power crest inside bracket"),
        stage=out_k.reservoir_stage[1:].tolist())
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


TILED_COUNTERS = ("launch_count", "stage_b_launch_count", "stage_c_launch_count")


def reduced_cr_flops(rows: int) -> int:
    """Operations of stage B's cyclic reduction over ``rows`` reduced rows:
    one row update per row eliminated on the way up, one back-substitution
    per row solved on the way down."""
    updates, s = 0, 1
    while 2 * s <= rows:
        updates += rows // (2 * s)
        s *= 2
    return updates * FLOPS_CR_ROW + (rows - 1) * FLOPS_CR_BACK


def tiled_bounds(n: int, T: int) -> dict:
    """The least time of the whole solve and of stages B and C at N = n, tile
    T: (bound ms, "bytes" / "operations") each.  The whole function reads L,
    D, U, b once and writes x once (16 doubles a node); its operations are
    those of block Thomas on the same system (stage A's PCR sweeps are the
    algorithm's work, not the function's).  Stage B reads the reduced rows
    once and writes y once; stage C reads G, V, W and y once and writes x
    once."""
    tiles = -(-n // T)
    b_flops, c_flops = reduced_cr_flops(tiles), FLOPS_SUBSTITUTE * n

    def bound(nbytes, flops):
        tb, tf = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F64_FLOPS * 1e3
        return max(tb, tf), "bytes" if tb >= tf else "operations"

    return dict(whole=bound(8 * 16 * n, FLOPS_THOMAS * n),
                stage_b=bound(8 * 24 * tiles, b_flops),
                stage_c=bound(8 * (12 * n + 4 * tiles), c_flops))


def dense_reduced_system(Lc, Uc, r):
    """The reduced system of ``tiled_pcr.reduced_rows`` as one dense
    ``[4 n, 4 n]`` matrix and its right-hand side ``[4 n]``."""
    m = r.shape[0]
    A = torch.eye(4 * m, dtype=r.dtype, device=r.device)
    t = torch.arange(m, device=r.device)
    rows = (4 * t[:, None] + torch.arange(4, device=r.device))[:, :, None]   # [m, 4, 1]
    two = torch.arange(2, device=r.device)
    A[rows[1:], (4 * (t[1:] - 1) + 2)[:, None, None] + two] = Lc[1:]      # x_last of tile t-1
    A[rows[:-1], (4 * (t[:-1] + 1))[:, None, None] + two] = Uc[:-1]       # x_first of tile t+1
    return A, r.reshape(-1)


def drive_long_reach(dev, launches: dict) -> tuple[list, dict]:
    """The long-reach main path: ``simulate(linear_solver="cuda_tiled")`` at
    each of LONG_REACH_NODES against the same run with ``"pcr"`` (in turns:
    tiled, pcr, tiled, pcr -- the host's clock moves them by tens of per
    cent), and one solve stage by stage, each stage's kernel against its
    plain version and timed with CUDA events, at each tile of TILED_TILES.
    Returns the per-size records and the figures of the largest size for the
    kernel table."""
    from flowsim_tpu_torch.ops import preissmann as prs
    from flowsim_tpu_torch.ops.cuda import tiled_pcr

    records, table = [], {}
    for n in LONG_REACH_NODES:
        geo, us, ds, h0, Q0, sset = build_long_reach(n, dev, levels=8, linear_solver="cuda_tiled")
        runs = {"cuda_tiled": [], "pcr": []}
        for solver in ("cuda_tiled", "pcr", "cuda_tiled", "pcr"):
            for c in TILED_COUNTERS:
                setattr(tiled_pcr, c, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = prs.simulate(geo, us, ds, h0, Q0, dataclasses.replace(sset, linear_solver=solver))
            torch.cuda.synchronize()
            runs[solver].append((time.perf_counter() - t0) * 1e3)
            if solver == "cuda_tiled":
                out_t, counts = out, {c: getattr(tiled_pcr, c) for c in TILED_COUNTERS}
            else:
                out_p = out
        cmp = compare_runs(out_t, out_p, f"long reach N={n}, cuda_tiled vs pcr")
        if any(v != cmp["iterations"] for v in counts.values()) or cmp["iterations"] == 0:
            raise AssertionError(f"long reach N={n}: launches {counts} for {cmp['iterations']} iterations")
        if out_t.depth.shape != (sset.n_time_levels, n):
            raise AssertionError(f"long reach N={n}: depth has shape {tuple(out_t.depth.shape)}")
        tiled_ms, pcr_ms = min(runs["cuda_tiled"]), min(runs["pcr"])

        # one solve, stage by stage, on the first Newton system of level 1
        prev = prs.prev_level_state(geo, h0, Q0)
        L, D, U, b, *_ = prs.assemble(geo, us, ds, sset, prev, h0, Q0, 1)
        x_plain = tiled_pcr.tiled_spike_plain(L, D, U, b)
        scale = float(x_plain.abs().max())
        per_tile = {}
        for tile in TILED_TILES:
            T, n_tiles = tiled_pcr._tiling(n, tile)
            G, V, W, R = tiled_pcr.stage_a(L, D, U, b, T)
            R0 = R.clone()
            y = tiled_pcr.stage_b(R)
            y_plain = tiled_pcr.stage_b_plain(G, V, W, T)
            x = tiled_pcr.stage_c(G, V, W, y, T)
            x_c_plain = tiled_pcr.stage_c_plain(G, V, W, y, T)
            x_solve = tiled_pcr.tiled_spike_solve(L, D, U, b, tile=T)
            x_tile_plain = tiled_pcr.tiled_spike_plain(L, D, U, b, tile=T)
            errs = dict(stage_b=float((y - y_plain).abs().max()),
                        stage_c=float((x - x_c_plain).abs().max()),
                        whole=float((x_solve - x_tile_plain).abs().max()),
                        whole_vs_default_tile=float((x_solve - x_plain).abs().max()))
            y_scale, x_scale = float(y_plain.abs().max()), float(x_c_plain.abs().max())
            if not (errs["stage_b"] <= TILED_REL_TOL * y_scale and errs["stage_c"] <= TILED_REL_TOL * x_scale
                    and errs["whole"] <= TILED_REL_TOL * scale and errs["whole_vs_default_tile"] <= 1e-9 * scale):
                raise AssertionError(f"long reach N={n}, tile {T}: kernels differ from their plain versions: {errs}")
            Rw = torch.empty_like(R0)
            a_ms = time_cuda(lambda: tiled_pcr.stage_a(L, D, U, b, T), reps=50)
            # stage B overwrites its rows: a fresh copy each time, its own time taken off
            copy_ms = time_cuda(lambda: Rw.copy_(R0), reps=50)
            b_ms = time_cuda(lambda: tiled_pcr.stage_b(Rw.copy_(R0)), reps=50) - copy_ms
            c_ms = time_cuda(lambda: tiled_pcr.stage_c(G, V, W, y, T), reps=50)
            solve_ms = time_cuda(lambda: tiled_pcr.tiled_spike_solve(L, D, U, b, tile=T), reps=50)
            per_tile[T] = dict(tile=T, tiles=n_tiles, solve_ms=solve_ms, stage_a_ms=a_ms, stage_b_ms=b_ms,
                               stage_c_ms=c_ms, max_abs_err=errs,
                               bounds={k: v[0] for k, v in tiled_bounds(n, T).items()})
            if T == tiled_pcr._tiling(n, tiled_pcr.DEFAULT_TILE)[0]:
                main = dict(per_tile[T], y=y, G=G, V=V, W=W, T=T)
        T = main["T"]
        plain_ms = statistics.median(wall_ms(lambda: tiled_pcr.tiled_spike_plain(L, D, U, b)) for _ in range(2))
        G, V, W, y = main["G"], main["V"], main["W"], main["y"]
        b_plain_ms = statistics.median(wall_ms(lambda: tiled_pcr.stage_b_plain(G, V, W, T)) for _ in range(3))
        c_plain_ms = time_cuda(lambda: tiled_pcr.stage_c_plain(G, V, W, y, T), reps=10)
        # stage B's yardstick: one dense torch.linalg.solve of the reduced system
        A_red, r_red = dense_reduced_system(*tiled_pcr.reduced_rows(G, V, W, T))
        b_lib_ms = time_cuda(lambda: torch.linalg.solve(A_red, r_red), reps=3, warmup=1)
        b_lib_err = float((torch.linalg.solve(A_red, r_red).reshape(-1, 4) - y).abs().max())
        del A_red
        pcr_solve_ms = time_cuda(lambda: prs.tridiag.block_pcr(L, D, U, b), reps=3, warmup=1)
        for c, v in counts.items():   # the timing launches above are not the main path's
            setattr(tiled_pcr, c, v)
        bounds = tiled_bounds(n, T)
        rec = dict(n_nodes=n, tile=T, tiles=main["tiles"], launches=counts,
                   iterations_per_level=out_t.iterations.tolist(), wall_ms=tiled_ms, wall_ms_pcr=pcr_ms,
                   wall_ms_runs=runs["cuda_tiled"], wall_ms_runs_pcr=runs["pcr"],
                   newton_node_updates_per_s=n * cmp["iterations"] / (tiled_ms * 1e-3),
                   newton_node_updates_per_s_pcr=n * cmp["iterations"] / (pcr_ms * 1e-3),
                   solve_ms=main["solve_ms"], stage_a_ms=main["stage_a_ms"], stage_b_ms=main["stage_b_ms"],
                   stage_c_ms=main["stage_c_ms"], plain_solve_ms=plain_ms, stage_b_plain_ms=b_plain_ms,
                   stage_c_plain_ms=c_plain_ms, block_pcr_solve_ms=pcr_solve_ms,
                   stage_b_library_ms=b_lib_ms, stage_b_library_max_abs_diff=b_lib_err,
                   bound_ms=bounds["whole"][0], bound_by=bounds["whole"][1],
                   tiles_tried=list(per_tile.values()), **cmp)
        records.append(rec)
        table = dict(rec, max_abs_err=main["max_abs_err"], bounds=bounds)
        del out_t, out_p, out, L, D, U, b, G, V, W, R, R0, Rw, y, x, x_plain, main, per_tile
        torch.cuda.empty_cache()
    launches["tiled_spike_solve"] = table["launches"]["launch_count"]
    launches["tiled_spike_reduced"] = table["launches"]["stage_b_launch_count"]
    launches["tiled_spike_substitute"] = table["launches"]["stage_c_launch_count"]
    return records, table


def drive_reservoir(dev) -> dict:
    """The reservoir main path: the shipped example (a flood wave routed into
    a lumped storage) through ``models.example.build`` and ``solver.run``,
    ``engine="fused"`` against ``engine="plain"``, all 24 levels; and the
    same reservoir with a fitted power outflow rating
    (:func:`example_with_rating`)."""
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
    rated, _ = example_with_rating(dev)
    out_r = rated.run(engine="fused", max_iter=100, verbose=0)
    rated_stage = out_r.reservoir_stage
    power = dict(compare_runs(out_r, rated.run(engine="plain", max_iter=100, verbose=0),
                              "reservoir example with a fitted power rating"),
                 rating=dict(kind=rated.ds_params.storage.rating.kind,
                             a_b=rated.ds_params.storage.rating.coeffs.tolist()),
                 peak_stage=float(rated_stage[1:].max()), peak_stage_unrated=float(stage[1:].max()))
    if not float(rated_stage[1:].max()) < float(stage[1:].max()):
        raise AssertionError("the rated reservoir peaks no lower than the unrated one")
    return dict(n_nodes=21, n_time_levels=25, launches=count, kernel_ms=kernel_ms, plain_ms=plain_ms,
                iterations_per_level=out_k.iterations.tolist(), reservoir_stage=stage[1:].tolist(),
                peak_stage=float(stage[1:].max()), peak_inflow=float(out_k.flow[:, 0].max()),
                peak_flow_into_reservoir=float(out_k.flow[:, -1].max()), fitted_power_rating=power, **cmp)


def example_with_rating(dev):
    """The shipped example (``models.example.build``) with an outflow rating
    on its reservoir, fitted through the api (``RatingCurve.fit(...,
    type="power")`` on ``api.LumpedStorage``): Q = 30 (Y / 5)^1.5 m^3/s
    sampled at stages 5-70 m.  Returns (solver, channel)."""
    from flowsim_tpu_torch import api
    from flowsim_tpu_torch.models import example

    stages = np.linspace(5.0, 70.0, 14)
    rating = api.RatingCurve()
    rating.fit(30.0 * (stages / 5.0) ** 1.5, stages, type="power")
    us = api.Boundary(condition="flow_hydrograph", bed_level=5, chainage=0,
                      hydrograph=api.Hydrograph(function=example.trapezoid_hydrograph))
    ds = api.Boundary(condition="fixed_depth", initial_depth=5, bed_level=0, chainage=20000)
    ds.set_lumped_storage(api.LumpedStorage(surface_area=5000 * 250, min_stage=5, solution_boundaries=(0, 200),
                                            rating_curve=rating))
    channel = api.Channel(width=250, initial_flow=example.trapezoid_hydrograph(0), roughness=0.027,
                          upstream_boundary=us, downstream_boundary=ds)
    solver = api.PreissmannSolver(channel=channel, theta=0.8, time_step=3600, spatial_step=1000,
                                  simulation_time=24 * 3600, device=dev)
    return solver, channel


def roofline(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time of a function on the card: (ms, "bytes" / "operations")
    from its bytes over PEAK_BYTES_PER_S and its float64 operations over
    PEAK_F64_FLOPS, the larger of the two."""
    tb, tf = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F64_FLOPS * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def same_stages(a, b, what: str) -> None:
    """Reservoir stages bit for bit, NaN at the same places."""
    for f in ("reservoir_stage", "reservoir_stage_us"):
        x, y = getattr(a, f), getattr(b, f)
        if not (torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(), y.nan_to_num())):
            raise AssertionError(f"{what}: {f} is not bit-identical")


def check_long_build(dev) -> dict:
    """Kernel 1's long build, its reach build (16 blocks) and its cluster
    build (2 blocks) forced at N <= 964, against its register build, bit for
    bit (depth,
    flow, error, iterations, converged, gate, reservoir stages): the
    flagship (N = 121, 25 levels),
    the flagship with lateral inflow per level and store="boundaries" (13
    levels), the flagship at spatial_step=125 (N = 964, 13 levels), four
    storage cases (12 levels), the scaling reach on lookup tables (N = 121
    and 964, M = 32, 8 levels), and kernel 3 on 4 flagship members; the two
    builds timed in turns on the flagship cases.  Counts no launch."""
    from flowsim_tpu_torch.models.gerd_roseires import model
    from flowsim_tpu_torch.ops.cuda import fused_newton as fn
    from flowsim_tpu_torch.parallel import ensemble

    cases = {}
    s, c = model.build(device=dev, sim_duration=3600 * 24)
    flag = (c.geometry, s.us_params, s.ds_params, s.h0, s.Q0, s.settings(tolerance=1e-6, max_iter=100))
    cases["flagship_n121_25_levels"] = flag
    s13, _ = model.build(device=dev, sim_duration=3600 * 12)
    rng = np.random.default_rng(7)
    q_level = torch.tensor(rng.uniform(0.0, 2e-3, (13, 121)), dtype=torch.float64, device=dev)
    cases["inflow_per_level_store_boundaries_13_levels"] = (
        *cut_levels(flag, 13)[:5], dataclasses.replace(cut_levels(flag, 13)[5], store="boundaries"), q_level)
    s964, c964 = model.build(device=dev, sim_duration=3600 * 12, spatial_step=125.0)
    cases[f"flagship_n{s964.number_of_nodes}_13_levels"] = (
        c964.geometry, s964.us_params, s964.ds_params, s964.h0, s964.Q0, s964.settings(tolerance=1e-6, max_iter=100))
    for name in ("ds_curve_rating_losses", "ds_power_losses", "us_table", "both_poly_n"):
        cases["storage_" + name] = build_storage_case(name, dev)
    for n in (121, fn.MAX_N):   # the scaling reach on lookup tables, 8 levels
        args = build_long_reach(n, dev)
        cases[f"table_n{n}_m{LONG_TABLE_SAMPLES}_8_levels"] = (as_table(args[0], samples=LONG_TABLE_SAMPLES),
                                                                *args[1:])
    out = {}
    for name, args in cases.items():
        packed = pack_one(*args)
        reg = fn.launch(*packed, build_id=fn.REGISTER_BUILD)
        lng = fn.launch(*packed, build_id=fn.LONG_BUILD)
        same_bits(lng, reg, f"long vs register build, {name}")
        same_stages(lng, reg, f"long vs register build, {name}")
        clu = fn.launch(*packed, build_id=fn.CLUSTER_BUILD)
        same_bits(clu, reg, f"cluster vs register build, {name}")
        same_stages(clu, reg, f"cluster vs register build, {name}")
        rch = fn.launch(*packed, build_id=fn.REACH_BUILD)
        same_bits(rch, reg, f"reach vs register build, {name}")
        same_stages(rch, reg, f"reach vs register build, {name}")
        if not bool(lng.converged.all()):
            raise AssertionError(f"{name}: not converged")
        n = int(args[3].shape[0])
        out[name] = dict(n_nodes=n, levels=int(lng.iterations.shape[1]), iterations=int(lng.iterations.sum()),
                         cluster_blocks=fn.cluster_blocks(n), reach_blocks=fn.REACH_RANKS, bit_identical=True)
        if name.startswith("flagship"):   # the two builds on the same launch, by CUDA events, in turns
            ids = dict(register_build=fn.REGISTER_BUILD, long_build=fn.LONG_BUILD)
            runs = {b: [] for b in ids}
            for b in ("register_build", "long_build", "long_build", "register_build"):
                runs[b].append(time_cuda(lambda: fn.launch(*packed, build_id=ids[b]), reps=3, warmup=3))
            out[name].update({f"{b}_ms_runs": v for b, v in runs.items()})
    geob = ensemble.roughness_ensemble(c.geometry, [0.026, 0.030, 0.036, 0.044])
    reg = batched_launch(geob, s.us_params, s.ds_params, s.h0, s.Q0, flag[5], fn.REGISTER_BUILD)
    lng = batched_launch(geob, s.us_params, s.ds_params, s.h0, s.Q0, flag[5], fn.LONG_BUILD)
    same_bits(lng, reg, "kernel 3: long vs register build")
    same_bits(batched_launch(geob, s.us_params, s.ds_params, s.h0, s.Q0, flag[5], fn.CLUSTER_BUILD), reg,
              "kernel 3: cluster vs register build")
    same_bits(batched_launch(geob, s.us_params, s.ds_params, s.h0, s.Q0, flag[5], fn.REACH_BUILD), reg,
              "kernel 3: reach vs register build (a cluster a member)")
    out["batched_4x25"] = dict(members=4, iterations=int(lng.iterations.sum()), bit_identical=True)
    return out


def long_kernel_builds(ptxas: list) -> list:
    """Registers and spills of fused_newton.cu's long and cluster builds, by
    template arguments (storage rows, table geometry; the cluster build's
    probe); the reach build's: :func:`reach_kernel_builds`."""
    out = []
    for rec in ptxas:
        m = re.search(r"fused_(long|cluster)_kernelILb([01])ELb([01])E(?:Lb([01])E)?", rec["kernel"])
        if m:
            out.append(dict(build=m.group(1), storage=m.group(2) == "1", table=m.group(3) == "1",
                            **({"probe": m.group(4) == "1"} if m.group(1) == "cluster" else {}),
                            **{k: rec.get(k) for k in ("registers", "stack_bytes", "spill_store_bytes",
                                                       "spill_load_bytes")}))
    return out


def long_builds_in_turns(dev, geob, us, ds, h0, Q0, sset, chosen_out) -> dict:
    """Kernel 3's builds for the long ensemble on the same packed members:
    the cluster build and the long build (a block and a scratch a member),
    each held to the other's bits and the chosen one to the main path's run;
    then by CUDA events in turns (cluster, long, long, cluster), three
    readings a turn (:func:`readings`), each build's median.  Fails unless
    the chosen build is the faster: its median no more than the spread of
    its readings above the other's.  Each build's plan (grid, cluster) is
    held against the wrapper's pure reckoning (``fused_newton.launch_grid``,
    ``cluster_blocks``), and the state each holds is reported: the scratch
    it allocates, or the shared memory of the clusters of its grid."""
    from flowsim_tpu_torch.ops.cuda import fused_newton as fn

    n_members, n = geob.z_bed.shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    packed = batched_packed(geob, us, ds, h0, Q0, sset)
    ids = dict(cluster_build=fn.CLUSTER_BUILD, long_build=fn.LONG_BUILD)
    chosen = KERNEL1_BUILD_NAMES[fn.chosen_build(n_members, n)]
    outs = {b: fn.launch(*packed, build_id=i) for b, i in ids.items()}
    same_bits(outs["cluster_build"], outs["long_build"], "long ensemble: cluster vs long build")
    same_bits(chosen_out, outs[chosen], f"long ensemble: the main path's run vs the {chosen} forced")
    cluster_out = outs["cluster_build"]
    del outs
    rec = dict(chosen_build=chosen, bits="every field of every build")
    for b, i in ids.items():
        build_id, grid, cluster = fn.plan(n_members, n, False, False, i)
        clusters = grid // cluster if i == fn.CLUSTER_BUILD else None
        mirror = fn.launch_grid(i, n_members, n, sms, clusters_at_once=clusters)
        if build_id != i or mirror != grid or (i == fn.CLUSTER_BUILD and (cluster != fn.cluster_blocks(n)
                                                                          or clusters > sms // cluster)):
            raise AssertionError(f"{b}: the C entry launches grid {grid}, cluster {cluster}; the wrapper's "
                                 f"reckoning gives grid {mirror}, cluster {fn.cluster_blocks(n)}")
        state = (grid * fn.rank_nodes(n, cluster) * fn.CLUSTER_BYTES_PER_NODE if i == fn.CLUSTER_BUILD
                 else fn.scratch_bytes(grid, n))
        rec[b] = dict(grid=grid, cluster_blocks=cluster, clusters_at_once=clusters, ms_runs=[],
                      state_bytes=state, state_in="shared memory" if i == fn.CLUSTER_BUILD else "scratch")
    for b in ("cluster_build", "long_build", "long_build", "cluster_build"):
        rec[b]["ms_runs"] += readings(lambda: fn.launch(*packed, build_id=ids[b]))
    for b in ids:
        rec[b]["ms"] = statistics.median(rec[b]["ms_runs"])
    rec["fastest_build"] = min(ids, key=lambda b: rec[b]["ms"])
    spread = max(rec[chosen]["ms_runs"]) - min(rec[chosen]["ms_runs"])
    if rec[chosen]["ms"] > rec[rec["fastest_build"]]["ms"] + spread:
        raise AssertionError(f"long ensemble: the C entry chooses the {chosen} ({rec[chosen]['ms']:.3f} ms), "
                             f"slower than the {rec['fastest_build']} ({rec[rec['fastest_build']]['ms']:.3f} ms) "
                             f"by more than its spread ({spread:.3f} ms)")
    # the cluster build's probe build: thread 0 of rank 0 of the first
    # cluster, over the members that cluster runs
    cycles = torch.zeros(len(fn.PROBE_PHASES), dtype=torch.int64, device=dev)
    clock = ctypes.c_int(0)
    po = fn.launch(*packed, build_id=fn.CLUSTER_BUILD, probe=(cycles, clock))
    same_bits(po, cluster_out, "long ensemble: the cluster build's probe build")
    its = int(po.iterations[::rec["cluster_build"]["clusters_at_once"]].sum())
    rec["cluster_build"]["probe_rank_0_of_cluster_0"] = dict(
        probe_record(dict(zip(fn.PROBE_PHASES, cycles.tolist())), clock.value, its, rec["cluster_build"]["ms"]),
        members=len(range(0, n_members, rec["cluster_build"]["clusters_at_once"])))
    del cluster_out, po
    # the cluster of every long shape the card runs, as the wrapper reckons it
    rec["cluster_blocks_by_n"] = {}
    for nn in (fn.MAX_N + 1, 2048, 2409, 4096, 8192):
        cl = fn.plan(2, nn, False, False, fn.CLUSTER_BUILD)[2]
        if cl != fn.cluster_blocks(nn):
            raise AssertionError(f"N={nn}: the C entry's cluster has {cl} blocks, cluster_blocks says "
                                 f"{fn.cluster_blocks(nn)}")
        rec["cluster_blocks_by_n"][nn] = cl
    return rec


def single_builds_in_turns(dev, cases: dict, main_outs: dict) -> dict:
    """Kernel 1's single launches of 965-8192 nodes: the reach build the C
    entry takes against the long build and the batch's cluster build, both
    forced, bit for bit (and the reach build against ``main_outs``, the main
    path's run of the case, where given), then by CUDA events in turns
    (reach, cluster, long, long, cluster, reach), three readings a turn
    (:func:`readings`), each build's median.  Fails unless the reach build
    is the fastest."""
    from flowsim_tpu_torch.ops.cuda import fused_newton as fn

    ids = dict(reach_build=fn.REACH_BUILD, cluster_build=fn.CLUSTER_BUILD, long_build=fn.LONG_BUILD)
    out = {}
    for name, args in cases.items():
        packed = pack_one(*args)
        n = int(args[3].shape[0])
        build_id, grid, cluster = fn.plan(1, n)
        if (build_id, grid, cluster) != (fn.REACH_BUILD, fn.launch_grid(fn.REACH_BUILD, 1, n, 0), fn.REACH_RANKS):
            raise AssertionError(f"{name}: the C entry launches build {build_id}, grid {grid}, cluster {cluster}; "
                                 f"the wrapper's reckoning: the reach build over {fn.REACH_RANKS} blocks")
        outs = {b: fn.launch(*packed, build_id=i) for b, i in ids.items()}
        for b in ("cluster_build", "long_build"):
            same_bits(outs["reach_build"], outs[b], f"{name}: reach vs {b}")
            same_stages(outs["reach_build"], outs[b], f"{name}: reach vs {b}")
        if name in main_outs:
            same_bits(main_outs[name], prs_out_member(outs["reach_build"], 0),
                      f"{name}: the main path's run vs the reach build")
        iterations = int(outs["reach_build"].iterations.sum())
        del outs
        runs = {b: [] for b in ids}
        for b in ("reach_build", "cluster_build", "long_build", "long_build", "cluster_build", "reach_build"):
            runs[b] += readings(lambda: fn.launch(*packed, build_id=ids[b]))
        rec = dict(n_nodes=n, iterations=iterations, reach_blocks=fn.REACH_RANKS, reach_lanes=fn.reach_lanes(n),
                   cluster_blocks=fn.cluster_blocks(n), bits="every field of the three builds",
                   **{f"{b}_ms_runs": v for b, v in runs.items()},
                   **{f"{b}_ms": statistics.median(v) for b, v in runs.items()})
        rec["reach_us_per_newton_iteration"] = rec["reach_build_ms"] * 1e3 / iterations
        if rec["reach_build_ms"] >= min(rec["cluster_build_ms"], rec["long_build_ms"]):
            raise AssertionError(f"{name}: the reach build ({rec['reach_build_ms']:.3f} ms) is not faster than the "
                                 f"cluster ({rec['cluster_build_ms']:.3f}) and the long build "
                                 f"({rec['long_build_ms']:.3f}) in turns")
        out[name] = rec
    return out


def refused_launches(dev, refused_n_8193: str) -> dict:
    """The launches refused by name: N = 8193 (by the wrapper); the builds
    forced where they do not apply (the bracket and the lean build on
    trapezoids, a probe of the cluster or the reach build on tables, a probe
    of the long build), by the C
    entry's own rules through ``fused_newton.plan`` before anything is
    allocated, and the plan of the bracket build on trapezoids asked of it
    directly."""
    from flowsim_tpu_torch.models.gerd_roseires import model
    from flowsim_tpu_torch.ops.cuda import fused_newton as fn

    out = dict(n_8193=refused_n_8193)
    s, c = model.build(device=dev, sim_duration=3600 * 2)
    args = (c.geometry, s.us_params, s.ds_params, s.h0, s.Q0, s.settings(tolerance=1e-6, max_iter=100))
    packed = pack_one(*args)
    tpacked = pack_one(as_table(c.geometry, samples=32), *args[1:])
    probe = (torch.zeros(len(fn.PROBE_PHASES), dtype=torch.int64, device=dev), ctypes.c_int(0))
    for name, pk, kw in (("bracket_build_on_trapezoids", packed, dict(build_id=fn.BRACKET_BUILD)),
                         ("lean_build_on_trapezoids", packed, dict(build_id=fn.LEAN_BUILD)),
                         ("cluster_build_probe_on_tables", tpacked, dict(build_id=fn.CLUSTER_BUILD, probe=probe)),
                         ("reach_build_probe_on_tables", tpacked, dict(build_id=fn.REACH_BUILD, probe=probe)),
                         ("long_build_probe", packed, dict(build_id=fn.LONG_BUILD, probe=probe))):
        try:
            fn.launch(*pk, **kw)
        except fn.FusedUnsupported as e:
            if fn.BUILD_NAMES[kw["build_id"]] not in str(e):
                raise AssertionError(f"{name}: the refusal does not name the build: {e}")
            out[name] = str(e)
        else:
            raise AssertionError(f"{name}: launched")
    try:
        fn.plan(1, 121, False, False, fn.BRACKET_BUILD)
    except fn.FusedUnsupported as e:
        if "bracket build" not in str(e):
            raise AssertionError(f"the C entry's refusal does not name the build: {e}")
        out["c_entry_bracket_build_on_trapezoids"] = str(e)
    else:
        raise AssertionError("the C entry planned the bracket build on trapezoids")
    return out


def drive_long_fused(dev, launches: dict) -> tuple[dict, list]:
    """Reaches of 965-8192 nodes through kernels 1 and 3: the main path — the
    flagship at 50 m through ``api.PreissmannSolver.run(engine="fused")`` (385
    levels), the scaling reach at N = 2048 / 4096 / 8192 through
    ``fused_simulate`` (each one launch of the reach build) and 1024 members
    of the N = 2048 reach through ``batched_simulate(engine="fused",
    store="boundaries")`` (the cluster build) — with the counts set to 0 just
    before and read just after; then each held against the plain engine (the
    flagship on its first 25 levels, the reaches on all 8, members 0 and
    1023), 4 members (the cluster build) against single launches (the reach
    build) bit for bit, the builds of the ensemble in turns
    (:func:`long_builds_in_turns`), the N = 2048 reach on lookup tables, the
    long, reach and cluster builds forced at N <= 964 against the register
    build (:func:`check_long_build`), the reach build against the long and
    the cluster build forced on the single launches, in turns
    (:func:`single_builds_in_turns`), the reach build's probe build, the
    times and the refusals (:func:`refused_launches`).  Returns (record,
    kernel rows)."""
    from flowsim_tpu_torch import trees
    from flowsim_tpu_torch.models.gerd_roseires import model
    from flowsim_tpu_torch.ops.cuda import build, fused_batched
    from flowsim_tpu_torch.ops.cuda import fused_newton as fn
    from flowsim_tpu_torch.parallel import ensemble

    t0 = time.perf_counter()
    s50, c50 = model.build(device=dev, spatial_step=LONG_FLAGSHIP_STEP)
    flagship_build_s = time.perf_counter() - t0
    reaches = {n: build_long_reach(n, dev) for n in LONG_FUSED_NODES}
    geo, us, ds, h0, Q0, sset = build_long_reach(LONG_ENSEMBLE_NODES, dev)
    sset_b = dataclasses.replace(sset, store="boundaries")
    B = LONG_ENSEMBLE_MEMBERS
    geob = ensemble.roughness_ensemble(geo, np.linspace(*LONG_ENSEMBLE_N_RANGE, B))

    def run_ensemble(members=B):
        return ensemble.batched_simulate(trees.slice_members(geob, 0, members), us, ds, h0, Q0, sset_b,
                                         engine="fused")

    # -- the main path: counts to 0, drive, read the counts
    fn.launch_count = fn.long_launch_count = fn.reach_launch_count = 0
    fused_batched.launch_count = fused_batched.long_launch_count = fused_batched.cluster_launch_count = 0
    unconverged = None
    try:
        out50 = s50.run(engine="fused", tolerance=1e-6, verbose=0)
    except ValueError as e:
        # the api refuses a run that did not converge at some level; the
        # launch happened (the counts below say so) and its output is kept
        unconverged, out50 = str(e), s50.output
    outs = {n: fn.fused_simulate(*reaches[n]) for n in LONG_FUSED_NODES}
    out_e = run_ensemble()
    torch.cuda.synchronize()
    launches["fused_simulate_long"] = fn.long_launch_count
    launches["fused_simulate_reach"] = fn.reach_launch_count
    launches["fused_simulate_batched_long"] = fused_batched.long_launch_count
    launches["fused_simulate_batched_cluster"] = fused_batched.cluster_launch_count
    if (fn.launch_count, fn.long_launch_count, fn.reach_launch_count) != (1 + len(LONG_FUSED_NODES),) * 3 \
            or (fused_batched.launch_count, fused_batched.long_launch_count) != (1, 1) \
            or fused_batched.cluster_launch_count != 1:
        raise AssertionError(f"long reaches: of {fn.launch_count} single launches {fn.long_launch_count} took a "
                             f"long-reach build, {fn.reach_launch_count} the reach build, expected "
                             f"{1 + len(LONG_FUSED_NODES)} each; of {fused_batched.launch_count} batched launches "
                             f"{fused_batched.long_launch_count} a long-reach build, "
                             f"{fused_batched.cluster_launch_count} the cluster build, expected 1 each")

    # -- the flagship at 50 m: all 385 levels, the plain engine on the first 25
    n50, nt50 = s50.number_of_nodes, s50.number_of_time_levels
    if out50.depth.shape != (nt50, n50) or not bool(torch.isfinite(out50.depth).all()):
        raise AssertionError(f"flagship at {LONG_FLAGSHIP_STEP} m: output of the wrong shape or not finite")
    args50 = (c50.geometry, s50.us_params, s50.ds_params, s50.h0, s50.Q0, s50.settings(tolerance=1e-6, max_iter=100))
    again = {}
    ms50 = wall_ms(lambda: again.update(out=fn.fused_simulate(*args50)))
    if not (torch.equal(again["out"].depth, out50.depth) and torch.equal(again["out"].iterations, out50.iterations)):
        raise AssertionError("flagship at 50 m: fused_simulate differs from the api's run")
    it50 = int(out50.iterations.sum())
    cut50 = cut_levels(args50, LONG_FLAGSHIP_PLAIN_LEVELS)
    out_c = fn.fused_simulate(*cut50)
    t0 = time.perf_counter()
    out_cp = fn.fused_simulate_plain(*cut50)
    torch.cuda.synchronize()
    flagship = dict(n_nodes=n50, spatial_step=LONG_FLAGSHIP_STEP, n_time_levels=nt50,
                    host_build_seconds=flagship_build_s, levels_converged=int(out50.converged.sum()),
                    api_unconverged=unconverged,
                    total_iterations=it50, max_iterations_in_a_level=int(out50.iterations.max()),
                    wall_ms=ms50, us_per_newton_iteration=ms50 * 1e3 / it50,
                    plain_compared=dict(compare_runs(out_c, out_cp, "flagship at 50 m vs plain"),
                                        plain_ms=(time.perf_counter() - t0) * 1e3))
    if not torch.equal(out_c.depth, out50.depth[:LONG_FLAGSHIP_PLAIN_LEVELS]):
        raise AssertionError("flagship at 50 m: the first 25 levels of the api run differ from the cut run")

    # -- the scaling reach at N = 2048 / 4096 / 8192, 8 levels, against the plain engine
    reach_recs, rows = {}, {}
    for n, args in reaches.items():
        t0 = time.perf_counter()
        out_p = fn.fused_simulate_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        rec = compare_runs(outs[n], out_p, f"long reach N={n}")
        packed = pack_one(*args)
        ms = time_cuda(lambda: fn.launch(*packed), reps=5, warmup=3)
        reach_recs[f"n_{n}"] = dict(rec, kernel_ms=ms, us_per_newton_iteration=ms * 1e3 / rec["iterations"],
                                    plain_ms=plain_ms, chosen_build=KERNEL1_BUILD_NAMES[fn.chosen_build(1, n)],
                                    shared_memory_bytes=fn.REACH_RANKS * fn.reach_rank_nodes(n)
                                    * fn.REACH_BYTES_PER_NODE)
    # on lookup tables: the N = 2048 reach's two end sections sampled at M = 32
    t0 = time.perf_counter()
    tg = as_table(reaches[LONG_TABLE_NODES][0], samples=LONG_TABLE_SAMPLES)
    table_host_s = time.perf_counter() - t0
    targs = (tg, *reaches[LONG_TABLE_NODES][1:])
    out_t = fn.fused_simulate(*targs)
    tpacked = pack_one(*targs)
    table_rec = dict(compare_runs(out_t, fn.fused_simulate_plain(*targs), "long table reach"),
                     n_nodes=LONG_TABLE_NODES, samples=LONG_TABLE_SAMPLES, host_table_build_seconds=table_host_s,
                     kernel_ms=time_cuda(lambda: fn.launch(*tpacked), reps=5, warmup=3))

    # -- the ensemble: timed, 4 members against single launches, 2 against the plain engine
    if out_e.depth.shape != (B, sset.n_time_levels, 2) or not bool(out_e.converged.all()) \
            or not bool(torch.isfinite(out_e.depth).all()):
        raise AssertionError("long ensemble: wrong shape, not converged or not finite")
    ens_runs = [wall_ms(run_ensemble) for _ in range(3)]
    ens_ms = statistics.median(ens_runs)
    ens_iters = int(out_e.iterations.sum())
    # single launches take the reach build, a batch the cluster build
    singles = [fn.fused_simulate(trees.member(geob, m), us, ds, h0, Q0, sset_b) for m in range(LONG_BIT_MEMBERS)]
    bits = compare_members(run_ensemble(LONG_BIT_MEMBERS), singles, "long ensemble vs single launches", exact=True)
    bits["chosen_build"] = KERNEL1_BUILD_NAMES[fn.chosen_build(LONG_BIT_MEMBERS, LONG_ENSEMBLE_NODES)]
    builds_rec = long_builds_in_turns(dev, geob, us, ds, h0, Q0, sset_b, out_e)
    picked = [0, B - 1]
    t0 = time.perf_counter()
    plains = [fn.fused_simulate_plain(trees.member(geob, m), us, ds, h0, Q0, sset_b) for m in picked]
    torch.cuda.synchronize()
    ens_plain_ms = (time.perf_counter() - t0) * 1e3
    ens_cmp = compare_members(prs_out_member(out_e, picked), plains, "long ensemble vs plain", exact=False)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bps = fn.resident_blocks(LONG_ENSEMBLE_NODES, False, fn.LONG_BUILD)
    chosen_e = builds_rec["chosen_build"]
    ensemble_rec = dict(members=B, n_nodes=LONG_ENSEMBLE_NODES, n_time_levels=sset.n_time_levels,
                        store="boundaries", launches=1, build=chosen_e, wall_ms_runs=ens_runs,
                        wall_ms_median=ens_ms, simulations_per_s=B / (ens_ms * 1e-3),
                        total_newton_iterations=ens_iters, long_build_resident_blocks_per_sm=bps,
                        multiprocessors=sms, builds=builds_rec, against_single_launches=bits,
                        members_0_and_last_vs_plain=dict(ens_cmp, plain_ms=ens_plain_ms))

    # -- the limits: the build the C entry takes, and N = 8193 refused by name
    for n, want in ((fn.MAX_N, fn.REGISTER_BUILD), (fn.MAX_N + 1, fn.REACH_BUILD), (fn.LONG_MAX_N, fn.REACH_BUILD)):
        if fn.chosen_build(1, n) != want:
            raise AssertionError(f"N={n}: the C entry does not take build {want}")
    try:
        fn.fused_simulate(*build_long_reach(fn.LONG_MAX_N + 1, dev, levels=1))
    except fn.FusedUnsupported as e:
        refused = str(e)
    else:
        raise AssertionError(f"fused_simulate accepted N = {fn.LONG_MAX_N + 1}")
    t0 = time.perf_counter()
    forced = check_long_build(dev)
    forced_s = time.perf_counter() - t0
    singles = single_builds_in_turns(dev, {**{f"n_{n}": reaches[n] for n in LONG_FUSED_NODES}, "flagship_50m": args50},
                                     {f"n_{n}": outs[n] for n in LONG_FUSED_NODES})
    # the reach build's probe build on the flagship at 50 m: thread 0 of rank 0
    cycles = torch.zeros(len(fn.PROBE_PHASES), dtype=torch.int64, device=dev)
    clock = ctypes.c_int(0)
    po = fn.launch(*pack_one(*args50), build_id=fn.REACH_BUILD, probe=(cycles, clock))
    if not (torch.equal(po.depth[0], out50.depth) and torch.equal(po.iterations[0], out50.iterations)):
        raise AssertionError("flagship at 50 m: the reach build's probe build differs from the api's run")
    probe50 = probe_record(dict(zip(fn.PROBE_PHASES, cycles.tolist())), clock.value, it50,
                           singles["flagship_50m"]["reach_build_ms"])
    del po
    record = dict(flagship_50m=flagship, reaches=reach_recs, table_reach=table_rec, ensemble=ensemble_rec,
                  forced_long_reach_and_cluster_builds_vs_register_build=dict(forced, seconds=forced_s),
                  single_launches_reach_vs_cluster_and_long_builds=singles, reach_probe_flagship_50m=probe50,
                  refused=refused_launches(dev, refused),
                  ptxas=long_kernel_builds(build.build_info["fused_newton"]["ptxas"]),
                  ptxas_reach=reach_kernel_builds(build.build_info["fused_newton"]["ptxas"]))

    # -- the kernel rows: kernel 1's long reaches at N = 8192 (the reach build), kernel 3's on the ensemble
    n_par = fn._N_PARAMS
    big = reach_recs[f"n_{max(LONG_FUSED_NODES)}"]
    n, nt = max(LONG_FUSED_NODES), sset.n_time_levels
    b1, by1 = roofline(8 * (13 * n + 2 * n + 2 * nt + n_par) + fn.output_bytes(1, n, nt, "full"),
                       big["iterations"] * n * (FLOPS_ASSEMBLY + FLOPS_THOMAS))
    ne = LONG_ENSEMBLE_NODES
    b3, by3 = roofline(B * 8 * (13 * ne + 2 * ne + 2 * nt + n_par) + fn.output_bytes(B, ne, nt, "boundaries"),
                       ens_iters * ne * (FLOPS_ASSEMBLY + FLOPS_THOMAS))
    tol = dict(depth_m=H_TOL, flow_m3s=Q_TOL, iteration_counts="identical")
    kernels = [
        dict(name="fused_simulate_long", route="cuda", source="flowsim_tpu_torch/ops/cuda/csrc/fused_newton.cu",
             replaces="flowsim_tpu/ops/pallas/fused_newton.py:1413", launches=launches["fused_simulate_long"],
             max_abs_err=max(r["max_abs_dh"] for r in reach_recs.values()), ms=big["kernel_ms"],
             plain_ms=big["plain_ms"], bound_ms=b1, bound_by=by1, library_ms=None, build=big["chosen_build"],
             reach_launches=launches["fused_simulate_reach"],
             ms_by_n={k: r["kernel_ms"] for k, r in reach_recs.items()},
             us_per_newton_iteration_by_n={k: r["us_per_newton_iteration"] for k, r in reach_recs.items()},
             in_turns_ms={k: {b: r[f"{b}_ms"] for b in ("reach_build", "cluster_build", "long_build")}
                          for k, r in singles.items()},
             flagship_50m_wall_ms=ms50,
             shape=dict(n_nodes=n, n_time_levels=nt, newton_iterations=big["iterations"]), tolerance=tol),
        dict(name="fused_simulate_batched_long", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/fused_newton.cu",
             replaces="flowsim_tpu/ops/pallas/fused_newton.py:2269",
             launches=launches["fused_simulate_batched_long"], max_abs_err=ens_cmp["max_abs_dh"], ms=ens_ms,
             plain_ms=ens_plain_ms, bound_ms=b3, bound_by=by3, library_ms=None, build=chosen_e,
             cluster_launches=launches["fused_simulate_batched_cluster"],
             kernel_alone_ms=builds_rec[chosen_e]["ms"], ms_over_bound=ens_ms / b3,
             kernel_alone_ms_by_build={b: r["ms"] for b, r in builds_rec.items() if isinstance(r, dict) and "ms" in r},
             state_bytes={b: r["state_bytes"] for b, r in builds_rec.items()
                                    if isinstance(r, dict) and "ms" in r},
             shape=dict(members=B, n_nodes=ne, n_time_levels=nt, newton_iterations=ens_iters, store="boundaries"),
             plain_shape=dict(members=len(picked), n_nodes=ne, n_time_levels=nt,
                              newton_iterations=ens_cmp["iterations"]),
             tolerance=dict(tol, against_single_launches="bit-identical")),
    ]
    return record, kernels


def compare_networks(kernel_out, ref_out, what: str, exact: bool = False, err_rtol: float | None = None) -> dict:
    """A network run against a reference run: identical per-level iteration
    counts and gate series; depths, flows, junction stages and reservoir
    stages within H_TOL / Q_TOL / NETWORK_Y_TOL / STAGE_TOL, or bit-identical
    (``exact``: the same kernel launched another way; with ``err_rtol`` the
    norm within that relative tolerance, another build that sums it in
    another order)."""
    it_k, it_r = kernel_out.iterations.cpu().tolist(), ref_out.iterations.cpu().tolist()
    if it_k != it_r:
        raise AssertionError(f"{what}: per-level iteration counts differ: {it_k} vs {it_r}")
    if not torch.equal(kernel_out.gate_open, ref_out.gate_open):
        raise AssertionError(f"{what}: gate series differ")
    pairs = list(zip(kernel_out.depth, ref_out.depth)) + list(zip(kernel_out.flow, ref_out.flow)) + [
        (kernel_out.junction_stage, ref_out.junction_stage)] + ([] if err_rtol else [(kernel_out.error, ref_out.error)])
    if exact and err_rtol and not bool(((kernel_out.error - ref_out.error).nan_to_num().abs()
                                        <= err_rtol * ref_out.error.nan_to_num().abs()).all()):
        raise AssertionError(f"{what}: the norms differ by more than {err_rtol} relative")
    if exact:
        same = lambda a, b: torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())
        if not all(same(a, b) for a, b in pairs + [(kernel_out.reservoir_stage, ref_out.reservoir_stage)]):
            raise AssertionError(f"{what}: the fields are not bit-identical")
    dh = max(float((a - b).abs().max()) for a, b in zip(kernel_out.depth, ref_out.depth))
    dq = max(float((a - b).abs().max()) for a, b in zip(kernel_out.flow, ref_out.flow))
    dy = float((kernel_out.junction_stage - ref_out.junction_stage).abs().max())
    dst = stage_diff(kernel_out.reservoir_stage, ref_out.reservoir_stage, what)
    if not (dh <= H_TOL and dq <= Q_TOL and dy <= NETWORK_Y_TOL and dst <= STAGE_TOL):
        raise AssertionError(f"{what}: max|dh|={dh} (tol {H_TOL}), max|dQ|={dq} (tol {Q_TOL}), "
                             f"max|dY|={dy} (tol {NETWORK_Y_TOL}), max|d stage|={dst} (tol {STAGE_TOL})")
    if not bool(kernel_out.converged.all()) or not all(bool(torch.isfinite(h).all()) for h in kernel_out.depth):
        raise AssertionError(f"{what}: kernel run not converged / not finite")
    return dict(levels=len(it_k), iterations=int(sum(it_k)), max_abs_dh=dh, max_abs_dQ=dq, max_abs_dY=dy,
                max_abs_dstage=dst, bit_identical=exact)


def network_setup_ms(branches, n_junctions, settings) -> float:
    """Host time of what ``fused_simulate_network`` does before its launch:
    the input checks and the packing of every branch (median of 3)."""
    from flowsim_tpu_torch.ops import network as net
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet

    def setup():
        net._check_supported(branches, n_junctions, settings)
        topo = fnet.check_supported(branches, n_junctions, settings)
        fnet._pack(branches, n_junctions, settings, [dict() for _ in branches], 1, None, None, None, topo)

    return statistics.median(wall_ms(setup) for _ in range(3))


def network_member(out, m):
    """Member ``m`` of a batched NetworkOutput."""
    return type(out)(*(tuple(x[m] for x in f) if isinstance(f, tuple) else f[m] for f in out))


def scale_inflows(branches, scales) -> list:
    """Per-branch overrides of a network ensemble: every external
    flow-hydrograph upstream end gets its series times the member's scale
    (the ``_scale_us`` of the JAX package's scripts/bench_network_mc.py)."""
    from flowsim_tpu_torch.ops import network as net

    return [dict(us=scaled_inflow(br.us, scales))
            if not net._is_junction(br.us) and br.us.kind == "flow_hydrograph" else dict()
            for br in branches]


NETWORK_CASES = tuple("reservoir_" + k for k in JUNCTION_RATING_KINDS) + (
    "withdrawal", "gated_outlet", "storage_outlet", "lateral_inflow_per_node", "lateral_inflow_per_level")


def build_network_case(name: str, device, sim_hours: float = 2.0):
    """The 7-branch basin of models/basin.py (levels=3: junction 0 drains
    into the outlet reach, junctions 1 and 2 join two headwaters each; 13
    nodes a reach, dt = 900 s) with one of NETWORK_CASES: a junction
    reservoir at junction 1 with a rated release of each junction rating
    kind; a rated withdrawal at the plain junction 0; the outlet through a
    gated rating whose controller opens at level 1, or into a lumped storage;
    lateral inflow per node, or per level and node.  Returns
    (branches, n_junctions, settings, simulate_network keywords)."""
    from flowsim_tpu_torch.models import basin
    from flowsim_tpu_torch.ops import boundary as bnd
    from flowsim_tpu_torch.ops import rating_curve as rcurve
    from flowsim_tpu_torch.ops import storage as stg

    branches, nj, sset = basin.build(levels=3, sim_hours=sim_hours, device=device)
    nt = sset.n_time_levels
    stage_at = lambda b, i: float(branches[b].geo.z_bed[i] + branches[b].h0[i])
    mk = dict(device=device)
    kw = {}
    if name.startswith("reservoir_"):
        y1, z1 = stage_at(1, 0), float(branches[1].geo.z_bed[0])
        rating = {
            "polynomial": lambda: rcurve.make_polynomial(2.0, 15.0, 20.0, stage_shift=-y1, **mk),
            "blended_poly": lambda: rcurve.make_blended_poly([0.0, 10.0, 20.0 - 10.0 * y1],
                                                             [0.0, 14.0, 20.0 - 14.0 * y1],
                                                             pivot_stage=y1 + 0.1, buffer=0.3, **mk),
            "poly_n": lambda: rcurve.make_polynomial_general([20.0, 12.0, 1.5, -0.1], stage_shift=-y1, **mk),
            "power": lambda: rcurve.make_power(20.0, 1.5, stage_shift=-z1, **mk),
            "table": lambda: rcurve.make_table([y1 - 2.0, y1 - 0.5, y1 + 0.5, y1 + 3.0], [0.0, 12.0, 30.0, 90.0],
                                               **mk),
        }[name[len("reservoir_"):]]()
        kw = dict(junction_area=[0.0, 4.0e4, 0.0], junction_rating=[None, rating, None])
    elif name == "withdrawal":
        y0 = stage_at(0, 0)
        kw = dict(junction_rating=[rcurve.make_polynomial(0.0, 5.0, 5.0, stage_shift=-y0, **mk), None, None])
    elif name in ("gated_outlet", "storage_outlet"):
        outlet = branches[0]
        z_ds, y_ds, q_ds = float(outlet.geo.z_bed[-1]), stage_at(0, -1), float(outlet.Q0[-1])
        if name == "gated_outlet":
            gated = rcurve.make_gated_blend([0.0, 150.0, q_ds - 150.0 * y_ds], [0.0, 200.0, q_ds - 200.0 * y_ds],
                                            pivot_stage=y_ds - 0.6, max_cooldown=1800.0, **mk)
            ds = bnd.make_boundary("rating_curve", bed_level=z_ds, rating=gated, **mk)
        else:
            ds = bnd.make_boundary("fixed_depth", bed_level=z_ds, storage=stg.make_storage(
                surface_area=1.0e6, min_stage=y_ds, solution_boundaries=(0.0, 100.0), **mk), **mk)
        branches[0] = dataclasses.replace(outlet, ds=ds)
    elif name.startswith("lateral_inflow"):
        rng = np.random.default_rng(3)
        q = lambda *shape: torch.tensor(rng.uniform(0.0, 2e-3, shape), dtype=torch.float64, device=device)
        n = int(branches[1].h0.shape[0])
        per_level = name.endswith("per_level")
        for b in (1, 3, 6):
            branches[b] = dataclasses.replace(branches[b], qlat=q(nt, n) if per_level and b != 6 else q(n))
    else:
        raise ValueError(f"unknown network case {name!r}; expected one of {NETWORK_CASES}")
    return branches, nj, sset, kw


def storage_outlet_networks(dev, sim_hours: float = 2.0) -> dict:
    """The basin's ``storage_outlet`` case (:func:`build_network_case`) with
    an outflow rating on the outlet's reservoir, one network per kind:
    ``power`` Q = 20 Y^1.5 (Y the stage, 1.57 m at the start), a ``table`` of
    8 breakpoints and a cubic ``poly_n``.  Returns {kind: (branches,
    n_junctions, settings)}."""
    from flowsim_tpu_torch.ops import rating_curve as rcurve
    from flowsim_tpu_torch.ops import storage as stg

    b7, n7, s7, _ = build_network_case("storage_outlet", dev, sim_hours=sim_hours)
    ratings = dict(
        power=rcurve.make_power(20.0, 1.5, device=dev),
        table=rcurve.make_table([0.0, 1.0, 1.5, 2.0, 3.0, 5.0, 10.0, 100.0],
                                [0.0, 10.0, 30.0, 60.0, 140.0, 400.0, 1500.0, 50000.0], device=dev),
        poly_n=rcurve.make_polynomial_general([0.0, 10.0, 8.0, 1.5], device=dev))
    out = {}
    for kind, rating in ratings.items():
        sp = stg.make_storage(surface_area=1.0e6, min_stage=float(b7[0].ds.storage.min_stage),
                              solution_boundaries=(0.0, 100.0), rating=rating, device=dev)
        out[kind] = ([dataclasses.replace(b7[0], ds=dataclasses.replace(b7[0].ds, storage=sp)), *b7[1:]], n7, s7)
    return out


def split_flagship(solver, channel):
    """The flagship cut at NETWORK_SPLIT_NODE into two branches joined at one
    junction: the same nonlinear system as the single reach."""
    from flowsim_tpu_torch import trees
    from flowsim_tpu_torch.ops import network as net

    cut, geo, dx = NETWORK_SPLIT_NODE, channel.geometry, solver.spatial_step
    return [net.BranchDef(geo=trees.tree_map(lambda v: v[: cut + 1], geo), dx=dx, us=solver.us_params, ds=0,
                          h0=solver.h0[: cut + 1], Q0=solver.Q0[: cut + 1]),
            net.BranchDef(geo=trees.tree_map(lambda v: v[cut:], geo), dx=dx, us=0, ds=solver.ds_params,
                          h0=solver.h0[cut:], Q0=solver.Q0[cut:])]


def check_network_kernels(dev) -> dict:
    """Kernel 5 against its plain version (the stacked engine with the "pcr"
    solve, on the card) and against kernel 1 on the serial split; kernel 6
    against its plain version and against single launches of kernel 5; every
    refusal by its message."""
    from flowsim_tpu_torch import trees
    from flowsim_tpu_torch.models import basin, gerd_tributary
    from flowsim_tpu_torch.models.gerd_roseires import model
    from flowsim_tpu_torch.ops import network as net
    from flowsim_tpu_torch.ops import rating_curve as rcurve
    from flowsim_tpu_torch.ops import storage as stg
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet
    from flowsim_tpu_torch.ops.cuda.fused_newton import FusedUnsupported, fused_simulate
    from flowsim_tpu_torch.parallel import ensemble

    out = {}
    # (i) the serial split against kernel 1 on the single reach
    solver, channel = model.build(device=dev, sim_duration=3600 * 24)
    sset = solver.settings(tolerance=1e-6, max_iter=100)
    single = fused_simulate(channel.geometry, solver.us_params, solver.ds_params, solver.h0, solver.Q0, sset)
    split = fnet.fused_simulate_network(split_flagship(solver, channel), 1, sset)
    cut = NETWORK_SPLIT_NODE
    if split.iterations.tolist() != single.iterations.tolist():
        raise AssertionError(f"serial split: counts {split.iterations.tolist()} vs kernel 1 "
                             f"{single.iterations.tolist()}")
    dh = max(float((split.depth[0] - single.depth[:, : cut + 1]).abs().max()),
             float((split.depth[1] - single.depth[:, cut:]).abs().max()))
    dq = max(float((split.flow[0] - single.flow[:, : cut + 1]).abs().max()),
             float((split.flow[1] - single.flow[:, cut:]).abs().max()))
    dy = float((split.junction_stage[:, 0] - (single.depth[:, cut] + channel.geometry.z_bed[cut])).abs().max())
    if not (dh <= H_TOL and dq <= Q_TOL and dy <= NETWORK_Y_TOL):
        raise AssertionError(f"serial split vs kernel 1: max|dh|={dh}, max|dQ|={dq}, max|dY|={dy}")
    out["serial_split_vs_fused_simulate_25"] = dict(levels=len(single.iterations), iterations=int(single.iterations.sum()),
                                                    max_abs_dh=dh, max_abs_dQ=dq, max_abs_dY=dy)

    # (ii) the tributary against the stacked plain engine is the network
    # phase's comparison over its first NETWORK_COMPARED_LEVELS levels
    br, nj, sset_t, _ = gerd_tributary.build(sim_duration=3600 * 24, device=dev)

    # (iii) junction reservoirs with each rating kind, a withdrawal, a gated
    # and a storage outlet, lateral inflow: the 7-branch basin over 9 levels
    for name in NETWORK_CASES:
        b7, n7, s7, kw = build_network_case(name, dev)
        o_k = fnet.fused_simulate_network(b7, n7, s7, **kw)
        rec = compare_networks(o_k, fnet.fused_simulate_network_plain(b7, n7, s7, **kw), name)
        if "junction_rating" in kw:
            rec["junction_outflow_first_last"] = [float(o_k.junction_outflow[1].max()),
                                                  float(o_k.junction_outflow[-1].max())]
        if name == "gated_outlet":
            rec["gate_switches"] = int((o_k.gate_open[1:, 0, 1] != o_k.gate_open[:-1, 0, 1]).sum())
            if rec["gate_switches"] < 1:
                raise AssertionError("gated outlet: the gate never switched")
        if name == "storage_outlet":
            stage = o_k.reservoir_stage[1:, 0, 1]
            if not bool(torch.isfinite(stage).all()):
                raise AssertionError("storage outlet: the reservoir stage is not finite")
            rec["stage_first_last"] = [float(stage[0]), float(stage[-1])]
        out[name] = rec
    # (iii-b) the storage outlet with an outflow rating beyond the quadratics
    # (power, a table of 8 breakpoints, a cubic): kernel 5, and kernel 6 on 4
    # members of per-member inflow, against the plain version
    for kind, (b7r, n7, s7) in storage_outlet_networks(dev).items():
        o_k = fnet.fused_simulate_network(b7r, n7, s7)
        rec = compare_networks(o_k, fnet.fused_simulate_network_plain(b7r, n7, s7), f"storage outlet, {kind}")
        stage = o_k.reservoir_stage[1:, 0, 1]
        batch = scale_inflows(b7r, [0.9, 1.0, 1.1, 1.2])
        ob = fnet.fused_simulate_network_batched(b7r, n7, s7, batch)
        op = fnet.fused_simulate_network_batched_plain(b7r, n7, s7, batch)
        recs = [compare_networks(network_member(ob, m), network_member(op, m), f"storage outlet {kind}, member {m}")
                for m in range(4)]
        out[f"{kind}_rating_on_storage"] = dict(
            rec, stage_first_last=[float(stage[0]), float(stage[-1])],
            batched_4=dict(members=4, iterations=sum(r["iterations"] for r in recs),
                           max_abs_dh=max(r["max_abs_dh"] for r in recs),
                           max_abs_dstage=max(r["max_abs_dstage"] for r in recs)))
    # (iv) the 15-branch basin over 25 levels
    b4, n4, s4 = basin.build(levels=4, sim_hours=6, device=dev)
    out["basin_levels4_25"] = compare_networks(fnet.fused_simulate_network(b4, n4, s4),
                                               fnet.fused_simulate_network_plain(b4, n4, s4), "basin levels=4")

    # (v) kernel 6 against its plain version: 2 members x 25 levels with
    # per-member inflows, tributary roughness and lateral inflow
    batch = scale_inflows(br, [0.9, 1.2])
    batch[1]["geo"] = ensemble.roughness_ensemble(br[1].geo, [0.028, 0.040])
    rng = np.random.default_rng(4)
    batch[2]["qlat"] = torch.tensor(rng.uniform(0.0, 1e-3, (2, int(br[2].h0.shape[0]))), dtype=torch.float64,
                                    device=dev)
    ob = fnet.fused_simulate_network_batched(br, nj, sset_t, batch)
    t0 = time.perf_counter()
    op = fnet.fused_simulate_network_batched_plain(br, nj, sset_t, batch)
    torch.cuda.synchronize()
    batched_plain_ms = (time.perf_counter() - t0) * 1e3
    recs = [compare_networks(network_member(ob, m), network_member(op, m), f"batched member {m}") for m in range(2)]
    out["batched_2x25"] = dict(members=2, levels=25, iterations=sum(r["iterations"] for r in recs),
                               max_abs_dh=max(r["max_abs_dh"] for r in recs),
                               max_abs_dQ=max(r["max_abs_dQ"] for r in recs),
                               max_abs_dY=max(r["max_abs_dY"] for r in recs), plain_ms=batched_plain_ms)

    # (vi) 8 members x 385 levels against 8 single launches: bit-identical
    br385, nj, s385, _ = gerd_tributary.build(device=dev)
    batch8 = scale_inflows(br385, np.linspace(0.8, 1.2, 8))
    batch8[0]["geo"] = expand_members(br385[0].geo, 8)
    ob8 = fnet.fused_simulate_network_batched(br385, nj, s385, batch8)
    singles = [fnet.fused_simulate_network(net.member_branches(br385, batch8, m), nj, s385) for m in range(8)]
    recs = [compare_networks(network_member(ob8, m), singles[m], f"8x385 member {m}", exact=True)
            for m in range(8)]
    out["batched_bit_identity_8x385"] = dict(members=8, levels=s385.n_time_levels,
                                             iterations=sum(r["iterations"] for r in recs), bit_identical=True)
    # (vii) one member made to diverge (main-channel roughness 1e-6 on the
    # upper stem) beside seven sound ones
    bad = 3
    n_main = batch8[0]["geo"].n_main.clone()
    n_main[bad] = 1e-6
    batch_d = [dict(d) for d in batch8]
    batch_d[0]["geo"] = dataclasses.replace(batch8[0]["geo"], n_main=n_main)
    od = fnet.fused_simulate_network_batched(br385, nj, s385, batch_d)
    for m in range(8):
        if m != bad:
            compare_networks(network_member(od, m), singles[m], f"sound member {m} beside a diverged one",
                             exact=True)
    if bool(od.converged[bad].all()):
        raise AssertionError("the diverging member converged at every level")
    out["diverged_member"] = dict(bad_member=bad, bad_member_levels_converged=int(od.converged[bad].sum()),
                                  sound_members_bit_identical=True)
    # (vii-b) the same 8 members (and the diverging one) repeated until the
    # batch is larger than the card holds in the fast build: through the
    # wrapper the C entry then takes the residency build itself, which must
    # give every copy the bits of the single launches
    topo = net.stacked_topology(br385)
    shape = (len(br385) * topo.n_max, len(br385), nj, topo.m_rhs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fast = fnet.chosen_build(1, *shape)
    copies = fnet.resident_blocks(*shape, fast) * sms // 8 + 1
    chosen = fnet.chosen_build(8 * copies, *shape)
    if chosen != fnet.RESIDENCY_BUILD:
        raise AssertionError(f"{8 * copies} members take build {chosen}, not a residency build")

    def tiled(batch):
        t = scale_inflows(br385, np.tile(np.linspace(0.8, 1.2, 8), copies))
        t[0]["geo"] = dataclasses.replace(expand_members(br385[0].geo, 8 * copies),
                                          n_main=batch[0]["geo"].n_main.repeat(copies, 1))
        return t

    ort = fnet.fused_simulate_network_batched(br385, nj, s385, tiled(batch8))
    for m in range(8 * copies):
        compare_networks(network_member(ort, m), singles[m % 8], f"residency build member {m}", exact=True)
    del ort
    ord_ = fnet.fused_simulate_network_batched(br385, nj, s385, tiled(batch_d))
    for m in range(8 * copies):
        if m % 8 != bad:
            compare_networks(network_member(ord_, m), singles[m % 8], f"residency build: sound member {m}",
                             exact=True)
    if not torch.equal(ord_.converged, od.converged.repeat(copies, 1)):
        raise AssertionError("residency build: the converged flags differ from the fast build's")
    del ord_
    out["residency_build_bit_identity_8x385"] = dict(
        members=8 * copies, distinct_members=8, levels=s385.n_time_levels, fast_build=fast, chosen_build=chosen,
        fast_build_holds=fnet.resident_blocks(*shape, fast) * sms,
        sound_members_beside_diverged_ones_bit_identical=True)
    # (vii-c) the latency build against the loop build: the tributary (385
    # levels) and the basin at levels=4 (25 levels), bits and counts
    b4, n4, s4 = basin.build(levels=4, sim_hours=6, device=dev)
    lat = {}
    for name, (b, j, st) in (("tributary_385", (br385, nj, s385)), ("basin_levels4_25", (b4, n4, s4))):
        o_loop = network_launch(b, j, st, build_id=fnet.LOOP_BUILD)
        o_lat = network_launch(b, j, st, build_id=fnet.LATENCY_BUILD)
        lat[name] = dict(compare_networks(o_lat, o_loop, f"{name}: latency vs loop build", exact=True),
                         wrapper_build=fnet.chosen_build(1, len(b) * net.stacked_topology(b).n_max, len(b), j,
                                                         net.stacked_topology(b).m_rhs))
    out["latency_vs_loop_build"] = lat

    # (viii) what the kernel refuses reaches the caller by name
    b_ext = [dataclasses.replace(br[0], ds=br[2].ds)]
    b7, n7, s7, _ = build_network_case("storage_outlet", dev)
    gated_storage = stg.make_storage(surface_area=1.0e6, min_stage=float(b7[0].ds.storage.min_stage),
                                     rating=rcurve.make_gated_blend([0.0, 20.0, 0.0], [0.0, 30.0, 0.0], 2.0,
                                                                    device=dev), device=dev)
    b7_gated = [dataclasses.replace(b7[0], ds=dataclasses.replace(b7[0].ds, storage=gated_storage)), *b7[1:]]
    gated_us = dataclasses.replace(
        br[0], us=dataclasses.replace(br[2].ds, rating=rcurve.make_gated_blend(
            [0.0, 5.0, 0.0], [0.0, 6.0, 0.0], 480.0, device=dev)))
    poly4 = dataclasses.replace(rcurve.make_polynomial(1.0, 2.0, 3.0, device=dev),
                                coeffs=torch.ones(4, dtype=torch.float64, device=dev))
    # the JAX kernel's own limits: 127 junctions (the basin at levels=8), a
    # branch of 8193 nodes
    b8, n8, s8 = basin.build(levels=8, link_nodes=2, sim_hours=0.5, device=dev)
    n_long = 8193
    long_branch = dataclasses.replace(
        br[2], geo=trees.tree_map(lambda v: v[-1:].expand(n_long).clone(), br[2].geo),
        h0=br[2].h0[-1:].expand(n_long).clone(), Q0=br[2].Q0[-1:].expand(n_long).clone())
    refused = {}
    for name, call in (
            ("not_a_network", lambda: fnet.fused_simulate_network(b_ext, 0, sset_t)),
            ("diagnos", lambda: fnet.fused_simulate_network(br, nj, dataclasses.replace(sset_t, diagnos=True))),
            ("newton_fixed", lambda: fnet.fused_simulate_network(br, nj, dataclasses.replace(sset_t, newton="fixed"))),
            ("upstream_gated_rating", lambda: fnet.fused_simulate_network([gated_us, *br[1:]], nj, sset_t)),
            ("gated_blend_rating_on_storage", lambda: fnet.fused_simulate_network(b7_gated, n7, s7)),
            ("junction_rating_quartic_polynomial",
             lambda: fnet.fused_simulate_network(br, nj, sset_t, junction_rating=[poly4])),
            ("junctions_beyond_120", lambda: fnet.fused_simulate_network(b8, n8, s8)),
            ("batched_junctions_beyond_120", lambda: fnet.fused_simulate_network_batched(
                b8, n8, s8, scale_inflows(b8, [1.0, 1.1]))),
            ("branch_beyond_8192_nodes", lambda: fnet.fused_simulate_network([br[0], br[1], long_branch], nj,
                                                                              sset_t))):
        try:
            call()
        except FusedUnsupported as e:
            refused[name] = str(e)
        else:
            raise AssertionError(f"the network kernel accepted {name}")
    out["refuses"] = refused
    # (ix) beyond one block's shared memory, accepted: the basin at levels=6
    # (63 x 13 slots, 3 levels) in the cluster build, one network and two
    # members, against the plain version
    b6, n6, s6 = basin.build(levels=6, sim_hours=0.5, device=dev)
    batch6 = scale_inflows(b6, [1.0, 1.1])
    topo6 = net.stacked_topology(b6)
    build6 = fnet.chosen_build(1, len(b6) * topo6.n_max, len(b6), n6, topo6.m_rhs)
    if build6 != fnet.CLUSTER_BUILD:
        raise AssertionError(f"the basin at levels=6 takes build {build6}, not the cluster build")
    out["slots_beyond_shared_memory"] = dict(
        compare_networks(fnet.fused_simulate_network(b6, n6, s6), fnet.fused_simulate_network_plain(b6, n6, s6),
                         "basin levels=6"), build=build6, slots=len(b6) * topo6.n_max)
    ob6 = fnet.fused_simulate_network_batched(b6, n6, s6, batch6)
    op6 = fnet.fused_simulate_network_batched_plain(b6, n6, s6, batch6)
    recs = [compare_networks(network_member(ob6, m), network_member(op6, m), f"basin levels=6, member {m}")
            for m in range(2)]
    out["batched_slots_beyond_shared_memory"] = dict(members=2, iterations=sum(r["iterations"] for r in recs),
                                                     max_abs_dh=max(r["max_abs_dh"] for r in recs))
    return out


def probe_record(cycles: dict, clock_khz: int, iterations: int, launch_ms: float) -> dict:
    """Microseconds per Newton iteration of each probe phase (cycles at the
    SM clock the device reports), and their sum against the launch's time
    by CUDA events; the network probe's parts of the assembly phase
    (``fused_network.ASSEMBLY_PARTS``) are listed and not summed."""
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet

    us = {ph: c / clock_khz * 1e3 / iterations for ph, c in cycles.items()}
    total_ms = sum(c for ph, c in cycles.items() if ph not in fnet.ASSEMBLY_PARTS) / clock_khz
    return dict(us_per_iteration=us, us_per_iteration_sum=sum(v for ph, v in us.items()
                                                              if ph not in fnet.ASSEMBLY_PARTS),
                iterations=iterations,
                cycles=cycles, clock_khz=clock_khz, probe_ms=total_ms, launch_ms=launch_ms,
                probe_ms_over_launch_ms=total_ms / launch_ms)


def drive_probe(dev, tributary_builds=(0, 1)) -> dict:
    """The probe builds inside an iteration: kernel 5 on the tributary (385
    levels; each of ``tributary_builds``: 0 the loop build, 1 the latency
    build) and on the basin at levels=5 (the loop build: 403 slots), kernel 1
    on the flagship in each of its builds that has a probe build
    (:func:`kernel1_probe_builds`).  Each probe launch must give the
    production launch's bits; the production launch is timed by CUDA events
    (no launch counted)."""
    from flowsim_tpu_torch.models import basin, gerd_tributary
    from flowsim_tpu_torch.models.gerd_roseires import model
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet
    from flowsim_tpu_torch.ops.cuda import fused_newton

    out = {}
    br, nj, sset, _ = gerd_tributary.build(device=dev)
    b5, n5, s5 = basin.build(levels=5, device=dev)
    for name, (b, j, st), builds in (("tributary", (br, nj, sset), tributary_builds),
                                     ("basin_levels5", (b5, n5, s5), (0,))):
        topo, launch = network_packed(b, j, st)
        rec = {}
        for bid in builds:
            prod = fnet._single(fnet._output(launch(bid), topo, None))
            ms = time_cuda(lambda: launch(bid), reps=3, warmup=1)
            probed, cycles, clock = fnet.fused_simulate_network_probe(b, j, st, build_id=bid)
            compare_networks(probed, prod, f"probe of {name}, build {bid}", exact=True)
            rec[{0: "loop_build", 1: "latency_build"}[bid]] = dict(
                probe_record(cycles, clock, int(prod.iterations.sum()), ms), bit_identical_to_production=True)
        out[name] = dict(branches=len(b), junctions=j, slots=len(b) * topo.n_max, n_time_levels=st.n_time_levels,
                         rhs_pairs=topo.m_rhs, **rec)
    solver, channel = model.build(device=dev)
    args = (channel.geometry, solver.us_params, solver.ds_params, solver.h0, solver.Q0,
            solver.settings(tolerance=1e-6, max_iter=100))
    for key, bid in kernel1_probe_builds(fused_newton).items():
        prod, _ = fused_newton._launch_one(*args, None, build_id=bid)
        ms = time_cuda(lambda: fused_newton._launch_one(*args, None, build_id=bid), reps=3, warmup=1)
        probed, cycles, clock = fused_newton.fused_simulate_probe(*args, build_id=bid)
        same_bits(probed, prod, f"probe of the flagship, build {bid}")
        out[key] = dict(build_id=bid, n_nodes=int(solver.h0.shape[0]), n_time_levels=args[5].n_time_levels,
                        **probe_record(cycles, clock, int(prod.iterations.sum()), ms),
                        bit_identical_to_production=True)
    return out


def drive_network(dev, launches: dict, keep: dict | None = None) -> tuple[dict, dict]:
    """The network main path through the user entry points: the tributary
    at full width (385 levels) with ``simulate_network(engine="fused")`` and
    ``NetworkSolver.run(engine="fused")``, one launch of kernel 5 each, and
    the large basin of scripts/bench_basin_large.py through the stacked
    engine with ``linear_solver="cuda_pcr"`` (one kernel-2 launch per Newton
    iteration).  Then the timings and the comparisons with the stacked plain
    engine.  Returns the phase record and the figures for the kernel table;
    ``keep`` receives the large basin's run (``"large_basin"``), which the
    phase ``network_scratch`` holds kernel 5's scratch build against."""
    from flowsim_tpu_torch.models import basin, gerd_tributary
    from flowsim_tpu_torch.ops import network as net
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet
    from flowsim_tpu_torch.ops.cuda import pcr_kernel

    ns, br = gerd_tributary.network_solver(device=dev)
    nj = ns.n_junctions
    sset = ns.settings(1e-6, 100)
    bl, njl, sl = basin.build(device=dev, **LARGE_BASIN)
    sl = dataclasses.replace(sl, linear_solver="cuda_pcr")
    fnet.launch_count = 0
    pcr_kernel.launch_count = 0
    t0 = time.perf_counter()
    out = net.simulate_network(br, nj, sset, engine="fused")
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    out_ns = ns.run(tolerance=1e-6, verbose=0, engine="fused")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_l = net.simulate_network(bl, njl, sl, engine="stacked")
    torch.cuda.synchronize()
    large_ms = (time.perf_counter() - t0) * 1e3
    launches["fused_simulate_network"] = fnet.launch_count
    large_launches = pcr_kernel.launch_count

    nt = sset.n_time_levels
    total_it = int(out.iterations.sum())
    slots = sum(int(b.h0.shape[0]) for b in br)
    if (len(br), nt, sset.theta) != (3, 385, 0.6) or [int(b.h0.shape[0]) for b in br] != [61, 10, 61]:
        raise AssertionError(f"the tributary is not at full width: {[b.h0.shape for b in br]}, nt={nt}")
    if launches["fused_simulate_network"] != 2:
        raise AssertionError(f"simulate_network and NetworkSolver.run took {fnet.launch_count} launches, expected 2")
    for o, what in ((out, "simulate_network"), (out_ns, "NetworkSolver.run")):
        if not bool(o.converged.all()) or not all(bool(torch.isfinite(h).all()) for h in o.depth) \
                or o.junction_stage.shape != (nt, 1):
            raise AssertionError(f"tributary via {what}: not converged, not finite or of the wrong shape")
    via_solver = dict(iterations=int(out_ns.iterations.sum()),
                      max_abs_dh_vs_simulate_network=max(float((a - b).abs().max())
                                                         for a, b in zip(out_ns.depth, out.depth)))
    # the junction balances: what enters leaves (levels 1+)
    q_in = out.flow[0][1:, -1] + out.flow[1][1:, -1]
    imbalance = float((q_in - out.flow[2][1:, 0]).abs().max())
    large_it = int(out_l.iterations.sum())
    if large_launches != large_it or large_it == 0 or not bool(out_l.converged.all()):
        raise AssertionError(f"large basin: {large_launches} kernel-2 launches for {large_it} iterations")
    large = dict(branches=len(bl), junctions=njl, nodes=sum(int(b.h0.shape[0]) for b in bl),
                 n_time_levels=sl.n_time_levels, linear_solver="cuda_pcr", wall_ms=large_ms,
                 iterations=large_it, pcr_solve_launches=large_launches, ms_per_iteration=large_ms / large_it,
                 all_converged=True)
    if keep is not None:
        keep["large_basin"] = out_l
    del out_l

    runs = [wall_ms(lambda: fnet.fused_simulate_network(br, nj, sset)) for _ in range(6)][1:]
    launch_ms = statistics.median(runs)
    setup_ms = network_setup_ms(br, nj, sset)
    # against the stacked plain engine over the first levels
    cmp_levels = NETWORK_COMPARED_LEVELS
    bc, _, sc, _ = gerd_tributary.build(sim_duration=3600 * (cmp_levels - 1), device=dev)
    out_c = fnet.fused_simulate_network(bc, nj, sc)
    cmp_ms = statistics.median(wall_ms(lambda: fnet.fused_simulate_network(bc, nj, sc)) for _ in range(3))
    t0 = time.perf_counter()
    out_p = fnet.fused_simulate_network_plain(bc, nj, sc)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    cmp = compare_networks(out_c, out_p, "tributary fused vs stacked plain")
    # the basin at levels=5 (31 branches, 15 junctions, 97 levels): fused
    # against the stacked engine with the cuda_pcr solve
    b5, n5, s5 = basin.build(levels=5, device=dev)
    out_b5 = fnet.fused_simulate_network(b5, n5, s5)
    b5_ms = statistics.median(wall_ms(lambda: fnet.fused_simulate_network(b5, n5, s5)) for _ in range(3))
    b5_setup_ms = network_setup_ms(b5, n5, s5)
    t0 = time.perf_counter()
    out_b5s = net.simulate_network(b5, n5, dataclasses.replace(s5, linear_solver="cuda_pcr"), engine="stacked")
    torch.cuda.synchronize()
    b5_stacked_ms = (time.perf_counter() - t0) * 1e3
    b5_cmp = compare_networks(out_b5, out_b5s, "basin levels=5 fused vs stacked")
    fnet.launch_count = launches["fused_simulate_network"]   # the timing launches are not the main path's
    record = dict(
        branches=len(br), junctions=nj, nodes_per_branch=[int(b.h0.shape[0]) for b in br], n_time_levels=nt,
        theta=sset.theta, tolerance=sset.tolerance, launches=launches["fused_simulate_network"],
        all_converged=True, total_iterations=total_it, max_iterations_in_a_level=int(out.iterations.max()),
        first_launch_ms=first_ms, launch_ms_runs=runs, launch_ms_median=launch_ms, setup_ms=setup_ms,
        us_per_newton_iteration=launch_ms * 1e3 / total_it,
        newton_node_updates_per_s=slots * total_it / (launch_ms * 1e-3),
        max_junction_imbalance_m3s=imbalance, peak_flow_lower_stem=float(out.flow[2].max()),
        via_network_solver=via_solver,
        stacked_plain=dict(kernel_ms=cmp_ms, plain_ms=plain_ms,
                           plain_ms_per_iteration=plain_ms / cmp["iterations"], speedup=plain_ms / cmp_ms, **cmp),
        basin_levels5=dict(branches=len(b5), junctions=n5, n_time_levels=s5.n_time_levels, kernel_ms=b5_ms,
                           setup_ms=b5_setup_ms, stacked_cuda_pcr_ms=b5_stacked_ms,
                           us_per_newton_iteration=b5_ms * 1e3 / b5_cmp["iterations"],
                           **b5_cmp),
        large_basin_stacked=large)
    topo = net.stacked_topology(bc)
    table = dict(cmp, ms=cmp_ms, plain_ms=plain_ms, n_junctions=nj, topo=topo, n_max=topo.n_max,
                 n_branches=len(bc))
    return record, table


def drive_network_ensemble(dev, launches: dict, batched_plain_ms: float) -> tuple[dict, dict]:
    """The network Monte-Carlo main path: the tributary with per-member inflow
    scales through ``batched_simulate_network(engine="fused")``, NETWORK_MC_MEMBERS
    members in one launch of kernel 6; then the scaling curve and the basin
    (levels=4, 25 levels) at BASIN_MC_MEMBERS members."""
    from flowsim_tpu_torch.models import basin, gerd_tributary
    from flowsim_tpu_torch.ops import network as net
    from flowsim_tpu_torch.ops.cuda import build
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet
    from flowsim_tpu_torch.parallel import ensemble

    br, nj, sset, _ = gerd_tributary.build(device=dev)
    M = NETWORK_MC_MEMBERS
    scales = 0.9 + 0.2 * np.random.default_rng(NETWORK_MC_SEED).random(M)
    batch = scale_inflows(br, scales)
    fnet.launch_count = 0
    fnet.batched_launch_count = 0
    t0 = time.perf_counter()
    out = ensemble.batched_simulate_network(br, nj, sset, batch, engine="fused")
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches["fused_simulate_network_batched"] = fnet.batched_launch_count
    if fnet.batched_launch_count != 1 or fnet.launch_count != 0:
        raise AssertionError(f"the network ensemble took {fnet.batched_launch_count} batched and "
                             f"{fnet.launch_count} single launches, expected 1 and 0")
    nt = sset.n_time_levels
    if out.depth[0].shape != (M, nt, 61) or out.junction_stage.shape != (M, nt, 1) \
            or not all(bool(torch.isfinite(h).all()) for h in out.depth):
        raise AssertionError("network ensemble output has the wrong shape or is not finite")
    if not bool(out.converged.all()):
        raise AssertionError(f"network ensemble: {int((~out.converged.all(dim=1)).sum())} of {M} members "
                             "did not converge at every level")
    per_member = out.iterations.sum(dim=1)
    iters = int(per_member.sum())
    peak = out.flow[2][:, :, -1].max(dim=1).values.cpu().numpy()
    runs = [wall_ms(lambda: ensemble.batched_simulate_network(br, nj, sset, batch, engine="fused"))
            for _ in range(3)]
    ms = statistics.median(runs)
    # every build of the kernel on the same members, in turns with the
    # wrapper's choice: what the occupancy calculator puts on an SM, what
    # ptxas gave each, its time, and its bits (equal to the main run's)
    topo = net.stacked_topology(br)
    shape = (len(br) * topo.n_max, len(br), nj, topo.m_rhs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chosen = fnet.chosen_build(M, *shape)
    _, launch = network_packed(br, nj, sset, batch)
    ptxas = [k for k in network_kernel_builds(build.build_info["fused_network"]["ptxas"])
             if k["rhs"] == topo.m_rhs and not k["probe"] and not k["table"] and not k["scratch"]
             and not k["cluster"]]
    # (launch-bound block, blocks an SM, one slot a thread) of each build at these slots
    bounds = {fnet.LOOP_BUILD: (256, 1, False), fnet.LATENCY_BUILD: (256, 1, True),
              fnet.RESIDENCY_BUILD: (192 if shape[0] <= 192 else 256, 2, True)}
    builds = dict(multiprocessors=sms, chosen_build=chosen)
    for name, bid in (("loop_build", fnet.LOOP_BUILD), ("latency_build", fnet.LATENCY_BUILD),
                      ("residency_build", fnet.RESIDENCY_BUILD)):
        bps = fnet.resident_blocks(*shape, bid)
        ob = fnet._output(launch(bid), topo, None)
        for a, b in zip((*ob.depth, *ob.flow, ob.junction_stage, ob.error, ob.iterations),
                        (*out.depth, *out.flow, out.junction_stage, out.error, out.iterations)):
            if not torch.equal(a, b):
                raise AssertionError(f"network ensemble: the {name} disagrees with the wrapper's build")
        del ob
        blk, minb, one = bounds[bid]
        builds[name] = dict(build_id=bid, resident_blocks_per_sm=bps, members_in_flight=bps * sms,
                            ms=time_cuda(lambda: launch(bid), reps=2, warmup=1),
                            ptxas=[k for k in ptxas if (k["block"], k["min_blocks"], k["one_slot"]) == (blk, minb, one)])
    del out
    scaling = []
    for members in NETWORK_SCALING_MEMBERS:
        part = [{k: trees_slice(v, members) for k, v in d.items()} for d in batch]
        its = fnet.fused_simulate_network_batched(br, nj, sset, part).iterations.sum(dim=1)
        ms_m = wall_ms(lambda: fnet.fused_simulate_network_batched(br, nj, sset, part))
        scaling.append(dict(members=members, ms=ms_m, sims_per_s=members / (ms_m * 1e-3),
                            newton_iterations=int(its.sum()), most_in_a_member=int(its.max())))
    # the basin at levels=4, 25 levels, BASIN_MC_MEMBERS members
    b4, n4, s4 = basin.build(levels=4, sim_hours=6, device=dev)
    scales4 = 0.9 + 0.2 * np.random.default_rng(NETWORK_MC_SEED).random(BASIN_MC_MEMBERS)
    batch4 = scale_inflows(b4, scales4)
    out4 = fnet.fused_simulate_network_batched(b4, n4, s4, batch4)
    if not bool(out4.converged.all()):
        raise AssertionError("basin ensemble: a member did not converge")
    ms4_runs = [wall_ms(lambda: fnet.fused_simulate_network_batched(b4, n4, s4, batch4)) for _ in range(3)]
    ms4 = statistics.median(ms4_runs)
    topo4 = net.stacked_topology(b4)
    shape4 = (len(b4) * topo4.n_max, len(b4), n4, topo4.m_rhs)
    # the kernel alone (CUDA events, packing outside) in each build, in
    # turns: the loop build is the one-block-an-SM design the others replace
    builds4 = dict(chosen_build=fnet.chosen_build(BASIN_MC_MEMBERS, *shape4))
    _, launch4 = network_packed(b4, n4, s4, batch4)
    for name, bid in (("loop_build", fnet.LOOP_BUILD), ("latency_build", fnet.LATENCY_BUILD),
                      ("residency_build", fnet.RESIDENCY_BUILD)):
        o4 = fnet._output(launch4(bid), topo4, None)
        if not all(torch.equal(a, b) for a, b in zip((*o4.depth, o4.error), (*out4.depth, out4.error))):
            raise AssertionError(f"basin ensemble: the {name} disagrees with the wrapper's build")
        builds4[name] = dict(resident_blocks_per_sm=fnet.resident_blocks(*shape4, bid), ms_runs=[])
    for _ in range(3):
        for name, bid in (("loop_build", fnet.LOOP_BUILD), ("latency_build", fnet.LATENCY_BUILD),
                          ("residency_build", fnet.RESIDENCY_BUILD)):
            builds4[name]["ms_runs"].append(time_cuda(lambda: launch4(bid), reps=5, warmup=1))
    fnet.batched_launch_count = launches["fused_simulate_network_batched"]
    record = dict(
        members=M, branches=len(br), n_time_levels=nt, store="full", launches=1, all_converged=True,
        first_launch_ms=first_ms, wall_ms_runs=runs, wall_ms_median=ms, network_simulations_per_s=M / (ms * 1e-3),
        builds=builds,
        total_newton_iterations=iters, min_max_iterations_per_member=[int(per_member.min()), int(per_member.max())],
        newton_node_updates_per_s=sum(int(b.h0.shape[0]) for b in br) * iters / (ms * 1e-3),
        output_bytes=fnet.output_bytes(M, len(br), 61, nj, nt),
        outlet_peak_flow_quantiles_5_50_95=np.percentile(peak, [5, 50, 95]).tolist(), scaling=scaling,
        basin_levels4=dict(members=BASIN_MC_MEMBERS, branches=len(b4), n_time_levels=s4.n_time_levels, ms=ms4,
                           ms_runs=ms4_runs, builds=builds4,
                           network_simulations_per_s=BASIN_MC_MEMBERS / (ms4 * 1e-3),
                           total_newton_iterations=int(out4.iterations.sum())))
    table = dict(ms=ms, plain_ms=batched_plain_ms, members=M, iterations=iters, n_time_levels=nt,
                 n_branches=len(br), topo=net.stacked_topology(br), n_junctions=nj, builds=builds)
    return record, table


def trees_slice(v, members: int):
    """The first ``members`` members of a batched override (a tree or a tensor)."""
    from flowsim_tpu_torch import trees

    return v[:members] if isinstance(v, torch.Tensor) else trees.slice_members(v, 0, members)


def network_bound(n_iterations: int, topo, n_junctions: int, n_time_levels: int,
                  members: int = 1, table=None, table_bytes: int = 0) -> tuple[float, str, dict]:
    """The least time of a network run, over the real nodes of its branches
    (``topo``: ``ops.network.stacked_topology``; the kernel's edge pads are
    its own overhead, not work the function needs): its inputs read once (13
    geometry rows, h0, Q0 per node; two boundary series per branch) and its
    outputs written once (depth and flow of every node, junction stages, two
    reservoir stages and gate flags per branch, error, iterations and
    converged, per level), against its FP64 operations (per iteration and
    node of branch b: the assembly and a block-Thomas solve with 1 +
    couplings_b right-hand-side pairs; per iteration the J x J Gauss-Jordan
    solve, 2 J^3 / 3 + 2 J^2).  ``table``: per branch True for a table
    branch, whose nodes read 4 geometry rows and do FLOPS_TABLE_ASSEMBLY;
    ``table_bytes``: the table samples its evaluations read, once."""
    n_b, B, J = topo.n_b, len(topo.n_b), n_junctions
    table = table or (False,) * B
    nodes = sum(n_b)
    rows = sum(n * (6 if t else 15) for n, t in zip(n_b, table))
    nbytes = table_bytes + members * (8 * (rows + 2 * B * n_time_levels)
                                      + n_time_levels * (8 * (2 * nodes + J + 4 * B + 1) + 2 * 4))
    per_iteration = sum(n * ((FLOPS_TABLE_ASSEMBLY if t else FLOPS_ASSEMBLY) + FLOPS_THOMAS
                             + len(c) * FLOPS_THOMAS_PAIR)
                        for n, c, t in zip(n_b, topo.couplings, table))
    flops = n_iterations * (per_iteration + 2 * J ** 3 / 3 + 2 * J ** 2)
    tb, tf = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F64_FLOPS * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations"), dict(bytes=nbytes, flops=flops)


def table_polyline(seed: int, z0: float):
    """One surveyed section of the validation reach: 21 points over 220 m,
    a parabola 8 m deep plus up to 0.5 m of noise from ``seed``."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 220.0, 21)
    return x, z0 + 8.0 * ((x - 110.0) / 110.0) ** 2 + rng.uniform(0.0, 0.5, x.size)


def table_stations():
    from flowsim_tpu_torch.geometry_tables import IrregularStation

    (x1, z1), (x2, z2) = table_polyline(1, TABLE_SLOPE * TABLE_LENGTH), table_polyline(2, 0.0)
    return [IrregularStation(x=x1, z=z1, n_main=0.03, bed_slope=TABLE_SLOPE),
            IrregularStation(x=x2, z=z2, n_main=0.03, bed_slope=TABLE_SLOPE)]


def table_channel(api, stations, chainages, length):
    """A channel of the given stations: inflow rising from 400 to 1000 m^3/s
    over 4 h upstream, normal depth downstream, steady state at 400 m^3/s."""
    us = api.Boundary(condition="flow_hydrograph", chainage=0.0, hydrograph=api.Hydrograph(
        function=lambda t: 400.0 + 600.0 * min(t / (4 * 3600.0), 1.0)))
    ds = api.Boundary(condition="normal_depth", chainage=length)
    channel = api.Channel(us, ds, initial_flow=400.0, interpolation_method="steady-state")
    channel.set_cross_sections(chainages, stations)
    return channel


def table_reach_solver(dev):
    """The validation reach through the port's api (``Channel`` of two
    ``IrregularStation``s -> ``PreissmannSolver``): N = 121, M = 1024 (the
    api's sampling), 193 levels.  Rasterizing its tables is host work of about
    a minute."""
    from flowsim_tpu_torch import api

    channel = table_channel(api, table_stations(), [0.0, TABLE_LENGTH], TABLE_LENGTH)
    return api.PreissmannSolver(channel=channel, theta=TABLE_THETA, time_step=TABLE_DT,
                                spatial_step=TABLE_LENGTH / (TABLE_NODES - 1),
                                simulation_time=TABLE_DT * (TABLE_LEVELS - 1), device=dev)


def mixed_reach_solver(dev, levels: int = 13):
    """A 20 km mixed reach through the api: trapezoids at 0 and 10 km, a
    surveyed polyline at 15 km and a compound trapezoid at 20 km, N = 21, so
    that nodes sample the analytic trapezoid (0-10 km) and the union-grid
    blend (10-20 km)."""
    from flowsim_tpu_torch import api
    from flowsim_tpu_torch.geometry import TrapezoidStation
    from flowsim_tpu_torch.geometry_tables import IrregularStation

    length = 20000.0
    x, z = table_polyline(3, 0.0)
    stations = [TrapezoidStation(z_bed=length * TABLE_SLOPE, b_main=80.0, m_main=2.5, bed_slope=TABLE_SLOPE),
                TrapezoidStation(z_bed=0.5 * length * TABLE_SLOPE, b_main=85.0, m_main=2.5, bed_slope=TABLE_SLOPE),
                IrregularStation(x=x, z=z - z.min() + 0.25 * length * TABLE_SLOPE, n_main=0.035,
                                 bed_slope=TABLE_SLOPE),
                TrapezoidStation(z_bed=0.0, b_main=90.0, m_main=2.0, bed_slope=TABLE_SLOPE, h_bank=3.0,
                                 b_fp_left=40.0, b_fp_right=30.0, m_fp=4.0, n_left=0.05, n_right=0.045)]
    channel = table_channel(api, stations, [0.0, 0.5 * length, 0.75 * length, length], length)
    return api.PreissmannSolver(channel=channel, theta=TABLE_THETA, time_step=TABLE_DT, spatial_step=1000.0,
                                simulation_time=TABLE_DT * (levels - 1), device=dev)


def as_table(geo, samples: int = 256, depth_max: float = 20.0):
    """The lookup tables of a prismatic trapezoid reach (its two end sections,
    interpolated), sampled from the closed forms: the same reach as a
    TableGeometry, for the boundary and storage rows on tables."""
    from flowsim_tpu_torch.geometry import TrapezoidStation
    from flowsim_tpu_torch.geometry_tables import build_table_geometry

    g = geo.to("cpu")
    ends = [TrapezoidStation(z_bed=float(g.z_bed[i]), b_main=float(g.b_main[i]), m_main=float(g.m_main[i]),
                             n_main=float(g.n_main[i]), bed_slope=float(g.bed_slope[i])) for i in (0, -1)]
    n = g.n_nodes
    return build_table_geometry(ends, [0.0, float(n - 1)], np.arange(n, dtype=np.float64), depth_max=depth_max,
                                samples=samples, device=geo.device)


def cut_levels(args, levels: int):
    """A run's arguments cut to its first ``levels`` levels."""
    geo, us, ds, h0, Q0, sset = args
    cut = lambda bc: dataclasses.replace(bc, target_series=bc.target_series[..., :levels]) \
        if bc.kind in ("flow_hydrograph", "stage_hydrograph") else bc
    return geo, cut(us), cut(ds), h0, Q0, dataclasses.replace(sset, n_time_levels=levels)


def drive_table(dev, launches: dict) -> tuple[dict, list, dict]:
    """Irregular sections on the card: kernel 1's and kernel 3's table paths.

    The main path, counts at 0 before and read after: the validation reach
    through ``api.PreissmannSolver.run(engine="fused")`` (one launch of kernel
    1) and its 10 240-member roughness ensemble through
    ``table_roughness_ensemble`` -> ``batched_simulate(engine="fused")`` (one
    launch of kernel 3).  Then each held against its plain version on the
    card (the single run and 4 of the 10 240 members, on all their levels)
    and timed, a mixed-station reach through the api, lateral inflow
    with store="boundaries", the boundary pairs and storage rows on tables,
    B = 16 against 16 single launches bit for bit (the wrapper's build and
    the bracket build forced), and a NaN member beside sound ones; the lean
    and the bracket build forced on every single table launch above against
    the register build bit for bit; kernel 1's lean, register and bracket
    builds in turns by CUDA events with their probe builds
    (:func:`table_reach_builds`: the validation reach at M = 1024 and 96, 16
    members and one wave at M = 96; the C entry's choice must be the faster
    of the lean and the register build at each); every table build on the
    10 240 members against the chosen one bit for bit, the bracket and the
    residency build in turns by CUDA events and their probe builds.  Returns
    the phase record, the kernel-table rows and the reach's geometry
    (``solver``, and ``geo96``, ``h96``, ``Q96`` at M = 96) for the network
    phase, which slices it rather than building it again."""
    from flowsim_tpu_torch import api, trees
    from flowsim_tpu_torch.ops.cuda import build, fused_batched, fused_newton as fn
    from flowsim_tpu_torch.ops.cuda.fused_batched import fused_simulate_batched, fused_simulate_batched_plain
    from flowsim_tpu_torch.ops.cuda.fused_newton import fused_simulate, fused_simulate_plain
    from flowsim_tpu_torch.parallel import ensemble

    rec = {}
    t0 = time.perf_counter()
    solver = table_reach_solver(dev)
    rec["api_build_seconds"] = time.perf_counter() - t0
    geo = solver.channel.geometry
    n, nt, M = geo.n_nodes, solver.number_of_time_levels, geo.area.shape[-1]
    if (n, nt, M, solver.theta) != (TABLE_NODES, TABLE_LEVELS, 1024, TABLE_THETA):
        raise AssertionError(f"table reach is not the validation case: N={n}, nt={nt}, M={M}")
    t0 = time.perf_counter()
    geo96, h96, Q96 = batch_geometry(solver, dev)
    rec["batch_geometry_build_seconds"] = time.perf_counter() - t0
    B = ENSEMBLE_MEMBERS
    sset_b = dataclasses.replace(solver.settings(TABLE_BATCH_TOL, 100), store="boundaries")
    geob = ensemble.table_roughness_ensemble(geo96, np.linspace(*TABLE_N_RANGE, B))

    def run_ensemble():
        return ensemble.batched_simulate(geob, solver.us_params, solver.ds_params, h96, Q96, sset_b,
                                         engine="fused")

    # -- the main path
    fn.launch_count = fn.lean_launch_count = 0
    fused_batched.launch_count = 0
    out = solver.run(engine="fused", tolerance=TABLE_TOL, max_iter=100, verbose=0)
    torch.cuda.synchronize()
    launches["fused_simulate_table"] = fn.launch_count
    launches["fused_simulate_table_lean"] = fn.lean_launch_count
    fn.launch_count = 0
    fused_batched.bracket_launch_count = 0
    out_e = run_ensemble()
    torch.cuda.synchronize()
    launches["fused_simulate_batched_table"] = fused_batched.launch_count
    launches["fused_simulate_batched_bracket"] = fused_batched.bracket_launch_count
    if launches["fused_simulate_table"] != 1 or launches["fused_simulate_table_lean"] != 1 \
            or launches["fused_simulate_batched_table"] != 1 or fn.launch_count != 0 \
            or fused_batched.bracket_launch_count != 1:
        raise AssertionError(f"table main path: {launches['fused_simulate_table']} single launches "
                             f"({launches['fused_simulate_table_lean']} in the lean build) and "
                             f"{fused_batched.launch_count} batched ({fused_batched.bracket_launch_count} in the "
                             "bracket build), expected 1 in the lean build and 1 in the bracket build")
    total_it = int(out.iterations.sum())
    if out.depth.shape != (nt, n) or not bool(out.converged.all()) or not bool(torch.isfinite(out.depth).all()):
        raise AssertionError("table reach: not converged or not finite")
    if out_e.depth.shape != (B, nt, 2) or not bool(out_e.converged.all()) \
            or not bool(torch.isfinite(out_e.flow).all()):
        raise AssertionError(f"table ensemble: {int((~out_e.converged.all(dim=1)).sum())} of {B} members "
                             "did not converge at every level")
    ens_iters = int(out_e.iterations.sum())
    rec["single"] = dict(build=KERNEL1_BUILD_NAMES[fn.chosen_build(1, n, table=True)], n_nodes=n,
                         n_time_levels=nt, samples=M, total_iterations=total_it,
                         max_iterations_in_a_level=int(out.iterations.max()), all_converged=True)

    # -- kernel 1's table path: the main path's run against its plain version, every level
    args = (geo, solver.us_params, solver.ds_params, solver.h0, solver.Q0, solver.settings(TABLE_TOL, 100))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_plain = fused_simulate_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    cmp = compare_runs(out, out_plain, "table reach fused vs plain")
    # kernel alone by CUDA events, packing outside: median of 5 readings
    packed = pack_one(*args)
    runs = [time_cuda(lambda: fn.launch(*packed), reps=1, warmup=int(not i)) for i in range(5)]
    events = dict(ms=statistics.median(runs), ms_runs=runs,
                  us_per_newton_iteration=statistics.median(runs) * 1e3 / total_it)
    if fn.chosen_build(1, n, table=True) != fn.LEAN_BUILD:
        raise AssertionError("one table launch does not take the lean build")
    # kernel 1's table builds on one and on many members, in turns, probed
    in_turns = table_reach_builds(dev, table_reach_launches(dev, solver, geo96, h96, Q96))
    rec["single"].update(kernel_alone_cuda_events=events, plain_compared_levels=nt, plain_ms=plain_ms, **cmp)
    rec["builds_in_turns"] = in_turns

    # -- through the api: a mixed-station reach
    mixed = mixed_reach_solver(dev)
    if not isinstance(mixed.channel.geometry, type(geo)):
        raise AssertionError("the mixed reach did not lower to tables")
    out_mk = mixed.run(engine="fused", tolerance=TABLE_TOL, verbose=0)
    out_mp = mixed.run(engine="plain", tolerance=TABLE_TOL, verbose=0)
    checks = dict(mixed_stations_api=compare_runs(out_mk, out_mp, "mixed reach, api"))
    # lateral inflow per level and node with store="boundaries", 25 levels
    lo = TABLE_OPTION_LEVELS
    a25 = cut_levels(args, lo)
    q = torch.tensor(np.random.default_rng(5).uniform(0.0, 2e-3, (lo, n)), dtype=torch.float64, device=dev)
    a25b = (*a25[:5], dataclasses.replace(a25[5], store="boundaries"))
    out_q = fused_simulate(*a25b, lateral_inflow=q)
    checks["lateral_inflow_store_boundaries"] = compare_runs(
        out_q, fused_simulate_plain(*a25b, lateral_inflow=q), "table reach, lateral inflow, store=boundaries")
    moved = float((out_q.flow[:, 1] - out.flow[:lo, -1]).abs().max())
    if out_q.depth.shape != (lo, 2) or moved < 1e-3:
        raise AssertionError(f"lateral inflow on tables: shape {tuple(out_q.depth.shape)}, moved {moved}")
    checks["lateral_inflow_store_boundaries"]["moved_outflow_by"] = moved
    # every boundary pair and the storage rows, on the tables of the same prismatic reaches
    forced_cases = {"validation_reach_193_levels": args, "lateral_inflow_store_boundaries": (*a25b, q)}
    for name in BOUNDARY_CASES:
        b = build_boundary_case(api, name, device=dev)
        ba = (as_table(b.channel.geometry), b.us_params, b.ds_params, b.h0, b.Q0, b.settings(1e-8, 100))
        checks["boundary_" + name] = compare_runs(fused_simulate(*ba), fused_simulate_plain(*ba), "table " + name)
        forced_cases["boundary_" + name] = ba
    # the lean build (kernel 1's) and the bracket build (kernel 3's table
    # batches) forced on those single launches and on the gated_blend
    # flagship's reach on tables (its curvature, which the validation reach
    # has not), against the register build bit for bit: every option and
    # boundary row
    from flowsim_tpu_torch.models.gerd_roseires import model
    sg, cg = model.build(device=dev, sim_duration=3600 * 24, smooth=False)
    forced_cases["gated_blend_25_levels"] = (as_table(cg.geometry), sg.us_params, sg.ds_params, sg.h0, sg.Q0,
                                              sg.settings(tolerance=1e-6, max_iter=100))
    for name, a in forced_cases.items():
        pk = pack_one(*a)
        reg = fn.launch(*pk, build_id=fn.REGISTER_BUILD)
        for bid in (fn.LEAN_BUILD, fn.BRACKET_BUILD):
            same_bits(fn.launch(*pk, build_id=bid), reg, f"{fn.BUILD_NAMES[bid]} vs register build, table {name}")
    checks["lean_and_bracket_builds_forced_bit_identical"] = sorted(forced_cases)
    for name in ("ds_curve_rating_losses", "both_ends"):
        sa = build_storage_case(name, dev)
        sa = (as_table(sa[0], depth_max=30.0), *sa[1:])
        checks["storage_" + name] = compare_runs(fused_simulate(*sa), fused_simulate_plain(*sa), "table " + name)
    rec["checks"] = checks

    # -- kernel 3's table path
    sset16 = solver.settings(TABLE_BATCH_TOL, 100)
    bargs = (solver.us_params, solver.ds_params, h96, Q96, sset16)
    g16 = ensemble.table_roughness_ensemble(geo96, np.linspace(*TABLE_N_RANGE, TABLE_SMALL_BATCH))
    out16 = fused_simulate_batched(g16, *bargs)
    singles = [fused_simulate(trees.member(g16, m), *bargs) for m in range(TABLE_SMALL_BATCH)]
    batched = dict(bit_identity_16_members=compare_members(out16, singles, "table batch vs single launches",
                                                       exact=True))
    # the 16 members in the bracket build forced (the wrapper gives a batch
    # of 16 the lean build), against the same single launches
    b16 = batched_launch(g16, solver.us_params, solver.ds_params, h96, Q96, sset16, fn.BRACKET_BUILD)
    batched["bit_identity_16_members_bracket_build"] = compare_members(
        b16, singles, "table batch in the bracket build vs single launches", exact=True)
    if not bool(out16.converged.all()):
        raise AssertionError("table batch: a member did not converge")
    # members of the main path's ensemble against the plain engine, every level
    picked = torch.linspace(0, B - 1, TABLE_PLAIN_MEMBERS).round().long().tolist()
    sub = trees.tree_map(lambda x: x[picked], geob)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_sub = fused_simulate_batched_plain(sub, solver.us_params, solver.ds_params, h96, Q96, sset_b)
    torch.cuda.synchronize()
    batched_plain_ms = (time.perf_counter() - t0) * 1e3
    batched["plain_members"] = dict(compare_members(prs_out_member(out_e, picked),
                                                    [prs_out_member(out_sub, m) for m in range(len(picked))],
                                                    "table ensemble vs plain", exact=False),
                                    members_of_the_timed_batch=picked, plain_ms=batched_plain_ms)
    del sub, out_sub
    # a member whose initial depth is NaN: its bracket index stays in the
    # table, it converges at no level, and the others keep their single bits
    bad = TABLE_SMALL_BATCH // 3
    h_nan = h96.expand(TABLE_SMALL_BATCH, n).clone()
    h_nan[bad, 7] = float("nan")
    out_nan = fused_simulate_batched(g16, solver.us_params, solver.ds_params, h_nan, Q96, sset16)
    sound = [m for m in range(TABLE_SMALL_BATCH) if m != bad]
    compare_members(prs_out_member(out_nan, sound), [singles[m] for m in sound],
                    "table batch: sound members beside a NaN one", exact=True)
    if bool(out_nan.converged[bad, 1:].any()):
        raise AssertionError("table batch: the NaN member converged at some level")
    nan_b = batched_launch(g16, solver.us_params, solver.ds_params, h_nan, Q96, sset16, fn.BRACKET_BUILD)
    same_bits(nan_b, out_nan, "table batch with a NaN member: bracket vs lean build")
    same_bits(batched_launch(g16, solver.us_params, solver.ds_params, h_nan, Q96, sset16, fn.REGISTER_BUILD),
              out_nan, "table batch with a NaN member: register vs lean build")
    batched["nan_member"] = dict(member=bad, levels_converged=int(out_nan.converged[bad, 1:].sum()),
                                 sound_members_bit_identical=True)
    # the 10 240 members: timed, and the build the C entry chose against the register build
    ens_runs = [wall_ms(run_ensemble) for _ in range(3)]
    ens_ms = statistics.median(ens_runs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    table_builds = (("register_build", fn.REGISTER_BUILD), ("residency_build", fn.RESIDENCY_BUILD),
                    ("bracket_build", fn.BRACKET_BUILD), ("lean_build", fn.LEAN_BUILD))
    builds = {name: dict(resident_blocks_per_sm=fn.resident_blocks(n, False, bid, table=True))
              for name, bid in table_builds}
    chosen = fn.chosen_build(B, n, table=True)
    bl = (geob, solver.us_params, solver.ds_params, h96, Q96, sset_b)
    for name, bid in table_builds:   # every build on the whole batch: the main path's bits
        same_bits(batched_launch(*bl, bid), out_e, f"table ensemble: the {name} vs the chosen build")
    builds["register_build"]["ensemble_ms"] = wall_ms(lambda: batched_launch(*bl, fn.REGISTER_BUILD))
    # the kernel alone by CUDA events, the chosen and the old build in turns
    pk = batched_packed(*bl)
    for name in ("bracket_build", "residency_build", "residency_build", "bracket_build"):
        bid = dict(table_builds)[name]
        builds[name].setdefault("kernel_alone_ms_runs", []).extend(readings(lambda: fn.launch(*pk, build_id=bid)))
    for name in ("bracket_build", "residency_build"):
        builds[name]["kernel_alone_ms"] = statistics.median(builds[name]["kernel_alone_ms_runs"])
    # the probe builds on the 10 240 members (four blocks an SM, as in the
    # run): thread 0 of block 0's cycles, member 0's iterations
    for name in ("residency_build", "bracket_build"):
        cycles = torch.zeros(len(fn.PROBE_PHASES), dtype=torch.int64, device=dev)
        clock = ctypes.c_int(0)
        po = fn.launch(*pk, build_id=dict(table_builds)[name], probe=(cycles, clock))
        same_bits(po, out_e, f"table ensemble: the {name}'s probe build")
        builds[name]["probe_member_0"] = probe_record(dict(zip(fn.PROBE_PHASES, cycles.tolist())), clock.value,
                                                      int(po.iterations[0].sum()), builds[name]["kernel_alone_ms"])
    del pk, po
    builds["ptxas"] = [k for k in kernel_builds(build.build_info["fused_newton"]["ptxas"]) if k["table"]] \
        + [dict(k, bracket_build=True) for k in bracket_kernel_builds(build.build_info["fused_newton"]["ptxas"])]
    batched["ensemble"] = dict(members=B, samples=TABLE_BATCH_SAMPLES, n_time_levels=nt, store="boundaries",
                               launches=1, all_converged=True, wall_ms_runs=ens_runs, wall_ms_median=ens_ms,
                               simulations_per_s=B / (ens_ms * 1e-3), total_newton_iterations=ens_iters,
                               chosen_build=KERNEL1_BUILD_NAMES[chosen], multiprocessors=sms, builds=builds,
                               every_build_bit_identical=True)
    rec["batched"] = batched

    # -- bounds: operations as FLOPS_TABLE_ASSEMBLY and block Thomas per node
    # and Newton iteration this run's data needed; bytes: the inputs read
    # once and the outputs written once, where of the tables only the rows an
    # evaluation reads count (a bracket is two rows of each of the seven):
    # for the single run the brackets of the stored depths of every level;
    # for the ensemble, whose interior depths are not stored, one bracket a
    # node (shared tables once, K, n_eq and dK/dA once a member)
    def bound(nbytes, flops):
        tb, tf = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F64_FLOPS * 1e3
        return max(tb, tf), ("bytes" if tb >= tf else "operations"), dict(bytes=nbytes, flops=flops)

    n_par = fn._N_PARAMS
    small = 8 * (4 * n + 2 * n + n_par)                     # rows, state, parameters
    dgrid = geo.depth_max / (M - 1)
    j = torch.clamp(torch.floor(out.depth / dgrid), 0, M - 2).long() + torch.arange(n, device=dev) * M
    rows_read = int(torch.unique(torch.cat([j, j + 1]).flatten()).numel())
    sb, sby, sterms = bound(small + 8 * (7 * rows_read + 2 * nt) + fn.output_bytes(1, n, nt, "full"),
                            total_it * n * (FLOPS_TABLE_ASSEMBLY + FLOPS_THOMAS))
    sterms["table_rows_read"] = rows_read
    Mb = TABLE_BATCH_SAMPLES
    bb, bby, bterms = bound(8 * 4 * 2 * n + B * (small + 8 * (3 * 2 * n + 2 * nt))
                            + fn.output_bytes(B, n, nt, "boundaries"),
                            ens_iters * n * (FLOPS_TABLE_ASSEMBLY + FLOPS_THOMAS))
    kernels = [
        dict(name="fused_simulate_table", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/fused_newton.cu",
             replaces="flowsim_tpu/ops/pallas/fused_newton.py:1413",
             launches=launches["fused_simulate_table"], max_abs_err=cmp["max_abs_dh"],
             ms=events["ms"], plain_ms=plain_ms, bound_ms=sb, bound_by=sby, library_ms=None, bound_terms=sterms,
             table_closures="flowsim_tpu/ops/pallas/fused_newton.py:268 _section_df_table, :317",
             build=rec["single"]["build"], us_per_newton_iteration=events["us_per_newton_iteration"],
             lean_launches=launches["fused_simulate_table_lean"],
             in_turns_ms={k: {b: v[b]["ms"] for b in TABLE_REACH_BUILDS} for k, v in in_turns.items()},
             shape=dict(n_nodes=n, samples=M, n_time_levels=nt, newton_iterations=total_it),
             tolerance=dict(depth_m=H_TOL, flow_m3s=Q_TOL, iteration_counts="identical")),
        dict(name="fused_simulate_batched_table", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/fused_newton.cu",
             replaces="flowsim_tpu/ops/pallas/fused_newton.py:2269",
             launches=launches["fused_simulate_batched_table"], max_abs_err=batched["plain_members"]["max_abs_dh"],
             ms=ens_ms, plain_ms=batched_plain_ms, bound_ms=bb, bound_by=bby, library_ms=None, bound_terms=bterms,
             table_closures="flowsim_tpu/ops/pallas/fused_newton.py:341 _section_df_table_rows, :2061-2078",
             build=KERNEL1_BUILD_NAMES[chosen], ms_over_bound=ens_ms / bb,
             bracket_launches=launches["fused_simulate_batched_bracket"],
             kernel_alone_ms=builds[KERNEL1_BUILD_NAMES[chosen]].get("kernel_alone_ms"),
             residency_build_kernel_alone_ms=builds["residency_build"]["kernel_alone_ms"],
             register_build_ms=builds["register_build"]["ensemble_ms"],
             shape=dict(members=B, n_nodes=n, samples=Mb, n_time_levels=nt, newton_iterations=ens_iters,
                        store="boundaries"),
             plain_shape=dict(members=len(picked), n_nodes=n, samples=Mb, n_time_levels=nt,
                              newton_iterations=batched["plain_members"]["iterations"], store="boundaries"),
             tolerance=dict(depth_m=H_TOL, flow_m3s=Q_TOL, iteration_counts="identical",
                            against_single_launches="bit-identical")),
    ]
    return rec, kernels, dict(solver=solver, geo96=geo96, h96=h96, Q96=Q96)



def surveyed_network(reach: dict, geo, h0, Q0, mixed: bool) -> list:
    """The surveyed-reach network: the validation reach ``geo`` with its
    initial state split at NETWORK_SPLIT_NODE into two table branches that
    share that node (the upper one takes the reach's inflow, the lower one
    its normal-depth end, junction 0 between them); ``mixed`` adds the
    trapezoid tributary at the junction (TRIB_*, at the main stem's dx, its
    own steady state) and its initial 150 m^3/s to the lower branch's flow."""
    from flowsim_tpu_torch import trees
    from flowsim_tpu_torch.geometry import interpolate_stations, trapezoid_station
    from flowsim_tpu_torch.ops import boundary as bnd
    from flowsim_tpu_torch.ops import initial_conditions as ic
    from flowsim_tpu_torch.ops import network as net

    solver = reach["solver"]
    cut, dx, dev = NETWORK_SPLIT_NODE, solver.spatial_step, h0.device
    upper = net.BranchDef(geo=trees.tree_map(lambda v: v[: cut + 1], geo), dx=dx, us=solver.us_params, ds=0,
                          h0=h0[: cut + 1], Q0=Q0[: cut + 1])
    lower = net.BranchDef(geo=trees.tree_map(lambda v: v[cut:], geo), dx=dx, us=0, ds=solver.ds_params,
                          h0=h0[cut:], Q0=Q0[cut:])
    if not mixed:
        return [upper, lower]
    z_conf = float(geo.z_bed[cut])
    station = lambda z: trapezoid_station(z_bed=z, b_main=TRIB_WIDTH, m_main=TRIB_SIDE, n_main=TRIB_N,
                                          bed_slope=TABLE_SLOPE)
    n_trib = round(TRIB_LENGTH / dx) + 1
    g_trib = interpolate_stations([station(z_conf + TRIB_LENGTH * TABLE_SLOPE), station(z_conf)],
                                  [0.0, TRIB_LENGTH], np.linspace(0.0, TRIB_LENGTH, n_trib), device=dev)
    h_trib, Q_trib = ic.initial_conditions(g_trib, "steady-state", TRIB_FLOWS[0], dx)
    q0, q1 = TRIB_FLOWS
    times = np.arange(solver.number_of_time_levels) * solver.time_step
    us = bnd.make_boundary("flow_hydrograph", bed_level=float(g_trib.z_bed[0]),
                           target_series=[q0 + (q1 - q0) * min(t / (4 * 3600.0), 1.0) for t in times], device=dev)
    trib = net.BranchDef(geo=g_trib, dx=dx, us=us, ds=0, h0=h_trib, Q0=Q_trib)
    return [upper, trib, dataclasses.replace(lower, Q0=lower.Q0 + q0)]


def cut_network_levels(branches, settings, levels: int):
    """A network run's branches and settings cut to its first ``levels``
    levels."""
    from flowsim_tpu_torch.ops import network as net

    cut = lambda e: e if net._is_junction(e) or e.kind not in ("flow_hydrograph", "stage_hydrograph") \
        else dataclasses.replace(e, target_series=e.target_series[..., :levels])
    return ([dataclasses.replace(b, us=cut(b.us), ds=cut(b.ds)) for b in branches],
            dataclasses.replace(settings, n_time_levels=levels))


def network_levels(out, levels: int):
    """The first ``levels`` levels of a single NetworkOutput."""
    return type(out)(*(tuple(x[:levels] for x in f) if isinstance(f, tuple) else f[:levels] for f in out))


def table_samples_read(branches, depths) -> int:
    """Table samples the evaluations of the stored depths read: per table
    branch, the two samples of the bracket of every level's depth at every
    node, each counted once."""
    from flowsim_tpu_torch.geometry import TableGeometry

    total = 0
    for br, d in zip(branches, depths):
        g = br.geo
        if isinstance(g, TableGeometry):
            M = g.area.shape[-1]
            j = torch.clamp(torch.floor(d / (g.depth_max / (M - 1))), 0, M - 2).long() \
                + torch.arange(d.shape[-1], device=d.device) * M
            total += int(torch.unique(torch.cat([j, j + 1]).flatten()).numel())
    return total


def drive_table_network(dev, launches: dict, reach: dict, t_start: float) -> tuple[dict, list]:
    """Surveyed branches in river networks: the table paths of kernels 5 and 6.

    The main path, counts at 0 before and read after: the surveyed-reach
    network — the table phase's validation reach (N = 121, M = 1024, 193
    levels) split at node 60 into two table branches, with the trapezoid
    tributary (mixed) and without it (all-table) — through
    ``simulate_network(engine="fused")`` (one launch of kernel 5 each, in
    its lean build with side warps), and
    the mixed network at M = 96 with NETWORK_MC_MEMBERS members through
    ``batched_simulate_network(engine="fused")`` (one launch of kernel 6, in
    its bracket build).  The branches are sliced from the table phase's
    geometry, not built again.  Then both networks against the stacked engine with the "pcr"
    solve on the card (the kernel's plain version) on their first
    TABLE_NET_COMPARED_LEVELS levels, kernel 5
    alone by CUDA events, every build the C entry can take for a table
    network forced (the same bits), the loop build's probe, the lean builds
    with and without side warps, the latency and the bracket build in turns
    with their probe builds (:func:`single_table_builds`; the lean build
    with side warps must be the fastest), and the ensemble:
    timed, every build on its members, the bracket build in turns with the
    residency build (:func:`table_ensemble_builds`, with its probe build),
    its and the lean build's forms for three RHS pairs, 256 threads, storage
    ends and the other end rows on other networks (:func:`bracket_forms`),
    B = 4 against single launches, two of its members against the plain
    version, a NaN member among 15 sound ones (also in the bracket build
    forced); B = 4 takes the lean build with side warps and is held to the
    latency build forced; 3/2 the SMs of all-table members take the lean
    build without them (:func:`lean_batch_past_one_an_sm`).
    Returns the phase record and the kernel-table rows."""
    from flowsim_tpu_torch.geometry import TableGeometry
    from flowsim_tpu_torch.ops import network as net
    from flowsim_tpu_torch.ops.cuda import build
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet
    from flowsim_tpu_torch.parallel import ensemble

    rec = dict(script_seconds_at_phase_start=time.perf_counter() - t_start)
    solver = reach["solver"]
    geo = solver.channel.geometry
    sset = solver.settings(TABLE_TOL, 100)
    nets = {"mixed": surveyed_network(reach, geo, solver.h0, solver.Q0, True),
            "all_table": surveyed_network(reach, geo, solver.h0, solver.Q0, False)}
    ens_br = surveyed_network(reach, reach["geo96"], reach["h96"], reach["Q96"], True)
    sset_e = solver.settings(TABLE_BATCH_TOL, 100)
    M = NETWORK_MC_MEMBERS
    scales = 0.9 + 0.2 * np.random.default_rng(NETWORK_MC_SEED).random(M)
    batch = scale_inflows(ens_br, scales)

    def run_ensemble():
        return ensemble.batched_simulate_network(ens_br, 1, sset_e, batch, engine="fused")

    # -- the main path
    fnet.launch_count = fnet.lean_launch_count = 0
    fnet.batched_launch_count = fnet.batched_bracket_launch_count = 0
    outs = {k: net.simulate_network(b, 1, sset, engine="fused") for k, b in nets.items()}
    torch.cuda.synchronize()
    single_launches, lean_launches = fnet.launch_count, fnet.lean_launch_count
    out_e = run_ensemble()
    torch.cuda.synchronize()
    launches["fused_simulate_network_table"] = single_launches
    launches["fused_simulate_network_table_lean"] = lean_launches
    launches["fused_simulate_network_batched_table"] = fnet.batched_launch_count
    launches["fused_simulate_network_batched_bracket"] = fnet.batched_bracket_launch_count
    if single_launches != 2 or lean_launches != 2 or fnet.batched_launch_count != 1 or fnet.launch_count != 2 \
            or fnet.batched_bracket_launch_count != 1:
        raise AssertionError(f"table network main path: {fnet.launch_count} single ({lean_launches} in the lean "
                             f"build) and {fnet.batched_launch_count} batched launches "
                             f"({fnet.batched_bracket_launch_count} in the bracket build), expected 2 (2) and 1 (1)")
    nt = sset.n_time_levels
    for k, b in nets.items():
        o = outs[k]
        if [tuple(d.shape) for d in o.depth] != [(nt, int(br.h0.shape[0])) for br in b] \
                or o.junction_stage.shape != (nt, 1) or not bool(o.converged.all()) \
                or not all(bool(torch.isfinite(d).all()) for d in o.depth + o.flow):
            raise AssertionError(f"table network {k}: wrong shape, not converged or not finite")
    if out_e.depth[0].shape != (M, nt, NETWORK_SPLIT_NODE + 1) or not bool(out_e.converged.all()) \
            or not all(bool(torch.isfinite(d).all()) for d in out_e.depth + out_e.flow):
        raise AssertionError(f"table network ensemble: {int((~out_e.converged.all(dim=1)).sum())} of {M} members "
                             "did not converge at every level, or a field is not finite")
    mixed = outs["mixed"]
    imbalance = float((mixed.flow[0][1:, -1] + mixed.flow[1][1:, -1] - mixed.flow[2][1:, 0]).abs().max())

    # -- kernel 5's table path: each network against its plain version, timed alone
    L = TABLE_NET_COMPARED_LEVELS
    singles = {}
    for k, b in nets.items():
        topo = net.stacked_topology(b)
        shape = (len(b) * topo.n_max, len(b), 1, topo.m_rhs)
        b_cut, s_cut = cut_network_levels(b, sset, L)
        t0 = time.perf_counter()
        ref = fnet.fused_simulate_network_plain(b_cut, 1, s_cut)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        cmp = compare_networks(network_levels(outs[k], L), ref, f"table network {k}: kernel vs stacked plain")
        del ref
        _, launch = network_packed(b, 1, sset)
        runs = [time_cuda(lambda: launch(-1), reps=1, warmup=int(not i)) for i in range(5)]
        chosen = fnet.chosen_build(1, *shape, table=True)
        if chosen != fnet.LEAN_SIDE_BUILD:
            raise AssertionError(f"table network {k}: the C entry chooses build {chosen}, not the lean build "
                                 "with side warps")
        # the builds the comparison of SINGLE_TABLE_BUILDS in turns (below)
        # does not hold to its bits
        builds = {}
        for name, bid in (("loop_build", fnet.LOOP_BUILD), ("residency_build", fnet.RESIDENCY_BUILD)):
            compare_networks(network_launch(b, 1, sset, build_id=bid), outs[k],
                             f"table network {k}: the {name} against the chosen build", exact=True)
            builds[name] = dict(build_id=bid, bit_identical=True,
                                ms=statistics.median(time_cuda(lambda: launch(bid), reps=1, warmup=int(not i))
                                                     for i in range(3)))
        iters = int(outs[k].iterations.sum())
        singles[k] = dict(
            branches=len(b), nodes_per_branch=list(topo.n_b), kinds=[type(br.geo).__name__ for br in b],
            samples=int(geo.area.shape[-1]), n_time_levels=nt, total_iterations=iters,
            max_iterations_in_a_level=int(outs[k].iterations.max()), all_converged=True,
            chosen_build=chosen, builds=builds,
            kernel_alone_cuda_events=dict(ms=statistics.median(runs), ms_runs=runs,
                                          us_per_newton_iteration=statistics.median(runs) * 1e3 / iters),
            plain_compared_levels=L, plain_ms=plain_ms, plain=cmp,
            table_samples_read=table_samples_read(b, outs[k].depth), topo=topo)
    # the probe builds split a mixed-network iteration by phase: the loop
    # build's here, those of SINGLE_TABLE_BUILDS with their times in turns
    # on both networks (bits against the first, the chosen)
    b = nets["mixed"]
    probed, cycles, clock = fnet.fused_simulate_network_probe(b, 1, sset, build_id=fnet.LOOP_BUILD)
    compare_networks(probed, mixed, "probe of the mixed network, the loop build", exact=True)
    probe = dict(loop_build=dict(probe_record(cycles, clock, singles["mixed"]["total_iterations"],
                                              singles["mixed"]["builds"]["loop_build"]["ms"]),
                                 bit_identical_to_production=True))
    rec["single"] = {k: {f: v for f, v in r.items() if f != "topo"} for k, r in singles.items()}
    rec["single"]["mixed"].update(probe=probe, max_junction_imbalance_m3s=imbalance)
    in_turns_single = single_table_builds(nets, sset)
    for k in nets:
        t = in_turns_single[k]
        if t["fastest"] != "lean_side_build":
            raise AssertionError(f"table network {k}: the C entry takes the lean build with side warps, but the "
                                 f"{t['fastest']} was faster in turns ({ {n: t[n]['ms'] for n in SINGLE_TABLE_BUILDS} })")
        rec["single"][k]["builds_in_turns"] = t

    # -- kernel 6's table path: the ensemble
    ens_iters = int(out_e.iterations.sum())
    ens_runs = [wall_ms(run_ensemble) for _ in range(3)]
    ens_ms = statistics.median(ens_runs)
    topo_e = net.stacked_topology(ens_br)
    shape_e = (len(ens_br) * topo_e.n_max, len(ens_br), 1, topo_e.m_rhs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chosen_e = fnet.chosen_build(M, *shape_e, table=True)
    _, launch_e = network_packed(ens_br, 1, sset_e, batch)
    ptxas = [k for k in network_kernel_builds(build.build_info["fused_network_table"]["ptxas"])
             if k["rhs"] == topo_e.m_rhs and not k["probe"] and k["table"] and not k["scratch"]
             and not k["cluster"]]
    blk = 192 if shape_e[0] <= 192 else 256
    # (launch-bound block, blocks an SM, one slot a thread, bracket, lean,
    # side warps): the lean build at M members has no side warps
    bounds = {fnet.LOOP_BUILD: (256, 1, False, False, False, False),
              fnet.LATENCY_BUILD: (256, 1, True, False, False, False),
              fnet.RESIDENCY_BUILD: (blk, 2, True, False, False, False),
              fnet.BRACKET_BUILD: (blk, 2, True, True, False, False), fnet.LEAN_BUILD: (256, 1, True, True, True, False),
              fnet.LEAN_SIDE_BUILD: (256, 1, True, True, True, True)}
    ens_builds = dict(multiprocessors=sms, chosen_build=chosen_e)
    if chosen_e != fnet.BRACKET_BUILD:
        raise AssertionError(f"table network ensemble: the C entry chooses build {chosen_e}, not the bracket build")
    for name, bid in (("loop_build", fnet.LOOP_BUILD), ("latency_build", fnet.LATENCY_BUILD),
                      ("residency_build", fnet.RESIDENCY_BUILD), ("bracket_build", fnet.BRACKET_BUILD),
                      ("lean_build", fnet.LEAN_BUILD), ("lean_side_build", fnet.LEAN_SIDE_BUILD)):
        ob = fnet._output(launch_e(bid), topo_e, None)
        for a, c in zip((*ob.depth, *ob.flow, ob.junction_stage, ob.error, ob.iterations),
                        (*out_e.depth, *out_e.flow, out_e.junction_stage, out_e.error, out_e.iterations)):
            if not torch.equal(a, c):
                raise AssertionError(f"table network ensemble: the {name} disagrees with the wrapper's build")
        del ob
        bps = fnet.resident_blocks(*shape_e, bid, table=True)
        ens_builds[name] = dict(build_id=bid, resident_blocks_per_sm=bps, members_in_flight=bps * sms,
                                ms=time_cuda(lambda: launch_e(bid), reps=2, warmup=1), bit_identical=True,
                                ptxas=[k for k in ptxas if (k["block"], k["min_blocks"], k["one_slot"], k["bracket"],
                                                            k["lean"], k["side_warps"]) == bounds[bid]])
    # the bracket build against the residency build by CUDA events in turns,
    # its probe build on the batch; its other forms on other networks
    ens_builds["in_turns"] = table_ensemble_builds(dev, ens_br, sset_e, batch, chosen_out=out_e)
    ens_builds["other_forms"] = bracket_forms(dev)
    # B = 4 against single launches, and the timed batch's first members against them
    part = [{k: trees_slice(v, TABLE_NET_BIT_MEMBERS) for k, v in d.items()} for d in batch]
    ob4 = fnet.fused_simulate_network_batched(ens_br, 1, sset_e, part)
    if fnet.chosen_build(TABLE_NET_BIT_MEMBERS, *shape_e, table=True) != fnet.LEAN_SIDE_BUILD:
        raise AssertionError("table network B=4: the C entry does not choose the lean build with side warps")
    same_network_bits(network_launch(ens_br, 1, sset_e, part, build_id=fnet.LATENCY_BUILD), ob4,
                      "table network B=4: the latency build forced vs the lean build with side warps")
    ens_builds["lean_past_one_an_sm"] = lean_batch_past_one_an_sm(dev, reach, sset_e)
    for m in range(TABLE_NET_BIT_MEMBERS):
        one = fnet.fused_simulate_network(net.member_branches(ens_br, part, m), 1, sset_e)
        compare_networks(network_member(ob4, m), one, f"table network B=4 member {m} vs its single launch",
                         exact=True)
        compare_networks(network_member(out_e, m), one, f"table network ensemble member {m} vs its single launch",
                         exact=True)
    # two members of the timed batch against the plain version, first levels
    picked = [0, M - 1]
    plain_recs, t0 = [], time.perf_counter()
    for m in picked:
        bm, sm = cut_network_levels(net.member_branches(ens_br, batch, m), sset_e, L)
        plain_recs.append(compare_networks(network_levels(network_member(out_e, m), L),
                                           fnet.fused_simulate_network_plain(bm, 1, sm),
                                           f"table network ensemble member {m} vs stacked plain"))
    torch.cuda.synchronize()
    ens_plain_ms = (time.perf_counter() - t0) * 1e3
    # a member whose upper inflow turns NaN at one level among 15 sound ones:
    # it converges at no later level, the others keep the timed batch's bits
    n16, bad, nan_level = TABLE_NET_SMALL_BATCH, TABLE_NET_SMALL_BATCH // 3, 5
    batch16 = [{k: trees_slice(v, n16) for k, v in d.items()} for d in batch]
    batch16[0]["us"] = dataclasses.replace(batch16[0]["us"], target_series=batch16[0]["us"].target_series.clone())
    batch16[0]["us"].target_series[bad, nan_level] = float("nan")
    o16 = fnet.fused_simulate_network_batched(ens_br, 1, sset_e, batch16)
    for m in range(n16):
        if m != bad:
            compare_networks(network_member(o16, m), network_member(out_e, m),
                             f"table network: sound member {m} beside a NaN one", exact=True)
    if bool(o16.converged[bad, nan_level:].any()):
        raise AssertionError("table network: the NaN member converged at a level after its NaN inflow")
    # and the bracket build forced on the same 16 members: the same bits,
    # NaN where they are NaN
    same_network_bits(network_launch(ens_br, 1, sset_e, batch16, build_id=fnet.BRACKET_BUILD), o16,
                      "table network: the bracket build beside a NaN member")
    rec["ensemble"] = dict(
        members=M, branches=len(ens_br), kinds=[type(br.geo).__name__ for br in ens_br],
        samples=int(reach["geo96"].area.shape[-1]), n_time_levels=nt, tolerance=sset_e.tolerance, store="full",
        launches=1, all_converged=True, wall_ms_runs=ens_runs, wall_ms_median=ens_ms,
        network_simulations_per_s=M / (ens_ms * 1e-3), total_newton_iterations=ens_iters,
        min_max_iterations_per_member=[int(v) for v in out_e.iterations.sum(dim=1).aminmax()],
        builds=ens_builds, bit_identity_4_members=True,
        plain_members=dict(members_of_the_timed_batch=picked, levels=L, plain_ms=ens_plain_ms,
                           iterations=sum(r["iterations"] for r in plain_recs),
                           max_abs_dh=max(r["max_abs_dh"] for r in plain_recs),
                           max_abs_dQ=max(r["max_abs_dQ"] for r in plain_recs),
                           max_abs_dY=max(r["max_abs_dY"] for r in plain_recs)),
        nan_member=dict(member=bad, nan_inflow_level=nan_level,
                        levels_converged=int(o16.converged[bad, 1:].sum()), sound_members_bit_identical=True))
    del out_e, o16, ob4

    # -- bounds: FLOPS_TABLE_ASSEMBLY on table nodes, FLOPS_ASSEMBLY on
    # trapezoid ones, the solve and junction terms as for kernels 5-6; of
    # the tables only the samples read count: the brackets of every stored
    # depth for one run, one bracket a node for the ensemble (whose members
    # share the tables)
    sm_ = singles["mixed"]
    kinds = [isinstance(br.geo, TableGeometry) for br in nets["mixed"]]
    sb, sby, sterms = network_bound(sm_["total_iterations"], sm_["topo"], 1, nt, table=kinds,
                                    table_bytes=8 * 7 * sm_["table_samples_read"])
    sterms["table_samples_read"] = sm_["table_samples_read"]
    table_nodes = sum(n for n, t in zip(topo_e.n_b, kinds) if t)
    eb, eby, eterms = network_bound(ens_iters, topo_e, 1, nt, members=M, table=kinds,
                                    table_bytes=8 * 7 * 2 * table_nodes)
    tol = dict(depth_m=H_TOL, flow_m3s=Q_TOL, junction_stage_m=NETWORK_Y_TOL, iteration_counts="identical")
    kernels = [
        dict(name="fused_simulate_network_table", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/fused_network.cu",
             replaces="flowsim_tpu/ops/pallas/fused_network.py:887",
             table_closures="flowsim_tpu/ops/pallas/fused_network.py:419, :459-467 -> "
                            "fused_newton.py:341 _section_df_table_rows",
             launches=launches["fused_simulate_network_table"], max_abs_err=sm_["plain"]["max_abs_dh"],
             ms=sm_["kernel_alone_cuda_events"]["ms"], plain_ms=sm_["plain_ms"], bound_ms=sb, bound_by=sby,
             library_ms=None, bound_terms=sterms, build=sm_["chosen_build"],
             lean_launches=launches["fused_simulate_network_table_lean"],
             us_per_newton_iteration=sm_["kernel_alone_cuda_events"]["us_per_newton_iteration"],
             all_table_ms=singles["all_table"]["kernel_alone_cuda_events"]["ms"],
             in_turns_ms={k: {b: in_turns_single[k][b]["ms"] for b in SINGLE_TABLE_BUILDS} for k in nets},
             shape=dict(network="mixed", branches=sm_["branches"], nodes_per_branch=sm_["nodes_per_branch"],
                        samples=sm_["samples"], n_time_levels=nt, newton_iterations=sm_["total_iterations"]),
             plain_shape=dict(n_time_levels=L, newton_iterations=sm_["plain"]["iterations"]),
             tolerance=tol),
        dict(name="fused_simulate_network_batched_table", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/fused_network.cu",
             replaces="flowsim_tpu/ops/pallas/fused_network.py:1904",
             table_closures="flowsim_tpu/ops/pallas/fused_network.py:1471, :1556-1580 -> "
                            "fused_newton.py:341 _section_df_table_rows",
             launches=launches["fused_simulate_network_batched_table"],
             max_abs_err=rec["ensemble"]["plain_members"]["max_abs_dh"], ms=ens_ms, plain_ms=ens_plain_ms,
             bound_ms=eb, bound_by=eby, library_ms=None, bound_terms=eterms, ms_over_bound=ens_ms / eb,
             build=chosen_e, build_ms={k: v["ms"] for k, v in ens_builds.items()
                                       if isinstance(v, dict) and "ms" in v},
             bracket_launches=launches["fused_simulate_network_batched_bracket"],
             kernel_alone_ms_in_turns={k: v["ms"] for k, v in ens_builds["in_turns"].items()
                                       if isinstance(v, dict) and "ms" in v},
             shape=dict(members=M, branches=len(ens_br), samples=rec["ensemble"]["samples"], n_time_levels=nt,
                        newton_iterations=ens_iters, store="full"),
             plain_shape=dict(members=len(picked), n_time_levels=L,
                              newton_iterations=rec["ensemble"]["plain_members"]["iterations"]),
             tolerance=dict(tol, against_single_launches="bit-identical")),
    ]
    fnet.launch_count = launches["fused_simulate_network_table"]
    fnet.batched_launch_count = launches["fused_simulate_network_batched_table"]
    return rec, kernels


def scratch_table_network(dev, nodes: int = LONG_TABLE_NODES, split: int = SCRATCH_TABLE_SPLIT, table: bool = True):
    """The scaling reach of ``nodes`` nodes (``table``: on lookup tables, M =
    32; the long-reach phase's table reach at N = 2048) split at node
    ``split`` into two branches, joined at junction 0 by a trapezoid
    tributary (TRIB_*, 4 km at the reach's dx and slope, 150 -> 300 m^3/s
    over the first hour): 3 x (split + 1) slots — at the defaults 3 x 1025,
    beyond one block's shared memory; at SCRATCH_HUGE 3 x 4097, beyond a
    cluster's.  Returns (branches, settings)."""
    from flowsim_tpu_torch import trees
    from flowsim_tpu_torch.geometry import interpolate_stations, trapezoid_station
    from flowsim_tpu_torch.ops import boundary as bnd
    from flowsim_tpu_torch.ops import initial_conditions as ic
    from flowsim_tpu_torch.ops import network as net

    geo, us, ds, h0, Q0, sset = build_long_reach(nodes, dev)
    tg = as_table(geo, samples=LONG_TABLE_SAMPLES) if table else geo
    cut, dx, slope = split, sset.spatial_step, float(geo.bed_slope[0])
    z_conf = float(geo.z_bed[cut])
    station = lambda z: trapezoid_station(z_bed=z, b_main=TRIB_WIDTH, m_main=TRIB_SIDE, n_main=TRIB_N,
                                          bed_slope=slope)
    n_trib = round(TRIB_LENGTH / dx) + 1
    g_trib = interpolate_stations([station(z_conf + TRIB_LENGTH * slope), station(z_conf)], [0.0, TRIB_LENGTH],
                                  np.linspace(0.0, TRIB_LENGTH, n_trib), device=dev)
    q0, q1 = TRIB_FLOWS
    h_trib, Q_trib = ic.initial_conditions(g_trib, "steady-state", q0, dx)
    times = np.arange(sset.n_time_levels) * sset.time_step
    trib_us = bnd.make_boundary("flow_hydrograph", bed_level=float(g_trib.z_bed[0]),
                                target_series=[q0 + (q1 - q0) * min(t / 3600.0, 1.0) for t in times], device=dev)
    return [net.BranchDef(geo=trees.tree_map(lambda v: v[: cut + 1], tg), dx=dx, us=us, ds=0, h0=h0[: cut + 1],
                          Q0=Q0[: cut + 1]),
            net.BranchDef(geo=g_trib, dx=dx, us=trib_us, ds=0, h0=h_trib, Q0=Q_trib),
            net.BranchDef(geo=trees.tree_map(lambda v: v[cut:], tg), dx=dx, us=0, ds=ds, h0=h0[cut:],
                          Q0=Q0[cut:] + q0)], sset


def scratch_sweep_bytes(slots: int, m_rhs: int) -> int:
    """Bytes one PCR sweep of the scratch build moves in a block's scratch:
    per slot its own 12 + 2 m_rhs components and its two partners' read, its
    own written."""
    return 4 * (12 + 2 * m_rhs) * 8 * slots


def same_network_bits(a, b, what: str, err_rtol: float | None = None) -> None:
    """Two network outputs (any leading member axis) bit for bit, every
    field, NaN where the other is NaN.  ``err_rtol``: the norm (``error``)
    within this relative tolerance instead — two builds that sum it in
    another order (the cluster build, rank by rank)."""
    for f, x in a._asdict().items():
        y = getattr(b, f)
        if x is None or y is None:
            if x is not y:
                raise AssertionError(f"{what}: {f} is missing from one output")
            continue
        for u, v in zip(x, y) if isinstance(x, tuple) else ((x, y),):
            if f == "error" and err_rtol is not None:
                same = torch.equal(u.isnan(), v.isnan()) and bool(
                    ((u - v).nan_to_num().abs() <= err_rtol * v.nan_to_num().abs()).all())
            elif u.is_floating_point():
                same = torch.equal(u.isnan(), v.isnan()) and torch.equal(u.nan_to_num(), v.nan_to_num())
            else:
                same = torch.equal(u, v)
            if not same:
                raise AssertionError(f"{what}: {f} is not bit-identical"
                                     + (f" (the norm: not within {err_rtol} relative)" if f == "error" else ""))


def in_turns(launches: dict, order, reps: dict) -> tuple[dict, dict]:
    """Named launches timed by CUDA events in the given order (``reps[name]``
    back-to-back calls each time, no warm-up), so that the builds share the
    card's state: the ms of each turn by name, and each name's outputs of its
    last call."""
    runs, outs = {k: [] for k in launches}, {}
    for k in order:
        outs.pop(k, None)
        last = []
        runs[k].append(time_cuda(lambda: last.__setitem__(slice(None), [launches[k]()]), reps=reps[k], warmup=0))
        outs[k] = last[0]
    return runs, outs


def cluster_vs_scratch(b, j, s_, what: str, reps_cluster: int = 3, reps_scratch: int = 1, batch=None) -> dict:
    """The cluster build (the C entry's cluster) and the scratch build forced
    on one packed network, timed in turns (cluster, scratch, scratch,
    cluster) and held to the same bits (the norm to CLUSTER_ERR_RTOL)."""
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet

    topo, launch = network_packed(b, j, s_, batch)
    runs, outs = in_turns({"cluster": lambda: launch(fnet.CLUSTER_BUILD), "scratch": lambda: launch(fnet.SCRATCH_BUILD)},
                          ("cluster", "scratch", "scratch", "cluster"),
                          dict(cluster=reps_cluster, scratch=reps_scratch))
    o_c, o_s = (fnet._output(outs[k], topo, None) for k in ("cluster", "scratch"))
    same_network_bits(o_c, o_s, f"{what}: cluster build vs scratch build", err_rtol=CLUSTER_ERR_RTOL)
    it = int(o_c.iterations.sum())
    shape = (len(b) * topo.n_max, len(b), j, topo.m_rhs)
    table = any(type(x.geo).__name__ == "TableGeometry" for x in b)
    cluster = fnet.cluster_of(*shape, table=table)
    ms_c, ms_s = statistics.median(runs["cluster"]), statistics.median(runs["scratch"])
    return dict(slots=shape[0], cluster_blocks=cluster, slots_a_rank=-(-shape[0] // cluster), iterations=it,
                cluster_ms_runs=runs["cluster"], scratch_ms_runs=runs["scratch"], cluster_ms=ms_c, scratch_ms=ms_s,
                cluster_us_per_newton_iteration=ms_c * 1e3 / it, scratch_us_per_newton_iteration=ms_s * 1e3 / it,
                scratch_over_cluster=ms_s / ms_c, bit_identical_but_the_norm=True)


def probe_pair(b, j, s_, what: str) -> dict:
    """The probe builds of the cluster and the scratch build on one network:
    µs per Newton iteration by phase, each probe's outputs the production
    build's (the cluster's norm to CLUSTER_ERR_RTOL of the scratch build's)."""
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet

    topo, launch = network_packed(b, j, s_)
    rec, outs = {}, {}
    for name, bid in (("cluster_build", fnet.CLUSTER_BUILD), ("scratch_build", fnet.SCRATCH_BUILD)):
        prod = fnet._single(fnet._output(launch(bid), topo, None))
        ms = time_cuda(lambda: launch(bid), reps=1, warmup=0)
        probed, cycles, clock = fnet.fused_simulate_network_probe(b, j, s_, build_id=bid)
        compare_networks(probed, prod, f"probe of {what}, {name}", exact=True)
        outs[name] = probed
        rec[name] = dict(probe_record(cycles, clock, int(prod.iterations.sum()), ms), bit_identical_to_production=True)
    compare_networks(outs["cluster_build"], outs["scratch_build"], f"probes of {what}", exact=True,
                     err_rtol=CLUSTER_ERR_RTOL)
    return rec


def drive_network_scratch(dev, launches: dict, reach: dict, large_basin) -> tuple[dict, list]:
    """Networks beyond one block's shared memory: the cluster build of
    kernel 5 and the scratch builds of kernels 5 and 6.

    The main path, counts at 0 before and read after: the tributary on the
    flagship at 50 m (3627 slots, 385 levels) through
    ``simulate_network(engine="fused")`` and ``gerd_tributary.network_solver(
    ...).run(engine="fused")``, the large basin (LARGE_BASIN: 5715 slots, 63
    junctions) and the basin at levels=6 (819 slots), 25 levels each, and the
    table network of :func:`scratch_table_network` through
    ``simulate_network(engine="fused")`` — one launch of kernel 5's cluster
    build each —; the N = 8192 scaling reach split at 4096 with a tributary
    (SCRATCH_HUGE: 3 x 4097 slots, beyond a cluster's shared memory), on
    trapezoids and on tables — one launch of kernel 5's scratch build each
    —; and NETWORK_MC_MEMBERS members of the tributary at 250 m (729 slots,
    385 levels, the network Monte-Carlo's inflow draws) through
    ``batched_simulate_network(engine="fused")``, one launch of kernel 6 in
    the build the C entry chooses (the scratch build: more members than one
    wave of clusters).  Then each against the plain version on the card (the
    large basin against the network phase's stacked ``cuda_pcr`` run,
    ``large_basin``); the cluster build timed in turns with the scratch build
    forced and held to its bits (the norm, summed rank by rank, to
    CLUSTER_ERR_RTOL); the probe builds of both; kernel 6 in the scratch
    build and in the cluster build's forms, in turns, and at one wave of
    clusters; B = 4 against single launches; a NaN member among 16; the
    launches the card refuses; the cluster and scratch builds forced where
    the shared-memory builds run (the bits of the chosen build, and the
    scratch build timed in turns); the ptxas figures.  ``reach``: the table
    phase's validation reach, for the mixed surveyed network.  Returns the
    phase record and the kernel-table rows."""
    from flowsim_tpu_torch.geometry import TableGeometry
    from flowsim_tpu_torch.models import basin, gerd_tributary
    from flowsim_tpu_torch.ops import network as net
    from flowsim_tpu_torch.ops.cuda import build
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet
    from flowsim_tpu_torch.parallel import ensemble

    t0 = time.perf_counter()
    ns50, b50 = gerd_tributary.network_solver(device=dev, **SCRATCH_TRIB_50)
    nj, s50 = ns50.n_junctions, ns50.settings(1e-6, 100)
    host_build_s = time.perf_counter() - t0
    bl, njl, sl = basin.build(device=dev, **LARGE_BASIN)
    b6, n6, s6 = basin.build(device=dev, **SCRATCH_BASIN)
    bt, st = scratch_table_network(dev)
    bh, sh_ = scratch_table_network(dev, *SCRATCH_HUGE, table=False)
    bht, sht = scratch_table_network(dev, *SCRATCH_HUGE)
    b250, nj250, s250, _ = gerd_tributary.build(device=dev, **SCRATCH_TRIB_250)
    M = NETWORK_MC_MEMBERS
    batch = scale_inflows(b250, 0.9 + 0.2 * np.random.default_rng(NETWORK_MC_SEED).random(M))

    def run_ensemble(part=batch):
        return ensemble.batched_simulate_network(b250, nj250, s250, part, engine="fused")

    # -- the main path
    counters = ("launch_count", "batched_launch_count", "scratch_launch_count", "batched_scratch_launch_count",
                "cluster_launch_count", "batched_cluster_launch_count")
    for c in counters:
        setattr(fnet, c, 0)
    t0 = time.perf_counter()
    out50 = net.simulate_network(b50, nj, s50, engine="fused")
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    out50_ns = ns50.run(tolerance=1e-6, verbose=0, engine="fused")
    outs = {"large_basin": net.simulate_network(bl, njl, sl, engine="fused"),
            "basin_levels6": net.simulate_network(b6, n6, s6, engine="fused"),
            "beyond_a_cluster": net.simulate_network(bh, 1, sh_, engine="fused")}
    trapezoid = (fnet.cluster_launch_count, fnet.scratch_launch_count)
    outs["table_network"] = net.simulate_network(bt, 1, st, engine="fused")
    outs["beyond_a_cluster_table"] = net.simulate_network(bht, 1, sht, engine="fused")
    torch.cuda.synchronize()
    table = (fnet.cluster_launch_count - trapezoid[0], fnet.scratch_launch_count - trapezoid[1])
    out_e = run_ensemble()
    torch.cuda.synchronize()
    count = {c: getattr(fnet, c) for c in counters}
    topo_e = net.stacked_topology(b250)
    shape_e = (len(b250) * topo_e.n_max, len(b250), nj250, topo_e.m_rhs)
    build_e = fnet.chosen_build(M, *shape_e)
    launches["fused_simulate_network_cluster"], launches["fused_simulate_network_scratch"] = trapezoid
    launches["fused_simulate_network_table_cluster"], launches["fused_simulate_network_table_scratch"] = table
    launches["fused_simulate_network_batched_scratch"] = count["batched_scratch_launch_count"]
    launches["fused_simulate_network_batched_cluster"] = count["batched_cluster_launch_count"]
    if (count["launch_count"], trapezoid, table) != (7, (4, 1), (1, 1)) or count["batched_launch_count"] != 1 \
            or (count["batched_cluster_launch_count"], count["batched_scratch_launch_count"]) \
            != (int(build_e == fnet.CLUSTER_BUILD), int(build_e == fnet.SCRATCH_BUILD)):
        raise AssertionError(f"networks beyond one block's shared memory: {count}; trapezoid (cluster, scratch) "
                             f"{trapezoid}, tables {table}; expected 7 single launches, (4, 1) and (1, 1), and one "
                             f"batched launch in build {build_e}")

    # -- the 50 m tributary: both entry points, all levels; the plain version on the first levels
    nt = s50.n_time_levels
    n_b50 = [int(b.h0.shape[0]) for b in b50]
    if n_b50 != [1201, 201, 1209] or nt != 385:
        raise AssertionError(f"the 50 m tributary is not at full width: {n_b50}, nt={nt}")
    for o, what in ((out50, "simulate_network"), (out50_ns, "NetworkSolver.run")):
        if not bool(o.converged.all()) or not all(bool(torch.isfinite(h).all()) for h in o.depth + o.flow) \
                or [tuple(d.shape) for d in o.depth] != [(nt, n) for n in n_b50] or o.junction_stage.shape != (nt, 1):
            raise AssertionError(f"50 m tributary via {what}: not converged, not finite or of the wrong shape")
    L = SCRATCH_PLAIN_LEVELS
    topo50 = net.stacked_topology(b50)
    slots50 = len(b50) * topo50.n_max
    # the wrapper's mirror of the C entry's cluster, for every network the phase runs in it
    for b, j in ((b50, nj), (bl, njl), (b6, n6), (bt, 1), (b250, nj250)):
        tp = net.stacked_topology(b)
        shape = (len(b) * tp.n_max, len(b), j, tp.m_rhs)
        if fnet.cluster_blocks(*shape) != fnet.cluster_of(*shape, table=any(isinstance(x.geo, TableGeometry)
                                                                            for x in b)):
            raise AssertionError(f"cluster_blocks{shape} differs from the C entry's cluster")
    b50c, s50c = cut_network_levels(b50, s50, L)
    t0 = time.perf_counter()
    ref50 = fnet.fused_simulate_network_plain(b50c, nj, s50c)
    torch.cuda.synchronize()
    plain50_ms = (time.perf_counter() - t0) * 1e3
    cmp50 = compare_networks(network_levels(out50, L), ref50, "50 m tributary: cluster build vs plain")
    del ref50
    turns50 = {f"levels_{L}": cluster_vs_scratch(b50c, nj, s50c, f"50 m tributary, {L} levels"),
               f"levels_{nt}": cluster_vs_scratch(b50, nj, s50, "50 m tributary", reps_cluster=2)}
    ms50c, ms50 = turns50[f"levels_{L}"]["cluster_ms"], turns50[f"levels_{nt}"]["cluster_ms"]
    it50 = int(out50.iterations.sum())
    trib50 = dict(
        nodes_per_branch=n_b50, slots=slots50, rhs_pairs=topo50.m_rhs, n_time_levels=nt, host_build_seconds=host_build_s,
        all_converged=True, total_iterations=it50, max_iterations_in_a_level=int(out50.iterations.max()),
        first_launch_ms=first_ms, kernel_ms=ms50, us_per_newton_iteration=ms50 * 1e3 / it50, sweeps=sweeps(topo50.n_max),
        in_turns_with_the_scratch_build=turns50,
        via_network_solver=dict(iterations=int(out50_ns.iterations.sum()), max_abs_dh_vs_simulate_network=max(
            float((a - b).abs().max()) for a, b in zip(out50_ns.depth, out50.depth))),
        max_junction_imbalance_m3s=float((out50.flow[0][1:, -1] + out50.flow[1][1:, -1]
                                          - out50.flow[2][1:, 0]).abs().max()),
        plain=dict(cmp50, kernel_ms=ms50c, plain_ms=plain50_ms))

    # -- the basins, the table network and the networks beyond a cluster against the plain version
    others = {}
    for name, (b, j, s_) in (("large_basin", (bl, njl, sl)), ("basin_levels6", (b6, n6, s6)),
                             ("table_network", (bt, 1, st)), ("beyond_a_cluster", (bh, 1, sh_)),
                             ("beyond_a_cluster_table", (bht, 1, sht))):
        o = outs[name]
        topo = net.stacked_topology(b)
        t0 = time.perf_counter()
        ref = large_basin if name == "large_basin" else fnet.fused_simulate_network_plain(b, j, s_)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        what = "stacked cuda_pcr (the network phase's run)" if name == "large_basin" else "plain"
        beyond = name.startswith("beyond")
        cmp = compare_networks(o, ref, f"{name}: {'scratch' if beyond else 'cluster'} build vs {what}")
        del ref
        it = int(o.iterations.sum())
        slots = len(b) * topo.n_max
        rec = dict(branches=len(b), junctions=j, slots=slots, rhs_pairs=topo.m_rhs, n_time_levels=s_.n_time_levels,
                   kinds=sorted({type(br.geo).__name__ for br in b}), all_converged=True, total_iterations=it,
                   sweeps=sweeps(topo.n_max), against=what, plain=dict(cmp, plain_ms=None if name == "large_basin"
                                                                        else plain_ms), topo=topo)
        if beyond:
            if fnet.cluster_blocks(slots, len(b), j, topo.m_rhs) != 0:
                raise AssertionError(f"{name}: {slots} slots fit a cluster")
            _, launch = network_packed(b, j, s_)
            ms = time_cuda(lambda: launch(-1), reps=2, warmup=1)
            rec.update(kernel_ms=ms, us_per_newton_iteration=ms * 1e3 / it,
                       scratch_bytes=fnet.scratch_bytes(1, slots, topo.m_rhs),
                       scratch_bytes_per_sweep=scratch_sweep_bytes(slots, topo.m_rhs))
        else:
            turn = cluster_vs_scratch(b, j, s_, name)
            rec.update(kernel_ms=turn["cluster_ms"], us_per_newton_iteration=turn["cluster_us_per_newton_iteration"],
                       in_turns_with_the_scratch_build=turn)
        others[name] = rec
    del large_basin
    # refused: a cluster build forced on a network beyond a cluster's shared
    # memory, a cluster of 17 blocks, the two-blocks-an-SM form on ranks of
    # more than 192 slots — each raises with the C entry's code, and no
    # other build runs in its place
    refusals = {}
    for name, (b, j, s_, cluster) in (("beyond_a_cluster", (bh, 1, sh_, 0)), ("cluster_of_17", (b50, nj, s50, 17)),
                                      ("pair_form_242_slots_a_rank", (b50, nj, s50, 15 | fnet.CLUSTER_PAIR))):
        _, launch = network_packed(b, j, s_)
        try:
            launch(fnet.CLUSTER_BUILD, cluster)
        except RuntimeError as e:
            refusals[name] = str(e)
        else:
            raise AssertionError(f"{name}: the cluster build was not refused")

    # -- probes of the cluster and the scratch build
    probes = {f"tributary_50m_{L}_levels": probe_pair(b50c, nj, s50c, "the 50 m tributary"),
              "large_basin": probe_pair(bl, njl, sl, "the large basin")}

    # -- kernel 6: the ensemble, timed; B = 4 against single launches; two
    # members against the plain version; a NaN member among 16
    n250 = [int(b.h0.shape[0]) for b in b250]
    if n250 != [241, 41, 243] or out_e.depth[0].shape != (M, nt, 241) or not bool(out_e.converged.all()) \
            or not all(bool(torch.isfinite(d).all()) for d in out_e.depth + out_e.flow):
        raise AssertionError(f"250 m tributary ensemble: {n250} nodes, {int((~out_e.converged.all(dim=1)).sum())} "
                             f"of {M} members not converged at every level, or a field not finite")
    ens_iters = int(out_e.iterations.sum())
    ens_runs = [wall_ms(run_ensemble) for _ in range(3)]
    ens_ms = statistics.median(ens_runs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid_e = fnet.scratch_grid(M, *shape_e)
    part = [{k: trees_slice(v, SCRATCH_BIT_MEMBERS) for k, v in d.items()} for d in batch]
    if fnet.chosen_build(SCRATCH_BIT_MEMBERS, *shape_e) != fnet.CLUSTER_BUILD:
        raise AssertionError(f"{SCRATCH_BIT_MEMBERS} members of the 250 m tributary do not take the cluster build")
    ob4 = fnet.fused_simulate_network_batched(b250, nj250, s250, part)
    for m in range(SCRATCH_BIT_MEMBERS):
        one = fnet.fused_simulate_network(net.member_branches(b250, part, m), nj250, s250)
        compare_networks(network_member(ob4, m), one, f"250 m tributary B=4 member {m} vs its single launch",
                         exact=True)
        compare_networks(network_member(out_e, m), one, f"250 m ensemble member {m} vs its single launch",
                         exact=True, err_rtol=None if build_e == fnet.CLUSTER_BUILD else CLUSTER_ERR_RTOL)
    del ob4
    picked, plain_recs, Lc = [M - 1], [], SCRATCH_PLAIN_LEVELS
    t0 = time.perf_counter()
    for m in picked:
        bm, sm = cut_network_levels(net.member_branches(b250, batch, m), s250, Lc)
        plain_recs.append(compare_networks(network_levels(network_member(out_e, m), Lc),
                                           fnet.fused_simulate_network_plain(bm, nj250, sm),
                                           f"250 m ensemble member {m} vs plain"))
    torch.cuda.synchronize()
    ens_plain_ms = (time.perf_counter() - t0) * 1e3
    n16, bad, nan_level = SCRATCH_NAN_MEMBERS, SCRATCH_NAN_MEMBERS // 3, 5
    batch16 = [{k: trees_slice(v, n16) for k, v in d.items()} for d in batch]
    batch16[0]["us"] = dataclasses.replace(batch16[0]["us"], target_series=batch16[0]["us"].target_series.clone())
    batch16[0]["us"].target_series[bad, nan_level] = float("nan")
    o16 = fnet.fused_simulate_network_batched(b250, nj250, s250, batch16)
    build16 = fnet.chosen_build(n16, *shape_e)
    for m in range(n16):
        if m != bad:
            compare_networks(network_member(o16, m), network_member(out_e, m),
                             f"250 m ensemble: sound member {m} beside a NaN one", exact=True,
                             err_rtol=None if build16 == build_e else CLUSTER_ERR_RTOL)
    if bool(o16.converged[bad, nan_level:].any()):
        raise AssertionError("250 m ensemble: the NaN member converged at a level after its NaN inflow")
    del o16
    # the cluster build's forms on the same members, in turns with the
    # scratch build; and at one wave of clusters, the batch the C entry
    # gives the cluster build at most
    _, launch_e = network_packed(b250, nj250, s250, batch)
    cl_e = fnet.cluster_of(*shape_e)
    forms = {"scratch_build": (fnet.SCRATCH_BUILD, 0), f"cluster_{cl_e}": (fnet.CLUSTER_BUILD, cl_e),
             "cluster_2_loop_form": (fnet.CLUSTER_BUILD, 2), "cluster_4": (fnet.CLUSTER_BUILD, 4),
             "cluster_4_two_an_sm": (fnet.CLUSTER_BUILD, 4 | fnet.CLUSTER_PAIR)}
    order = ["scratch_build", *[k for k in forms if k != "scratch_build"], "scratch_build"]
    runs_f, ref_f = {k: [] for k in forms}, None
    for k in order:
        bid, cl = forms[k]
        last = []
        runs_f[k].append(time_cuda(lambda: last.append(launch_e(bid, cl)), reps=1, warmup=0))
        o = fnet._output(last[0], topo_e, None)
        if ref_f is None:
            ref_f = o
        else:
            same_network_bits(o, ref_f, f"250 m ensemble, {k} vs the scratch build", err_rtol=CLUSTER_ERR_RTOL)
        del last, o
    del ref_f
    wave = fnet.scratch_grid(M, *shape_e, fnet.CLUSTER_BUILD) // cl_e
    if fnet.chosen_build(wave, *shape_e) != fnet.CLUSTER_BUILD or fnet.chosen_build(wave + 1, *shape_e) == \
            fnet.CLUSTER_BUILD:
        raise AssertionError(f"the C entry does not give the cluster build exactly the batches of up to one wave "
                             f"({wave} clusters)")
    bw = [{k: trees_slice(v, wave) for k, v in d.items()} for d in batch]
    _, launch_w = network_packed(b250, nj250, s250, bw)
    runs_w, outs_w = in_turns({"cluster": lambda: launch_w(fnet.CLUSTER_BUILD), "scratch":
                               lambda: launch_w(fnet.SCRATCH_BUILD)}, ("cluster", "scratch", "scratch", "cluster"),
                              dict(cluster=1, scratch=1))
    same_network_bits(*(fnet._output(outs_w[k], topo_e, None) for k in ("cluster", "scratch")),
                      f"one wave of {wave} members: cluster vs scratch build", err_rtol=CLUSTER_ERR_RTOL)
    del outs_w
    forms_rec = dict(ms_runs=runs_f, ms={k: statistics.median(v) for k, v in runs_f.items()}, order=order,
                     bit_identical_but_the_norm=True,
                     one_wave=dict(members=wave, cluster_ms_runs=runs_w["cluster"], scratch_ms_runs=runs_w["scratch"],
                                   chosen_build=fnet.CLUSTER_BUILD))
    ensemble_rec = dict(
        members=M, nodes_per_branch=n250, slots=shape_e[0], rhs_pairs=topo_e.m_rhs, n_time_levels=nt, store="full",
        launches=1, build=build_e, all_converged=True, wall_ms_runs=ens_runs, wall_ms_median=ens_ms,
        network_simulations_per_s=M / (ens_ms * 1e-3), total_newton_iterations=ens_iters,
        min_max_iterations_per_member=[int(v) for v in out_e.iterations.sum(dim=1).aminmax()],
        output_bytes=fnet.output_bytes(M, len(b250), topo_e.n_max, nj250, nt), multiprocessors=sms,
        resident_blocks_per_sm=fnet.resident_blocks(*shape_e, fnet.SCRATCH_BUILD), grid=grid_e,
        scratch_bytes=fnet.scratch_bytes(grid_e, shape_e[0], topo_e.m_rhs),
        scratch_bytes_one_a_member=fnet.scratch_bytes(M, shape_e[0], topo_e.m_rhs),
        scratch_bytes_per_sweep=grid_e * scratch_sweep_bytes(shape_e[0], topo_e.m_rhs),
        bit_identity_4_members=True, cluster_forms_in_turns=forms_rec,
        plain_members=dict(members_of_the_timed_batch=picked, levels=Lc, plain_ms=ens_plain_ms,
                           iterations=sum(r["iterations"] for r in plain_recs),
                           max_abs_dh=max(r["max_abs_dh"] for r in plain_recs),
                           max_abs_dQ=max(r["max_abs_dQ"] for r in plain_recs),
                           max_abs_dY=max(r["max_abs_dY"] for r in plain_recs)),
        nan_member=dict(member=bad, nan_inflow_level=nan_level, build=build16, sound_members_bit_identical=True))
    del out_e

    # -- the scratch and the cluster build forced where the shared-memory
    # builds run: the bits of the build the C entry chooses; the scratch
    # build timed in turns with it
    br, nj1, s1, _ = gerd_tributary.build(device=dev)
    b5, n5, s5 = basin.build(levels=5, device=dev)
    solver = reach["solver"]
    mixed = surveyed_network(reach, solver.channel.geometry, solver.h0, solver.Q0, True)
    batch1 = scale_inflows(br, 0.9 + 0.2 * np.random.default_rng(NETWORK_MC_SEED).random(M))
    forced = {}
    for name, (b, j, s_, bb) in (("tributary_385", (br, nj1, s1, None)), ("basin_levels5", (b5, n5, s5, None)),
                                 ("surveyed_mixed_193", (mixed, 1, solver.settings(TABLE_TOL, 100), None)),
                                 ("tributary_1024_members", (br, nj1, s1, batch1))):
        topo, launch = network_packed(b, j, s_, bb)
        table = any(isinstance(x.geo, TableGeometry) for x in b)
        members = 1 if bb is None else M
        chosen = fnet.chosen_build(members, len(b) * topo.n_max, len(b), j, topo.m_rhs, table=table)
        # every field of every member at once (a leading member axis)
        o_c = fnet._output(launch(chosen), topo, None)
        o_s = fnet._output(launch(fnet.SCRATCH_BUILD), topo, None)
        same_network_bits(o_s, o_c, f"{name}: scratch build vs build {chosen}")
        del o_s
        if bb is None:
            o_k = fnet._output(launch(fnet.CLUSTER_BUILD), topo, None)
            same_network_bits(o_k, o_c, f"{name}: cluster build vs build {chosen}", err_rtol=CLUSTER_ERR_RTOL)
            del o_k
        iterations = int(o_c.iterations.sum())
        del o_c
        runs = {"chosen_build": [], "scratch_build": []}
        ids = dict(chosen_build=chosen, scratch_build=fnet.SCRATCH_BUILD)
        for key in ("chosen_build", "scratch_build", "scratch_build", "chosen_build"):
            runs[key].append(time_cuda(lambda: launch(ids[key]), reps=1 if bb is not None else 3, warmup=1))
        forced[name] = dict(members=members, chosen_build=chosen, slots=len(b) * topo.n_max,
                            iterations=iterations, bit_identical=True,
                            cluster_bit_identical_but_the_norm=bb is None,
                            cluster=fnet.cluster_of(len(b) * topo.n_max, len(b), j, topo.m_rhs, table=table),
                            scratch_grid=fnet.scratch_grid(members, len(b) * topo.n_max, len(b), j, topo.m_rhs,
                                                           table=table),
                            **{f"{k}_ms_runs": v for k, v in runs.items()})
    # B = 4 tributary members in the cluster build forced, against their
    # single launches in it (bit for bit) and in the latency build
    part1 = [{k: trees_slice(v, SCRATCH_BIT_MEMBERS) for k, v in d.items()} for d in batch1]
    topo1, launch4 = network_packed(br, nj1, s1, part1)
    o4 = fnet._output(launch4(fnet.CLUSTER_BUILD), topo1, None)
    for m in range(SCRATCH_BIT_MEMBERS):
        b_m = net.member_branches(br, part1, m)
        one_c = network_launch(b_m, nj1, s1, build_id=fnet.CLUSTER_BUILD)
        compare_networks(network_member(o4, m), one_c, f"tributary B=4 member {m}, cluster build, vs its single "
                         "launch", exact=True)
        compare_networks(network_member(o4, m), network_launch(b_m, nj1, s1, build_id=fnet.LATENCY_BUILD),
                         f"tributary B=4 member {m}, cluster build, vs the latency build", exact=True,
                         err_rtol=CLUSTER_ERR_RTOL)
    del o4
    forced["tributary_4_members_cluster_vs_single_launches"] = dict(bit_identical=True)
    ptxas = {lib: [k for k in network_kernel_builds(build.build_info[lib]["ptxas"]) if k["scratch"] or k["cluster"]]
             for lib in ("fused_network", "fused_network_table")}
    record = dict(tributary_50m=trib50, **{k: {f: v for f, v in r.items() if f != "topo"} for k, r in others.items()},
                  ensemble_250m=ensemble_rec, probes=probes, refusals=refusals,
                  forced_vs_chosen_build=forced, ptxas=ptxas,
                  main_path=dict(counts=count, batch_build=build_e))

    # -- the kernel rows: bounds as for the other network rows, over the
    # compared runs
    tol = dict(depth_m=H_TOL, flow_m3s=Q_TOL, junction_stage_m=NETWORK_Y_TOL, iteration_counts="identical")
    b5b, by5, t5 = network_bound(cmp50["iterations"], topo50, nj, L)
    tn, hh, ht = others["table_network"], others["beyond_a_cluster"], others["beyond_a_cluster_table"]
    kinds = lambda bs: [isinstance(x.geo, TableGeometry) for x in bs]
    samples_read = table_samples_read(bt, outs["table_network"].depth)
    btb, bty, tt = network_bound(tn["total_iterations"], tn["topo"], 1, st.n_time_levels, table=kinds(bt),
                                 table_bytes=8 * 7 * samples_read)
    tt["table_samples_read"] = samples_read
    bhb, bhy, th = network_bound(hh["total_iterations"], hh["topo"], 1, sh_.n_time_levels)
    samples_h = table_samples_read(bht, outs["beyond_a_cluster_table"].depth)
    bhtb, bhty, tht = network_bound(ht["total_iterations"], ht["topo"], 1, sht.n_time_levels, table=kinds(bht),
                                    table_bytes=8 * 7 * samples_h)
    tht["table_samples_read"] = samples_h
    b6b, by6, t6 = network_bound(ens_iters, topo_e, nj250, nt, members=M)
    src, k5, k6 = "flowsim_tpu_torch/ops/cuda/csrc/fused_network.cu", "flowsim_tpu/ops/pallas/fused_network.py:887", \
        "flowsim_tpu/ops/pallas/fused_network.py:1904"
    t25 = turns50[f"levels_{L}"]
    kernels = [
        dict(name="fused_simulate_network_cluster", route="cuda", source=src, replaces=k5,
             launches=launches["fused_simulate_network_cluster"],
             max_abs_err=max(cmp50["max_abs_dh"], others["large_basin"]["plain"]["max_abs_dh"],
                             others["basin_levels6"]["plain"]["max_abs_dh"]),
             ms=ms50c, plain_ms=plain50_ms, bound_ms=b5b, bound_by=by5, library_ms=None, build="cluster",
             cluster_blocks=t25["cluster_blocks"], bound_terms=t5, scratch_build_ms=t25["scratch_ms"],
             ms_385_levels=ms50, scratch_build_ms_385_levels=turns50[f"levels_{nt}"]["scratch_ms"],
             us_per_newton_iteration=trib50["us_per_newton_iteration"],
             large_basin_ms=others["large_basin"]["kernel_ms"],
             large_basin_scratch_build_ms=others["large_basin"]["in_turns_with_the_scratch_build"]["scratch_ms"],
             basin_levels6_ms=others["basin_levels6"]["kernel_ms"],
             shape=dict(network="tributary, 50 m", branches=len(b50), slots=slots50, n_time_levels=L,
                        newton_iterations=cmp50["iterations"]),
             tolerance=dict(tol, against_the_scratch_build=f"bit-identical, the norm to {CLUSTER_ERR_RTOL} relative")),
        dict(name="fused_simulate_network_table_cluster", route="cuda", source=src, replaces=k5,
             launches=launches["fused_simulate_network_table_cluster"], max_abs_err=tn["plain"]["max_abs_dh"],
             ms=tn["kernel_ms"], plain_ms=tn["plain"]["plain_ms"], bound_ms=btb, bound_by=bty, library_ms=None,
             build="cluster (table)", cluster_blocks=tn["in_turns_with_the_scratch_build"]["cluster_blocks"],
             scratch_build_ms=tn["in_turns_with_the_scratch_build"]["scratch_ms"], bound_terms=tt,
             shape=dict(network="N = 2048 table reach split at 1024 + trapezoid tributary", slots=tn["slots"],
                        samples=LONG_TABLE_SAMPLES, n_time_levels=st.n_time_levels,
                        newton_iterations=tn["total_iterations"]),
             tolerance=dict(tol, against_the_scratch_build=f"bit-identical, the norm to {CLUSTER_ERR_RTOL} relative")),
        dict(name="fused_simulate_network_scratch", route="cuda", source=src, replaces=k5,
             launches=launches["fused_simulate_network_scratch"], max_abs_err=hh["plain"]["max_abs_dh"],
             ms=hh["kernel_ms"], plain_ms=hh["plain"]["plain_ms"], bound_ms=bhb, bound_by=bhy, library_ms=None,
             build="scratch", bound_terms=th, scratch_bytes_per_sweep=hh["scratch_bytes_per_sweep"],
             us_per_newton_iteration=hh["us_per_newton_iteration"],
             shape=dict(network="N = 8192 scaling reach split at 4096 + trapezoid tributary", slots=hh["slots"],
                        n_time_levels=sh_.n_time_levels, newton_iterations=hh["total_iterations"]),
             tolerance=tol),
        dict(name="fused_simulate_network_table_scratch", route="cuda", source=src, replaces=k5,
             launches=launches["fused_simulate_network_table_scratch"], max_abs_err=ht["plain"]["max_abs_dh"],
             ms=ht["kernel_ms"], plain_ms=ht["plain"]["plain_ms"], bound_ms=bhtb, bound_by=bhty, library_ms=None,
             build="scratch (table)", bound_terms=tht, scratch_bytes_per_sweep=ht["scratch_bytes_per_sweep"],
             shape=dict(network="N = 8192 table reach split at 4096 + trapezoid tributary", slots=ht["slots"],
                        samples=LONG_TABLE_SAMPLES, n_time_levels=sht.n_time_levels,
                        newton_iterations=ht["total_iterations"]),
             tolerance=tol),
        dict(name="fused_simulate_network_batched_scratch", route="cuda", source=src, replaces=k6,
             launches=launches["fused_simulate_network_batched_scratch"],
             max_abs_err=ensemble_rec["plain_members"]["max_abs_dh"], ms=ens_ms, plain_ms=ens_plain_ms,
             bound_ms=b6b, bound_by=by6, library_ms=None, build="scratch", bound_terms=t6, ms_over_bound=ens_ms / b6b,
             grid=grid_e, scratch_bytes=ensemble_rec["scratch_bytes"],
             scratch_bytes_per_sweep=ensemble_rec["scratch_bytes_per_sweep"],
             cluster_forms_ms=forms_rec["ms"],
             shape=dict(network="tributary, 250 m", members=M, slots=shape_e[0], n_time_levels=nt,
                        newton_iterations=ens_iters, store="full"),
             plain_shape=dict(members=len(picked), n_time_levels=Lc,
                              newton_iterations=ensemble_rec["plain_members"]["iterations"]),
             tolerance=dict(tol, against_single_launches=f"bit-identical, the norm to {CLUSTER_ERR_RTOL} relative "
                            "(the single launches take the cluster build)")),
    ]
    if build_e == fnet.CLUSTER_BUILD:
        kernels[-1]["name"] = "fused_simulate_network_batched_cluster"
        kernels[-1]["launches"] = launches["fused_simulate_network_batched_cluster"]
        kernels[-1]["build"] = "cluster"
    for c, (single, batched) in (("cluster", ("fused_simulate_network_cluster", "fused_simulate_network_batched_cluster")),
                                 ("scratch", ("fused_simulate_network_scratch", "fused_simulate_network_batched_scratch"))):
        table_row = single.replace("network_", "network_table_")
        setattr(fnet, f"{c}_launch_count", launches[single] + launches[table_row])
        setattr(fnet, f"batched_{c}_launch_count", launches[batched])
    fnet.launch_count = count["launch_count"]
    fnet.batched_launch_count = count["batched_launch_count"]
    return record, kernels


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

    # -- phase 2: build (one nvcc per source, started together); the network
    #    libraries, the slowest, finish while the checks of kernels 1-4 run
    t0 = time.perf_counter()
    build.start_all()
    network_libs = ("fused_network", "fused_network_table")
    for name in build.SOURCES:
        if name not in network_libs:
            build.load(name)
    emit("build", seconds=time.perf_counter() - t0, flags=" ".join(build.NVCC_FLAGS),
         sources={n: dict(seconds=i["seconds"], ptxas=i["ptxas"]) for n, i in build.build_info.items()})

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
    # the carried path (up to CARRIED_MAX_N nodes) against the node path, bit for bit
    pcr_paths = {}
    for n in (2, 121, 128, pcr_kernel.CARRIED_MAX_N):
        sys_n = random_system(n, seed=n, device=dev)
        x_carried = pcr_kernel.pcr_solve(*sys_n, path=pcr_kernel.PATH_CARRIED)
        x_node = pcr_kernel.pcr_solve(*sys_n, path=pcr_kernel.PATH_NODE)
        if not torch.equal(x_carried, x_node):
            raise AssertionError(f"pcr_solve N={n}: the carried path is not the node path's bits")
        pcr_paths[f"n_{n}"] = "bit-identical"
    if not torch.equal(pcr_kernel.pcr_solve(Lb, Db, Ub, bb, path=pcr_kernel.PATH_CARRIED),
                       pcr_kernel.pcr_solve(Lb, Db, Ub, bb, path=pcr_kernel.PATH_NODE)):
        raise AssertionError("pcr_solve batched: the carried path is not the node path's bits")
    pcr_paths["batched_3x121"] = "bit-identical"
    # the shared-memory attribute belongs to each device: where there is a
    # second card, both paths above 48 KB launch there after the first card's
    # launches, with the first card's bits
    pcr_paths["second_device"] = "not run: one card"
    if torch.cuda.device_count() > 1:
        for n in (pcr_kernel.CARRIED_MAX_N, pcr_kernel.SMEM_MAX_N):
            sys_n = random_system(n, seed=n, device=dev)
            x0 = pcr_kernel.pcr_solve(*sys_n)
            x1 = pcr_kernel.pcr_solve(*(t.to("cuda:1") for t in sys_n))
            if not torch.equal(x1.cpu(), x0.cpu()):
                raise AssertionError(f"pcr_solve N={n}: the second card's bits differ")
        pcr_paths["second_device"] = "bit-identical"
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
    plain_batched_ms = kernel_batched_cmp_ms = None
    # (name, flagship options, roughness, inflow scale and rating pivot shift of each member)
    for name, kw, ns, scales, pivots in (
            ("smooth_2x25", {}, [0.026, 0.044], [0.85, 1.2], (-0.1, 0.1)),
            ("gated_blend_4x25", dict(smooth=False), [0.026, 0.030, 0.036, 0.044], [0.85, 1.0, 1.1, 1.2],
             (0.0, -0.6, 0.2, -1.0))):
        solver, channel = model.build(device=dev, sim_duration=3600 * 24, **kw)
        geob = ensemble.roughness_ensemble(channel.geometry, ns)
        us_b = scaled_inflow(solver.us_params, scales)
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
        members = [prs_out_member(out_p, m) for m in range(len(ns))]
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
    # the same batch forced into the register build: single launches take the
    # latency build, so this holds the two builds to one another as kernel 3
    out_kr = batched_launch(geob, us_b, solver.ds_params, solver.h0, solver.Q0, sset, fused_newton.REGISTER_BUILD)
    batched_checks["register_build_bit_identity_8x385"] = compare_members(
        out_kr, singles, "register build batch vs single launches", exact=True)
    del out_kr
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
    # (iv) the same two batches, repeated until the batch is larger than the
    # card holds in the register build, through the wrapper: its C entry
    # then takes the residency build (what the 10 240-member ensemble runs),
    # which must give every copy the bits of the single launches
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n121 = channel.geometry.z_bed.shape[0]
    reg_bps = fused_newton.resident_blocks(n121, False, fused_newton.REGISTER_BUILD)
    res_bps = fused_newton.resident_blocks(n121, False, fused_newton.RESIDENCY_BUILD)
    copies = reg_bps * sms // 8 + 1
    if res_bps <= reg_bps:
        raise AssertionError(f"the residency build holds {res_bps} blocks an SM, the register build {reg_bps}")
    us_r = scaled_inflow(solver.us_params, np.tile(s8, copies))
    out_r = fused_simulate_batched(ensemble.roughness_ensemble(channel.geometry, np.tile(n8, copies)), us_r,
                                   solver.ds_params, solver.h0, solver.Q0, sset, us_batched=True)
    compare_members(out_r, [singles[m % 8] for m in range(8 * copies)], "residency build vs single launches",
                    exact=True)
    out_rd = fused_simulate_batched(ensemble.roughness_ensemble(channel.geometry, np.tile(n_bad, copies)),
                                    us_r, solver.ds_params, solver.h0, solver.Q0, sset, us_batched=True)
    sound_r = [m for m in range(8 * copies) if m % 8 != bad]
    compare_members(prs_out_member(out_rd, sound_r), [singles[m % 8] for m in sound_r],
                    "residency build: sound members beside diverged ones", exact=True)
    if not torch.equal(out_rd.converged, out_d.converged.repeat(copies, 1)):
        raise AssertionError("residency build: the converged flags differ from the register build's")
    batched_checks["residency_build_bit_identity_8x385"] = dict(
        members=8 * copies, distinct_members=8, levels=sset.n_time_levels,
        register_build_holds=reg_bps * sms, sound_members_beside_diverged_ones_bit_identical=True)
    del out_r, out_rd
    t0 = time.perf_counter()
    for name in network_libs:
        build.load(name)
    emit("build_network", waited_seconds=time.perf_counter() - t0,
         sources={n: dict(seconds=build.build_info[n]["seconds"], ptxas=build.build_info[n]["ptxas"])
                  for n in network_libs})
    t0 = time.perf_counter()
    network_checks = dict(check_network_kernels(dev), seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    latency_checks = dict(check_latency_build(dev), seconds=time.perf_counter() - t0)
    emit("kernels", pcr_solve=pcr_checks, pcr_solve_paths=pcr_paths, pcr_solve_oversize_raises=oversize,
         fused_simulate=fused_checks, fused_simulate_latency_vs_register=latency_checks,
         fused_simulate_refuses=refused,
         fused_simulate_batched=batched_checks, tiled_spike_solve=check_tiled_kernel(dev),
         storage=check_storage_kernels(dev), network=network_checks)

    # -- phase 3b: inside an iteration, the probe builds -----------------------
    t0 = time.perf_counter()
    emit("probe", **drive_probe(dev), seconds=time.perf_counter() - t0)

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
    flagship_build = KERNEL1_BUILD_NAMES[fused_newton.chosen_build(1, n)]
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
    fused_cmp_host_ms = statistics.median(wall_ms(lambda: fused_simulate(*cmp_args)) for _ in range(3))
    k1_events = kernel1_times(dev)
    fused_cmp_ms = k1_events["flagship_97_levels"]["ms"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_plain = fused_simulate_plain(*cmp_args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    cmp = compare_runs(out_cmp, out_plain, "flagship fused vs plain")
    emit("flagship", build=flagship_build, n_nodes=n, n_time_levels=nt, theta=solver.theta,
         total_iterations=total_it,
         max_iterations_in_a_level=int(out.iterations.max()), all_converged=True,
         launches=launches["fused_simulate"], launch_ms_runs=fused_ms_runs, launch_ms_median=fused_ms,
         us_per_newton_iteration=fused_ms * 1e3 / total_it,
         newton_node_updates_per_s=n * total_it / (fused_ms * 1e-3),
         plain_compared_levels=cmp_levels, plain_ms=plain_ms, plain_compared_levels_host_ms=fused_cmp_host_ms,
         kernel_alone_cuda_events=k1_events, **cmp)

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
    pcr_device_ms = graph_ms(lambda: pcr_kernel.pcr_solve(L, D, U, b))
    k2_times = kernel2_times(dev)
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

    # the register build's longest reach: the flagship at 125 m, N = 964
    s_long, c_long = model.build(device=dev, sim_duration=3600 * 48, spatial_step=125.0)
    la = (c_long.geometry, s_long.us_params, s_long.ds_params, s_long.h0, s_long.Q0,
          s_long.settings(tolerance=1e-6, max_iter=100))
    if s_long.number_of_nodes != fused_newton.MAX_N:
        raise AssertionError(f"the flagship at 125 m has {s_long.number_of_nodes} nodes, not {fused_newton.MAX_N}")
    out_lk = fused_simulate(*la)
    long_ms = statistics.median(wall_ms(lambda: fused_simulate(*la)) for _ in range(3))
    t0 = time.perf_counter()
    out_lp = fused_simulate_plain(*la)
    torch.cuda.synchronize()
    long_plain_ms = (time.perf_counter() - t0) * 1e3
    lcmp = compare_runs(out_lk, out_lp, "long reach fused vs plain")
    emit("long_reach", n_nodes=s_long.number_of_nodes, sweeps=sweeps(s_long.number_of_nodes),
         spatial_step=s_long.spatial_step, kernel_ms=long_ms, plain_ms=long_plain_ms,
         us_per_newton_iteration=long_ms * 1e3 / lcmp["iterations"],
         build=KERNEL1_BUILD_NAMES[fused_newton.chosen_build(1, s_long.number_of_nodes)],
         shorter_reaches=mid_checks, **lcmp)

    # -- phase 6b: reaches of 965-8192 nodes, the long build of kernels 1 and 3
    t0 = time.perf_counter()
    long_fused, long_kernels = drive_long_fused(dev, launches)
    emit("long_reach_fused", **long_fused, seconds=time.perf_counter() - t0)

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
    scaling.append(dict(members=B, ms=ens_ms, sims_per_s=B / (ens_ms * 1e-3), newton_iterations=ens_iters,
                        most_in_a_member=int(per_member.max())))
    # the two builds of the kernel: what the occupancy calculator puts on an
    # SM, what ptxas gave each, and the whole ensemble in the register build
    # (the main run above took the residency build: B is more than the card
    # holds in the register build), which must give the same bits
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    builds = dict(multiprocessors=sms)
    for name, bid in (("register_build", fused_newton.REGISTER_BUILD),
                      ("residency_build", fused_newton.RESIDENCY_BUILD),
                      ("latency_build", fused_newton.LATENCY_BUILD)):
        bps = fused_newton.resident_blocks(n, False, bid)
        builds[name] = dict(build_id=bid, resident_blocks_per_sm=bps, members_in_flight=bps * sms)
        # the first B members in this build alone, B = 1, one and two waves of SMs
        builds[name]["batch_ms"] = {}
        for members in (1, sms, 2 * sms):
            gb, ub = trees.slice_members(geob, 0, members), trees.slice_members(us_b, 0, members)
            builds[name]["batch_ms"][members] = time_cuda(lambda: batched_launch(
                gb, ub, solver.ds_params, solver.h0, solver.Q0, sset_b, bid), reps=2, warmup=1)
    kernels_128 = [k for k in kernel_builds(build.build_info["fused_newton"]["ptxas"])
                   if k["block"] == 128 and not k["storage"] and not k["table"]]
    for k in kernels_128:
        builds["register_build" if k["min_blocks"] == 1 else "residency_build"]["ptxas"] = k
    builds["latency_build"]["ptxas"] = latency_kernel_builds(build.build_info["fused_newton"]["ptxas"])
    out_reg = batched_launch(geob, us_b, solver.ds_params, solver.h0, solver.Q0, sset_b,
                             fused_newton.REGISTER_BUILD)
    if not (torch.equal(out_reg.depth, out_e.depth) and torch.equal(out_reg.flow, out_e.flow)
            and torch.equal(out_reg.iterations, out_e.iterations)):
        raise AssertionError("the register and residency builds disagree on the ensemble")
    builds["register_build"]["ensemble_ms"] = wall_ms(lambda: batched_launch(
        geob, us_b, solver.ds_params, solver.h0, solver.Q0, sset_b, fused_newton.REGISTER_BUILD))
    builds["residency_build"]["ensemble_ms"] = ens_ms
    del out_reg
    if builds["residency_build"]["resident_blocks_per_sm"] < 3:
        raise AssertionError(f"the residency build holds {builds['residency_build']} blocks an SM")
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
         scaling=scaling, builds=builds, store_full_1024=dict(members=1024, ms=full_ms, ms_store_boundaries=ends_ms,
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

    # -- phase 9: the long reach, the tiled solve's three kernels per Newton iteration
    long_records, tiled = drive_long_reach(dev, launches)
    emit("long_reach_tiled", linear_solver="cuda_tiled", against="pcr", sizes=long_records)

    # -- phase 10: the reservoir example ---------------------------------------
    emit("reservoir", **drive_reservoir(dev))

    # -- phase 11: river networks, one launch of kernel 5 per simulation ------
    t0 = time.perf_counter()
    network_keep = {}
    network, net_table = drive_network(dev, launches, network_keep)
    emit("network", **network, seconds=time.perf_counter() - t0)

    # -- phase 12: the network Monte-Carlo, one launch of kernel 6 ------------
    t0 = time.perf_counter()
    network_ens, ens_table = drive_network_ensemble(dev, launches, network_checks["batched_2x25"]["plain_ms"])
    emit("network_ensemble", **network_ens, seconds=time.perf_counter() - t0)

    # -- phase 13: irregular sections, the table paths of kernels 1 and 3 ------
    t0 = time.perf_counter()
    table, table_kernels, table_reach = drive_table(dev, launches)
    emit("table", **table, seconds=time.perf_counter() - t0)

    # -- phase 14: surveyed branches in river networks, the table paths of kernels 5 and 6
    t0 = time.perf_counter()
    table_net, table_net_kernels = drive_table_network(dev, launches, table_reach, t_start)
    emit("table_network", **table_net, seconds=time.perf_counter() - t0)

    # -- phase 15: networks beyond one block's shared memory, the scratch build of kernels 5 and 6
    t0 = time.perf_counter()
    scratch_net, scratch_kernels = drive_network_scratch(dev, launches, table_reach, network_keep.pop("large_basin"))
    del table_reach
    emit("network_scratch", **scratch_net, seconds=time.perf_counter() - t0)

    # -- the kernel table ----------------------------------------------------
    n_it = cmp["iterations"]          # iterations of the run that ms/plain_ms time
    n_par = fused_newton._N_PARAMS
    fused_bytes = 8 * (13 * n + 2 * n + 2 * cmp_levels + n_par) \
        + fused_newton.output_bytes(1, n, cmp_levels, "full")
    fused_flops = n_it * n * (FLOPS_ASSEMBLY + FLOPS_THOMAS)
    pcr_bytes = 8 * (14 * n + 2 * n)
    pcr_flops = n * FLOPS_THOMAS

    def bound(nbytes, flops):
        tb, tf = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F64_FLOPS * 1e3
        return max(tb, tf), ("bytes" if tb >= tf else "operations")

    fb, fby = bound(fused_bytes, fused_flops)
    pb, pby = bound(pcr_bytes, pcr_flops)
    # the batched kernel: the same work per Newton iteration, over the
    # iterations this ensemble's data needed; store="boundaries" outputs
    per_member_in = 8 * (13 * n + 2 * n + 2 * nt + n_par)
    bb, bby = bound(B * per_member_in + fused_newton.output_bytes(B, n, nt, "boundaries"),
                    ens_iters * n * (FLOPS_ASSEMBLY + FLOPS_THOMAS))
    kernels = [
        dict(name="fused_simulate", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/fused_newton.cu",
             replaces="flowsim_tpu/ops/pallas/fused_newton.py:1413",
             launches=launches["fused_simulate"], max_abs_err=cmp["max_abs_dh"],
             ms=fused_cmp_ms, plain_ms=plain_ms, bound_ms=fb, bound_by=fby, library_ms=None,
             # one launch of 10-20 ms: its CUDA-event time is the device's alone
             build=flagship_build, device_alone_ms=fused_cmp_ms,
             register_build_ms=k1_events["flagship_97_levels"]["register_build"]["ms"],
             ms_385_levels=k1_events["flagship_385_levels"]["ms"],
             register_build_ms_385_levels=k1_events["flagship_385_levels"]["register_build"]["ms"],
             shape=dict(n_nodes=n, n_time_levels=cmp_levels, newton_iterations=n_it),
             tolerance=dict(depth_m=H_TOL, flow_m3s=Q_TOL, iteration_counts="identical")),
        dict(name="fused_simulate_batched", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/fused_newton.cu",
             replaces="flowsim_tpu/ops/pallas/fused_newton.py:2269",
             launches=launches["fused_simulate_batched"], max_abs_err=batched_cmp["max_abs_dh"],
             ms=ens_ms, plain_ms=plain_batched_ms, bound_ms=bb, bound_by=bby, library_ms=None,
             ms_at_plain_shape=kernel_batched_cmp_ms, ms_over_bound=ens_ms / bb,
             resident_blocks_per_sm=builds["residency_build"]["resident_blocks_per_sm"],
             register_build_ms=builds["register_build"]["ensemble_ms"],
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
             device_alone_ms=pcr_device_ms, build="carried path" if n <= pcr_kernel.CARRIED_MAX_N else "node path",
             times_by_path=k2_times,
             shape=dict(n_nodes=n, systems=1),
             tolerance=dict(relative=1e-10)),
        # ms is the whole solve: stage A (this row's source) and the stage-B
        # and stage-C kernels below, launched back to back.  No single
        # PyTorch call solves a banded system of 2e6 unknowns: library_ms null
        dict(name="tiled_spike_solve", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/tiled_pcr.cu",
             replaces="flowsim_tpu/ops/pallas/tiled_pcr.py:139",
             launches=launches["tiled_spike_solve"], max_abs_err=tiled["max_abs_err"]["whole"],
             ms=tiled["solve_ms"], plain_ms=tiled["plain_solve_ms"], bound_ms=tiled["bound_ms"],
             bound_by=tiled["bound_by"], library_ms=None,
             stage_a_ms=tiled["stage_a_ms"], stage_b_ms=tiled["stage_b_ms"], stage_c_ms=tiled["stage_c_ms"],
             shape=dict(n_nodes=tiled["n_nodes"], tile=tiled["tile"], tiles=tiled["tiles"]),
             tolerance=dict(relative=TILED_REL_TOL)),
        # stage B, the reduced solve over the tile boundaries (the JAX
        # package's dense_block_thomas scan in the same jitted function)
        dict(name="tiled_spike_reduced", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/tiled_pcr.cu",
             replaces="flowsim_tpu/ops/pallas/tiled_pcr.py:179",
             launches=launches["tiled_spike_reduced"], max_abs_err=tiled["max_abs_err"]["stage_b"],
             ms=tiled["stage_b_ms"], plain_ms=tiled["stage_b_plain_ms"], bound_ms=tiled["bounds"]["stage_b"][0],
             bound_by=tiled["bounds"]["stage_b"][1], library_ms=tiled["stage_b_library_ms"],
             library_call="torch.linalg.solve, the dense 4 n_tiles system",
             shape=dict(reduced_rows=tiled["tiles"], n_nodes=tiled["n_nodes"]),
             tolerance=dict(relative=TILED_REL_TOL)),
        # stage C, the substitution of the boundary values into every node
        dict(name="tiled_spike_substitute", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/tiled_pcr.cu",
             replaces="flowsim_tpu/ops/pallas/tiled_pcr.py:184",
             launches=launches["tiled_spike_substitute"], max_abs_err=tiled["max_abs_err"]["stage_c"],
             ms=tiled["stage_c_ms"], plain_ms=tiled["stage_c_plain_ms"], bound_ms=tiled["bounds"]["stage_c"][0],
             bound_by=tiled["bounds"]["stage_c"][1], library_ms=None,
             shape=dict(n_nodes=tiled["n_nodes"], tile=tiled["tile"], tiles=tiled["tiles"]),
             tolerance=dict(relative=TILED_REL_TOL)),
    ]
    # the network kernels: the same work per slot and iteration as kernel 1
    # with 1 + couplings right-hand-side pairs, plus the junction solve
    nb, nby, _ = network_bound(net_table["iterations"], net_table["topo"], net_table["n_junctions"],
                               net_table["levels"])
    eb, eby, _ = network_bound(ens_table["iterations"], ens_table["topo"], ens_table["n_junctions"],
                               ens_table["n_time_levels"], members=ens_table["members"])
    batched4 = network_checks["batched_2x25"]
    kernels += [
        dict(name="fused_simulate_network", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/fused_network.cu",
             replaces="flowsim_tpu/ops/pallas/fused_network.py:887",
             launches=launches["fused_simulate_network"], max_abs_err=net_table["max_abs_dh"],
             ms=net_table["ms"], plain_ms=net_table["plain_ms"], bound_ms=nb, bound_by=nby, library_ms=None,
             shape=dict(branches=net_table["n_branches"], n_max=net_table["n_max"],
                        junctions=net_table["n_junctions"], n_time_levels=net_table["levels"],
                        newton_iterations=net_table["iterations"]),
             tolerance=dict(depth_m=H_TOL, flow_m3s=Q_TOL, junction_stage_m=NETWORK_Y_TOL,
                            iteration_counts="identical")),
        dict(name="fused_simulate_network_batched", route="cuda",
             source="flowsim_tpu_torch/ops/cuda/csrc/fused_network.cu",
             replaces="flowsim_tpu/ops/pallas/fused_network.py:1904",
             launches=launches["fused_simulate_network_batched"], max_abs_err=batched4["max_abs_dh"],
             ms=ens_table["ms"], plain_ms=ens_table["plain_ms"], bound_ms=eb, bound_by=eby, library_ms=None,
             ms_over_bound=ens_table["ms"] / eb, chosen_build=ens_table["builds"]["chosen_build"],
             build_ms={k: v["ms"] for k, v in ens_table["builds"].items() if isinstance(v, dict)},
             resident_blocks_per_sm={k: v["resident_blocks_per_sm"] for k, v in ens_table["builds"].items()
                                     if isinstance(v, dict)},
             shape=dict(members=ens_table["members"], branches=ens_table["n_branches"],
                        n_time_levels=ens_table["n_time_levels"], newton_iterations=ens_table["iterations"],
                        store="full"),
             plain_shape=dict(members=batched4["members"], n_time_levels=batched4["levels"],
                              newton_iterations=batched4["iterations"]),
             tolerance=dict(depth_m=H_TOL, flow_m3s=Q_TOL, junction_stage_m=NETWORK_Y_TOL,
                            iteration_counts="identical", against_single_launches="bit-identical")),
    ]
    kernels += long_kernels + table_kernels + table_net_kernels + scratch_kernels
    for kern in kernels:
        if kern["launches"] < 1:
            raise AssertionError(f"{kern['name']} was not launched on the main path")

    if "jax" in sys.modules or "flowsim_tpu" in sys.modules or "pandas" in sys.modules:
        raise AssertionError("chip_smoke.py must not import jax, flowsim_tpu or pandas")

    emit("done", seconds=time.perf_counter() - t_start,
         phase_seconds={k: v for k, v in PHASE_SECONDS.items() if k != "_since"})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# kernel 1's builds on tables, timed in turns (:func:`table_reach_builds`): the
# C entry's choice must be the faster of the first two at each launch
TABLE_REACH_BUILDS = ("lean_build", "register_build", "bracket_build")


def batch_geometry(solver, dev):
    """The validation reach at M = TABLE_BATCH_SAMPLES (its ensemble's
    tables) and its steady state: ``(geo96, h96, Q96)``."""
    from flowsim_tpu_torch.geometry_tables import build_table_geometry
    from flowsim_tpu_torch.ops import initial_conditions as ic

    n = solver.channel.geometry.n_nodes
    geo96 = build_table_geometry(table_stations(), [0.0, TABLE_LENGTH], np.linspace(0.0, TABLE_LENGTH, n),
                                 samples=TABLE_BATCH_SAMPLES, device=dev)
    h96, Q96 = ic.initial_conditions(geo96, "steady-state", 400.0, solver.spatial_step)
    return geo96, h96, Q96


def table_reach_launches(dev, solver, geo96, h96, Q96) -> dict:
    """Kernel 1's table launches its builds are held and timed on, as
    ``fused_newton.launch``'s arguments, name -> (members, packed): the
    validation reach at M = 1024 (TABLE_TOL) and at M = TABLE_BATCH_SAMPLES
    (TABLE_BATCH_TOL), TABLE_SMALL_BATCH members at M = 96 (the JAX case) and
    one full wave of the lean build (its resident blocks an SM times the
    SMs), members of ``table_roughness_ensemble`` over TABLE_N_RANGE."""
    from flowsim_tpu_torch.ops.cuda import fused_newton as fn
    from flowsim_tpu_torch.parallel import ensemble

    n = solver.channel.geometry.n_nodes
    sset = solver.settings(TABLE_BATCH_TOL, 100)
    wave = fn.resident_blocks(n, False, fn.LEAN_BUILD, table=True) * torch.cuda.get_device_properties(
        dev).multi_processor_count
    cases = {"validation_reach_m1024": (1, pack_one(solver.channel.geometry, solver.us_params, solver.ds_params,
                                                    solver.h0, solver.Q0, solver.settings(TABLE_TOL, 100))),
             "validation_reach_m96": (1, pack_one(geo96, solver.us_params, solver.ds_params, h96, Q96, sset))}
    for name, members in ((f"batch_{TABLE_SMALL_BATCH}_m96", TABLE_SMALL_BATCH), (f"wave_{wave}_m96", wave)):
        geob = ensemble.table_roughness_ensemble(geo96, np.linspace(*TABLE_N_RANGE, members))
        cases[name] = (members, batched_packed(geob, solver.us_params, solver.ds_params, h96, Q96, sset))
    return cases


def table_reach_builds(dev, cases: dict, rounds: int = 3) -> dict:
    """Kernel 1's table path on each launch of ``cases`` (name -> (members,
    packed), :func:`table_reach_launches`): each of TABLE_REACH_BUILDS
    forced, bit for bit against the register build; by
    CUDA events in turns (:func:`builds_in_turns`, ``rounds`` readings a
    turn; each build's median); and on one simulation each build's probe
    build (member 0, thread 0; its bits the production launch's).  Fails
    unless the build the C entry chooses is the faster of the first two of
    TABLE_REACH_BUILDS at each launch.  Counts no launch."""
    from flowsim_tpu_torch.ops.cuda import fused_newton as fn

    ids = {b: getattr(fn, b.upper()) for b in TABLE_REACH_BUILDS}
    compared = TABLE_REACH_BUILDS[:2]
    out = {}
    for name, (members, pk) in cases.items():
        n = int(pk[1].shape[1])
        outs = {b: fn.launch(*pk, build_id=i) for b, i in ids.items()}
        for b in ids:
            same_bits(outs[b], outs["register_build"], f"table reach {name}: the {b} vs the register build")
        iters = int(outs["register_build"].iterations.sum())
        runs = builds_in_turns(lambda i: fn.launch(*pk, build_id=i), ids, rounds)
        chosen = KERNEL1_BUILD_NAMES[fn.chosen_build(members, n, table=True)]
        rec = dict(members=members, n_nodes=n, samples=pk[13][2], total_iterations=iters, chosen_build=chosen,
                   bits="every field, against the register build")
        for b, i in ids.items():
            ms = statistics.median(runs[b])
            rec[b] = dict(build_id=i, ms_runs=runs[b], ms=ms, us_per_newton_iteration=ms * 1e3 * members / iters,
                          resident_blocks_per_sm=fn.resident_blocks(n, False, i, table=True))
            if members == 1:
                cycles = torch.zeros(len(fn.PROBE_PHASES), dtype=torch.int64, device=dev)
                clock = ctypes.c_int(0)
                probed = fn.launch(*pk, build_id=i, probe=(cycles, clock))
                same_bits(probed, outs[b], f"table reach {name}: the {b}'s probe build")
                rec[b]["probe"] = dict(probe_record(dict(zip(fn.PROBE_PHASES, cycles.tolist())), clock.value,
                                                    iters, ms), bit_identical_to_production=True)
        del outs
        rec["fastest"] = min(compared, key=lambda b: rec[b]["ms"])
        if chosen in compared and rec[chosen]["ms"] > rec[rec["fastest"]]["ms"]:
            raise AssertionError(f"table reach {name}: the C entry takes the {chosen} ({rec[chosen]['ms']:.4f} ms), "
                                 f"slower in turns than the {rec['fastest']} ({rec[rec['fastest']]['ms']:.4f} ms)")
        out[name] = rec
    return out


def table_times(dev, rounds: int = 3) -> dict:
    """Kernel 1's table builds alone (:func:`table_reach_builds` on
    :func:`table_reach_launches`): the validation reach through the api at M
    = 1024 (about a minute of host work) and at M = 96, and batches at M =
    96.  ``python3 chip_smoke.py --table-times`` prints only this."""
    solver = table_reach_solver(dev)
    cases = table_reach_launches(dev, solver, *batch_geometry(solver, dev))
    return table_reach_builds(dev, cases, rounds)


def table_ensemble_builds(dev, ens_br, sset_e, batch, chosen_out=None, rounds: int = 3) -> dict:
    """Kernel 6's table path on a batch (the surveyed mixed network's
    ensemble): the bracket build against the residency build, both forced,
    bit for bit (and against ``chosen_out``, the main path's run, when
    given), then by CUDA events in turns (forward, backward, forward,
    backward), ``rounds`` readings a turn (:func:`readings`), each build's
    median; and the bracket build's probe build on the same batch (thread 0
    of block 0, member 0), its bits those of the production launch."""
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet

    topo, launch = network_packed(ens_br, 1, sset_e, batch)
    ids = dict(bracket_build=fnet.BRACKET_BUILD, residency_build=fnet.RESIDENCY_BUILD)
    ref = fnet._output(launch(fnet.RESIDENCY_BUILD), topo, None)
    same_network_bits(fnet._output(launch(fnet.BRACKET_BUILD), topo, None), ref,
                      "table ensemble: the bracket build vs the residency build")
    if chosen_out is not None:
        same_network_bits(chosen_out, ref, "table ensemble: the main path's run vs the residency build")
    runs = builds_in_turns(launch, ids, rounds)
    rec = {b: dict(build_id=i, ms_runs=runs[b]) for b, i in ids.items()}
    for b in ids:
        rec[b]["ms"] = statistics.median(rec[b]["ms_runs"])
    # the bracket build's probe build on the batch
    shape = (len(ens_br) * topo.n_max, len(ens_br), 1, topo.m_rhs)
    members = int(ref.iterations.shape[0])
    p = fnet._pack(ens_br, 1, sset_e, batch, members, None, None, None, topo)
    cycles = torch.zeros(len(fnet.PROBE_FIELDS), dtype=torch.int64, device=dev)
    *raw, clock = fnet._launch(p, members, len(ens_br), 1, sset_e, topo, build_id=fnet.BRACKET_BUILD, probe=cycles)
    same_network_bits(fnet._output(tuple(raw), topo, None), ref, "table ensemble: bracket probe")
    rec["bracket_build"]["probe_member_0"] = probe_record(
        dict(zip(fnet.PROBE_FIELDS, cycles.tolist())), clock, int(ref.iterations[0].sum()),
        rec["bracket_build"]["ms"])
    for b, i in ids.items():
        rec[b]["smem_bytes_per_block"] = fnet.bracket_smem_bytes(*shape) if i == fnet.BRACKET_BUILD \
            else fnet.smem_bytes(*shape)
        rec[b]["resident_blocks_per_sm"] = fnet.resident_blocks(*shape, i, table=True)
    rec["bracket_build"]["bytes_per_slot"] = fnet.bracket_smem_bytes(1, 0, 0, topo.m_rhs)
    rec["fastest"] = min(ids, key=lambda b: rec[b]["ms"])
    rec["bits"] = "every field of every member"
    return rec


def lean_batch_past_one_an_sm(dev, reach: dict, sset) -> dict:
    """Kernel 6's table path between one member an SM and the latency
    build's one wave: 3/2 the card's SMs of members of the all-table
    surveyed network on the ensemble's tables (M = 96), inflows scaled
    0.9-1.1.  The C entry takes the lean build there, two blocks an SM as
    the latency build (with side warps a block holds an SM, two waves); its
    launch against the latency build and the lean build with side warps
    forced, bit for bit, and the three by CUDA events in turns
    (:func:`builds_in_turns`), where the lean build must be the fastest.
    Counts no launch."""
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet

    br = surveyed_network(reach, reach["geo96"], reach["h96"], reach["Q96"], False)
    M = torch.cuda.get_device_properties(dev).multi_processor_count * 3 // 2
    topo, launch = network_packed(br, 1, sset, scale_inflows(br, np.linspace(0.9, 1.1, M)))
    shape = (len(br) * topo.n_max, len(br), 1, topo.m_rhs)
    ids = dict(lean_build=fnet.LEAN_BUILD, lean_side_build=fnet.LEAN_SIDE_BUILD, latency_build=fnet.LATENCY_BUILD)
    chosen = fnet.chosen_build(M, *shape, table=True)
    bps = {n: fnet.resident_blocks(*shape, i, table=True) for n, i in ids.items()}
    if chosen != fnet.LEAN_BUILD or bps != dict(lean_build=2, lean_side_build=1, latency_build=2):
        raise AssertionError(f"table batch of {M}: the C entry takes build {chosen}, {bps} blocks an SM; expected "
                             "the lean build, two an SM")
    out = fnet._output(launch(-1), topo, None)
    for n in ("lean_side_build", "latency_build"):
        same_network_bits(fnet._output(launch(ids[n]), topo, None), out,
                          f"table batch of {M}: the {n} vs the lean build")
    if not bool(out.converged.all()):
        raise AssertionError(f"table batch of {M}: not converged at every level")
    runs = builds_in_turns(launch, ids)
    ms = {n: statistics.median(v) for n, v in runs.items()}
    if min(ms, key=ms.get) != "lean_build":
        raise AssertionError(f"table batch of {M}: the C entry takes the lean build, but it was not the fastest in "
                             f"turns ({ms})")
    return dict(network="all_table", members=M, slots=shape[0], samples=int(reach["geo96"].area.shape[-1]),
                chosen_build=chosen, resident_blocks_per_sm=bps, total_iterations=int(out.iterations.sum()),
                bits="every field of every member", in_turns_ms=ms, ms_runs=runs)


def gated_ends_network(dev, sim_hours: float = 2.0):
    """The basin's ``gated_outlet`` case (:func:`build_network_case`: the
    outlet through a gated rating whose controller acts) with two
    headwaters' upstream ends changed: the first to a rating through its
    initial stage and flow that falls as the stage rises (an upstream
    rating is gate-style), the second to a stage hydrograph about its
    initial stage.  Returns (branches, n_junctions, settings)."""
    from flowsim_tpu_torch.ops import boundary as bnd
    from flowsim_tpu_torch.ops import network as net
    from flowsim_tpu_torch.ops import rating_curve as rcurve

    br, nj, sset, _ = build_network_case("gated_outlet", dev, sim_hours=sim_hours)
    rated, staged = [b for b, x in enumerate(br) if not net._is_junction(x.us)][:2]
    z = lambda b: float(br[b].geo.z_bed[0])
    y = lambda b: z(b) + float(br[b].h0[0])
    rating = rcurve.make_polynomial(0.0, -30.0, float(br[rated].Q0[0]), stage_shift=-y(rated), device=dev)
    stage = y(staged) + 0.05 * np.sin(np.linspace(0.0, np.pi, sset.n_time_levels))
    br[rated] = dataclasses.replace(br[rated], us=bnd.make_boundary("rating_curve", bed_level=z(rated),
                                                                    rating=rating, device=dev))
    br[staged] = dataclasses.replace(br[staged], us=bnd.make_boundary("stage_hydrograph", bed_level=z(staged),
                                                                      target_series=stage, device=dev))
    return br, nj, sset


def bracket_forms(dev) -> dict:
    """The bracket and lean builds' forms that the surveyed networks do not
    run, every branch lowered to lookup tables (:func:`as_table`, M =
    BRACKET_FORM_SAMPLES), over two hours (9 levels of 900 s): the 15-branch
    basin (levels=4: 195 slots, so the bracket build's 256-thread instance,
    three RHS pairs, and the lean build, whose side warps that many slots
    leave no room for), the 7-branch basin draining into a lumped storage
    with a power outflow rating (:func:`storage_outlet_networks`: the
    storage end rows, three RHS pairs; the lean build, as the C entry takes
    no side warps beside a storage, and the lean build with side warps
    forced) and the 7-branch basin's gated outlet with an upstream rating
    and an upstream stage hydrograph (:func:`gated_ends_network`: the other
    end rows, in the side warps).  On each, the bracket build and the lean
    builds that take the network forced on BRACKET_FORM_MEMBERS members
    (inflows scaled 0.9-1.1) against the residency build forced, bit for
    bit; on a single launch of the same network over a day (97 levels)
    those lean builds and the latency build against the C entry's choice,
    bit for bit, and by CUDA events in turns (:func:`builds_in_turns`, five
    readings a turn, each build's median), where the C entry's choice must
    beat the latency build.  Counts no launch."""
    from flowsim_tpu_torch.models import basin
    from flowsim_tpu_torch.ops import network as net
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet

    nets = dict(basin_levels4=lambda hours: basin.build(levels=4, sim_hours=hours, device=dev),
                storage_outlet_power=lambda hours: storage_outlet_networks(dev, sim_hours=hours)["power"],
                gated_ends=lambda hours: gated_ends_network(dev, sim_hours=hours))
    names = {fnet.LEAN_SIDE_BUILD: "lean_side_build", fnet.LEAN_BUILD: "lean_build", fnet.LATENCY_BUILD: "latency_build"}
    tables = lambda br: [dataclasses.replace(b, geo=as_table(b.geo, samples=BRACKET_FORM_SAMPLES)) for b in br]
    out = {}
    for name, make in nets.items():
        br, nj, st = make(2.0)
        br = tables(br)
        batch = scale_inflows(br, np.linspace(0.9, 1.1, BRACKET_FORM_MEMBERS))
        topo, launch = network_packed(br, nj, st, batch)
        shape = (len(br) * topo.n_max, len(br), nj, topo.m_rhs)
        storage = any(x.storage is not None for b in br for x in (b.us, b.ds) if not net._is_junction(x))
        chosen = {m: fnet.chosen_build(m, *shape, table=True, storage=storage) for m in (1, BRACKET_FORM_MEMBERS)}
        # whether the side warps take the network (the C entry's choice for
        # it without a storage)
        side = fnet.chosen_build(1, *shape, table=True) == fnet.LEAN_SIDE_BUILD
        if chosen[1] not in (fnet.LEAN_BUILD, fnet.LEAN_SIDE_BUILD) or chosen[BRACKET_FORM_MEMBERS] != chosen[1] \
                or (chosen[1] == fnet.LEAN_SIDE_BUILD) != (side and not storage):
            raise AssertionError(f"bracket forms, {name}: the C entry takes builds {chosen}")
        res = fnet._output(launch(fnet.RESIDENCY_BUILD), topo, None)
        forms = [fnet.BRACKET_BUILD, fnet.LEAN_BUILD] + ([fnet.LEAN_SIDE_BUILD] if side else [])
        for bid in forms:
            same_network_bits(fnet._output(launch(bid), topo, None), res,
                              f"bracket forms, {name}: build {bid} vs the residency build")
        if not bool(res.converged.all()):
            raise AssertionError(f"bracket forms, {name}: not converged at every level")
        # one launch of a day (97 levels): the lean builds that take the
        # network and the latency build against the C entry's choice, which
        # must beat the latency build
        br1, nj1, st1 = make(24.0)
        topo1, launch1 = network_packed(tables(br1), nj1, st1)
        ids = {names[i]: i for i in names if side or i != fnet.LEAN_SIDE_BUILD}
        ref = fnet._single(fnet._output(launch1(-1), topo1, None))
        for n, i in ids.items():
            same_network_bits(fnet._single(fnet._output(launch1(i), topo1, None)), ref,
                              f"bracket forms, {name}: one launch, the {n} vs the C entry's choice")
        runs = builds_in_turns(launch1, ids, rounds=5)
        ms = {n: statistics.median(v) for n, v in runs.items()}
        if ms[names[chosen[1]]] >= ms["latency_build"] or not bool(ref.converged.all()):
            raise AssertionError(f"bracket forms, {name}: the C entry takes the {names[chosen[1]]}, but it did not "
                                 f"beat the latency build in turns ({ms}), or a level did not converge")
        out[name] = dict(branches=len(br), junctions=nj, slots=shape[0], rhs_pairs=topo.m_rhs,
                         block_threads=192 if shape[0] <= 192 else 256, storage_end=br[0].ds.storage is not None,
                         ends=sorted({x.kind for b in br for x in (b.us, b.ds) if not net._is_junction(x)}),
                         chosen=chosen, takes_side_warps=side, members=BRACKET_FORM_MEMBERS, levels=st.n_time_levels,
                         samples=BRACKET_FORM_SAMPLES, iterations=int(res.iterations.sum()),
                         bits="every field of every member", forms=forms,
                         one_launch=dict(levels=st1.n_time_levels, iterations=int(ref.iterations.sum()),
                                         in_turns_ms=ms, ms_runs=runs, fastest=min(ms, key=ms.get)))
    if (out["basin_levels4"]["rhs_pairs"], out["basin_levels4"]["block_threads"]) != (3, 256) \
            or {k: v["chosen"][1] for k, v in out.items()} != dict(
                basin_levels4=fnet.LEAN_BUILD, storage_outlet_power=fnet.LEAN_BUILD, gated_ends=fnet.LEAN_SIDE_BUILD) \
            or not out["storage_outlet_power"]["takes_side_warps"] \
            or not out["storage_outlet_power"]["storage_end"] or out["storage_outlet_power"]["rhs_pairs"] != 3 \
            or not {"rating_curve", "stage_hydrograph", "flow_hydrograph"} <= set(out["gated_ends"]["ends"]):
        raise AssertionError(f"bracket forms: not the forms meant: {out}")
    return out


# kernel 5's table builds timed against each other on single networks
# (:func:`single_table_builds`), the first the reference of their bits
SINGLE_TABLE_BUILDS = ("lean_side_build", "lean_build", "latency_build", "bracket_build")


def single_table_builds(nets: dict, sset, rounds: int = 3) -> dict:
    """Kernel 5's table path on single networks: each of SINGLE_TABLE_BUILDS
    forced on each network of ``nets``, bit for bit against the first, then
    by CUDA events in turns (forward, backward, forward, backward;
    ``rounds`` readings a turn, :func:`readings`; each build's median), and
    each build's probe build (its fields hold the split of the assembly
    phase), whose bits are the production launch's.  Counts no launch."""
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet

    ids = {n: getattr(fnet, n.upper()) for n in SINGLE_TABLE_BUILDS}
    first = SINGLE_TABLE_BUILDS[0]
    out = {}
    for k, b in nets.items():
        topo, launch = network_packed(b, 1, sset)
        outs = {n: fnet._single(fnet._output(launch(i), topo, None)) for n, i in ids.items()}
        for n in ids:
            same_network_bits(outs[n], outs[first], f"table network {k}: the {n} vs the {first}")
        runs = builds_in_turns(launch, ids, rounds)
        rec = {n: dict(build_id=i, ms_runs=runs[n]) for n, i in ids.items()}
        iters = int(outs[first].iterations.sum())
        for n, i in ids.items():
            rec[n]["ms"] = statistics.median(rec[n]["ms_runs"])
            rec[n]["us_per_newton_iteration"] = rec[n]["ms"] * 1e3 / iters
            probed, cycles, clock = fnet.fused_simulate_network_probe(b, 1, sset, build_id=i)
            same_network_bits(probed, outs[n], f"table network {k}: the {n}'s probe build")
            rec[n]["probe"] = dict(probe_record(cycles, clock, iters, rec[n]["ms"]),
                                   bit_identical_to_production=True)
        out[k] = dict(slots=len(b) * topo.n_max, threads=-(-len(b) * topo.n_max // 32) * 32,
                      chosen_build=fnet.chosen_build(1, len(b) * topo.n_max, len(b), 1, topo.m_rhs, table=True),
                      total_iterations=iters, bits=f"every field, against the {first}",
                      fastest=min(ids, key=lambda n: rec[n]["ms"]), **rec)
    return out


def table_network_times(dev, rounds: int = 3) -> dict:
    """Kernels 5 and 6's table paths alone, on tables the api samples at M =
    TABLE_BATCH_SAMPLES (rather than sliced from the M = 1024 reach, whose
    host build takes minutes): kernel 5 on the single surveyed networks,
    mixed and all-table, 193 levels at TABLE_TOL (:func:`single_table_builds`),
    with the trapezoid tributary's latency build probed beside them; kernel
    6 on 3/2 the SMs of all-table members (:func:`lean_batch_past_one_an_sm`)
    and on NETWORK_MC_MEMBERS members of the mixed network (the
    ``table_network`` phase's ensemble), the bracket and the residency build
    in turns (:func:`table_ensemble_builds`).  ``python3 chip_smoke.py
    --table-network-times`` prints only this."""
    import functools

    from flowsim_tpu_torch import api
    from flowsim_tpu_torch.ops import initial_conditions as ic

    sampled = api.build_table_geometry
    api.build_table_geometry = functools.partial(sampled, samples=TABLE_BATCH_SAMPLES)
    try:
        solver = table_reach_solver(dev)
    finally:
        api.build_table_geometry = sampled
    geo96 = solver.channel.geometry
    h96, Q96 = ic.initial_conditions(geo96, "steady-state", 400.0, solver.spatial_step)
    ens_br = surveyed_network(dict(solver=solver), geo96, h96, Q96, True)
    nets = dict(mixed=ens_br, all_table=surveyed_network(dict(solver=solver), geo96, h96, Q96, False))
    singles = single_table_builds(nets, solver.settings(TABLE_TOL, 100), rounds=rounds)
    singles["trapezoid_tributary_latency_probe"] = tributary_latency_probe(dev)
    sset_e = solver.settings(TABLE_BATCH_TOL, 100)
    batch = scale_inflows(ens_br, 0.9 + 0.2 * np.random.default_rng(NETWORK_MC_SEED).random(NETWORK_MC_MEMBERS))
    past = lean_batch_past_one_an_sm(dev, dict(solver=solver, geo96=geo96, h96=h96, Q96=Q96), sset_e)
    return dict(samples=TABLE_BATCH_SAMPLES, single=singles, lean_past_one_an_sm=past, members=NETWORK_MC_MEMBERS,
                **table_ensemble_builds(dev, ens_br, sset_e, batch, rounds=rounds))


def tributary_latency_probe(dev) -> dict:
    """The probe build of kernel 5's trapezoid latency build on the
    tributary (385 levels), its bits the production launch's: the
    trapezoid counterpart of the table builds' split assembly."""
    from flowsim_tpu_torch.models import gerd_tributary
    from flowsim_tpu_torch.ops.cuda import fused_network as fnet

    br, nj, sset, _ = gerd_tributary.build(device=dev)
    topo, launch = network_packed(br, nj, sset)
    prod = fnet._single(fnet._output(launch(fnet.LATENCY_BUILD), topo, None))
    ms = time_cuda(lambda: launch(fnet.LATENCY_BUILD), reps=3, warmup=1)
    probed, cycles, clock = fnet.fused_simulate_network_probe(br, nj, sset, build_id=fnet.LATENCY_BUILD)
    same_network_bits(probed, prod, "the tributary's latency probe build")
    return dict(slots=len(br) * topo.n_max, **probe_record(cycles, clock, int(prod.iterations.sum()), ms))


def network_times(dev, rounds: int = 3) -> dict:
    """Kernels 5 and 6 alone by CUDA events, packing outside, the build the C
    entry chooses: the tributary (385 levels), one launch, and its 1024
    members of the network Monte-Carlo's inflow draws, one launch; ``rounds``
    readings each.  ``python3 chip_smoke.py --network-times`` prints only
    this, so that two checkouts can be compared on one card."""
    from flowsim_tpu_torch.models import gerd_tributary

    br, nj, sset, _ = gerd_tributary.build(device=dev)
    batch = scale_inflows(br, 0.9 + 0.2 * np.random.default_rng(NETWORK_MC_SEED).random(NETWORK_MC_MEMBERS))
    launches = dict(tributary_385_levels=(network_packed(br, nj, sset)[1], 3),
                    tributary_1024_members=(network_packed(br, nj, sset, batch)[1], 1))
    out = {}
    for name, (launch, reps) in launches.items():
        runs = [time_cuda(launch, reps=reps, warmup=1) for _ in range(rounds)]
        out[name] = dict(ms=statistics.median(runs), ms_runs=runs)
    return out


def ptxas_figures(dev) -> dict:
    """Every kernel's ptxas figures (registers, stack, spills, static shared
    memory) by source, each source built as ``main`` builds it (one nvcc a
    source, all started together).  ``python3 chip_smoke.py --ptxas`` prints
    only this, so that two checkouts' builds can be compared."""
    from flowsim_tpu_torch.ops.cuda import build

    build.start_all()
    for name in build.SOURCES:
        build.load(name)
    return {n: dict(seconds=i["seconds"], ptxas=i["ptxas"]) for n, i in build.build_info.items()}


# kernels that gained defaulted template flags (the builds added since: the
# network kernel's bracket and lean builds, kernel 1's lean build), and the
# template arguments they had before
FLAGGED_KERNELS = {"fused_network_kernelI": 8, "fused_bracket_kernelI": 1}


def ptxas_key(kernel: str) -> str:
    """A kernel's mangled name without the anonymous namespace's hash (which
    changes with the source) and without the trailing defaulted ``false``
    template arguments of FLAGGED_KERNELS: the same key for the same build in
    two checkouts."""
    k = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "", kernel).split("EEvPK")[0]
    for name, before in FLAGGED_KERNELS.items():
        m = re.match(rf"(.*{name})((?:L[ib]\d+E)+)$", k)
        if m:
            args = re.findall(r"L[ib]\d+E", m.group(2))
            while len(args) > before and args[-1] == "Lb0E":
                args.pop()
            k = m.group(1) + "".join(args)
    return k


def ptxas_changes(parent: dict, change: dict) -> dict:
    """Two checkouts' :func:`ptxas_figures` compared build by build
    (:func:`ptxas_key`): per source the builds with the same registers,
    stack and spills, those that differ (both figures), and the builds only
    one checkout has."""
    keys = ("registers", "stack_bytes", "spill_store_bytes", "spill_load_bytes")
    out = {}
    for src in sorted(set(parent) | set(change)):
        a = {ptxas_key(r["kernel"]): r for r in parent.get(src, {}).get("ptxas", [])}
        b = {ptxas_key(r["kernel"]): r for r in change.get(src, {}).get("ptxas", [])}
        diff = {k: dict(parent={f: a[k].get(f) for f in keys}, change={f: b[k].get(f) for f in keys})
                for k in a if k in b and any(a[k].get(f) != b[k].get(f) for f in keys)}
        out[src] = dict(same=sum(1 for k in a if k in b) - len(diff), differ=diff,
                        parent_only=sorted(k for k in a if k not in b), change_only=sorted(k for k in b if k not in a))
    return out


# the measurement modes: the argument, the key of the printed JSON, the measurement
MODES = {"--kernel1-times": ("kernel1_times", kernel1_times), "--kernel2-times": ("kernel2_times", kernel2_times),
         "--network-times": ("network_times", network_times), "--sass": ("sass", lambda dev: sass_counts()),
         "--table-network-times": ("table_network_times", table_network_times),
         "--table-times": ("table_times", table_times),
         "--ptxas": ("ptxas", ptxas_figures)}


def modes_main(flags) -> int:
    """``--kernel1-times`` / ``--kernel2-times`` / ``--network-times`` /
    ``--sass`` / ``--table-network-times`` / ``--table-times`` / ``--ptxas``
    (any of them): the card's name and power limit, then one JSON line with
    each asked measurement (:func:`kernel1_times`, :func:`kernel2_times`,
    :func:`network_times`, :func:`sass_counts`, :func:`table_network_times`,
    :func:`table_times`, :func:`ptxas_figures`) as the last line."""
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    unknown = [f for f in flags if f not in MODES]
    if unknown:
        print(f"unknown arguments {unknown}; expected none or any of {list(MODES)}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    print(json.dumps({MODES[f][0]: MODES[f][1](dev) for f in flags}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(modes_main(sys.argv[1:]) if sys.argv[1:] else main())
