"""``fused_simulate``: the whole-simulation CUDA kernel and its plain version.

Counterpart of ``flowsim_tpu/ops/pallas/fused_newton.py``
(``fused_simulate``).  The kernel (``csrc/fused_newton.cu``) runs every time
level and every Newton iteration of one single-reach simulation inside one
thread block, in float64; this module packs the parameter trees into the flat
buffers the kernel reads, checks that the configuration is inside the
kernel's scope (:func:`_check_supported` raises :class:`FusedUnsupported`
otherwise — callers are NOT silently re-routed to the plain engine), launches,
and unpacks a :class:`~flowsim_tpu_torch.ops.preissmann.SimOutput`.

On CUDA tensors the wrapper launches the kernel or raises.  The plain version
:func:`fused_simulate_plain` — ``ops.preissmann.simulate`` with
``linear_solver="pcr"`` — runs only for tensors that lie on the CPU.

The same kernel on a grid of B blocks is the batched (ensemble) kernel; its
wrapper is ``ops/cuda/fused_batched.py``, which shares :func:`launch` and the
packing functions of this module (they accept a leading member axis).

Both geometry kinds run in the kernel: a :class:`TrapezoidGeometry` packs its
13 rows; a :class:`TableGeometry` (irregular sections) packs 4 rows (bed
level, table span, bed slope, curvature) and its seven lookup tables, which
stay in device memory (:func:`pack_tables`).

Reaches of up to :data:`MAX_N` nodes keep their state in shared memory; from
there to :data:`LONG_MAX_N` (the TPU kernel's limit) one simulation takes the
reach build, spread over a thread-block cluster of :data:`REACH_RANKS`
blocks with its state in their shared memory, and a batch the cluster
build, one member over the fewest blocks that hold it
(:func:`cluster_blocks`).  Neither holds a scratch; the long build (its
state in a scratch of device memory that :func:`launch` allocates) runs only
where a test hook forces it.  A lumped
storage's outflow rating may be of any kind but ``gated_blend``
(:func:`pack_storage` packs poly_n coefficients and rating tables after the
storage's own tables).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from flowsim_tpu_torch.geometry import TableGeometry, TrapezoidGeometry
from flowsim_tpu_torch.ops import preissmann as prs
from flowsim_tpu_torch.ops.cuda import build

# shared-memory footprint of the kernel: two 14-component PCR buffers plus
# h and Q, float64, per node; 227 KB per block less the static reduction area
SMEM_BYTES_PER_NODE = (2 * 14 + 2) * 8
MAX_N = 964
# the long build (N > MAX_N, up to the TPU kernel's MAX_VMEM_N): the same
# state per node, plus the previous level's state and the cell's lateral
# inflow, in a scratch of device memory the wrapper allocates per simulation
LONG_MAX_N = 8192
LONG_SCRATCH_BYTES_PER_NODE = (2 * 14 + 2 + 6) * 8
# the cluster build: the long build's state, and each node's squared
# residuals, in the shared memory of a thread-block cluster of 2-16 blocks,
# each rank at most CLUSTER_BLOCK nodes (a multiple of 32, one a thread)
CLUSTER_BLOCK = 768
CLUSTER_BYTES_PER_NODE = LONG_SCRATCH_BYTES_PER_NODE + 8
MAX_CLUSTER = 16
# the reach build: the same 296 B a node (its PCR buffers carry the inverse
# of D in D's place) over a cluster of REACH_RANKS blocks at every N, node i
# on rank i % REACH_RANKS; at most REACH_MAX_RANK_NODES nodes a rank; its
# closure lanes a node are the C entry's rule (reach_lanes)
REACH_BYTES_PER_NODE = CLUSTER_BYTES_PER_NODE
REACH_RANKS = 16
REACH_MAX_RANK_NODES = 512
# the bracket build's shared memory a node: two carried-inverse PCR buffers
# of 18 components, h, Q, 5 doubles of the previous level, the 14 bracket
# values and the bracket index
BRACKET_BYTES_PER_NODE = (2 * 18 + 2 + 5 + 14) * 8 + 4

_GEO_ROWS = ("z_bed", "b_main", "m_main", "n_main", "compound", "h_bank", "b_fp_left",
             "b_fp_right", "m_fp", "n_left", "n_right", "bed_slope", "curvature")
# a TableGeometry: its rows (TG_*), the tables the geometry alone sets (TS_*,
# shared by the members of an ensemble) and those a roughness ensemble
# rescales per member (TM_*), in csrc/reach_common.cuh's order
_TABLE_ROWS = ("z_bed", "depth_max", "bed_slope", "curvature")
_SHARED_TABLES = ("area", "perimeter", "top_width", "dR_dA")
_MEMBER_TABLES = ("conveyance", "n_eq", "dK_dA")
_BC_KINDS = {"flow_hydrograph": 0, "stage_hydrograph": 1, "fixed_depth": 2,
             "normal_depth": 3, "rating_curve": 4}
# rating kinds, csrc/reach_common.cuh's RC_*: a boundary rating is one of
# the first three, a storage's outflow rating any kind but gated_blend
_RC_KINDS = {"polynomial": 0, "blended_poly": 1, "gated_blend": 2, "poly_n": 3, "power": 4, "table": 5}
_DS_RC_KINDS = ("polynomial", "blended_poly", "gated_blend")
_US_RC_KINDS = ("polynomial", "blended_poly")   # the gate controller is downstream-only
_N_PARAMS = 32
# one boundary's storage block: surface area, min stage, bracket, beta,
# reservoir length, K_q and a 10-slot rating block
_N_STORAGE_PARAMS = 17
_ST_ON, _ST_AREA_CURVE, _ST_RATING, _ST_LOSSES, _ST_RC_SHIFT = 1, 2, 4, 8, 4
_STORAGE_RC_KINDS = ("polynomial", "blended_poly", "poly_n", "power", "table")

# the kernel's builds (csrc/fused_newton.cu): every shape up to MAX_N has the
# register build.  At N <= LATENCY_MAX_N without storage a launch that fits
# the card in one wave of the latency build (two threads a node for the
# closures) takes it; a larger batch the register build while one wave of
# that holds it, then the residency build (four blocks an SM, not two); on
# lookup tables the bracket build instead (each node's bracket cached in
# shared memory, carried-inverse sweeps).  Above MAX_N one simulation takes
# the reach build (a cluster of REACH_RANKS blocks) and a batch the cluster
# build; the long build (1024 threads, up to 8 nodes a thread, its state in
# device memory) runs only forced.  A test hook forces a build at any shape
# it takes; the C entry refuses it elsewhere (plan).
REGISTER_BUILD, RESIDENCY_BUILD, LATENCY_BUILD, LONG_BUILD, BRACKET_BUILD, CLUSTER_BUILD, REACH_BUILD = range(7)
BUILD_NAMES = {REGISTER_BUILD: "register build", RESIDENCY_BUILD: "residency build", LATENCY_BUILD: "latency build",
               LONG_BUILD: "long build", BRACKET_BUILD: "bracket build", CLUSTER_BUILD: "cluster build",
               REACH_BUILD: "reach build"}
LATENCY_MAX_N = 128
# what the C entry's refusals mean (cudaError_t)
_REFUSALS = {1: "cudaErrorInvalidValue: the build does not take this shape, or its block exceeds the card's "
                "shared memory",
             701: "cudaErrorLaunchOutOfResources: the card cannot hold one cluster of this shape at once",
             912: f"cudaErrorInvalidClusterSize: a cluster has 2-{MAX_CLUSTER} blocks"}

# phases of an iteration in the probe build, as the network kernel's
# (ops/cuda/fused_network.py): kernel 1 has no junction, and its
# back-substitution and update are one phase
PROBE_PHASES = ("level_start", "previous_level", "closures", "assembly", "sweeps", "back_substitution",
                "schur_rows", "junction_solve", "update")

# number of kernel launches made by fused_simulate (not by its plain version),
# of those the launches of a long reach (N > MAX_N), and of those the ones
# that took the reach build
launch_count = 0
long_launch_count = 0
reach_launch_count = 0


class FusedUnsupported(Exception):
    """Raised when the configuration is outside the fused kernel's scope."""


def _check_rating(name, bc, kinds):
    kind = None if bc.rating is None else bc.rating.kind
    if kind not in kinds:
        raise FusedUnsupported(f"unsupported {name} rating kind {kind!r}; the kernel has {tuple(kinds)}")
    if bc.rating.coeffs.shape[-1] != 3:
        raise FusedUnsupported("the fused kernel packs quadratics (3 coefficients)")


def _check_storage_rating(name, rc):
    """A storage's outflow rating: any kind but gated_blend; the quadratic
    kinds with 3 coefficients, power with 2, poly_n with at least one, a
    table of at least 2 breakpoints."""
    if rc.kind == "gated_blend":
        raise FusedUnsupported(
            f"a gated_blend rating on the {name} storage itself is unsupported "
            "(the plain mass balance cannot evaluate it either)")
    if rc.kind not in _STORAGE_RC_KINDS:
        raise FusedUnsupported(f"unknown rating kind {rc.kind!r} on the {name} storage; the kernel "
                               f"evaluates {_STORAGE_RC_KINDS} there")
    width = rc.coeffs.shape[-1]
    if rc.kind in ("polynomial", "blended_poly") and width != 3:
        raise FusedUnsupported(f"a {rc.kind} rating on the {name} storage packs a quadratic "
                               f"(3 coefficients); got {width}: use poly_n for another degree")
    if rc.kind == "power" and width != 2:
        raise FusedUnsupported(f"a power rating on the {name} storage has 2 coefficients (a, b); got {width}")
    if rc.kind == "poly_n" and width < 1:
        raise FusedUnsupported(f"a poly_n rating on the {name} storage has no coefficients")
    if rc.kind == "table" and (rc.table_stage.shape[-1] < 2 or rc.table_q.shape != rc.table_stage.shape):
        raise FusedUnsupported(f"a table rating on the {name} storage needs at least 2 (stage, discharge) "
                               f"pairs of one length; got {tuple(rc.table_stage.shape)} and "
                               f"{tuple(rc.table_q.shape)}")


def _check_supported(geo, us_bc, ds_bc, settings):
    """Raise :class:`FusedUnsupported` outside the kernel's scope."""
    if not isinstance(geo, (TrapezoidGeometry, TableGeometry)):
        raise FusedUnsupported(
            f"unknown geometry class {type(geo).__name__!r}: the fused kernel takes "
            "TrapezoidGeometry or TableGeometry")
    if isinstance(geo, TableGeometry) and geo.area.shape[-1] < 2:
        raise FusedUnsupported(f"a lookup table needs at least 2 depth samples; got {geo.area.shape[-1]}")
    for name, bc in (("upstream", us_bc), ("downstream", ds_bc)):
        if bc.kind not in _BC_KINDS:
            raise FusedUnsupported(f"unknown {name} BC kind {bc.kind!r}")
        if bc.kind == "fixed_depth" and bc.storage is not None and bc.storage.has_rating:
            _check_storage_rating(name, bc.storage.rating)
        if bc.kind == "normal_depth":
            s0 = float(bc.bed_slope.reshape(-1)[0])
            if not math.isfinite(s0) or s0 <= 0.0:
                raise FusedUnsupported(f"normal_depth {name} BC needs S0 > 0")
    if us_bc.kind == "rating_curve":
        _check_rating("upstream", us_bc, _US_RC_KINDS)
    if ds_bc.kind == "rating_curve":
        _check_rating("downstream", ds_bc, _DS_RC_KINDS)
    if settings.newton != "while":
        raise FusedUnsupported("fused kernel implements the while-Newton only")
    if settings.store not in prs.STORES:
        raise FusedUnsupported(f"fused kernel stores {prs.STORES}; got {settings.store!r}")
    if settings.diagnos:
        raise FusedUnsupported("fused kernel has no rcond diagnostics")
    n = geo.n_nodes
    if n > LONG_MAX_N:
        raise FusedUnsupported(
            f"N={n} exceeds the fused kernel's limit of {LONG_MAX_N} nodes (the TPU kernel's MAX_VMEM_N); "
            "run the plain engine with linear_solver='cuda_tiled' (any N)")


def fused_simulate_plain(geo, us_bc, ds_bc, h0, Q0, settings, lateral_inflow=None) -> prs.SimOutput:
    """The plain PyTorch version of the kernel: the eager scan-of-Newton with
    the PCR inner solve."""
    sset = dataclasses.replace(settings, linear_solver="pcr")
    return prs.simulate(geo, us_bc, ds_bc, h0, Q0, sset, lateral_inflow=lateral_inflow)


def _lib():
    lib = build.load("fused_newton")
    fn = lib.flowsim_fused_simulate
    if not getattr(fn, "_typed", False):
        head = [ctypes.c_void_p] * 16 + [ctypes.c_longlong] + [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_int)] \
            + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p]
        fn.argtypes = head + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flowsim_fused_simulate_probe.argtypes = head + [ctypes.c_int, ctypes.c_void_p,
                                                            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        lib.flowsim_fused_simulate_probe.restype = ctypes.c_int
        lib.flowsim_fused_resident_blocks.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.flowsim_fused_resident_blocks.restype = ctypes.c_int
        lib.flowsim_fused_chosen_build.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.flowsim_fused_chosen_build.restype = ctypes.c_int
        lib.flowsim_fused_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.flowsim_fused_plan.restype = ctypes.c_int
        lib.flowsim_fused_reach_lanes.argtypes = [ctypes.c_int]
        lib.flowsim_fused_reach_lanes.restype = ctypes.c_int
        for aux in (lib.flowsim_fused_param_count, lib.flowsim_fused_smem_bytes_per_node,
                    lib.flowsim_fused_storage_param_count, lib.flowsim_fused_probe_phases,
                    lib.flowsim_fused_latency_max_n, lib.flowsim_fused_register_max_n,
                    lib.flowsim_fused_long_max_n, lib.flowsim_fused_long_scratch_bytes_per_node,
                    lib.flowsim_fused_bracket_bytes_per_node, lib.flowsim_fused_cluster_block,
                    lib.flowsim_fused_cluster_bytes_per_node, lib.flowsim_fused_max_cluster,
                    lib.flowsim_fused_reach_bytes_per_node, lib.flowsim_fused_reach_ranks):
            aux.argtypes = []
            aux.restype = ctypes.c_int
        if lib.flowsim_fused_param_count() != _N_PARAMS \
                or lib.flowsim_fused_storage_param_count() != _N_STORAGE_PARAMS \
                or lib.flowsim_fused_probe_phases() != len(PROBE_PHASES) \
                or lib.flowsim_fused_latency_max_n() != LATENCY_MAX_N \
                or lib.flowsim_fused_register_max_n() != MAX_N \
                or lib.flowsim_fused_long_max_n() != LONG_MAX_N \
                or lib.flowsim_fused_cluster_block() != CLUSTER_BLOCK \
                or lib.flowsim_fused_max_cluster() != MAX_CLUSTER \
                or lib.flowsim_fused_reach_ranks() != REACH_RANKS:
            raise RuntimeError("parameter layout of fused_newton.cu and its wrapper differ")
        if lib.flowsim_fused_smem_bytes_per_node() != SMEM_BYTES_PER_NODE \
                or lib.flowsim_fused_long_scratch_bytes_per_node() != LONG_SCRATCH_BYTES_PER_NODE \
                or lib.flowsim_fused_bracket_bytes_per_node() != BRACKET_BYTES_PER_NODE \
                or lib.flowsim_fused_cluster_bytes_per_node() != CLUSTER_BYTES_PER_NODE \
                or lib.flowsim_fused_reach_bytes_per_node() != REACH_BYTES_PER_NODE:
            raise RuntimeError("memory layout of fused_newton.cu and its wrapper differ")
        fn._typed = True
    return lib


def pack_geometry(geo) -> torch.Tensor:
    """The geometry rows in the kernel's order, float64: ``[13, N]`` of a
    TrapezoidGeometry (``compound`` as 0/1), ``[4, N]`` of a TableGeometry
    (its tables: :func:`pack_tables`); ``[B, rows, N]`` for a batched one."""
    dt = geo.z_bed.dtype
    rows = _TABLE_ROWS if isinstance(geo, TableGeometry) else _GEO_ROWS
    return torch.stack([getattr(geo, r).to(dt) for r in rows], dim=-2).contiguous()


def check_shared_tables(geo_batch: TableGeometry) -> None:
    """Raise :class:`FusedUnsupported` unless every member of a batched
    TableGeometry holds member 0's A, P, T and dR/dA tables (an expanded view,
    as ``table_roughness_ensemble`` gives, does so by its stride): the kernel
    reads those four once for the whole batch."""
    for name in _SHARED_TABLES:
        t = getattr(geo_batch, name)
        if not (t.stride(0) == 0 or torch.equal(t, t[:1].expand_as(t))):
            raise FusedUnsupported(
                f"the members of a batched TableGeometry must share {_SHARED_TABLES}; {name} differs "
                "(parallel.ensemble.table_roughness_ensemble gives such a batch)")


def pack_tables(geo, n_sims: int | None = None) -> tuple[torch.Tensor, tuple, int]:
    """The lookup tables of a TableGeometry as the kernel reads them:
    ``(shared [4, N, M], (K, n_eq, dK/dA) each [S, N, M], M)`` — A, P, T
    and dR/dA stacked once, the three member tables as the geometry holds
    them (no copy of a contiguous table: at 10 240 members they are GBs).
    ``n_sims=None``: one simulation of ``[N, M]`` tables; else a batched
    geometry of ``n_sims`` members that :func:`check_shared_tables` accepts
    (its member 0 gives the shared tables).  A TrapezoidGeometry has no
    tables: ``(None, None, 0)``."""
    if not isinstance(geo, TableGeometry):
        return None, None, 0
    lead = (lambda t: t.unsqueeze(0)) if n_sims is None else (lambda t: t)
    shared = torch.stack([lead(getattr(geo, t))[0] for t in _SHARED_TABLES])
    member = tuple(lead(getattr(geo, t)).contiguous() for t in _MEMBER_TABLES)
    return shared, member, geo.area.shape[-1]


def _rating_slots(rc, gated):
    """(tensor, width) pairs of one rating block: low, high, shift, pivot,
    buffer, fd step and (downstream only, by the caller) the gate cooldown."""
    if rc is None:
        return [(None, 3), (None, 3), (None, 1), (None, 1), (None, 1), (None, 1)], None
    high = rc.coeffs_high if rc.coeffs_high.shape[-1] == 3 else None
    slots = [(rc.coeffs, 3), (high, 3), (rc.stage_shift, 1), (rc.pivot_stage, 1),
             (rc.buffer, 1), (rc.fd_step, 1)]
    return slots, (rc.max_cooldown if gated else None)


def _cat_slots(slots, batch_shape, dev):
    """Concatenate (tensor or None, width) slots into ``[*batch_shape, sum of
    widths]``; ``None`` gives zeros, a width-1 slot is a scalar leaf (0-d when
    shared, ``[B]`` per member)."""
    dt = torch.float64
    parts = []
    for t, width in slots:
        if t is None:
            t = torch.zeros((width,), dtype=dt, device=dev)
        elif width == 1:
            t = t.unsqueeze(-1)
        parts.append(t.to(dt).expand(*batch_shape, width))
    return torch.cat(parts, dim=-1).contiguous()


def pack_params(us_bc, ds_bc, settings, batch_shape=()) -> tuple[torch.Tensor, int, int]:
    """The 32 scalar parameters the kernel reads — ``[32]``, or ``[B, 32]``
    with ``batch_shape=(B,)`` where any boundary leaf may carry a leading
    member axis — and the downstream and upstream rating-curve kinds."""
    dev, dt = us_bc.bed_level.device, torch.float64
    rc = ds_bc.rating if ds_bc.kind == "rating_curve" else None
    urc = us_bc.rating if us_bc.kind == "rating_curve" else None
    ds_slots, cooldown = _rating_slots(rc, rc is not None and rc.kind == "gated_blend")
    us_slots, _ = _rating_slots(urc, False)
    host = torch.tensor(
        [settings.theta, settings.time_step, settings.spatial_step, settings.tolerance],
        dtype=dt, device=dev)
    gate_init = torch.tensor(1.0 if settings.gate_initially_open else 0.0, dtype=dt, device=dev)
    slots = [(host, 4), (us_bc.bed_level, 1), (us_bc.bed_slope, 1), (us_bc.initial_depth, 1),
             (ds_bc.bed_level, 1), (ds_bc.bed_slope, 1), (ds_bc.initial_depth, 1),
             *ds_slots, (cooldown, 1), (gate_init, 1), *us_slots]
    par = _cat_slots(slots, batch_shape, dev)
    if par.shape[-1] != _N_PARAMS:
        raise RuntimeError(f"packed {par.shape[-1]} parameters, the kernel reads {_N_PARAMS}")
    return par, (_RC_KINDS[rc.kind] if rc is not None else 0), (_RC_KINDS[urc.kind] if urc is not None else 0)


def _storage_of(bc):
    return bc.storage if bc.kind == "fixed_depth" else None


def _storage_rating(rc):
    """A storage's outflow rating as the kernel reads it: the rating block
    (``_rating_slots``; power's a and b in the low quadratic's first two
    slots, poly_n's and table's coefficients not in it) and the rating data
    packed after the end's tables: poly_n's ascending coefficients, table's
    stages then discharges (``None`` for the other kinds)."""
    data = None
    if rc.kind in ("power", "poly_n", "table"):
        lead = rc.coeffs.shape[:-1]
        low = torch.zeros((*lead, 3), dtype=torch.float64, device=rc.coeffs.device)
        if rc.kind == "power":
            low[..., :2] = rc.coeffs
        elif rc.kind == "poly_n":
            data = rc.coeffs
        else:
            data = torch.cat([rc.table_stage, rc.table_q], dim=-1)
        rc = dataclasses.replace(rc, coeffs=low)
    slots, _ = _rating_slots(rc, False)
    return slots, data


def pack_storage(us_bc, ds_bc, batch_shape=()):
    """The storage inputs of the kernel: the scalar blocks ``[*batch, 2, 17]``
    (upstream, downstream), the tables ``[*batch, L]`` or shared ``[L]`` — per
    end ``vol_stage | vol_table | area_stage | area_table | rating data`` —
    and the eight ints {us flags, ds flags, us nv, us na, ds nv, ds na, us nr,
    ds nr}: nv and na the lengths of the stage-volume and stage-area tables,
    nr the doubles of a poly_n or table outflow rating (its coefficients, or
    its stages then discharges).  A flag word holds the options and, from bit
    4, the rating's kind.  A boundary without storage gives a zero block, no
    tables and flags 0."""
    dev, dt = us_bc.bed_level.device, torch.float64
    blocks, tables, flags, lens, rating_lens = [], [], [], [], []
    for sp in (_storage_of(us_bc), _storage_of(ds_bc)):
        if sp is None:
            blocks.append(torch.zeros((*batch_shape, _N_STORAGE_PARAMS), dtype=dt, device=dev))
            flags.append(0)
            lens += [0, 0]
            rating_lens.append(0)
            continue
        rc_slots, data = _storage_rating(sp.rating) if sp.has_rating else _rating_slots(None, False)
        slots = [(t, 1) for t in (sp.surface_area, sp.min_stage, sp.y_min, sp.y_max, sp.beta,
                                  sp.reservoir_length, sp.K_q)] + rc_slots
        blocks.append(_cat_slots(slots, batch_shape, dev))
        flag = _ST_ON | (_ST_AREA_CURVE if sp.has_area_curve else 0) \
            | (_ST_RATING if sp.has_rating else 0) | (_ST_LOSSES if sp.capture_losses else 0)
        if sp.has_rating:
            flag |= _RC_KINDS[sp.rating.kind] << _ST_RC_SHIFT
        flags.append(flag)
        if sp.has_area_curve:
            lens += [sp.vol_stage.shape[-1], sp.area_stage.shape[-1]]
            tables += [sp.vol_stage, sp.vol_table, sp.area_stage, sp.area_table]
        else:
            lens += [0, 0]
        rating_lens.append(0 if data is None else data.shape[-1])
        if data is not None:
            tables.append(data)
    stor = torch.stack(blocks, dim=-2).contiguous()
    if not tables:
        stab = torch.zeros((1,), dtype=dt, device=dev)
    else:
        # tables of a stacked boundary carry the member axis; a shared
        # boundary's are expanded only when the other end's are per member
        lead = batch_shape if any(t.dim() > 1 for t in tables) else ()
        stab = torch.cat([t.to(dt).expand(*lead, t.shape[-1]) for t in tables], dim=-1).contiguous()
    return stor, stab, (flags[0], flags[1], *lens, *rating_lens)


def storage_table_len(st_ints) -> int:
    """Doubles of both ends' storage tables, from :func:`pack_storage`'s
    eight ints: the stage-volume and stage-area tables (stages and values)
    and the rating data."""
    return 2 * sum(st_ints[2:6]) + st_ints[6] + st_ints[7]


def output_bytes(n_sims: int, n: int, nt: int, store: str) -> int:
    """Bytes of the kernel's outputs: depth and flow (float64, N or 2 nodes
    per level) plus error, gate, the two reservoir stages, iterations and
    converged per level."""
    width = n if store == "full" else 2
    return n_sims * nt * (2 * width * 8 + 4 * 8 + 2 * 4)


def scratch_bytes(n_sims: int, n: int) -> int:
    """Bytes of the long build's scratch: its per-node state in device
    memory, one block of N nodes a simulation."""
    return n_sims * n * LONG_SCRATCH_BYTES_PER_NODE


def uses_long_build(n: int, build_id: int = -1, n_sims: int = 1) -> bool:
    """Whether ``n_sims`` simulations at N nodes take the long build, and so
    hold a scratch: only where a test hook forces it (the C entry gives one
    simulation above :data:`MAX_N` the reach build and a batch the cluster
    build, whose state lies in shared memory)."""
    return build_id == LONG_BUILD


def uses_reach_build(n: int, build_id: int = -1, n_sims: int = 1) -> bool:
    """Whether ``n_sims`` simulations at N nodes take the reach build: the C
    entry takes it above :data:`MAX_N` for one simulation
    (``choose_build_id``), and a test hook may force it."""
    return build_id == REACH_BUILD or (build_id < 0 and n > MAX_N and n_sims == 1)


def reach_rank_nodes(n: int) -> int:
    """Nodes a rank of the reach build holds (node i on rank i %
    :data:`REACH_RANKS`): ceil(N / REACH_RANKS) rounded up to a whole warp."""
    return rank_nodes(n, REACH_RANKS)


def reach_lanes(n: int) -> int:
    """The reach build's closure lanes a node at N nodes, the C entry's rule
    (``reach_lanes`` in ``csrc/fused_newton.cu``, asked here): two while two
    a node of a rank fit its 512-thread launch bound (N <= 4096), else one;
    its block is lanes x :func:`reach_rank_nodes` threads.  Needs the card."""
    return _lib().flowsim_fused_reach_lanes(n)


def rank_nodes(n: int, blocks: int) -> int:
    """Nodes a rank of the cluster build holds at N nodes over ``blocks``
    blocks: ceil(N / blocks) rounded up to a whole warp (one node a
    thread)."""
    per_rank = -(-n // blocks)
    return (per_rank + 31) // 32 * 32


def cluster_blocks(n: int) -> int:
    """The blocks of the cluster build's cluster at N nodes, as the C entry
    takes them (``cluster_blocks_for``): the fewest, at least 2, at which a
    rank holds at most :data:`CLUSTER_BLOCK` nodes — so that its share of the
    state, :data:`CLUSTER_BYTES_PER_NODE` a node, fits a block's shared
    memory (3 at N = 2048, 6 at 4096, 11 at 8192)."""
    blocks = 2
    while rank_nodes(n, blocks) > CLUSTER_BLOCK:
        blocks += 1
    return blocks


def launch_grid(build_id: int, n_sims: int, n: int, sms: int, clusters_at_once: int | None = None) -> int:
    """The grid the C entry launches (``grid_of``) for ``n_sims`` simulations
    of N nodes in a build on a card of ``sms`` SMs: one block a simulation;
    the cluster build's persistent grid the blocks of at most
    ``clusters_at_once`` clusters — the card's answer, which its layout of
    SMs may put below ``sms // cluster_blocks(n)``, the default here; the
    reach build a cluster of :data:`REACH_RANKS` blocks a simulation."""
    if build_id == CLUSTER_BUILD:
        blocks = cluster_blocks(n)
        clusters = sms // blocks if clusters_at_once is None else clusters_at_once
        return min(n_sims, clusters) * blocks
    if build_id == REACH_BUILD:   # a cluster a simulation
        return n_sims * REACH_RANKS
    return n_sims


def launch_error(rc: int, build_id: int, cluster: int = 1) -> str:
    """The message of a launch the C entry refused with ``rc``: the build,
    its cluster and what the code means."""
    what = BUILD_NAMES.get(build_id, f"build {build_id}")
    if build_id in (CLUSTER_BUILD, REACH_BUILD):
        what += f" ({cluster} blocks a cluster)"
    return (f"fused_simulate launch failed in the {what}: CUDA error {rc} "
            f"({_REFUSALS.get(rc, 'see cudaGetErrorString')}); no other build or plain version runs in its place")


def refusal(rc: int, build_id: int, cluster: int = 1) -> Exception:
    """The exception of a launch the C entry refused with ``rc``, with
    :func:`launch_error`'s text: :class:`FusedUnsupported` where the build
    does not take the shape, the geometry or the probe
    (cudaErrorInvalidValue), :class:`RuntimeError` for any other error."""
    msg = launch_error(rc, build_id, cluster)
    return FusedUnsupported(msg) if rc == 1 else RuntimeError(msg)


def check_output_memory(n_sims: int, n: int, nt: int, store: str, free_bytes: int,
                        long_build: bool = False) -> None:
    """Refuse, before anything is allocated, a launch whose outputs (and,
    with ``long_build``, the long build's scratch: :func:`uses_long_build`)
    exceed the free memory of the card."""
    out = output_bytes(n_sims, n, nt, store)
    scratch = scratch_bytes(n_sims, n) if long_build else 0
    if out + scratch > free_bytes:
        what = f"outputs ({out / 1e9:.2f} GB)" + (f" and scratch ({scratch / 1e9:.2f} GB)" if scratch else "")
        raise MemoryError(
            f"the {what} of {n_sims} simulations (N={n}, nt={nt}, store={store!r}) take "
            f"{(out + scratch) / 1e9:.2f} GB but the card has {free_bytes / 1e9:.2f} GB free: run the "
            f"ensemble in chunks (batched_simulate(..., chunk_size=...)) or use store='boundaries'")


def resident_blocks(n: int, storage: bool = False, build_id: int = REGISTER_BUILD, table: bool = False) -> int:
    """Blocks of a kernel build that one SM holds at N nodes, from the CUDA
    occupancy calculator (:data:`REGISTER_BUILD`, every shape to
    :data:`MAX_N`; :data:`LONG_BUILD` every shape to :data:`LONG_MAX_N`; the
    others N <= :data:`LATENCY_MAX_N` without storage, and the latency build
    trapezoid geometry only; ``table``: the table geometry's build)."""
    out = ctypes.c_int(0)
    rc = _lib().flowsim_fused_resident_blocks(n, int(storage), int(table), build_id, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return out.value


def chosen_build(n_sims: int, n: int, storage: bool = False, table: bool = False) -> int:
    """The build the kernel's C entry takes for ``n_sims`` simulations of
    ``n`` nodes (``choose_build_id`` in ``csrc/fused_newton.cu``): above
    :data:`MAX_N` the reach build for one simulation and the cluster build
    for a batch; with storage or N > :data:`LATENCY_MAX_N` the register
    build; else the latency build while one wave of it holds the batch
    (trapezoid geometry; ``table`` skips it), the register build while one
    wave of that does, then the residency build (``table``: the bracket
    build) where it holds more members an SM."""
    out = ctypes.c_int(0)
    rc = _lib().flowsim_fused_chosen_build(n_sims, n, int(storage), int(table), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"build choice failed: CUDA error {rc}")
    return out.value


def plan(n_sims: int, n: int, storage: bool = False, table: bool = False, build_id: int = -1,
         probe: bool = False) -> tuple[int, int, int]:
    """What the C entry launches for ``n_sims`` simulations of ``n`` nodes in
    ``build_id`` (-1: its choice; ``probe``: its probe build):
    ``(build, grid, cluster)`` — the grid's blocks and the blocks of a
    cluster (1 outside the cluster build).  Raises what :func:`refusal`
    gives for a launch the C entry would refuse: a forced build that does
    not take the shape is refused here, by the C entry's own rules."""
    b, grid, cluster = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib().flowsim_fused_plan(n_sims, n, int(storage), int(table), build_id, int(probe), ctypes.byref(b),
                                   ctypes.byref(grid), ctypes.byref(cluster))
    if rc != 0:
        raise refusal(rc, b.value, cluster.value)
    return b.value, grid.value, cluster.value


def launch(geo_rows, h0, Q0, us_series, ds_series, par, qlat, settings, us_kind, ds_kind,
           rc_kind, us_rc_kind, storage, tables=(None, None, 0), build_id: int = -1,
           probe=None) -> prs.SimOutput:
    """Launch the kernel on a grid of ``S = geo_rows.shape[0]`` blocks, one per
    simulation.  Every input carries the leading ``S`` axis and lies on one
    CUDA device; ``qlat`` is ``None``, ``[S, N]`` or ``[S, nt, N]``;
    ``storage`` is what :func:`pack_storage` returns (blocks ``[S, 2, 17]``,
    tables ``[S, L]`` or shared ``[L]``).  ``tables``: what
    :func:`pack_tables` returns — ``(None, None, 0)`` for trapezoid rows
    ``[S, 13, N]``, else ``(shared [4, N, M], (K, n_eq, dK/dA) each
    [S, N, M], M)`` for table rows ``[S, 4, N]``.  ``build_id`` -1 lets the kernel's C
    entry choose its build (:func:`chosen_build`: what every wrapper does); a
    build id forces one (:func:`plan` refuses one that does not take the
    shape), a test hook for timing the builds against each other and for
    holding them to one another's bits.  The long build's scratch
    (:func:`scratch_bytes`) is allocated here, counted with the outputs
    against the card's free memory.  ``probe``: ``None``, or ``(cycles, clock)`` — an
    int64 tensor ``[len(PROBE_PHASES)]`` on the device and a
    ``ctypes.c_int`` — for one launch of the probe build of that build (the
    register or latency build on trapezoids, the residency or bracket build
    on tables, N <= 128; the cluster and the reach build on trapezoids; no storage), which
    fills them with the cycles of each phase and the SM clock in kHz.  Returns a SimOutput whose fields
    carry the ``S`` axis."""
    dev = geo_rows.device
    n_sims, _, n = geo_rows.shape
    nt = settings.n_time_levels
    tab_shared, tab_member, tab_m = tables
    expect = dict(geo_rows=(n_sims, len(_TABLE_ROWS) if tab_m else len(_GEO_ROWS), n), h0=(n_sims, n),
                  Q0=(n_sims, n), us_series=(n_sims, nt), ds_series=(n_sims, nt), par=(n_sims, _N_PARAMS))
    given = dict(geo_rows=geo_rows, h0=h0, Q0=Q0, us_series=us_series, ds_series=ds_series, par=par)
    if tab_m:
        expect["shared tables"] = (len(_SHARED_TABLES), n, tab_m)
        given["shared tables"] = tab_shared
        for name, t in zip(_MEMBER_TABLES, tab_member):
            expect[name + " table"] = (n_sims, n, tab_m)
            given[name + " table"] = t
    stor, stab, st_ints = storage
    expect["storage blocks"] = (n_sims, 2, _N_STORAGE_PARAMS)
    given["storage blocks"] = stor
    tab_len = max(1, storage_table_len(st_ints))
    expect["storage tables"] = (n_sims, tab_len) if stab.dim() == 2 else (tab_len,)
    given["storage tables"] = stab
    if qlat is not None:
        expect["qlat"] = (n_sims, n) if qlat.dim() == 2 else (n_sims, nt, n)
        given["qlat"] = qlat
    for name, t in given.items():
        if tuple(t.shape) != expect[name] or t.dtype != torch.float64 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous float64 {expect[name]} tensor on {dev}; got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    storage_on = bool((st_ints[0] | st_ints[1]) & _ST_ON)
    with torch.cuda.device(dev):
        build_id, grid, cluster = plan(n_sims, n, storage_on, bool(tab_m), build_id, probe is not None)
        long_build = build_id == LONG_BUILD
        check_output_memory(n_sims, n, nt, settings.store, torch.cuda.mem_get_info()[0], long_build)
        scratch = torch.empty((n_sims, LONG_SCRATCH_BYTES_PER_NODE // 8, n), dtype=torch.float64,
                              device=dev) if long_build else None
        width = n if settings.store == "full" else 2
        f64 = dict(dtype=torch.float64, device=dev)
        depth = torch.empty((n_sims, nt, width), **f64)
        flow = torch.empty((n_sims, nt, width), **f64)
        error = torch.empty((n_sims, nt), **f64)
        gate = torch.empty((n_sims, nt), **f64)
        iters = torch.empty((n_sims, nt), dtype=torch.int32, device=dev)
        conv = torch.empty((n_sims, nt), dtype=torch.int32, device=dev)
        stage = torch.full((n_sims, nt, 2), float("nan"), **f64)
        args = (geo_rows.data_ptr(), h0.data_ptr(), Q0.data_ptr(), us_series.data_ptr(),
                ds_series.data_ptr(), par.data_ptr(), None if qlat is None else qlat.data_ptr(),
                depth.data_ptr(), flow.data_ptr(), iters.data_ptr(), error.data_ptr(),
                conv.data_ptr(), gate.data_ptr(), stage.data_ptr(), stor.data_ptr(), stab.data_ptr(),
                tab_len if stab.dim() == 2 else 0, n_sims, n, nt, int(settings.max_iter),
                _BC_KINDS[us_kind], _BC_KINDS[ds_kind], rc_kind, us_rc_kind,
                int(settings.store == "boundaries"), 0 if qlat is None else qlat.dim() - 1,
                (ctypes.c_int * 8)(*st_ints), None if not tab_m else tab_shared.data_ptr(),
                *((None,) * 3 if not tab_m else (t.data_ptr() for t in tab_member)), tab_m,
                None if scratch is None else scratch.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        if probe is None:
            rc = _lib().flowsim_fused_simulate(*args, build_id, stream)
        else:
            rc = _lib().flowsim_fused_simulate_probe(*args, build_id, probe[0].data_ptr(), ctypes.byref(probe[1]),
                                                     stream)
    if rc != 0:
        raise refusal(rc, build_id, cluster)
    return prs.SimOutput(
        depth=depth, flow=flow, iterations=iters, error=error, converged=conv.bool(),
        reservoir_stage=stage[..., 0], gate_open=gate, rcond=None,
        reservoir_stage_us=stage[..., 1],
    )


def series(bc, nt, dev, batch_shape=()):
    """The boundary's target series ``[*batch_shape, nt]`` (zeros for a kind
    that reads none)."""
    if bc.kind in ("flow_hydrograph", "stage_hydrograph"):
        return bc.target_series.expand(*batch_shape, nt).contiguous()
    return torch.zeros((*batch_shape, nt), dtype=torch.float64, device=dev)


def check_device(dev, h0, Q0, geo, us_bc, ds_bc, name):
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA or CPU tensors; got {dev}")
    if h0.dtype != torch.float64 or Q0.dtype != torch.float64:
        raise TypeError("h0 and Q0 must be float64 on the card")
    if geo.device != dev or Q0.device != dev or us_bc.bed_level.device != dev \
            or ds_bc.bed_level.device != dev:
        raise ValueError("geometry, boundaries and state must lie on the same device")


def _launch_one(geo, us_bc, ds_bc, h0, Q0, settings, qlat, probe=None,
                build_id=-1) -> tuple[prs.SimOutput, int]:
    """One simulation in ``build_id`` (-1: the build the C entry chooses,
    :func:`chosen_build`).  Returns the output and the build launched."""
    nt, dev = settings.n_time_levels, h0.device
    par, rc_kind, us_rc_kind = pack_params(us_bc, ds_bc, settings)
    stor, stab, st_ints = pack_storage(us_bc, ds_bc)
    tables = pack_tables(geo)
    if build_id < 0:
        with torch.cuda.device(dev):
            build_id = chosen_build(1, geo.n_nodes, bool((st_ints[0] | st_ints[1]) & _ST_ON), bool(tables[2]))
    one = lambda t: t.unsqueeze(0).contiguous()
    out = launch(one(pack_geometry(geo)), one(h0), one(Q0), one(series(us_bc, nt, dev)),
                 one(series(ds_bc, nt, dev)), one(par), None if qlat is None else one(qlat),
                 settings, us_bc.kind, ds_bc.kind, rc_kind, us_rc_kind,
                 (one(stor), stab, st_ints), tables, build_id=build_id, probe=probe)
    return prs.SimOutput(*(None if f is None else f[0] for f in out)), build_id


def fused_simulate_probe(geo, us_bc, ds_bc, h0, Q0, settings, build_id=-1):
    """A measurement hook: one launch of the probe build (N <= 128, no
    storage) of the build the wrapper takes (``build_id`` -1) or of a forced
    one, on CUDA tensors.  Returns ``(SimOutput, cycles, clock_khz)``:
    ``cycles`` maps each of :data:`PROBE_PHASES` to the SM cycles thread 0
    spent in it over the run.  Its outputs are the production build's bits.
    Trapezoid geometry only.  Counts no launch."""
    if not isinstance(geo, TrapezoidGeometry):
        raise FusedUnsupported("the probe builds are of the trapezoid closures")
    _check_supported(geo, us_bc, ds_bc, settings)
    prs.check_shapes(geo, us_bc, ds_bc, h0, Q0, settings, None)
    check_device(h0.device, h0, Q0, geo, us_bc, ds_bc, "fused_simulate_probe")
    cycles = torch.zeros(len(PROBE_PHASES), dtype=torch.int64, device=h0.device)
    clock = ctypes.c_int(0)
    out, _ = _launch_one(geo, us_bc, ds_bc, h0, Q0, settings, None, probe=(cycles, clock), build_id=build_id)
    return out, dict(zip(PROBE_PHASES, cycles.tolist())), clock.value


def fused_simulate(geo, us_bc, ds_bc, h0, Q0, settings, lateral_inflow=None) -> prs.SimOutput:
    """Run the full simulation in one CUDA kernel launch; returns a SimOutput.

    ``lateral_inflow``: ``None``, per node ``[N]`` or per level and node
    ``[nt, N]``.  Raises :class:`FusedUnsupported` for configurations outside
    the kernel's scope.  CPU tensors take the plain version.
    """
    global launch_count, long_launch_count, reach_launch_count
    _check_supported(geo, us_bc, ds_bc, settings)
    qlat = prs.as_lateral_inflow(lateral_inflow, h0)
    prs.check_shapes(geo, us_bc, ds_bc, h0, Q0, settings, qlat)
    dev = h0.device
    if dev.type == "cpu":
        return fused_simulate_plain(geo, us_bc, ds_bc, h0, Q0, settings, qlat)
    check_device(dev, h0, Q0, geo, us_bc, ds_bc, "fused_simulate")
    out, build_id = _launch_one(geo, us_bc, ds_bc, h0, Q0, settings, qlat)
    launch_count += 1
    long_launch_count += geo.n_nodes > MAX_N
    reach_launch_count += build_id == REACH_BUILD
    return out
