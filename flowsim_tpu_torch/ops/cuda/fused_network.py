"""``fused_simulate_network``: the whole-network CUDA kernel, single and batched.

Counterpart of ``flowsim_tpu/ops/pallas/fused_network.py``
(``fused_simulate_network`` and ``fused_simulate_network_batched``).  The
kernel (``csrc/fused_network.cu``) runs every time level and every Newton
iteration of one river network inside one thread block, in float64, and
computes what the stacked engine of ``ops/network.py`` computes; on a grid of
M blocks it runs M networks (ensemble members) in one launch.  This module
checks that a network is inside the kernel's scope (:class:`FusedUnsupported`
otherwise — nothing is re-routed to another engine), validates the inputs the
kernel would otherwise read out of range, packs the branches into the flat
edge-padded buffers the kernel reads, launches, and unpacks a
:class:`~flowsim_tpu_torch.ops.network.NetworkOutput`.

The external ends of a branch are packed with the single-reach kernel's own
functions (``fused_newton.pack_params`` / ``pack_storage`` /
``pack_geometry``), one parameter block per branch.

A branch's geometry is a :class:`TrapezoidGeometry` or a
:class:`TableGeometry` (surveyed sections as lookup tables), mixed freely: a
network with a table branch takes the kernel's table builds, in which each
slot evaluates its own branch's closure.  The table branches must share one
depth-grid resolution M (as the JAX kernel asks); their tables are packed
once for the launch (:func:`pack_tables`), and a batch cannot override a
table branch's geometry per member (its members share its tables).

The kernel has builds of one arithmetic, and the C entry picks one by the
network's size and the member count (every build gives the same bits):

* the **latency build** (:data:`LATENCY_BUILD`) when the slots (branches x
  padded nodes) fit one block of at most 256 threads — the tributary, the
  basin up to levels=4 — and the batch fits the card at once in it: a
  thread owns one slot and keeps its geometry, indices, previous-level state
  and closures in registers, for the shortest chain an iteration;
* the **loop build** (:data:`LOOP_BUILD`) for a network with more slots than
  threads (the basin at levels=5): the threads loop over the slots;
* the **residency build** (:data:`RESIDENCY_BUILD`) for a network whose slots
  fit the block and a batch larger than the card holds at once in the latency
  build: the latency build's form with its registers capped so that two
  blocks share an SM.  A network with more slots than threads has none;
* the **scratch build** (:data:`SCRATCH_BUILD`) for a network whose slot
  arrays do not fit one block's shared memory (:func:`smem_bytes` over
  :data:`SMEM_LIMIT`: the basin at levels >= 6, a tributary on the flagship
  at 250 m): the loop build with the slot arrays in a scratch of device
  memory that :func:`_launch` allocates, one for each block of a persistent
  grid of at most the blocks the card holds at once (:func:`scratch_grid`,
  :func:`scratch_bytes`), each block running its members one after another.
  The junction block and the gate state stay in shared memory, so a network
  may have up to :data:`MAX_JUNCTIONS` junctions and branches of up to 8192
  nodes, the JAX kernel's own limits.  The C entry takes it for a network
  whose slot arrays exceed a cluster's shared memory too, and for a batch
  of networks beyond one block's larger than the card holds in one wave of
  clusters;
* the **cluster build** (:data:`CLUSTER_BUILD`) for a network whose slot
  arrays do not fit one block's shared memory but fit a thread-block
  cluster's (:func:`cluster_blocks`: 2-16 blocks, each holding a contiguous
  range of the slots in its shared memory and reading the other ranks'
  through distributed shared memory): one slot a thread of each rank up to
  4096 slots, the loop form over 16 blocks beyond.  It allocates no
  scratch.  Every field but the norm has the other builds' bits; the norm,
  summed rank by rank, agrees to rounding;
* the **bracket build** (:data:`BRACKET_BUILD`, networks with table branches
  only) where the residency build would run: the residency build's form
  (two blocks an SM) with each table slot's bracket index and 14 bracket
  values cached in shared memory (re-read from the tables only when the
  depth leaves the bracket; :func:`bracket_smem_bytes`) and the sweeps with
  the carried inverse, the slot's own rows in registers.  The same bits;
* the **lean build** (:data:`LEAN_BUILD`, networks with table branches only)
  where the latency build would run (one network, batches the card holds at
  once) and the lean build holds the batch at once too: the bracket build's
  form under the latency build's launch bound (255 registers), with one
  closure pass a Newton iteration and none between levels (a level's
  previous-level closures are its first iteration's), and a trapezoid slot
  that is not compound evaluated without the compound code.  Where a
  network has at most 192 slots, 16 branches and 32 junctions, each member
  has an SM of its own and no external end has a lumped storage, the
  **lean build with side warps**
  (:data:`LEAN_SIDE_BUILD`): two warps beyond the slots' take the external
  end rows and the junction rows off the slots' warps.  Their shared memory
  is the bracket build's.  The same bits.

A forced ``build_id`` (``_launch``, with ``cluster`` for the cluster build:
its blocks, plus :data:`CLUSTER_PAIR` for the two-blocks-an-SM form) is a
test hook: ``chip_smoke.py`` times the builds against each other and holds
them to the same bits.  :func:`fused_simulate_network_probe` runs the probe
build, which sums the cycles of each phase of an iteration.  A launch the
card refuses raises :class:`RuntimeError` with the C entry's return code
(:func:`launch_error`); nothing else runs in its place.

On CUDA tensors the wrappers launch the kernel or raise.  The plain versions —
:func:`fused_simulate_network_plain` (the stacked engine with the ``"pcr"``
solve) and :func:`fused_simulate_network_batched_plain` (a member loop over
it) — run only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from flowsim_tpu_torch.config import farray
from flowsim_tpu_torch.geometry import TableGeometry
from flowsim_tpu_torch.ops import boundary as bnd
from flowsim_tpu_torch.ops import network as net
from flowsim_tpu_torch.ops.cuda import build
from flowsim_tpu_torch.ops.cuda import fused_newton as fn
from flowsim_tpu_torch.ops.cuda.fused_newton import FusedUnsupported

MAX_THREADS = 256
# the kernel's builds (csrc/fused_network.cu).  The C entry chooses by the
# member count; a forced build id is a test hook for chip_smoke.py, which
# times the builds against each other and holds them to the same bits.
LOOP_BUILD, LATENCY_BUILD, RESIDENCY_BUILD, SCRATCH_BUILD, CLUSTER_BUILD, BRACKET_BUILD = 0, 1, 2, 3, 4, 5
LEAN_BUILD, LEAN_SIDE_BUILD = 6, 7
CHOOSE_BUILD = -1
PROBE_PHASES = fn.PROBE_PHASES
# the probe build's split of the assembly phase (csrc/fused_network.cu's
# AP_*), by the cycle at which the block's last thread reaches each point:
# the wait at the closures' barrier (the probing thread reads the clock when
# its warp arrives at a barrier, so the phase after a barrier carries its
# wait), its cell rows, end rows and junction rows, the probe's own stamps
# and the norm; they add up to "assembly"
ASSEMBLY_PARTS = ("assembly_wait", "assembly_cells", "assembly_ends", "assembly_junctions", "assembly_stamps",
                  "assembly_norm")
PROBE_FIELDS = PROBE_PHASES + ASSEMBLY_PARTS
# dynamic shared memory a block may take: 227 KB less the static reduction
# area; a network that needs more takes the cluster or the scratch build
SMEM_LIMIT = 232448 - 512
# the cluster build: at most 16 blocks a cluster; a block's dynamic shared
# memory less its static reduction areas (the block's and the rank sums');
# the flag of the two-blocks-an-SM form in a forced cluster
MAX_CLUSTER = 16
CLUSTER_SMEM_LIMIT = 232448 - 528
CLUSTER_PAIR = 256
_BUILD_NAMES = {LOOP_BUILD: "loop build", LATENCY_BUILD: "latency build", RESIDENCY_BUILD: "residency build",
                SCRATCH_BUILD: "scratch build", CLUSTER_BUILD: "cluster build", BRACKET_BUILD: "bracket build",
                LEAN_BUILD: "lean build", LEAN_SIDE_BUILD: "lean build with side warps"}
# what the C entry's refusals mean (cudaError_t)
_REFUSALS = {1: "cudaErrorInvalidValue: the build does not take this network or form, or its block exceeds the "
                "card's shared memory",
             701: "cudaErrorLaunchOutOfResources: the card cannot hold one cluster of this shape at once",
             912: f"cudaErrorInvalidClusterSize: a cluster has 2-{MAX_CLUSTER} blocks"}
# the bracket build (networks with table branches): each slot's bracket
# index and its 14 bracket values, an int and 14 doubles a slot, after the
# junction block; its level-start state lies in the assembly buffer, so a
# slot holds 6 doubles of state fewer than in the other builds
BRACKET_BYTES_PER_SLOT = 14 * 8 + 4
# the JAX kernel's junction limit (flowsim_tpu/ops/pallas/fused_network.py:1103):
# the J x J Schur matrix stays in shared memory, about 121 KB at J = 120
MAX_JUNCTIONS = 120
_BI_COUNT = 16
# a table branch's geometry rows: the bed level, the table span (in the
# trapezoid's b_main row), the bed slope and the curvature; its seven tables
# in csrc/fused_network.cu's order (TS_* then TAB_K, TAB_NEQ, TAB_DK)
_TABLE_GEO_ROWS = {0: "z_bed", 1: "depth_max", 11: "bed_slope", 12: "curvature"}
_TABLES = fn._SHARED_TABLES + fn._MEMBER_TABLES
_JP_COUNT = 14
# a junction's release rating: the kind codes of a storage's outflow rating
# (one device function evaluates the kinds beyond the quadratics for both,
# reach_common.cuh's rating_discharge_n)
_JR_KINDS = {k: fn._RC_KINDS[k] for k in ("polynomial", "blended_poly", "poly_n", "power", "table")}
_JP_AREA, _JP_KIND, _JP_SHIFT, _JP_PIVOT, _JP_BUFFER, _JP_FD, _JP_C0, _JP_H0, _JP_NCOEF, _JP_OFF = \
    0, 1, 2, 3, 4, 5, 6, 9, 12, 13

# kernel launches made by fused_simulate_network and by
# fused_simulate_network_batched (not by their plain versions), and those of
# them that took the scratch, cluster, bracket and lean builds (the build
# the C entry chose and the launch took; the lean build with or without its
# side warps)
launch_count = 0
batched_launch_count = 0
scratch_launch_count = 0
batched_scratch_launch_count = 0
cluster_launch_count = 0
batched_cluster_launch_count = 0
batched_bracket_launch_count = 0
lean_launch_count = 0
batched_lean_launch_count = 0


def smem_bytes(slots: int, n_branches: int, n_junctions: int, m_rhs: int) -> int:
    """Dynamic shared memory of one block of the shared-memory builds: the
    slot arrays (:func:`scratch_bytes` of one block); the J x J Schur matrix
    and six junction columns; four gate-state doubles per branch."""
    return scratch_bytes(1, slots, m_rhs) + 8 * (n_junctions * (n_junctions + 6) + 4 * n_branches)


def bracket_smem_bytes(slots: int, n_branches: int, n_junctions: int, m_rhs: int) -> int:
    """Dynamic shared memory of one block of the bracket build: per slot two
    PCR buffers of 12 + 2 m_rhs doubles (the inverse of D carried in D's
    place, so the other builds' size), h and Q (the level-start state lies
    in the assembly buffer) and the bracket cache
    (:data:`BRACKET_BYTES_PER_SLOT`); the junction block."""
    return slots * (8 * (2 * (12 + 2 * m_rhs) + 2) + BRACKET_BYTES_PER_SLOT) \
        + 8 * (n_junctions * (n_junctions + 6) + 4 * n_branches)


def scratch_bytes(n_blocks: int, slots: int, m_rhs: int) -> int:
    """Bytes of the scratch build's scratch for ``n_blocks`` blocks: per
    (branch, node) slot two PCR buffers of 12 + 2 m_rhs doubles and 8
    doubles of state."""
    return 8 * n_blocks * slots * (2 * (12 + 2 * m_rhs) + 8)


def cluster_blocks(slots: int, n_branches: int, n_junctions: int, m_rhs: int) -> int:
    """The blocks of the cluster the C entry gives a network in the cluster
    build, as far as shared memory decides: the fewest (at least 2) at which
    a rank holds at most :data:`MAX_THREADS` slots (one slot a thread), or
    :data:`MAX_CLUSTER` of the loop form beyond, a block more while a rank's
    slot arrays and the junction block (:func:`smem_bytes`) exceed
    :data:`CLUSTER_SMEM_LIMIT`; 0 when no cluster holds them (the scratch
    build's networks).  The card may refuse a cluster it cannot schedule,
    which this does not know."""
    first = min(max(2, -(-slots // MAX_THREADS)), MAX_CLUSTER)
    for blocks in range(first, MAX_CLUSTER + 1):
        if smem_bytes(-(-slots // blocks), n_branches, n_junctions, m_rhs) <= CLUSTER_SMEM_LIMIT:
            return blocks
    return 0


def launch_error(rc: int, build_id: int, cluster: int = 0) -> str:
    """The message of a launch the C entry refused with ``rc``: the build,
    the cluster (its blocks and form) and what the code means."""
    what = _BUILD_NAMES.get(build_id, f"build {build_id}")
    if build_id == CLUSTER_BUILD and cluster:
        what += f" ({cluster & ~CLUSTER_PAIR} blocks a cluster" + (", two an SM)" if cluster & CLUSTER_PAIR else ")")
    return (f"fused_simulate_network launch failed in the {what}: CUDA error {rc} "
            f"({_REFUSALS.get(rc, 'see cudaGetErrorString')}); no other build or plain version runs in its place")


def fused_simulate_network_plain(branches, n_junctions, settings, Y0=None, junction_area=None,
                                 junction_rating=None) -> net.NetworkOutput:
    """The plain PyTorch version of the kernel: the stacked engine with the
    PCR inner solve, each geometry class stacked on its own
    (``ops.network.simulate_stacked(by_class=True)``)."""
    sset = dataclasses.replace(settings, linear_solver="pcr")
    return net.simulate_stacked(branches, n_junctions, sset, Y0=Y0, junction_area=junction_area,
                                junction_rating=junction_rating, by_class=True)


def _lib(table: bool = False):
    """The kernel's library: its trapezoid builds, or (``table``) the builds
    of networks with table branches, a second library of the same source
    (``build.VARIANTS``) that nvcc compiles beside the first."""
    lib = build.load("fused_network_table" if table else "fused_network")
    f = lib.flowsim_fused_network
    if not getattr(f, "_typed", False):
        head = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_void_p] * 14
        f.argtypes = head + [ctypes.c_void_p] + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        lib.flowsim_fused_network_probe.argtypes = head + [ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_int)] \
            + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        lib.flowsim_fused_network_probe.restype = ctypes.c_int
        out = [ctypes.POINTER(ctypes.c_int)]
        for name, ints in (("resident_blocks", 6), ("chosen_build", 6), ("grid", 7), ("cluster", 5)):
            getattr(lib, f"flowsim_fused_network_{name}").argtypes = [ctypes.c_int] * ints + out
            getattr(lib, f"flowsim_fused_network_{name}").restype = ctypes.c_int
        for aux in (lib.flowsim_fused_network_branch_ints, lib.flowsim_fused_network_junction_params,
                    lib.flowsim_fused_network_probe_phases, lib.flowsim_fused_network_assembly_parts,
                    lib.flowsim_fused_network_tables):
            aux.argtypes = []
            aux.restype = ctypes.c_int
        lib.flowsim_fused_network_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.flowsim_fused_network_smem_bytes.restype = ctypes.c_longlong
        lib.flowsim_fused_network_scratch_bytes.argtypes = [ctypes.c_int] * 2
        lib.flowsim_fused_network_scratch_bytes.restype = ctypes.c_longlong
        lib.flowsim_fused_network_bracket_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.flowsim_fused_network_bracket_smem_bytes.restype = ctypes.c_longlong
        if any(lib.flowsim_fused_network_bracket_smem_bytes(*a) != bracket_smem_bytes(*a)
               for a in ((183, 3, 1, 2), (195, 15, 7, 3))):
            raise RuntimeError("the bracket build's shared memory in fused_network.cu and its wrapper differ")
        if lib.flowsim_fused_network_branch_ints() != _BI_COUNT \
                or lib.flowsim_fused_network_junction_params() != _JP_COUNT \
                or lib.flowsim_fused_network_probe_phases() != len(PROBE_PHASES) \
                or lib.flowsim_fused_network_assembly_parts() != len(ASSEMBLY_PARTS) \
                or lib.flowsim_fused_network_tables() != len(_TABLES):
            raise RuntimeError("parameter layout of fused_network.cu and its wrapper differ")
        if any(lib.flowsim_fused_network_smem_bytes(*a) != smem_bytes(*a) for a in ((183, 3, 1, 2), (403, 31, 15, 3))) \
                or any(lib.flowsim_fused_network_scratch_bytes(n, r) != scratch_bytes(1, n, r)
                       for n, r in ((3627, 2), (5715, 3))):
            raise RuntimeError("shared-memory or scratch layout of fused_network.cu and its wrapper differ")
        f._typed = True
    return lib


def _dummy_end(nt, like):
    """A stand-in external end for a junction end, so the single-reach
    packing functions can fill a branch's parameter block (the kernel never
    reads it)."""
    f64 = dict(dtype=torch.float64, device=like.device)
    return bnd.BoundaryParams(kind="flow_hydrograph", bed_level=torch.zeros((), **f64),
                              bed_slope=torch.full((), float("nan"), **f64),
                              initial_depth=torch.full((), float("nan"), **f64),
                              target_series=torch.zeros((nt,), **f64))


def _ends(br, nt, like):
    return tuple(_dummy_end(nt, like) if net._is_junction(e) else e for e in (br.us, br.ds))


def check_supported(branches, n_junctions, settings, junction_rating=None, batch=None):
    """Raise :class:`FusedUnsupported` outside the kernel's scope: no
    junction, a geometry class other than trapezoid or table, table branches
    of different depth-grid resolutions, an external end kernel 1 refuses, a
    junction rating kind the kernel does not evaluate, more than
    :data:`MAX_JUNCTIONS` junctions, or (``batch``: per-branch override
    dicts) a per-member override of a table branch's geometry; a branch of
    more than 8192 nodes is refused by the single-reach check.  A batch is
    checked on its member 0, since the members share every kind.  Any number
    of slots runs: a network that does not fit one block's shared memory
    takes the scratch build."""
    if n_junctions < 1:
        raise FusedUnsupported("not a network (no junctions): run the single reach with "
                               "ops.cuda.fused_newton.fused_simulate")
    if n_junctions > MAX_JUNCTIONS:
        raise FusedUnsupported(f"J > {MAX_JUNCTIONS} junctions exceed the in-kernel Gauss-Jordan budget (J = "
                               f"{n_junctions}): the J x J Schur system is solved in one block's shared memory")
    nt = settings.n_time_levels
    for i, br in enumerate(branches):
        try:
            fn._check_supported(br.geo, *_ends(br, nt, br.h0), settings)
        except FusedUnsupported as e:
            raise FusedUnsupported(f"branch {i}: {e}") from None
    table_m = sorted({int(br.geo.area.shape[-1]) for br in branches if isinstance(br.geo, TableGeometry)})
    if len(table_m) > 1:
        raise FusedUnsupported(
            f"TableGeometry branches must share one depth-grid resolution (got M = {table_m}); rebuild the "
            "tables with a common resolution")
    for i, (br, d) in enumerate(zip(branches, batch or ())):
        if isinstance(br.geo, TableGeometry) and "geo" in d:
            raise FusedUnsupported(
                f"branch {i}: per-member TableGeometry overrides do not batch (the members of a branch share "
                "its lookup tables); run the members one by one")
    for j, rc in enumerate(junction_rating or ()):
        if rc is None:
            continue
        if rc.kind not in _JR_KINDS:
            raise FusedUnsupported(f"junction {j} rating kind {rc.kind!r}; the kernel has {tuple(_JR_KINDS)}")
        if rc.kind in ("polynomial", "blended_poly") and rc.coeffs.shape[-1] != 3:
            raise FusedUnsupported(f"junction {j}: a {rc.kind} rating packs a quadratic (3 coefficients); "
                                   "use poly_n for another degree")
    return net.stacked_topology(branches)


def table_resolution(branches) -> int:
    """The depth samples M of the network's table branches (0: none)."""
    return next((int(br.geo.area.shape[-1]) for br in branches if isinstance(br.geo, TableGeometry)), 0)


def pack_tables(branches, n_max: int) -> torch.Tensor | None:
    """The seven tables of every table branch, ``[T, 7, n_max, M]`` float64,
    edge-padded along the node axis (a pad node reads its branch's last
    node): one copy for the launch, which every member reads.  ``None``
    without table branches."""
    geos = [br.geo for br in branches if isinstance(br.geo, TableGeometry)]
    if not geos:
        return None
    return torch.stack([torch.stack([net.edge_pad(getattr(g, t).to(torch.float64), n_max) for t in _TABLES])
                        for g in geos]).contiguous()


def table_branches(branches, dev) -> torch.Tensor | None:
    """Each branch's index among the table branches, -1 for a trapezoid one
    (int32 ``[B]`` on ``dev``); ``None`` without table branches."""
    is_table = [isinstance(br.geo, TableGeometry) for br in branches]
    if not any(is_table):
        return None
    index = torch.cumsum(torch.tensor(is_table, dtype=torch.int32), 0) - 1
    return torch.where(torch.tensor(is_table), index, -1).to(torch.int32).to(dev)


def table_bytes(branches, n_max: int) -> int:
    """Bytes of :func:`pack_tables`' output."""
    return 8 * len(_TABLES) * n_max * table_resolution(branches) * sum(
        isinstance(br.geo, TableGeometry) for br in branches)


def _geometry_rows(geo) -> torch.Tensor:
    """A branch's geometry rows ``[13, N]`` (``[M, 13, N]`` batched): a
    trapezoid's own (``fused_newton.pack_geometry``), or a table branch's
    bed level, table span, bed slope and curvature in the rows the kernel
    reads for them (:data:`_TABLE_GEO_ROWS`)."""
    if not isinstance(geo, TableGeometry):
        return fn.pack_geometry(geo)
    z = geo.z_bed.to(torch.float64)
    rows = [torch.zeros_like(z)] * len(fn._GEO_ROWS)
    for r, name in _TABLE_GEO_ROWS.items():
        rows[r] = getattr(geo, name).to(torch.float64)
    return torch.stack(rows, dim=-2).contiguous()


def _edge_pad_last(x, n_max):
    n = x.shape[-1]
    return x if n == n_max else torch.cat([x, x[..., -1:].expand(*x.shape[:-1], n_max - n)], dim=-1)


def _junction_block(junction_area, junction_rating, J, dev):
    """The shared junction inputs: ``jpar [J, 14]`` and ``jtab`` (poly_n
    coefficients, table stages and discharges)."""
    f64 = dict(dtype=torch.float64, device=dev)
    jpar = torch.zeros((J, _JP_COUNT), **f64)
    jpar[:, _JP_KIND] = -1.0
    if junction_area is not None:
        jpar[:, _JP_AREA] = farray(junction_area, dev)
    tab = [torch.zeros((1,), **f64)]
    off = 1
    for j, rc in enumerate(junction_rating or ()):
        if rc is None:
            continue
        jpar[j, _JP_KIND] = _JR_KINDS[rc.kind]
        for slot, v in ((_JP_SHIFT, rc.stage_shift), (_JP_PIVOT, rc.pivot_stage), (_JP_BUFFER, rc.buffer),
                        (_JP_FD, rc.fd_step)):
            jpar[j, slot] = v.to(**f64)
        if rc.kind in ("polynomial", "blended_poly", "power"):
            c = rc.coeffs.to(**f64)
            jpar[j, _JP_C0:_JP_C0 + c.shape[0]] = c
            if rc.kind == "blended_poly":
                jpar[j, _JP_H0:_JP_H0 + 3] = rc.coeffs_high.to(**f64)
        else:
            parts = [rc.coeffs] if rc.kind == "poly_n" else [rc.table_stage, rc.table_q]
            jpar[j, _JP_NCOEF] = parts[0].shape[0]
            jpar[j, _JP_OFF] = off
            for p in parts:
                tab.append(p.to(**f64))
                off += p.shape[0]
    return jpar.contiguous(), torch.cat(tab).contiguous()


def output_bytes(n_members, n_branches, n_max, n_junctions, nt) -> int:
    """Bytes of the kernel's outputs: depth and flow of every padded slot,
    the junction stages, two reservoir stages and two gate flags per branch,
    error, iterations and converged, per level and member."""
    return n_members * nt * (2 * n_branches * n_max * 8 + n_junctions * 8 + 4 * n_branches * 8 + 8 + 2 * 4)


def check_output_memory(n_members, n_branches, n_max, n_junctions, nt, free_bytes, scratch_blocks: int = 0,
                        m_rhs: int = 2) -> None:
    """Refuse, before anything is allocated, a launch whose outputs (and,
    with ``scratch_blocks``, the scratch build's scratch of that many blocks
    at ``m_rhs``) exceed the card's free memory."""
    out = output_bytes(n_members, n_branches, n_max, n_junctions, nt)
    scratch = scratch_bytes(scratch_blocks, n_branches * n_max, m_rhs)
    if out + scratch > free_bytes:
        what = f"outputs ({out / 1e9:.2f} GB)" + (f" and scratch ({scratch / 1e9:.2f} GB)" if scratch else "")
        raise MemoryError(
            f"the {what} of {n_members} network simulations ({n_branches} branches x {n_max} nodes, "
            f"nt={nt}) take {(out + scratch) / 1e9:.2f} GB but the card has {free_bytes / 1e9:.2f} GB free: run "
            f"the ensemble in chunks (batched_simulate_network(..., chunk_size=...))")


def _pack(branches, J, settings, batch, M, Y0, junction_area, junction_rating, topo):
    """The kernel's inputs with a leading member axis M (batch: per-branch
    override dicts, or empty dicts)."""
    nt, Nmax, B = settings.n_time_levels, topo.n_max, len(branches)
    dev = branches[0].h0.device
    f64 = dict(dtype=torch.float64, device=dev)
    lead = (M,)
    geo_rows, h0s, Q0s, sers, pars, stors, tabs, qlats = [], [], [], [], [], [], [], []
    bint = torch.zeros((B, _BI_COUNT), dtype=torch.int32)
    any_tab_member = storage = False
    tab_off = 0
    for b, (br, d) in enumerate(zip(branches, batch)):
        geo, us, ds = (d.get(k, getattr(br, k)) for k in ("geo", "us", "ds"))
        h0 = d.get("h0", br.h0)
        Q0 = d.get("Q0", br.Q0)
        rows = _geometry_rows(geo)                                    # [13, N] or [M, 13, N]
        geo_rows.append(_edge_pad_last(rows, Nmax).expand(M, -1, Nmax))
        h0s.append(_edge_pad_last(h0.to(**f64), Nmax).expand(M, Nmax))
        Q0s.append(_edge_pad_last(Q0.to(**f64), Nmax).expand(M, Nmax))
        ends = [_dummy_end(nt, h0) if net._is_junction(e) else e for e in (us, ds)]
        # a shared end gains the member axis inside the packing functions
        sset = dataclasses.replace(settings, spatial_step=float(br.dx))
        par, rc_kind, us_rc_kind = fn.pack_params(ends[0], ends[1], sset, batch_shape=lead)
        pars.append(par)
        sers.append(torch.stack([fn.series(e, nt, dev, lead) for e in ends], dim=1))
        stor, stab, st = fn.pack_storage(ends[0], ends[1], batch_shape=lead)
        stors.append(stor)
        storage |= bool((st[0] | st[1]) & fn._ST_ON)
        tab_len = fn.storage_table_len(st)
        if tab_len:
            tabs.append(stab)
            any_tab_member |= stab.dim() == 2
        kind = lambda e: -1 if net._is_junction(e) else fn._BC_KINDS[e.kind]
        jid = lambda e: int(e) if net._is_junction(e) else -1
        bint[b] = torch.tensor([topo.n_b[b], jid(br.us), jid(br.ds), max(kind(br.us), 0), max(kind(br.ds), 0),
                                rc_kind, us_rc_kind, *st, tab_off], dtype=torch.int32)
        tab_off += tab_len
        q = d.get("qlat", None)
        if q is not None:
            q = torch.as_tensor(q, **f64)                              # [M, N] or [M, nt, N]
        elif br.qlat is not None:
            q = torch.as_tensor(br.qlat, **f64).expand(M, *br.qlat.shape)
        qlats.append(q)
    geo_all = torch.stack(geo_rows, dim=1).contiguous()               # [M, B, 13, Nmax]
    h0_all = torch.stack(h0s, dim=1).contiguous()
    Q0_all = torch.stack(Q0s, dim=1).contiguous()
    ser_all = torch.stack(sers, dim=1).contiguous()                   # [M, B, 2, nt]
    par_all = torch.stack(pars, dim=1).contiguous()                   # [M, B, 32]
    stor_all = torch.stack(stors, dim=1).contiguous()                 # [M, B, 2, 17]
    if not tabs:
        stab_all, stride = torch.zeros((1,), **f64), 0
    elif any_tab_member:
        stab_all = torch.cat([t.expand(M, t.shape[-1]) for t in tabs], dim=-1).contiguous()
        stride = stab_all.shape[-1]
    else:
        stab_all, stride = torch.cat(tabs).contiguous(), 0
    if all(q is None for q in qlats):
        qlat_all = None
    else:
        levels = any(q is not None and q.dim() == 3 for q in qlats)
        per = []
        for q, n in zip(qlats, topo.n_b):
            q = torch.zeros((M, n), **f64) if q is None else q
            if levels and q.dim() == 2:
                q = q[:, None, :].expand(M, nt, n)
            per.append(_edge_pad_last(q, Nmax))
        qlat_all = torch.stack(per, dim=-2).contiguous()              # [M, B, Nmax] / [M, nt, B, Nmax]
    if Y0 is None:
        # default_initial_stages: the first connected end of each junction,
        # downstream ends preferred, per member
        found = {}
        for b, br in enumerate(branches):
            for end, idx in ((br.ds, topo.n_b[b] - 1), (br.us, 0)):
                if net._is_junction(end) and int(end) not in found:
                    found[int(end)] = geo_all[:, b, 0, idx] + h0_all[:, b, idx]
        Y0_all = torch.stack([found[j] for j in range(J)], dim=-1)
    else:
        Y0_all = torch.as_tensor(Y0, **f64).expand(M, J)
    jpar, jtab = _junction_block(junction_area, junction_rating, J, dev)
    return dict(geo=geo_all, h0=h0_all, Q0=Q0_all, ser=ser_all, par=par_all, qlat=qlat_all, stor=stor_all,
                stab=stab_all, stride=stride, Y0=Y0_all.contiguous(), bint=bint.to(dev), jpar=jpar, jtab=jtab,
                tab=pack_tables(branches, Nmax), tab_branch=table_branches(branches, dev),
                tab_m=table_resolution(branches), storage=storage)


def _outputs(M, B, J, nt, n_max, dev):
    """The kernel's output tensors (stage NaN-filled: levels and ends without
    storage keep NaN)."""
    f64 = dict(dtype=torch.float64, device=dev)
    return dict(depth=torch.empty((M, nt, B, n_max), **f64), flow=torch.empty((M, nt, B, n_max), **f64),
                Y=torch.empty((M, nt, J), **f64), iters=torch.empty((M, nt), dtype=torch.int32, device=dev),
                err=torch.empty((M, nt), **f64), conv=torch.empty((M, nt), dtype=torch.int32, device=dev),
                stage=torch.full((M, nt, B, 2), float("nan"), **f64), gate=torch.empty((M, nt, B, 2), **f64))


def _c_args(p, o):
    """The pointer arguments the C entries share, in their order."""
    qlat, tab, tab_branch = p["qlat"], p["tab"], p["tab_branch"]
    return (p["geo"].data_ptr(), p["h0"].data_ptr(), p["Q0"].data_ptr(), p["ser"].data_ptr(), p["par"].data_ptr(),
            None if qlat is None else qlat.data_ptr(), p["stor"].data_ptr(), p["stab"].data_ptr(), p["stride"],
            p["Y0"].data_ptr(), p["bint"].data_ptr(), p["jpar"].data_ptr(), p["jtab"].data_ptr(),
            None if tab_branch is None else tab_branch.data_ptr(), None if tab is None else tab.data_ptr(),
            *(o[k].data_ptr() for k in ("depth", "flow", "Y", "iters", "err", "conv", "stage", "gate")))


def _launch(p, M, B, J, settings, topo, build_id=CHOOSE_BUILD, probe=None, cluster=0):
    """One launch for M members; returns the raw output tensors.
    ``build_id``: :data:`CHOOSE_BUILD` (the C entry chooses by the network's
    size and the member count, :func:`chosen_build`) or a forced build, a
    test hook; ``cluster`` (the cluster build): 0 for the C entry's cluster
    (:func:`cluster_of`) or a forced one, a test hook.  The scratch build's
    scratch (:func:`scratch_bytes` of :func:`scratch_grid` blocks) is
    allocated here, counted with the outputs against the card's free memory;
    the cluster build allocates none.  ``probe``: ``None``, or an int64
    tensor ``[len(PROBE_FIELDS)]`` on the device that the probe build of the
    loop, latency, scratch, cluster, bracket or lean build fills with cycles; the SM clock
    in kHz is then returned after the outputs.  A refused launch raises
    :class:`RuntimeError` (:func:`launch_error`)."""
    nt, Nmax = settings.n_time_levels, topo.n_max
    dev = p["geo"].device
    table = p["tab_m"] != 0
    shape = (B * Nmax, B, J, topo.m_rhs)
    with torch.cuda.device(dev):
        if build_id == CHOOSE_BUILD:
            build_id = _chosen(p, M, B, J, topo)
        if build_id == CLUSTER_BUILD:
            cluster = cluster_of(*shape, cluster, table=table)
        blocks = scratch_grid(M, *shape, build_id, table=table) if build_id == SCRATCH_BUILD else 0
        check_output_memory(M, B, Nmax, J, nt, torch.cuda.mem_get_info()[0], blocks, topo.m_rhs)
        scratch = torch.empty(scratch_bytes(blocks, B * Nmax, topo.m_rhs) // 8, dtype=torch.float64,
                              device=dev) if blocks else None
        o = _outputs(M, B, J, nt, Nmax, dev)
        qlat = p["qlat"]
        tail = (M, B, Nmax, J, nt, int(settings.max_iter), topo.m_rhs, 0 if qlat is None else qlat.dim() - 2,
                p["tab_m"], build_id, cluster, torch.cuda.current_stream().cuda_stream)
        lib = _lib(table)
        clock = ctypes.c_int(0)
        scratch_ptr = None if scratch is None else scratch.data_ptr()
        if probe is None:
            rc = lib.flowsim_fused_network(*_c_args(p, o), scratch_ptr, *tail)
        else:
            rc = lib.flowsim_fused_network_probe(*_c_args(p, o), scratch_ptr, probe.data_ptr(), ctypes.byref(clock),
                                                 *tail)
    if rc != 0:
        raise RuntimeError(launch_error(rc, build_id, cluster))
    raw = tuple(o[k] for k in ("depth", "flow", "Y", "iters", "err", "conv", "stage", "gate"))
    return raw if probe is None else (*raw, clock.value)


def chosen_build(n_members: int, slots: int, n_branches: int, n_junctions: int, m_rhs: int,
                 table: bool = False, storage: bool = False) -> int:
    """The build the C entry takes for ``n_members`` members of a network of
    this shape (when the slot arrays do not fit one block's shared memory,
    the cluster build while a cluster holds them and the card holds the
    batch in one wave of clusters, else the scratch build; the loop build
    for more slots than threads; else the latency build, or the residency
    build for a batch larger than the card holds in the latency one);
    ``table``: a network with table branches, which chooses among the table
    builds the same way, the bracket build where the residency build would
    run, and where the latency build would the lean build with side warps
    for a network that takes them, an SM a member and (``storage``) no
    lumped storage at an external end, else the lean build where it holds
    the batch at once."""
    out = ctypes.c_int(0)
    rc = _lib(table).flowsim_fused_network_chosen_build(n_members, slots, n_branches, n_junctions, m_rhs,
                                                        int(storage), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"build choice failed: CUDA error {rc}")
    return out.value


def resident_blocks(slots: int, n_branches: int, n_junctions: int, m_rhs: int, build_id: int,
                    table: bool = False, cluster: int = 0) -> int:
    """Blocks of a kernel build (``table``: its table build; ``cluster`` as
    :func:`_launch` takes it) that one SM holds for this network's block
    size and shared memory, from the CUDA occupancy calculator."""
    out = ctypes.c_int(0)
    rc = _lib(table).flowsim_fused_network_resident_blocks(slots, n_branches, n_junctions, m_rhs, build_id, cluster,
                                                           ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return out.value


def scratch_grid(n_members: int, slots: int, n_branches: int, n_junctions: int, m_rhs: int,
                 build_id: int = SCRATCH_BUILD, table: bool = False, cluster: int = 0) -> int:
    """The grid the C entry launches for ``n_members`` members in a build:
    ``n_members``; in the scratch build at most the blocks the card holds at
    once (the occupancy calculator's blocks an SM times the SMs), each with
    a scratch of its own; in the cluster build (``cluster`` as
    :func:`_launch` takes it) the blocks of at most the clusters it holds at
    once.  Raises :class:`RuntimeError` (:func:`launch_error`) for a launch
    the C entry refuses."""
    out = ctypes.c_int(0)
    rc = _lib(table).flowsim_fused_network_grid(n_members, slots, n_branches, n_junctions, m_rhs, build_id, cluster,
                                                ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(launch_error(rc, build_id, cluster))
    return out.value


def cluster_of(slots: int, n_branches: int, n_junctions: int, m_rhs: int, cluster: int = 0,
               table: bool = False) -> int:
    """The cluster the C entry launches the cluster build with: ``cluster``
    checked, or (0) its choice (:func:`cluster_blocks`, and a cluster the
    card can schedule); its blocks, plus :data:`CLUSTER_PAIR` for the
    two-blocks-an-SM form.  Raises :class:`RuntimeError`
    (:func:`launch_error`) when no cluster holds the network or the forced
    one is out of range."""
    out = ctypes.c_int(0)
    rc = _lib(table).flowsim_fused_network_cluster(slots, n_branches, n_junctions, m_rhs, cluster,
                                                   ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(launch_error(rc, CLUSTER_BUILD, cluster))
    return out.value


def _output(raw, topo, junction_rating) -> net.NetworkOutput:
    """NetworkOutput with a leading member axis on every field."""
    depth, flow, Y, iters, err, conv, stage, gate = raw
    return net.NetworkOutput(
        depth=tuple(depth[:, :, b, :n] for b, n in enumerate(topo.n_b)),
        flow=tuple(flow[:, :, b, :n] for b, n in enumerate(topo.n_b)),
        junction_stage=Y, iterations=iters, error=err, converged=conv.bool(), reservoir_stage=stage,
        gate_open=gate, junction_outflow=net.junction_outflow_series(junction_rating, Y))


def _check_device(branches, dev, name):
    """Every branch on the launch's card, and the packed tables within its
    free memory (a table's resolution M is bounded by device memory alone)."""
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA or CPU tensors; got {dev}")
    for br in branches:
        us, ds = _ends(br, 1, br.h0)
        fn.check_device(dev, br.h0, br.Q0, br.geo, us, ds, name)
    need = table_bytes(branches, max(int(br.h0.shape[0]) for br in branches))
    if need:
        free = torch.cuda.mem_get_info(dev)[0]
        if need > free:
            raise MemoryError(f"{name}: the packed tables of the table branches take {need / 1e9:.2f} GB but the "
                              f"card has {free / 1e9:.2f} GB free: rebuild them with fewer depth samples")


def fused_simulate_network(branches, n_junctions, settings, Y0=None, junction_area=None,
                           junction_rating=None) -> net.NetworkOutput:
    """Run a whole network simulation in ONE kernel launch.

    Same arguments and :class:`~flowsim_tpu_torch.ops.network.NetworkOutput`
    as :func:`~flowsim_tpu_torch.ops.network.simulate_network`.  Raises
    :class:`FusedUnsupported` outside the kernel's scope (:func:`check_supported`)
    and ``ValueError`` for inputs of the wrong shape, before any launch.  CPU
    tensors take the plain version."""
    global launch_count, scratch_launch_count, cluster_launch_count, lean_launch_count
    net._check_supported(branches, n_junctions, settings)
    net.check_junction_inputs(junction_area, junction_rating, n_junctions)
    topo = check_supported(branches, n_junctions, settings, junction_rating)
    dev = branches[0].h0.device
    if dev.type == "cpu":
        return fused_simulate_network_plain(branches, n_junctions, settings, Y0, junction_area, junction_rating)
    _check_device(branches, dev, "fused_simulate_network")
    p = _pack(branches, n_junctions, settings, [dict() for _ in branches], 1, Y0, junction_area,
              junction_rating, topo)
    build_id = _chosen(p, 1, len(branches), n_junctions, topo)
    raw = _launch(p, 1, len(branches), n_junctions, settings, topo, build_id=build_id)
    launch_count += 1
    scratch_launch_count += build_id == SCRATCH_BUILD
    cluster_launch_count += build_id == CLUSTER_BUILD
    lean_launch_count += build_id in (LEAN_BUILD, LEAN_SIDE_BUILD)
    return _single(_output(raw, topo, junction_rating))


def _chosen(p, M, B, J, topo) -> int:
    """The build the C entry takes for this packed launch of M members."""
    with torch.cuda.device(p["geo"].device):
        return chosen_build(M, B * topo.n_max, B, J, topo.m_rhs, table=p["tab_m"] != 0, storage=p["storage"])


def _single(out) -> net.NetworkOutput:
    """Member 0 of a NetworkOutput with a leading member axis."""
    return net.NetworkOutput(depth=tuple(d[0] for d in out.depth), flow=tuple(f[0] for f in out.flow),
                             **{k: getattr(out, k)[0] for k in net.NetworkOutput._fields if k not in ("depth", "flow")})


def fused_simulate_network_probe(branches, n_junctions, settings, build_id=LATENCY_BUILD, Y0=None,
                                 junction_area=None, junction_rating=None, cluster=0):
    """A measurement hook: one launch of the probe build of the loop
    (:data:`LOOP_BUILD`), latency (:data:`LATENCY_BUILD`), scratch
    (:data:`SCRATCH_BUILD`) or cluster (:data:`CLUSTER_BUILD`, ``cluster``
    as :func:`_launch` takes it) build on CUDA tensors; the scratch and
    cluster ones for trapezoid networks, the bracket and lean builds'
    (:data:`BRACKET_BUILD`, :data:`LEAN_BUILD`, :data:`LEAN_SIDE_BUILD`) for networks with table
    branches.  Returns ``(NetworkOutput, cycles,
    clock_khz)``: ``cycles`` maps each of :data:`PROBE_PHASES` to the SM
    cycles thread 0 (of the first cluster's rank 0) spent in it over the
    run, and each of :data:`ASSEMBLY_PARTS` to its cycles of the assembly
    phase; ``clock_khz`` is the clock rate they count at.  Its outputs are the
    production build's bits.  Counts no launch."""
    net._check_supported(branches, n_junctions, settings)
    net.check_junction_inputs(junction_area, junction_rating, n_junctions)
    topo = check_supported(branches, n_junctions, settings, junction_rating)
    dev = branches[0].h0.device
    _check_device(branches, dev, "fused_simulate_network_probe")
    p = _pack(branches, n_junctions, settings, [dict() for _ in branches], 1, Y0, junction_area,
              junction_rating, topo)
    probe = torch.zeros(len(PROBE_FIELDS), dtype=torch.int64, device=dev)
    *raw, clock_khz = _launch(p, 1, len(branches), n_junctions, settings, topo, build_id=build_id, probe=probe,
                              cluster=cluster)
    return _single(_output(raw, topo, junction_rating)), dict(zip(PROBE_FIELDS, probe.tolist())), clock_khz


def fused_simulate_network_batched_plain(branches, n_junctions, settings, batch, Y0=None,
                                         junction_area=None, junction_rating=None) -> net.NetworkOutput:
    """The plain PyTorch version of the batched kernel: every member through
    :func:`fused_simulate_network_plain`, stacked on a leading member axis."""
    return net.simulate_members(branches, n_junctions, dataclasses.replace(settings, linear_solver="pcr"), batch,
                                Y0=Y0, junction_area=junction_area, junction_rating=junction_rating, by_class=True)


def fused_simulate_network_batched(branches, n_junctions, settings, batch, Y0=None, junction_area=None,
                                   junction_rating=None) -> net.NetworkOutput:
    """M network simulations in ONE kernel launch, one block per member.

    ``batch``: one dict per branch of per-member overrides (:func:`~flowsim_tpu_torch.ops.network.check_batch`);
    the branch layout, boundary kinds and junction configuration are shared.
    Returns a NetworkOutput whose fields carry a leading member axis (depth
    and flow ``[M, nt, N_b]`` per branch).  Raises :class:`FusedUnsupported`
    outside the kernel's scope and ``MemoryError`` when the outputs (with the
    scratch build's scratch) would not fit the card.  CPU tensors take the plain version."""
    global batched_launch_count, batched_scratch_launch_count, batched_cluster_launch_count, \
        batched_bracket_launch_count, batched_lean_launch_count
    M = net.check_batch(branches, batch, settings)
    net._check_supported(branches, n_junctions, settings)
    net.check_junction_inputs(junction_area, junction_rating, n_junctions)
    topo = check_supported(net.member_branches(branches, batch, 0), n_junctions, settings, junction_rating, batch)
    dev = branches[0].h0.device
    if dev.type == "cpu":
        return fused_simulate_network_batched_plain(branches, n_junctions, settings, batch, Y0, junction_area,
                                                    junction_rating)
    _check_device(branches, dev, "fused_simulate_network_batched")
    p = _pack(branches, n_junctions, settings, batch, M, Y0, junction_area, junction_rating, topo)
    build_id = _chosen(p, M, len(branches), n_junctions, topo)
    raw = _launch(p, M, len(branches), n_junctions, settings, topo, build_id=build_id)
    batched_launch_count += 1
    batched_scratch_launch_count += build_id == SCRATCH_BUILD
    batched_cluster_launch_count += build_id == CLUSTER_BUILD
    batched_bracket_launch_count += build_id == BRACKET_BUILD
    batched_lean_launch_count += build_id in (LEAN_BUILD, LEAN_SIDE_BUILD)
    return _output(raw, topo, junction_rating)
