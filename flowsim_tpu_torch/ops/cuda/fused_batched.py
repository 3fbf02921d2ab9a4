"""``fused_simulate_batched``: B whole simulations in one CUDA kernel launch.

Counterpart of ``flowsim_tpu/ops/pallas/fused_newton.py``
(``_prepare_batched`` / ``_unpack_batched`` / ``fused_simulate_batched``): the
Monte-Carlo and calibration-sweep engine.  The kernel is
``csrc/fused_newton.cu`` on a grid of B thread blocks, one per ensemble
member: every member has its own geometry rows, initial state, boundary
series, parameter block, lateral inflow and gate-controller state, and runs
its own while-Newton, so its per-level iteration counts are those of its
single run and a member that diverges holds up no other.  What the TPU kernel
needs for members on vector sublanes — padding to 8 members, lifting the
slots that vary, a member cap from on-chip memory, level streaming — has no
counterpart: a grid larger than what the card holds at once is queued by the
hardware scheduler.

What bounds it on an H100: at a few members, the latency chain of one
simulation (see ``csrc/fused_newton.cu``); at many, the members in flight.
The flagship's 128-thread block takes 250 registers per thread, so two blocks
are resident per SM (264 members on the card).  A larger batch takes the
kernel's residency build (128 registers, four blocks an SM, 528 members in
flight, the same bits), chosen by the C entry from the member count; PERF.md
keeps the readings.

Irregular sections: a batched :class:`TableGeometry` (what
``parallel.ensemble.table_roughness_ensemble`` gives) runs in the kernel's
table builds.  Its members must share the four tables that the geometry alone
sets (A, P, T, dR/dA), packed once; each member's K, n_eq and dK/dA are its
own, so a batched launch gives each member the bits of its single launch.
The TPU kernel's factored form (member 0's tables times a per-member
conveyance scale) would round differently and is not carried over.  A table
batch that one wave of the kernel's lean build holds takes it (each node's
table bracket cached in shared memory, carried-inverse sweeps, one block an
SM guaranteed); past one wave of the register build, the bracket build (the
same cache, four blocks an SM).

Reaches of more than ``fused_newton.MAX_N`` nodes run, as a batch, in the
kernel's cluster build: each member over a thread-block cluster of 2-16
blocks (``fused_newton.cluster_blocks``), its state in their shared memory,
on a persistent grid of as many clusters as the card holds at once (one
simulation there takes ``fused_newton``'s reach build); the outputs are
counted against the card's free memory before anything is allocated.

The boundary *kinds* and the settings are shared by all members; everything
else may differ (a lumped storage's outflow rating keeps one kind and one
length of coefficients or table across the members).  Packing is done with
tensor ops on the members' device (stack / expand), never a Python loop over
members.

On CUDA tensors the wrapper launches the kernel or raises.  The plain version
:func:`fused_simulate_batched_plain` — a loop over members through the plain
engine — runs only for tensors that lie on the CPU.
"""

from __future__ import annotations

import torch

from flowsim_tpu_torch import trees
from flowsim_tpu_torch.geometry import TableGeometry, TrapezoidGeometry
from flowsim_tpu_torch.ops import preissmann as prs
from flowsim_tpu_torch.ops.cuda import fused_newton as fn
from flowsim_tpu_torch.ops.cuda.fused_newton import FusedUnsupported

# number of kernel launches made by fused_simulate_batched (not by its plain
# version, and not by fused_simulate); of those, by the build launched: a
# long-reach build (fused_newton.LONG_REACH_BUILDS), the cluster build, the
# bracket build, the lean build
launch_count = 0
long_launch_count = 0
cluster_launch_count = 0
bracket_launch_count = 0
lean_launch_count = 0


def _check_batched_boundary(name, flag, bc, batched, n_members, nt):
    lead = (n_members,) if batched else ()
    if tuple(bc.bed_level.shape) != lead:
        raise ValueError(
            f"{name} boundary: {flag}={batched} needs leaves of leading shape {lead}; "
            f"bed_level has {tuple(bc.bed_level.shape)}")
    if bc.kind in ("flow_hydrograph", "stage_hydrograph") and tuple(bc.target_series.shape) != (*lead, nt):
        raise ValueError(
            f"{name} target_series must have shape {(*lead, nt)}; got {tuple(bc.target_series.shape)}")


def batched_lateral_inflow(lateral_inflow, n_members, n, nt, like):
    """``None``, or the inflow as ``[B, N]`` (constant in time) or
    ``[B, nt, N]``.  Accepted: shared ``[N]``, per-member constants ``[B, N]``
    (a 2-D argument is always member-major) and per-member series
    ``[B, nt, N]``; express a shared series by broadcasting."""
    if lateral_inflow is None:
        return None
    q = prs.as_lateral_inflow(lateral_inflow, like)
    if q.dim() == 1 and q.shape[0] == n:
        return q.expand(n_members, n)
    if q.dim() == 2 and n_members == nt and tuple(q.shape) == (n_members, n):
        # per-member constants [B, N] and a shared series [nt, N] cannot be
        # told apart when B == nt: refuse rather than pick one
        raise ValueError(
            f"2-D lateral_inflow is ambiguous when the member count equals the level count "
            f"(B={n_members} == nt={nt}): broadcast to [B, nt, N] to disambiguate")
    if tuple(q.shape) in ((n_members, n), (n_members, nt, n)):
        return q
    raise FusedUnsupported(
        f"batched lateral_inflow must be [N={n}], [B={n_members}, N] per-member constants or "
        f"[B, nt={nt}, N] per-member series; got {tuple(q.shape)}")


def _member_args(geo_batch, us_bc, ds_bc, h0, Q0, qlat, us_batched, ds_batched, m):
    return (trees.member(geo_batch, m),
            trees.member(us_bc, m) if us_batched else us_bc,
            trees.member(ds_bc, m) if ds_batched else ds_bc,
            h0[m] if h0.dim() > 1 else h0, Q0[m] if Q0.dim() > 1 else Q0,
            None if qlat is None else qlat[m])


def member_loop(simulate_one, geo_batch, us_bc, ds_bc, h0, Q0, us_batched, ds_batched, qlat):
    """``simulate_one(geo, us_bc, ds_bc, h0, Q0, lateral_inflow)`` for every
    member of the batch (``qlat`` as :func:`batched_lateral_inflow` returns
    it), stacked on a leading member axis."""
    outs = []
    for m in range(geo_batch.z_bed.shape[0]):
        outs.append(simulate_one(
            *_member_args(geo_batch, us_bc, ds_bc, h0, Q0, qlat, us_batched, ds_batched, m)))
    return prs.SimOutput(*(None if f[0] is None else torch.stack(f) for f in zip(*outs)))


def _plain(geo_batch, us_bc, ds_bc, h0, Q0, settings, us_batched, ds_batched, qlat):
    one = lambda *args: fn.fused_simulate_plain(*args[:5], settings, lateral_inflow=args[5])
    return member_loop(one, geo_batch, us_bc, ds_bc, h0, Q0, us_batched, ds_batched, qlat)


def fused_simulate_batched_plain(geo_batch, us_bc, ds_bc, h0, Q0, settings, us_batched=False,
                                 ds_batched=False, lateral_inflow=None) -> prs.SimOutput:
    """The plain PyTorch version of the batched kernel: every member through
    the eager scan-of-Newton with the PCR inner solve, stacked on a leading
    member axis."""
    n_members, n = geo_batch.z_bed.shape
    qlat = batched_lateral_inflow(lateral_inflow, n_members, n, settings.n_time_levels, h0)
    return _plain(geo_batch, us_bc, ds_bc, h0, Q0, settings, us_batched, ds_batched, qlat)


def fused_simulate_batched(geo_batch, us_bc, ds_bc, h0, Q0, settings, us_batched=False,
                           ds_batched=False, lateral_inflow=None) -> prs.SimOutput:
    """Run a member-batch of full simulations in ONE kernel launch.

    ``geo_batch``: TrapezoidGeometry with a leading member axis on every leaf
    (``parallel.ensemble.stack_geometries`` / ``roughness_ensemble``), or a
    TableGeometry whose members share A, P, T and dR/dA
    (``table_roughness_ensemble``).
    ``us_bc`` / ``ds_bc``: shared BoundaryParams, or (with ``us_batched`` /
    ``ds_batched``) the stacked per-member params of
    ``ensemble.batch_boundaries`` — per-member target series, initial depth,
    bed level, rating coefficients, pivots, gate cooldown and lumped storage
    (surface area, bracket, loss coefficients, storage rating, and the
    members' own stage-area tables); the kinds, the storage options and the
    table lengths are shared.  ``h0`` / ``Q0``: ``[N]`` shared or ``[B, N]``
    per member.
    ``lateral_inflow``: see :func:`batched_lateral_inflow`.

    Returns a SimOutput whose fields carry a leading member axis: depth/flow
    ``[B, nt, N]`` (``[B, nt, 2]`` with ``settings.store="boundaries"``),
    iterations / error / converged / gate_open / reservoir_stage /
    reservoir_stage_us ``[B, nt]``.

    Raises :class:`FusedUnsupported` outside the kernel's scope and
    ``MemoryError`` when the outputs would not fit the card's free memory.
    CPU tensors take the plain version.
    """
    global launch_count, long_launch_count, cluster_launch_count, bracket_launch_count, lean_launch_count
    if not isinstance(geo_batch, (TrapezoidGeometry, TableGeometry)):
        raise FusedUnsupported(
            f"unknown geometry class {type(geo_batch).__name__!r}: the batched fused kernel takes "
            "TrapezoidGeometry or TableGeometry")
    if geo_batch.z_bed.dim() != 2:
        raise FusedUnsupported("geo_batch needs a leading member axis")
    n_members, n = geo_batch.z_bed.shape
    nt = settings.n_time_levels
    _check_batched_boundary("upstream", "us_batched", us_bc, us_batched, n_members, nt)
    _check_batched_boundary("downstream", "ds_batched", ds_bc, ds_batched, n_members, nt)
    for name, t in (("h0", h0), ("Q0", Q0)):
        if tuple(t.shape) not in ((n,), (n_members, n)):
            raise ValueError(f"{name} must be [N={n}] or [B={n_members}, N]; got {tuple(t.shape)}")
    qlat = batched_lateral_inflow(lateral_inflow, n_members, n, nt, h0)
    geo0, us0, ds0, *_ = _member_args(geo_batch, us_bc, ds_bc, h0, Q0, None, us_batched, ds_batched, 0)
    fn._check_supported(geo0, us0, ds0, settings)
    if isinstance(geo_batch, TableGeometry):
        fn.check_shared_tables(geo_batch)

    dev = h0.device
    if dev.type == "cpu":
        return _plain(geo_batch, us_bc, ds_bc, h0, Q0, settings, us_batched, ds_batched, qlat)
    fn.check_device(dev, h0, Q0, geo_batch, us_bc, ds_bc, "fused_simulate_batched")

    lead = (n_members,)
    tables = fn.pack_tables(geo_batch, n_members)
    par, rc_kind, us_rc_kind = fn.pack_params(us_bc, ds_bc, settings, batch_shape=lead)
    storage = fn.pack_storage(us_bc, ds_bc, batch_shape=lead)
    st = storage[2]
    with torch.cuda.device(dev):
        build_id = fn.chosen_build(n_members, n, bool((st[0] | st[1]) & fn._ST_ON), bool(tables[2]))
    out = fn.launch(fn.pack_geometry(geo_batch), h0.expand(n_members, n).contiguous(),
                    Q0.expand(n_members, n).contiguous(), fn.series(us_bc, nt, dev, lead),
                    fn.series(ds_bc, nt, dev, lead), par,
                    None if qlat is None else qlat.contiguous(), settings,
                    us_bc.kind, ds_bc.kind, rc_kind, us_rc_kind, storage, tables, build_id=build_id)
    launch_count += 1
    long_launch_count += build_id in fn.LONG_REACH_BUILDS
    cluster_launch_count += build_id == fn.CLUSTER_BUILD
    bracket_launch_count += build_id == fn.BRACKET_BUILD
    lean_launch_count += build_id == fn.LEAN_BUILD
    return out
