"""Ensemble (scenario-batch) simulation.

Counterpart of ``flowsim_tpu/parallel/ensemble.py``: a batch of scenarios
(per-member roughness fields, inflow series, boundary parameters, initial
states, lateral inflow) runs as one batched simulation.  A batched tree is one
of the port's parameter dataclasses with a leading member axis on every tensor
leaf (:mod:`flowsim_tpu_torch.trees`).

Two engines:

* ``engine="plain"`` — a loop over members through ``ops.preissmann.simulate``
  (the counterpart of the JAX package's vmapped ``"xla"`` engine; the
  reference the batched kernel is held against);
* ``engine="fused"`` — all members in one CUDA kernel launch, one thread block
  per member (``ops/cuda/fused_batched.py``); ``chunk_size`` splits the batch
  into sequential launches when the outputs of one would not fit the card.

River networks: :func:`batched_simulate_network` runs per-member branch
overrides with ``engine="plain"`` (a member loop through the stacked network
engine) or ``engine="fused"`` (all members in one launch of the network
kernel, ``ops/cuda/fused_network.py``).

Irregular sections: :func:`table_roughness_ensemble` rescales the lookup
tables of a ``TableGeometry`` per member; both engines take the result.

Not ported yet: ``shard`` / ``mesh`` (a batch spread over several cards,
ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from flowsim_tpu_torch import trees
from flowsim_tpu_torch.ops import preissmann as prs
from flowsim_tpu_torch.ops import network as net
from flowsim_tpu_torch.ops.cuda import fused_batched, fused_network

ENGINES = ("plain", "fused")

_SHARD_MESSAGE = (
    "spreading an ensemble over several cards (shard=True / mesh=) is not ported yet "
    "(ROADMAP.md Queue 1 item 13: scale-out); run one batch per card")


def batch_boundaries(bcs):
    """Stack per-member BoundaryParams into one batched params tree.

    All members must share the static configuration (kind, rating kind);
    tensor leaves gain a leading member axis.  Returns ``(stacked, axes)``
    where ``axes`` (0) is what to pass as ``us_axes`` / ``ds_axes`` of
    :func:`batched_simulate` to mark the boundary as per-member.
    """
    bcs = list(bcs)
    kinds = {b.kind for b in bcs}
    if len(kinds) != 1:
        raise ValueError(f"all members must share the boundary kind, got {kinds}")
    # a lumped storage's outflow rating: one kind and one length of
    # coefficients or rating table across the members, as a JAX batched tree
    # has one static kind (the members' own values may differ)
    ratings = {None if b.storage is None or b.storage.rating is None else
               (b.storage.rating.kind, b.storage.rating.coeffs.shape[-1], b.storage.rating.table_stage.shape[-1])
               for b in bcs}
    if len(ratings) > 1:
        raise ValueError(
            "all members must share the storage rating's kind and its number of coefficients or table "
            f"breakpoints; got (kind, coefficients, breakpoints) {sorted(map(str, ratings))}")
    return trees.stack(bcs), 0


def stack_geometries(geos):
    """Stack per-member geometry trees into one batched tree."""
    return trees.stack(geos)


def roughness_ensemble(geo, n_values):
    """Batched geometry with per-member main-channel roughness."""
    n_values = torch.as_tensor(n_values, dtype=geo.n_main.dtype, device=geo.device).reshape(-1)
    B = n_values.shape[0]
    batched = trees.tree_map(lambda v: v.expand(B, *v.shape), geo)
    return dataclasses.replace(
        batched, n_main=n_values[:, None].expand(B, geo.n_nodes).contiguous())


def table_roughness_ensemble(geo, n_values, n_base=None):
    """Batched :class:`TableGeometry` with per-member uniform roughness.

    Irregular-section tables bake Manning n into the conveyance columns at
    build time (geometry_tables.build_table_geometry), so a per-member
    roughness is applied as an exact rescale: with ``s = n / n_base``,
    Manning K = A R^(2/3) / n gives ``K -> K/s``, ``dK_dA -> dK_dA/s`` and
    the Horton-Einstein equivalent n (linear in the subsection n's when all
    scale together, ref cross_section.py:443-501) gives ``n_eq -> s*n_eq``.
    A/P/R/T columns are pure geometry and are shared across members: they
    are expanded views of the input's tensors, and only K, dK_dA and n_eq
    take memory per member.

    ``n_base`` defaults to the build-time main-channel n recorded on the
    geometry (``geo.n_ref``); passing a different value is rejected — the
    rescale is silently wrong physics when anchored off the baked n.
    """
    n_ref = geo.n_ref
    if n_base is None:
        if n_ref is None:
            raise ValueError(
                "geo does not record its build-time Manning n (stations "
                "disagreed, or the geometry predates n_ref); pass n_base "
                "explicitly — it MUST be the n baked into the tables")
        n_base = n_ref
    elif n_ref is not None and abs(n_base - n_ref) > 1e-12 * abs(n_ref):
        raise ValueError(
            f"n_base={n_base} does not match the Manning n baked into the "
            f"tables at build time (geo.n_ref={n_ref}); the rescale would "
            f"be uniformly mis-scaled")
    n_values = torch.as_tensor(n_values, dtype=torch.float64, device=geo.device).reshape(-1)
    s = (n_values / n_base).to(geo.conveyance.dtype)[:, None, None]
    batched = trees.tree_map(lambda v: v.expand(s.shape[0], *v.shape), geo)
    # the batch no longer has a single baked n (each member's is its own
    # n value): clear the anchor so a second rescale cannot anchor off the
    # original build-time value
    return dataclasses.replace(batched, conveyance=geo.conveyance / s, dK_dA=geo.dK_dA / s,
                               n_eq=geo.n_eq * s, n_ref=None)


def batched_simulate(geo_batch, us_bc, ds_bc, h0, Q0, settings: prs.PreissmannSettings,
                     mesh=None, shard: bool = False, us_axes=None, ds_axes=None,
                     chunk_size: Optional[int] = None, engine: str = "plain",
                     lateral_inflow=None) -> prs.SimOutput:
    """Simulate a batch of scenarios differing in geometry (e.g. roughness)
    and, optionally, boundary forcing, initial state and lateral inflow.

    ``geo_batch`` has a leading member axis on every leaf; ``h0`` / ``Q0`` may
    be shared ``[N]`` or per member ``[B, N]``.  Per-member boundaries: pass
    the stacked params and axes of :func:`batch_boundaries` as ``us_bc`` /
    ``us_axes`` (likewise downstream); with ``us_axes=None`` the boundary is
    shared.  ``lateral_inflow``: shared ``[N]``, per-member constants
    ``[B, N]`` (a 2-D argument is member-major) or per-member series
    ``[B, nt, N]``.

    ``chunk_size``: run the batch as sequential chunks of that many members
    (the batch size must be a multiple of it), concatenated on the member
    axis.  With ``engine="fused"`` each chunk is one kernel launch; the
    default is one launch for the whole batch.

    Returns a SimOutput with a leading member axis on every field.
    ``engine="fused"`` raises ``FusedUnsupported`` outside the kernel's scope:
    nothing falls back to the plain engine.
    """
    if shard or mesh is not None:
        raise NotImplementedError(_SHARD_MESSAGE)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    B = geo_batch.z_bed.shape[0]
    if chunk_size is not None and B > chunk_size and B % chunk_size:
        raise ValueError(f"batch {B} not divisible by chunk_size {chunk_size}")
    us_batched, ds_batched = us_axes is not None, ds_axes is not None
    nt, n = settings.n_time_levels, geo_batch.n_nodes
    # the B == nt ambiguity of a 2-D lateral inflow is judged on the whole
    # batch; a chunk of exactly nt members is then given the [B, nt, N] form
    q = fused_batched.batched_lateral_inflow(lateral_inflow, B, n, nt, h0)
    if q is not None and q.dim() == 2 and chunk_size == nt:
        q = q[:, None, :].expand(B, nt, n)

    if engine == "fused":
        run = fused_batched.fused_simulate_batched
    else:
        def run(geo_b, us, ds, h, Q, sset, us_batched, ds_batched, lateral_inflow):
            one = lambda *args: prs.simulate(*args[:5], sset, lateral_inflow=args[5])
            return fused_batched.member_loop(one, geo_b, us, ds, h, Q, us_batched, ds_batched,
                                             lateral_inflow)

    step = B if chunk_size is None else min(chunk_size, B)
    outs = []
    for s in range(0, B, step):
        e = s + step
        outs.append(run(
            trees.slice_members(geo_batch, s, e),
            trees.slice_members(us_bc, s, e) if us_batched else us_bc,
            trees.slice_members(ds_bc, s, e) if ds_batched else ds_bc,
            h0[s:e] if h0.dim() > 1 else h0, Q0[s:e] if Q0.dim() > 1 else Q0, settings,
            us_batched=us_batched, ds_batched=ds_batched,
            lateral_inflow=None if q is None else q[s:e]))
    if len(outs) == 1:
        return outs[0]
    return prs.SimOutput(*(None if f[0] is None else torch.cat(f, dim=0) for f in zip(*outs)))


def batched_simulate_network(branches, n_junctions, settings: prs.PreissmannSettings, batch, Y0=None,
                             junction_area=None, junction_rating=None, mesh=None, shard: bool = False,
                             engine: str = "plain", chunk_size: Optional[int] = None) -> net.NetworkOutput:
    """Monte-Carlo over a river network: per-member branch overrides.

    ``batch``: one dict per branch, keyed by ``geo``, ``us``, ``ds``, ``h0``,
    ``Q0``, ``qlat``, each value with a leading member axis (a batched tree of
    :func:`roughness_ensemble` / :func:`batch_boundaries`, or a stacked
    tensor); absent keys are shared.  Junction ends and ``dx`` cannot be
    overridden; the junction configuration (``Y0``, ``junction_area``,
    ``junction_rating``) is shared (``Y0=None`` takes each member's own
    default stages).

    ``engine="plain"``: every member through ``simulate_network(engine=
    "stacked")`` with ``settings.linear_solver``; ``engine="fused"``: one
    kernel launch per chunk, raising ``FusedUnsupported`` outside the
    kernel's scope (nothing falls back) and ``MemoryError`` when the outputs
    (and the scratch of a network beyond one block's shared memory) would
    not fit the card.  ``chunk_size`` splits the members into
    sequential runs (it must divide the member count).  Returns a
    NetworkOutput with a leading member axis on every field.
    """
    if shard or mesh is not None:
        raise NotImplementedError(_SHARD_MESSAGE)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    M = net.check_batch(branches, batch, settings)
    if chunk_size is not None and M > chunk_size and M % chunk_size:
        raise ValueError(f"batch {M} not divisible by chunk_size {chunk_size}")
    kw = dict(Y0=Y0, junction_area=junction_area, junction_rating=junction_rating)
    step = M if chunk_size is None else min(chunk_size, M)
    outs = []
    for s in range(0, M, step):
        part = [{k: (trees.slice_members(v, s, s + step) if k in ("geo", "us", "ds") else v[s:s + step])
                 for k, v in d.items()} for d in batch]
        if engine == "fused":
            outs.append(fused_network.fused_simulate_network_batched(branches, n_junctions, settings, part, **kw))
        else:
            outs.append(net.simulate_members(branches, n_junctions, settings, part, **kw))
    return outs[0] if len(outs) == 1 else net.join_outputs(outs, torch.cat)
