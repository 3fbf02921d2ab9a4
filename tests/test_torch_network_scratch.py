"""PyTorch port vs JAX package: river networks beyond one block's shared memory.

A network whose slot arrays (branches x padded nodes) do not fit one block's
shared memory runs in the network kernel's scratch build on the card; on CPU
tensors the wrappers run the kernel's plain version, so here:

* the GERD tributary on the flagship at 250 m (241 / 41 / 243 nodes, 729
  slots: 233 432 B of shared memory against 231 936 B), 3 levels, through
  ``fused_simulate_network`` and ``simulate_network(engine="fused")`` against
  the JAX stacked engine: identical per-level counts, max|dh| <= 1e-9 m,
  max|dQ| <= 1e-6 m^3/s, max|dY| <= 1e-9 m;
* two members of it through ``batched_simulate_network(engine="fused")``
  against the port's stacked engine member by member, bit for bit;
* the scope: such networks pass ``check_supported``, a branch of more than
  8192 nodes does not;
* the scratch reckoning (``scratch_bytes``, ``check_output_memory``) at the
  shapes the card runs: the tributary on the 50 m flagship, the large basin,
  1024 members of the 250 m tributary on a grid of 132 blocks;
* ``gerd_tributary.network_solver`` at 250 m assembles the branches of
  ``gerd_tributary.build``;
* the cluster build's reckoning as pure functions: the cluster the wrapper
  expects for each network the card runs (``cluster_blocks``), no scratch
  counted inside a cluster's shared memory and the scratch build's beyond
  it, just below and above the limit; the messages of refused launches;
* the bracket build's shared memory a slot and a block (two blocks an SM).

One JAX network simulation is compiled, once, in a module-scoped fixture.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flowsim_tpu.models import gerd_tributary as jgt
from flowsim_tpu.ops import network as jnet
from flowsim_tpu_torch import convert, trees
from flowsim_tpu_torch.ops import network as net
from flowsim_tpu_torch.ops.cuda import fused_network as fnet
from flowsim_tpu_torch.ops.cuda.fused_newton import FusedUnsupported
from flowsim_tpu_torch.parallel import ensemble as ens

from tests._torch_port import arr, tree_to_numpy, without_autograd  # noqa: F401 (autouse fixture)

torch.set_num_threads(1)

H_TOL = 1e-9   # m
Q_TOL = 1e-6   # m^3/s
Y_TOL = 1e-9   # m
SPLIT, STEP = 240, 250.0     # the confluence node and the spatial step of the 250 m flagship


@pytest.fixture(scope="module")
def tributary_250m():
    """The JAX tributary at 250 m over 3 levels, its stacked-engine run, and
    the same branches and settings converted to the port."""
    jb, nj, js, _ = jgt.build(split_node=SPLIT, spatial_step=STEP, sim_duration=7200)
    jout = jnet.simulate_network(jb, nj, js, engine="stacked")
    pb = [convert.from_numpy("branch", tree_to_numpy(b), device="cpu") for b in jb]
    ps = convert.from_numpy("PreissmannSettings", {f.name: getattr(js, f.name) for f in dataclasses.fields(js)},
                            device="cpu")
    return pb, nj, ps, jout


def _assert_matches_jax(out, jout, what):
    assert out.iterations.tolist() == arr(jout.iterations).tolist(), what
    assert bool(out.converged.all()), what
    for h, jh in zip(out.depth, jout.depth):
        assert float(np.abs(arr(h) - arr(jh)).max()) <= H_TOL, what
    for q, jq in zip(out.flow, jout.flow):
        assert float(np.abs(arr(q) - arr(jq)).max()) <= Q_TOL, what
    assert float(np.abs(arr(out.junction_stage) - arr(jout.junction_stage)).max()) <= Y_TOL, what


def test_the_250m_tributary_is_beyond_shared_memory_and_in_scope(tributary_250m):
    pb, nj, ps, _ = tributary_250m
    assert [int(b.h0.shape[0]) for b in pb] == [SPLIT + 1, 41, 243]
    topo = fnet.check_supported(pb, nj, ps)
    slots = len(pb) * topo.n_max
    assert slots == 729 and topo.m_rhs == 2
    assert fnet.smem_bytes(slots, len(pb), nj, topo.m_rhs) == 233432 > fnet.SMEM_LIMIT


@pytest.mark.parametrize("entry", ["fused_simulate_network", "simulate_network"])
def test_the_250m_tributary_matches_jax(tributary_250m, entry):
    pb, nj, ps, jout = tributary_250m
    before = fnet.launch_count
    if entry == "fused_simulate_network":
        out = fnet.fused_simulate_network(pb, nj, ps)
    else:
        out = net.simulate_network(pb, nj, ps, engine="fused")
    assert out.iterations.tolist() == [0, 11, 12]
    _assert_matches_jax(out, jout, entry)
    assert fnet.launch_count == before          # CPU tensors: the plain version, no launch


def test_batched_fused_is_the_stacked_engine_member_by_member(tributary_250m):
    pb, nj, ps, _ = tributary_250m
    scales = torch.tensor([0.9, 1.1], dtype=torch.float64)
    us = pb[0].us
    us2 = dataclasses.replace(trees.tree_map(lambda v: v.expand(2, *v.shape), us),
                              target_series=us.target_series[None, :] * scales[:, None])
    batch = [dict(us=us2), dict(), dict()]
    out = ens.batched_simulate_network(pb, nj, ps, batch, engine="fused")
    stacked = dataclasses.replace(ps, linear_solver="pcr")
    for m in range(2):
        one = net.simulate_network(net.member_branches(pb, batch, m), nj, stacked, engine="stacked")
        assert torch.equal(out.iterations[m], one.iterations)
        for a, b in zip(out.depth + out.flow, one.depth + one.flow):
            assert torch.equal(a[m], b)
        assert torch.equal(out.junction_stage[m], one.junction_stage)
        assert torch.equal(out.error[m], one.error)
    assert not torch.equal(out.depth[0][0], out.depth[0][1])


def test_a_branch_beyond_8192_nodes_is_refused(tributary_250m):
    pb, nj, ps, _ = tributary_250m
    n = 8193
    long = dataclasses.replace(pb[2], geo=trees.tree_map(lambda v: v[-1:].expand(n).clone(), pb[2].geo),
                               h0=pb[2].h0[-1:].expand(n).clone(), Q0=pb[2].Q0[-1:].expand(n).clone())
    with pytest.raises(FusedUnsupported, match="branch 2: N=8193 exceeds"):
        fnet.check_supported([pb[0], pb[1], long], nj, ps)


# (members, branches, padded nodes, junctions, levels, RHS pairs, blocks of the
# scratch build's grid): one 50 m tributary (1201 / 201 / 1209 nodes), one
# large basin of scripts/bench_basin_large.py (levels=7: 127 x 45, 63
# junctions, 6 h at 900 s), 1024 members of the 250 m tributary on an H100's
# 132 SMs at one block each
SCRATCH_SHAPES = {
    "tributary_50m": (1, 3, 1209, 1, 385, 2, 1),
    "large_basin": (1, 127, 45, 63, 25, 3, 1),
    "tributary_250m_1024_members": (1024, 3, 243, 1, 385, 2, 132),
}


@pytest.mark.parametrize("case", sorted(SCRATCH_SHAPES))
def test_scratch_is_counted_with_the_outputs(case):
    M, B, n_max, J, nt, m_rhs, blocks = SCRATCH_SHAPES[case]
    slots = B * n_max
    scratch = fnet.scratch_bytes(blocks, slots, m_rhs)
    assert scratch == blocks * slots * (2 * (12 + 2 * m_rhs) + 8) * 8
    assert fnet.smem_bytes(slots, B, J, m_rhs) > fnet.SMEM_LIMIT
    need = fnet.output_bytes(M, B, n_max, J, nt) + scratch
    fnet.check_output_memory(M, B, n_max, J, nt, need, blocks, m_rhs)
    fnet.check_output_memory(M, B, n_max, J, nt, need - 1)           # the outputs alone fit
    with pytest.raises(MemoryError, match="scratch"):
        fnet.check_output_memory(M, B, n_max, J, nt, need - 1, blocks, m_rhs)


def test_network_solver_at_250m_assembles_the_branches_of_build():
    """``gerd_tributary.network_solver`` at a spatial step whose rounded node
    chainages floor a stem one node short: each branch still has the node
    count, dx and geometry of ``build``."""
    from flowsim_tpu_torch.models import gerd_tributary

    ns, branches = gerd_tributary.network_solver(split_node=SPLIT, spatial_step=STEP, sim_duration=3600,
                                                 device="cpu")
    for a, b in zip(ns.branches, branches):
        assert a.dx == b.dx and a.geo.n_nodes == b.geo.n_nodes == int(b.h0.shape[0])
        for f in ("z_bed", "b_main", "n_main", "curvature"):
            assert float((getattr(a.geo, f) - getattr(b.geo, f)).abs().max()) <= 1e-10, f


# (slots, branches, junctions, RHS pairs): the cluster of each network the
# card runs beyond one block's shared memory — the fewest blocks at one slot
# a thread, 16 of the loop form beyond 4096 slots, none beyond a cluster's
# shared memory
CLUSTERS = {
    "tributary_50m": ((3627, 3, 1, 2), 15),
    "large_basin": ((5715, 127, 63, 3), 16),
    "basin_levels6": ((819, 63, 31, 3), 4),
    "table_network": ((3075, 3, 1, 2), 13),
    "tributary_250m": ((729, 3, 1, 2), 3),
    "beyond_a_cluster": ((12291, 3, 1, 2), 0),
}


@pytest.mark.parametrize("case", sorted(CLUSTERS))
def test_cluster_blocks_of_the_networks_the_card_runs(case):
    shape, blocks = CLUSTERS[case]
    assert fnet.smem_bytes(*shape) > fnet.SMEM_LIMIT
    assert fnet.cluster_blocks(*shape) == blocks
    if blocks:
        assert fnet.smem_bytes(-(-shape[0] // blocks), *shape[1:]) <= fnet.CLUSTER_SMEM_LIMIT


# (branches, junctions, RHS pairs, levels): a tributary and the large basin's
# junction layout, each at the branch length where its slot arrays stop
# fitting a cluster's shared memory
CLUSTER_LIMITS = {"tributary": (3, 1, 2, 385), "large_basin": (127, 63, 3, 25)}


@pytest.mark.parametrize("case", sorted(CLUSTER_LIMITS))
def test_cluster_build_counts_no_scratch_within_a_clusters_shared_memory(case):
    B, J, m_rhs, nt = CLUSTER_LIMITS[case]
    fits = lambda n_max: fnet.cluster_blocks(B * n_max, B, J, m_rhs) > 0
    n_max = 2
    while fits(n_max + 1):
        n_max += 1
    assert fnet.cluster_blocks(B * n_max, B, J, m_rhs) == fnet.MAX_CLUSTER
    # the cluster build allocates no scratch; beyond, the scratch build's grid
    # of 132 blocks (an H100's SMs at one block each) has one a block
    for n, blocks in ((n_max, 0), (n_max + 1, 132)):
        assert fits(n) == (blocks == 0)
        out = fnet.output_bytes(1, B, n, J, nt)
        fnet.check_output_memory(1, B, n, J, nt, out + fnet.scratch_bytes(blocks, B * n, m_rhs), blocks, m_rhs)
        if blocks:
            with pytest.raises(MemoryError, match="scratch"):
                fnet.check_output_memory(1, B, n, J, nt, out, blocks, m_rhs)
        else:
            fnet.check_output_memory(1, B, n, J, nt, out, blocks, m_rhs)


# (C return code, build, cluster): what each refusal names
REFUSALS = {
    "cluster_of_17": (912, fnet.CLUSTER_BUILD, 17, ("cluster build (17 blocks a cluster)", "2-16 blocks")),
    "no_cluster_at_once": (701, fnet.CLUSTER_BUILD, 16, ("16 blocks a cluster)", "cannot hold one cluster")),
    "two_an_sm_on_242_slots": (1, fnet.CLUSTER_BUILD, 15 | fnet.CLUSTER_PAIR,
                               ("15 blocks a cluster, two an SM)", "does not take this network")),
    "scratch_build": (1, fnet.SCRATCH_BUILD, 0, ("scratch build:", "does not take this network")),
    "bracket_build_on_trapezoids": (1, fnet.BRACKET_BUILD, 0, ("bracket build:", "does not take this network")),
    "lean_build_on_trapezoids": (1, fnet.LEAN_BUILD, 0, ("lean build:", "does not take this network")),
    "side_warps_beyond_the_block": (1, fnet.LEAN_SIDE_BUILD, 0, ("lean build with side warps:",
                                                                 "does not take this network")),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_a_refused_launch_names_its_build_and_code(case):
    rc, build_id, cluster, words = REFUSALS[case]
    msg = fnet.launch_error(rc, build_id, cluster)
    assert f"CUDA error {rc} " in msg and "no other build or plain version runs in its place" in msg
    for w in words:
        assert w in msg


# H100: 228 KB of shared memory an SM, 1 KB of it reserved a block, and the
# kernel's static reduction area (512 B)
SM_SMEM, BLOCK_RESERVED, STATIC_SMEM = 233472, 1024, 512
# (slots, branches, junctions, RHS pairs): the surveyed mixed network of the
# table ensemble (two table branches of 61 nodes and the tributary padded to
# 61, one junction), the all-table network (its two table branches; the lean
# build's other single network), and a 15-branch basin's 195 slots, three
# RHS pairs.  The lean build has the bracket build's shared memory.
BRACKET_NETWORKS = {"surveyed_mixed": (183, 3, 1, 2), "surveyed_all_table": (122, 2, 1, 2),
                    "basin_levels4": (195, 15, 7, 3)}


@pytest.mark.parametrize("case", sorted(BRACKET_NETWORKS))
def test_bracket_build_shared_memory_a_slot(case):
    slots, B, J, rhs = BRACKET_NETWORKS[case]
    # a slot: two PCR buffers of 12 + 2 RHS doubles (the inverse of D carried
    # in D's place, no extra component), h and Q (the level-start state lies
    # in the assembly buffer), and the bracket cache, 14 doubles and an int:
    # 388 B at two RHS pairs, 420 B at three
    per_slot = 8 * (2 * (12 + 2 * rhs) + 2) + fnet.BRACKET_BYTES_PER_SLOT
    assert per_slot == {2: 388, 3: 420}[rhs]
    smem = fnet.bracket_smem_bytes(slots, B, J, rhs)
    assert smem == slots * per_slot + 8 * (J * (J + 6) + 4 * B)
    assert smem - fnet.smem_bytes(slots, B, J, rhs) == slots * (fnet.BRACKET_BYTES_PER_SLOT - 6 * 8)
    # shared memory holds three such blocks an SM at the surveyed network's
    # 183 slots and two RHS pairs (the residency build's registers hold two;
    # the lean build's, at 255 a thread, one), four at the all-table
    # network's 122, two at the basin's 195 slots and three
    block = smem + STATIC_SMEM + BLOCK_RESERVED
    fit = {"surveyed_mixed": 3, "surveyed_all_table": 4, "basin_levels4": 2}[case]
    assert fit * block <= SM_SMEM < (fit + 1) * block
