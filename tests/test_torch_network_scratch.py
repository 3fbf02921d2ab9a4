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
  ``gerd_tributary.build``.

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
