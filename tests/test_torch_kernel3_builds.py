"""The reckoning of the long-reach and bracket builds of kernels 1 and 3, as
pure functions.

On the card a batch of reaches of 965-8192 nodes runs in the cluster build
(each member over a thread-block cluster, its state in the blocks' shared
memory) and one simulation there in the reach build (one reach over a
cluster of 16 blocks, node i on rank i % 16, its state in their shared
memory); the long build (its state in a scratch of device memory) runs only
forced.  A table batch past one wave of the register build runs in the
bracket build.  None of that runs here, so this file holds the wrapper's
arithmetic to what the C entry does:

* the cluster of each long shape (``cluster_blocks``: 2 blocks at N = 965, 3
  at 2048, 6 at 4096, 11 at 8192) and the grids (``launch_grid``): a block a
  simulation, the cluster build the clusters the card holds at once;
* the reach build's cluster and nodes a rank at each long shape
  (``REACH_RANKS``, ``reach_rank_nodes``), its threads and a rank's bytes;
* the state each holds: the long build a scratch a simulation, the cluster
  and the reach build shared memory, no scratch (``scratch_bytes``,
  ``uses_long_build``, ``uses_reach_build``, ``check_output_memory``): a
  batch that one scratch a member would have refused is taken, one whose
  outputs do not fit is not, and one simulation counts no scratch;
* the exception and message of a launch the C entry refuses (``refusal``,
  ``launch_error``); which forced builds it refuses is the C entry's own
  rule, held on the card by ``chip_smoke.py``.

No JAX compile and no simulation: each test takes milliseconds.
"""

import pytest
import torch

from flowsim_tpu_torch.ops.cuda import fused_newton as fn
from flowsim_tpu_torch.ops.cuda.fused_newton import FusedUnsupported

torch.set_num_threads(1)

H100_SMS = 132
# a block's shared memory on an H100, less the static reduction area
BLOCK_SMEM = 232448 - 1024

# N: (blocks of the cluster, nodes a rank)
CLUSTERS = {965: (2, 512), 2048: (3, 704), 2409: (4, 608), 4096: (6, 704), 8192: (11, 768)}


@pytest.mark.parametrize("n", sorted(CLUSTERS))
def test_cluster_of_each_long_shape(n):
    blocks, rn = CLUSTERS[n]
    assert fn.cluster_blocks(n) == blocks
    assert fn.rank_nodes(n, blocks) == rn and rn % 32 == 0 and blocks * rn >= n
    # a rank's share of the state fits a block's 227 KB of shared memory,
    # one block fewer would not hold it at one node a thread
    assert rn <= fn.CLUSTER_BLOCK and rn * fn.CLUSTER_BYTES_PER_NODE <= BLOCK_SMEM
    assert fn.rank_nodes(n, blocks - 1) > fn.CLUSTER_BLOCK or blocks == 2
    assert 2 <= blocks <= fn.MAX_CLUSTER


# N: the cluster build's grid of 1024 members on an H100 (132 SMs),
# floor(132 / blocks) clusters unless the card says fewer
CLUSTER_GRIDS = {965: 132, 2048: 132, 4096: 132, 8192: 132}


@pytest.mark.parametrize("n", sorted(CLUSTER_GRIDS))
def test_grids_of_1024_members(n):
    blocks = fn.cluster_blocks(n)
    assert fn.launch_grid(fn.CLUSTER_BUILD, 1024, n, H100_SMS) == (H100_SMS // blocks) * blocks \
        <= CLUSTER_GRIDS[n]
    # the card's own count of clusters at once (its SMs come in groups a
    # cluster may not span), and a batch smaller than a wave
    assert fn.launch_grid(fn.CLUSTER_BUILD, 1024, n, H100_SMS, clusters_at_once=7) == 7 * blocks
    assert fn.launch_grid(fn.CLUSTER_BUILD, 4, n, H100_SMS) == 4 * blocks
    # every other build a block a simulation: the long build forced on a
    # batch, the shared-memory builds
    assert fn.launch_grid(fn.LONG_BUILD, 1024, n, H100_SMS) == 1024
    assert fn.launch_grid(fn.BRACKET_BUILD, 10240, 121, H100_SMS) == 10240


# N: the reach build's nodes a rank (N / 16 to a whole warp; two threads a
# node, so 128-1024 threads a block)
REACH = {965: 64, 2048: 128, 2409: 160, 4096: 256, 8192: 512}


@pytest.mark.parametrize("n", sorted(REACH))
def test_reach_build_of_each_long_shape(n):
    ranks, rn = fn.REACH_RANKS, fn.reach_rank_nodes(n)
    assert ranks == fn.REACH_RANKS == 16 and ranks & (ranks - 1) == 0 and ranks <= fn.MAX_CLUSTER
    assert rn == REACH[n] and rn % 32 == 0 and ranks * rn >= n > ranks * (rn - 32)
    # two threads a node in one block of at most 1024; a rank's share of the
    # state (the cluster build's 296 B a node) within a block's shared memory
    assert 2 * rn <= 1024 and rn <= fn.REACH_MAX_RANK_NODES
    assert rn * fn.REACH_BYTES_PER_NODE <= BLOCK_SMEM and fn.REACH_BYTES_PER_NODE == fn.CLUSTER_BYTES_PER_NODE
    # one simulation takes it over one cluster; a batch, or a reach that
    # shared memory holds in one block, does not; forced, a cluster a member
    assert fn.uses_reach_build(n) and not fn.uses_reach_build(n, n_sims=2)
    assert not fn.uses_reach_build(fn.MAX_N) and fn.uses_reach_build(fn.MAX_N, fn.REACH_BUILD)
    assert fn.launch_grid(fn.REACH_BUILD, 1, n, H100_SMS) == ranks
    assert fn.launch_grid(fn.REACH_BUILD, 4, n, H100_SMS) == 4 * ranks


@pytest.mark.parametrize("n", [2048, 8192])
def test_state_of_each_long_build(n):
    # one simulation: the reach build, no scratch; the long build (one
    # scratch) only where a test hook forces it
    assert not fn.uses_long_build(n) and fn.uses_reach_build(n)
    assert fn.uses_long_build(n, fn.LONG_BUILD) and fn.scratch_bytes(1, n) == n * 36 * 8
    # a batch: the cluster build and no scratch, its state in the shared
    # memory of at most one cluster an SM's worth of blocks
    assert not fn.uses_long_build(n, n_sims=1024)
    grid = fn.launch_grid(fn.CLUSTER_BUILD, 1024, n, H100_SMS)
    assert grid <= H100_SMS
    assert grid * fn.rank_nodes(n, fn.cluster_blocks(n)) * fn.CLUSTER_BYTES_PER_NODE <= H100_SMS * BLOCK_SMEM
    # forced, the long build holds a scratch a member
    assert fn.uses_long_build(n, fn.LONG_BUILD, n_sims=1024)
    assert not fn.uses_long_build(n, fn.CLUSTER_BUILD, n_sims=1)


# (members, N, levels, store): 1024 members of the N = 2048 reach (the long
# ensemble of chip_smoke.py), and 10 240 members of the N = 8192 reach, whose
# scratch of one a member (24 GB) the card's 80 GB would not hold beside
# other work
BATCHES = {"n2048_1024_members": (1024, 2048, 9, "boundaries"), "n8192_10240_members": (10240, 8192, 9, "boundaries")}


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_check_output_memory_takes_a_batch_one_scratch_a_member_would_refuse(case):
    members, n, nt, store = BATCHES[case]
    out = fn.output_bytes(members, n, nt, store)
    # the wrapper counts the scratch only where the long build runs: a
    # batch takes the cluster build, whose outputs alone must fit
    fn.check_output_memory(members, n, nt, store, out, fn.uses_long_build(n, n_sims=members))
    with pytest.raises(MemoryError, match="scratch"):   # one scratch a member
        fn.check_output_memory(members, n, nt, store, out, long_build=True)
    with pytest.raises(MemoryError, match=r"outputs .* chunk_size"):
        fn.check_output_memory(members, n, nt, store, out - 1, fn.uses_long_build(n, n_sims=members))
    # one simulation (the reach build) counts its outputs alone; forced into
    # the long build it counts its scratch
    one = fn.output_bytes(1, n, nt, store)
    fn.check_output_memory(1, n, nt, store, one, fn.uses_long_build(n))
    with pytest.raises(MemoryError, match=r"outputs .* chunk_size"):
        fn.check_output_memory(1, n, nt, store, one - 1, fn.uses_long_build(n))
    with pytest.raises(MemoryError, match="scratch"):
        fn.check_output_memory(1, n, nt, store, one, fn.uses_long_build(n, fn.LONG_BUILD))


# the codes the C entry refuses a launch with, and what each message says
CODES = {1: "cudaErrorInvalidValue", 701: "cannot hold one cluster", 912: "a cluster has 2-16 blocks"}


@pytest.mark.parametrize("build_id", sorted(fn.BUILD_NAMES))
@pytest.mark.parametrize("rc", sorted(CODES))
def test_a_refused_launch_raises_with_the_build_and_the_error(build_id, rc):
    e = fn.refusal(rc, build_id, cluster=11)
    # a build that does not take the shape is outside the kernel's scope;
    # any other refusal is a failure of the card
    assert type(e) is (FusedUnsupported if rc == 1 else RuntimeError)
    msg = str(e)
    assert f"the {fn.BUILD_NAMES[build_id]}" in msg and f"CUDA error {rc}" in msg and CODES[rc] in msg
    assert ("(11 blocks a cluster)" in msg) == (build_id in (fn.CLUSTER_BUILD, fn.REACH_BUILD))
    assert "no other build or plain version" in msg


def test_a_refused_launch_of_no_such_build_names_its_id():
    msg = str(fn.refusal(1, 7))
    assert "build 7" in msg and "cudaErrorInvalidValue" in msg


def test_a_refused_reach_build_names_its_cluster():
    # a card that cannot hold 16 blocks of the reach build at once refuses
    # the launch: the message names the build and its cluster, and nothing
    # runs in its place
    e = fn.refusal(701, fn.REACH_BUILD, cluster=fn.REACH_RANKS)
    assert type(e) is RuntimeError
    assert "the reach build (16 blocks a cluster)" in str(e) and "cannot hold one cluster" in str(e)
