"""PyTorch port vs JAX package: the long-reach (tiled SPIKE) solve on the CPU.

* the block-Thomas functions added for it (``dense_block_thomas``,
  ``block_thomas_factor`` / ``block_thomas_apply``, ``interleave_to_blocks``)
  against ``flowsim_tpu.ops.tridiag`` in float64, rtol 1e-11 (the same
  algorithm on both sides; a dense 4x4 solve may pivot differently);
* the plain stage B, ``reduced_cr_plain`` (block cyclic reduction over the
  normalised reduced rows, the algorithm of the stage-B kernel), against the
  JAX ``dense_block_thomas`` on reduced systems drawn from a seed and on the
  one the 2048-node long-reach Newton system gives, rtol 1e-11 of the
  solution's scale;
* ``tiled_spike_plain`` — what ``tiled_spike_solve`` runs for CPU tensors —
  against the JAX ``block_thomas`` in float64 at rtol 1e-11 of the solution's
  scale, and against the TPU kernel in Pallas interpret mode, which is
  float32, at its own bar of 5e-6 x scale;
* a 2048-node long reach, 2 levels, ``linear_solver="cuda_tiled"`` against the
  JAX scan with ``"pcr"``: the same iteration count at every level,
  max|dh| <= 1e-9 m, max|dQ| <= 1e-6 m^3/s;
* the wrappers' 16-byte alignment of a view, and the whole solve's bound as
  ``chip_smoke.py`` reckons it (the function's own bytes).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from flowsim_tpu.ops import preissmann as jprs
from flowsim_tpu.ops import tridiag as jtri
from flowsim_tpu.ops.pallas.tiled_pcr import tiled_spike_pallas
from flowsim_tpu_torch.ops import preissmann as prs
from flowsim_tpu_torch.ops import tridiag as tri
from flowsim_tpu_torch.ops.cuda import fused_newton, tiled_pcr

from tests._torch_port import to_jax, without_autograd  # noqa: F401 (without_autograd is an autouse fixture)

torch.set_num_threads(1)

RTOL = 1e-11

T = lambda xs: [torch.tensor(x) for x in xs]
J = lambda xs: [jnp.asarray(x) for x in xs]


def close(port, ref, rtol=RTOL):
    ref = np.asarray(ref, dtype=np.float64)
    np.testing.assert_allclose(port.numpy(), ref, rtol=rtol, atol=rtol * float(np.abs(ref).max()))


def system(n, seed=0, coupling=0.3):
    """The ``_random_system`` of ``tests/test_tiled_pcr.py``: float32 values
    (so that the float32 TPU kernel sees the same system), held in float64."""
    rng = np.random.default_rng(100 * n + seed)
    L = (rng.normal(size=(n, 2, 2)) * coupling).astype(np.float32)
    D = (rng.normal(size=(n, 2, 2)) + 4 * np.eye(2)).astype(np.float32)
    U = (rng.normal(size=(n, 2, 2)) * coupling).astype(np.float32)
    L[0] = 0.0
    U[-1] = 0.0
    b = rng.normal(size=(n, 2)).astype(np.float32)
    return [a.astype(np.float64) for a in (L, D, U, b)]


@pytest.mark.parametrize("S,m", [(1, 4), (2, 4), (9, 4), (6, 3)])
def test_dense_block_thomas(S, m):
    rng = np.random.default_rng(S * 10 + m)
    L, U = rng.uniform(-1, 1, (2, S, m, m))
    D = rng.uniform(-1, 1, (S, m, m)) + 5.0 * np.eye(m)
    b = rng.uniform(-1, 1, (S, m))
    x = tri.dense_block_thomas(*T((L, D, U, b)))
    close(x, jtri.dense_block_thomas(*J((L, D, U, b))))
    # and it solves the system (L[0] and U[-1] lie outside the matrix)
    A = np.zeros((S * m, S * m))
    for i in range(S):
        A[i * m:(i + 1) * m, i * m:(i + 1) * m] = D[i]
        if i > 0:
            A[i * m:(i + 1) * m, (i - 1) * m:i * m] = L[i]
        if i < S - 1:
            A[i * m:(i + 1) * m, (i + 1) * m:(i + 2) * m] = U[i]
    np.testing.assert_allclose(A @ x.numpy().reshape(-1), b.reshape(-1), atol=1e-12)


def dense_reduced(Lc, Uc, r):
    """The reduced rows of ``tiled_pcr.reduced_rows`` as the dense 4x4 blocks
    L = [0 | Lc], D = I, U = [Uc | 0] that the JAX stage B solves."""
    S = r.shape[0]
    Z = np.zeros((S, 4, 2))
    return np.concatenate([Z, Lc], -1), np.broadcast_to(np.eye(4), (S, 4, 4)), np.concatenate([Uc, Z], -1), r


def close_scaled(port, ref, rtol=RTOL):
    ref = np.asarray(ref, dtype=np.float64)
    assert float(np.abs(port.numpy() - ref).max()) <= rtol * float(np.abs(ref).max())


@pytest.mark.parametrize("S", [1, 2, 37])
def test_reduced_cr_matches_jax_dense_block_thomas(S):
    """One tile's row, two tiles and a few dozen: spikes that decay into the
    tile (V_last, W_first small), as a diagonally dominant reach gives."""
    rng = np.random.default_rng(S)
    Lc, Uc = rng.uniform(-0.5, 0.5, (2, S, 4, 2))
    Lc[:, 2:] *= 1e-3
    Uc[:, :2] *= 1e-3
    r = rng.uniform(-1, 1, (S, 4))
    y = tiled_pcr.reduced_cr_plain(*T((Lc, Uc, r)))
    assert y.shape == (S, 4)
    close_scaled(y, jtri.dense_block_thomas(*J(dense_reduced(Lc, Uc, r))))


@pytest.mark.parametrize("layout", ["vector", "multi_rhs", "batched_vectors", "batch_equal_to_n"])
def test_block_thomas_factor_and_apply(layout):
    n = 5
    L, D, U, _ = system(n, seed=3)
    rng = np.random.default_rng(7)
    shape = dict(vector=(n, 2), multi_rhs=(n, 2, 3), batched_vectors=(4, n, 2), batch_equal_to_n=(n, n, 2))[layout]
    b = rng.uniform(-1, 1, shape)
    factor = tri.block_thomas_factor(*T((L, D, U)))
    jfactor = jtri.block_thomas_factor(*J((L, D, U)))
    for got, want in zip(factor, jfactor):
        close(got, want)
    x = tri.block_thomas_apply(factor, torch.tensor(b))
    close(x, jtri.block_thomas_apply(jfactor, jnp.asarray(b)))
    if layout == "vector":
        close(x, jtri.block_thomas(*J((L, D, U, b))))
        with pytest.raises(ValueError, match="matches neither"):
            tri.block_thomas_apply(factor, torch.zeros((3, n + 1, 2), dtype=torch.float64))


@pytest.mark.parametrize("n", [1, 2, 7])
def test_interleave_to_blocks_inverts_blocks_to_dense(n):
    L, D, U, _ = system(n, seed=5)
    A = tri.blocks_to_dense(*T((L, D, U)))
    back = tri.interleave_to_blocks(A)
    for got, want, jwant in zip(back, (L, D, U), jtri.interleave_to_blocks(jnp.asarray(A.numpy()))):
        assert np.array_equal(got.numpy(), want) and np.array_equal(got.numpy(), np.asarray(jwant))
    with pytest.raises(ValueError, match="square"):
        tri.interleave_to_blocks(torch.zeros((3, 3), dtype=torch.float64))


@pytest.mark.parametrize("N,tile", [(256, 128), (1000, 128), (4096, 512)])
def test_tiled_plain_matches_jax_thomas_f64(N, tile):
    s = system(N)
    x = tiled_pcr.tiled_spike_plain(*T(s), tile=tile)
    assert x.shape == (N, 2) and x.dtype == torch.float64
    close(x, jtri.block_thomas(*J(s)))
    # the wrapper takes this plain version for CPU tensors, and launches nothing
    before = tiled_pcr.launch_count
    assert torch.equal(tiled_pcr.tiled_spike_solve(*T(s), tile=tile), x)
    assert tiled_pcr.launch_count == before


@pytest.mark.parametrize("N,tile", [(256, 128), (1000, 128)])
def test_tiled_plain_vs_tpu_kernel_interpret(N, tile):
    """Against the TPU kernel in interpret mode (float32): its own bar."""
    s = system(N, seed=1)
    x = tiled_pcr.tiled_spike_plain(*T(s), tile=tile)
    jx = tiled_spike_pallas(*[jnp.asarray(a, jnp.float32) for a in s], tile=tile, interpret=True)
    scale = float(x.abs().max())
    assert float(np.abs(x.numpy() - np.asarray(jx, np.float64)).max()) < 5e-6 * scale


def test_stage_a_spikes_and_single_tile():
    """Stage A's G, V, W are the local solves they are defined as, and one
    tile degenerates to the plain PCR."""
    N, tile = 96, 32
    L, D, U, b = T(system(N, seed=2))
    G, V, W = tiled_pcr.stage_a_plain(L, D, U, b, tile)
    for t in range(N // tile):
        sl = slice(t * tile, (t + 1) * tile)
        Lt, Ut = L[sl].clone(), U[sl].clone()
        L_ext, U_ext = Lt[0].clone(), Ut[-1].clone()
        Lt[0] = 0.0
        Ut[-1] = 0.0
        e0 = torch.zeros((tile, 2, 2), dtype=torch.float64)
        el = torch.zeros((tile, 2, 2), dtype=torch.float64)
        e0[0], el[-1] = L_ext, U_ext
        close(G[sl], tri.block_thomas(Lt, D[sl], Ut, b[sl]).numpy())
        close(V[sl], tri.block_thomas(Lt, D[sl], Ut, e0).numpy())
        close(W[sl], tri.block_thomas(Lt, D[sl], Ut, el).numpy())
    s = system(200, seed=4)
    assert torch.equal(tiled_pcr.tiled_spike_plain(*T(s), tile=256), tri.block_pcr(*T(s)))
    with pytest.raises(ValueError, match="shared-memory maximum"):
        tiled_pcr.tiled_spike_plain(*T(s), tile=tiled_pcr.MAX_TILE + 1)
    # two buffers of 22 doubles a node fit a block's 227 KB up to MAX_TILE
    assert 2 * 22 * 8 * tiled_pcr.MAX_TILE <= 232448 < 2 * 22 * 8 * (tiled_pcr.MAX_TILE + 32)


def test_vector_aligned_copies_only_a_misaligned_view():
    """Stages A and C read 16-byte vectors: a view at an odd double offset
    is copied to an aligned tensor; an aligned contiguous one is passed on."""
    base = torch.arange(18, dtype=torch.float64)
    odd = base[1:17].view(8, 2)
    assert odd.data_ptr() % 16 == 8
    fixed = tiled_pcr._vector_aligned(odd)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, odd)
    even = base[2:18].view(8, 2)
    assert tiled_pcr._vector_aligned(even).data_ptr() == even.data_ptr()


def test_whole_solve_bound_is_the_functions_bytes():
    """The bound of the whole solve charges the function's least work: its
    16 doubles a node of traffic outweigh block Thomas's operations, so at
    N = 1e6 it is bound by bytes at 128 MB over 3.35 TB/s, whatever the
    tile."""
    for T in (256, 512):
        ms, by = chip_smoke.tiled_bounds(10**6, T)["whole"]
        assert by == "bytes" and ms == pytest.approx(8 * 16 * 1e6 / 3.35e12 * 1e3, rel=1e-12)


@pytest.mark.parametrize("method", ["cuda_tiled"])
def test_solve_block_tridiag_cuda_tiled_multi_rhs(method):
    s = system(700, seed=6)
    rng = np.random.default_rng(8)
    b = rng.uniform(-1, 1, (700, 2, 3))
    x = tri.solve_block_tridiag(*T(s[:3]), torch.tensor(b), method=method)
    close(x, jtri.solve_block_tridiag(*J(s[:3]), jnp.asarray(b), method="thomas"))
    assert method in tri.METHODS


@pytest.fixture(scope="module")
def long_reach():
    geo, us, ds, h0, Q0, sset = chip_smoke.build_long_reach(2048, "cpu", levels=2, linear_solver="cuda_tiled")
    jset = dataclasses.replace(to_jax(sset), linear_solver="pcr")
    jout = jprs.simulate(to_jax(geo), to_jax(us), to_jax(ds), jnp.asarray(h0.numpy()), jnp.asarray(Q0.numpy()), jset)
    return (geo, us, ds, h0, Q0, sset), jout


def test_long_reach_cuda_tiled_matches_jax_pcr(long_reach):
    args, jout = long_reach
    out = prs.simulate(*args)
    assert out.iterations.tolist() == np.asarray(jout.iterations).tolist()
    assert int(out.iterations.sum()) >= 4 and bool(out.converged.all())
    assert np.abs(out.depth.numpy() - np.asarray(jout.depth)).max() <= 1e-9
    assert np.abs(out.flow.numpy() - np.asarray(jout.flow)).max() <= 1e-6
    assert float((out.flow[-1] - out.flow[0]).abs().max()) > 100.0   # the ramp moved the state


def test_fused_simulate_on_the_long_reach_matches_jax(long_reach):
    """The slice of the long reaches: ``fused_simulate`` takes a reach of
    2048 nodes (the kernel's reach build on the card; here, on CPU tensors,
    its plain version, the eager engine with the PCR solve), held against
    the JAX package's run of the same reach."""
    args, jout = long_reach
    n = args[0].n_nodes
    assert fused_newton.MAX_N < n <= fused_newton.LONG_MAX_N and fused_newton.uses_reach_build(n)
    before = fused_newton.launch_count
    out = fused_newton.fused_simulate(*args)
    assert fused_newton.launch_count == before       # CPU tensors: the plain version
    assert out.iterations.tolist() == np.asarray(jout.iterations).tolist() and bool(out.converged.all())
    assert np.abs(out.depth.numpy() - np.asarray(jout.depth)).max() <= 1e-9
    assert np.abs(out.flow.numpy() - np.asarray(jout.flow)).max() <= 1e-6


def test_long_reach_newton_system_through_the_tiles(long_reach):
    """Realistic conditioning: the first Newton system of the long reach."""
    (geo, us, ds, h0, Q0, sset), _ = long_reach
    prev = prs.prev_level_state(geo, h0, Q0)
    L, D, U, b, *_ = prs.assemble(geo, us, ds, sset, prev, h0, Q0, 1)
    x = tiled_pcr.tiled_spike_plain(L, D, U, b, tile=256)
    close(x, jtri.block_thomas(*J([a.numpy() for a in (L, D, U, b)])), rtol=1e-9)


def test_reduced_cr_on_the_long_reach_newton_system(long_reach):
    """Stage B of the first Newton system of the long reach (eight 256-node
    tiles): the reduced rows solved by cyclic reduction against the JAX
    dense block-Thomas."""
    (geo, us, ds, h0, Q0, sset), _ = long_reach
    prev = prs.prev_level_state(geo, h0, Q0)
    L, D, U, b, *_ = prs.assemble(geo, us, ds, sset, prev, h0, Q0, 1)
    rows = tiled_pcr.reduced_rows(*tiled_pcr.stage_a_plain(L, D, U, b, 256), 256)
    assert rows[2].shape == (8, 4)
    y = tiled_pcr.reduced_cr_plain(*rows)
    close_scaled(y, jtri.dense_block_thomas(*J(dense_reduced(*(a.numpy() for a in rows)))))
