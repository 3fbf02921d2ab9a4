"""PyTorch port vs JAX package: block-tridiagonal solvers.

Random block-diagonally-dominant systems from a NumPy seed go through
``flowsim_tpu.ops.tridiag`` and ``flowsim_tpu_torch.ops.tridiag`` in float64
(rtol 1e-11: the two run the same algorithm, sums of ~log2 N sweeps may round
differently).  The CUDA kernel's wrapper takes its plain version on CPU
tensors and is held against the TPU kernel in Pallas interpret mode, which is
float32 only (rtol 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowsim_tpu.ops import tridiag as jtri
from flowsim_tpu.ops.pallas.pcr_kernel import pcr_pallas
from flowsim_tpu_torch.ops import tridiag as tri
from flowsim_tpu_torch.ops.cuda import pcr_kernel

from tests._torch_port import assert_close, without_autograd  # noqa: F401 (without_autograd is an autouse fixture)

torch.set_num_threads(1)

SIZES = [1, 2, 3, 121, 128, 1000]
RTOL = 1e-11


def system(n, seed=0, batch=(), m=None):
    rng = np.random.default_rng(1000 * n + seed)
    L = rng.uniform(-1.0, 1.0, batch + (n, 2, 2))
    U = rng.uniform(-1.0, 1.0, batch + (n, 2, 2))
    D = rng.uniform(-1.0, 1.0, batch + (n, 2, 2)) + 6.0 * np.eye(2)
    L[..., 0, :, :] = 0.0
    U[..., -1, :, :] = 0.0
    b = rng.uniform(-1.0, 1.0, batch + (n, 2) + (() if m is None else (m,)))
    return L, D, U, b


# the JAX references compiled as one program each: run op by op they spend
# seconds compiling every sweep's shifted shapes one primitive at a time
jit_block_pcr = jax.jit(jtri.block_pcr)
jit_block_pcr_diag = jax.jit(jtri.block_pcr_diag)

T = lambda xs: [torch.tensor(x) for x in xs]
J = lambda xs: [jnp.asarray(x) for x in xs]


def close(port, ref):
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("n", SIZES)
def test_block_thomas(n):
    s = system(n)
    close(tri.block_thomas(*T(s)), jtri.block_thomas(*J(s)))


@pytest.mark.parametrize("n", SIZES)
def test_block_pcr(n):
    s = system(n)
    x = tri.block_pcr(*T(s))
    close(x, jit_block_pcr(*J(s)))
    # and it solves the system: residual of the dense 2N x 2N matrix
    if n <= 128:
        L, D, U, b = T(s)
        A = tri.blocks_to_dense(L, D, U)
        assert_close(A, jtri.blocks_to_dense(*J(s)[:3]))
        assert float((A @ x.reshape(-1) - b.reshape(-1)).abs().max()) < 1e-12


@pytest.mark.parametrize("n", [1, 2, 3, 121])
def test_block_pcr_diag(n):
    s = system(n)
    x, rcond = tri.block_pcr_diag(*T(s))
    jx, jrcond = jit_block_pcr_diag(*J(s))
    close(x, jx)
    np.testing.assert_allclose(float(rcond), float(jrcond), rtol=1e-10)


@pytest.mark.parametrize("method", ["thomas", "pcr"])
def test_batched_and_multi_rhs(method):
    s = system(37, batch=(3,), m=4)
    fn = dict(thomas=(tri.block_thomas, jtri.block_thomas), pcr=(tri.block_pcr, jit_block_pcr))[method]
    close(fn[0](*T(s)), fn[1](*J(s)))


def test_singular_pivot_guard_gives_finite_delta():
    L, D, U, b = system(8)
    D[3] = 0.0
    x, jx = tri.block_pcr(*T((L, D, U, b))), jit_block_pcr(*J((L, D, U, b)))
    assert bool(torch.isfinite(x).all()) and bool(jnp.isfinite(jx).all())


@pytest.mark.parametrize("method", ["thomas", "pcr", "pcr_f32", "cuda_pcr"])
def test_solve_block_tridiag_methods(method):
    s = system(121, seed=5)
    jmethod = "pcr" if method == "cuda_pcr" else method  # on CPU tensors: the plain version
    x = tri.solve_block_tridiag(*T(s), method=method)
    jx = jtri.solve_block_tridiag(*J(s), method=jmethod)
    tol = 2e-5 if method == "pcr_f32" else RTOL
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=tol, atol=tol * float(np.abs(np.asarray(jx)).max()))
    assert x.dtype == torch.float64
    with pytest.raises(ValueError):
        tri.solve_block_tridiag(*T(s), method="pallas_pcr")


@pytest.mark.parametrize("n", [2, 121])
def test_pcr_solve_wrapper_cpu_vs_tpu_kernel_interpret(n):
    """The wrapper on CPU tensors (plain path, float64) against the TPU
    kernel in interpret mode (float32)."""
    s = system(n, seed=9)
    before = pcr_kernel.launch_count
    x = pcr_kernel.pcr_solve(*T(s))
    assert pcr_kernel.launch_count == before  # the plain path launches nothing
    jx = pcr_pallas(*J(s), interpret=True)
    scale = float(np.abs(np.asarray(jx)).max())
    np.testing.assert_allclose(x.numpy(), np.asarray(jx, dtype=np.float64), rtol=2e-4, atol=2e-4 * scale)
    # batched systems map to the leading dimension
    sb = system(n, seed=10, batch=(2,))
    xb = pcr_kernel.pcr_solve(*T(sb))
    close(xb[1], jit_block_pcr(*[a[1] for a in J(sb)]))


def test_pcr_solve_rejects_oversize_and_bad_shapes():
    n = pcr_kernel.MAX_N + 1
    z = torch.zeros((n, 2, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="exceeds"):
        pcr_kernel.pcr_solve(z, z, z, torch.zeros((n, 2), dtype=torch.float64))
    L, D, U, b = T(system(5))
    with pytest.raises(ValueError):
        pcr_kernel.pcr_solve(L, D, U, b[:-1])
    with pytest.raises(ValueError):
        pcr_kernel.pcr_solve(L[:, 0], D, U, b)
    # shared memory holds both buffers up to SMEM_MAX_N nodes (227 KB per block)
    assert 2 * 14 * 8 * pcr_kernel.SMEM_MAX_N <= 232448 < 2 * 14 * 8 * (pcr_kernel.SMEM_MAX_N + 38)


@pytest.mark.parametrize("solver", ["block_thomas", "block_pcr"])
def test_multi_rhs_columns_are_the_vector_solves(solver):
    """A multi-RHS solve shares the reduction across its columns: each column
    is the vector solve of that right-hand side, to the bit, batched too."""
    fn = getattr(tri, solver)
    for n, batch, m in ((1, (), 2), (121, (), 3), (37, (2,), 2)):
        L, D, U, b = T(system(n, seed=5, batch=batch, m=m))
        x = fn(L, D, U, b)
        for j in range(m):
            assert torch.equal(x[..., j], fn(L, D, U, b[..., j])), (n, batch, m, j)


def test_cuda_pcr_solves_every_column_of_every_system_in_one_batch():
    """The stacked network engine's shape, [B, N, 2, m]: ``cuda_pcr`` hands
    the B x m systems to the kernel as one batch (on CPU tensors its plain
    version, column by column), and each column is the PCR solve of that
    system."""
    L, D, U, b = T(system(37, seed=2, batch=(3,), m=3))
    before = pcr_kernel.launch_count
    x = tri.solve_block_tridiag(L, D, U, b, method="cuda_pcr")
    assert x.shape == b.shape and pcr_kernel.launch_count == before
    for j in range(3):
        assert torch.equal(x[..., j], tri.block_pcr(L, D, U, b[..., j]))
