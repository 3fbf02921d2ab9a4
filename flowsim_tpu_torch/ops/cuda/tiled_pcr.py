"""``tiled_spike_solve``: the long-reach block-tridiagonal solve.

Counterpart of ``flowsim_tpu/ops/pallas/tiled_pcr.py`` (``tiled_spike_pallas``).
The single-block kernel (:mod:`pcr_kernel`) stops at N = 8192 and the plain
``ops.tridiag.block_pcr`` rewrites all 14 system rows to device memory on each
of its ceil(log2 N) sweeps.  This is SPIKE substructuring over tiles of T
nodes, float64, any N, in three kernels of ``csrc/tiled_pcr.cu`` launched on
one stream with no host synchronisation between them:

    stage A (one thread block per tile): the tile drops its couplings to the
        neighbour tiles and PCR-solves its local system in shared memory for
        5 right-hand-side pairs at once — G = A_loc^-1 b and the spike
        columns V = A_loc^-1 (e_0 L_ext), W = A_loc^-1 (e_last U_ext).  One
        read of the system, one write of (G, V, W), and the tile's compact
        reduced row (V, W, G at its first and last node: 20 doubles).
    stage B (one thread block): the tile-boundary unknowns
        y_t = [x_first; x_last] satisfy a block-tridiagonal *reduced* system
        of n_tiles 4x4 blocks with unit diagonal, solved by block cyclic
        reduction on normalised rows (:func:`reduced_cr_plain` is the same
        algorithm in torch).
    stage C (one thread per node): x = G - V x_prev_last - W x_next_first.

The tile is bounded by shared memory: two buffers of 22 doubles a node are
352 B a node, so :data:`DEFAULT_TILE` = 512 takes 180 224 B (one tile an
SM), T = 256 takes 90 112 B (two tiles an SM, one tile's loads overlapping
the other's sweeps) and :data:`MAX_TILE` = 640 takes 225 280 B of the
232 448 B a block may have.  At N = 1e6 the two tiles give the same whole
solve on an H100: T = 256 gains in stage A what it loses in stage B, which
has twice the rows (PERF.md keeps the readings).

On a CUDA tensor :func:`tiled_spike_solve` launches the kernels or raises;
the plain version (:func:`tiled_spike_plain`: the same three stages, stage A
by ``ops.tridiag._pcr_core`` over all tiles at once, stage B by
:func:`reduced_cr_plain`) runs only for tensors that lie on the CPU.
``ops.tridiag.dense_block_thomas``, the JAX package's stage-B solver, is the
reference the tests hold stage B against.
"""

from __future__ import annotations

import ctypes

import torch

from flowsim_tpu_torch.ops import tridiag
from flowsim_tpu_torch.ops.cuda import build

DEFAULT_TILE = 512
MAX_TILE = 640        # 2 buffers x 22 doubles x T <= 227 KB of shared memory

REDUCED_ROW = 20     # doubles of one compact reduced row (csrc/tiled_pcr.cu)

# kernel launches made by tiled_spike_solve (not by its plain version): stage
# A (one per solve), stage B and stage C (one each per solve of more than one
# tile)
launch_count = 0
stage_b_launch_count = 0
stage_c_launch_count = 0


def _tiling(N: int, tile: int):
    T = int(tile)
    if T < 2:
        raise ValueError(f"tile={T} must be at least 2")
    if T > MAX_TILE:
        raise ValueError(f"tile={T} exceeds the shared-memory maximum {MAX_TILE}")
    T = min(T, max(32, -(-N // 32) * 32))  # no point tiling beyond N
    return T, -(-N // T)


def _check(L, D, U, b):
    if L.ndim != 3 or L.shape[-2:] != (2, 2):
        raise ValueError(f"L must be [N, 2, 2]; got {tuple(L.shape)}")
    if D.shape != L.shape or U.shape != L.shape:
        raise ValueError("L, D, U must have the same shape")
    if b.shape != L.shape[:-1]:
        raise ValueError(f"b must be {tuple(L.shape[:-1])}; got {tuple(b.shape)}")
    if L.shape[0] < 1:
        raise ValueError("empty system")
    return L.shape[0]


def stage_a_plain(L, D, U, b, T: int):
    """Stage A in plain PyTorch: G ``[N, 2]``, V, W ``[N, 2, 2]``."""
    N = L.shape[0]
    n_tiles = -(-N // T)
    pad = n_tiles * T - N

    def tiles(X, diag=False):
        if pad:
            fill = X.new_zeros((pad,) + X.shape[1:])
            if diag:
                fill[:, 0, 0] = 1.0
                fill[:, 1, 1] = 1.0
            X = torch.cat([X, fill])
        return X.reshape((n_tiles, T) + X.shape[1:])

    Lt, Dt, Ut, bt = tiles(L).clone(), tiles(D, diag=True), tiles(U).clone(), tiles(b)
    rhs = bt.new_zeros((n_tiles, T, 2, 5))
    rhs[..., 0] = bt
    rhs[:, 0, :, 1:3] = Lt[:, 0]      # e_0 (x) L_ext, column by column
    rhs[:, -1, :, 3:5] = Ut[:, -1]    # e_last (x) U_ext
    Lt[:, 0] = 0.0
    Ut[:, -1] = 0.0
    x, _ = tridiag._pcr_core(Lt, Dt, Ut, rhs)
    x = x.reshape(n_tiles * T, 2, 5)[:N]
    return x[..., 0], x[..., 1:3], x[..., 3:5]


def _pad_tiles(X, n_tiles: int, T: int):
    """``[N, ...]`` -> ``[n_tiles, T, ...]``, zero rows past N (what stage A
    gives for the padding nodes: a zero right-hand side)."""
    pad = n_tiles * T - X.shape[0]
    if pad:
        X = torch.cat([X, X.new_zeros((pad,) + X.shape[1:])])
    return X.reshape((n_tiles, T) + X.shape[1:])


def reduced_rows(G, V, W, T: int):
    """The stage-B system over y_t = [x_first; x_last] of each tile, as the
    normalised compact rows the kernels keep: ``Lc, Uc [n_tiles, 4, 2]`` (the
    non-zero halves of L_t = [[0, V_first], [0, V_last]] and
    U_t = [[W_first, 0], [W_last, 0]]; the diagonal block is I) and
    ``r [n_tiles, 4]`` = [G_first; G_last]."""
    n_tiles = -(-G.shape[0] // T)
    Gt, Vt, Wt = (_pad_tiles(X, n_tiles, T) for X in (G, V, W))
    edge = lambda X: torch.cat([X[:, 0], X[:, -1]], dim=1)
    return edge(Vt), edge(Wt), edge(Gt)


def _cr_levels(n: int):
    s = 1
    while 2 * s <= n:
        yield s
        s *= 2


def reduced_cr_plain(Lc, Uc, r):
    """Solve the reduced system of :func:`reduced_rows` by block cyclic
    reduction, the algorithm of the stage-B kernel (``reduced_cr_kernel``),
    every row of a level at once: ``y [n, 4]``.

    A row is kept normalised (diagonal I).  At stride s the rows
    i = 2s-1 (mod 2s) eliminate rows i-s and i+s (rows outside [0, n) are
    zero) and are renormalised by a 4x4 solve with partial pivoting; the
    row left at the top is solved, and the back-substitution
    y_i = r_i - Lc_i y_{i-s}[2:4] - Uc_i y_{i+s}[0:2] walks the strides down.
    """
    n = r.shape[0]
    Lc, Uc, r = Lc.clone(), Uc.clone(), r.clone()
    eye = torch.eye(4, dtype=r.dtype, device=r.device)
    mm = tridiag._mm
    mv = lambda A, v: mm(A, v.unsqueeze(-1))[..., 0]

    def neighbours(X, idx, rows):
        """X[idx] with rows outside [0, n) zero, restricted to ``rows``."""
        ok = (idx >= 0) & (idx < n)
        out = X[idx.clamp(0, n - 1)][:, rows]
        return torch.where(ok.view((-1,) + (1,) * (out.dim() - 1)), out, torch.zeros_like(out))

    levels = list(_cr_levels(n))
    for s in levels:
        i = torch.arange(2 * s - 1, n, 2 * s, device=r.device)
        last, first = slice(2, 4), slice(0, 2)   # the neighbour rows that couple to i
        Lm, Um, rm = (neighbours(X, i - s, last) for X in (Lc, Uc, r))
        Lp, Up, rp = (neighbours(X, i + s, first) for X in (Lc, Uc, r))
        Li, Ui, ri = Lc[i], Uc[i], r[i]
        A = eye - torch.cat([mm(Li, Um), mm(Ui, Lp)], dim=-1)
        X = torch.cat([-mm(Li, Lm), -mm(Ui, Up),
                       ((ri - mv(Li, rm)) - mv(Ui, rp)).unsqueeze(-1)], dim=-1)
        X = torch.linalg.solve_ex(A, X).result
        Lc[i], Uc[i], r[i] = X[..., 0:2], X[..., 2:4], X[..., 4]
    y = torch.zeros_like(r)
    top = 2 * levels[-1] if levels else 1
    y[top - 1] = r[top - 1]
    s = top // 2
    while s >= 1:
        i = torch.arange(s - 1, n, 2 * s, device=r.device)
        ym = neighbours(y, i - s, slice(2, 4))
        yp = neighbours(y, i + s, slice(0, 2))
        y[i] = (r[i] - mv(Lc[i], ym)) - mv(Uc[i], yp)
        s //= 2
    return y


def stage_b_plain(G, V, W, T: int):
    """Stage B in plain PyTorch: the tile-boundary unknowns ``y [n_tiles, 4]``."""
    return reduced_cr_plain(*reduced_rows(G, V, W, T))


def stage_c_plain(G, V, W, y, T: int):
    """Stage C in plain PyTorch: substitute the neighbour tiles' boundary
    values back."""
    N = G.shape[0]
    zero = y.new_zeros((1, 2))
    x_prev_last = torch.cat([zero, y[:-1, 2:4]]).repeat_interleave(T, dim=0)[:N]
    x_next_first = torch.cat([y[1:, 0:2], zero]).repeat_interleave(T, dim=0)[:N]
    mv = lambda A, v: (A * v.unsqueeze(-2)).sum(-1)
    return G - mv(V, x_prev_last) - mv(W, x_next_first)


def tiled_spike_plain(L, D, U, b, tile: int = DEFAULT_TILE):
    """The plain PyTorch version of :func:`tiled_spike_solve`."""
    N = _check(L, D, U, b)
    T, _ = _tiling(N, tile)
    G, V, W = stage_a_plain(L, D, U, b, T)
    if N <= T:
        return G  # one tile, no neighbours: the local solve is the solve
    return stage_c_plain(G, V, W, stage_b_plain(G, V, W, T), T)


def _lib():
    lib = build.load("tiled_pcr")
    if not getattr(lib, "_typed", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.flowsim_tiled_spike.argtypes = [p] * 8 + [i64, i32, p]
        lib.flowsim_tiled_reduced.argtypes = [p, p, i32, p]
        lib.flowsim_tiled_substitute.argtypes = [p] * 5 + [i64, i32, p]
        for fn in (lib.flowsim_tiled_spike, lib.flowsim_tiled_reduced, lib.flowsim_tiled_substitute,
                   lib.flowsim_tiled_reduced_row):
            fn.restype = ctypes.c_int
        if lib.flowsim_tiled_reduced_row() != REDUCED_ROW:
            raise RuntimeError("tiled_pcr.cu and tiled_pcr.py disagree on the reduced row")
        lib._typed = True
    return lib


def _raise_on(rc: int, stage: str):
    if rc != 0:
        raise RuntimeError(f"tiled_spike_solve {stage} launch failed: CUDA error {rc}")


def _vector_aligned(t):
    """``t`` contiguous at a 16-byte address: stages A and C move 2x2 blocks
    and pairs as 16-byte vectors, and a misaligned one would fault after the
    launch.  A view at an odd double offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stage_a(L, D, U, b, T: int):
    """Stage A by its kernel, on CUDA float64 tensors: G ``[N, 2]``, V, W
    ``[N, 2, 2]`` and the compact reduced rows R ``[20, n_tiles]`` (what
    stage B reads)."""
    global launch_count
    for name, t in (("L", L), ("D", D), ("U", U), ("b", b)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64 on the card; got {t.dtype}")
        if t.device != L.device:
            raise ValueError("L, D, U, b must lie on the same device")
    L, D, U, b = (_vector_aligned(t) for t in (L, D, U, b))
    G = torch.empty_like(b)
    V = torch.empty_like(L)
    W = torch.empty_like(L)
    R = L.new_empty((REDUCED_ROW, -(-L.shape[0] // T)))
    with torch.cuda.device(L.device):
        _raise_on(_lib().flowsim_tiled_spike(
            L.data_ptr(), D.data_ptr(), U.data_ptr(), b.data_ptr(), G.data_ptr(), V.data_ptr(),
            W.data_ptr(), R.data_ptr(), L.shape[0], T, torch.cuda.current_stream().cuda_stream),
            "stage A")
    launch_count += 1
    return G, V, W, R


def stage_b(R):
    """Stage B by its kernel: the reduced rows ``R [20, n_tiles]`` of
    :func:`stage_a` (overwritten) -> ``y [n_tiles, 4]``."""
    global stage_b_launch_count
    y = R.new_empty((R.shape[1], 4))
    with torch.cuda.device(R.device):
        _raise_on(_lib().flowsim_tiled_reduced(
            R.data_ptr(), y.data_ptr(), R.shape[1], torch.cuda.current_stream().cuda_stream),
            "stage B")
    stage_b_launch_count += 1
    return y


def stage_c(G, V, W, y, T: int):
    """Stage C by its kernel: x ``[N, 2]``."""
    global stage_c_launch_count
    G, V, W, y = (_vector_aligned(t) for t in (G, V, W, y))
    x = torch.empty_like(G)
    with torch.cuda.device(G.device):
        _raise_on(_lib().flowsim_tiled_substitute(
            G.data_ptr(), V.data_ptr(), W.data_ptr(), y.data_ptr(), x.data_ptr(), G.shape[0], T,
            torch.cuda.current_stream().cuda_stream), "stage C")
    stage_c_launch_count += 1
    return x


def tiled_spike_solve(L, D, U, b, tile: int = DEFAULT_TILE):
    """Solve the 2x2-block tridiagonal system L, D, U ``[N, 2, 2]``,
    b ``[N, 2]`` -> x ``[N, 2]`` for any N, float64."""
    N = _check(L, D, U, b)
    if L.device.type == "cpu":
        return tiled_spike_plain(L, D, U, b, tile)
    if L.device.type != "cuda":
        raise ValueError(f"tiled_spike_solve needs CUDA or CPU tensors; got {L.device}")
    T, _ = _tiling(N, tile)
    G, V, W, R = stage_a(L, D, U, b, T)
    if N <= T:
        return G
    return stage_c(G, V, W, stage_b(R), T)
