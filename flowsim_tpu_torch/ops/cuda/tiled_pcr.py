"""``tiled_spike_solve``: the long-reach block-tridiagonal solve.

Counterpart of ``flowsim_tpu/ops/pallas/tiled_pcr.py`` (``tiled_spike_pallas``).
The single-block kernel (:mod:`pcr_kernel`) stops at N = 8192 and the plain
``ops.tridiag.block_pcr`` rewrites all 14 system rows to device memory on each
of its ceil(log2 N) sweeps.  This is SPIKE substructuring over tiles of T
nodes, float64, any N:

    stage A (the CUDA kernel ``csrc/tiled_pcr.cu``, one thread block per
        tile): the tile drops its couplings to the neighbour tiles and
        PCR-solves its local system in shared memory for 5 right-hand-side
        pairs at once — G = A_loc^-1 b and the spike columns
        V = A_loc^-1 (e_0 L_ext), W = A_loc^-1 (e_last U_ext).  One read of
        the system, one write of (G, V, W).
    stage B (torch): the tile-boundary unknowns y_t = [x_first; x_last]
        satisfy a block-tridiagonal *reduced* system of n_tiles 4x4 blocks
        with unit diagonal, solved by ``ops.tridiag.dense_block_thomas`` — a
        sequential scan over the tiles.
    stage C (torch): x = G - V x_prev_last - W x_next_first, elementwise.

The tile is bounded by shared memory: two buffers of 22 doubles a node are
352 B a node, so :data:`DEFAULT_TILE` = 512 takes 180 224 B and
:data:`MAX_TILE` = 640 takes 225 280 B of the 232 448 B a block may have.

On a CUDA tensor :func:`tiled_spike_solve` launches the kernel or raises; the
plain version (:func:`tiled_spike_plain`: the same three stages, stage A by
``ops.tridiag._pcr_core`` over all tiles at once) runs only for tensors that
lie on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from flowsim_tpu_torch.ops import tridiag
from flowsim_tpu_torch.ops.cuda import build

DEFAULT_TILE = 512
MAX_TILE = 640        # 2 buffers x 22 doubles x T <= 227 KB of shared memory

# number of kernel launches made by tiled_spike_solve (not by its plain version)
launch_count = 0


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


def reduced_system(G, V, W):
    """The stage-B system over y_t = [x_first; x_last] of each tile: L, D, U
    ``[n_tiles, 4, 4]`` (unit diagonal) and b ``[n_tiles, 4]``.  ``G``, ``V``,
    ``W`` are padded to whole tiles, ``[n_tiles, T, ...]``."""
    n_tiles = G.shape[0]
    Z = G.new_zeros((n_tiles, 2, 2))
    V0, Vl = V[:, 0], V[:, -1]
    W0, Wl = W[:, 0], W[:, -1]
    Lr = torch.cat([torch.cat([Z, V0], dim=-1), torch.cat([Z, Vl], dim=-1)], dim=-2)
    Ur = torch.cat([torch.cat([W0, Z], dim=-1), torch.cat([Wl, Z], dim=-1)], dim=-2)
    Dr = torch.eye(4, dtype=G.dtype, device=G.device).expand(n_tiles, 4, 4)
    br = torch.cat([G[:, 0], G[:, -1]], dim=-1)
    return Lr, Dr, Ur, br


def _pad_tiles(X, n_tiles: int, T: int):
    """``[N, ...]`` -> ``[n_tiles, T, ...]``, zero rows past N (what stage A
    gives for the padding nodes: a zero right-hand side)."""
    pad = n_tiles * T - X.shape[0]
    if pad:
        X = torch.cat([X, X.new_zeros((pad,) + X.shape[1:])])
    return X.reshape((n_tiles, T) + X.shape[1:])


def stage_b(G, V, W, T: int):
    """Stage B: the tile-boundary unknowns ``y [n_tiles, 4]``."""
    n_tiles = -(-G.shape[0] // T)
    return tridiag.dense_block_thomas(
        *reduced_system(*(_pad_tiles(X, n_tiles, T) for X in (G, V, W))))


def stage_c(G, V, W, y, T: int):
    """Stage C: substitute the neighbour tiles' boundary values back."""
    N = G.shape[0]
    zero = y.new_zeros((1, 2))
    x_prev_last = torch.cat([zero, y[:-1, 2:4]]).repeat_interleave(T, dim=0)[:N]
    x_next_first = torch.cat([y[1:, 0:2], zero]).repeat_interleave(T, dim=0)[:N]
    mv = lambda A, v: (A * v.unsqueeze(-2)).sum(-1)
    return G - mv(V, x_prev_last) - mv(W, x_next_first)


def _stages_bc(G, V, W, T: int):
    if G.shape[0] <= T:
        return G  # one tile, no neighbours: the local solve is the solve
    return stage_c(G, V, W, stage_b(G, V, W, T), T)


def tiled_spike_plain(L, D, U, b, tile: int = DEFAULT_TILE):
    """The plain PyTorch version of :func:`tiled_spike_solve`."""
    N = _check(L, D, U, b)
    T, _ = _tiling(N, tile)
    return _stages_bc(*stage_a_plain(L, D, U, b, T), T)


def _lib():
    lib = build.load("tiled_pcr")
    fn = lib.flowsim_tiled_spike
    if not getattr(fn, "_typed", False):
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return lib


def stage_a(L, D, U, b, T: int):
    """Stage A by the CUDA kernel, on CUDA float64 tensors: G, V, W."""
    global launch_count
    for name, t in (("L", L), ("D", D), ("U", U), ("b", b)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64 on the card; got {t.dtype}")
        if t.device != L.device:
            raise ValueError("L, D, U, b must lie on the same device")
    L, D, U, b = (t.contiguous() for t in (L, D, U, b))
    G = torch.empty_like(b)
    V = torch.empty_like(L)
    W = torch.empty_like(L)
    with torch.cuda.device(L.device):
        rc = _lib().flowsim_tiled_spike(
            L.data_ptr(), D.data_ptr(), U.data_ptr(), b.data_ptr(),
            G.data_ptr(), V.data_ptr(), W.data_ptr(), L.shape[0], T,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tiled_spike_solve launch failed: CUDA error {rc}")
    launch_count += 1
    return G, V, W


def tiled_spike_solve(L, D, U, b, tile: int = DEFAULT_TILE):
    """Solve the 2x2-block tridiagonal system L, D, U ``[N, 2, 2]``,
    b ``[N, 2]`` -> x ``[N, 2]`` for any N, float64."""
    N = _check(L, D, U, b)
    if L.device.type == "cpu":
        return tiled_spike_plain(L, D, U, b, tile)
    if L.device.type != "cuda":
        raise ValueError(f"tiled_spike_solve needs CUDA or CPU tensors; got {L.device}")
    T, _ = _tiling(N, tile)
    return _stages_bc(*stage_a(L, D, U, b, T), T)
