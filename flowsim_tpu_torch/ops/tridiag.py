"""Block-tridiagonal linear solvers (2x2 blocks, torch).

Counterpart of ``flowsim_tpu/ops/tridiag.py``.  The Preissmann Jacobian with
interleaved unknowns ``[h0,Q0,h1,Q1,...]`` is block tridiagonal when the
equations are grouped per node:

    L_i x_{i-1} + D_i x_i + U_i x_{i+1} = b_i ,   i = 0..N-1,

with 2x2 blocks, ``L_0 = U_{N-1} = 0``.

* :func:`block_thomas` — sequential block LU, a Python loop over the nodes
  (O(N) depth): the correctness reference.
* :func:`block_pcr` — parallel cyclic reduction: ceil(log2 N) sweeps of
  elementwise 2x2 algebra over all nodes; the plain version that the CUDA
  kernel ``ops.cuda.pcr_kernel.pcr_solve`` is held against.
* :func:`block_thomas_factor` / :func:`block_thomas_apply` — the same block LU
  with the factorization kept for later right-hand sides.
* :func:`dense_block_thomas` — Thomas with dense m x m blocks, for the small
  reduced systems of the SPIKE substructuring (``ops.cuda.tiled_pcr``).

The 2x2 solvers take leading batch dims.  All 2x2 inverses are closed form; the PCR
paths apply a tiny-pivot guard by default (:data:`PIVOT_EPS`) so a singular
system yields large-but-finite deltas instead of inf/NaN.
"""

from __future__ import annotations

import torch

# Default tiny-pivot guard for the closed-form 2x2 inverses.  Healthy pivot
# determinants in this application are O(1) and the guard only replaces a
# determinant whose magnitude is <= eps, so results on well-conditioned
# systems are bitwise unchanged; a singular pivot gives a finite delta.
PIVOT_EPS = {torch.float32: 1e-30, torch.float64: 1e-250}


def _default_eps(dtype) -> float:
    return PIVOT_EPS.get(dtype, 1e-30)


def _inv2(M, eps=0.0):
    """Closed-form inverse of [..., 2, 2] blocks."""
    a = M[..., 0, 0]
    b = M[..., 0, 1]
    c = M[..., 1, 0]
    d = M[..., 1, 1]
    det = a * d - b * c
    if eps:
        signed = torch.where(det >= 0, torch.full_like(det, eps), torch.full_like(det, -eps))
        det = torch.where(torch.abs(det) > eps, det, signed)
    inv_det = (1.0 / det).unsqueeze(-1)
    return (torch.stack([d, -b, -c, a], dim=-1) * inv_det).reshape(M.shape)


def _mm(A, B):
    """[..., 2, 2] @ [..., 2, m] as one broadcast product and a 2-term sum
    (entry = A[i,0] B[0,j] + A[i,1] B[1,j]; no library matmul)."""
    return (A.unsqueeze(-1) * B.unsqueeze(-3)).sum(-2)


def block_thomas(L, D, U, b):
    """Sequential block-Thomas solve along axis -3 (the node axis).

    Shapes: L, D, U: [..., N, 2, 2]; b: [..., N, 2] (vector RHS) or
    [..., N, 2, m] (multi-RHS — one forward/backward sweep shared across the
    m columns).  Batch dims must lead.
    """
    multi = b.ndim == L.ndim  # [..., N, 2, m]
    b_mat = b if multi else b.unsqueeze(-1)
    N = L.shape[-3]
    Ls, Ds, Us, bs = (X.unbind(-3) for X in (L, D, U, b_mat))

    C = torch.zeros_like(Ds[0])
    d = torch.zeros_like(bs[0])
    Cs, ds = [], []
    for i in range(N):
        Dhat_inv = _inv2(Ds[i] - _mm(Ls[i], C))
        d = _mm(Dhat_inv, bs[i] - _mm(Ls[i], d))
        C = _mm(Dhat_inv, Us[i])
        Cs.append(C)
        ds.append(d)

    x = torch.zeros_like(bs[0])
    xs = [None] * N
    for i in range(N - 1, -1, -1):
        x = ds[i] - _mm(Cs[i], x)
        xs[i] = x
    out = torch.stack(xs, dim=-3)
    return out if multi else out[..., 0]


def block_thomas_factor(L, D, U):
    """Forward block-LU sweep; returns reusable factors ``(C, Dhat_inv, L)``,
    each with the node axis leading.

    With C_i = Dhat_i^{-1} U_i and Dhat_i = D_i - L_i C_{i-1}, a later RHS is
    solved by d_i = Dhat_i^{-1} (b_i - L_i d_{i-1}) then back-substitution —
    the factorization is shared across right-hand sides (the SPIKE
    domain-decomposed solve needs 5 per local system).
    """
    L_ = torch.movedim(L, -3, 0)
    D_ = torch.movedim(D, -3, 0)
    U_ = torch.movedim(U, -3, 0)
    Cprev = torch.zeros_like(D_[0])
    C, Dhat_inv = [], []
    for i in range(L_.shape[0]):
        Dinv = _inv2(D_[i] - _mm(L_[i], Cprev))
        Cprev = _mm(Dinv, U_[i])
        C.append(Cprev)
        Dhat_inv.append(Dinv)
    return torch.stack(C), torch.stack(Dhat_inv), L_


def block_thomas_apply(factor, b):
    """Solve with a precomputed factorization (:func:`block_thomas_factor`).

    ``b``: vector RHS ``[N, 2]`` (optionally with leading batch axes
    ``[..., N, 2]``), or multi-RHS ``[N, 2, m]`` (trailing column axis).
    The ambiguous ``[2, 2, 2]`` shape is read as multi-RHS.
    """
    C, Dhat_inv, L_ = factor
    N = C.shape[0]
    if b.ndim == 2:  # vector RHS [N, 2]
        mv = lambda A, v: _mm(A, v.unsqueeze(-1))[..., 0]
        d = torch.zeros_like(b[0])
        ds = []
        for i in range(N):
            d = mv(Dhat_inv[i], b[i] - mv(L_[i], d))
            ds.append(d)
        x = torch.zeros_like(b[0])
        xs = [None] * N
        for i in range(N - 1, -1, -1):
            x = ds[i] - mv(C[i], x)
            xs[i] = x
        return torch.stack(xs)
    if b.shape[-3] == N and b.shape[-2] == 2:
        # multi-RHS [..., N, 2, m]: one column at a time
        return torch.stack([block_thomas_apply(factor, b[..., j]) for j in range(b.shape[-1])], dim=-1)
    if b.shape[-2] == N and b.shape[-1] == 2:
        # leading batch axes over vector RHS (a batch must not be read as the
        # node axis: silently wrong answers when B == N)
        flat = b.reshape((-1,) + b.shape[-2:])
        return torch.stack([block_thomas_apply(factor, bb) for bb in flat]).reshape(b.shape)
    raise ValueError(
        f"RHS shape {tuple(b.shape)} matches neither [..., {N}, 2] nor "
        f"[..., {N}, 2, m]")


def _shift(arr, s, node_axis):
    """arr shifted so index i reads i+s; out-of-range rows give zeros."""
    N = arr.shape[node_axis]
    if s == 0:
        return arr
    out = torch.zeros_like(arr)
    k = min(abs(s), N)
    if k == N:
        return out
    if s > 0:
        out.narrow(node_axis, 0, N - k).copy_(arr.narrow(node_axis, k, N - k))
    else:
        out.narrow(node_axis, k, N - k).copy_(arr.narrow(node_axis, 0, N - k))
    return out


def _pcr_core(L, D, U, b, pivot_eps: float | None = None):
    """Parallel cyclic reduction over 2x2 blocks.

    Each sweep eliminates the couplings at the current stride: with
    ``a = -L_i D_{i-s}^{-1}`` and ``c = -U_i D_{i+s}^{-1}``,

        L' = a L_{i-s},  U' = c U_{i+s},
        D' = D + a U_{i-s} + c L_{i+s},
        b' = b + a b_{i-s} + c b_{i+s}.

    Out-of-range neighbours are identity-diagonal/zero rows, so the update is
    a no-op there.  After ceil(log2 N) sweeps the system is block diagonal.

    ``pivot_eps=None`` selects the dtype default (:data:`PIVOT_EPS`); pass
    ``0.0`` to disable the guard entirely.  ``b`` may be a vector RHS
    [..., N, 2] or multi-RHS [..., N, 2, m].
    """
    if pivot_eps is None:
        pivot_eps = _default_eps(D.dtype)
    N = L.shape[-3]
    node_axis = L.ndim - 3

    multi = b.ndim == L.ndim  # [..., N, 2, m]
    b_mat = b if multi else b.unsqueeze(-1)

    eye = torch.eye(2, dtype=D.dtype, device=D.device)
    idx = torch.arange(N, device=D.device)
    m = b_mat.shape[-1]
    cL, cD, cU, cb = slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 6 + m)
    lead = (1,) * node_axis

    # one packed tensor [..., N, 2, 6 + m] = [L | D | U | b], and the two
    # neighbours i-s / i+s stacked on a leading axis: a sweep inverts both
    # neighbour pivots in one call and multiplies both neighbour rows by
    # (a, c) in one call — the same scalar operations as block by block, in
    # far fewer tensor calls
    X = torch.cat([L, D, U, b_mat], dim=-1)
    s = 1
    n_sweeps = max(1, (N - 1).bit_length())
    for _ in range(n_sweeps):
        # rows shifted by -s and +s, zeros out of range: two views of one padding
        pad = X.new_zeros(X.shape[:node_axis] + (s,) + X.shape[node_axis + 1:])
        Xpad = torch.cat([pad, X, pad], dim=node_axis)
        XX = torch.stack([Xpad.narrow(node_axis, 0, N), Xpad.narrow(node_axis, 2 * s, N)])
        # out-of-range neighbour D must be invertible: use identity there
        valid = torch.stack([idx - s >= 0, idx + s < N]).reshape((2,) + lead + (N, 1, 1))
        inv = _inv2(torch.where(valid, XX[..., cD], eye), pivot_eps)
        # a = -L inv(D[i-s]), c = -U inv(D[i+s])
        ac = -_mm(torch.stack([X[..., cL], X[..., cU]]), inv)
        aXm, cXp = _mm(ac, XX).unbind(0)
        X = torch.cat([
            aXm[..., cL],                               # L' = a L[i-s]
            X[..., cD] + aXm[..., cU] + cXp[..., cL],   # D' = D + a U[i-s] + c L[i+s]
            cXp[..., cU],                               # U' = c U[i+s]
            X[..., cb] + aXm[..., cb] + cXp[..., cb],   # b' = b + a b[i-s] + c b[i+s]
        ], dim=-1)
        s *= 2
    D, b_mat = X[..., cD], X[..., cb]

    x = _mm(_inv2(D, pivot_eps), b_mat)
    return (x if multi else x[..., 0]), D


def block_pcr(L, D, U, b, pivot_eps: float | None = None):
    """Parallel cyclic reduction solve (see :func:`_pcr_core`)."""
    x, _ = _pcr_core(L, D, U, b, pivot_eps)
    return x


def _rel_pivot_det(D):
    """|det| of each 2x2 pivot relative to its entry scale, [..., N]."""
    a = D[..., 0, 0]
    b_ = D[..., 0, 1]
    c = D[..., 1, 0]
    d = D[..., 1, 1]
    det = a * d - b_ * c
    scale = torch.maximum(torch.maximum(torch.abs(a), torch.abs(b_)),
                          torch.maximum(torch.abs(c), torch.abs(d)))
    tiny = torch.finfo(D.dtype).tiny
    return torch.abs(det) / torch.clamp(scale * scale, min=tiny)


def block_pcr_diag(L, D, U, b, pivot_eps: float | None = None):
    """PCR solve plus a reciprocal-condition proxy: ``(x, rcond)`` where
    ``rcond`` is the minimum over the final (fully decoupled) PCR pivots of
    ``|det| / scale^2``."""
    x, D_final = _pcr_core(L, D, U, b, pivot_eps)
    rcond = torch.min(_rel_pivot_det(D_final), dim=-1).values
    return x, rcond


def dense_block_thomas(L, D, U, b):
    """Sequential Thomas solve with dense m x m blocks.

    Shapes: L, D, U [S, m, m]; b [S, m].  Used for the small *reduced* systems
    of the SPIKE substructuring (S = number of tiles, m = 4).  A Python loop
    over S with one small dense solve per step (``[U_i | b_i]`` share it):
    exact, and sequential by nature.
    """
    S, m = D.shape[0], D.shape[-1]
    C = torch.zeros((m, m), dtype=D.dtype, device=D.device)
    d = torch.zeros((m, 1), dtype=D.dtype, device=D.device)
    rhs = torch.cat([U, b.unsqueeze(-1)], dim=-1)  # [S, m, m + 1]
    Cd = []
    for i in range(S):
        Dh = D[i] - L[i] @ C
        r = rhs[i].clone()
        r[:, m:] -= L[i] @ d
        # solve_ex: no host read of the LAPACK status per step
        sol = torch.linalg.solve_ex(Dh, r).result
        C, d = sol[:, :m], sol[:, m:]
        Cd.append(sol)
    x = torch.zeros((m, 1), dtype=D.dtype, device=D.device)
    xs = [None] * S
    for i in range(S - 1, -1, -1):
        x = Cd[i][:, m:] - Cd[i][:, :m] @ x
        xs[i] = x[:, 0]
    return torch.stack(xs)


def interleave_to_blocks(A):
    """Inverse of :func:`blocks_to_dense`: split a dense 2N x 2N banded
    matrix into its (L, D, U) 2x2 block diagonals (tests / diagnostics)."""
    twoN = A.shape[-1]
    if A.shape[-2] != twoN or twoN % 2:
        raise ValueError("expected a square 2N x 2N matrix")
    N = twoN // 2
    A4 = A.reshape(*A.shape[:-2], N, 2, N, 2).transpose(-3, -2)  # [..., N(row), N(col), 2, 2]
    idx = torch.arange(N, device=A.device)
    D = A4[..., idx, idx, :, :]
    L = torch.zeros_like(D)
    U = torch.zeros_like(D)
    if N > 1:
        L[..., 1:, :, :] = A4[..., idx[1:], idx[:-1], :, :]
        U[..., :-1, :, :] = A4[..., idx[:-1], idx[1:], :, :]
    return L, D, U


def blocks_to_dense(L, D, U):
    """Assemble the dense 2N x 2N matrix from block-tridiagonal form (tests)."""
    N = L.shape[0]
    A = torch.zeros((2 * N, 2 * N), dtype=D.dtype, device=D.device)
    for i in range(N):
        A[2 * i: 2 * i + 2, 2 * i: 2 * i + 2] = D[i]
        if i > 0:
            A[2 * i: 2 * i + 2, 2 * i - 2: 2 * i] = L[i]
        if i < N - 1:
            A[2 * i: 2 * i + 2, 2 * i + 2: 2 * i + 4] = U[i]
    return A


METHODS = ("thomas", "pcr", "pcr_f32", "cuda_pcr", "cuda_tiled")


def solve_block_tridiag(L, D, U, b, method: str = "pcr"):
    """Solve the 2x2 block-tridiagonal system.

    ``b``: [..., N, 2] vector RHS, or [..., N, 2, m] multi-RHS (thomas / pcr /
    pcr_f32 share the reduction work across the m columns; the CUDA kernels
    solve the columns independently).
    """
    if method == "thomas":
        return block_thomas(L, D, U, b)
    if method == "pcr":
        return block_pcr(L, D, U, b)
    if method == "pcr_f32":
        # inexact-Newton inner solve: the increment only needs a few correct
        # digits for Newton to keep its convergence behavior
        f32 = torch.float32
        return block_pcr(L.to(f32), D.to(f32), U.to(f32), b.to(f32)).to(b.dtype)
    if method in ("cuda_pcr", "cuda_tiled"):
        if method == "cuda_pcr":
            # hand-written Hopper kernel, one system resident in one block
            from flowsim_tpu_torch.ops.cuda.pcr_kernel import pcr_solve as solve
        else:
            # two-level SPIKE solve, hand-written per-tile kernel: any N (the
            # long-reach solver)
            from flowsim_tpu_torch.ops.cuda.tiled_pcr import tiled_spike_solve as solve

        if b.ndim == L.ndim:
            return torch.stack([solve(L, D, U, b[..., j]) for j in range(b.shape[-1])], dim=-1)
        return solve(L, D, U, b)
    raise ValueError(f"unknown method {method!r}")
