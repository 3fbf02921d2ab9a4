// tiled_spike: the SPIKE long-reach solve, float64, all three stages on the card.
//
// Replaces flowsim_tpu/ops/pallas/tiled_pcr.py (_tiled_spike_kernel via
// tiled_spike_pallas, whose jitted function also holds stages B and C): a
// 2x2-block tridiagonal system L, D, U [N, 2, 2], b [N, 2] of any length N is
// cut into tiles of T nodes and solved in three launches on one stream, with
// no host synchronisation between them:
//
//   stage A (tiled_spike_kernel, one thread block per tile): the tile drops
//     its couplings to the neighbour tiles and PCR-solves its local system
//     for five right-hand-side pairs at once,
//         G = A_loc^-1 b,  V = A_loc^-1 (e_0 (x) L_ext),  W = A_loc^-1 (e_last (x) U_ext),
//     L_ext / U_ext being the dropped blocks (the first node's L, the last
//     node's U).  It writes G, V, W for every node and, for stage B, the
//     tile's compact reduced row: V, W, G at its first and last node.
//   stage B (reduced_cr_kernel, one thread block): the tile-boundary unknowns
//     y_t = [x_first; x_last] satisfy a block-tridiagonal system of 4x4 blocks
//     with unit diagonal whose off-diagonal blocks are half zero,
//         L_t = [[0, V_first], [0, V_last]],  U_t = [[W_first, 0], [W_last, 0]],
//     and it stays so under elimination: a row is kept normalised (diagonal
//     I) as 20 doubles, the 4x2 non-zero halves Lc, Uc and the right-hand
//     side.  Block cyclic reduction: at stride s the rows i = 2s-1 (mod 2s)
//     eliminate rows i-s and i+s,
//         D' = I - [Lc_i Uc_{i-s}[2:4] | Uc_i Lc_{i+s}[0:2]],
//         Lc' = -Lc_i Lc_{i-s}[2:4],  Uc' = -Uc_i Uc_{i+s}[0:2],
//         r' = r_i - Lc_i r_{i-s}[2:4] - Uc_i r_{i+s}[0:2],
//     and renormalise by a 4x4 Gaussian elimination with partial pivoting;
//     the last row standing is solved, then the back-substitution
//     y_i = r_i - Lc_i y_{i-s}[2:4] - Uc_i y_{i+s}[0:2] walks the strides
//     down.  Readers and writers of a level are disjoint rows, so the rows
//     are updated in place, one block barrier a level.
//   stage C (substitute_kernel, one thread per node):
//         x = G - V x_prev_last - W x_next_first.
//
// What bounds it on an H100: the function reads L, D, U, b once (14 doubles
// a node) and writes x once (2): 128 B a node, 38 us at N = 1e6 over
// 3.35 TB/s.  Its least work is block Thomas on the same system, ~58
// float64 operations a node, ~2 us at the card's FP64 rate, so bytes is the
// larger: stage A's ceil(log2 T) five-pair sweeps are the algorithm's work,
// not the function's.  The kernels move more than the function: stage A
// writes G, V, W (10 doubles a node) and stage C reads them back, 36 doubles
// a node in all.
//
// The design of each stage:
//  * stage A keeps every sweep out of device memory: the tile's 12 matrix
//    and 10 right-hand-side components are held component-major in shared
//    memory and ping-ponged between two buffers through pcr::sweep_node<5>,
//    one block barrier per sweep.  That is 2 x 22 x 8 = 352 B a node: the
//    default T = 512 takes 180 KB, one tile an SM; T = 256 takes 90 KB, so
//    two tiles are resident on an SM and one tile's loads and stores overlap
//    the other's sweeps (T <= 640 fits).  A thread owns one node (T <= 512
//    threads) and reads and writes its 2x2 blocks as 16-byte vectors.  The
//    sweeps themselves set the pace: each reads three nodes' 22 components
//    and writes one node's, ~700 B of shared-memory traffic a node and
//    sweep, so two tiles an SM win back only the loads, and an asynchronous
//    copy or a persistent block prefetching the next tile could win no more
//    (a staging area would also cost the second resident tile).  Nodes past N in
//    the last tile are identity-diagonal decoupled rows with a zero
//    right-hand side; they take part in every sweep, so every tile runs the
//    same sweeps, and their solution is exactly zero.
//  * stage B is ~n_tiles row updates of ~300 operations and a log-depth
//    chain of barriers: one block of 512 threads, the rows in device memory
//    (20 doubles a row, 0.3 MB at 1954 tiles: L2-resident).  The rows are
//    read and written in the same launch, so they are never marked const
//    __restrict__ (a read through the non-coherent cache could see a stale
//    row).
//  * stage C is one coalesced elementwise pass.
//
// Reached on an NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py):
// the whole solve at N = 1e6, T = 512, 0.39 ms, 10.3 times its bound (stage A
// 0.29 ms, B 0.058 ms, C 0.036 ms); the eager scan it replaces took 400-600
// ms.  PERF.md keeps the readings.
//
// C interface (ctypes): each function launches one kernel on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include "pcr_common.cuh"

namespace {

constexpr int RHS = 5;
constexpr int COMP = pcr::components<RHS>();  // 22
constexpr int A_THREADS = 512;                 // at most one node a thread
constexpr int B_THREADS = 512;
constexpr int C_THREADS = 256;
// the compact reduced row, component-major [ROW, n_tiles]: Lc (4x2,
// row-major) 0-7, Uc 8-15, r 16-19; rows 0-1 of Lc, Uc, r belong to the
// tile's first node, rows 2-3 to its last
constexpr int ROW = 20;
constexpr int R_LC = 0, R_UC = 8, R_R = 16;

__global__ void __launch_bounds__(A_THREADS) tiled_spike_kernel(
        const double* __restrict__ L, const double* __restrict__ D,
        const double* __restrict__ U, const double* __restrict__ b,
        double* __restrict__ G, double* __restrict__ V, double* __restrict__ W,
        double* __restrict__ R, long long n, int T, int n_tiles, int sweeps) {
    extern __shared__ double smem[];
    double* buf0 = smem;
    double* buf1 = smem + (size_t)COMP * T;
    const long long base = (long long)blockIdx.x * T;
    const double2* L2 = reinterpret_cast<const double2*>(L);
    const double2* D2 = reinterpret_cast<const double2*>(D);
    const double2* U2 = reinterpret_cast<const double2*>(U);
    const double2* b2 = reinterpret_cast<const double2*>(b);

    for (int i = threadIdx.x; i < T; i += blockDim.x) {
        const long long gi = base + i;
        const bool live = gi < n;
        const double2 z = make_double2(0.0, 0.0);
        const double2 l01 = live ? L2[2 * gi] : z, l23 = live ? L2[2 * gi + 1] : z;
        const double2 d01 = live ? D2[2 * gi] : make_double2(1.0, 0.0);
        const double2 d23 = live ? D2[2 * gi + 1] : make_double2(0.0, 1.0);
        const double2 u01 = live ? U2[2 * gi] : z, u23 = live ? U2[2 * gi + 1] : z;
        const double2 r = live ? b2[gi] : z;
        const double l[4] = {l01.x, l01.y, l23.x, l23.y};
        const double d[4] = {d01.x, d01.y, d23.x, d23.y};
        const double u[4] = {u01.x, u01.y, u23.x, u23.y};
        const bool first = i == 0, last = i == T - 1;
        // pair 0: b; pairs 1-2: the columns of e_0 (x) L_ext (column j of a
        // row-major 2x2 block is its entries j and 2 + j); pairs 3-4: those
        // of e_last (x) U_ext.  The blocks themselves leave the local matrix.
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            buf0[(0 + c) * T + i] = first ? 0.0 : l[c];
            buf0[(4 + c) * T + i] = d[c];
            buf0[(8 + c) * T + i] = last ? 0.0 : u[c];
        }
        buf0[12 * T + i] = r.x;
        buf0[13 * T + i] = r.y;
        buf0[14 * T + i] = first ? l[0] : 0.0;
        buf0[15 * T + i] = first ? l[2] : 0.0;
        buf0[16 * T + i] = first ? l[1] : 0.0;
        buf0[17 * T + i] = first ? l[3] : 0.0;
        buf0[18 * T + i] = last ? u[0] : 0.0;
        buf0[19 * T + i] = last ? u[2] : 0.0;
        buf0[20 * T + i] = last ? u[1] : 0.0;
        buf0[21 * T + i] = last ? u[3] : 0.0;
    }
    __syncthreads();

    double* src = buf0;
    double* dst = buf1;
    int s = 1;
    for (int k = 0; k < sweeps; ++k, s *= 2) {
        for (int i = threadIdx.x; i < T; i += blockDim.x)
            pcr::sweep_node<RHS>(src, dst, T, T, s, i);
        __syncthreads();
        double* t = src; src = dst; dst = t;
    }

    for (int i = threadIdx.x; i < T; i += blockDim.x) {
        const long long gi = base + i;
        const bool live = gi < n, first = i == 0, last = i == T - 1;
        if (!live && !last) continue;
        double x[2 * RHS];
        pcr::backsolve_node<RHS>(src, T, i, x);
        // V[row][col]: pair 1 is column 0, pair 2 column 1; W likewise
        const double v00 = x[2], v01 = x[4], v10 = x[3], v11 = x[5];
        const double w00 = x[6], w01 = x[8], w10 = x[7], w11 = x[9];
        if (live) {
            reinterpret_cast<double2*>(G)[gi] = make_double2(x[0], x[1]);
            reinterpret_cast<double2*>(V)[2 * gi] = make_double2(v00, v01);
            reinterpret_cast<double2*>(V)[2 * gi + 1] = make_double2(v10, v11);
            reinterpret_cast<double2*>(W)[2 * gi] = make_double2(w00, w01);
            reinterpret_cast<double2*>(W)[2 * gi + 1] = make_double2(w10, w11);
        }
        if (first || last) {
            // a padding node at the end of the last tile writes its zeros:
            // what the plain version's zero padding gives
            const int o = last ? 4 : 0, t = blockIdx.x;
            R[(R_LC + o + 0) * n_tiles + t] = v00;
            R[(R_LC + o + 1) * n_tiles + t] = v01;
            R[(R_LC + o + 2) * n_tiles + t] = v10;
            R[(R_LC + o + 3) * n_tiles + t] = v11;
            R[(R_UC + o + 0) * n_tiles + t] = w00;
            R[(R_UC + o + 1) * n_tiles + t] = w01;
            R[(R_UC + o + 2) * n_tiles + t] = w10;
            R[(R_UC + o + 3) * n_tiles + t] = w11;
            R[(R_R + o / 2 + 0) * n_tiles + t] = x[0];
            R[(R_R + o / 2 + 1) * n_tiles + t] = x[1];
        }
    }
}

// Solve A X = B in place for a 4x4 A and NC columns: Gaussian elimination
// with partial pivoting (the first largest |pivot| wins, as LAPACK's getrf),
// rows swapped by selects so that every index is known at compile time and
// the arrays stay in registers.  One reciprocal a pivot: a float64 division
// is a long instruction sequence on this card, and the row update is
// latency-bound.
template <int NC>
__device__ __forceinline__ void solve4(double (&A)[4][4], double (&X)[4][NC]) {
    double inv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        int p = k;
        double best = fabs(A[k][k]);
#pragma unroll
        for (int r = k + 1; r < 4; ++r) {
            const double v = fabs(A[r][k]);
            if (v > best) { best = v; p = r; }
        }
#pragma unroll
        for (int r = k + 1; r < 4; ++r) {
            const bool sw = p == r;
#pragma unroll
            for (int c = k; c < 4; ++c) {
                const double t = A[k][c];
                A[k][c] = sw ? A[r][c] : t;
                A[r][c] = sw ? t : A[r][c];
            }
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const double t = X[k][c];
                X[k][c] = sw ? X[r][c] : t;
                X[r][c] = sw ? t : X[r][c];
            }
        }
        inv[k] = 1.0 / A[k][k];
#pragma unroll
        for (int r = k + 1; r < 4; ++r) {
            const double f = A[r][k] * inv[k];
#pragma unroll
            for (int c = k + 1; c < 4; ++c) A[r][c] = A[r][c] - f * A[k][c];
#pragma unroll
            for (int c = 0; c < NC; ++c) X[r][c] = X[r][c] - f * X[k][c];
        }
    }
#pragma unroll
    for (int k = 3; k >= 0; --k) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            double v = X[k][c];
#pragma unroll
            for (int j = k + 1; j < 4; ++j) v = v - A[k][j] * X[j][c];
            X[k][c] = v * inv[k];
        }
    }
}

// Row i at stride s eliminates its neighbours i-s and i+s (rows outside
// [0, n) read as zero) and is renormalised, in place.
__device__ __forceinline__ void reduce_row(double* Rw, int n, int i, int s) {
    const int im = i - s, ip = i + s;
    const bool vm = im >= 0, vp = ip < n;
    double Lc[4][2], Uc[4][2], r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            Lc[q][c] = Rw[(R_LC + 2 * q + c) * n + i];
            Uc[q][c] = Rw[(R_UC + 2 * q + c) * n + i];
        }
        r[q] = Rw[(R_R + q) * n + i];
    }
    // the neighbours' halves that couple to row i: rows 2-3 of i-s (its last
    // node), rows 0-1 of i+s (its first node)
    double Lm[2][2], Um[2][2], rm[2], Lp[2][2], Up[2][2], rp[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            Lm[q][c] = vm ? Rw[(R_LC + 2 * (q + 2) + c) * n + im] : 0.0;
            Um[q][c] = vm ? Rw[(R_UC + 2 * (q + 2) + c) * n + im] : 0.0;
            Lp[q][c] = vp ? Rw[(R_LC + 2 * q + c) * n + ip] : 0.0;
            Up[q][c] = vp ? Rw[(R_UC + 2 * q + c) * n + ip] : 0.0;
        }
        rm[q] = vm ? Rw[(R_R + q + 2) * n + im] : 0.0;
        rp[q] = vp ? Rw[(R_R + q) * n + ip] : 0.0;
    }
    double A[4][4], X[4][5];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            A[q][c] = (q == c ? 1.0 : 0.0) - (Lc[q][0] * Um[0][c] + Lc[q][1] * Um[1][c]);
            A[q][c + 2] = (q == c + 2 ? 1.0 : 0.0) - (Uc[q][0] * Lp[0][c] + Uc[q][1] * Lp[1][c]);
            X[q][c] = -(Lc[q][0] * Lm[0][c] + Lc[q][1] * Lm[1][c]);
            X[q][c + 2] = -(Uc[q][0] * Up[0][c] + Uc[q][1] * Up[1][c]);
        }
        X[q][4] = (r[q] - (Lc[q][0] * rm[0] + Lc[q][1] * rm[1])) - (Uc[q][0] * rp[0] + Uc[q][1] * rp[1]);
    }
    solve4<5>(A, X);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            Rw[(R_LC + 2 * q + c) * n + i] = X[q][c];
            Rw[(R_UC + 2 * q + c) * n + i] = X[q][c + 2];
        }
        Rw[(R_R + q) * n + i] = X[q][4];
    }
}

// Back-substitution of row i at stride s: y_i from the solved rows i-s, i+s.
__device__ __forceinline__ void substitute_row(const double* Rw, double* y, int n, int i, int s) {
    const int im = i - s, ip = i + s;
    const bool vm = im >= 0, vp = ip < n;
    const double ym0 = vm ? y[4 * im + 2] : 0.0, ym1 = vm ? y[4 * im + 3] : 0.0;
    const double yp0 = vp ? y[4 * ip + 0] : 0.0, yp1 = vp ? y[4 * ip + 1] : 0.0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const double lc0 = Rw[(R_LC + 2 * q) * n + i], lc1 = Rw[(R_LC + 2 * q + 1) * n + i];
        const double uc0 = Rw[(R_UC + 2 * q) * n + i], uc1 = Rw[(R_UC + 2 * q + 1) * n + i];
        y[4 * i + q] = (Rw[(R_R + q) * n + i] - (lc0 * ym0 + lc1 * ym1)) - (uc0 * yp0 + uc1 * yp1);
    }
}

// Stage B: block cyclic reduction over the n reduced rows Rw [ROW, n] (updated
// in place) into y [n, 4].
__global__ void __launch_bounds__(B_THREADS) reduced_cr_kernel(double* Rw, double* y, int n) {
    int s = 1;
    for (; 2 * s <= n; s *= 2) {
        // rows i = 2s-1, 4s-1, ... below n
        for (int k = threadIdx.x; k < n / (2 * s); k += blockDim.x)
            reduce_row(Rw, n, (2 * k + 2) * s - 1, s);
        __syncthreads();
    }
    // the one row left, s-1, couples only outside [0, n): it is solved
    if (threadIdx.x < 4) y[4 * (s - 1) + threadIdx.x] = Rw[(R_R + threadIdx.x) * n + s - 1];
    __syncthreads();
    for (s /= 2; s >= 1; s /= 2) {
        // rows i = s-1, 3s-1, ... below n
        for (int k = threadIdx.x; k < (n - s) / (2 * s) + 1; k += blockDim.x)
            substitute_row(Rw, y, n, 2 * k * s + s - 1, s);
        __syncthreads();
    }
}

// Stage C: x = G - V x_prev_last - W x_next_first, one thread per node.
__global__ void __launch_bounds__(C_THREADS) substitute_kernel(
        const double* __restrict__ G, const double* __restrict__ V, const double* __restrict__ W,
        const double* __restrict__ y, double* __restrict__ x, long long n, int T, int n_tiles) {
    const long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (gi >= n) return;
    const int t = (int)(gi / T);
    const double pl0 = t > 0 ? y[4 * (t - 1) + 2] : 0.0, pl1 = t > 0 ? y[4 * (t - 1) + 3] : 0.0;
    const double nf0 = t < n_tiles - 1 ? y[4 * (t + 1) + 0] : 0.0;
    const double nf1 = t < n_tiles - 1 ? y[4 * (t + 1) + 1] : 0.0;
    const double2 g = reinterpret_cast<const double2*>(G)[gi];
    const double2 v0 = reinterpret_cast<const double2*>(V)[2 * gi];
    const double2 v1 = reinterpret_cast<const double2*>(V)[2 * gi + 1];
    const double2 w0 = reinterpret_cast<const double2*>(W)[2 * gi];
    const double2 w1 = reinterpret_cast<const double2*>(W)[2 * gi + 1];
    reinterpret_cast<double2*>(x)[gi] = make_double2(
        (g.x - (v0.x * pl0 + v0.y * pl1)) - (w0.x * nf0 + w0.y * nf1),
        (g.y - (v1.x * pl0 + v1.y * pl1)) - (w1.x * nf0 + w1.y * nf1));
}

}  // namespace

extern "C" int flowsim_tiled_reduced_row() { return ROW; }

// Stage A.  R: [ROW, n_tiles] doubles.
extern "C" int flowsim_tiled_spike(const void* L, const void* D, const void* U, const void* b,
                                   void* G, void* V, void* W, void* R, long long n, int tile,
                                   void* stream) {
    if (n <= 0 || tile < 2) return (int)cudaErrorInvalidValue;
    const long long n_tiles = (n + tile - 1) / tile;
    if (n_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(2 * COMP) * tile * sizeof(double);
    cudaError_t e = cudaFuncSetAttribute(tiled_spike_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int threads = ((tile + 31) / 32) * 32;
    if (threads > A_THREADS) threads = A_THREADS;
    tiled_spike_kernel<<<(unsigned)n_tiles, threads, smem, (cudaStream_t)stream>>>(
        (const double*)L, (const double*)D, (const double*)U, (const double*)b,
        (double*)G, (double*)V, (double*)W, (double*)R, n, tile, (int)n_tiles,
        pcr::n_sweeps(tile));
    return (int)cudaGetLastError();
}

// Stage B.  R: the rows stage A wrote, [ROW, n_rows], overwritten; y [n_rows, 4].
extern "C" int flowsim_tiled_reduced(void* R, void* y, int n_rows, void* stream) {
    if (n_rows <= 0) return (int)cudaErrorInvalidValue;
    reduced_cr_kernel<<<1, B_THREADS, 0, (cudaStream_t)stream>>>((double*)R, (double*)y, n_rows);
    return (int)cudaGetLastError();
}

// Stage C.  x [n, 2].
extern "C" int flowsim_tiled_substitute(const void* G, const void* V, const void* W, const void* y,
                                        void* x, long long n, int tile, void* stream) {
    if (n <= 0 || tile < 2) return (int)cudaErrorInvalidValue;
    const long long n_tiles = (n + tile - 1) / tile;
    const long long blocks = (n + C_THREADS - 1) / C_THREADS;
    if (n_tiles > 2147483647LL || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    substitute_kernel<<<(unsigned)blocks, C_THREADS, 0, (cudaStream_t)stream>>>(
        (const double*)G, (const double*)V, (const double*)W, (const double*)y, (double*)x, n, tile,
        (int)n_tiles);
    return (int)cudaGetLastError();
}
