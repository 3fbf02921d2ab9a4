// tiled_spike: stage A of the SPIKE long-reach solve, float64.
//
// Replaces flowsim_tpu/ops/pallas/tiled_pcr.py (_tiled_spike_kernel via
// tiled_spike_pallas): a 2x2-block tridiagonal system of any length N is cut
// into tiles of T nodes; every tile drops its couplings to the neighbour
// tiles and solves its local system for five right-hand-side pairs at once,
//
//     G = A_loc^-1 b,   V = A_loc^-1 (e_0 (x) L_ext),   W = A_loc^-1 (e_last (x) U_ext),
//
// L_ext / U_ext being the dropped blocks (the first node's L, the last
// node's U).  The wrapper (ops/cuda/tiled_pcr.py) then solves the small
// reduced system over the tile-boundary unknowns and substitutes back.
//
// What bounds it on an H100: the system is read once (14 doubles a node) and
// G, V, W are written once (10 doubles): 192 B a node, 57 us at N = 1e6 over
// 3.35 TB/s; the ceil(log2 T) sweeps of ~180 float64 operations a node come to
// about the same time at the card's FP64 rate, so the two limits lie close
// together and bytes is the larger.  The design keeps every sweep out of
// device memory: one thread block per tile (blockIdx.x = tile, tiles are
// independent, so the 132 SMs take them in any order), the tile's 12 matrix
// and 10 right-hand-side components held component-major in shared memory
// and ping-ponged between two buffers through pcr::sweep_node<5>, one block
// barrier per sweep.  That is 2 x 22 x 8 = 352 B a node: T = 512 takes
// 180 224 B of the 232 448 B a block may have (one block per SM), T <= 640
// fits.  A thread loops over its nodes, so the block has 256 threads whatever
// T is, and the launch bound of 256 leaves the five-pair sweep all the
// registers it wants.
//
// The kernel reads L, D, U [N, 2, 2] and b [N, 2] as the rest of the package
// lays them out (the TPU kernel's packed [16, Np] buffer is a vector-memory
// layout and is not carried over) and writes G [N, 2], V and W [N, 2, 2].
// Nodes past N in the last tile are identity-diagonal decoupled rows with a
// zero right-hand side; they take part in every sweep, so every tile runs
// the same ceil(log2 T) sweeps.
//
// Reached on an NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py):
// 0.353 ms at N = 1e6, T = 512 (1954 tiles), 6.2 times the bytes bound, 62
// registers and no spills; the plain sweeps it replaces take 46.5 ms there.
// The reduced system the wrapper solves afterwards takes far longer than
// this kernel today (PERF.md keeps the readings).
//
// C interface (ctypes): launches on the given stream, allocates nothing,
// does not synchronise, returns cudaGetLastError().
#include <cuda_runtime.h>

#include "pcr_common.cuh"

namespace {

constexpr int RHS = 5;
constexpr int COMP = pcr::components<RHS>();  // 22
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) tiled_spike_kernel(
        const double* __restrict__ L, const double* __restrict__ D,
        const double* __restrict__ U, const double* __restrict__ b,
        double* __restrict__ G, double* __restrict__ V, double* __restrict__ W,
        long long n, int T, int sweeps) {
    extern __shared__ double smem[];
    double* buf0 = smem;
    double* buf1 = smem + (size_t)COMP * T;
    const long long base = (long long)blockIdx.x * T;

    for (int i = threadIdx.x; i < T; i += blockDim.x) {
        const long long gi = base + i;
        const bool live = gi < n;
        double l[4], d[4], u[4], r[2];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            l[c] = live ? L[gi * 4 + c] : 0.0;
            d[c] = live ? D[gi * 4 + c] : ((c == 0 || c == 3) ? 1.0 : 0.0);
            u[c] = live ? U[gi * 4 + c] : 0.0;
        }
        r[0] = live ? b[gi * 2 + 0] : 0.0;
        r[1] = live ? b[gi * 2 + 1] : 0.0;
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
        buf0[12 * T + i] = r[0];
        buf0[13 * T + i] = r[1];
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
        if (gi >= n) continue;
        double x[2 * RHS];
        pcr::backsolve_node<RHS>(src, T, i, x);
        G[gi * 2 + 0] = x[0];
        G[gi * 2 + 1] = x[1];
        // V[row][col]: pair 1 is column 0, pair 2 column 1
        V[gi * 4 + 0] = x[2];
        V[gi * 4 + 1] = x[4];
        V[gi * 4 + 2] = x[3];
        V[gi * 4 + 3] = x[5];
        W[gi * 4 + 0] = x[6];
        W[gi * 4 + 1] = x[8];
        W[gi * 4 + 2] = x[7];
        W[gi * 4 + 3] = x[9];
    }
}

}  // namespace

extern "C" int flowsim_tiled_spike(const void* L, const void* D, const void* U, const void* b,
                                   void* G, void* V, void* W, long long n, int tile,
                                   void* stream) {
    if (n <= 0 || tile <= 0) return (int)cudaErrorInvalidValue;
    const long long n_tiles = (n + tile - 1) / tile;
    if (n_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(2 * COMP) * tile * sizeof(double);
    cudaError_t e = cudaFuncSetAttribute(tiled_spike_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    tiled_spike_kernel<<<(unsigned)n_tiles, THREADS, smem, (cudaStream_t)stream>>>(
        (const double*)L, (const double*)D, (const double*)U, (const double*)b,
        (double*)G, (double*)V, (double*)W, n, tile, pcr::n_sweeps(tile));
    return (int)cudaGetLastError();
}
