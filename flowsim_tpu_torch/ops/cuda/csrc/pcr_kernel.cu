// pcr_solve: one 2x2-block tridiagonal solve per thread block, float64.
//
// Replaces flowsim_tpu/ops/pallas/pcr_kernel.py (_pcr_kernel via pcr_pallas),
// the TPU kernel that keeps one whole system in on-chip memory across all
// ceil(log2 N) PCR sweeps.
//
// What bounds it on an H100: neither bytes nor flops.  One system is 14 N
// doubles in and 2 N out (14 KB at N = 121: nanoseconds at 3.35 TB/s) and
// ~150 flops per node and sweep; what costs time is the dependent chain of
// sweeps, each ended by a block-wide barrier, run by a single block on one of
// the card's 132 SMs — launch latency plus ceil(log2 N) barrier-separated
// steps.  The design therefore (a) keeps the system in shared memory, double
// buffered (2 x 14 doubles = 224 B per node), so a sweep never touches device
// memory; (b) maps blockIdx.x to the system, so independent systems (a batch)
// fill the other SMs for free; (c) for N above the shared-memory capacity
// (N > 1000) ping-pongs the same block through a global scratch buffer the
// wrapper allocates, which stays in the 50 MB L2 (8192 x 224 B = 1.8 MB).
// The TPU kernel's f32-only restriction is gone: the H100 has native FP64.
//
// C interface (ctypes): launches on the given stream, allocates nothing,
// does not synchronise, returns cudaGetLastError().
#include <cuda_runtime.h>

#include "pcr_common.cuh"

namespace {

constexpr int COMP = pcr::components<1>();  // 14
// A sweep keeps ~70 registers live per thread; 512 threads leave it that
// budget (1024 would cap it at 64 and spill).  A thread loops over its nodes
// i, i + blockDim, ... so any N runs with any block size.
constexpr int MAX_THREADS = 512;

__global__ void __launch_bounds__(MAX_THREADS) pcr_solve_kernel(const double* __restrict__ L, const double* __restrict__ D,
                                 const double* __restrict__ U, const double* __restrict__ b,
                                 double* __restrict__ x, double* __restrict__ scratch,
                                 int n, int sweeps, int use_smem) {
    extern __shared__ double smem[];
    const size_t sys = blockIdx.x;
    double* buf0 = use_smem ? smem : scratch + sys * (size_t)(2 * COMP) * n;
    double* buf1 = buf0 + (size_t)COMP * n;
    const double* Ls = L + sys * (size_t)n * 4;
    const double* Ds = D + sys * (size_t)n * 4;
    const double* Us = U + sys * (size_t)n * 4;
    const double* bs = b + sys * (size_t)n * 2;
    double* xs = x + sys * (size_t)n * 2;

    for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            buf0[(0 + c) * n + i] = Ls[i * 4 + c];
            buf0[(4 + c) * n + i] = Ds[i * 4 + c];
            buf0[(8 + c) * n + i] = Us[i * 4 + c];
        }
        buf0[12 * n + i] = bs[i * 2 + 0];
        buf0[13 * n + i] = bs[i * 2 + 1];
    }
    __syncthreads();

    double* src = buf0;
    double* dst = buf1;
    int s = 1;
    for (int k = 0; k < sweeps; ++k, s *= 2) {
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            pcr::sweep_node<1>(src, dst, n, n, s, i);
        __syncthreads();
        double* t = src; src = dst; dst = t;
    }

    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        double sol[2];
        pcr::backsolve_node<1>(src, n, i, sol);
        xs[i * 2 + 0] = sol[0];
        xs[i * 2 + 1] = sol[1];
    }
}

}  // namespace

extern "C" int flowsim_pcr_solve(const void* L, const void* D, const void* U, const void* b,
                                 void* x, void* scratch, int n_sys, int n, int use_smem,
                                 void* stream) {
    if (n_sys <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
    int threads = ((n + 31) / 32) * 32;
    if (threads > MAX_THREADS) threads = MAX_THREADS;
    size_t smem = use_smem ? (size_t)(2 * COMP) * n * sizeof(double) : 0;
    cudaError_t e = cudaFuncSetAttribute(pcr_solve_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    pcr_solve_kernel<<<n_sys, threads, smem, (cudaStream_t)stream>>>(
        (const double*)L, (const double*)D, (const double*)U, (const double*)b,
        (double*)x, (double*)scratch, n, pcr::n_sweeps(n), use_smem);
    return (int)cudaGetLastError();
}
