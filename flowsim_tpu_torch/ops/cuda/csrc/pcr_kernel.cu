// pcr_solve: one 2x2-block tridiagonal solve per thread block, float64.
//
// Replaces flowsim_tpu/ops/pallas/pcr_kernel.py (_pcr_kernel via pcr_pallas),
// the TPU kernel that keeps one whole system in on-chip memory across all
// ceil(log2 N) PCR sweeps.
//
// What bounds it on an H100: neither bytes nor flops.  One system is 14 N
// doubles in and 2 N out (14 KB at N = 121: nanoseconds at 3.35 TB/s) and
// ~150 flops per node and sweep; what costs time is latency: the host's path
// to the launch, then the dependent chain of sweeps, each ended by a
// block-wide barrier, run by a single block on one of the card's 132 SMs.
// The design therefore (a) keeps the system in shared memory, so a sweep never
// touches device memory; (b) maps blockIdx.x to the system, so independent
// systems (a batch) fill the other SMs for free; (c) up to CARRIED_MAX_N
// nodes runs sweep_node_carried of pcr_common.cuh (kernel 1's latency build
// shares it): the thread that forms a node's D' inverts it before the barrier
// and stores the inverse beside it (18 doubles a node a buffer), so a sweep
// inverts each node once instead of twice; (d) above that, the 14-component
// sweep_node, double buffered (224 B a node), and for N above the
// shared-memory capacity (N > 1000) the same block ping-pongs through a
// global scratch buffer the wrapper allocates, which stays in the 50 MB L2
// (8192 x 224 B = 1.8 MB).  Both paths give the same bits.  The host path is
// kept short: the dynamic shared-memory attribute is set once a process and
// device for the largest size seen, not on every call.  The TPU kernel's f32-only
// restriction is gone: the H100 has native FP64.
//
// Reached on an NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py,
// kernel table and --kernel2-times; PERF.md keeps the readings): at N = 121,
// the main path's shape, a few microseconds of device time inside a call of
// about 0.02 ms on the host's path.  Splitting a node's elimination over four
// threads of a warp (side and row each) ran slower than one thread a node:
// the shuffles and selects cost more issue slots than the shorter chain saved.
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
// The carried path (2 x 18 doubles a node of shared memory) up to CARRIED_MAX_N
// nodes, the largest size measured faster than the node path.
constexpr int CARRIED_MAX_N = 512;
enum { PATH_CHOOSE = -1, PATH_NODE = 0, PATH_CARRIED = 1 };

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

// one thread a node with the carried inverse (18 doubles a node a buffer)
__global__ void __launch_bounds__(MAX_THREADS) pcr_carried_kernel(const double* __restrict__ L,
                                 const double* __restrict__ D, const double* __restrict__ U,
                                 const double* __restrict__ b, double* __restrict__ x, int n, int sweeps) {
    extern __shared__ double smem[];
    const size_t sys = blockIdx.x;
    double* buf0 = smem;
    double* buf1 = buf0 + (size_t)pcr::CARRY_COMP * n;
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
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            if (k == 0) pcr::sweep_node_carried<false>(src, dst, n, n, s, i);
            else pcr::sweep_node_carried<true>(src, dst, n, n, s, i);
        }
        __syncthreads();
        double* t = src; src = dst; dst = t;
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        double sol[2];
        pcr::backsolve_carried(src, n, i, sol);
        xs[i * 2 + 0] = sol[0];
        xs[i * 2 + 1] = sol[1];
    }
}

// the dynamic shared memory each kernel's attribute allows so far on each
// device (the attribute belongs to the current device's context): set once a
// process and device, and again only for a larger size; a device past
// MAX_DEVICES sets it on every call
constexpr int MAX_DEVICES = 64;
int node_smem_set[MAX_DEVICES], carried_smem_set[MAX_DEVICES];

int allow_smem(const void* fn, int bytes, int* set_by_device) {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    int* set = dev < MAX_DEVICES ? set_by_device + dev : nullptr;
    if (set && bytes <= *set) return 0;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    if (set) *set = bytes;
    return 0;
}

}  // namespace

extern "C" int flowsim_pcr_carried_max_n() { return CARRIED_MAX_N; }

// path: -1 chooses (the carried path up to CARRIED_MAX_N nodes, else the node
// path), 0 or 1 forces one (a test hook: chip_smoke.py holds the two to the
// same bits and times them).
extern "C" int flowsim_pcr_solve(const void* L, const void* D, const void* U, const void* b,
                                 void* x, void* scratch, int n_sys, int n, int use_smem,
                                 int path, void* stream) {
    if (n_sys <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
    if (path == PATH_CHOOSE) path = (use_smem && n <= CARRIED_MAX_N) ? PATH_CARRIED : PATH_NODE;
    if (path == PATH_CARRIED) {
        if (!use_smem || n > CARRIED_MAX_N) return (int)cudaErrorInvalidValue;
        int threads = ((n + 31) / 32) * 32;
        if (threads > MAX_THREADS) threads = MAX_THREADS;
        const size_t smem = (size_t)(2 * pcr::CARRY_COMP) * n * sizeof(double);
        int rc = allow_smem((const void*)pcr_carried_kernel, (int)smem, carried_smem_set);
        if (rc) return rc;
        pcr_carried_kernel<<<n_sys, threads, smem, (cudaStream_t)stream>>>(
            (const double*)L, (const double*)D, (const double*)U, (const double*)b, (double*)x, n, pcr::n_sweeps(n));
        return (int)cudaGetLastError();
    }
    if (path != PATH_NODE) return (int)cudaErrorInvalidValue;
    int threads = ((n + 31) / 32) * 32;
    if (threads > MAX_THREADS) threads = MAX_THREADS;
    size_t smem = use_smem ? (size_t)(2 * COMP) * n * sizeof(double) : 0;
    int rc = allow_smem((const void*)pcr_solve_kernel, (int)smem, node_smem_set);
    if (rc) return rc;
    pcr_solve_kernel<<<n_sys, threads, smem, (cudaStream_t)stream>>>(
        (const double*)L, (const double*)D, (const double*)U, (const double*)b,
        (double*)x, (double*)scratch, n, pcr::n_sweeps(n), use_smem);
    return (int)cudaGetLastError();
}
