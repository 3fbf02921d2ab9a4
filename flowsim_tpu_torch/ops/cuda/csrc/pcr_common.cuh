// Shared 2x2-block parallel-cyclic-reduction device functions.
//
// Replaces flowsim_tpu/ops/pallas/pcr_common.py (pcr_reduce / pcr_backsolve),
// the sweep shared by every TPU kernel of the JAX package.  One source of
// truth for the PCR algebra of the CUDA kernels: pcr_kernel.cu (one system
// per block), fused_newton.cu (the in-simulation Newton solve: its buffers in
// shared memory, or in device memory for the long build) and tiled_pcr.cu
// (one tile per block, five right-hand-side pairs).
//
// The TPU version holds the system as rows of a [16, lanes] vector buffer and
// reaches neighbours i-s / i+s with lane rolls; being functional, each sweep
// builds a new buffer.  Here a node is a thread's loop index and neighbours
// are plain indexed reads, so a sweep MUST read one buffer and write another
// (an in-place sweep races), with a block barrier between sweeps: the caller
// ping-pongs two buffers and calls __syncthreads() after every sweep.
//
// Buffer layout: component-major, buf[c * ld + i] for node i, so consecutive
// threads touch consecutive addresses (no shared-memory bank conflicts,
// coalesced when the buffer lives in global memory).  Components: 0-3 L,
// 4-7 D, 8-11 U (2x2 blocks, row-major), then 2*RHS right-hand-side rows.
// Out-of-range neighbours read as identity for D and zero otherwise.
//
// The arithmetic mirrors ops/tridiag.py::_pcr_core operation for operation
// (same association, same tiny-pivot guard), so built with --fmad=false the
// kernels agree with the plain PyTorch version to rounding.
#pragma once

namespace pcr {

constexpr double PIVOT_EPS = 1e-250;  // float64 guard of ops/tridiag.py

template <int RHS>
constexpr int components() { return 12 + 2 * RHS; }

__device__ __forceinline__ void inv2(double a, double b, double c, double d,
                                     double& i00, double& i01, double& i10, double& i11) {
    double det = a * d - b * c;
    if (!(fabs(det) > PIVOT_EPS)) det = (det >= 0.0) ? PIVOT_EPS : -PIVOT_EPS;
    const double inv = 1.0 / det;
    i00 = d * inv;
    i01 = -b * inv;
    i10 = -c * inv;
    i11 = a * inv;
}

// One PCR sweep at stride s for node i: reads src (own node and i-s, i+s),
// writes every component of node i into dst.
template <int RHS>
__device__ __forceinline__ void sweep_node(const double* __restrict__ src,
                                           double* __restrict__ dst,
                                           int ld, int n, int s, int i) {
    const int im = i - s, ip = i + s;
    const bool vm = im >= 0, vp = ip < n;
#define PCR_OWN(c) src[(c) * ld + i]
#define PCR_M(c, dflt) (vm ? src[(c) * ld + im] : (dflt))
#define PCR_P(c, dflt) (vp ? src[(c) * ld + ip] : (dflt))
    const double l00 = PCR_OWN(0), l01 = PCR_OWN(1), l10 = PCR_OWN(2), l11 = PCR_OWN(3);
    const double u00 = PCR_OWN(8), u01 = PCR_OWN(9), u10 = PCR_OWN(10), u11 = PCR_OWN(11);

    double mi00, mi01, mi10, mi11, pi00, pi01, pi10, pi11;
    inv2(PCR_M(4, 1.0), PCR_M(5, 0.0), PCR_M(6, 0.0), PCR_M(7, 1.0), mi00, mi01, mi10, mi11);
    inv2(PCR_P(4, 1.0), PCR_P(5, 0.0), PCR_P(6, 0.0), PCR_P(7, 1.0), pi00, pi01, pi10, pi11);

    // a = -L @ inv(D[i-s]);  c = -U @ inv(D[i+s])
    const double a00 = -(l00 * mi00 + l01 * mi10);
    const double a01 = -(l00 * mi01 + l01 * mi11);
    const double a10 = -(l10 * mi00 + l11 * mi10);
    const double a11 = -(l10 * mi01 + l11 * mi11);
    const double c00 = -(u00 * pi00 + u01 * pi10);
    const double c01 = -(u00 * pi01 + u01 * pi11);
    const double c10 = -(u10 * pi00 + u11 * pi10);
    const double c11 = -(u10 * pi01 + u11 * pi11);

    {   // L' = a @ L[i-s]
        const double m00 = PCR_M(0, 0.0), m01 = PCR_M(1, 0.0), m10 = PCR_M(2, 0.0), m11 = PCR_M(3, 0.0);
        dst[0 * ld + i] = a00 * m00 + a01 * m10;
        dst[1 * ld + i] = a00 * m01 + a01 * m11;
        dst[2 * ld + i] = a10 * m00 + a11 * m10;
        dst[3 * ld + i] = a10 * m01 + a11 * m11;
    }
    {   // U' = c @ U[i+s]
        const double p00 = PCR_P(8, 0.0), p01 = PCR_P(9, 0.0), p10 = PCR_P(10, 0.0), p11 = PCR_P(11, 0.0);
        dst[8 * ld + i] = c00 * p00 + c01 * p10;
        dst[9 * ld + i] = c00 * p01 + c01 * p11;
        dst[10 * ld + i] = c10 * p00 + c11 * p10;
        dst[11 * ld + i] = c10 * p01 + c11 * p11;
    }
    {   // D' = (D + a @ U[i-s]) + c @ L[i+s]
        const double m00 = PCR_M(8, 0.0), m01 = PCR_M(9, 0.0), m10 = PCR_M(10, 0.0), m11 = PCR_M(11, 0.0);
        const double p00 = PCR_P(0, 0.0), p01 = PCR_P(1, 0.0), p10 = PCR_P(2, 0.0), p11 = PCR_P(3, 0.0);
        dst[4 * ld + i] = (PCR_OWN(4) + (a00 * m00 + a01 * m10)) + (c00 * p00 + c01 * p10);
        dst[5 * ld + i] = (PCR_OWN(5) + (a00 * m01 + a01 * m11)) + (c00 * p01 + c01 * p11);
        dst[6 * ld + i] = (PCR_OWN(6) + (a10 * m00 + a11 * m10)) + (c10 * p00 + c11 * p10);
        dst[7 * ld + i] = (PCR_OWN(7) + (a10 * m01 + a11 * m11)) + (c10 * p01 + c11 * p11);
    }
#pragma unroll
    for (int r = 0; r < RHS; ++r) {  // b' = (b + a @ b[i-s]) + c @ b[i+s]
        const int c0 = 12 + 2 * r, c1 = c0 + 1;
        const double m0 = PCR_M(c0, 0.0), m1 = PCR_M(c1, 0.0);
        const double p0 = PCR_P(c0, 0.0), p1 = PCR_P(c1, 0.0);
        dst[c0 * ld + i] = (PCR_OWN(c0) + (a00 * m0 + a01 * m1)) + (c00 * p0 + c01 * p1);
        dst[c1 * ld + i] = (PCR_OWN(c1) + (a10 * m0 + a11 * m1)) + (c10 * p0 + c11 * p1);
    }
#undef PCR_OWN
#undef PCR_M
#undef PCR_P
}

// One sweep over several nodes a thread: sweep_node for the nodes first,
// first + step, ... below n, in that order.  The long build of
// fused_newton.cu runs it on buffers in device memory (a thread of its
// 1024-thread block owns up to eight nodes); the caller's barrier after the
// sweep, __syncthreads(), makes the writes visible to the block.
template <int RHS>
__device__ __forceinline__ void sweep_nodes(const double* src, double* dst, int ld, int n, int s, int first,
                                            int step) {
    for (int i = first; i < n; i += step) sweep_node<RHS>(src, dst, ld, n, s, i);
}

// Diagonal solve of the fully reduced system at node i: x = inv(D) @ b for
// every RHS pair; x holds 2*RHS values.
template <int RHS>
__device__ __forceinline__ void backsolve_node(const double* __restrict__ buf, int ld, int i,
                                               double* __restrict__ x) {
    double i00, i01, i10, i11;
    inv2(buf[4 * ld + i], buf[5 * ld + i], buf[6 * ld + i], buf[7 * ld + i], i00, i01, i10, i11);
#pragma unroll
    for (int r = 0; r < RHS; ++r) {
        const double b0 = buf[(12 + 2 * r) * ld + i], b1 = buf[(13 + 2 * r) * ld + i];
        x[2 * r] = i00 * b0 + i01 * b1;
        x[2 * r + 1] = i10 * b0 + i11 * b1;
    }
}

// -- the carried inverse (one right-hand-side pair) ---------------------------
//
// A buffer of these sweeps has four more components, inv(D)
// (INV_COMP..INV_COMP+3, row-major).  The thread that forms a node's new D'
// also inverts it, before the barrier, and stores both; the next sweep reads
// inv(D[i-s]) and inv(D[i+s]) instead of inverting them, and the
// back-substitution reads inv(D) of the last.  One inversion per node and
// sweep instead of two; inv2 of the same D gives the same bits.  The first
// sweep (CARRIED = false) inverts as sweep_node does, since its rows of D come
// from the assembly.  sweep_node_carried (kernel 1's latency build, kernel 2
// up to its CARRIED_MAX_N nodes) is sweep_node with the inverse carried.
// Splitting a sweep's two sides over two lanes a node was slower on the H100
// (the shuffles and selects cost more issue slots than the shorter chain
// saved) and was dropped.
constexpr int INV_COMP = 14;
constexpr int CARRY_COMP = 18;   // components of a carried-inverse buffer

// sweep_node<1> with the carried inverse, one thread a node: the same
// arithmetic, inv(D[i-s]) and inv(D[i+s]) read from src (CARRIED) or formed
// (the first sweep), and inv(D') formed once and stored beside D'.
template <bool CARRIED>
__device__ __forceinline__ void sweep_node_carried(const double* __restrict__ src, double* __restrict__ dst,
                                                   int ld, int n, int s, int i) {
    const int im = i - s, ip = i + s;
    const bool vm = im >= 0, vp = ip < n;
#define PCR_OWN(c) src[(c) * ld + i]
#define PCR_M(c, dflt) (vm ? src[(c) * ld + im] : (dflt))
#define PCR_P(c, dflt) (vp ? src[(c) * ld + ip] : (dflt))
    const double l00 = PCR_OWN(0), l01 = PCR_OWN(1), l10 = PCR_OWN(2), l11 = PCR_OWN(3);
    const double u00 = PCR_OWN(8), u01 = PCR_OWN(9), u10 = PCR_OWN(10), u11 = PCR_OWN(11);
    double mi00, mi01, mi10, mi11, pi00, pi01, pi10, pi11;
    if (CARRIED) {
        double e00, e01, e10, e11;
        inv2(1.0, 0.0, 0.0, 1.0, e00, e01, e10, e11);
        mi00 = PCR_M(INV_COMP + 0, e00); mi01 = PCR_M(INV_COMP + 1, e01);
        mi10 = PCR_M(INV_COMP + 2, e10); mi11 = PCR_M(INV_COMP + 3, e11);
        pi00 = PCR_P(INV_COMP + 0, e00); pi01 = PCR_P(INV_COMP + 1, e01);
        pi10 = PCR_P(INV_COMP + 2, e10); pi11 = PCR_P(INV_COMP + 3, e11);
    } else {
        inv2(PCR_M(4, 1.0), PCR_M(5, 0.0), PCR_M(6, 0.0), PCR_M(7, 1.0), mi00, mi01, mi10, mi11);
        inv2(PCR_P(4, 1.0), PCR_P(5, 0.0), PCR_P(6, 0.0), PCR_P(7, 1.0), pi00, pi01, pi10, pi11);
    }
    const double a00 = -(l00 * mi00 + l01 * mi10);
    const double a01 = -(l00 * mi01 + l01 * mi11);
    const double a10 = -(l10 * mi00 + l11 * mi10);
    const double a11 = -(l10 * mi01 + l11 * mi11);
    const double c00 = -(u00 * pi00 + u01 * pi10);
    const double c01 = -(u00 * pi01 + u01 * pi11);
    const double c10 = -(u10 * pi00 + u11 * pi10);
    const double c11 = -(u10 * pi01 + u11 * pi11);
    {
        const double m00 = PCR_M(0, 0.0), m01 = PCR_M(1, 0.0), m10 = PCR_M(2, 0.0), m11 = PCR_M(3, 0.0);
        dst[0 * ld + i] = a00 * m00 + a01 * m10;
        dst[1 * ld + i] = a00 * m01 + a01 * m11;
        dst[2 * ld + i] = a10 * m00 + a11 * m10;
        dst[3 * ld + i] = a10 * m01 + a11 * m11;
    }
    {
        const double p00 = PCR_P(8, 0.0), p01 = PCR_P(9, 0.0), p10 = PCR_P(10, 0.0), p11 = PCR_P(11, 0.0);
        dst[8 * ld + i] = c00 * p00 + c01 * p10;
        dst[9 * ld + i] = c00 * p01 + c01 * p11;
        dst[10 * ld + i] = c10 * p00 + c11 * p10;
        dst[11 * ld + i] = c10 * p01 + c11 * p11;
    }
    const double m00 = PCR_M(8, 0.0), m01 = PCR_M(9, 0.0), m10 = PCR_M(10, 0.0), m11 = PCR_M(11, 0.0);
    const double p00 = PCR_P(0, 0.0), p01 = PCR_P(1, 0.0), p10 = PCR_P(2, 0.0), p11 = PCR_P(3, 0.0);
    const double d00 = (PCR_OWN(4) + (a00 * m00 + a01 * m10)) + (c00 * p00 + c01 * p10);
    const double d01 = (PCR_OWN(5) + (a00 * m01 + a01 * m11)) + (c00 * p01 + c01 * p11);
    const double d10 = (PCR_OWN(6) + (a10 * m00 + a11 * m10)) + (c10 * p00 + c11 * p10);
    const double d11 = (PCR_OWN(7) + (a10 * m01 + a11 * m11)) + (c10 * p01 + c11 * p11);
    double i00, i01, i10, i11;
    inv2(d00, d01, d10, d11, i00, i01, i10, i11);
    dst[4 * ld + i] = d00; dst[5 * ld + i] = d01; dst[6 * ld + i] = d10; dst[7 * ld + i] = d11;
    dst[(INV_COMP + 0) * ld + i] = i00; dst[(INV_COMP + 1) * ld + i] = i01;
    dst[(INV_COMP + 2) * ld + i] = i10; dst[(INV_COMP + 3) * ld + i] = i11;
    const double mb0 = PCR_M(12, 0.0), mb1 = PCR_M(13, 0.0);
    const double pb0 = PCR_P(12, 0.0), pb1 = PCR_P(13, 0.0);
    dst[12 * ld + i] = (PCR_OWN(12) + (a00 * mb0 + a01 * mb1)) + (c00 * pb0 + c01 * pb1);
    dst[13 * ld + i] = (PCR_OWN(13) + (a10 * mb0 + a11 * mb1)) + (c10 * pb0 + c11 * pb1);
#undef PCR_OWN
#undef PCR_M
#undef PCR_P
}

// backsolve_node with the carried inverse: x = inv(D) b at node i
__device__ __forceinline__ void backsolve_carried(const double* __restrict__ buf, int ld, int i,
                                                  double* __restrict__ x) {
    const double b0 = buf[12 * ld + i], b1 = buf[13 * ld + i];
    x[0] = buf[(INV_COMP + 0) * ld + i] * b0 + buf[(INV_COMP + 1) * ld + i] * b1;
    x[1] = buf[(INV_COMP + 2) * ld + i] * b0 + buf[(INV_COMP + 3) * ld + i] * b1;
}

__host__ __device__ inline int n_sweeps(int n) {
    int k = 0;
    while ((1 << k) < n) ++k;   // ceil(log2 n)
    return k < 1 ? 1 : k;
}

}  // namespace pcr
