// fused_simulate_network: a whole river-network simulation in one launch, and
// fused_simulate_network_batched: M such simulations (ensemble members) in one
// launch, one thread block per member.
//
// Replaces flowsim_tpu/ops/pallas/fused_network.py (_kernel_network via
// _build_call_network / fused_simulate_network, and _kernel_network_batched
// via _build_call_network_batched / fused_simulate_network_batched): for each
// time level — pad re-sync, gate-controller update, previous-level state —
// a while-Newton over the whole network: every branch's closures, cell
// residuals and Jacobian with equal-stage rows at its junction ends, one PCR
// solve per branch for 1 + its junction couplings right-hand sides, the
// junction residuals, the J x J Schur system and its solve, then every
// branch's increment.  The loop ends on the PRE-update residual norm with
// that iteration's update still applied.
//
// It computes what the stacked engine of ops/network.py computes (that engine
// with linear_solver="pcr" is its plain version): every branch edge-padded to
// the longest length Nmax, pad cells carrying delta-copy equations
// (dh_{i+1} = dh_i, dQ_{i+1} = dQ_i, no residual), so the padded end Nmax-1
// mirrors each branch's real end and external rows and junction couplings sit
// at node 0 and Nmax-1 of every branch.  Pads are re-synced to their branch's
// end at every level start.
//
// What bounds it on an H100: latency, as for the single reach (fused_newton.cu):
// the iterations are sequential and each is a chain of barrier-separated
// steps — closures, assembly with the residual reduction, ceil(log2 Nmax) PCR
// sweeps, back-substitution, Schur assembly, the J x J solve, update.  So:
//
//  * ONE thread block per network; slot s = b * Nmax + i is (branch, node),
//    and a thread owns the same slots in every step and every level;
//  * all state lives in shared memory, float64: h and Q, the level-start h,
//    Q, A, Se and Q2A, the lateral-inflow cell averages of the level, and two
//    component-major PCR buffers of 12 + 2 RHS doubles a slot (RHS = 1 + the
//    most couplings of a branch: 2 or 3); the second buffer is the
//    neighbour-exchange area of the closures during assembly and receives the
//    solution columns after the back-substitution.  44 doubles a slot at
//    RHS = 3: about 650 slots fit the 227 KB of a block; the wrapper refuses
//    a network that does not fit and names the stacked engine with cuda_pcr;
//  * the PCR is pcr_common.cuh's sweep on each branch's Nmax segment of the
//    buffers (neighbours outside the segment read as identity rows), so every
//    branch takes the same ceil(log2 Nmax) sweeps, one barrier each;
//  * junction rows: G_j and dQ_out/dY go to threads that own no slot when
//    there are J of them (else to threads 0..J-1), so they do not lengthen an
//    end slot's thread.  The Schur row of junction j is formed from the end
//    values of the solution columns in the stacked engine's order (branches
//    in order, downstream end first) and solved by Gauss-Jordan elimination
//    with partial pivoting (the plain version's torch.linalg.solve is an LU
//    with partial pivoting: the two agree to rounding).  J = 1: every thread
//    forms the 1 x 1 system itself and reads its own dY, with no barrier;
//    J <= 32: lane j of warp 0 forms row j and warp 0 solves, one barrier;
//    J > 32: every thread forms rows, a barrier, warp 0 solves, a barrier;
//  * the residual norm is one block reduction over the real cells, the end
//    rows and the junction rows only (pads are not added, not multiplied by
//    zero); every thread reads the same sum, so the Newton while exits
//    uniformly;
//  * blockIdx.x is the member: each member has its own geometry, initial
//    state, boundary series and parameters, storage blocks and tables,
//    lateral inflow and initial junction stages; the branch layout, the
//    boundary kinds and the junction configuration are shared.  A member's
//    per-level counts are those of its single run, and a member that diverges
//    holds up no other.
//
// Builds, which run when, and why (chosen by the C entry):
//  * the LATENCY build, for a network whose slots fit the block (slots <=
//    256: the tributary's 183, the 15-branch basin's 195) and a batch the
//    card holds at once in it (single networks, small ensembles): a thread
//    owns one slot for the whole run and keeps its geometry, branch and node
//    index, previous-level state and this iteration's closures in registers,
//    as kernel 1 does; nothing is reloaded from the geometry rows inside the
//    Newton loop and the end rows reuse the iteration's closures;
//  * the LOOP build, for a network with more slots than threads (the basin at
//    levels=5: 403): the threads loop over the slots, the geometry is read
//    from device memory (L1) where it is needed;
//  * the RESIDENCY build, for a network whose slots fit the block and a
//    batch larger than the card holds at once in the latency build (one
//    block an SM: 204-255 registers): the latency build's form under
//    __launch_bounds__(threads, 2), which caps the registers (and spills the
//    rest) so that two blocks share an SM, twice the members in flight.
//    Three blocks an SM ran no faster, and the loop form under the same cap
//    slower (PERF.md); a network with more slots than threads has no
//    residency build.
//  Every build does the same operations in the same order and gives the
//  same bits; the build id of the C entry is a test hook for chip_smoke.py.
//  The probe build (PROBE, reach_common.cuh) of the loop and latency forms
//  sums the cycles of each phase of an iteration.
//
// Dropped from the TPU kernel, which needs them only for the TPU: double-single
// (df32) arithmetic and the f32 Jacobian (the card has FP64), one-hot sublane
// scatters and gathers for the Schur assembly, the level streamer, the
// data-derived zeros, the VMEM member cap.
//
// External ends take every kind kernel 1 takes (boundary_row / storage_row of
// reach_common.cuh: hydrographs, fixed and normal depth, polynomial and
// blended ratings, the gated controller downstream, lumped storage at either
// end or both).  Junction ratings: polynomial, blended_poly, poly_n, power and
// table, with ops/rating_curve.py's formulas (central difference for the
// blended and table slopes, analytic otherwise).
//
// Float64 throughout; the expressions and their association are the plain
// engine's, built with --fmad=false.
//
// C interface (ctypes): launches on the given stream, allocates nothing, does
// not synchronise, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math_constants.h>

#include "pcr_common.cuh"
#include "reach_common.cuh"

namespace {

// per-branch ints [B, BI_COUNT]; a junction end holds its id, an external
// end -1
enum { BI_N, BI_US_J, BI_DS_J, BI_US_KIND, BI_DS_KIND, BI_RC_KIND, BI_URC_KIND,
       BI_US_SFLAGS, BI_DS_SFLAGS, BI_US_NV, BI_US_NA, BI_DS_NV, BI_DS_NA, BI_TAB_OFF, BI_COUNT };

// per-junction parameters [J, JP_COUNT]: reservoir area, rating kind (JR_*),
// stage shift, pivot, buffer, finite-difference step, the low and high
// quadratics (power: a, b in C0, C1), and the count and offset of poly_n
// coefficients (ascending) or of a table (stages then discharges) in jtab
enum { JP_AREA, JP_KIND, JP_SHIFT, JP_PIVOT, JP_BUFFER, JP_FD, JP_C0, JP_C1, JP_C2,
       JP_H0, JP_H1, JP_H2, JP_NCOEF, JP_OFF, JP_COUNT };
enum { JR_NONE = -1, JR_POLY = 0, JR_BLEND = 1, JR_POLY_N = 2, JR_POWER = 3, JR_TABLE = 4 };

constexpr int MAX_THREADS = 256;
constexpr int MAX_JUNCTION_ENDS = 8;   // a longer list is scanned from the branch table
constexpr int STATE_DOUBLES_PER_SLOT = 8;   // h, Q, hp, Qp, Ap, Sep, Q2Ap, qavg

__host__ __device__ constexpr int comp(int rhs) { return 12 + 2 * rhs; }

__host__ __device__ inline size_t smem_doubles(int slots, int B, int J, int rhs) {
    return (size_t)slots * (2 * comp(rhs) + STATE_DOUBLES_PER_SLOT) + (size_t)J * (J + 6) + 4 * (size_t)B;
}

// -- ops/rating_curve.py at a junction ---------------------------------------

// rating_curve._interp: linear interpolation, the end values held outside
__device__ double table_q(const double* __restrict__ xp, const double* __restrict__ fp, int n, double x) {
    int lo = 0, hi = n;   // searchsorted(right=True): entries <= x
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (xp[mid] <= x) lo = mid + 1; else hi = mid;
    }
    int i = lo - 1;
    i = i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
    const double x0 = xp[i], x1 = xp[i + 1], f0 = fp[i], f1 = fp[i + 1];
    double val = f0 + (x - x0) * (f1 - f0) / (x1 - x0);
    if (x <= xp[0]) val = fp[0];
    if (x >= xp[n - 1]) val = fp[n - 1];
    return val;
}

__device__ double junction_q(const double* __restrict__ jp, const double* __restrict__ jtab, double Y) {
    const int kind = (int)jp[JP_KIND];
    if (kind == JR_POLY) {
        const double x = Y + jp[JP_SHIFT];
        return jp[JP_C0] * x * x + jp[JP_C1] * x + jp[JP_C2];
    }
    if (kind == JR_BLEND) {
        Rating r{jp[JP_C0], jp[JP_C1], jp[JP_C2], jp[JP_H0], jp[JP_H1], jp[JP_H2], 0.0, jp[JP_PIVOT],
                 jp[JP_BUFFER], jp[JP_FD], 0.0, RC_BLEND};
        return rating_q(r, Y, 0.0);
    }
    const int n = (int)jp[JP_NCOEF];
    const double* c = jtab + (int)jp[JP_OFF];
    if (kind == JR_POLY_N) {   // Horner, coefficients ascending
        const double x = Y + jp[JP_SHIFT];
        double out = c[n - 1];
        for (int j = n - 2; j >= 0; --j) out = out * x + c[j];
        return out;
    }
    if (kind == JR_POWER) return jp[JP_C0] * pow(Y + jp[JP_SHIFT], jp[JP_C1]);
    if (kind == JR_TABLE) return table_q(c, c + n, n, Y);
    return 0.0;
}

__device__ double junction_dq(const double* __restrict__ jp, const double* __restrict__ jtab, double Y) {
    const int kind = (int)jp[JP_KIND];
    if (kind == JR_POLY) {
        const double x = Y + jp[JP_SHIFT];
        return jp[JP_C0] * 2.0 * x + jp[JP_C1];
    }
    if (kind == JR_POLY_N) {   // the derivative's ascending coefficients c[j+1] * (j+1)
        const int n = (int)jp[JP_NCOEF];
        const double* c = jtab + (int)jp[JP_OFF];
        if (n < 2) return 0.0;
        const double x = Y + jp[JP_SHIFT];
        double out = c[n - 1] * (double)(n - 1);
        for (int j = n - 3; j >= 0; --j) out = out * x + c[j + 1] * (double)(j + 1);
        return out;
    }
    if (kind == JR_POWER) {
        const double x = Y + jp[JP_SHIFT];
        return jp[JP_C0] * jp[JP_C1] * pow(x, jp[JP_C1] - 1.0);
    }
    if (kind == JR_BLEND || kind == JR_TABLE) {
        const double d = jp[JP_FD];
        return (junction_q(jp, jtab, Y + d) - junction_q(jp, jtab, Y - d)) / (2.0 * d);
    }
    return 0.0;
}

// Gauss-Jordan elimination with partial pivoting of the J x J system
// M x = rhs (shared memory, row-major) by one warp; every lane calls it and
// x goes to x.  Lane 0 picks the pivot of column c (the first row from c on
// of largest |entry|) and swaps the rows; lane r reduces row r.  Each row is
// reduced in groups of four entries, all loads of a group before its stores,
// so that the loads overlap (row c is never written in the step).
__device__ void warp_gauss_jordan(double* M, double* rhs, double* x, int J, int lane) {
    for (int c = 0; c < J; ++c) {
        if (lane == 0) {
            int p = c;
            double best = fabs(M[(size_t)c * J + c]);
            for (int r = c + 1; r < J; ++r) {
                const double v = fabs(M[(size_t)r * J + c]);
                if (v > best) { best = v; p = r; }
            }
            if (p != c) {
                for (int q = 0; q < J; ++q) {
                    const double t = M[(size_t)c * J + q];
                    M[(size_t)c * J + q] = M[(size_t)p * J + q];
                    M[(size_t)p * J + q] = t;
                }
                const double t = rhs[c]; rhs[c] = rhs[p]; rhs[p] = t;
            }
        }
        __syncwarp();
        const double piv = M[(size_t)c * J + c];
        const double* mc = M + (size_t)c * J;
        for (int r = lane; r < J; r += 32) {
            if (r == c) continue;
            double* mr = M + (size_t)r * J;
            const double f = mr[c] / piv;
            int q = c;
            for (; q + 4 <= J; q += 4) {
                const double c0 = mc[q], c1 = mc[q + 1], c2 = mc[q + 2], c3 = mc[q + 3];
                const double r0 = mr[q], r1 = mr[q + 1], r2 = mr[q + 2], r3 = mr[q + 3];
                mr[q] = r0 - f * c0; mr[q + 1] = r1 - f * c1; mr[q + 2] = r2 - f * c2; mr[q + 3] = r3 - f * c3;
            }
            for (; q < J; ++q) mr[q] -= f * mc[q];
            rhs[r] -= f * rhs[c];
        }
        __syncwarp();
    }
    for (int r = lane; r < J; r += 32) x[r] = rhs[r] / M[(size_t)r * J + r];
}

__device__ __forceinline__ Geo load_geo(const double* __restrict__ geo, int n_max, int b, int i) {
    const double* r = geo + (size_t)b * G_ROWS * n_max + i;
    Geo g;
    g.z = r[G_ZBED * n_max];       g.b = r[G_BMAIN * n_max];
    g.m = r[G_MMAIN * n_max];      g.n = r[G_NMAIN * n_max];
    g.compound = r[G_COMPOUND * n_max] != 0.0;
    g.hbank = r[G_HBANK * n_max];  g.bl = r[G_BFPL * n_max];
    g.br = r[G_BFPR * n_max];      g.mfp = r[G_MFP * n_max];
    g.nl = r[G_NLEFT * n_max];     g.nr = r[G_NRIGHT * n_max];
    g.s0 = r[G_BEDSLOPE * n_max];  g.curv = r[G_CURV * n_max];
    return g;
}

// Builds (the header says which runs when).  LOOP: the block's threads loop
// over the slots.  LATENCY (slots <= threads): a thread owns one slot for the
// whole run.  RESIDENCY: the latency build's form under a launch bound that
// caps the registers so that two blocks fit an SM.
enum { LOOP_BUILD = 0, LATENCY_BUILD = 1, RESIDENCY_BUILD = 2 };

// ONE: the latency build's one slot a thread (needs slots <= blockDim.x).
// PROBE: the probe build (reach_common.cuh, Probe).
template <int RHS, int BLOCK, int MINB, bool ONE, bool PROBE>
__global__ void __launch_bounds__(BLOCK, MINB)
fused_network_kernel(const double* __restrict__ geo_all,   // [M, B, 13, Nmax]
                     const double* __restrict__ h0_all,    // [M, B, Nmax]
                     const double* __restrict__ Q0_all,    // [M, B, Nmax]
                     const double* __restrict__ ser_all,   // [M, B, 2, nt]: us, ds target series
                     const double* __restrict__ par_all,   // [M, B, P_COUNT]
                     const double* __restrict__ qlat_all,  // [M, B, Nmax] / [M, nt, B, Nmax] / null
                     const double* __restrict__ stor_all,  // [M, B, 2, SP_COUNT]
                     const double* __restrict__ stab_all,  // [M, L] or shared [L]
                     long long stab_stride,                // doubles per member (0: shared)
                     const double* __restrict__ Y0_all,    // [M, J]
                     const int* __restrict__ bint,         // [B, BI_COUNT]
                     const double* __restrict__ jpar,      // [J, JP_COUNT]
                     const double* __restrict__ jtab,      // poly_n coefficients and tables
                     double* __restrict__ depth_all,       // [M, nt, B, Nmax]
                     double* __restrict__ flow_all,        // [M, nt, B, Nmax]
                     double* __restrict__ Y_all,           // [M, nt, J]
                     int* __restrict__ iters_all,          // [M, nt]
                     double* __restrict__ err_all,         // [M, nt]
                     int* __restrict__ conv_all,           // [M, nt]
                     double* stage_all,                    // [M, nt, B, 2]; NaN-filled
                     double* __restrict__ gate_all,        // [M, nt, B, 2]
                     long long* __restrict__ probe_out,    // [PH_COUNT] cycles (probe build)
                     int B, int n_max, int J, int nt, int max_iter, int sweeps, int qlat_mode) {
    constexpr int C = comp(RHS);
    extern __shared__ double smem[];
    __shared__ double warp_part[2][32];

    const size_t mem = blockIdx.x;
    const int ld = B * n_max;                      // slots
    const double* geo = geo_all + mem * (size_t)B * G_ROWS * n_max;
    const double* ser = ser_all + mem * (size_t)B * 2 * nt;
    const double* par_m = par_all + mem * (size_t)B * P_COUNT;
    const double* stor_m = stor_all + mem * (size_t)B * 2 * SP_COUNT;
    const double* stab_m = stab_all + mem * (size_t)stab_stride;
    const double* qlat = qlat_mode == QLAT_NONE ? nullptr
        : qlat_all + mem * (size_t)(qlat_mode == QLAT_LEVELS ? nt : 1) * ld;
    double* depth = depth_all + mem * (size_t)nt * ld;
    double* flow = flow_all + mem * (size_t)nt * ld;
    double* Yout = Y_all + mem * (size_t)nt * J;
    int* iters = iters_all + mem * (size_t)nt;
    double* errs = err_all + mem * (size_t)nt;
    int* conv = conv_all + mem * (size_t)nt;
    double* stage = stage_all + mem * (size_t)nt * B * 2;
    double* gate = gate_all + mem * (size_t)nt * B * 2;

    double* buf0 = smem;                        // the assembled system / PCR ping
    double* buf1 = buf0 + (size_t)C * ld;       // exchange area / PCR pong / solution
    double* sh = buf1 + (size_t)C * ld;
    double* sQ = sh + ld;
    double* shp = sQ + ld;
    double* sQp = shp + ld;
    double* sAp = sQp + ld;
    double* sSep = sAp + ld;
    double* sQ2Ap = sSep + ld;
    double* sqavg = sQ2Ap + ld;
    double* sY = sqavg + ld;                    // junction stage
    double* sYp = sY + J;                       // its level-start value
    double* sSp = sYp + J;                      // level-start signed end sum
    double* sqp = sSp + J;                      // level-start rated outflow
    double* srhs = sqp + J;                     // G, then the Schur right-hand side
    double* sdY = srhs + J;                     // dQ_out/dY, then the increment dY
    double* sM = sdY + J;                       // the J x J Schur matrix
    double* gopen = sM + (size_t)J * J;         // per branch: downstream gate state
    double* gcool = gopen + B;
    double* gtime = gcool + B;
    double* gstage = gtime + B;

    const double theta = par_m[P_THETA], dt = par_m[P_DT], tol = par_m[P_TOL];
    const double inv2dt = 1.0 / (2.0 * dt);
    const int tid = threadIdx.x, nthr = blockDim.x;
    // the junction rows go to the threads that own no slot when there are J
    // of them (junction j on thread slots + j), else to threads 0..J-1
    const int j0 = nthr - ld >= J ? (tid >= ld ? tid - ld : J) : tid;
    Probe<PROBE> probe;

#define TDIFF(c1, c0, p1, p0) (((c1) + (c0) - (p1) - (p0)) / (2.0 * dt))
#define SDIFF(c1, c0, p1, p0) ((theta * ((c1) - (c0)) + (1.0 - theta) * ((p1) - (p0))) / dx)
#define CAVG(c1, c0, p1, p0) (0.5 * theta * ((c1) + (c0)) + 0.5 * (1.0 - theta) * ((p1) + (p0)))
#define BRANCH_INT(b, f) bint[(b) * BI_COUNT + (f)]

    // -- the latency build's own slot: indices, branch, geometry in registers
    const bool own = tid < ld;
    int ob = 0, oi = 0, on_b = 0, ous_j = -1, ods_j = -1;
    double odx = 1.0, oz1 = 0.0;
    Geo og{};
    if constexpr (ONE) {
        if (own) {
            ob = tid / n_max;
            oi = tid - ob * n_max;
            on_b = BRANCH_INT(ob, BI_N);
            ous_j = BRANCH_INT(ob, BI_US_J);
            ods_j = BRANCH_INT(ob, BI_DS_J);
            odx = par_m[(size_t)ob * P_COUNT + P_DX];
            og = load_geo(geo, n_max, ob, oi);
            if (oi < n_max - 1) oz1 = geo[((size_t)ob * G_ROWS + G_ZBED) * n_max + oi + 1];
        }
    }
    // every slot of this thread: once in the latency build, a loop otherwise
    auto each_slot = [&](auto&& body) {
        if constexpr (ONE) {
            if (own) body(tid, ob, oi);
        } else {
            for (int s = tid; s < ld; s += nthr) {
                const int b = s / n_max;
                body(s, b, s - b * n_max);
            }
        }
    };
    auto geo_at = [&](int b, int i) -> Geo {
        if constexpr (ONE) return og;
        else return load_geo(geo, n_max, b, i);
    };

    // the latency build's registers: previous-level state of its node (0) and
    // of node i+1 (1), and this iteration's closures of its node
    double ohp0 = 0, oQp0 = 0, oAp0 = 0, oSep0 = 0, oQ2Ap0 = 0, oqavg = 0;
    double ohp1 = 0, oQp1 = 0, oAp1 = 0, oSep1 = 0, oQ2Ap1 = 0;
    double oh = 0, oQ = 0, oQ2A = 0, oQA = 0;
    Sec osc{};
    Slope oe{};

    // lane j of warp 0 (J <= 32): the ends at junction j in the stacked
    // engine's order (branches in order, downstream end first), 2 b + up, so
    // that the lanes form their Schur rows side by side and not one end of
    // the network after another
    int jend[MAX_JUNCTION_ENDS];
    int n_jend = 0;
    if (J >= 2 && J <= 32 && tid < J) {
        for (int b = 0; b < B; ++b) {
            if (BRANCH_INT(b, BI_DS_J) == tid) { if (n_jend < MAX_JUNCTION_ENDS) jend[n_jend] = 2 * b; ++n_jend; }
            if (BRANCH_INT(b, BI_US_J) == tid) { if (n_jend < MAX_JUNCTION_ENDS) jend[n_jend] = 2 * b + 1; ++n_jend; }
        }
    }

    each_slot([&](int s, int, int) {
        sh[s] = h0_all[mem * (size_t)ld + s];
        sQ[s] = Q0_all[mem * (size_t)ld + s];
        depth[s] = sh[s];
        flow[s] = sQ[s];
    });
    for (int j = tid; j < J; j += nthr) {
        sY[j] = Y0_all[mem * (size_t)J + j];
        Yout[j] = sY[j];
    }
    for (int b = tid; b < B; b += nthr) {
        const double* par = par_m + (size_t)b * P_COUNT;
        const double g0 = par[P_GATE_INIT];
        gopen[b] = BRANCH_INT(b, BI_DS_J) < 0 ? g0 : 0.0;
        gcool[b] = 0.0;
        gtime[b] = -1.0;
        gate[b * 2 + 0] = BRANCH_INT(b, BI_US_J) < 0 ? g0 : 0.0;
        gate[b * 2 + 1] = gopen[b];
    }
    if (tid == 0) { iters[0] = 0; errs[0] = 0.0; conv[0] = 1; }
    __syncthreads();
    probe.start();
    for (int b = tid; b < B; b += nthr)
        gstage[b] = par_m[(size_t)b * P_COUNT + P_DS_BED_LEVEL] + sh[b * n_max + n_max - 1];

    for (int k = 1; k < nt; ++k) {
        // -- level start: pads re-anchored to their branch's end
        each_slot([&](int s, int b, int i) {
            const int n_b = ONE ? on_b : BRANCH_INT(b, BI_N);
            if (i >= n_b) { sh[s] = sh[b * n_max + n_b - 1]; sQ[s] = sQ[b * n_max + n_b - 1]; }
        });
        // the gate controller of a gated downstream rating, on the stage the
        // previous level left
        for (int b = tid; b < B; b += nthr) {
            if (BRANCH_INT(b, BI_DS_KIND) != BC_RATING || BRANCH_INT(b, BI_RC_KIND) != RC_GATED) continue;
            const double* par = par_m + (size_t)b * P_COUNT;
            const double pivot = par[P_RC_PIVOT], time = (double)k * dt;
            const double elapsed = gtime[b] >= 0.0 ? time - gtime[b] : 0.0;
            double cool = clamp_min(gcool[b] - elapsed, 0.0);
            const bool can_act = cool <= 0.0;
            const bool do_open = can_act && (gstage[b] >= pivot + 0.5) && (gopen[b] < 0.5);
            const bool do_close = can_act && (gstage[b] <= pivot - 1.0) && (gopen[b] > 0.5);
            gopen[b] = do_open ? 1.0 : (do_close ? 0.0 : gopen[b]);
            gcool[b] = (do_open || do_close) ? par[P_RC_COOLDOWN] : cool;
            gtime[b] = time;
        }
        __syncthreads();
        probe.mark(PH_LEVEL);

        // -- previous-level state per slot; junction level-start terms
        each_slot([&](int s, int b, int i) {
            const double h = sh[s], Q = sQ[s];
            const Geo g = geo_at(b, i);
            const Sec sc = section_state(g, h);
            const Slope e = energy_slope(g, sc, h, Q);
            const double Q2A = Q * Q / sc.A;
            shp[s] = h; sQp[s] = Q;
            sAp[s] = sc.A; sSep[s] = e.Se; sQ2Ap[s] = Q2A;
            double qa = 0.0;
            if (qlat_mode != QLAT_NONE && i < n_max - 1) {
                const double* qc = qlat_mode == QLAT_LEVELS ? qlat + (size_t)k * ld : qlat;
                const double* qp = qlat_mode == QLAT_LEVELS ? qlat + (size_t)(k - 1) * ld : qlat;
                qa = CAVG(qc[s + 1], qc[s], qp[s + 1], qp[s]);
            }
            sqavg[s] = qa;
            if constexpr (ONE) { ohp0 = h; oQp0 = Q; oAp0 = sc.A; oSep0 = e.Se; oQ2Ap0 = Q2A; oqavg = qa; }
        });
        for (int j = j0; j < J; j += nthr) {
            const double* jp = jpar + (size_t)j * JP_COUNT;
            double S = 0.0;
            for (int b = 0; b < B; ++b) {
                if (BRANCH_INT(b, BI_DS_J) == j) S += sQ[b * n_max + n_max - 1];
                if (BRANCH_INT(b, BI_US_J) == j) S += -sQ[b * n_max];
            }
            sYp[j] = sY[j];
            sSp[j] = S;
            sqp[j] = junction_q(jp, jtab, sY[j]);
        }
        __syncthreads();
        probe.mark(PH_PREV);
        if constexpr (ONE) {
            if (own && oi < n_max - 1) {
                const int t = tid + 1;
                ohp1 = shp[t]; oQp1 = sQp[t]; oAp1 = sAp[t]; oSep1 = sSep[t]; oQ2Ap1 = sQ2Ap[t];
            }
        }

        // -- while-Newton on the pre-update residual
        double err = CUDART_INF;
        int it = 0;
        while (err >= tol && it < max_iter) {
            // closures of every slot into the exchange area
            each_slot([&](int s, int b, int i) {
                const double h = sh[s], Q = sQ[s];
                const Geo g = geo_at(b, i);
                const Sec sc = section_state(g, h);
                const Slope e = energy_slope(g, sc, h, Q);
                const double Q2A = Q * Q / sc.A, QA = Q / sc.A;
                buf1[0 * ld + s] = sc.A;      buf1[1 * ld + s] = Q2A;
                buf1[2 * ld + s] = e.Se;      buf1[3 * ld + s] = sc.dA_dh;
                buf1[4 * ld + s] = e.dSe_dA;  buf1[5 * ld + s] = e.dSe_dQ;
                buf1[6 * ld + s] = QA;
                if constexpr (ONE) { oh = h; oQ = Q; osc = sc; oe = e; oQ2A = Q2A; oQA = QA; }
            });
            __syncthreads();
            probe.mark(PH_CLOSURES);

            double sq = 0.0;
            each_slot([&](int s, int b, int i) {
                const int n_b = ONE ? on_b : BRANCH_INT(b, BI_N);
                const int us_j = ONE ? ous_j : BRANCH_INT(b, BI_US_J);
                const int ds_j = ONE ? ods_j : BRANCH_INT(b, BI_DS_J);
                const double* par = par_m + (size_t)b * P_COUNT;
                const double dx = ONE ? odx : par[P_DX];
                const double th_dx = theta / dx;
                // this slot's own values: registers in the latency build
                double h, Q, A0, Q2A0, Se0, dA_dh0, dSe_dA0, dSe_dQ0, QA0;
                if constexpr (ONE) {
                    h = oh; Q = oQ; A0 = osc.A; Q2A0 = oQ2A; Se0 = oe.Se; dA_dh0 = osc.dA_dh;
                    dSe_dA0 = oe.dSe_dA; dSe_dQ0 = oe.dSe_dQ; QA0 = oQA;
                } else {
                    h = sh[s]; Q = sQ[s];
                    A0 = buf1[0 * ld + s]; Q2A0 = buf1[1 * ld + s]; Se0 = buf1[2 * ld + s];
                    dA_dh0 = buf1[3 * ld + s]; dSe_dA0 = buf1[4 * ld + s];
                    dSe_dQ0 = buf1[5 * ld + s]; QA0 = buf1[6 * ld + s];
                }
                // structural zeros (L row 1, U row 0) and the coupling columns
                buf0[2 * ld + s] = 0.0; buf0[3 * ld + s] = 0.0;
                buf0[8 * ld + s] = 0.0; buf0[9 * ld + s] = 0.0;
#pragma unroll
                for (int r = 1; r < RHS; ++r) { buf0[(12 + 2 * r) * ld + s] = 0.0; buf0[(13 + 2 * r) * ld + s] = 0.0; }

                if (i < n_max - 1) {          // cell (i, i+1): node i row 1, node i+1 row 0
                    const int t = s + 1;
                    if (i < n_b - 1) {
                        const double h1 = sh[t], Q1 = sQ[t];
                        const double A1 = buf1[0 * ld + t], Q2A1 = buf1[1 * ld + t], Se1 = buf1[2 * ld + t];
                        const double dA_dh1 = buf1[3 * ld + t], dSe_dA1 = buf1[4 * ld + t];
                        const double dSe_dQ1 = buf1[5 * ld + t], QA1 = buf1[6 * ld + t];
                        double hp0, hp1, Qp0, Qp1, Ap0, Ap1, Sep0, Sep1, Q2Ap0, Q2Ap1, qavg, z0, z1;
                        if constexpr (ONE) {
                            hp0 = ohp0; hp1 = ohp1; Qp0 = oQp0; Qp1 = oQp1; Ap0 = oAp0; Ap1 = oAp1;
                            Sep0 = oSep0; Sep1 = oSep1; Q2Ap0 = oQ2Ap0; Q2Ap1 = oQ2Ap1; qavg = oqavg;
                            z0 = og.z; z1 = oz1;
                        } else {
                            hp0 = shp[s]; hp1 = shp[t]; Qp0 = sQp[s]; Qp1 = sQp[t];
                            Ap0 = sAp[s]; Ap1 = sAp[t]; Sep0 = sSep[s]; Sep1 = sSep[t];
                            Q2Ap0 = sQ2Ap[s]; Q2Ap1 = sQ2Ap[t]; qavg = sqavg[s];
                            z0 = geo[((size_t)b * G_ROWS + G_ZBED) * n_max + i];
                            z1 = geo[((size_t)b * G_ROWS + G_ZBED) * n_max + i + 1];
                        }

                        double Rc = TDIFF(A1, A0, Ap1, Ap0) + SDIFF(Q1, Q, Qp1, Qp0);
                        if (qlat_mode != QLAT_NONE) Rc = Rc - qavg;
                        const double avgA = CAVG(A1, A0, Ap1, Ap0);
                        const double dYdx = (z1 - z0) / dx + SDIFF(h1, h, hp1, hp0);
                        const double avgSe = CAVG(Se1, Se0, Sep1, Sep0);
                        const double Rm = TDIFF(Q1, Q, Qp1, Qp0) + SDIFF(Q2A1, Q2A0, Q2Ap1, Q2Ap0)
                            + G * avgA * (dYdx + avgSe);
                        const double geom = dYdx + avgSe;
                        const double dM_dh_i = (th_dx * (QA0 * QA0) * dA_dh0
                            + G * (avgA * (-th_dx + 0.5 * theta * dSe_dA0 * dA_dh0)
                                   + 0.5 * theta * dA_dh0 * geom));
                        const double dM_dh_i1 = (-th_dx * (QA1 * QA1) * dA_dh1
                            + G * (avgA * (th_dx + 0.5 * theta * dSe_dA1 * dA_dh1)
                                   + 0.5 * theta * dA_dh1 * geom));
                        const double dM_dQ_i = inv2dt - th_dx * 2.0 * QA0 + G * avgA * 0.5 * theta * dSe_dQ0;
                        const double dM_dQ_i1 = inv2dt + th_dx * 2.0 * QA1 + G * avgA * 0.5 * theta * dSe_dQ1;
                        buf0[6 * ld + s] = dA_dh0 * inv2dt;  buf0[7 * ld + s] = -th_dx;
                        buf0[10 * ld + s] = dA_dh1 * inv2dt; buf0[11 * ld + s] = th_dx;
                        buf0[13 * ld + s] = -Rc;
                        buf0[0 * ld + t] = dM_dh_i;   buf0[1 * ld + t] = dM_dQ_i;
                        buf0[4 * ld + t] = dM_dh_i1;  buf0[5 * ld + t] = dM_dQ_i1;
                        buf0[12 * ld + t] = -Rm;
                        sq += Rc * Rc + Rm * Rm;
                    } else {                  // pad cell: delta-copy rows, no residual in the norm
                        buf0[6 * ld + s] = -1.0;  buf0[7 * ld + s] = 0.0;
                        buf0[10 * ld + s] = 1.0;  buf0[11 * ld + s] = 0.0;
                        buf0[13 * ld + s] = -(sh[t] - h);
                        buf0[0 * ld + t] = 0.0;   buf0[1 * ld + t] = -1.0;
                        buf0[4 * ld + t] = 0.0;   buf0[5 * ld + t] = 1.0;
                        buf0[12 * ld + t] = -(sQ[t] - Q);
                    }
                }
                if (i == 0 || i == n_max - 1) {   // the branch's end rows
                    const bool up = i == 0;
                    const int jid = up ? us_j : ds_j;
                    double res, df_dh, df_dQ;
                    // D row 0 of node 0 (upstream) or row 1 of node Nmax-1 (downstream)
                    double* p_dh = &buf0[(up ? 4 : 6) * ld + s];
                    double* p_dq = &buf0[(up ? 5 : 7) * ld + s];
                    double* p_b = &buf0[(up ? 12 : 13) * ld + s];
                    if (up) { buf0[0 * ld + s] = 0.0; buf0[1 * ld + s] = 0.0; }
                    else { buf0[10 * ld + s] = 0.0; buf0[11 * ld + s] = 0.0; }
                    if (jid >= 0) {
                        const double z = ONE ? og.z : geo[((size_t)b * G_ROWS + G_ZBED) * n_max + i];
                        res = h - (sY[jid] - z);
                        *p_dh = 1.0; *p_dq = 0.0; *p_b = -res;
                        // its -1 coupling column: the upstream coupling first
                        const int col = 1 + (up ? 0 : (us_j >= 0 ? 1 : 0));
                        buf0[(12 + 2 * col + (up ? 0 : 1)) * ld + s] = -1.0;
                    } else {
                        Sec sc;
                        if constexpr (ONE) sc = osc;
                        else sc = section_state(load_geo(geo, n_max, b, i), h);
                        const int kind = BRANCH_INT(b, up ? BI_US_KIND : BI_DS_KIND);
                        const int sflags = BRANCH_INT(b, up ? BI_US_SFLAGS : BI_DS_SFLAGS);
                        const double bed = par[up ? P_US_BED_LEVEL : P_DS_BED_LEVEL];
                        double* st = &stage[((size_t)k * B + b) * 2 + (up ? 0 : 1)];
                        if (kind == BC_FIXED && (sflags & ST_ON)) {
                            // level 1: upstream anchors on the previous level's
                            // surface, downstream on the current trial stage;
                            // later levels on the stage this thread stored
                            const double hp_s = ONE ? ohp0 : shp[s];
                            const double Y_old = k == 1 ? (up ? hp_s : h) + bed
                                : stage[((size_t)(k - 1) * B + b) * 2 + (up ? 0 : 1)];
                            const int nv = BRANCH_INT(b, up ? BI_US_NV : BI_DS_NV);
                            const int na = BRANCH_INT(b, up ? BI_US_NA : BI_DS_NA);
                            const int off = BRANCH_INT(b, BI_TAB_OFF)
                                + (up ? 0 : 2 * (BRANCH_INT(b, BI_US_NV) + BRANCH_INT(b, BI_US_NA)));
                            res = storage_row(stor_m + ((size_t)b * 2 + (up ? 0 : 1)) * SP_COUNT, stab_m + off,
                                              sflags, nv, na, up ? -1.0 : 1.0, bed, dt, ONE ? oQp0 : sQp[s], Y_old,
                                              sc.A, sc.R, sc.n_eq, sc.dR_dA, sc.dA_dh, h, Q, p_dh, p_dq, p_b, st);
                        } else {
                            Bc bc = up ? Bc{par[P_US_BED_LEVEL], par[P_US_BED_SLOPE], par[P_US_INIT_DEPTH], kind}
                                       : Bc{par[P_DS_BED_LEVEL], par[P_DS_BED_SLOPE], par[P_DS_INIT_DEPTH], kind};
                            Rating rat{};
                            if (kind == BC_RATING)
                                rat = up ? Rating{par[P_URC_LOW0], par[P_URC_LOW1], par[P_URC_LOW2],
                                                  par[P_URC_HIGH0], par[P_URC_HIGH1], par[P_URC_HIGH2],
                                                  par[P_URC_SHIFT], par[P_URC_PIVOT], par[P_URC_BUFFER],
                                                  par[P_URC_FD], 0.0, BRANCH_INT(b, BI_URC_KIND)}
                                         : Rating{par[P_RC_LOW0], par[P_RC_LOW1], par[P_RC_LOW2],
                                                  par[P_RC_HIGH0], par[P_RC_HIGH1], par[P_RC_HIGH2],
                                                  par[P_RC_SHIFT], par[P_RC_PIVOT], par[P_RC_BUFFER],
                                                  par[P_RC_FD], par[P_RC_COOLDOWN], BRANCH_INT(b, BI_RC_KIND)};
                            const double target = ser[((size_t)b * 2 + (up ? 0 : 1)) * nt + k];
                            boundary_row(bc, rat, sc, h, Q, target, up ? 0.0 : gopen[b], res, df_dh, df_dQ);
                            *p_dh = df_dh; *p_dq = df_dQ; *p_b = -res;
                        }
                    }
                    sq += res * res;
                }
            });
            // junction rows: G_j, and dQ_out/dY for the Schur diagonal
            for (int j = j0; j < J; j += nthr) {
                const double* jp = jpar + (size_t)j * JP_COUNT;
                double S = 0.0;
                for (int b = 0; b < B; ++b) {
                    if (BRANCH_INT(b, BI_DS_J) == j) S += sQ[b * n_max + n_max - 1];
                    if (BRANCH_INT(b, BI_US_J) == j) S += -sQ[b * n_max];
                }
                const double area = jp[JP_AREA];
                const double q = junction_q(jp, jtab, sY[j]);
                const double Gj = area > 0.0
                    ? area * (sY[j] - sYp[j]) / dt - 0.5 * (S + sSp[j]) + 0.5 * (q + sqp[j])
                    : S - q;
                srhs[j] = Gj;
                sdY[j] = junction_dq(jp, jtab, sY[j]);
                sq += Gj * Gj;
            }
            // the barrier inside publishes buf0 and retires every read of the
            // exchange area before the first sweep overwrites it
            err = sqrt(block_sum(sq, warp_part[it & 1]));
            probe.mark(PH_ASSEMBLY);

            double* src = buf0;
            double* dst = buf1;
            int stride = 1;
            for (int sw = 0; sw < sweeps; ++sw, stride *= 2) {
                each_slot([&](int s, int b, int i) {
                    pcr::sweep_node<RHS>(src + b * n_max, dst + b * n_max, ld, n_max, stride, i);
                });
                __syncthreads();
                probe.mark(PH_SWEEPS);
                double* tmp = src; src = dst; dst = tmp;
            }
            // the solution columns (x[2r + row]) into the free buffer
            each_slot([&](int s, int b, int i) {
                double x[2 * RHS];
                pcr::backsolve_node<RHS>(src + b * n_max, ld, i, x);
#pragma unroll
                for (int c = 0; c < 2 * RHS; ++c) dst[c * ld + s] = x[c];
            });
            __syncthreads();
            probe.mark(PH_BACKSOLVE);
            const double* X = dst;

            // the Schur system, in the stacked engine's order: row j from the
            // end values of the solution columns of the branches at junction
            // j, downstream end first
            double dY1 = 0.0;        // J = 1: the increment, formed by every thread
            if (J == 1) {
                const double area = jpar[JP_AREA];
                const double D_Y = area > 0.0 ? area / dt + 0.5 * sdY[0] : -sdY[0];
                const double fac = area > 0.0 ? -0.5 : 1.0;
                double m = 0.0, rhs = srhs[0];
                for (int b = 0; b < B; ++b) {
                    const int us_j = BRANCH_INT(b, BI_US_J), ds_j = BRANCH_INT(b, BI_DS_J);
                    for (int e = 0; e < 2; ++e) {
                        const bool up = e == 1;
                        if ((up ? us_j : ds_j) != 0) continue;
                        const int s = b * n_max + (up ? 0 : n_max - 1);
                        const double fs = fac * (up ? -1.0 : 1.0);
                        rhs += fs * X[1 * ld + s];
                        int ci = 0;
                        if (us_j >= 0) { m += fs * X[(2 * (1 + ci) + 1) * ld + s]; ++ci; }
                        if (ds_j >= 0) { m += fs * X[(2 * (1 + ci) + 1) * ld + s]; }
                    }
                }
                m = m - D_Y;
                dY1 = rhs / m;
            } else {
                // junction j's row by lane j of warp 0 when J <= 32 (then the
                // rows and their solve need no block barrier between them),
                // over its list of ends
                const bool warp0 = J <= 32;
                for (int j = tid; j < J && (!warp0 || tid < 32); j += (warp0 ? 32 : nthr)) {
                    const double area = jpar[(size_t)j * JP_COUNT + JP_AREA];
                    const double fac = area > 0.0 ? -0.5 : 1.0;
                    const double D_Y = area > 0.0 ? area / dt + 0.5 * sdY[j] : -sdY[j];
                    double* row = sM + (size_t)j * J;
                    for (int c = 0; c < J; ++c) row[c] = 0.0;
                    double rhs = srhs[j];
                    auto add_end = [&](int b, bool up) {
                        const int us_j = BRANCH_INT(b, BI_US_J), ds_j = BRANCH_INT(b, BI_DS_J);
                        const int s = b * n_max + (up ? 0 : n_max - 1);
                        const double fs = fac * (up ? -1.0 : 1.0);
                        rhs += fs * X[1 * ld + s];
                        int ci = 0;
                        if (us_j >= 0) { row[us_j] += fs * X[(2 * (1 + ci) + 1) * ld + s]; ++ci; }
                        if (ds_j >= 0) { row[ds_j] += fs * X[(2 * (1 + ci) + 1) * ld + s]; }
                    };
                    if (warp0 && n_jend <= MAX_JUNCTION_ENDS) {
                        for (int e = 0; e < n_jend; ++e) add_end(jend[e] >> 1, jend[e] & 1);
                    } else {
                        for (int b = 0; b < B; ++b) {       // downstream end first
                            if (BRANCH_INT(b, BI_DS_J) == j) add_end(b, false);
                            if (BRANCH_INT(b, BI_US_J) == j) add_end(b, true);
                        }
                    }
                    row[j] = row[j] - D_Y;
                    srhs[j] = rhs;
                }
                if (warp0) {
                    __syncwarp();
                } else {
                    __syncthreads();
                    probe.mark(PH_SCHUR);
                }
                // dY into sdY by warp 0 (the rows above have read its dQ_out/dY)
                if (tid < 32) warp_gauss_jordan(sM, srhs, sdY, J, tid);
                __syncthreads();
                probe.mark(PH_JSOLVE);
            }
            auto dY_of = [&](int j) { return J == 1 ? dY1 : sdY[j]; };

            // dx = u - V dY per slot; Y += dY
            each_slot([&](int s, int b, int i) {
                const int us_j = ONE ? ous_j : BRANCH_INT(b, BI_US_J);
                const int ds_j = ONE ? ods_j : BRANCH_INT(b, BI_DS_J);
                double d[RHS > 1 ? RHS - 1 : 1];
#pragma unroll
                for (int m = 0; m < RHS - 1; ++m) d[m] = 0.0;
                int ci = 0;
                if (us_j >= 0) d[ci++] = dY_of(us_j) * 1.0;
                if (ds_j >= 0) d[ci] = dY_of(ds_j) * 1.0;
                double dh, dq;
                if constexpr (RHS == 2) {
                    dh = X[0 * ld + s] - X[2 * ld + s] * d[0];
                    dq = X[1 * ld + s] - X[3 * ld + s] * d[0];
                } else {
                    dh = X[0 * ld + s] - (X[2 * ld + s] * d[0] + X[4 * ld + s] * d[1]);
                    dq = X[1 * ld + s] - (X[3 * ld + s] * d[0] + X[5 * ld + s] * d[1]);
                }
                const double h = ONE ? oh : sh[s], Q = ONE ? oQ : sQ[s];
                sh[s] = h + dh;
                sQ[s] = Q + dq;
            });
            for (int j = tid; j < J; j += nthr) sY[j] = sY[j] + dY_of(j);
            ++it;
            __syncthreads();
            probe.mark(PH_UPDATE);
        }

        // -- the level's records
        each_slot([&](int s, int, int) {
            depth[(size_t)k * ld + s] = sh[s];
            flow[(size_t)k * ld + s] = sQ[s];
        });
        for (int j = tid; j < J; j += nthr) Yout[(size_t)k * J + j] = sY[j];
        for (int b = tid; b < B; b += nthr) {
            gate[((size_t)k * B + b) * 2 + 0] = gate[b * 2 + 0];
            gate[((size_t)k * B + b) * 2 + 1] = gopen[b];
            gstage[b] = par_m[(size_t)b * P_COUNT + P_DS_BED_LEVEL] + sh[b * n_max + n_max - 1];
        }
        if (tid == 0) {
            iters[k] = it;
            errs[k] = err;
            conv[k] = err < tol ? 1 : 0;
        }
        // the next level's pad re-sync must not overwrite an end read above
        __syncthreads();
        probe.mark(PH_LEVEL);
    }
    probe.write(probe_out);
#undef TDIFF
#undef SDIFF
#undef CAVG
#undef BRANCH_INT
}

// Every build has one signature: a build is a kernel pointer.
using NetKernel = decltype(&fused_network_kernel<2, MAX_THREADS, 1, false, false>);

int threads_for(int slots) {
    const int t = ((slots + 31) / 32) * 32;
    return t > MAX_THREADS ? MAX_THREADS : t;
}

// The residency build is the latency build's form (one slot a thread, so
// slots <= MAX_THREADS) under a launch bound of two blocks of the block's
// size, 192 threads (the tributary's 183 slots) or MAX_THREADS:
// 65536 / (2 * BLOCK) registers a thread, rounded down to 8 — 168 at 192
// threads, 128 at 256.  A network with more slots than threads has no
// residency build: the loop build runs every batch of it.
template <int RHS>
int pick_rhs(int build, int slots, bool probe, NetKernel* out) {
    const bool one = slots <= MAX_THREADS;
    if (probe && build != LOOP_BUILD && build != LATENCY_BUILD) return (int)cudaErrorInvalidValue;
    switch (build) {
    case LOOP_BUILD:
        *out = probe ? &fused_network_kernel<RHS, MAX_THREADS, 1, false, true>
                     : &fused_network_kernel<RHS, MAX_THREADS, 1, false, false>;
        return 0;
    case LATENCY_BUILD:
        if (!one) return (int)cudaErrorInvalidValue;
        *out = probe ? &fused_network_kernel<RHS, MAX_THREADS, 1, true, true>
                     : &fused_network_kernel<RHS, MAX_THREADS, 1, true, false>;
        return 0;
    case RESIDENCY_BUILD:
        if (!one) return (int)cudaErrorInvalidValue;
        *out = threads_for(slots) <= 192 ? &fused_network_kernel<RHS, 192, 2, true, false>
                                         : &fused_network_kernel<RHS, MAX_THREADS, 2, true, false>;
        return 0;
    }
    return (int)cudaErrorInvalidValue;
}

int pick_build(int build, int slots, int rhs, bool probe, NetKernel* out) {
    if (rhs == 2) return pick_rhs<2>(build, slots, probe, out);
    if (rhs == 3) return pick_rhs<3>(build, slots, probe, out);
    return (int)cudaErrorInvalidValue;
}

// blocks of this build the occupancy calculator puts on one SM
int resident_blocks(NetKernel fn, int threads, size_t smem, int* blocks) {
    cudaError_t e = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, (const void*)fn, threads, smem);
}

// The build a launch of n_members networks takes.  A network with more
// slots than threads takes the loop build.  Else the latency build runs
// every batch the card holds at once in it; a larger batch takes the
// residency build when that holds more members.
int choose_build(int n_members, int slots, int rhs, size_t smem, int* build) {
    *build = slots <= MAX_THREADS ? LATENCY_BUILD : LOOP_BUILD;
    if (*build == LOOP_BUILD) return 0;
    int dev, sms, fast_bps, res_bps, rc;
    NetKernel fast, res;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return rc;
    if (n_members <= sms) return 0;
    if ((rc = pick_build(*build, slots, rhs, false, &fast))) return rc;
    if ((rc = resident_blocks(fast, threads_for(slots), smem, &fast_bps))) return rc;
    if (n_members <= fast_bps * sms) return 0;
    if ((rc = pick_build(RESIDENCY_BUILD, slots, rhs, false, &res))) return rc;
    if ((rc = resident_blocks(res, threads_for(slots), smem, &res_bps))) return rc;
    if (res_bps > fast_bps) *build = RESIDENCY_BUILD;
    return 0;
}

int launch(int build, bool probe, const double* geo, const double* h0, const double* Q0, const double* ser,
           const double* par, const double* qlat, const double* stor, const double* stab, long long stab_stride,
           const double* Y0, const int* bint, const double* jpar, const double* jtab, double* depth,
           double* flow, double* Y, int* iters, double* err, int* conv, double* stage, double* gate,
           long long* probe_out, int n_members, int B, int n_max, int J, int nt, int max_iter, int rhs,
           int qlat_mode, cudaStream_t stream) {
    const int slots = B * n_max;
    const size_t smem = smem_doubles(slots, B, J, rhs) * sizeof(double);
    int rc = 0;
    if (build < 0 && (rc = choose_build(n_members, slots, rhs, smem, &build))) return rc;
    NetKernel fn;
    if ((rc = pick_build(build, slots, rhs, probe, &fn))) return rc;
    cudaError_t e = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    fn<<<n_members, threads_for(slots), smem, stream>>>(
        geo, h0, Q0, ser, par, qlat, stor, stab, stab_stride, Y0, bint, jpar, jtab, depth, flow, Y,
        iters, err, conv, stage, gate, probe_out, B, n_max, J, nt, max_iter, pcr::n_sweeps(n_max), qlat_mode);
    return (int)cudaGetLastError();
}

int check_args(int n_members, int B, int n_max, int J, int nt, int qlat_mode, const void* qlat,
               const void* stage, const void* stor, const void* stab, const void* jtab) {
    if (n_members <= 0 || B <= 0 || n_max <= 1 || J <= 0 || nt <= 0) return (int)cudaErrorInvalidValue;
    if (qlat_mode < QLAT_NONE || qlat_mode > QLAT_LEVELS) return (int)cudaErrorInvalidValue;
    if ((qlat_mode != QLAT_NONE) != (qlat != nullptr)) return (int)cudaErrorInvalidValue;
    if (stage == nullptr || stor == nullptr || stab == nullptr || jtab == nullptr) return (int)cudaErrorInvalidValue;
    return 0;
}

}  // namespace

extern "C" int flowsim_fused_network_branch_ints() { return BI_COUNT; }
extern "C" int flowsim_fused_network_junction_params() { return JP_COUNT; }
extern "C" int flowsim_fused_network_probe_phases() { return PH_COUNT; }
// dynamic shared memory of one block, in bytes
extern "C" long long flowsim_fused_network_smem_bytes(int slots, int B, int J, int rhs) {
    return (long long)(smem_doubles(slots, B, J, rhs) * sizeof(double));
}

#define FLOWSIM_NET_ARGS (const double*)geo, (const double*)h0, (const double*)Q0, (const double*)ser, \
        (const double*)par, (const double*)qlat, (const double*)stor, (const double*)stab, stab_stride, \
        (const double*)Y0, (const int*)bint, (const double*)jpar, (const double*)jtab, (double*)depth, \
        (double*)flow, (double*)Y, (int*)iters, (double*)err, (int*)conv, (double*)stage, (double*)gate

// One block per member: n_members = 1 is fused_simulate_network, M is
// fused_simulate_network_batched.  Every per-member array carries the leading
// member axis (the storage tables only when stab_stride != 0); bint, jpar and
// jtab are shared.  stage [M, nt, B, 2] is filled with NaN by the caller.
// build: -1 chooses by the member count (choose_build: what the wrappers
// do); 0-2 forces a build (a test hook: chip_smoke.py times the builds
// against each other and holds them to the same bits).
extern "C" int flowsim_fused_network(const void* geo, const void* h0, const void* Q0, const void* ser,
                                     const void* par, const void* qlat, const void* stor, const void* stab,
                                     long long stab_stride, const void* Y0, const void* bint,
                                     const void* jpar, const void* jtab, void* depth, void* flow, void* Y,
                                     void* iters, void* err, void* conv, void* stage, void* gate,
                                     int n_members, int B, int n_max, int J, int nt, int max_iter, int rhs,
                                     int qlat_mode, int build, void* stream) {
    const int rc = check_args(n_members, B, n_max, J, nt, qlat_mode, qlat, stage, stor, stab, jtab);
    if (rc) return rc;
    return launch(build, false, FLOWSIM_NET_ARGS, nullptr, n_members, B, n_max, J, nt, max_iter, rhs, qlat_mode,
                  (cudaStream_t)stream);
}

// The probe build of the loop (build 0) or latency (build 1) form: the same
// launch, and the cycles of each phase of thread 0 of block 0 summed over the
// run into probe [PH_COUNT] (device memory); clock_khz receives the SM clock
// rate the cycles count at (cudaDevAttrClockRate).
extern "C" int flowsim_fused_network_probe(const void* geo, const void* h0, const void* Q0, const void* ser,
                                           const void* par, const void* qlat, const void* stor, const void* stab,
                                           long long stab_stride, const void* Y0, const void* bint,
                                           const void* jpar, const void* jtab, void* depth, void* flow, void* Y,
                                           void* iters, void* err, void* conv, void* stage, void* gate,
                                           void* probe, int* clock_khz, int n_members, int B, int n_max, int J,
                                           int nt, int max_iter, int rhs, int qlat_mode, int build, void* stream) {
    int rc = check_args(n_members, B, n_max, J, nt, qlat_mode, qlat, stage, stor, stab, jtab);
    if (rc) return rc;
    if (probe == nullptr || clock_khz == nullptr || (build != LOOP_BUILD && build != LATENCY_BUILD))
        return (int)cudaErrorInvalidValue;
    int dev;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaDeviceGetAttribute(clock_khz, cudaDevAttrClockRate, dev))) return rc;
    return launch(build, true, FLOWSIM_NET_ARGS, (long long*)probe, n_members, B, n_max, J, nt, max_iter, rhs,
                  qlat_mode, (cudaStream_t)stream);
}
#undef FLOWSIM_NET_ARGS

// The build flowsim_fused_network takes for n_members members (build -1).
extern "C" int flowsim_fused_network_chosen_build(int n_members, int slots, int B, int J, int rhs, int* build) {
    if (n_members <= 0 || slots <= 0 || B <= 0 || J <= 0 || build == nullptr) return (int)cudaErrorInvalidValue;
    return choose_build(n_members, slots, rhs, smem_doubles(slots, B, J, rhs) * sizeof(double), build);
}

// Resident blocks per SM of a build at this network's block size and shared
// memory, from the CUDA occupancy calculator.
extern "C" int flowsim_fused_network_resident_blocks(int slots, int B, int J, int rhs, int build, int* blocks) {
    if (slots <= 0 || B <= 0 || J <= 0 || blocks == nullptr) return (int)cudaErrorInvalidValue;
    NetKernel fn;
    const int rc = pick_build(build, slots, rhs, false, &fn);
    return rc ? rc : resident_blocks(fn, threads_for(slots), smem_doubles(slots, B, J, rhs) * sizeof(double),
                                     blocks);
}
